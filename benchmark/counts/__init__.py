"""The yardstick's arithmetic: the card's peaks, the least bytes and
operations of the hand-written kernels' functions, and the model FLOPs of
the served work. Frozen here so that a change to the program cannot move
them."""
