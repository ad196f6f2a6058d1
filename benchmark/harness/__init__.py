"""The benchmark's own machinery: seeds, weights, traffic, the device trace
and the result line. Nothing here imports the program at module level."""
