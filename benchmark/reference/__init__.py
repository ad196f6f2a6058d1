"""The plain reference: the published models' equations in plain PyTorch
and NumPy, written from the architectures' descriptions and the
configuration files' sizes. It imports nothing of the program and takes
nothing the program made: it reads the benchmark's raw seeded weights (in
the checkpoint's key layout) and works the int8 weights, scales and caches
out again itself. It computes float32 work in full float32, TF32 off
(``nn.set_tf32``), as the configurations state."""
