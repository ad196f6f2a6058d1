"""One NVIDIA H100 SXM's published peaks (NVIDIA's data sheet, dense, no
sparsity, at the 700 W power limit; the card's own limit is printed beside
every number the benchmark reports).

fp32 work is bounded by the TF32 tensor-core rate: no method that keeps
fp32's accuracy (3xTF32 splits, for one) can run faster, so a roofline or
an MFU against it never passes 100 %. The program's own tables bound fp32
work at the 67 TFLOP/s of the SIMT units, which a tensor-core fp32 kernel
would exceed."""

PEAK_FLOPS = {
    "float32": 495e12,     # TF32 dense tensor cores
    "bfloat16": 989e12,    # bf16 dense tensor cores
}
HBM_BYTES_PER_S = 3.35e12
