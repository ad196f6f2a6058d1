"""PyTorch/CUDA port of ``seamless_communication_tpu`` for NVIDIA Hopper.

The JAX package stays the reference: this package mirrors its module paths
(``ops/transformer.py`` here is the counterpart of ``ops/transformer.py``
there), keeps its public layouts, and is held against it on the same weights
and inputs. It imports torch, numpy and the standard library only, never JAX
and never the JAX package. Kernels that the JAX package wrote in Pallas for
the TPU are CUDA C++ kernels here (``csrc/``), built at first use.
"""
