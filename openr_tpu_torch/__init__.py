"""openr-tpu ported to PyTorch and hand-written CUDA kernels for one NVIDIA
H100; the JAX package ``openr_tpu`` is the reference it is held against."""
