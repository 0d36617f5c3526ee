"""Hand-written CUDA kernels (``csrc/*.cu``, built for sm_90a with nvcc at
first use by ``_build``) and their PyTorch wrappers."""
