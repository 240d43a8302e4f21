"""cake-tpu's PyTorch/CUDA port: single-host Llama-family generation on an
NVIDIA Hopper GPU, with the TPU package's attention kernels rewritten as
CUDA kernels (ops/csrc). Imports torch only, never jax or ``cake_tpu``."""

__version__ = "0.1.0"
