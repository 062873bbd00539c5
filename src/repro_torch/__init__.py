"""PyTorch/CUDA port of the Equinox serving stack for one NVIDIA H100.

Mirrors ``src/repro`` file for file.  Modules with no JAX in them are
copies (so scheduling decisions stay identical); the model layers, KV
pools, engine and predictor experts are PyTorch; the paged-attention
kernels are hand-written CUDA C++ built at first use (``kernels/_build``).
"""
