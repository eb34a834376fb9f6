"""PyTorch + CUDA port of `opus_pllm_tpu` for one NVIDIA H100 (Hopper).

The JAX package beside this one is the reference: every module here names
its JAX counterpart by file and function, keeps its public layouts
((B, S, H, D) activations, (B, 1, Sq, Skv) masks) and is held to it by the
tests in `tests/test_torch_*.py`. This package imports `torch` and never
`jax`; the subpackage `__init__` files stay empty so importing one module
pulls in nothing else.
"""
