"""Small shared helpers (port of `opus_pllm_tpu/core/util.py`)."""

from __future__ import annotations

import torch


def round_up(n: int, multiple: int) -> int:
    """Round n up to a multiple (the eval runner's shape bucketing)."""
    return ((n + multiple - 1) // multiple) * multiple


def mm_fp32(a, b):
    """a (M, K) @ b (K, N) with fp32 accumulation and an fp32 result (the
    JAX `preferred_element_type=float32` product), no autograd. On CUDA a
    low-precision pair runs on the tensor cores and writes fp32 directly;
    elsewhere the same values multiply in fp32."""
    if a.is_cuda and a.dtype != torch.float32 and a.dtype == b.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means CUDA. There is no
    fallback: without a GPU, torch raises where the tensors are made. CPU
    callers (the tests) pass device="cpu"."""
    return torch.device("cuda" if device is None else device)
