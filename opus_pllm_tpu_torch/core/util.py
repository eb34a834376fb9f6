"""Small shared helpers (port of `opus_pllm_tpu/core/util.py`)."""

from __future__ import annotations

import torch


def round_up(n: int, multiple: int) -> int:
    """Round n up to a multiple (the eval runner's shape bucketing)."""
    return ((n + multiple - 1) // multiple) * multiple


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means CUDA. There is no
    fallback: without a GPU, torch raises where the tensors are made. CPU
    callers (the tests) pass device="cpu"."""
    return torch.device("cuda" if device is None else device)
