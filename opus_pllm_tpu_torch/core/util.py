"""Small shared helpers (port of `opus_pllm_tpu/core/util.py`)."""

from __future__ import annotations


def round_up(n: int, multiple: int) -> int:
    """Round n up to a multiple (the eval runner's shape bucketing)."""
    return ((n + multiple - 1) // multiple) * multiple
