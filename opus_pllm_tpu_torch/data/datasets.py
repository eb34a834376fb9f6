"""Instruction-tuning data (port of the stage-(c)/(d) half of
`opus_pllm_tpu/data/datasets.py`: `InstructionDataset` :170 and
`batch_iterator` :211). Host-side, numpy only."""

from __future__ import annotations

import json
from typing import Iterator, Optional

import numpy as np


class InstructionDataset:
    """Instruction-tuning JSON [{instruction, input (an amino-acid
    sequence), output}] for stages (c)/(d); entries without an input are
    dropped. Optionally joined with a precomputed {sequence: embedding}
    map (the pooled-embedding training path)."""

    def __init__(self, path: str, embedding_map_path: Optional[str] = None):
        with open(path) as f:
            self.items = [d for d in json.load(f) if d.get("input")]
        self.embeddings = None
        if embedding_map_path:
            with open(embedding_map_path) as f:
                self.embeddings = {k: np.asarray(v, np.float32)
                                   for k, v in json.load(f).items()}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        d = self.items[i]
        out = {"instruction": d["instruction"], "sequence": d["input"],
               "output": d.get("output", "")}
        if self.embeddings is not None:
            out["seq_embedding"] = self.embeddings.get(d["input"])
        return out


def batch_iterator(n: int, batch_size: int, *, shuffle: bool = True,
                   drop_remainder: bool = True, seed: int = 0,
                   epochs: int = 1) -> Iterator[np.ndarray]:
    """Index batches; each epoch shuffles with
    np.random.default_rng(seed + epoch), as the JAX function does."""
    for ep in range(epochs):
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + ep).shuffle(idx)
        end = n - (n % batch_size) if drop_remainder else n
        for s in range(0, end, batch_size):
            yield idx[s:s + batch_size]
