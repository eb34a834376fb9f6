"""Prompt tokenization with `<seq>` sentinels and batch padding (port of
`opus_pllm_tpu/infer/tokenization.py`: `tokenize_with_seq` :23,
`pad_batch` :44, `ByteTokenizer` :78). Host-side, numpy only."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import SEQ_TOKEN, SEQ_TOKEN_INDEX


def tokenize_with_seq(prompt: str, encode: Callable[[str], List[int]],
                      bos_token_id: Optional[int] = None) -> List[int]:
    """Tokenize `prompt`, replacing each `<seq>` with one -200 sentinel;
    one leading BOS when `bos_token_id` is given."""
    chunks = [encode(c) for c in prompt.split(SEQ_TOKEN)]
    ids: List[int] = []
    if bos_token_id is not None:
        ids.append(bos_token_id)
        chunks = [c[1:] if c and c[0] == bos_token_id else c for c in chunks]
    for i, c in enumerate(chunks):
        if i > 0:
            ids.append(SEQ_TOKEN_INDEX)
        ids.extend(c)
    return ids


def pad_batch(seqs: Sequence[Sequence[int]], pad_id: int, *, left: bool,
              max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged ids -> (ids (B, L) int32, mask (B, L) bool), padded (or
    truncated: the tail for left-pad, the head for right-pad) to max_len."""
    longest = max((len(s) for s in seqs), default=0)
    pad_to = max(max_len if max_len else longest, 1)
    ids = np.full((len(seqs), pad_to), pad_id, dtype=np.int32)
    mask = np.zeros((len(seqs), pad_to), dtype=bool)
    for i, s in enumerate(seqs):
        s = list(s)
        if len(s) > pad_to:
            s = s[-pad_to:] if left else s[:pad_to]
        if left:
            ids[i, pad_to - len(s):] = s
            mask[i, pad_to - len(s):] = True
        else:
            ids[i, :len(s)] = s
            mask[i, :len(s)] = True
    return ids, mask


class ByteTokenizer:
    """Self-contained tokenizer: UTF-8 bytes offset by `offset`, ids below
    `offset` reserved for specials."""

    def __init__(self, offset: int = 4, bos_token_id: int = 1,
                 eos_token_id: int = 2, pad_token_id: int = 0):
        self.offset = offset
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.vocab_size = 256 + offset

    def encode(self, text: str) -> List[int]:
        return [b + self.offset for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        bs = bytes(i - self.offset for i in ids
                   if i >= self.offset and i - self.offset < 256)
        return bs.decode("utf-8", errors="ignore")
