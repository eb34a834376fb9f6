"""Batch collation for multimodal instruction tuning (port of
`opus_pllm_tpu/data/collate.py`: `collate_instruction_batch` :23 and
`instruction_batches` :74).

RIGHT-padded training batches: the annotation prompt around "<seq>\\n" +
instruction, one `<seq>` sentinel, the answer plus EOS as labels
(IGNORE_INDEX over the prompt and the padding), ESM tokens for the protein
tower (or the precomputed pooled embeddings). numpy arrays out, as in the
JAX package.

`count_positions` counts a collated batch's spliced positions for the
recorder (`utils.observability`): the trainer calls it, which knows how
many soft tokens the protein's sentinel becomes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.config import IGNORE_INDEX
from ..core.util import round_up
from ..infer.conversation import VICUNA_V0, annotation_prompt
from ..infer.tokenization import pad_batch, tokenize_with_seq
from ..models import esm2
from ..utils.observability import count


def collate_instruction_batch(examples: Sequence[dict], tokenizer, *,
                              max_len: Optional[int] = None,
                              prompt_bucket: int = 64,
                              esm_bucket: int = 128,
                              conv=VICUNA_V0) -> Dict[str, np.ndarray]:
    """examples: [{"instruction", "sequence", "output"}] -> {input_ids,
    attn_mask, labels, esm_tokens | pooled_emb}: ids truncated to max_len,
    padded to a multiple of prompt_bucket (at most round_up(max_len,
    prompt_bucket)); ESM tokens padded to a multiple of esm_bucket."""
    ids_list: List[List[int]] = []
    labels_list: List[List[int]] = []
    for ex in examples:
        prompt = annotation_prompt("<seq>\n" + ex["instruction"], conv)
        p_ids = tokenize_with_seq(prompt, tokenizer.encode,
                                  getattr(tokenizer, "bos_token_id", None))
        a_ids = tokenizer.encode(" " + ex["output"])
        eos = getattr(tokenizer, "eos_token_id", None)
        if eos is not None:
            a_ids = a_ids + [eos]
        ids = p_ids + a_ids
        labels = [IGNORE_INDEX] * len(p_ids) + list(a_ids)
        if max_len is not None:
            ids, labels = ids[:max_len], labels[:max_len]
        ids_list.append(ids)
        labels_list.append(labels)

    longest = max(len(x) for x in ids_list)
    pad_to = round_up(longest, prompt_bucket)
    if max_len is not None:
        pad_to = min(pad_to, round_up(max_len, prompt_bucket))
    input_ids, attn = pad_batch(ids_list, tokenizer.pad_token_id,
                                left=False, max_len=pad_to)
    labels, _ = pad_batch(labels_list, IGNORE_INDEX, left=False,
                          max_len=pad_to)
    labels = np.where(attn, labels, IGNORE_INDEX).astype(np.int32)

    out = {"input_ids": input_ids, "attn_mask": attn, "labels": labels}
    if all(ex.get("seq_embedding") is not None for ex in examples):
        out["pooled_emb"] = np.stack(
            [np.asarray(ex["seq_embedding"], np.float32)
             for ex in examples])[:, None, :]
    else:
        aa_len = max(len(ex["sequence"]) for ex in examples) + 2
        esm_toks, _ = esm2.tokenize([ex["sequence"] for ex in examples],
                                    max_len=round_up(aa_len, esm_bucket))
        out["esm_tokens"] = esm_toks[:, None, :]
    return out


def count_positions(batch: Dict, n_tokens: int) -> None:
    """Count a collated batch's spliced positions (host values only):
    `collate.positions` += rows x the spliced length, and
    `collate.positions_live` += those that are not padding, each valid id
    once and the protein's sentinel as its `n_tokens` soft tokens."""
    rows, length = batch["attn_mask"].shape
    count("collate.positions", rows * (length + n_tokens - 1))
    count("collate.positions_live",
          int(batch["attn_mask"].sum()) + rows * (n_tokens - 1))


def instruction_batches(dataset, tokenizer, batch_size: int, *,
                        shuffle: bool = True, seed: int = 0, epochs: int = 1,
                        drop_remainder: bool = True, **collate_kw):
    """Generator of collated batches over an InstructionDataset;
    drop_remainder=False yields the leftover examples as a smaller last
    batch (validation)."""
    from .datasets import batch_iterator

    for idx in batch_iterator(len(dataset), batch_size, shuffle=shuffle,
                              seed=seed, epochs=epochs,
                              drop_remainder=drop_remainder):
        yield collate_instruction_batch([dataset[int(i)] for i in idx],
                                        tokenizer, **collate_kw)
