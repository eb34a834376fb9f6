"""Batch annotation eval (port of the static path of
`opus_pllm_tpu/evals/runner.py`: `run_annotation_eval` :193,
`_prepare_from_ids` :51, `_prepare_inputs` :65, `_generate_spliced` :130,
`_pad_chunk` :464).

Each batch: tokenize the annotation prompts with one `<seq>` sentinel,
left-pad them to a multiple of `prompt_bucket` and the ESM tokens to a
multiple of `esm_bucket`, splice the protein soft tokens into the text
embeddings (`opus.splice_prompt`), generate with the KV-cache engine and
cut the text at "###". Reports entries/sec as the reference does
(run_opus_ddp.py:143).

Not ported yet (ROADMAP.md): beam search, the speculative draft, the
device meshes, the prefetch thread, multi-host gathering and
`compute_metrics` (its scorers need nltk and rouge_score); `metrics` is
returned empty.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..core.config import GenerationConfig, OpusConfig
from ..core.util import round_up
from ..infer import engine
from ..infer.conversation import VICUNA_V0, annotation_prompt, truncate_at_sep
from ..infer.tokenization import pad_batch, tokenize_with_seq
from ..models import decoder, esm2, opus
from . import datasets as ds


@dataclass
class EvalReport:
    results: List[dict]
    metrics: dict
    entries_per_sec: float
    seconds: float
    decode_tokens: int = 0        # decode steps x batch rows, all batches
    decode_seconds: float = 0.0   # wall time inside the decode loops


def _prepare_from_ids(tokenizer, tok_ids, sequences, *, prompt_bucket: int,
                      esm_bucket: int, device):
    """Tokenized prompts + proteins -> bucket-padded tensors on `device`:
    ids/mask (B, L), ESM tokens (B, 1, L_aa)."""
    longest = max(len(t) for t in tok_ids)
    ids, mask = pad_batch(tok_ids, tokenizer.pad_token_id, left=True,
                          max_len=round_up(longest, prompt_bucket))
    aa_len = max(len(s) for s in sequences) + 2
    esm_toks, _ = esm2.tokenize(list(sequences),
                                max_len=round_up(aa_len, esm_bucket))
    to = lambda a: torch.from_numpy(a).to(device)
    return to(ids), to(mask), to(esm_toks)[:, None]


def _prepare_inputs(tokenizer, prompts, sequences, *, prompt_bucket: int,
                    esm_bucket: int, device):
    tok_ids = [tokenize_with_seq(p, tokenizer.encode,
                                 getattr(tokenizer, "bos_token_id", None))
               for p in prompts]
    return _prepare_from_ids(tokenizer, tok_ids, sequences,
                             prompt_bucket=prompt_bucket,
                             esm_bucket=esm_bucket, device=device)


def _generate_spliced(params, cfg: OpusConfig, tokenizer, ids, mask,
                      esm_toks, gen: GenerationConfig, *, impl: str,
                      batch_index: int):
    """Splice -> generate -> decode texts. The sampling generator is seeded
    from (gen.seed, batch_index) so batches draw independent noise."""
    sp = opus.splice_prompt(params, cfg, ids, mask, esm_toks, left_pad=True,
                            impl=impl)
    pos = decoder.positions_from_mask(sp.mask)
    g = torch.Generator(device=ids.device)
    g.manual_seed(gen.seed * 1_000_003 + batch_index)
    out = engine.generate(
        params["llm"], cfg.llm, sp.embeds, sp.mask, pos, g,
        max_new_tokens=gen.max_new_tokens, temperature=gen.temperature,
        top_p=gen.top_p, eos_token_id=gen.eos_token_id,
        pad_token_id=gen.pad_token_id)
    toks = out.tokens.cpu().numpy()
    lens = out.lengths.cpu().numpy()
    texts = []
    for row, n in zip(toks, lens):
        ids_out = [int(t) for t in row[:n] if int(t) != gen.eos_token_id]
        texts.append(truncate_at_sep(tokenizer.decode(ids_out)))
    return texts, out


def _pad_chunk(chunk, batch_size: int):
    """Pad the last partial batch to `batch_size` by repeating its last
    example (every batch keeps one shape); padded rows are dropped."""
    n_real = len(chunk)
    if 0 < n_real < batch_size:
        chunk = list(chunk) + [chunk[-1]] * (batch_size - n_real)
    return chunk, n_real


def _check_gen(gen: GenerationConfig) -> None:
    if gen.num_beams > 1 or gen.draft_layers > 0 or gen.quantize_cache:
        raise NotImplementedError(
            "beam search, speculative drafts and quantized KV caches are "
            "not ported yet")


@torch.no_grad()
def run_annotation_eval(params, cfg: OpusConfig, tokenizer, file_path: str,
                        *, gen: Optional[GenerationConfig] = None,
                        batch_size: int = 8, prompt_bucket: int = 64,
                        esm_bucket: int = 128, impl: str = "auto",
                        save_path: Optional[str] = None, examples=None,
                        log_fn=print) -> EvalReport:
    """Batch annotation eval over one benchmark JSON (the reference's
    run_opus_ddp eval_model). `examples` overrides loading `file_path`;
    the file name still picks the task policy. Runs on the device that
    holds the parameters."""
    if examples is None:
        examples = ds.load_annotation_json(file_path)
    gen = gen or GenerationConfig(
        max_new_tokens=ds.max_new_tokens_for(file_path),
        eos_token_id=getattr(tokenizer, "eos_token_id", -1),
        pad_token_id=getattr(tokenizer, "pad_token_id", 0))
    _check_gen(gen)
    device = params["llm"]["embed_tokens"]["embedding"].device

    results = []
    decode_tokens, decode_seconds = 0, 0.0
    t0 = time.perf_counter()
    for bi, s in enumerate(range(0, len(examples), batch_size)):
        chunk, n_real = _pad_chunk(examples[s:s + batch_size], batch_size)
        prompts = [annotation_prompt(ds.instruction_for(e, file_path),
                                     VICUNA_V0) for e in chunk]
        ids, mask, esm_toks = _prepare_inputs(
            tokenizer, prompts, [e.sequence for e in chunk],
            prompt_bucket=prompt_bucket, esm_bucket=esm_bucket,
            device=device)
        texts, out = _generate_spliced(params, cfg, tokenizer, ids, mask,
                                       esm_toks, gen, impl=impl,
                                       batch_index=bi)
        decode_tokens += out.steps * len(chunk)
        decode_seconds += out.decode_seconds
        results.extend({"ground_truth": e.output, "generated": t}
                       for e, t in zip(chunk[:n_real], texts[:n_real]))
    dt = time.perf_counter() - t0

    eps = len(results) / dt if dt > 0 else 0.0
    log_fn(f"entries/sec: {eps:.3f}, time elapsed: {dt:.1f}s")
    if save_path:
        with open(save_path, "w") as f:
            json.dump(results, f, indent=1)
    return EvalReport(results, {}, eps, dt, decode_tokens, decode_seconds)
