"""Batch annotation eval (port of `opus_pllm_tpu/evals/runner.py`: the
static path `run_annotation_eval` :193, `_prepare_from_ids` :51,
`_prepare_inputs` :65, `_generate_spliced` :130, `_pad_chunk` :464; and
the serving-engine path `run_annotation_eval_engine` :372,
`_engine_generate` :275, `_check_engine_gen` :249).

Each batch: tokenize the annotation prompts with one `<seq>` sentinel,
left-pad them to a multiple of `prompt_bucket` and the ESM tokens to a
multiple of `esm_bucket`, splice the protein soft tokens into the text
embeddings (`opus.splice_prompt`), generate with the KV-cache engine and
cut the text at "###". Reports entries/sec as the reference does
(run_opus_ddp.py:143).

The engine path (CLI `annotate --engine`) splices every request in
static batches, then drives `serve.engine.ServingEngine` to completion:
each sequence ends on its own and the next prompt takes its slot.

After the timed window both runners score the results with
`metrics.compute_metrics` (runner.py:243, :436), BERTScore through
`bert_embed_fn` (e.g. `models.bert.make_embed_fn`) where one is given,
and return the scores in `EvalReport.metrics`; entries/s counts only the
generation, as in the JAX runners.

Not ported yet (ROADMAP.md): beam search, the speculative draft, the
device meshes, the prefetch thread, multi-host gathering, and the engine's
prefix cache, LoRA bank and engine reuse.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..core.config import GenerationConfig, OpusConfig
from ..core.util import round_up
from ..infer import engine
from ..infer.conversation import VICUNA_V0, annotation_prompt, truncate_at_sep
from ..infer.tokenization import pad_batch, tokenize_with_seq
from ..models import decoder, esm2, opus
from . import datasets as ds
from .metrics import compute_metrics


@dataclass
class EvalReport:
    results: List[dict]
    metrics: dict
    entries_per_sec: float
    seconds: float
    # static path: decode steps x batch rows, and the decode loops' wall
    # time; engine path: tokens generated, and the engine's wall time
    decode_tokens: int = 0
    decode_seconds: float = 0.0
    engine: Optional[dict] = None  # engine path: counters and TTFTs


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
        pad_token_id=gen.pad_token_id, quantize_cache=gen.quantize_cache,
        impl=impl)
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
    if gen.num_beams > 1 or gen.draft_layers > 0:
        raise NotImplementedError(
            "beam search and speculative drafts are not ported yet")


@torch.no_grad()
def run_annotation_eval(params, cfg: OpusConfig, tokenizer, file_path: str,
                        *, gen: Optional[GenerationConfig] = None,
                        batch_size: int = 8, prompt_bucket: int = 64,
                        esm_bucket: int = 128, impl: str = "auto",
                        save_path: Optional[str] = None, examples=None,
                        bert_embed_fn=None, log_fn=print) -> EvalReport:
    """Batch annotation eval over one benchmark JSON (the reference's
    run_opus_ddp eval_model). `examples` overrides loading `file_path`;
    the file name still picks the task policy and the metrics. Runs on the
    device that holds the parameters."""
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

    eps, metrics = _report(results, dt, file_path, save_path,
                           bert_embed_fn, log_fn)
    return EvalReport(results, metrics, eps, dt, decode_tokens,
                      decode_seconds)


def _report(results, dt, file_path, save_path, bert_embed_fn, log_fn):
    """After the timed window (runner.py:236-245): entries/s, the results
    saved, the metrics computed and logged."""
    eps = len(results) / dt if dt > 0 else 0.0
    log_fn(f"entries/sec: {eps:.3f}, time elapsed: {dt:.1f}s")
    if save_path:
        with open(save_path, "w") as f:
            json.dump(results, f, indent=1)
    metrics = compute_metrics(results, file_path, bert_embed_fn=bert_embed_fn)
    log_fn(str(metrics))
    return eps, metrics


def _check_engine_gen(gen: GenerationConfig) -> None:
    if gen.num_beams > 1:
        raise ValueError("beam search needs the static path (drop --engine)")
    if gen.draft_layers > 0:
        from ..serve.engine import not_ported
        raise not_ported("draft_layers (speculative ticks)")


def _engine_generate(params, cfg: OpusConfig, tokenizer, prompts, sequences,
                     gen: GenerationConfig, *, max_slots: int,
                     steps_per_tick: int, splice_batch: int,
                     prompt_bucket: int, esm_bucket: int
                     ) -> Tuple[List[List[int]], dict]:
    """Splice every (prompt, protein) pair in batches of `splice_batch`,
    drive the serving engine to completion, return the token lists in input
    order and the engine's numbers (runner.py:275-369 without the prefix
    cache, LoRA bank, mesh and engine reuse)."""
    from ..serve.engine import ServeRequest, ServingEngine

    if not prompts:
        return [], {}
    device = params["llm"]["embed_tokens"]["embedding"].device
    bos = getattr(tokenizer, "bos_token_id", None)
    tok_ids = [tokenize_with_seq(p, tokenizer.encode, bos) for p in prompts]
    # 1) splice in static batches; each row's valid (left-padded) tail
    #    stays on the device as that request's prompt
    embeds = []
    for s in range(0, len(tok_ids), splice_batch):
        pch, n_real = _pad_chunk(tok_ids[s:s + splice_batch], splice_batch)
        sch, _ = _pad_chunk(sequences[s:s + splice_batch], splice_batch)
        ids, mask, esm_toks = _prepare_from_ids(
            tokenizer, pch, sch, prompt_bucket=prompt_bucket,
            esm_bucket=esm_bucket, device=device)
        sp = opus.splice_prompt_left(params, cfg, ids, mask, esm_toks)
        valid = sp.mask.cpu()
        embeds.extend(sp.embeds[r, valid[r].nonzero()[:, 0].to(device)]
                      for r in range(n_real))

    # 2) size the engine to the workload: buckets up to the longest
    #    prompt, capacity = largest bucket + budget
    longest = max(e.shape[0] for e in embeds)
    buckets = tuple(b for b in (64, 128, 256, 512, 1024, 2048)
                    if b < longest) + (round_up(longest, 64),)
    eng = ServingEngine(params["llm"], cfg.llm, max_slots=max_slots,
                        max_len=buckets[-1] + gen.max_new_tokens,
                        prefill_buckets=buckets,
                        steps_per_tick=steps_per_tick,
                        quantize_cache=gen.quantize_cache, seed=gen.seed)
    engine._sync(device)
    t0 = time.perf_counter()
    done = eng.run([ServeRequest(i, embeds=e,
                                 max_new_tokens=gen.max_new_tokens,
                                 temperature=gen.temperature,
                                 top_p=gen.top_p if gen.do_sample else 1.0,
                                 eos_token_id=gen.eos_token_id)
                    for i, e in enumerate(embeds)])
    engine._sync(device)
    ttft = eng.latency["ttft"]
    stats = dict(eng.counters, seconds=time.perf_counter() - t0,
                 ticks=eng._tick,
                 decode_steps=eng._tick * eng.steps_per_tick,
                 ttft_p50=ttft.percentile(0.5), ttft_p99=ttft.percentile(0.99),
                 ttft_mean=ttft.mean)
    return [done[i].tokens for i in range(len(embeds))], stats


@torch.no_grad()
def run_annotation_eval_engine(params, cfg: OpusConfig, tokenizer,
                               file_path: str, *,
                               gen: Optional[GenerationConfig] = None,
                               max_slots: int = 16, steps_per_tick: int = 4,
                               splice_batch: int = 8, prompt_bucket: int = 64,
                               esm_bucket: int = 128,
                               save_path: Optional[str] = None,
                               examples=None, lora_bank=None,
                               adapter_id: Optional[str] = None,
                               engine_cache: Optional[dict] = None,
                               mesh=None, cache_prefix: bool = False,
                               bert_embed_fn=None,
                               log_fn=print) -> EvalReport:
    """Annotation eval through the continuous-batching serving engine (CLI
    `annotate --engine`, defaults 16 slots and 4 steps a tick). Greedy
    output is token-identical to `run_annotation_eval`; T > 0 samples with
    per-request temperature and top_p. Runs on the device that holds the
    parameters. `decode_tokens` / `decode_seconds` are the engine's tokens
    and wall time, `engine` its counters and TTFT percentiles."""
    from ..serve.engine import not_ported
    for what, asked in (
            ("lora_bank / adapter_id (the LoRA bank)",
             lora_bank is not None or adapter_id is not None),
            ("engine_cache (engine reuse)", engine_cache is not None),
            ("mesh", mesh is not None),
            ("cache_prefix (the prefix cache)", cache_prefix)):
        if asked:
            raise not_ported(what)
    if examples is None:
        examples = ds.load_annotation_json(file_path)
    gen = gen or GenerationConfig(
        max_new_tokens=ds.max_new_tokens_for(file_path),
        eos_token_id=getattr(tokenizer, "eos_token_id", -1),
        pad_token_id=getattr(tokenizer, "pad_token_id", 0))
    _check_engine_gen(gen)

    t0 = time.perf_counter()
    prompts = [annotation_prompt(ds.instruction_for(e, file_path),
                                 VICUNA_V0) for e in examples]
    done, stats = _engine_generate(
        params, cfg, tokenizer, prompts, [e.sequence for e in examples], gen,
        max_slots=max_slots, steps_per_tick=steps_per_tick,
        splice_batch=splice_batch, prompt_bucket=prompt_bucket,
        esm_bucket=esm_bucket)
    results = [{"ground_truth": e.output,
                "generated": truncate_at_sep(tokenizer.decode(toks))}
               for e, toks in zip(examples, done)]
    dt = time.perf_counter() - t0

    eps, metrics = _report(results, dt, file_path, save_path,
                           bert_embed_fn, log_fn)
    return EvalReport(results, metrics, eps, dt, stats.get("tokens", 0),
                      stats.get("seconds", 0.0), stats)
