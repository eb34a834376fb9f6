"""Batch annotation and MCQ eval (port of `opus_pllm_tpu/evals/runner.py`:
the static path `run_annotation_eval` :193, `_prepare_from_ids` :51,
`_prepare_inputs` :65, `_generate_spliced` :130 (greedy / sampled, beam search and the
self-speculative draft), `make_draft` :90, `_prefetched_batches` :440,
`_pad_chunk` :464; the
serving-engine path `run_annotation_eval_engine` :372, `_engine_generate`
:275 (with the LoRA bank, the prefix cache and engine reuse),
`_common_token_prefix` :254, `_check_engine_gen` :249; and the MCQ
runners `run_mcq_eval` :476,
`_mcq_next_logits` :544, `_letter_token_candidates` :554,
`run_mcq_eval_scored` :567, `_logsumexp` / `_logsumexp_ids` :632-644 and
`run_mcq_eval_engine` :646).

Each batch: tokenize the prompts with one `<seq>` sentinel, left-pad them
to a multiple of `prompt_bucket` and the ESM tokens to a multiple of
`esm_bucket`, splice the protein soft tokens into the text embeddings
(`opus.splice_prompt`), generate with the KV-cache engine and cut the text
at "###". Reports entries/sec as the reference does (run_opus_ddp.py:143).

The engine path (CLI `annotate --engine`, `mcq --engine`) splices every
request in static batches, then drives `serve.engine.ServingEngine` to
completion: each sequence ends on its own and the next prompt takes its
slot.

The MCQ runners render each question with the tokenizer's own chat
template where it has one, else VICUNA_V3's ChatML
(eval_run_multichoice.py:61-73), and return {"Accuracy", "OptionCounts"}
(`evals.mcq.score`). `run_mcq_eval_scored` (CLI `mcq --scored`) decodes
nothing: one prefill scores the option letters' first tokens.

After the timed window the annotation runners score the results with
`metrics.compute_metrics` (runner.py:243, :436), BERTScore through
`bert_embed_fn` (e.g. `models.bert.make_embed_fn`) where one is given,
and return the scores in `EvalReport.metrics`; entries/s counts only the
generation, as in the JAX runners.

The static runners prepare each batch (prompts, tokenization, bucket
padding, the copy to the device) on a prefetch thread
(`utils.prefetch`), so batch i + 1 is prepared while batch i generates.
`gen.num_beams > 1` takes `engine.beam_generate`, `gen.draft_layers > 0`
`speculative.speculative_generate` with the layer-skip draft built once a
run (`make_draft`); the engine runners take `draft_layers` as speculative
ticks and refuse beams.

The parallel axes (runner.py:66-85, :109-127, :199-238, :481-534,
:712-745): with `mesh` (core.mesh.Mesh) each data row of ranks takes its
contiguous slice of the examples (`core.mesh.data_slice`), the model
ranks of a row run tensor-parallel over the row's share of the decoder
(the runners shard a whole tree themselves; the CLI loads each rank's
share), the data index folds into each batch's seed, and the results are
gathered in order (`gather_json_blobs` over the mesh, model rank 0 of
each data row contributing); global rank 0 logs, saves and scores.
`seq_mesh` (parallel.ring.SeqMesh) shards each prompt's KV cache over
its ranks instead (`infer.sp_engine`); beams and the static draft are
refused there, as in JAX. The engine runners take a mesh of data 1, and
`data_mesh`: a mesh whose data rows each run their own engine on their
slice of the examples, the results gathered (JAX's engine runners under
several processes: `local_slice` of the set, runner.py:405, :667).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import mesh as mesh_mod
from ..core.config import SEQ_TOKEN_INDEX, GenerationConfig, OpusConfig
from ..core.util import round_up
from ..infer import engine
from ..infer.conversation import (VICUNA_V0, VICUNA_V3, annotation_prompt,
                                  truncate_at_sep)
from ..infer.tokenization import pad_batch, tokenize_with_seq
from ..models import decoder, esm2, opus
from ..utils.observability import count, span
from . import datasets as ds
from . import mcq as mcq_mod
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
    count("esm.rows", esm_toks.shape[0] * esm_toks.shape[1])
    count("esm.rows_residue", sum(len(s) + 2 for s in sequences))
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


def make_draft(params, cfg: OpusConfig, gen: GenerationConfig):
    """The self-speculative layer-skip draft, built once a run: None when
    gen.draft_layers == 0; beam search with a draft is refused
    (runner.py:90-102)."""
    if gen.draft_layers <= 0:
        return None
    if gen.num_beams > 1:
        raise ValueError("--draft-layers with beam search is unsupported")
    from ..infer import speculative
    return speculative.draft_from_target(params["llm"], cfg.llm,
                                         gen.draft_layers)


def _generate_spliced(params, cfg: OpusConfig, tokenizer, ids, mask,
                      esm_toks, gen: GenerationConfig, *, impl: str,
                      batch_index: int, draft=None, seq_mesh=None,
                      data_index: int = 0):
    """Splice -> generate -> decode texts. The sampling generator is seeded
    from (gen.seed, data_index * 100003 + batch_index) so batches and data
    ranks draw independent noise (runner.py:135-136). gen.num_beams > 1:
    beam search; `draft` (make_draft): speculative decoding, the same
    spliced embeddings feeding target and draft; `seq_mesh`: the
    sequence-sharded cache (runner.py:130-176).

    Spans: `runner.batch` around it all, `runner.splice` (device clock)
    and `runner.detokenize`; counters `decode.row_steps` (steps x rows)
    and `decode.row_steps_live` (the tokens the rows generated)."""
    with span("runner.batch", device=ids.device, batch=batch_index,
              rows=ids.shape[0]):
        with span("runner.splice", device=ids.device):
            sp = opus.splice_prompt(params, cfg, ids, mask, esm_toks,
                                    left_pad=True, impl=impl)
        pos = decoder.positions_from_mask(sp.mask)
        g = torch.Generator(device=ids.device)
        g.manual_seed(gen.seed * 1_000_003 + data_index * 100003
                      + batch_index)
        if seq_mesh is not None and gen.num_beams > 1:
            raise ValueError("beam search over a sequence-sharded cache is "
                             "not supported (--seq-shards with --num-beams "
                             "1 only)")
        if seq_mesh is not None and draft is not None:
            raise ValueError("--draft-layers over a sequence-sharded cache "
                             "is unsupported (drop --seq-shards)")
        common = dict(max_new_tokens=gen.max_new_tokens,
                      eos_token_id=gen.eos_token_id,
                      pad_token_id=gen.pad_token_id,
                      quantize_cache=gen.quantize_cache, impl=impl)
        if gen.num_beams > 1:
            out = engine.beam_generate(
                params["llm"], cfg.llm, sp.embeds, sp.mask, pos,
                num_beams=gen.num_beams, length_penalty=gen.length_penalty,
                **common)
        elif seq_mesh is not None:
            from ..infer.sp_engine import generate_seq_sharded
            out = generate_seq_sharded(
                params["llm"], cfg.llm, sp.embeds, sp.mask, pos, g,
                mesh=seq_mesh, max_new_tokens=gen.max_new_tokens,
                temperature=gen.temperature, top_p=gen.top_p,
                eos_token_id=gen.eos_token_id,
                pad_token_id=gen.pad_token_id,
                quantize_cache=gen.quantize_cache)
        elif draft is not None:
            from ..infer import speculative
            dparams, dcfg = draft
            out = speculative.speculative_generate(
                dparams, params["llm"], dcfg, cfg.llm, sp.embeds, sp.embeds,
                sp.mask, pos, n_draft=gen.n_draft,
                temperature=gen.temperature if gen.do_sample else 0.0,
                top_p=gen.top_p if gen.do_sample else 1.0, generator=g,
                **common)
        else:
            out = engine.generate(
                params["llm"], cfg.llm, sp.embeds, sp.mask, pos, g,
                temperature=gen.temperature, top_p=gen.top_p, **common)
        with span("runner.detokenize"):
            toks = out.tokens.cpu().numpy()
            lens = out.lengths.cpu().numpy()
            count("decode.row_steps", out.steps * len(lens))
            count("decode.row_steps_live", int(lens.sum()))
            texts = []
            for row, n in zip(toks, lens):
                ids_out = [int(t) for t in row[:n]
                           if int(t) != gen.eos_token_id]
                texts.append(truncate_at_sep(tokenizer.decode(ids_out)))
        return texts, out


def _prefetched_batches(examples, batch_size: int, prompt_of: Callable,
                        tokenizer, *, prompt_bucket: int, esm_bucket: int,
                        device):
    """(chunk, n_real, batch index, (ids, mask, esm tokens) on `device`)
    for each batch, prepared on the prefetch thread up to two batches
    ahead (runner.py:440-461)."""
    from ..utils.prefetch import prefetch_to_device

    def produce():
        for bi, s in enumerate(range(0, len(examples), batch_size)):
            chunk, n_real = _pad_chunk(examples[s:s + batch_size],
                                       batch_size)
            yield chunk, n_real, bi, _prepare_inputs(
                tokenizer, [prompt_of(e) for e in chunk],
                [e.sequence for e in chunk], prompt_bucket=prompt_bucket,
                esm_bucket=esm_bucket, device=device)

    return prefetch_to_device(produce(), size=2, place=lambda b: b)


def _pad_chunk(chunk, batch_size: int):
    """Pad the last partial batch to `batch_size` by repeating its last
    example (every batch keeps one shape); padded rows are dropped."""
    n_real = len(chunk)
    if 0 < n_real < batch_size:
        chunk = list(chunk) + [chunk[-1]] * (batch_size - n_real)
    return chunk, n_real


@torch.no_grad()
def run_annotation_eval(params, cfg: OpusConfig, tokenizer, file_path: str,
                        *, gen: Optional[GenerationConfig] = None,
                        batch_size: int = 8, prompt_bucket: int = 64,
                        esm_bucket: int = 128, impl: str = "auto",
                        save_path: Optional[str] = None, examples=None,
                        bert_embed_fn=None, mesh=None, seq_mesh=None,
                        log_fn=print) -> EvalReport:
    """Batch annotation eval over one benchmark JSON (the reference's
    run_opus_ddp eval_model). `examples` overrides loading `file_path`;
    the file name still picks the task policy and the metrics. Runs on the
    device that holds the parameters. `mesh` / `seq_mesh`: the parallel
    axes (module docstring); ranks other than 0 return empty metrics."""
    if examples is None:
        examples = ds.load_annotation_json(file_path)
    params, cfg = _tp_share(params, cfg, mesh)
    examples = examples[mesh_mod.data_slice(mesh, len(examples))]
    gen = gen or GenerationConfig(
        max_new_tokens=ds.max_new_tokens_for(file_path),
        eos_token_id=getattr(tokenizer, "eos_token_id", -1),
        pad_token_id=getattr(tokenizer, "pad_token_id", 0))

    t0 = time.perf_counter()
    texts, decode_tokens, decode_seconds = _static_generate(
        params, cfg, tokenizer, examples,
        lambda e: annotation_prompt(ds.instruction_for(e, file_path),
                                    VICUNA_V0),
        gen, batch_size=batch_size, prompt_bucket=prompt_bucket,
        esm_bucket=esm_bucket, impl=impl, mesh=mesh, seq_mesh=seq_mesh)
    results = [{"ground_truth": e.output, "generated": t}
               for e, t in zip(examples, texts)]
    dt = time.perf_counter() - t0

    results = _allgather_results(results, mesh)
    eps, metrics = _report(results, dt, file_path, save_path,
                           bert_embed_fn, log_fn)
    return EvalReport(results, metrics, eps, dt, decode_tokens,
                      decode_seconds)


def _static_generate(params, cfg: OpusConfig, tokenizer, examples,
                     prompt_of: Callable, gen: GenerationConfig, *,
                     batch_size: int, prompt_bucket: int, esm_bucket: int,
                     impl: str, mesh=None, seq_mesh=None
                     ) -> Tuple[List[str], int, float]:
    """The static runners' loop (runner.py:212-226, :513-530): batches of
    `batch_size` (the last one padded), each prompted by `prompt_of` and
    prepared on the prefetch thread (`_prefetched_batches`), spliced and
    generated on the device that holds the parameters -> (one text per
    example, decode steps x batch rows, the decode loops' seconds)."""
    device = params["llm"]["embed_tokens"]["embedding"].device
    draft = make_draft(params, cfg, gen)
    texts = []
    decode_tokens, decode_seconds = 0, 0.0
    for chunk, n_real, bi, (ids, mask, esm_toks) in _prefetched_batches(
            examples, batch_size, prompt_of, tokenizer,
            prompt_bucket=prompt_bucket, esm_bucket=esm_bucket,
            device=device):
        out_texts, out = _generate_spliced(
            params, cfg, tokenizer, ids, mask, esm_toks, gen, impl=impl,
            batch_index=bi, draft=draft, seq_mesh=seq_mesh,
            data_index=mesh.data_index if mesh is not None else 0)
        decode_tokens += out.steps * len(chunk)
        decode_seconds += out.decode_seconds
        texts.extend(out_texts[:n_real])
    return texts, decode_tokens, decode_seconds


def _is_logger() -> bool:
    """Global rank 0 (or a single process): the rank that logs, saves and
    scores (runner.py:238)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _report(results, dt, file_path, save_path, bert_embed_fn, log_fn):
    """After the timed window (runner.py:236-245): entries/s, the results
    saved, the metrics computed and logged (on the logging rank; the
    others get empty metrics)."""
    eps = len(results) / dt if dt > 0 else 0.0
    if not _is_logger():
        return eps, {}
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


def _tp_share(params, cfg: OpusConfig, mesh):
    """This rank's share of a whole tree under `mesh`'s model axis (the
    tree as it is when it is a share already, or at M = 1)."""
    if mesh is None or mesh.model <= 1 or cfg.llm.tp is not None:
        return params, cfg
    from ..parallel import partition
    return partition.shard_params(mesh, params, cfg)


def _engine_mesh(mesh):
    """The engine runners' mesh: tensor-parallel only (cli/main.py:198)."""
    if mesh is not None and mesh.data != 1:
        raise ValueError("the engine shards tensor-parallel only: use a "
                         "mesh of data 1 (--mesh 1,N; the slot pool is the "
                         "batch axis)")
    return mesh


def gather_json_blobs(results: List[dict], process_count: int,
                      process_index: int, allgather_fn) -> List[dict]:
    """Variable-size JSON gather over a fixed-shape allgather primitive
    (runner.py:712): each process serializes its results to a byte blob;
    the blob sizes are allgathered first, every blob is padded to the
    max, allgathered, and sliced back by its true size. `allgather_fn`
    takes a local numpy array and returns the (process_count, ...)
    stack."""
    blob = json.dumps(results).encode()
    arr = np.frombuffer(blob, np.uint8)
    n = np.zeros((process_count,), np.int32)
    n[process_index] = len(arr)
    sizes = np.asarray(allgather_fn(n)).sum(0)
    buf = np.zeros((max(int(sizes.max()), 1),), np.uint8)
    buf[:len(arr)] = arr
    all_bufs = np.asarray(allgather_fn(buf))
    merged: List[dict] = []
    for i in range(process_count):
        merged.extend(json.loads(bytes(all_bufs[i][:int(sizes[i])]).decode()))
    return merged


def _allgather_results(results: List[dict], mesh) -> List[dict]:
    """The data rows' results in order on every rank of the mesh
    (run_opus_ddp.py:138's gather_object): model rank 0 of each data row
    contributes its rows, the others an empty list. Identity without a
    mesh or with one data row."""
    if mesh is None or mesh.data == 1:
        return results
    ranks = [r for row in mesh.ranks for r in row]

    def allgather(a: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
        return torch.stack(mesh_mod.all_gather_list(t, mesh.group)
                           ).cpu().numpy()

    mine = results if mesh.model_index == 0 else []
    return gather_json_blobs(mine, len(ranks), ranks.index(dist.get_rank()),
                             allgather)


def _common_token_prefix(tok_ids: List[list]) -> int:
    """Longest common leading id run across all prompts, cut before a
    splice sentinel (the pinned prefix is computed from plain token
    embeddings) and short enough to leave every prompt at least one
    suffix token (runner.py:254)."""
    first = tok_ids[0]
    common = len(first)
    for ids_l in tok_ids[1:]:
        m = min(common, len(ids_l))
        i = 0
        while i < m and ids_l[i] == first[i]:
            i += 1
        common = i
        if common == 0:
            return 0
    head = first[:common]
    if SEQ_TOKEN_INDEX in head:
        common = head.index(SEQ_TOKEN_INDEX)
    return min(common, min(len(t) for t in tok_ids) - 1)


@torch.no_grad()
def splice_tails(params, cfg: OpusConfig, tokenizer, tok_ids, sequences, *,
                 splice_batch: int, prompt_bucket: int, esm_bucket: int
                 ) -> List[torch.Tensor]:
    """The engine path's splice (runner.py:316-329): the tokenized prompts
    (one `<seq>` sentinel each) and their proteins in static batches of
    `splice_batch` (the last one padded), each row's valid left-padded
    tail kept on the device as that request's prompt (P, H)."""
    device = params["llm"]["embed_tokens"]["embedding"].device
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
    return embeds


def _engine_generate(params, cfg: OpusConfig, tokenizer, prompts, sequences,
                     gen: GenerationConfig, *, max_slots: int,
                     steps_per_tick: int, splice_batch: int,
                     prompt_bucket: int, esm_bucket: int, lora_bank=None,
                     adapter_id=None, engine_cache=None,
                     cache_prefix: bool = False, mesh=None
                     ) -> Tuple[List[List[int]], dict]:
    """Splice every (prompt, protein) pair in batches of `splice_batch`,
    drive the serving engine to completion, return the token lists in input
    order and the engine's numbers (runner.py:275-369).

    lora_bank / adapter_id: every request under one named bank adapter.
    engine_cache (a caller's dict): one engine is reused, reseeded with
    gen.seed, whenever the workload's shape recurs (its key holds what
    shapes the engine; the caller keeps params and bank constant).
    cache_prefix: the prompts' common token prefix (16 tokens or more) is
    prefilled once (`register_prefix`) and every request admits with its
    suffix only; not under an adapter (the pinned prefix holds base-weight
    state). gen.draft_layers / gen.n_draft: speculative ticks. `mesh` (data
    1): the engine runs tensor-parallel over its model ranks."""
    from ..serve.engine import ServeRequest, ServingEngine

    if not prompts:
        return [], {}
    device = params["llm"]["embed_tokens"]["embedding"].device
    bos = getattr(tokenizer, "bos_token_id", None)
    tok_ids = [tokenize_with_seq(p, tokenizer.encode, bos) for p in prompts]
    prefix_id, plen, header = None, 0, None
    if cache_prefix and adapter_id is None:
        common = _common_token_prefix(tok_ids)
        if common >= 16:
            plen = common
            header = tuple(tok_ids[0][:plen])
            # keyed by content: a reused engine registers a new header only
            prefix_id = ("evalpfx",) + header
            tok_ids = [t[plen:] for t in tok_ids]
    # 1) splice in static batches
    embeds = splice_tails(params, cfg, tokenizer, tok_ids, sequences,
                          splice_batch=splice_batch,
                          prompt_bucket=prompt_bucket, esm_bucket=esm_bucket)

    # 2) size the engine to the workload: buckets up to the longest
    #    (suffix) prompt, capacity = prefix + largest bucket + budget
    longest = max(e.shape[0] for e in embeds)
    buckets = tuple(b for b in (64, 128, 256, 512, 1024, 2048)
                    if b < longest) + (round_up(longest, 64),)
    max_len = plen + buckets[-1] + gen.max_new_tokens
    ck = (buckets, max_len, max_slots, steps_per_tick, gen.quantize_cache,
          mesh is not None, gen.draft_layers, gen.n_draft)
    eng = engine_cache.get(ck) if engine_cache is not None else None
    if eng is None:
        eng = ServingEngine(params["llm"], cfg.llm, max_slots=max_slots,
                            max_len=max_len, prefill_buckets=buckets,
                            steps_per_tick=steps_per_tick,
                            quantize_cache=gen.quantize_cache, seed=gen.seed,
                            lora_bank=lora_bank, mesh=mesh,
                            draft_layers=gen.draft_layers or None,
                            spec_k=gen.n_draft)
        if engine_cache is not None:
            engine_cache[ck] = eng
    else:
        eng.reseed(gen.seed)
    if prefix_id is not None and prefix_id not in eng._prefixes:
        eng.register_prefix(prefix_id,
                            token_ids=np.asarray(header, np.int64))
    counters0, tick0 = dict(eng.counters), eng._tick
    engine._sync(device)
    t0 = time.perf_counter()
    done = eng.run([ServeRequest(i, embeds=e,
                                 max_new_tokens=gen.max_new_tokens,
                                 temperature=gen.temperature,
                                 top_p=gen.top_p if gen.do_sample else 1.0,
                                 eos_token_id=gen.eos_token_id,
                                 adapter_id=adapter_id,
                                 prefix_id=prefix_id)
                    for i, e in enumerate(embeds)])
    engine._sync(device)
    ttft = eng.latency["ttft"]
    ticks = eng._tick - tick0
    # this call's counts (a reused engine carries earlier calls' too)
    stats = {k: v - counters0[k] for k, v in eng.counters.items()}
    stats.update(seconds=time.perf_counter() - t0, ticks=ticks,
                 decode_steps=ticks * eng.steps_per_tick,
                 prefix_tokens=plen,
                 ttft_p50=ttft.percentile(0.5),
                 ttft_p99=ttft.percentile(0.99), ttft_mean=ttft.mean)
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
                               bert_embed_fn=None, data_mesh=None,
                               log_fn=print) -> EvalReport:
    """Annotation eval through the continuous-batching serving engine (CLI
    `annotate --engine`, defaults 16 slots and 4 steps a tick). Greedy
    output is token-identical to `run_annotation_eval`; T > 0 samples with
    per-request temperature and top_p. Runs on the device that holds the
    parameters. `decode_tokens` / `decode_seconds` are the engine's tokens
    and wall time, `engine` its counters and TTFT percentiles. `lora_bank`
    ({name: folded adapter tree}) with `adapter_id` runs the set under one
    bank adapter; `engine_cache`, `cache_prefix` and gen.draft_layers as
    in `_engine_generate`; `data_mesh` as in the module docstring."""
    if examples is None:
        examples = ds.load_annotation_json(file_path)
    examples = examples[mesh_mod.data_slice(data_mesh, len(examples))]
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
        esm_bucket=esm_bucket, lora_bank=lora_bank, adapter_id=adapter_id,
        engine_cache=engine_cache, cache_prefix=cache_prefix,
        mesh=_engine_mesh(mesh))
    results = [{"ground_truth": e.output,
                "generated": truncate_at_sep(tokenizer.decode(toks))}
               for e, toks in zip(examples, done)]
    dt = time.perf_counter() - t0

    results = _allgather_results(results, data_mesh)
    eps, metrics = _report(results, dt, file_path, save_path,
                           bert_embed_fn, log_fn)
    return EvalReport(results, metrics, eps, dt, stats.get("tokens", 0),
                      stats.get("seconds", 0.0), stats)


def _mcq_renderer(tokenizer, render_prompt: Optional[Callable]):
    """The MCQ prompt rendering (runner.py:490-499): the tokenizer's own
    chat template where it has one, else VICUNA_V3's ChatML."""
    if render_prompt is not None:
        return render_prompt

    def default_render(instr: str) -> str:
        messages = [{"role": "system", "content": VICUNA_V3.system},
                    {"role": "user", "content": "<seq>\n" + instr}]
        if hasattr(tokenizer, "apply_chat_template"):
            return tokenizer.apply_chat_template(
                messages, add_generation_prompt=True)
        conv = VICUNA_V3.copy()
        conv.append("user", "<seq>\n" + instr)
        return conv.get_prompt_chatml(add_generation_prompt=True)

    return default_render


def _mcq_gen(tokenizer, gen: Optional[GenerationConfig]) -> GenerationConfig:
    return gen or GenerationConfig(
        max_new_tokens=50,
        eos_token_id=getattr(tokenizer, "eos_token_id", -1),
        pad_token_id=getattr(tokenizer, "pad_token_id", 0))


def _mcq_report(results, dt, save_path, log_fn):
    """Accuracy and the option histogram, logged and saved after the timed
    window (runner.py:532-541) -> (entries/s, metrics)."""
    acc, counts = mcq_mod.score(results)
    eps = len(results) / dt if dt > 0 else 0.0
    if not _is_logger():
        return eps, {"Accuracy": round(acc, 4), "OptionCounts": counts}
    log_fn(f"{counts}")
    log_fn(f"Accuracy: {acc * 100:.2f}%  entries/sec: {eps:.3f}")
    if save_path:
        with open(save_path, "w") as f:
            json.dump(results, f, indent=1)
    return eps, {"Accuracy": round(acc, 4), "OptionCounts": counts}


@torch.no_grad()
def run_mcq_eval(params, cfg: OpusConfig, tokenizer, file_path: str, *,
                 gen: Optional[GenerationConfig] = None, batch_size: int = 8,
                 prompt_bucket: int = 64, esm_bucket: int = 128,
                 impl: str = "auto", render_prompt: Optional[Callable] = None,
                 examples=None, save_path: Optional[str] = None,
                 mesh=None, seq_mesh=None, log_fn=print) -> EvalReport:
    """MCQ eval (the reference's eval_run_multichoice eval_model): the
    chat-template prompt, 50 new tokens by default, option-letter accuracy
    and histogram. Runs on the device that holds the parameters; `mesh` /
    `seq_mesh` as in `run_annotation_eval`."""
    if examples is None:
        examples = ds.load_mcq_json(file_path)
    params, cfg = _tp_share(params, cfg, mesh)
    examples = examples[mesh_mod.data_slice(mesh, len(examples))]
    gen = _mcq_gen(tokenizer, gen)
    render = _mcq_renderer(tokenizer, render_prompt)

    t0 = time.perf_counter()
    texts, decode_tokens, decode_seconds = _static_generate(
        params, cfg, tokenizer, examples,
        lambda e: render(ds.mcq_prompt(e.question, e.options)), gen,
        batch_size=batch_size, prompt_bucket=prompt_bucket,
        esm_bucket=esm_bucket, impl=impl, mesh=mesh, seq_mesh=seq_mesh)
    results = [{"ground_truth": e.answer, "generated": t}
               for e, t in zip(examples, texts)]
    dt = time.perf_counter() - t0
    results = _allgather_results(results, mesh)
    eps, metrics = _mcq_report(results, dt, save_path, log_fn)
    return EvalReport(results, metrics, eps, dt, decode_tokens,
                      decode_seconds)


@torch.no_grad()
def _mcq_next_logits(params, cfg: OpusConfig, ids, mask, esm_toks,
                     impl: str = "auto"):
    """Left-padded spliced forward -> fp32 next-token logits (B, V) at the
    final (rightmost valid) position. The head runs on that position only:
    it works per position, so this is the JAX function's `logits[:, -1]`
    without the (B, L, V) logits."""
    hid, _ = opus.forward(params, cfg, ids, mask, esm_toks, left_pad=True,
                          return_hidden=True, impl=impl)
    return decoder.head_logits(params["llm"], cfg.llm, hid[:, -1:],
                               impl=impl)[:, 0].float()


def _letter_token_candidates(tokenizer, letter: str) -> List[int]:
    """First-token ids that start an answer of this option letter: the
    bare letter and the space-prefixed variant (BPE commonly merges the
    leading space into the letter token)."""
    bos = getattr(tokenizer, "bos_token_id", None)
    cands = []
    for text in (letter, " " + letter):
        ids = [i for i in tokenizer.encode(text) if i != bos]
        if ids and ids[0] not in cands:
            cands.append(ids[0])
    return cands


def run_mcq_eval_scored(params, cfg: OpusConfig, tokenizer, file_path: str,
                        *, batch_size: int = 8, prompt_bucket: int = 64,
                        esm_bucket: int = 128, impl: str = "auto",
                        render_prompt: Optional[Callable] = None,
                        examples=None, save_path: Optional[str] = None,
                        mesh=None, log_fn=print) -> EvalReport:
    """Scored MCQ eval (CLI `mcq --scored`): one prefill forward a batch
    scores the option letters, and the answer is the option whose letter
    is the likeliest first generated token (log P summed over its
    candidate first tokens). Deterministic and regex-free; the results
    carry the chosen letter, so `mcq.score` applies. `mesh` as in
    `run_annotation_eval` (the JAX runner slices by process,
    runner.py:588)."""
    if examples is None:
        examples = ds.load_mcq_json(file_path)
    params, cfg = _tp_share(params, cfg, mesh)
    examples = examples[mesh_mod.data_slice(mesh, len(examples))]
    render = _mcq_renderer(tokenizer, render_prompt)
    device = params["llm"]["embed_tokens"]["embedding"].device
    letters = "ABCD"
    cand_ids = {c: _letter_token_candidates(tokenizer, c) for c in letters}
    results = []
    t0 = time.perf_counter()
    for s in range(0, len(examples), batch_size):
        chunk, n_real = _pad_chunk(examples[s:s + batch_size], batch_size)
        prompts = [render(ds.mcq_prompt(e.question, e.options))
                   for e in chunk]
        ids, mask, esm_toks = _prepare_inputs(
            tokenizer, prompts, [e.sequence for e in chunk],
            prompt_bucket=prompt_bucket, esm_bucket=esm_bucket,
            device=device)
        lg = _mcq_next_logits(params, cfg, ids, mask, esm_toks,
                              impl=impl).cpu().numpy()
        logp = lg - _logsumexp(lg)
        for r, e in enumerate(chunk[:n_real]):
            opts = letters[:len(e.options)] or "ABCD"
            best = max(opts, key=lambda c: _logsumexp_ids(
                logp[r], cand_ids[c]))
            results.append({"ground_truth": e.answer, "generated": best})
    dt = time.perf_counter() - t0
    results = _allgather_results(results, mesh)
    eps, metrics = _mcq_report(results, dt, save_path, log_fn)
    return EvalReport(results, metrics, eps, dt)


def _logsumexp(lg: np.ndarray) -> np.ndarray:
    m = lg.max(axis=-1, keepdims=True)
    return m + np.log(np.sum(np.exp(lg - m), axis=-1, keepdims=True))


def _logsumexp_ids(logp_row: np.ndarray, ids: List[int]) -> float:
    """log P(any of these first tokens) from a log-softmax row."""
    if not ids:
        return -np.inf
    xs = logp_row[np.asarray(ids)]
    m = float(xs.max())
    return m + float(np.log(np.sum(np.exp(xs - m))))


@torch.no_grad()
def run_mcq_eval_engine(params, cfg: OpusConfig, tokenizer, file_path: str,
                        *, gen: Optional[GenerationConfig] = None,
                        max_slots: int = 16, steps_per_tick: int = 4,
                        splice_batch: int = 8, prompt_bucket: int = 64,
                        esm_bucket: int = 128,
                        render_prompt: Optional[Callable] = None,
                        examples=None, save_path: Optional[str] = None,
                        lora_bank=None, adapter_id: Optional[str] = None,
                        engine_cache: Optional[dict] = None,
                        mesh=None, cache_prefix: bool = False,
                        data_mesh=None, log_fn=print) -> EvalReport:
    """MCQ eval through the continuous-batching engine (CLI `mcq
    --engine`): the static runner's prompts and scoring, each question
    finishing on its own. Greedy output is token-identical to
    `run_mcq_eval`. `decode_tokens` / `decode_seconds` are the engine's
    tokens and wall time, `engine` its counters and TTFT percentiles. The
    engine options and `data_mesh` as in `run_annotation_eval_engine`."""
    if examples is None:
        examples = ds.load_mcq_json(file_path)
    examples = examples[mesh_mod.data_slice(data_mesh, len(examples))]
    gen = _mcq_gen(tokenizer, gen)
    _check_engine_gen(gen)
    render = _mcq_renderer(tokenizer, render_prompt)

    t0 = time.perf_counter()
    prompts = [render(ds.mcq_prompt(e.question, e.options))
               for e in examples]
    done, stats = _engine_generate(
        params, cfg, tokenizer, prompts, [e.sequence for e in examples], gen,
        max_slots=max_slots, steps_per_tick=steps_per_tick,
        splice_batch=splice_batch, prompt_bucket=prompt_bucket,
        esm_bucket=esm_bucket, lora_bank=lora_bank, adapter_id=adapter_id,
        engine_cache=engine_cache, cache_prefix=cache_prefix,
        mesh=_engine_mesh(mesh))
    results = [{"ground_truth": e.answer,
                "generated": tokenizer.decode(toks)}
               for e, toks in zip(examples, done)]
    dt = time.perf_counter() - t0
    results = _allgather_results(results, data_mesh)
    eps, metrics = _mcq_report(results, dt, save_path, log_fn)
    return EvalReport(results, metrics, eps, dt, stats.get("tokens", 0),
                      stats.get("seconds", 0.0), stats)
