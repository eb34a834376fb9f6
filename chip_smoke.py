#!/usr/bin/env python3
"""Drive the PyTorch port's annotation-eval path once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; the first failure exits non-zero
and prints no result:
  1. device: needs torch.cuda.is_available(); prints `nvidia-smi`'s card
     name and power limit;
  2. build: compiles each opus_pllm_tpu_torch/csrc/*.cu with its own nvcc
     (sm_90a), all started together, and prints the build times and the
     compiler's register report;
  3. kernels: each kernel against its plain PyTorch version on the same
     inputs. Passes when
     max|kernel - plain_fp32| <= 2 * max|plain_bf16 - plain_fp32| + ATOL,
     where plain_fp32 runs the plain version on the same inputs in fp32,
     plain_bf16 in bf16 (its error is the rounding the bf16 formats force),
     and ATOL = 4e-3 (half a bf16 ulp at magnitude 1-2) covers the kernels'
     other summation order. Prints kernel and plain device times (the host
     held behind a queued device sleep) and the kernel's time per call as
     the host issues it. Shapes:
       - the four fused-encoder kernels at the annotate path's shapes (B=8,
         S in {128, 512}, E=1280, H=20, F=5120, bf16, padded key rows);
       - int4_matmul at M = 8 for each distinct (K, N) of a Llama-3-8B
         decode step: 4096->4096, 4096->1024, 4096->14336, 14336->4096,
         4096->128256 (random weights quantized by quant4.quantize_grouped);
       - decode_attention_int8 / _int4 at B=8, Hq=32, Hkv=8, D=128 over a
         391-slot cache (the annotate decode capacity), and at B=32 over
         2048 slots;
  4. slice: OpusConfig() at full width (ESM2-650M and Llama-3-8B in bf16,
     CSTP 1280->5120 and the mlp2x_gelu switch 5120->8x4096 in fp32, random
     weights drawn on the card from a seeded torch.Generator) answers 16
     synthetic keywords-task requests through
     evals.runner.run_annotation_eval (batch 8, T=0.1, top_p=0.7, 64 new
     tokens, ByteTokenizer). Checks that every encoder kernel's launch
     count rose by 33 x batches (and no quantized kernel ran), that ESM2's
     pooled embedding through the kernels agrees with the plain layer
     composition on two proteins, and that the decoder's logits are
     finite; prints entries/s and decode tok/s;
  5. quantized slice: the same LLM quantized by quant4.quantize_decoder4
     (int4 v2 words, fp32 group scales; the bf16 projections are freed)
     answers the same 16 requests with an int4 KV cache, then one batch of
     8 with an int8 cache. Checks exact launch counts, each derived from
     the dispatch and the decode steps run (prefill projections have
     M = 8 x 327 > 64 rows and take the dequantize route, the prefill head
     and every decode projection and head the kernel):
       int4_matmul = batches + steps x (32 x 7 + 1),
       decode_attention_<cache> = steps x 32, the other one 0,
       encoder kernels = 33 x batches;
     and that one decode step's logits through the kernels (impl="auto")
     stay within 2 * (plain bf16 error) + ATOL of the plain path run in
     fp32, next to the plain path in bf16 (impl="torch"). Prints entries/s,
     decode tok/s, ms per decode step and GiB on the card.
The last two lines: a JSON object of the kernels' numbers, then
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ATOL = 4e-3
SEED = 0
B, E, H, F = 8, 1280, 20, 5120
TPU_KERNELS = {   # the Pallas call each CUDA kernel replaces
    "ln_qkv_rope": "opus_pllm_tpu/kernels/fused_encoder.py:107",
    "encoder_attention": "opus_pllm_tpu/kernels/fused_encoder.py:228",
    "out_proj": "opus_pllm_tpu/kernels/fused_encoder.py:380",
    "ffn": "opus_pllm_tpu/kernels/fused_encoder.py:323",
}
QUANT_KERNELS = {
    "int4_matmul": ("opus_pllm_tpu/kernels/quant4.py:392",
                    "opus_pllm_tpu_torch/csrc/int4_matmul.cu"),
    "decode_attention_int8": (
        "opus_pllm_tpu/kernels/decode_attention.py:126",
        "opus_pllm_tpu_torch/csrc/decode_attention.cu"),
    "decode_attention_int4": (
        "opus_pllm_tpu/kernels/decode_attention.py:234",
        "opus_pllm_tpu_torch/csrc/decode_attention.cu"),
}
SOURCE = "opus_pllm_tpu_torch/csrc/fused_encoder.cu"
INT4_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
               (4096, 128256))          # (K, N) of one Llama-3-8B decode step
ATTN_SHAPES = ((8, 391), (32, 2048))    # (B, capacity); Hq 32, Hkv 8, D 128


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(msg):
    print(f"== {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, hold=True):
    """Mean ms per call between CUDA events around `iters` calls, after 3
    warm-up calls. hold=True first queues a ~50 ms sleep on the device so
    that the host has enqueued every call before the device reaches them:
    the device's time for the calls. hold=False times the calls as the
    host issues them, which is the per-call cost where the host's launch
    rate is the slower side."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(100_000_000)     # ~50 ms of device clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def reset_counts():
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.kernels import quant4
    for mod in (fe, quant4, da):
        mod.reset_launches()


def read_counts():
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.kernels import quant4
    return {**fe.launches, **quant4.launches, **da.launches}


def compare(name, kern, plain, bf_in, card, extra=()):
    """The kernel vs its plain version on the same inputs (module
    docstring, phase 3); `extra` arguments are passed as they are. Returns
    (max_abs_err, kernel ms, plain ms), device times."""
    import torch
    ref32 = plain(*(t.float() for t in bf_in), *extra).float()
    ref_bf = plain(*bf_in, *extra).float()
    out = kern(*bf_in, *extra)
    torch.cuda.synchronize()
    if out.shape != ref32.shape or not torch.isfinite(out).all():
        fail(f"{name}: shape {tuple(out.shape)} or non-finite")
    err = (out.float() - ref32).abs().max().item()
    err_plain = (ref_bf - ref32).abs().max().item()
    bound = 2 * err_plain + ATOL
    ms = time_ms(lambda: kern(*bf_in, *extra))
    plain_ms = time_ms(lambda: plain(*bf_in, *extra))
    call_ms = time_ms(lambda: kern(*bf_in, *extra), hold=False)
    print(f"{name:38s} max_abs_err={err:.3e} (bound {bound:.3e}, plain bf16 "
          f"err {err_plain:.3e}) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
          f"  (kernel per call as issued {call_ms:.4f} ms)  [{card}]",
          flush=True)
    if not err <= bound:
        fail(f"{name}: error {err:.3e} above bound {bound:.3e}")
    return err, ms, plain_ms


def check_quant_kernels(card):
    """int4_matmul and both decode attentions at the quantized slice's
    shapes; the first shape of each is the one kept for the JSON line."""
    import torch
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.kernels import quant4
    from opus_pllm_tpu_torch.models import decoder
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    rows = {}

    def keep(name, res):
        row = rows.setdefault(name, {"max_abs_err": 0.0, "ms": res[1],
                                     "plain_ms": res[2]})
        row["max_abs_err"] = max(row["max_abs_err"], res[0])

    for k, n in INT4_SHAPES:
        q, s = quant4.quantize_grouped(
            torch.randn((k, n), generator=g, device="cuda"))
        packed = quant4.pack_int4_v2(q)
        del q
        x = torch.randn((8, k), generator=g, device="cuda").bfloat16()
        keep("int4_matmul", compare(
            f"int4_matmul M=8 K={k} N={n}",
            lambda x: quant4.int4_matmul(x, packed, s),
            lambda x: quant4.int4_matmul_plain(x, packed, s), (x,), card))
        del packed, s
        torch.cuda.empty_cache()
    hq, hkv, d = 32, 8, 128
    for b, cap in ATTN_SHAPES:
        lengths = torch.randint(cap // 2, cap + 1, (b,), generator=g,
                                device="cuda")
        mask4 = (torch.arange(cap, device="cuda")[None] < lengths[:, None]
                 )[:, None, None, :]
        q = (torch.randn((b, 1, hq, d), generator=g, device="cuda")
             * 0.5).bfloat16()
        for kind, quant, fn in (
                ("int8", decoder._quantize_kv, da.decode_attention_int8),
                ("int4", decoder._quantize_kv4, da.decode_attention_int4)):
            kl, vl = ({key: t.contiguous() for key, t in quant(torch.randn(
                (b, cap, hkv, d), generator=g, device="cuda")).items()}
                for _ in range(2))
            keep(f"decode_attention_{kind}", compare(
                f"decode_attention_{kind} B={b} cap={cap}",
                lambda q: fn(q, kl, vl, mask4),
                lambda q: da.decode_attention_plain(q, kl, vl, mask4), (q,),
                card))
    return rows


def kernel_cases(s, g):
    """(name, kernel, plain, bf16 inputs) at B=8, sequence length s."""
    import torch
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.models.layers import rope_cos_sin
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        t = torch.randn(shape, generator=g, device=dev) * scale
        return t.to(torch.bfloat16)

    lengths = torch.randint(s // 4, s + 1, (B,), generator=g, device=dev)
    lengths[0] = s                                  # one row unpadded
    mask = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    ln = torch.stack([1 + 0.1 * torch.randn(E, generator=g, device=dev),
                      0.1 * torch.randn(E, generator=g, device=dev)]
                     ).to(torch.bfloat16)
    cos, sin = rope_cos_sin(torch.arange(s, device=dev), 64)
    x = rnd(B, s, E)
    return [
        ("ln_qkv_rope", fe.ln_qkv_rope, fe.ln_qkv_rope_plain,
         (x, rnd(3, E, E, scale=E ** -0.5), rnd(3, E, scale=0.1), ln),
         (cos, sin)),
        ("encoder_attention", fe.encoder_attention,
         fe.encoder_attention_plain, (rnd(3, B, H, s, 64),), (mask,)),
        ("out_proj", fe.out_proj, fe.out_proj_plain,
         (rnd(B, s, E, scale=0.5), rnd(E, E, scale=E ** -0.5),
          rnd(E, scale=0.1), x), ()),
        ("ffn", fe.ffn, fe.ffn_plain,
         (x, rnd(E, F, scale=E ** -0.5), rnd(F, scale=0.1),
          rnd(F, E, scale=F ** -0.5), rnd(E, scale=0.1), ln), ()),
    ]


def check_kernels(card):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    rows = {}
    for s in (128, 512):
        for name, kern, plain, bf_in, extra in kernel_cases(s, g):
            err, ms, plain_ms = compare(f"{name} S={s}", kern, plain, bf_in,
                                        card, extra)
            row = rows.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"], row["plain_ms"] = ms, plain_ms   # S=512 is kept
    return rows


def synthetic_examples(n):
    import numpy as np
    from opus_pllm_tpu_torch.evals.datasets import AnnotationExample
    rng = np.random.default_rng(SEED)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    return [AnnotationExample(
        "What are the UniProtKB keywords of this protein?",
        "".join(rng.choice(aa, int(rng.integers(60, 501)))), "")
        for _ in range(n)]


def _to_fp32(tree):
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_fp32(v) for v in tree]
    return tree.float()


def check_slice(card):
    import torch
    from opus_pllm_tpu_torch.core.config import (ESM2Config, GenerationConfig,
                                                 OpusConfig)
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.models import decoder, esm2, opus

    cfg = OpusConfig(esm=ESM2Config(dtype="bfloat16"))
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    t0 = time.perf_counter()
    params = opus.init(cfg, generator=g, device="cuda")
    torch.cuda.synchronize()
    print(f"init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)

    tok = ByteTokenizer()
    examples = synthetic_examples(16)
    gen = GenerationConfig(max_new_tokens=64, temperature=0.1, top_p=0.7,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id, seed=SEED)
    batch = 8
    n_batches = -(-len(examples) // batch)
    reset_counts()
    rep = runner.run_annotation_eval(
        params, cfg, tok, "synthetic_keywords.json", gen=gen,
        batch_size=batch, examples=examples, log_fn=lambda *_: None)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"launches {counts}", flush=True)
    for name, n in counts.items():
        want = cfg.esm.num_layers * n_batches if name in fe.launches else 0
        if n != want:
            fail(f"{name} launched {n} times, expected {want}")
    if len(rep.results) != len(examples) or not all(
            isinstance(r["generated"], str) for r in rep.results):
        fail("the runner did not answer every request")
    tok_s = rep.decode_tokens / rep.decode_seconds
    print(f"slice: {len(rep.results)} entries in {rep.seconds:.2f} s, "
          f"entries/s {rep.entries_per_sec:.3f}; decode {rep.decode_tokens} "
          f"tokens in {rep.decode_seconds:.2f} s = {tok_s:.1f} tok/s "
          f"(batch {batch}) [{card}]", flush=True)
    print(f"sample output: {rep.results[0]['generated'][:60]!r}", flush=True)

    # ESM2 through the kernels vs the plain layer composition in fp32
    toks, _ = esm2.tokenize([e.sequence for e in examples[:2]])
    toks = torch.from_numpy(toks).cuda()
    got = esm2.pooled_embedding(params["esm"], cfg.esm, toks, impl="auto")
    bf = esm2.pooled_embedding(params["esm"], cfg.esm, toks, impl="torch")
    esm32 = _to_fp32(params["esm"])
    ref = esm2.pooled_embedding(esm32, ESM2Config(), toks, impl="torch")
    err = (got - ref).abs().max().item()
    err_plain = (bf - ref).abs().max().item()
    print(f"esm2 pooled (2 proteins, 33 layers): kernels vs fp32 plain "
          f"{err:.3e}, bf16 plain vs fp32 plain {err_plain:.3e}", flush=True)
    if not (torch.isfinite(got).all() and err <= 2 * err_plain + ATOL):
        fail(f"ESM2 pooled embedding through the kernels is off: {err:.3e}")
    del esm32

    # decoder logits on the first spliced batch: finite, (B, V)
    ids, mask, esm_toks = runner._prepare_inputs(
        tok, [runner.annotation_prompt(runner.ds.instruction_for(
            e, "synthetic_keywords.json")) for e in examples[:batch]],
        [e.sequence for e in examples[:batch]], prompt_bucket=64,
        esm_bucket=128, device="cuda")
    with torch.no_grad():
        sp = opus.splice_prompt(params, cfg, ids, mask, esm_toks,
                                left_pad=True)
        hid, _ = decoder.forward(
            params["llm"], cfg.llm, sp.embeds,
            decoder.positions_from_mask(sp.mask),
            decoder.layers.causal_mask(sp.mask), return_hidden=True)
        logits = decoder.head_logits(params["llm"], cfg.llm, hid[:, -1])
    if logits.shape != (batch, cfg.llm.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        fail(f"decoder logits {tuple(logits.shape)} not finite")
    print(f"decoder prefill logits {tuple(logits.shape)} finite, prompt "
          f"length {sp.embeds.shape[1]}", flush=True)
    return counts, params, cfg, examples, gen


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if hasattr(tree, "clone") else tree


def check_decode_step(params, cfg, examples, quantize):
    """One decode step over a prefilled quantized cache: kernels
    (impl="auto", bf16) and plain (impl="torch", bf16) against the plain
    path in fp32 (fp32 activations, embeddings and norms; the same int4
    words and cache bytes)."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.models import decoder, opus
    tok, batch = ByteTokenizer(), 8
    ids, mask, esm_toks = runner._prepare_inputs(
        tok, [runner.annotation_prompt(runner.ds.instruction_for(
            e, "synthetic_keywords.json")) for e in examples[:batch]],
        [e.sequence for e in examples[:batch]], prompt_bucket=64,
        esm_bucket=128, device="cuda")
    llm, lcfg = params["llm"], cfg.llm
    with torch.no_grad():
        sp = opus.splice_prompt(params, cfg, ids, mask, esm_toks,
                                left_pad=True)
        pos = decoder.positions_from_mask(sp.mask)
        b, l, _ = sp.embeds.shape
        cap = engine.cache_capacity(lcfg, l, 64)
        cache = decoder.init_cache(lcfg, b, cap, device="cuda",
                                   quantize=quantize)
        cache["mask"][:, :l] = sp.mask
        cols = torch.arange(cap, device="cuda")[None, None, None, :]
        rows = torch.arange(l, device="cuda")[None, None, :, None]
        hid, cache = decoder.forward(
            llm, lcfg, sp.embeds, pos, cache["mask"][:, None, None, :]
            & (cols <= rows), cache, return_hidden=True)
        nxt = decoder.head_logits(llm, lcfg, hid[:, -1]).argmax(-1)
        cache["mask"][:, l] = True
        emb = decoder.embed_tokens(llm, nxt)[:, None]
        step = dict(positions=pos[:, -1:] + 1,
                    mask4=cache["mask"][:, None, None, :])
        out = {}
        for impl in ("auto", "torch"):
            lg, _ = decoder.forward(llm, lcfg, emb, step["positions"],
                                    step["mask4"], _clone(cache), impl=impl)
            out[impl] = lg[:, 0].float()
        small = ("embed_tokens", "final_norm", "attn_norm", "ffn_norm")
        to32 = lambda t: ({k: (to32(v) if k not in small else
                               {kk: vv.float() for kk, vv in v.items()})
                           for k, v in t.items()} if isinstance(t, dict)
                          else [to32(v) for v in t] if isinstance(t, list)
                          else t)
        lg, _ = decoder.forward(to32(llm), dataclasses.replace(
            lcfg, dtype="float32"), emb.float(), step["positions"],
            step["mask4"], _clone(cache), impl="torch")
        ref = lg[:, 0]
    err = (out["auto"] - ref).abs().max().item()
    err_plain = (out["torch"] - ref).abs().max().item()
    direct = (out["auto"] - out["torch"]).abs().max().item()
    bound = 2 * err_plain + ATOL
    print(f"decode step ({quantize} cache): |auto - torch| {direct:.3e}; "
          f"vs fp32 plain: auto {err:.3e}, torch {err_plain:.3e} (bound "
          f"{bound:.3e}); max|logit| {ref.abs().max().item():.3e}",
          flush=True)
    if not (torch.isfinite(out["auto"]).all() and err <= bound):
        fail(f"decode step over the {quantize} cache: kernels {err:.3e} "
             f"from the fp32 plain path, bound {bound:.3e}")


def check_quant_slice(card, params, cfg, examples, gen):
    """The bf16 slice's LLM quantized to int4 v2, then the eval with an
    int4 cache (16 requests) and an int8 cache (8)."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.kernels import quant4

    t0 = time.perf_counter()
    params["llm"] = quant4.quantize_decoder4(params["llm"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    layout = quant4.quant_layout_of(params["llm"])
    print(f"quantize_decoder4 {time.perf_counter() - t0:.1f} s, layout "
          f"{layout}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB of "
          f"weights on the card", flush=True)
    if layout != "int4-v2":
        fail(f"quantized LLM has layout {layout}")
    tok, batch = ByteTokenizer(), 8
    per_step = cfg.llm.num_layers * 7 + 1
    stats = {}
    for kind, n_req in (("int4", 16), ("int8", 8)):
        g = dataclasses.replace(gen, quantize_cache=kind)
        n_batches = -(-n_req // batch)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rep = runner.run_annotation_eval(
            params, cfg, tok, "synthetic_keywords.json", gen=g,
            batch_size=batch, examples=examples[:n_req],
            log_fn=lambda *_: None)
        torch.cuda.synchronize()
        counts = read_counts()
        steps = rep.decode_tokens // batch       # every batch is full here
        want = {n: cfg.esm.num_layers * n_batches for n in fe.launches}
        want["int4_matmul"] = n_batches + steps * per_step
        for name in da.launches:
            want[name] = (steps * cfg.llm.num_layers
                          if name == f"decode_attention_{kind}" else 0)
        print(f"{kind} cache: launches {counts}", flush=True)
        if counts != want:
            fail(f"{kind} cache: launches {counts}, expected {want}")
        if len(rep.results) != n_req or not all(
                isinstance(r["generated"], str) for r in rep.results):
            fail(f"{kind} cache: the runner did not answer every request")
        tok_s = rep.decode_tokens / rep.decode_seconds
        ms_step = 1e3 * rep.decode_seconds / steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"quantized slice, int4 weights + {kind} cache: "
              f"{len(rep.results)} entries in {rep.seconds:.2f} s, "
              f"entries/s {rep.entries_per_sec:.3f}; decode "
              f"{rep.decode_tokens} tokens in {rep.decode_seconds:.2f} s = "
              f"{tok_s:.1f} tok/s, {ms_step:.2f} ms/step (batch {batch}); "
              f"peak {peak:.2f} GiB on the card [{card}]", flush=True)
        print(f"sample output: {rep.results[0]['generated'][:60]!r}",
              flush=True)
        stats[kind] = counts
        check_decode_step(params, cfg, examples, kind)
    return stats


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import opus_pllm_tpu_torch
        from opus_pllm_tpu_torch.kernels import build
    except ImportError as e:
        fail(f"the opus_pllm_tpu_torch package is missing beside "
             f"chip_smoke.py ({e})")
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(opus_pllm_tpu_torch.__file__)))
    if pkg_root != here:
        fail(f"opus_pllm_tpu_torch was imported from {pkg_root}, not from "
             f"the checkout beside chip_smoke.py ({here})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
          f"{card}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"built {len(build.sources())} sources in parallel in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          + ", ".join(f"{n} {t:.1f} s" for n, t in
                      build.build_seconds.items()) + ")", flush=True)
    for line in build.build_log.splitlines():
        if line.startswith("[") or "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    phase("kernels vs plain")
    rows = check_kernels(card)
    rows.update(check_quant_kernels(card))

    phase("slice")
    counts, params, cfg, examples, gen = check_slice(card)

    phase("quantized slice")
    qcounts = check_quant_slice(card, params, cfg, examples, gen)

    kernels = [{"name": n, "route": "cuda", "source": SOURCE,
                "replaces": TPU_KERNELS[n], "launches": counts[n]}
               for n in TPU_KERNELS]
    kernels += [{"name": n, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": qcounts["int8" if n.endswith("int8")
                                     else "int4"][n]}
                for n, (tpu, src) in QUANT_KERNELS.items()]
    for k in kernels:
        k.update({key: rows[k["name"]][key]
                  for key in ("max_abs_err", "ms", "plain_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
