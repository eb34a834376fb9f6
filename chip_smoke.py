#!/usr/bin/env python3
"""Drive the PyTorch port's annotation-eval path once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; the first failure exits non-zero
and prints no result:
  1. device: needs torch.cuda.is_available(); prints `nvidia-smi`'s card
     name and power limit;
  2. build: compiles opus_pllm_tpu_torch/csrc/*.cu with nvcc (sm_90a) and
     prints the build time and the compiler's register report;
  3. kernels: each of the four fused-encoder kernels against its plain
     PyTorch version at the annotate path's shapes (B=8, S in {128, 512},
     E=1280, H=20, F=5120, bf16, padded key rows). Passes when
     max|kernel - plain_fp32| <= 2 * max|plain_bf16 - plain_fp32| + ATOL,
     where plain_fp32 runs the plain version on the same inputs in fp32,
     plain_bf16 in bf16 (its error is the rounding the bf16 output format
     forces), and ATOL = 4e-3 (half a bf16 ulp at magnitude 1-2) covers the
     kernels' other summation order. Prints kernel and plain times;
  4. slice: OpusConfig() at full width (ESM2-650M and Llama-3-8B in bf16,
     CSTP 1280->5120 and the mlp2x_gelu switch 5120->8x4096 in fp32, random
     weights drawn on the card from a seeded torch.Generator) answers 16
     synthetic keywords-task requests through
     evals.runner.run_annotation_eval (batch 8, T=0.1, top_p=0.7, 64 new
     tokens, ByteTokenizer). Checks that every kernel's launch count rose
     by 33 x batches, that ESM2's pooled embedding through the kernels
     agrees with the plain layer composition on two proteins, and that
     the decoder's logits are finite; prints entries/s and decode tok/s.
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
SOURCE = "opus_pllm_tpu_torch/csrc/fused_encoder.cu"


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


def time_ms(fn, iters=20):
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
            f32_in = tuple(t.float() for t in bf_in)
            ref32 = plain(*f32_in, *extra).float()
            ref_bf = plain(*bf_in, *extra).float()
            out = kern(*bf_in, *extra)
            torch.cuda.synchronize()
            if out.shape != ref32.shape or not torch.isfinite(out).all():
                fail(f"{name} S={s}: shape {tuple(out.shape)} or non-finite")
            err = (out.float() - ref32).abs().max().item()
            err_plain = (ref_bf - ref32).abs().max().item()
            bound = 2 * err_plain + ATOL
            ms = time_ms(lambda: kern(*bf_in, *extra))
            plain_ms = time_ms(lambda: plain(*bf_in, *extra))
            print(f"{name:18s} S={s:3d} max_abs_err={err:.3e} "
                  f"(bound {bound:.3e}, plain bf16 err {err_plain:.3e}) "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  [{card}]",
                  flush=True)
            if not err <= bound:
                fail(f"{name} S={s}: error {err:.3e} above bound {bound:.3e}")
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
    fe.reset_launches()
    rep = runner.run_annotation_eval(
        params, cfg, tok, "synthetic_keywords.json", gen=gen,
        batch_size=batch, examples=examples, log_fn=lambda *_: None)
    torch.cuda.synchronize()
    counts = dict(fe.launches)
    print(f"launches {counts}", flush=True)
    for name, n in counts.items():
        if n != cfg.esm.num_layers * n_batches:
            fail(f"{name} launched {n} times, expected "
                 f"{cfg.esm.num_layers * n_batches}")
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
    return counts


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
    build.library()
    print(f"built {build.sources()[0].parent} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{build.build_seconds if build.build_seconds is not None else 0:.1f} s)",
          flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    phase("kernels vs plain")
    rows = check_kernels(card)

    phase("slice")
    counts = check_slice(card)

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": SOURCE,
         "replaces": TPU_KERNELS[n], "launches": counts[n],
         "max_abs_err": rows[n]["max_abs_err"], "ms": rows[n]["ms"],
         "plain_ms": rows[n]["plain_ms"]} for n in TPU_KERNELS]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
