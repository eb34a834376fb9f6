#!/usr/bin/env python3
"""Drive the PyTorch port's annotation-eval and LoRA-training paths once on
one CUDA GPU.

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
     other summation order. Prints kernel (and its TFLOP/s), plain and
     library device times (the host held behind a queued device sleep),
     the kernel's time per call as the host issues it, and the bound: the
     larger of the bytes the function must move over 3.35 TB/s and its
     bf16 tensor-core operations over 989 TFLOP/s (H100 SXM data sheet),
     counting only the work this run's data needs (valid cache slots,
     mask-true query-key pairs).
     Shapes:
       - the four fused-encoder kernels at the annotate path's shapes (B=8,
         S in {128, 512}, E=1280, H=20, F=5120, bf16, padded key rows; the
         bound of encoder_attention counts the valid keys only, whose
         64-key tiles the kernel loads). Library for encoder_attention:
         scaled_dot_product_attention with the same key mask; printed
         beside ln_qkv_rope, out_proj and ffn (not in the JSON line): the
         bf16 cuBLAS products they contain at the same (M, K, N), marked *;
       - int4_matmul at M = 8 for each distinct (K, N) of a Llama-3-8B
         decode step: 4096->4096, 4096->1024, 4096->14336, 14336->4096,
         4096->128256 (random weights quantized by quant4.quantize_grouped),
         with the kernel's earlier design (kept for N % 4 != 0) beside it;
       - decode_attention_int8 / _int4 at B=8, Hq=32, Hkv=8, D=128 over a
         391-slot cache (the annotate decode capacity), at B=32 over 2048
         slots (lengths uniform over cap/2..cap), and with the static
         decode's mask at B=8 over 391 slots (left padding, then an
         unwritten tail: the kernel skips the 16-slot slabs false
         everywhere, and the bound counts the valid slots only);
       - flash_attention at the serving prefill (16 rows of bucket 320, the
         engine's admission mask), the static prefill (8 x 327 queries over
         a 391-slot left-padded cache, whose padding rows have no valid key:
         the kernel gives them out 0, as the plain version does), causal
         B=1, S=2048 and the training shape (B=16, L=519, the training mask:
         64 launches a train step run there); Hq=32, Hkv=8, D=128. The
         kernel skips the 64-key tiles whose mask is false everywhere (the
         bound counts mask-true pairs only). Library: torch's
         scaled_dot_product_attention with the same mask (K/V heads
         repeated beforehand);
       - int8_matmul at M = 5120 (serving prefill) and 2616 (static
         prefill) for the four (K, N) of a Llama-3-8B layer. Library: the
         bf16 cuBLAS product on W dequantized beforehand (the dequantize
         not timed, so not the same function); the port's own dequantize
         route (`quant.dequant_matmul`), which is, beside it (route_ms),
         and the kernel's earlier design, kept for unaligned N;
       - flash_attention_bwd_dq and _dkv (the saved out and lse of the
         forward kernel as inputs, dk and dv stacked into one output) at
         the training shape (B=16, L=519, right-padded valid lengths, the
         causal_mask of opus.forward) and causal B=1, S=2048; Hq=32,
         Hkv=8, D=128. Gradients are larger than 1, so ATOL is scaled by
         max(1, max|plain_fp32|). Library: the backward of
         scaled_dot_product_attention with the same mask, timed as
         backward only (it computes dq, dk and dv; so does the plain
         version, in both rows);
       - int4_matmul_v1 at M = 8304 (a train-lora batch, 16 x 519) for the
         five (K, N) of Llama-3-8B. Library: cuBLAS bf16 on W dequantized
         beforehand; the dequantize route (`quant4.dequant_matmul`) beside
         it (route_ms), and the earlier design, kept for unaligned N;
     the JSON line keeps, per kernel, the largest error over its shapes and
     the times of one shape: S=512 (encoder), 4096->4096 (int4), cap 391
     (decode attention), the serving prefill (flash), M=5120 4096->14336
     (int8), the training shape (flash backward) and 4096->14336 (v1);
  4. slice: OpusConfig() at full width (ESM2-650M and Llama-3-8B in bf16,
     CSTP 1280->5120 and the mlp2x_gelu switch 5120->8x4096 in fp32, random
     weights drawn on the card from a seeded torch.Generator) answers 16
     synthetic keywords-task requests through
     evals.runner.run_annotation_eval (batch 8, T=0.1, top_p=0.7, 64 new
     tokens, ByteTokenizer). Checks the launch counts exactly: every
     encoder kernel 33 x batches, flash_attention 32 x batches (each
     prefill layer), no other kernel; that ESM2's pooled embedding through
     the kernels agrees with the plain layer composition on two proteins,
     and that the decoder's logits are finite; that the runner's metrics
     (Precision, Recall, F1 Score of the keywords task, against synthetic
     keyword answers) are finite and in [0, 1]; prints entries/s and
     decode tok/s;
  5. function metrics: the same params answer 8 synthetic function-task
     requests (one batch, 64 new tokens) through run_annotation_eval
     with bert_embed_fn = models.bert.make_embed_fn over a full-width
     BertConfig() (BioBERT-large: 24 x 1024, 16 heads, vocab 58996; fp32
     random weights drawn on the card from SEED) and a WordPieceTokenizer
     over a vocab made in the script (the special tokens, the printable
     ASCII characters and their ## forms; no file is read). Checks exact
     launch counts (each encoder kernel 33, flash_attention 32; the BERT's
     d = 64 fp32 attention takes the plain path, as in the JAX package);
     that ROUGE, BLEU, METEOR and BERTScore are finite and in [0, 1]; and
     that a text scored against itself gives BERTScore F1 = 1 within
     1e-5. Prints the BERT's GiB on the card and its seconds;
  6. quantized slice: the same LLM quantized by quant4.quantize_decoder4
     (int4 v2 words, fp32 group scales; the bf16 projections are freed)
     answers the same 16 requests with an int4 KV cache, then one batch of
     8 with an int8 cache. Checks exact launch counts, each derived from
     the dispatch and the decode steps run (prefill projections have
     M = 8 x 327 > 64 rows and take the dequantize route, the prefill head
     and every decode projection and head the kernel):
       int4_matmul = batches + steps x (32 x 7 + 1),
       decode_attention_<cache> = steps x 32, the other one 0,
       flash_attention = 32 x batches, encoder kernels = 33 x batches;
     and that one decode step's logits through the kernels (impl="auto")
     stay within 2 * (plain bf16 error) + ATOL of the plain path run in
     fp32, next to the plain path in bf16 (impl="torch"). Prints entries/s,
     decode tok/s, ms per decode step and GiB on the card;
  7. serving slice: a bf16 Llama-3-8B drawn again from the seed, quantized
     to int8 by quant.quantize_decoder (the bf16 weights freed), answers 32
     synthetic requests through evals.runner.run_annotation_eval_engine
     (the continuous-batching engine: 16 slots, 4 steps a tick, T=0.1,
     top_p=0.7, 64 new tokens, bf16 cache), then 8 with an int8 cache.
     Checks exact launch counts from the engine's own counters: every
     admission group is one prefill of n x bucket >= 256 rows, so
       flash_attention = 32 x prefills, int8_matmul = 7 x 32 x prefills,
       decode_attention_<cache> = 32 x decode steps (int8 cache; none on
       the bf16 cache), encoder kernels = 33 x splice batches,
       int4_matmul = 0, and every kernel kept for unaligned N
       (int8_matmul_unaligned, int4_matmul_unaligned,
       int4_matmul_v1_unaligned) 0 in every phase;
     that every request is answered; and that one admission group's
     prefill logits (16 rows, bucket 320) through the kernels stay within
     the bound above of the plain path in fp32. Prints entries/s, tokens/s,
     TTFT p50/p99 (the engine's histogram bounds) and GiB on the card;
  8. training slice (`train-lora`): the earlier phases' LLM freed, a fresh
     Llama-3-8B drawn from the seed inside OpusConfig() (the ESM2, CSTP and
     switch of phase 4, frozen) trains LoRA adapters with train-lora's
     defaults (lr 2e-5, wd 0, batch 16, max-len 512, rank 16 / alpha 32
     on the seven projections, remat full, ce_chunk 0, grad_accum 1) on
     64 synthetic keywords-task records (proteins of 60-500 residues,
     24-64-token answers, instructions long enough that every batch
     reaches the 512-token cap, so the decoder runs at L = 512 + 8 - 1 =
     519, which the phase asserts) written to a temporary JSON and read
     through InstructionDataset -> instruction_batches ->
     multimodal_trainer.fit: (a) over the bf16 LLM for 4 steps, (b) over
     the same LLM through quantize_decoder4(layout="v1") (QLoRA, the bf16
     projections freed) for 3 steps. Exact launch counts per optimizer
     step: one ESM2 call of 16 proteins (each encoder kernel 33); the 32
     layers' forward and, under remat, their recompute in the backward
     (flash_attention 2 x 32, and with the v1 base int4_matmul_v1 2 x 7 x
     32 plus 1 for the vocab head, which is outside the remat: 449); one
     backward of each attention (flash_attention_bwd_dq = _dkv = 32); 0
     for every other kernel (the int4 backward dx is a dequantize + cuBLAS
     product, as in the JAX package). Checks: a finite loss every step and
     every LoRA B leaf changed after step 1. A gradient gate between (a)
     and (b): the LLM's first four layers and its head, 4 rows of the same
     traffic (their pooled ESM2 embeddings computed once), LoRA B drawn
     from N(0, 0.01); the `loss_fn` gradient of every LoRA leaf through
     the kernels (impl="auto", bf16) must stay within the bound of phase 3
     of the plain path in fp32 (impl="torch", fp32 weights), in units of
     each leaf's largest entry, printed next to the plain path in bf16.
     Prints s/step (steps after the first), trained tokens/s (the valid
     label tokens of a step over its wall time), GiB on the card after the
     weights are in place and the peak.
The last two lines: a JSON object of the kernels' numbers, then
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile-serving

runs phases 1 and 2, then the serving configuration of phase 7 (bf16
cache, 32 requests) twice unprofiled, then its first 16 requests (one
wave: one prefill, 64 decode steps) under torch.profiler, and prints
where the device time goes: the kernels' summed device time against the
profiled wall time (the profiler inflates host time), the sums for the
casts and multiplies (mostly the dequantize route's), the hand-written
kernels and cuBLAS, and the kernels with the most device time. It checks
nothing and prints no result line.

    python3 chip_smoke.py --profile-training

runs phases 1 and 2, then phase 8's configuration: two unprofiled steps
and one profiled step of train-lora over the bf16 LLM, then the same over
its v1 quantization, each printed as above with the sums for the
hand-written kernels, cuBLAS, the elementwise casts / multiplies / adds
and the softmax kernels. It checks nothing and prints no result line.

    python3 chip_smoke.py --kernel-times [TREE ...]

times the kernels of each checkout TREE (default: this one; each in a
process of its own, which builds that tree's kernels into its git-ignored
build/), inputs drawn from the same seed, one device time per line (as
phase 3 times a kernel) with the card's name and power limit:
  - the flash-attention kernels at phase 3's flash shapes: the forward at
    all four, dq and dk/dv at the training shape and causal 2048;
  - the four encoder kernels at B=8, S in {128, 512} on phase 3's inputs,
    each with its bound and share: encoder_attention beside SDPA on the
    same inputs and key mask, ln_qkv_rope, out_proj and ffn beside the
    bf16 cuBLAS products they contain at the same (M, K, N) (marked *: not
    the same function);
  - int4_matmul (v2) at M=8 on the five decode shapes and at M in {1, 16,
    64} on 4096->14336, with the weights cold (the calls rotate over
    copies of the words and scales larger than the 50 MB L2 together, as
    a decode step streams 4 GB of them), each with its bound, then the
    sum of one decode step's 225 launches at M=8;
  - decode_attention_int8 / _int4 at phase 3's three shapes with the cache
    cold (rotated over copies past the L2), each with its bound, SDPA over
    a bf16 cache dequantized beforehand (marked *: not the same function)
    and, at B=8, one decode step's 32 launches; then the floor at one
    (row, KV head) over one 64-slot tile.
Naming the parent's checkout and this one in turns (parent, change,
change, parent) compares two designs on one card. It checks nothing and
prints no result line.

    python3 chip_smoke.py --flash-times [TREE ...]
    python3 chip_smoke.py --decode-times [TREE ...]
    python3 chip_smoke.py --encoder-times [TREE ...]

the same for the flash-attention kernels only, the decode attentions
only, or the four encoder kernels only.
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
SERVE_KERNELS = {
    "flash_attention": ("opus_pllm_tpu/kernels/flash_attention.py:257",
                        "opus_pllm_tpu_torch/csrc/flash_attention.cu"),
    "int8_matmul": ("opus_pllm_tpu/kernels/quant.py:142",
                    "opus_pllm_tpu_torch/csrc/int8_matmul.cu"),
}
TRAIN_KERNELS = {
    "flash_attention_bwd_dq": (
        "opus_pllm_tpu/kernels/flash_attention_bwd.py:197",
        "opus_pllm_tpu_torch/csrc/flash_attention_bwd.cu"),
    "flash_attention_bwd_dkv": (
        "opus_pllm_tpu/kernels/flash_attention_bwd.py:211",
        "opus_pllm_tpu_torch/csrc/flash_attention_bwd.cu"),
    "int4_matmul_v1": ("opus_pllm_tpu/kernels/quant4.py:359",
                       "opus_pllm_tpu_torch/csrc/int4_matmul_v1.cu"),
}
SOURCE = "opus_pllm_tpu_torch/csrc/fused_encoder.cu"
INT4_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
               (4096, 128256))          # (K, N) of one Llama-3-8B decode step
INT8_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
ATTN_SHAPES = ((8, 391), (32, 2048))    # (B, capacity); Hq 32, Hkv 8, D 128
# H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
SERVE_REQUESTS = 32
SERVE_SLOTS, SERVE_STEPS = 16, 4
# train-lora (cli/main.py:1027-1069): batch 16 at --max-len 512; one
# protein's 8 soft tokens replace its sentinel, so the decoder sees 519
TRAIN_BATCH, TRAIN_MAX_LEN = 16, 512
TRAIN_LEN = TRAIN_MAX_LEN + 8 - 1
TRAIN_RECORDS, TRAIN_STEPS_BF16, TRAIN_STEPS_QLORA = 64, 4, 3
GATE_LAYERS, GATE_ROWS = 4, 4


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


def _kernel_modules():
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import flash_attention_bwd as fab
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.kernels import quant, quant4
    return fe, quant4, da, fa, quant, fab


def reset_counts():
    for mod in _kernel_modules():
        mod.reset_launches()


def read_counts():
    counts = {}
    for mod in _kernel_modules():
        counts.update(mod.launches)
    return counts


def expect_counts(label, counts, **want):
    """Every kernel's launch count against `want` (names not given: 0)."""
    full = {name: want.get(name, 0) for name in counts}
    print(f"{label}: launches {counts}", flush=True)
    if counts != full:
        fail(f"{label}: launches {counts}, expected {full}")


def nbytes(*ts):
    import torch
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def bound_ms(flops, n_bytes):
    """The least time the card could take: (ms, what bounds it)."""
    ops = 1e3 * flops / PEAK_BF16_FLOPS
    mem = 1e3 * n_bytes / PEAK_HBM_BYTES
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def compare(name, kern, plain, bf_in, card, extra=(), *, flops,
            more_bytes=0, n_bytes=None, library=None, route=None,
            earlier=None, cublas=None, scaled_atol=False):
    """The kernel vs its plain version on the same inputs (module
    docstring, phase 3); `extra` arguments are passed as they are.
    `flops` and the bytes of the inputs, the output and `more_bytes`
    (operands the calls capture), or `n_bytes` where the data needs fewer
    (keys of padding that are never read), give the bound; `library` is the PyTorch
    yardstick, `route` another path of the port (its time is kept as
    route_ms), `earlier` the kernel's earlier design, `cublas` the bare
    cuBLAS products of a fused kernel (printed, marked *: not the same
    function), all only timed.
    scaled_atol: ATOL times max(1, max|plain_fp32|) (gradients). Returns
    the kernel's row of the JSON line, device times."""
    import torch
    ref32 = plain(*(t.float() for t in bf_in), *extra).float()
    ref_bf = plain(*bf_in, *extra).float()
    out = kern(*bf_in, *extra)
    torch.cuda.synchronize()
    if out.shape != ref32.shape or not torch.isfinite(out).all():
        fail(f"{name}: shape {tuple(out.shape)} or non-finite")
    err = (out.float() - ref32).abs().max().item()
    err_plain = (ref_bf - ref32).abs().max().item()
    tol = 2 * err_plain + ATOL * (
        max(1.0, ref32.abs().max().item()) if scaled_atol else 1.0)
    b_ms, b_by = bound_ms(flops, n_bytes if n_bytes is not None else
                          nbytes(*bf_in, *extra, out) + more_bytes)
    del ref32, ref_bf, out
    ms = time_ms(lambda: kern(*bf_in, *extra))
    plain_ms = time_ms(lambda: plain(*bf_in, *extra))
    call_ms = time_ms(lambda: kern(*bf_in, *extra), hold=False)
    lib_ms = time_ms(library) if library is not None else None
    route_ms = time_ms(route) if route is not None else None
    earlier_ms = time_ms(earlier) if earlier is not None else None
    cublas_ms = time_ms(cublas) if cublas is not None else None
    print(f"{name:38s} max_abs_err={err:.3e} (tol {tol:.3e}, plain bf16 "
          f"err {err_plain:.3e}) kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s)  plain {plain_ms:.4f} ms"
          + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else "")
          + (f"  dequantize route {route_ms:.4f} ms"
             if route_ms is not None else "")
          + (f"  earlier kernel {earlier_ms:.4f} ms"
             if earlier_ms is not None else "")
          + (f"  cuBLAS* {cublas_ms:.4f} ms" if cublas_ms is not None
             else "")
          + f"  bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
          f"{100 * b_ms / ms:.1f}% of it)  (kernel per call as issued "
          f"{call_ms:.4f} ms)  [{card}]", flush=True)
    if not err <= tol:
        fail(f"{name}: error {err:.3e} above {tol:.3e}")
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    if route is not None:
        res["route_ms"] = route_ms
    return res


def earlier_kernel(name, x, w, scale):
    """A call of the kernel that `name` keeps for unaligned N (its earlier
    design), made directly at an aligned shape so that phase 3 times the
    two designs in one run; not counted in `launches`."""
    import torch
    from opus_pllm_tpu_torch.kernels import build, quant4
    lib = build.library(name)
    fn = getattr(lib, f"opus_{name}_unaligned")
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if name == "int4_matmul":                  # v2: its split-K workspace
        n_sb = k // quant4.SUPER
        splits = quant4._splits(n_sb, -(-n // quant4.KERNEL_COLS)
                                * -(-m // quant4.KERNEL_MT))
        ws = torch.empty((splits, m, n), dtype=torch.float32,
                         device=x.device)
        args = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), ws.data_ptr(),
                out.data_ptr(), m, n, k, -(-n_sb // splits), splits, 1)
        stream = torch.cuda.current_stream().cuda_stream
        return lambda: build.check(fn(*args, stream), name, lib)
    args = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n, k) + ((0,) if name == "int4_matmul_v1" else ())
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: build.check(fn(*args, stream), name, lib)


def keep(rows, name, res, main):
    """Fold one shape's result into the kernel's JSON row: the largest
    error over its shapes, the times of its `main` shape."""
    row = rows.setdefault(name, {"max_abs_err": 0.0})
    err = max(row["max_abs_err"], res["max_abs_err"])
    if main:
        row.update(res)
    row["max_abs_err"] = err


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
    for i, (k, n) in enumerate(INT4_SHAPES):
        q, s = quant4.quantize_grouped(
            torch.randn((k, n), generator=g, device="cuda"))
        packed = quant4.pack_int4_v2(q)
        del q
        x = torch.randn((8, k), generator=g, device="cuda").bfloat16()
        keep(rows, "int4_matmul", compare(
            f"int4_matmul M=8 K={k} N={n}",
            lambda x: quant4.int4_matmul(x, packed, s),
            lambda x: quant4.int4_matmul_plain(x, packed, s), (x,), card,
            flops=2 * 8 * k * n, more_bytes=nbytes(packed, s),
            earlier=earlier_kernel("int4_matmul", x, packed, s)), i == 0)
        del packed, s
        torch.cuda.empty_cache()
    hq, hkv, d = 32, 8, 128
    for i, (label, b, cap, mask4) in enumerate(attn_cases(g)):
        q = (torch.randn((b, 1, hq, d), generator=g, device="cuda")
             * 0.5).bfloat16()
        valid = mask4.sum().item()
        for kind, quant, fn in (
                ("int8", decoder._quantize_kv, da.decode_attention_int8),
                ("int4", decoder._quantize_kv4, da.decode_attention_int4)):
            kl, vl = ({key: t.contiguous() for key, t in quant(torch.randn(
                (b, cap, hkv, d), generator=g, device="cuda")).items()}
                for _ in range(2))
            keep(rows, f"decode_attention_{kind}", compare(
                f"decode_attention_{kind} {label}",
                lambda q: fn(q, kl, vl, mask4),
                lambda q: da.decode_attention_plain(q, kl, vl, mask4), (q,),
                card, flops=4 * hq * d * valid,
                n_bytes=decode_bytes(q, kl, vl, mask4)), i == 0)
    return rows


def attn_cases(g):
    """The decode attention shapes, masks drawn from `g`: (label, B, cap,
    mask4). ATTN_SHAPES with lengths uniform over cap/2..cap, then the
    static decode's mask at B = 8 over 391 slots: prompts of 100-327 tokens
    left-padded to 327, and 32 of the 64 decode slots written (the rest an
    unwritten tail)."""
    import torch
    cases = []
    for b, cap in ATTN_SHAPES:
        lengths = torch.randint(cap // 2, cap + 1, (b,), generator=g,
                                device="cuda")
        mask = torch.arange(cap, device="cuda")[None] < lengths[:, None]
        cases.append((f"B={b} cap={cap}", b, cap, mask[:, None, None, :]))
    pad = 327 - torch.randint(100, 328, (8,), generator=g, device="cuda")
    slots = torch.arange(391, device="cuda")[None]
    mask = (slots >= pad[:, None]) & (slots < 327 + 32)
    cases.append(("static B=8 cap=391", 8, 391, mask[:, None, None, :]))
    return cases


def decode_bytes(q, kl, vl, mask4):
    """The bytes decode attention must move: q, out and the mask once, and
    the K and V rows and scales of the valid slots only."""
    b, cap = mask4.shape[0], mask4.shape[-1]
    share = mask4.sum().item() / (b * cap)
    return 2 * nbytes(q) + nbytes(mask4) + share * nbytes(*kl.values(),
                                                         *vl.values())


def flash_cases(g):
    """phase 3's flash_attention shapes, masks drawn from `g`: (label, B,
    Sq, Skv, mask, causal)."""
    import torch
    from opus_pllm_tpu_torch.serve.engine import admission_inputs
    # serving prefill: 16 admitted prompts of 200-320 spliced tokens
    n_valid = torch.randint(200, 321, (16,), generator=g, device="cuda")
    n_valid[0] = 287
    _, serve_mask = admission_inputs(n_valid, 320)
    # static prefill: 8 left-padded prompts of 327 tokens over 391 slots,
    # the 64 decode slots not yet written
    pad = 327 - torch.randint(100, 328, (8,), generator=g, device="cuda")
    cols = torch.arange(391, device="cuda")[None, None, None, :]
    rows_q = torch.arange(327, device="cuda")[None, None, :, None]
    static_mask = (cols <= rows_q) & (cols >= pad[:, None, None, None])
    # training: train-lora's batch at L = 519, right-padded
    n_train = torch.randint(TRAIN_LEN // 2, TRAIN_LEN + 1, (TRAIN_BATCH,),
                            generator=g, device="cuda")
    n_train[0] = TRAIN_LEN
    return (("serving prefill B=16 S=320", 16, 320, 320, serve_mask, False),
            ("static prefill B=8 327x391", 8, 327, 391, static_mask, False),
            ("causal B=1 S=2048", 1, 2048, 2048, None, True),
            (f"training B={TRAIN_BATCH} L={TRAIN_LEN}", TRAIN_BATCH,
             TRAIN_LEN, TRAIN_LEN, train_mask(n_train, TRAIN_LEN), False))


def kernel_times(flag, trees):
    """--kernel-times / --flash-times / --decode-times / --encoder-times
    (module docstring): each tree in a process of its own, or, for one
    tree, its kernels' device times."""
    if len(trees) != 1:
        for tree in trees:
            subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                            tree], check=True, timeout=900)
        return
    import torch
    tree = os.path.abspath(trees[0])
    sys.path.insert(0, tree)
    import opus_pllm_tpu_torch
    pkg = os.path.dirname(os.path.dirname(
        os.path.abspath(opus_pllm_tpu_torch.__file__)))
    if pkg != tree:
        fail(f"imported {pkg}, not the package of {tree}")
    from opus_pllm_tpu_torch.kernels import build
    card = card_line()
    build.build_all()
    if flag == "--decode-times":
        decode_attention_times(tree, card)
        return
    if flag == "--encoder-times":
        encoder_times(tree, card)
        return
    flash_kernel_times(tree, card)
    if flag == "--kernel-times":
        encoder_times(tree, card)
        int4_times(tree, card)
        decode_attention_times(tree, card)


def flash_kernel_times(tree, card):
    """The flash kernels at phase 3's flash shapes."""
    import torch
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import flash_attention_bwd as fab
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    rnd = lambda *shape: torch.randn(shape, generator=g,
                                     device="cuda").bfloat16()
    hq, hkv, d = 32, 8, 128
    for label, b, sq, skv, mask, causal in flash_cases(g):
        q, k, v = rnd(b, sq, hq, d), rnd(b, skv, hkv, d), rnd(b, skv, hkv, d)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, mask,
                                                causal=causal))
        print(f"{tree}: flash_attention {label}: {ms:.4f} ms [{card}]",
              flush=True)
        if label.startswith(("training", "causal")):
            dout = rnd(b, sq, hq, d)
            out, lse = fa.flash_attention(q, k, v, mask, causal=causal,
                                          return_lse=True)
            delta = fab._delta(out, dout)
            for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                fn = getattr(fab, name)
                ms = time_ms(lambda: fn(q, k, v, mask, lse, delta, dout,
                                        causal=causal))
                print(f"{tree}: {name} {label}: {ms:.4f} ms [{card}]",
                      flush=True)


def encoder_times(tree, card):
    """The four encoder kernels at B = 8, S in {128, 512} on phase 3's
    inputs (ragged key rows, one unpadded), each with its bound and share,
    SDPA beside the attention and the bare cuBLAS products beside
    ln_qkv_rope, out_proj and ffn (marked *: not the same function)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    for s in (128, 512):
        for (name, kern, _, bf_in, extra, flops, lib, n_bytes,
             cublas) in kernel_cases(s, g):
            out = kern(*bf_in, *extra)
            b_ms, b_by = bound_ms(flops, n_bytes if n_bytes is not None
                                  else nbytes(*bf_in, *extra, out))
            del out
            ms = time_ms(lambda: kern(*bf_in, *extra))
            yard = ""
            if lib is not None:
                yard = f", SDPA {time_ms(lib):.4f} ms"
            if cublas is not None:
                yard = f", cuBLAS* {time_ms(cublas):.4f} ms"
            print(f"{tree}: {name} B={B} S={s}: {ms:.4f} ms{yard}, bound "
                  f"{b_ms:.4f} ms ({b_by}; {100 * b_ms / ms:.1f}% of it) "
                  f"[{card}]", flush=True)


INT4_TIMES = tuple((8, k, n) for k, n in INT4_SHAPES) + tuple(
    (m, 4096, 14336) for m in (1, 16, 64))
COLD_BYTES = 120e6          # > the H100's 50 MB L2, as a decode step finds it


def int4_times(tree, card):
    """int4_matmul (v2) at M = 8 on the five decode shapes and M in {1, 16,
    64} on 4096->14336, the weights cold: the calls rotate over copies of
    the words and scales that together exceed the L2 (COLD_BYTES), as a
    decode step streams 4 GB of them. Then the sum of one Llama-3-8B
    decode step (32 x the seven projections + the head) at M = 8."""
    import itertools
    import torch
    from opus_pllm_tpu_torch.kernels import quant4
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    step = {(4096, 4096): 2 * 32, (4096, 1024): 2 * 32,
            (4096, 14336): 2 * 32, (14336, 4096): 32, (4096, 128256): 1}
    total = total_bound = 0.0
    for m, k, n in INT4_TIMES:
        q, s = quant4.quantize_grouped(
            torch.randn((k, n), generator=g, device="cuda"))
        packed = quant4.pack_int4_v2(q)
        del q
        x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        copies = max(1, int(-(-COLD_BYTES // nbytes(packed, s))))
        weights = [(packed, s)] + [(packed.clone(), s.clone())
                                   for _ in range(copies - 1)]
        out = quant4.int4_matmul(x, packed, s)
        b_ms, b_by = bound_ms(2 * m * k * n, nbytes(x, packed, s, out))
        turn = itertools.cycle(weights)
        ms = time_ms(lambda: quant4.int4_matmul(x, *next(turn)))
        print(f"{tree}: int4_matmul M={m} K={k} N={n}: {ms:.4f} ms (weights "
              f"cold, {copies} copies), bound {b_ms:.4f} ms ({b_by}; "
              f"{100 * b_ms / ms:.1f}% of it) [{card}]", flush=True)
        if m == 8:
            total += step[(k, n)] * ms
            total_bound += step[(k, n)] * b_ms
        del weights, packed, s, turn
        torch.cuda.empty_cache()
    print(f"{tree}: int4_matmul one decode step at M=8 (225 launches): "
          f"{total:.4f} ms, bound {total_bound:.4f} ms "
          f"({100 * total_bound / total:.1f}% of it) [{card}]", flush=True)


def decode_attention_times(tree, card):
    """Both decode attentions at phase 3's shapes (attn_cases), the cache
    cold: the calls rotate over copies of the cache that together exceed
    the L2 (COLD_BYTES), as a decode step streams 32 layers' caches. Beside
    each: the bound, SDPA over a bf16 cache dequantized beforehand (K/V
    heads repeated; not the same function: the dequantize is not timed and
    the cache read is bf16), and, at B = 8, one decode step's 32 launches.
    Then the floor: one (row, KV head) over one 64-slot tile."""
    import itertools
    import torch
    import torch.nn.functional as tnf
    from opus_pllm_tpu_torch.kernels import decode_attention as da
    from opus_pllm_tpu_torch.models import decoder
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    hq, hkv, d = 32, 8, 128
    kinds = (("int8", decoder._quantize_kv, da.decode_attention_int8),
             ("int4", decoder._quantize_kv4, da.decode_attention_int4))
    for label, b, cap, mask4 in attn_cases(g):
        q = (torch.randn((b, 1, hq, d), generator=g, device="cuda")
             * 0.5).bfloat16()
        for kind, quant, fn in kinds:
            kl, vl = ({key: t.contiguous() for key, t in quant(torch.randn(
                (b, cap, hkv, d), generator=g, device="cuda")).items()}
                for _ in range(2))
            copies = max(1, int(-(-COLD_BYTES // nbytes(*kl.values(),
                                                       *vl.values()))))
            caches = [(kl, vl)] + [
                tuple({key: t.clone() for key, t in leaf.items()}
                      for leaf in (kl, vl)) for _ in range(copies - 1)]
            b_ms, b_by = bound_ms(4 * hq * d * mask4.sum().item(),
                                  decode_bytes(q, kl, vl, mask4))
            turn = itertools.cycle(caches)
            ms = time_ms(lambda: fn(q, *next(turn), mask4))
            hot = time_ms(lambda: fn(q, kl, vl, mask4))
            kx, vx = (decoder._dequantize_kv(leaf, torch.bfloat16)
                      .repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                      .contiguous() for leaf in (kl, vl))
            qx = q.transpose(1, 2)
            lib = time_ms(lambda: tnf.scaled_dot_product_attention(
                qx, kx, vx, attn_mask=mask4))
            step = (f", one decode step (32 launches) {32 * ms:.4f} ms"
                    if b == 8 else "")
            print(f"{tree}: decode_attention_{kind} {label}: {ms:.4f} ms "
                  f"(cache cold, {copies} copies; hot {hot:.4f} ms), "
                  f"bound {b_ms:.4f} ms "
                  f"({b_by}; {100 * b_ms / ms:.1f}% of it), SDPA* on a bf16 "
                  f"cache {lib:.4f} ms{step} [{card}]", flush=True)
            del caches, turn, kx, vx
            torch.cuda.empty_cache()
    q = torch.randn((1, 1, 4, d), generator=g, device="cuda").bfloat16()
    mask4 = torch.ones((1, 1, 1, 64), dtype=torch.bool, device="cuda")
    for kind, quant, fn in kinds:
        kl, vl = ({key: t.contiguous() for key, t in quant(torch.randn(
            (1, 64, 1, d), generator=g, device="cuda")).items()}
            for _ in range(2))
        ms = time_ms(lambda: fn(q, kl, vl, mask4))
        print(f"{tree}: decode_attention_{kind} floor (B=1, one KV head, "
              f"one 64-slot tile): {ms:.4f} ms [{card}]", flush=True)


def check_serve_kernels(card):
    """flash_attention and int8_matmul at the prefill shapes of the serving
    and static paths (module docstring, phase 3)."""
    import torch
    import torch.nn.functional as tnf
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import quant
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    rnd = lambda *shape: torch.randn(shape, generator=g,
                                     device="cuda").bfloat16()
    rows = {}
    hq, hkv, d = 32, 8, 128
    for i, (label, b, sq, skv, mask, causal) in enumerate(flash_cases(g)):
        q, k, v = rnd(b, sq, hq, d), rnd(b, skv, hkv, d), rnd(b, skv, hkv, d)
        pairs = (mask.sum().item() if mask is not None
                 else b * sq * (sq + 1) // 2)
        kx, vx = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  for t in (k, v))
        qx = q.transpose(1, 2)
        keep(rows, "flash_attention", compare(
            f"flash_attention {label}",
            lambda q, k, v: fa.flash_attention(q, k, v, mask, causal=causal),
            lambda q, k, v: fa.flash_attention_plain(q, k, v, mask,
                                                     causal=causal),
            (q, k, v), card, flops=4 * hq * d * pairs,
            more_bytes=nbytes(mask),
            library=lambda: tnf.scaled_dot_product_attention(
                qx, kx, vx, attn_mask=mask, is_causal=causal)), i == 0)
        del q, k, v, kx, vx, qx
    for m in (5120, 2616):
        for k, n in INT8_SHAPES:
            wq, s = quant.quantize_per_channel(
                torch.randn((k, n), generator=g, device="cuda"))
            w_bf = (wq.float() * s).bfloat16()
            x = rnd(m, k)
            keep(rows, "int8_matmul", compare(
                f"int8_matmul M={m} K={k} N={n}",
                lambda x: quant.int8_matmul(x, wq, s),
                lambda x: quant.int8_matmul_plain(x, wq, s), (x,), card,
                flops=2 * m * n * k, more_bytes=nbytes(wq, s),
                library=lambda: torch.mm(x, w_bf),
                route=lambda: quant.dequant_matmul(x, wq, s),
                earlier=earlier_kernel("int8_matmul", x, wq, s)),
                (m, k, n) == (5120, 4096, 14336))
            del wq, s, w_bf, x
            torch.cuda.empty_cache()
    return rows


def train_mask(n_valid, length):
    """opus.forward's training mask: right-padded valid lengths (B,) and
    causality -> (B, 1, L, L) bool."""
    import torch
    from opus_pllm_tpu_torch.models.layers import causal_mask
    attn = (torch.arange(length, device=n_valid.device)[None]
            < n_valid[:, None])
    return causal_mask(attn)


def check_train_kernels(card):
    """Both flash-attention backward kernels and int4_matmul_v1 at the
    training slice's shapes (module docstring, phase 3)."""
    import torch
    from opus_pllm_tpu_torch.kernels import flash_attention as fa
    from opus_pllm_tpu_torch.kernels import flash_attention_bwd as fab
    from opus_pllm_tpu_torch.kernels import quant4
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    rnd = lambda *shape: torch.randn(shape, generator=g,
                                     device="cuda").bfloat16()
    rows = {}
    hq, hkv, d = 32, 8, 128
    n_valid = torch.randint(TRAIN_LEN // 2, TRAIN_LEN + 1, (TRAIN_BATCH,),
                            generator=g, device="cuda")
    n_valid[0] = TRAIN_LEN
    cases = ((f"training B={TRAIN_BATCH} L={TRAIN_LEN}", TRAIN_BATCH,
              TRAIN_LEN, train_mask(n_valid, TRAIN_LEN), False),
             ("causal B=1 S=2048", 1, 2048, None, True))
    for i, (label, b, s, mask, causal) in enumerate(cases):
        q, k, v, dout = rnd(b, s, hq, d), rnd(b, s, hkv, d), \
            rnd(b, s, hkv, d), rnd(b, s, hq, d)
        out, lse = fa.flash_attention(q, k, v, mask, causal=causal,
                                      return_lse=True)
        delta = fab._delta(out, dout)
        pairs = (mask.sum().item() if mask is not None
                 else b * s * (s + 1) // 2)
        plain = lambda q, k, v, dout: fab.flash_attention_bwd_plain(
            q, k, v, mask, out, lse, dout, causal=causal)
        # SDPA on (B, H, S, D) leaves, K/V heads repeated, backward only
        qx, kx, vx = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k.repeat_interleave(hq // hkv, dim=2),
                                v.repeat_interleave(hq // hkv, dim=2)))
        ox = torch.nn.functional.scaled_dot_product_attention(
            qx, kx, vx, attn_mask=mask, is_causal=causal)
        gx = dout.transpose(1, 2)
        library = lambda: torch.autograd.grad(ox, (qx, kx, vx), gx,
                                              retain_graph=True)
        saved = nbytes(mask, lse, delta)
        keep(rows, "flash_attention_bwd_dq", compare(
            f"flash_attention_bwd_dq {label}",
            lambda q, k, v, dout: fab.flash_attention_bwd_dq(
                q, k, v, mask, lse, delta, dout, causal=causal),
            lambda *a: plain(*a)[0], (q, k, v, dout), card,
            flops=6 * hq * d * pairs, more_bytes=saved, library=library,
            scaled_atol=True), i == 0)
        keep(rows, "flash_attention_bwd_dkv", compare(
            f"flash_attention_bwd_dkv {label}",
            lambda q, k, v, dout: fab.flash_attention_bwd_dkv(
                q, k, v, mask, lse, delta, dout, causal=causal),
            lambda *a: torch.stack(plain(*a)[1:]), (q, k, v, dout), card,
            flops=8 * hq * d * pairs, more_bytes=saved, library=library,
            scaled_atol=True), i == 0)
        del q, k, v, dout, out, lse, delta, qx, kx, vx, ox, gx
        torch.cuda.empty_cache()
    m = TRAIN_BATCH * TRAIN_LEN
    for k, n in INT4_SHAPES:
        q, s = quant4.quantize_grouped(
            torch.randn((k, n), generator=g, device="cuda"))
        packed = quant4.pack_int4(q)
        del q
        w_bf = quant4.dequantize_bf16(packed, s)
        x = rnd(m, k)
        keep(rows, "int4_matmul_v1", compare(
            f"int4_matmul_v1 M={m} K={k} N={n}",
            lambda x: quant4.int4_matmul(x, packed, s),
            lambda x: quant4.int4_matmul_plain(x, packed, s), (x,), card,
            flops=2 * m * k * n, more_bytes=nbytes(packed, s),
            library=lambda: torch.mm(x, w_bf),
            route=lambda: quant4.dequant_matmul(x, packed, s),
            earlier=earlier_kernel("int4_matmul_v1", x, packed, s)),
            (k, n) == (4096, 14336))
        del packed, s, w_bf, x
        torch.cuda.empty_cache()
    return rows


def attention_bytes(qkv, mask):
    """The bytes encoder_attention must move: every query row and output
    row, the keys and values of valid keys only (a 64-key tile of padding
    is never loaded), the key mask."""
    _, b, h, s, d = qkv.shape
    row = h * d * qkv.element_size()
    return row * (2 * b * s + 2 * mask.sum().item()) + nbytes(mask)


def kernel_cases(s, g):
    """(name, kernel, plain, bf16 inputs, extra arguments, FLOP, library
    call or None, bytes or None, bare cuBLAS products or None) at B=8,
    sequence length s."""
    import torch
    import torch.nn.functional as tnf
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
    qkv = rnd(3, B, H, s, 64)
    # every query against the valid keys of its row
    pairs = s * mask.sum().item()
    qkv_in = (x, rnd(3, E, E, scale=E ** -0.5), rnd(3, E, scale=0.1), ln)
    out_in = (rnd(B, s, E, scale=0.5), rnd(E, E, scale=E ** -0.5),
              rnd(E, scale=0.1), x)
    ffn_in = (x, rnd(E, F, scale=E ** -0.5), rnd(F, scale=0.1),
              rnd(F, E, scale=F ** -0.5), rnd(E, scale=0.1), ln)
    # the bare products at the kernels' (M, K, N): x . W_qkv as one (E, 3E)
    # matrix; a . W_o; x . W1, then a bf16 (M, F) hidden . W2 (its own
    # generator: the draws above stay those of the kernels' inputs)
    x2 = x.reshape(B * s, E)
    a2 = out_in[0].reshape(B * s, E)
    w_cat = qkv_in[1].permute(1, 0, 2).reshape(E, 3 * E)
    hidden = torch.randn((B * s, F), device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED)).to(torch.bfloat16)
    return [
        ("ln_qkv_rope", fe.ln_qkv_rope, fe.ln_qkv_rope_plain, qkv_in,
         (cos, sin), 2 * B * s * E * 3 * E, None, None, lambda: x2 @ w_cat),
        ("encoder_attention", fe.encoder_attention,
         fe.encoder_attention_plain, (qkv,), (mask,), 4 * H * 64 * pairs,
         lambda: tnf.scaled_dot_product_attention(
             qkv[0], qkv[1], qkv[2], attn_mask=mask[:, None, None, :]),
         attention_bytes(qkv, mask), None),
        ("out_proj", fe.out_proj, fe.out_proj_plain, out_in, (),
         2 * B * s * E * E, None, None, lambda: a2 @ out_in[1]),
        ("ffn", fe.ffn, fe.ffn_plain, ffn_in, (), 4 * B * s * E * F, None,
         None, lambda: (x2 @ ffn_in[1], hidden @ ffn_in[3])),
    ]


def check_kernels(card):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    rows = {}
    for s in (128, 512):
        for (name, kern, plain, bf_in, extra, flops, lib,
             n_bytes, cublas) in kernel_cases(s, g):
            keep(rows, name, compare(f"{name} S={s}", kern, plain, bf_in,
                                     card, extra, flops=flops,
                                     n_bytes=n_bytes, library=lib,
                                     cublas=cublas), s == 512)
    return rows


KEYWORDS = ("Hydrolase", "Zinc", "Metal-binding", "Transferase",
            "ATP-binding", "Membrane", "Kinase")
FUNCTIONS = ("Catalyzes the hydrolysis of ATP to drive transport across "
             "membranes.", "Forms a channel that conducts potassium ions "
             "across the membrane.", "Acts as a chaperone assisting the "
             "folding of nascent polypeptides.")


def synthetic_examples(n, instruction="What are the UniProtKB keywords of "
                       "this protein?", answers=None):
    """n requests with proteins of 60-500 residues drawn from SEED; the
    ground truths cycle through `answers` (default: pairs of KEYWORDS) and
    draw nothing, so the proteins stay those of the seed."""
    import numpy as np
    from opus_pllm_tpu_torch.evals.datasets import AnnotationExample
    rng = np.random.default_rng(SEED)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    answers = answers or tuple(
        f"{KEYWORDS[i]}; {KEYWORDS[(i + 3) % len(KEYWORDS)]}"
        for i in range(len(KEYWORDS)))
    return [AnnotationExample(
        instruction, "".join(rng.choice(aa, int(rng.integers(60, 501)))),
        answers[i % len(answers)]) for i in range(n)]


def in_unit_range(values):
    import math
    return all(isinstance(v, float) and math.isfinite(v) and 0.0 <= v <= 1.0
               for v in values)


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
    expect_counts("slice", counts, flash_attention=cfg.llm.num_layers
                  * n_batches, **{n: cfg.esm.num_layers * n_batches
                                  for n in fe.launches})
    if len(rep.results) != len(examples) or not all(
            isinstance(r["generated"], str) for r in rep.results):
        fail("the runner did not answer every request")
    m = rep.metrics
    if set(m) != {"Precision", "Recall", "F1 Score"} or not in_unit_range(
            m.values()):
        fail(f"keywords metrics {m}")
    print(f"slice metrics: {m}", flush=True)
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


def wordpiece_vocab():
    """A WordPiece vocab made here (no file is read): [PAD] [UNK] [CLS]
    [SEP], the printable ASCII characters and their ## forms, every id
    below BertConfig().vocab_size."""
    chars = [chr(c) for c in range(33, 127)]
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + chars + [
        "##" + c for c in chars]
    return {t: i for i, t in enumerate(toks)}


def check_function_metrics(card, params, cfg, gen):
    """8 function-task requests, one batch, through the bf16 slice's
    params, scored with BERTScore over a full-width BioBERT-large shape
    (random fp32 weights from SEED) on the card (module docstring, phase
    5)."""
    import torch
    from opus_pllm_tpu_torch.core.config import BertConfig
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.evals.metrics import bertscore_from_embeddings
    from opus_pllm_tpu_torch.evals.textproc import WordPieceTokenizer
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.models import bert

    bcfg = BertConfig()
    vocab = wordpiece_vocab()
    if max(vocab.values()) >= bcfg.vocab_size:
        fail("the WordPiece vocab does not fit BioBERT's embedding")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    before = torch.cuda.memory_allocated()
    bparams = bert.init(bcfg, generator=g, device="cuda")
    torch.cuda.synchronize()
    gib = (torch.cuda.memory_allocated() - before) / 2**30
    embed = bert.make_embed_fn(bparams, bcfg, WordPieceTokenizer(vocab))
    spent = []

    def timed_embed(texts):
        t0 = time.perf_counter()
        out = embed(texts)
        spent.append(time.perf_counter() - t0)
        return out

    batch = 8
    examples = synthetic_examples(
        batch, "What is the function of this protein?", FUNCTIONS)
    reset_counts()
    rep = runner.run_annotation_eval(
        params, cfg, ByteTokenizer(), "synthetic_function.json", gen=gen,
        batch_size=batch, examples=examples, bert_embed_fn=timed_embed,
        log_fn=lambda *_: None)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("function metrics", counts,
                  flash_attention=cfg.llm.num_layers,
                  **{n: cfg.esm.num_layers for n in fe.launches})
    if len(rep.results) != batch:
        fail("the runner did not answer every function request")
    m = rep.metrics
    print(f"function metrics: {m}", flush=True)
    if set(m) != {"ROUGEScore", "BLEU", "METEOR", "BERTScore"} or \
            m["BERTScore"] is None or not in_unit_range(
                [*m["ROUGEScore"].values(), m["BLEU"], m["METEOR"],
                 *m["BERTScore"].values()]):
        fail(f"function metrics {m}")
    emb, mask = embed([ex.output for ex in examples[:3]])
    same = bertscore_from_embeddings(emb, mask, emb, mask)
    print(f"BERTScore of a text against itself {same}", flush=True)
    if abs(same["f1"] - 1.0) > 1e-5:
        fail(f"BERTScore of a text against itself is {same['f1']}")
    print(f"BioBERT-large shape ({bcfg.num_layers} x {bcfg.hidden_size}, "
          f"fp32): {gib:.2f} GiB on the card, {sum(spent):.2f} s to embed "
          f"{2 * batch} texts in {len(spent)} calls; {len(rep.results)} "
          f"entries in {rep.seconds:.2f} s [{card}]", flush=True)
    del bparams, embed
    torch.cuda.empty_cache()
    return counts


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if hasattr(tree, "clone") else tree


def _norms_to_fp32(llm):
    """The decoder tree with its embedding and norms in fp32; projections
    (bf16, int8 or int4 leaves) stay as they are."""
    small = ("embed_tokens", "final_norm", "attn_norm", "ffn_norm")
    if isinstance(llm, list):
        return [_norms_to_fp32(v) for v in llm]
    if not isinstance(llm, dict):
        return llm
    return {k: ({kk: vv.float() for kk, vv in v.items()} if k in small
                else _norms_to_fp32(v)) for k, v in llm.items()}


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
        lg, _ = decoder.forward(_norms_to_fp32(llm), dataclasses.replace(
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
        expect_counts(
            f"{kind} cache", counts,
            int4_matmul=n_batches + steps * per_step,
            flash_attention=cfg.llm.num_layers * n_batches,
            **{f"decode_attention_{kind}": steps * cfg.llm.num_layers},
            **{n: cfg.esm.num_layers * n_batches for n in fe.launches})
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


def check_prefill_group(params, cfg, examples):
    """One admission group's prefill as the serving engine runs it (the
    valid tails of the spliced prompts, zero-padded to one bucket, the
    admission mask, a scratch cache), then the head on each row's last
    position: kernels (impl="auto", bf16: flash_attention and int8_matmul)
    and plain (impl="torch", bf16) against the plain path in fp32 (fp32
    activations, embedding and norms; the same int8 weights)."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.core.util import round_up
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.models import decoder, opus
    from opus_pllm_tpu_torch.serve.engine import admission_inputs
    n = len(examples)
    ids, mask, esm_toks = runner._prepare_inputs(
        ByteTokenizer(), [runner.annotation_prompt(runner.ds.instruction_for(
            e, "synthetic_keywords.json")) for e in examples],
        [e.sequence for e in examples], prompt_bucket=64, esm_bucket=128,
        device="cuda")
    llm, lcfg = params["llm"], cfg.llm
    with torch.no_grad():
        sp = opus.splice_prompt_left(params, cfg, ids, mask, esm_toks)
        n_valid = sp.mask.sum(1)
        bucket = round_up(int(n_valid.max()), 64)
        embs = torch.zeros((n, bucket, lcfg.hidden_size), dtype=sp.embeds.dtype,
                           device="cuda")
        for r in range(n):
            tail = sp.embeds[r, sp.mask[r]]
            embs[r, :tail.shape[0]] = tail
        pos, mask4 = admission_inputs(n_valid, bucket)
        rows = torch.arange(n, device="cuda")

        def last_logits(tree, c, x, impl):
            cache = decoder.init_cache(c, n, bucket, device="cuda")
            hid, _ = decoder.forward(tree, c, x, pos, mask4, cache,
                                     impl=impl, return_hidden=True)
            h = hid[rows, n_valid - 1][:, None]
            return decoder.head_logits(tree, c, h, impl=impl)[:, 0].float()

        got = last_logits(llm, lcfg, embs, "auto")
        plain = last_logits(llm, lcfg, embs, "torch")
        ref = last_logits(_norms_to_fp32(llm),
                          dataclasses.replace(lcfg, dtype="float32"),
                          embs.float(), "torch")
    err = (got - ref).abs().max().item()
    err_plain = (plain - ref).abs().max().item()
    tol = 2 * err_plain + ATOL
    print(f"serving prefill group ({n} rows, bucket {bucket}, M = "
          f"{n * bucket}): vs fp32 plain: kernels {err:.3e}, bf16 plain "
          f"{err_plain:.3e} (tol {tol:.3e}); max|logit| "
          f"{ref.abs().max().item():.3e}", flush=True)
    if not (torch.isfinite(got).all() and err <= tol):
        fail(f"serving prefill through the kernels: {err:.3e} from the fp32 "
             f"plain path, above {tol:.3e}")


def check_serve_slice(card, params, cfg, gen):
    """The int8 LLM behind the serving engine: 32 requests with a bf16
    cache, 8 with an int8 cache (module docstring, phase 7)."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.kernels import quant, quant4
    from opus_pllm_tpu_torch.models import decoder

    params["llm"] = None                      # the int4 LLM of phase 6
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    t0 = time.perf_counter()
    params["llm"] = quant.quantize_decoder(
        decoder.init(cfg.llm, generator=g, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    layout = quant4.quant_layout_of(params["llm"])
    print(f"init + quantize_decoder {time.perf_counter() - t0:.1f} s, "
          f"layout {layout}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"of weights on the card", flush=True)
    if layout != "int8":
        fail(f"quantized LLM has layout {layout}")
    tok, splice_batch = ByteTokenizer(), 8
    examples = synthetic_examples(SERVE_REQUESTS)
    layers = cfg.llm.num_layers
    stats = {}
    for kind, n_req in ((False, SERVE_REQUESTS), ("int8", 8)):
        label = f"{kind or 'bf16'} cache"
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rep = runner.run_annotation_eval_engine(
            params, cfg, tok, "synthetic_keywords.json",
            gen=dataclasses.replace(gen, quantize_cache=kind),
            max_slots=SERVE_SLOTS, steps_per_tick=SERVE_STEPS,
            splice_batch=splice_batch, examples=examples[:n_req],
            log_fn=lambda *_: None)
        torch.cuda.synchronize()
        counts = read_counts()
        eng = rep.engine
        prefills, steps = eng["prefills"], eng["decode_steps"]
        want = {n: cfg.esm.num_layers * -(-n_req // splice_batch)
                for n in fe.launches}
        if kind:
            want[f"decode_attention_{kind}"] = layers * steps
        expect_counts(f"serving, {label}", counts,
                      flash_attention=layers * prefills,
                      int8_matmul=7 * layers * prefills, **want)
        if len(rep.results) != n_req or eng["completions"] != n_req \
                or not all(isinstance(r["generated"], str)
                           for r in rep.results):
            fail(f"serving, {label}: not every request was answered")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"serving slice, int8 weights + {label}: {n_req} entries in "
              f"{rep.seconds:.2f} s, entries/s {rep.entries_per_sec:.3f}; "
              f"{rep.decode_tokens} tokens in {rep.decode_seconds:.2f} s of "
              f"engine time = {rep.decode_tokens / rep.decode_seconds:.1f} "
              f"tok/s; {prefills} prefills, {eng['ticks']} ticks "
              f"({steps} decode steps), {eng['parked']} parked; TTFT p50 <= "
              f"{eng['ttft_p50']} s, p99 <= {eng['ttft_p99']} s, mean "
              f"{eng['ttft_mean']:.3f} s; peak {peak:.2f} GiB on the card "
              f"[{card}]", flush=True)
        print(f"sample output: {rep.results[0]['generated'][:60]!r}",
              flush=True)
        stats[label] = counts
    check_prefill_group(params, cfg, examples[:SERVE_SLOTS])
    return stats["bf16 cache"]


def train_records(n, tok):
    """n synthetic train-lora records: the keywords question followed by
    protein context, sized so that the tokenized prompt is 460-500 tokens,
    a protein of 60-500 residues and a 24-64-token answer (with the
    leading space and EOS), so most records pass the 512-token cap."""
    import numpy as np
    from opus_pllm_tpu_torch.infer.conversation import annotation_prompt
    from opus_pllm_tpu_torch.infer.tokenization import tokenize_with_seq
    rng = np.random.default_rng(SEED)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    words = ["Membrane", "Transport", "Zinc", "Kinase", "Nucleus",
             "Transmembrane helix", "Hydrolase", "Metal-binding", "Signal"]
    question = "What are the UniProtKB keywords of this protein?"
    context = (" The protein was isolated from a soil bacterium; its gene "
               "lies next to an ABC transporter operon and it is expressed "
               "under zinc limitation.") * 8
    base = len(tokenize_with_seq(annotation_prompt("<seq>\n" + question),
                                 tok.encode, tok.bos_token_id))
    recs = []
    for _ in range(n):
        extra = int(rng.integers(460, 501)) - base
        answer = "; ".join(rng.choice(words, 12))[:int(rng.integers(22, 63))]
        recs.append({"instruction": question + context[:extra],
                     "input": "".join(rng.choice(aa, int(rng.integers(
                         60, 501)))),
                     "output": answer})
    return recs


def _lora_b(trainable):
    return [ab["B"] for lp in trainable["lora"]["layers"]
            for ab in lp.values()]


def run_training(label, card, params, cfg, tcfg, lcfg, batches, want):
    """`fit` over `batches` from fresh LoRA adapters (module docstring,
    phase 8); checks the launch counts against `want` (per step), a finite
    loss every step and every LoRA B leaf moved by step 1. Returns the
    launch counts."""
    import math
    import torch
    from opus_pllm_tpu_torch.core.config import IGNORE_INDEX
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
    steps = len(batches)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    state, tx = mmt.create_state(cfg, tcfg, params, generator=g,
                                 train_switch=False, lora_cfg=lcfg,
                                 total_steps=steps, device="cuda")
    b0 = [t.detach().clone() for t in _lora_b(state.trainable)]
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() / 2**30
    stamps, losses = [], []

    def log(line):
        stamps.append(time.perf_counter())
        losses.append(float(line.split("loss=")[1]))
        if len(losses) == 1:
            still = sum(bool(torch.equal(a, b)) for a, b in
                        zip(b0, _lora_b(state.trainable)))
            if still:
                fail(f"{label}: {still} LoRA B leaves unchanged by step 1")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = mmt.fit(state, tx, cfg, tcfg, params, batches, lora_cfg=lcfg,
                    log_fn=log, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts(f"training, {label}", counts,
                  **{n: steps * c for n, c in want.items()})
    if state.step != steps or len(losses) != steps or not all(
            math.isfinite(x) for x in losses):
        fail(f"{label}: losses {losses} after {state.step} steps")
    walls = [b - a for a, b in zip([t0] + stamps, stamps)]
    per_step = sum(walls[1:]) / (steps - 1)
    tokens = sum(int((b["labels"] != IGNORE_INDEX).sum()) for b in batches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"training, {label}: {steps} steps, losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + "; step walls " + ", ".join(f"{w:.3f}" for w in walls)
          + f" s; {per_step:.3f} s/step after the first; "
          f"{tokens / steps / per_step:.1f} trained tokens/s "
          f"({tokens // steps} valid label tokens a step); "
          f"{weights:.2f} GiB on the card with the weights in place, peak "
          f"{peak:.2f} GiB [{card}]", flush=True)
    return counts


def _gate_grads(trainable, frozen, cfg, batch, ls, tcfg, impl):
    import torch
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
    tr = {"lora": mmt._trainable_copy(trainable["lora"])}
    loss, _ = mmt.loss_fn(tr, frozen, cfg, batch, ls, tcfg.remat_mode,
                          tcfg.ce_chunk, impl)
    return [t.float() for t in torch.autograd.grad(loss, mmt.leaves(tr))]


def gradient_gate(params, cfg, tcfg, lcfg, batch):
    """The LoRA gradients of loss_fn through the kernels vs the plain path
    in fp32 (module docstring, phase 8), at depth GATE_LAYERS."""
    import dataclasses
    import torch
    from opus_pllm_tpu_torch.lora import lora as lora_mod
    from opus_pllm_tpu_torch.models import esm2
    llm = dict(params["llm"], layers=params["llm"]["layers"][:GATE_LAYERS])
    cfg4 = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=GATE_LAYERS))
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    lora = lora_mod.init(cfg4.llm, lcfg, generator=g, device="cuda")
    for lp in lora["layers"]:
        for ab in lp.values():
            ab["B"].normal_(0.0, 0.01, generator=g)
    rows = {k: torch.as_tensor(v[:GATE_ROWS]).cuda() for k, v in batch.items()
            if k != "esm_tokens"}
    with torch.no_grad():
        esm = torch.as_tensor(batch["esm_tokens"][:GATE_ROWS]).cuda()
        rows["pooled_emb"] = esm2.pooled_embedding(
            params["esm"], cfg.esm, esm[:, 0]).float()[:, None]
    ls = lora_mod.scaling(lcfg)
    frozen = dict(params, llm=llm)
    got = _gate_grads({"lora": lora}, frozen, cfg4, rows, ls, tcfg, "auto")
    plain = _gate_grads({"lora": lora}, frozen, cfg4, rows, ls, tcfg, "torch")
    cfg32 = dataclasses.replace(cfg4, llm=dataclasses.replace(
        cfg4.llm, dtype="float32"))
    ref = _gate_grads({"lora": lora}, dict(params, llm=_to_fp32(llm)), cfg32,
                      rows, ls, tcfg, "torch")
    rel = lambda a, r: ((a - r).abs().max() / r.abs().max()).item()
    err = max(rel(a, r) for a, r in zip(got, ref))
    err_plain = max(rel(a, r) for a, r in zip(plain, ref))
    bound = 2 * err_plain + ATOL
    print(f"gradient gate ({GATE_LAYERS} layers, {GATE_ROWS} rows of "
          f"{rows['input_ids'].shape[1]} prompt tokens, {len(ref)} LoRA "
          f"leaves), "
          f"max error in units of each leaf's largest entry vs fp32 plain: "
          f"kernels {err:.3e}, bf16 plain {err_plain:.3e} (bound "
          f"{bound:.3e})", flush=True)
    if not (all(torch.isfinite(a).all() for a in got) and err <= bound):
        fail(f"gradient gate: kernels {err:.3e} from the fp32 plain path, "
             f"above {bound:.3e}")


def check_train_slice(card, params, cfg):
    """Phase 7 (module docstring): `train-lora` over the bf16 LLM, the
    gradient gate, then QLoRA over its v1 quantization."""
    import itertools
    import json as _json
    import tempfile
    import torch
    from opus_pllm_tpu_torch.core.config import LoRAConfig, TrainConfig
    from opus_pllm_tpu_torch.data.collate import instruction_batches
    from opus_pllm_tpu_torch.data.datasets import InstructionDataset
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import fused_encoder as fe
    from opus_pllm_tpu_torch.kernels import quant4
    from opus_pllm_tpu_torch.models import decoder

    params["llm"] = None                      # the int8 LLM of phase 7
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    t0 = time.perf_counter()
    params["llm"] = decoder.init(cfg.llm, generator=g, device="cuda")
    torch.cuda.synchronize()
    print(f"init {time.perf_counter() - t0:.1f} s", flush=True)
    tok = ByteTokenizer()
    tcfg = TrainConfig(learning_rate=2e-5, weight_decay=0.0,
                       batch_size=TRAIN_BATCH, remat="full", ce_chunk=0,
                       grad_accum=1, log_every=1)
    lcfg = LoRAConfig(rank=16, alpha=32.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.json")
        with open(path, "w") as f:
            _json.dump(train_records(TRAIN_RECORDS, tok), f)
        batches = list(itertools.islice(instruction_batches(
            InstructionDataset(path), tok, TRAIN_BATCH, seed=SEED,
            max_len=TRAIN_MAX_LEN), TRAIN_STEPS_BF16))
    lengths = {b["input_ids"].shape[1] + cfg.switch.n_tokens - 1
               for b in batches}
    if lengths != {TRAIN_LEN}:
        fail(f"training batches reach decoder lengths {lengths}, not "
             f"{TRAIN_LEN}")
    layers = cfg.llm.num_layers
    base = {"flash_attention": 2 * layers,
            "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers,
            **{n: cfg.esm.num_layers for n in fe.launches}}
    counts = run_training("bf16 LLM", card, params, cfg, tcfg, lcfg, batches,
                          base)
    gradient_gate(params, cfg, tcfg, lcfg, batches[0])

    t0 = time.perf_counter()
    params["llm"] = quant4.quantize_decoder4(params["llm"], layout="v1")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    layout = quant4.quant_layout_of(params["llm"])
    print(f"quantize_decoder4(layout='v1') {time.perf_counter() - t0:.1f} s, "
          f"layout {layout}", flush=True)
    if layout != "int4-v1" or any(
            p.dtype != torch.int8 for p in
            [params["llm"]["lm_head"]["kernel_p"]]
            + [lp[t]["kernel_p"] for lp in params["llm"]["layers"]
               for t in lcfg.target_modules]):
        fail(f"the QLoRA LLM is not v1 everywhere ({layout})")
    qcounts = run_training(
        "int4-v1 LLM (QLoRA)", card, params, cfg, tcfg, lcfg,
        batches[:TRAIN_STEPS_QLORA],
        dict(base, int4_matmul_v1=2 * 7 * layers + 1))
    return counts, qcounts


def profile_serving(card):
    """The serving slice's device-time breakdown (module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opus_pllm_tpu_torch.core.config import (ESM2Config, GenerationConfig,
                                                 OpusConfig)
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import quant
    from opus_pllm_tpu_torch.models import opus

    cfg = OpusConfig(esm=ESM2Config(dtype="bfloat16"))
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    params = opus.init(cfg, generator=g, device="cuda")
    params["llm"] = quant.quantize_decoder(params["llm"])
    torch.cuda.empty_cache()
    tok = ByteTokenizer()
    gen = GenerationConfig(max_new_tokens=64, temperature=0.1, top_p=0.7,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id, seed=SEED)
    examples = synthetic_examples(SERVE_REQUESTS)

    def run(n):
        rep = runner.run_annotation_eval_engine(
            params, cfg, tok, "synthetic_keywords.json", gen=gen,
            max_slots=SERVE_SLOTS, steps_per_tick=SERVE_STEPS,
            examples=examples[:n], log_fn=lambda *_: None)
        torch.cuda.synchronize()
        print(f"{n} requests: {rep.seconds:.3f} s wall, engine "
              f"{rep.decode_seconds:.3f} s for {rep.engine['decode_steps']} "
              f"decode steps and {rep.engine['prefills']} prefills "
              f"[{card}]", flush=True)

    for _ in range(2):
        run(SERVE_REQUESTS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(SERVE_SLOTS)
        wall = 1e3 * (time.perf_counter() - t0)
    # casts and multiplies: mostly the M=17 dequantize route's
    # int8->bf16 cast and scale multiply, with every other cast / multiply
    print_profile(prof, wall, card, {
        "casts (direct_copy_kernel)": "direct_copy_kernel",
        "multiplies (MulFunctor)": "MulFunctor",
        "int8_matmul_wgmma_kernel": "int8_matmul_wgmma_kernel",
        "flash_fwd_wgmma_kernel": "flash_fwd_wgmma_kernel",
        "flash mask packing (pack_row_words)": "pack_row_words",
        "cuBLAS (nvjet / gemm)": ("nvjet", "gemmSN", "gemv")})


def print_profile(prof, wall, card, groups):
    """Device time against the profiled wall `wall` (ms), summed per group
    of kernel-name keys, then the kernels with the most device time."""
    # device kernels and copies only: a CPU op's self device time repeats
    # the time of the kernels it launched
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA") and dev(e) > 0),
                     key=dev, reverse=True)
    busy = sum(dev(e) for e in kernels)
    print(f"profiled: {wall:.1f} ms wall, {busy:.1f} ms of device time in "
          f"{sum(e.count for e in kernels)} kernels and copies ("
          f"{100 * busy / wall:.1f}% of the profiled wall) [{card}]",
          flush=True)
    for label, keys in groups.items():
        keys = (keys,) if isinstance(keys, str) else keys
        hit = [e for e in kernels if any(k in e.key for k in keys)]
        print(f"  {label:38s} {sum(dev(e) for e in hit):10.3f} ms in "
              f"{sum(e.count for e in hit)} launches", flush=True)
    for e in kernels[:20]:
        print(f"  {dev(e):10.3f} ms  {e.count:7d} x  {e.key[:100]}",
              flush=True)


def profile_training(card):
    """The training slice's device-time breakdown (module docstring): one
    bf16 step and one QLoRA step under torch.profiler, each after two
    unprofiled steps."""
    import itertools
    import json as _json
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opus_pllm_tpu_torch.core.config import (ESM2Config, LoRAConfig,
                                                 OpusConfig, TrainConfig)
    from opus_pllm_tpu_torch.data.collate import instruction_batches
    from opus_pllm_tpu_torch.data.datasets import InstructionDataset
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import quant4
    from opus_pllm_tpu_torch.models import opus
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt

    cfg = OpusConfig(esm=ESM2Config(dtype="bfloat16"))
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    params = opus.init(cfg, generator=g, device="cuda")
    tok = ByteTokenizer()
    tcfg = TrainConfig(learning_rate=2e-5, weight_decay=0.0,
                       batch_size=TRAIN_BATCH, remat="full", ce_chunk=0,
                       grad_accum=1, log_every=1)
    lcfg = LoRAConfig(rank=16, alpha=32.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.json")
        with open(path, "w") as f:
            _json.dump(train_records(TRAIN_RECORDS, tok), f)
        batches = list(itertools.islice(instruction_batches(
            InstructionDataset(path), tok, TRAIN_BATCH, seed=SEED,
            max_len=TRAIN_MAX_LEN), 3))
    groups = {
        "flash_fwd_wgmma_kernel (forward + recompute)":
            "flash_fwd_wgmma_kernel",
        "flash_bwd_dq_wgmma_kernel": "flash_bwd_dq_wgmma_kernel",
        "flash_bwd_dkv_wgmma_kernel": "flash_bwd_dkv_wgmma_kernel",
        "flash mask packing (pack_row / col_words)": ("pack_row_words",
                                                      "pack_col_words"),
        "int4_v1_wgmma_kernel": "int4_v1_wgmma_kernel",
        "encoder kernels (fused_encoder.cu)": (
            "bf16_gemm_kernel", "bf16_gemm_io_kernel", "ln_rows_kernel",
            "encoder_attn_wgmma_kernel", "pack_key_words"),
        "cuBLAS bf16 (nvjet)": "nvjet",
        "cuBLAS fp32 (xmma_gemm_f32: LoRA, fp32 head)": "gemm_f32",
        "casts (direct_copy / bfloat16_copy)": ("direct_copy_kernel",
                                                "bfloat16_copy_kernel"),
        "adds (CUDAFunctor_add)": "CUDAFunctor_add",
        "other elementwise (Unary / BinaryFunctor)": ("AUnaryFunctor",
                                                      "BinaryFunctor",
                                                      "MulFunctor"),
        "softmax / log_softmax": ("SoftMax", "softmax")}
    for label in ("bf16 LLM", "int4-v1 LLM (QLoRA)"):
        if label.startswith("int4"):
            params["llm"] = quant4.quantize_decoder4(params["llm"],
                                                     layout="v1")
            torch.cuda.empty_cache()
        state, tx = mmt.create_state(cfg, tcfg, params, generator=g,
                                     train_switch=False, lora_cfg=lcfg,
                                     device="cuda")
        step = mmt.make_train_step(cfg, tx, lora_cfg=lcfg,
                                   remat=tcfg.remat_mode)
        placed = [mmt.place(b, "cuda") for b in batches]
        for b in placed[:2]:
            step(state, params, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, params, placed[2])
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        print(f"training step, {label}:", flush=True)
        print_profile(prof, wall, card, groups)


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    for flag in ("--kernel-times", "--flash-times", "--decode-times",
                 "--encoder-times"):
        if flag in sys.argv[1:]:
            kernel_times(flag, sys.argv[sys.argv.index(flag) + 1:]
                         or [os.path.dirname(os.path.abspath(__file__))])
            return
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
    if "--profile-serving" in sys.argv[1:]:
        phase("serving profile")
        profile_serving(card)
        return
    if "--profile-training" in sys.argv[1:]:
        phase("training profile")
        profile_training(card)
        return

    phase("kernels vs plain")
    rows = check_kernels(card)
    rows.update(check_quant_kernels(card))
    rows.update(check_serve_kernels(card))
    rows.update(check_train_kernels(card))

    phase("slice")
    counts, params, cfg, examples, gen = check_slice(card)

    phase("function metrics")
    check_function_metrics(card, params, cfg, gen)

    phase("quantized slice")
    qcounts = check_quant_slice(card, params, cfg, examples, gen)

    phase("serving slice")
    scounts = check_serve_slice(card, params, cfg, gen)

    phase("training slice")
    tcounts, qlora_counts = check_train_slice(card, params, cfg)

    kernels = [{"name": n, "route": "cuda", "source": SOURCE,
                "replaces": TPU_KERNELS[n], "launches": counts[n]}
               for n in TPU_KERNELS]
    kernels += [{"name": n, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": qcounts["int8" if n.endswith("int8")
                                     else "int4"][n]}
                for n, (tpu, src) in QUANT_KERNELS.items()]
    kernels += [{"name": n, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": scounts[n]}
                for n, (tpu, src) in SERVE_KERNELS.items()]
    kernels += [{"name": n, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": (qlora_counts if n == "int4_matmul_v1"
                              else tcounts)[n]}
                for n, (tpu, src) in TRAIN_KERNELS.items()]
    for k in kernels:
        k.update({key: rows[k["name"]][key]
                  for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "route_ms")
                  if key in rows[k["name"]]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
