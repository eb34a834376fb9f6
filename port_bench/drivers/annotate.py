"""Batch annotation: `evals/runner`'s static path, batch after batch.

Each batch goes the way `run_annotation_eval` takes it: the prefetch thread
prepares batch i + 1 (prompt, tokenization, bucket padding, the copy to
the card) while batch i is spliced (ESM2 -> CSTP -> switch -> splice) and
generated by `infer/engine.generate` (prefill, then the decode loop), and
the texts are cut at the separator. Every batch samples as the task's
`GenerationConfig` says; the window runs batches until `seconds` have
passed. A CUDA event after each batch gives its length on the device's
clock, which the per-layer metrics read.

Check, on `check_rows` rows of the first window batch drawn from the seed,
teacher-forced through the fp32 reference over the prompt and the served
tokens, with the program's logits read where the decode loop hands them to
its sampler at the `capture_steps` (step 0 is the prefill's, the rest come
through the cache):

- `logit_rel_err`: the worst relative L2 distance of the program's logits
  from the reference's, over the captured (step, row) pairs. A decode
  step that feeds the wrong token moves the logits of the steps after it;
- `nucleus_gap`: the widest gap by which a served token's reference logit
  lies below the reference's own nucleus at the task's temperature and
  top_p (0 for a token inside it), over every served token of those rows:
  a token altered where it is sampled lies far outside.

With the control, the reference in float8 takes the program's place: its
logits at the same positions, and at each position a token drawn from its
own nucleus.
"""

from __future__ import annotations

import contextlib
import time

import torch

from port_bench.drivers import common
from port_bench.reference import model as ref
from port_bench.reference.prompts import annotation_prompt
from port_bench.yardstick import traffic, work
from port_bench.yardstick.instrument import Tracer


class Driver:
    def __init__(self, conf, mix, seed, device, control=False):
        self.conf, self.mix, self.seed = conf, mix, int(seed)
        self.device = torch.device(device)
        self.control = control
        self.task = mix["task"]
        self.task_file = f"{self.task}.json"
        self.batches = []     # per window batch: its record
        self.served = None    # (tokens, lengths) of window batch 0
        self.capture = None   # window batch 0's _Capture

    # ---- set-up ----------------------------------------------------------

    def setup(self):
        from opus_pllm_tpu_torch.core.config import GenerationConfig
        from opus_pllm_tpu_torch.evals import datasets as ds
        from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
        from opus_pllm_tpu_torch.models import decoder

        self.cfg, self.spec = common.program_config(self.conf)
        if self.device.type == "cuda":
            from opus_pllm_tpu_torch.kernels import build
            build.build_all()
        params = common.draw_weights(self.conf, self.spec, self.seed,
                                     self.device)
        # generation decodes on one [q|k|v] and one [gate|up] product a
        # layer, as the CLI's model build fuses them
        layers = params["llm"]["layers"]
        for i, lp in enumerate(layers):
            layers[i] = decoder.fuse_layer(lp)
        self.params = params
        self.tok = ByteTokenizer()
        self.gen = GenerationConfig(
            max_new_tokens=ds.max_new_tokens_for(self.task_file),
            eos_token_id=self.tok.eos_token_id,
            pad_token_id=self.tok.pad_token_id, seed=self.seed)
        self.examples = []
        for i in range(self.mix["batches_max"]):
            self.examples.extend(
                ds.AnnotationExample(ins, seq, "")
                for ins, seq in traffic.annotate_batch(self.mix, self.seed,
                                                       i))
        # warm-up: one batch of the cell's shapes (eager kernels: nothing
        # compiles per shape)
        warm = [ds.AnnotationExample(ins, seq, "") for ins, seq in
                traffic.annotate_batch(self.mix, self.seed, 10 ** 6)]
        self._run_batches(warm, stop=lambda bi: False)
        common.sync(self.device)

    def _prompt_of(self, e):
        from opus_pllm_tpu_torch.evals import datasets as ds
        from opus_pllm_tpu_torch.infer.conversation import (VICUNA_V0,
                                                            annotation_prompt)
        return annotation_prompt(ds.instruction_for(e, self.task_file),
                                 VICUNA_V0)

    def _run_batches(self, examples, stop, on_batch=None, around=None):
        from opus_pllm_tpu_torch.evals import runner
        it = runner._prefetched_batches(
            examples, self.mix["batch"], self._prompt_of, self.tok,
            prompt_bucket=self.mix["prompt_bucket"],
            esm_bucket=self.mix["esm_bucket"], device=self.device)
        try:
            for chunk, n_real, bi, (ids, mask, esm_toks) in it:
                with (around and around(bi)) or contextlib.nullcontext():
                    _, out = runner._generate_spliced(
                        self.params, self.cfg, self.tok, ids, mask, esm_toks,
                        self.gen, impl="auto", batch_index=bi)
                if on_batch is not None:
                    on_batch(bi, out)
                if stop(bi):
                    break
        finally:
            it.close()

    # ---- window ----------------------------------------------------------

    def window(self, seconds: float, tracer=None) -> dict:
        marks = [_mark(self.device)]
        t0 = time.perf_counter()
        ends = []

        def on_batch(bi, out):
            t = time.perf_counter() - t0
            marks.append(_mark(self.device))
            ends.append(t)
            self.batches.append({"index": bi, "rows": self.mix["batch"],
                                 "steps": out.steps,
                                 "decode_s": out.decode_seconds,
                                 "end_s": t, "lengths": out.lengths,
                                 "traced": (tracer is not None
                                            and bi == tracer.batch)})
            if bi == 0:
                self.served = (out.tokens, out.lengths)
            if tracer is not None and bi == tracer.batch:
                tracer.lengths = out.lengths.cpu().tolist()

        def stop(bi):
            return ends[-1] >= seconds and (tracer is None
                                            or bi >= tracer.batch)

        def around(bi):
            if bi == 0:
                self.capture = _Capture(self._check_rows(),
                                        self.mix["capture_steps"],
                                        self.device)
                return self.capture
            if tracer is not None and bi == tracer.batch:
                return tracer.profiled(self.device)
            return None

        self._run_batches(self.examples, stop, on_batch, around=around)
        # after the window: each batch's length on the device's clock (the
        # host's where there is no card) and the FLOPs its data needs
        common.sync(self.device)
        for i, bt in enumerate(self.batches):
            bt["device_s"] = (marks[i].elapsed_time(marks[i + 1]) / 1e3
                              if marks[0] is not None
                              else bt["end_s"] - (ends[i - 1] if i else 0.0))
            bt["lengths"] = bt["lengths"].cpu().tolist()
            bt["flops"] = self.model_flops(bt["index"], bt["lengths"])
        rows = sum(b["rows"] for b in self.batches)
        return {"batches": self.batches, "window_s": ends[-1],
                "attempted": rows, "failed": 0}

    # ---- traced sub-window -------------------------------------------------

    def tracer(self):
        # two batches before the profiled one, for the readers that take
        # the unprofiled batches' lengths
        return Tracer(batch=2)

    def model_flops(self, bi: int, lengths) -> float:
        """FLOPs the data of window batch `bi` needs: ESM2 over each
        protein, the bridge, the prefill over each prompt's valid
        positions (head at the last), and one decode forward per served
        token after the first."""
        spec = self.spec
        b = self.mix["batch"]
        rows = self.examples[bi * b:(bi + 1) * b]
        f = 0.0
        for e, t in zip(rows, lengths):
            n_p = len(ref.byte_ids(self._prompt_of(e))) + spec["n_tokens"] \
                - 1
            f += work.esm_flops(spec, len(e.sequence) + 2)
            f += work.bridge_flops(spec)
            f += work.decoder_flops(spec, n_p, n_p * (n_p + 1) / 2)
            f += work.head_flops(spec, 1)
            steps = max(int(t) - 1, 0)
            ctx = steps * n_p + steps * (steps + 1) / 2
            f += work.decoder_flops(spec, steps, ctx)
            f += work.head_flops(spec, steps)
        return f

    # ---- check ---------------------------------------------------------------

    def _check_rows(self):
        r = traffic.rng(self.seed, 7)
        return sorted(r.choice(self.mix["batch"], size=min(
            self.mix["check_rows"], self.mix["batch"]), replace=False)
            .tolist())

    def check(self) -> dict:
        cap = self.capture
        toks, lens = (t.cpu() for t in self.served)
        rows = cap.rows_list
        served = [toks[r, :int(lens[r])].tolist() for r in rows]
        exs = [self.examples[r] for r in rows]
        prompts = [ref.byte_ids(annotation_prompt(e.instruction, self.task))
                   for e in exs]
        proteins = [e.sequence for e in exs]
        prog = {k: v.cpu() for k, v in cap.logits.items()}
        # the program's state goes before the reference draws its copy
        self.params = self.capture = self.served = None
        common.free_device()
        ref.no_tf32()
        w = common.draw_weights(self.conf, self.spec, self.seed, self.device)
        temp, top_p = self.gen.temperature, self.gen.top_p
        with torch.no_grad():
            lg = ref.position_logits(w, self.spec, prompts, proteins, served,
                                     ref.Precision("fp32"))
            out = _readings(prog, served, lg, temp, top_p)
            if not self.control:
                return out
            # the control in the program's place: the float8 reference's
            # logits at the captured steps, and at each position a token
            # drawn from its own nucleus
            cl = ref.position_logits(w, self.spec, prompts, proteins,
                                     served, ref.Precision("fp8"))
            ctl = {k: torch.stack([c[min(k, c.shape[0] - 1)].cpu()
                                   for c in cl]) for k in prog}
            g = torch.Generator(device=self.device)
            g.manual_seed(self.seed % 2 ** 63)
            drawn = [ref.nucleus_sample(c, temp, top_p, g).tolist()
                     for c in cl]
            ctl_out = _readings(ctl, drawn, lg, temp, top_p)
        ctl_out.update({f"program_{k}": v for k, v in out.items()})
        return ctl_out


def _mark(device):
    """A CUDA event recorded now on the current stream (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _readings(logits: dict, tokens, ref_logits, temp: float,
              top_p: float) -> dict:
    """The numbers compared, of `logits` {step: (rows, V)} read at the
    captured steps and `tokens` served per row, against the reference's
    per-row (T, V) logits over the same prompts and served tokens."""
    worst = 0.0
    for step, lg in logits.items():
        for i, rl in enumerate(ref_logits):
            if step < rl.shape[0]:
                want = rl[step].cpu()
                worst = max(worst, float((lg[i] - want).norm()
                                         / want.norm()))
    gap = max(float(ref.nucleus_gaps(rl, t, temp, top_p).max())
              for rl, t in zip(ref_logits, tokens))
    return {"logit_rel_err": worst, "nucleus_gap": gap,
            "compared_tokens": sum(len(t) for t in tokens)}


class _Capture:
    """One batch's view of its decode loop, read where
    `infer/engine.generate` hands each step's fp32 logits to its sampler:
    the logits of `rows` at `steps` (kept on the card until the window has
    closed)."""

    def __init__(self, rows, steps, device):
        self.rows_list = list(rows)
        self.rows = torch.tensor(self.rows_list, dtype=torch.long,
                                 device=device)
        self.steps = set(steps)
        self.logits = {}

    def __enter__(self):
        from opus_pllm_tpu_torch.infer import engine
        self._engine, self._orig = engine, engine.advance_sampling

        def advance_sampling(step, done, cur_logits, *a, **k):
            if step in self.steps:
                self.logits[step] = cur_logits[self.rows].float().clone()
            return self._orig(step, done, cur_logits, *a, **k)
        engine.advance_sampling = advance_sampling
        return self

    def __exit__(self, *exc):
        self._engine.advance_sampling = self._orig
        return False
