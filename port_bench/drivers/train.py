"""LoRA instruction tuning: `train/multimodal_trainer.fit`, with its
prefetch thread collating each batch (`data/collate`) while the step
before it runs.

Set-up builds the one train state (the frozen bf16 model from the seed,
the LoRA adapters drawn by `port_bench`, AdamW) and drives it through
`setup_steps` steps of `fit` on batches of its own; the window hands the
same state to `fit` again, over fresh batches until `seconds` have
passed, and counts the steps completed.

Check: the reference follows the first two steps from the same adapters
and batches in fp32. Compared: the first gradient of each leaf as AdamW
holds it after step 1 (exp_avg / 0.1), and each leaf's change after step
2, both as the gap between the program's norm and the reference's over
the larger of the reference leaf's norm and the median leaf's, the worst
leaf; and the number of target tokens each step's mean loss is taken
over, which the step reports, against the reference's count (exact).
Leaves whose reference gradient stays under a thousandth of the median
leaf's in both steps move by round-off alone and are left out of the
change. The two losses are read, not compared: the first differs from
the reference's by 1e-6-2e-4 relative, the float8 control only about
twice that; the second by ~5e-3 on every seed, because the port rounds
base + LoRA delta to bf16 and loses the first update's +-lr deltas that
fp32 keeps (PERF.md, Findings).
"""

from __future__ import annotations

import contextlib
import time

import torch

from port_bench.drivers import common
from port_bench.reference import model as ref
from port_bench.reference import train as rtrain
from port_bench.yardstick import traffic, work
from port_bench.yardstick.instrument import Tracer
from port_bench.yardstick.weights import make_lora

BETA1 = 0.9
REF_STEPS = 2


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (
        xs[len(xs) // 2 - 1] + xs[len(xs) // 2])


class Driver:
    def __init__(self, conf, mix, seed, device, control=False):
        self.conf, self.mix, self.seed = conf, mix, int(seed)
        self.device = torch.device(device)
        self.control = control
        self.steps = []         # per window step: its tokens
        self.losses = []        # per step: the step's loss (device)
        self.counts = []        # per step: its target tokens (device)
        self._profile = None    # window step index to profile

    # ---- program pieces ----------------------------------------------------

    def _collate(self, index: int):
        from opus_pllm_tpu_torch.data.collate import \
            collate_instruction_batch
        b = collate_instruction_batch(
            traffic.train_batch(self.mix, self.seed, index), self.tok,
            max_len=self.mix["max_len"])
        # spliced rows that are not padding: each valid id, the protein's
        # sentinel counted as its n_tokens soft tokens
        tokens = int(b["attn_mask"].sum()) + b["attn_mask"].shape[0] * (
            self.spec["n_tokens"] - 1)
        return b, tokens

    def _fit(self, batches):
        from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
        self.state = mmt.fit(self.state, self.tx, self.cfg, self.tcfg,
                             self.frozen, batches, lora_cfg=self.lcfg,
                             device=self.device, log_fn=lambda *_: None)

    @contextlib.contextmanager
    def _step_hook(self):
        """Each step's loss kept (on the device), and the step that
        `_profile` names run under the profiler."""
        from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
        orig = mmt.make_train_step

        def make(*a, **k):
            step = orig(*a, **k)

            def hooked(state, frozen, batch):
                n = len(self.losses)
                ctx = (self._tracer.profiled(self.device)
                       if self._profile is not None and n == self._profile
                       else contextlib.nullcontext())
                with ctx:
                    state, m = step(state, frozen, batch)
                self.losses.append(m["loss"])
                self.counts.append(m["valid"])
                return state, m
            return hooked
        mmt.make_train_step = make
        try:
            yield
        finally:
            mmt.make_train_step = orig

    # ---- set-up ------------------------------------------------------------

    def setup(self):
        from opus_pllm_tpu_torch.core.config import LoRAConfig, TrainConfig
        from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
        from opus_pllm_tpu_torch.train import multimodal_trainer as mmt

        self.cfg, self.spec = common.program_config(self.conf)
        if self.device.type == "cuda":
            from opus_pllm_tpu_torch.kernels import build
            build.build_all()
        self.frozen = common.draw_weights(self.conf, self.spec, self.seed,
                                          self.device)
        m = self.mix
        self.lcfg = LoRAConfig(rank=m["lora_rank"], alpha=m["lora_alpha"])
        self.tcfg = TrainConfig(learning_rate=m["lr"],
                                weight_decay=m["weight_decay"],
                                batch_size=m["batch"], remat=m["remat"])
        self.lora0 = make_lora(self.spec, m["lora_rank"], self.seed,
                               self.device)
        self.state, self.tx = mmt.create_state(
            self.cfg, self.tcfg, self.frozen, train_switch=False,
            lora_cfg=self.lcfg, device=self.device,
            trainable={"lora": self.lora0})
        self.tok = ByteTokenizer()
        self.first = [self._collate(i)[0] for i in range(m["setup_steps"])]
        with self._step_hook():
            self._fit(self.first[:1])
            # an optimizer that kept no moment reads as a zero gradient
            self.g1 = {k: self.tx.opt.state.get(t, {}).get(
                "exp_avg", torch.zeros_like(t)) / (1 - BETA1)
                for k, t in self._leaves().items()}
            self._fit(self.first[1:REF_STEPS])
            self.p_ref_steps = {k: t.detach().clone()
                                for k, t in self._leaves().items()}
            self._fit(self.first[REF_STEPS:])
        common.sync(self.device)

    def _leaves(self) -> dict:
        return rtrain.flat(self.state.trainable["lora"])

    # ---- window -------------------------------------------------------------

    def window(self, seconds: float, tracer=None) -> dict:
        first = self.mix["setup_steps"]
        last = first + self.mix["steps_max"]
        t0 = time.perf_counter()

        def batches():
            for i in range(first, last):
                if time.perf_counter() - t0 >= seconds and (
                        tracer is None or i > first + tracer.batch):
                    return
                b, tokens = self._collate(i)
                self.steps.append({"tokens": tokens})
                yield b

        n0 = len(self.losses)
        if tracer is not None:
            self._profile = n0 + tracer.batch
            self._tracer = tracer
        with self._step_hook():
            self._fit(batches())
        common.sync(self.device)
        end = time.perf_counter() - t0
        done = len(self.losses) - n0
        if done != len(self.steps):
            raise RuntimeError(f"{len(self.steps)} batches fed, {done} "
                               "steps run")
        rec = {"steps": self.steps, "window_s": end, "attempted": done,
               "failed": 0}
        return rec

    def tracer(self):
        return Tracer()

    def model_flops(self, step: int, lengths) -> float:
        """The profiled step's work: ESM2 and the bridge forward, the
        decoder and head forward plus their input-gradient backward (2x
        the forward), over the batch's spliced rows that are not padding;
        remat's recompute not counted."""
        spec = self.spec
        exs = traffic.train_batch(self.mix, self.seed,
                                  self.mix["setup_steps"] + step)
        f = 0.0
        for ex in exs:
            ids, _ = rtrain.row_ids(ex, self.mix["max_len"])
            n = len(ids) + spec["n_tokens"] - 1
            f += work.esm_flops(spec, len(ex["sequence"]) + 2)
            f += work.bridge_flops(spec)
            f += 2 * (work.decoder_flops(spec, n, n * (n + 1) / 2)
                      + work.head_flops(spec, n))
        return f

    # ---- check ---------------------------------------------------------------

    def check(self) -> dict:
        prog = {"loss": [float(x) for x in self.losses[:REF_STEPS]],
                "count": [int(x) for x in self.counts[:REF_STEPS]],
                "grad": [self.g1],
                "change": {k: self.p_ref_steps[k] - t for k, t in
                           rtrain.flat(self.lora0).items()}}
        self.state = self.tx = self.frozen = self.first = None
        self.g1 = self.p_ref_steps = None
        common.free_device()
        ref.no_tf32()
        out = self._reference(ref.Precision("fp32"), prog)
        run = out.pop("_run")
        if not self.control:
            return out
        # the control in the program's place: the reference's own steps
        # in float8 / bfloat16, read against the fp32 reference's
        ctl = self._reference(ref.Precision("fp8"), None)
        ctl_out = _readings(ctl["_run"], run)
        ctl_out.update({f"program_{k}": v for k, v in out.items()})
        return ctl_out

    def _reference(self, prec, prog):
        w = common.draw_weights(self.conf, self.spec, self.seed,
                                self.device)
        scaling = self.mix["lora_alpha"] / self.mix["lora_rank"]
        params = {k: t.detach().clone()
                  for k, t in rtrain.flat(self.lora0).items()}
        opt = rtrain.AdamW(self.mix["lr"], self.mix["weight_decay"])
        run = {"loss": [], "count": [], "grad": []}
        for s in range(REF_STEPS):
            exs = traffic.train_batch(self.mix, self.seed, s)
            tree = {"layers": [{} for _ in self.lora0["layers"]]}
            for (li, proj, k), t in params.items():
                tree["layers"][li].setdefault(proj, {})[k] = t
            loss, grads, count = rtrain.loss_and_grads(
                w, self.spec, exs, tree, scaling, self.mix["max_len"], prec)
            run["loss"].append(loss)
            run["count"].append(count)
            run["grad"].append(grads)
            with torch.no_grad():
                opt.step(params, grads)
        run["change"] = {k: params[k] - t for k, t in
                         rtrain.flat(self.lora0).items()}
        del w
        common.free_device()
        if prog is None:
            return {"_run": run}
        out = _readings(prog, run)
        out["_run"] = run
        return out


def _readings(prog: dict, run: dict) -> dict:
    """The numbers compared and read, of `prog` against the reference
    run."""
    loss_gap = [abs(a - b) / abs(b) for a, b in
                zip(prog["loss"], run["loss"])]
    g_ref = {k: float(v.norm()) for k, v in run["grad"][0].items()}
    med = _median(list(g_ref.values()))
    grad_gap = max(abs(float(prog["grad"][0][k].norm()) - g_ref[k])
                   / max(g_ref[k], med) for k in g_ref)
    gmax = {k: max(float(g[k].norm()) for g in run["grad"])
            for k in g_ref}
    gmed = _median(list(gmax.values()))
    kept = [k for k in g_ref if gmax[k] >= 1e-3 * gmed]
    d_ref = {k: float(run["change"][k].norm()) for k in kept}
    dmed = _median(list(d_ref.values()))
    change_gap = max(abs(float(prog["change"][k].norm()) - d_ref[k])
                     / max(d_ref[k], dmed) for k in kept)
    count_gap = sum(abs(a - b) for a, b in zip(prog["count"], run["count"]))
    return {"loss1_rel_gap": loss_gap[0], "grad1_norm_gap": grad_gap,
            "change_norm_gap": change_gap, "target_tokens_gap": count_gap,
            "loss2_rel_gap": loss_gap[1], "leaves_compared": len(kept)}
