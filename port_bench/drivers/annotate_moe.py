"""Batch annotation with a sparse-expert decoder (the deepseek_v2 family):
the annotate driver's window and check, with this family's size table,
weights, reference, FLOP count and kernel probe.

The window is `drivers/annotate.Driver`'s: `evals/runner`'s static path
batch after batch, each sampled as the task says. Set-up draws the weights
from `yardstick/deepseek.py` and fuses each layer as generation does
(`decoder.fuse_layer`: [q | kv_a], the SwiGLUs' gate|up, the routed
experts' interleaved gate|up for the grouped GEMM). The check is the
annotate driver's (`logit_rel_err`, `nucleus_gap` on `check_rows` rows of
window batch 0, the logits read where the decode loop samples) against
`reference/deepseek_v2.py` in fp32; the control is that reference in
float8. The traced batch is profiled with `yardstick/moe_probe.py`'s
probe, and the run's record carries the decode step's weight bytes and
the expert count (`moe`) for the routed layers' readers.
"""

from __future__ import annotations

import torch

from port_bench.drivers import annotate, common
from port_bench.reference import deepseek_v2 as dref
from port_bench.reference import model as ref
from port_bench.reference.prompts import annotation_prompt
from port_bench.yardstick import deepseek, traffic
from port_bench.yardstick.moe_probe import MoETracer


class Driver(annotate.Driver):

    def setup(self):
        self.cfg, self.spec = deepseek.program_config(self.conf)
        from opus_pllm_tpu_torch.core.config import GenerationConfig
        from opus_pllm_tpu_torch.evals import datasets as ds
        from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
        from opus_pllm_tpu_torch.models import decoder

        if self.device.type == "cuda":
            from opus_pllm_tpu_torch.kernels import build
            build.build_all()
        params = deepseek.draw_weights(self.conf, self.spec, self.seed,
                                       self.device)
        layers = params["llm"]["layers"]
        for i, lp in enumerate(layers):
            layers[i] = decoder.fuse_layer(lp)
        self.params = params
        common.free_device()
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
        warm = [ds.AnnotationExample(ins, seq, "") for ins, seq in
                traffic.annotate_batch(self.mix, self.seed, 10 ** 6)]
        self._run_batches(warm, stop=lambda bi: False)
        common.sync(self.device)

    def window(self, seconds: float, tracer=None) -> dict:
        rec = super().window(seconds, tracer)
        rec["moe"] = deepseek.decode_weight_bytes(self.spec)
        return rec

    def tracer(self):
        return MoETracer(batch=2)

    def model_flops(self, bi: int, lengths) -> float:
        """The active FLOPs window batch `bi`'s data needs: ESM2 over each
        protein, the bridge, the prefill over each prompt's valid
        positions (the head at the last), one decode forward a served
        token after the first; a token's routed layers count its top-k
        experts and the shared ones, attention at the model's 192 / 128
        widths (`yardstick.deepseek.decoder_flops`)."""
        from port_bench.yardstick import work
        spec = self.spec
        b = self.mix["batch"]
        rows = self.examples[bi * b:(bi + 1) * b]
        f = 0.0
        for e, t in zip(rows, lengths):
            n_p = len(ref.byte_ids(self._prompt_of(e))) + spec["n_tokens"] \
                - 1
            f += work.esm_flops(spec, len(e.sequence) + 2)
            f += work.bridge_flops(spec)
            f += deepseek.decoder_flops(spec, n_p, n_p * (n_p + 1) / 2)
            f += deepseek.head_flops(spec, 1)
            steps = max(int(t) - 1, 0)
            ctx = steps * n_p + steps * (steps + 1) / 2
            f += deepseek.decoder_flops(spec, steps, ctx)
            f += deepseek.head_flops(spec, steps)
        return f

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
        self.params = self.capture = self.served = None
        common.free_device()
        dref.no_tf32()
        w = deepseek.draw_weights(self.conf, self.spec, self.seed,
                                  self.device)
        temp, top_p = self.gen.temperature, self.gen.top_p
        with torch.no_grad():
            lg = dref.position_logits(w, self.spec, prompts, proteins,
                                      served, ref.Precision("fp32"))
            out = annotate._readings(prog, served, lg, temp, top_p)
            if not self.control:
                return out
            cl = dref.position_logits(w, self.spec, prompts, proteins,
                                      served, ref.Precision("fp8"))
            ctl = {k: torch.stack([c[min(k, c.shape[0] - 1)].cpu()
                                   for c in cl]) for k in prog}
            g = torch.Generator(device=self.device)
            g.manual_seed(self.seed % 2 ** 63)
            drawn = [ref.nucleus_sample(c, temp, top_p, g).tolist()
                     for c in cl]
            ctl_out = annotate._readings(ctl, drawn, lg, temp, top_p)
        ctl_out.update({f"program_{k}": v for k, v in out.items()})
        return ctl_out
