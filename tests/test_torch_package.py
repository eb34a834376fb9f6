"""The port stands alone: importing opus_pllm_tpu_torch and running its
CPU slice, its scorers, its BERTScore encoder, the MCQ runners, the metric
library with make_logprob_fn, the checkpoint modules, stage (a)
(precompute_cstp_pairs over a qwen2 and an opt text LM, then the CSTP
trainer), the HTTP server's front with its OpenAI API, the engine with
speculative ticks, a prefix and chunked prefill, the observability
module, the CLI, the checkpoint builder, the HF tokenizer wrapper, the
prefetch thread, beam search and static speculative decoding, and the
parallel axes' modules (core.mesh, parallel.partition, parallel.ring,
infer.sp_engine) loads neither jax nor the JAX package, and chip_smoke.py refuses
to run without a CUDA device (non-zero exit, no result line). Its entry
points default to CUDA."""

import os
import subprocess
import sys
from pathlib import Path

import torch

from opus_pllm_tpu_torch.core.util import resolve_device

ROOT = Path(__file__).resolve().parents[1]

NO_JAX = r"""
import dataclasses, sys
import torch
from opus_pllm_tpu_torch.core.config import (ESM2Config, GenerationConfig,
                                             OpusConfig)
from opus_pllm_tpu_torch.evals import runner
from opus_pllm_tpu_torch.evals.datasets import AnnotationExample
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.models import opus
import opus_pllm_tpu_torch.core.convert, opus_pllm_tpu_torch.kernels.build
import opus_pllm_tpu_torch.kernels.flash_attention
import opus_pllm_tpu_torch.kernels.quant
import opus_pllm_tpu_torch.serve.engine
from opus_pllm_tpu_torch.core.config import BertConfig
from opus_pllm_tpu_torch.evals import metrics, textproc, wordnet
from opus_pllm_tpu_torch.models import bert
from opus_pllm_tpu_torch.core import checkpoint
from opus_pllm_tpu_torch.evals import (mcq, metric_extra, metric_registry,
                                       metric_tail, multilabel)
from opus_pllm_tpu_torch.evals.datasets import MCQExample
from opus_pllm_tpu_torch.infer import conversation, scoring
import opus_pllm_tpu_torch.train.multimodal_trainer

cfg = OpusConfig.tiny("llama")
cfg = dataclasses.replace(cfg, esm=ESM2Config(num_layers=1, embed_dim=128,
                                              num_heads=2),
                          cstp=dataclasses.replace(cfg.cstp, protein_dim=128))
params = opus.init(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
rep = runner.run_annotation_eval(
    params, cfg, ByteTokenizer(), "x_keywords.json",
    gen=GenerationConfig(max_new_tokens=4, eos_token_id=2), batch_size=2,
    prompt_bucket=32, esm_bucket=32, log_fn=lambda *_: None,
    examples=[AnnotationExample("What?", "MKTAYIAKQR", "")] * 3)
assert len(rep.results) == 3
assert set(rep.metrics) == {"Precision", "Recall", "F1 Score"}
vocab = {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                     "a", "##a"])}
embed = bert.make_embed_fn(
    bert.init(BertConfig.tiny(), generator=torch.Generator().manual_seed(0),
              device="cpu"),
    BertConfig.tiny(), textproc.WordPieceTokenizer(vocab))
scores = metrics.compute_metrics(
    [{"generated": "a aa", "ground_truth": "aaa a"}], "x_function.json",
    bert_embed_fn=embed)
assert 0.0 <= scores["BERTScore"]["f1"] <= 1.0
q = MCQExample("Which?", ["A) x", "B) y"], "MKTAYIAKQR", "A")
for run in (runner.run_mcq_eval, runner.run_mcq_eval_scored):
    rep = run(params, cfg, ByteTokenizer(), "x_mcq.json", examples=[q] * 2,
              batch_size=2, prompt_bucket=32, esm_bucket=32,
              log_fn=lambda *_: None,
              **({"gen": GenerationConfig(max_new_tokens=2)}
                 if run is runner.run_mcq_eval else {}))
    assert sum(rep.metrics["OptionCounts"].values()) == 2
ppl = metric_registry.load("perplexity").compute(
    predictions=["ab"], logprob_fn=scoring.make_logprob_fn(
        params["llm"], cfg.llm, ByteTokenizer().encode, bos_token_id=1))
assert ppl["mean_perplexity"] > 1
import pickle, tempfile, os
from opus_pllm_tpu_torch.bridge import adapters, losses
from opus_pllm_tpu_torch.core.config import (CSTPConfig, DecoderConfig,
                                             TrainConfig)
from opus_pllm_tpu_torch.data import datasets, precompute
from opus_pllm_tpu_torch.models import decoder, text_encoder
from opus_pllm_tpu_torch.train import cstp_trainer
with tempfile.TemporaryDirectory() as tmp:
    up, out = os.path.join(tmp, "u.pkl"), os.path.join(tmp, "p.pkl")
    with open(up, "wb") as f:
        pickle.dump({f"P{i}": {"Sequence": "MKTAYIAKQR"[:5 + i], "Name": "x"}
                     for i in range(4)}, f)
    for fam in ("qwen2", "opt"):
        lcfg = DecoderConfig.tiny(fam)
        llm = decoder.init(lcfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
        assert precompute.precompute_cstp_pairs(
            params["esm"], cfg.esm, llm, lcfg, ByteTokenizer(), up, out,
            batch_size=2, len_bucket=16, device="cpu") == 4
    se, te = datasets.UniProtQAVecDataset(out).arrays()
    ccfg = CSTPConfig(protein_dim=se.shape[1], text_dim=te.shape[1],
                      proj_dim=32, warmup_info_nce_steps=-1)
    tcfg = TrainConfig(batch_size=4, log_every=0)
    st, tx = cstp_trainer.create_state(
        ccfg, tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    st = cstp_trainer.fit(st, tx, ccfg, tcfg, [(se, te)] * 2, device="cpu")
    assert st.step == 2
from opus_pllm_tpu_torch.infer import speculative
from opus_pllm_tpu_torch.serve import openai_api
from opus_pllm_tpu_torch.serve.engine import ServeRequest, ServingEngine
from opus_pllm_tpu_torch.serve.server import OpusServer
from opus_pllm_tpu_torch.utils import observability
srv = OpusServer(params, cfg, ByteTokenizer(), max_slots=2, max_len=96,
                 prefill_buckets=(32, 64), default_max_new=3)
try:
    assert srv.handle_generate({"prompt": "Hi"})["tokens"] == 3
    assert openai_api.list_models(srv)["data"][0]["object"] == "model"
    assert "opus_serve_completions_total 1" in srv.metrics_text()
finally:
    srv.close()
eng = ServingEngine(params["llm"], cfg.llm, max_slots=2, max_len=64,
                    prefill_buckets=(16,), draft_layers=1, spec_k=2,
                    chunk_prefill=16)
eng.register_prefix("p", token_ids=[5, 6, 7])
done = eng.run([ServeRequest(0, token_ids=[1, 2, 3], max_new_tokens=3,
                             prefix_id="p"),
                ServeRequest(1, token_ids=list(range(3, 30)),
                             max_new_tokens=3)])
assert [len(done[i].tokens) for i in (0, 1)] == [3, 3]
with observability.span("x", batch=0):
    observability.count("x.n", 2)
assert observability.SPANS.spans()[-1].name == "x"
assert observability.SPANS.counters()["x.n"] == 2
from opus_pllm_tpu_torch.cli import main as cli_main
from opus_pllm_tpu_torch.core import builder
from opus_pllm_tpu_torch.infer import hf_tokenizer
from opus_pllm_tpu_torch.utils.prefetch import prefetch_to_device
assert cli_main.build_parser().parse_args(["bench"]).cmd == "bench"
assert builder.family_from_path("/m/Meta-Llama-3-8B") == "llama"
assert list(prefetch_to_device([1, 2], place=lambda b: b)) == [1, 2]
from opus_pllm_tpu_torch.infer import engine as engine_mod
dp, dc = speculative.draft_from_target(params["llm"], cfg.llm, 1)
x = torch.zeros((1, 4, cfg.llm.hidden_size))
m = torch.ones((1, 4), dtype=torch.bool)
p4 = torch.arange(4)[None]
assert engine_mod.beam_generate(params["llm"], cfg.llm, x, m, p4,
                                num_beams=2, max_new_tokens=2,
                                ).tokens.shape == (1, 2)
assert speculative.speculative_generate(dp, params["llm"], dc, cfg.llm, x,
                                        x, m, p4, max_new_tokens=2,
                                        n_draft=2).tokens.shape == (1, 2)
from opus_pllm_tpu_torch.core import mesh as mesh_mod
from opus_pllm_tpu_torch.core.config import MeshConfig
from opus_pllm_tpu_torch.infer import sp_engine
from opus_pllm_tpu_torch.parallel import partition, ring
assert partition.specs(params["llm"], MeshConfig(1, 2))["lm_head"][
    "kernel"] == ("data", "model")
assert mesh_mod.local_slice(5, 1, 2) == slice(3, 5)
bad = [m for m in sys.modules if m in ("jax", "jaxlib", "opus_pllm_tpu")
       or m.startswith(("jax.", "jaxlib.", "opus_pllm_tpu."))]
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_and_cpu_slice_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", NO_JAX], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_chip_smoke_fails_without_cuda(tmp_path):
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=tmp_path, env=_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "FAIL" in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_resolve_device_defaults_to_cuda():
    """`device=None` means CUDA in every entry point, with no fallback; the
    CPU is asked for by name."""
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
