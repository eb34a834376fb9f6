"""The port stands alone: importing opus_pllm_tpu_torch and running its
CPU slice, its scorers and its BERTScore encoder loads neither jax nor the
JAX package, and chip_smoke.py refuses
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
