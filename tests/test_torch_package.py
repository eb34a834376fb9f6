"""The port stands alone: importing opus_pllm_tpu_torch and running its
CPU slice loads neither jax nor the JAX package, and chip_smoke.py refuses
to run without a CUDA device (non-zero exit, no result line)."""

import os
import subprocess
import sys
from pathlib import Path

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

cfg = OpusConfig.tiny("llama")
cfg = dataclasses.replace(cfg, esm=ESM2Config(num_layers=1, embed_dim=128,
                                              num_heads=2),
                          cstp=dataclasses.replace(cfg.cstp, protein_dim=128))
params = opus.init(cfg, generator=torch.Generator().manual_seed(0))
rep = runner.run_annotation_eval(
    params, cfg, ByteTokenizer(), "x_keywords.json",
    gen=GenerationConfig(max_new_tokens=4, eos_token_id=2), batch_size=2,
    prompt_bucket=32, esm_bucket=32, log_fn=lambda *_: None,
    examples=[AnnotationExample("What?", "MKTAYIAKQR", "")] * 3)
assert len(rep.results) == 3
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
