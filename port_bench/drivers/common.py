"""What every driver shares: the port's configuration for a file of
`port_bench/configs/`, checked against the file's numbers, and the
weights handed to the port."""

from __future__ import annotations

import dataclasses
import gc

import torch

from port_bench.yardstick.spec import model_spec
from port_bench.yardstick.weights import make_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(conf: dict):
    """The port's OpusConfig built from the preset the file names, refused
    where the preset's widths differ from the file's."""
    from opus_pllm_tpu_torch.core import config as C
    if conf["preset"] == "tiny":
        cfg = C.OpusConfig.tiny(conf["model_type"])
    else:
        llm = getattr(C.DecoderConfig, conf["preset"])()
        esm = dataclasses.replace(C.ESM2Config.t33_650M(),
                                  dtype=conf["esm"]["dtype"])
        cstp = C.CSTPConfig()
        sw = conf["switch"]
        cfg = C.OpusConfig(
            esm=esm, cstp=cstp,
            switch=C.SwitchProjectorConfig(
                input_dim=sw["input_dim"], llm_hidden_size=llm.hidden_size,
                n_tokens=sw["n_tokens"],
                projector_type=sw["projector_type"]),
            llm=llm)
    spec = model_spec(conf)
    got = {"vocab_size": cfg.llm.vocab_size,
           "hidden_size": cfg.llm.hidden_size,
           "intermediate_size": cfg.llm.intermediate_size,
           "num_layers": cfg.llm.num_layers,
           "num_heads": cfg.llm.num_heads,
           "num_kv_heads": cfg.llm.num_kv_heads,
           "head_dim": cfg.llm.head_dim,
           "family": cfg.llm.family,
           "tie_word_embeddings": cfg.llm.tie_word_embeddings,
           "esm_layers": cfg.esm.num_layers, "esm_dim": cfg.esm.embed_dim,
           "esm_heads": cfg.esm.num_heads, "n_tokens": cfg.switch.n_tokens,
           "switch_in": cfg.switch.input_dim,
           "switch_depth": cfg.switch.mlp_depth}
    if cfg.llm.family == "opt":
        got["activation"] = cfg.llm.activation
    else:
        got["rope_theta"] = cfg.llm.rope_theta
        got["rms_norm_eps"] = cfg.llm.rms_norm_eps
    bad = {k: (v, spec[k]) for k, v in got.items() if spec[k] != v}
    if bad:
        raise ValueError(f"the port's preset {conf['preset']} differs from "
                         f"the configuration file: {bad}")
    return cfg, spec


def draw_weights(conf: dict, spec: dict, seed: int, device) -> dict:
    return make_weights(spec, seed, device,
                        llm_dtype=DTYPES[conf["torch_dtype"]],
                        esm_dtype=DTYPES[conf["esm"]["dtype"]])


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
