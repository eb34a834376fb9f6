"""A configuration file of `port_bench/configs/` -> the plain size table
that the weight maker and the reference read (no class of the port)."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_config(name: str) -> dict:
    with open(ROOT / "configs" / f"{name}.json") as f:
        return json.load(f)


def model_spec(conf: dict) -> dict:
    """The sizes of every part, under one set of names."""
    fam = {"qwen2": "qwen2", "opt": "opt"}[conf["model_type"]]
    heads = conf["num_attention_heads"]
    hidden = conf["hidden_size"]
    esm, switch = conf["esm"], conf["switch"]
    depth = 1 if switch["projector_type"] == "linear" else int(
        switch["projector_type"][3:].split("x")[0])
    return {
        "family": fam,
        "vocab_size": conf["vocab_size"],
        "hidden_size": hidden,
        "intermediate_size": conf.get("intermediate_size",
                                      conf.get("ffn_dim")),
        "num_layers": conf["num_hidden_layers"],
        "num_heads": heads,
        "num_kv_heads": conf.get("num_key_value_heads", heads),
        "head_dim": hidden // heads,
        "rope_theta": conf.get("rope_theta", 10000.0),
        "rms_norm_eps": conf.get("rms_norm_eps", 1e-5),
        "attention_bias": fam in ("qwen2", "opt"),
        "activation": conf.get("activation_function",
                               conf.get("hidden_act", "silu")),
        "max_position_embeddings": conf["max_position_embeddings"],
        "tie_word_embeddings": conf.get("tie_word_embeddings", False),
        "esm_layers": esm["num_hidden_layers"],
        "esm_dim": esm["hidden_size"],
        "esm_heads": esm["num_attention_heads"],
        "esm_ffn": esm["intermediate_size"],
        "esm_vocab": esm["vocab_size"],
        "cstp_in": conf["cstp"]["protein_dim"],
        "cstp_out": conf["cstp"]["proj_dim"],
        "n_tokens": switch["n_tokens"],
        "switch_in": switch["input_dim"],
        "switch_depth": depth,
    }
