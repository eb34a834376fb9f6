"""Typed configuration tree (port of `opus_pllm_tpu/core/config.py`).

The same dataclasses, fields and presets as the JAX module, for the parts
of the model the port runs: `ESM2Config`, `CSTPConfig`,
`SwitchProjectorConfig`, `DecoderConfig`, `BertConfig`, `OpusConfig`,
`GenerationConfig`, `LoRAConfig` and `TrainConfig`. The JAX dtype map
(config.py:26-27) becomes a torch dtype map; nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

# Special token conventions (reference: multi_modality_v1/constants.py:7-9)
IGNORE_INDEX = -100
SEQ_TOKEN_INDEX = -200
SEQ_TOKEN = "<seq>"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass(frozen=True)
class ESM2Config:
    """ESM2 protein encoder (fair-esm `esm2_t*` family)."""

    num_layers: int = 33
    embed_dim: int = 1280
    num_heads: int = 20
    vocab_size: int = 33
    cls_idx: int = 0
    pad_idx: int = 1
    eos_idx: int = 2
    mask_idx: int = 32
    token_dropout: bool = True
    dtype: str = "float32"

    @property
    def ffn_dim(self) -> int:
        return self.embed_dim * 4

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @staticmethod
    def t33_650M() -> "ESM2Config":
        return ESM2Config(num_layers=33, embed_dim=1280, num_heads=20)

    @staticmethod
    def tiny() -> "ESM2Config":
        """Test-only config: 2 layers, 64-wide."""
        return ESM2Config(num_layers=2, embed_dim=64, num_heads=4)


@dataclass(frozen=True)
class DecoderConfig:
    """A decoder-only LLM. The port runs family "llama"; "qwen2" and "opt"
    are accepted by the dataclass and refused by `models/decoder.py`."""

    family: str = "llama"
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    use_dynamic_ntk: bool = False
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    do_layer_norm_before: bool = True
    activation: str = "silu"
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @staticmethod
    def llama3_8b() -> "DecoderConfig":
        return DecoderConfig(
            family="llama", vocab_size=128256, hidden_size=4096,
            intermediate_size=14336, num_layers=32, num_heads=32,
            num_kv_heads=8, head_dim=128, rope_theta=500000.0,
        )

    @staticmethod
    def tiny(family: str = "llama") -> "DecoderConfig":
        """Test-only config."""
        return DecoderConfig(
            family=family, vocab_size=256, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2 if family != "opt" else 4, head_dim=16,
            max_position_embeddings=512, dtype="float32",
            attention_bias=(family == "qwen2"),
            activation="relu" if family == "opt" else "silu",
        )


@dataclass(frozen=True)
class BertConfig:
    """BERT encoder (BioBERT-large for BERTScore in the eval harness;
    config.py:168-190)."""

    vocab_size: int = 58996          # biobert-large-cased-v1.1
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128,
                          max_position_embeddings=128)


@dataclass(frozen=True)
class CSTPConfig:
    """Stage-(a) contrastive protein-sequence<->text alignment adapter."""

    protein_dim: int = 1280
    text_dim: int = 5120
    proj_dim: int = 5120
    temperature: float = 0.0007
    kl_threshold_step: int = 30
    kl_annealing_steps: int = 500
    kl_coefficient: float = 1.0
    evidence_global_step: int = 1000
    warmup_info_nce_steps: int = 0

    @staticmethod
    def tiny() -> "CSTPConfig":
        return CSTPConfig(protein_dim=64, text_dim=96, proj_dim=96)


@dataclass(frozen=True)
class SwitchProjectorConfig:
    """Stage-(c) modality refinement projector ('linear' or 'mlpNx_gelu')."""

    input_dim: int = 5120
    llm_hidden_size: int = 4096
    n_tokens: int = 8
    projector_type: str = "mlp2x_gelu"

    @property
    def output_dim(self) -> int:
        return self.llm_hidden_size * self.n_tokens

    @property
    def mlp_depth(self) -> int:
        if self.projector_type == "linear":
            return 1
        m = re.match(r"^mlp(\d+)x_gelu$", self.projector_type)
        if not m:
            raise ValueError(f"unknown projector_type: {self.projector_type}")
        return int(m.group(1))


@dataclass(frozen=True)
class OpusConfig:
    """Full protein-multimodal model: encoder + CSTP + switch + LLM."""

    esm: ESM2Config = field(default_factory=ESM2Config.t33_650M)
    cstp: Optional[CSTPConfig] = field(default_factory=CSTPConfig)
    switch: SwitchProjectorConfig = field(default_factory=SwitchProjectorConfig)
    llm: DecoderConfig = field(default_factory=DecoderConfig.llama3_8b)
    max_prompt_len: int = 512
    max_proteins_per_prompt: int = 1

    @staticmethod
    def tiny(family: str = "llama") -> "OpusConfig":
        llm = DecoderConfig.tiny(family)
        cstp = CSTPConfig.tiny()
        return OpusConfig(
            esm=ESM2Config.tiny(),
            cstp=dataclasses.replace(cstp, protein_dim=64, text_dim=96,
                                     proj_dim=96),
            switch=SwitchProjectorConfig(input_dim=96,
                                         llm_hidden_size=llm.hidden_size,
                                         n_tokens=4),
            llm=llm,
            max_prompt_len=64,
        )


@dataclass(frozen=True)
class GenerationConfig:
    """Mirrors the reference generate() call sites (run_opus_ddp.py:120-132).
    The port's runner refuses `num_beams > 1` and `draft_layers > 0` (not
    ported yet, ROADMAP.md)."""

    max_new_tokens: int = 256
    temperature: float = 0.1
    top_p: float = 0.7
    eos_token_id: int = -1
    pad_token_id: int = 0
    seed: int = 0
    quantize_cache: object = False
    num_beams: int = 1
    length_penalty: float = 1.0
    draft_layers: int = 0
    n_draft: int = 4

    @property
    def do_sample(self) -> bool:
        return self.temperature > 0


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA adapters (config.py:333-338): rank, alpha (scaling alpha/rank)
    and the projections they adapt; dropout is carried, not applied (the
    JAX trainer applies none either)."""

    rank: int = 16
    alpha: float = 32.0
    dropout: float = 0.0
    target_modules: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj",
                                       "gate_proj", "up_proj", "down_proj")


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (config.py:341-375). `scan_mode` is the
    JAX layer-loop layout and changes nothing here (the port runs a plain
    loop over its layer list)."""

    learning_rate: float = 0.05       # stage-(a) AdamW lr (modelling.py:599)
    weight_decay: float = 1e-4
    batch_size: int = 128
    num_epochs: int = 1
    warmup_steps: int = 0
    grad_clip_norm: float = 0.0
    seed: int = 0
    log_every: int = 10
    ce_chunk: int = 0                 # >0: chunked head + cross-entropy
    scan_mode: str = "xs"
    grad_accum: int = 1               # micro-chunks per optimizer step
    remat: str = "full"               # "full" | "none" | "dots"

    @property
    def remat_mode(self):
        """TrainConfig.remat -> the decoder.forward remat argument."""
        return {"full": True, "none": False, "dots": "dots"}[self.remat]
