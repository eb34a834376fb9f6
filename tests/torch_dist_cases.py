"""What each rank of tests/torch_dist.RankPool runs for the port's parallel
tests (test_torch_ring.py, test_torch_serve_tp.py, test_torch_mesh.py):
functions of (rank, *args) over numpy inputs that return numpy or plain
Python results. torch and the port only; the JAX references are computed
in the test process."""

from __future__ import annotations

import numpy as np
import torch

from opus_pllm_tpu_torch.core import convert, mesh as mesh_mod
from opus_pllm_tpu_torch.core.config import (DecoderConfig, GenerationConfig,
                                             MeshConfig)
from opus_pllm_tpu_torch.models import decoder


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _params(tree):
    """A JAX tree (numpy leaves), an Opus one or a decoder's -> torch."""
    if "llm" in tree:
        return convert.from_jax(tree, device="cpu")
    return convert.decoder_from_jax(tree, device="cpu")


# ---------------------------------------------------------------------------
# ring and sharded decode attention
# ---------------------------------------------------------------------------

def ring_attention(rank, n, q, k, v, mask, causal):
    from opus_pllm_tpu_torch.parallel import ring
    sp = ring.make_sp_mesh(n)
    if sp is None:
        return None
    return ring.ring_self_attention(sp, _t(q), _t(k), _t(v), _t(mask),
                                    causal=causal).numpy()


def sharded_decode(rank, n, q, k, v, mask):
    from opus_pllm_tpu_torch.parallel import ring
    sp = ring.make_sp_mesh(n)
    if sp is None:
        return None
    s = k.shape[1] // n
    sl = slice(sp.index * s, (sp.index + 1) * s)
    return ring.sharded_decode_attention(
        _t(q), _t(k[:, sl]), _t(v[:, sl]), _t(mask[:, sl]),
        group=sp.group).numpy()


# ---------------------------------------------------------------------------
# sequence-sharded generation
# ---------------------------------------------------------------------------

def sp_generate(rank, n, cfg_fields, tree, emb, mask, kw):
    """-> (tokens, lengths, first-step logits) of this rank, or None off
    the mesh."""
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.infer.sp_engine import generate_seq_sharded
    from opus_pllm_tpu_torch.parallel import ring
    sp = ring.make_sp_mesh(n)
    if sp is None:
        return None
    cfg = DecoderConfig(**cfg_fields)
    params = _params(tree)
    emb_t, mask_t = _t(emb), _t(mask)
    pos = decoder.positions_from_mask(mask_t)
    g = torch.Generator().manual_seed(1)
    out = generate_seq_sharded(params, cfg, emb_t, mask_t, pos, g, mesh=sp,
                               **kw)
    # the first step's logits: the ring prefill's last row, as the engine
    # broadcasts it from the last rank
    b, l, _ = emb.shape
    pad = -(-l // n) * n - l
    emb_p = torch.nn.functional.pad(emb_t, (0, 0, pad, 0))
    mask_p = torch.nn.functional.pad(mask_t, (pad, 0))
    pos_p = torch.nn.functional.pad(pos, (pad, 0))
    l_loc = emb_p.shape[1] // n
    sl = slice(sp.index * l_loc, (sp.index + 1) * l_loc)
    cache = decoder.init_cache(cfg, b, l_loc, device="cpu",
                               quantize=kw.get("quantize_cache", False))
    ctx = engine.cache_capacity(cfg, l, kw["max_new_tokens"])
    hid, _ = decoder.forward(params, cfg, emb_p[:, sl], pos_p[:, sl],
                             mask_p[:, sl], cache, impl="ring",
                             return_hidden=True, ntk_ctx=ctx, sp=sp)
    logits = decoder.head_logits(params, cfg, hid[:, -1:])[:, 0]
    return (out.tokens.numpy(), out.lengths.numpy(),
            logits.numpy() if sp.index == n - 1 else None)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def _mesh(data, model):
    return mesh_mod.make_mesh(MeshConfig(data, model),
                              ranks=list(range(data * model)))


def tp_generate(rank, model, cfg_fields, tree, emb, mask, kw, fuse=True):
    """Greedy generate over this rank's share of the decoder (fused after
    the cut, as the CLI does) -> (tokens, first-step logits, which groups
    split)."""
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.parallel import partition
    mesh = _mesh(1, model)
    if mesh is None:
        return None
    cfg = DecoderConfig(**cfg_fields)
    params, lcfg = partition.shard_decoder(_params(tree), cfg, mesh)
    if fuse:
        params = decoder.fuse_projections(params, lcfg)
    emb_t, mask_t = _t(emb), _t(mask)
    pos = decoder.positions_from_mask(mask_t)
    out = engine.generate(params, lcfg, emb_t, mask_t, pos,
                          torch.Generator().manual_seed(1), **kw)
    m4 = decoder.layers.causal_mask(mask_t)
    lg, _ = decoder.forward(params, lcfg, emb_t, pos, m4)
    tp = lcfg.tp
    return (out.tokens.numpy(), lg[:, -1].numpy(),
            (tp.attn, tp.mlp, tp.head))


def _requests(reqs):
    from opus_pllm_tpu_torch.serve.engine import ServeRequest
    return [ServeRequest(**r) for r in reqs]


def tp_engine(rank, model, cfg_fields, tree, reqs, engine_kw, bank=None,
              prefix=None):
    """The serving engine over `model` tensor-parallel ranks (it shards the
    whole tree itself) -> ({request id: tokens}, cache leaf shape)."""
    from opus_pllm_tpu_torch.serve.engine import ServingEngine
    mesh = _mesh(1, model)
    if mesh is None:
        return None
    cfg = DecoderConfig(**cfg_fields)
    kw = dict(engine_kw)
    if bank is not None:
        kw["lora_bank"] = {name: convert.lora_from_jax(t, device="cpu")
                           for name, t in bank.items()}
    eng = ServingEngine(_params(tree), cfg, mesh=mesh, **kw)
    if prefix is not None:
        eng.register_prefix("p", embeds=prefix)
    done = eng.run(_requests(reqs), max_ticks=200)
    leaf = eng.cache["layers"][0]["k"]
    leaf = leaf["q"] if isinstance(leaf, dict) else leaf
    return ({i: c.tokens for i, c in done.items()}, tuple(leaf.shape))


# ---------------------------------------------------------------------------
# the runners and the CLI
# ---------------------------------------------------------------------------

def _opus(cfg_dicts, tree):
    """The port's OpusConfig from the JAX one's field dicts, and the tree."""
    from opus_pllm_tpu_torch.core.config import (CSTPConfig, ESM2Config,
                                                 OpusConfig,
                                                 SwitchProjectorConfig)
    d = cfg_dicts
    cfg = OpusConfig(esm=ESM2Config(**d["esm"]), cstp=CSTPConfig(**d["cstp"]),
                     switch=SwitchProjectorConfig(**d["switch"]),
                     llm=DecoderConfig(**d["llm"]),
                     max_prompt_len=d["max_prompt_len"],
                     max_proteins_per_prompt=d["max_proteins_per_prompt"])
    return _params(tree), cfg


def runner(rank, kind, data, model, seq, cfg_dicts, tree, examples,
           gen_fields, file_name):
    """One of the runners under a (data, model) mesh or a seq mesh of
    `seq` ranks -> (results, metrics) on every rank of it."""
    from opus_pllm_tpu_torch.evals import runner as rn
    from opus_pllm_tpu_torch.evals.datasets import (AnnotationExample,
                                                    MCQExample)
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.parallel import ring
    mesh = seq_mesh = None
    if seq:
        seq_mesh = ring.make_sp_mesh(seq)
        if seq_mesh is None:
            return None
    else:
        mesh = _mesh(data, model)
        if mesh is None:
            return None
    params, cfg = _opus(cfg_dicts, tree)
    tok = ByteTokenizer()
    gen = GenerationConfig(**gen_fields)
    kw = dict(gen=gen, log_fn=lambda *_: None)
    if kind == "annotate":
        ex = [AnnotationExample(**e) for e in examples]
        rep = rn.run_annotation_eval(params, cfg, tok, file_name,
                                     examples=ex, batch_size=2, mesh=mesh,
                                     seq_mesh=seq_mesh, **kw)
    elif kind == "annotate_engine":
        ex = [AnnotationExample(**e) for e in examples]
        rep = rn.run_annotation_eval_engine(params, cfg, tok, file_name,
                                            examples=ex, max_slots=2,
                                            splice_batch=2, mesh=mesh, **kw)
    elif kind == "mcq":
        ex = [MCQExample(**e) for e in examples]
        rep = rn.run_mcq_eval(params, cfg, tok, file_name, examples=ex,
                              batch_size=2, mesh=mesh, seq_mesh=seq_mesh,
                              **kw)
    else:
        ex = [MCQExample(**e) for e in examples]
        rep = rn.run_mcq_eval_scored(params, cfg, tok, file_name,
                                     examples=ex, batch_size=2, mesh=mesh,
                                     log_fn=kw["log_fn"])
    return rep.results, rep.metrics


def cli(rank, argv, feeds=None):
    """The port's CLI on this rank (the byte tokenizer for the toy
    directories' missing tokenizer files) -> what it printed."""
    import builtins
    import contextlib
    import io

    from opus_pllm_tpu_torch.cli import main as cli_main
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    cli_main.load_tokenizer = lambda path, family: ByteTokenizer()
    if feeds is not None:
        it = iter(feeds)
        builtins.input = lambda *_: next(it)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main.main(argv)
    return buf.getvalue()
