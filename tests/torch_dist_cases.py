"""What each rank of tests/torch_dist.RankPool runs for the port's parallel
tests (test_torch_ring.py, test_torch_serve_tp.py, test_torch_mesh.py,
test_torch_train_mesh.py, test_torch_sp_train.py, test_torch_pp_train.py):
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


def ring_attention_grad(rank, n, q, k, v, mask, dout, causal, remat):
    """This rank's shard through `ring_attention` with grad on, its slice
    of the cotangent `dout` backpropagated (under a non-reentrant
    checkpoint when `remat`, so the ring runs again in the backward) ->
    (out, dq, dk, dv) of the shard, or None off the mesh."""
    import torch.utils.checkpoint
    from opus_pllm_tpu_torch.parallel import ring
    sp = ring.make_sp_mesh(n)
    if sp is None:
        return None
    s = q.shape[1] // n
    sl = slice(sp.index * s, (sp.index + 1) * s)
    qt, kt, vt = (_t(x[:, sl]).requires_grad_(True) for x in (q, k, v))
    fn = lambda a, b, c: ring.ring_attention(  # noqa: E731
        a, b, c, _t(mask[:, sl]), group=sp.group, causal=causal) * 1.0
    out = (torch.utils.checkpoint.checkpoint(fn, qt, kt, vt,
                                             use_reentrant=False)
           if remat else fn(qt, kt, vt))
    out.backward(_t(dout[:, sl]))
    return (out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(),
            vt.grad.numpy())


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


# ---------------------------------------------------------------------------
# the trainers on a mesh
# ---------------------------------------------------------------------------

def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().float().cpu().numpy()


def train_step(rank, data, model, cfg_dicts, frozen_tree, trainable_tree,
               batches, tcfg_fields, lora_fields, ckpt_dir=None):
    """train-lora steps on a (data, model) mesh from the JAX trees, one a
    batch of `batches`, each on the rank's rows -> (each step's (loss,
    valid count, the whole gradient as AdamW took it (after the clip)),
    the whole post-step trainable tree, each leaf's (model dim, data
    dim)), or None off the mesh. With `ckpt_dir` each step's full state
    is saved there."""
    from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
    from opus_pllm_tpu_torch.core.config import LoRAConfig, TrainConfig
    from opus_pllm_tpu_torch.parallel import partition
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    params, cfg = _opus(cfg_dicts, frozen_tree)
    tcfg = TrainConfig(**tcfg_fields)
    lcfg = LoRAConfig(**lora_fields) if lora_fields else None
    state, tx = mmt.create_state(
        cfg, tcfg, params, trainable=convert.trainable_from_jax(
            trainable_tree, device="cpu"), lora_cfg=lcfg, device="cpu")
    params, cfg = partition.shard_frozen(mesh, params, cfg)
    state, tx = mmt.shard_state(mesh, state, cfg)
    seen = {}
    adam = tx.opt.step

    def record(*a, **k):
        # the gradients as torch's AdamW reads them: reduced, cut, clipped
        seen["grads"] = [p.grad.clone() for p in tx.params]
        return adam(*a, **k)
    tx.opt.step = record
    step = mmt.make_train_step(cfg, tx, lora_cfg=lcfg,
                               grad_accum=tcfg.grad_accum,
                               ce_chunk=tcfg.ce_chunk,
                               remat=tcfg.remat_mode)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    steps = []
    for batch in batches:
        local = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in mmt._train_rows(mesh, batch).items()}
        state, metrics = step(state, params, local)
        full = mmt.full_trainable(state)
        grads = mmt.tree_from_leaves(
            full, partition.uncut_leaves(seen["grads"], tx.layout))
        steps.append((float(metrics["loss"]), int(metrics["valid"]),
                      _np_tree(grads)))
        mmt.maybe_save(ckpt, 1, state.step, state)
    mmt.finish_saves(ckpt, 1)
    split = [(lay.model_dim, lay.data_dim) for lay in tx.layout.leaves]
    return steps, _np_tree(mmt.full_trainable(state)), split


def _axis_steps(step_fn, state, tx, params, batches, ckpt_dir):
    """Run `step_fn` over `batches` (the global batch on every rank) ->
    (each step's (loss, valid count, the gradient AdamW took (after the
    clip), as a tree), the post-step trainable tree); with `ckpt_dir`
    each step's state is saved there (rank 0 writes)."""
    from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
    seen = {}
    adam = tx.opt.step

    def record(*a, **k):
        seen["grads"] = [p.grad.clone() for p in tx.params]
        return adam(*a, **k)
    tx.opt.step = record
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    steps = []
    for batch in batches:
        state, metrics = step_fn(state, params, {
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()})
        grads = mmt.tree_from_leaves(state.trainable, seen["grads"])
        steps.append((float(metrics["loss"]), int(metrics["valid"]),
                      _np_tree(grads)))
        mmt.maybe_save(ckpt, 1, state.step, state)
    mmt.finish_saves(ckpt, 1)
    return steps, _np_tree(state.trainable)


def _axis_state(cfg_dicts, frozen_tree, trainable_tree, tcfg_fields,
                lora_fields):
    from opus_pllm_tpu_torch.core.config import LoRAConfig, TrainConfig
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
    params, cfg = _opus(cfg_dicts, frozen_tree)
    tcfg = TrainConfig(**tcfg_fields)
    lcfg = LoRAConfig(**lora_fields) if lora_fields else None
    state, tx = mmt.create_state(
        cfg, tcfg, params, trainable=convert.trainable_from_jax(
            trainable_tree, device="cpu"), lora_cfg=lcfg, device="cpu")
    return params, cfg, tcfg, lcfg, state, tx


def sp_train_steps(rank, n, cfg_dicts, frozen_tree, trainable_tree,
                   batches, tcfg_fields, lora_fields, ckpt_dir=None):
    """train.sp's step on a ("seq",) mesh of `n` ranks -> `_axis_steps`'
    result, or None off the mesh."""
    from opus_pllm_tpu_torch.parallel import ring
    from opus_pllm_tpu_torch.train import sp
    mesh = ring.make_sp_mesh(n)
    if mesh is None:
        return None
    params, cfg, tcfg, lcfg, state, tx = _axis_state(
        cfg_dicts, frozen_tree, trainable_tree, tcfg_fields, lora_fields)
    step = sp.make_sp_train_step(cfg, tx, mesh, lora_cfg=lcfg,
                                 ce_chunk=tcfg.ce_chunk,
                                 remat=tcfg.remat_mode,
                                 grad_accum=tcfg.grad_accum, impl="torch")
    return _axis_steps(step, state, tx, params, batches, ckpt_dir)


def pp_train_steps(rank, stages, data, n_micro, cfg_dicts, frozen_tree,
                   trainable_tree, batches, tcfg_fields, lora_fields,
                   ckpt_dir=None):
    """train.pp's step on `data` replicas of `stages` stages (the frozen
    tree cut to the rank's stage) -> (`_axis_steps`' result, the layers
    the stage holds), or None off the mesh."""
    from opus_pllm_tpu_torch.parallel import pipeline
    from opus_pllm_tpu_torch.train import pp
    mesh = pipeline.make_pp_mesh(stages, data=data)
    if mesh is None:
        return None
    params, cfg, tcfg, lcfg, state, tx = _axis_state(
        cfg_dicts, frozen_tree, trainable_tree, tcfg_fields, lora_fields)
    params = pp.shard_frozen(mesh, params, cfg)
    step = pp.make_pp_train_step(cfg, tx, mesh, lora_cfg=lcfg,
                                 ce_chunk=tcfg.ce_chunk, n_micro=n_micro,
                                 remat=tcfg.remat_mode, impl="torch",
                                 grad_accum=tcfg.grad_accum)
    return (_axis_steps(step, state, tx, params, batches, ckpt_dir),
            len(params["llm"]["layers"]))


def cstp_steps(rank, data, params_tree, batches, cfg_fields, tcfg_fields):
    """cstp_trainer.fit over `batches` on a data mesh of `data` ranks ->
    (each step's metrics, the post-fit parameters), or None off it."""
    from opus_pllm_tpu_torch.core.config import CSTPConfig, TrainConfig
    from opus_pllm_tpu_torch.train import cstp_trainer as ct
    mesh = _mesh(data, 1)
    if mesh is None:
        return None
    cfg, tcfg = CSTPConfig(**cfg_fields), TrainConfig(**tcfg_fields)
    state, tx = ct.create_state(cfg, tcfg, params=convert.cstp_from_jax(
        params_tree, device="cpu"), device="cpu")
    steps = []
    ct.fit(state, tx, cfg, tcfg, batches, mesh=mesh, device="cpu",
           prefetch=0, log_fn=lambda *_: None,
           metrics_fn=lambda i, m: steps.append(
               {k: float(v) for k, v in m.items()}))
    return steps, _np_tree(state.params)


# ---------------------------------------------------------------------------
# serving on a mesh and the data-parallel engine runners
# ---------------------------------------------------------------------------

def _http(port, path, body=None, timeout=120):
    """-> (status, JSON answer) of one request to 127.0.0.1:port."""
    import json
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def lockstep_server(rank, cfg_dicts, tree, adapter_dirs, requests,
                    engine_kw):
    """A tensor-parallel server over both ranks: rank 0 serves HTTP and
    sends `requests` ((path, body) in order: annotate requests, a request
    whose 0.02 s timeout cancels it, an adapter added from a PEFT
    directory, a request under it), then stops; rank 1 follows. ->
    rank 0: the answers and /health; rank 1: its engine's counters."""
    import threading

    from opus_pllm_tpu_torch.core import builder
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.lora.lora import fold_scaling
    from opus_pllm_tpu_torch.serve import server
    from opus_pllm_tpu_torch.serve.engine import ServingEngine
    mesh = _mesh(1, 2)
    params, cfg = _opus(cfg_dicts, tree)
    tok = ByteTokenizer()
    bank = {"a": fold_scaling(*builder.load_peft_adapter(
        adapter_dirs["a"], cfg.llm.num_layers))}
    kw = dict(engine_kw, lora_bank=bank, adapter_capacity=2)
    if rank != 0:
        engine = ServingEngine(params["llm"], cfg.llm, mesh=mesh, **kw)
        engine.register_prefix("sys", token_ids=np.asarray(
            server.system_prefix_ids(tok), np.int64))
        server.serve_follower(engine, mesh, log_fn=lambda *_: None)
        return dict(engine.counters)
    srv = server.OpusServer(params, cfg, tok, mesh=mesh, default_max_new=6,
                            cache_system_prefix=True, **kw)
    httpd = srv.make_http_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        answers = []
        for path, body in requests:
            if path == "/v1/adapters":
                body = dict(body, path=adapter_dirs[body["name"]])
            answers.append(_http(port, path, body))
        health = _http(port, "/health")[1]
    finally:
        httpd.shutdown()
        srv.close()
    return answers, health, dict(srv.engine.counters)


def engine_runner(rank, kind, n, cfg_dicts, tree, examples, gen_fields,
                  file_name):
    """The engine runner with each of `n` ranks running its own engine on
    its slice of the examples (`data_mesh`) -> (results, metrics)."""
    from opus_pllm_tpu_torch.evals import runner as rn
    from opus_pllm_tpu_torch.evals.datasets import (AnnotationExample,
                                                    MCQExample)
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    mesh = _mesh(n, 1)
    if mesh is None:
        return None
    params, cfg = _opus(cfg_dicts, tree)
    kw = dict(gen=GenerationConfig(**gen_fields), max_slots=2,
              splice_batch=2, data_mesh=mesh, log_fn=lambda *_: None)
    if kind == "annotate":
        rep = rn.run_annotation_eval_engine(
            params, cfg, ByteTokenizer(), file_name,
            examples=[AnnotationExample(**e) for e in examples], **kw)
    else:
        rep = rn.run_mcq_eval_engine(
            params, cfg, ByteTokenizer(), file_name,
            examples=[MCQExample(**e) for e in examples], **kw)
    return rep.results, rep.metrics


def cli_serve(rank, argv, port, body, alone=False):
    """The port's `serve` CLI on this rank (only rank 0 when `alone`): rank
    0 answers one request, then takes SIGTERM, drains and returns, and
    its last message stops the followers -> (rank 0's answer, what the
    rank printed); None for a rank that does not serve."""
    import contextlib
    import io
    import os
    import signal
    import threading
    import time

    from opus_pllm_tpu_torch.cli import main as cli_main
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    if alone and rank != 0:
        return None
    cli_main.load_tokenizer = lambda path, family: ByteTokenizer()
    got = {}

    def client():
        end = time.monotonic() + 60
        while time.monotonic() < end:
            try:
                got["health"] = _http(port, "/health", timeout=5)
                break
            except OSError:
                time.sleep(0.1)
        got["answer"] = _http(port, "/v1/annotate", body)
        os.kill(os.getpid(), signal.SIGTERM)
    if rank == 0:
        threading.Thread(target=client, daemon=True).start()
    saved = signal.getsignal(signal.SIGTERM)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli_main.main(argv)
    finally:
        signal.signal(signal.SIGTERM, saved)
    return got.get("answer"), buf.getvalue()


def row_parallel_lora(rank, model, x, w, a, b, scale):
    """A row-parallel projection with a LoRA adapter over `model` ranks
    (decoder._row_parallel, each rank its rows of x, w and A) in bf16 ->
    (the no_grad output, the output with grad on), or None off the mesh."""
    from opus_pllm_tpu_torch.parallel import partition
    mesh = _mesh(1, model)
    if mesh is None:
        return None
    tp = partition.TensorParallel(mesh.model_group, model, mesh.model_index,
                                  True, True, False)
    n = x.shape[-1] // model
    rows = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
    bf = lambda v: _t(v).to(torch.bfloat16)    # noqa: E731
    p = {"kernel": bf(w[rows])}
    la = {"A": _t(a[rows]), "B": _t(b)}
    with torch.no_grad():
        off = decoder._row_parallel(p, la, bf(x[..., rows]), scale, "torch",
                                    tp)
    xg = bf(x[..., rows]).requires_grad_(True)
    on = decoder._row_parallel(p, la, xg, scale, "torch", tp)
    return off.float().numpy(), on.detach().float().numpy()
