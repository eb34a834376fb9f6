"""The port's command line (port of `opus_pllm_tpu/cli/main.py`): annotate /
annotate-all / mcq / chat / serve / train-cstp / train-projector /
train-lora / precompute-embeddings / precompute-pairs / convert-weights /
bench, with the JAX CLI's subcommands, options, defaults and choices.

    python -m opus_pllm_tpu_torch.cli.main annotate --test-json ... \\
        --model-base ... --weights ... --esm ...
    python -m opus_pllm_tpu_torch.cli.main train-lora --train-json ... --out ...

One option the JAX CLI lacks: `--device` (default "cuda"), the counterpart
of the JAX_PLATFORMS variable the JAX CLI reads. Without a GPU the model
commands stop with an error unless `--device cpu` is given; nothing falls
back to the CPU. The tokenizer comes from `load_tokenizer` (a HF tokenizer
directory, infer/hf_tokenizer.py). The generation commands (annotate,
annotate-all, mcq, chat, serve) fuse the decoder's projections once on
load (`models.decoder.fuse_layer`): 4 projection products a layer instead
of 7, where the JAX CLI keeps the 7; the train commands keep them apart.

The parallel axes of serving (cli/main.py:65-74, :86-91, :198-211): each
rank is a process of a `torchrun` run, e.g.

    torchrun --nproc-per-node 4 -m opus_pllm_tpu_torch.cli.main annotate \
        --mesh 1,4 --test-json ... --model-base ...

`--mesh D[,M]` (annotate, annotate-all, mcq, chat) splits the examples
over D data rows and the LLM over M tensor-parallel ranks; each rank
loads only its share (`core.builder.load_pretrained(mesh=...)`), and the
projections are fused after the cut. `--seq-shards N` shards each
prompt's KV cache over N ranks (ring prefill, LSE-merged decode);
`--distributed` alone runs every rank on the data axis, and under
`--engine` each rank runs its own engine on its slice of the examples
(the JAX CLI's mesh None: runner.py:405, :667). The process group comes
from torchrun's environment (`core.mesh.initialize_distributed`);
`--mesh` without a live group of D x M ranks is an error naming
torchrun. Exclusions as in JAX: `--seq-shards` with `--mesh`; `--engine`
with `--seq-shards` or with `--mesh D,M`, D > 1. Rank 0 prints the
results.

`train-lora` / `train-projector --mesh D[,M]` train data- and
tensor-parallel with the train state sharded
(`train.multimodal_trainer.fit(mesh=)`); `train-cstp --mesh D` is stage
(a)'s data parallelism. `--distributed` alone puts every rank on the data
axis (the JAX CLI leaves each process its own whole-batch copy there;
the trained parameters are the same). Rank 0 saves and prints.
`serve --mesh 1,N` serves tensor-parallel in lockstep (rank 0 runs HTTP,
the others `serve.server.serve_follower`); `serve --distributed` alone
serves one whole model a rank, as in JAX, and stops when two ranks of
one host would bind one port.

Refused with NotImplementedError, naming ROADMAP.md §1 item 10 (steps
(c) and (d)): `--seq-shards` on the train commands, `--pipe-stages`,
`--micro-batches`, `--pipe-data` > 1. Parsed and without effect:
`--unroll-layers` and `--scan-mode` (the JAX layer-loop layouts; the
port runs a plain loop over its layer list), and `--mesh` /
`--distributed` on `precompute-pairs` and `convert-weights` (the JAX
commands take them and never read them). `bench` runs the JAX
package's TPU harness there; here it exits with a pointer to
chip_smoke.py, which holds the port's measurements.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from typing import Optional

import numpy as np

STANDARD_AA = set("ACDEFGHIKLMNPQRSTVWY")
ITEM_10 = ("ROADMAP.md §1 item 10, sequence- and pipeline-parallel "
           "training")


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (the port's counterpart of "
                        "JAX_PLATFORMS); 'cpu' runs on the CPU, which "
                        "nothing falls back to")


def _model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-base", default=None,
                   help="HF dir of the base LLM (family by path substring)")
    p.add_argument("--weights", default=None,
                   help="opus-pllm weights dir (modality_encoder/, "
                        "modality_refinement_projector/, lora_adapter/)")
    p.add_argument("--esm", default=None, help="fair-esm .pt or HF-ESM dir")
    p.add_argument("--no-cstp", action="store_true",
                   help="raw-ESM pipeline (switch projector over 1280-d)")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer dir (default: --model-base)")
    p.add_argument("--switch-projector-type", default="mlp2x_gelu",
                   help="'linear' or 'mlp<N>x_gelu' (the reference's "
                        "--switch_projector_type, run_opus_ddp.py:160; "
                        "must match the modality_refinement_projector "
                        "checkpoint's layer count)")
    p.add_argument("--load-int8", action="store_true",
                   help="int8 weight-only LLM (the reference's --load-8bit)")
    p.add_argument("--load-int4", action="store_true",
                   help="int4 grouped weight-only LLM (the reference's "
                        "--load-4bit / NF4): half the weight bytes of int8")
    p.add_argument("--quantize-cache", nargs="?", const="int8",
                   default=False, choices=["int8", "int4"],
                   help="quantized KV cache during generation: bare flag "
                        "or 'int8' = half the cache bytes; 'int4' = "
                        "packed 4-bit (quarter)")
    p.add_argument("--unroll-layers", action="store_true",
                   help="the JAX package's per-layer decode layout; "
                        "changes nothing here (the port always runs a "
                        "loop over its layer list)")
    p.add_argument("--mesh", default=None, metavar="DATA[,MODEL]",
                   help="(data, model) mesh of torchrun ranks, e.g. '1,4': "
                        "the examples (or the training batch) split over "
                        "the data rows, the LLM tensor-parallel over the "
                        "model ranks; serve takes '1,N'")
    p.add_argument("--distributed", action="store_true",
                   help="start the process group from torchrun's "
                        "environment (RANK / WORLD_SIZE / MASTER_ADDR); "
                        "without --mesh every rank is on the data axis "
                        "(--engine and serve: one whole engine a rank)")
    _device_arg(p)


def _gen_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--top-p", type=float, default=0.7)
    p.add_argument("--max-new-tokens", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-beams", type=int, default=1,
                   help="beam search width (run_opus_ddp.py:156-158); >1 "
                        "disables sampling")
    p.add_argument("--length-penalty", type=float, default=1.0)
    p.add_argument("--seq-shards", type=int, default=0,
                   help="shard each prompt's KV cache over this many "
                        "torchrun ranks (ring prefill + LSE-merged decode, "
                        "infer/sp_engine.py); exclusive with --mesh")
    p.add_argument("--draft-layers", type=int, default=0,
                   help="self-speculative decoding: draft with the "
                        "target's own first N layers, verify --n-draft "
                        "proposals per target pass. Greedy decodes are "
                        "token-identical to plain decoding; sampled ones "
                        "are distribution-identical (rejection-verified "
                        "speculative sampling), on the static path and "
                        "under --engine / serve")
    p.add_argument("--n-draft", type=int, default=4,
                   help="speculative proposals per verify pass "
                        "(--draft-layers only)")


def _train_axes(args) -> None:
    """The train commands' exclusions, as in JAX (cli/main.py:616-625),
    then the axes not ported yet, refused before anything loads."""
    seq, pipe = getattr(args, "seq_shards", 0), getattr(args, "pipe_stages",
                                                        0)
    if sum(bool(x) for x in (seq, pipe, getattr(args, "mesh", None))) > 1:
        raise SystemExit("--seq-shards, --pipe-stages and --mesh are "
                         "mutually exclusive (sequence vs pipeline vs "
                         "data/model parallelism)")
    if getattr(args, "val_json", None) and (seq or pipe):
        raise SystemExit("--val-json runs on the standard (mesh/single-"
                         "device) path only; drop --seq-shards/"
                         "--pipe-stages")
    for flag, value in (("--seq-shards", seq), ("--pipe-stages", pipe),
                        ("--micro-batches",
                         getattr(args, "micro_batches", 0))):
        if value:
            raise NotImplementedError(f"{flag} is not ported yet ({ITEM_10})")
    if getattr(args, "pipe_data", 1) > 1:
        raise NotImplementedError(f"--pipe-data > 1 is not ported yet "
                                  f"({ITEM_10})")


def _launch_hint(n) -> str:
    return (f"start it with torchrun --nproc-per-node {n} -m "
            f"opus_pllm_tpu_torch.cli.main ...")


def _parallel(args):
    """--mesh / --seq-shards / --distributed of a generation command ->
    (mesh or None, seq mesh or None), checked and built before anything
    loads: the process group from torchrun's environment, then the mesh
    over every rank of it (cli/main.py:198-211, :337-561)."""
    flag = getattr(args, "mesh", None)
    n_seq = getattr(args, "seq_shards", 0)
    if not (flag or n_seq or getattr(args, "distributed", False)):
        return None, None
    if flag and n_seq:
        raise SystemExit("--seq-shards and --mesh are mutually exclusive")
    import torch.distributed as dist

    from ..core import mesh as mesh_mod
    mcfg = mesh_mod.parse_mesh_flag(flag) if flag else None
    want = mcfg.data * mcfg.model if mcfg else n_seq
    what = f"--mesh {flag}" if flag else (f"--seq-shards {n_seq}" if n_seq
                                          else "--distributed")
    want = want or "N"
    if not mesh_mod.initialize_distributed(device_type=_device(args).type):
        raise SystemExit(f"{what} needs a process group of {want} ranks "
                         f"and none is running: {_launch_hint(want)}")
    world = dist.get_world_size()
    if n_seq:
        from ..parallel.ring import make_sp_mesh
        if n_seq != world:
            raise SystemExit(f"--seq-shards {n_seq} runs on {n_seq} ranks, "
                             f"this process group has {world}: "
                             f"{_launch_hint(n_seq)}")
        return None, make_sp_mesh(n_seq)
    try:
        return mesh_mod.make_mesh(mcfg), None
    except ValueError as e:
        raise SystemExit(f"{what}: {e} (the process group has {world} "
                         f"ranks): {_launch_hint(want)}") from None


def _device(args):
    """The torch device of --device (this rank's card under a process
    group); a CUDA device without a GPU is an error (the run does not move
    to the CPU)."""
    import torch
    import torch.distributed as dist
    dev = torch.device(getattr(args, "device", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu "
                         "to run on the CPU")
    if dist.is_initialized():
        from ..core.mesh import rank_device
        return rank_device(dev.type)
    return dev


def _engine_mesh(mesh, seq_mesh):
    """--engine composes with tensor-parallel meshes only (--mesh 1,N):
    a data axis > 1 or --seq-shards has no engine meaning (the slot pool
    is the batch axis), refused rather than left idle (cli/main.py:198)."""
    if seq_mesh is not None:
        raise SystemExit("--engine and --seq-shards are mutually exclusive")
    if mesh is not None and mesh.data != 1:
        raise SystemExit("--engine shards tensor-parallel only: use "
                         "--mesh 1,N (the slot pool is the batch axis)")
    return mesh


def _engine_meshes(args, mesh, seq_mesh):
    """--engine's (tensor-parallel mesh, data mesh): `--distributed`
    without --mesh gives every rank its own engine over its slice of the
    examples, gathered afterwards (the JAX CLI's mesh None); otherwise the
    engine's mesh is `_engine_mesh`'s and there is no data split."""
    if (mesh is not None and not getattr(args, "mesh", None)
            and getattr(args, "distributed", False)):
        return None, mesh
    return _engine_mesh(mesh, seq_mesh), None


def _is_rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def load_tokenizer(path: str, family: str):
    """The CLI's one tokenizer source (cli/main.py:310-311, :746): the HF
    tokenizer in `path` with the family's pad / eos rules."""
    from ..infer.hf_tokenizer import HFTokenizer
    return HFTokenizer(path, family=family)


def _adapter_specs(args) -> dict:
    """--adapter NAME=PATH (repeatable) -> {name: path}, checked before
    the model loads: the format, duplicate names and that each path
    exists."""
    specs: dict = {}
    for spec in getattr(args, "adapter", None) or ():
        name, _, path = spec.partition("=")
        if not name or not path:
            raise SystemExit(f"--adapter expects name=path, got {spec!r}")
        if name in specs:
            raise SystemExit(f"duplicate --adapter name {name!r} "
                             f"({specs[name]} and {path})")
        if not os.path.isdir(path):
            raise SystemExit(f"--adapter {name}: no such directory {path}")
        specs[name] = path
    return specs


def _adapter_bank(specs: dict, cfg) -> dict:
    """{name: path} -> {name: folded unmerged tree}: each PEFT adapter's
    alpha / rank scaling folds into B, so one bank serves mixed recipes
    at the engine's lora_scale 1."""
    from ..core import builder
    from ..lora.lora import fold_scaling
    bank = {}
    for name, path in specs.items():
        tree, scale = builder.load_peft_adapter(path, cfg.llm.num_layers)
        bank[name] = fold_scaling(tree, scale)
    return bank


def _adapter_for(names, test_json: str) -> Optional[str]:
    """The bank adapter a test set runs under: the one NAME that is a
    substring of the set's basename; none -> base weights; two ->
    ambiguous, refused (--map resolves it)."""
    base = os.path.basename(test_json)
    hits = [n for n in names if n in base]
    if len(hits) > 1:
        raise SystemExit(f"test set {base!r} matches multiple adapters "
                         f"{sorted(hits)}; pick one with "
                         f"--map {base}=NAME")
    return hits[0] if hits else None


def _adapter_map(names, test_jsons, map_flags) -> dict:
    """The whole set -> adapter mapping, computed and printed before the
    model loads. --map BASENAME=NAME overrides one set's match;
    BASENAME= forces base weights."""
    overrides = {}
    for spec in map_flags or ():
        base, _, name = spec.partition("=")
        if not base:
            raise SystemExit(f"--map expects basename=adapter, got {spec!r}")
        if name and name not in names:
            raise SystemExit(f"--map {spec!r}: {name!r} is not a bank "
                             f"adapter ({sorted(names)})")
        overrides[base] = name or None
    bases = [os.path.basename(t) for t in test_jsons]
    unknown = set(overrides) - set(bases)
    if unknown:
        raise SystemExit(f"--map names test sets not in --test-jsons: "
                         f"{sorted(unknown)}")
    mapping = {}
    for tj, base in zip(test_jsons, bases):
        mapping[tj] = (overrides[base] if base in overrides
                       else _adapter_for(names, tj))
        print(f"{base}: adapter {mapping[tj] or '<base weights>'}")
    return mapping


def _single_adapter(args, specs) -> Optional[str]:
    """annotate / mcq: the bank adapter the whole set runs under."""
    if (specs or getattr(args, "use_adapter", None)) \
            and not getattr(args, "engine", False):
        raise SystemExit("--adapter/--use-adapter need --engine (the "
                         "static path merges adapters via --weights "
                         "instead)")
    if not specs:
        if getattr(args, "use_adapter", None):
            raise SystemExit("--use-adapter needs --adapter NAME=PATH "
                             "entries")
        return None
    aid = getattr(args, "use_adapter", None)
    if aid is not None and aid not in specs:
        raise SystemExit(f"--use-adapter {aid!r} is not in the bank "
                         f"({sorted(specs)})")
    if aid is None:
        aid = _adapter_for(specs, args.test_json)
    print(f"{os.path.basename(args.test_json)}: adapter "
          f"{aid or '<base weights>'}")
    return aid


def _resume_setup(args, state, restore_fn, data):
    """Resume and periodic saves for the train commands: the full state's
    CheckpointManager in OUT/resume_state (the final trainable-only save
    stays the load surface), --resume restores its latest step and skips
    the batches it consumed, --max-steps bounds the stream. Returns
    (state, data, manager or None, save_every)."""
    from ..core.checkpoint import CheckpointManager

    save_every = getattr(args, "save_every", 0)
    rs_mgr = None
    if save_every or getattr(args, "resume", False):
        rs_mgr = CheckpointManager(os.path.join(args.out, "resume_state"),
                                   max_to_keep=2)
    skip = 0
    if getattr(args, "resume", False) and rs_mgr.latest_step() is not None:
        state = restore_fn(rs_mgr, state)
        skip = int(state.step)
        if _is_rank0():
            print(f"resuming from step {skip}")
    if skip:
        data = itertools.islice(data, skip, None)
    if getattr(args, "max_steps", 0):
        data = itertools.islice(data, max(args.max_steps - skip, 0))
    return state, data, rs_mgr, save_every


def _opus_config(args, llm_cfg):
    from ..core import builder
    from ..core.config import OpusConfig, SwitchProjectorConfig
    esm_cfg = builder.esm_config_for(args.esm)
    cstp = None if args.no_cstp else builder.cstp_config_for(args.weights)
    return OpusConfig(
        esm=esm_cfg, cstp=cstp,
        switch=SwitchProjectorConfig(
            input_dim=esm_cfg.embed_dim if args.no_cstp else cstp.proj_dim,
            llm_hidden_size=llm_cfg.hidden_size,
            projector_type=getattr(args, "switch_projector_type",
                                   "mlp2x_gelu")),
        llm=llm_cfg)


def _quantize_flag(args) -> Optional[str]:
    return ("int4" if getattr(args, "load_int4", False)
            else "int8" if getattr(args, "load_int8", False) else None)


def _build(args, mesh=None):
    """Config, parameters on --device and tokenizer of a model command
    (cli/main.py:240-311) -> (cfg, params, tokenizer). Under a mesh whose
    model axis splits the LLM each rank loads only its share, and cfg.llm
    is the share's config."""
    from ..core import builder
    if not args.model_base:
        raise SystemExit("--model-base is required for model commands")
    device = _device(args)
    llm_cfg = builder.decoder_config_for(args.model_base)
    cfg = _opus_config(args, llm_cfg)
    params, _ = builder.load_pretrained(
        args.model_base, args.weights, cfg, esm_path=args.esm,
        quantize=_quantize_flag(args),
        # the train commands take the v1 int4 layout, decode the v2 one
        int4_layout=("v1" if getattr(args, "cmd", "").startswith("train")
                     else "auto"), device=device, mesh=mesh)
    builder.check_train_layout(getattr(args, "cmd", ""), params["llm"])
    if mesh is not None and mesh.model > 1:
        import dataclasses

        from ..parallel import partition
        cfg = dataclasses.replace(cfg, llm=partition.config_for(
            params["llm"], llm_cfg, mesh))
    if not getattr(args, "cmd", "").startswith("train"):
        # generation decodes on one [q|k|v] and one [gate|up] product a
        # layer: 4 projection launches instead of 7. A layer at a time, so
        # only one layer's unfused copy is alive besides the tree.
        from ..models import decoder
        layers = params["llm"]["layers"]
        for i, lp in enumerate(layers):
            layers[i] = decoder.fuse_layer(lp)
    tok = load_tokenizer(args.tokenizer or args.model_base, llm_cfg.family)
    return cfg, params, tok


def _bert_embed_fn(biobert_dir: Optional[str], device):
    """BERTScore embedder from a local BioBERT HF dir (weights +
    vocab.txt); None disables BERTScore."""
    if not biobert_dir:
        return None
    from ..core import convert
    from ..core.config import BertConfig
    from ..core.util import to_device
    from ..evals.textproc import WordPieceTokenizer
    from ..models import bert

    cfg = BertConfig()
    params = to_device(convert.bert_from_hf(
        convert.load_hf_dir(biobert_dir), cfg), device)
    vocab = WordPieceTokenizer.load_vocab(os.path.join(biobert_dir,
                                                       "vocab.txt"))
    tok = WordPieceTokenizer(vocab, lowercase=False)   # biobert is cased
    return bert.make_embed_fn(params, cfg, tok, max_tokens=500)


def _gen_config(args, tok, max_new: int, seed: Optional[int] = None):
    from ..core.config import GenerationConfig
    return GenerationConfig(
        max_new_tokens=max_new, temperature=args.temperature,
        top_p=args.top_p, eos_token_id=tok.eos_token_id,
        pad_token_id=tok.pad_token_id,
        seed=args.seed if seed is None else seed,
        quantize_cache=getattr(args, "quantize_cache", False),
        num_beams=getattr(args, "num_beams", 1),
        length_penalty=getattr(args, "length_penalty", 1.0),
        draft_layers=getattr(args, "draft_layers", 0),
        n_draft=getattr(args, "n_draft", 4))


def cmd_annotate(args) -> None:
    from ..evals import runner
    from ..evals.datasets import max_new_tokens_for

    specs = _adapter_specs(args)
    aid = _single_adapter(args, specs)
    mesh, seq_mesh = _parallel(args)
    use_engine = getattr(args, "engine", False)
    e_mesh, d_mesh = (_engine_meshes(args, mesh, seq_mesh) if use_engine
                      else (None, None))
    cfg, params, tok = _build(args, mesh)
    gen = _gen_config(args, tok, args.max_new_tokens
                      or max_new_tokens_for(args.test_json))
    bank = _adapter_bank(specs, cfg)
    embed_fn = _bert_embed_fn(getattr(args, "biobert", None), _device(args))
    if use_engine:
        rep = runner.run_annotation_eval_engine(
            params, cfg, tok, args.test_json, gen=gen,
            max_slots=args.max_slots, steps_per_tick=args.steps_per_tick,
            splice_batch=args.batch_size, save_path=args.save_path,
            lora_bank=bank or None, adapter_id=aid, mesh=e_mesh,
            data_mesh=d_mesh,
            cache_prefix=getattr(args, "cache_prefix", False),
            bert_embed_fn=embed_fn)
    else:
        rep = runner.run_annotation_eval(
            params, cfg, tok, args.test_json, gen=gen,
            batch_size=args.batch_size, save_path=args.save_path,
            bert_embed_fn=embed_fn, mesh=mesh, seq_mesh=seq_mesh)
    if _is_rank0():
        print(json.dumps(rep.metrics))


def cmd_annotate_all(args) -> None:
    """Test sets x repeats (eval_total_ablation.sh:27-73 runs each set 5
    times to average the sampling noise)."""
    from ..evals import runner
    from ..evals.datasets import max_new_tokens_for

    use_engine = getattr(args, "engine", False)
    specs = _adapter_specs(args)
    if (specs or getattr(args, "map", None)) and not use_engine:
        raise SystemExit("--adapter/--map need --engine")
    adapter_map = (_adapter_map(specs, args.test_jsons,
                                getattr(args, "map", None))
                   if specs else {})
    mesh, seq_mesh = _parallel(args)
    e_mesh, d_mesh = (_engine_meshes(args, mesh, seq_mesh) if use_engine
                      else (None, None))
    cfg, params, tok = _build(args, mesh)
    bank = _adapter_bank(specs, cfg)
    engine_cache: dict = {}
    all_metrics = {}
    for test_json in args.test_jsons:
        runs = []
        for rep in range(args.repeats):
            gen = _gen_config(args, tok, args.max_new_tokens
                              or max_new_tokens_for(test_json),
                              seed=args.seed + rep)
            save = None
            if args.save_dir:
                os.makedirs(args.save_dir, exist_ok=True)
                base = os.path.splitext(os.path.basename(test_json))[0]
                save = os.path.join(args.save_dir, f"{base}_rep{rep}.json")
            if use_engine:
                out = runner.run_annotation_eval_engine(
                    params, cfg, tok, test_json, gen=gen,
                    max_slots=args.max_slots,
                    steps_per_tick=args.steps_per_tick,
                    splice_batch=args.batch_size, save_path=save,
                    lora_bank=bank or None,
                    adapter_id=adapter_map.get(test_json),
                    engine_cache=engine_cache, mesh=e_mesh,
                    data_mesh=d_mesh,
                    cache_prefix=getattr(args, "cache_prefix", False))
            else:
                out = runner.run_annotation_eval(
                    params, cfg, tok, test_json, gen=gen,
                    batch_size=args.batch_size, save_path=save, mesh=mesh,
                    seq_mesh=seq_mesh)
            runs.append(out.metrics)
        all_metrics[test_json] = runs
    if _is_rank0():
        print(json.dumps(all_metrics, indent=1))


def cmd_mcq(args) -> None:
    from ..evals import runner

    use_engine = getattr(args, "engine", False)
    specs = _adapter_specs(args)
    aid = _single_adapter(args, specs)
    if getattr(args, "scored", False):
        if use_engine:
            raise SystemExit("--scored is a single-forward evaluator; "
                             "drop --engine")
        if (getattr(args, "draft_layers", 0) or getattr(args, "mesh", None)
                or getattr(args, "seq_shards", 0)):
            raise SystemExit("--scored runs single-device (one prefill "
                             "forward): drop --mesh/--seq-shards/"
                             "--draft-layers")
    mesh, seq_mesh = _parallel(args)
    e_mesh, d_mesh = (_engine_meshes(args, mesh, seq_mesh) if use_engine
                      else (None, None))
    cfg, params, tok = _build(args, mesh)
    gen = _gen_config(args, tok, args.max_new_tokens or 50)
    if getattr(args, "scored", False):
        rep = runner.run_mcq_eval_scored(
            params, cfg, tok, args.test_json, batch_size=args.batch_size,
            save_path=args.save_path)
    elif use_engine:
        rep = runner.run_mcq_eval_engine(
            params, cfg, tok, args.test_json, gen=gen,
            max_slots=args.max_slots, steps_per_tick=args.steps_per_tick,
            splice_batch=args.batch_size, save_path=args.save_path,
            lora_bank=_adapter_bank(specs, cfg) or None, adapter_id=aid,
            mesh=e_mesh, data_mesh=d_mesh,
            cache_prefix=getattr(args, "cache_prefix", False))
    else:
        rep = runner.run_mcq_eval(params, cfg, tok, args.test_json, gen=gen,
                                  batch_size=args.batch_size,
                                  save_path=args.save_path, mesh=mesh,
                                  seq_mesh=seq_mesh)
    if _is_rank0():
        print(json.dumps(rep.metrics))


def cmd_chat(args) -> None:
    """The interactive REPL on stdin: professor-style annotation
    (run_opus_online.py) or, with --chat-template, the chat-template flow
    (eval_run_online.py)."""
    from ..evals import runner
    from ..infer.conversation import VICUNA_V0, VICUNA_V3, annotation_prompt

    mesh, seq_mesh = _parallel(args)
    cfg, params, tok = _build(args, mesh)
    gen = _gen_config(args, tok, args.max_new_tokens or 256)
    draft = runner.make_draft(params, cfg, gen)   # once, not per turn
    device = params["llm"]["embed_tokens"]["embedding"].device
    rank0 = _is_rank0()
    if rank0:
        print("opus-pllm-tpu chat — empty line to exit")
    turn = 0   # seeds each turn's sampling, so a repeated prompt resamples
    while True:
        instr, seq = _read_turn(rank0)
        if not instr:
            break
        bad = set(seq) - STANDARD_AA
        if bad:
            if rank0:
                print(f"invalid amino acids: {''.join(sorted(bad))} "
                      f"(allowed: {''.join(sorted(STANDARD_AA))})")
            continue
        if getattr(args, "chat_template", False):
            prompt = tok.apply_chat_template(
                [{"role": "system", "content": VICUNA_V3.system},
                 {"role": "user", "content": "<seq>\n" + instr}],
                add_generation_prompt=True)
        else:
            prompt = annotation_prompt("<seq>\n" + instr, VICUNA_V0)
        ids, mask, esm_toks = runner._prepare_inputs(
            tok, [prompt], [seq], prompt_bucket=64, esm_bucket=128,
            device=device)
        texts, _ = runner._generate_spliced(
            params, cfg, tok, ids, mask, esm_toks, gen, impl="auto",
            batch_index=turn, draft=draft, seq_mesh=seq_mesh,
            data_index=mesh.data_index if mesh is not None else 0)
        turn += 1
        if rank0:
            print(texts[0])


def _read_turn(rank0: bool):
    """One (instruction, sequence) from stdin; under a process group rank
    0 reads it and broadcasts it, so every rank runs the same turn. An
    empty instruction (or end of input) ends the chat."""
    import torch.distributed as dist
    turn = ["", ""]
    if rank0:
        try:
            turn[0] = input("instruction> ").strip()
            if turn[0]:
                turn[1] = input("sequence> ").strip().upper()
        except EOFError:
            turn = ["", ""]
    if dist.is_initialized():
        dist.broadcast_object_list(turn, src=0)
    return turn[0], turn[1]


def cmd_train_cstp(args) -> None:
    import torch

    from ..core.checkpoint import CheckpointManager
    from ..core.config import CSTPConfig, TrainConfig
    from ..data.datasets import UniProtQAVecDataset, batch_iterator
    from ..train import cstp_trainer

    mesh, _ = _parallel(args)
    device = _device(args)
    tcfg = TrainConfig(learning_rate=args.lr, weight_decay=args.wd,
                       batch_size=args.batch_size, num_epochs=args.epochs)
    se, te = UniProtQAVecDataset(args.vec_pickle).arrays()
    # the adapter's input widths from the pairs (the JAX CLI hard-wires
    # CSTPConfig()'s 1280 / 5120, cli/main.py:579, which the pairs of
    # precompute-pairs over a 4096-wide text LM do not fit)
    cfg = CSTPConfig(protein_dim=se.shape[1], text_dim=te.shape[1])
    g = torch.Generator(device=device)
    g.manual_seed(args.seed)
    state, tx = cstp_trainer.create_state(cfg, tcfg, generator=g,
                                          device=device)
    mgr = CheckpointManager(args.out, max_to_keep=2)

    def batches():
        for idx in batch_iterator(len(se), tcfg.batch_size, seed=args.seed,
                                  epochs=tcfg.num_epochs):
            yield se[idx], te[idx]

    state, data, rs_mgr, save_every = _resume_setup(
        args, state, cstp_trainer.restore_state, batches())
    state = cstp_trainer.fit(state, tx, cfg, tcfg, data, mesh=mesh,
                             ckpt=rs_mgr, save_every=save_every,
                             device=device)
    if _is_rank0():
        mgr.save(int(state.step), state.params)
        print(f"saved CSTP adapter at step {int(state.step)} -> {args.out}")


def _export_reference(args, cfg, trainable, lcfg) -> None:
    """--export-reference-format: the switch as the reference's
    modality_refinement_projection.bin, the LoRA adapter as a PEFT
    directory with its adapter_config.json (cli/main.py:679-705)."""
    from ..core import convert as cv
    from ..lora.lora import _proj_dims
    if "switch" in trainable:
        d = os.path.join(args.out, "modality_refinement_projector")
        os.makedirs(d, exist_ok=True)
        cv.save_torch_state_dict(
            cv.switch_projector_to_torch(trainable["switch"]),
            os.path.join(d, "modality_refinement_projection.bin"))
        print(f"exported switch projector (reference format) -> {d}")
    if "lora" in trainable:
        d = os.path.join(args.out, "lora_adapter")
        os.makedirs(d, exist_ok=True)
        cv.save_torch_state_dict(
            cv.lora_to_peft(trainable["lora"], family=cfg.llm.family),
            os.path.join(d, "adapter_model.bin"))
        # target_modules in HF names: without it PEFT falls back to the
        # model's default (q/v only) and drops the other adapters
        hf_name = {"o_proj": "out_proj"} if cfg.llm.family == "opt" else {}
        targets = [hf_name.get(t, t) for t in lcfg.target_modules
                   if t in _proj_dims(cfg.llm)] if lcfg else []
        with open(os.path.join(d, "adapter_config.json"), "w") as f:
            json.dump({"r": lcfg.rank if lcfg else 16,
                       "lora_alpha": lcfg.alpha if lcfg else 32,
                       "peft_type": "LORA", "task_type": "CAUSAL_LM",
                       "lora_dropout": 0.0, "bias": "none",
                       "target_modules": targets}, f)
        print(f"exported LoRA adapter (PEFT format) -> {d}")


def _train_multimodal(args, *, lora: bool) -> None:
    import torch

    from ..core.checkpoint import CheckpointManager
    from ..core.config import LoRAConfig, TrainConfig
    from ..data.collate import instruction_batches
    from ..data.datasets import InstructionDataset
    from ..train import multimodal_trainer as mmt

    import dataclasses

    from ..core import builder

    _train_axes(args)
    mesh, _ = _parallel(args)
    cfg, params, tok = _build(args, mesh)
    # the trainable tree is the single process's (drawn from the whole
    # model's config), then cut to this rank's share
    full_cfg = dataclasses.replace(
        cfg, llm=builder.decoder_config_for(args.model_base))
    device = params["llm"]["embed_tokens"]["embedding"].device
    tcfg = TrainConfig(learning_rate=args.lr, weight_decay=args.wd,
                       batch_size=args.batch_size, num_epochs=args.epochs,
                       ce_chunk=args.ce_chunk, scan_mode=args.scan_mode,
                       grad_accum=args.grad_accum, remat=args.remat)
    lcfg = LoRAConfig(rank=args.lora_rank) if lora else None
    ds = InstructionDataset(args.train_json)
    g = torch.Generator(device=device)
    g.manual_seed(args.seed)
    state, tx = mmt.create_state(full_cfg, tcfg, params, generator=g,
                                 train_switch=not lora or args.train_switch,
                                 lora_cfg=lcfg, device=device)
    batches = instruction_batches(ds, tok, tcfg.batch_size, seed=args.seed,
                                  epochs=tcfg.num_epochs,
                                  max_len=args.max_len)
    state, batches, rs_mgr, save_every = _resume_setup(
        args, state, mmt.restore_state, batches)
    if mesh is not None:
        from ..parallel import partition
        params, cfg = partition.shard_frozen(mesh, params, cfg)
        state, tx = mmt.shard_state(mesh, state, cfg)
    mgr = CheckpointManager(args.out, max_to_keep=2)
    val_fn = None
    if args.val_json:
        vds = InstructionDataset(args.val_json)
        # deterministic, every held-out example (a smaller last batch)
        val_fn = lambda: instruction_batches(  # noqa: E731
            vds, tok, min(tcfg.batch_size, len(vds)), shuffle=False,
            seed=0, epochs=1, drop_remainder=False, max_len=args.max_len)
    state = mmt.fit(state, tx, cfg, tcfg, params, batches, lora_cfg=lcfg,
                    mesh=mesh, ckpt=rs_mgr, save_every=save_every,
                    val_batches_fn=val_fn, val_every=args.val_every,
                    device=device)
    trainable = mmt.full_trainable(state)
    if not _is_rank0():
        return
    mgr.save(int(state.step), trainable)
    print(f"saved trainable tree at step {int(state.step)} -> {args.out}")
    if args.export_reference_format:
        _export_reference(args, full_cfg, trainable, lcfg)


def cmd_precompute(args) -> None:
    from ..core import builder
    from ..data import precompute

    device = _device(args)
    cfg = builder.esm_config_for(args.esm)
    params = builder.load_esm(args.esm, cfg, device=device)
    fn = (precompute.precompute_instruction_embeddings
          if args.mode == "jsonl" else precompute.precompute_sequence_map)
    n = fn(params, cfg, args.json, args.out, batch_size=args.batch_size,
           device=device)
    print(f"wrote {n} entries -> {args.out}")


def cmd_precompute_pairs(args) -> None:
    """UniProtQA pickle -> stage-(a) (seq, text) embedding pairs."""
    import torch

    from ..core import builder, convert
    from ..core.util import to_device
    from ..data import precompute
    from ..models import decoder

    device = _device(args)
    esm_cfg = builder.esm_config_for(args.esm)
    esm_params = builder.load_esm(args.esm, esm_cfg, device=device)
    llm_cfg = builder.decoder_config_for(args.model_base)
    if args.model_base and os.path.isdir(args.model_base):
        llm_params = to_device(convert.decoder_from_hf(
            convert.load_hf_dir(args.model_base), llm_cfg), device)
    else:
        g = torch.Generator(device=device)
        g.manual_seed(0)
        llm_params = decoder.init(llm_cfg, generator=g, device=device)
    tok = load_tokenizer(args.tokenizer or args.model_base, llm_cfg.family)
    n = precompute.precompute_cstp_pairs(
        esm_params, esm_cfg, llm_params, llm_cfg, tok, args.uniprot_pickle,
        args.out, batch_size=args.batch_size, device=device)
    print(f"wrote {n} pairs -> {args.out}")


def cmd_convert(args) -> None:
    """Reference-format checkpoints -> the native `save_native` layout."""
    from ..core import builder
    from ..kernels.quant4 import quant_layout_of

    if not args.model_base:
        raise SystemExit("--model-base required")
    cfg = _opus_config(args, builder.decoder_config_for(args.model_base))
    params, _ = builder.load_pretrained(
        args.model_base, args.weights, cfg, esm_path=args.esm,
        quantize=_quantize_flag(args), int4_layout=args.int4_layout,
        device=_device(args))
    builder.save_native(args.out, params)
    print(f"saved native checkpoint -> {args.out} "
          f"(llm layout: {quant_layout_of(params['llm'])})")


def cmd_bench(args) -> None:
    raise SystemExit("bench runs the JAX package's TPU harness (bench.py); "
                     "the port's measurements are chip_smoke.py's: run "
                     "`python3 chip_smoke.py` on a machine with a GPU")


def _serve_mesh(args):
    """serve's parallel flags -> the engine's mesh or None: --mesh 1,N
    (tensor-parallel, in lockstep); --mesh D,M with D > 1 refused as the
    engine refuses it; --distributed alone one whole server a rank (the
    JAX CLI's mesh None), which ranks sharing a host cannot do: they
    would all bind one port."""
    if getattr(args, "mesh", None):
        mesh, _ = _parallel(args)
        return _engine_mesh(mesh, None)
    if getattr(args, "distributed", False):
        env = os.environ
        local = int(env.get("LOCAL_WORLD_SIZE", env.get("WORLD_SIZE", "1")))
        if local > 1:
            raise SystemExit(
                f"serve --distributed without --mesh runs one whole "
                f"server a rank, and the {local} ranks on this host would "
                f"all bind port {args.port}: start one rank a host, or "
                f"serve tensor-parallel with --mesh 1,{local}")
    return None


def cmd_serve(args) -> None:
    """The HTTP serving daemon over the continuous-batching engine
    (serve/engine.py + serve/server.py); under --mesh 1,N rank 0 serves
    and the other ranks follow it in lockstep."""
    from ..serve.server import (OpusServer, serve_follower,
                                system_prefix_ids)

    specs = _adapter_specs(args)
    mesh = _serve_mesh(args)
    cfg, params, tok = _build(args, mesh)
    bank = _adapter_bank(specs, cfg)
    if args.adapter_slots and not bank:
        raise SystemExit("--adapter-slots needs at least one --adapter "
                         "NAME=PATH (the bank's shapes come from the "
                         "first adapter)")
    engine_kw = dict(
        max_slots=args.max_slots, max_len=args.max_len,
        steps_per_tick=args.steps_per_tick,
        admit_min_free=args.admit_min_free,
        quantize_cache=args.quantize_cache, seed=args.seed,
        lora_bank=bank or None, chunk_prefill=args.chunk_prefill,
        adapter_capacity=args.adapter_slots,
        # serve's parser has no --draft-layers / --n-draft (as in JAX,
        # which reads them with getattr): no speculation unless given
        draft_layers=getattr(args, "draft_layers", 0) or None,
        spec_k=getattr(args, "n_draft", 4),
        spec_adaptive=not args.no_spec_adaptive, mesh=mesh)
    if mesh is not None and mesh.model > 1 and not _is_rank0():
        from ..serve.engine import ServingEngine
        engine = ServingEngine(params["llm"], cfg.llm, **engine_kw)
        if args.cache_system_prefix and not args.chat_template:
            # rank 0 pins the same header before its first message
            engine.register_prefix("sys", token_ids=np.asarray(
                system_prefix_ids(tok), np.int64))
        serve_follower(engine, mesh)
        return
    srv = OpusServer(
        params, cfg, tok, chat_template=args.chat_template,
        default_max_new=args.max_new_tokens or 256,
        model_id=args.served_model_name or "opus-pllm-tpu",
        cache_system_prefix=args.cache_system_prefix,
        max_queue=args.max_queue, **engine_kw)
    t0 = time.time()
    srv.warmup()
    print(f"warmup done in {time.time() - t0:.1f}s")
    srv.serve_forever(args.host, args.port, drain_grace=args.drain_grace)


def _no_effect(p: argparse.ArgumentParser) -> None:
    """--mesh / --distributed of a command that runs on one device: taken,
    as the JAX CLI takes them through `_model_args`, and without effect."""
    for action in p._actions:
        if action.dest in ("mesh", "distributed"):
            action.help = ("taken for the JAX CLI's surface; changes "
                           "nothing here (this command runs on one "
                           "device)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="opus-pllm-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("annotate", help="batch annotation eval on a test set")
    _model_args(a); _gen_args(a)
    a.add_argument("--test-json", required=True)
    a.add_argument("--save-path", default=None)
    a.add_argument("--biobert", default=None,
                   help="local BioBERT dir for BERTScore (function sets)")
    a.add_argument("--engine", action="store_true",
                   help="continuous-batching engine instead of static "
                        "batches: per-sequence finish + mid-stream "
                        "admission (T=0 token-identical; T>0 samples "
                        "with per-request temperature + top-p)")
    a.add_argument("--max-slots", type=int, default=16,
                   help="engine slots (--engine only)")
    a.add_argument("--steps-per-tick", type=int, default=4,
                   help="decode steps per engine tick (--engine only)")
    a.add_argument("--cache-prefix", action="store_true",
                   help="prefill the eval run's common prompt header ONCE "
                        "and admit each request with only its suffix "
                        "(--engine, base weights only)")
    a.add_argument("--adapter", action="append", metavar="NAME=PATH",
                   help="named UNMERGED LoRA adapter for the engine bank "
                        "(repeatable, --engine only); auto-matched to the "
                        "test set by basename, or forced via --use-adapter")
    a.add_argument("--use-adapter", default=None, metavar="NAME",
                   help="run the whole set under this bank adapter")
    a.set_defaults(fn=cmd_annotate)

    aa = sub.add_parser("annotate-all",
                        help="loop test sets x repeats (ablation protocol)")
    _model_args(aa); _gen_args(aa)
    aa.add_argument("--test-jsons", nargs="+", required=True)
    aa.add_argument("--repeats", type=int, default=5)
    aa.add_argument("--save-dir", default=None)
    aa.add_argument("--engine", action="store_true",
                    help="continuous-batching engine instead of static "
                         "batches (see annotate --engine)")
    aa.add_argument("--max-slots", type=int, default=16,
                    help="engine slots (--engine only)")
    aa.add_argument("--steps-per-tick", type=int, default=4,
                    help="decode steps per engine tick (--engine only)")
    aa.add_argument("--cache-prefix", action="store_true",
                    help="see annotate --cache-prefix")
    aa.add_argument("--adapter", action="append", metavar="NAME=PATH",
                    help="named UNMERGED LoRA adapter (repeatable, --engine "
                         "only): each test set runs under the adapter whose "
                         "NAME appears in its basename; the mapping prints "
                         "and is checked before the model loads")
    aa.add_argument("--map", action="append", metavar="BASENAME=NAME",
                    help="override the substring match for one test set; "
                         "BASENAME= (empty NAME) forces base weights")
    aa.set_defaults(fn=cmd_annotate_all)

    m = sub.add_parser("mcq", help="multiple-choice eval")
    _model_args(m); _gen_args(m)
    m.add_argument("--test-json", required=True)
    m.add_argument("--save-path", default=None)
    m.add_argument("--engine", action="store_true",
                   help="continuous-batching engine instead of static "
                        "batches (see annotate --engine)")
    m.add_argument("--max-slots", type=int, default=16,
                   help="engine slots (--engine only)")
    m.add_argument("--steps-per-tick", type=int, default=4,
                   help="decode steps per engine tick (--engine only)")
    m.add_argument("--cache-prefix", action="store_true",
                   help="see annotate --cache-prefix")
    m.add_argument("--scored", action="store_true",
                   help="score option letters with ONE prefill forward "
                        "(argmax of P(first token = letter)) instead of "
                        "free-text decode + regex extraction")
    m.add_argument("--adapter", action="append", metavar="NAME=PATH",
                   help="named UNMERGED LoRA adapter for the engine bank "
                        "(repeatable, --engine only)")
    m.add_argument("--use-adapter", default=None, metavar="NAME",
                   help="run the whole set under this bank adapter")
    m.set_defaults(fn=cmd_mcq)

    c = sub.add_parser("chat", help="interactive annotation REPL")
    _model_args(c); _gen_args(c)
    c.add_argument("--chat-template", action="store_true",
                   help="chat-template prompting (Evol models)")
    c.set_defaults(fn=cmd_chat)

    sv = sub.add_parser("serve", help="HTTP serving daemon (continuous "
                        "batching)")
    _model_args(sv)
    sv.add_argument("--host", default="0.0.0.0")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--max-slots", type=int, default=16,
                    help="concurrent sequences (the decode batch)")
    sv.add_argument("--max-len", type=int, default=1024,
                    help="per-slot KV capacity (prompt + generation)")
    sv.add_argument("--steps-per-tick", type=int, default=8,
                    help="decode steps per engine tick")
    sv.add_argument("--max-queue", type=int, default=None,
                    help="admission backpressure: reject new requests "
                         "with 429 once this many wait for slots "
                         "(default: unbounded)")
    sv.add_argument("--cache-system-prefix", action="store_true",
                    help="pin the constant professor-header KV once; "
                         "matching requests admit with only their suffix")
    sv.add_argument("--adapter-slots", type=int, default=None,
                    help="adapter-bank capacity: spare rows beyond the "
                         "--adapter entries that POST /v1/adapters can "
                         "fill at runtime")
    sv.add_argument("--drain-grace", type=float, default=30.0,
                    help="graceful-shutdown window: on SIGTERM, reject "
                         "new requests (503) and give in-flight ones "
                         "this many seconds before cancelling")
    sv.add_argument("--admit-min-free", type=int, default=1,
                    help="batch admissions until this many slots are free")
    sv.add_argument("--max-new-tokens", type=int, default=None,
                    help="default per-request budget (requests can "
                         "override)")
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--adapter", action="append", metavar="NAME=PATH",
                    help="serve a named UNMERGED LoRA adapter from the "
                         "bank (repeatable; PEFT dir or weights dir with "
                         'lora_adapter/); requests select one with '
                         '{"adapter": NAME}')
    sv.add_argument("--no-spec-adaptive", action="store_true",
                    help="with --draft-layers: always speculate instead "
                         "of falling back to plain decode ticks when the "
                         "measured acceptance stops covering the draft "
                         "cost (the adaptive default)")
    sv.add_argument("--chunk-prefill", type=int, default=None,
                    metavar="C",
                    help="admit prompts longer than the largest prefill "
                         "bucket in C-token chunks, one per tick")
    sv.add_argument("--served-model-name", default=None,
                    help="the `model` name the OpenAI-compatible endpoints "
                         "serve the base weights under; bank adapters "
                         "route by their --adapter names")
    sv.add_argument("--chat-template", action="store_true",
                    help="chat-template prompting (Evol models)")
    sv.set_defaults(fn=cmd_serve)

    tc = sub.add_parser("train-cstp", help="stage (a): contrastive adapter")
    tc.add_argument("--vec-pickle", required=True)
    tc.add_argument("--out", required=True)
    tc.add_argument("--lr", type=float, default=0.05)
    tc.add_argument("--wd", type=float, default=1e-4)
    tc.add_argument("--batch-size", type=int, default=128)
    tc.add_argument("--epochs", type=int, default=1)
    tc.add_argument("--seed", type=int, default=0)
    tc.add_argument("--mesh", default=None, metavar="DATA[,MODEL]",
                    help="data-parallel mesh of torchrun ranks for stage "
                         "(a): the batch splits over the data rows, the "
                         "similarity spans the global batch")
    tc.add_argument("--max-steps", type=int, default=0,
                    help="stop after N optimizer steps (0 = all)")
    tc.add_argument("--save-every", type=int, default=0,
                    help="checkpoint the full train state every N steps "
                         "into OUT/resume_state")
    tc.add_argument("--resume", action="store_true",
                    help="resume from the latest OUT/resume_state")
    tc.add_argument("--distributed", action="store_true",
                    help="start the process group from torchrun's "
                         "environment; without --mesh every rank is on "
                         "the data axis")
    _device_arg(tc)
    tc.set_defaults(fn=cmd_train_cstp)

    for name, is_lora in (("train-projector", False), ("train-lora", True)):
        t = sub.add_parser(name)
        _model_args(t)
        t.add_argument("--train-json", required=True)
        t.add_argument("--val-json", default=None,
                       help="held-out instruction JSON: token-weighted "
                            "val loss every --val-every steps + at the end")
        t.add_argument("--val-every", type=int, default=0,
                       help="validation interval in steps (0: only at "
                            "the end, when --val-json is set)")
        t.add_argument("--out", required=True)
        t.add_argument("--lr", type=float, default=2e-5 if is_lora else 1e-3)
        t.add_argument("--wd", type=float, default=0.0)
        t.add_argument("--batch-size", type=int, default=16)
        t.add_argument("--epochs", type=int, default=1)
        t.add_argument("--seed", type=int, default=0)
        t.add_argument("--max-len", type=int, default=512)
        t.add_argument("--lora-rank", type=int, default=16)
        t.add_argument("--train-switch", action="store_true")
        t.add_argument("--grad-accum", type=int, default=1,
                       help="gradient accumulation: micro-chunks per "
                            "optimizer step (the update equals the "
                            "big-batch step)")
        t.add_argument("--ce-chunk", type=int, default=0,
                       help="sequence-chunked cross-entropy: bounds live "
                            "fp32 logits to (B, chunk, V)")
        t.add_argument("--scan-mode", choices=("xs", "index"), default="xs",
                       help="the JAX package's stacked layer-loop layout; "
                            "changes nothing here (the port runs a loop "
                            "over its layer list)")
        t.add_argument("--remat", choices=("full", "none", "dots"),
                       default="full",
                       help="per-layer activation rematerialization: "
                            "'full' (default), 'none', or 'dots' (the "
                            "matmul outputs kept)")
        t.add_argument("--max-steps", type=int, default=0,
                       help="stop after N optimizer steps (0 = all)")
        t.add_argument("--save-every", type=int, default=0,
                       help="checkpoint the full train state (trainable + "
                            "optimizer + step) every N steps into "
                            "OUT/resume_state")
        t.add_argument("--resume", action="store_true",
                       help="resume from the latest OUT/resume_state "
                            "checkpoint (skips the consumed batches of "
                            "the seeded data stream)")
        t.add_argument("--seq-shards", type=int, default=0,
                       help=f"sequence-parallel training: not ported "
                            f"({ITEM_10})")
        t.add_argument("--pipe-stages", type=int, default=0,
                       help=f"pipeline-parallel training: not ported "
                            f"({ITEM_10})")
        t.add_argument("--micro-batches", type=int, default=0,
                       help=f"microbatches per pipeline step: not ported "
                            f"({ITEM_10})")
        t.add_argument("--pipe-data", type=int, default=1,
                       help=f"pipeline replicas: values > 1 are not ported "
                            f"({ITEM_10})")
        t.add_argument("--export-reference-format", action="store_true",
                       help="also write the reference checkpoint layout "
                            "(modality_refinement_projector/, lora_adapter/)")
        t.set_defaults(fn=lambda a, _l=is_lora: _train_multimodal(a, lora=_l))

    pc = sub.add_parser("precompute-embeddings")
    pc.add_argument("--json", required=True)
    pc.add_argument("--out", required=True)
    pc.add_argument("--mode", choices=("jsonl", "map"), default="jsonl")
    pc.add_argument("--esm", default=None)
    pc.add_argument("--batch-size", type=int, default=16)
    _device_arg(pc)
    pc.set_defaults(fn=cmd_precompute)

    pp = sub.add_parser("precompute-pairs",
                        help="UniProtQA pickle -> CSTP training pairs")
    _model_args(pp)
    pp.add_argument("--uniprot-pickle", required=True)
    pp.add_argument("--out", required=True)
    pp.add_argument("--batch-size", type=int, default=8)
    _no_effect(pp)
    pp.set_defaults(fn=cmd_precompute_pairs)

    cv = sub.add_parser("convert-weights")
    _model_args(cv)
    cv.add_argument("--out", required=True)
    cv.add_argument("--int4-layout", choices=("auto", "v1", "v2"),
                    default="auto",
                    help="with --load-int4: on-disk pack layout, v1 nibble "
                         "bytes (the train-lora path) or v2/auto "
                         "magic-bitcast words (decode and serving; train-* "
                         "commands reject it). Recorded in "
                         "<out>/quant_layout.json")
    _no_effect(cv)
    cv.set_defaults(fn=cmd_convert)

    b = sub.add_parser("bench")
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
