"""Where the second train-lora step of a 2 x 2 mesh parts from one
process's, on one card with a GPU (the diagnostic behind PERF.md's "step
2's gap").

    python3 chip_step2_rounding.py

Phase 17's bf16 train-lora run of chip_smoke.py (4 ranks over gloo on
this card, Llama-3-8B widths at 8 layers, --ce-chunk 64, 2 steps, a
checkpoint a step) twice: with the decoder's row-parallel product as it
is, and with the earlier chain (the LoRA delta added to the fp32 partial
sums before the all-reduce and the one rounding). Then, on one process:
the same command; the command resumed for step 2 from each mesh's
checkpoint of step 1 and from its own; and the same three with the LLM
in fp32 (the bf16 draws cast up, the splice and the layers in fp32).
Prints each step-2 loss, the step-2 gradients against the resumed bf16
and fp32 processes (of each leaf's largest), and how far the parameters
part after each step. It checks nothing and prints no result line.
"""

import dataclasses
import datetime
import os
import shutil
import sys
import tempfile
import time

here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, here)
import chip_smoke as cs  # noqa: E402

LAYERS = cs.PT_LAYERS_SHARED


def earlier_row_parallel(p, la, x, ls, impl, tp):
    """models.decoder._row_parallel with the LoRA delta summed into the
    fp32 partial products before the all-reduce and one rounding."""
    import torch
    from opus_pllm_tpu_torch.core import mesh as mesh_mod
    from opus_pllm_tpu_torch.models.decoder import dense, lora_delta
    y = dense({k: v for k, v in p.items() if k != "bias"}, x,
              impl=impl).float()
    if la is not None:
        y = y + lora_delta(la, x, ls)
    if torch.is_grad_enabled():
        y = mesh_mod.reduce_from_model(y, tp.group)
    else:
        tp.all_reduce(y)
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rank_main(rank, tmp, chain):
    try:
        sys.path.insert(0, here)
        import torch
        import torch.distributed as dist
        from opus_pllm_tpu_torch.cli import main as cli
        from opus_pllm_tpu_torch.core import mesh as mesh_mod
        from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
        from opus_pllm_tpu_torch.models import decoder
        torch.backends.cuda.matmul.allow_tf32 = False
        if chain == "earlier":
            decoder._row_parallel = earlier_row_parallel
        mesh_mod.initialize_distributed(
            "file://" + os.path.join(tmp, "rendezvous"), cs.PT_RANKS, rank,
            device_type="cuda", timeout=datetime.timedelta(seconds=600))
        cli.load_tokenizer = lambda path, family: ByteTokenizer()
        cs.pt_one_run(rank, tmp, 0, LAYERS)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        import traceback
        print(f"rank {rank}:\n{traceback.format_exc()}", flush=True)
        os._exit(1)


def mesh_run(tmp, chain):
    import torch
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, tmp, chain))
             for r in range(cs.PT_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    codes = [p.exitcode for p in procs]
    if codes != [0] * cs.PT_RANKS:
        cs.fail(f"rank exit codes {codes}")
    return torch.load(os.path.join(tmp, "pt0_rank0.pt"), weights_only=False)


def resumed(tmp, src_out, work, tag, fp32=False):
    """The command on one process resumed for step 2 from `src_out`'s
    checkpoint of step 1 -> its record."""
    import torch
    from opus_pllm_tpu_torch.core import builder
    from opus_pllm_tpu_torch.models import decoder
    d = os.path.join(work, tag)
    shutil.copytree(os.path.join(src_out, "resume_state", "1"),
                    os.path.join(d, "resume_state", "1"))
    orig_cfg, orig_init = builder.decoder_config_for, decoder.init

    def up(t):
        if isinstance(t, dict):
            return {k: up(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(up(v) for v in t)
        return t.float() if t.is_floating_point() else t
    if fp32:
        builder.decoder_config_for = lambda path: dataclasses.replace(
            orig_cfg(path), num_layers=LAYERS, dtype="float32")
        decoder.init = lambda cfg, *a, **k: up(orig_init(
            dataclasses.replace(cfg, dtype="bfloat16"), *a, **k))
    else:
        cs.pt_depth(LAYERS)
    seen, restore = cs.pt_record_training()
    try:
        cs.run_cli(cs.pt_argv(tmp, 0, d, mesh=False) + ["--resume"])
    finally:
        restore()
        builder.decoder_config_for, decoder.init = orig_cfg, orig_init
        cs.pt_depth(None)
    torch.cuda.empty_cache()
    return seen


def rel_worst(got, want):
    return max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
               for a, b in zip(got, want))


def main():
    import torch
    from opus_pllm_tpu_torch.cli import main as cli
    from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.kernels import build
    from opus_pllm_tpu_torch.train.multimodal_trainer import leaves
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a GPU")
    os.environ["HF_HUB_OFFLINE"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    build.build_all()
    cli.load_tokenizer = lambda path, family: ByteTokenizer()
    work = tempfile.mkdtemp(prefix="step2-rounding-")
    try:
        mesh = {}
        for chain in ("now", "earlier"):
            tmp = os.path.join(work, chain)
            os.makedirs(tmp)
            cs.pt_files(tmp)
            t0 = time.time()
            mesh[chain] = mesh_run(tmp, chain)
            print(f"mesh 2,2, the {chain} row-parallel chain: losses "
                  f"{[m['loss'] for m in mesh[chain]['metrics']]} "
                  f"({time.time() - t0:.1f} s) [{card}]", flush=True)
        tmp = os.path.join(work, "now")
        seen = cs.pt_reference(tmp, 0, LAYERS)[0]
        print(f"one process: losses {[m['loss'] for m in seen['metrics']]}",
              flush=True)
        src = {"now": os.path.join(tmp, "out0"),
               "earlier": os.path.join(work, "earlier", "out0"),
               "one": os.path.join(tmp, "one0")}
        res = {}
        for fp32 in (False, True):
            for name, out in src.items():
                tag = ("fp32 " if fp32 else "bf16 ") + name
                res[tag] = resumed(tmp, out, work, tag.replace(" ", "_"),
                                   fp32)
                print(f"one process, {tag.split()[0]}, resumed from the "
                      f"{name} run's step 1: step-2 loss "
                      f"{res[tag]['metrics'][0]['loss']}", flush=True)
        for chain in ("now", "earlier"):
            g = mesh[chain]["grads"][1]
            b16 = res["bf16 " + chain]["grads"][0]
            f32 = res["fp32 " + chain]["grads"][0]
            print(f"the {chain} chain's step-2 gradients, of each leaf's "
                  f"largest: {rel_worst(g, b16):.3e} from the resumed bf16 "
                  f"process's, {rel_worst(g, f32):.3e} from the fp32 one's "
                  f"(the bf16 one's {rel_worst(b16, f32):.3e})", flush=True)
        for step, other in ((1, src["one"]),
                            (2, os.path.join(work, "bf16_now"))):
            a = leaves(CheckpointManager(os.path.join(
                src["now"], "resume_state")).restore(step=step)["trainable"])
            b = leaves(CheckpointManager(os.path.join(
                other, "resume_state")).restore(step=step)["trainable"])
            d = torch.cat([(x.float() - y.float()).abs().flatten()
                           for x, y in zip(a, b)])
            lr = cs.PT_LORA_LR
            whom = ("one process" if step == 1 else
                    "one process resumed from its step 1")
            print(f"parameters after step {step}, the mesh against {whom}"
                  f": largest {d.max().item():.3e}, beyond lr / 10 "
                  f"{(d > lr / 10).float().mean().item():.3e} of "
                  f"{d.numel()} entries", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
