"""One run of one cell of the port's benchmark, on the machine it starts on.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

Everything is found by name: the cell in `BENCHMARK.json` at the root of
the checkout names its configuration (`configs/<config>.json`) and its
traffic mix (`traffic/<traffic>.json`); the mix names its driver
(`drivers/<driver>.py`); the cell's limits are `limits/<cell>.json`; each
metric the cell reports is read by `metrics/<metric>.py`. Adding a cell,
a mix, a driver or a metric is adding files and entries.

The run builds the state on the card from the seed, warms the cell's
shapes (set-up), measures for `--seconds`, then checks the window's
outputs against the plain reference and prints one JSON line. `--trace 1`
profiles a steady sub-window and reports the per-layer metrics instead of
the end-to-end ones. `--control 1` puts the check's control (the
reference in the precision below the configuration's) in the program's
place: the numbers held to the limits are the control's, the program's
own are printed beside them as `program_<name>`, and such a run has to
come out not correct; the benchmark's own runs never pass it. Without a
CUDA card, or with fewer than the cell asks for, the run prints no result
and exits 3.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "opus_pllm_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (`opus_pllm_tpu_torch` is not `opus_pllm_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_file(path: Path):
    spec = importlib.util.spec_from_file_location(
        "port_bench._loaded." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_metrics(bench: dict, cell: str, trace: int):
    """The cell's metrics: its end-to-end ones, or with --trace 1 its
    per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def device_info(device, trace_rec):
    import torch
    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace_rec:
        info["busy_s"] = trace_rec["busy_s"]
        info["window_s"] = trace_rec["window_s"]
    return info


def read_trace(tracer, drv) -> dict:
    """Export the sub-window's trace under TMPDIR, reduce it, delete it."""
    from port_bench.yardstick.trace import analyze
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        tracer.prof.export_chrome_trace(path)
        rec = analyze(path)
    finally:
        os.unlink(path)
    if rec:
        rec["bounds"] = tracer.probe.bounds()
        rec["model_flops"] = drv.model_flops(tracer.batch, tracer.lengths)
    return rec


def main(argv=None, *, device=None, overrides=None, out=None) -> int:
    out = out or sys.stdout
    overrides = overrides or {}
    args = parse(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
                  f"found {torch.cuda.device_count()}: no result",
                  file=sys.stderr)
            return 3
        device = "cuda"
    device = torch.device(device)

    from port_bench.yardstick.spec import load_config
    from port_bench.yardstick.traffic import load_mix
    conf = overrides.get("config") or load_config(cell["config"])
    mix = overrides.get("traffic") or load_mix(cell["traffic"])
    with open(HERE / "limits" / f"{cell['name']}.json") as f:
        limits = json.load(f)
    driver = load_file(HERE / "drivers" / f"{mix['driver']}.py")
    drv = driver.Driver(conf, mix, args.seed, device,
                        control=bool(args.control))
    drv.setup()
    setup_s = time.perf_counter() - _T0
    tracer = drv.tracer() if args.trace else None
    rec = drv.window(args.seconds, tracer)
    rec["setup_s"] = setup_s
    rec["trace"] = read_trace(tracer, drv) if tracer is not None else {}
    info = device_info(device, rec["trace"])
    readings = drv.check()
    checks = {k: {"value": readings[k], "limit": lim}
              for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in cell_metrics(bench, cell["name"], args.trace):
        value = load_file(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": info}
    if rec["trace"]:
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
        result["kernels"] = {
            k: {"calls": n, "bound_s": b,
                "device_s": rec["trace"]["kernel_s"].get(k)}
            for k, (n, b) in rec["trace"]["bounds"].items()}
    if rec.get("batches"):
        ends = [0.0] + [b["end_s"] for b in rec["batches"]]
        result["batch_s"] = [b - a for a, b in zip(ends, ends[1:])]
    extra = {k: v for k, v in readings.items() if k not in limits}
    if extra:
        result["readings"] = extra
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
