"""Build and load the port's CUDA kernels (route (b): nvcc + ctypes).

Each `*.cu` file in `opus_pllm_tpu_torch/csrc/` is compiled by its own
`nvcc` (sm_90a) into a shared library with a plain C interface, which
`ctypes` loads. The libraries live in `build/cuda/` at the root of the
checkout (listed in `.gitignore`), each under a name that carries a hash of
its source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. Nothing is built when this module is imported:
`library(name)` builds that source at its first call; `build_all()` starts
one nvcc per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]   # -v: registers / spills into build_log

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures per source (every entry point returns a cudaError_t as int;
# the last argument is the stream)
SIGNATURES = {
    "fused_encoder": {
        "opus_ln_qkv_rope": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                             _I, _P],
        "opus_encoder_attention": [_P, _P, _P, _P, _I, _I, _I, _P],
        "opus_out_proj": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "opus_ffn": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                     _I, _P],
    },
    "int4_matmul": {
        "opus_int4_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    },
    "decode_attention": {
        "opus_decode_attention": [_P] * 7 + [_I] * 8 + [_F, _P],
        "opus_decode_attention_bf16": [_P] * 5 + [_I] * 7 + [_F, _P],
    },
    "int8_matmul": {
        "opus_int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
    "flash_attention": {
        "opus_flash_attention": [_P] * 7 + [_I] * 6 + [_L] * 12
                                + [_I, _F, _P],
    },
    "flash_attention_bwd": {
        "opus_flash_attention_bwd_dq": [_P] * 10 + [_I] * 6 + [_L] * 15
                                       + [_I, _F, _P],
        "opus_flash_attention_bwd_dkv": [_P] * 10 + [_I] * 6 + [_L] * 15
                                        + [_I, _F, _P],
    },
    "int4_matmul_v1": {
        "opus_int4_matmul_v1": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "moe_grouped_gemm": {
        "opus_moe_grouped_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _P],
    },
}

_libs = {}
build_seconds = {}   # nvcc wall time per source built by this process
build_log = ""       # nvcc's output (register / shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built on this machine")
    return path


def sources():
    return [CSRC / f"{name}.cu" for name in SIGNATURES]


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for inc in sorted(CSRC.glob("*.cuh")):
        h.update(inc.name.encode())
        h.update(inc.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile(names) -> None:
    """Start one nvcc per source that has no library yet; wait for all."""
    global build_log
    todo = [(n, out) for n in names if not (out := _target(n)).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, cmd, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, cmd, t0, proc in procs:
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_log += f"[{name}.cu]\n{log}"
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.opus_error_string.argtypes = [ctypes.c_int]
    lib.opus_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed; raises
    on failure."""
    if name not in _libs:
        if name not in SIGNATURES:
            raise KeyError(f"no CUDA source named {name!r}")
        _compile([name])
        _load(name)
    return _libs[name]


def build_all() -> None:
    """Build every source in parallel (one nvcc each) and load them."""
    _compile([n for n in SIGNATURES if n not in _libs])
    for name in SIGNATURES:
        library(name)


def check(rc: int, name: str, lib: ctypes.CDLL) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.opus_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc} ({msg})")
