"""Build and load the port's CUDA kernels (route (b): nvcc + ctypes).

Every `*.cu` file in `opus_pllm_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into one shared library with a plain C interface, which `ctypes`
loads. The library lives in `build/cuda/` at the root of the checkout
(listed in `.gitignore`), under a name that carries a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. Nothing is built when this module is imported: the first call
of `library()` builds, later calls return the loaded library.
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
# C signatures of csrc/fused_encoder.cu (all return a cudaError_t as int)
SIGNATURES = {
    "opus_ln_qkv_rope": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "opus_encoder_attention": [_P, _P, _P, _I, _I, _I, _P],
    "opus_out_proj": [_P, _P, _P, _P, _P, _I, _I, _P],
    "opus_ffn": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
}

_lib = None
build_seconds = None     # wall time of the build this process ran, if any
build_log = ""           # nvcc's output (register / shared-memory report)


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
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raise on failure."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libopus_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{build_log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.opus_error_string.argtypes = [ctypes.c_int]
    lib.opus_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = _lib.opus_error_string(rc).decode() if _lib else ""
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc} ({msg})")
