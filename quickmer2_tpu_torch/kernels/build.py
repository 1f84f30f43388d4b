"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain
C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, the shared headers
(csrc/*.cuh) and the flags, so an edited source rebuilds and a stale
library is never loaded. Builds go
into quickmer2_tpu_torch/_build/kernels/ (listed in .gitignore) at
first use; `build_all` starts one nvcc per source, all at once. A
missing nvcc is an error: the card path has no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build", "kernels")
SOURCES = ("count_mono", "hamming_join", "anchored", "neighbor_bits",
           "neighbor_sum", "count_flat", "emit_member", "est_windows")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return path


def library_path(name: str) -> str:
    tag = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            tag.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{tag.hexdigest()[:12]}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every library in `names` that is not built yet, one nvcc
    process per source, all started together. Returns {name: {"s":
    seconds or 0.0 when already built, "log": nvcc's -Xptxas -v
    report}}; raises with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            out[name] = {"s": 0.0, "log": ""}
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so, time.time())
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"s": time.time() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, argtypes: dict | None = None) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use.
    `argtypes` ({entry point: ctypes argument types}) are set when the
    library is first loaded, not on every call."""
    if name not in _libs:
        build_all([name])
        lib = ctypes.CDLL(library_path(name))
        lib.qm2t_error_string.argtypes = [ctypes.c_int]
        lib.qm2t_error_string.restype = ctypes.c_char_p
        for fn, types in (argtypes or {}).items():
            getattr(lib, fn).argtypes = types
        _libs[name] = lib
    return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.qm2t_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def check_tensors(what: str, device: torch.device, specs) -> None:
    """Raise unless every (name, tensor, dtype, shape) in `specs` is a
    contiguous tensor of that dtype and shape on `device`."""
    for name, t, dtype, shape in specs:
        if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous() or t.device != device):
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} tensor of "
                f"shape {tuple(shape)} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
