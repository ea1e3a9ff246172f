"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

``nvcc`` compiles every source to an object file, all sources at once in
parallel, and links them into one shared library with a plain C interface,
which is loaded with ctypes. The library lands in a build
directory inside the checkout (``build/kernels``, listed in .gitignore),
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Nothing is built at import time:
this module only compiles when a kernel is first launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes (pointers and the stream as c_void_p, ints as c_int).
_SIGNATURES = {
    "ast_trunk_fwd": [_P] * 8 + [_I] * 5 + [_P],
    "ast_trunk_bwd": [_P] * 8 + [_I] * 5 + [_P],
    "ast_trunk_fwd_mma": [_P] * 8 + [_I] * 5 + [_P],
    "ast_trunk_bwd_mma": [_P] * 8 + [_I] * 5 + [_P],
    "ast_trunk_bwd_group": ([_P, ctypes.POINTER(_P), ctypes.POINTER(_P)] + [_P] * 4
                            + [ctypes.POINTER(_I)] * 2 + [_I] * 6 + [_P]),
    "ast_trunk_bwd_group_mma": ([_P, ctypes.POINTER(_P), ctypes.POINTER(_P)] + [_P] * 4
                                + [ctypes.POINTER(_I)] + [_I] * 6 + [_P]),
    "ast_encoder_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "ast_encoder_bwd": [_P] * 7 + [_I] * 5 + [_P],
    "ast_encoder_fwd_mma": [_P] * 6 + [_I] * 5 + [_P],
    "ast_encoder_bwd_mma": [_P] * 7 + [_I] * 5 + [_P],
    "ast_pair_gram": [ctypes.POINTER(_P)] + [_I] * 6 + [_P] * 3,
    "ast_pair_gram_bwd": [ctypes.POINTER(_P)] * 2 + [_I] * 6 + [_P] * 2,
    "ast_layer_gram": [ctypes.POINTER(_P)] + [_I] * 4 + [_P] * 3,
    "ast_layer_gram_bwd": [ctypes.POINTER(_P)] * 2 + [_I] * 4 + [_P] * 2,
    "ast_decoder_gate_fwd": [_P] * 5 + [_I] * 4 + [_P],
    "ast_decoder_gate_bwd": [_P] * 7 + [_I] * 4 + [_P],
    "ast_decoder_residual_fwd": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 3 + [_P],
    "ast_decoder_residual_bwd": [_P, _I, _P] + [_I] * 3 + [_P] * 2 + [_I, _P],
    "ast_taps_pack": [_P] * 2 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

# Kernel launches, one count per wrapper call that launched its kernel
# (K1 trunk forward layer, K2 trunk backward layer, K2wf grouped wavefront
# trunk backward, K5 gram forward, K6 gram backward, K7f / K7b per-layer
# encoder block forward / backward, K8f / K8b per-layer (Gatys) gram forward /
# backward; the decoder block's gate and residual epilogues, forward and
# backward, ops/decoder.py; the merged-taps pack of the bf16 convs,
# ops/conv.py).
LAUNCHES = {"K1": 0, "K2": 0, "K2wf": 0, "K5": 0, "K6": 0, "K7f": 0, "K7b": 0,
            "K8f": 0, "K8b": 0,
            "gate_fwd": 0, "gate_bwd": 0, "residual_fwd": 0, "residual_bwd": 0,
            "taps_pack": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"libast_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side, wait for all, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{log}")


def build() -> Path:
    """Compile the kernels unless the library for these sources exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)]
                  for src, obj in zip(_sources(), objs)])
        tmp = os.path.join(tmpdir, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.ast_error_string.argtypes = [_I]
            handle.ast_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(status: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if status != 0:
        msg = lib().ast_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``, which the
    wrappers size their grids by."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
