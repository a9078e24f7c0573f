"""Builds the port's CUDA kernels from ``src/repro_torch/csrc/`` with ``nvcc``
and loads them with ``ctypes`` (plain C interface, no PyTorch headers).

Each ``csrc/<name>.cu`` compiles on first use, for ``sm_90a``, into
``build/kernels/<name>-<hash>.so`` at the repo root (the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header rebuilds). ``build_all`` starts
one ``nvcc`` per source at once. A missing ``nvcc`` or a failed build
raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ERR = {"repro_cuda_error_string": ([_I], ctypes.c_char_p)}
# exported C functions of each kernel library: name -> (argtypes, restype)
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "paged_attention": {
        "paged_attention_f32": ([_P] * 7 + [_I] * 7 + [ctypes.c_float]
                                + [_I] * 2 + [_P], _I),
        "paged_attention_bf16": ([_P] * 7 + [_I] * 7 + [ctypes.c_float]
                                 + [_I] * 2 + [_P], _I),
        **_ERR,
    },
    "quant4": {
        # (ptr, group stride, row stride) x 3 operands, B, R, n, block
        "quant4_pack_f32": (([_P] + [_L] * 2) * 3 + [_L] * 3 + [_I, _P], _I),
        "quant4_unpack_f32": (([_P] + [_L] * 2) * 3 + [_L] * 3 + [_I, _P],
                              _I),
        **_ERR,
    },
    "fused_compress": {
        "fused_project_f32": ([_P] * 5 + [_I] * 5 + [_P], _I),
        "fused_project_t_pack_f32": ([_P] * 7 + [_I] * 7 + [_P], _I),
        "fused_reconstruct_f32": ([_P] * 10 + [_I] * 4 + [_P], _I),
        **_ERR,
    },
    "flash_attention": {
        "flash_attention_fwd_f32": ([_P] * 5 + [_I] * 6 + [_L] * 9
                                    + [_I] * 3 + [_P, _P], _I),
        "flash_attention_bwd_f32": ([_P] * 10 + [_I] * 6 + [_L] * 9
                                    + [_I] * 5 + [_P, _P], _I),
        "flash_attention_fwd_bf16": ([_P] * 5 + [_I] * 6 + [_L] * 9
                                     + [_I] * 3 + [_P, _P], _I),
        "flash_attention_bwd_bf16": ([_P] * 10 + [_I] * 6 + [_L] * 9
                                     + [_I] * 5 + [_P, _P], _I),
        "flash_attention_occupancy": ([_I, _I, _P, _P, _P], _I),
        "flash_attention_occupancy_bf16": ([_I, _I, _P, _P, _P], _I),
        **_ERR,
    },
    "lowrank_mm": {
        "lowrank_mm": ([_P, _I, _P, _I, _P] + [_I] * 4 + [_L] * 6
                       + [_I] * 3 + [_P, _P], _I),
        **_ERR,
    },
}
KERNEL_LIBS = list(SIGNATURES)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
ptxas_report: Dict[str, str] = {}     # name -> nvcc's -Xptxas -v output


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compiles every listed kernel that is not built yet, one ``nvcc``
    process per source, all started together. Returns name -> .so path."""
    names = list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        ptxas_report[n] = (out + err).strip()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{err}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """Builds (if needed) and loads one kernel library, with every exported
    function's ``argtypes``/``restype`` declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
    return _loaded[name]


def cuda_error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{lib.repro_cuda_error_string(err).decode()} (cudaError {err})"
