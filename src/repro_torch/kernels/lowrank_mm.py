"""Tiled matrix product with f32 accumulation (port of
``repro.kernels.lowrank_mm``): the PowerSGD products of the mesh runtime's
outer step (``core/mesh_compression.py``).

``matmul(a, b)`` takes (m, k) @ (k, n) or a batch (B, m, k) @ (B, k, n),
f32 or bf16 operands, and returns ``promote_types(a, b)``. For CUDA
tensors it launches the hand-written kernel of ``csrc/lowrank_mm.cu``
(which replaces the TPU kernel ``_mm_kernel``); for CPU tensors it runs
the plain version, ``ref.matmul_ref`` matrix by matrix. There is no other
switch and no fallback: a failed build or launch raises.
``cuda_matmul.launches`` counts calls (each launches one route's kernels).

Operands may be any strided views, transposes included: the kernel reads
them through their strides and masks the ragged tiles, so neither a
transposed operand nor the Pallas wrapper's tile padding is ever copied.
The plain version loops over the batch, so each matrix's product is the
same whatever batch it is computed in (as each block of the kernel is).

On the card a call takes one of three routes (``_route``), each a
hand-written kernel of ``csrc/lowrank_mm.cu``:

  split    f32, n <= 64, B row-major, A with a unit stride (P = M Q and
           Q = M^T P): the split-K GEMM of ``csrc/proj_gemm.cuh`` with the
           plan ``_plan.split_k(ceil(m / 128), k)`` (``_split_plan``), a
           function of (m, k) alone, never of the batch or the strides;
  rank     f32, k <= 64 (P Q^T): the K-resident GEMM of
           ``csrc/rank_gemm.cuh``;
  general  anything else (bf16 operands, wide products): ``mm_kernel``.

``cuda_matmul.routes`` counts the calls of each route.
"""
from __future__ import annotations

import torch

from typing import Tuple

from repro_torch.device import on_device
from repro_torch.kernels import _plan, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
ROUTES = ("general", "split", "rank")      # csrc/lowrank_mm.cu's Route codes
RANK_K_MAX = 64                            # rank_gemm.cuh's KMAX


def _check(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """Shapes, dtypes and devices ``matmul`` takes; returns the output
    dtype."""
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"matmul takes two 2-d or two 3-d (batched) "
                         f"operands, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"do not agree")
    if a.dtype not in _DTYPE_CODE or b.dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul takes float32 or bfloat16 operands, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    return torch.promote_types(a.dtype, b.dtype)


def _route(a3: torch.Tensor, b3: torch.Tensor) -> str:
    """The route of a (batch, m, k) @ (batch, k, n) product on the card:
    from the dtypes, shapes and strides (see the module docstring)."""
    _, m, k = a3.shape
    n = b3.shape[2]
    if a3.dtype != torch.float32 or b3.dtype != torch.float32 or k == 0:
        return "general"
    if (n <= _plan.R_MAX and b3.stride(2) == 1 and b3.stride(1) == n
            and 1 in (a3.stride(1), a3.stride(2))):
        return "split"
    if k <= RANK_K_MAX:
        return "rank"
    return "general"


def _split_plan(m: int, k: int) -> Tuple[int, int]:
    """(S, chunk) of the split route: rows m, K = k; batch- and
    stride-free, so batches and views keep their bits."""
    return _plan.row_plan(m, k)[1:]


def cuda_matmul(a: torch.Tensor, b: torch.Tensor, *,
                _plan_override=None) -> torch.Tensor:
    """The CUDA kernel on two CUDA tensors (any strides); the output is a
    new contiguous tensor. ``_plan_override`` (S, chunk) replaces the split
    route's plan, for timing other plans only."""
    from repro_torch.kernels import _build

    out_dtype = _check(a, b)
    a3, b3 = (a, b) if a.dim() == 3 else (a.unsqueeze(0), b.unsqueeze(0))
    batch, m, k = a3.shape
    n = b3.shape[2]
    if max(batch, m, n, k) > _INT_MAX:
        raise ValueError(f"matmul dimensions {(batch, m, k, n)} exceed int32")
    out = torch.empty((batch, m, n), dtype=out_dtype, device=a.device)
    if out.numel():
        route = _route(a3, b3)
        S, chunk = 1, 0
        ws = None
        if route == "split":
            S, chunk = _plan_override or _split_plan(m, k)
            if S > 1:
                ws = torch.empty(_plan.workspace_floats(S, batch * m * n),
                                 dtype=torch.float32, device=a.device)
        lib = _build.load("lowrank_mm")
        err = lib.lowrank_mm(
            a3.data_ptr(), _DTYPE_CODE[a.dtype], b3.data_ptr(),
            _DTYPE_CODE[b.dtype], out.data_ptr(), batch, m, n, k,
            *a3.stride(), *b3.stride(), ROUTES.index(route), S, chunk,
            None if ws is None else ws.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"lowrank_mm kernel launch failed ({route} "
                               f"route): "
                               f"{_build.cuda_error_string(lib, err)}")
        cuda_matmul.launches += 1
        cuda_matmul.routes[route] += 1
    return out if a.dim() == 3 else out[0]


cuda_matmul.launches = 0
cuda_matmul.routes = dict.fromkeys(ROUTES, 0)


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: ``ref.matmul_ref`` on the operands cast
    to the output type, one matrix at a time."""
    out_dtype = _check(a, b)
    a, b = a.to(out_dtype), b.to(out_dtype)
    if a.dim() == 2:
        return ref.matmul_ref(a, b)
    out = torch.empty((a.shape[0], a.shape[1], b.shape[2]), dtype=out_dtype,
                      device=a.device)
    for i in range(a.shape[0]):
        out[i] = ref.matmul_ref(a[i], b[i])
    return out


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) or (B, m, k) @ (B, k, n) with f32 accumulation: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    return on_device(a, cuda_matmul, matmul_plain, a, b)
