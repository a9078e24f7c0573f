"""The fused outer-step compressor (port of ``repro.kernels.fused_compress``).

Per parameter matrix the compressor runs EF add -> PowerSGD project ->
Cholesky-QR -> back-project -> int4 quantize -> pack -> reconstruct -> EF
residual. Three kernels and one small host-level step carry it, as in the
JAX package:

  1. ``project``        P = (delta + e) @ (Q_warm * mask)      (kernel 3)
  2. host: ``_orthonormalize`` (r x r Cholesky-QR) and the rank mask
  3. ``project_t_pack`` Q = (delta + e)^T @ P, plus the int4 codes and
                        scales of the flat Q in the same kernel (kernel 4);
                        P is packed by ``quant4.quant4_pack`` (kernel 1)
  4. ``reconstruct``    delta_hat = deq(P) @ deq(Q)^T from the packed
                        payload, and with EF e' = (delta + e) - delta_hat
                        (kernel 5; ``fused_decompress`` is its EF-less dual)

Each of ``project``, ``project_t_pack`` and ``reconstruct`` launches its
hand-written CUDA kernels (``csrc/fused_compress.cu``, replacing
``_proj_kernel``, ``_proj_t_pack_kernel`` and ``_recon_kernel``) for CUDA
tensors and runs its plain PyTorch version for CPU tensors; no other
switch, no fallback. ``cuda_project.launches`` etc. count wrapper calls.
The two projections split K over the card (``_plan.split_k``): a call runs
the GEMM and, where S > 1 or a pack follows, a second pass that adds the
split partials in split order, so it counts once but may launch two
kernels. ``reconstruct`` decodes both factors once into f32 scratch
(quant4 unpack's arithmetic), then runs the K-resident GEMM of
``csrc/rank_gemm.cuh`` with the EF epilogue: one count, three kernels.
The GEMMs are shared with ``lowrank_mm`` (``csrc/proj_gemm.cuh``,
``csrc/rank_gemm.cuh``, the plan in ``_plan.py``).

The kernels mask their ragged edges themselves, so the JAX driver's grid
padding (``_pad2d``, ``_pad_packed``) has no counterpart here. The kernels
keep the EF add on the operand tile (``e`` given: ``with_e``), but the
driver hoists it, as the JAX driver does: delta + e is materialized once
and every kernel reads one operand. With the split-K projections the
fused form is the faster one on an H100 at the (24576, 8192) leaf,
kernels 3-5 with e' 4.04-4.15 ms against 4.34-4.37 (PERF.md); switching
``fused_compress_ef`` to it is open work (ROADMAP B).

Adaptive rank: factors keep the warm start's width r_max; columns >= r_t
are exactly zero in P, Q, the codes and q_new. Wire bytes are
bit-identical to ``ref.quant4_pack_ref`` on the row-major flat factors.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.device import on_device
from repro_torch.kernels import _plan, ref
from repro_torch.kernels.ref import FusedPayload, col_mask as _col_mask

from repro_torch.kernels._plan import BM, R_MAX

TILE = 64          # the row unit of t_pack's pack
SMEM_FLOATS = 227 * 1024 // 4    # t_pack's (tile_rows, r) shared tile
_INT_MAX = 2 ** 31 - 1


def _row_tile(r: int, block: int) -> int:
    """Rows of Q per block of t_pack's pack: a multiple of 64 rows whose
    ``rows * r`` is a whole number of quantization blocks, so no block
    straddles two CUDA blocks (the JAX ``_row_tile`` rule, here with a
    64-row unit instead of a VMEM cap)."""
    unit = block // math.gcd(r, block)
    return TILE * unit // math.gcd(TILE, unit)


def _proj_plan(m: int, n: int) -> Tuple[int, int, int]:
    """(tiles, S, chunk) of ``cuda_project``: rows m, K = n."""
    return _plan.row_plan(m, n)


def _proj_t_plan(m: int, n: int) -> Tuple[int, int, int]:
    """(tiles, S, chunk) of ``cuda_project_t_pack``: rows n, K = m."""
    return _plan.row_plan(n, m)


def _workspace(S, rows, r, device):
    """The S partials of a split GEMM, each ceil4(rows * r) floats."""
    return torch.empty(_plan.workspace_floats(S, rows * r),
                       dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _operand(d, e):
    return d if e is None else d + e


def project_plain(d, e, qm):
    return _operand(d, e) @ qm


def project_t_pack_plain(d, e, p, block: int = 256):
    q = _operand(d, e).T @ p
    packed, scales, _ = ref.quant4_pack_ref(q.reshape(-1), block)
    return q, packed, scales


def reconstruct_plain(pp, sp, pq, sq, d, e, m: int, n: int, r: int,
                      block: int = 256, with_ef: bool = True):
    P = ref.quant4_unpack_ref(pp, sp, m * r, block).reshape(m, r)
    Q = ref.quant4_unpack_ref(pq, sq, n * r, block).reshape(n, r)
    hat = P @ Q.T
    return hat, (_operand(d, e) - hat if with_ef else None)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/fused_compress.cu)
# ---------------------------------------------------------------------------

def _check_f32(name, t, shape, device):
    if t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape) or t.device != device:
        raise TypeError(f"{name} must be a contiguous float32 {tuple(shape)} "
                        f"tensor on {device}, got {t.dtype} "
                        f"{tuple(t.shape)} on {t.device}")


def _check_operands(d, e, r):
    m, n = d.shape
    _check_f32("delta", d, (m, n), d.device)
    if e is not None:
        _check_f32("error", e, (m, n), d.device)
    if not 1 <= r <= R_MAX:
        raise ValueError(f"rank {r} outside the kernels' envelope "
                         f"1..{R_MAX}")
    if -(-m // BM) > 65535 or n >= 2 ** 31:    # kernel 5's grid.y: 128 rows
        raise ValueError(f"matrix {m} x {n} outside the kernels' envelope")
    return m, n


def _lib_call(fn_name, *args):
    from repro_torch.kernels import _build

    lib = _build.load("fused_compress")
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def cuda_project(d, e, qm):
    """P = (d + e) @ qm: the split-K GEMM, then (S > 1) the split sum.
    ``launches`` counts calls, one per call whatever S is."""
    m, n = _check_operands(d, e, qm.shape[1])
    r = qm.shape[1]
    _check_f32("qm", qm, (n, r), d.device)
    _, S, chunk = _proj_plan(m, n)
    p = torch.empty((m, r), dtype=torch.float32, device=d.device)
    ws = _workspace(S, m, r, d.device) if S > 1 else None
    _lib_call("fused_project_f32", d.data_ptr(), _ptr(e), qm.data_ptr(),
              p.data_ptr(), _ptr(ws), m, n, r, S, chunk, _stream(d))
    cuda_project.launches += 1
    return p


cuda_project.launches = 0


def cuda_project_t_pack(d, e, p, block: int = 256):
    """(Q = (d + e)^T @ p, int4 codes, scales): the split-K GEMM, then the
    pass that adds the partials in split order and packs Q. ``launches``
    counts calls (two kernels each)."""
    m, n = _check_operands(d, e, p.shape[1])
    r = p.shape[1]
    _check_f32("p", p, (m, r), d.device)
    if block <= 0 or block % 2:
        raise ValueError(f"block must be even and positive, got {block}")
    tile_rows = _row_tile(r, block)
    if tile_rows * r > SMEM_FLOATS:
        raise ValueError(f"r={r}, block={block}: a {tile_rows}-row tile "
                         f"does not fit in shared memory")
    _, S, chunk = _proj_t_plan(m, n)
    nblk = -(-n * r // block)
    q = torch.empty((n, r), dtype=torch.float32, device=d.device)
    ws = _workspace(S, n, r, d.device) if S > 1 else q
    packed = torch.empty(nblk * (block // 2), dtype=torch.uint8,
                         device=d.device)
    scales = torch.empty(nblk, dtype=torch.float32, device=d.device)
    _lib_call("fused_project_t_pack_f32", d.data_ptr(), _ptr(e), p.data_ptr(),
              q.data_ptr(), ws.data_ptr(), packed.data_ptr(),
              scales.data_ptr(), m, n, r, S, chunk, tile_rows, block,
              _stream(d))
    cuda_project_t_pack.launches += 1
    return q, packed, scales


cuda_project_t_pack.launches = 0


def cuda_reconstruct(pp, sp, pq, sq, d, e, m: int, n: int, r: int,
                     block: int = 256, with_ef: bool = True):
    dev = pp.device
    if not 1 <= r <= R_MAX:
        raise ValueError(f"rank {r} outside the kernels' envelope 1..{R_MAX}")
    for name, t, dt, size in (
            ("packed_p", pp, torch.uint8, -(-m * r // block) * (block // 2)),
            ("scales_p", sp, torch.float32, -(-m * r // block)),
            ("packed_q", pq, torch.uint8, -(-n * r // block) * (block // 2)),
            ("scales_q", sq, torch.float32, -(-n * r // block))):
        if t.dtype != dt or t.dim() != 1 or t.shape[0] < size \
                or not t.is_contiguous() or t.device != dev:
            raise TypeError(f"{name} must be a contiguous {dt} vector of at "
                            f"least {size} on {dev}")
    if with_ef:
        _check_f32("delta", d, (m, n), dev)
        if e is not None:
            _check_f32("error", e, (m, n), dev)
    if (m + n) * r > _INT_MAX:
        raise ValueError(f"factors ({m} + {n}) x {r} exceed the decode's "
                         f"int32 indexing")
    hat = torch.empty((m, n), dtype=torch.float32, device=dev)
    enew = torch.empty_like(hat) if with_ef else None
    # the decoded factors, P (m, r) and Q (n, r), as f32 scratch
    pf = torch.empty((m + n) * r, dtype=torch.float32, device=dev)
    _lib_call("fused_reconstruct_f32", pp.data_ptr(), sp.data_ptr(),
              pq.data_ptr(), sq.data_ptr(),
              _ptr(d) if with_ef else None, _ptr(e) if with_ef else None,
              hat.data_ptr(), _ptr(enew), pf.data_ptr(),
              pf[m * r:].data_ptr(), m, n, r, block, _stream(pp))
    cuda_reconstruct.launches += 1
    return hat, enew


cuda_reconstruct.launches = 0


# ---------------------------------------------------------------------------
# dispatch on the tensors' device
# ---------------------------------------------------------------------------

def project(d, e, qm):
    """P = (d + e) @ qm, f32 (m, r)."""
    return on_device(d, cuda_project, project_plain, d, e, qm)


def project_t_pack(d, e, p, block: int = 256):
    """(Q = (d + e)^T @ p, packed int4 codes of flat Q, their scales)."""
    return on_device(d, cuda_project_t_pack, project_t_pack_plain, d, e, p,
                     block)


def reconstruct(pp, sp, pq, sq, d, e, m: int, n: int, r: int,
                block: int = 256, with_ef: bool = True):
    """(delta_hat (m, n) f32, e_new or None) from the packed payload."""
    return on_device(pp, cuda_reconstruct, reconstruct_plain, pp, sp, pq, sq,
                     d, e, m, n, r, block, with_ef)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def fused_compress_ef(delta: torch.Tensor, error: Optional[torch.Tensor],
                      q_prev: torch.Tensor, rank_scalar=None, *,
                      block: int = 256, compute_error: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                 torch.Tensor, FusedPayload]:
    """The fused outer-step compressor for one (m, n) parameter matrix.

    ``delta``: pseudo-gradient; ``error``: EF residual (f32) or None;
    ``q_prev``: (n, r_max) PowerSGD warm start; ``rank_scalar``: adaptive
    rank r_t (columns >= r_t masked). Returns ``(delta_hat, e_new, q_new,
    payload)`` with the semantics of ``ref.outer_step_ref`` (same wire
    bytes, reconstruction within a reordering ulp bound); ``e_new`` is
    None with ``compute_error=False`` (the compressor path, where the round
    owns error feedback)."""
    if block % 2:
        raise ValueError(f"block must be even, got {block}")
    m, n = delta.shape
    r = q_prev.shape[1]
    cm = _col_mask(r, rank_scalar, delta.device)
    qm = (q_prev.float() * cm).contiguous()
    # EF hoist: materialize the corrected delta once; every kernel then
    # runs without its e operand
    d = delta.float()
    if error is not None:
        d = d + error.float()
    d = d.contiguous()

    from repro_torch.core.compression import _orthonormalize
    from repro_torch.kernels.quant4 import quant4_pack

    P = project(d, None, qm)
    P = (_orthonormalize(P) * cm).contiguous()
    Q, packed_q, scales_q = project_t_pack(d, None, P, block)
    packed_p, scales_p = quant4_pack(P.reshape(-1), block)
    hat, e_new = reconstruct(packed_p, scales_p, packed_q, scales_q, d,
                             None, m, n, r, block, with_ef=compute_error)
    # warm start: keep the unquantized Q; the zero-input guard keeps q_prev
    # when the first delayed round compresses an all-zero delta
    q_new = torch.where((Q * Q).sum() > 0, Q, qm)
    payload = FusedPayload(packed_p, scales_p, packed_q, scales_q, P, Q)
    return hat.to(delta.dtype), e_new, q_new, payload


def fused_decompress(packed_p, scales_p, packed_q, scales_q, m: int, n: int,
                     r: int, *, block: int = 256,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Decompress dual: unpack -> dequant -> P Q^T, kernel 5 without EF."""
    hat, _ = reconstruct(packed_p, scales_p, packed_q, scales_q, None, None,
                         m, n, r, block, with_ef=False)
    return hat.to(out_dtype)
