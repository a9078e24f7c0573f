"""Paged-gather decode attention (port of ``repro.serve.attention_paged``):
the plain PyTorch version and the hand-written CUDA kernels that replace
the TPU kernel ``_paged_kernel`` (``csrc/paged_attention.cu``: partials
over fixed chunks of each slot's pages, ``_plan.paged_plan``, then their
merge in chunk order).

Shapes (per segment unit):
  q            (S, 1, H, dh)      one query token per slot
  cache k/v    (1 + n_pages, page_size, KV, dh)   page 0 = scratch
  page_tables  (S, max_pages)     int32; 0 = unallocated -> scratch page
  lengths      (S,)               tokens already cached (== query position)
  active       (S,)               bool slot mask

Masking contract: the key position is computed from the *table column
index* (``page * page_size + slot``), never from page contents, and the
``k_pos <= q_pos`` mask (-1e30, whose exp underflows to exactly 0.0) kills
every position past ``lengths``, including whatever the scratch page holds.
Inactive slots read the all-zero table row, i.e. the scratch page, and
the scheduler discards their output.

``paged_attention`` runs the plain version for CPU tensors and the CUDA
kernel for CUDA tensors; there is no switch between them and no fallback.
The kernel takes float32 or bfloat16 (q and the pool of one type): bf16
reads bf16 and computes in f32 as the plain version does, and writes
bf16.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.device import on_device
from repro_torch.kernels import _plan
from repro_torch.models import attention as attn

NEG_INF = attn.NEG_INF

# the kernel's envelope (checked by the wrapper)
MAX_HEAD_DIM = 256
MAX_PAGE_SIZE = 64
MAX_SMEM_BYTES = 227 * 1024
MAX_GRID_DIM = 65535               # slots and KV heads: grid y and z


# ---------------------------------------------------------------------------
# scatter this step's K/V rows into their page slots (in place)
# ---------------------------------------------------------------------------

def write_kv(cache, k_new, v_new, page_tables, lengths, active):
    """cache {"k","v"}: (P, ps, KV, dh), updated in place; k_new/v_new:
    (S, KV, dh). Writes row i at (table[i, len_i // ps], len_i % ps).
    Inactive rows go to scratch page 0 (the scheduler gives them length 0,
    so slot 0): duplicate indices land in no fixed order, which is
    harmless only because the scratch page is never read unmasked."""
    ps = cache["k"].shape[1]
    lengths = lengths.long()
    log_page = lengths // ps
    slot = lengths % ps
    phys = torch.gather(page_tables.long(), 1, log_page[:, None])[:, 0]
    phys = torch.where(active, phys, torch.zeros_like(phys))
    cache["k"].index_put_((phys, slot), k_new.to(cache["k"].dtype))
    cache["v"].index_put_((phys, slot), v_new.to(cache["v"].dtype))
    return cache


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def ref_paged_attention(q, cache, page_tables, lengths, *, window: int = 0):
    """Gather pages -> contiguous per-sequence KV, then the same
    ``_mask_bias`` + ``grouped_attend`` as the dense decode path, so paged
    and dense decode are bitwise equal on matching shapes.
    Returns (S, 1, H, dh)."""
    S, P = page_tables.shape
    ps = cache["k"].shape[1]
    idx = page_tables.long()
    k = cache["k"][idx].reshape(S, P * ps, *cache["k"].shape[2:])
    v = cache["v"][idx].reshape(S, P * ps, *cache["v"].shape[2:])
    pos = lengths[:, None]
    k_pos = torch.arange(P * ps, dtype=torch.int32, device=q.device)[None, :]
    bias = attn._mask_bias(pos, k_pos, causal=True, window=window)
    return attn.grouped_attend(q, k, v, bias)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------

def smem_bytes(P: int, ps: int, G: int, dh: int, esize: int = 4) -> int:
    """Shared memory of one block of the partial kernel at this shape and
    element size."""
    return _plan.paged_smem_bytes(_plan.paged_plan(P, ps, dh, esize)[0], ps,
                                  G, dh, esize)


def _check_envelope(q, cache, page_tables, lengths, window):
    S, one, H, dh = q.shape
    k, v = cache["k"], cache["v"]
    if one != 1:
        raise ValueError(f"paged_attention decodes one token per slot, "
                         f"got q {tuple(q.shape)}")
    ps, KV = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernel's 16-byte copies)")
    if v.shape != k.shape or k.dim() != 4 or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    for name, t in (("page_tables", page_tables), ("lengths", lengths)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != q.device:
            raise TypeError(f"{name} must be a contiguous int32 tensor on "
                            f"{q.device}")
    if page_tables.dim() != 2 or page_tables.shape[0] != S \
            or tuple(lengths.shape) != (S,):
        raise ValueError(f"page_tables {tuple(page_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match S={S}")
    if H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    per16 = 16 // q.element_size()        # dh in whole 16-byte copies
    if dh > MAX_HEAD_DIM or dh % per16 or ps > MAX_PAGE_SIZE:
        raise ValueError(f"dh={dh} (a multiple of {per16}, max "
                         f"{MAX_HEAD_DIM}) or page size {ps} (max "
                         f"{MAX_PAGE_SIZE}) outside the kernel envelope")
    if not 0 < S <= MAX_GRID_DIM or KV > MAX_GRID_DIM:
        raise ValueError(f"S={S}, KV={KV} outside the kernel's grid")
    P = page_tables.shape[1]
    need = smem_bytes(P, ps, H // KV, dh, q.element_size())
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"G={H // KV}, ps={ps}, dh={dh} need {need} B of "
                         f"shared memory")
    if window < 0:
        raise ValueError(f"window={window}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def cuda_paged_attention(q, cache, page_tables, lengths, *, window: int = 0):
    """Launches the CUDA kernels on the current stream: the partials of
    every (chunk of pages, KV head, slot), then their merge in chunk order
    (``_plan.paged_plan``). Same contract as ``ref_paged_attention``
    (ulp-level differences: the chunks and the merge reassociate the
    sums). It reads no tensor on the host, so it never waits for the
    device. ``cuda_paged_attention.launches`` counts calls."""
    from repro_torch.kernels import _build

    _check_envelope(q, cache, page_tables, lengths, window)
    S, _, H, dh = q.shape
    P = page_tables.shape[1]
    ps, KV = cache["k"].shape[1], cache["k"].shape[2]
    G = H // KV
    pages, n_chunks = _plan.paged_plan(P, ps, dh, q.element_size())
    lib = _build.load("paged_attention")
    out = torch.empty_like(q)
    ws = torch.empty(S * KV * n_chunks * G * (dh + 2), dtype=torch.float32,
                     device=q.device)
    launch = (lib.paged_attention_f32 if q.dtype == torch.float32
              else lib.paged_attention_bf16)
    err = launch(
        q.data_ptr(), cache["k"].data_ptr(), cache["v"].data_ptr(),
        page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ws.data_ptr(), S, P, ps, KV, G, dh, int(window),
        ctypes.c_float(1.0 / math.sqrt(dh)), pages, n_chunks, _stream(q))
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    cuda_paged_attention.launches += 1
    return out


cuda_paged_attention.launches = 0


# ---------------------------------------------------------------------------
# dispatch on the tensor's device
# ---------------------------------------------------------------------------

def paged_attention(q, cache, page_tables, lengths, *, window: int = 0):
    return on_device(q, cuda_paged_attention, ref_paged_attention, q, cache,
                     page_tables, lengths, window=window)
