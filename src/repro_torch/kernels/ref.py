"""Plain PyTorch oracles for the port's kernels (port of
``repro.kernels.ref``): int4 block pack/unpack, the matmul oracle, the
fused payload and the unfused outer-step chain, and causal GQA attention
with the flash kernels' forward (o, lse) and backward (dq, dk, dv).

Wire format (int4, block-wise symmetric):
  packed: uint8, two int4 codes per byte (low nibble = even index)
  scales: float32, one per ``block`` elements

The scale is ``amax * f32(1/qmax)``, not ``amax / qmax``: the JAX
reference runs under ``jit``, where XLA rewrites the division by the
constant into a multiply by its reciprocal, and the wire bytes must be
bit-identical to that. The codes divide, ``round(x / scale)`` with
round-half-to-even, as the jitted reference does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


def block_scales(xf: torch.Tensor, qmax: float = 7.0) -> torch.Tensor:
    """Per-row scale of a (nblk, block) f32 view: amax * f32(1/qmax),
    with 1.0 where that is 0."""
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=xf.device)
    scale = xf.abs().amax(dim=1) * inv
    return torch.where(scale == 0, torch.ones_like(scale), scale)


def quant4_pack_ref(x: torch.Tensor, block: int = 256):
    """x: flat (n,) f32. Returns (packed uint8 (ceil(n/block)*block/2,),
    scales f32 (ceil(n/block),), n)."""
    n = x.shape[0]
    pad = (-n) % block
    xf = torch.nn.functional.pad(x.float(), (0, pad)).reshape(-1, block)
    scale = block_scales(xf)
    q = torch.clamp(torch.round(xf / scale[:, None]), -8, 7).to(torch.int32)
    qu = (q & 0xF).to(torch.uint8).reshape(-1)          # two's complement
    packed = qu[0::2] | (qu[1::2] << 4)
    return packed, scale, n


def quant4_unpack_ref(packed: torch.Tensor, scales: torch.Tensor, n: int,
                      block: int = 256) -> torch.Tensor:
    lo = (packed & 0xF).to(torch.int32)
    hi = ((packed >> 4) & 0xF).to(torch.int32)
    codes = torch.stack([lo, hi], dim=1).reshape(-1)
    codes = torch.where(codes >= 8, codes - 16, codes)  # sign extend
    vals = codes.float().reshape(-1, block) * scales[:, None]
    return vals.reshape(-1)[:n]


def quant4_roundtrip_ref(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    packed, scales, n = quant4_pack_ref(x.reshape(-1), block)
    return quant4_unpack_ref(packed, scales, n, block).reshape(x.shape)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


class FusedPayload(NamedTuple):
    """Wire payload of one compressed parameter matrix: packed int4 factor
    codes and per-block scales in ``quant4_pack_ref``'s flat row-major
    layout. ``p_factor``/``q_factor`` are the pre-quantization f32 factors
    (warm start and audit fields; they never go on the wire)."""
    packed_p: torch.Tensor     # uint8 (ceil(m*r/block) * block//2,)
    scales_p: torch.Tensor     # f32   (ceil(m*r/block),)
    packed_q: torch.Tensor     # uint8 (ceil(n*r/block) * block//2,)
    scales_q: torch.Tensor     # f32   (ceil(n*r/block),)
    p_factor: torch.Tensor     # f32 (m, r)
    q_factor: torch.Tensor     # f32 (n, r)


def col_mask(r: int, rank_scalar, device) -> torch.Tensor:
    """(r,) f32: 1 for columns < r_t, 0 from r_t on (all ones without
    an adaptive rank)."""
    if rank_scalar is None:
        return torch.ones((r,), dtype=torch.float32, device=device)
    rt = torch.as_tensor(rank_scalar, device=device)
    return (torch.arange(r, device=device) < rt).float()


def outer_step_ref(delta: torch.Tensor, error, q_prev: torch.Tensor,
                   rank_scalar=None, block: int = 256):
    """The unfused chain the fused pipeline replaces: EF add -> P = M Qm ->
    Cholesky-QR -> Q = M^T P -> quantize factors -> pack -> reconstruct ->
    EF residual. Returns (delta_hat, e_new, q_new, payload)."""
    from repro_torch.core.compression import _orthonormalize

    m, n = delta.shape
    r = q_prev.shape[1]
    M = delta.float()
    if error is not None:
        M = M + error.float()
    cm = col_mask(r, rank_scalar, delta.device)
    qm = q_prev.float() * cm
    P = M @ qm
    P = _orthonormalize(P) * cm
    Q = M.T @ P
    pP, sP, _ = quant4_pack_ref(P.reshape(-1), block)
    pQ, sQ, _ = quant4_pack_ref(Q.reshape(-1), block)
    Pq = quant4_unpack_ref(pP, sP, m * r, block).reshape(m, r)
    Qq = quant4_unpack_ref(pQ, sQ, n * r, block).reshape(n, r)
    rec = Pq @ Qq.T
    delta_hat = rec.to(delta.dtype)
    e_new = M - rec
    q_new = torch.where((Q * Q).sum() > 0, Q, qm)
    return delta_hat, e_new, q_new, FusedPayload(pP, sP, pQ, sQ, P, Q)


# ---------------------------------------------------------------------------
# flash attention (causal, GQA): the plain versions of the CUDA kernels
# ---------------------------------------------------------------------------

def _work_dtype(dtype) -> torch.dtype:
    """f32 for f32 and narrower inputs; f64 stays f64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _scores(q, k, causal: bool) -> torch.Tensor:
    """(B,KV,G,Sq,Sk) scaled scores in the working type; masked lanes
    (top-left causal: key j seen by query i iff j <= i) are -1e30."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    wt = _work_dtype(q.dtype)
    qg = q.reshape(B, Sq, KV, H // KV, d).to(wt)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(wt)) / math.sqrt(d)
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full((), -1e30, dtype=wt,
                                            device=q.device))
    return s


def flash_attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,H,d); k,v: (B,Sk,KV,d). Plain softmax attention in f32
    (port of ``repro.kernels.ref.flash_attention_ref``)."""
    B, Sq, H, d = q.shape
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(p.dtype))
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def flash_attention_fwd_ref(q, k, v, causal: bool = True):
    """The forward kernel's plain version: (o (B,Sq,H,d) in q's dtype,
    contiguous as the kernel writes it, lse (B,H,Sq), the per-row
    log-sum-exp of the scaled scores)."""
    B, Sq, H, d = q.shape
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)                       # (B,KV,G,Sq)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(p.dtype))
    return (o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype).contiguous(),
            lse.reshape(B, H, Sq).contiguous())


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True):
    """The backward kernels' plain version, with their math: D =
    rowsum(dO * O), P = exp(S - lse), dS = P * (dP - D); dk and dv sum over
    the G query heads that share a KV head. Returns (dq, dk, dv) in the
    dtypes of q, k, v."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    s = _scores(q, k, causal)
    wt = s.dtype
    p = torch.exp(s - lse.to(wt).reshape(B, KV, G, Sq)[..., None])
    dog = do.to(wt).reshape(B, Sq, KV, G, d)
    D = (do.to(wt) * o.to(wt)).sum(-1)                     # (B,Sq,H)
    D = D.reshape(B, Sq, KV, G).permute(0, 2, 3, 1)        # (B,KV,G,Sq)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.to(wt))
    ds = p * (dp - D[..., None]) / math.sqrt(d)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(wt)).reshape(B, Sq, H, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.to(wt).reshape(B, Sq, KV, G, d))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
