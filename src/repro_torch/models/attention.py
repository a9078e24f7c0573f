"""GQA attention (port of the dense paths of ``repro.models.attention``):
the additive mask, the einsum ``grouped_attend`` with its query-chunked
form, full-sequence self-attention for training (``apply_gqa``),
projections, and the dense and ring-buffer decode caches.

Caches are updated in place (the JAX functions return new caches; here
the returned dict is the same, mutated one).

``grouped_attend`` routes plain causal self-attention to the flash kernels
(``kernels.flash_attention``: a forward and a hand-written backward) under
the JAX condition, with ``flash=True`` in place of ``REPRO_USE_PALLAS=1``:
``plain_causal and flash and Sq == Sk and dh == dv and Sq % 128 == 0``.
Like the JAX route it ignores ``bias``: ``apply_gqa`` marks ``plain_causal``
only for a causal mask without a window over ``arange`` positions, which
is what the kernels' own mask computes. Otherwise, and by default, the
einsum path runs, as the JAX default does.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mask construction (position-id based)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, *, causal: bool, window: int) -> torch.Tensor:
    """Returns additive bias (..., Sq, Sk). window==0 -> no sliding limit.
    Masked lanes get -1e30, not -inf: exp underflows to exact zeros."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=qp.device)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    zero = torch.zeros((), dtype=torch.float32, device=qp.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _block(q_blk, k, v, bias_blk, scale):
    """q_blk (B,cq,KV,G,dh); bias_blk (B|1,cq,Sk) -> (B,cq,KV,G,dv) f32."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q_blk.float(), k.float()) * scale
    s = s + bias_blk[:, None, None, :, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.float())


def grouped_attend(q, k, v, bias, *, chunk: int = 0,
                   plain_causal: bool = False,
                   flash: bool = False) -> torch.Tensor:
    """GQA core. q: (B,Sq,H,dh); k,v: (B,Sk,KV,dh[v]); bias: (B|1,Sq,Sk)
    or (Sq,Sk) additive. Returns (B,Sq,H,dv). Query head h reads KV head
    h // G. ``plain_causal`` with ``flash`` takes the flash kernels where
    the JAX route would take its Pallas kernel (module docstring). On the
    einsum path, with ``chunk`` dividing Sq the queries go in chunks, each
    checkpointed, so backward recomputes the (chunk, Sk) scores instead of
    keeping them all."""
    if (plain_causal and flash and q.shape[1] == k.shape[1]
            and q.shape[-1] == v.shape[-1] and q.shape[1] % 128 == 0):
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=True)
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Sq, KV, G, dh)
    if bias.dim() == 2:
        bias = bias[None]
    if chunk and Sq > chunk and Sq % chunk == 0:
        outs = [checkpoint(_block, qg[:, i:i + chunk], k, v,
                           bias[:, i:i + chunk], scale, use_reentrant=False)
                for i in range(0, Sq, chunk)]
        o = torch.cat(outs, dim=1)
    else:
        o = _block(qg, k, v, bias, scale)
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def init_gqa(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
             lead=(), dtype=torch.float32, device=None):
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, **kw),
        "wk": dense_init(gen, d_model, n_kv * head_dim, **kw),
        "wv": dense_init(gen, d_model, n_kv * head_dim, **kw),
        "wo": dense_init(gen, n_heads * head_dim, d_model, **kw),
    }


def _qkv(p, x, n_heads, n_kv, head_dim):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(B, S, n_kv, head_dim)
    return q, k, v


def apply_gqa(p, x, positions, *, n_heads, n_kv, head_dim, rope_theta,
              causal=True, window=0, chunk=0, flash=False) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill); ``flash``
    lets plain causal attention take the flash kernels."""
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    bias = _mask_bias(positions, positions, causal=causal, window=window)
    o = grouped_attend(q, k, v, bias, chunk=chunk,
                       plain_causal=(causal and window == 0), flash=flash)
    return o.reshape(*x.shape[:2], -1) @ p["wo"]


def decode_gqa(p, x1, cache, index: int, *, n_heads, n_kv, head_dim,
               rope_theta, window=0):
    """One-token decode. x1: (B,1,d). cache: {"k","v"}: (B,Smax,KV,dh),
    written in place at ``index``. Returns (out (B,1,d), cache)."""
    B = x1.shape[0]
    q, k_new, v_new = _qkv(p, x1, n_heads, n_kv, head_dim)
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x1.device)
    q = apply_rope(q, pos, rope_theta)
    k_new = apply_rope(k_new, pos, rope_theta)
    cache["k"][:, index] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, index] = v_new[:, 0].to(cache["v"].dtype)
    k_pos = torch.arange(cache["k"].shape[1], dtype=torch.int32,
                         device=x1.device)[None, :]
    bias = _mask_bias(pos, k_pos, causal=True, window=window)
    o = grouped_attend(q, cache["k"], cache["v"], bias)
    out = o.reshape(B, 1, -1) @ p["wo"]
    return out, cache


def init_gqa_cache(batch, s_max, n_kv, head_dim, *, window=0, lead=(),
                   dtype=torch.float32, device=None):
    """Full-length cache for global layers; ring buffer of size `window`
    (plus a slot-position array) for sliding-window layers."""
    if window > 0 and window < s_max:
        shape = (*lead, batch, window, n_kv, head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.full((*lead, batch, window), -1,
                                  dtype=torch.int32, device=device)}
    shape = (*lead, batch, s_max, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_gqa_ring(p, x1, cache, index: int, *, n_heads, n_kv, head_dim,
                    rope_theta):
    """Sliding-window decode against a ring buffer. ``pos`` tracks which
    absolute position each slot holds; every stored position is within the
    window by construction, so the only mask is slot validity."""
    B = x1.shape[0]
    W = cache["k"].shape[1]
    q, k_new, v_new = _qkv(p, x1, n_heads, n_kv, head_dim)
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x1.device)
    q = apply_rope(q, pos, rope_theta)
    k_new = apply_rope(k_new, pos, rope_theta)
    slot = index % W
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][:, slot] = index
    zero = torch.zeros((), dtype=torch.float32, device=x1.device)
    bias = torch.where(cache["pos"] >= 0, zero,
                       torch.full_like(zero, NEG_INF))[:, None, :]
    o = grouped_attend(q, cache["k"], cache["v"], bias)
    out = o.reshape(B, 1, -1) @ p["wo"]
    return out, cache
