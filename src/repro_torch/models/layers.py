"""Shared building blocks: norms, RoPE, MLPs, initializers (port of
``repro.models.layers``).

All modules are functional: ``init_*`` returns a param dict of tensors,
``apply``-style functions consume it. Stacked layers carry a leading unit
dim (``lead``). Layouts are the JAX package's: weights are ``(d_in,
d_out)`` and applied as ``x @ W``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init helpers (same distributions as the JAX package; other random streams)
# ---------------------------------------------------------------------------

def _randn(shape, gen, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def dense_init(gen, d_in: int, d_out: int, *, lead=(), dtype=torch.float32,
               device=None):
    scale = 1.0 / math.sqrt(d_in)
    return (_randn((*lead, d_in, d_out), gen, device) * scale).to(dtype)


def embed_init(gen, vocab: int, d: int, *, dtype=torch.float32, device=None):
    return (_randn((vocab, d), gen, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms: eps 1e-6, computed in f32 and cast back (not nn.LayerNorm's 1e-5)
# ---------------------------------------------------------------------------

def init_norm(kind: str, d: int, *, lead=(), dtype=torch.float32, device=None):
    if kind == "rmsnorm":
        return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def apply_norm(params, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE: rotates halves (split into x1, x2), not interleaved pairs
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)            # (d/2,)
    ang = positions[..., None].float() * inv                # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_swiglu(gen, d: int, d_ff: int, *, lead=(), dtype=torch.float32,
                device=None):
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {"w_gate": dense_init(gen, d, d_ff, **kw),
            "w_up": dense_init(gen, d, d_ff, **kw),
            "w_down": dense_init(gen, d_ff, d, **kw)}


def apply_swiglu(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def init_gelu_mlp(gen, d: int, d_ff: int, *, lead=(), dtype=torch.float32,
                  device=None):
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {"w_in": dense_init(gen, d, d_ff, **kw),
            "b_in": torch.zeros((*lead, d_ff), dtype=dtype, device=device),
            "w_out": dense_init(gen, d_ff, d, **kw),
            "b_out": torch.zeros((*lead, d), dtype=dtype, device=device)}


def apply_gelu_mlp(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    # a row-parallel shard holds no b_out: it is added once after the sum
    return h @ p["w_out"] + p["b_out"] if "b_out" in p else h @ p["w_out"]
