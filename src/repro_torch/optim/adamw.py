"""Inner optimizer: AdamW (port of ``repro.optim.adamw``; the paper's inner
optimizer, §2.2).

The JAX function returns new trees; here ``update`` writes the new params,
m and v into the given tensors in place and returns them, because at
opt-1.3b width every extra copy of the model is 3.2 GB on the card. State
is param-shaped (m, v) in float32 plus an int32 step.

The casts are JAX's: a bf16 gradient times the f32 clip scale is f32
(JAX promotes), and the new parameter is ``p - lr * delta`` taken in f32
and rounded once to ``p.dtype``. In float32 both are the in-place forms,
bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as T


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32, () or (C,) when cluster-stacked
    m: Any
    v: Any


def init(params) -> AdamWState:
    z = T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    dev = T.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=z, v=T.tree_map(torch.clone, z))


def scaled(g, scale):
    """``g * scale`` (the clip) as JAX takes it: an f32 gradient scaled in
    place, a bf16 one into an f32 copy (bf16 x the f32 scale promotes)."""
    return g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale


def sub_rounded_once_(p, step):
    """``p <- (p - step)`` with ``step`` f32: the difference taken in f32
    and rounded once to ``p.dtype`` (JAX's ``(p.astype(f32) -
    step).astype(p.dtype)``); ``step`` is overwritten. In f32, ``p.sub_``."""
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(torch.sub(p.float(), step, out=step))


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """One AdamW step with global-norm clipping and bias correction, in
    place on ``params``, ``state.m``, ``state.v`` (and float32 ``grads``,
    which are scaled by the clip; other grads are clipped into f32
    copies). Returns ``(params, state)`` with the step advanced. ``lr``
    may be a scalar or a callable of the step."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    flat_g = T.leaves(grads)
    if grad_clip:
        sq = None
        for g in flat_g:                 # jnp: sum(...) over the leaves
            s = torch.sum(torch.square(g.float()))
            sq = s if sq is None else sq + s
        gnorm = torch.sqrt(sq + 1e-16)
        scale = torch.clamp(grad_clip / gnorm, max=1.0)
        flat_g = [scaled(g, scale) for g in flat_g]
    stepf = step.float()
    b1t = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2t = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    for p, g, m, v in zip(T.leaves(params), flat_g, T.leaves(state.m),
                          T.leaves(state.v)):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / b1t) / (torch.sqrt(v / b2t) + eps)
        delta.add_(weight_decay * p.float())
        sub_rounded_once_(p, delta.mul_(lr_t))
    return params, AdamWState(step=step, m=state.m, v=state.v)
