"""Outer optimizer: Nesterov momentum over pseudo-gradients (port of
``repro.optim.nesterov``; DiLoCo / DiLoCoX §2.2).

``update`` writes the new params and momentum in place (the JAX function
returns new trees) and returns them. A bf16 parameter's step is taken in
f32 and rounded once, as JAX's ``(p.astype(f32) - lr *
step_dir).astype(p.dtype)``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as T
from repro_torch.optim.adamw import sub_rounded_once_


class NesterovState(NamedTuple):
    step: torch.Tensor        # int32 ()
    momentum: Any


def init(params) -> NesterovState:
    dev = T.leaves(params)[0].device
    return NesterovState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        momentum=T.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))


@torch.no_grad()
def update_leaf(g, v, p, *, lr=0.7, momentum=0.9):
    """``update`` on one leaf: momentum ``v`` and params ``p`` in place."""
    g = g.float()
    v.mul_(momentum).add_(g)
    step_dir = momentum * v + g
    sub_rounded_once_(p, step_dir.mul_(lr))


@torch.no_grad()
def update(pseudo_grads, state: NesterovState, params, *, lr=0.7,
           momentum=0.9):
    """theta <- theta - lr*(mu*v_new + Delta), v_new = mu*v + Delta
    (DiLoCo's Nesterov form). Pseudo-gradients point in the descent
    direction already (theta_anchor - theta_local)."""
    for p, g, v in zip(T.leaves(params), T.leaves(pseudo_grads),
                       T.leaves(state.momentum)):
        update_leaf(g, v, p, lr=lr, momentum=momentum)
    return params, NesterovState(step=state.step + 1,
                                 momentum=state.momentum)
