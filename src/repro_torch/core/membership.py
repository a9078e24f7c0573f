"""Cluster membership / dropout tolerance for the decentralized outer step
(port of ``repro.core.membership``).

Decentralized clusters drop out and rejoin. The outer average must stay
correct under a changing participant set: Delta = sum_c m_c * C(delta_c)
/ sum_c m_c with a liveness mask m, and a rejoining cluster's stale
per-cluster buffers are zeroed.

Everything runs on the tensors' own device. The sums over the cluster
axis are unrolled in cluster order (``acc + x_c * m_c``), the order XLA
reduces the JAX package's leading axis in, so a mean does not depend on
how the device library would split a C-row reduction. ``reset_rejoining``
writes the port's stacked buffers in place (as ``core.diloco`` does); the
others return new tensors.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T

# trimmed_cluster_mean sorts this many columns of a leaf at a time: torch.sort
# also returns int64 indices, C x 8 bytes a column (3.3 GB for opt-1.3b's
# embedding at C = 4 in one call)
_SORT_COLS = 1 << 22


def _mask(alive, device) -> torch.Tensor:
    return torch.as_tensor(alive).to(device=device, dtype=torch.float32)


def _rows_sum(rows):
    """``rows[0] + rows[1] + ...`` in order, each add rounded on its own."""
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc


def masked_cluster_mean(stacked_tree: Any, alive) -> Any:
    """Mean over the cluster axis counting only alive clusters. ``alive``:
    (C,) float or bool mask (a float mask weights the rows, e.g. by
    staleness). A zero update if no cluster reported (mass clamped at
    1e-9): the outer optimizer then applies momentum only."""
    dev = T.leaves(stacked_tree)[0].device
    m32 = _mask(alive, dev)
    mass = torch.clamp(_rows_sum(list(m32)), min=1e-9)

    def one(x):
        m = m32.to(x.dtype)
        acc = x[0] * m[0]
        for c in range(1, x.shape[0]):
            acc = acc + x[c] * m[c]
        return acc / mass.to(x.dtype)

    return T.tree_map(one, stacked_tree)


def trimmed_cluster_mean(stacked_tree: Any, alive, trim: int = 1) -> Any:
    """Coordinate-wise trimmed mean over the alive cluster rows: per
    coordinate, drop the ``trim`` largest and ``trim`` smallest values
    among the alive candidates and average the rest (the robust
    aggregation against a Byzantine cluster; callers pass a 0/1 mask).

    Dead rows are pushed past the top of the sort with ``+inf`` so the
    alive candidates occupy the first ``n_alive`` slots; degenerate masks
    (``n_alive <= 2*trim``) give a zero update. Leaf by leaf, and within a
    leaf ``_SORT_COLS`` columns at a time."""
    dev = T.leaves(stacked_tree)[0].device
    m = _mask(alive, dev) > 0
    n_alive = m.sum().to(torch.int32)
    lo = trim
    hi = n_alive - trim
    cnt = torch.clamp(hi - lo, min=1).to(torch.float32)

    def one(x):
        C = x.shape[0]
        idx = torch.arange(C, dtype=torch.int32, device=dev)
        inc = ((idx >= lo) & (idx < hi)).reshape(C, 1)
        x2 = x.reshape(C, -1)
        out = torch.empty(x2.shape[1:], dtype=x.dtype, device=dev)
        for s in range(0, x2.shape[1], _SORT_COLS):
            chunk = x2[:, s:s + _SORT_COLS].float()
            ranked = torch.sort(torch.where(m.reshape(C, 1), chunk,
                                            torch.inf), dim=0).values
            kept = torch.where(inc, ranked, 0.0)
            out[s:s + _SORT_COLS] = _rows_sum(list(kept)) / cnt
        return out.reshape(x.shape[1:])

    return T.tree_map(one, stacked_tree)


def masked_mixing_matrix(W, alive) -> torch.Tensor:
    """Membership-masked row renormalization of a mixing matrix, in f32 as
    the JAX package computes it (so the matrix bytes are JAX's).

    Zeroes every row/column of a dead cluster and folds the lost
    off-diagonal mass back into each alive row's *self*-weight, so the
    alive block keeps rows summing to 1 and stays symmetric whenever ``W``
    is: doubly stochastic over the alive set. Dead rows become identity
    rows: a dead cluster's state passes through a mix untouched."""
    W = torch.as_tensor(W).to(torch.float32)
    n = W.shape[0]
    m = _mask(alive, W.device).reshape(n)
    eye = torch.eye(n, dtype=torch.float32, device=W.device)
    off = W * (1.0 - eye) * m[None, :] * m[:, None]
    diag = torch.diag(1.0 - _rows_sum(list(off.T)))
    return torch.where(m[:, None] > 0, off + diag, eye)


@torch.no_grad()
def reset_rejoining(stacked_tree: Any, rejoined,
                    fill_value: float = 0.0) -> Any:
    """Set the rows of clusters that just rejoined to ``fill_value`` in
    place (pending deltas, error feedback: their stale local state
    predates the current global params and must not leak into the next
    average); returns the tree."""
    def one(x):
        r = torch.as_tensor(rejoined).to(device=x.device, dtype=torch.bool)
        return x.masked_fill_(r.reshape((-1,) + (1,) * (x.dim() - 1)),
                              fill_value)

    return T.tree_map(one, stacked_tree)


def effective_batch_scale(alive, n_clusters: int) -> torch.Tensor:
    """Outer-lr compensation for lost data parallelism: sqrt(alive/C) (the
    linear-scaling-rule analogue for the outer step)."""
    frac = _rows_sum(list(_mask(alive, "cpu"))) / max(n_clusters, 1)
    return torch.sqrt(torch.clamp(frac, min=1e-9))
