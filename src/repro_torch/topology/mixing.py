"""Doubly-stochastic mixing matrices + the gossip mixing operator (port of
``repro.topology.mixing``).

``MixingMatrix`` turns a ``Topology`` into the per-round averaging weights:

 - gather kinds (star/full): ``W = J/n``, the exact global mean in one
   step (what the hub relay realizes), spectral gap 1;
 - gossip kinds: Metropolis-Hastings weights on the graph,
   ``W_ij = 1/(1 + max(d_i, d_j))`` on edges, self-weight absorbs the rest:
   doubly stochastic, so repeated mixing contracts every cluster toward
   the mean at the rate of the spectral gap ``1 - |lambda_2|``.

The matrices, push-sum weights and ``consensus_distance`` are numpy,
copied from the JAX package (float32 matrices, the same bytes); the
membership mask goes through ``core.membership.masked_mixing_matrix``.
``consensus_distance_trees`` is the same distance taken on the device.

``mixing_op(topology, alive)`` produces the ``cluster_mean``-shaped
callable ``core.diloco.diloco_round`` consumes: the masked global mean for
gather kinds; for gossip kinds a *stacked* tree (row c is cluster c's
neighborhood average), tagged ``returns_stacked=True`` so the round
switches to gossip semantics.

``mix_row``/``mix_stacked`` are unrolled f32 multiply-add chains in fixed
j order, each multiply and each add a separate rounding (a separate
PyTorch op, never ``add(alpha=)``, ``addcmul`` or ``lerp``, which may
contract to an FMA on CUDA): one worker computing its own row and the
stacked mix computing all rows execute the identical op sequence, so the
two are bit for bit equal, and equal to the JAX package's eager chain.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.topology.graphs import (GATHER_KINDS, Digraph, Topology,
                                         as_digraph)


# ---------------------------------------------------------------------------
# matrices (pure numpy)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MixingMatrix:
    """A (n, n) float32 mixing matrix tied to the topology that produced it.
    float32 on purpose: the same bytes feed both simulator backends."""
    W: np.ndarray
    kind: str = "custom"

    def __post_init__(self):
        W = np.asarray(self.W, np.float32)
        if W.ndim != 2 or W.shape[0] != W.shape[1]:
            raise ValueError(f"mixing matrix must be square, got {W.shape}")
        object.__setattr__(self, "W", W)

    @staticmethod
    def metropolis(topo: Topology,
                   alive: Optional[np.ndarray] = None) -> "MixingMatrix":
        """Metropolis-Hastings weights on the (alive-masked) graph.  Gather
        kinds get J/n over the alive set — one hub round IS the global
        mean, not an MH step on the star graph."""
        n = topo.n
        if topo.kind in ("star", "full"):
            W = np.full((n, n), 1.0 / n, np.float64)
        else:
            deg = np.array([topo.degree(c) for c in range(n)], np.float64)
            W = np.zeros((n, n), np.float64)
            for i, j in topo.edges:
                w = 1.0 / (1.0 + max(deg[i], deg[j]))
                W[i, j] = W[j, i] = w
            np.fill_diagonal(W, 1.0 - W.sum(axis=1))
        mm = MixingMatrix(W.astype(np.float32), topo.kind)
        if alive is not None:
            mm = mm.masked(alive)
        return mm

    def masked(self, alive: np.ndarray) -> "MixingMatrix":
        """Membership-masked row renormalization (core.membership)."""
        from repro_torch.core.membership import masked_mixing_matrix

        W = masked_mixing_matrix(self.W, np.asarray(alive)).numpy()
        return MixingMatrix(W, self.kind)

    def is_doubly_stochastic(self, atol: float = 1e-5) -> bool:
        W = self.W.astype(np.float64)
        return bool((W >= -atol).all()
                    and np.allclose(W.sum(axis=0), 1.0, atol=atol)
                    and np.allclose(W.sum(axis=1), 1.0, atol=atol))

    def spectral_gap(self, alive: Optional[np.ndarray] = None) -> float:
        """1 - |lambda_2| of the (alive block of the) matrix: the per-mix
        contraction rate toward consensus.  Dead identity rows would each
        contribute a spurious eigenvalue 1, hence the restriction."""
        W = self.W.astype(np.float64)
        if alive is not None:
            ids = np.flatnonzero(np.asarray(alive, bool))
            W = W[np.ix_(ids, ids)]
        if W.shape[0] <= 1:
            return 1.0
        eig = np.sort(np.abs(np.linalg.eigvals(W)))[::-1]
        return float(1.0 - eig[1])


# ---------------------------------------------------------------------------
# push-sum: column-stochastic weights for directed/asymmetric graphs
# ---------------------------------------------------------------------------

def push_sum_weights(graph) -> np.ndarray:
    """Column-stochastic push-sum weights for a directed graph.

    ``W[i, j] = 1 / (out_degree(j) + 1)`` for every arc ``j -> i`` and for
    the self-loop ``j -> j``: node ``j`` splits its mass equally over its
    out-neighbors and itself, so every *column* sums to exactly 1 — total
    mass is conserved — with no symmetry (double stochasticity)
    requirement at all.  That is the whole point: Metropolis-Hastings
    weights need ``W = Wᵀ``, which an asymmetric-uplink WAN cannot
    provide; push-sum instead tracks a weight scalar ``φ`` through the
    same matrix and debiases with the ratio ``x/φ`` (Kempe et al.), which
    converges to the true average on any strongly connected digraph.

    Accepts a ``Digraph`` or an undirected ``Topology`` (promoted via
    ``as_digraph``).  float64, exact ``1/(d+1)`` rationals — both sim
    backends build the identical matrix.
    """
    g = graph if isinstance(graph, Digraph) else as_digraph(graph)
    n = g.n
    W = np.zeros((n, n), np.float64)
    for j in range(n):
        share = 1.0 / (g.out_degree(j) + 1.0)
        W[j, j] = share
        for i in g.out_neighbors(j):
            W[i, j] = share
    return W


def push_sum_round(W: np.ndarray, x: np.ndarray, phi: np.ndarray):
    """One synchronous push-sum iteration: ``x' = W x``, ``φ' = W φ``.
    ``x``: (n, ...) values, ``φ``: (n,) weights (init: ones).  The
    debiased estimate at any time is ``x / φ`` per node; column
    stochasticity conserves ``Σx`` and ``Σφ`` exactly."""
    x = np.asarray(x, np.float64)
    phi = np.asarray(phi, np.float64)
    xc = x.reshape(x.shape[0], -1)
    return (W @ xc).reshape(x.shape), W @ phi


def push_sum_average(graph, x: np.ndarray, iters: int = 200):
    """Run ``iters`` push-sum rounds from ``φ = 1`` and return the
    per-node debiased estimates ``x_i/φ_i`` (each converging to
    ``mean(x)`` on a strongly connected graph) — the reference iteration
    the property tests certify and the bounded-stale engine's
    weighted-mean aggregation approximates one commit at a time."""
    W = push_sum_weights(graph)
    x = np.asarray(x, np.float64)
    phi = np.ones(x.shape[0], np.float64)
    for _ in range(int(iters)):
        x, phi = push_sum_round(W, x, phi)
    return x / phi.reshape((-1,) + (1,) * (x.ndim - 1))


def async_mix_weights(topo: Topology) -> np.ndarray:
    """The (C, C) base mixing-weight matrix for ``sync="bounded_stale"``:
    row ``c`` holds the weight cluster ``c`` gives each peer's freshest
    published delta (support of row c = c's in-neighborhood = the
    staleness-gate set).

    Gather kinds (star/full) model a relay hub that re-broadcasts every
    published delta, so every cluster mixes everyone uniformly (``J/n`` —
    push-sum on the complete graph).  Gossip kinds take the push-sum
    weights of the bidirected graph: ``W[c, p] = 1/(deg(p)+1)`` — each
    peer's out-share of its own delta.  Rows are NOT normalized here:
    ``core.diloco.staleness_weights`` discounts by staleness and
    ``masked_cluster_mean``'s sum-normalization supplies the push-sum
    ``x/φ`` debiasing at commit time.
    """
    n = topo.n
    if topo.kind in GATHER_KINDS:
        return np.full((n, n), 1.0 / n, np.float64)
    return push_sum_weights(topo)


def consensus_distance(stacked: np.ndarray, alive: np.ndarray) -> float:
    """RMS distance of alive rows from their mean — the scalar the timeline
    records as ``disagreement`` (0 for gather, since rows are identical)."""
    alive = np.asarray(alive, bool)
    rows = np.asarray(stacked, np.float64)[alive].reshape(alive.sum(), -1)
    if rows.shape[0] == 0:
        return 0.0
    centred = rows - rows.mean(axis=0, keepdims=True)
    return float(np.sqrt(np.mean(centred ** 2)))


# consensus_distance_trees takes a leaf this many elements at a time, so
# its float64 temporaries stay small beside a model's embedding
_DIST_CHUNK = 1 << 24


@torch.no_grad()
def consensus_distance_trees(trees: Sequence[Any], alive) -> float:
    """``consensus_distance`` of one tree per cluster (the rows flattened
    leaf after leaf), computed on the trees' device: leaf by leaf and
    ``_DIST_CHUNK`` elements at a time, in float64, the alive rows' mean
    and then the RMS of the centred alive rows over every element.  No
    row is copied to the host; the value agrees with the numpy form to
    float64 rounding (the sums run in another order)."""
    rows = [T.leaves(t) for t, a in zip(trees, np.asarray(alive, bool))
            if a]
    if not rows:
        return 0.0
    n = len(rows)
    total = torch.zeros((), dtype=torch.float64, device=rows[0][0].device)
    count = 0
    for leaf in zip(*rows):
        flat = [x.reshape(-1) for x in leaf]
        for s in range(0, flat[0].numel(), _DIST_CHUNK):
            xs = [x[s:s + _DIST_CHUNK].double() for x in flat]
            mean = xs[0]
            for x in xs[1:]:
                mean = mean + x
            mean = mean / n
            for x in xs:
                total += torch.sum(torch.square(x - mean))
        count += flat[0].numel()
    return float(torch.sqrt(total / (n * count)))


# ---------------------------------------------------------------------------
# mix operators (PyTorch, on the rows' device)
# ---------------------------------------------------------------------------

def _weights(W) -> np.ndarray:
    return np.asarray(W.cpu() if isinstance(W, torch.Tensor) else W,
                      np.float32)


@torch.no_grad()
def mix_row(w_row, parts: Sequence[Any], out: Any = None) -> Any:
    """One cluster's neighborhood average: sum_j w_row[j] * parts[j], as an
    unrolled f32 multiply-add chain in fixed j order. ``parts`` has one
    tree per cluster (a dead or non-neighbor cluster's weight is 0, and
    its term is still computed, as in the JAX package). ``out``: a tree to
    write the row into (the stacked mix's row c); else new tensors."""
    w = [float(v) for v in _weights(w_row).reshape(-1)]

    def one(o, *xs):
        o = torch.mul(xs[0].float(), w[0], out=o)
        tmp = torch.empty_like(o)
        for j in range(1, len(xs)):
            o.add_(torch.mul(xs[j].float(), w[j], out=tmp))
        return o

    if out is None:
        return T.tree_map(lambda *xs: one(None, *xs), *parts)
    return T.tree_map(one, out, *parts)


@torch.no_grad()
def mix_stacked(W, stacked_tree: Any) -> Any:
    """All clusters' neighborhood averages: row c of the result is
    ``mix_row(W[c], rows)``. W: (C, C), stacked_tree leaves: (C, ...).
    Each row is written into one preallocated stacked f32 output, so the
    mix holds one copy of the stack and a leaf-sized temporary; the output
    aliases no input row."""
    from repro_torch.core.diloco import take_row

    W = _weights(W)
    n = W.shape[0]
    parts = [take_row(stacked_tree, j) for j in range(n)]
    out = T.tree_map(lambda x: torch.empty(x.shape, dtype=torch.float32,
                                           device=x.device), stacked_tree)
    for c in range(n):
        mix_row(W[c], parts, out=take_row(out, c))
    return out


def mixing_op(topology: Topology, alive: np.ndarray):
    """The ``cluster_mean``-shaped callable for ``core.diloco.diloco_round``
    under this topology and alive mask.

    Gather kinds: masked global mean (unstacked result, the hub path).
    Gossip kinds: stacked neighborhood averages through the masked MH
    matrix; the op carries ``returns_stacked=True`` (switches
    ``diloco_round`` to gossip semantics), ``.matrix`` (the
    ``MixingMatrix`` applied) and ``.topology``."""
    from repro_torch.core.membership import masked_cluster_mean

    alive = np.asarray(alive, bool)
    mm = MixingMatrix.metropolis(topology, alive)
    if not topology.is_gossip:
        m = torch.as_tensor(alive.astype(np.float32))
        op = lambda tree: masked_cluster_mean(tree, m)
        op.returns_stacked = False
    else:
        op = lambda tree: mix_stacked(mm.W, tree)
        op.returns_stacked = True
    op.matrix = mm
    op.topology = topology
    return op
