"""Communication graphs for the decentralized outer step (a copy of
``repro.topology.graphs``: numpy only, so each graph equals the JAX
package's edge for edge).

A ``Topology`` is the *shape* of the outer-step communication pattern: which
cluster talks to which.  The seed repo hard-wired a hub (every cluster
reaches a coordinator every round — ``star``); this module makes the graph a
first-class object so the outer sync can also run as neighbor gossip
(NoLoCo-style) over a ring, a 2D torus, or a random k-regular expander.

Two families, with different *semantics* downstream:

 - **gather kinds** (``star``, ``full``): every round realizes the exact
   global average (hub relay / all-gather).  ``star`` is the seed repo's
   coordinator topology; ``full`` is the same average with all-to-all wire
   accounting.  Mixing matrix = J/n (averages in one step, spectral gap 1).
 - **gossip kinds** (``ring``, ``torus``, ``random``): each cluster
   exchanges compressed pseudo-gradients with its graph neighbors only and
   applies a doubly-stochastic local mix (``repro_torch.topology.mixing``).
   Per-cluster outer params are no longer identical after the round;
   information diffuses at the rate of the graph's spectral gap.

Everything here is pure numpy/python.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

GATHER_KINDS = ("star", "full")
GOSSIP_KINDS = ("ring", "torus", "random")
KINDS = GATHER_KINDS + GOSSIP_KINDS


@dataclass(frozen=True)
class Topology:
    """An undirected communication graph over ``n`` clusters.

    ``edges`` is a sorted tuple of ``(i, j)`` pairs with ``i < j``.  Use the
    module-level constructors (``ring``/``torus``/``random_regular``/
    ``star``/``full``) or ``make_topology`` rather than building directly.
    """
    kind: str
    n: int
    edges: Tuple[Tuple[int, int], ...]
    meta: Dict[str, int] = field(default_factory=dict, compare=False)

    def __post_init__(self):
        for i, j in self.edges:
            if not (0 <= i < j < self.n):
                raise ValueError(f"bad edge ({i},{j}) for n={self.n}")

    @property
    def is_gossip(self) -> bool:
        return self.kind in GOSSIP_KINDS

    def neighbors(self, c: int) -> Tuple[int, ...]:
        out = [j for i, j in self.edges if i == c]
        out += [i for i, j in self.edges if j == c]
        return tuple(sorted(out))

    def degree(self, c: int) -> int:
        return len(self.neighbors(c))

    def adjacency(self) -> np.ndarray:
        A = np.zeros((self.n, self.n), bool)
        for i, j in self.edges:
            A[i, j] = A[j, i] = True
        return A

    def alive_neighbors(self, c: int, alive: np.ndarray) -> Tuple[int, ...]:
        """Graph neighbors of ``c`` restricted to the alive set."""
        alive = np.asarray(alive, bool)
        return tuple(j for j in self.neighbors(c) if alive[j])

    def is_connected(self, alive: Optional[np.ndarray] = None) -> bool:
        """Connectivity of the (alive-induced) subgraph — gossip only
        contracts to a global consensus on a connected graph."""
        alive = (np.ones(self.n, bool) if alive is None
                 else np.asarray(alive, bool))
        nodes = [int(i) for i in np.flatnonzero(alive)]
        if not nodes:
            return True
        seen, stack = {nodes[0]}, [nodes[0]]
        while stack:
            c = stack.pop()
            for j in self.alive_neighbors(c, alive):
                if j not in seen:
                    seen.add(j)
                    stack.append(j)
        return len(seen) == len(nodes)

    def describe(self) -> str:
        extra = "".join(f" {k}={v}" for k, v in sorted(self.meta.items()))
        return (f"{self.kind}(n={self.n}, |E|={len(self.edges)}{extra})")


@dataclass(frozen=True)
class Digraph:
    """A directed communication graph: arc ``(src, dst)`` means ``src``
    pushes its delta to ``dst``.  This is the asymmetric-uplink setting
    (WAN sites with very different up/down capacity) where doubly-
    stochastic Metropolis-Hastings weights do not exist — push-sum
    (``mixing.push_sum_weights``) mixes correctly with only column
    stochasticity, which any out-degree normalization provides.
    """
    n: int
    arcs: Tuple[Tuple[int, int], ...]

    def __post_init__(self):
        object.__setattr__(
            self, "arcs", tuple(sorted({(int(a), int(b))
                                        for a, b in self.arcs})))
        for a, b in self.arcs:
            if not (0 <= a < self.n and 0 <= b < self.n) or a == b:
                raise ValueError(f"bad arc ({a},{b}) for n={self.n}")

    def out_neighbors(self, c: int) -> Tuple[int, ...]:
        return tuple(sorted(b for a, b in self.arcs if a == c))

    def in_neighbors(self, c: int) -> Tuple[int, ...]:
        return tuple(sorted(a for a, b in self.arcs if b == c))

    def out_degree(self, c: int) -> int:
        return len(self.out_neighbors(c))

    def is_strongly_connected(self) -> bool:
        """Push-sum converges to the true average iff the graph is
        strongly connected (every node's mass can reach every other)."""
        def reach(start, nbrs):
            seen, stack = {start}, [start]
            while stack:
                c = stack.pop()
                for j in nbrs(c):
                    if j not in seen:
                        seen.add(j)
                        stack.append(j)
            return len(seen) == self.n

        return (reach(0, self.out_neighbors) and reach(0, self.in_neighbors))


def directed_ring(n: int) -> Digraph:
    """The canonical asymmetric gossip graph: ``i -> (i+1) % n``."""
    return Digraph(n, tuple((i, (i + 1) % n) for i in range(n)))


def as_digraph(topo: Topology) -> Digraph:
    """Both directions of every undirected edge — how the symmetric
    topologies enter the push-sum weight construction."""
    arcs = []
    for i, j in topo.edges:
        arcs.append((i, j))
        arcs.append((j, i))
    return Digraph(topo.n, tuple(arcs))


def _dedupe(pairs) -> Tuple[Tuple[int, int], ...]:
    return tuple(sorted({(min(a, b), max(a, b)) for a, b in pairs
                         if a != b}))


def ring(n: int) -> Topology:
    return Topology("ring", n, _dedupe((i, (i + 1) % n) for i in range(n)))


def torus(n: int, rows: Optional[int] = None) -> Topology:
    """2D torus on an r x c grid with r*c == n.  ``rows`` defaults to the
    largest divisor of n that is <= sqrt(n) (prime n degenerates to a 1 x n
    wrap — i.e. a ring)."""
    if rows is None:
        rows = max(d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0)
    if n % rows:
        raise ValueError(f"torus rows={rows} does not divide n={n}")
    cols = n // rows
    idx = lambda r, c: r * cols + c
    pairs = []
    for r in range(rows):
        for c in range(cols):
            pairs.append((idx(r, c), idx(r, (c + 1) % cols)))
            pairs.append((idx(r, c), idx((r + 1) % rows, c)))
    t = Topology("torus", n, _dedupe(pairs))
    t.meta.update(rows=rows, cols=cols)
    return t


def random_regular(n: int, degree: int = 3, seed: int = 0) -> Topology:
    """Random k-regular graph by stub matching (configuration model),
    retried until simple *and* connected.  Deterministic in (n, degree,
    seed) — numpy's PCG64 streams are stable across versions."""
    degree = min(degree, n - 1)
    if degree <= 0:
        raise ValueError("random topology needs degree >= 1 and n >= 2")
    if (n * degree) % 2:
        raise ValueError(f"n*degree must be even (n={n}, degree={degree})")
    rng = np.random.default_rng([seed, n, degree])
    for _ in range(500):
        stubs = np.repeat(np.arange(n), degree)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        edges = set()
        ok = True
        for a, b in pairs:
            a, b = int(a), int(b)
            e = (min(a, b), max(a, b))
            if a == b or e in edges:
                ok = False
                break
            edges.add(e)
        if not ok:
            continue
        t = Topology("random", n, tuple(sorted(edges)),
                     meta={"degree": degree, "seed": seed})
        if t.is_connected():
            return t
    raise RuntimeError(f"no connected {degree}-regular graph found for "
                       f"n={n} (seed={seed})")


def star(n: int) -> Topology:
    return Topology("star", n, _dedupe((0, i) for i in range(1, n)))


def full(n: int) -> Topology:
    return Topology("full", n, _dedupe((i, j) for i in range(n)
                                       for j in range(i + 1, n)))


def make_topology(kind: str, n: int, *, degree: int = 0,
                  seed: int = 0) -> Topology:
    """Registry constructor — the string surface the Scenario/CLI use.
    ``degree`` is only meaningful for ``random`` (0 = default 3, clamped to
    n-1; bumped by one when n*degree is odd so a matching exists)."""
    if n < 1:
        raise ValueError("need at least one cluster")
    if kind == "ring":
        return ring(n)
    if kind == "torus":
        return torus(n)
    if kind == "random":
        k = degree or min(3, n - 1)
        if (n * k) % 2:
            k = k + 1 if k + 1 <= n - 1 else k - 1
        return random_regular(n, k, seed)
    if kind == "star":
        return star(n)
    if kind == "full":
        return full(n)
    raise ValueError(f"unknown topology kind {kind!r} (choices: {KINDS})")
