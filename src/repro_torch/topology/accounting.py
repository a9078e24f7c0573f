"""Wire/time accounting for the outer sync under a topology (a copy of
``repro.topology.accounting``).

One function pair that every model of a round's wire and time calls (the
JAX package's simulator and proc coordinator share it verbatim), so the
structural fields (bottleneck cluster, total bytes) come from one place.

Gather kinds keep the seed repo's arithmetic (ring all-gather charge of
``(n_alive-1) * payload`` per member over the bottleneck link).  Gossip
kinds charge each cluster ``deg * payload`` on its *own* (possibly
degraded) uplink — sends to each neighbor are serialized on that link —
and the round's comm time is the slowest cluster's exchange.

All numpy/python.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.topology.graphs import Topology


@dataclass(frozen=True)
class ComputeLeg:
    """One round's compute side of the barrier, per cluster.

    ``t_by[c]`` is cluster c's own local-training seconds
    (``h_c * t_step_c``), ``t_barrier_s`` the round's compute leg (the
    slowest alive cluster — everyone waits at the outer sync), and
    ``idle_by[c]`` the barrier wait each cluster burns
    (``t_barrier_s - t_by[c]``) — the waste the heterogeneous-H scheduler
    exists to shrink.
    """
    t_barrier_s: float
    slowest_cluster: int               # argmax own compute time (-1: none)
    t_by: Dict[int, float]             # cluster -> own compute seconds
    idle_by: Dict[int, float]          # cluster -> barrier wait seconds


def compute_leg(h_by: Dict[int, int], t_steps: Sequence[float],
                alive: np.ndarray) -> ComputeLeg:
    """Per-round compute/barrier accounting for a (possibly per-cluster)
    local-step schedule ``h_by`` (``core.adaptive.plan_h`` output) over the
    alive set.  One implementation shared by the in-process simulator and
    the proc coordinator — the modeled compute targets, barrier time, and
    the ``slowest_cluster`` structural field can never drift between the
    backends.  Deterministic tie-break: first alive cluster with the max
    time wins (ascending-id ``max``, both backends)."""
    alive = np.asarray(alive, bool)
    ids = [int(i) for i in np.flatnonzero(alive)]
    if not ids:
        return ComputeLeg(0.0, -1, {}, {})
    t_by = {c: float(int(h_by[c]) * float(t_steps[c])) for c in ids}
    slowest = max(ids, key=lambda c: (t_by[c], -c))
    barrier = t_by[slowest]
    idle_by = {c: barrier - t_by[c] for c in ids}
    return ComputeLeg(barrier, int(slowest), t_by, idle_by)


@dataclass(frozen=True)
class GossipComm:
    t_comm_s: float                    # slowest cluster's neighbor exchange
    bottleneck_cluster: int            # argmax per-cluster comm time (-1)
    wire_bytes_total: int              # sum over links, both directions
    sends: Dict[int, int]              # cluster -> payloads it ships


def gossip_round_comm(topo: Topology, alive: np.ndarray, wire_bytes: int,
                      bws: Sequence[float], latency_s: float,
                      wire_by_cluster: Optional[Dict[int, int]] = None
                      ) -> GossipComm:
    """Per-round comm accounting for a gossip topology.

    ``bws`` is the per-cluster bandwidth *after* fault degradation/jitter
    (index = cluster id, dead entries ignored).  ``wire_by_cluster`` is the
    per-EDGE variant: cluster c ships ``wire_by_cluster[c]`` bytes per
    neighbor (the bandwidth-aware controller compresses a degraded uplink's
    edges harder); omitted, every sender ships ``wire_bytes``.
    Deterministic tie-break: first alive cluster with the max time wins,
    matching Python ``max`` over ascending ids on both backends.
    """
    alive = np.asarray(alive, bool)
    alive_ids = [int(i) for i in np.flatnonzero(alive)]
    w_of = (lambda c: int(wire_by_cluster[c])) if wire_by_cluster is not None \
        else (lambda c: int(wire_bytes))
    sends = {c: len(topo.alive_neighbors(c, alive)) for c in alive_ids}
    total = sum(sends[c] * w_of(c) for c in alive_ids)
    busy = [c for c in alive_ids if sends[c]]
    if not busy:
        return GossipComm(0.0, -1, 0, sends)
    t_of = lambda c: (sends[c] * w_of(c) / float(bws[c])
                      + sends[c] * latency_s)
    bottleneck = max(busy, key=lambda c: (t_of(c), -c))
    return GossipComm(float(t_of(bottleneck)), int(bottleneck), int(total),
                      sends)


def round_wire_total(mode: str, n_alive: int, wire_bytes: int,
                     h_steps: int = 1) -> int:
    """Total bytes crossing all links in one round for the non-gossip
    modes (gossip comes from ``gossip_round_comm``):

     - ``gather``: ring all-gather, every member forwards (n-1) payloads;
     - ``allreduce``: per-local-step ring allreduce, 2(n-1)/n * payload
       per member per step.
    """
    if n_alive < 2:
        return 0
    if mode == "gather":
        return n_alive * (n_alive - 1) * wire_bytes
    if mode == "allreduce":
        return int(h_steps * 2 * (n_alive - 1) * wire_bytes)
    raise ValueError(f"unknown wire mode {mode!r}")
