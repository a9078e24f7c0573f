"""Decentralized communication model (paper §2.4.1 arithmetic; a copy of
``repro.core.comm``).

Reproduces the paper's throughput comparisons (Fig. 4, Table 1) from first
principles: wire bytes come from the actual parameter shapes + compressor
accounting (not hand-waved ratios), link speed is the paper's 1 Gbps, and
the local step time follows the paper's own assumption (§2.4.1: "the
duration of every local step is 1 second" for the 107B model; smaller
models scale by FLOPs).

Ring AllReduce moves 2(C-1)/C * bytes per link; the gather-based DiLoCoX
outer sync moves (C-1)/C * payload (DESIGN.md §3).

One-step-delay overlap (§2.3): communication of round t-1 hides behind the
H local steps of round t, so the exposed comm time per round is
max(0, T_comm - H * T_step) instead of T_comm.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

GBPS = 0.125e9          # 1 Gbps in bytes/s


@dataclass(frozen=True)
class CommScenario:
    n_clusters: int = 2
    link_bytes_per_s: float = GBPS
    t_step_s: float = 1.0          # local step time (paper §2.4.1)
    tokens_per_step: int = 4_194_304   # global batch x seq (e.g. 1024x4096)


def ring_allreduce_time(bytes_total: float, sc: CommScenario) -> float:
    c = sc.n_clusters
    return 2 * (c - 1) / c * bytes_total / sc.link_bytes_per_s


def gather_time(payload_bytes: float, sc: CommScenario) -> float:
    """Ring all-gather of a per-cluster payload: C-1 forwarding steps of
    payload-sized pieces per member."""
    c = sc.n_clusters
    return (c - 1) * payload_bytes / sc.link_bytes_per_s


@dataclass
class MethodThroughput:
    name: str
    tokens_per_s: float
    t_round_s: float
    comm_s_per_round: float
    exposed_comm_s: float
    wire_bytes: float


def method_throughput(name: str, *, param_bytes_fp32: float,
                      wire_bytes: float, h_steps: int, overlap: bool,
                      sc: CommScenario, allreduce_per_step: bool = False
                      ) -> MethodThroughput:
    """Throughput of one method.

    allreduce_per_step: vanilla AllReduce / CocktailSGD style — communicate
    every step (wire_bytes is the per-step payload). Otherwise local-SGD
    style: H local steps then one pseudo-gradient sync of wire_bytes.
    """
    if allreduce_per_step:
        comm = ring_allreduce_time(wire_bytes, sc)
        t_round = sc.t_step_s + comm       # no overlap in vanilla DDP
        tokens = sc.tokens_per_step
        return MethodThroughput(name, tokens / t_round, t_round, comm, comm,
                                wire_bytes)
    comm = gather_time(wire_bytes, sc)
    compute = h_steps * sc.t_step_s
    exposed = max(0.0, comm - compute) if overlap else comm
    t_round = compute + exposed
    tokens = sc.tokens_per_step * h_steps
    return MethodThroughput(name, tokens / t_round, t_round, comm, exposed,
                            wire_bytes)
