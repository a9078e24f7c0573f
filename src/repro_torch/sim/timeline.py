"""Event-timeline output of the simulator (port of ``repro.sim.timeline``).

One ``RoundEvent`` per outer round records who participated and where the
time went (compute vs total vs *exposed* comm — the §2.3 overlap means
exposed can be zero while the wire is busy).  ``Timeline`` aggregates to
effective throughput and provides a stable ``fingerprint()`` so tests can
assert determinism ("same seed => identical timeline") as an equality on
one string.

Everything but ``tree_hash`` is a copy of the JAX module, so a timeline
built from the same events serializes and hashes to the same strings in
both packages.  ``tree_hash`` takes PyTorch tensors (on any device) and
gives the digest the JAX package's ``tree_hash`` gives for the same bits.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# the header ``np.asarray`` of a JAX bfloat16 array carries: ml_dtypes'
# bfloat16 is a 2-byte void type to numpy (``dtype.str == '<V2'``)
_BF16_DTYPE_STR = "<V2"


def _leaf_header_and_data(node) -> Tuple[str, Tuple[int, ...], np.ndarray]:
    """(numpy dtype string, shape, C-contiguous host array of the raw bytes)
    of one leaf, as the JAX package's ``np.asarray(leaf)`` sees it."""
    if isinstance(node, torch.Tensor):
        t = node.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return (_BF16_DTYPE_STR, tuple(int(s) for s in t.shape),
                    t.view(torch.int16).numpy())
        a = t.numpy()
        return a.dtype.str, a.shape, a
    a = np.asarray(node)
    return a.dtype.str, a.shape, np.ascontiguousarray(a)


def tree_hash(tree: Any) -> str:
    """Canonical sha256 of a tree of tensors: dicts by sorted key,
    lists/tuples (incl. NamedTuples) positionally; each leaf contributes its
    dtype, shape, and raw bytes.  The digest is the JAX package's
    ``tree_hash`` of the same values: the header is the numpy dtype string
    (``'<f4'``, ``'<i4'``; a bf16 leaf ``'<V2'``, as ml_dtypes' bfloat16
    reads to numpy, with its raw 2-byte payload) and the numpy shape tuple.
    CUDA tensors are copied to the host first."""
    h = hashlib.sha256()

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            dtype_str, shape, data = _leaf_header_and_data(node)
            h.update(f"{prefix}:{dtype_str}:{shape}".encode())
            h.update(data)          # the buffer itself: no bytes copy

    walk("", tree)
    return h.hexdigest()


def combine_row_hashes(pairs) -> str:
    """One digest over per-cluster ``(cluster_id, tree_hash)`` pairs — the
    gossip-mode equivalent of a single ``param_hash``: per-cluster outer
    params legitimately differ, so the round's currency is the multiset of
    row hashes.  The proc coordinator combines hashes reported by workers;
    the in-process simulator combines hashes of the stacked rows — equality
    of the combined digest is equality of every participating replica."""
    blob = "|".join(f"{int(c)}:{h}" for c, h in sorted(pairs))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


@dataclass(frozen=True)
class RoundEvent:
    round: int
    alive: Tuple[int, ...]             # participating cluster ids
    rejoined: Tuple[int, ...]          # ids whose buffers were reset
    h_steps: int
    rank: Optional[int]                # compressor rank r_t (None: n/a)
    t_compute_s: float                 # H * slowest alive cluster's step
    t_comm_s: float                    # full wire time of the outer sync
    exposed_comm_s: float              # comm not hidden behind compute
    t_round_s: float                   # t_compute + exposed
    wire_bytes: int
    slowest_cluster: int               # argmax local step time (-1: none)
    bottleneck_cluster: int            # argmin link bandwidth (-1: none)
    tokens: float                      # tokens trained this round
    faults: Tuple[str, ...] = ()
    loss: Optional[float] = None       # numeric mode only
    param_hash: Optional[str] = None   # tree_hash of global params after the
                                       # round (numeric mode; the proc/
                                       # in-process equivalence currency —
                                       # gossip mode: combine_row_hashes
                                       # over the alive replicas)
    wire_bytes_total: int = 0          # bytes crossing ALL links this round
                                       # (gossip: sum of neighbor sends;
                                       # gather: ring all-gather total)
    disagreement: Optional[float] = None   # gossip numeric mode: RMS
                                       # distance of per-cluster outer
                                       # params from their alive mean
    ranks: Optional[Tuple[int, ...]] = None   # per-cluster SEND ranks under
                                       # gossip adaptive compression (id
                                       # order over the alive set): a
                                       # degraded uplink's edges carry a
                                       # lower rank than healthy ones
    h_by: Optional[Tuple[int, ...]] = None    # per-cluster executed local
                                       # steps (alive-id order) when an
                                       # ``HSpec`` policy is active;
                                       # ``h_steps`` stays the round's
                                       # budget H (what "global" runs)
    t_compute_by: Optional[Tuple[float, ...]] = None  # per-cluster compute
                                       # seconds (alive-id order): modeled
                                       # h_c*t_step_c in-process, measured
                                       # wall clock on the proc backend
    idle_by: Optional[Tuple[float, ...]] = None       # per-cluster barrier
                                       # wait (t_compute_s - own compute) —
                                       # the straggler waste the balance
                                       # H-policy shrinks
    spans: Optional[Tuple[Tuple[str, int, float, float], ...]] = None
                                       # per-round phase spans for the
                                       # trace exporter (obs/trace.py):
                                       # (name, cluster, start_s, dur_s)
                                       # relative to round start — modeled
                                       # in-process, measured wall clock on
                                       # proc (cluster -1 = coordinator).
                                       # Telemetry only: deliberately NOT
                                       # in STRUCTURAL_FIELDS (proc spans
                                       # carry wall clock)
    cluster: Optional[int] = None      # bounded-stale async mode: the one
                                       # cluster that committed this outer
                                       # step (None = barrier round, where
                                       # every alive cluster commits)
    staleness: Optional[Tuple[Tuple[int, int], ...]] = None
                                       # async mode: (peer, rounds_stale)
                                       # for every delta incorporated in
                                       # this commit (self always 0); the
                                       # engine guarantees every entry is
                                       # <= max_staleness
    round_clock: Optional[Tuple[int, ...]] = None
                                       # async mode: per-cluster committed-
                                       # leg counters after this event —
                                       # the fleet's logical clock vector
                                       # (-1 = never committed)
    t_start_s: Optional[float] = None  # async mode: global modeled clock
                                       # at this leg's start.  Async events
                                       # overlap in global time, so the
                                       # timeline is laid out by t_start_s
                                       # instead of cumulative round sums
                                       # (telemetry; NOT structural)


@dataclass
class Timeline:
    scenario: Dict[str, Any]
    events: List[RoundEvent] = field(default_factory=list)

    # ---- aggregates -------------------------------------------------------
    @property
    def total_time_s(self) -> float:
        """Barrier mode: rounds are sequential, so total time is the sum.
        Bounded-stale async mode: commits overlap in global time (each
        event carries its ``t_start_s``), so total time is the makespan."""
        if any(e.t_start_s is not None for e in self.events):
            return max((e.t_start_s or 0.0) + e.t_round_s
                       for e in self.events)
        return sum(e.t_round_s for e in self.events)

    @property
    def total_tokens(self) -> float:
        return sum(e.tokens for e in self.events)

    @property
    def tokens_per_s(self) -> float:
        t = self.total_time_s
        return self.total_tokens / t if t > 0 else 0.0

    @property
    def total_wire_bytes(self) -> int:
        return sum(e.wire_bytes for e in self.events)

    @property
    def total_wire_bytes_on_links(self) -> int:
        """Sum of per-round all-link traffic (``wire_bytes_total``) — what
        the gossip-vs-gather benchmark compares."""
        return sum(e.wire_bytes_total for e in self.events)

    @property
    def exposed_comm_frac(self) -> float:
        t = self.total_time_s
        return (sum(e.exposed_comm_s for e in self.events) / t
                if t > 0 else 0.0)

    @property
    def total_hidden_comm_s(self) -> float:
        """Comm seconds overlapped behind compute (the §2.3 win):
        ``t_comm − exposed`` per round, clamped at 0 — proc measures the
        two independently, so noise can push exposed past t_comm."""
        return sum(max(0.0, e.t_comm_s - e.exposed_comm_s)
                   for e in self.events)

    @property
    def overlap_efficiency(self) -> float:
        """Fraction of all comm seconds hidden behind compute (1.0 when
        the wire was never busy — nothing needed hiding)."""
        comm = sum(e.t_comm_s for e in self.events)
        return self.total_hidden_comm_s / comm if comm > 0 else 1.0

    @property
    def total_barrier_idle_s(self) -> float:
        """Cluster-seconds burnt waiting at the end-of-round barrier,
        summed over rounds and clusters (``RoundEvent.idle_by``) — the
        straggler waste ``benchmarks/straggler_h.py`` compares across H
        policies."""
        return sum(sum(e.idle_by) for e in self.events
                   if e.idle_by is not None)

    @property
    def barrier_idle_frac(self) -> float:
        """Idle cluster-seconds as a fraction of all compute-side
        cluster-seconds (own compute + barrier wait)."""
        busy = sum(sum(e.t_compute_by) for e in self.events
                   if e.t_compute_by is not None)
        idle = self.total_barrier_idle_s
        return idle / (busy + idle) if busy + idle > 0 else 0.0

    def losses(self) -> List[float]:
        return [e.loss for e in self.events if e.loss is not None]

    # ---- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario,
            "summary": {
                "total_time_s": round(self.total_time_s, 6),
                "total_tokens": self.total_tokens,
                "tokens_per_s": round(self.tokens_per_s, 3),
                "total_wire_bytes": self.total_wire_bytes,
                "exposed_comm_frac": round(self.exposed_comm_frac, 6),
                "total_hidden_comm_s": round(self.total_hidden_comm_s, 6),
                "overlap_efficiency": round(self.overlap_efficiency, 6),
                "total_barrier_idle_s": round(self.total_barrier_idle_s, 6),
                "barrier_idle_frac": round(self.barrier_idle_frac, 6),
                "structural_fingerprint": self.structural_fingerprint(),
            },
            "events": [self._event_row(e) for e in self.events],
        }

    @classmethod
    def _event_row(cls, e: "RoundEvent") -> Dict[str, Any]:
        """One event as a dict, with never-set async fields omitted (see
        ``ASYNC_FIELDS``) — the single serialization used by both
        ``to_dict`` and ``fingerprint``."""
        return {k: v for k, v in asdict(e).items()
                if not (v is None and k in cls.ASYNC_FIELDS)}

    #: fields that only bounded-stale async events populate.  Omitted from
    #: serialization while None so that barrier timelines hash to the SAME
    #: fingerprints as before these fields existed (the bitwise guarantee
    #: the engine refactor preserves).
    ASYNC_FIELDS = ("cluster", "staleness", "round_clock", "t_start_s")

    def fingerprint(self) -> str:
        """Stable hash of the full event timeline (floats canonicalized to
        9 decimals).  Two runs are "identical" iff fingerprints match."""
        def canon(x):
            if isinstance(x, float):
                return round(x, 9)
            if isinstance(x, dict):
                return {k: canon(v) for k, v in sorted(x.items())}
            if isinstance(x, (list, tuple)):
                return [canon(v) for v in x]
            return x

        rows = [self._event_row(e) for e in self.events]
        blob = json.dumps(canon(rows), sort_keys=True).encode("utf-8")
        return hashlib.sha256(blob).hexdigest()

    STRUCTURAL_FIELDS = ("round", "alive", "rejoined", "h_steps", "h_by",
                         "rank", "ranks", "wire_bytes", "wire_bytes_total",
                         "faults", "param_hash",
                         # bounded-stale async rounds: the commit owner,
                         # the staleness of every incorporated delta, and
                         # the per-cluster round-clock vector are decision
                         # outputs of the event engine (no seconds), so
                         # they are part of the determinism currency the
                         # CI drift gate compares
                         "cluster", "staleness", "round_clock")

    def h_schedule(self) -> List[Any]:
        """Per-round executed local-step counts — the H-policy's decision
        trace, the analogue of ``rank_schedule()``.  Rounds scheduled by a
        per-cluster policy record the per-cluster list (``RoundEvent.h_by``,
        alive-id order); global rounds record the scalar budget."""
        return [list(e.h_by) if e.h_by is not None else e.h_steps
                for e in self.events]

    def rank_schedule(self) -> List[Any]:
        """Per-round executed compressor ranks — the adaptive controller's
        decision trace.  Feed it back to ``simulate(sc,
        rank_schedule=...)`` to replay an adaptive run's wire accounting in
        timing-only mode (no numeric problem, no controller).  Per-edge
        gossip rounds record the per-cluster send-rank list
        (``RoundEvent.ranks``, alive-id order) so the replay reproduces
        the per-edge payload sizes, not just the headline max."""
        return [list(e.ranks) if e.ranks is not None else e.rank
                for e in self.events]

    def structural_fingerprint(self) -> str:
        """Like ``fingerprint()`` but over the *stable* per-round fields only
        (participants, budgets, wire accounting, fault tags, param hashes) —
        no measured/modeled seconds.  A proc-backend run is wall-clock-noisy,
        yet two runs of the same scenario must produce the same structural
        fingerprint; CI fails on drift."""
        rows = []
        for e in self.events:
            row = [getattr(e, f) for f in self.STRUCTURAL_FIELDS]
            if e.cluster is None and e.staleness is None \
                    and e.round_clock is None:
                row = row[:-3]       # barrier event: pre-async row layout
            rows.append(row)
        blob = json.dumps(rows, sort_keys=True).encode("utf-8")
        return hashlib.sha256(blob).hexdigest()

    # ---- display ----------------------------------------------------------
    def table(self, max_rows: int = 0) -> str:
        hdr = (f"{'rnd':>4} {'alive':>10} {'H':>4} {'r_t':>5} "
               f"{'compute_s':>10} {'comm_s':>9} {'exposed_s':>10} "
               f"{'round_s':>9} {'wire_MB':>8} {'loss':>9}  faults")
        lines = [hdr, "-" * len(hdr)]
        events = self.events if not max_rows else self.events[:max_rows]
        for e in events:
            alive = (f"{len(e.alive)}/{self.scenario.get('n_clusters', '?')}")
            loss = "" if e.loss is None else f"{e.loss:9.4f}"
            lines.append(
                f"{e.round:>4} {alive:>10} {e.h_steps:>4} "
                f"{('-' if e.rank is None else e.rank):>5} "
                f"{e.t_compute_s:>10.3f} {e.t_comm_s:>9.3f} "
                f"{e.exposed_comm_s:>10.3f} {e.t_round_s:>9.3f} "
                f"{e.wire_bytes / 1e6:>8.2f} {loss:>9}  "
                f"{'; '.join(e.faults)}")
        if max_rows and len(self.events) > max_rows:
            lines.append(f"... ({len(self.events) - max_rows} more rounds)")
        lines.append(
            f"total {self.total_time_s:.2f}s  "
            f"{self.total_tokens:.0f} tokens  "
            f"{self.tokens_per_s:.1f} tok/s  "
            f"exposed-comm {100 * self.exposed_comm_frac:.1f}%  "
            f"overlap-eff {100 * self.overlap_efficiency:.1f}%")
        return "\n".join(lines)
