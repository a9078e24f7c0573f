"""Scenario description for the virtual decentralized cluster (port of
``repro.sim.scenario``; the same fields, checks and ``meta()``, so a
scenario describes the same run in both packages).

A ``Scenario`` is everything the simulator needs to replay a decentralized
training run deterministically: cluster count, round/local-step budget,
the link model, a fault schedule, and the compression method whose wire
bytes (core.compression accounting — the same accounting the paper's
Fig. 4 numbers come from) drive the comm times.

``adaptive`` stays a field (it enters ``meta()``), but the port has no
``AdaptiveSpec`` yet (ROADMAP A.14 item 3): ``simulate`` refuses a
scenario that sets it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import comm
from repro_torch.core.adaptive import HSpec
from repro_torch.sim.faults import FaultSchedule


@dataclass(frozen=True)
class LinkProfile:
    """Per-link WAN model.  ``jitter`` is the fractional sigma of the
    deterministic per-(round, cluster) lognormal-ish noise applied to both
    step time and bandwidth (0 = the paper's idealized constant link)."""
    bytes_per_s: float = comm.GBPS       # 1 Gbps, the paper's setting
    latency_s: float = 0.0               # per forwarding hop
    jitter: float = 0.0


def synthetic_shapes(n_params: float, n_mats: int = 8
                     ) -> Dict[str, Tuple[int, ...]]:
    """A stand-in parameter tree of ``n_mats`` square matrices totalling
    ~n_params elements, so compressor wire accounting (incl. the low-rank
    (m+n)*r arithmetic) behaves like a real model of that size without
    building one."""
    d = max(8, int(round((n_params / max(n_mats, 1)) ** 0.5)))
    return {f"w{i}": (d, d) for i in range(n_mats)}


@dataclass(frozen=True)
class Scenario:
    n_clusters: int = 4
    rounds: int = 20
    h_steps: int = 30                    # H local steps per outer round
    t_step_s: float = 1.0                # §2.4.1 baseline local step time
    tokens_per_step: int = 36_000        # global tokens per local step
    link: LinkProfile = field(default_factory=LinkProfile)
    faults: FaultSchedule = field(default_factory=FaultSchedule)

    # method knobs (the Fig. 4 / Table 1 axes)
    compressor: str = "diloco_x"
    compressor_kw: Dict[str, Any] = field(default_factory=dict)
    rank: Optional[int] = None           # wire-accounting rank r_t override

    # §2.4 adaptive compression: the JAX package's ``AdaptiveSpec`` (the
    # spectral/bandwidth/hybrid controller); None = fixed rank.  Not ported
    # yet (ROADMAP A.14 item 3): ``simulate`` refuses any other value.
    adaptive: Optional[Any] = None

    # heterogeneous local-step scheduling (``core.adaptive.HSpec``): None/
    # "global" runs the uniform h_steps budget everywhere (the paper's
    # setting); policy="balance" sets each cluster's H from its modeled
    # step time so all clusters land near the barrier together (slow
    # sites do fewer local steps), clamped under gossip by the mixing
    # matrix's spectral-gap certificate.  Applied by BOTH backends,
    # including the numeric leg (``core.diloco.masked_local_steps``).
    h_spec: Optional[HSpec] = None
    delay: bool = True                   # §2.3 one-step-delay overlap
    allreduce_per_step: bool = False     # vanilla-DDP/CocktailSGD style:
                                         # ring allreduce EVERY local step

    # outer-sync communication pattern (topology/): "star" is the
    # seed hub/gather, "full" the same average with all-to-all accounting,
    # "ring"/"torus"/"random" are neighbor-gossip mixing graphs
    topology: str = "star"
    topology_degree: int = 0             # random k-regular degree (0=auto)
    topology_seed: int = 0               # random topology edge seed
    # dynamic time-varying topology (NoLoCo-style fresh random partners):
    # a per-round seed schedule for the "random" kind — round r draws the
    # k-regular graph from seed schedule[r % len] instead of the fixed
    # topology_seed.  In-process backend only (proc raises).
    topology_seed_schedule: Optional[Tuple[int, ...]] = None

    # outer-sync policy (sim/engine.py): "barrier" is the lockstep round
    # loop (staleness bound 0 on a global clock); "bounded_stale" runs
    # SSP-style async rounds — each cluster commits an outer step the
    # moment its local leg finishes, gated so no incorporated delta is
    # more than max_staleness rounds older than its own clock.
    sync: str = "barrier"
    max_staleness: int = 1

    # bounded-stale aggregation: "mean" is the staleness-discounted
    # weighted mean (push-sum debiased); "trimmed_mean" drops the
    # coordinate-wise top/bottom trim_k candidate rows before averaging
    # (core.membership.trimmed_cluster_mean) — the robust defense against
    # a Byzantine cluster's corrupted deltas (bounded_stale only).
    aggregation: str = "mean"
    trim_k: int = 1

    # inner engine: "scalar" is the single-replica inner loop (quadratic/
    # trainer, clusters one after another); "pp" runs each cluster's H
    # local steps through the pipeline-parallel engine.  Timing-only
    # scenarios may declare either (the engine only changes the numeric
    # leg); numeric runs cross-check the declared engine against the
    # problem's ``engine`` tag (the pp problem, ``sim/pp_problem.py``, is
    # ROADMAP A.14 item 4).
    inner_engine: str = "scalar"

    # what is being shipped: explicit shapes win; else a synthetic tree
    param_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
    n_params: float = 1.0e9

    # initial membership (default: everyone alive)
    initial_alive: Optional[Tuple[bool, ...]] = None

    seed: int = 0

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        if self.param_shapes is not None:
            return dict(self.param_shapes)
        return synthetic_shapes(self.n_params)

    def topo(self, rnd: Optional[int] = None):
        """The ``repro_torch.topology.Topology`` this scenario communicates
        over (built fresh; Topology construction is deterministic).
        With a ``topology_seed_schedule``, ``rnd`` selects round ``rnd``'s
        fresh random graph (``rnd=None`` gives the base graph)."""
        from repro_torch.topology import make_topology
        seed = self.topology_seed
        if rnd is not None and self.topology_seed_schedule:
            seed = int(self.topology_seed_schedule[
                rnd % len(self.topology_seed_schedule)])
        return make_topology(self.topology, self.n_clusters,
                             degree=self.topology_degree, seed=seed)

    def __post_init__(self):
        if self.inner_engine not in ("scalar", "pp"):
            raise ValueError(
                f"inner_engine must be 'scalar' or 'pp', "
                f"got {self.inner_engine!r}")
        from repro_torch.sim.engine import SYNC_KINDS
        if self.sync not in SYNC_KINDS:
            raise ValueError(
                f"sync must be one of {SYNC_KINDS}, got {self.sync!r}")
        if self.aggregation not in ("mean", "trimmed_mean"):
            raise ValueError(
                f"aggregation must be 'mean' or 'trimmed_mean', "
                f"got {self.aggregation!r}")
        if self.sync == "bounded_stale":
            if self.max_staleness < 0:
                raise ValueError("max_staleness must be >= 0")
            if self.allreduce_per_step:
                raise ValueError("bounded_stale has no per-step allreduce "
                                 "(there is no global step barrier)")
            if self.adaptive is not None or self.h_spec is not None:
                raise ValueError(
                    "bounded_stale does not support adaptive compression "
                    "or H policies yet (the controllers assume a global "
                    "round clock)")
            if self.inner_engine != "scalar":
                raise ValueError("bounded_stale supports the scalar inner "
                                 "engine only")
        elif self.aggregation != "mean":
            raise ValueError("trimmed_mean aggregation is a bounded_stale "
                             "feature (barrier aggregation happens inside "
                             "the jitted round program)")
        if self.topology_seed_schedule is not None:
            if self.topology != "random":
                raise ValueError(
                    "topology_seed_schedule redraws the random k-regular "
                    f"graph per round; topology {self.topology!r} is fixed")
            if not self.topology_seed_schedule:
                raise ValueError("topology_seed_schedule must be non-empty")
            object.__setattr__(self, "topology_seed_schedule",
                               tuple(int(s)
                                     for s in self.topology_seed_schedule))

    @property
    def is_gossip(self) -> bool:
        from repro_torch.topology import GOSSIP_KINDS
        return self.topology in GOSSIP_KINDS

    def meta(self) -> Dict[str, Any]:
        """JSON-serializable scenario header for the Timeline."""
        return {
            "n_clusters": self.n_clusters,
            "rounds": self.rounds,
            "h_steps": self.h_steps,
            "t_step_s": self.t_step_s,
            "tokens_per_step": self.tokens_per_step,
            "link": {"bytes_per_s": self.link.bytes_per_s,
                     "latency_s": self.link.latency_s,
                     "jitter": self.link.jitter},
            "faults": [e.describe() if hasattr(e, "describe") else repr(e)
                       for e in self.faults.events],
            "compressor": self.compressor,
            "rank": self.rank,
            "adaptive": (None if self.adaptive is None
                         else self.adaptive.to_dict()),
            "h_spec": (None if self.h_spec is None
                       else self.h_spec.to_dict()),
            "delay": self.delay,
            "sync": self.sync,
            "max_staleness": self.max_staleness,
            "aggregation": self.aggregation,
            "trim_k": self.trim_k,
            "inner_engine": self.inner_engine,
            "allreduce_per_step": self.allreduce_per_step,
            "topology": self.topology,
            "topology_degree": self.topology_degree,
            "topology_seed": self.topology_seed,
            "topology_seed_schedule": (
                None if self.topology_seed_schedule is None
                else list(self.topology_seed_schedule)),
            "seed": self.seed,
        }
