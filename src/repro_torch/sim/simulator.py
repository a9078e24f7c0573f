"""Deterministic virtual decentralized-cluster simulator (port of
``repro.sim.simulator``).

``simulate(scenario)`` replays ``scenario.rounds`` outer rounds of the
DiLoCoX loop over N virtual clusters and returns an event ``Timeline``:

 - **timing**: per-round compute time (H x the *slowest* alive cluster's
   step — the outer sync is a barrier), wire time of the outer collective
   from ``core.comm``'s analytic arithmetic over the *bottleneck* link,
   and the §2.3 overlap rule ``exposed = max(0, T_comm - H*T_step)``;
 - **faults** (``sim.faults``): stragglers inflate a cluster's step time,
   link degradation shrinks bandwidth, Leave/Join drive the
   ``core.membership`` mask semantics (mask-weighted outer mean, buffer
   reset on rejoin);
 - **numerics** (optional): pass ``numeric=make_quadratic_problem(...)``
   (or any ``NumericProblem``) and each simulated round *actually runs*
   ``core.diloco.diloco_round`` — compression, error feedback, one-step
   delay, masked cluster mean — recording the realized loss per round.

``sync="bounded_stale"`` runs SSP-style asynchronous rounds instead
(``sim.engine.BoundedStaleEngine``): one event per committed outer step
of one cluster, each cluster on its own round clock, with the numeric
executor ``_AsyncNumeric`` (published deltas in a versioned store,
Byzantine corruption of what a cluster publishes, the staleness-weighted
mean or the trimmed mean).

All randomness (link/step jitter) is drawn from ``numpy`` generators
seeded by ``(scenario.seed, round)``, and the timing arithmetic is the JAX
package's host code, so a timing-only run gives the JAX package's
timeline, fingerprints included.  The numeric leg runs eagerly on the
problem's device (CUDA unless the problem was built with ``device="cpu"``);
its ``param_hash`` is deterministic within the port (same scenario, same
hash) but not JAX's: the JAX package jits its round and XLA sums and
contracts in other orders.

The round writes its state in place (``core.diloco``): ``simulate`` takes
ownership of the ``NumericProblem``'s tensors, so build a fresh problem for
each run.  ``timeline.wall`` holds host seconds (synchronized with the
device): for each barrier round the whole round, the numeric leg and the
``tree_hash``; for each bounded-stale commit its publish leg, the commit,
the ``tree_hash`` and the disagreement.

Not ported yet, and refused with its ROADMAP item: the adaptive controller
(``Scenario.adaptive`` / ``adaptive_cfg``, A.14 item 3).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import comm, diloco, membership
from repro_torch.core.adaptive import plan_h
from repro_torch.core.compression import make_compressor
from repro_torch.optim import nesterov
from repro_torch.sim.engine import BoundedStaleEngine, run_barrier
from repro_torch.sim.faults import Byzantine
from repro_torch.sim.scenario import Scenario
from repro_torch.sim.timeline import (RoundEvent, Timeline, combine_row_hashes,
                                      tree_hash)
from repro_torch.topology import (MixingMatrix, async_mix_weights,
                                  compute_leg, gossip_round_comm,
                                  round_wire_total)
from repro_torch.topology import mixing as topo_mixing


# ---------------------------------------------------------------------------
# optional numeric problem (runs the real diloco_round per simulated round)
# ---------------------------------------------------------------------------

@dataclass
class NumericProblem:
    params: Any                      # initial global params
    inner_opt_stacked: Any           # per-cluster inner optimizer states
    inner_fn: Callable               # diloco inner_fn(params, opt, t)
    outer_lr: float = 0.7
    outer_momentum: float = 0.5
    compress: bool = True
    error_feedback: bool = True
    eval_fn: Optional[Callable] = None   # params -> scalar loss (recorded)
    inner_fn_stacked: Optional[Callable] = None  # gossip mode: like
                                     # inner_fn but params carry a
                                     # (n_clusters, ...) leading axis
                                     # (each cluster trains from its OWN
                                     # outer params)
    inner_fn_h: Optional[Callable] = None        # per-cluster-H variant:
                                     # inner_fn(params, opt, t, h_vec)
                                     # where h_vec is a (n_clusters,)
                                     # int32 local-step schedule (aux =
                                     # per-cluster mean loss)
    inner_fn_h_stacked: Optional[Callable] = None  # gossip x per-cluster H
    engine: str = "scalar"           # which inner engine built the fns:
                                     # "scalar" (single-replica) or "pp"
                                     # (pipeline-parallel); cross-checked
                                     # against Scenario.inner_engine
    inner_fn_row: Optional[Callable] = None      # bounded-stale async mode:
                                     # ONE cluster's H-step inner program
                                     # (params_row, opt_row, cluster) ->
                                     # (params_H, opt', losses); read by
                                     # the bounded-stale executor


def make_quadratic_problem(n_clusters: int, **kw) -> NumericProblem:
    """Tiny per-cluster least-squares problem (see ``sim.quadratic``)."""
    from repro_torch.sim.quadratic import make_quadratic_problem as _mk
    return _mk(n_clusters, **kw)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

def _jitter_factors(seed: int, rnd: int, n: int, sigma: float, salt: int
                    ) -> np.ndarray:
    """Deterministic positive per-(round, cluster) noise: exp(sigma * z)
    with z ~ N(0,1) from a generator seeded by (seed, salt, round)."""
    if sigma <= 0:
        return np.ones(n)
    rng = np.random.default_rng([seed, salt, rnd])
    return np.exp(sigma * rng.standard_normal(n))


def _sync(device) -> float:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _row_mask(mask: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    m = torch.as_tensor(np.asarray(mask, bool), device=x.device)
    return m.reshape((-1,) + (1,) * (x.dim() - 1))


@torch.no_grad()
def _reset_buffers(st, mask: np.ndarray) -> None:
    """Zero per-cluster pending-delta/error rows of masked clusters in
    place (dead sites neither train nor accumulate error)."""
    membership.reset_rejoining(st.delta_pending, mask)
    membership.reset_rejoining(st.error, mask)


@torch.no_grad()
def _reset_rejoined(st, mask: np.ndarray, comp0) -> None:
    """A rejoining cluster is a *fresh worker*: pending/error zeroed,
    inner-optimizer moments and step zeroed (== adamw.init), and the
    compressor warm start RE-INITIALIZED to its deterministic init value —
    never zeroed, a zero Q bricks PowerSGD (P = M @ 0 forever).  In place;
    each rejoined row of the warm start is a copy of ``comp0``."""
    _reset_buffers(st, mask)
    rows = [int(c) for c in np.flatnonzero(mask)]

    def inner(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            x.masked_fill_(_row_mask(mask, x), 0)

    def comp(x, x0):
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            for c in rows:
                x[c].copy_(x0.to(x.dtype))

    T.tree_map(inner, st.inner_opt)
    T.tree_map(comp, st.comp_state, comp0)


@torch.no_grad()
def _consensus_bootstrap(st, rejoined: np.ndarray, alive_prev: np.ndarray):
    """Gossip-mode rejoin: there is no single global replica to copy, so a
    rejoiner restarts from the masked MEAN of the surviving clusters'
    (params, outer momentum): zero-masked rows through
    ``masked_cluster_mean``.  Both means are taken from the survivors'
    rows before any rejoined row is written."""
    m_prev = alive_prev.astype(np.float32)
    rows = [int(c) for c in np.flatnonzero(rejoined)]

    def mean_rows(tree):
        zeroed = T.tree_map(
            lambda x: torch.where(_row_mask(m_prev > 0, x), x,
                                  torch.zeros_like(x)), tree)
        return membership.masked_cluster_mean(zeroed, m_prev)

    mp = mean_rows(st.params)
    mv = mean_rows(st.outer_opt.momentum)

    def put(x, m):
        for c in rows:
            x[c].copy_(m.to(x.dtype))

    T.tree_map(put, st.params, mp)
    T.tree_map(put, st.outer_opt.momentum, mv)


def _host_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def simulate(sc: Scenario, numeric: Optional[NumericProblem] = None,
             adaptive_cfg: Optional[Any] = None,
             rank_schedule: Optional[Any] = None) -> Timeline:
    """Run the scenario; returns the event Timeline.

    ``rank_schedule`` = a recorded per-round rank list (e.g. a previous
    adaptive run's ``Timeline.rank_schedule()``): replayed verbatim for
    the wire accounting, timing-only or numeric.  Entries are scalars, or
    per-alive-cluster send-rank lists for per-edge gossip rounds (requires
    the recording run's fault schedule, so the alive sets line up).

    The adaptive controller (``sc.adaptive`` / ``adaptive_cfg``) is
    ROADMAP A.14 item 3 and raises.
    """
    if sc.sync == "bounded_stale":
        if adaptive_cfg is not None or rank_schedule is not None:
            raise ValueError(
                "sync='bounded_stale' has no global round clock for the "
                "adaptive controller / a recorded rank schedule to index; "
                "run them under sync='barrier'")
        return _simulate_bounded_stale(sc, numeric)
    if any(isinstance(e, Byzantine) for e in sc.faults.events):
        raise ValueError(
            "Byzantine faults model corrupt *published* deltas, which only "
            "exist under sync='bounded_stale' (the barrier round mixes "
            "inside one jitted program with no publish step to corrupt)")
    if rank_schedule is None and (adaptive_cfg is not None
                                  or sc.adaptive is not None):
        raise NotImplementedError(
            "adaptive compression in the simulator (Scenario.adaptive, an "
            "AdaptiveSpec, or the legacy adaptive_cfg=AdaGradCmpConfig) "
            "needs AdaptiveController, which is not ported yet: ROADMAP "
            "A.14 item 3; replay a recorded rank_schedule instead")

    C = sc.n_clusters
    shapes = sc.shapes()
    compressor = make_compressor(sc.compressor, **sc.compressor_kw)
    alive = (np.ones(C, bool) if sc.initial_alive is None
             else np.asarray(sc.initial_alive, bool).copy())
    if alive.shape != (C,):
        raise ValueError(f"initial_alive must have shape ({C},)")

    topo = sc.topo()
    gossip = topo.is_gossip
    if gossip and sc.allreduce_per_step:
        raise ValueError("allreduce_per_step models the per-step DDP "
                         "baseline; gossip topologies sync per round only")
    h_active = sc.h_spec is not None and sc.h_spec.active
    if h_active and sc.allreduce_per_step:
        raise ValueError("allreduce_per_step has no outer-round barrier to "
                         "balance; h_spec needs the DiLoCo round structure")

    # dynamic time-varying topology: a fresh random graph (and mixing
    # matrix) per round, cached by seed — round r communicates over
    # sc.topo(r)
    _topo_cache: Dict[int, Any] = {}

    def topo_at(rnd: int):
        if sc.topology_seed_schedule is None:
            return topo
        key = rnd % len(sc.topology_seed_schedule)
        if key not in _topo_cache:
            _topo_cache[key] = sc.topo(rnd)
        return _topo_cache[key]

    _mm_cache: Dict[int, MixingMatrix] = {}

    def mm_at(rnd: int, topo_r) -> Optional[MixingMatrix]:
        if not gossip:
            return None
        if sc.topology_seed_schedule is None:
            key = -1
        else:
            key = rnd % len(sc.topology_seed_schedule)
        if key not in _mm_cache:
            _mm_cache[key] = MixingMatrix.metropolis(topo_r)
        return _mm_cache[key]

    # --- numeric state (real diloco rounds) --------------------------------
    num = None
    device = None
    if numeric is not None:
        engine = getattr(numeric, "engine", "scalar")
        if engine != sc.inner_engine:
            raise ValueError(
                f"Scenario.inner_engine={sc.inner_engine!r} but the "
                f"NumericProblem was built for engine {engine!r} "
                "(PPSpec.problem() tags engine='pp'; quadratic/trainer "
                "problems are 'scalar')")
        if engine == "pp" and gossip:
            raise ValueError(
                "inner_engine='pp' supports gather topologies only: the "
                "gossip leg needs a stacked inner_fn, and stacking C "
                "pipeline meshes in one program would compile a different "
                "(non-bitwise) computation than a lone pp worker")

        device = T.leaves(numeric.params)[0].device
        rcfg = diloco.RoundConfig(
            outer_lr=numeric.outer_lr, outer_momentum=numeric.outer_momentum,
            delay=sc.delay, compress=numeric.compress,
            error_feedback=numeric.error_feedback)

        if gossip:
            if numeric.inner_fn_stacked is None:
                raise ValueError(
                    f"topology {sc.topology!r} needs a stacked inner_fn "
                    "(each cluster trains from its own outer params); the "
                    "NumericProblem provides no inner_fn_stacked")
            if h_active and numeric.inner_fn_h_stacked is None:
                raise ValueError(
                    f"h policy {sc.h_spec.policy!r} needs a per-cluster-H "
                    "stacked inner_fn (masked scan); the NumericProblem "
                    "provides no inner_fn_h_stacked")
            state = diloco.init_state(
                diloco.stack_replicas(numeric.params, C),
                numeric.inner_opt_stacked, C, compressor,
                stacked_params=True)

            def _mix(W):
                mix = lambda tree: topo_mixing.mix_stacked(W, tree)
                mix.returns_stacked = True
                return mix

            def _round(st, rank_scalar, W):
                return diloco.diloco_round(st, numeric.inner_fn_stacked,
                                           compressor, _mix(W), rcfg,
                                           rank_scalar)

            def _round_h(st, rank_scalar, W, h_vec):
                return diloco.diloco_round_h(
                    st, numeric.inner_fn_h_stacked, compressor, _mix(W),
                    rcfg, h_vec, rank_scalar)
        else:
            if h_active and numeric.inner_fn_h is None:
                raise ValueError(
                    f"h policy {sc.h_spec.policy!r} needs a per-cluster-H "
                    "inner_fn (masked scan); the NumericProblem provides "
                    "no inner_fn_h")
            state = diloco.init_state(numeric.params,
                                      numeric.inner_opt_stacked,
                                      C, compressor)

            def _mean(alive_vec):
                return lambda tree: membership.masked_cluster_mean(
                    tree, alive_vec)

            def _round(st, rank_scalar, alive_vec):
                return diloco.diloco_round(st, numeric.inner_fn,
                                           compressor, _mean(alive_vec),
                                           rcfg, rank_scalar)

            def _round_h(st, rank_scalar, alive_vec, h_vec):
                return diloco.diloco_round_h(st, numeric.inner_fn_h,
                                             compressor, _mean(alive_vec),
                                             rcfg, h_vec, rank_scalar)

        # NOTE on the two round programs: a round whose planned schedule is
        # uniform at the budget H runs the SCALAR program and only
        # genuinely heterogeneous rounds run ``diloco_round_h``.  The
        # dispatch is host-side on the planned h_map, as in the JAX
        # package, so a uniform balance run is bit for bit the global one.
        comp0 = T.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            compressor.init_state(numeric.params))
        num = {"state": state, "round": _round,
               "round_h": (_round_h if h_active else None), "comp0": comp0}

    schedule = None
    if rank_schedule is not None:
        if adaptive_cfg is not None or sc.adaptive is not None:
            raise ValueError("rank_schedule replays a recorded adaptive "
                             "run; drop adaptive_cfg / Scenario.adaptive")

        def _norm(x):
            if x is None:
                return None
            if isinstance(x, (list, tuple)):   # per-edge gossip round
                return [int(v) for v in x]
            return int(x)

        schedule = [_norm(x) for x in rank_schedule]
        if len(schedule) < sc.rounds:
            raise ValueError(f"rank_schedule has {len(schedule)} entries "
                             f"for {sc.rounds} rounds")

    events = []
    wall = []

    def _barrier_round(r: int) -> None:
        nonlocal alive
        t_round0 = time.perf_counter()
        alive, rejoined = sc.faults.membership(r, alive)
        alive_ids = tuple(int(i) for i in np.flatnonzero(alive))
        n_alive = len(alive_ids)
        topo_r = topo_at(r)
        mm_r = mm_at(r, topo_r)

        h_t = sc.h_steps

        # ---- compute leg: barrier on the slowest alive cluster -----------
        step_j = _jitter_factors(sc.seed, r, C, sc.link.jitter, salt=1)
        t_steps = np.array([sc.t_step_s * sc.faults.step_multiplier(c, r)
                            * step_j[c] for c in range(C)])
        # per-cluster local-step schedule: slow sites do fewer steps so the
        # barrier tightens; under gossip the spread is clamped by the
        # masked mixing matrix's spectral-gap certificate
        gap = (mm_r.masked(alive).spectral_gap(alive)
               if (gossip and h_active and n_alive) else None)
        h_map = plan_h(sc.h_spec, h_t, t_steps, alive, spectral_gap=gap)
        leg = compute_leg(h_map, t_steps, alive)
        slowest, t_compute = leg.slowest_cluster, leg.t_barrier_s

        # ---- link state (modeled per-cluster bandwidths) -----------------
        bw_j = _jitter_factors(sc.seed, r, C, sc.link.jitter, salt=2)
        bws = np.array([sc.link.bytes_per_s * sc.faults.bandwidth_factor(c, r)
                        * bw_j[c] for c in range(C)])

        # ---- rank: the scenario's, or a recorded schedule's entry --------
        rank_t = sc.rank
        ranks_map = None
        if schedule is not None:
            entry = schedule[r]
            if isinstance(entry, list):        # recorded per-edge ranks
                if not gossip:
                    raise ValueError(
                        f"rank_schedule round {r} is a per-edge list but "
                        f"topology {sc.topology!r} is not gossip")
                if len(entry) != n_alive:
                    raise ValueError(
                        f"rank_schedule round {r} has {len(entry)} send "
                        f"ranks for {n_alive} alive clusters (replay needs "
                        "the recording run's fault schedule)")
                ranks_map = dict(zip(alive_ids, entry))
                rank_t = max(entry) if entry else sc.rank
            else:
                rank_t = entry
        ranks_tuple = (tuple(ranks_map[c] for c in alive_ids)
                       if ranks_map is not None else None)

        # ---- comm leg: analytic collective over the bottleneck link ------
        wire = int(compressor.wire_bytes(shapes, rank=rank_t))
        if gossip:
            # neighbor exchange: each cluster ships its payload to every
            # alive graph neighbor over its own (serialized) uplink;
            # per-edge ranks give each sender its own payload size
            wire_by = (compressor.wire_bytes_per_edge(shapes, ranks_map)
                       if ranks_map is not None else None)
            gc = gossip_round_comm(topo_r, alive, wire, bws,
                                   sc.link.latency_s,
                                   wire_by_cluster=wire_by)
            t_comm, bottleneck = gc.t_comm_s, gc.bottleneck_cluster
            wire_total = gc.wire_bytes_total
            exposed = (max(0.0, t_comm - t_compute) if sc.delay else t_comm)
        elif n_alive >= 2:
            bottleneck = int(min(alive_ids, key=lambda c: bws[c]))
            bw = float(bws[bottleneck])
            csub = comm.CommScenario(n_clusters=n_alive, link_bytes_per_s=bw,
                                     t_step_s=sc.t_step_s)
            if sc.allreduce_per_step:
                per_step = (comm.ring_allreduce_time(wire, csub)
                            + 2 * (n_alive - 1) * sc.link.latency_s)
                t_comm = h_t * per_step
                exposed = t_comm                   # no overlap in DDP style
                wire_total = round_wire_total("allreduce", n_alive, wire,
                                              h_t)
            else:
                t_comm = (comm.gather_time(wire, csub)
                          + (n_alive - 1) * sc.link.latency_s)
                exposed = (max(0.0, t_comm - t_compute) if sc.delay
                           else t_comm)
                wire_total = round_wire_total("gather", n_alive, wire)
        else:
            bottleneck, t_comm, exposed, wire_total = -1, 0.0, 0.0, 0

        t_round = t_compute + exposed
        tokens = sc.tokens_per_step * sum(h_map.values()) / max(C, 1)

        # ---- numeric leg: one REAL diloco round over the alive set -------
        loss = None
        param_hash = None
        disagreement = None
        numeric_s = hash_s = 0.0
        if num is not None:
            t0 = _sync(device)
            st = num["state"]
            if rejoined.any():
                _reset_rejoined(st, rejoined, num["comp0"])
                if gossip:
                    _consensus_bootstrap(st, rejoined, alive & ~rejoined)
            if ranks_map is not None:
                # per-EDGE gossip ranks: one send rank per cluster row
                # (dead rows compress zeros — any rank; use the round max)
                rank_arg = [int(rank_t)] * C
                for c, rv in ranks_map.items():
                    rank_arg[c] = int(rv)
            else:
                rank_arg = None if rank_t is None else int(rank_t)
            het_round = h_active and any(h_map[c] != h_t for c in alive_ids)
            round_fn, round_args = num["round"], []
            if het_round:
                # dead rows get the budget H (deterministic filler: their
                # pendings are zeroed after the round and their state is
                # reset on rejoin, so the value never reaches a hash)
                h_vec_np = np.full((C,), h_t, np.int32)
                for c, hv in h_map.items():
                    h_vec_np[c] = hv
                round_fn, round_args = num["round_h"], [h_vec_np]
            if gossip:
                W_r = mm_r.masked(alive).W
                st, aux = round_fn(st, rank_arg, W_r, *round_args)
            else:
                st, aux = round_fn(st, rank_arg, alive.astype(np.float32),
                                   *round_args)
            # dead clusters neither train nor accumulate error
            if (~alive).any():
                _reset_buffers(st, ~alive)
            num["state"] = st
            aux_np = _host_numpy(aux)
            t1 = _sync(device)
            if gossip:
                rows = [(c, tree_hash(diloco.take_row(st.params, c)))
                        for c in alive_ids]
                param_hash = combine_row_hashes(rows)
                disagreement = topo_mixing.consensus_distance_trees(
                    [diloco.take_row(st.params, c) for c in range(C)], alive)
            else:
                param_hash = tree_hash(st.params)
            t2 = time.perf_counter()
            numeric_s, hash_s = t1 - t0, t2 - t1
            if n_alive:
                loss = float(np.mean(aux_np[np.asarray(alive)]))

        # ---- telemetry: modeled phase spans (read-only, derived from the
        # same compute_leg/comm arithmetic that filled the timing fields) --
        spans = []
        for c in alive_ids:
            spans.append(("inner", c, 0.0, float(leg.t_by[c])))
            spans.append(("idle", c, float(leg.t_by[c]),
                          float(leg.idle_by[c])))
        if t_comm > 0:
            # delayed rounds ship LAST round's delta while training, so the
            # modeled wire span starts at 0; synchronous (and per-step
            # allreduce) rounds put it after the compute leg
            wire_start = (0.0 if (sc.delay and not sc.allreduce_per_step)
                          else float(t_compute))
            for c in alive_ids:
                spans.append(("wire", c, wire_start, float(t_comm)))

        events.append(RoundEvent(
            round=r, alive=alive_ids,
            rejoined=tuple(int(i) for i in np.flatnonzero(rejoined)),
            h_steps=h_t, rank=rank_t, t_compute_s=t_compute,
            t_comm_s=t_comm, exposed_comm_s=exposed, t_round_s=t_round,
            wire_bytes=wire, slowest_cluster=slowest,
            bottleneck_cluster=bottleneck, tokens=tokens,
            faults=sc.faults.active(r), loss=loss, param_hash=param_hash,
            wire_bytes_total=wire_total, disagreement=disagreement,
            ranks=ranks_tuple,
            h_by=(tuple(h_map[c] for c in alive_ids) if h_active and n_alive
                  else None),
            t_compute_by=(tuple(leg.t_by[c] for c in alive_ids)
                          if n_alive else None),
            idle_by=(tuple(leg.idle_by[c] for c in alive_ids)
                     if n_alive else None),
            spans=(tuple(spans) if spans else None)))
        wall.append({"round": r, "round_s": time.perf_counter() - t_round0,
                     "numeric_s": numeric_s, "hash_s": hash_s})

    run_barrier(sc.rounds, _barrier_round)

    tl = Timeline(scenario=sc.meta(), events=events)
    tl.wall = wall
    if num is not None:
        tl.final_params = num["state"].params      # handy for callers/tests
    return tl


# ---------------------------------------------------------------------------
# bounded-staleness async rounds (sync="bounded_stale")
# ---------------------------------------------------------------------------

def async_modeled_times(sc: Scenario, wire: int, topo):
    """The bounded-stale engine's modeled timing callbacks, built from the
    same host arithmetic (``_jitter_factors`` salts 1/2, fault multipliers)
    the barrier path uses, so the engine's commit sequence (and every
    structural Timeline field) is the JAX package's.

    Returns ``(leg_seconds, send_seconds, sends)`` where ``sends[c]`` is
    the number of uplink transfers charged per publish: gossip pushes to
    each graph neighbor; gather models the relay hub (one up + one down
    transfer).
    """
    C = sc.n_clusters
    sends = [topo.degree(c) if topo.is_gossip else (2 if C > 1 else 0)
             for c in range(C)]

    def leg_seconds(c: int, k: int) -> float:
        step_j = _jitter_factors(sc.seed, k, C, sc.link.jitter, salt=1)
        return float(sc.h_steps * sc.t_step_s
                     * sc.faults.step_multiplier(c, k) * step_j[c])

    def send_seconds(c: int, k: int) -> float:
        if sends[c] == 0:
            return 0.0
        bw_j = _jitter_factors(sc.seed, k, C, sc.link.jitter, salt=2)
        bw = float(sc.link.bytes_per_s * sc.faults.bandwidth_factor(c, k)
                   * bw_j[c])
        return float(sends[c] * wire / bw + sends[c] * sc.link.latency_s)

    return leg_seconds, send_seconds, sends


def _own(tree):
    """A copy of ``tree`` that no other cluster's state shares."""
    return T.tree_map(
        lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
        tree)


def _rows_mean(rows, like, mean_fn):
    """``mean_fn`` of the cluster rows stacked leaf by leaf (a ``None`` row
    is f32 zeros), so at most one leaf's C rows are stacked at a time; the
    result has ``like``'s structure."""
    flat = [None if r is None else T.leaves(r) for r in rows]
    out = []
    for i, ref in enumerate(T.leaves(like)):
        xs = [torch.zeros_like(ref, dtype=torch.float32) if f is None
              else f[i] for f in flat]
        out.append(mean_fn(torch.stack(xs)))
        del xs
    return T.unflatten_like(like, out)


class _AsyncNumeric:
    """Per-cluster numeric executor for bounded-stale commits.

    Holds one (params, inner opt, outer opt, EF error, compressor state)
    replica per cluster plus a versioned store of *published* compressed
    deltas.  The engine's publish/commit split maps onto two entry points:
    :meth:`publish` (the ``on_publish`` callback) runs the inner leg and
    materializes the compressed — possibly Byzantine-corrupted — delta
    into the store the moment the leg finishes, so the version exists even
    while its publisher is still gate-blocked; :meth:`commit` then mixes
    the exact delta versions the engine recorded in ``AsyncCommit.used``
    and applies the outer step.  A ``used`` version missing from the store
    is an engine/executor contract violation and raises instead of
    silently substituting zeros (which would deflate the outer step while
    ``staleness_weights``/the trimmed mean still credited the row).

    Error feedback is the classic compressor-local form ``e = δ − C(δ)``
    (vs the cluster's own uncorrupted hat), never Alg. 2's ``δ − Δ``:
    under partial/stale mixing the latter's ``I − W`` error iteration has
    spectral radius > 1 and diverges (see ``core.diloco._error_feedback``).

    The JAX executor shares one immutable array across clusters (the
    initial params, zero errors, the warm start); here the row program,
    the outer step and the EF update write in place, so every cluster owns
    each tensor it writes.  ``_inner0`` (the problem's inner-state rows)
    and ``_comp0`` (the compressor's initial warm start) are never
    written: a rejoiner gets clones of them.  The means stack one leaf's
    rows at a time.
    """

    def __init__(self, sc: Scenario, numeric: NumericProblem, compressor,
                 W_base: np.ndarray):
        if numeric.inner_fn_row is None:
            raise ValueError(
                "sync='bounded_stale' needs NumericProblem.inner_fn_row — "
                "the per-cluster H-step program a proc worker jits "
                "(QuadraticSpec.problem() provides it)")
        if not (numeric.compress and numeric.error_feedback):
            raise ValueError("bounded_stale models the compressed published "
                             "delta; compress/error_feedback must stay on")
        self.C = sc.n_clusters
        self.W = np.asarray(W_base, np.float64)
        self.max_staleness = int(sc.max_staleness)
        self.trimmed = sc.aggregation == "trimmed_mean"
        self.trim_k = sc.trim_k
        self.faults = sc.faults
        self.compressor = compressor
        self.rank = None if sc.rank is None else int(sc.rank)
        self.inner_fn_row = numeric.inner_fn_row
        self.outer_lr = numeric.outer_lr
        self.outer_momentum = numeric.outer_momentum
        params = numeric.params
        self.device = T.leaves(params)[0].device

        self._inner0 = [diloco.take_row(numeric.inner_opt_stacked, c)
                        for c in range(self.C)]
        self._comp0 = _own(compressor.init_state(params))
        # cluster 0 takes the problem's params (simulate owns them)
        self.params = [params] + [_own(params) for _ in range(1, self.C)]
        self.inner_opt = [_own(o) for o in self._inner0]
        self.outer_opt = [nesterov.init(params) for _ in range(self.C)]
        self.error = [self._zeros(params) for _ in range(self.C)]
        self.comp = [_own(self._comp0) for _ in range(self.C)]
        self.store = [dict() for _ in range(self.C)]   # leg -> published hat
        # c -> (err, inner_new, comp_new, losses) between publish and commit
        self._inflight: Dict[int, Tuple] = {}
        self.publish_s: Dict[int, float] = {}   # c -> its last publish's s
        self.alive = (np.ones(self.C, bool) if sc.initial_alive is None
                      else np.asarray(sc.initial_alive, bool).copy())

    @staticmethod
    def _zeros(params):
        return T.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                          params)

    @torch.no_grad()
    def publish(self, c: int, k: int, t: float) -> None:
        """Engine ``on_publish``: run leg ``k`` from the post-commit anchor
        (the engine schedules leg ``k`` only after leg ``k-1``'s commit, so
        nothing writes cluster ``c``'s params between here and its commit)
        and materialize the published version the instant it exists."""
        t0 = _sync(self.device)
        anchor = self.params[c]
        p_inner, inner_new, losses = self.inner_fn_row(
            anchor, self.inner_opt[c], c)
        raw = diloco.pseudo_grad(anchor, p_inner, self.error[c])
        del p_inner
        hat, comp_new = self.compressor.roundtrip(raw, self.comp[c],
                                                  self.rank)
        # err = raw - hat, into raw's buffers (a compressor that hands its
        # input back gets a fresh zero error instead)
        err = T.tree_map(lambda r, h: torch.sub(r, h) if h is r
                         else r.sub_(h), raw, hat)
        del raw
        # a Byzantine cluster corrupts what it PUBLISHES (everyone's mix
        # row, including its own) but keeps honest EF vs its clean hat —
        # the attack is on the wire, not on its local buffers. The hat is
        # f32 (raw is), so JAX's f32 product needs no cast; err already
        # holds what it needs of the clean hat, so scale it in place
        scale = self.faults.byzantine_scale(c, k)
        pub = (hat if scale is None
               else T.tree_map(lambda x: x.mul_(float(scale)), hat))
        self.store[c][k] = pub
        self._inflight[c] = (err, inner_new, comp_new, losses)
        self.publish_s[c] = _sync(self.device) - t0

    @torch.no_grad()
    def commit(self, ev):
        """One bounded-stale outer step; returns (loss, hash, disagreement,
        host seconds of the step, of the hash, of the disagreement)."""
        t0 = _sync(self.device)
        c, k = ev.cluster, ev.round
        anchor = self.params[c]
        err_new, inner_new, comp_new, losses = self._inflight.pop(c)

        used = dict(ev.used)
        rows = []
        for p in range(self.C):
            if p not in used:
                rows.append(None)              # weight/mask 0 anyway
            elif used[p] in self.store[p]:
                rows.append(self.store[p][used[p]])
            else:
                raise RuntimeError(
                    f"bounded-stale store miss: commit (c{c}, k{k}) uses "
                    f"version (c{p}, k{used[p]}) which was never "
                    f"materialized — engine publish/commit contract broken")
        if self.trimmed:
            mask = np.array([1.0 if p in used else 0.0
                             for p in range(self.C)], np.float32)
            Delta = _rows_mean(rows, anchor, lambda x: membership.
                               trimmed_cluster_mean(x, mask, self.trim_k))
        else:
            stal = np.full((self.C,), -1, np.int64)
            for p, s_p in ev.staleness:
                stal[p] = s_p
            w = diloco.staleness_weights(self.W[c], stal, self.max_staleness)
            Delta = _rows_mean(rows, anchor, lambda x: membership.
                               masked_cluster_mean(x, w))
        del rows
        params_new, outer_new = nesterov.update(
            Delta, self.outer_opt[c], anchor, lr=self.outer_lr,
            momentum=self.outer_momentum)
        del Delta
        self.params[c] = params_new
        self.inner_opt[c] = inner_new
        self.outer_opt[c] = outer_new
        self.error[c] = err_new
        self.comp[c] = comp_new
        # GC: the engine's arrived-publish watermarks are monotone (per
        # epoch), so versions below avail[p] can never be referenced again
        for p in range(self.C):
            for old in [v for v in self.store[p] if v < ev.avail[p]]:
                del self.store[p][old]
        loss = float(torch.mean(losses.float()))
        t1 = _sync(self.device)
        param_hash = tree_hash(params_new)
        t2 = time.perf_counter()
        disagreement = topo_mixing.consensus_distance_trees(self.params,
                                                            self.alive)
        t3 = time.perf_counter()
        return loss, param_hash, disagreement, t1 - t0, t2 - t1, t3 - t2

    def on_leave(self, c: int, k: int, t: float) -> None:
        self.alive[c] = False     # state freezes; nobody mixes it anymore

    @torch.no_grad()
    def on_join(self, c: int, k: int, t: float) -> None:
        """Consensus bootstrap: a rejoiner is a fresh worker restarting
        from the masked mean of the SURVIVORS' (params, outer momentum),
        the zero-masked rows through ``masked_cluster_mean``; its inner
        state and warm start are clones of the initial ones, its error
        zero."""
        m = self.alive.astype(np.float32)
        mean = lambda x: membership.masked_cluster_mean(x, m)
        params = _rows_mean(self.params, self.params[c], mean)
        mom = _rows_mean([o.momentum for o in self.outer_opt],
                         self.outer_opt[c].momentum, mean)
        self.params[c] = params
        self.outer_opt[c] = nesterov.NesterovState(
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            momentum=mom)
        self.inner_opt[c] = _own(self._inner0[c])
        self.error[c] = self._zeros(params)
        self.comp[c] = _own(self._comp0)   # re-INIT, never zeroed (PowerSGD)
        self.store[c].clear()              # engine retires the old epoch too
        self._inflight.pop(c, None)
        self.alive[c] = True

    def final_params(self):
        """The clusters' params stacked; the run is over, so the store and
        in-flight buffers are dropped first."""
        self.store = [dict() for _ in range(self.C)]
        self._inflight.clear()
        return T.tree_map(lambda *xs: torch.stack(xs), *self.params)


def _simulate_bounded_stale(sc: Scenario,
                            numeric: Optional[NumericProblem]) -> Timeline:
    """Drive ``BoundedStaleEngine`` over the scenario: modeled per-cluster
    leg/publish times from the SAME host arithmetic the barrier path uses
    (``_jitter_factors`` salts 1/2, fault multipliers), push-sum-supported
    mixing weights, and one :class:`RoundEvent` per committed outer step.

    ``sc.delay`` is ignored here on purpose: publish-at-finish means the
    send *always* overlaps the staleness wait and the next leg, which
    subsumes the §2.3 one-step-delay rule — ``exposed_comm_s`` records the
    gate wait instead.
    """
    if sc.topology_seed_schedule is not None:
        raise ValueError(
            "sync='bounded_stale' gates on a FIXED peer set per cluster; "
            "a per-round topology re-draw would change the staleness-gate "
            "semantics mid-flight (run dynamic topologies under barrier)")

    C = sc.n_clusters
    compressor = make_compressor(sc.compressor, **sc.compressor_kw)
    wire = int(compressor.wire_bytes(sc.shapes(), rank=sc.rank))
    topo = sc.topo()
    W_base = async_mix_weights(topo)
    peers = [tuple(p for p in range(C) if p != c and W_base[c, p] > 0.0)
             for c in range(C)]
    leg_seconds, send_seconds, sends = async_modeled_times(sc, wire, topo)

    execr = (None if numeric is None
             else _AsyncNumeric(sc, numeric, compressor, W_base))

    events = []
    wall = []

    def on_commit(ev) -> None:
        loss = param_hash = disagreement = None
        c, k = ev.cluster, ev.round
        times = dict(cluster=c, round=k, publish_s=0.0, commit_s=0.0,
                     hash_s=0.0, disagreement_s=0.0)
        if execr is not None:
            (loss, param_hash, disagreement, times["commit_s"],
             times["hash_s"], times["disagreement_s"]) = execr.commit(ev)
            times["publish_s"] = execr.publish_s.pop(c)
        t_comp, wait, t_send = (float(ev.t_compute), float(ev.wait),
                                float(ev.t_send))
        spans = [("inner", c, 0.0, t_comp),
                 ("stale_wait", c, t_comp, wait)]
        if t_send > 0:
            spans.append(("wire", c, t_comp, t_send))
        spans.append(("leg", c, 0.0, t_comp + wait))
        events.append(RoundEvent(
            round=k, alive=ev.alive, rejoined=ev.rejoined,
            h_steps=sc.h_steps, rank=sc.rank,
            t_compute_s=t_comp, t_comm_s=t_send, exposed_comm_s=wait,
            t_round_s=t_comp + wait, wire_bytes=wire,
            slowest_cluster=c, bottleneck_cluster=c,
            tokens=sc.tokens_per_step * sc.h_steps / max(C, 1),
            faults=sc.faults.active(k), loss=loss, param_hash=param_hash,
            wire_bytes_total=wire * sends[c], disagreement=disagreement,
            t_compute_by=(t_comp,), idle_by=(wait,),
            spans=tuple(spans), cluster=c, staleness=ev.staleness,
            round_clock=ev.round_clock, t_start_s=float(ev.t_start)))
        wall.append(times)

    alive0 = (None if sc.initial_alive is None
              else tuple(int(i) for i in
                         np.flatnonzero(np.asarray(sc.initial_alive, bool))))
    engine = BoundedStaleEngine(
        n_clusters=C, rounds=sc.rounds, max_staleness=sc.max_staleness,
        peers=peers, leg_seconds=leg_seconds, send_seconds=send_seconds,
        commit=on_commit,
        on_publish=(execr.publish if execr is not None else None),
        leaves=sc.faults.leave_events(),
        joins=sc.faults.join_events(), initial_alive=alive0,
        on_leave=(execr.on_leave if execr is not None else None),
        on_join=(execr.on_join if execr is not None else None))
    engine.run()

    tl = Timeline(scenario=sc.meta(), events=events)
    tl.wall = wall
    if execr is not None:
        tl.final_params = execr.final_params()
    return tl


# ---------------------------------------------------------------------------
# paper-method comparison (Fig. 4 / Table 1 / 357x as a runnable program)
# ---------------------------------------------------------------------------

def compare_methods(base: Scenario, rank: int = 64) -> Dict[str, Any]:
    """Run the paper's four methods through the *same* scenario (same link
    profile, same faults) and compare effective throughput, simulated
    round-by-round — so fault schedules change the ordering measurably
    instead of being outside the model."""
    H = base.h_steps
    variants = {
        "allreduce": replace(base, compressor="identity", compressor_kw={},
                             allreduce_per_step=True, delay=False, h_steps=1),
        "opendiloco": replace(base, compressor="fp16", compressor_kw={},
                              delay=False, h_steps=4 * H),
        "cocktail": replace(base, compressor="cocktail", compressor_kw={},
                            allreduce_per_step=True, delay=False, h_steps=1),
        "diloco_x": replace(base, compressor="diloco_x",
                            compressor_kw=dict(base.compressor_kw,
                                               rank=rank),
                            delay=True, h_steps=H),
    }
    timelines = {name: simulate(v) for name, v in variants.items()}
    tps = {name: tl.tokens_per_s for name, tl in timelines.items()}
    ar = tps["allreduce"]
    return {
        "tokens_per_s": tps,
        "speedup_vs_allreduce": {k: (v / ar if ar > 0 else float("inf"))
                                 for k, v in tps.items()},
        "timelines": timelines,
    }
