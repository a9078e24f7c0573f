"""Injectable faults for the virtual decentralized cluster (a copy of
``repro.sim.faults``: numpy only, and the ``describe()`` strings are the
JAX package's, since they enter the timeline's fingerprints).

Faults are plain frozen dataclasses collected in a ``FaultSchedule``; the
simulator queries the schedule once per outer round.  Round intervals are
half-open ``[start_round, end_round)`` — the operational vocabulary of
OpenDiLoCo/NoLoCo's WAN setting:

 - ``Straggler``: one cluster's local step time is multiplied by
   ``slowdown`` (a slow/preempted site; the outer barrier waits for it).
 - ``LinkDegradation``: link bandwidth multiplied by ``factor`` (<1), for
   every link or only the links touching one cluster.
 - ``Leave`` / ``Join``: membership churn.  A leaving cluster stops
   participating in the outer average (mask-weighted mean,
   ``core.membership``); a (re)joining cluster restarts from the current
   global params with zeroed pending-delta/error buffers.
 - ``Byzantine``: an adversarial cluster whose *published* compressed
   delta is corrupted (scaled by an arbitrary factor, e.g. sign-flipped
   and blown up) before it enters any aggregation — the attack model the
   trimmed-mean robust aggregation in ``core.membership`` defends
   against.  Only meaningful under ``sync="bounded_stale"``, where the
   publish step is an explicit engine event (the barrier round averages
   inside one round program with no injection point).

Under ``sync="bounded_stale"`` there is no global round: ``Straggler`` /
``LinkDegradation`` / ``Leave`` windows are indexed by each cluster's OWN
round clock, while ``Join`` fires when the fleet frontier (highest
committed leg anywhere) reaches the join round (``sim/engine.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Straggler:
    cluster: int
    start_round: int
    end_round: int                 # exclusive
    slowdown: float = 3.0          # multiplies t_step_s while active

    def describe(self) -> str:
        return (f"straggler(c{self.cluster} x{self.slowdown:g} "
                f"@[{self.start_round},{self.end_round}))")


@dataclass(frozen=True)
class LinkDegradation:
    start_round: int
    end_round: int                 # exclusive
    factor: float = 0.5            # multiplies link bandwidth while active
    cluster: Optional[int] = None  # None: every link; else links of one site

    def describe(self) -> str:
        who = "all" if self.cluster is None else f"c{self.cluster}"
        return (f"degrade({who} x{self.factor:g} "
                f"@[{self.start_round},{self.end_round}))")


@dataclass(frozen=True)
class Leave:
    cluster: int
    round: int

    def describe(self) -> str:
        return f"leave(c{self.cluster} @r{self.round})"


@dataclass(frozen=True)
class Join:
    cluster: int
    round: int

    def describe(self) -> str:
        return f"join(c{self.cluster} @r{self.round})"


@dataclass(frozen=True)
class Byzantine:
    cluster: int
    start_round: int
    end_round: int                 # exclusive
    scale: float = -8.0            # multiplies the published delta while
                                   # active (default: sign-flip + blow-up)

    def describe(self) -> str:
        return (f"byzantine(c{self.cluster} x{self.scale:g} "
                f"@[{self.start_round},{self.end_round}))")


@dataclass(frozen=True)
class FaultSchedule:
    events: Tuple = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def step_multiplier(self, cluster: int, rnd: int) -> float:
        """Product of active straggler slowdowns for one cluster."""
        m = 1.0
        for e in self.events:
            if (isinstance(e, Straggler) and e.cluster == cluster
                    and e.start_round <= rnd < e.end_round):
                m *= e.slowdown
        return m

    def bandwidth_factor(self, cluster: int, rnd: int) -> float:
        """Product of active degradation factors on one cluster's links."""
        f = 1.0
        for e in self.events:
            if (isinstance(e, LinkDegradation)
                    and e.start_round <= rnd < e.end_round
                    and (e.cluster is None or e.cluster == cluster)):
                f *= e.factor
        return f

    def membership(self, rnd: int, alive: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Apply this round's Leave/Join events.  Returns (alive', rejoined)
        — rejoined marks clusters that were dead and came back this round
        (their stale buffers must be reset before the outer average)."""
        new = alive.copy()
        rejoined = np.zeros_like(alive)
        for e in self.events:
            if isinstance(e, Leave) and e.round == rnd:
                new[e.cluster] = False
            elif isinstance(e, Join) and e.round == rnd:
                if not new[e.cluster]:
                    rejoined[e.cluster] = True
                new[e.cluster] = True
        return new, rejoined

    def byzantine_scale(self, cluster: int, rnd: int) -> Optional[float]:
        """Product of active Byzantine corruption scales on one cluster's
        published delta, or None when the cluster is honest this round."""
        s = None
        for e in self.events:
            if (isinstance(e, Byzantine) and e.cluster == cluster
                    and e.start_round <= rnd < e.end_round):
                s = e.scale if s is None else s * e.scale
        return s

    def leaves_at(self, rnd: int) -> Tuple[int, ...]:
        """Clusters leaving at round ``rnd`` (sorted) — the per-event query
        the bounded-stale engine uses in place of ``membership``."""
        return tuple(sorted(e.cluster for e in self.events
                            if isinstance(e, Leave) and e.round == rnd))

    def leave_events(self) -> Tuple[Tuple[int, int], ...]:
        """All ``(round, cluster)`` Leave events (engine init input)."""
        return tuple((e.round, e.cluster) for e in self.events
                     if isinstance(e, Leave))

    def join_events(self) -> Tuple[Tuple[int, int], ...]:
        """All ``(round, cluster)`` Join events (engine init input)."""
        return tuple((e.round, e.cluster) for e in self.events
                     if isinstance(e, Join))

    def active(self, rnd: int) -> Tuple[str, ...]:
        """Human-readable tags of everything firing/active at round rnd
        (recorded on the event timeline)."""
        tags = []
        for e in self.events:
            if isinstance(e, (Straggler, LinkDegradation, Byzantine)):
                if e.start_round <= rnd < e.end_round:
                    tags.append(e.describe())
            elif e.round == rnd:
                tags.append(e.describe())
        return tuple(tags)
