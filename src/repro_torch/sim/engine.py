"""Round engine of the simulator, the barrier policy (port of the barrier
part of ``repro.sim.engine``).

``sync="barrier"`` → :func:`run_barrier`: every cluster's round-``r`` leg
ends at the same global barrier, so the event queue collapses to a
lockstep iteration and the engine drives the backend's whole-round body in
order.

``sync="bounded_stale"`` (SSP-style asynchronous rounds: the JAX package's
``AsyncCommit`` and ``BoundedStaleEngine``) is ROADMAP A.14 item 2 and not
ported yet; ``Scenario`` accepts the name so a scenario describes the same
run in both packages, and ``simulate`` refuses it.
"""
from __future__ import annotations

from typing import Callable

#: Outer-sync policies understood by ``Scenario.sync``.
SYNC_KINDS = ("barrier", "bounded_stale")


def run_barrier(rounds: int, round_fn: Callable[[int], None]) -> None:
    """Drive the barrier policy: the backend's whole-round body, in order
    (staleness bound 0 on a global clock makes every event order collapse
    to ``0..rounds-1``)."""
    for rnd in range(rounds):
        round_fn(rnd)
