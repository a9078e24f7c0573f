"""Virtual decentralized-cluster simulator (port of ``repro.sim``; ROADMAP
A.14 items 1 and 2).

Runs the DiLoCoX round loop (core/diloco.py) over N *simulated* clusters
connected by modeled slow links (core/comm.py arithmetic), with
injectable faults: stragglers, link degradation, membership churn
(core/membership.py semantics), Byzantine members; in barrier mode or as
bounded-stale asynchronous rounds (``BoundedStaleEngine``).  Not ported
yet: the adaptive controller (A.14 item 3), the pipeline-parallel problem
``PPSpec`` and the proc backend (A.14 item 4).
"""
from repro_torch.sim.engine import (SYNC_KINDS, AsyncCommit,
                                    BoundedStaleEngine, run_barrier)
from repro_torch.sim.faults import (Byzantine, FaultSchedule, Join, Leave,
                                    LinkDegradation, Straggler)
from repro_torch.sim.problems import problem_from_dict
from repro_torch.sim.quadratic import QuadraticSpec
from repro_torch.sim.scenario import LinkProfile, Scenario, synthetic_shapes
from repro_torch.sim.simulator import (NumericProblem, async_modeled_times,
                                       compare_methods,
                                       make_quadratic_problem, simulate)
from repro_torch.sim.timeline import (RoundEvent, Timeline,
                                      combine_row_hashes, tree_hash)

__all__ = [
    "SYNC_KINDS", "run_barrier", "AsyncCommit", "BoundedStaleEngine",
    "async_modeled_times", "Byzantine",
    "FaultSchedule", "Join", "Leave", "LinkDegradation", "Straggler",
    "LinkProfile", "Scenario", "synthetic_shapes", "QuadraticSpec",
    "problem_from_dict",
    "NumericProblem", "compare_methods", "make_quadratic_problem",
    "simulate", "RoundEvent", "Timeline", "tree_hash", "combine_row_hashes",
]
