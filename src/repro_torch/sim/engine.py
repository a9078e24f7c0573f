"""Round engine of the simulator: one control plane for its sync policies
(port of ``repro.sim.engine``, pure Python on floats, no torch).

``sync="barrier"`` → :func:`run_barrier`
    Every cluster's round-``r`` leg ends at the same global barrier, so
    the event queue collapses to a lockstep iteration and the engine
    drives the backend's whole-round body in order.

``sync="bounded_stale"`` → :class:`BoundedStaleEngine`
    SSP-style bounded-staleness asynchronous rounds.  Each cluster runs on
    its own round clock, *publishes* its compressed outer delta the moment
    a local leg finishes (the send overlaps whatever the cluster does
    next, generalizing the paper's §2.3 one-step-delay overlap), and
    *commits* an outer step eagerly against the freshest published peer
    deltas, gated so that no incorporated delta is more than
    ``max_staleness`` rounds older than the committing cluster's own
    round.  ``max_staleness=0`` degenerates to barrier cadence: nobody
    commits round ``k`` before every live peer has published round ``k``.

The engine owns event ordering, per-cluster round clocks, the staleness
gate and membership (leave/join) sequencing, and delegates all timing
arithmetic and all numerics to callbacks.  It is the JAX package's engine
line for line, so for the same callbacks it makes the same decision
sequence: every field of every :class:`AsyncCommit`, in order, and with
it every structural Timeline field (``staleness``, ``round_clock``).

Determinism contract: the heap is keyed ``(time, kind, cluster)`` with
publish-availability events ordered before leg-finish events at equal
times, blocked clusters are re-checked in sorted cluster order until a
fixpoint, and all clock arithmetic is plain Python floats.

Membership semantics under local clocks: ``Leave(c, r)`` fires when
cluster ``c`` is about to *start* its local leg ``r``; ``Join(c, r)``
fires when the fleet frontier (the highest committed leg index anywhere)
reaches ``r - 1``.  The rejoiner adopts the frontier clock and, until its
first real publish, carries a *virtual* published index equal to the
frontier so it never retroactively stalls peers it was not part of.  Its
pre-leave publishes are retired for good: the join resets the cluster's
published watermark and bumps its publish epoch, so an in-flight
pre-leave arrival can never resurrect a version the numeric executor
discarded when it bootstrapped the fresh replica.  A blocked cluster has
always already published the leg it is waiting to commit, so the gate
cannot deadlock among live clusters.

Publish/commit split: ``on_publish(c, k, t)`` fires the moment leg ``k``
finishes, before the gate is evaluated and before any peer can observe
the version; a numeric executor materializes the published (compressed,
possibly Byzantine-corrupted) delta into its versioned store there.
``commit`` then only aggregates and applies the outer step, so every
``(peer, leg)`` pair in ``AsyncCommit.used`` exists in the store even
when the publishing peer is itself still gate-blocked.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

#: Outer-sync policies understood by ``Scenario.sync``.
SYNC_KINDS = ("barrier", "bounded_stale")

# heap tie-break at equal times: a delta that lands exactly when another
# cluster finishes its leg is visible to that cluster's gate
_AVAIL, _FINISH = 0, 1


def run_barrier(rounds: int, round_fn: Callable[[int], None]) -> None:
    """Drive the barrier policy: the backend's whole-round body, in order
    (staleness bound 0 on a global clock makes every event order collapse
    to ``0..rounds-1``)."""
    for rnd in range(rounds):
        round_fn(rnd)


@dataclass(frozen=True)
class AsyncCommit:
    """One committed bounded-stale outer step, handed to the backend.

    ``used`` names the exact delta versions incorporated (``(peer, leg)``
    pairs, self first, then peers in cluster order) so a numeric executor
    can fetch them from its versioned store; ``staleness`` is the parallel
    ``(peer, rounds_stale)`` view recorded on the Timeline (self is always
    0; a peer that is *ahead* clamps to 0).
    """

    cluster: int                  # owner of this outer step
    round: int                    # owner's local leg index k
    t_start: float                # global modeled clock at leg start
    t_compute: float              # seconds of local compute for this leg
    t_send: float                 # modeled publish (uplink) seconds
    wait: float                   # staleness-gate wait after finishing
    t_commit: float               # global clock when the outer step ran
    used: Tuple[Tuple[int, int], ...]
    staleness: Tuple[Tuple[int, int], ...]
    alive: Tuple[int, ...]        # alive cluster ids at commit time
    rejoined: Tuple[int, ...]     # (c,) on the first commit after a Join
    round_clock: Tuple[int, ...]  # per-cluster committed-leg counters
    avail: Tuple[int, ...]        # per-cluster arrived-publish watermarks;
                                  # versions below avail[p] can never be
                                  # referenced again (avail is monotone per
                                  # epoch), so backends may GC them


class BoundedStaleEngine:
    """Deterministic event queue over per-cluster round clocks.

    Parameters
    ----------
    peers:
        Per-cluster in-neighbor ids (excluding self) — the clusters whose
        published deltas this cluster incorporates, i.e. the support of
        its row of the (push-sum) mixing weights.  The staleness gate
        ranges over exactly this set.
    leg_seconds / send_seconds:
        ``(cluster, leg) -> float`` modeled compute / publish times.
    commit:
        Called once per committed outer step with an :class:`AsyncCommit`.
    on_publish:
        ``(cluster, leg, t_finish)`` — fired at leg finish, before the
        gate is evaluated and before any peer can commit against the new
        version.  Numeric backends materialize the published delta here
        (see module docstring); timing-only callers may omit it.
    leaves / joins:
        ``(round, cluster)`` membership events (see module docstring for
        the local-clock semantics).
    """

    def __init__(
        self,
        *,
        n_clusters: int,
        rounds: int,
        max_staleness: int,
        peers: Sequence[Sequence[int]],
        leg_seconds: Callable[[int, int], float],
        send_seconds: Callable[[int, int], float],
        commit: Callable[[AsyncCommit], None],
        on_publish: Optional[Callable[[int, int, float], None]] = None,
        leaves: Iterable[Tuple[int, int]] = (),
        joins: Iterable[Tuple[int, int]] = (),
        initial_alive: Optional[Sequence[int]] = None,
        on_leave: Optional[Callable[[int, int, float], None]] = None,
        on_join: Optional[Callable[[int, int, float], None]] = None,
    ) -> None:
        if rounds < 1:
            raise ValueError("rounds must be >= 1")
        if max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        self.n = int(n_clusters)
        self.rounds = int(rounds)
        self.s = int(max_staleness)
        self.peers = [tuple(sorted(int(p) for p in peers[c]))
                      for c in range(self.n)]
        self._leg_seconds = leg_seconds
        self._send_seconds = send_seconds
        self._commit_cb = commit
        self._on_publish = on_publish
        self._on_leave = on_leave
        self._on_join = on_join
        self._leave_set = {(int(r), int(c)) for r, c in leaves}
        self._pending_joins: List[Tuple[int, int]] = sorted(
            (int(r), int(c)) for r, c in joins)
        if initial_alive is None:
            self._alive = [True] * self.n
        else:
            live = {int(c) for c in initial_alive}
            self._alive = [c in live for c in range(self.n)]
        self._committed = [-1] * self.n   # highest committed leg
        self._avail = [-1] * self.n       # highest peer-visible published leg
        self._virtual = [-1] * self.n     # rejoiner gate floor (pre-publish)
        self._own = [-1] * self.n         # highest locally finished leg
        self._epoch = [0] * self.n        # publish epoch; bumped on Join so
                                          # in-flight pre-leave arrivals die
        self._frontier = -1               # max committed leg fleet-wide
        self._rejoin_pending: set = set()
        # c -> (k, t_finish, t_start, t_leg, t_send) awaiting the gate
        self._blocked: Dict[int, Tuple[int, float, float, float, float]] = {}
        self._heap: List[Tuple[float, int, int, int, int]] = []
        self._leg_meta: Dict[int, Tuple[int, float, float]] = {}

    # ------------------------------------------------------------------ run

    def run(self) -> None:
        """Process events until every live cluster has committed its last
        leg (or left).  Raises ``RuntimeError`` on an engine deadlock —
        impossible by construction, kept as a bug tripwire."""
        self._fire_joins(t=0.0)           # Join(c, 0): alive from the start
        for c in range(self.n):
            if self._alive[c]:
                self._schedule_leg(c, 0, 0.0)
        while self._heap:
            t, kind, c, k, epoch = heapq.heappop(self._heap)
            if kind == _AVAIL:
                if epoch != self._epoch[c]:
                    continue              # pre-leave publish of a rejoiner:
                                          # the version was discarded at the
                                          # join bootstrap, never resurrect
                if k > self._avail[c]:
                    self._avail[c] = k
                self._recheck_blocked(t)
            else:
                if not self._alive[c]:
                    continue              # left while this event was queued
                self._finish(c, k, t)
        if self._blocked:
            raise RuntimeError(
                f"bounded-stale engine deadlock: blocked={self._blocked}")

    # ----------------------------------------------------------- internals

    def _schedule_leg(self, c: int, k: int, t: float) -> None:
        if k >= self.rounds:
            return                         # this cluster is done
        if (k, c) in self._leave_set:
            self._alive[c] = False
            if self._on_leave is not None:
                self._on_leave(c, k, t)
            self._recheck_blocked(t)       # shrinking a gate set can unblock
            return
        dur = float(self._leg_seconds(c, k))
        self._leg_meta[c] = (k, t, dur)
        heapq.heappush(self._heap, (t + dur, _FINISH, c, k, self._epoch[c]))

    def _finish(self, c: int, k: int, t: float) -> None:
        # publish first: the delta exists now and the send overlaps the
        # gate wait and the next leg (the async generalization of §2.3).
        # on_publish materializes the version BEFORE any gate/commit can
        # reference it — a gate-blocked publisher's delta is still real.
        t_send = float(self._send_seconds(c, k))
        self._own[c] = k
        if self._on_publish is not None:
            self._on_publish(c, k, t)
        heapq.heappush(self._heap, (t + t_send, _AVAIL, c, k, self._epoch[c]))
        _, t_start, t_leg = self._leg_meta[c]
        if self._gate_ok(c, k):
            self._commit(c, k, t, t, t_start, t_leg, t_send)
        else:
            self._blocked[c] = (k, t, t_start, t_leg, t_send)

    def _gate_ok(self, c: int, k: int) -> bool:
        floor = k - self.s
        for p in self.peers[c]:
            if not self._alive[p]:
                continue
            if max(self._avail[p], self._virtual[p]) < floor:
                return False
        return True

    def _commit(self, c: int, k: int, t: float, t_finish: float,
                t_start: float, t_leg: float, t_send: float) -> None:
        used = [(c, self._own[c])]
        stal = [(c, 0)]
        for p in self.peers[c]:
            # incorporate only deltas that respect the bound themselves: a
            # rejoiner's *virtual* index satisfies the gate (it must not
            # stall peers) but its last real publish predates the leave —
            # mixing that would smuggle in a delta older than max_staleness
            if self._alive[p] and self._avail[p] >= 0 \
                    and self._avail[p] >= k - self.s:
                idx = self._avail[p]
                used.append((p, idx))
                stal.append((p, max(0, k - idx)))
        self._committed[c] = k
        rejoined: Tuple[int, ...] = ()
        if c in self._rejoin_pending:
            self._rejoin_pending.discard(c)
            rejoined = (c,)
        ev = AsyncCommit(
            cluster=c, round=k, t_start=t_start, t_compute=t_leg,
            t_send=t_send, wait=t - t_finish, t_commit=t,
            used=tuple(used), staleness=tuple(stal),
            alive=tuple(i for i in range(self.n) if self._alive[i]),
            rejoined=rejoined,
            round_clock=tuple(self._committed),
            avail=tuple(self._avail),
        )
        self._commit_cb(ev)
        if k > self._frontier:
            self._frontier = k
            self._fire_joins(t)
        self._schedule_leg(c, k + 1, t)

    def _fire_joins(self, t: float) -> None:
        while self._pending_joins and \
                self._pending_joins[0][0] <= self._frontier + 1:
            _, c = self._pending_joins.pop(0)
            if self._alive[c]:
                continue                  # joining a live cluster is a no-op
            self._alive[c] = True
            self._committed[c] = self._frontier
            self._virtual[c] = self._frontier
            # the rejoiner is a FRESH replica: its pre-leave publishes are
            # gone from the numeric stores, so retire them here too (new
            # epoch kills in-flight arrivals; watermark back to "nothing
            # published") — only current-epoch versions ever enter `used`
            self._avail[c] = -1
            self._epoch[c] += 1
            self._rejoin_pending.add(c)
            if self._on_join is not None:
                self._on_join(c, self._frontier + 1, t)
            self._schedule_leg(c, self._frontier + 1, t)

    def _recheck_blocked(self, t: float) -> None:
        # commits fired here can trigger joins/leaves that change other
        # clusters' gate sets, so iterate to a fixpoint in sorted order
        changed = True
        while changed:
            changed = False
            for c in sorted(self._blocked):
                k, t_finish, t_start, t_leg, t_send = self._blocked[c]
                if self._gate_ok(c, k):
                    del self._blocked[c]
                    self._commit(c, k, t, t_finish, t_start, t_leg, t_send)
                    changed = True
