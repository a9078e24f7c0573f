"""Port parity for the round engine (``repro_torch.sim.engine``) and the
bounded-stale simulator's timing side against the JAX package.

- Twins of ``tests/test_engine.py:20-165`` on the port's engine (no
  scenario): commits, the staleness bound, barrier cadence at bound 0,
  fast clusters running ahead, leave/join sequencing, the parameter
  checks, publish-before-use and the rejoiner's retired publishes.
- The port's ``AsyncCommit`` sequence equal to the JAX engine's, field
  for field and in order, over a grid of cluster counts, bounds, leg
  times, leaves and joins (with the hooks' call order too).
- Timing-only ``simulate`` under ``sync="bounded_stale"``:
  ``fingerprint()``, ``structural_fingerprint()`` and ``to_dict()`` equal
  to JAX's for ``tests/test_engine.py:171-218``'s scenarios and for a
  parametrised twin of ``tests/test_topology.py:338-366`` (star and
  ring, bounds 0-3), with the JAX tests' own assertions in the port.
"""
import dataclasses

import numpy as np
import pytest

import repro.sim as J
import repro_torch.sim as P
from repro.sim import engine as JE
from repro_torch.sim import engine as PE


# ---------------------------------------------------------------------------
# the engine alone (tests/test_engine.py:20-165 in the port)
# ---------------------------------------------------------------------------

def _drive(eng_mod=PE, n=3, rounds=4, s=1, legs=None, leaves=(), joins=(),
           send=None, **kw):
    commits = []
    eng = eng_mod.BoundedStaleEngine(
        n_clusters=n, rounds=rounds, max_staleness=s,
        peers=[[p for p in range(n) if p != c] for c in range(n)],
        leg_seconds=legs or (lambda c, k: 1.0),
        send_seconds=send or (lambda c, k: 0.1),
        commit=commits.append, leaves=leaves, joins=joins, **kw)
    eng.run()
    return commits


def test_run_barrier_is_the_sequential_loop():
    seen = []
    PE.run_barrier(5, seen.append)
    assert seen == [0, 1, 2, 3, 4]


def test_engine_commits_every_leg_once_and_is_deterministic():
    a = _drive(legs=lambda c, k: 1.0 + 0.3 * c)
    b = _drive(legs=lambda c, k: 1.0 + 0.3 * c)
    assert a == b
    per = {}
    for ev in a:
        assert isinstance(ev, PE.AsyncCommit)
        per.setdefault(ev.cluster, []).append(ev.round)
    assert all(v == [0, 1, 2, 3] for v in per.values())


@pytest.mark.parametrize("s", [0, 1, 2])
def test_engine_staleness_bound_holds_under_stragglers(s):
    slow = lambda c, k: 5.0 if c == 2 else 1.0
    for ev in _drive(rounds=6, s=s, legs=slow):
        for p, stale in ev.staleness:
            assert 0 <= stale <= s, (ev.cluster, ev.round, p, stale)


def test_engine_zero_staleness_is_barrier_cadence():
    commits = _drive(rounds=4, s=0, legs=lambda c, k: 1.0 + 0.5 * c)
    waves = [ev.round for ev in commits]
    assert waves == sorted(waves)
    for ev in commits:
        assert all(stale == 0 for _, stale in ev.staleness)
        assert len(ev.used) == 3


def test_engine_fast_clusters_run_ahead_within_bound():
    slow = lambda c, k: 4.0 if c == 2 else 1.0
    commits = _drive(rounds=6, s=2, legs=slow)
    clock = {c: [] for c in range(3)}
    for ev in commits:
        clock[ev.cluster].append(ev.t_commit)
    assert max(clock[0][-1], clock[1][-1]) < clock[2][-1]
    for ev in commits:
        own = ev.round_clock[ev.cluster]
        others = [ev.round_clock[p] for p in range(3) if p != ev.cluster]
        assert own - min(others) <= 3


def test_engine_membership_leave_join_sequencing():
    hooks = []
    commits = _drive(
        rounds=6, s=1, leaves=[(2, 1)], joins=[(4, 1)],
        on_leave=lambda c, k, t: hooks.append(("leave", c, k)),
        on_join=lambda c, k, t: hooks.append(("join", c, k)))
    assert ("leave", 1, 2) in hooks and ("join", 1, 4) in hooks
    assert hooks.index(("leave", 1, 2)) < hooks.index(("join", 1, 4))
    c1 = [ev.round for ev in commits if ev.cluster == 1]
    assert 2 not in c1 and 3 not in c1 and c1 == sorted(c1)
    rejoined = [ev for ev in commits if ev.rejoined]
    assert rejoined and rejoined[0].cluster == 1
    for ev in commits:
        for p, idx in ev.used:
            assert idx >= ev.round - 1, (ev.cluster, ev.round, p, idx)


@pytest.mark.parametrize("kw", [dict(rounds=0), dict(s=-1)])
def test_engine_rejects_bad_parameters(kw):
    with pytest.raises(ValueError) as got:
        _drive(**kw)
    with pytest.raises(ValueError) as want:
        _drive(JE, **kw)
    assert str(got.value) == str(want.value)


def _logged(eng_mod, raises=False, **kw):
    """The engine's whole callback sequence: publishes, commits, leaves and
    joins in the order they fire (``raises``: and what ``run`` raised, as
    the last entry)."""
    log = []
    n = kw.pop("n", 3)
    peers = kw.pop("peers", [[p for p in range(n) if p != c]
                             for c in range(n)])
    eng = eng_mod.BoundedStaleEngine(
        n_clusters=n, peers=peers,
        send_seconds=kw.pop("send", lambda c, k: 0.1),
        commit=lambda ev: log.append(("commit", ev)),
        on_publish=lambda c, k, t: log.append(("publish", c, k, t)),
        on_leave=lambda c, k, t: log.append(("leave", c, k, t)),
        on_join=lambda c, k, t: log.append(("join", c, k, t)), **kw)
    if not raises:
        eng.run()
        return log
    try:
        eng.run()
    except Exception as e:      # noqa: BLE001 - compared with JAX's
        log.append(("raised", type(e).__name__, str(e)))
    return log


def _plain(log):
    """``log`` with each ``AsyncCommit`` as a dict of its fields (the two
    packages' dataclasses never compare equal as objects)."""
    return [("commit", dataclasses.asdict(e[1])) if e[0] == "commit" else e
            for e in log]


def test_engine_every_used_version_was_published_first():
    log = _logged(PE, rounds=6, max_staleness=2,
                  leg_seconds=lambda c, k: 5.0 if c == 2 else 1.0)
    published = set()
    ahead_of_commit = 0
    for entry in log:
        if entry[0] == "publish":
            published.add((entry[1], entry[2]))
        elif entry[0] == "commit":
            ev = entry[1]
            for p, idx in ev.used:
                assert (p, idx) in published, (ev.cluster, ev.round, p, idx)
                if idx > ev.round_clock[p]:
                    ahead_of_commit += 1
    assert ahead_of_commit > 0


def test_engine_rejoiner_pre_leave_publishes_are_retired():
    log = _logged(PE, rounds=6, max_staleness=4,
                  leg_seconds=lambda c, k: 1.0, leaves=[(1, 1)],
                  joins=[(2, 1)])
    rejoin_leg = None
    for entry in log:
        if entry[0] == "join":
            rejoin_leg = entry[2]
        elif entry[0] == "commit" and rejoin_leg is not None:
            for p, idx in entry[1].used:
                if p == 1:
                    assert idx >= rejoin_leg, (entry[1].cluster,
                                               entry[1].round, idx)
    assert rejoin_leg is not None


# ---------------------------------------------------------------------------
# the decision sequence against the JAX engine's
# ---------------------------------------------------------------------------

def _legs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return lambda c, k: 1.0
    if kind == "straggler":
        return lambda c, k: 5.0 if c == seed % 3 else 1.0
    table = rng.uniform(0.5, 3.0, size=(8, 12))
    return lambda c, k: float(table[c, k])


def _sends(kind, seed):
    if kind == "uniform":
        return lambda c, k: 0.1
    table = np.random.default_rng(seed + 100).uniform(0.0, 2.0, (8, 12))
    return lambda c, k: float(table[c, k])


GRID = [
    # (n, s, legs, sends, leaves, joins, initial_alive, ring peers)
    (3, 0, "uniform", "uniform", (), (), None, False),
    (3, 1, "straggler", "uniform", (), (), None, False),
    (4, 2, "random", "random", (), (), None, False),
    (4, 1, "random", "random", ((2, 1),), ((4, 1),), None, False),
    (5, 3, "random", "random", ((1, 0), (3, 4)), ((3, 0), (5, 4)), None,
     False),
    (4, 0, "straggler", "random", ((2, 3),), ((3, 3),), (0, 1, 2), False),
    (5, 1, "random", "uniform", ((2, 2),), ((4, 2),), None, True),
    (6, 2, "random", "random", ((1, 5), (2, 1)), ((3, 1), (4, 5)), None,
     True),
    (4, 4, "uniform", "uniform", ((1, 1),), ((2, 1),), None, False),
    (2, 0, "random", "random", (), (), None, False),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", range(len(GRID)))
def test_commit_sequence_equals_jax_field_for_field(case, seed):
    n, s, legs, sends, leaves, joins, alive0, ring = GRID[case]
    peers = ([[(c - 1) % n, (c + 1) % n] for c in range(n)] if ring
             else [[p for p in range(n) if p != c] for c in range(n)])
    kw = dict(n=n, rounds=6, max_staleness=s, peers=peers,
              leg_seconds=_legs(legs, seed), send=_sends(sends, seed),
              leaves=leaves, joins=joins, initial_alive=alive0)
    got = _plain(_logged(PE, raises=True, **dict(kw)))
    want = _plain(_logged(JE, raises=True, **dict(kw)))
    assert any(e[0] == "commit" for e in got)
    assert got == want


def test_nested_recheck_raises_in_both_engines():
    """A reference fault the port keeps (ROADMAP §C): a commit inside
    ``_recheck_blocked``'s loop schedules a leg whose Leave re-enters
    ``_recheck_blocked``; the inner call commits a cluster that the outer
    loop's sorted snapshot still lists, and the outer loop's lookup raises
    ``KeyError``. Both engines make the same decisions up to it."""
    n, s, legs, sends, leaves, joins, alive0, ring = GRID[3]
    kw = dict(n=n, rounds=6, max_staleness=s, leg_seconds=_legs(legs, 0),
              send=_sends(sends, 0), leaves=leaves, joins=joins)
    got = _plain(_logged(PE, raises=True, **dict(kw)))
    assert got == _plain(_logged(JE, raises=True, **dict(kw)))
    assert got[-1][:2] == ("raised", "KeyError")


def test_engine_constants_are_jax_s():
    assert PE.SYNC_KINDS == JE.SYNC_KINDS
    assert (PE._AVAIL, PE._FINISH) == (JE._AVAIL, JE._FINISH)
    assert ([f.name for f in dataclasses.fields(PE.AsyncCommit)]
            == [f.name for f in dataclasses.fields(JE.AsyncCommit)])


# ---------------------------------------------------------------------------
# timing-only simulate (tests/test_engine.py:171-218, test_topology.py:338)
# ---------------------------------------------------------------------------

def _async_sc(m, **kw):
    base = dict(n_clusters=4, rounds=6, h_steps=4, seed=3, t_step_s=0.02,
                sync="bounded_stale", max_staleness=2,
                link=m.LinkProfile(bytes_per_s=2e8, latency_s=0.01,
                                   jitter=0.1),
                faults=m.FaultSchedule((m.Straggler(1, 1, 4, 3.0),)))
    base.update(kw)
    return m.Scenario(**base)


def _same_timeline(sc_of):
    got, want = P.simulate(sc_of(P)), J.simulate(sc_of(J))
    assert got.fingerprint() == want.fingerprint()
    assert got.structural_fingerprint() == want.structural_fingerprint()
    assert got.to_dict() == want.to_dict()
    return got


def test_async_timeline_structure_and_makespan():
    tl = _same_timeline(_async_sc)
    assert len(tl.events) == 4 * 6
    assert all(e.cluster is not None and e.round_clock is not None
               and e.t_start_s is not None for e in tl.events)
    per = {}
    for e in tl.events:
        per.setdefault(e.cluster, []).append(e.t_start_s)
    for starts in per.values():
        assert starts == sorted(starts)
    tlb = _same_timeline(lambda m: _async_sc(m, sync="barrier"))
    assert tl.total_time_s < tlb.total_time_s
    assert tl.total_barrier_idle_s < tlb.total_barrier_idle_s
    assert len(tl.wall) == len(tl.events)
    assert all(w["publish_s"] == w["hash_s"] == 0.0 for w in tl.wall)


def test_async_two_runs_bitwise_identical():
    a, b = P.simulate(_async_sc(P)), P.simulate(_async_sc(P))
    assert a.fingerprint() == b.fingerprint()
    assert a.structural_fingerprint() == b.structural_fingerprint()


def test_barrier_events_serialize_without_async_fields():
    tlb = _same_timeline(lambda m: m.Scenario(
        n_clusters=3, rounds=3, h_steps=4, seed=0,
        link=m.LinkProfile(bytes_per_s=2e8)))
    for e in tlb.events:
        assert e.cluster is None and e.staleness is None
    d = tlb.to_dict()
    assert all("cluster" not in row and "staleness" not in row
               and "round_clock" not in row and "t_start_s" not in row
               for row in d["events"])


# the timing sides of the numeric scenarios (test_engine.py:221-313)
TIMING_TWINS = {
    "star_mean": lambda m: _async_sc(m, topology="star",
                                     faults=m.FaultSchedule(()),
                                     compressor="diloco_x",
                                     compressor_kw={"rank": 4}, rank=4),
    "ring_mean": lambda m: _async_sc(m, topology="ring",
                                     faults=m.FaultSchedule(()),
                                     compressor="diloco_x",
                                     compressor_kw={"rank": 4}, rank=4),
    "churn": lambda m: _async_sc(
        m, faults=m.FaultSchedule((m.Leave(0, 2), m.Join(0, 4))),
        compressor="diloco_x", compressor_kw={"rank": 4}, rank=4),
    "byzantine_trimmed": lambda m: m.Scenario(
        n_clusters=5, rounds=10, h_steps=4, seed=11, t_step_s=0.02,
        sync="bounded_stale", max_staleness=1, compressor="diloco_x",
        compressor_kw={"rank": 4}, rank=4,
        link=m.LinkProfile(bytes_per_s=2e8, latency_s=0.01, jitter=0.05),
        faults=m.FaultSchedule((m.Byzantine(cluster=2, start_round=2,
                                            end_round=8, scale=-8.0),)),
        aggregation="trimmed_mean", trim_k=1),
    "initially_dead": lambda m: _async_sc(
        m, initial_alive=(True, False, True, True),
        faults=m.FaultSchedule((m.Join(1, 3),))),
}


@pytest.mark.parametrize("name", sorted(TIMING_TWINS))
def test_async_timing_twin_equals_jax(name):
    tl = _same_timeline(TIMING_TWINS[name])
    per = {}
    for e in tl.events:
        per.setdefault(e.cluster, []).append(e.round)
    assert all(v == sorted(v) for v in per.values())


@pytest.mark.parametrize("jitter", [0.0, 0.3])
@pytest.mark.parametrize("seed", [0, 17])
@pytest.mark.parametrize("bound", [0, 1, 2, 3])
@pytest.mark.parametrize("topology", ["star", "ring"])
def test_timeline_staleness_never_exceeds_bound(topology, bound, seed,
                                                jitter):
    """``tests/test_topology.py:338-366`` in the port, the timeline equal
    to JAX's."""
    sc_of = lambda m: m.Scenario(
        n_clusters=4, rounds=6, h_steps=4, seed=seed, t_step_s=0.02,
        topology=topology, sync="bounded_stale", max_staleness=bound,
        link=m.LinkProfile(bytes_per_s=2e8, latency_s=0.01, jitter=jitter),
        faults=m.FaultSchedule((m.Straggler(1, 1, 4, 3.0),)))
    tl = _same_timeline(sc_of)
    for e in tl.events:
        assert e.cluster is not None and e.staleness is not None
        for p, s in e.staleness:
            assert 0 <= s <= bound, (e.round, e.cluster, p, s)
        assert dict(e.staleness)[e.cluster] == 0
    per = {}
    for e in tl.events:
        per.setdefault(e.cluster, []).append(e.round)
    assert all(v == list(range(6)) for v in per.values())


def test_async_modeled_times_equal_jax():
    from repro.sim.simulator import async_modeled_times as jamt
    for topology in ("star", "ring", "torus"):
        sc_of = lambda m: _async_sc(m, topology=topology, n_clusters=4,
                                    faults=m.FaultSchedule((
                                        m.Straggler(1, 1, 4, 3.0),
                                        m.LinkDegradation(2, 4, 0.25,
                                                          cluster=0))))
        got = P.async_modeled_times(sc_of(P), 12345, sc_of(P).topo())
        want = jamt(sc_of(J), 12345, sc_of(J).topo())
        assert got[2] == want[2]
        for c in range(4):
            for k in range(6):
                assert got[0](c, k) == want[0](c, k)
                assert got[1](c, k) == want[1](c, k)
