"""Port parity for the bounded-stale simulator's numeric executor
(``repro_torch.sim.simulator._AsyncNumeric``, the quadratic problem on the
CPU) against the JAX package.

- Numeric twins of ``tests/test_engine.py:221-313`` (the staleness-weighted
  mean over a star and a ring, the straggler regime that mixes published
  but uncommitted deltas, churn with a rejoin, a Byzantine member under the
  mean and under the trimmed mean) on JAX's quadratic arrays and
  ``LowRankQuant`` warm start (carried in as ``test_torch_sim_numeric``
  does): the timeline but its numeric fields equal to JAX's, every
  commit's loss within ``LOSS_RTOL`` of JAX's and the final params within
  ``PARAM_RTOL`` of the leaf's max |value|; the JAX tests' own assertions
  in the port; in-port runs bit for bit across two runs.
- The executor's contract: a ``used`` version missing from the store
  raises; JAX's two ``ValueError``s and the dynamic-topology refusal keep
  their messages; no two clusters share the storage of a tensor they
  write; ``_inner0`` and ``_comp0`` keep their first bits through a rejoin.
- The disagreement taken on the rows' device
  (``topology.mixing.consensus_distance_trees``) against the numpy
  ``consensus_distance`` within ``DIST_RTOL``; ``trimmed_cluster_mean``
  bit for bit the same at every chunk size.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.sim as J
import repro_torch.sim as P
import repro_torch.sim.simulator as PS
from repro.topology.mixing import consensus_distance as j_consensus_distance
from repro_torch import tree as T
from repro_torch.core import membership as MB
from repro_torch.topology import mixing as PM
from test_torch_sim_numeric import CarriedSpec, _JaxWarmStart

# measured worst cases over the twins below (CPU): losses 4.8e-7 relative
# (engine_294_attacked), params 1.1e-6 of the leaf's max
# (lowrank_churn_trimmed), disagreement 5.0e-7
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
DISAGREEMENT_RTOL = 1e-4
DIST_RTOL = 1e-10
NUMERIC_FIELDS = ("loss", "param_hash", "disagreement")


@pytest.fixture
def jax_warm_start(monkeypatch):
    make = PS.make_compressor
    monkeypatch.setattr(PS, "make_compressor", lambda name, **kw:
                        _JaxWarmStart(make(name, **kw), name, kw))


def _async_sc(m, **kw):
    """``tests/test_engine.py::_async_sc``."""
    base = dict(n_clusters=4, rounds=6, h_steps=4, seed=3, t_step_s=0.02,
                sync="bounded_stale", max_staleness=2,
                link=m.LinkProfile(bytes_per_s=2e8, latency_s=0.01,
                                   jitter=0.1),
                faults=m.FaultSchedule((m.Straggler(1, 1, 4, 3.0),)))
    base.update(kw)
    return m.Scenario(**base)


_LOWRANK = dict(compressor="diloco_x", compressor_kw={"rank": 4}, rank=4)


def _byz(m, faults, **kw):
    return m.Scenario(
        n_clusters=5, rounds=10, h_steps=4, seed=11, t_step_s=0.02,
        sync="bounded_stale", max_staleness=1,
        link=m.LinkProfile(bytes_per_s=2e8, latency_s=0.01, jitter=0.05),
        faults=(m.FaultSchedule((m.Byzantine(cluster=2, start_round=2,
                                             end_round=8, scale=-8.0),))
                if faults else m.FaultSchedule(())), **_LOWRANK, **kw)


# name -> (the scenario for a module, QuadraticSpec kwargs)
TWINS = {
    "engine_221_star": (lambda m: _async_sc(
        m, topology="star", faults=m.FaultSchedule(()), **_LOWRANK),
        dict(n_clusters=4, d=8, h_steps=4, seed=1)),
    "engine_221_ring": (lambda m: _async_sc(
        m, topology="ring", faults=m.FaultSchedule(()), **_LOWRANK),
        dict(n_clusters=4, d=8, h_steps=4, seed=1)),
    "engine_237_straggler": (lambda m: m.Scenario(
        n_clusters=3, rounds=8, h_steps=4, seed=3, t_step_s=0.02,
        sync="bounded_stale", max_staleness=2, topology="star",
        link=m.LinkProfile(bytes_per_s=2e8, latency_s=0.01, jitter=0.1),
        faults=m.FaultSchedule((m.Straggler(1, 1, 5, 3.0),)), **_LOWRANK),
        dict(n_clusters=3, d=8, h_steps=4, seed=1)),
    "engine_280_churn": (lambda m: _async_sc(
        m, faults=m.FaultSchedule((m.Leave(0, 2), m.Join(0, 4))),
        **_LOWRANK), dict(n_clusters=4, d=8, h_steps=4, seed=1)),
    "engine_294_honest": (lambda m: _byz(m, False),
                          dict(n_clusters=5, d=8, h_steps=4, seed=3)),
    "engine_294_attacked": (lambda m: _byz(m, True),
                            dict(n_clusters=5, d=8, h_steps=4, seed=3)),
    "engine_294_defended": (lambda m: _byz(
        m, True, aggregation="trimmed_mean", trim_k=1),
        dict(n_clusters=5, d=8, h_steps=4, seed=3)),
    # low-rank leaves (d 16 >= min_dim_for_lowrank 8): the warm starts
    # and the rejoin's re-init of them are on the path
    "lowrank_churn_trimmed": (lambda m: _async_sc(
        m, n_clusters=5, faults=m.FaultSchedule((
            m.Leave(1, 2), m.Join(1, 4), m.Byzantine(3, 1, 4, -4.0))),
        compressor="diloco_x",
        compressor_kw={"rank": 4, "min_dim_for_lowrank": 8}, rank=4,
        aggregation="trimmed_mean", trim_k=1),
        dict(n_clusters=5, d=16, h_steps=4, seed=2)),
}


def _run_jax(name):
    build, spec_kw = TWINS[name]
    return J.simulate(build(J), numeric=J.QuadraticSpec(**spec_kw).problem())


def _run_port(name, spec_cls=CarriedSpec, device="cpu"):
    build, spec_kw = TWINS[name]
    return P.simulate(build(P), numeric=spec_cls(**spec_kw).problem(device))


def _timing_rows(tl):
    return [{k: v for k, v in dataclasses.asdict(e).items()
             if k not in NUMERIC_FIELDS} for e in tl.events]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), 1e-30)))


def _param_err(got, want):
    """(worst max |difference| over the leaf's max |value|, its leaf)."""
    assert sorted(got) == sorted(want)
    worst = (0.0, "")
    for k in sorted(want):
        w, g = np.asarray(want[k]), got[k].cpu().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        worst = max(worst, (float(np.abs(g - w).max() / np.abs(w).max()), k))
    return worst


@pytest.mark.parametrize("name", sorted(TWINS))
def test_async_numeric_twin_matches_jax(name, jax_warm_start):
    want = _run_jax(name)
    got = _run_port(name)
    assert _timing_rows(got) == _timing_rows(want)
    gl, wl = got.losses(), want.losses()
    assert len(gl) == len(wl) == len(want.events)
    assert all(np.isfinite(gl))
    loss_err = _rel(gl, wl)
    p_err, p_key = _param_err(got.final_params, want.final_params)
    d_err = _rel([e.disagreement for e in got.events],
                 [e.disagreement for e in want.events])
    msg = (f"{name}: worst loss rel err {loss_err:.3e} (tol {LOSS_RTOL}), "
           f"worst param err {p_err:.3e} at {p_key} (tol {PARAM_RTOL}), "
           f"disagreement {d_err:.3e} (tol {DISAGREEMENT_RTOL})")
    print(msg)
    assert loss_err <= LOSS_RTOL, msg
    assert p_err <= PARAM_RTOL, msg
    assert d_err <= DISAGREEMENT_RTOL, msg
    assert all(e.param_hash for e in got.events)
    assert len(got.wall) == len(got.events)
    assert all(w["publish_s"] > 0 for w in got.wall)
    if name != "engine_294_attacked":
        assert gl[-1] < gl[0], (name, gl)


def test_async_churn_rejoin_in_the_port():
    """``tests/test_engine.py:280``'s assertions on the port's run."""
    tl = _run_port("engine_280_churn", spec_cls=P.QuadraticSpec)
    c0 = [e.round for e in tl.events if e.cluster == 0]
    assert 2 not in c0 and 3 not in c0
    assert len([e for e in tl.events if e.rejoined == (0,)]) == 1
    assert tl.losses()[-1] < tl.losses()[0]


def test_trimmed_mean_defends_against_byzantine_member_in_the_port():
    """``tests/test_engine.py:294``'s claim on the port's runs (its own
    arrays): the attack damages the plain mean; trimming restores
    near-honest convergence."""
    tail = lambda name: float(np.mean(_run_port(
        name, spec_cls=P.QuadraticSpec).losses()[-3:]))
    honest = tail("engine_294_honest")
    attacked = tail("engine_294_attacked")
    defended = tail("engine_294_defended")
    assert attacked > 5 * honest
    assert abs(defended - honest) < 0.2 * abs(attacked - honest)


@pytest.mark.parametrize("name", ["engine_237_straggler",
                                  "engine_294_defended",
                                  "lowrank_churn_trimmed"])
def test_async_numeric_runs_are_bitwise_deterministic(name):
    a = _run_port(name, spec_cls=P.QuadraticSpec)
    b = _run_port(name, spec_cls=P.QuadraticSpec)
    assert a.fingerprint() == b.fingerprint()
    assert [e.param_hash for e in a.events] == [e.param_hash
                                                 for e in b.events]
    assert P.tree_hash(a.final_params) == P.tree_hash(b.final_params)
    if name == "engine_237_straggler":
        # versions ahead of their publisher's commit are mixed: a used
        # index is at least round - staleness
        ahead = sum(1 for e in a.events for p, s in e.staleness
                    if p != e.cluster and e.round - s > e.round_clock[p])
        assert ahead > 0


# ---------------------------------------------------------------------------
# the executor's contract
# ---------------------------------------------------------------------------

def _executor(name, spec_kw=None):
    build, kw = TWINS[name]
    sc = build(P)
    prob = P.QuadraticSpec(**(spec_kw or kw)).problem("cpu")
    comp = PS.make_compressor(sc.compressor, **sc.compressor_kw)
    W = PM.async_mix_weights(sc.topo())
    return sc, prob, PS._AsyncNumeric(sc, prob, comp, W)


def test_store_miss_raises():
    sc, _, ex = _executor("engine_221_star")
    ex.publish(0, 0, 1.0)
    ev = P.AsyncCommit(cluster=0, round=0, t_start=0.0, t_compute=1.0,
                       t_send=0.1, wait=0.0, t_commit=1.0,
                       used=((0, 0), (1, 0)), staleness=((0, 0), (1, 0)),
                       alive=(0, 1, 2, 3), rejoined=(), round_clock=(0, -1,
                                                                   -1, -1),
                       avail=(-1, -1, -1, -1))
    with pytest.raises(RuntimeError, match="store miss"):
        ex.commit(ev)


def _refusal(m, prob_edit=None, **sc_kw):
    spec = (J.QuadraticSpec if m is J else P.QuadraticSpec)(
        n_clusters=4, d=8, h_steps=4, seed=1)
    prob = spec.problem() if m is J else spec.problem("cpu")
    if prob_edit:
        prob_edit(prob)
    try:
        m.simulate(_async_sc(m, **_LOWRANK, **sc_kw), numeric=prob)
    except ValueError as e:
        return str(e)
    return None


REFUSALS = {
    "no_inner_fn_row": (lambda p: setattr(p, "inner_fn_row", None), {}),
    "compress_off": (lambda p: setattr(p, "compress", False), {}),
    "error_feedback_off": (lambda p: setattr(p, "error_feedback", False),
                           {}),
    "dynamic_topology": (None, dict(topology="random",
                                    topology_seed_schedule=(0, 1))),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_async_refusals_keep_jax_messages(name):
    edit, sc_kw = REFUSALS[name]
    want = _refusal(J, edit, **sc_kw)
    assert want is not None
    assert _refusal(P, edit, **sc_kw) == want


def test_adaptive_and_rank_schedule_refused_under_bounded_stale():
    sc = _async_sc(P)
    with pytest.raises(ValueError, match="no global round clock"):
        P.simulate(sc, rank_schedule=[4] * sc.rounds)
    with pytest.raises(ValueError, match="no global round clock"):
        P.simulate(sc, adaptive_cfg=object())


def _storages(ex, c):
    trees = (ex.params[c], ex.inner_opt[c], ex.outer_opt[c], ex.error[c],
             ex.comp[c])
    return {x.untyped_storage().data_ptr() for t in trees
            for x in T.leaves(t) if isinstance(x, torch.Tensor)
            and x.numel()}


def _pristine(ex):
    return (P.tree_hash(ex._inner0), P.tree_hash(ex._comp0))


@pytest.mark.parametrize("name", ["engine_280_churn",
                                  "lowrank_churn_trimmed"])
def test_clusters_own_their_state_and_rejoin_from_pristine_copies(name):
    sc, prob, ex = _executor(name)
    inner0, comp0 = _pristine(ex)
    assert P.tree_hash(prob.inner_opt_stacked) == P.tree_hash(
        P.QuadraticSpec(**TWINS[name][1]).problem("cpu").inner_opt_stacked)
    joins = []

    def on_join(c, k, t):
        ex.on_join(c, k, t)
        joins.append(c)
        # the rejoiner starts from the initial inner state and warm start
        assert P.tree_hash(ex.inner_opt[c]) == P.tree_hash(ex._inner0[c])
        assert P.tree_hash(ex.comp[c]) == P.tree_hash(ex._comp0)
        assert not any(x.any() for x in T.leaves(ex.error[c]))

    def commit(ev):
        ex.commit(ev)
        sets = [_storages(ex, c) for c in range(ex.C)]
        for a in range(ex.C):
            for b in range(a + 1, ex.C):
                assert not sets[a] & sets[b], (ev.cluster, ev.round, a, b)

    comp = PS.make_compressor(sc.compressor, **sc.compressor_kw)
    W = PM.async_mix_weights(sc.topo())
    peers = [tuple(p for p in range(ex.C) if p != c and W[c, p] > 0)
             for c in range(ex.C)]
    wire = int(comp.wire_bytes(sc.shapes(), rank=sc.rank))
    leg_s, send_s, _ = P.async_modeled_times(sc, wire, sc.topo())
    P.BoundedStaleEngine(
        n_clusters=ex.C, rounds=sc.rounds, max_staleness=sc.max_staleness,
        peers=peers, leg_seconds=leg_s, send_seconds=send_s, commit=commit,
        on_publish=ex.publish, leaves=sc.faults.leave_events(),
        joins=sc.faults.join_events(), on_leave=ex.on_leave,
        on_join=on_join).run()
    assert joins
    assert _pristine(ex) == (inner0, comp0)
    # the inner state moved: the clusters wrote their own copies
    assert P.tree_hash(ex.inner_opt[0]) != P.tree_hash(ex._inner0[0])


# ---------------------------------------------------------------------------
# the disagreement on the device, the trimmed mean's chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_device_disagreement_equals_numpy(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    C = 3 + seed % 3
    trees = [{"a": torch.from_numpy(rng.standard_normal((17, 9))
                                    .astype(np.float32)),
              "b": [torch.from_numpy(rng.standard_normal(1000 + seed)
                                     .astype(np.float32)) * 3,
                    torch.from_numpy(rng.standard_normal(5)
                                     .astype(np.float32)) + 1e3]}
             for _ in range(C)]
    alive = rng.random(C) > 0.3
    alive[seed % C] = True
    flat = np.stack([np.concatenate([x.numpy().reshape(-1)
                                     for x in T.leaves(t)]) for t in trees])
    want = j_consensus_distance(flat, alive)
    assert want == PM.consensus_distance(flat, alive)
    for chunk in (1 << 24, 7, 64):
        monkeypatch.setattr(PM, "_DIST_CHUNK", chunk)
        got = PM.consensus_distance_trees(trees, alive)
        assert abs(got - want) <= DIST_RTOL * want, (chunk, got, want)
    assert PM.consensus_distance_trees(trees, np.zeros(C, bool)) == 0.0
    one = np.zeros(C, bool)
    one[0] = True
    assert PM.consensus_distance_trees(trees, one) == 0.0


@pytest.mark.parametrize("trim", [1, 2])
@pytest.mark.parametrize("seed", range(3))
def test_trimmed_mean_does_not_depend_on_its_chunk(seed, trim, monkeypatch):
    gen = torch.Generator().manual_seed(seed)
    C = 6
    tree = {"w": torch.randn(C, 37, 11, generator=gen),
            "b": torch.randn(C, 129, generator=gen),
            "s": torch.randn(C, generator=gen)}
    tree["w"][2, 3] = tree["w"][4, 3]          # ties across rows
    masks = [np.ones(C, np.float32),
             (np.arange(C) % 3 != 1).astype(np.float32)]
    for m in masks:
        want = MB.trimmed_cluster_mean(tree, m, trim)
        for cols in (1, 5, 64, 400):
            monkeypatch.setattr(MB, "_SORT_COLS", cols)
            got = MB.trimmed_cluster_mean(tree, m, trim)
            for k in tree:
                assert torch.equal(got[k], want[k]), (k, cols)
        monkeypatch.undo()
