"""Port parity for the simulator's numeric leg (``repro_torch.sim``, barrier
mode, the quadratic problem on the CPU) against the JAX package.

The JAX package draws the quadratic's arrays and ``LowRankQuant``'s warm
start from ``jax.random``; both are carried into the port: the arrays
through ``_arrays`` on a test-side ``QuadraticSpec`` subclass (no new
field, so ``to_dict()`` is unchanged), the warm start through a wrapper
around the compressor the port's ``simulate`` builds
(``simulator.make_compressor`` patched).

- Numeric twins of ``tests/test_sim.py:42``, ``:155``, ``:166``, ``:189``,
  ``tests/test_h_schedule.py:124``, ``:139``, ``:162``, ``:244`` and
  ``tests/test_topology.py:219`` (plus a gossip leave/rejoin, which runs
  the consensus bootstrap): the timeline with its numeric fields taken out
  equal to JAX's field for field; every round's loss within
  ``LOSS_RTOL`` of JAX's and the final params within ``PARAM_RTOL`` (max
  abs difference over the leaf's max abs value).  JAX jits its round and
  XLA sums the clip norm and the loss in another order, so the two differ
  by f32 ulps (``param_hash`` therefore differs); a factor within ulps of
  an int4 boundary can land one code apart (ROADMAP §C), which the
  ``compress=False`` legs separate out.
- The port against itself: the same scenario twice gives the same
  fingerprint, ``param_hash`` included; a uniform balance schedule is bit
  for bit the scalar-H path; each row of the stacked inner function is bit
  for bit the lone-cluster function; a rejoined cluster's inner moments
  are zero and its warm start is ``comp0`` bit for bit when it next runs.
- The JAX package's numeric refusals (``simulator.py:199-252``: engine
  mismatch, gossip or balance without the inner function it needs) keep
  their messages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as J
import repro_torch.sim as P
import repro_torch.sim.simulator as PS
from repro.core import compression as JC
from repro.core.adaptive import HSpec as JHSpec
from repro_torch import tree as T
from repro_torch.core import diloco as D
from repro_torch.core.adaptive import HSpec as PHSpec
from repro_torch.core.compression import make_compressor

# measured worst cases over the twins below (CPU): losses 2.0e-6 relative
# (sim_166_straggler_churn), params 2.0e-6 of the leaf's max (sim_155)
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
NUMERIC_FIELDS = ("loss", "param_hash", "disagreement")
DISAGREEMENT_RTOL = 1e-4


class CarriedSpec(P.QuadraticSpec):
    """The port's ``QuadraticSpec`` with the JAX package's arrays."""

    def _arrays(self):
        js = J.QuadraticSpec(**dataclasses.asdict(self))
        to = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in
                        d.items()}
        return tuple(to(d) for d in js._arrays())


class _JaxWarmStart:
    """Delegates to the port's compressor; ``init_state`` returns the JAX
    package's warm start for the same params."""

    def __init__(self, compressor, name, kw):
        self._c, self._name, self._kw = compressor, name, kw

    def __getattr__(self, attr):
        return getattr(self._c, attr)

    def init_state(self, params):
        jc = JC.make_compressor(self._name, **self._kw)
        st = jc.init_state({k: jnp.asarray(v.cpu().numpy())
                            for k, v in params.items()})
        dev = T.leaves(params)[0].device
        return jax.tree.map(lambda x: torch.from_numpy(np.array(x)).to(dev),
                            st)


@pytest.fixture
def jax_warm_start(monkeypatch):
    make = PS.make_compressor
    monkeypatch.setattr(PS, "make_compressor", lambda name, **kw:
                        _JaxWarmStart(make(name, **kw), name, kw))


def _hspec(m, **kw):
    return (JHSpec if m is J else PHSpec)(**kw)


def _clean(m, **kw):
    base = dict(n_clusters=4, rounds=6, h_steps=10, t_step_s=1.0,
                n_params=1e8, compressor="diloco_x",
                compressor_kw={"rank": 4, "min_dim_for_lowrank": 8}, seed=3)
    base.update(kw)
    return m.Scenario(**base)


def _hsched(m, **kw):
    base = dict(n_clusters=3, rounds=4, h_steps=4, t_step_s=0.05,
                link=m.LinkProfile(bytes_per_s=200_000),
                compressor="diloco_x",
                compressor_kw={"rank": 4, "min_dim_for_lowrank": 8}, rank=4,
                n_params=1e5, seed=0)
    base.update(kw)
    return m.Scenario(**base)


def _fs(m, *events):
    return m.FaultSchedule(tuple(e(m) for e in events))


def _topo_219(m, **kw):
    return m.Scenario(n_clusters=4, rounds=6, h_steps=4, t_step_s=0.05,
                      link=m.LinkProfile(bytes_per_s=200_000),
                      compressor="diloco_x",
                      compressor_kw={"rank": 4, "min_dim_for_lowrank": 8},
                      rank=4, n_params=1e5, topology="ring", seed=0, **kw)


# name -> (scenario builder of a module, QuadraticSpec kwargs, compress)
TWINS = {
    "sim_42_churn": (lambda m: _clean(m, rounds=6, h_steps=4, faults=_fs(
        m, lambda m: m.Straggler(1, 2, 4, 3.0), lambda m: m.Leave(2, 3),
        lambda m: m.Join(2, 5))), dict(n_clusters=4, h_steps=4), True),
    "sim_42_churn_uncompressed": (lambda m: _clean(
        m, rounds=6, h_steps=4, faults=_fs(
            m, lambda m: m.Straggler(1, 2, 4, 3.0), lambda m: m.Leave(2, 3),
            lambda m: m.Join(2, 5))), dict(n_clusters=4, h_steps=4), False),
    "sim_155_converges": (lambda m: _clean(m, rounds=12, h_steps=6),
                          dict(n_clusters=4, h_steps=6), True),
    "sim_166_straggler_churn": (lambda m: _clean(
        m, rounds=14, h_steps=6, link=m.LinkProfile(jitter=0.05),
        faults=_fs(m, lambda m: m.Straggler(1, 3, 6, slowdown=4.0),
                   lambda m: m.Leave(2, 4), lambda m: m.Join(2, 9))),
        dict(n_clusters=4, h_steps=6), True),
    "sim_189_base": (lambda m: _clean(m, n_clusters=3, rounds=8, h_steps=4),
                     dict(n_clusters=3, h_steps=4, seed=1), True),
    "sim_189_leave": (lambda m: _clean(
        m, n_clusters=3, rounds=8, h_steps=4,
        faults=_fs(m, lambda m: m.Leave(0, 4))),
        dict(n_clusters=3, h_steps=4, seed=1), True),
    "h_124_global": (lambda m: _hsched(m),
                     dict(n_clusters=3, d=8, h_steps=4), True),
    "h_124_balance": (lambda m: _hsched(m, h_spec=_hspec(
        m, policy="balance")), dict(n_clusters=3, d=8, h_steps=4), True),
    "h_139_straggler_balance": (lambda m: _hsched(
        m, rounds=6, faults=_fs(m, lambda m: m.Straggler(1, 1, 5, 4.0)),
        h_spec=_hspec(m, policy="balance")),
        dict(n_clusters=3, d=8, h_steps=4), True),
    "h_162_ring_clamp": (lambda m: _hsched(
        m, n_clusters=4, topology="ring", rounds=4,
        faults=_fs(m, lambda m: m.Straggler(1, 1, 4, 6.0)),
        h_spec=_hspec(m, policy="balance")),
        dict(n_clusters=4, d=8, h_steps=4), True),
    "h_244_dynamic_random": (lambda m: _hsched(
        m, n_clusters=4, rounds=6, topology="random",
        topology_seed_schedule=(0, 1, 2)),
        dict(n_clusters=4, d=8, h_steps=4), True),
    "topology_219_ring": (lambda m: _topo_219(m),
                          dict(n_clusters=4, d=8, h_steps=4), True),
    "topology_219_ring_uncompressed": (lambda m: _topo_219(m),
                                       dict(n_clusters=4, d=8, h_steps=4),
                                       False),
    "ring_leave_rejoin": (lambda m: _topo_219(m, faults=_fs(
        m, lambda m: m.Leave(2, 2), lambda m: m.Join(2, 4))),
        dict(n_clusters=4, d=8, h_steps=4), True),
}


def _run_jax(name):
    build, spec_kw, compress = TWINS[name]
    prob = J.QuadraticSpec(**spec_kw).problem()
    prob.compress = compress
    return J.simulate(build(J), numeric=prob)


def _run_port(name, device="cpu", spec_cls=CarriedSpec):
    build, spec_kw, compress = TWINS[name]
    prob = spec_cls(**spec_kw).problem(device)
    prob.compress = compress
    return P.simulate(build(P), numeric=prob)


def _timing_rows(tl):
    return [{k: v for k, v in dataclasses.asdict(e).items()
             if k not in NUMERIC_FIELDS} for e in tl.events]


def _rel(got, want):
    scale = np.maximum(np.abs(want), 1e-30)
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64)) / scale))


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
def test_numeric_twin_matches_jax(name, jax_warm_start):
    want = _run_jax(name)
    got = _run_port(name)
    assert _timing_rows(got) == _timing_rows(want)
    gl, wl = got.losses(), want.losses()
    assert len(gl) == len(wl) == len(want.events)
    assert all(np.isfinite(gl))
    loss_err = _rel(gl, wl)
    p_err, p_key = _param_err(got.final_params, want.final_params)
    msg = (f"{name}: worst loss rel err {loss_err:.3e} (tol {LOSS_RTOL}), "
           f"worst param err {p_err:.3e} at {p_key} (tol {PARAM_RTOL})")
    assert loss_err <= LOSS_RTOL, msg
    assert p_err <= PARAM_RTOL, msg
    if want.events[0].disagreement is not None:
        d_err = _rel([e.disagreement for e in got.events],
                     [e.disagreement for e in want.events])
        assert d_err <= DISAGREEMENT_RTOL, (msg, d_err)
    # every round carries a hash of its params; the port's are its own
    assert all(e.param_hash is not None for e in got.events)
    if name in CONVERGES:        # the JAX test's own claim, in the port
        assert gl[-1] < CONVERGES[name] * gl[0], (name, gl)
    print(msg)


CONVERGES = {"sim_155_converges": 0.3, "sim_166_straggler_churn": 0.3,
             "h_139_straggler_balance": 1.0, "h_244_dynamic_random": 1.0,
             "topology_219_ring": 1.0}


def test_churn_changes_losses_only_after_leave():
    """``tests/test_sim.py:189`` in the port: before the Leave round the
    churn run is bit for bit the clean one, after it the losses move."""
    base = _run_port("sim_189_base", spec_cls=P.QuadraticSpec)
    churn = _run_port("sim_189_leave", spec_cls=P.QuadraticSpec)
    assert base.losses()[:4] == churn.losses()[:4]
    assert ([e.param_hash for e in base.events[:4]]
            == [e.param_hash for e in churn.events[:4]])
    assert not np.allclose(base.losses()[4:], churn.losses()[4:], rtol=1e-6)


@pytest.mark.parametrize("name", ["sim_42_churn", "h_139_straggler_balance",
                                  "ring_leave_rejoin"])
def test_numeric_runs_are_deterministic(name):
    a = _run_port(name, spec_cls=P.QuadraticSpec)
    b = _run_port(name, spec_cls=P.QuadraticSpec)
    assert a.fingerprint() == b.fingerprint()
    assert a.structural_fingerprint() == b.structural_fingerprint()
    assert [e.param_hash for e in a.events] == [e.param_hash
                                                 for e in b.events]
    assert len({e.param_hash for e in a.events}) == len(a.events)


def test_uniform_h_vector_bitwise_equals_scalar_path():
    """``tests/test_h_schedule.py:124`` in the port: a fault-free balance
    run plans the uniform h_base vector and runs the scalar program, bit
    for bit the global run; ``diloco_round_h`` with that uniform vector
    through ``inner_fn_h`` is bit for bit the scalar round too."""
    a = _run_port("h_124_global", spec_cls=P.QuadraticSpec)
    b = _run_port("h_124_balance", spec_cls=P.QuadraticSpec)
    assert [e.h_by for e in b.events] == [(4, 4, 4)] * 4
    assert [e.param_hash for e in a.events] == [e.param_hash
                                                 for e in b.events]
    spec = P.QuadraticSpec(n_clusters=3, d=8, h_steps=4)
    states = []
    for use_h in (False, True):
        prob = spec.problem("cpu")
        comp = make_compressor("diloco_x", rank=4, min_dim_for_lowrank=8)
        st = D.init_state(prob.params, prob.inner_opt_stacked, 3, comp)
        cm = lambda tree: T.tree_map(lambda x: x.mean(0), tree)
        cfg = D.RoundConfig(outer_lr=0.7, outer_momentum=0.5)
        for _ in range(3):
            if use_h:
                st, _ = D.diloco_round_h(st, prob.inner_fn_h, comp, cm, cfg,
                                         np.full(3, 4, np.int32))
            else:
                st, _ = D.diloco_round(st, prob.inner_fn, comp, cm, cfg)
        states.append(P.tree_hash(st))
    assert states[0] == states[1]


def test_rows_are_the_lone_cluster_function_bitwise():
    spec = P.QuadraticSpec(n_clusters=3, d=8, h_steps=4, seed=2)
    prob = spec.problem("cpu")
    one = spec.one_cluster_fn("cpu")
    one_h = spec.one_cluster_fn_h("cpu")
    fresh = lambda: spec.problem("cpu").inner_opt_stacked

    def row(opt, c):
        return type(opt)(step=opt.step[c], m=D.take_row(opt.m, c),
                         v=D.take_row(opt.v, c))

    p_s, o_s, losses = prob.inner_fn(prob.params, fresh(), 0)
    h_vec = np.array([4, 1, 3], np.int32)
    ph_s, oh_s, means = prob.inner_fn_h(prob.params, fresh(), 0, h_vec)
    stacked = D.stack_replicas(prob.params, 3)
    pst, _, _ = prob.inner_fn_stacked(stacked, fresh(), 0)
    for c in range(3):
        p, o, l = one(prob.params, row(fresh(), c), c)
        assert P.tree_hash(p) == P.tree_hash(D.take_row(p_s, c))
        assert P.tree_hash(p) == P.tree_hash(D.take_row(pst, c))
        assert P.tree_hash(o) == P.tree_hash(row(o_s, c))
        assert torch.equal(l, losses[c])
        ph, oh, mean = one_h(prob.params, row(fresh(), c), c, h_vec[c])
        assert P.tree_hash(ph) == P.tree_hash(D.take_row(ph_s, c))
        assert P.tree_hash(oh) == P.tree_hash(row(oh_s, c))
        assert torch.equal(mean, means[c])
        assert int(oh.step) == h_vec[c]
    # h == h_steps through the masked path is the scalar function
    ph, _, _ = one_h(prob.params, row(fresh(), 0), 0, 4)
    assert P.tree_hash(ph) == P.tree_hash(D.take_row(p_s, 0))
    # the inner functions do not touch the params they start from
    assert P.tree_hash(prob.params) == P.tree_hash(spec.init_params("cpu"))


def test_rejoin_reinitializes_the_fresh_worker(monkeypatch):
    """At the rejoin round the rejoined cluster's inner moments and step
    are zero when its inner leg starts, and the warm start it compresses
    with is ``comp0`` bit for bit (not zero); the other rows keep theirs."""
    make = PS.make_compressor
    seen = []

    class Recording:
        def __init__(self, c):
            self._c = c

        def __getattr__(self, attr):
            return getattr(self._c, attr)

        def roundtrip(self, tree, state, rank_scalar=None):
            seen.append(("comp", T.leaves(state)))
            return self._c.roundtrip(tree, state, rank_scalar)

    monkeypatch.setattr(PS, "make_compressor",
                        lambda name, **kw: Recording(make(name, **kw)))
    spec = P.QuadraticSpec(n_clusters=4, d=16, h_steps=4)
    prob = spec.problem("cpu")
    inner = prob.inner_fn

    def recording_inner(params, opt, t):
        seen.append(("inner", int(t), T.tree_map(torch.clone, opt)))
        return inner(params, opt, t)

    prob.inner_fn = recording_inner
    sc = _clean(P, rounds=6, h_steps=4, faults=_fs(
        P, lambda m: m.Leave(2, 2), lambda m: m.Join(2, 4)))
    tl = P.simulate(sc, numeric=prob)
    assert tl.events[4].rejoined == (2,)
    comp0 = make("diloco_x", rank=4, min_dim_for_lowrank=8).init_state(
        spec.init_params("cpu"))
    inner_calls = [s for s in seen if s[0] == "inner"]
    comp_calls = [s for s in seen if s[0] == "comp"]
    assert len(inner_calls) == 6 and len(comp_calls) == 6 * 4
    opt = inner_calls[4][2]
    assert inner_calls[4][1] == 4
    for x in T.leaves(opt):
        assert not x[2].any()                       # moments and step zero
        assert x[0].any()                           # a live row keeps its
    rejoin_state = comp_calls[4 * 4 + 2][1]         # round 4, cluster 2
    low_rank = [x for x in T.leaves(comp0) if x.numel()]
    assert low_rank
    for got, want in zip(rejoin_state, T.leaves(comp0)):
        assert torch.equal(got, want)
    assert any(not torch.equal(g, w) for g, w in zip(
        comp_calls[4 * 4 + 0][1], T.leaves(comp0)) if w.numel())


def test_problem_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is legitimate here")
    spec = P.QuadraticSpec(n_clusters=2)
    for call in (spec.problem, spec.init_params,
                 lambda: P.make_quadratic_problem(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# numeric refusals of the JAX package (simulator.py:199-252): the problem
# and the scenario disagree; each case edits a fresh problem of a module
NUMERIC_REFUSALS = {
    "engine_mismatch": (dict(inner_engine="pp"), {}),
    "gossip_without_stacked_inner": (dict(topology="ring", n_clusters=4),
                                     {"inner_fn_stacked": None}),
    "gossip_balance_without_stacked_h": (
        dict(topology="ring", n_clusters=4), {"inner_fn_h_stacked": None}),
    "balance_without_inner_fn_h": (dict(), {"inner_fn_h": None}),
}


@pytest.mark.parametrize("name", sorted(NUMERIC_REFUSALS))
def test_numeric_refusals_keep_jax_messages(name):
    sc_kw, edits = NUMERIC_REFUSALS[name]
    n = sc_kw.get("n_clusters", 3)

    def run(m, prob):
        for k, v in edits.items():
            setattr(prob, k, v)
        kw = dict(sc_kw)
        if "balance" in name:
            kw["h_spec"] = _hspec(m, policy="balance")
        try:
            m.simulate(_hsched(m, **kw), numeric=prob)
        except ValueError as e:
            return str(e)
        return None

    want = run(J, J.QuadraticSpec(n_clusters=n, d=8, h_steps=4).problem())
    got = run(P, P.QuadraticSpec(n_clusters=n, d=8, h_steps=4).problem("cpu"))
    assert want is not None and got == want
