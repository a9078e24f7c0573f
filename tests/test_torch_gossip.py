"""Port parity for the gossip layer: ``repro_torch.topology.mixing``'s mix
operators and ``mixing_op``, and ``core.diloco``'s gossip mode,
``diloco_round_h`` and churn, against the JAX package.

- ``mix_row(W[c])`` is bit for bit row c of ``mix_stacked``, and the
  port's ``mix_stacked`` bit for bit the JAX package's eager one.
- Gossip rounds on a ring and a 2 x 2 torus of 4 clusters, with the
  constant-displacement inner function of ``tests/test_topology.py``
  defined the same way in both packages: each round starts both from the
  same JAX state (the JAX warm start carried in through
  ``checkpoint.state_from_flat``), and the port's whole state after the
  round is held to JAX's eager round through ``state_to_flat``: bit for
  bit with the ``Identity`` compressor, rtol 1e-4 / atol 1e-6 with
  ``LowRankQuant`` (the two Cholesky-QRs differ by ulps, as in
  ``tests/test_torch_diloco.py``).
- Churn on reduced opt-1.3b (vocab 64), 2 clusters, cluster 1 dead in
  round 1, ``make_inner_fn`` fed the JAX trainer's batches: the losses
  within the trainer tests' rtol 1e-4, and each round's state leaf by
  leaf within rtol 1e-4 of the jitted JAX round's in the Frobenius norm
  (as ``chip_smoke.py`` holds gradients; AdamW's m / sqrt(v) amplifies
  the grads' summation-order ulps at elements with tiny gradients, a few
  of 16,384 in the embedding reach 2e-3 relative), integer leaves equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.configs.base import get_config as jax_get_config
from repro.core import compression as JC
from repro.core import diloco as JD
from repro.core import membership as JMB
from repro.data import synthetic as JS
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.topology import make_topology as jtopo
from repro.topology import mixing as JX
from repro.train import trainer as JT
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core import compression as C
from repro_torch.core import diloco as D
from repro_torch.core import membership as MB
from repro_torch.topology import make_topology as ptopo
from repro_torch.topology import mixing as PX
from repro_torch.train import trainer as TT

NC = 4
TOL = dict(rtol=1e-4, atol=1e-6)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return {"w": f(80, 72), "b": f(16), "segments": [{"x": f(2, 70, 66)}]}


def _stacked(seed, n=NC):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.standard_normal((n,) + x.shape) * 0.05).astype(
            np.float32), _params())


def _t(tree):
    return T.tree_map(torch.from_numpy, tree)


def _flat_norm_close(got, want, rtol, msg=""):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        if not np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_array_equal(got[k], want[k], err_msg=msg + k)
            continue
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        err, ref = np.linalg.norm(g - w), np.linalg.norm(w)
        assert err <= rtol * ref, (msg + k, err, ref)


def _flat_equal(got, want, tol=None, msg=""):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        if tol is None:
            np.testing.assert_array_equal(got[k], want[k], err_msg=msg + k)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=msg + k,
                                       **tol)


# ---------------------------------------------------------------------------
# the mix operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,n,seed", [("random", 6, 1), ("ring", 4, 0),
                                         ("torus", 9, 0), ("ring", 7, 0),
                                         ("random", 8, 3)])
def test_mix_row_matches_mix_stacked_bitwise(kind, n, seed):
    W = PX.MixingMatrix.metropolis(ptopo(kind, n, seed=seed)).W
    tree = _stacked(seed, n)
    full = PX.mix_stacked(W, _t(tree))
    parts = [D.take_row(_t(tree), j) for j in range(n)]
    for c in range(n):
        row = PX.mix_row(W[c], parts)
        into = T.tree_map(torch.empty_like, row)
        PX.mix_row(torch.from_numpy(W)[c], parts, out=into)
        for (k, x), (_, y), (_, z) in zip(T.keystr_items(row),
                                          T.keystr_items(D.take_row(full, c)),
                                          T.keystr_items(into)):
            assert torch.equal(x, y) and torch.equal(x, z), (c, k)
    want = JX.mix_stacked(jnp.asarray(W), jax.tree.map(jnp.asarray, tree))
    _flat_equal(ckpt.params_to_flat(full), jflatten(want))
    # the output aliases no input row
    ins = {x.data_ptr() for x in T.leaves(_t(tree))}
    assert not ins & {x.data_ptr() for x in T.leaves(full)}


@pytest.mark.parametrize("kind", ["star", "full", "ring", "torus", "random"])
def test_mixing_op_matches_jax(kind):
    n = 6
    tree = _stacked(7, n)
    for dead in (None, 3):
        alive = np.ones(n, bool)
        if dead is not None:
            alive[dead] = False
        jop = JX.mixing_op(jtopo(kind, n, seed=1), alive)
        op = PX.mixing_op(ptopo(kind, n, seed=1), alive)
        assert op.returns_stacked == jop.returns_stacked
        assert op.matrix.W.tobytes() == jop.matrix.W.tobytes()
        assert op.topology.edges == jop.topology.edges
        got = op(_t(tree))
        want = jop(jax.tree.map(jnp.asarray, tree))
        _flat_equal(ckpt.params_to_flat(got), jflatten(want))
        if not op.returns_stacked:
            # gather kinds: the membership-masked mean
            mean = MB.masked_cluster_mean(_t(tree), alive.astype(np.float32))
            for x, y in zip(T.leaves(got), T.leaves(mean)):
                assert torch.equal(x, y)
        elif dead is not None:
            # a dead cluster's row passes through the mix bit for bit
            for x, y in zip(T.leaves(D.take_row(got, dead)),
                            T.leaves(D.take_row(_t(tree), dead))):
                assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# gossip rounds: the constant-displacement inner function in both packages
# ---------------------------------------------------------------------------

STEPS = _stacked(11)


def _jax_inner(params, inner_opt, t):
    new = jax.tree.map(lambda p, s: p - s, params,
                       jax.tree.map(jnp.asarray, STEPS))
    return new, inner_opt, np.zeros(1)


def _port_inner(params, inner_opt, t):
    new = T.tree_map(lambda p, s: p - s, params, _t(STEPS))
    return new, inner_opt, torch.zeros(1)


def _comps(name):
    if name == "identity":
        return JC.Identity(), C.Identity()
    return (JC.LowRankQuant(rank=8),
            C.LowRankQuant(rank=8, backend=name.split("-")[1]))


def _jax_gossip_state(jcomp):
    p = jax.tree.map(jnp.asarray, _params())
    return JD.init_state(JD.stack_replicas(p, NC), {}, NC, jcomp,
                         stacked_params=True)


def _port_like(comp):
    return D.init_state(D.stack_replicas(_t(_params()), NC), {}, NC, comp,
                        stacked_params=True)


def test_gossip_init_state_matches_jax():
    """The stacked-params state: the same keys, shapes and dtypes as JAX's,
    params stacked, outer momentum, pending and EF zero and stacked; the
    compressor's warm starts one per cluster, from row 0's shapes."""
    jcomp, comp = _comps("lowrank-pallas")
    want = jflatten(_jax_gossip_state(jcomp))
    got = ckpt.state_to_flat(_port_like(comp))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        if not k.startswith(".comp_state"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="lead dim"):
        D.init_state(D.stack_replicas(_t(_params()), 3), {}, NC, comp,
                     stacked_params=True)


@pytest.mark.parametrize("comp_name", ["identity", "lowrank-ref",
                                       "lowrank-pallas"])
@pytest.mark.parametrize("delay", [True, False])
@pytest.mark.parametrize("kind", ["ring", "torus"])
def test_gossip_rounds_track_jax(kind, delay, comp_name):
    """Three rounds; in round 1 cluster 3 is dead (the masked matrix)."""
    jcomp, comp = _comps(comp_name)
    cfg = dict(delay=delay, outer_lr=0.7, outer_momentum=0.9)
    jcfg, pcfg = JD.RoundConfig(**cfg), D.RoundConfig(**cfg)
    tol = None if comp_name == "identity" else TOL
    jstate = _jax_gossip_state(jcomp)
    for rnd in range(3):
        alive = np.ones(NC, bool)
        if rnd == 1:
            alive[3] = False
        jop = JX.mixing_op(jtopo(kind, NC), alive)
        op = PX.mixing_op(ptopo(kind, NC), alive)
        assert op.returns_stacked
        flat = jflatten(jstate)
        state = ckpt.state_from_flat(flat, _port_like(comp))
        state, aux = D.diloco_round(state, _port_inner, comp, op, pcfg)
        jstate, jaux = JD.diloco_round(jstate, _jax_inner, jcomp, jop, jcfg)
        _flat_equal(ckpt.state_to_flat(state), jflatten(jstate), tol,
                    f"{rnd} ")
    # replicas saw different neighborhoods: the rows differ
    rows = state.params["w"]
    assert (rows - rows.mean(0)).abs().max() > 1e-4


def test_gossip_mean_trajectory_equals_gather():
    """Twin of the JAX test: with a doubly-stochastic mix and the linear
    Nesterov outer step, the cluster mean of the gossip trajectory equals
    the gather trajectory; the replicas themselves diverge."""
    n = 4
    steps = {"w": torch.from_numpy(
        (np.linspace(0.1, 0.4, n)[:, None] * np.ones((n, 3))).astype(
            np.float32))}
    params0 = {"w": torch.zeros(3)}
    comp = C.Identity()
    cfg = D.RoundConfig(outer_lr=0.7, outer_momentum=0.5, compress=False,
                        error_feedback=False)
    g_state = D.init_state(T.tree_map(torch.clone, params0), None, n, comp)
    gather_inner = lambda p, o, t: ({"w": p["w"][None] - steps["w"]}, o,
                                    torch.zeros(1))
    mean0 = lambda tree: {"w": tree["w"].mean(0)}
    s_state = D.init_state(D.stack_replicas(params0, n), None, n, comp,
                           stacked_params=True)
    stacked_inner = lambda p, o, t: ({"w": p["w"] - steps["w"]}, o,
                                     torch.zeros(1))
    op = PX.mixing_op(ptopo("ring", n), np.ones(n, bool))
    for _ in range(5):
        g_state, _ = D.diloco_round(g_state, gather_inner, comp, mean0, cfg)
        s_state, _ = D.diloco_round(s_state, stacked_inner, comp, op, cfg)
        np.testing.assert_allclose(s_state.params["w"].mean(0).numpy(),
                                   g_state.params["w"].numpy(), rtol=0,
                                   atol=1e-6)
    rows = s_state.params["w"].numpy()
    assert np.abs(rows - rows.mean(0)).max() > 1e-4


def test_gossip_needs_stacked_params():
    comp = C.Identity()
    params = _t(_params())
    gather = D.init_state(params, {}, NC, comp)
    op = PX.mixing_op(ptopo("ring", NC), np.ones(NC, bool))
    with pytest.raises(ValueError, match="stacked_params=True"):
        D.diloco_round(gather, _port_inner, comp, op, D.RoundConfig())
    with pytest.raises(ValueError, match="unstacked"):
        D.diloco_round(_port_like(comp), _port_inner, comp, TT.cluster_mean,
                       D.RoundConfig())


# ---------------------------------------------------------------------------
# diloco_round_h: per-cluster local-step counts
# ---------------------------------------------------------------------------

H = 3
TARGETS = _stacked(21, 2)


def _port_inner_h(params, inner_opt, t, h_vec):
    """Cluster c takes h_vec[c] steps p <- p - 0.25 (p - target_c)."""
    rows = []
    for c in range(2):
        tgt = D.take_row(_t(TARGETS), c)
        step = lambda p, i: (T.tree_map(lambda a, g: a - (a - g) * 0.25, p,
                                        tgt), torch.tensor(float(i)))
        p, _ = D.masked_local_steps(step, params, H, h_vec[c])
        rows.append(p)
    return T.tree_map(lambda *xs: torch.stack(xs), *rows), inner_opt, \
        torch.zeros(2)


def _jax_inner_h(params, inner_opt, t, h_vec):
    def one(tgt, h):
        step = lambda p, i: (jax.tree.map(lambda a, g: a - (a - g) * 0.25, p,
                                          tgt), i.astype(jnp.float32))
        return JD.masked_local_steps(step, params, H, h)[0]
    tgt = jax.tree.map(jnp.asarray, TARGETS)
    rows = [one(JD.take_row(tgt, c), h_vec[c]) for c in range(2)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *rows), inner_opt, \
        jnp.zeros(2)


def _gather_pair():
    jstate = JD.init_state(jax.tree.map(jnp.asarray, _params()), {}, 2,
                           JC.Identity())
    flat = jflatten(jstate)
    like = D.init_state(_t(_params()), {}, 2, C.Identity())
    return jstate, ckpt.state_from_flat(flat, like)


def test_diloco_round_h_uniform_is_diloco_round_bitwise():
    comp, cfg = C.Identity(), D.RoundConfig()
    _, a = _gather_pair()
    _, b = _gather_pair()
    plain = lambda p, o, t: _port_inner_h(p, o, t, [H, H])
    for r in range(3):
        a, _ = D.diloco_round_h(a, _port_inner_h, comp, TT.cluster_mean, cfg,
                                [H, H])
        b, _ = D.diloco_round(b, plain, comp, TT.cluster_mean, cfg)
        _flat_equal(ckpt.state_to_flat(a), ckpt.state_to_flat(b))


@pytest.mark.parametrize("h_vec", [(3, 3), (1, 3), (3, 2), (0, 1)])
def test_diloco_round_h_tracks_jax(h_vec):
    """Non-uniform schedules against the JAX round (its masked scan runs
    compiled, so the step's multiply-add may contract: rtol 1e-6)."""
    jstate, state = _gather_pair()
    comp, jcomp = C.Identity(), JC.Identity()
    for r in range(3):
        state, _ = D.diloco_round_h(state, _port_inner_h, comp,
                                    TT.cluster_mean, D.RoundConfig(), h_vec)
        jstate, _ = JD.diloco_round_h(jstate, _jax_inner_h, jcomp,
                                      JT.cluster_mean, JD.RoundConfig(),
                                      jnp.asarray(h_vec, jnp.int32))
        _flat_equal(ckpt.state_to_flat(state), jflatten(jstate),
                    dict(rtol=1e-6, atol=1e-7), f"{r} ")


# ---------------------------------------------------------------------------
# rejoin and churn
# ---------------------------------------------------------------------------

def test_rejoin_zeroes_exactly_that_clusters_rows():
    """After a compressed gossip round the pending deltas and EF rows are
    non-zero; ``reset_rejoining`` of cluster 2 zeroes exactly its rows (as
    JAX's on the same state) and the next round runs."""
    jcomp, comp = _comps("lowrank-pallas")
    op = PX.mixing_op(ptopo("ring", NC), np.ones(NC, bool))
    jstate = _jax_gossip_state(jcomp)
    state = ckpt.state_from_flat(jflatten(jstate), _port_like(comp))
    for _ in range(2):
        state, _ = D.diloco_round(state, _port_inner, comp, op,
                                  D.RoundConfig())
    before = {k: v.clone() for k, v in T.keystr_items(
        (state.delta_pending, state.error))}
    rejoined = np.array([False, False, True, False])
    jreset = JMB.reset_rejoining(
        jax.tree.map(jnp.asarray, ckpt.state_to_flat(state)),
        jnp.asarray(rejoined))
    MB.reset_rejoining(state.delta_pending, rejoined)
    MB.reset_rejoining(state.error, rejoined)
    got = ckpt.state_to_flat(state)
    for k, v in T.keystr_items((state.delta_pending, state.error)):
        assert before[k][2].abs().sum() > 0, k
        assert not v[2].any(), k
        for c in (0, 1, 3):
            assert torch.equal(v[c], before[k][c]), (k, c)
    for k in got:
        if k.startswith((".delta_pending", ".error")):
            np.testing.assert_array_equal(got[k], np.asarray(jreset[k]))
    state, _ = D.diloco_round(state, _port_inner, comp, op, D.RoundConfig())
    assert all(torch.isfinite(x).all() for x in T.leaves(state.params))


VOCAB, B, S, HS = 64, 8, 16, 4


def test_churn_reduced_lm_tracks_jax():
    """Twin of ``test_dropout_training_still_converges`` at 3 rounds:
    reduced opt-1.3b, 2 clusters, LowRankQuant(16, int4), cluster 1 dead in
    round 1; JAX's init_params, batches and warm start carried over."""
    jcfg = dataclasses.replace(jax_get_config("opt-1.3b").reduced(),
                               vocab_size=VOCAB)
    cfg = dataclasses.replace(get_config("opt-1.3b").reduced(),
                              vocab_size=VOCAB)
    kw = dict(n_clusters=2, local_batch=B, seq_len=S, inner_lr=3e-3,
              h_steps=HS, outer_lr=0.5, outer_momentum=0.7)
    jt = JT.TrainConfig(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jcomp = JC.make_compressor("diloco_x", rank=16, bits=4)
    comp = C.make_compressor("diloco_x", rank=16, bits=4, backend="pallas")
    inner0 = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape).copy(),
                          jadamw.init(jparams))
    jstate = JD.init_state(jparams, inner0, 2, jcomp)
    rcfg = dict(outer_lr=0.5, outer_momentum=0.7)
    table = JS.SyntheticLM(VOCAB, S, B, seed=0).table
    jinner = JT.make_inner_fn(jcfg, jt, table)

    @jax.jit
    def jround(state, alive):
        cm = lambda t: JMB.masked_cluster_mean(t, alive)
        return JD.diloco_round(state, jinner, jcomp, cm,
                               JD.RoundConfig(**rcfg), jnp.asarray(16))

    def batch_fn(c, r, h):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(jt.seed + 7), c), r), h)
        return np.asarray(JS._gen_batch(key, B, S, 4, table, None))

    inner = TT.make_inner_fn(cfg, TT.TrainConfig(**kw), None,
                             batch_fn=batch_fn)
    tparams = ckpt.params_from_flat(jflatten(jparams), cfg, "cpu")
    like = D.init_state(tparams, TT._init_inner_stacked(tparams, 2), 2, comp)
    for r in range(3):
        alive = np.array([1.0, 0.0 if r == 1 else 1.0], np.float32)
        flat = jflatten(jstate)
        state = ckpt.state_from_flat(flat, like)
        cm = lambda t: MB.masked_cluster_mean(t, torch.from_numpy(alive))
        state, losses = D.diloco_round(state, inner, comp, cm,
                                       D.RoundConfig(**rcfg), 16)
        jstate, jlosses = jround(jstate, jnp.asarray(alive))
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                                   rtol=1e-4)
        assert np.isfinite(losses.numpy()).all()
        _flat_norm_close(ckpt.state_to_flat(state), jflatten(jstate), 1e-4,
                         f"{r} ")
