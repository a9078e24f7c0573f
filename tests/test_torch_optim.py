"""Port parity: one AdamW update (with and without the global-norm clip
engaging, and a second step for the bias correction) and one Nesterov
update of ``repro_torch.optim`` against ``repro.optim`` on
reference-supplied grads. Tolerance: rtol 1e-6 / atol 1e-7 in float32
(the same arithmetic; the clip's norm sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.optim import adamw as jadamw
from repro.optim import nesterov as jnesterov
from repro.optim import schedules as jsched
from repro_torch import tree as T
from repro_torch.optim import adamw, nesterov, schedules

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"w": f(8, 6), "b": f(6), "segments": [{"x": f(2, 3, 4)}]}


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, **tol):
    want = jflatten(want)
    got = {k: v.numpy() for k, v in T.keystr_items(got)}
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])    # clip off / on
def test_adamw_two_updates_match_jax(grad_scale):
    p = _tree(0)
    jp, jst = jax.tree.map(jnp.asarray, p), jadamw.init(
        jax.tree.map(jnp.asarray, p))
    tp = _t(p)
    tst = adamw.init(tp)
    jupd = jax.jit(lambda g, s, q: jadamw.update(g, s, q, lr=1e-2))
    for step in range(2):
        g = _tree(10 + step, grad_scale)
        jp, jst = jupd(jax.tree.map(jnp.asarray, g), jst, jp)
        tp, tst = adamw.update(_t(g), tst, tp, lr=1e-2)
        _close(tp, jp, **TOL)
        _close(tst.m, jst.m, **TOL)
        _close(tst.v, jst.v, **TOL)
        assert int(tst.step) == int(jst.step) == step + 1


def test_adamw_lr_schedule_callable():
    p = _tree(0)
    lr = schedules.warmup_cosine(1e-2, 2, 10)
    jlr = jsched.warmup_cosine(1e-2, 2, 10)
    for s in range(12):
        np.testing.assert_allclose(float(lr(s)), float(jlr(jnp.int32(s))),
                                   rtol=1e-6)
    tp, tst = adamw.update(_t(_tree(1)), adamw.init(_t(p)), _t(p), lr=lr)
    jp, _ = jadamw.update(jax.tree.map(jnp.asarray, _tree(1)),
                          jadamw.init(jax.tree.map(jnp.asarray, p)),
                          jax.tree.map(jnp.asarray, p), lr=jlr)
    _close(tp, jp, **TOL)
    assert schedules.constant(0.3)(5) == jsched.constant(0.3)(5)


def test_nesterov_update_matches_jax():
    p, d = _tree(0), _tree(1, 0.1)
    jp = jax.tree.map(jnp.asarray, p)
    jst = jnesterov.init(jp)
    tp = _t(p)
    tst = nesterov.init(tp)
    upd = jax.jit(lambda g, s, q: jnesterov.update(g, s, q, lr=0.7,
                                                   momentum=0.9))
    for step in range(2):
        g = _tree(20 + step, 0.1)
        jp, jst = upd(jax.tree.map(jnp.asarray, g), jst, jp)
        tp, tst = nesterov.update(_t(g), tst, tp, lr=0.7, momentum=0.9)
        _close(tp, jp, **TOL)
        _close(tst.momentum, jst.momentum, **TOL)
    assert int(tst.step) == 2


def test_nesterov_zero_pseudo_grad_is_exact_noop():
    """Round 0 of the delay mode applies Delta = 0: params unchanged bit
    for bit."""
    tp = _t(_tree(0))
    before = {k: v.clone() for k, v in T.keystr_items(tp)}
    zero = T.tree_map(torch.zeros_like, tp)
    tp, _ = nesterov.update(zero, nesterov.init(tp), tp)
    for k, v in T.keystr_items(tp):
        assert torch.equal(v, before[k]), k
