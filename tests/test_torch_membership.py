"""Port parity for ``repro_torch.core.membership`` against
``repro.core.membership``.

The same numpy inputs, drawn from a seed, go through both. The reference
runs eagerly, op by op, and every gate is bit for bit: the port sums the
cluster axis unrolled in cluster order, as XLA reduces it, with each
multiply and add rounded on its own. (Under ``jax.jit`` XLA contracts
``x * m`` and the sum to FMAs, 1-2 ulps from the eager result with a
float mask; the eager reference is the one held.) Zero signs are not
compared (``np.array_equal``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import membership as JM
from repro_torch.core import diloco as PD
from repro_torch.core import membership as PM
from repro_torch.topology import mixing as PX
from repro_torch.topology.graphs import make_topology


def _tree(seed, C):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((C, 37, 29)).astype(np.float32),
            "b": rng.standard_normal((C, 11)).astype(np.float32),
            "s": [{"x": rng.standard_normal((C, 2, 5, 3)).astype(np.float32)}]}


def _masks(seed, C):
    """All alive, a 0/1 mask with dead rows, a float (staleness-weighted)
    mask from ``staleness_weights``, and all dead."""
    rng = np.random.default_rng(100 + seed)
    dead = np.ones(C, np.float32)
    dead[rng.choice(C, size=max(1, C // 3), replace=False)] = 0.0
    stale = PD.staleness_weights(rng.random(C) + 0.1,
                                 rng.integers(-1, 4, C), 2)
    return {"alive": np.ones(C, np.float32), "dead": dead, "stale": stale,
            "none": np.zeros(C, np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _equal(got, want):
    gl, wl = jax.tree.leaves(jax.tree.map(np.asarray, got)), \
        jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w)
        np.testing.assert_array_equal(g, np.asarray(w))


def _np(tree):
    return jax.tree.map(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                        else x, tree, is_leaf=lambda x: isinstance(
                            x, torch.Tensor))


@pytest.mark.parametrize("C", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_masked_cluster_mean_bitwise(seed, C):
    tree = _tree(seed, C)
    for name, m in _masks(seed, C).items():
        want = JM.masked_cluster_mean(_j(tree), jnp.asarray(m))
        got = PM.masked_cluster_mean(_t(tree), torch.from_numpy(m))
        _equal(_np(got), want)
        if name == "none":      # all dead: a zero update
            assert all(not x.any() for x in jax.tree.leaves(_np(got)))
        # a bool mask and a numpy mask take the same path
        if name in ("alive", "dead"):
            got_b = PM.masked_cluster_mean(_t(tree), torch.from_numpy(m > 0))
            _equal(_np(got_b), want)
            _equal(_np(PM.masked_cluster_mean(_t(tree), m)), want)


@pytest.mark.parametrize("C", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("trim", [1, 2])
def test_trimmed_cluster_mean_bitwise(trim, C, monkeypatch):
    tree = _tree(C, C)
    tree["w"][0, 0, :4] = [np.inf, -np.inf, 1e30, -1e30]   # outliers
    tree["w"][:, 1, 0] = 0.5                                # ties
    for name, m in _masks(C, C).items():
        m = (m > 0).astype(np.float32)
        want = JM.trimmed_cluster_mean(_j(tree), jnp.asarray(m), trim)
        got = PM.trimmed_cluster_mean(_t(tree), torch.from_numpy(m), trim)
        _equal(_np(got), want)
    # a leaf sorted in several column chunks gives the same bits
    monkeypatch.setattr(PM, "_SORT_COLS", 100)
    got = PM.trimmed_cluster_mean(_t(tree), torch.ones(C), trim)
    _equal(_np(got), JM.trimmed_cluster_mean(_j(tree), jnp.ones(C), trim))


@pytest.mark.parametrize("seed", range(4))
def test_masked_mixing_matrix_bytes(seed):
    rng = np.random.default_rng(seed)
    n = 3 + 2 * seed
    A = rng.random((n, n)).astype(np.float32)
    for W in (A, (A + A.T) / 2, np.full((n, n), 1.0 / n, np.float32)):
        for m in (np.ones(n), rng.random(n) > 0.4, np.zeros(n)):
            want = np.asarray(JM.masked_mixing_matrix(W, m))
            got = PM.masked_mixing_matrix(W, m)
            assert got.dtype == torch.float32
            assert got.numpy().tobytes() == want.tobytes()
            # a torch matrix and a float mask are accepted too
            got_t = PM.masked_mixing_matrix(torch.from_numpy(W),
                                            torch.from_numpy(
                                                m.astype(np.float32)))
            assert got_t.numpy().tobytes() == want.tobytes()
    # the alive block of a masked Metropolis matrix stays doubly stochastic
    ring = PX.MixingMatrix.metropolis(make_topology("ring", n))
    assert PX.MixingMatrix(PM.masked_mixing_matrix(
        ring.W, np.arange(n) % 3 != 0).numpy()).is_doubly_stochastic()


@pytest.mark.parametrize("C", [2, 4, 5])
def test_reset_rejoining_in_place(C):
    tree = _tree(C, C)
    rng = np.random.default_rng(C)
    for fill in (0.0, 1.5):
        rejoined = rng.random(C) > 0.5
        rejoined[-1] = True
        want = JM.reset_rejoining(_j(tree), jnp.asarray(rejoined), fill)
        port = _t(jax.tree.map(np.copy, tree))
        before = [x.data_ptr() for x in jax.tree.leaves(
            port, is_leaf=lambda x: isinstance(x, torch.Tensor))]
        got = PM.reset_rejoining(port, torch.from_numpy(rejoined), fill)
        _equal(_np(got), want)
        after = [x.data_ptr() for x in jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor))]
        assert after == before          # written in place
        for k in ("w", "b"):
            for c in range(C):
                row = got[k][c].numpy()
                if rejoined[c]:
                    assert (row == fill).all()
                else:
                    assert np.array_equal(row, tree[k][c])
    # an int mask, as JAX's tests pass one
    x = {"e": torch.ones(3, 4)}
    PM.reset_rejoining(x, np.array([0, 1, 0]))
    assert x["e"][1].eq(0).all() and x["e"][[0, 2]].eq(1).all()


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_effective_batch_scale(C):
    rng = np.random.default_rng(C)
    for m in (np.ones(C, np.float32), (rng.random(C) > 0.5).astype(
            np.float32), rng.random(C).astype(np.float32),
            np.zeros(C, np.float32)):
        want = np.asarray(JM.effective_batch_scale(jnp.asarray(m), C))
        got = PM.effective_batch_scale(torch.from_numpy(m), C)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
