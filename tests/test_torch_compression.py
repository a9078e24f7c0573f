"""Port parity: ``repro_torch.core.compression`` against the JAX package's
``repro.core.compression`` on the same inputs and the JAX-drawn warm
start (carried over as arrays; the two packages' random streams differ).

Gates: ``quantize_sim`` bit-identical to the jitted JAX function (bits 4,
8, 16); ``LowRankQuant`` (both backends, with and without an adaptive
rank) within one int4 step per factor of the jitted JAX ref chain (the
Cholesky-QRs differ by ulps), warm starts within rtol/atol 1e-5;
``QuantOnly``, ``FP16`` and ``TopK`` exact; ``wire_bytes`` equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.core import compression as JC
from repro_torch import tree as T
from repro_torch.checkpoint.checkpoint import tree_from_flat
from repro_torch.core import compression as C


def _tree(seed=0):
    """A small param-like tree: two low-rank matrices (one stacked), one
    quant-only vector and one quant-only stacked bias."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    return {"w": f(80, 72), "b": f(300),
            "segments": [{"x": f(2, 70, 66), "bias": f(2, 40)}]}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_close(got, want, **tol):
    want = jflatten(want)
    got = {k: v.detach().numpy() for k, v in T.keystr_items(got)}
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_sim_matches_jitted_jax(bits):
    x = (np.random.default_rng(bits).standard_normal(1000) * 3).astype(
        np.float32)
    x[256:512] = 0.0
    want = np.asarray(jax.jit(JC.quantize_sim, static_argnums=(1, 2))(
        jnp.asarray(x), bits, 256))
    got = C.quantize_sim(torch.from_numpy(x), bits, 256).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("rank_scalar", [None, 5])
def test_lowrank_quant_roundtrip_matches_jax(backend, rank_scalar):
    tree = _tree()
    jcomp = JC.LowRankQuant(rank=16)
    jstate = jcomp.init_state(_j(tree))
    rs = None if rank_scalar is None else jnp.int32(rank_scalar)
    jout, jq = jax.jit(lambda t, s: jcomp.roundtrip(t, s, rs))(_j(tree),
                                                              jstate)
    comp = C.LowRankQuant(rank=16, backend=backend)
    state = tree_from_flat(jflatten(jstate), comp.init_state(_t(tree)))
    out, q = comp.roundtrip(_t(tree), state, rank_scalar)
    # one int4 step per factor: scales ~ amax/7 of factors with |P| <= 1
    # and |Q| ~ |M|_2, well inside 1e-2 at these magnitudes; a flipped code
    # is rare, so almost every element agrees to ulps
    _assert_tree_close(out, jout, rtol=0, atol=1e-2)
    for k, v in jflatten(jout).items():
        got = dict(T.keystr_items(out))[k].numpy()
        assert np.mean(np.abs(got - v) > 1e-6) <= 0.01, k
    _assert_tree_close(q, jq, rtol=1e-5, atol=1e-5)
    # the quant-only leaves are exact
    for key in ("b",):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]))
    if rank_scalar is not None:
        assert not q["w"][:, rank_scalar:].any()


def test_lowrank_quant_backends_agree_within_the_port():
    """On the CPU both backends run the same arithmetic: bitwise equal."""
    tree = _t(_tree(3))
    a = C.LowRankQuant(rank=16, backend="ref")
    b = C.LowRankQuant(rank=16, backend="pallas")
    state = a.init_state(tree)
    oa, qa = a.roundtrip(tree, state, 7)
    ob, qb = b.roundtrip(tree, state, 7)
    for (ka, x), (kb, y) in zip(T.keystr_items((oa, qa)),
                                T.keystr_items((ob, qb))):
        assert ka == kb and torch.equal(x, y), ka


def test_init_state_shapes_match_jax():
    tree = _tree()
    jstate = JC.LowRankQuant(rank=16).init_state(_j(tree))
    state = C.LowRankQuant(rank=16).init_state(_t(tree))
    want = {k: v.shape for k, v in jflatten(jstate).items()}
    assert {k: tuple(v.shape) for k, v in T.keystr_items(state)} == want


@pytest.mark.parametrize("name,kw", [("quant", {}), ("quant", {"bits": 8}),
                                     ("fp16", {}), ("topk", {"ratio": 0.05}),
                                     ("identity", {})])
def test_baseline_roundtrips_exact(name, kw):
    tree = _tree(1)
    jc = JC.make_compressor(name, **kw)
    jout, _ = jax.jit(lambda t: jc.roundtrip(t, jc.init_state(t)))(_j(tree))
    c = C.make_compressor(name, **kw)
    out, _ = c.roundtrip(_t(tree), c.init_state(_t(tree)))
    _assert_tree_close(out, jout, rtol=0, atol=0)


@pytest.mark.parametrize("name,kw", [
    ("identity", {}), ("fp16", {}), ("quant", {}), ("quant", {"bits": 8}),
    ("diloco_x", {"rank": 16}), ("diloco_x", {"rank": 64}),
    ("topk", {"ratio": 0.01}), ("random_sparse", {}), ("cocktail", {})])
@pytest.mark.parametrize("rank", [None, 5])
def test_wire_bytes_equal(name, kw, rank):
    shapes = JC.tree_shapes(_j(_tree()))
    assert C.tree_shapes(_t(_tree())) == shapes
    assert C.make_compressor(name, **kw).wire_bytes(shapes, rank=rank) == \
        JC.make_compressor(name, **kw).wire_bytes(shapes, rank=rank)


def test_not_ported_compressors_raise_with_roadmap_item():
    """The two random baselines, refused until ROADMAP A.3b ported them,
    build and round-trip (their parity: tests/test_torch_sparse_compressors.py);
    the pallas backend still refuses int8."""
    tree = _t(_tree(2))
    for name in ("random_sparse", "cocktail"):
        comp = C.make_compressor(name)
        out, state = comp.roundtrip(tree, comp.init_state(tree))
        assert int(state) == 1
        for (k, x), (_, y) in zip(T.keystr_items(out),
                                  T.keystr_items(tree)):
            assert x.shape == y.shape and x.dtype == y.dtype, k
            assert torch.isfinite(x).all() and 0 < int((x != 0).sum()) \
                < x.numel(), k
    with pytest.raises(ValueError):
        C.LowRankQuant(backend="pallas", bits=8)


def test_orthonormalize_matches_jax():
    P = (np.random.default_rng(0).standard_normal((200, 12)) * 1e-2).astype(
        np.float32)
    P[:, 9:] = 0.0
    want = np.asarray(jax.jit(JC._orthonormalize)(jnp.asarray(P)))
    got = C._orthonormalize(torch.from_numpy(P)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert not got[:, 9:].any()
