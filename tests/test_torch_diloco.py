"""Port parity: the DiLoCoX round (``repro_torch.core.diloco``) against
``repro.core.diloco`` with a toy ``inner_fn``, in delay and sync modes,
with the ``LowRankQuant`` compressor (both backends of the port against
the JAX ref chain, jitted). Each of three rounds starts both packages from
the same JAX state, carried into the port by the state bridge
(``checkpoint.state_from_flat``), and the port's state after the round
must track JAX's: rtol 1e-4 / atol 1e-6 (ulps of the two Cholesky-QRs
reach the outer step through the compressed deltas). Round 0 of the delay
mode applies Delta = 0 exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.core import compression as JC
from repro.core import diloco as JD
from repro.optim import adamw as jadamw
from repro.train import trainer as JT
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import compression as C
from repro_torch.core import diloco as D
from repro_torch.train import trainer as TT

NC = 2
TOL = dict(rtol=1e-4, atol=1e-6)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return {"w": f(80, 72), "b": f(16), "segments": [{"x": f(2, 70, 66)}]}


TARGETS = [_params(10 + c) for c in range(NC)]


def _jax_inner(params, inner_opt, t):
    """Each cluster moves its params 30% of the way to its own target (a
    round-dependent amount), a stand-in for H inner steps."""
    tgt = jax.tree.map(lambda *xs: jnp.stack(xs), *TARGETS)
    k = 0.3 + 0.1 * t.astype(jnp.float32)
    out = jax.tree.map(lambda p, g: p[None] + k * (g - p[None]), params, tgt)
    return out, inner_opt, jnp.arange(NC, dtype=jnp.float32)


def _port_inner(params, inner_opt, t):
    k = 0.3 + 0.1 * t.float()
    tgt = T.tree_map(lambda *xs: torch.from_numpy(np.stack(xs)), *TARGETS)
    out = T.tree_map(lambda p, g: p[None] + k * (g - p[None]), params, tgt)
    return out, inner_opt, torch.arange(NC, dtype=torch.float32)


def _jax_state(compressor):
    p = jax.tree.map(jnp.asarray, _params())
    opt = jax.tree.map(lambda x: jnp.stack([x] * NC), jadamw.init(p))
    return JD.init_state(p, opt, NC, compressor)


def _port_like(flat, compressor):
    params = ckpt.tree_from_flat(
        {k[len(".params"):]: v for k, v in flat.items()
         if k.startswith(".params")},
        T.tree_map(torch.from_numpy, _params()))
    opt = TT._init_inner_stacked(params, NC)
    return D.init_state(params, opt, NC, compressor)


def test_state_bridge_roundtrip_byte_equal():
    jstate = _jax_state(JC.LowRankQuant(rank=8))
    flat = jflatten(jstate)
    like = _port_like(flat, C.LowRankQuant(rank=8))
    state = ckpt.state_from_flat(flat, like)
    back = ckpt.state_to_flat(state)
    assert list(back) == list(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.mark.parametrize("delay", [True, False])
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_rounds_track_jax(delay, backend):
    cfg = JD.RoundConfig(delay=delay)
    jcomp = JC.LowRankQuant(rank=8)
    jround = jax.jit(lambda s, r: JD.diloco_round(
        s, _jax_inner, jcomp, JT.cluster_mean, cfg, r))
    comp = C.LowRankQuant(rank=8, backend=backend)
    tcfg = D.RoundConfig(delay=delay)
    jstate = _jax_state(jcomp)
    for rnd, rank in enumerate([8, 8, 5]):
        flat = jflatten(jstate)
        state = ckpt.state_from_flat(flat, _port_like(flat, comp))
        before = {k: v.clone() for k, v in T.keystr_items(state.params)}
        state, aux = D.diloco_round(state, _port_inner, comp,
                                    TT.cluster_mean, tcfg, rank)
        jstate, jaux = jround(jstate, jnp.int32(rank))
        np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))
        want = jflatten(jstate)
        got = ckpt.state_to_flat(state)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{rnd} {k}",
                                       **TOL)
        if delay and rnd == 0:      # Delta == 0: params unchanged exactly
            for k, v in T.keystr_items(state.params):
                assert torch.equal(v, before[k]), k


def test_per_cluster_ranks_and_unrolled_compress():
    comp = C.LowRankQuant(rank=8)
    stacked = T.tree_map(lambda *xs: torch.from_numpy(np.stack(xs)),
                         *TARGETS)
    cs = D.init_state(T.tree_map(torch.from_numpy, _params()),
                      TT._init_inner_stacked(
                          T.tree_map(torch.from_numpy, _params()), NC),
                      NC, comp).comp_state
    hats, states = D.per_cluster_compress(comp, stacked, cs, [8, 3])
    for c, r in enumerate([8, 3]):
        hat_c, st_c = comp.roundtrip(D.take_row(stacked, c),
                                     D.take_row(cs, c), r)
        for (k, x), (_, y) in zip(T.keystr_items(D.take_row(hats, c)),
                                  T.keystr_items(hat_c)):
            assert torch.equal(x, y), k
        assert not states["w"][c][:, r:].any()


def test_masked_local_steps_runs_first_h():
    calls = []

    def step(carry, i):
        calls.append(i)
        return carry + 1, torch.tensor(float(i))

    carry, mean = D.masked_local_steps(step, 0, 4, 2)
    assert carry == 2 and calls == [0, 1] and float(mean) == 0.5


def test_gossip_mixing_refused():
    """A gossip mix on a gather-mode state (unstacked params) is refused:
    gossip needs ``init_state(..., stacked_params=True)``
    (``tests/test_torch_gossip.py`` drives it)."""
    comp = C.LowRankQuant(rank=8)
    params = T.tree_map(torch.from_numpy, _params())
    state = D.init_state(params, TT._init_inner_stacked(params, NC), NC,
                         comp)
    mix = lambda t: t
    mix.returns_stacked = True
    with pytest.raises(ValueError, match="stacked_params=True"):
        D.diloco_round(state, _port_inner, comp, mix, D.RoundConfig())


def test_pseudo_grad_matches_jax():
    anchor, local, err = _params(0), _params(1), _params(2)
    for e in (None, err):
        want = jflatten(JD.pseudo_grad(
            jax.tree.map(jnp.asarray, anchor), jax.tree.map(jnp.asarray, local),
            None if e is None else jax.tree.map(jnp.asarray, e)))
        t = lambda x: T.tree_map(torch.from_numpy, x)
        got = ckpt.params_to_flat(D.pseudo_grad(t(anchor), t(local),
                                                None if e is None else t(e)))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
