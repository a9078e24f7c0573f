"""Port parity: the trainer-side parts of the adaptive controller
(``repro_torch.core.adaptive``) against ``repro.core.adaptive``: the
Alg. 3 update and driver step on the same r' sequence (exact: host-side
numpy copies), the stable-rank estimator (rtol 1e-4: power iteration in
float32, other summation orders), and ``plan_h`` (exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as JA
from repro_torch.core import adaptive as A


def _mats(seed=0):
    rng = np.random.default_rng(seed)
    low = rng.standard_normal((40, 4)) @ rng.standard_normal((4, 30))
    return {"a": (low + 0.01 * rng.standard_normal((40, 30))).astype(
                np.float32),
            "b": rng.standard_normal((2, 16, 24)).astype(np.float32),
            "c": rng.standard_normal(50).astype(np.float32)}


@pytest.mark.parametrize("mode", ["paper", "overlap"])
def test_adagradcmp_updates_match_jax(mode):
    cfg = A.AdaGradCmpConfig(window=3, r1=64, h1=20, mode=mode)
    jcfg = JA.AdaGradCmpConfig(window=3, r1=64, h1=20, mode=mode)
    st, jst = A.AdaGradCmpState.create(cfg), JA.AdaGradCmpState.create(jcfg)
    for r in [60.2, 41.7, 33.3, 12.5, 3.0, 80.0]:
        st = A.adagradcmp_update(st, r, cfg)
        jst = JA.adagradcmp_update(jst, r, jcfg)
        assert (st.r_t, st.h_t, st.t, st.r_hist) == \
            (jst.r_t, jst.h_t, jst.t, jst.r_hist)


def test_stable_rank_and_observe_match_jax():
    mats = _mats()
    for k in ("a", "b"):
        np.testing.assert_allclose(
            float(A.stable_rank(torch.from_numpy(mats[k]))),
            float(JA.stable_rank(jnp.asarray(mats[k]))), rtol=1e-4)
    tmats = {k: torch.from_numpy(v) for k, v in mats.items()}
    jmats = {k: jnp.asarray(v) for k, v in mats.items()}
    np.testing.assert_allclose(float(A.tree_effective_rank(tmats)),
                               float(JA.tree_effective_rank(jmats)),
                               rtol=1e-4)
    cfg = A.AdaGradCmpConfig(window=1, r1=64, h1=20)
    st = A.observe_mean_pseudo_grad(A.AdaGradCmpState.create(cfg), tmats,
                                    cfg)
    jst = JA.observe_mean_pseudo_grad(
        JA.AdaGradCmpState.create(JA.AdaGradCmpConfig(window=1, r1=64,
                                                      h1=20)), jmats,
        JA.AdaGradCmpConfig(window=1, r1=64, h1=20))
    assert (st.r_t, st.h_t) == (jst.r_t, jst.h_t)


@pytest.mark.parametrize("times", [(1.0, 1.0, 1.0), (1.0, 2.0, 3.5),
                                   (0.5, 4.0, 1.1)])
@pytest.mark.parametrize("h_min", [1, 3])
def test_plan_h_matches_jax(times, h_min):
    alive = np.ones(3, bool)
    for gap in (None, 0.4):
        want = JA.plan_h(JA.HSpec(h_min=h_min), 8, times, alive, gap)
        got = A.plan_h(A.HSpec(h_min=h_min), 8, times, alive, gap)
        assert got == want
    assert A.plan_h(None, 8, times, alive) == {0: 8, 1: 8, 2: 8}
