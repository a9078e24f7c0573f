"""Port parity for the topology layer (``repro_torch.topology``,
``repro_torch.core.comm``, ``core.diloco.staleness_weights`` and
``core.adaptive.plan_h``'s gossip clamp) against the JAX package.

Graphs, matrices and accounting are numpy on both sides, so every gate
here is exact: edges equal, ``MixingMatrix.W`` byte for byte (the masked
matrices through ``core.membership.masked_mixing_matrix`` in f32 on both
sides), float results equal. ``push_sum_weights`` is held to the
reference's own float64 output, not to exact column sums of 1."""
import dataclasses

import numpy as np
import pytest

from repro.core import adaptive as JA
from repro.core import comm as JC
from repro.core import diloco as JD
from repro import topology as JT
from repro_torch.core import adaptive as PA
from repro_torch.core import comm as PC
from repro_torch.core import diloco as PD
from repro_torch import topology as PT

SIZES = list(range(3, 13))


def _pair(kind, n, **kw):
    return JT.make_topology(kind, n, **kw), PT.make_topology(kind, n, **kw)


def _masks(n, seed):
    """All alive, then 1..3 dead clusters chosen from a seeded stream."""
    rng = np.random.RandomState(seed)
    out = [np.ones(n, bool)]
    for dead in range(1, min(3, n - 1) + 1):
        a = np.ones(n, bool)
        a[rng.choice(n, size=dead, replace=False)] = False
        out.append(a)
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", list(JT.KINDS))
def test_graph_edges_match_jax(kind, n):
    for seed in range(0, 21, 4):
        j, p = _pair(kind, n, seed=seed)
        assert p.edges == j.edges and p.kind == j.kind and p.n == j.n
        assert p.meta == j.meta
        assert np.array_equal(p.adjacency(), j.adjacency())
        for c in range(n):
            assert p.neighbors(c) == j.neighbors(c)
        for alive in _masks(n, seed):
            assert p.is_connected(alive) == j.is_connected(alive)
            for c in range(n):
                assert (p.alive_neighbors(c, alive)
                        == j.alive_neighbors(c, alive))
        assert p.describe() == j.describe()


def test_random_regular_failure_matches_jax():
    """Where stub matching finds no connected simple graph in 500 draws,
    both packages raise the same error."""
    msgs = []
    for mod in (JT, PT):
        with pytest.raises(RuntimeError) as e:
            mod.random_regular(12, 5, 3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("n,degree,seed", [(8, 3, 0), (10, 4, 7), (10, 4, 8),
                                           (12, 4, 3), (6, 2, 1)])
def test_random_regular_and_digraphs_match_jax(n, degree, seed):
    j, p = _pair("random", n, degree=degree, seed=seed)
    assert p.edges == j.edges
    assert (PT.random_regular(n, degree, seed).edges
            == JT.random_regular(n, degree, seed).edges)
    for jg, pg in ((JT.directed_ring(n), PT.directed_ring(n)),
                   (JT.as_digraph(j), PT.as_digraph(p))):
        assert pg.arcs == jg.arcs
        assert pg.is_strongly_connected() == jg.is_strongly_connected()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", list(JT.KINDS))
def test_mixing_matrix_bytes_match_jax(kind, n):
    """``MixingMatrix.metropolis`` with and without an alive mask, and
    ``masked_mixing_matrix`` through ``MixingMatrix.masked``: the same
    float32 bytes; the spectral gap (of the alive block) the same float."""
    for seed in (0, 5):
        j, p = _pair(kind, n, seed=seed)
        jm, pm = JT.MixingMatrix.metropolis(j), PT.MixingMatrix.metropolis(p)
        assert pm.W.dtype == np.float32 and pm.W.tobytes() == jm.W.tobytes()
        assert pm.kind == jm.kind
        assert pm.spectral_gap() == jm.spectral_gap()
        for alive in _masks(n, seed):
            ja = JT.MixingMatrix.metropolis(j, alive)
            pa = PT.MixingMatrix.metropolis(p, alive)
            assert pa.W.tobytes() == ja.W.tobytes(), alive
            assert pm.masked(alive).W.tobytes() == jm.masked(alive).W.tobytes()
            assert pa.spectral_gap(alive) == ja.spectral_gap(alive)
            assert pa.is_doubly_stochastic() == ja.is_doubly_stochastic()


@pytest.mark.parametrize("n", [3, 4, 5, 8])
@pytest.mark.parametrize("shape", ["directed_ring", "star", "ring", "full",
                                   "torus", "random"])
def test_push_sum_and_async_weights_match_jax(shape, n):
    if shape == "directed_ring":
        jg, pg = JT.directed_ring(n), PT.directed_ring(n)
    else:
        j, p = _pair(shape, n)
        jg, pg = JT.as_digraph(j), PT.as_digraph(p)
        assert np.array_equal(PT.async_mix_weights(p),
                              JT.async_mix_weights(j))
    W = PT.push_sum_weights(pg)
    assert W.dtype == np.float64 and np.array_equal(W, JT.push_sum_weights(jg))
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3))
    phi = rng.random(n) + 0.5
    for a, b in zip(PT.push_sum_round(W, x, phi),
                    JT.push_sum_round(W, x, phi)):
        assert np.array_equal(a, b)
    assert np.array_equal(PT.push_sum_average(pg, x, iters=50),
                          JT.push_sum_average(jg, x, iters=50))
    alive = np.ones(n, bool)
    alive[0] = False
    assert (PT.consensus_distance(x, alive)
            == JT.consensus_distance(x, alive))


@pytest.mark.parametrize("seed", range(6))
def test_staleness_weights_match_jax(seed):
    rng = np.random.default_rng(seed)
    C = 2 + seed
    topo = PT.make_topology("ring" if seed % 2 else "random", max(C, 3),
                            seed=seed)
    base = PT.async_mix_weights(topo)[0][:C]
    stale = rng.integers(-1, 5, C)
    for bound in (0, 1, 3):
        got = PD.staleness_weights(base, stale, bound)
        want = JD.staleness_weights(base, stale, bound)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", list(JT.KINDS))
def test_wire_and_compute_accounting_match_jax(kind):
    n = 8
    j, p = _pair(kind, n, seed=2)
    rng = np.random.default_rng(3)
    bws = rng.random(n) * 1e6 + 1e5
    for alive in _masks(n, 4):
        for wbc in (None, {c: int(1000 + 17 * c) for c in range(n)}):
            g = PT.gossip_round_comm(p, alive, 5_000, bws, 1e-3, wbc)
            w = JT.gossip_round_comm(j, alive, 5_000, bws, 1e-3, wbc)
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        h_by = {c: int(rng.integers(1, 9)) for c in range(n)}
        t_steps = rng.random(n) + 0.1
        assert (dataclasses.asdict(PT.compute_leg(h_by, t_steps, alive))
                == dataclasses.asdict(JT.compute_leg(h_by, t_steps, alive)))
        k = int(alive.sum())
        for mode in ("gather", "allreduce"):
            assert (PT.round_wire_total(mode, k, 5_000, 4)
                    == JT.round_wire_total(mode, k, 5_000, 4))
    dead = np.zeros(n, bool)
    assert (dataclasses.asdict(PT.compute_leg({}, [], dead))
            == dataclasses.asdict(JT.compute_leg({}, [], dead)))


@pytest.mark.parametrize("n_clusters", [2, 4, 8])
def test_comm_model_matches_jax(n_clusters):
    psc = PC.CommScenario(n_clusters=n_clusters, t_step_s=0.5)
    jsc = JC.CommScenario(n_clusters=n_clusters, t_step_s=0.5)
    assert dataclasses.asdict(psc) == dataclasses.asdict(jsc)
    assert PC.GBPS == JC.GBPS
    assert (PC.ring_allreduce_time(1e9, psc)
            == JC.ring_allreduce_time(1e9, jsc))
    assert PC.gather_time(3e8, psc) == JC.gather_time(3e8, jsc)
    for kw in (dict(h_steps=125, overlap=True),
               dict(h_steps=4, overlap=False),
               dict(h_steps=1, overlap=False, allreduce_per_step=True)):
        got = PC.method_throughput("m", param_bytes_fp32=5.2e9,
                                   wire_bytes=4.1e7, sc=psc, **kw)
        want = JC.method_throughput("m", param_bytes_fp32=5.2e9,
                                    wire_bytes=4.1e7, sc=jsc, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kind", ["ring", "torus", "random"])
def test_plan_h_gossip_clamp_from_ports_spectral_gap(kind):
    """``plan_h``'s gossip clamp takes its gap from the port's own
    ``MixingMatrix.spectral_gap``: the schedule equals JAX's fed JAX's."""
    n = 8
    j, p = _pair(kind, n, seed=1)
    t_steps = [1.0, 1.5, 2.0, 3.0, 1.0, 4.0, 1.2, 2.5]
    for alive in _masks(n, 1):
        pgap = PT.MixingMatrix.metropolis(p, alive).spectral_gap(alive)
        jgap = JT.MixingMatrix.metropolis(j, alive).spectral_gap(alive)
        for h_min in (1, 3):
            got = PA.plan_h(PA.HSpec(h_min=h_min), 16, t_steps, alive, pgap)
            want = JA.plan_h(JA.HSpec(h_min=h_min), 16, t_steps, alive, jgap)
            assert got == want
            assert (PA.gap_h_floor(PA.HSpec(h_min=h_min), 16, pgap)
                    == JA.gap_h_floor(JA.HSpec(h_min=h_min), 16, jgap))
