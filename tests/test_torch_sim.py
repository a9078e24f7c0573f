"""Port parity for the simulator's timing side (``repro_torch.sim``,
barrier mode) against the JAX package's ``repro.sim``.

- Every timing-only scenario of ``tests/test_sim.py:29-222`` and
  ``tests/test_h_schedule.py:182``, ``:202``, ``:216`` (and a gossip
  ring): ``fingerprint()`` and ``structural_fingerprint()`` equal to the
  JAX package's, so every event field, float and fault tag is JAX's.
- ``compare_methods``: tokens/s equal to JAX's exactly, and each method's
  timeline fingerprint.
- ``rank_schedule`` replay of a fixed list, scalar (star) and per-edge
  (ring), equal to JAX's replay of the same list.
- ``tree_hash`` of a port tree equals JAX's ``tree_hash`` of the same bits
  (f32, bf16, int32, 0-d and empty leaves, nested dicts, lists and
  NamedTuples); ``combine_row_hashes`` is a copy.
- Refusals: what the port does not have raises naming its ROADMAP item
  (A.14 items 3, 4); the JAX package's own refusals keep their type and
  message. ``sync="bounded_stale"`` (item 2) runs: its refusal test now
  holds the scenario's timeline to JAX's.
"""
import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as J
import repro_torch.sim as P
from repro.core import comm as jcomm
from repro.core.adaptive import HSpec as JHSpec
from repro_torch.core.adaptive import HSpec as PHSpec

GBPS = jcomm.GBPS


def _hspec(m, **kw):
    return (JHSpec if m is J else PHSpec)(**kw)


def _clean(m, **kw):
    """``tests/test_sim.py::clean_scenario``."""
    base = dict(n_clusters=4, rounds=6, h_steps=10, t_step_s=1.0,
                n_params=1e8, compressor="diloco_x",
                compressor_kw={"rank": 32}, seed=3)
    base.update(kw)
    return m.Scenario(**base)


def _hsched(m, **kw):
    """``tests/test_h_schedule.py::_scenario``."""
    base = dict(n_clusters=3, rounds=4, h_steps=4, t_step_s=0.05,
                link=m.LinkProfile(bytes_per_s=200_000),
                compressor="diloco_x",
                compressor_kw={"rank": 4, "min_dim_for_lowrank": 8}, rank=4,
                n_params=1e5, seed=0)
    base.update(kw)
    return m.Scenario(**base)


def _fs(*events):
    return lambda m: m.FaultSchedule(tuple(e(m) for e in events))


STRAG_H = _fs(lambda m: m.Straggler(1, 1, 3, 3.0))
DYNAMIC = dict(n_clusters=6, rounds=6, topology="random",
               topology_seed_schedule=tuple(range(6)),
               initial_alive=(True,) * 5 + (False,))
DEGRADE0 = _fs(lambda m: m.LinkDegradation(0, 6, 0.05, cluster=0))

# name -> scenario builder of a module (J or P); the JAX tests' scenarios
SCENARIOS = {
    # tests/test_sim.py
    "jitter": lambda m: _clean(m, link=m.LinkProfile(jitter=0.1)),
    "jitter_seed4": lambda m: _clean(m, link=m.LinkProfile(jitter=0.1),
                                     seed=4),
    "clean": lambda m: _clean(m),
    "slow_link": lambda m: _clean(m, link=m.LinkProfile(
        bytes_per_s=GBPS / 500)),
    "slow_link_no_delay": lambda m: _clean(m, link=m.LinkProfile(
        bytes_per_s=GBPS / 500), delay=False),
    "straggler": lambda m: _clean(m, faults=_fs(
        lambda m: m.Straggler(2, 2, 4, slowdown=3.0))(m)),
    "link_base": lambda m: _clean(m, link=m.LinkProfile(
        bytes_per_s=GBPS / 100)),
    "link_degraded": lambda m: _clean(
        m, link=m.LinkProfile(bytes_per_s=GBPS / 100),
        faults=_fs(lambda m: m.LinkDegradation(1, 2, factor=0.25))(m)),
    "link_degraded_c3": lambda m: _clean(
        m, link=m.LinkProfile(bytes_per_s=GBPS / 100),
        faults=_fs(lambda m: m.LinkDegradation(1, 2, factor=0.25,
                                               cluster=3))(m)),
    "churn": lambda m: _clean(m, faults=_fs(lambda m: m.Leave(1, 2),
                                            lambda m: m.Join(1, 4))(m)),
    "numeric_42_timing": lambda m: _clean(
        m, rounds=6, h_steps=4,
        faults=_fs(lambda m: m.Straggler(1, 2, 4, 3.0),
                   lambda m: m.Leave(2, 3), lambda m: m.Join(2, 5))(m),
        compressor_kw={"rank": 4, "min_dim_for_lowrank": 8}),
    "numeric_166_timing": lambda m: _clean(
        m, rounds=14, h_steps=6, link=m.LinkProfile(jitter=0.05),
        faults=_fs(lambda m: m.Straggler(1, 3, 6, slowdown=4.0),
                   lambda m: m.Leave(2, 4), lambda m: m.Join(2, 9))(m),
        compressor_kw={"rank": 4, "min_dim_for_lowrank": 8}),
    "paper_107b": lambda m: m.Scenario(
        n_clusters=2, rounds=3, h_steps=125,
        t_step_s=6.0 * 107e9 * 36_000 / (160 * 312e12 * 0.045),
        n_params=107e9, tokens_per_step=36_000),
    # tests/test_h_schedule.py:182, :202, :216
    "idle_split": lambda m: _hsched(m, faults=STRAG_H(m)),
    "idle_split_slow": lambda m: _hsched(m, faults=STRAG_H(m),
                                         t_step_s=0.1),
    "idle_split_balance": lambda m: _hsched(
        m, faults=STRAG_H(m), h_spec=_hspec(m, policy="balance")),
    "dynamic_random": lambda m: _hsched(m, **DYNAMIC, faults=DEGRADE0(m)),
    "dynamic_random_8": lambda m: _hsched(m, **dict(DYNAMIC, rounds=8),
                                          faults=DEGRADE0(m)),
    "dynamic_fixed_seed": lambda m: _hsched(
        m, **dict(DYNAMIC, topology_seed_schedule=None),
        faults=DEGRADE0(m)),
    # gossip and per-step allreduce accounting, churn on a ring
    "ring_churn_balance": lambda m: _hsched(
        m, n_clusters=4, topology="ring", rounds=5,
        faults=_fs(lambda m: m.Straggler(1, 1, 4, 6.0),
                   lambda m: m.Leave(3, 2), lambda m: m.Join(3, 4))(m),
        h_spec=_hspec(m, policy="balance")),
    "allreduce_per_step": lambda m: _clean(m, compressor="identity",
                                           compressor_kw={},
                                           allreduce_per_step=True,
                                           delay=False, h_steps=1),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_timing_only_fingerprints_equal_jax(name):
    want = J.simulate(SCENARIOS[name](J))
    got = P.simulate(SCENARIOS[name](P))
    assert got.scenario == want.scenario
    assert len(got.events) == len(want.events)
    for g, w in zip(got.events, want.events):
        assert dataclasses.asdict(g) == dataclasses.asdict(w), g.round
    assert got.fingerprint() == want.fingerprint()
    assert got.structural_fingerprint() == want.structural_fingerprint()
    assert got.to_dict() == want.to_dict()
    assert got.table() == want.table()
    assert got.h_schedule() == want.h_schedule()
    assert got.rank_schedule() == want.rank_schedule()


def test_synthetic_shapes_and_meta_equal_jax():
    for n in (1e5, 1e8, 107e9):
        assert P.synthetic_shapes(n) == J.synthetic_shapes(n)
    sc = SCENARIOS["idle_split_balance"]
    assert sc(P).meta() == sc(J).meta()
    assert sc(P).shapes() == sc(J).shapes()


def test_compare_methods_equal_jax():
    want = J.compare_methods(SCENARIOS["paper_107b"](J), rank=2048)
    got = P.compare_methods(SCENARIOS["paper_107b"](P), rank=2048)
    assert got["tokens_per_s"] == want["tokens_per_s"]
    assert got["speedup_vs_allreduce"] == want["speedup_vs_allreduce"]
    for k in want["timelines"]:
        assert (got["timelines"][k].fingerprint()
                == want["timelines"][k].fingerprint()), k
    s = got["speedup_vs_allreduce"]
    assert s["diloco_x"] > s["cocktail"] > s["allreduce"] == 1.0
    assert 250 < s["diloco_x"] < 450          # paper: 357x


@pytest.mark.parametrize("topology,schedule", [
    ("star", [8, 8, 8, 4, 2, 2, 8, 8]),
    ("ring", [8, [8, 4, 8, 8], [8, 2, 8, 8], 8, [8, 8, 4, 2], 8, 8, 8]),
])
def test_rank_schedule_replay_equal_jax(topology, schedule):
    def sc(m):
        return m.Scenario(
            n_clusters=4, rounds=8, h_steps=4, t_step_s=0.05,
            link=m.LinkProfile(bytes_per_s=200_000),
            faults=m.FaultSchedule((m.LinkDegradation(3, 6, factor=0.05,
                                                      cluster=1),)),
            compressor="diloco_x",
            compressor_kw={"rank": 8, "min_dim_for_lowrank": 8}, rank=8,
            n_params=2e5, seed=0, topology=topology)
    want = J.simulate(sc(J), rank_schedule=schedule)
    got = P.simulate(sc(P), rank_schedule=schedule)
    assert got.rank_schedule() == want.rank_schedule()
    assert got.fingerprint() == want.fingerprint()
    assert got.structural_fingerprint() == want.structural_fingerprint()
    # the ranks moved the bytes (per-edge ranks move the all-link total)
    assert len({(e.wire_bytes, e.wire_bytes_total) for e in got.events}) > 1


# ---------------------------------------------------------------------------
# tree_hash
# ---------------------------------------------------------------------------

class _Pair(NamedTuple):
    step: object
    moments: object


def _bits(seed):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16_bits": rng.integers(0, 2 ** 16, (4, 6), dtype=np.uint16),
        "i32": rng.integers(-2 ** 31, 2 ** 31 - 1, (7,), dtype=np.int32),
        "scalar": np.float32(rng.standard_normal()),
        "empty": np.zeros((0,), np.float32),
    }


def _trees(seed):
    b = _bits(seed)
    jbf = jax.lax.bitcast_convert_type(jnp.asarray(b["bf16_bits"]),
                                       jnp.bfloat16)
    tbf = torch.from_numpy(b["bf16_bits"].view(np.int16)).view(torch.bfloat16)

    def tree(f32, bf16, i32, scalar, empty):
        return {"z": [f32, {"b": bf16, "a": i32}],
                "a": _Pair(step=scalar, moments=(empty, f32 * 2)),
                "m": {"w10": i32, "w2": bf16},
                "host": [3.5, 7, np.float32(0.25), b["i32"][:3]]}

    jt = tree(jnp.asarray(b["f32"]), jbf, jnp.asarray(b["i32"]),
              jnp.asarray(b["scalar"]), jnp.asarray(b["empty"]))
    tt = tree(torch.from_numpy(b["f32"]), tbf, torch.from_numpy(b["i32"]),
              torch.tensor(b["scalar"]), torch.from_numpy(b["empty"]))
    return jt, tt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_hash_equals_jax(seed):
    jt, tt = _trees(seed)
    assert P.tree_hash(tt) == J.tree_hash(jt)
    # leaf by leaf too, so a mismatch names its dtype
    for key in ("z", "a", "m", "host"):
        assert P.tree_hash(tt[key]) == J.tree_hash(jt[key]), key
    # a non-contiguous view hashes as its contiguous copy
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    assert P.tree_hash({"x": x.T}) == J.tree_hash(
        {"x": jnp.asarray(np.arange(24, dtype=np.float32).reshape(4, 6).T)})
    # one flipped bit changes the digest
    flipped = tt["z"][0].clone()
    flipped.view(torch.int32)[0, 0] ^= 1
    assert P.tree_hash({**tt, "z": [flipped, tt["z"][1]]}) != P.tree_hash(tt)


def test_combine_row_hashes_equals_jax():
    pairs = [(2, "ab"), (0, "cd"), (5, "ef")]
    assert P.combine_row_hashes(pairs) == J.combine_row_hashes(pairs)
    assert P.combine_row_hashes(pairs[::-1]) == P.combine_row_hashes(pairs)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["adaptive", "adaptive_cfg"])
def test_adaptive_refused_naming_item_3(case):
    from repro_torch.core.adaptive import AdaGradCmpConfig

    if case == "adaptive":
        sc = dataclasses.replace(_hsched(P), adaptive=object())
        kw = {}
    else:
        sc, kw = _hsched(P), {"adaptive_cfg": AdaGradCmpConfig()}
    with pytest.raises(NotImplementedError, match="A.14 item 3"):
        P.simulate(sc, **kw)


def test_bounded_stale_refused_naming_item_2():
    """``sync="bounded_stale"`` was refused here until the bounded-stale
    engine was ported (A.14 item 2); the scenario the refusal was pinned
    on now runs, timing-only, into JAX's timeline (``tests/
    test_torch_engine.py`` holds the rest of the engine's twins)."""
    got = P.simulate(_hsched(P, sync="bounded_stale"))
    want = J.simulate(_hsched(J, sync="bounded_stale"))
    assert got.fingerprint() == want.fingerprint()
    assert got.structural_fingerprint() == want.structural_fingerprint()
    assert got.to_dict() == want.to_dict()
    assert len(got.events) == 3 * 4
    assert all(e.cluster is not None for e in got.events)


def test_pp_lm_problem_refused_naming_item_4():
    with pytest.raises(NotImplementedError, match="A.14 item 4"):
        P.problem_from_dict({"kind": "pp_lm", "n_stages": 2})
    d = {"kind": "pp_lm", "n_stages": 2, "data_parallel": 2}
    from repro.sim.problems import xla_device_count as jcount
    from repro_torch.sim.problems import xla_device_count as pcount
    assert pcount(d) == jcount(d) == 4
    spec = P.QuadraticSpec(n_clusters=3, d=8)
    assert P.problem_from_dict(spec.to_dict()) == spec
    assert spec.to_dict() == J.QuadraticSpec(n_clusters=3, d=8).to_dict()
    assert pcount(spec.to_dict()) == 1
    with pytest.raises(ValueError, match="unknown problem kind"):
        P.problem_from_dict({"kind": "nope"})


def _raise(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - compared below
        return type(e).__name__, str(e)
    return None


# each: (module -> a call that the JAX package refuses)
JAX_REFUSALS = {
    "byzantine_barrier": lambda m: m.simulate(_hsched(
        m, faults=m.FaultSchedule((m.Byzantine(1, 0, 2),)))),
    "bounded_stale_with_schedule": lambda m: m.simulate(
        _hsched(m, sync="bounded_stale"), rank_schedule=[4] * 4),
    "gossip_allreduce_per_step": lambda m: m.simulate(_hsched(
        m, topology="ring", allreduce_per_step=True)),
    "balance_allreduce_per_step": lambda m: m.simulate(_hsched(
        m, allreduce_per_step=True, h_spec=_hspec(m, policy="balance"))),
    "initial_alive_shape": lambda m: m.simulate(_hsched(
        m, initial_alive=(True, False))),
    "short_rank_schedule": lambda m: m.simulate(_hsched(m),
                                                rank_schedule=[4, 4]),
    "per_edge_schedule_on_star": lambda m: m.simulate(
        _hsched(m), rank_schedule=[[4, 4, 4]] * 4),
    "per_edge_schedule_wrong_length": lambda m: m.simulate(
        _hsched(m, topology="ring", n_clusters=4),
        rank_schedule=[[4, 4]] * 4),
    "seed_schedule_on_ring": lambda m: _hsched(
        m, topology="ring", topology_seed_schedule=(0, 1)),
    "empty_seed_schedule": lambda m: _hsched(
        m, topology="random", topology_seed_schedule=()),
    "bad_sync": lambda m: _hsched(m, sync="async"),
    "bad_engine": lambda m: _hsched(m, inner_engine="moe"),
    "bad_aggregation": lambda m: _hsched(m, aggregation="median"),
    "trimmed_under_barrier": lambda m: _hsched(m, aggregation="trimmed_mean"),
    "negative_staleness": lambda m: _hsched(m, sync="bounded_stale",
                                            max_staleness=-1),
    "stale_allreduce": lambda m: _hsched(m, sync="bounded_stale",
                                         allreduce_per_step=True),
    "stale_h_spec": lambda m: _hsched(m, sync="bounded_stale",
                                      h_spec=_hspec(m, policy="balance")),
    "stale_pp": lambda m: _hsched(m, sync="bounded_stale",
                                  inner_engine="pp"),
}


@pytest.mark.parametrize("name", sorted(JAX_REFUSALS))
def test_jax_refusals_keep_their_messages(name):
    want = _raise(lambda: JAX_REFUSALS[name](J))
    got = _raise(lambda: JAX_REFUSALS[name](P))
    assert want is not None
    assert got == want
