"""Port parity for the dry-run (``repro_torch.launch.dryrun``) and the
pieces it stands on, on the CPU.

1. The spec helpers (``launch/steps.py``: ``input_specs``,
   ``decode_state_specs``, ``params_specs``, ``opt_specs``,
   ``outer_state_specs``) against JAX's ``eval_shape`` trees, keystr for
   keystr, in shape and dtype, for every dense config and shape.
2. ``make_cluster_mesh`` on an ``{axis: size}`` mapping against JAX's on
   a mesh over repeated CPU devices.
3. ``make_prefill_step`` against JAX's on reduced configs (f32), rtol and
   atol 1e-5; the sharded prefill (``TPLoss.prefill``) against it.
4. Per-rank state bytes at both production meshes against the JAX rules
   on the duck-typed mesh, exactly: params and AdamW for training, params
   for serving; the decode cache against the port's KV-head rule and the
   JAX rule's bytes; the parameter count against JAX's ``params_specs``.
5. gloo ranks' recorded collectives (``parallel/comm.py``) entry for
   entry against the meta run of each rank: the tensor-parallel train
   step at 1 x 2 x 2, train and outer step with 2 clusters (2 x 1 x 2),
   2 pipeline stages (1 x 2 x 2), the 2-D decode step at 2 x 2, whose
   ranks are also bit for bit the in-process shards and give the
   one-card run's tokens.
6. ``lower_one`` at full size: granite-3-8b and qwen1.5-107b ``train_4k``
   (the outer step's whole-leaf gather overflows a card at qwen1.5-107b),
   a decode row, the ``not_ported`` and ``skipped`` rows, the ``--all``
   matrix's statuses and the summary line; the arg bytes of 4j's layout
   against the state the mesh driver holds (reduced opt-1.3b).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jax_get_config
from repro.core import mesh_compression as jmc
from repro.launch import mesh as jmesh
from repro.launch import steps as JSteps
from repro.models import model as JM
from repro.parallel import sharding as JSH
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import base
from repro_torch.core import mesh_compression as mc
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.launch import train as TR
from repro_torch.models import model as M
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh
from repro_torch.parallel import tensor as TP

CPU = torch.device("cpu")
META = torch.device("meta")
MATRIX_DENSE = ["granite-3-8b", "stablelm-12b", "phi3-medium-14b",
                "gemma3-1b"]


class FakeMesh:
    """Duck-typed mesh: only .shape is consulted by the rule functions."""
    def __init__(self, shape):
        self.shape = shape


@pytest.fixture
def bare_specs(monkeypatch):
    """The JAX rules returning their ``PartitionSpec``s, so they run on the
    duck-typed mesh at real axis sizes."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)


def _prod(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def _jax_items(tree):
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_items(tree):
    return {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for k, x in T.keystr_items(tree)}


# ---------------------------------------------------------------------------
# 1. the spec helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_spec_helpers_match_jax_eval_shape(arch):
    jcfg, cfg = _prod(jax_get_config(arch)), _prod(base.get_config(arch))
    for name, shape in base.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            JSHAPES[name])
        n = 2 if shape.kind == "train" else 1
        assert _port_items(steps.input_specs(cfg, shape, n_clusters=n)) == \
            _jax_items(JSteps.input_specs(jcfg, JSHAPES[name],
                                          n_clusters=n)), name
        if shape.kind == "decode":
            assert _port_items(steps.decode_state_specs(cfg, shape)) == \
                _jax_items(JSteps.decode_state_specs(jcfg, JSHAPES[name]))
    for n in (0, 2):
        assert _port_items(steps.params_specs(cfg, n_clusters=n)) == \
            _jax_items(JSteps.params_specs(jcfg, n_clusters=n))
    stacked = steps.params_specs(cfg, n_clusters=2)
    assert _port_items(steps.opt_specs(stacked)) == _jax_items(
        JSteps.opt_specs(JSteps.params_specs(jcfg, n_clusters=2)))
    assert _port_items(steps.outer_state_specs(
        cfg, 2, mc.MeshCompressionConfig(rank=128))) == _jax_items(
        JSteps.outer_state_specs(jcfg, 2, jmc.MeshCompressionConfig(
            rank=128)))


# ---------------------------------------------------------------------------
# 2. the cluster mesh of a mapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,n", [((4, 3), None), ((4, 3), 4),
                                     ((2, 2, 3), None), ((4, 3), 3)])
def test_cluster_mesh_of_a_mapping_matches_jax(shape, n):
    from jax.sharding import Mesh

    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    devs = np.array(jax.devices() * int(np.prod(shape)),
                    dtype=object).reshape(shape)
    base_map = dict(zip(axes, shape))
    if n == 3:
        with pytest.raises(ValueError, match="not divisible by 3"):
            jmesh.make_cluster_mesh(Mesh(devs, axes), n_clusters=n)
        with pytest.raises(ValueError, match="not divisible by 3"):
            tmesh.make_cluster_mesh(base_map, n_clusters=n)
        return
    want = jmesh.make_cluster_mesh(Mesh(devs, axes), n_clusters=n)
    got = tmesh.make_cluster_mesh(base_map, n_clusters=n)
    assert tuple(got) == tuple(want.axis_names)
    assert tuple(got.values()) == tuple(want.devices.shape)


def test_production_cluster_meshes():
    assert tmesh.make_cluster_mesh(tmesh.make_production_mesh()) == \
        {"clusters": 2, "data": 8, "model": 16}
    assert tmesh.make_cluster_mesh(tmesh.make_production_mesh(
        multi_pod=True)) == {"clusters": 2, "data": 16, "model": 16}


# ---------------------------------------------------------------------------
# 3. prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["opt-1.3b", "granite-3-8b", "gemma3-1b",
                                  "stablelm-12b"])
def test_prefill_step_matches_jax(arch):
    """The port's ``make_prefill_step`` against JAX's on carried weights;
    the sharded prefill (``TPLoss.prefill`` at 2 x 2, the training
    placement) against the port's."""
    jcfg, cfg = jax_get_config(arch).reduced(), base.get_config(arch).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = ckpt.params_from_flat(jflatten(jparams), cfg, CPU)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 24)).astype(np.int32)
    want = np.asarray(JSteps.make_prefill_step(jcfg)(
        jparams, {"tokens": jax.numpy.asarray(toks)}))
    got = steps.make_prefill_step(cfg)(params,
                                       {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    shards = TP.ShardGroup(2, 2)
    specs = sh.param_placements(params, shards.mesh, cluster_stacked=False)
    parts = {k: shards.parts(x, specs[k]) for k, x in
             T.keystr_items(params)}
    t = torch.from_numpy(toks)
    tp = torch.cat(TP.TPLoss(cfg, shards, specs).prefill(parts,
                                                         [t[:2], t[2:]]))
    np.testing.assert_allclose(tp.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# 4. a rank's state at the production meshes
# ---------------------------------------------------------------------------

ITEMSIZE = {"bfloat16": 2, "float32": 4, "int32": 4}


def _rule_bytes(tree, specs, mesh):
    """Per-device bytes of ``tree`` under ``specs`` ({keystr: spec})."""
    total = 0
    for k, (shape, dtype) in _jax_items(tree).items():
        n = int(np.prod(shape)) * ITEMSIZE[dtype]
        for a in specs[k]:
            n //= mesh[a] if a else 1
        total += n
    return total


def _spec_items(tree):
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", MATRIX_DENSE + ["qwen1.5-107b"])
def test_rank_state_bytes_match_jax_rules(arch, multi_pod, bare_specs):
    jcfg, cfg = _prod(jax_get_config(arch)), _prod(base.get_config(arch))
    bmesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    cm = tmesh.make_cluster_mesh(bmesh)
    # training: cluster-stacked params and the vmapped AdamW state
    jp = JSteps.params_specs(jcfg, n_clusters=2)
    jo = JSteps.opt_specs(jp)
    fm = FakeMesh(cm)
    want = _rule_bytes(jp, _spec_items(JSH.param_shardings(
        jp, fm, cluster_stacked=True)), cm)
    # m and v, and the (C,) step counters over "clusters": 4 bytes a rank
    want_opt = _rule_bytes(jo.m, _spec_items(JSH.param_shardings(
        jo.m, fm, cluster_stacked=True)), cm) * 2 + 4
    coords = {"clusters": 1, "data": 3, "model": 5}
    st, _ = DR.train_gspmd_phases(cfg, base.SHAPES["train_4k"], cm, coords,
                                  DR.meta_groups(cm, coords), META)
    assert DR.state_bytes(st["params"]) == want
    assert DR.state_bytes(st["opt"]) == want_opt
    # serving: the 2-D params on the serving mesh, the cache by KV head
    smesh = tmesh.make_serving_mesh(bmesh)
    jp1 = JSteps.params_specs(jcfg)
    want = _rule_bytes(jp1, _spec_items(JSH.param_shardings(
        jp1, FakeMesh(smesh), cluster_stacked=False)), smesh)
    shape = base.SHAPES["decode_32k"]
    coords = {"data": 2, "model": 7}
    st, _ = DR.decode_phases(cfg, shape, smesh, coords,
                             DR.meta_groups(smesh, coords), META)
    assert DR.state_bytes(st["params"]) == want
    lo, hi = TP.kv_heads(cfg, smesh["model"], coords["model"])
    B = shape.global_batch // smesh["data"]
    hd = cfg.resolved_head_dim
    cache = 0
    for seg in M.build_segments(cfg):
        S = seg.window if 0 < seg.window < shape.seq_len else shape.seq_len
        cache += seg.n * B * S * ((hi - lo) * hd * 2 * 2 + (
            4 if 0 < seg.window < shape.seq_len else 0))
    assert DR.state_bytes(st["cache"]) == cache
    # the JAX rule's cache bytes, which the dry-run reports beside
    js = JSteps.decode_state_specs(jcfg, JSHAPES["decode_32k"])
    rule = _rule_bytes(js, _spec_items(JSH.decode_state_shardings(
        js, FakeMesh(smesh), seq_shard=False)), smesh)
    assert DR.jax_rule_cache_bytes(cfg, shape, smesh) == rule
    assert cache >= rule


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_param_count_matches_jax(arch):
    jp = JSteps.params_specs(jax_get_config(arch))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert sum(x.numel() for x in T.leaves(steps.params_specs(
        base.get_config(arch)))) == want


def test_meta_tracker_counts_live_bytes_traffic_and_flops():
    """Storages counted once with their views, freed when released; each
    operation's inputs read and outputs written, views and allocations
    moving nothing; the matrix products' FLOPs."""
    from repro_torch.obs.memtrack import MetaTracker

    held = torch.empty((4, 8), device=META)
    held_t = held.T                       # a view of the same storage
    tr = MetaTracker()
    with tr:
        assert tr.hold({"a": held, "b": [held_t]}) == 128
        x = torch.empty((16, 8), device=META)         # 512 B, no traffic
        y = x @ held_t                                  # reads 640, writes 256
        v = y.view(-1)                                  # a view: nothing
        del x
        z = torch.zeros(64, device=META)                # writes 256
    assert tr.peak == 128 + 512 + 256
    assert tr.live == 128 + 256 + 256
    assert tr.read == 512 + 128 and tr.written == 256 + 256
    assert tr.flops == 2 * 16 * 8 * 4
    assert v.numel() == 64 and z.numel() == 64


def test_on_device_runs_the_plain_version_on_meta():
    from types import SimpleNamespace

    from repro_torch.device import on_device

    def cuda_fn(x):
        raise AssertionError("no kernel off the card")

    for dev in ("meta", "cpu"):
        t = torch.empty(3, device=dev)
        assert on_device(t, cuda_fn, lambda x: x * 2, t).shape == (3,)
    with pytest.raises(ValueError, match="unsupported device"):
        on_device(SimpleNamespace(device=torch.device("mps")), cuda_fn,
                  lambda: None)


# ---------------------------------------------------------------------------
# 5. gloo ranks' collectives against the meta runs
# ---------------------------------------------------------------------------

LEGS = {  # leg: (arch, mesh, shape)
    "train_tp": ("granite-3-8b", {"clusters": 1, "data": 2, "model": 2},
                 base.ShapeConfig("t", 16, 4, "train")),
    "train_outer": ("opt-1.3b", {"clusters": 2, "data": 1, "model": 2},
                    base.ShapeConfig("t", 16, 4, "train")),
    "pipeline": ("granite-3-8b", {"clusters": 1, "data": 2, "model": 2},
                 base.ShapeConfig("t", 16, 8, "train")),
    "decode": ("opt-1.3b", {"data": 2, "model": 2},
               base.ShapeConfig("d", 8, 4, "decode")),
}
PHASES = {"train_tp": DR.train_gspmd_phases,
          "train_outer": DR.train_gspmd_phases,
          "pipeline": DR.train_pipeline_phases, "decode": DR.decode_phases}


def _leg_run(leg, coords, groups, device, generator=None, **kw):
    arch, mesh, shape = LEGS[leg]
    cfg = base.get_config(arch).reduced()
    extra = dict(n_micro=2) if leg == "pipeline" else {}
    if leg == "train_outer":
        extra["rank"] = 8
    st, phases = PHASES[leg](cfg, shape, mesh, coords, groups, device,
                             generator=generator, **extra, **kw)
    with comm.recording() as log:
        for _, fn in phases:
            fn()
    return st, [list(e) for e in log]


def _legs_worker(rank, store, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    out = {}
    try:
        for leg, (_, mesh, _) in LEGS.items():
            dm = init_device_mesh("cpu", tuple(mesh.values()),
                                  mesh_dim_names=tuple(mesh))
            coords = dict(zip(mesh, dm.get_coordinate()))
            groups = {a: dm.get_group(a) for a in mesh}
            per = mesh.get("data", 1) * mesh.get("model", 1)
            clusters = [dist.new_group(list(range(c * per, (c + 1) * per)))
                        for c in range(4 // per)]
            groups["cluster"] = clusters[coords.get("clusters", 0)]
            gen = torch.Generator().manual_seed(0)
            digests = []
            kw = {}
            if leg == "decode":
                kw["on_logits"] = lambda rows, parts: digests.extend(
                    [list(rows), m, T.bit_digest(lg)] for m, lg in parts)
            st, log = _leg_run(leg, coords, groups, CPU, gen, **kw)
            out[leg] = {"coords": coords, "entries": log}
            if leg == "decode":
                out[leg]["tokens"] = st["out"][:, 0].tolist()
                out[leg]["digests"] = digests
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def gloo_legs(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("legs")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_legs_worker,
                         args=(r, str(d / "store"), str(d)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0] * 4
    out = []
    for r in range(4):
        with open(d / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("leg", list(LEGS))
def test_gloo_collectives_equal_the_meta_run(gloo_legs, leg):
    mesh = LEGS[leg][1]
    seen = set()
    for rank in gloo_legs:
        coords = rank[leg]["coords"]
        _, want = _leg_run(leg, coords, DR.meta_groups(mesh, coords), META)
        assert rank[leg]["entries"] == want, (leg, coords)
        assert want
        seen |= {tuple(e[:2]) for e in want}
    # (the outer step hands its payloads to the clusters group's all-gather
    # also where that group is one rank, as the driver does)
    axes = {"train_tp": {"data", "model", "data,model", "clusters"},
            "train_outer": {"model", "data,model", "clusters"},
            "pipeline": {"data", "model"}, "decode": {"data", "model"}}[leg]
    assert {a for a, _ in seen} == axes


def test_2d_decode_ranks_equal_in_process_and_one_card(gloo_legs):
    arch, mesh, shape = LEGS["decode"]
    cfg = base.get_config(arch).reduced()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        gen = torch.Generator().manual_seed(0)
        params = M.init_params(cfg, gen, CPU)
        toks = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
        toks.random_(0, cfg.vocab_size, generator=gen)
        shards = TP.ShardGroup(mesh["data"], mesh["model"])
        specs = sh.param_placements(params, shards.mesh,
                                    cluster_stacked=False)
        tp = TP.TPDecode(cfg, shards, placement="2d")
        digests = []
        tp.on_logits = lambda rows, parts: digests.extend(
            [list(rows), m, T.bit_digest(lg)] for m, lg in parts)
        state = tp.init_decode_state(shape.global_batch, shape.seq_len, CPU)
        parts = {k: shards.parts(x, specs[k]) for k, x in
                 T.keystr_items(params)}
        nxt, _ = steps.make_serve_step(cfg, tp=tp)(parts, state, toks)
        one, _ = steps.make_serve_step(cfg)(
            params, M.init_decode_state(cfg, shape.global_batch,
                                        shape.seq_len, CPU), toks)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(nxt, one)
    got = [d for rank in gloo_legs for d in rank["decode"]["digests"]]
    assert sorted(map(json.dumps, got)) == sorted(map(json.dumps, digests))
    for rank in gloo_legs:
        assert rank["decode"]["tokens"] == nxt[:, 0].tolist()


# ---------------------------------------------------------------------------
# 6. lower_one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [
    "granite-3-8b", pytest.param("qwen1.5-107b", marks=pytest.mark.slow)])
def test_lower_one_train_full_size(arch):
    res = DR.lower_one(arch, "train_4k", verbose=False)
    assert res["status"] == "ok", res
    jp = JSteps.params_specs(jax_get_config(arch))
    assert res["param_count"] == sum(int(np.prod(x.shape))
                                     for x in jax.tree.leaves(jp))
    assert res["arg_bytes"] == sum(res["arg_bytes_by_part"].values())
    assert res["per_device_memory_bytes"] == max(
        p["peak_bytes"] for p in res["phases"].values())
    assert res["temp_bytes"] > 0 and res["flops_per_device"] > 0
    assert set(res["phases"]) == {"train", "outer"}
    # one cluster row of the 2: its payloads cross, nothing else does but
    # the loss's 8-byte sum
    assert res["cross_cluster_bytes"] == \
        res["phases"]["outer"]["cross_cluster_bytes"] + 8
    # granite-3-8b fits a card; at qwen1.5-107b the outer step's owner,
    # which gathers whole leaves and reconstructs both clusters' copies,
    # overflows it most (so does the inner step: 78 remat'd unit inputs
    # of 16 x 4,096 x 8,192 bf16)
    ph = res["phases"]
    assert res["fits_80gib"] == (arch == "granite-3-8b")
    if arch == "qwen1.5-107b":
        assert ph["outer"]["peak_bytes"] > ph["train"]["peak_bytes"] \
            > DR.CARD_BYTES


def test_lower_one_decode_and_statuses(capsys):
    res = DR.lower_one("gemma3-1b", "decode_32k", multi_pod=True,
                       verbose=False)
    assert res["status"] == "ok", res
    assert res["mesh"] == "{'data': 32, 'model': 16}"
    # gemma3-1b's 4 heads do not divide 16: attention and its cache whole
    # on every model shard, where the JAX rule splits the head dim
    assert res["arg_bytes_by_part"]["cache"] > res["jax_rule_cache_bytes"]
    assert DR.lower_one("deepseek-v2-236b", "train_4k", verbose=False)[
        "status"] == "not_ported"
    sk = DR.lower_one("granite-3-8b", "long_500k", verbose=False)
    assert sk["status"] == "skipped" and "sub-quadratic" in sk["reason"]
    lg = DR.lower_one("gemma3-1b", "long_500k", verbose=False)
    assert lg["status"] == "not_ported" and "A.11h" in lg["reason"]
    # the --all matrix: each row's status before anything runs
    rows = [DR._status(a, base.SHAPES[s], (32 if mp else 16))
            for a in DR.matrix_archs() for s in base.SHAPES
            for mp in (False, True)]
    counts = {k: sum((r or ("ok",))[0] == k for r in rows)
              for k in ("ok", "skipped", "not_ported")}
    assert counts == {"ok": 24, "skipped": 6, "not_ported": 50}
    capsys.readouterr()
    with pytest.raises(SystemExit):     # the pipeline refuses gemma3-1b
        DR.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--mode",
                 "pipeline"])
    assert capsys.readouterr().out.rstrip().endswith(
        "DRYRUN SUMMARY ok=0 skipped=0 not_ported=0 fail=1")
    DR.main(["--arch", "xlstm-1.3b", "--shape", "long_500k"])
    assert capsys.readouterr().out.rstrip().endswith(
        "DRYRUN SUMMARY ok=0 skipped=0 not_ported=1 fail=0")


@pytest.mark.slow
def test_dryrun_all_matrix(capsys):
    DR.main(["--all"])
    assert capsys.readouterr().out.rstrip().endswith(
        "DRYRUN SUMMARY ok=24 skipped=6 not_ported=50 fail=0")


def test_arg_bytes_are_the_mesh_drivers_state():
    """Phase 4j's layout at the reduced opt-1.3b: one cluster, 1 x 1, f32,
    rank 8: ``arg_bytes`` is the bytes of the round state the mesh driver
    holds, and the cross-cluster bytes what it hands the all-gather."""
    cfg = base.get_config("opt-1.3b").reduced()
    res = DR.lower_one("opt-1.3b", mesh={"clusters": 1, "data": 1,
                                         "model": 1},
                       shape=base.ShapeConfig("mesh", 16, 4, "train"),
                       rank=8, production=False, cfg=cfg, verbose=False)
    assert res["status"] == "ok", res
    held = []
    summary = TR.main(["--arch", "opt-1.3b", "--smoke", "--device", "cpu",
                       "--devices", "1", "--clusters", "1", "--data", "1",
                       "--model", "1", "--rounds", "1", "--h-steps", "1",
                       "--global-batch", "4", "--seq-len", "16", "--rank",
                       "8"],
                      on_round=lambda r, p, o, st: held.append(
                          DR.state_bytes({"params": p, "opt": o,
                                          "outer": st})))
    assert res["arg_bytes"] == held[0]
    assert res["phases"]["outer"]["cross_cluster_bytes"] == \
        summary["gather_bytes"][0]
