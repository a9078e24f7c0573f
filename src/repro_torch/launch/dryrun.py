"""The multi-pod dry-run (port of ``repro.launch.dryrun``, spec
deliverable e): what one rank of the production mesh needs, on H100s.

    python -m repro_torch.launch.dryrun --arch qwen1.5-107b \\
        --shape train_4k [--multi-pod] [--mode gspmd|pipeline] \\
        [--no-outer] [--rank 128] [--out results.json]
    python -m repro_torch.launch.dryrun --all        # JAX's matrix
    python -m repro_torch.launch.dryrun --inner pp --arch qwen1.5-107b

Runs on the CPU and needs no card. The JAX version lowers the mesh step
through XLA and reads ``memory_analysis()``, ``cost_analysis()`` and the
HLO's collectives. The port has no compiler between it and the card, so
it runs one rank of its own step on the ``meta`` device at full size,
with production dtypes (bf16 params and compute) and no memory, under
``parallel/sharding.py``'s placements, and counts as it goes:

  - memory: the storages alive at once, the rank's state included, and
    their peak (``obs/memtrack.py``; before the allocator's rounding and
    the CUDA context);
  - work: FLOPs of the matrix products (``FlopCounterMode``) and the
    bytes each ATen operation reads and writes, with no fusion, so an
    upper bound on the traffic;
  - collectives: the ``(axis, kind, bytes)`` of every collective the
    rank issues (``parallel/comm.py``), its own step's, not GSPMD's: the
    "clusters" axis's bytes cross the 1 Gbps cluster boundary.

The roofline terms divide these by one H100's peaks (below). Modes:

  - train, gspmd: ``parallel/tensor.py::TPLoss``'s ``value_and_grad``
    and AdamW on the cluster mesh (``launch/mesh.py::make_cluster_mesh``)
    for one cluster row, then the outer step (``--no-outer``: not), on
    the rank that the sharded outer step's owner map (leaf j on rank
    j mod D*M) gives the most whole-leaf bytes;
  - train, pipeline: 16 stages over "model", 16 microbatches, one inner
    step; the first and the last stage run, the larger reported, with
    the GPipe bubble share;
  - prefill: ``TPLoss.prefill`` on the serving mesh with the training
    (2-D) placement; decode: one step of ``TPDecode(placement="2d")``
    (the JAX dry-run's default serving layouts).

Statuses: ``ok``; ``skipped`` (the JAX shape table's reason);
``not_ported`` (the six non-dense configs, A.16; a decode whose batch is
smaller than "data", whose cache JAX shards by sequence, A.11h);
``fail``. Attention runs the einsum route until A.18b gives the flash
kernels a meta path.

``--inner pp`` is the pipeline-parallel inner engine's shape check
(``pp_inner_smoke``): the round state built on ``meta``, one inner step
through the GPipe schedule a shape fixed point of the params and AdamW
state, ``extract_delta`` an f32 tree congruent with the params, every
leaf placed. Prints ``PP-INNER-SMOKE-OK arch=... stages=...
layers_per_stage=... params=...``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict

import torch

from repro_torch import tree as T
from repro_torch.configs import base
from repro_torch.core import diloco
from repro_torch.core import mesh_compression as mc
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.obs.memtrack import MetaTracker
from repro_torch.parallel import comm
from repro_torch.parallel import inner_engine as IE
from repro_torch.parallel import pipeline as PP
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.tensor import ShardGroup, TPDecode, TPLoss


def production_dtypes(cfg):
    return base.with_dtype(cfg, "bfloat16")


def pp_inner_smoke(arch: str, *, n_stages: int = 8, n_micro: int = 8,
                   batch: int = 16, seq_len: int = 512,
                   verbose: bool = True) -> Dict[str, Any]:
    """``--inner pp``: the full-size model through the pipeline-parallel
    inner engine on ``meta`` tensors (shapes only, no memory, no
    compute)."""
    res: Dict[str, Any] = {"arch": arch, "shape": f"pp_inner_b{batch}",
                           "mode": "pp_inner", "n_stages": n_stages}
    t0 = time.time()
    try:
        cfg = production_dtypes(base.get_config(arch))
        pcfg = PP.PipelineConfig(n_stages=n_stages, n_micro=n_micro)
        lps, pad = PP.layers_per_stage(cfg, pcfg)
        meta = torch.device("meta")
        state = IE.init_train_state(cfg, pcfg, None, meta)
        specs = IE.state_shardings(state)
        assert list(specs) == [k for k, _ in T.keystr_items(state)]
        for k, x in T.keystr_items(state):
            sp = specs[k]
            assert len(sp) == x.dim(), (k, sp, tuple(x.shape))
            assert ("model" in sp) == PP.is_stage_path(k), (k, sp)

        sd = lambda t: [(k, tuple(x.shape), x.dtype)
                        for k, x in T.keystr_items(t)]
        before = sd(state.params), sd(state.inner_opt)
        train_step = IE.make_pp_train_step(cfg, pcfg, inner_lr=1e-4)
        toks = torch.zeros((batch, seq_len), dtype=torch.int32, device=meta)
        p2, o2, loss = train_step(state.params, state.inner_opt, toks)
        assert sd(p2) == before[0], "inner step not a shape fixed point"
        assert sd(o2) == before[1]
        assert tuple(loss.shape) == ()

        delta = IE.extract_delta(state.params, state._replace(params=p2))
        assert [k for k, _ in T.keystr_items(delta)] == \
            [k for k, _ in T.keystr_items(state.params)]
        assert all(x.dtype == torch.float32 for x in T.leaves(delta))
        for (k, d), p in zip(T.keystr_items(delta), T.leaves(p2)):
            assert d.shape == p.shape, k

        n_params = sum(x.numel() for x in T.leaves(state.params))
        res.update({
            "status": "ok", "layers_per_stage": lps, "padded_layers": pad,
            "n_micro": n_micro, "param_count": n_params,
            "state_bytes": sum(x.numel() * x.element_size()
                               for x in T.leaves(state)),
            "bubble_frac": (n_stages - 1) / (n_micro + n_stages - 1),
        })
        print(f"PP-INNER-SMOKE-OK arch={arch} stages={n_stages} "
              f"layers_per_stage={lps} params={n_params}")
    except Exception as e:  # noqa: BLE001 - reported, and the exit code says
        res["status"] = "fail"
        res["error"] = f"{type(e).__name__}: {str(e)[:500]}"
    res["seconds"] = round(time.time() - t0, 1)
    if verbose:
        print(json.dumps(res)[:2000])
    return res


# ---------------------------------------------------------------------------
# one NVIDIA H100 80GB HBM3 (SXM5) at 700 W: NVIDIA's datasheet peaks
# ---------------------------------------------------------------------------

SMS, TENSOR_CORES_PER_SM = 132, 4
# dense bf16 on the tensor cores: 132 SMs x 4 x 1,024 FLOP a clock (512
# FMAs) x 1.83 GHz = 989.4e12
BF16_FLOPS_PER_S = SMS * TENSOR_CORES_PER_SM * 1024 * 1.83e9
# dense TF32 on the tensor cores: half the bf16 rate (chip_smoke's 495e12)
TF32_FLOPS_PER_S = BF16_FLOPS_PER_S / 2
# f32 outside the tensor cores: 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz
# (the max SM clock) = 66.9e12 (chip_smoke's 67e12); matmuls in f32 take it
# (TF32 is off)
F32_FLOPS_PER_S = SMS * 128 * 2 * 1.98e9
HBM_BYTES_PER_S = 3.35e12        # HBM3, 5 stacks
# NVLink 4: 18 links x 25 GB/s each way = 450 GB/s per direction, for the
# "data" and "model" axes (optimistic where an axis spans nodes: 16 ranks
# are two 8-card nodes)
NVLINK_BYTES_PER_S = 18 * 25e9
DCN_BYTES_PER_S = 0.125e9        # the paper's 1 Gbps between clusters
CARD_BYTES = 80 * 2 ** 30

META = torch.device("meta")
NOT_PORTED_DECODE = "A.11h"      # the seq-sharded (context-parallel) cache


# ---------------------------------------------------------------------------
# a rank's groups
# ---------------------------------------------------------------------------

def meta_groups(mesh: Dict[str, int], coords: Dict[str, int]
                ) -> Dict[str, Any]:
    """``comm.MetaGroup``s of the rank at ``coords`` of ``mesh``: one per
    axis, and ``"cluster"`` (its cluster's data x model ranks)."""
    out = {a: comm.MetaGroup(n, coords.get(a, 0)) for a, n in mesh.items()}
    D, Mm = mesh.get("data", 1), mesh.get("model", 1)
    out["cluster"] = comm.MetaGroup(D * Mm, coords.get("data", 0) * Mm
                                    + coords.get("model", 0))
    return out


def shard_group(mesh: Dict[str, int], coords: Dict[str, int], groups):
    """The rank's ``tensor.ShardGroup`` (None for one shard a cluster)."""
    D, Mm = mesh["data"], mesh["model"]
    if D * Mm == 1:
        return None
    return ShardGroup(D, Mm, data_group=groups["data"],
                      model_group=groups["model"], group=groups["cluster"],
                      coords=(coords["data"], coords["model"]))


def _rows(n: int, parts: int) -> int:
    """A data shard's rows of an n-row batch (all of them where the data
    axis does not divide it: the batch placement leaves it whole)."""
    return n // parts if n % parts == 0 else n


# ---------------------------------------------------------------------------
# the steps, on any device (meta here; the CPU with gloo groups in the
# tests, whose recorded collectives must equal these)
# ---------------------------------------------------------------------------

def owner_rank(cfg, mesh: Dict[str, int]) -> int:
    """The cluster rank (j * M + m) to which the sharded outer step's
    owner map (leaf j on rank j mod D*M) gives the most whole-leaf
    bytes."""
    n = mesh["data"] * mesh["model"]
    load = [0] * n
    for j, x in enumerate(T.leaves(M.init_params(cfg, device=META))):
        load[j % n] += x.numel()
    return max(range(n), key=lambda r: (load[r], -r))


def train_gspmd_phases(cfg, shape, mesh, coords, groups, device, *,
                       rank: int = 128, include_outer: bool = True,
                       generator=None):
    """The rank's round state and its phases: ``(state, [(name, fn)])``,
    ``train`` one inner step of its cluster row (``launch/steps.py::
    make_train_step`` over its shard group), ``outer`` the outer step,
    as ``launch/train.py``'s ``run`` builds and calls them."""
    shards = shard_group(mesh, coords, groups)
    ccfg = mc.MeshCompressionConfig(rank=rank)
    params1 = M.init_params(cfg, generator, device)
    q0 = None
    if shards is not None:
        q0 = mc.init_q_state(params1, ccfg)
        params1 = sh.shard_tree(params1, sh.param_placements(
            params1, shards.mesh, cluster_stacked=False), shards.mesh,
            {"data": coords["data"], "model": coords["model"]})
    params, opt, outer = steps.init_round_state(params1, 1, ccfg, q0=q0)
    st = {"params": params, "opt": opt, "outer": outer}
    cg = groups["clusters"]
    B = _rows(shape.global_batch // mesh["clusters"], mesh["data"])
    train_step = steps.make_train_step(cfg, shards=shards, cluster_group=cg)
    outer_step = steps.make_outer_step(cfg, ccfg, cluster_group=cg,
                                       shards=shards)

    def train():
        toks = torch.zeros((1, B, shape.seq_len), dtype=torch.int32,
                           device=device)
        if generator is not None:
            toks.random_(0, cfg.vocab_size, generator=generator)
        st["params"], st["opt"], _ = train_step(st["params"], st["opt"],
                                                {"tokens": toks})

    def outer_phase():
        st["params"], st["outer"] = outer_step(st["params"], st["outer"],
                                               rank)

    phases = [("train", train)]
    if include_outer:
        phases.append(("outer", outer_phase))
    return st, phases


def train_pipeline_phases(cfg, shape, mesh, coords, groups, device, *,
                          n_micro: int = 16, generator=None):
    """Stage ``coords["model"]`` of the pipeline (the "model" axis's
    stages): its rows of the pp params and AdamW state, and one inner step
    (``parallel/inner_engine.py::make_pp_train_step``)."""
    n_stages, s = mesh["model"], coords["model"]
    pcfg = PP.PipelineConfig(n_stages=n_stages, n_micro=n_micro)
    full = PP.init_pp_params(cfg, generator, pcfg, device)
    params1 = T.tree_map(lambda x: x.clone(), PP.stage_slice(full, s, s + 1))
    del full
    params = diloco.stack_replicas(params1, 1)
    st = {"params": params, "opt": steps.init_inner_state(params)}
    transport = (PP.StageGroup(groups["model"], s, n_stages)
                 if n_stages > 1 else PP.InProcess(1))
    train_step = IE.make_pp_train_step(
        cfg, pcfg, inner_lr=1e-4, transport=transport,
        data_group=groups["data"], cluster_stacked=True)
    B = _rows(shape.global_batch // mesh["clusters"], mesh["data"])

    def train():
        toks = torch.zeros((1, B, shape.seq_len), dtype=torch.int32,
                           device=device)
        if generator is not None:
            toks.random_(0, cfg.vocab_size, generator=generator)
        st["params"], st["opt"], _ = train_step(st["params"], st["opt"],
                                                toks)

    return st, [("train", train)]


def _serve_parts(cfg, mesh, coords, groups, device, generator):
    """The rank's 2-D weight blocks as ``TPLoss``/``TPDecode`` parts."""
    shards = shard_group(mesh, coords, groups) or ShardGroup(1, 1)
    whole = M.init_params(cfg, generator, device)
    specs = sh.param_placements(whole, mesh, cluster_stacked=False)
    blocks = sh.shard_tree(whole, specs, mesh, coords)
    del whole
    return shards, specs, {k: [[v]] for k, v in T.keystr_items(blocks)}


def prefill_phases(cfg, shape, mesh, coords, groups, device, *,
                   generator=None):
    """The sharded prefill (``TPLoss.prefill``) of the rank's rows."""
    shards, specs, parts = _serve_parts(cfg, mesh, coords, groups, device,
                                        generator)
    loss = TPLoss(cfg, shards, specs)
    st = {"params": parts, "out": None}
    B = _rows(shape.global_batch, mesh["data"])

    def prefill():
        toks = torch.zeros((B, shape.seq_len), dtype=torch.int32,
                           device=device)
        if generator is not None:
            toks.random_(0, cfg.vocab_size, generator=generator)
        st["out"] = loss.prefill(st["params"], [toks])

    return st, [("prefill", prefill)]


def decode_phases(cfg, shape, mesh, coords, groups, device, *,
                  generator=None, on_logits=None):
    """One greedy decode step of ``TPDecode(placement="2d")`` on the
    rank's rows of the batch, its cache the shard's KV heads
    (``on_logits``: ``TPDecode.on_logits``)."""
    shards, _, parts = _serve_parts(cfg, mesh, coords, groups, device,
                                    generator)
    tp = TPDecode(cfg, shards, placement="2d")
    tp.on_logits = on_logits
    st = {"params": parts,
          "cache": tp.init_decode_state(shape.global_batch, shape.seq_len,
                                        device)}
    step = steps.make_serve_step(cfg, tp=tp)

    def decode():
        toks = torch.zeros((shape.global_batch, 1), dtype=torch.int32,
                           device=device)
        if generator is not None:
            toks.random_(0, cfg.vocab_size, generator=generator)
        st["out"], st["cache"] = step(st["params"], st["cache"], toks)

    return st, [("decode", decode)]


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def state_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors."""
    return MetaTracker().hold(tree)


def _roofline(flops, traffic, coll, peak_flops) -> Dict[str, Any]:
    by_kind: Dict[str, int] = {}
    by_axis: Dict[str, int] = {}
    for axis, kind, n in coll:
        by_kind[kind] = by_kind.get(kind, 0) + n
        by_axis[axis] = by_axis.get(axis, 0) + n
    total = sum(by_kind.values())
    cross = by_axis.get("clusters", 0)
    return {"flops_per_device": flops, "bytes_per_device": traffic,
            "collective_bytes_per_device": by_kind,
            "collective_bytes_by_axis": by_axis,
            "collective_total_bytes": total, "cross_cluster_bytes": cross,
            "t_compute": flops / peak_flops,
            "t_memory": traffic / HBM_BYTES_PER_S,
            "t_collective_intra": (total - cross) / NVLINK_BYTES_PER_S,
            "t_collective_dcn_1gbps": cross / DCN_BYTES_PER_S}


def measure(state, phases, *, peak_flops: float = BF16_FLOPS_PER_S
            ) -> Dict[str, Any]:
    """Runs ``phases`` in order under a ``MetaTracker`` holding ``state``:
    the peak of the live bytes over all of them, the state's bytes, and
    the work, collectives and roofline terms in all and per phase."""
    tr = MetaTracker()
    out: Dict[str, Any] = {"phases": {}}
    entries = []
    with comm.recording() as log, tr:
        arg = tr.hold(state)
        for name, fn in phases:
            tr.peak = tr.live
            f0, t0, n0 = tr.flops, tr.read + tr.written, len(log)
            fn()
            ph = _roofline(tr.flops - f0, tr.read + tr.written - t0,
                           log[n0:], peak_flops)
            ph["peak_bytes"] = tr.peak
            out["phases"][name] = ph
        entries = list(log)
    peak = max(p["peak_bytes"] for p in out["phases"].values())
    out.update(_roofline(tr.flops, tr.read + tr.written, entries,
                         peak_flops))
    out.update({"per_device_memory_bytes": peak, "arg_bytes": arg,
                "temp_bytes": peak - arg, "fits_80gib": peak <= CARD_BYTES,
                "n_collectives": len(entries)})
    return out


# ---------------------------------------------------------------------------
# one (arch, shape, mesh)
# ---------------------------------------------------------------------------

def _status(arch: str, shape, serving_data: int):
    """(status, reason) before anything runs, or None."""
    if arch in base._NOT_PORTED:
        return "not_ported", (f"{arch}: not a dense config; ported with "
                              f"ROADMAP {base._NOT_PORTED[arch]}")
    ok, why = base.supports_shape(base.get_config(arch), shape)
    if not ok:
        return "skipped", why
    if shape.kind == "decode" and shape.global_batch < serving_data:
        return "not_ported", (
            f"batch {shape.global_batch} < data {serving_data}: the JAX "
            f"dry-run shards the cache's sequence over \"data\" (context "
            f"parallelism), ROADMAP {NOT_PORTED_DECODE}")
    return None


def lower_one(arch: str, shape_name: str = "", *, multi_pod: bool = False,
              rank: int = 128, include_outer: bool = True,
              mode: str = "gspmd", verbose: bool = True, mesh=None,
              shape=None, production: bool = True, cfg=None
              ) -> Dict[str, Any]:
    """One (arch, shape) on one mesh: the JAX function's result keys where
    the port has them. ``mesh``: a base ``{axis: size}`` mapping (default
    ``make_production_mesh(multi_pod=...)``; a mapping with "clusters" is
    taken as the cluster mesh itself), ``shape`` a ``ShapeConfig`` (in
    place of ``shape_name``), ``production=False`` keeps the config's own
    dtypes, ``cfg`` a config in place of ``arch``'s (a cut one)."""
    shape = shape or base.get_shape(shape_name)
    bmesh = dict(mesh or mesh_lib.make_production_mesh(multi_pod=multi_pod))
    res: Dict[str, Any] = {"arch": arch, "shape": shape.name,
                           "multi_pod": multi_pod, "mode": mode}
    smesh = (mesh_lib.make_serving_mesh(bmesh) if "clusters" not in bmesh
             else {"data": bmesh["clusters"] * bmesh["data"],
                   "model": bmesh["model"]})
    pre = _status(arch, shape, smesh["data"])
    if pre is not None:
        res.update(status=pre[0], reason=pre[1])
        if verbose:
            print(json.dumps(res))
        return res
    t0 = time.time()
    try:
        res.update(_lower(cfg or base.get_config(arch), shape, bmesh,
                          smesh, mode=mode, rank=rank,
                          include_outer=include_outer,
                          production=production))
        res["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - reported, and the summary says
        res["status"] = "fail"
        res["error"] = f"{type(e).__name__}: {str(e)[:500]}"
    res["seconds"] = round(time.time() - t0, 1)
    if verbose:
        print(json.dumps(res)[:3000])
    return res


def _lower(cfg, shape, bmesh, smesh, *, mode, rank, include_outer,
           production) -> Dict[str, Any]:

    if production:
        cfg = production_dtypes(cfg)
    peak = (BF16_FLOPS_PER_S if cfg.compute_dtype == "bfloat16"
            else F32_FLOPS_PER_S)
    out: Dict[str, Any] = {
        "param_count": sum(x.numel() for x in
                           T.leaves(M.init_params(cfg, device=META))),
        "dtypes": [cfg.param_dtype, cfg.compute_dtype],
        "peak_flops_per_s": peak, "attention": "einsum"}
    dev = META
    if shape.kind == "train":
        cm = (bmesh if "clusters" in bmesh
              else mesh_lib.make_cluster_mesh(bmesh))
        out["mesh"] = mesh_lib.describe(cm)
        if mode == "pipeline":
            return {**out, **_pipeline(cfg, shape, cm, dev, peak)}
        r = owner_rank(cfg, cm) if include_outer else 0
        coords = {"clusters": 0, "data": r // cm["model"],
                  "model": r % cm["model"]}
        st, phases = train_gspmd_phases(
            cfg, shape, cm, coords, meta_groups(cm, coords), dev, rank=rank,
            include_outer=include_outer)
        out["rank_coords"] = coords
        out["arg_bytes_by_part"] = {k: state_bytes(v) for k, v in st.items()}
        return {**out, **measure(st, phases, peak_flops=peak)}
    out["mesh"] = mesh_lib.describe(smesh)
    coords = {"data": 0, "model": 0}
    fn = prefill_phases if shape.kind == "prefill" else decode_phases
    st, phases = fn(cfg, shape, smesh, coords, meta_groups(smesh, coords),
                    dev)
    out["rank_coords"] = coords
    out["arg_bytes_by_part"] = {k: state_bytes(v) for k, v in st.items()
                                if v is not None}
    if shape.kind == "decode":
        out["seq_sharded_cache"] = False
        out["jax_rule_cache_bytes"] = jax_rule_cache_bytes(cfg, shape, smesh)
    return {**out, **measure(st, phases, peak_flops=peak)}


def jax_rule_cache_bytes(cfg, shape, smesh) -> int:
    """A rank's bytes of the decode cache as the JAX rule places it
    (``sharding.decode_state_placements``: batch over "data", head dim
    over "model"), beside the port's, which splits by KV head and keeps a
    replicated KV head a shard where M is a multiple of the KV heads."""
    st = steps.decode_state_specs(cfg, shape)
    rule = sh.decode_state_placements(st, smesh, seq_shard=False)
    total = 0
    for k, x in T.keystr_items(st):
        n = x.numel() * x.element_size()
        for a in rule[k]:
            n //= smesh[a] if a else 1
        total += n
    return total


def _pipeline(cfg, shape, cm, dev, peak, n_micro: int = 16):

    n_stages = cm["model"]
    pcfg = PP.PipelineConfig(n_stages=n_stages, n_micro=n_micro)
    lps, pad = PP.layers_per_stage(cfg, pcfg)
    stages = {}
    for s in sorted({0, n_stages - 1}):
        coords = {"clusters": 0, "data": 0, "model": s}
        st, phases = train_pipeline_phases(
            cfg, shape, cm, coords, meta_groups(cm, coords), dev,
            n_micro=n_micro)
        stages[s] = measure(st, phases, peak_flops=peak)
    worst = max(stages, key=lambda s: stages[s]["per_device_memory_bytes"])
    return {**stages[worst], "stage": worst,
            "stage_peaks": {str(s): r["per_device_memory_bytes"]
                            for s, r in stages.items()},
            "pipeline": {"n_stages": n_stages, "layers_per_stage": lps,
                         "padded_layers": pad, "n_micro": n_micro,
                         "bubble_frac": (n_stages - 1)
                         / (n_micro + n_stages - 1)}}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def matrix_archs():
    """The ``--all`` matrix's architectures: JAX's, less the paper's own
    two models."""
    return [a for a in base.JAX_ARCH_IDS if a not in ("opt-1.3b", "qwen1.5-107b")]


def summary_line(results) -> str:
    n = {k: sum(r["status"] == k for r in results)
         for k in ("ok", "skipped", "not_ported", "fail")}
    return ("DRYRUN SUMMARY " + " ".join(f"{k}={v}" for k, v in n.items()))


def main(argv=None) -> None:

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=base.JAX_ARCH_IDS
                    + ["hundred-m"])
    ap.add_argument("--shape", default="train_4k", choices=list(base.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="full matrix: every arch x shape x both meshes")
    ap.add_argument("--no-outer", action="store_true")
    ap.add_argument("--rank", type=int, default=128)
    ap.add_argument("--mode", default="gspmd", choices=["gspmd", "pipeline"])
    ap.add_argument("--inner", default="gspmd", choices=["gspmd", "pp"],
                    help="pp: the pipeline-parallel inner engine's shape "
                         "check on the meta device, in place of the mesh "
                         "step")
    ap.add_argument("--pp-stages", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    results = []
    if args.inner == "pp":
        results.append(pp_inner_smoke(args.arch, n_stages=args.pp_stages))
    elif args.all:
        for arch in matrix_archs():
            for shape in base.SHAPES:
                for mp in (False, True):
                    results.append(lower_one(
                        arch, shape, multi_pod=mp, rank=args.rank,
                        include_outer=(shape == "train_4k"
                                       and not args.no_outer)))
    else:
        results.append(lower_one(args.arch, args.shape,
                                 multi_pod=args.multi_pod, rank=args.rank,
                                 include_outer=not args.no_outer,
                                 mode=args.mode))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(summary_line(results))
    if any(r["status"] == "fail" for r in results):
        sys.exit(1)


if __name__ == "__main__":
    main()
