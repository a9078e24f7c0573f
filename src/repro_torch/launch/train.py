"""End-to-end DiLoCoX training driver on ``torch.distributed`` (port of the
gspmd path of ``repro.launch.train``).

    for outer step t:  H x train_step (per cluster)
                       outer_step     (compress -> gather -> Nesterov,
                                       one-step-delay semantics)
                       AdaGradCmp     (Alg. 3 host-side controller)

``--devices`` = clusters x data x model processes, one card each (one CPU
process each with ``--device cpu``), laid out as a ("clusters", "data",
"model") ``DeviceMesh``. Rank (c, j, m) holds block (j, m) of every leaf
of cluster c's round state, placed by ``parallel/sharding.py`` (FSDP over
"data", tensor parallelism over "model"), and trains on the j-th slice
of the cluster's batch, the cluster's data and model shards computing
each step together (``parallel/tensor.py``); the clusters group meets
once per round, in the outer step's all-gather of the packed int4
payload. NCCL on the card, gloo on the CPU, rendezvous through a
``FileStore`` in a temporary directory. ``--devices 1`` runs in this
process (still through a process group of size 1); more devices spawn
one process per rank. ``run`` called with no groups runs every cluster
and every shard in this process, bit for bit the ranks (``--cpu-threads
1`` on the CPU).

Usage (2 CPU processes, one cluster each; 4 processes, one cluster in
2 x 2 shards; the JAX driver's documented 8):
  python -m repro_torch.launch.train --arch granite-3-8b --smoke \\
      --device cpu --devices 2 --clusters 2 --data 1 --model 1 \\
      --rounds 2 --h-steps 2
  python -m repro_torch.launch.train --smoke --device cpu --devices 4 \\
      --clusters 1 --data 2 --model 2
  python -m repro_torch.launch.train --smoke --device cpu --devices 8 \\
      --clusters 2 --data 2 --model 2

``--ckpt-dir`` writes the one-device layout (cluster-stacked whole leaves,
``{"params", "outer"}``; ``{"params"}`` under ``--inner pp``) from rank 0,
each leaf gathered from the ranks as it is written.

``--inner pp`` switches the inner loop to the pipeline-parallel engine
(``parallel/inner_engine.py``, ``run_pp``): the mesh becomes (clusters,
data, ``--pp-stages``), ``--devices`` = clusters x data x pp-stages, and
rank (c, j, s) holds stage s of cluster c's model (its rows of the
params, AdamW moments, Nesterov momentum and EF residual; embed, final
norm and head on every stage) and trains on the j-th slice of the
cluster's batch:
  python -m repro_torch.launch.train --arch granite-3-8b --smoke \\
      --inner pp --device cpu --devices 4 --clusters 2 --data 1 \\
      --pp-stages 2

Parameters come from a ``torch.Generator`` seeded 0 and batches from the
port's ``SyntheticLM`` streams, so a run of this driver and one of the
JAX driver see different numbers; the tests carry JAX's over.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="keep the config's width but cut its depth to this "
                         "many layers (0: the config's own)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default="float32", choices=["float32",
                                                           "bfloat16"],
                    help="param_dtype and compute_dtype of the model "
                         "(bfloat16: the JAX dry-run's production dtypes)")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--h-steps", type=int, default=10)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--inner-lr", type=float, default=1e-3)
    ap.add_argument("--outer-lr", type=float, default=0.5)
    ap.add_argument("--outer-momentum", type=float, default=0.7)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--h-policy", default="global",
                    choices=["global", "balance"],
                    help="per-cluster local-step scheduling: balance gives "
                         "each cluster its own H from --step-times so slow "
                         "sites do fewer local steps per round")
    ap.add_argument("--step-times", default="",
                    help="comma-separated per-cluster step seconds "
                         "(measured on the real sites) for --h-policy "
                         "balance; default: uniform (== global)")
    ap.add_argument("--h-min", type=int, default=1)
    ap.add_argument("--inner", default="gspmd", choices=["gspmd", "pp"],
                    help="inner engine: gspmd = the per-cluster step "
                         "(launch/steps.py); pp = the pipeline-parallel "
                         "engine (parallel/inner_engine.py), --pp-stages "
                         "stages a cluster, one per rank")
    ap.add_argument("--pp-stages", type=int, default=2)
    ap.add_argument("--pp-micro", type=int, default=4)
    ap.add_argument("--flash", action="store_true",
                    help="plain causal attention through the flash kernels "
                         "(f32 or bf16; S a multiple of 128)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--trace", default="",
                    help="write a wall-clock Chrome-trace JSON of the "
                         "driver's round/inner/outer spans here")
    ap.add_argument("--log-json", action="store_true",
                    help="mirror log lines as JSON objects on stderr")
    ap.add_argument("--cpu-threads", type=int, default=0,
                    help="torch.set_num_threads in every rank (0: the "
                         "host's cores split over the CPU ranks; torch's "
                         "default in one process)")
    ap.add_argument("--state-out", default="",
                    help="write each rank's rows of the round state (params, "
                         "inner and outer state) here after every round, "
                         "as round_RRRR.rankK.npz")
    ap.add_argument("--join-timeout", type=float, default=3600.0,
                    help="seconds to wait for the spawned ranks")
    return ap.parse_args(argv)


def _check_args(args) -> None:
    """The refusals and the JAX driver's checks, before any process
    starts. ``--inner pp`` ignores ``--model`` (default 2), as the JAX
    driver does, so its checks come first."""
    C = args.clusters
    if args.inner == "pp":
        if args.adaptive or args.h_policy != "global":
            raise SystemExit("--inner pp supports the static round schedule "
                             "only (no --adaptive / --h-policy balance yet)")
        assert C * args.data * args.pp_stages == args.devices, (
            "--devices must equal clusters * data * pp-stages")
        Bc = args.global_batch // C
        assert Bc % args.pp_micro == 0, (
            "per-cluster batch (global-batch/clusters) must divide --pp-micro")
        if args.global_batch % C or Bc % args.data or \
                (Bc // args.data) % args.pp_micro:
            raise ValueError(f"--global-batch {args.global_batch} must split "
                             f"into {C} clusters x {args.data} data ranks x "
                             f"{args.pp_micro} microbatches")
        return
    assert C * args.data * args.model == args.devices, (
        "--devices must equal clusters * data * model")
    from repro_torch.parallel.tensor import check_tp
    check_tp(_model_config(args), args.model)
    if args.global_batch % C or (args.global_batch // C) % args.data:
        raise ValueError(f"--global-batch {args.global_batch} must split "
                         f"into {C} clusters x {args.data} data ranks")


def _setup_obs(args, rank: int):
    """Logger (stdout, byte-stable lines, rank 0's info lines only) +
    optional wall-clock tracer. Returns ``(log, tracer, span)``."""
    from repro_torch.obs import Tracer, configure_logging, get_logger

    if rank == 0:
        configure_logging(stream=sys.stdout,
                          json_stream=(sys.stderr if args.log_json else None),
                          level="info")
    else:                       # the other ranks report warnings only
        configure_logging(stream=None, json_stream=None, level="warning")
    log = get_logger("launch.train")
    tracer = Tracer("train-driver") if args.trace and rank == 0 else None
    if tracer is not None:
        span = tracer.span
    else:
        def span(name, **kw):
            return contextlib.nullcontext()
    return log, tracer, span


def run(args, device, *, clusters, cluster_group=None, shards=None,
        rank: int = 0, on_round=None):
    """The gspmd round loop for this rank's ``clusters`` (cluster indices;
    all of them with no ``cluster_group``: the in-process stacked run).
    ``shards``: this rank's shard of a ``parallel.tensor.ShardGroup`` of
    the cluster's ``--data`` x ``--model`` ranks; with none, every shard
    of each cluster runs in this process (whole tensors, whose blocks are
    views). Returns a summary dict (per round: mean loss, executed H,
    rank, wire bytes, the bytes this rank's clusters handed to the
    all-gather, summed over their shards, synchronized round/inner/outer
    seconds; every rank's peak device memory).
    ``on_round(r, params, opt, outer_state)`` sees the state after each
    round (this rank's blocks). ``--inner pp`` runs ``run_pp`` with every
    stage in this process."""
    if args.inner == "pp":
        return run_pp(args, device, clusters=clusters,
                      cluster_group=cluster_group, rank=rank,
                      on_round=on_round)
    import numpy as np
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.core import adaptive
    from repro_torch.core import mesh_compression as mc
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.steps import all_reduce_sum
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel import tensor as TP
    from repro_torch import tree as T

    cfg = _model_config(args)
    C = args.clusters
    CL = len(clusters)
    if shards is None and args.data * args.model > 1:
        shards = TP.ShardGroup(args.data, args.model)
    ranked = shards is not None and not shards.in_process
    meta = M.init_params(cfg, device="meta")
    specs = sh.param_placements(meta, {"data": args.data,
                                       "model": args.model},
                                cluster_stacked=False)

    # the whole model drawn on every rank (generator seeded 0), then this
    # rank's blocks kept
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params1 = M.init_params(cfg, gen, device)
    ccfg = mc.MeshCompressionConfig(rank=args.rank)
    q0 = None
    if ranked:
        j, m = shards.shards[0]
        q0 = mc.init_q_state(params1, ccfg)
        params1 = sh.shard_tree(params1, specs, shards.mesh,
                                {"data": j, "model": m})
    # the anchor is params1 itself, updated in place by the outer step
    params, opt, outer_state = steps.init_round_state(params1, CL, ccfg,
                                                      q0=q0)

    balance_h = args.h_policy == "balance"
    step_times = ([float(s) for s in args.step_times.split(",")]
                  if args.step_times else [1.0] * C)
    assert len(step_times) == C, "--step-times needs one entry per cluster"

    def plan_round_h(h_budget):
        h_map = adaptive.plan_h(
            adaptive.HSpec(policy="balance", h_min=args.h_min),
            h_budget, np.asarray(step_times), np.ones(C, bool))
        return [h_map[c] for c in range(C)]

    # uniform-at-budget rounds run the plain train step; only genuinely
    # heterogeneous rounds use the masked variant (the JAX driver's rule)
    train_step = steps.make_train_step(cfg, inner_lr=args.inner_lr,
                                       shards=shards,
                                       cluster_group=cluster_group,
                                       flash=args.flash)
    train_step_h = (steps.make_train_step(
        cfg, inner_lr=args.inner_lr, per_cluster_h=True,
        shards=shards, cluster_group=cluster_group, flash=args.flash)
        if balance_h else None)
    outer_step = steps.make_outer_step(
        cfg, ccfg, outer_lr=args.outer_lr,
        outer_momentum=args.outer_momentum, cluster_group=cluster_group,
        shards=shards)

    # in process the step takes each cluster's whole batch and splits it
    # over the data shards; a rank takes its own slice
    Bc = args.global_batch // C
    n_data, data_rank = ((args.data, shards.shards[0][0]) if ranked
                         else (1, 0))
    rows = slice(data_rank * Bc // n_data, (data_rank + 1) * Bc // n_data)
    data = [SyntheticLM(cfg.vocab_size, args.seq_len, Bc, seed=0,
                        data_shard=c) for c in clusters]
    ada_cfg = adaptive.AdaGradCmpConfig(r1=args.rank, h1=args.h_steps,
                                        mode="overlap")
    ada = adaptive.AdaGradCmpState.create(ada_cfg)

    def cluster_mean(stacked):
        """f32 mean over all clusters of a cluster-stacked tree, each leaf
        whole: a sum across the clusters group (the JAX driver's
        ``x.mean(0)`` under GSPMD), the blocks gathered on every rank."""
        return T.unflatten_like(stacked, [
            (shards.gather_whole if ranked else lambda x, _: x)(
                all_reduce_sum(x.float().sum(0), cluster_group) / C,
                specs[k]) for k, x in T.keystr_items(stacked)])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def state_spec(key):
        """The placement of a checkpoint leaf, by keystr."""
        for pre, lead in (("['params']", ("clusters",)),
                          ("['outer']['anchor']", ()),
                          ("['outer']['outer_opt'].momentum", ()),
                          ("['outer']['delta_pending']", ("clusters",)),
                          ("['outer']['error']", ("clusters",))):
            if key.startswith(pre):
                return lead + specs[key[len(pre):]]
        return ("clusters",) if "['q_state']" in key else ()

    log, tracer, span = _setup_obs(args, rank)
    summary = {k: [] for k in ("mean_loss", "h", "rank", "wire_bytes",
                               "gather_bytes", "round_s", "inner_s",
                               "outer_s")}
    h_vec_static = plan_round_h(args.h_steps) if balance_h else None
    for r in range(args.rounds):
        # pre-observe controller state = what this round executes
        h_t = ada.h_t if args.adaptive else args.h_steps
        r_exec = ada.r_t
        if balance_h:
            h_vec = plan_round_h(h_t) if args.adaptive else h_vec_static
        else:
            h_vec = [h_t] * C
        het_round = any(hc != h_t for hc in h_vec)
        losses = []
        sync()
        t0 = time.perf_counter()
        with span("round", round=r):
            with span("inner", round=r):
                for h in range(max(h_vec)):
                    toks = torch.stack([d.next_batch()["tokens"][rows]
                                        for d in data]).to(device)
                    batch = {"tokens": toks}
                    if het_round:
                        active = [h < h_vec[c] for c in clusters]
                        params, opt, loss = train_step_h(params, opt, batch,
                                                         active)
                    else:
                        params, opt, loss = train_step(params, opt, batch)
                    losses.append(float(loss))
                sync()
            t1 = time.perf_counter()
            with span("outer", round=r):
                params, outer_state = outer_step(params, outer_state, r_exec)
                sync()
        t2 = time.perf_counter()
        wire = mc.wire_bytes_tree(meta, ccfg,
                                  rank=r_exec if args.adaptive else None)
        h_str = (f"H={h_t}" if not het_round
                 else "H=" + "/".join(str(hc) for hc in h_vec))
        log.info(f"round {r}: mean_loss={np.mean(losses):.4f} "
                 f"{h_str} r={r_exec} wire_per_cluster={wire/1e6:.2f}MB",
                 round=r, mean_loss=float(np.mean(losses)), h=h_vec,
                 rank=int(r_exec), wire_bytes=wire,
                 gather_bytes=outer_step.gather_bytes)
        for key, val in (("mean_loss", float(np.mean(losses))),
                         ("h", list(h_vec)), ("rank", int(r_exec)),
                         ("wire_bytes", wire),
                         ("gather_bytes", outer_step.gather_bytes),
                         ("round_s", t2 - t0), ("inner_s", t1 - t0),
                         ("outer_s", t2 - t1)):
            summary[key].append(val)
        if args.adaptive:
            ada = adaptive.observe_mean_pseudo_grad(
                ada, cluster_mean(outer_state.delta_pending), ada_cfg)
        if args.ckpt_dir:
            _save(os.path.join(args.ckpt_dir, f"round_{r:04d}"),
                  {"params": params, "outer": outer_state._asdict()},
                  state_spec, args, rank, step=r, meta={"arch": args.arch})
        if args.state_out:
            ckpt_lib.save(os.path.join(args.state_out,
                                       f"round_{r:04d}.rank{rank}"),
                          {"params": params, "opt": opt,
                           "outer": outer_state._asdict()},
                          step=r, meta={"clusters": list(clusters),
                                        "shard": list(shards.shards[0])
                                        if ranked else [0, 0]})
        if on_round is not None:
            on_round(r, params, opt, outer_state)
    summary["peak_bytes"] = _peak_bytes(device)
    log.info("TRAIN-DRIVER-OK")
    if tracer is not None:
        tracer.write(args.trace)
        log.info(f"wrote {args.trace}")
    return summary


def _model_config(args):
    from repro_torch.configs.base import get_config, with_dtype

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return with_dtype(cfg, args.dtype)


def run_pp(args, device, *, clusters, data_rank: int = 0, stage=None,
           cluster_group=None, data_group=None, model_group=None,
           rank: int = 0, on_round=None):
    """The ``--inner pp`` round loop (the JAX driver's ``_run_pp``) for
    this rank's ``clusters`` on its ``data_rank``-th slice of each
    cluster's batch: every stage in this process with no ``model_group``
    (of more than one rank), else stage ``stage`` of each.

    Each round: H pipelined AdamW steps (``inner_engine.
    make_pp_train_step``; the stages' replicated leaves' gradients summed
    over the model group, the data group's averaged), then the delayed
    outer round of ``core.diloco.diloco_round``, leaf by leaf and in
    place: the ``LowRankQuant`` roundtrip of last round's δ (the whole
    leaf, as the JAX driver compresses the gathered pseudo-gradient, once
    per leaf on its owner stage, ``StageGroup.on_owner``: leaf j on stage
    j mod n_stages, which gathers a stage-split leaf, compresses it and
    scatters the reconstruction's rows), the f32 mean over clusters (a
    sum over the clusters group, then / C), EF against the applied mean,
    the new δ = (anchor − θ) + e with ``active``'s pinned to zero
    (``inner_engine.delta_leaf``), Nesterov on the anchor, and every
    cluster's params restarting from it.

    The state is ``launch.steps.OuterState``'s layout: cluster-stacked
    params, AdamW state, pending deltas, EF buffers and warm starts, the
    anchor and its Nesterov momentum unstacked; stage-split leaves hold
    this rank's stage rows (warm starts are per whole leaf). Returns the
    summary of ``run``, with ``allreduce_bytes`` (the f32 bytes this rank
    hands to the clusters group per round) in place of the gathered
    bytes, and ``peak_bytes`` (each rank's peak device memory, on the
    card). The warm starts stay current on every stage (the owner
    broadcasts them), so every rank's state is the in-process run's
    rows."""
    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.core import diloco
    from repro_torch.core.compression import make_compressor, tree_shapes
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.steps import all_reduce_sum
    from repro_torch.optim import nesterov
    from repro_torch.parallel import comm
    from repro_torch.parallel import inner_engine as IE
    from repro_torch.parallel import pipeline as PP

    cfg = _model_config(args)
    C, CL = args.clusters, len(clusters)
    pcfg = PP.PipelineConfig(n_stages=args.pp_stages, n_micro=args.pp_micro)
    if comm.size(model_group) > 1:
        transport = PP.StageGroup(model_group, stage, args.pp_stages)
    else:
        transport = PP.InProcess(args.pp_stages)
    lo, hi = transport.stages[0], transport.stages[-1] + 1

    # the whole model drawn on every rank (generator seeded 0), then this
    # rank's stage rows kept
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    full = PP.init_pp_params(cfg, gen, pcfg, device)
    # the JAX driver's make_compressor("diloco_x"): the fused kernels
    compressor = make_compressor("diloco_x", rank=args.rank,
                                 backend="pallas")
    q1 = compressor.init_state(full)
    wire = compressor.wire_bytes(tree_shapes(full))
    params1 = T.tree_map(lambda x: x.clone(),
                         PP.stage_slice(full, lo, hi))
    del full
    params = diloco.stack_replicas(params1, CL)
    opt = steps.init_inner_state(params)
    zeros = lambda: T.tree_map(
        lambda x: torch.zeros_like(x, dtype=torch.float32), params)
    outer = steps.OuterState(
        anchor=params1, outer_opt=nesterov.init(params1),
        delta_pending=zeros(), error=zeros(),
        q_state=T.tree_map(lambda q: diloco.stack_replicas(q, CL), q1))
    allreduce_bytes = 4 * sum(x.numel() for x in T.leaves(params1))
    pp_specs = PP.pp_param_specs(params, cluster_stacked=True)

    train_step = IE.make_pp_train_step(
        cfg, pcfg, inner_lr=args.inner_lr, flash=args.flash,
        transport=transport, data_group=data_group, cluster_stacked=True)

    @torch.no_grad()
    def outer_round(params, st, rank_r):
        for j, ((path, p), a, v, d, e, q) in enumerate(zip(
                T.keystr_items(params), T.leaves(st.anchor),
                T.leaves(st.outer_opt.momentum), T.leaves(st.delta_pending),
                T.leaves(st.error), T.leaves(st.q_state))):
            # comm leg: compress LAST round's pseudo-grads (one-step delay),
            # the whole leaf once, on its owner stage
            hat_sum = None
            for c in range(CL):
                def roundtrip(whole, c=c):
                    (hat,), (q_new,) = compressor.roundtrip([whole], [q[c]],
                                                            rank_r)
                    q[c].copy_(q_new)
                    return hat
                hat = transport.on_owner(j, d[c], PP.is_stage_path(path),
                                         roundtrip, shared=(q[c],))
                hat_sum = hat if hat_sum is None else hat_sum + hat
            Delta = all_reduce_sum(hat_sum, cluster_group) / C
            del hat_sum
            # Alg. 2 error feedback: e = delta - Delta (the applied mean)
            torch.sub(d, Delta[None], out=e)
            # next round's pending delta
            IE.delta_leaf(path, a[None], p, e, out=d)
            # delayed outer Nesterov on the anchor; replicas restart there
            nesterov.update_leaf(Delta, v, a, lr=args.outer_lr,
                                 momentum=args.outer_momentum)
            p.copy_(a[None].expand_as(p))
        return params, st._replace(outer_opt=nesterov.NesterovState(
            step=st.outer_opt.step + 1, momentum=st.outer_opt.momentum))

    Bc = args.global_batch // C
    n_data = comm.size(data_group)
    rows = slice(data_rank * Bc // n_data, (data_rank + 1) * Bc // n_data)
    data = [SyntheticLM(cfg.vocab_size, args.seq_len, Bc, seed=0,
                        data_shard=c) for c in clusters]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    log, tracer, span = _setup_obs(args, rank)
    summary = {k: [] for k in ("mean_loss", "h", "rank", "wire_bytes",
                               "allreduce_bytes", "round_s", "inner_s",
                               "outer_s")}
    for r in range(args.rounds):
        losses = []
        sync()
        t0 = time.perf_counter()
        with span("round", round=r):
            with span("inner", round=r):
                for h in range(args.h_steps):
                    toks = torch.stack([d.next_batch()["tokens"][rows]
                                        for d in data]).to(device)
                    params, opt, loss = train_step(params, opt, toks)
                    loss = all_reduce_sum(loss.detach().float(),
                                          cluster_group)
                    losses.append(float(loss) / C)
                sync()
            t1 = time.perf_counter()
            with span("outer", round=r):
                params, outer = outer_round(params, outer, args.rank)
                sync()
        t2 = time.perf_counter()
        log.info(f"round {r}: mean_loss={np.mean(losses):.4f} "
                 f"H={args.h_steps} r={args.rank} "
                 f"wire_per_cluster={wire/1e6:.2f}MB",
                 round=r, mean_loss=float(np.mean(losses)), h=args.h_steps,
                 rank=args.rank, wire_bytes=wire,
                 allreduce_bytes=allreduce_bytes)
        for key, val in (("mean_loss", float(np.mean(losses))),
                         ("h", [args.h_steps] * C), ("rank", args.rank),
                         ("wire_bytes", wire),
                         ("allreduce_bytes", allreduce_bytes),
                         ("round_s", t2 - t0), ("inner_s", t1 - t0),
                         ("outer_s", t2 - t1)):
            summary[key].append(val)
        if args.ckpt_dir:
            _save(os.path.join(args.ckpt_dir, f"round_{r:04d}"),
                  {"params": params},
                  lambda key: pp_specs[key[len("['params']"):]],
                  args, rank, step=r, meta={"arch": args.arch,
                                            "inner": "pp"})
        if args.state_out:
            ckpt_lib.save(os.path.join(args.state_out,
                                       f"round_{r:04d}.rank{rank}"),
                          {"params": params, "opt": opt,
                           "outer": outer._asdict()},
                          step=r, meta={"clusters": list(clusters),
                                        "data_rank": data_rank,
                                        "stages": [lo, hi]})
        if on_round is not None:
            on_round(r, params, opt, outer)
    summary["peak_bytes"] = _peak_bytes(device)
    log.info("TRAIN-DRIVER-OK")
    if tracer is not None:
        tracer.write(args.trace)
        log.info(f"wrote {args.trace}")
    return summary


def _save(path, tree, spec_of, args, rank: int, *, step: int, meta):
    """The checkpoint of a run's state: the whole tree as this process
    holds it, or across ranks rank 0 writing each leaf (cluster-stacked,
    whole) as it gathers the ranks' blocks, placed on the ("clusters",
    "data", "model") mesh by ``spec_of(keystr)``. Every rank calls it."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.parallel import sharding as sh

    if not dist.is_initialized() or dist.get_world_size() == 1:
        ckpt_lib.save(path, tree, step=step, meta=meta)
        return
    world = dist.get_world_size()
    model = args.pp_stages if args.inner == "pp" else args.model
    mesh = {"clusters": args.clusters, "data": args.data, "model": model}
    coords = [{"clusters": r // (args.data * model),
               "data": r // model % args.data, "model": r % model}
              for r in range(world)]

    def items():
        for key, x in T.keystr_items(tree):
            spec = spec_of(key)
            if not any(spec):           # the same on every rank
                yield key, ckpt_lib._to_numpy(x)
                continue
            x = x.contiguous()
            got = ([torch.empty_like(x) for _ in range(world)] if rank == 0
                   else None)
            dist.gather(x, got, dst=0)
            yield key, (sh.unshard_leaf(
                [(c, ckpt_lib._to_numpy(b)) for c, b in zip(coords, got)],
                spec, mesh) if rank == 0 else None)
            del got

    if rank == 0:
        ckpt_lib.save_items(path, items(), step=step, meta=meta)
    else:
        for _ in items():
            pass


def _peak_bytes(device):
    """Every rank's peak device memory (bytes, in rank order; empty on the
    CPU)."""
    import torch
    import torch.distributed as dist

    if device.type != "cuda":
        return []
    peak = torch.tensor([torch.cuda.max_memory_allocated(device)],
                        dtype=torch.int64, device=device)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [int(peak)]
    got = [torch.empty_like(peak) for _ in range(dist.get_world_size())]
    dist.all_gather(got, peak)
    return [int(x) for x in got]


def _worker(rank: int, args, store_path: str, on_round=None,
            summary_path: str = ""):
    """One rank: joins the process group, builds the mesh, runs its
    cluster, and leaves the group."""
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_cluster_mesh

    device = resolve_device(args.device)
    threads = args.cpu_threads
    if not threads and device.type == "cpu" and args.devices > 1:
        threads = max(1, (os.cpu_count() or 1) // args.devices)
    if threads:
        torch.set_num_threads(threads)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.FileStore(store_path, args.devices),
                            rank=rank, world_size=args.devices)
    try:
        pp = args.inner == "pp"
        mesh = make_cluster_mesh(args.clusters, args.data,
                                 args.pp_stages if pp else args.model,
                                 device_type=device.type)
        c, j, s = mesh.get_coordinate()
        if pp:
            summary = run_pp(args, device, clusters=[c], data_rank=j,
                             stage=s, model_group=mesh.get_group("model"),
                             cluster_group=mesh.get_group("clusters"),
                             data_group=mesh.get_group("data"), rank=rank,
                             on_round=on_round)
        else:
            summary = run(args, device, clusters=[c],
                          cluster_group=mesh.get_group("clusters"),
                          shards=_shard_group(args, mesh, c, j, s),
                          rank=rank, on_round=on_round)
    finally:
        dist.destroy_process_group()
    if summary_path and rank == 0:
        with open(summary_path, "w") as f:
            json.dump(summary, f)
    return summary


def _shard_group(args, mesh, c: int, j: int, m: int):
    """Rank (c, j, m)'s shard of its cluster's ``ShardGroup`` (None for one
    shard a cluster). Every rank makes every cluster's group, in order."""
    import torch.distributed as dist

    from repro_torch.parallel.tensor import ShardGroup

    D, M = args.data, args.model
    if D * M == 1:
        return None
    groups = [dist.new_group(list(range(cc * D * M, (cc + 1) * D * M)))
              for cc in range(args.clusters)]
    return ShardGroup(D, M, data_group=mesh.get_group("data"),
                      model_group=mesh.get_group("model"), group=groups[c],
                      coords=(j, m))


def _spawn(args, store_path: str, summary_path: str, worker=None) -> None:
    """One process per rank (spawn start method) running ``worker(rank,
    args, store_path, summary_path=summary_path)`` (default: this
    driver's);
    waits at most ``--join-timeout`` seconds, stops every rank if one
    fails or time runs out, and raises naming the ranks that did not
    finish."""
    import multiprocessing.connection as mpc

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker or _worker,
                         args=(rank, args, store_path),
                         kwargs={"summary_path": summary_path})
             for rank in range(args.devices)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + args.join_timeout
    try:
        while any(p.is_alive() for p in procs):
            left = deadline - time.monotonic()
            if left <= 0 or any(p.exitcode not in (None, 0) for p in procs):
                break
            mpc.wait([p.sentinel for p in procs if p.is_alive()],
                     timeout=min(left, 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    bad = {rank: p.exitcode for rank, p in enumerate(procs) if p.exitcode}
    if bad:
        raise RuntimeError(f"ranks failed or timed out after "
                           f"{args.join_timeout} s: exit codes {bad}")


def main(argv=None, *, on_round=None, store_dir=None):
    """Runs the driver; returns rank 0's summary (see ``run``).
    ``on_round`` (in-process runs only) sees the state after each round;
    the process group's rendezvous file lives in a new temporary
    directory under ``store_dir`` (default: the system's), removed
    afterwards."""
    args = _parse_args(argv)
    _check_args(args)

    import torch

    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda" and args.devices > torch.cuda.device_count():
        raise RuntimeError(f"--devices {args.devices} needs one card per "
                           f"rank; {torch.cuda.device_count()} visible")
    if on_round is not None and args.devices > 1:
        raise ValueError("on_round sees in-process runs only (--devices 1); "
                         "use --state-out across processes")
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_", dir=store_dir)
    store_path = os.path.join(tmp, "store")
    try:
        if args.devices == 1:
            return _worker(0, args, store_path, on_round)
        summary_path = os.path.join(tmp, "summary.json")
        _spawn(args, store_path, summary_path)
        with open(summary_path) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
