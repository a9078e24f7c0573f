"""Serving driver of the port: the dense greedy loop (``--dense``, the
default) or the paged continuous-batching engine (``--paged``), loading
DiLoCoX-trainer checkpoints of the JAX package through the weight bridge.

  python -m repro_torch.launch.serve --arch opt-1.3b --paged \
      --batch 8 --requests 12 --prompt-len 128 --gen-len 64 --page-size 16

Runs on CUDA unless ``--device cpu`` is given; with no GPU it raises.
Throughput is reported per phase: prefill tok/s (prompt tokens absorbed
into the cache) and decode tok/s (tokens generated). EOS handling:
generation stops early once every sequence has emitted ``cfg.eos_id``
(override with ``--eos``, disable with ``--eos -1``), and post-EOS
positions are masked to the EOS id in the sample output.

Across cards: ``--devices`` = ``--data`` x ``--model`` ranks, one card
each (one CPU process each with ``--device cpu``), laid out as a ("data",
"model") ``DeviceMesh`` (``launch/mesh.py::make_serving_mesh``), NCCL on
the card, gloo on the CPU, rendezvous through a ``FileStore`` in a
temporary directory. Rank (j, m) keeps model shard m's blocks of the
weights (``parallel/tensor.py::serve_index``: "model" only, no FSDP dim)
and of the KV cache (its query heads' KV heads), and decodes data block j
of the batch or of the engine's slots (``parallel/tensor.py::TPDecode``);
rank 0 prints. The defaults are 1 / 1 / 1, one card in this process,
where the JAX driver's are 4 / 2 / 2 (emulated CPU devices). ``run``
called with no shards runs every shard in this process, bit for bit the
ranks (``--cpu-threads 1`` on the CPU):

  python -m repro_torch.launch.serve --arch gemma3-1b --smoke --paged \
      --device cpu --devices 4 --data 2 --model 2

Parameters are drawn unit by unit (``models.model.draw_params``, seed 0)
and prompts from a ``torch.Generator`` seeded 1, so every layout draws
the same weights, and a run of this driver and one of the JAX driver
give different tokens; only the tests, with carried weights and numpy
prompts, compare the two.
"""
import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="keep the config's width but cut its depth to this "
                         "many layers (0: the config's own)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default="float32", choices=["float32",
                                                           "bfloat16"],
                    help="param_dtype and compute_dtype of the model, and "
                         "so of the KV cache (bfloat16: the JAX dry-run's "
                         "production dtypes)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks, one card each: --data x --model")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--ckpt", default="",
                    help="checkpoint path (or dir: latest) written by the "
                         "JAX trainer (repro.launch.train --ckpt-dir); both "
                         "the unstacked and cluster-stacked layouts load")
    ap.add_argument("--eos", type=int, default=None,
                    help="EOS token id (default: cfg.eos_id; -1 disables)")
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--paged", action="store_true",
                   help="serve on the paged continuous-batching engine")
    g.add_argument("--dense", action="store_true",
                   help="fixed-batch dense loop (the default)")
    ap.add_argument("--requests", type=int, default=0,
                    help="paged: number of requests (default: --batch)")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="paged: physical page pool size (default: "
                         "batch * pages-per-seq, i.e. dense-equivalent)")
    ap.add_argument("--policy", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace of the serve phases here")
    ap.add_argument("--metrics-out", default="",
                    help="write repro_serve_* metrics (Prometheus text)")
    ap.add_argument("--log-json", action="store_true")
    ap.add_argument("--cpu-threads", type=int, default=0,
                    help="torch.set_num_threads in every rank (0: the "
                         "host's cores split over the CPU ranks)")
    ap.add_argument("--join-timeout", type=float, default=3600.0,
                    help="seconds to wait for the spawned ranks")
    ap.add_argument("--digests-out", default="",
                    help="sharded runs: write each process's digests of its "
                         "head outputs (tree.bit_digest, per data block and "
                         "step) and its tokens here, as rankK.json")
    return ap.parse_args(argv)


def _model_config(args):
    import dataclasses

    from repro_torch.configs.base import get_config, with_dtype

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return with_dtype(cfg, args.dtype)


def _check_args(args) -> None:
    if args.data * args.model != args.devices:
        raise ValueError(f"--devices {args.devices} must equal --data "
                         f"{args.data} x --model {args.model}")
    from repro_torch.parallel.tensor import check_tp
    check_tp(_model_config(args), args.model)


def _ckpt_file(path):
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    if os.path.isdir(path):
        found = ckpt_lib.latest(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoints under {path!r}")
        path = found
    with open(path + ".json") as f:
        return path, json.load(f)["step"]


class _Leaves:
    """A checkpoint's ``['params']`` arrays by keystr, each read from the
    archive when asked for."""

    def __init__(self, data, prefix="['params']"):
        self.data, self.prefix = data, prefix

    def __getitem__(self, key):
        return self.data[self.prefix + key]


def _check_fits(cfg, n_model, local, device):
    """Raises, with the bytes, where this process's weight blocks would not
    fit its card."""
    import math

    import torch

    from repro_torch import tree as T
    from repro_torch.models import model as M
    from repro_torch.parallel.tensor import serve_index

    if device.type != "cuda":
        return
    need = 0
    for m in local:
        index_of = serve_index(cfg, n_model, m)
        for key, x in T.keystr_items(M.init_params(cfg, device="meta")):
            blk = x[index_of(key, tuple(x.shape))]
            need += math.prod(blk.shape) * x.element_size()
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise RuntimeError(
            f"{cfg.name}: model shards {list(local)} of {n_model} hold "
            f"{need} B of weights, more than the card's {have} B; raise "
            f"--model")


def _load_params(path, cfg, device, log, index_of=None):
    """Restore the ``{"params": ...}`` tree saved by the JAX trainer, the
    pp layout (unstacked) or the GSPMD one (cluster-stacked: every row is
    identical after a round, row 0 is taken), leaf by leaf, each leaf cut
    to ``index_of`` (``parallel.tensor.serve_index``; default: whole)
    before it reaches ``device``."""
    import numpy as np

    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.tensor import serve_index

    path, step = _ckpt_file(path)
    with np.load(path + ".npz") as data:
        params = sh.serve_blocks(_Leaves(data),
                                 index_of or serve_index(cfg, 1, 0),
                                 M.init_params(cfg, device="meta"), device,
                                 allow_stacked=True)
    log.info(f"restored params from {path} (round {step})")
    return params


def _load(args, cfg, shards, device, log):
    """The weights: one tree, or with ``shards`` one per local model shard
    (``parallel.tensor.serve_index``'s blocks), drawn (seed 0) or read
    from ``--ckpt``, each leaf cut before it reaches the card."""
    from repro_torch.models import model as M
    from repro_torch.parallel.tensor import serve_index

    n_model, local = (shards.M, shards.model.local) if shards else (1, [0])
    _check_fits(cfg, n_model, local, device)
    blocks = [_load_params(args.ckpt, cfg, device, log, ix) if args.ckpt
              else M.draw_params(cfg, 0, device, ix)
              for ix in (serve_index(cfg, n_model, m) for m in local)]
    return blocks if shards else blocks[0]


def _load_2d(args, cfg, shards, device, log):
    """The weights in the training placement: ``{keystr: [[block]]}``,
    the whole tree's blocks in process, this rank's block otherwise."""
    from repro_torch import tree as T
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as sh

    whole = (_load_params(args.ckpt, cfg, device, log) if args.ckpt
             else M.draw_params(cfg, 0, device))
    specs = sh.param_placements(whole, shards.mesh, cluster_stacked=False)
    if shards.in_process:
        return {k: shards.parts(x, specs[k])
                for k, x in T.keystr_items(whole)}
    j, m = shards.shards[0]
    blocks = sh.shard_tree(whole, specs, shards.mesh,
                           {"data": j, "model": m})
    return {k: [[x]] for k, x in T.keystr_items(blocks)}


def _digests(record):
    """A ``TPDecode.on_logits`` hook appending ``[rows, model index,
    bit_digest, finite]`` to ``record`` for each data block's head
    outputs, step by step."""
    import torch

    from repro_torch import tree as T

    def hook(rows, parts):
        for m, lg in parts:
            record.append([list(rows), m, T.bit_digest(lg),
                           bool(torch.isfinite(lg).all())])
    return hook


def run(args, device, *, shards=None, rank: int = 0,
        placement: str = "serve"):
    """The driver's work in this process. ``shards``: this rank's shard of
    a ``parallel.tensor.ShardGroup`` of the ``--data`` x ``--model`` ranks;
    with none, every shard runs in this process (``--data 1 --model 1``:
    the one-card model). ``placement="2d"``: the weights placed as for
    training (``TPDecode``'s 2-D form, the JAX dry-run's default decode
    layout) in place of "model" only. Returns the paged engine's stats
    dict (``--paged``) or the dense loop's summary; both hold ``tokens``,
    each request's or row's generated ids."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.obs import (MetricsRegistry, Tracer, configure_logging,
                                 get_logger)
    from repro_torch.parallel.tensor import ShardGroup

    configure_logging(stream=sys.stdout if rank == 0 else None,
                      json_stream=(sys.stderr if args.log_json and rank == 0
                                   else None),
                      level="info" if rank == 0 else "warning")
    log = get_logger("launch.serve")
    tracer = Tracer("serve-driver") if args.trace and rank == 0 else None
    if tracer is not None:
        span = tracer.span
    else:
        def span(name, **kw):
            return contextlib.nullcontext()
    metrics = MetricsRegistry() if args.metrics_out and rank == 0 else None

    cfg = _model_config(args)
    eos = cfg.eos_id if args.eos is None else (
        None if args.eos < 0 else args.eos)
    if shards is None and args.data * args.model > 1:
        shards = ShardGroup(args.data, args.model)
    record = [] if args.digests_out and shards is not None else None
    params = (_load_2d(args, cfg, shards, device, log)
              if placement == "2d" and shards is not None
              else _load(args, cfg, shards, device, log))

    prompt_gen = torch.Generator()
    prompt_gen.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size,
                           (max(args.batch, args.requests or 0),
                            args.prompt_len), generator=prompt_gen,
                           dtype=torch.int32)

    hook = _digests(record) if record is not None else None
    kw = dict(placement=placement) if shards is not None else {}
    if args.paged:
        out = _run_paged(args, cfg, params, prompt.numpy(), eos, log, span,
                         metrics, device, shards, hook, **kw)
    else:
        out = _run_dense(args, cfg, params, prompt.to(device), eos, log,
                         span, metrics, device, shards, hook, **kw)

    if record is not None:
        os.makedirs(args.digests_out, exist_ok=True)
        with open(os.path.join(args.digests_out, f"rank{rank}.json"),
                  "w") as f:
            json.dump({"digests": record, "tokens": out["tokens"]}, f)
    if tracer is not None:
        tracer.write(args.trace)
        log.info(f"wrote {args.trace}")
    if metrics is not None:
        metrics.write_prometheus(args.metrics_out)
        log.info(f"wrote {args.metrics_out}")
    return out


def _summary(out):
    """What rank 0 hands back across processes (JSON)."""
    return {k: v for k, v in out.items() if isinstance(v, (int, float, str))
            or k in ("tokens", "peak_bytes")}


def _worker(rank: int, args, store_path: str, summary_path: str = ""):
    """One rank: joins the process group, lays the ranks out as ("data",
    "model"), serves its shard and leaves the group. Only rank 0 prints."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.train import _peak_bytes
    from repro_torch.parallel.tensor import ShardGroup

    device = resolve_device(args.device)
    threads = args.cpu_threads
    if not threads and device.type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // args.devices)
    if threads:
        torch.set_num_threads(threads)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.FileStore(store_path, args.devices),
                            rank=rank, world_size=args.devices)
    quiet = open(os.devnull, "w") if rank else None
    try:
        mesh = make_serving_mesh(init_device_mesh(
            device.type, (args.data, args.model),
            mesh_dim_names=("data", "model")))
        j, m = mesh.get_coordinate()
        shards = ShardGroup(args.data, args.model,
                            data_group=mesh.get_group("data"),
                            model_group=mesh.get_group("model"),
                            group=dist.group.WORLD, coords=(j, m))
        with contextlib.redirect_stdout(quiet) if quiet \
                else contextlib.nullcontext():
            out = run(args, device, shards=shards, rank=rank)
        out["peak_bytes"] = _peak_bytes(device)
    finally:
        dist.destroy_process_group()
        if quiet:
            quiet.close()
    if summary_path and rank == 0:
        with open(summary_path, "w") as f:
            json.dump(_summary(out), f)
    return out


def main(argv=None, *, store_dir=None):
    """Runs the driver; returns the paged engine's stats dict (``--paged``)
    or the dense loop's summary (rank 0's, as JSON, across processes).
    ``--devices`` > 1 spawns one process per rank, their rendezvous file in
    a new temporary directory under ``store_dir`` (default: the
    system's), removed afterwards."""
    args = _parse_args(argv)
    _check_args(args)

    import torch

    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.devices == 1:
        return run(args, device)
    if device.type == "cuda" and args.devices > torch.cuda.device_count():
        raise RuntimeError(f"--devices {args.devices} needs one card per "
                           f"rank; {torch.cuda.device_count()} visible")
    from repro_torch.launch.train import _spawn

    tmp = tempfile.mkdtemp(prefix="repro_torch_serve_", dir=store_dir)
    try:
        summary_path = os.path.join(tmp, "summary.json")
        _spawn(args, os.path.join(tmp, "store"), summary_path, _worker)
        with open(summary_path) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_dense(args, cfg, params, prompt, eos, log, span, metrics, device,
               shards=None, on_logits=None, placement="serve"):
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel.tensor import TPDecode

    tp = None
    if shards is not None:
        tp = TPDecode(cfg, shards, placement=placement)
        tp.on_logits = on_logits

    B = args.batch
    prompt = prompt[:B]
    s_max = args.prompt_len + args.gen_len
    state = (tp.init_decode_state(B, s_max, device) if tp is not None
             else M.init_decode_state(cfg, B, s_max, device=device))
    serve_step = steps.make_serve_step(cfg, eos_id=eos, tp=tp)
    finished = torch.zeros((B,), dtype=torch.bool, device=device)

    def call(tokens):
        nonlocal state, finished
        if eos is None:
            nxt, state = serve_step(params, state, tokens)
        else:
            nxt, state, finished = serve_step(params, state, tokens,
                                              finished)
        return nxt

    _sync(device)
    t0 = time.time()
    with span("prefill", tokens=B * args.prompt_len):
        for t in range(args.prompt_len):
            nxt = call(prompt[:, t:t + 1])
            if eos is not None and t < args.prompt_len - 1:
                finished = torch.zeros_like(finished)  # prompt-forced outputs
        _sync(device)
    t1 = time.time()
    outs = [nxt]
    with span("decode"):
        for t in range(args.gen_len - 1):
            if eos is not None and bool(finished.all()):
                log.info(f"all sequences hit EOS after {t + 1} tokens")
                break
            nxt = call(nxt)
            outs.append(nxt)
        gen = torch.cat(outs, dim=1).cpu().numpy()
    t2 = time.time()

    # prefill absorbs prompt tokens; decode generates gen.shape[1] tokens
    # per row, the first of which came out of the last prefill step
    prefill_toks = B * args.prompt_len
    decode_toks = B * (gen.shape[1] - 1)
    print(f"prefill: {prefill_toks / max(t1 - t0, 1e-9):.1f} tok/s "
          f"({prefill_toks} tokens, {t1 - t0:.2f}s)")
    print(f"decode: {decode_toks / max(t2 - t1, 1e-9):.1f} tok/s "
          f"({decode_toks} tokens, {t2 - t1:.2f}s)")
    print(f"generated shape {gen.shape}; "
          f"{(prefill_toks + decode_toks) / max(t2 - t0, 1e-9):.1f} tok/s "
          f"({t2 - t0:.2f}s total) on {device.type}")
    print("sample:", gen[0][:12].tolist())
    if metrics is not None:
        metrics.counter("repro_serve_prefill_tokens").inc(prefill_toks)
        metrics.counter("repro_serve_decode_tokens").inc(decode_toks)
    print("SERVE-DRIVER-OK")
    return {"generated": gen, "tokens": gen.tolist(),
            "prefill_tokens": prefill_toks, "decode_tokens": decode_toks,
            "wall_s": t2 - t0}


def _run_paged(args, cfg, params, prompts, eos, log, span, metrics, device,
               shards=None, on_logits=None, placement="serve"):
    from repro_torch.serve.engine import ServeEngine, supports_paged

    ok, why = supports_paged(cfg)
    if not ok:
        print(f"SERVE-DRIVER-UNSUPPORTED: {args.arch}: {why}")
        sys.exit(2)

    ps = args.page_size
    max_new = args.gen_len
    max_pages = -(-(args.prompt_len + max_new) // ps)
    n_pages = args.pool_pages or args.batch * max_pages
    engine = ServeEngine(params, cfg, max_seqs=args.batch, page_size=ps,
                         n_pages=n_pages, max_pages_per_seq=max_pages,
                         eos_id=eos, policy=args.policy, metrics=metrics,
                         span=span, device=device, shards=shards,
                         placement=placement)
    if shards is not None:
        engine.tp.on_logits = on_logits
    n_req = args.requests or args.batch
    for r in range(n_req):
        engine.submit(prompts[r].tolist(), max_new, arrival=0)
    st = engine.run()

    print(f"paged engine: {st['requests_done']} requests in {st['steps']} "
          f"steps ({args.policy}, device={device.type}, "
          f"pool={n_pages}x{ps} pages"
          + (f", {shards.D} x {shards.M} shards" if shards else "") + ")")
    print(f"prefill: {st['prefill_tok_s']:.1f} tok/s "
          f"({st['prefill_tokens']} tokens)")
    print(f"decode: {st['decode_tok_s']:.1f} tok/s "
          f"({st['decode_tokens']} tokens, "
          f"{st['decode_tok_per_step']:.2f} tok/step)")
    total = st["prefill_tokens"] + st["decode_tokens"]
    print(f"generated shape ({st['requests_done']}, {max_new}); "
          f"{total / max(st['wall_s'], 1e-9):.1f} tok/s "
          f"({st['wall_s']:.2f}s total)")
    print(f"ttft p50/p99: {st['ttft_steps_p50']:.0f}/"
          f"{st['ttft_steps_p99']:.0f} steps; per-token p50/p99: "
          f"{st['per_token_ms_p50']:.2f}/{st['per_token_ms_p99']:.2f} ms")
    print(f"kv bytes: pool {st['kv_pool_bytes']} (peak resident "
          f"{st['kv_peak_bytes']}) vs dense {st['dense_equiv_bytes']}")
    done = sorted(engine.sched.done, key=lambda r: r.rid)
    print("sample:", done[0].generated[:12] if done else [])
    print(f"admission fingerprint: {st['admission_fingerprint']}")
    print("SERVE-DRIVER-OK")
    st["done"] = done
    st["tokens"] = [r.generated for r in done]
    return st


if __name__ == "__main__":
    main()
