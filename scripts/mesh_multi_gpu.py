"""The mesh driver (``repro_torch.launch.train``) across several NVIDIA GPUs:
one rank per card, NCCL, against the same clusters stacked on one card.

    python3 scripts/mesh_multi_gpu.py [--cards 4]

1. Equivalence, reduced granite-3-8b (``--smoke``), 2 rounds of H = 2: the
   driver with 2 clusters on 2 cards against its in-process stacked run
   (both clusters in one process on one card, no process group). Prints
   each round's largest gap per state tree and whether the states are
   bitwise equal; fails if a round's mean loss differs by more than rtol
   1e-5.
2. Time at full opt-1.3b (24 layers, rank 64, H = 4, 512-token rows, 4
   rows per cluster and data rank), 2 rounds each: ``--clusters N`` (one
   cluster per card: the all-gather of the int4 payload over N cards)
   and, with 4 cards, ``--clusters 2 --data 2`` (the data group's
   gradient all-reduce every step). Prints rank 0's round, inner and
   outer seconds and the bytes it handed to the all-gather.

3. The pipeline-parallel driver (``--inner pp``; ``--pp``, in place of 1
   and 2), full opt-1.3b width, rank 64, H = 4,
   2 microbatches of 2 rows of 512 tokens per cluster, 2 rounds:
   ``--clusters 1 --pp-stages 4`` and ``--clusters 2 --pp-stages 2`` on
   the four cards, one stage per rank, activations and their gradients
   sent by NCCL point to point. Each rank's state after each round
   (params, AdamW state, anchor, Nesterov momentum, pending deltas, EF
   buffers, warm starts) is reduced to one exact integer digest per leaf
   (``state_digests``) and compared with the same cluster's and stage's
   rows of the in-process pipeline on one card (every stage and cluster in
   one process): bit for bit, or the script fails. Every rank run comes
   before the one-card references, so that no reference holds the first
   card's memory while ranks run (``--pp-legs`` picks the cluster
   counts). Prints each round's
   round, inner and outer seconds, the f32 bytes each rank hands to the
   clusters group and every card's peak memory. The one-card reference
   of 2 clusters holds both clusters' states; at 24 layers that is ~70
   GiB, so the 2 x 2 leg compares at ``PP_EQUAL_LAYERS`` (12) and times
   the 24-layer ranks separately.

4. Tensor parallelism and FSDP placement (``--tp``, in place of 1 and 2),
   full opt-1.3b width, rank 64, H = 4, 4 rows of 512 tokens per cluster,
   2 rounds, at (clusters x data x model) 1 x 1 x 4, 1 x 2 x 2 and
   2 x 1 x 2 on the four cards (``TP_LEGS``): each rank keeps its
   blocks of every leaf and the cluster's shards compute each step
   together (``parallel/tensor.py``). Each rank's digests are compared
   with its blocks of the in-process run on one card (every cluster and
   shard in one process), as the pp legs are; 2 clusters compare at
   ``PP_EQUAL_LAYERS`` and time the 24-layer ranks separately. Prints
   each round's seconds, the bytes each cluster hands to the all-gather
   (summed over its ranks) and every card's peak memory, beside the
   dry-run's (``launch/dryrun.py`` on the ``meta`` device) predicted
   per-card peak and collective bytes by axis (``parallel/comm.py``'s
   counts of the rank the dry-run picks).

5. Serving across cards (``--serve``, in place of 1 and 2): the serve
   driver (``repro_torch.launch.serve``, paged engine, 8 slots, 12
   requests of 32 prompt and 32 generated tokens) one rank per card,
   weights and KV cache split over "model" (``parallel/tensor.py::
   TPDecode``), slots over "data" (``SERVE_LEGS``): opt-1.3b at data x
   model 1 x 4 and 2 x 2, stablelm-12b at 1 x 4 (40 layers) and
   qwen1.5-107b at 1 x 4 cut to 8 of 78 layers. Each rank's digest
   (``tree.bit_digest``) of its head outputs at every step must equal its
   shard's in the in-process run (every shard in one process on one card),
   and its tokens and admission fingerprint those of the one-card run.
   Then qwen1.5-107b at 40 of 78 layers, 1 x 4 (``SERVE_BIG``: ~53 GiB a
   card, ~212 GiB on one), ranks only: finite logits and the same tokens
   on every rank. Rank runs come before the one-card references. Prints
   per-token ms p50/p99 and every card's peak memory.

``--device cpu --smoke-only`` runs the same on CPU processes (gloo) at the
reduced size, to rehearse. Needs ``--cards`` GPUs otherwise.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch


def _flat_state(params, opt, outer):
    from repro_torch.checkpoint import checkpoint as ckpt
    return {k: v.copy() for k, v in ckpt._flatten(
        {"params": params, "opt": opt, "outer": outer._asdict()}).items()}


def equivalence(train, device, tmp):
    """Two ranks (one cluster each) against both clusters in one process."""
    argv = ["--arch", "granite-3-8b", "--smoke", "--device", device,
            "--devices", "2", "--clusters", "2", "--data", "1", "--model",
            "1", "--rounds", "2", "--h-steps", "2", "--global-batch", "4",
            "--seq-len", "16", "--cpu-threads", "1", "--join-timeout", "600"]
    out = os.path.join(tmp, "ranks")
    ranks = train.main(argv + ["--state-out", out], store_dir=tmp)
    states = []
    dev = torch.device(device)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stacked = train.run(train._parse_args(argv), dev, clusters=[0, 1],
                            on_round=lambda r, *s: states.append(
                                _flat_state(*s)))
    finally:
        torch.set_num_threads(threads)
    print(f"equivalence: mean loss per round, 2 ranks {ranks['mean_loss']}, "
          f"stacked {stacked['mean_loss']}", flush=True)
    for r, want in enumerate(states):
        got = [dict(np.load(os.path.join(out, f"round_{r:04d}.rank{k}.npz")))
               for k in range(2)]
        gaps, equal = {}, True
        for key, arr in want.items():
            unstacked = key.startswith(("['outer']['anchor']",
                                        "['outer']['outer_opt']"))
            g = got[0][key] if unstacked else np.concatenate(
                [got[0][key], got[1][key]])
            equal &= bool(np.array_equal(g, arr))
            tree = key.split("]")[0] + "]"
            gap = float(np.abs(g.astype(np.float64) - arr).max(initial=0.0))
            gaps[tree] = max(gaps.get(tree, 0.0), gap)
        print(f"round {r}: largest gap per tree {gaps}; bitwise equal: "
              f"{equal}", flush=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(ranks["mean_loss"],
                                                  stacked["mean_loss"]))
    if rel > 1e-5:
        sys.exit(f"FAIL equivalence: mean losses {rel:.3e} apart")


def timed(train, device, cards, clusters, data, smoke):
    argv = ["--arch", "opt-1.3b", "--device", device, "--devices",
            str(cards), "--clusters", str(clusters), "--data", str(data),
            "--model", "1", "--rounds", "2", "--h-steps", "4",
            "--global-batch", str(4 * clusters * data), "--seq-len",
            "32" if smoke else "512", "--rank", "64", "--join-timeout",
            "900"] + (["--smoke"] if smoke else [])
    print("== python -m repro_torch.launch.train " + " ".join(argv),
          flush=True)
    s = train.main(argv)
    for r in range(2):
        print(f"{clusters} clusters x {data} data ranks, round {r}: mean loss "
              f"{s['mean_loss'][r]:.6f}, round {s['round_s'][r]:.3f} s, inner "
              f"{s['inner_s'][r]:.3f} s ({1e3 * s['inner_s'][r] / 4:.1f} ms "
              f"per step), outer {s['outer_s'][r]:.3f} s, rank 0 handed "
              f"{s['gather_bytes'][r]} B to the all-gather", flush=True)


_PARAM_TREES = ("['params']", "['opt'].m", "['opt'].v",
                "['outer']['anchor']", "['outer']['outer_opt'].momentum",
                "['outer']['delta_pending']", "['outer']['error']")


def state_digests(params, opt, outer, clusters=None, stage=None, block=None):
    """{leaf path: ``tree.bit_digest``} of a driver's round state (the
    layout of ``--state-out``). With ``clusters``/``stage``: the rows of
    one cluster and one stage of an in-process state, as that rank holds
    them; with ``block`` = (placements, mesh, coords): the block of each
    param-shaped leaf that a tensor-parallel rank holds."""
    from repro_torch import tree as T
    from repro_torch.parallel.pipeline import is_stage_path
    from repro_torch.parallel.sharding import block_slices

    out = {}
    tree = {"params": params, "opt": opt, "outer": outer._asdict()}
    for key, x in T.keystr_items(tree):
        unstacked = key.startswith(("['outer']['anchor']",
                                    "['outer']['outer_opt']"))
        if clusters is not None and not unstacked and x.dim() > 0:
            x = x.narrow(0, clusters, 1)
        if stage is not None and is_stage_path(key) \
                and "['q_state']" not in key:
            x = x.narrow(0 if unstacked else 1, stage, 1)
        pre = [p for p in _PARAM_TREES if key.startswith(p)]
        if block is not None and pre:
            specs, mesh, coords = block
            lead = () if unstacked else (None,)
            x = x[block_slices(x.shape, lead + specs[key[len(pre[0]):]],
                               mesh, coords)]
        out[key] = T.bit_digest(x)
    return out


def _rank(rank, argv, store_path, out_dir, stuck_s):
    """One spawned rank of a pp or tp leg: the driver's worker, with each
    round's state digests written to ``out_dir``. A rank still running
    after ``stuck_s`` seconds prints every thread's Python stack and
    exits, which stops the others."""
    import faulthandler

    faulthandler.dump_traceback_later(stuck_s, exit=True)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    import torch

    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.parallel import comm

    digests = []
    comm.reset()
    summary = train._worker(
        rank, train._parse_args(argv), store_path,
        on_round=lambda r, *st: digests.append(state_digests(*st)))
    faulthandler.cancel_dump_traceback_later()
    by_axis = {}
    for (axis, _), (_, n) in comm.counts.items():
        by_axis[axis] = by_axis.get(axis, 0) + n
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"digests": digests, "summary": summary,
                   "collective_bytes_by_axis": by_axis}, f)


def pp_argv(device, cards, clusters, stages, smoke, n_layers=0):
    argv = ["--arch", "opt-1.3b", "--device", device, "--inner", "pp",
            "--devices", str(cards), "--clusters", str(clusters), "--data",
            "1", "--pp-stages", str(stages), "--pp-micro", "2", "--rounds",
            "2", "--h-steps", "4", "--global-batch", str(4 * clusters),
            "--seq-len", "32" if smoke else "512", "--rank", "64",
            "--join-timeout", "900"]
    if smoke:
        argv.append("--smoke")
    if n_layers:
        argv += ["--n-layers", str(n_layers)]
    if device == "cpu":
        argv += ["--cpu-threads", "1"]
    return argv


def rank_runs(argv, cards, tmp, stuck_s=420):
    """The driver's ranks, spawned here so that each writes its digests."""
    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(dir=tmp)
    store = os.path.join(out, "store")
    print("== ranks: python -m repro_torch.launch.train " + " ".join(argv),
          flush=True)
    mp.start_processes(_rank, args=(argv, store, out, stuck_s),
                       nprocs=cards, start_method="spawn", join=True)
    got = []
    for rank in range(cards):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            got.append(json.load(f))
    s = got[0]["summary"]
    for r in range(len(s["round_s"])):
        wire = (f"rank 0 hands {s['allreduce_bytes'][r]} B of f32 to the "
                f"clusters group" if "allreduce_bytes" in s else
                f"cluster 0 hands {s['gather_bytes'][r]} B to the all-gather")
        print(f"round {r}: mean loss {s['mean_loss'][r]:.6f}, round "
              f"{s['round_s'][r]:.3f} s, inner {s['inner_s'][r]:.3f} s "
              f"({1e3 * s['inner_s'][r] / 4:.1f} ms per step), outer "
              f"{s['outer_s'][r]:.3f} s; {wire}", flush=True)
    peaks = s.get("peak_bytes") or []
    print(f"peak memory per card: "
          f"{[round(b / 2**30, 2) for b in peaks]} GiB", flush=True)
    return got


def reference(train, device, argv, views):
    """The in-process run (every stage, shard and cluster in this process,
    one card): per round, each rank's digests of its view of the state
    (``views``: one ``state_digests`` keyword dict per rank); its device
    memory is released afterwards for the next ranks."""
    import torch

    want = []
    dev = torch.device(device)
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    args = train._parse_args(argv)
    try:
        summary = train.run(args, dev, clusters=list(range(args.clusters)),
                            on_round=lambda r, *st: want.append(
                                [state_digests(*st, **v) for v in views]))
    finally:
        torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.empty_cache()
    print(f"in-process on one card ({' '.join(argv[argv.index('--clusters'):argv.index('--rounds')])}"
          f"{' --n-layers ' + argv[argv.index('--n-layers') + 1] if '--n-layers' in argv else ''}): "
          f"mean loss {summary['mean_loss']}, peak "
          f"{[round(b / 2**30, 2) for b in summary['peak_bytes']]} GiB",
          flush=True)
    return summary, want


def compare(ranks, ref, label):
    """Whether every rank's digests equal its view of the reference."""
    summary, want = ref
    equal = ranks[0]["summary"]["mean_loss"] == summary["mean_loss"]
    for r, digests in enumerate(want):
        bad = []
        for rank, got in enumerate(ranks):
            got = got["digests"][r]
            bad += [f"rank {rank} {k}" for k, v in digests[rank].items()
                    if got.get(k) != v]
            if sorted(got) != sorted(digests[rank]):
                bad.append(f"rank {rank}: other leaves")
        print(f"round {r}: {label}, ranks bit for bit the in-process run: "
              f"{not bad} ({len(bad)} leaves differ"
              f"{': ' + ', '.join(bad[:4]) if bad else ''})", flush=True)
        equal &= not bad
    return equal


PP_EQUAL_LAYERS = 12     # the depth whose 2-cluster reference fits a card


def pp_legs(train, device, cards, legs, smoke, tmp):
    """Each leg (a cluster count; stages = cards / clusters): the ranks at
    full depth, and for 2 clusters again at ``PP_EQUAL_LAYERS``; then the
    one-card references of the runs to compare, after every rank run, so
    that no reference holds the first card's memory while ranks run."""
    runs = []
    for clusters in legs:
        stages = cards // clusters
        full = pp_argv(device, cards, clusters, stages, smoke)
        cut = (pp_argv(device, cards, clusters, stages, smoke,
                       PP_EQUAL_LAYERS) if clusters > 1 else None)
        got = rank_runs(full, cards, tmp)
        if cut is not None:
            got = rank_runs(cut, cards, tmp)
        views = [dict(clusters=c, stage=s) for c in range(clusters)
                 for s in range(stages)]
        runs.append((cut or full, got, views,
                     f"{clusters} clusters x {stages} stages"))
    return all([compare(got, reference(train, device, argv, views), label)
                for argv, got, views, label in runs])


TP_LEGS = ((1, 1, 4), (1, 2, 2), (2, 1, 2))  # clusters x data x model


def tp_argv(device, cards, clusters, data, model, smoke, n_layers=0):
    argv = ["--arch", "opt-1.3b", "--device", device, "--devices",
            str(cards), "--clusters", str(clusters), "--data", str(data),
            "--model", str(model), "--rounds", "2", "--h-steps", "4",
            "--global-batch", str(4 * clusters), "--seq-len",
            "32" if smoke else "512", "--rank", "64", "--join-timeout", "900"]
    if smoke:
        argv.append("--smoke")
    if n_layers:
        argv += ["--n-layers", str(n_layers)]
    if device == "cpu":
        argv += ["--cpu-threads", "1"]
    return argv


def predicted(train, argv, clusters, data, model):
    """The dry-run's (``launch/dryrun.py``, the ``meta`` device) per-card
    peak and per-axis collective bytes of the driver's run ``argv``: one
    round's step and outer step, times the run's steps and rounds, for
    the rank the dry-run picks (the outer step's heaviest owner)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR

    args = train._parse_args(argv)
    res = DR.lower_one(args.arch, mesh={"clusters": clusters, "data": data,
                                        "model": model},
                       shape=ShapeConfig("mesh", args.seq_len,
                                         args.global_batch, "train"),
                       rank=args.rank, production=False,
                       cfg=train._model_config(args), verbose=False)
    if res["status"] != "ok":
        sys.exit(f"mesh_multi_gpu: dry-run {res.get('error')}")
    ph = res["phases"]
    axes = set(ph["train"]["collective_bytes_by_axis"]) | set(
        ph["outer"]["collective_bytes_by_axis"])
    by_axis = {a: args.rounds * (
        args.h_steps * ph["train"]["collective_bytes_by_axis"].get(a, 0)
        + ph["outer"]["collective_bytes_by_axis"].get(a, 0)) for a in axes}
    c = res["rank_coords"]
    rank = (c["clusters"] * data + c["data"]) * model + c["model"]
    return {"peak": res["per_device_memory_bytes"], "by_axis": by_axis,
            "rank": rank}


def beside_prediction(want, got):
    """Prints the dry-run's prediction beside rank ``want["rank"]``'s
    measured per-axis bytes and every card's peak."""
    meas = got[want["rank"]]["collective_bytes_by_axis"]
    print(f"dry-run vs rank {want['rank']}: per-card peak predicted "
          f"{want['peak'] / 2**30:.2f} GiB, measured "
          f"{[round(b / 2**30, 2) for b in got[0]['summary'].get('peak_bytes') or []]}"
          f" GiB; collective bytes by axis (predicted / measured): "
          + ", ".join(f"{a} {want['by_axis'].get(a, 0)} / {meas.get(a, 0)}"
                      for a in sorted(set(want["by_axis"]) | set(meas))),
          flush=True)


def tp_legs(train, device, cards, legs, smoke, tmp):
    """Each leg (clusters, data, model): the ranks at full depth, and with
    2 clusters again at ``PP_EQUAL_LAYERS``; then the one-card references,
    after every rank run. A rank's view of the reference is its cluster's
    row and its blocks (``parallel.sharding.param_placements``)."""
    from repro_torch.parallel import sharding as sh

    runs = []
    for clusters, data, model in legs:
        full = tp_argv(device, cards, clusters, data, model, smoke)
        cut = (tp_argv(device, cards, clusters, data, model, smoke,
                       PP_EQUAL_LAYERS) if clusters > 1 else None)
        want = predicted(train, full, clusters, data, model)
        got = rank_runs(full, cards, tmp)
        beside_prediction(want, got)
        if cut is not None:
            got = rank_runs(cut, cards, tmp)
        cfg = train._model_config(train._parse_args(cut or full))
        from repro_torch.models import model as M

        mesh = {"data": data, "model": model}
        specs = sh.param_placements(M.init_params(cfg, device="meta"), mesh,
                                    cluster_stacked=False)
        views = [dict(clusters=r // (data * model), block=(
            specs, mesh, {"data": r // model % data, "model": r % model}))
            for r in range(cards)]
        runs.append((cut or full, got, views,
                     f"{clusters} x {data} x {model}"))
    return all([compare(got, reference(train, device, argv, views), label)
                for argv, got, views, label in runs])


SERVE_LEGS = (("opt-1.3b", 0, 1, 4), ("opt-1.3b", 0, 2, 2),
              ("stablelm-12b", 0, 1, 4), ("qwen1.5-107b", 8, 1, 4))
SERVE_BIG = ("qwen1.5-107b", 40, 1, 4)      # arch, layers, data, model


def serve_argv(device, arch, n_layers, data, model, smoke):
    argv = ["--arch", arch, "--device", device, "--paged", "--batch", "8",
            "--requests", "12", "--prompt-len", "32", "--gen-len", "32",
            "--page-size", "16", "--eos", "-1", "--devices",
            str(data * model), "--data", str(data), "--model", str(model),
            "--join-timeout", "900"]
    if smoke:
        argv.append("--smoke")
    if n_layers:
        argv += ["--n-layers", str(n_layers)]
    if device == "cpu":
        argv += ["--cpu-threads", "1"]
    return argv


def serve_ranks(serve, argv, cards, tmp):
    """The driver's ranks (``serve.main``), each writing its head outputs'
    digests and its tokens (``--digests-out``): rank 0's summary and
    every rank's record."""
    out = tempfile.mkdtemp(dir=tmp)
    print("== ranks: python -m repro_torch.launch.serve " + " ".join(argv),
          flush=True)
    s = serve.main(argv + ["--digests-out", out], store_dir=tmp)
    got = []
    for rank in range(cards):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            got.append(json.load(f))
    print(f"{s['requests_done']} requests, {s['device_steps']} device steps, "
          f"per-token p50/p99 {s['per_token_ms_p50']:.3f}/"
          f"{s['per_token_ms_p99']:.3f} ms, decode {s['decode_tok_s']:.1f} "
          f"tok/s, wall {s['wall_s']:.3f} s; peak memory per card "
          f"{[round(b / 2**30, 2) for b in s['peak_bytes']]} GiB", flush=True)
    return s, got


def serve_reference(serve, device, argv, shards, tmp):
    """The one-card run (``shards`` False: --data 1 --model 1) or the
    in-process shard run of ``argv`` (every shard in this process, its
    digests recorded); device memory is released afterwards."""
    import torch

    args = serve._parse_args(argv)
    if not shards:
        args.data = args.model = args.devices = 1
    args.digests_out = tempfile.mkdtemp(dir=tmp) if shards else ""
    threads = torch.get_num_threads()
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        st = serve.run(args, torch.device(device))
    finally:
        torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.empty_cache()
    print(f"{'in-process shards' if shards else 'one card'}: "
          f"per-token p50/p99 {st['per_token_ms_p50']:.3f}/"
          f"{st['per_token_ms_p99']:.3f} ms", flush=True)
    digests = []
    if shards:
        with open(os.path.join(args.digests_out, "rank0.json")) as f:
            digests = json.load(f)["digests"]
    return {"tokens": st["tokens"], "digests": digests,
            "admission_fingerprint": st["admission_fingerprint"]}


def serve_compare(summary, ranks, one, inproc, model, label):
    """Every rank's digests against its shard's in the in-process run, and
    the tokens and fingerprint against the one-card run's."""
    ok = (summary["admission_fingerprint"] == one["admission_fingerprint"])
    print(f"{label}: admission fingerprint equal: {ok}", flush=True)
    for rank, got in enumerate(ranks):
        mine = got["digests"]
        keys = {(tuple(r), m) for r, m, _, _ in mine}
        want = [d for d in inproc["digests"] if (tuple(d[0]), d[1]) in keys]
        same_bits = len(mine) > 0 and [d[2] for d in mine] == [
            d[2] for d in want]
        same_tokens = got["tokens"] == one["tokens"]
        print(f"{label}: rank {rank} (data {rank // model}, model "
              f"{rank % model}): {len(mine)} head outputs bit for bit the "
              f"in-process shard run's: {same_bits}; tokens equal the "
              f"one-card run's: {same_tokens}", flush=True)
        ok &= same_bits and same_tokens
    return ok


def serve_legs(device, cards, smoke, tmp):
    """The serve legs' ranks first, then the ranks-only leg, then the
    references (one card, and every shard in one process)."""
    from repro_torch.launch import serve

    runs = []
    for arch, n_layers, data, model in SERVE_LEGS:
        argv = serve_argv(device, arch, n_layers, data, model, smoke)
        label = (f"{arch}{f' {n_layers} layers' if n_layers else ''} "
                 f"{data} x {model}")
        runs.append((argv, model, label) + serve_ranks(serve, argv, cards,
                                                       tmp))
    arch, n_layers, data, model = SERVE_BIG
    _, big = serve_ranks(serve, serve_argv(device, arch, n_layers, data,
                                           model, smoke), cards, tmp)
    finite = all(d[3] for r in big for d in r["digests"])
    same = all(r["tokens"] == big[0]["tokens"] for r in big)
    print(f"{arch} {n_layers} layers {data} x {model}: head outputs finite "
          f"on every rank: {finite}; the same tokens on every rank: {same}",
          flush=True)
    ok = finite and same
    for argv, model, label, summary, ranks in runs:
        one = serve_reference(serve, device, argv, False, tmp)
        inproc = serve_reference(serve, device, argv, True, tmp)
        ok &= serve_compare(summary, ranks, one, inproc, model, label)
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke-only", action="store_true",
                    help="the timing runs at the reduced size too")
    ap.add_argument("--pp", action="store_true",
                    help="the pipeline-parallel legs in place of the others")
    ap.add_argument("--pp-legs", default="1,2",
                    help="cluster counts of the pp legs (stages: cards / "
                         "clusters)")
    ap.add_argument("--tp", action="store_true",
                    help="the tensor-parallel legs in place of the others")
    ap.add_argument("--serve", action="store_true",
                    help="the serving legs in place of the others")
    args = ap.parse_args()
    if args.tp and any(c * d * m != args.cards for c, d, m in TP_LEGS):
        sys.exit(f"mesh_multi_gpu: the --tp legs (clusters x data x model "
                 f"{TP_LEGS}) each need 4 cards; got --cards {args.cards}")
    if args.device == "cuda":
        if torch.cuda.device_count() < args.cards:
            sys.exit(f"mesh_multi_gpu: needs {args.cards} GPUs, "
                     f"{torch.cuda.device_count()} visible")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    from repro_torch.launch import train

    if args.serve:
        if args.cards != 4:
            sys.exit(f"mesh_multi_gpu: the --serve legs need 4 cards; got "
                     f"--cards {args.cards}")
        with tempfile.TemporaryDirectory() as tmp:
            equal = serve_legs(args.device, args.cards, args.smoke_only, tmp)
        if not equal:
            sys.exit("FAIL serve: the ranks differ from the references")
    elif args.tp:
        with tempfile.TemporaryDirectory() as tmp:
            equal = tp_legs(train, args.device, args.cards, TP_LEGS,
                            args.smoke_only, tmp)
        if not equal:
            sys.exit("FAIL tp: the ranks differ from the in-process run")
    elif not args.pp:
        with tempfile.TemporaryDirectory() as tmp:
            equivalence(train, args.device, tmp)
        timed(train, args.device, args.cards, args.cards, 1, args.smoke_only)
        if args.cards % 2 == 0 and args.cards >= 4:
            timed(train, args.device, args.cards, args.cards // 2, 2,
                  args.smoke_only)
    else:
        legs = [int(c) for c in args.pp_legs.split(",")
                if args.cards % int(c) == 0]
        with tempfile.TemporaryDirectory() as tmp:
            equal = pp_legs(train, args.device, args.cards, legs,
                            args.smoke_only, tmp)
        if not equal:
            sys.exit("FAIL pp: the ranks differ from the in-process pipeline")
    print("MESH-MULTI-GPU-OK")


if __name__ == "__main__":
    main()
