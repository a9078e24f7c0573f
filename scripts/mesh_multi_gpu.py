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

``--device cpu --smoke-only`` runs the same on CPU processes (gloo) at the
reduced size, to rehearse. Needs ``--cards`` GPUs otherwise.
"""
import argparse
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke-only", action="store_true",
                    help="the timing runs at the reduced size too")
    args = ap.parse_args()
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

    with tempfile.TemporaryDirectory() as tmp:
        equivalence(train, args.device, tmp)
    timed(train, args.device, args.cards, args.cards, 1, args.smoke_only)
    if args.cards % 2 == 0 and args.cards >= 4:
        timed(train, args.device, args.cards, args.cards // 2, 2,
              args.smoke_only)
    print("MESH-MULTI-GPU-OK")


if __name__ == "__main__":
    main()
