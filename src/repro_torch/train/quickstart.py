"""Quickstart: DiLoCoX vs vanilla AllReduce on a tiny LM (port of
``examples/quickstart.py``).

Trains the same reduced dense model two ways over 2 simulated clusters and
prints the loss curves plus the bytes each method put on the wire, then
``TRAIN-DRIVER-OK``:

  PYTHONPATH=src python -m repro_torch.train.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.train.quickstart     # on the GPU

On a CUDA device the DiLoCoX run compresses with the fused CUDA kernels
(``backend="pallas"``); on the CPU with their plain versions. ``--flash``
sends attention through the flash kernels (their plain versions on the
CPU) and trains on 128-token sequences, the shortest the flash route
takes (S % 128 == 0); without it the sequences have 32 tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import math

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.train import trainer as T


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="opt-1.3b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--h-steps", type=int, default=10)
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--flash", action="store_true",
                    help="attention through the flash kernels (S = 128)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(get_config(args.arch).reduced(),
                              vocab_size=args.vocab)
    rounds, h = args.rounds, args.h_steps
    print("attention:", "flash kernels" if args.flash else "einsum")
    base = dict(n_clusters=2, local_batch=8,
                seq_len=128 if args.flash else 32, inner_lr=3e-3,
                flash_attention=args.flash)

    print("== vanilla AllReduce (sync every step) ==")
    ar = T.run_allreduce_training(cfg, T.TrainConfig(**base, h_steps=1),
                                  rounds * h, device=device)
    print("eval loss:", [round(x, 2) for x in ar.eval_losses[::h]])

    print(f"== DiLoCoX (H={h} local steps, low-rank+int4, one-step delay) ==")
    tc = T.TrainConfig(**base, h_steps=h, compressor="diloco_x",
                       compressor_kw=dict(rank=16, bits=4, backend="pallas"),
                       outer_lr=0.5, outer_momentum=0.7)
    dlx = T.run_diloco_training(cfg, tc, rounds, device=device)
    print("eval loss:", [round(x, 2) for x in dlx.eval_losses])

    wire_ar = sum(ar.wire_bytes_per_round)
    wire_dlx = sum(dlx.wire_bytes_per_round)
    print(f"\nwire bytes  AllReduce: {wire_ar/1e6:9.1f} MB "
          f"(every step, fp32)")
    print(f"wire bytes  DiLoCoX : {wire_dlx/1e6:9.1f} MB "
          f"({wire_ar/max(wire_dlx,1):.0f}x less)")
    print(f"final loss  AllReduce={ar.eval_losses[-1]:.3f}  "
          f"DiLoCoX={dlx.eval_losses[-1]:.3f}")
    if not all(map(math.isfinite, ar.eval_losses + dlx.eval_losses)):
        raise SystemExit("non-finite loss")
    print(f"TRAIN-DRIVER-OK device={device.type} arch={args.arch}")
    return {"allreduce": ar, "diloco": dlx}


if __name__ == "__main__":
    main()
