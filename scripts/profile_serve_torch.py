"""Where the paged engine's step time goes on NVIDIA GPUs.

    python3 scripts/profile_serve_torch.py [--arch opt-1.3b] [--steps 20]
    python3 scripts/profile_serve_torch.py --arch stablelm-12b --model 4

Serves full-width ``--arch`` (random weights drawn unit by unit, seed 0,
``models.model.draw_params``) on the port's paged engine with 8 slots,
prompt 128, page size 16, and after ``--warmup`` engine steps measures
``--steps`` more twice: once untraced (host clock around each step, which
ends in a device-to-host copy of the next tokens), once under
``torch.profiler``. It prints the step time, the device busy time per
step (sum of kernel times; one stream, so kernels do not overlap), the
device idle share, the tracing overhead, and the kernels by device time.
With ``--data D --model M`` (D x M > 1) the engine runs tensor-parallel,
one rank per card (NCCL, ``parallel.tensor.TPDecode``), every rank
printing the same, then the same engine on one card for comparison.
Needs the GPUs; exits non-zero without them.
"""
import argparse
import os
import statistics
import sys
import tempfile
import time

import torch

SLOTS, PROMPT_LEN, PAGE_SIZE = 8, 128, 16


def _engine(args, dev, shards=None):
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.parallel.tensor import serve_index
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(args.arch)
    params = (M.draw_params(cfg, 0, dev) if shards is None else
              [M.draw_params(cfg, 0, dev, serve_index(cfg, shards.M, m))
               for m in shards.model.local])
    n_steps = args.warmup + 2 * args.steps
    max_pages = -(-(PROMPT_LEN + n_steps) // PAGE_SIZE)
    eng = ServeEngine(params, cfg, max_seqs=SLOTS, page_size=PAGE_SIZE,
                      n_pages=SLOTS * max_pages, max_pages_per_seq=max_pages,
                      eos_id=None, device=dev, shards=shards)
    pgen = torch.Generator()
    pgen.manual_seed(1)
    for _ in range(SLOTS):
        eng.submit(torch.randint(0, cfg.vocab_size, (PROMPT_LEN,),
                                 generator=pgen).tolist(), n_steps)
    return eng


def _rank(rank, args, store):
    """One rank of the tensor-parallel engine, profiled."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.parallel.tensor import ShardGroup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = args.data * args.model
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        mesh = make_serving_mesh(init_device_mesh(
            "cuda", (args.data, args.model), mesh_dim_names=("data",
                                                             "model")))
        shards = ShardGroup(args.data, args.model,
                            data_group=mesh.get_group("data"),
                            model_group=mesh.get_group("model"),
                            group=dist.group.WORLD,
                            coords=mesh.get_coordinate())
        lines = profile_engine(_engine(args, dev, shards), args)
        for r in range(n):               # print in rank order
            if r == rank:
                print("\n".join(f"rank {rank}: {line}" for line in lines),
                      flush=True)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-1.3b")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    args = ap.parse_args()
    n = args.data * args.model
    if torch.cuda.device_count() < n:
        sys.exit(f"profile_serve_torch: needs {n} NVIDIA GPUs")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if n > 1:
        import torch.multiprocessing as mp

        print(f"== {args.arch}, {args.data} x {args.model} ranks (data x "
              f"model), one card each", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_rank, args=(args, os.path.join(tmp, "store")),
                               nprocs=n, start_method="spawn", join=True)
        print(f"== {args.arch}, one card", flush=True)
    print("\n".join(profile_engine(_engine(args, torch.device("cuda")),
                                   args)), flush=True)


def _host_lines(prof, args):
    """The host operators by self CPU time, ms and calls per step."""
    from torch.autograd import DeviceType

    host = sorted(((ev.self_cpu_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CPU),
                  key=lambda t: -t[0])[:args.top]
    lines = ["top host operators by self CPU time (ms per step, calls "
             "per step):"]
    for us, count, name in host:
        lines.append(f"  {us / 1e3 / args.steps:8.4f}  "
                     f"{count / args.steps:6.1f}  {name[:90]}")
    return lines


def profile_engine(eng, args):
    """The engine's untraced and traced steps: the report's lines."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(args.warmup):
        eng.step()
    torch.cuda.synchronize()

    untraced = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        eng.step()
        untraced.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    # kernel events only: an operator's event (aten::mm) carries the
    # device time of the kernels it launched as well
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            kernels[ev.key] = (dev_us, ev.count)
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3 / args.steps
    step_ms = statistics.median(untraced)
    out = [f"arch {args.arch}, {SLOTS} slots, prompt {PROMPT_LEN}, page "
           f"size {PAGE_SIZE}, cache positions {args.warmup}.."
           f"{args.warmup + 2 * args.steps} (prefill by decode)",
           f"untraced step ms: median {step_ms:.3f}, min "
           f"{min(untraced):.3f}, max {max(untraced):.3f} ({args.steps} "
           f"steps)",
           f"traced step ms: {traced_ms:.3f} (tracing overhead "
           f"{traced_ms - statistics.mean(untraced):.3f} ms per step)"]
    if not kernels:
        return out + ["device busy: not measured (the profiler recorded "
                      "no device time)"] + _host_lines(prof, args)
    n_kernels = sum(c for _, c in kernels.values()) / args.steps
    out += [f"device busy ms per step: {busy_ms:.3f} (traced run); device "
            f"idle share: {1 - busy_ms / step_ms:.4f} of the untraced "
            f"median step, {1 - busy_ms / traced_ms:.4f} of the traced step",
            f"kernels per step: {n_kernels:.1f}",
            "top kernels by device time (ms per step, launches per step, "
            "share of busy):"]
    for name, (us, count) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][0])[:args.top]:
        out.append(f"  {us / 1e3 / args.steps:8.4f}  "
                   f"{count / args.steps:6.1f}  "
                   f"{us / 1e3 / args.steps / busy_ms:6.3f}  {name[:90]}")
    return out + _host_lines(prof, args)


if __name__ == "__main__":
    main()
