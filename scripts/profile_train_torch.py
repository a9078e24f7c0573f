"""Where the stacked trainer's inner step time goes on an NVIDIA GPU, in
float32 and in bfloat16.

    python3 scripts/profile_train_torch.py [--layers 12] [--steps 3]
    python3 scripts/profile_train_torch.py --dtypes bfloat16 --no-flash

One cluster's inner step of ``chip_smoke.py`` phase 4b (opt-1.3b at full
width, ``--layers`` of its 24, batch 4 x 512, flash attention unless
``--no-flash``): ``models.model.loss_fn``, its gradients, and
``optim.adamw.update``, as ``train.trainer.make_inner_fn`` runs them. For
each of ``--dtypes`` (the model's param and compute dtype; the AdamW
moments stay f32), in turns, after ``--warmup`` steps it times ``--steps``
steps on the host clock (each ends in a synchronize), then the same under
``torch.profiler``: the device busy time per step (the kernels' sum; one
stream), the idle share, the peak memory, the kernels by device time
with their share of the busy time, summed into groups by name (``gemm``:
cuBLAS / CUTLASS / nvjet names; ``flash``: this repository's flash kernels;
``other``: elementwise, reductions, copies), and the operators (ATen)
whose kernels take the most device time. bf16 matmuls reduce in f32
(``allow_bf16_reduced_precision_reduction = False``), as in
``chip_smoke.py``. Needs the GPU; exits non-zero without it.
"""
import argparse
import dataclasses
import os
import statistics
import sys
import time

import torch


def _group(name: str) -> str:
    low = name.lower()
    if "flash_" in low:
        return "flash"
    if any(k in low for k in ("gemm", "cutlass", "sm90", "xmma", "cublas", "nvjet")):
        return "gemm"
    return "other"


def _step_fn(cfg, params, opt, toks, flash):
    from repro_torch import tree as T
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    def step():
        nonlocal opt
        with torch.enable_grad():
            loss, _ = M.loss_fn(params, cfg, {"tokens": toks}, flash=flash)
            grads = torch.autograd.grad(loss, T.leaves(params))
        _, opt = adamw.update(T.unflatten_like(params, list(grads)), opt,
                              params, lr=1e-3)
        return loss.detach()

    return step


def profile(dtype: str, args, dev) -> None:
    from repro_torch import tree as T
    from repro_torch.configs.base import get_config, with_dtype
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(with_dtype(get_config("opt-1.3b"), dtype),
                              n_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.tree_map(lambda x: x.requires_grad_(True),
                        M.init_params(cfg, gen, dev))
    opt = adamw.init(params)
    toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                         device=dev, dtype=torch.int32)
    step = _step_fn(cfg, params, opt, toks, not args.no_flash)
    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        traced = 1e3 * (time.perf_counter() - t0) / args.steps
    kernels, ops = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.device_time_total > 0:
                kernels[e.key] = (e.device_time_total / 1e3 / args.steps,
                                  e.count // args.steps)
        elif e.self_device_time_total > 0:
            ops[e.key] = (e.self_device_time_total / 1e3 / args.steps,
                          e.count // args.steps)
    busy = sum(ms for ms, _ in kernels.values())
    step_ms = statistics.median(wall)
    groups = {}
    for name, (ms, _) in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    print(f"== {dtype}: opt-1.3b {args.layers} layers, 4 x 512, flash "
          f"{not args.no_flash}: step {step_ms:.1f} ms (host clock, median "
          f"of {args.steps}: {', '.join(f'{w:.1f}' for w in wall)}), traced "
          f"{traced:.1f} ms, device busy {busy:.1f} ms a step, idle share "
          f"{max(0.0, 1 - busy / traced):.3f}, peak {peak:.2f} GiB; by group "
          + ", ".join(f"{g} {ms:.1f} ms ({ms / busy:.1%})"
                      for g, ms in sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
          flush=True)
    for title, table in (("kernels", kernels), ("operators", ops)):
        print(f" {title} by device time a step:", flush=True)
        for name, (ms, n) in sorted(table.items(),
                                    key=lambda kv: -kv[1][0])[:args.top]:
            print(f"  {ms:8.2f} ms {ms / busy:6.1%} x{n:<5d} {name[:150]}",
                  flush=True)
    del params, opt, step
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--no-flash", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_torch: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    for dtype in args.dtypes.split(","):
        profile(dtype, args, dev)


if __name__ == "__main__":
    main()
