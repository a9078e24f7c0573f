"""Times the flash kernels at each phase-3c case (``chip_smoke.FLASH_CASES``)
under forced range plans, one pass at a time: the forward at each
candidate ``chunk`` of k tiles, then the backward with the dK/dV plan at
each candidate chunk of q tiles (the dQ plan as planned), then with the
dQ plan at each candidate (dK/dV as planned). The candidates of a pass
with n tiles a block: n (no split), 1 and ceil(n / k) for k in 2, 3, 4,
5, 6, 8. The ``kernels/_plan.py`` model (``_range_plan``) is checked
against these times.

    python3 scripts/flash_plan_sweep.py [case name ...]

Prints the card's name and power limit, then per case the planned
``(split, chunk)`` of each pass and ``chunk:ms`` for each candidate
(``chip_smoke.time_ms``: medians of 30 launches, L2 overwritten). Needs
one NVIDIA GPU.
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, _plan, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def candidates(n):
    return sorted({n, 1} | {-(-n // k) for k in (2, 3, 4, 5, 6, 8)},
                  reverse=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("flash_plan_sweep: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build_all(["flash_attention"])
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    planned = (_plan.flash_fwd_plan, _plan.flash_dkdv_plan,
               _plan.flash_dq_plan)
    names = sys.argv[1:]
    for name, B, Sq, Sk, H, KV, d, causal in cs.FLASH_CASES:
        if names and name not in names:
            continue
        q = torch.randn((B, Sq, H, d), generator=gen, device=dev)
        k = torch.randn((B, Sk, KV, d), generator=gen, device=dev)
        v = torch.randn((B, Sk, KV, d), generator=gen, device=dev)
        do = torch.randn((B, Sq, H, d), generator=gen, device=dev)
        o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, causal)
        G = H // KV
        n_fwd = -(-Sk // _plan.flash_tile(d))
        n_kv = -(-Sq // _plan.flash_q_tile(d))
        n_q = -(-Sk // _plan.flash_dq_tile(d))

        def fwd():
            return fa.cuda_flash_attention_fwd(q, k, v, causal)

        def bwd():
            return fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do,
                                               causal)

        times = {"fwd": [], "dkdv": [], "dq": []}
        try:
            for c in candidates(n_fwd):
                _plan.flash_fwd_plan = (
                    lambda *a, c=c: (-(-n_fwd // c), c))
                times["fwd"].append((c, cs.time_ms(fwd, flush=flush)))
            _plan.flash_fwd_plan = planned[0]
            for c in candidates(n_kv):
                _plan.flash_dkdv_plan = (
                    lambda *a, c=c: (-(-n_kv // c), c, G * -(-n_kv // c)))
                times["dkdv"].append((c, cs.time_ms(bwd, flush=flush)))
            _plan.flash_dkdv_plan = planned[1]
            for c in candidates(n_q):
                _plan.flash_dq_plan = lambda *a, c=c: (-(-n_q // c), c)
                times["dq"].append((c, cs.time_ms(bwd, flush=flush)))
        finally:
            (_plan.flash_fwd_plan, _plan.flash_dkdv_plan,
             _plan.flash_dq_plan) = planned
        print(f"{name}: planned fwd {_plan.flash_fwd_plan(B, H, Sq, Sk, d)}"
              f" dkdv {_plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d)} dq "
              f"{_plan.flash_dq_plan(B, H, Sq, Sk, d)}", flush=True)
        for kind, row in times.items():
            print(f"    {kind} " + " ".join(f"{c}:{t:.4f}" for c, t in row),
                  flush=True)
        del q, k, v, do, o_p, lse_p
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
