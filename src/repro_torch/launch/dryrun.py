"""Shape dry-run of the pipeline-parallel inner engine on the ``meta``
device (port of ``repro.launch.dryrun``'s ``--inner pp`` check,
``pp_inner_smoke``).

    python -m repro_torch.launch.dryrun --inner pp --arch qwen1.5-107b \\
        --pp-stages 8

At full size with production dtypes (bf16 params and compute) and no
memory: the round state is built on ``meta``, one inner train step runs
through the GPipe schedule (every stage in process) and must be a shape
fixed point of the state's params and AdamW state, ``extract_delta`` must
give an f32 tree congruent with the params, and the placement rule
(``inner_engine.state_shardings``) must place every leaf. Prints
``PP-INNER-SMOKE-OK arch=... stages=... layers_per_stage=... params=...``
and a JSON summary.

Not ported (ROADMAP A.11d): the rest of the JAX dry-run, i.e. lowering the
mesh step through XLA, parsing its HLO for collectives and the TPU
roofline (``--mode``, ``--shape``, ``--all``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Any, Dict


def production_dtypes(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def pp_inner_smoke(arch: str, *, n_stages: int = 8, n_micro: int = 8,
                   batch: int = 16, seq_len: int = 512,
                   verbose: bool = True) -> Dict[str, Any]:
    """``--inner pp``: the full-size model through the pipeline-parallel
    inner engine on ``meta`` tensors (shapes only, no memory, no
    compute)."""
    import torch

    from repro_torch import tree as T
    from repro_torch.configs.base import get_config
    from repro_torch.parallel import inner_engine as IE
    from repro_torch.parallel import pipeline as PP

    res: Dict[str, Any] = {"arch": arch, "shape": f"pp_inner_b{batch}",
                           "mode": "pp_inner", "n_stages": n_stages}
    t0 = time.time()
    try:
        cfg = production_dtypes(get_config(arch))
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


def main(argv=None) -> None:
    from repro_torch.configs.base import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_IDS)
    ap.add_argument("--inner", default="pp", choices=["pp"],
                    help="the pipeline-parallel inner engine's shape check "
                         "on the meta device (the JAX dry-run's other "
                         "modes are not ported yet, ROADMAP A.11d)")
    ap.add_argument("--pp-stages", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    results = [pp_inner_smoke(args.arch, n_stages=args.pp_stages)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"DRYRUN SUMMARY ok={n_ok} skipped=0 fail={n_fail}")
    if n_fail:
        sys.exit(1)


if __name__ == "__main__":
    main()
