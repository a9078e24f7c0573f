"""Single-card DiLoCoX trainer (port of ``repro.train.trainer``): D clusters
stacked along a leading axis of one device's tensors, each running its H
inner AdamW steps in turn, then the compressed, delayed outer step of
``core.diloco.diloco_round``.

AllReduce, OpenDiLoCo-style, CocktailSGD-style and DiLoCoX runs all go
through ``diloco_round`` or the two baselines below with different
``RoundConfig``/``Compressor`` settings, as in the JAX package.

Entry points run on CUDA unless ``device="cpu"`` is passed, and raise
without a GPU (``repro_torch.device``). Data comes from
``data.synthetic`` streams keyed by (seed, cluster, round, step); tests
pass ``batch_fn``/``eval_batch``/``params``/``comp_state`` drawn by the JAX
package instead, since the two packages' random streams differ.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adaptive, diloco
from repro_torch.core.compression import make_compressor, tree_shapes
from repro_torch.data.synthetic import (SyntheticLM, _gen_batch,
                                        stream_generator, with_frontend)
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw


@dataclass
class TrainConfig:
    n_clusters: int = 2           # D (paper's decentralized clusters)
    local_batch: int = 8
    seq_len: int = 64
    inner_lr: float = 1e-3
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    h_steps: int = 20             # H (local steps per round)
    compressor: str = "diloco_x"
    compressor_kw: Dict[str, Any] = field(default_factory=dict)
    delay: bool = True
    compress: bool = True
    error_feedback: bool = True
    adaptive: bool = False        # run AdaGradCmp (Alg. 3)
    adaptive_mode: str = "paper"
    adaptive_window: int = 5      # Alg. 3 window c
    hetero: float = 0.0           # per-cluster data heterogeneity (xi^2>0)
    # heterogeneous local steps (core.adaptive.HSpec): "balance" gives each
    # cluster its own H from step_times; the tail of the h_steps budget is
    # skipped (core.diloco.masked_local_steps)
    h_policy: str = "global"      # global | balance
    h_min: int = 1
    step_times: Optional[Any] = None   # per-cluster step seconds (len C)
    # "pp": the pipeline-parallel inner engine (parallel.inner_engine),
    # every stage on this device, pp_micro microbatches a step
    inner_engine: str = "scalar"  # scalar | pp
    pp_stages: int = 2
    pp_micro: int = 2
    # plain causal self-attention through the flash kernels (the port's
    # REPRO_USE_PALLAS=1 for attention; models.attention.grouped_attend)
    flash_attention: bool = False
    seed: int = 0


BRANCHING = 4


def _hetero_bias(tcfg: TrainConfig) -> Optional[torch.Tensor]:
    """(C, branching) per-cluster successor-slot bias logits, or None."""
    if tcfg.hetero <= 0:
        return None
    boost = float(np.log(1.0 + tcfg.hetero * BRANCHING
                         / (1 - tcfg.hetero + 1e-9)))
    bias = torch.zeros((tcfg.n_clusters, BRANCHING))
    for c in range(tcfg.n_clusters):
        bias[c, c % BRANCHING] = boost
    return bias


def default_batch_fn(tcfg: TrainConfig, data_table: torch.Tensor):
    """tokens for (cluster, round, step): the port's own stream."""
    bias_all = _hetero_bias(tcfg)

    def batch_fn(cluster_idx: int, round_idx: int, h: int) -> torch.Tensor:
        gen = stream_generator(tcfg.seed + 7, cluster_idx, round_idx, h)
        return _gen_batch(gen, tcfg.local_batch, tcfg.seq_len, BRANCHING,
                          data_table,
                          None if bias_all is None else bias_all[cluster_idx])
    return batch_fn


def _as_tensor(x, device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or an array (copied: arrays
    handed over from other frameworks may be read-only)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device)


def make_inner_fn(cfg: ModelConfig, tcfg: TrainConfig, data_table,
                  h_vec=None, *, batch_fn: Optional[Callable] = None):
    """Returns ``inner_fn(params, inner_opt_stacked, round_idx) -> (stacked
    params after the local AdamW steps of every cluster, inner state,
    losses)``. Clusters run one after another (no vmap); each starts from
    ``params`` and updates its own row of the stacked tensors in place.
    Losses are (C, H), or with ``h_vec`` (per-cluster step counts) the (C,)
    per-cluster mean over the steps each cluster ran. ``batch_fn(cluster,
    round, step)`` gives token batches (default: the port's stream)."""
    batch_fn = batch_fn or default_batch_fn(tcfg, data_table)
    C, H = tcfg.n_clusters, tcfg.h_steps

    def step_body(carry, h, cluster_idx, round_idx):
        params, opt_state = carry
        dev = T.leaves(params)[0].device
        toks = _as_tensor(batch_fn(cluster_idx, round_idx, h), dev)
        with torch.enable_grad():
            loss, _ = M.loss_fn(params, cfg, {"tokens": toks},
                                flash=tcfg.flash_attention)
            grads = torch.autograd.grad(loss, T.leaves(params))
        grads = T.unflatten_like(params, list(grads))
        params, opt_state = adamw.update(grads, opt_state, params,
                                         lr=tcfg.inner_lr)
        return (params, opt_state), loss.detach()

    def inner_fn(params, inner_opt_stacked, round_idx):
        r = int(round_idx)
        params_s = diloco.stack_replicas(params, C)
        losses, steps = [], []
        for c in range(C):
            p_c = T.tree_map(lambda x: x.detach().requires_grad_(True),
                             diloco.take_row(params_s, c))
            opt_c = adamw.AdamWState(step=inner_opt_stacked.step[c],
                                     m=diloco.take_row(inner_opt_stacked.m, c),
                                     v=diloco.take_row(inner_opt_stacked.v, c))
            carry = (p_c, opt_c)
            step = lambda carry, h, c=c: step_body(carry, h, c, r)
            if h_vec is None:
                row = []
                for h in range(H):
                    carry, loss = step(carry, h)
                    row.append(loss)
                losses.append(torch.stack(row).float().cpu())
            else:
                carry, mean = diloco.masked_local_steps(step, carry, H,
                                                        h_vec[c])
                losses.append(mean)
            steps.append(carry[1].step)
            del carry, p_c
        opt = adamw.AdamWState(step=torch.stack(steps),
                               m=inner_opt_stacked.m, v=inner_opt_stacked.v)
        return params_s, opt, torch.stack(losses)

    return inner_fn


def make_pp_inner_fn(cfg: ModelConfig, tcfg: TrainConfig, data_table, pcfg,
                     h_vec=None, *, batch_fn: Optional[Callable] = None,
                     device=None):
    """Pipeline-parallel counterpart of ``make_inner_fn``: the same
    (cluster, round, step) batches, every inner step through the GPipe
    loss with all stages in this process (``parallel.inner_engine.
    make_pp_one_cluster``), clusters unrolled by ``make_pp_inner_fns``.
    Numerics against the sequential engine are tolerance-level, not
    bitwise (``parallel.inner_engine``)."""
    from repro_torch.parallel import inner_engine as IE

    batch_fn = batch_fn or default_batch_fn(tcfg, data_table)
    one, one_h = IE.make_pp_one_cluster(
        cfg, pcfg, inner_lr=tcfg.inner_lr, h_steps=tcfg.h_steps,
        batch_fn=lambda c, t, i: _as_tensor(batch_fn(c, t, i), device),
        flash=tcfg.flash_attention)
    inner_fn, inner_fn_h = IE.make_pp_inner_fns(one, one_h,
                                                tcfg.n_clusters)
    if h_vec is None:
        return inner_fn
    return lambda params, opt, t: inner_fn_h(params, opt, t, h_vec)


def cluster_mean(stacked_tree):
    return T.tree_map(lambda x: x.mean(dim=0), stacked_tree)


@dataclass
class RunResult:
    losses: List[float]
    eval_losses: List[float]
    wire_bytes_per_round: List[int]
    h_per_round: List[int]
    r_per_round: List[int]
    wall_s: float
    # per-cluster executed local steps per round (heterogeneous h_policy
    # only; empty under the global policy)
    h_by_per_round: List[tuple] = field(default_factory=list)
    # host-clock seconds per round (synchronized with the device): the
    # whole round, the inner steps of all clusters, the compressor
    round_s: List[float] = field(default_factory=list)
    inner_s: List[float] = field(default_factory=list)
    compress_s: List[float] = field(default_factory=list)


class _Timed:
    """Wraps a callable; adds its synchronized host-clock seconds to
    ``total`` (the trainer's per-round breakdown)."""

    def __init__(self, fn, device):
        self.fn, self.device, self.total = fn, device, 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, *a, **kw):
        self._sync()
        t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        self._sync()
        self.total += time.perf_counter() - t0
        return out


class _TimedCompressor:
    """Delegates to a compressor and times its ``roundtrip``."""

    def __init__(self, compressor, device):
        self._c = compressor
        self.roundtrip = _Timed(compressor.roundtrip, device)

    def __getattr__(self, name):
        return getattr(self._c, name)


def _init_inner_stacked(params, n_clusters: int) -> adamw.AdamWState:
    z = lambda: T.tree_map(
        lambda p: torch.zeros((n_clusters,) + tuple(p.shape),
                              dtype=torch.float32, device=p.device), params)
    dev = T.leaves(params)[0].device
    return adamw.AdamWState(
        step=torch.zeros((n_clusters,), dtype=torch.int32, device=dev),
        m=z(), v=z())


def _eval_loss(params, cfg, eval_batch, flash: bool = False) -> float:
    with torch.no_grad():
        return float(M.loss_fn(params, cfg, eval_batch, remat=False,
                               flash=flash)[0])


def _data_and_eval(cfg, tcfg, device, eval_batch):
    data = SyntheticLM(cfg.vocab_size, tcfg.seq_len, tcfg.local_batch,
                       seed=tcfg.seed)
    if eval_batch is None:
        eval_data = SyntheticLM(cfg.vocab_size, tcfg.seq_len, 16,
                                seed=tcfg.seed, data_shard=9999)
        eval_batch = with_frontend(eval_data.next_batch(), cfg)
    eval_batch = {k: _as_tensor(v, device) for k, v in eval_batch.items()}
    return data, eval_batch


def check_flash(cfg: ModelConfig, tcfg: TrainConfig) -> None:
    """Refuses, before the first step, a run whose attention would take
    the flash kernels at a head dim they do not instantiate."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    d = cfg.resolved_head_dim
    if tcfg.flash_attention and d not in HEAD_DIMS:
        raise NotImplementedError(
            f"{cfg.name}: flash_attention=True at head dim {d}: the flash "
            f"kernels take head dims {HEAD_DIMS} (head dim {d} is ROADMAP "
            f"B item 9); train it with flash_attention=False (einsum)")


def _init_params(cfg, tcfg, device, params):
    if params is not None:
        return params
    gen = torch.Generator(device=device)
    gen.manual_seed(tcfg.seed)
    return M.init_params(cfg, gen, device)


def run_diloco_training(cfg: ModelConfig, tcfg: TrainConfig, n_rounds: int,
                        eval_every: int = 1, *, device=None, params=None,
                        comp_state=None, batch_fn: Optional[Callable] = None,
                        eval_batch: Optional[dict] = None,
                        on_round: Optional[Callable] = None) -> RunResult:
    """Full training run; returns per-round mean train loss, eval loss on a
    held-out batch, per-round wire bytes and the time breakdown.
    ``params``/``comp_state`` (the compressor's unstacked warm starts)
    replace the port's own random draws when given; ``params`` are updated
    in place round by round. ``on_round(r, state)`` sees the state after
    each round (e.g. to check that round 0 of the delay mode left the
    params as they were). ``inner_engine="pp"`` trains the pp parameter
    tree (``parallel.pipeline``; ``params`` must then be one, e.g.
    ``pipeline.to_pp_params`` of a sequential tree) and evaluates with the
    pipelined loss on the 16-row eval batch."""
    if tcfg.inner_engine not in ("scalar", "pp"):
        raise ValueError(f"inner_engine must be 'scalar' or 'pp', got "
                         f"{tcfg.inner_engine!r}")
    pp = tcfg.inner_engine == "pp"
    check_flash(cfg, tcfg)
    if pp:
        from repro_torch.parallel import pipeline as PP
        pcfg = PP.PipelineConfig(n_stages=tcfg.pp_stages,
                                 n_micro=tcfg.pp_micro)
        PP.check_pp(cfg)
    device = resolve_device(device)
    if pp and params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(tcfg.seed)
        params = PP.init_pp_params(cfg, gen, pcfg, device)
    params = _init_params(cfg, tcfg, device, params)
    compressor = make_compressor(tcfg.compressor, **tcfg.compressor_kw)
    state = diloco.init_state(params, _init_inner_stacked(
        params, tcfg.n_clusters), tcfg.n_clusters, compressor)
    if comp_state is not None:
        state = state._replace(comp_state=T.tree_map(
            lambda x: diloco.stack_replicas(x.to(device), tcfg.n_clusters),
            comp_state))
    rcfg = diloco.RoundConfig(
        outer_lr=tcfg.outer_lr, outer_momentum=tcfg.outer_momentum,
        delay=tcfg.delay, compress=tcfg.compress,
        error_feedback=tcfg.error_feedback)
    data, eval_batch = _data_and_eval(cfg, tcfg, device, eval_batch)

    # heterogeneous local-step schedule from the configured step times
    h_by = None
    if tcfg.h_policy != "global":
        t_by = (tcfg.step_times if tcfg.step_times is not None
                else (1.0,) * tcfg.n_clusters)
        if len(t_by) != tcfg.n_clusters:
            raise ValueError(f"step_times has {len(t_by)} entries for "
                             f"{tcfg.n_clusters} clusters")
        h_map = adaptive.plan_h(
            adaptive.HSpec(policy=tcfg.h_policy, h_min=tcfg.h_min),
            tcfg.h_steps, np.asarray(t_by, float),
            np.ones(tcfg.n_clusters, bool))
        h_by = tuple(h_map[c] for c in range(tcfg.n_clusters))
    uniform = h_by is None or all(h == tcfg.h_steps for h in h_by)
    h_vec = None if uniform else h_by
    if pp:
        inner_fn = make_pp_inner_fn(cfg, tcfg, data.table, pcfg, h_vec,
                                    batch_fn=batch_fn, device=device)
        pp_loss = PP.make_pp_loss(cfg, pcfg, flash=tcfg.flash_attention)
        eval_fn = lambda p: float(pp_loss(p, eval_batch["tokens"]))
    else:
        inner_fn = make_inner_fn(cfg, tcfg, data.table, h_vec,
                                 batch_fn=batch_fn)
        eval_fn = lambda p: _eval_loss(p, cfg, eval_batch,
                                       tcfg.flash_attention)
    inner_fn = _Timed(inner_fn, device)
    timed_comp = _TimedCompressor(compressor, device)

    ada_cfg = adaptive.AdaGradCmpConfig(
        r1=getattr(compressor, "rank", 64), h1=tcfg.h_steps,
        mode=tcfg.adaptive_mode, window=tcfg.adaptive_window)
    ada_state = adaptive.AdaGradCmpState.create(ada_cfg)

    shapes = tree_shapes(params)
    res = RunResult([], [], [], [], [], 0.0)
    t0 = time.time()
    for r in range(n_rounds):
        r_exec, h_exec = ada_state.r_t, ada_state.h_t
        inner0, comp0 = inner_fn.total, timed_comp.roundtrip.total
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tr = time.perf_counter()
        state, round_losses = diloco.diloco_round(
            state, inner_fn, timed_comp, cluster_mean, rcfg, r_exec)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        res.round_s.append(time.perf_counter() - tr)
        res.inner_s.append(inner_fn.total - inner0)
        res.compress_s.append(timed_comp.roundtrip.total - comp0)
        if on_round is not None:
            on_round(r, state)
        res.losses.append(float(torch.mean(round_losses.float())))
        res.eval_losses.append(eval_fn(state.params))
        res.wire_bytes_per_round.append(
            compressor.wire_bytes(shapes, rank=r_exec if tcfg.adaptive
                                  else None)
            if tcfg.compress else
            sum(int(np.prod(s)) * 4 for s in shapes.values()))
        res.h_per_round.append(h_exec if tcfg.adaptive else tcfg.h_steps)
        res.r_per_round.append(r_exec)
        if h_by is not None:
            res.h_by_per_round.append(h_by)
        if tcfg.adaptive and tcfg.compress:
            ada_state = adaptive.observe_mean_pseudo_grad(
                ada_state, cluster_mean(state.delta_pending), ada_cfg)
    res.wall_s = time.time() - t0
    return res


def _shards(cfg, tcfg):
    """One data stream per cluster (the baselines' per-step batches)."""
    return [SyntheticLM(cfg.vocab_size, tcfg.seq_len, tcfg.local_batch,
                        seed=tcfg.seed, data_shard=i, hetero=tcfg.hetero)
            for i in range(tcfg.n_clusters)]


def _cluster_batches(data, batch_fn, step, device):
    """Each cluster's tokens for one baseline step: ``batch_fn(c, 0,
    step)`` when given, else the next batch of each shard."""
    if batch_fn is not None:
        return [_as_tensor(batch_fn(c, 0, step), device)
                for c in range(len(data))]
    return [d.next_batch()["tokens"].to(device) for d in data]


def run_allreduce_training(cfg: ModelConfig, tcfg: TrainConfig,
                           n_steps: int, *, device=None, params=None,
                           batch_fn: Optional[Callable] = None,
                           eval_batch: Optional[dict] = None) -> RunResult:
    """Vanilla synchronous AllReduce baseline: the D clusters' gradients
    are averaged every step. ``batch_fn(cluster, 0, step)`` may replace the
    per-shard streams."""
    check_flash(cfg, tcfg)
    device = resolve_device(device)
    params = _init_params(cfg, tcfg, device, params)
    opt = adamw.init(params)
    data = _shards(cfg, tcfg)
    _, eval_batch = _data_and_eval(cfg, tcfg, device, eval_batch)
    leaves = T.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    shapes = tree_shapes(params)
    wire = sum(int(np.prod(s)) * 4 for s in shapes.values())
    losses, evals = [], []
    t0 = time.time()
    for s in range(n_steps):
        toks = _cluster_batches(data, batch_fn, s, device)
        loss = sum(M.loss_fn(params, cfg, {"tokens": t},
                             flash=tcfg.flash_attention)[0]
                   for t in toks) / len(toks)
        grads = T.unflatten_like(params, list(torch.autograd.grad(loss,
                                                                  leaves)))
        params, opt = adamw.update(grads, opt, params, lr=tcfg.inner_lr)
        losses.append(float(loss.detach()))
        evals.append(_eval_loss(params, cfg, eval_batch,
                                tcfg.flash_attention))
    for p in leaves:
        p.requires_grad_(False)
    return RunResult(losses, evals, [wire] * n_steps, [1] * n_steps,
                     [0] * n_steps, time.time() - t0)


def run_compressed_ddp_training(cfg: ModelConfig, tcfg: TrainConfig,
                                n_steps: int, *, device=None, params=None,
                                comp_state=None,
                                batch_fn: Optional[Callable] = None,
                                eval_batch: Optional[dict] = None
                                ) -> RunResult:
    """CocktailSGD-style baseline: NO local training. Every step each
    cluster compresses its gradient (with error feedback), the compressed
    gradients are averaged, and one AdamW applies them."""
    check_flash(cfg, tcfg)
    device = resolve_device(device)
    params = _init_params(cfg, tcfg, device, params)
    opt = adamw.init(params)
    compressor = make_compressor(tcfg.compressor, **tcfg.compressor_kw)
    comp0 = comp_state if comp_state is not None \
        else compressor.init_state(params)
    comp_state = T.tree_map(
        lambda x: diloco.stack_replicas(_as_tensor(x, device),
                                        tcfg.n_clusters), comp0)
    error = T.tree_map(
        lambda p: torch.zeros((tcfg.n_clusters,) + tuple(p.shape),
                              dtype=torch.float32, device=device), params)
    data = _shards(cfg, tcfg)
    _, eval_batch = _data_and_eval(cfg, tcfg, device, eval_batch)
    wire = compressor.wire_bytes(tree_shapes(params))
    losses, evals = [], []
    t0 = time.time()
    for s in range(n_steps):
        toks = _cluster_batches(data, batch_fn, s, device)
        step_losses, grads = [], []
        for t in toks:
            p_req = T.tree_map(lambda x: x.detach().requires_grad_(True),
                               params)
            loss, _ = M.loss_fn(p_req, cfg, {"tokens": t},
                                flash=tcfg.flash_attention)
            grads.append(T.unflatten_like(params, list(torch.autograd.grad(
                loss, T.leaves(p_req)))))
            step_losses.append(loss.detach())
        with torch.no_grad():
            with_err = T.tree_map(lambda e, *gs: torch.stack(gs) + e, error,
                                  *grads)
            del grads
            g_hat, comp_state = diloco.per_cluster_compress(
                compressor, with_err, comp_state)
            error = T.tree_map(lambda w, gh: w - gh, with_err, g_hat)
            g_mean = cluster_mean(g_hat)
        params, opt = adamw.update(g_mean, opt, params, lr=tcfg.inner_lr)
        losses.append(float(torch.stack(step_losses).mean()))
        evals.append(_eval_loss(params, cfg, eval_batch,
                                tcfg.flash_attention))
    return RunResult(losses, evals, [wire] * n_steps, [1] * n_steps,
                     [0] * n_steps, time.time() - t0)
