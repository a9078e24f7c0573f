"""The pipeline-parallel inner engine (port of
``repro.parallel.inner_engine``): one cluster's H inner AdamW steps
through ``parallel.pipeline``'s GPipe loss, the round state in one tree
with one placement rule, and the pseudo-gradient handed to the outer
compress/mix layer.

The paper's 107B-over-1-Gbps result rests on Pipeline Parallelism inside
each cluster (§2.2) with the Dual Optimizer and the one-step-delay overlap
on top. The JAX package runs the stages on faked devices of one process
(``unit_mesh``) or on a cluster-stacked mesh (``launch/train.py --inner
pp``). Here the stages run in this process (``pipeline.InProcess``, the
counterpart of ``unit_mesh``: the trainer) or one per rank
(``pipeline.StageGroup``: the mesh driver), with the same schedule and
the same bits.

State is a ``DiLoCoTrainState``: params, inner AdamW moments, outer
Nesterov momentum and EF residual, placed by one rule
(``state_shardings``: the stage dim split over the "model" group, the
rest replicated), so a process holding some stages holds their rows of
every param-shaped leaf (``shard_train_state``).

Numerics: pp ≡ sequential model to the pipeline-equivalence tolerance,
not bitwise (another op schedule: microbatches, chunked CE, per-stage
recompute); ranks ≡ in-process bit for bit.

Updates are in place, as everywhere in the port: the returned params and
optimizer state are the given tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core import diloco
from repro_torch.optim import adamw, nesterov
from repro_torch.parallel import comm
from repro_torch.parallel import pipeline as PP


class DiLoCoTrainState(NamedTuple):
    """One cluster's full DiLoCoX round state as a single tree. ``params``
    is the local (inner-loop) replica; the outer anchor is passed to
    ``extract_delta`` separately (in the one-step-delay round it is the
    outer layer's, not the engine's)."""
    params: Any        # pp param tree {"embed","final_norm","stages",
                       #   "active"[,"head"]}; stages: (n_stages, lps, ...)
    inner_opt: Any     # adamw.AdamWState, moments placed like the params
    outer_opt: Any     # nesterov.NesterovState, f32 momentum
    error: Any         # EF residual, f32, param-shaped


# ---------------------------------------------------------------------------
# placement + state construction
# ---------------------------------------------------------------------------

def init_train_state(cfg: ModelConfig, pcfg: PP.PipelineConfig,
                     generator=None, device=None) -> DiLoCoTrainState:
    """Round-0 state for one cluster (unstacked): moments, the outer
    momentum and the EF residual at zero."""
    params = PP.init_pp_params(cfg, generator, pcfg, device)
    return DiLoCoTrainState(
        params=params, inner_opt=adamw.init(params),
        outer_opt=nesterov.init(params),
        error=T.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                         params))


def state_shardings(state: DiLoCoTrainState) -> Dict[str, Tuple]:
    """The placement of every leaf of one cluster's state, by keystr: the
    params and every param-shaped companion (AdamW m and v, Nesterov
    momentum, EF residual) by ``pipeline.pp_param_specs``, the step
    counters replicated."""
    return PP.pp_param_specs(state)


def shard_train_state(state: DiLoCoTrainState, start: int,
                      stop: int) -> DiLoCoTrainState:
    """Copies of the rows of stages ``[start, stop)`` of every leaf that
    ``state_shardings`` splits by stage (``pipeline.stage_slice``), and of
    the rest whole: the state a process holding those stages keeps."""
    return T.tree_map(torch.clone, PP.stage_slice(state, start, stop))


# ---------------------------------------------------------------------------
# delta extraction (the outer-layer boundary)
# ---------------------------------------------------------------------------

def delta_leaf(path: str, anchor, params, error, out=None):
    """One leaf of ``extract_delta``: δ = (θ_anchor − θ_local) + e in f32
    (``core.diloco.pseudo_grad``'s arithmetic), into ``out`` when given
    (``anchor`` may broadcast over stacked ``params``). The ``active``
    mask is not trainable: its delta is pinned to exactly zero, so it
    stays zero through compression and its outer momentum never moves."""
    if out is None:
        out = torch.empty(torch.broadcast_shapes(anchor.shape, params.shape),
                          dtype=torch.float32, device=params.device)
    if path == "['active']":
        return out.zero_()
    torch.sub(anchor.float(), params.float(), out=out)
    return out.add_(error)


def extract_delta(anchor, state: DiLoCoTrainState):
    """Per-cluster pseudo-gradient, leaf by leaf (``delta_leaf``)."""
    return T.unflatten_like(anchor, [
        delta_leaf(k, a, p, e) for (k, a), p, e in zip(
            T.keystr_items(anchor), T.leaves(state.params),
            T.leaves(state.error))])


def apply_delta(anchor, delta, error=None):
    """Inverse of ``extract_delta`` up to f32 rounding: θ_local = θ_anchor
    − (δ − e), the ``active`` mask carried from the anchor. Not bitwise:
    ``a − (a − p)`` re-rounds unless Sterbenz applies."""
    if error is None:
        error = T.tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                           anchor)
    local = dict(T.tree_map(
        lambda a, d, e: (a.float() - (d - e)).to(a.dtype), anchor, delta,
        error))
    local["active"] = anchor["active"]
    return local


# ---------------------------------------------------------------------------
# the inner step / inner loop
# ---------------------------------------------------------------------------

def _clip(grads, transport, grad_clip: float = 1.0):
    """AdamW's global-norm clip over the whole cluster tree: the
    replicated leaves' squares (every stage holds them) plus each stage's
    part, summed in stage order on every rank. Returns the clipped tree
    (``adamw.scaled``)."""
    rep, stage = [], []
    for k, g in T.keystr_items(grads):
        if k.startswith("['stages']"):
            stage.append(g)
        elif not PP.is_stage_path(k):
            rep.append(g)

    def sq(gs):
        total = None
        for g in gs:
            s = torch.sum(torch.square(g.float()))
            total = s if total is None else total + s
        return total

    total = sq(rep)
    for part in transport.stage_scalars(
            [sq([g[i] for g in stage]) for i in range(len(transport.stages))]):
        total = total + part
    scale = torch.clamp(grad_clip / torch.sqrt(total + 1e-16), max=1.0)
    return T.tree_map(lambda g: adamw.scaled(g, scale), grads)


def _trainable(tree):
    return {k: v for k, v in tree.items() if k != "active"}


def make_pp_train_step(cfg: ModelConfig, pcfg: PP.PipelineConfig, *,
                       inner_lr: float, flash: bool = False, transport=None,
                       data_group=None, cluster_stacked: bool = False
                       ) -> Callable:
    """One inner AdamW step through the pipelined loss: ``train_step(
    params, opt, tokens) -> (params, opt, loss)``, in place. The ``active``
    mask gets no update (the JAX step zeroes its gradient and carries the
    mask; its m and v stay zero either way). With a ``data_group`` each
    rank holds a slice of the cluster's batch and the gradients and loss
    are averaged over the group before the clip. Cluster-stacked, each
    cluster row is stepped in turn with its own clip and the loss is the
    sum over clusters."""
    loss_fn = PP.make_pp_loss(cfg, pcfg, flash=flash, transport=transport)
    tr = loss_fn.transport
    n_data = comm.size(data_group)

    def one(params, opt, tokens):
        loss, grads = loss_fn.value_and_grad(params, tokens)
        if n_data > 1:
            for g in T.leaves(grads):
                comm.all_reduce(g, data_group, "data")
                g.div_(n_data)
            loss = comm.all_reduce(loss.clone(), data_group, "data")
            loss = loss / n_data
        grads = _clip(grads, tr)
        _, st = adamw.update(_trainable(grads), adamw.AdamWState(
            step=opt.step, m=_trainable(opt.m), v=_trainable(opt.v)),
            _trainable(params), lr=inner_lr, grad_clip=0)
        return params, adamw.AdamWState(step=st.step, m=opt.m, v=opt.v), loss

    if not cluster_stacked:
        return one

    def train_step(params, opt, tokens):
        steps, total = [], None
        for c in range(tokens.shape[0]):
            _, o, loss = one(diloco.take_row(params, c), adamw.AdamWState(
                step=opt.step[c], m=diloco.take_row(opt.m, c),
                v=diloco.take_row(opt.v, c)), tokens[c])
            steps.append(o.step)
            total = loss if total is None else total + loss
        return params, adamw.AdamWState(step=torch.stack(steps), m=opt.m,
                                        v=opt.v), total

    return train_step


def make_pp_one_cluster(cfg: ModelConfig, pcfg: PP.PipelineConfig, *,
                        inner_lr: float, h_steps: int, batch_fn: Callable,
                        flash: bool = False) -> Tuple[Callable, Callable]:
    """Per-cluster H-step inner loops, every stage in this process.
    ``batch_fn(c, t, i) -> tokens (B, S)`` for cluster ``c``, round ``t``
    and inner step ``i`` (the JAX function's data is round-invariant and
    takes no ``t``). Returns ``(one_cluster, one_cluster_h)``:
      one_cluster(params, opt, c, t)      -> (params_H, opt', losses (H,))
      one_cluster_h(params, opt, c, t, h) -> (params_H, opt', mean_loss)
    the second running only the first ``h`` steps
    (``diloco.masked_local_steps``)."""
    train_step = make_pp_train_step(cfg, pcfg, inner_lr=inner_lr,
                                    flash=flash)

    def step_body(carry, i, c, t):
        params, opt = carry
        params, opt, loss = train_step(params, opt, batch_fn(c, t, i))
        return (params, opt), loss.detach()

    def one_cluster(params, opt, c, t):
        carry, losses = (params, opt), []
        for i in range(h_steps):
            carry, loss = step_body(carry, i, c, t)
            losses.append(loss)
        return carry[0], carry[1], torch.stack(losses).float().cpu()

    def one_cluster_h(params, opt, c, t, h):
        (params, opt), mean = diloco.masked_local_steps(
            lambda carry, i: step_body(carry, i, c, t), (params, opt),
            h_steps, h)
        return params, opt, mean

    return one_cluster, one_cluster_h


def make_pp_inner_fns(one_cluster: Callable, one_cluster_h: Callable,
                      n_clusters: int) -> Tuple[Callable, Callable]:
    """The per-cluster loops lifted to ``inner_fn(params, inner_opt_stacked,
    round_idx) -> (params_stacked, opt_stacked, aux)`` (and ``inner_fn_h``
    with a per-cluster step count vector) by unrolling over clusters, one
    after another, never batched: each cluster runs the same op sequence
    a lone worker runs. Each cluster starts from a copy of ``params`` and
    updates its own rows of the stacked tensors; ``aux`` is the (C, H)
    losses, or with ``inner_fn_h`` the (C,) per-cluster means."""

    def run(params, opt_stacked, call):
        params_s = diloco.stack_replicas(params, n_clusters)
        steps, aux = [], []
        for c in range(n_clusters):
            _, o, a = call(diloco.take_row(params_s, c), adamw.AdamWState(
                step=opt_stacked.step[c], m=diloco.take_row(opt_stacked.m, c),
                v=diloco.take_row(opt_stacked.v, c)), c)
            steps.append(o.step)
            aux.append(a)
        return params_s, adamw.AdamWState(
            step=torch.stack(steps), m=opt_stacked.m,
            v=opt_stacked.v), torch.stack(aux)

    def inner_fn(params, opt_stacked, t):
        return run(params, opt_stacked,
                   lambda p, o, c: one_cluster(p, o, c, int(t)))

    def inner_fn_h(params, opt_stacked, t, h_vec):
        return run(params, opt_stacked,
                   lambda p, o, c: one_cluster_h(p, o, c, int(t), h_vec[c]))

    return inner_fn, inner_fn_h
