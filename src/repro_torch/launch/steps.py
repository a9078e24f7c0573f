"""Mesh-level step functions (port of ``repro.launch.steps``): the inner
train step, the outer DiLoCoX step and the serving step.

Cluster semantics: params carry a leading cluster axis. In one process
that axis may hold several clusters (the stacked layout of the JAX
package); across processes each rank holds its own clusters' rows and
the clusters meet only in the outer step, whose one collective moves the
packed int4 payload (``core.mesh_compression``). Within a cluster the
(data, model) shards of ``parallel.tensor.ShardGroup`` hold blocks of
every leaf (``parallel.sharding``): each data shard takes a slice of the
cluster's batch, the model shards split each layer, and AdamW, the error
feedback and Nesterov run on the blocks. With one shard a cluster is
whole and unsharded.

The JAX functions return new trees; these update the params, the
optimizer states and the outer state in place (at opt-1.3b every copy of
the model is 5.7 GB) and return the same tensors.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core import mesh_compression as mc
from repro_torch.models import model as M
from repro_torch.optim import adamw, nesterov
from repro_torch.parallel import comm


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the clusters ``group`` (in place; ``x`` itself
    without one)."""
    if comm.size(group) > 1:
        comm.all_reduce(x, group, "clusters")
    return x


# ---------------------------------------------------------------------------
# inner train step (per cluster, a loop over the local clusters)
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, *, inner_lr: float = 1e-4,
                    per_cluster_h: bool = False, shards=None,
                    cluster_group=None, flash: bool = False):
    """``(params_stacked, opt_stacked, batch_stacked) -> (params', opt',
    loss)``: one inner AdamW step per local cluster, no cross-cluster
    collective. Clusters run one after another (the JAX package vmaps;
    a batched product sums in another order, ROADMAP A.6).

    With ``shards`` (a ``parallel.tensor.ShardGroup`` of more than one
    shard) the params and AdamW state are blocks placed by
    ``parallel.sharding.param_placements``: whole tensors whose blocks are
    views with every shard in this process, this rank's blocks otherwise.
    Each data shard takes its slice of the cluster's batch (in process:
    ``batch_stacked`` holds the whole batch), the loss and gradients come
    from ``parallel.tensor.TPLoss`` and the clip from
    ``parallel.tensor.clip_``, both summing across shards in a fixed
    order. The returned loss is the mean over all clusters (local ones,
    and those of the ``cluster_group``) of each cluster's full-batch loss.

    ``flash`` routes plain causal attention to the flash kernels
    (``models.model.make_ctx``).

    ``per_cluster_h=True`` returns ``(params, opt, batch, active) ->
    (params', opt', loss)``: ``active`` is a (C_local,) bool mask;
    inactive clusters' params and optimizer state are left untouched and
    the loss is the mean over active clusters only."""
    if shards is not None and shards.size > 1:
        one_cluster = _sharded_cluster_step(cfg, shards, inner_lr, flash)
    else:
        def one_cluster(params_row, opt_row, tokens):
            p = T.tree_map(lambda x: x.detach().requires_grad_(True),
                           params_row)
            with torch.enable_grad():
                loss, _ = M.loss_fn(p, cfg, {"tokens": tokens}, flash=flash)
                grads = list(torch.autograd.grad(loss, T.leaves(p)))
            _, opt_row = adamw.update(T.unflatten_like(p, grads), opt_row, p,
                                      lr=inner_lr)
            return opt_row.step, loss.detach().float()

    def run(params_stacked, opt_stacked, batch_stacked, active):
        tokens = batch_stacked["tokens"]
        steps, total = [], None
        n_active = 0
        for c in range(tokens.shape[0]):
            if not active[c]:
                steps.append(opt_stacked.step[c])
                continue
            opt_c = adamw.AdamWState(step=opt_stacked.step[c],
                                     m=T.tree_map(lambda x: x[c],
                                                  opt_stacked.m),
                                     v=T.tree_map(lambda x: x[c],
                                                  opt_stacked.v))
            step, loss = one_cluster(T.tree_map(lambda x: x[c],
                                                params_stacked),
                                     opt_c, tokens[c])
            steps.append(step)
            total = loss if total is None else total + loss
            n_active += 1
        dev = tokens.device
        total = torch.zeros((), device=dev) if total is None else total
        stats = all_reduce_sum(torch.stack([
            total, torch.tensor(float(n_active), device=dev)]), cluster_group)
        opt = adamw.AdamWState(step=torch.stack(steps), m=opt_stacked.m,
                               v=opt_stacked.v)
        return params_stacked, opt, stats[0] / torch.clamp(stats[1], min=1.0)

    if not per_cluster_h:
        def train_step(params_stacked, opt_stacked, batch_stacked):
            C = batch_stacked["tokens"].shape[0]
            return run(params_stacked, opt_stacked, batch_stacked, [True] * C)

        return train_step

    def train_step_h(params_stacked, opt_stacked, batch_stacked, active):
        return run(params_stacked, opt_stacked, batch_stacked,
                   [bool(a) for a in active])

    return train_step_h


def _sharded_cluster_step(cfg: ModelConfig, shards, inner_lr: float,
                          flash: bool = False):
    """One cluster row's AdamW step on blocks: ``(params_row, opt_row,
    tokens) -> (step, loss)``."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel import tensor as TP

    specs = sh.param_placements(M.init_params(cfg, device="meta"),
                                shards.mesh, cluster_stacked=False)
    loss_fn = TP.TPLoss(cfg, shards, specs, flash=flash)

    def parts(tree):
        return {k: shards.parts(x, specs[k]) for k, x in T.keystr_items(tree)}

    def one_cluster(params_row, opt_row, tokens):
        p = parts(params_row)
        n = shards.D if shards.in_process else 1
        b = tokens.shape[0] // n
        loss, grads = loss_fn.value_and_grad(
            p, [tokens[j * b:(j + 1) * b] for j in range(n)])
        grads = TP.clip_(shards, specs, TP.regroup(p, grads))
        _, st = adamw.update(
            grads, adamw.AdamWState(
                step=opt_row.step, m=TP.flat_parts(parts(opt_row.m)),
                v=TP.flat_parts(parts(opt_row.v))),
            TP.flat_parts(p), lr=inner_lr, grad_clip=0)
        return st.step, loss

    return one_cluster


def init_inner_state(params_stacked) -> adamw.AdamWState:
    """AdamW state of cluster-stacked params (the JAX driver's
    ``jax.vmap(adamw.init)``): a (C,) step counter and stacked m, v."""
    z = lambda: T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params_stacked)
    first = T.leaves(params_stacked)[0]
    return adamw.AdamWState(
        step=torch.zeros((first.shape[0],), dtype=torch.int32,
                         device=first.device), m=z(), v=z())


# ---------------------------------------------------------------------------
# outer DiLoCoX step (the cross-cluster sync)
# ---------------------------------------------------------------------------

class OuterState(NamedTuple):
    anchor: Any          # theta^{t-1} (unstacked, global)
    outer_opt: Any       # Nesterov momentum
    delta_pending: Any   # cluster-stacked pseudo-grads (previous round)
    error: Any           # cluster-stacked EF buffers
    q_state: Any         # cluster-stacked PowerSGD warm starts


def init_outer_state(params, n_clusters: int,
                     ccfg: mc.MeshCompressionConfig, q0=None) -> OuterState:
    """Round-0 outer state for ``n_clusters`` local cluster rows. The
    anchor is ``params`` itself: the outer step updates it in place.
    ``q0``: the warm starts of the whole leaves, where ``params`` are a
    shard's blocks (default: ``params``' own)."""
    stack = lambda tree: T.tree_map(
        lambda x: torch.zeros((n_clusters,) + tuple(x.shape),
                              dtype=torch.float32, device=x.device), tree)
    if q0 is None:
        q0 = mc.init_q_state(params, ccfg)
    q_stacked = T.tree_map(
        lambda x: x.unsqueeze(0).expand((n_clusters,) + tuple(x.shape))
        .clone(), q0)
    return OuterState(anchor=params, outer_opt=nesterov.init(params),
                      delta_pending=stack(params), error=stack(params),
                      q_state=q_stacked)


def init_round_state(params, n_clusters: int, ccfg: mc.MeshCompressionConfig,
                     q0=None):
    """A rank's round state from its unstacked ``params`` (whole, or its
    blocks, with ``q0`` the whole leaves' warm starts: the sharded outer
    step compresses whole leaves): (params stacked over its
    ``n_clusters`` local clusters, their AdamW state, the outer state,
    whose anchor is ``params`` themselves)."""
    from repro_torch.core import diloco

    stacked = diloco.stack_replicas(params, n_clusters)
    return (stacked, init_inner_state(stacked),
            init_outer_state(params, n_clusters, ccfg, q0=q0))


def _outer_leaf(Delta, p, a, v, d, e, *, outer_lr, outer_momentum):
    """One leaf's update from its mean Delta, in place and elementwise (so
    the same on a block as on the whole leaf)."""
    # Alg. 2 error feedback: e = delta^{t-1} - Delta^{t-1}
    torch.sub(d, Delta[None], out=e)
    # next pending: (anchor - theta_inner) + e
    torch.sub(a.float()[None], p.float(), out=d)
    d.add_(e)
    # delayed outer update on the anchor
    nesterov.update_leaf(Delta, v, a, lr=outer_lr, momentum=outer_momentum)
    # replicas restart from the outer-updated params
    p.copy_(a[None].expand_as(p))


def make_outer_step(cfg: ModelConfig, ccfg: mc.MeshCompressionConfig, *,
                    outer_lr: float = 0.7, outer_momentum: float = 0.9,
                    cluster_group=None, shards=None):
    """``(params_stacked_postH, outer_state, rank_scalar) ->
    (params_stacked_next, outer_state')``: Alg. 2's communicate + delayed
    outer update with the one-step-delay schedule.

    The local clusters' pending deltas are compressed and their payloads
    gathered over ``cluster_group`` first; then, leaf by leaf, the mean
    Delta is reconstructed and the leaf's EF buffer, pending delta,
    anchor, momentum and replicas are updated in place, so no second
    full-size tree exists at any time (the JAX function's tree-at-once
    form holds about six). ``outer_step.gather_bytes`` is the byte count
    this rank's clusters handed to the last all-gather (summed over each
    cluster's shards).

    With ``shards`` of one rank each (``parallel.tensor.ShardGroup`` with
    groups), each leaf j has one owner, group rank j mod D * M: it gathers
    the leaf's delta blocks, compresses the whole leaf with the same code
    as one shard, meets the owners of the other clusters in the clusters
    group's all-gather, reconstructs the mean and scatters each rank's
    block of it; the warm starts are broadcast from the owner. The rest is
    elementwise on the blocks. In process the leaves are whole and the
    step is the unsharded one."""
    kw = dict(outer_lr=outer_lr, outer_momentum=outer_momentum)
    if shards is not None and not shards.in_process and shards.size > 1:
        return _sharded_outer_step(cfg, ccfg, shards, cluster_group, kw)

    @torch.no_grad()
    def outer_step(params_stacked, st: OuterState, rank_scalar):
        # communicate: compress + gather LAST round's pseudo-grads
        payloads, q_new = mc.compress_local(st.delta_pending, st.q_state,
                                            rank_scalar, ccfg)
        outer_step.gather_bytes = mc.gather_bytes(payloads)
        gathered = mc.gather_payloads(payloads, cluster_group)
        del payloads
        leaves = zip(gathered, T.leaves(params_stacked), T.leaves(st.anchor),
                     T.leaves(st.outer_opt.momentum),
                     T.leaves(st.delta_pending), T.leaves(st.error),
                     T.leaves(st.q_state))
        for rows, p, a, v, d, e, q in leaves:
            Delta = mc.decompress_mean_leaf(rows, a.shape, mc.factor_width(q),
                                            ccfg).to(d.dtype)
            _outer_leaf(Delta, p, a, v, d, e, **kw)
            del Delta
        outer_opt = nesterov.NesterovState(step=st.outer_opt.step + 1,
                                           momentum=st.outer_opt.momentum)
        return params_stacked, OuterState(
            anchor=st.anchor, outer_opt=outer_opt,
            delta_pending=st.delta_pending, error=st.error, q_state=q_new)

    outer_step.gather_bytes = 0
    return outer_step


def _sharded_outer_step(cfg, ccfg, shards, cluster_group, kw):
    from repro_torch.parallel import sharding as sh

    specs = list(sh.param_placements(M.init_params(cfg, device="meta"),
                                     shards.mesh,
                                     cluster_stacked=False).values())

    @torch.no_grad()
    def outer_step(params_stacked, st: OuterState, rank_scalar):
        n, me = shards.size, shards.index
        leaves = list(zip(specs, T.leaves(params_stacked), T.leaves(st.anchor),
                          T.leaves(st.outer_opt.momentum),
                          T.leaves(st.delta_pending), T.leaves(st.error),
                          T.leaves(st.q_state)))
        payloads = []
        for j, (spec, p, a, v, d, e, q) in enumerate(leaves):
            whole = shards.gather_to(j % n, d, (None,) + spec)
            if whole is not None:
                pay, (q_new,) = mc.compress_local([whole], [q], rank_scalar,
                                                  ccfg)
                q.copy_(q_new)
                payloads.append(pay[0])
            del whole
        outer_step.gather_bytes = shards.sum_int(mc.gather_bytes(payloads),
                                                 leaves[0][2].device)
        gathered = iter(mc.gather_payloads(payloads, cluster_group)
                        if payloads else [])
        del payloads
        for j, (spec, p, a, v, d, e, q) in enumerate(leaves):
            owner = j % n
            shards.broadcast_from(owner, q)
            Delta = None
            if owner == me:
                Delta = mc.decompress_mean_leaf(
                    next(gathered), shards.whole_shape(a.shape, spec),
                    mc.factor_width(q), ccfg).to(d.dtype)
            Delta = shards.scatter_from(owner, Delta, spec, like=d[0])
            _outer_leaf(Delta, p, a, v, d, e, **kw)
            del Delta
        outer_opt = nesterov.NesterovState(step=st.outer_opt.step + 1,
                                           momentum=st.outer_opt.momentum)
        return params_stacked, st._replace(outer_opt=outer_opt)

    outer_step.gather_bytes = 0
    return outer_step


# ---------------------------------------------------------------------------
# serving steps (no cluster dim)
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig):
    """Forward over the full sequence, returns the last position's logits
    (B, V) (the inference-prefill workload). ``parallel.tensor.TPLoss.
    prefill`` is its sharded form."""

    @torch.no_grad()
    def prefill_step(params, batch):
        h, _ = M.forward_hidden(params, cfg, batch, remat=True)
        return M.logits_fn(params, cfg, h[:, -1:])[:, 0]

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, eos_id: Optional[int] = None,
                    tp=None):
    """One decode step: token + caches -> next token (greedy) + caches.
    With ``tp`` (a ``parallel.tensor.TPDecode``) ``params`` is the local
    model shards' blocks and ``state`` ``tp.init_decode_state``'s.

    With ``eos_id`` set the returned function takes and returns a
    per-sequence ``finished`` bool mask: rows already finished keep
    emitting ``eos_id`` (so everything past the first EOS is masked in
    the decoded output) and the mask absorbs rows whose new token is EOS.
    Callers must reset the mask across prefill-by-decode steps — those
    outputs are prompt-forced and must not trip EOS."""

    def serve_step(params, state, tokens):
        if tp is not None:
            return tp.decode_next(params, state, tokens)
        logits, state = M.decode_step(params, cfg, state, tokens)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, state

    if eos_id is None:
        return serve_step

    def serve_step_eos(params, state, tokens, finished):
        nxt, state = serve_step(params, state, tokens)
        nxt = torch.where(finished[:, None],
                          torch.full_like(nxt, eos_id), nxt)
        finished = finished | (nxt[:, 0] == eos_id)
        return nxt, state, finished

    return serve_step_eos


# ---------------------------------------------------------------------------
# input and state specs: ``meta`` trees (no allocation), the JAX package's
# ShapeDtypeStruct stand-ins
# ---------------------------------------------------------------------------

META = torch.device("meta")


def input_specs(cfg: ModelConfig, shape, *, n_clusters: int = 1
                ) -> Dict[str, torch.Tensor]:
    """The model inputs of this (arch, ``configs.base.ShapeConfig``):
    training tokens (n_clusters, B / n_clusters, S), prefill tokens
    (B, S), decode tokens (B, 1), int32."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if B % n_clusters:
            raise ValueError(f"batch {B} over {n_clusters} clusters")
        dims = (n_clusters, B // n_clusters, S)
    elif shape.kind == "prefill":
        dims = (B, S)
    else:
        dims = (B, 1)
    return {"tokens": torch.empty(dims, dtype=torch.int32, device=META)}


def decode_state_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    """``models.model.init_decode_state`` at the shape's batch and length,
    in the compute dtype, its index an int32 scalar."""
    st = M.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                             device=META,
                             dtype=torch_dtype(cfg.compute_dtype))
    st["index"] = torch.zeros((), dtype=torch.int32, device=META)
    return st


def params_specs(cfg: ModelConfig, *, n_clusters: int = 0):
    """``init_params`` on ``meta`` (cluster-stacked with ``n_clusters``)."""
    p = M.init_params(cfg, device=META)
    if n_clusters:
        p = T.tree_map(lambda x: x.new_empty((n_clusters,) + tuple(x.shape)),
                       p)
    return p


def opt_specs(params_stacked_specs) -> adamw.AdamWState:
    """Per-cluster step counters (C,) and stacked f32 m, v."""
    return init_inner_state(params_stacked_specs)


def outer_state_specs(cfg: ModelConfig, n_clusters: int,
                      ccfg: mc.MeshCompressionConfig) -> OuterState:
    """``init_outer_state`` of the unstacked params, on ``meta``."""
    p = params_specs(cfg)
    return init_outer_state(p, n_clusters, ccfg)
