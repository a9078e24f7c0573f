"""DiLoCoX round state machine (port of ``repro.core.diloco``, paper Alg. 2).

The algorithm, independent of how clusters are realised: ``cluster_mean``
is injected (a stacked-axis mean on one card, the membership-masked mean of
``core.membership``, or a neighbor gossip mix from
``repro_torch.topology.mixing``).

 - Dual optimizer: inner AdamW for H local steps, outer Nesterov on the
   averaged pseudo-gradients (§2.2). Inner state persists across rounds.
 - One-step-delay overlap (§2.3): round t averages delta^{t-1}, and the
   outer update at the end of round t applies the delayed Delta^{t-1}.
   Round 0 applies Delta = 0 exactly.
 - Error feedback (Alg. 2): e^t = delta^{t-1} - Delta^{t-1}
   (``error_vs_own=True``: classic e = delta - C(delta)).
 - Compression: any ``core.compression.Compressor``.
 - Gossip topologies: when the injected averaging op is tagged
   ``returns_stacked=True`` (``topology.mixing.mixing_op``) the round runs
   in *gossip mode*: ``state.params`` carries one row per cluster
   (``init_state(..., stacked_params=True)``), each cluster averages
   compressed pseudo-gradients over its graph neighborhood only, EF is
   the classic ``delta - C(delta)``, and the outer Nesterov update applies
   row-wise.

Cluster-stacked trees carry a leading (C,) dim, as in the JAX package, so
the state bridges 1:1 (``checkpoint.state_to_flat``).

Memory: the JAX round returns new trees. At opt-1.3b width each copy of
the model is 3.2 GB, so ``diloco_round`` reuses the state's buffers: the
EF buffers, the pending deltas and the params/outer momentum are written
in place, and the returned state holds the same tensors. A caller that
needs an earlier state copies it first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.compression import Compressor
from repro_torch.optim import nesterov


class DiLoCoXState(NamedTuple):
    params: Any               # global params theta_t (post outer updates);
                              # gossip mode: one row per cluster (stacked)
    inner_opt: Any            # per-cluster inner AdamW state (stacked)
    outer_opt: Any            # outer Nesterov state (fp32, param-shaped;
                              # gossip mode: stacked like params)
    delta_pending: Any        # per-cluster pseudo-grads awaiting averaging
    error: Any                # per-cluster error-feedback buffers
    comp_state: Any           # compressor warm starts (per cluster)
    t: torch.Tensor           # outer step, int32 ()


def take_row(tree: Any, c: int) -> Any:
    """Cluster c's slice (a view) of a cluster-stacked tree (non-tensors
    and 0-d tensors pass through)."""
    return T.tree_map(
        lambda x: x[c] if isinstance(x, torch.Tensor) and x.dim() >= 1
        else x, tree)


def stack_replicas(tree: Any, n_clusters: int) -> Any:
    """An unstacked tree broadcast to one identical row per cluster (also
    the gossip-mode initial params: every cluster starts from the same
    ones)."""
    return T.tree_map(
        lambda x: x.unsqueeze(0).expand((n_clusters,) + tuple(x.shape))
        .clone(), tree)


def init_state(params, inner_opt_state, n_clusters: int,
               compressor: Compressor, *,
               stacked_params: bool = False) -> DiLoCoXState:
    """Round-0 state. ``stacked_params=True`` is gossip mode: ``params``
    already carries the (n_clusters, ...) leading axis (see
    ``stack_replicas``) and the outer optimizer state is stacked with it;
    the compressor's warm start comes from row 0."""
    dev = T.leaves(params)[0].device
    if stacked_params:
        n = T.leaves(params)[0].shape[0]
        if n != n_clusters:
            raise ValueError(f"stacked params lead dim {n} != "
                             f"n_clusters {n_clusters}")
        lead = ()
        comp0 = compressor.init_state(take_row(params, 0))
    else:
        lead = (n_clusters,)
        comp0 = compressor.init_state(params)
    buf = lambda: T.tree_map(
        lambda x: torch.zeros(lead + tuple(x.shape), dtype=torch.float32,
                              device=dev), params)
    return DiLoCoXState(
        params=params,
        inner_opt=inner_opt_state,
        outer_opt=nesterov.init(params),
        delta_pending=buf(),
        error=buf(),
        comp_state=T.tree_map(
            lambda x: stack_replicas(x, n_clusters)
            if isinstance(x, torch.Tensor) else x, comp0),
        t=torch.zeros((), dtype=torch.int32, device=dev),
    )


@dataclass
class RoundConfig:
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    delay: bool = True            # one-step-delay overlap (§2.3)
    compress: bool = True
    error_feedback: bool = True
    error_vs_own: bool = False    # classic EF instead of Alg. 2's variant


def per_cluster_compress(compressor: Compressor, stacked_tree, comp_state,
                         rank_scalar=None):
    """Compress each cluster's row with an unrolled per-cluster loop, as
    the JAX package does instead of ``vmap``: a real cluster compresses its
    own delta with plain matrix products, and a batched product sums in
    another order (~1 ulp in the warm start). No batched GEMM over
    clusters here either. Each cluster's result is copied into a
    preallocated stacked tree at once, so only one cluster's
    reconstruction exists unstacked. ``rank_scalar``: one rank, or a (C,)
    per-cluster sequence."""
    n = T.leaves(stacked_tree)[0].shape[0]
    per_cluster_rank = isinstance(rank_scalar, (list, tuple)) or (
        isinstance(rank_scalar, torch.Tensor) and rank_scalar.dim() >= 1)
    hats = T.tree_map(torch.empty_like, stacked_tree)
    states = []
    for c in range(n):
        r_c = rank_scalar[c] if per_cluster_rank else rank_scalar
        hat, st = compressor.roundtrip(take_row(stacked_tree, c),
                                       take_row(comp_state, c), r_c)
        T.tree_map(lambda dst, src: dst.copy_(src), take_row(hats, c), hat)
        del hat
        states.append(st)
    return hats, T.tree_map(lambda *xs: torch.stack(xs), *states)


def masked_local_steps(step_fn, carry, h_max: int, h):
    """Run the first ``h`` of ``h_max`` local steps. ``step_fn(carry, i) ->
    (carry', loss)``. The JAX function traces all ``h_max`` steps and
    discards the tail with a select; eagerly the tail is simply not run,
    which leaves the same carry. Returns ``(carry, mean_loss)`` over the
    ``h`` steps applied."""
    h = int(h)
    total = torch.zeros((), dtype=torch.float32)
    for i in range(min(h, h_max)):
        carry, loss = step_fn(carry, i)
        total = total + loss.detach().float().cpu()
    return carry, total / max(h, 1)


def _per_cluster_view(Delta, gossip: bool):
    """Delta as one row per cluster: gossip mixes already return stacked
    rows; the gather mean is broadcast (a view)."""
    if gossip:
        return Delta
    return T.tree_map(lambda D: D[None], Delta)


def _error_feedback(cfg: RoundConfig, delta_ref, delta_hat, Delta_rows,
                    error_buf, gossip: bool):
    """Alg. 2 EF ``e = delta - Delta`` or classic ``e = delta - C(delta)``
    (``error_vs_own``, and always under gossip: Alg. 2's form telescopes
    only when Delta is the global mean, and under a partial neighborhood
    mix it re-injects the ``(I - W) delta`` deviation every round), written
    into ``error_buf`` in place."""
    with torch.no_grad():
        if not cfg.error_feedback:
            T.tree_map(lambda e: e.zero_(), error_buf)
        elif cfg.error_vs_own or gossip:
            T.tree_map(lambda e, d, dh: torch.sub(d, dh, out=e), error_buf,
                       delta_ref, delta_hat)
        else:
            T.tree_map(lambda e, d, D: torch.sub(d, D, out=e), error_buf,
                       delta_ref, Delta_rows)
    return error_buf


def pseudo_grad(anchor, params_local, error=None):
    """Single-cluster pseudo-gradient delta = (theta_anchor - theta_local)
    + e, f32, no cluster axis."""
    if error is None:
        return T.tree_map(lambda a, p: a.float() - p.float(), anchor,
                          params_local)
    return T.tree_map(lambda a, p, e: (a.float() - p.float()) + e, anchor,
                      params_local, error)


@torch.no_grad()
def _pseudo_grad(anchor, params_inner, err, gossip: bool, out):
    """delta = (theta_anchor - theta_local) + e per cluster, in f32 as
    JAX's, written into ``out`` (the round's f32 pending buffers, which no
    longer hold anything the round needs); returns ``out``."""
    def one(a, p, e, o):
        a = a.float() if gossip else a.float()[None]
        torch.sub(a, p.float(), out=o)
        return o.add_(e)
    return T.tree_map(one, anchor, params_inner, err, out)


def staleness_weights(base_w, staleness, max_staleness: int):
    """Alg. 2 outer-step mixing weights under bounded staleness (host
    numpy, copied from the JAX package).

    ``base_w``: (C,) push-sum / neighborhood weights of the committing
    cluster (a ``topology.mixing.async_mix_weights`` row); ``staleness``:
    (C,) int rounds-stale of each peer's freshest published delta (< 0:
    none usable). A delta ``s`` rounds old is discounted by ``1/(1+s)``;
    beyond ``max_staleness`` (or unpublished, or outside the
    neighborhood) its weight is exactly 0. The result feeds
    ``membership.masked_cluster_mean`` as a float mask, whose
    sum-normalization is the push-sum ``x/phi`` debiasing."""
    w = np.asarray(base_w, np.float64).copy()
    s = np.asarray(staleness, np.int64)
    ok = (s >= 0) & (s <= int(max_staleness))
    w = np.where(ok, w / (1.0 + np.maximum(s, 0)), 0.0)
    return w.astype(np.float32)


def diloco_round(state: DiLoCoXState,
                 inner_fn: Callable,     # (params, inner_opt, round_idx)
                                         #   -> (params_H stacked,
                                         #       inner_opt', aux)
                 compressor: Compressor,
                 cluster_mean: Callable,  # stacked tree -> mean tree, or
                                          # (returns_stacked=True) a
                                          # stacked gossip mix
                 cfg: RoundConfig,
                 rank_scalar=None):
    """One outer round (H inner steps + the outer step). Returns
    (new_state, aux), aux from ``inner_fn`` (e.g. losses).

    A ``cluster_mean`` tagged ``returns_stacked=True`` (from
    ``topology.mixing.mixing_op``) is a neighbor gossip mix, and the state
    must come from ``init_state(..., stacked_params=True)``. The mix must
    return a new stacked tree (``mix_stacked`` does): the round overwrites
    the pending deltas it was given."""
    anchor = state.params
    gossip = bool(getattr(cluster_mean, "returns_stacked", False))
    stacked = (T.leaves(anchor)[0].shape
               == T.leaves(state.delta_pending)[0].shape)
    if gossip != stacked:
        raise ValueError(
            "gossip mixing needs stacked params (init_state(..., "
            "stacked_params=True)) and a gather mean unstacked ones; got "
            f"returns_stacked={gossip} with "
            f"{'stacked' if stacked else 'unstacked'} params")

    if cfg.delay:
        # communication: average LAST round's pseudo-grads
        if cfg.compress:
            delta_hat, comp_state = per_cluster_compress(
                compressor, state.delta_pending, state.comp_state,
                rank_scalar)
        else:
            delta_hat, comp_state = state.delta_pending, state.comp_state
        Delta = cluster_mean(delta_hat)
        Delta_rows = _per_cluster_view(Delta, gossip)
        err = _error_feedback(cfg, state.delta_pending, delta_hat,
                              Delta_rows, state.error, gossip)
        del delta_hat, Delta_rows

        # training: H local steps from the current params
        params_inner, inner_opt, aux = inner_fn(state.params,
                                                state.inner_opt, state.t)

        # join: next round's pending pseudo-grads (+ error compensation),
        # over last round's, which were compressed and fed the EF above
        delta_new = _pseudo_grad(anchor, params_inner, err, gossip,
                                 state.delta_pending)

        # delayed outer update on the anchor; round 0 applies Delta == 0
        params_new, outer_opt = nesterov.update(
            Delta, state.outer_opt, anchor,
            lr=cfg.outer_lr, momentum=cfg.outer_momentum)
    else:
        # synchronous DiLoCo: train, then average THIS round's deltas
        params_inner, inner_opt, aux = inner_fn(state.params,
                                                state.inner_opt, state.t)
        delta_raw = _pseudo_grad(anchor, params_inner, state.error, gossip,
                                 state.delta_pending)
        if cfg.compress:
            delta_hat, comp_state = per_cluster_compress(
                compressor, delta_raw, state.comp_state, rank_scalar)
        else:
            delta_hat, comp_state = delta_raw, state.comp_state
        Delta = cluster_mean(delta_hat)
        Delta_rows = _per_cluster_view(Delta, gossip)
        err = _error_feedback(cfg, delta_raw, delta_hat, Delta_rows,
                              state.error, gossip)
        del delta_hat, Delta_rows, delta_raw
        with torch.no_grad():     # pending stays zero; error carries on
            delta_new = T.tree_map(lambda x: x.zero_(), state.delta_pending)
        params_new, outer_opt = nesterov.update(
            Delta, state.outer_opt, anchor,
            lr=cfg.outer_lr, momentum=cfg.outer_momentum)

    return DiLoCoXState(
        params=params_new, inner_opt=inner_opt, outer_opt=outer_opt,
        delta_pending=delta_new, error=err, comp_state=comp_state,
        t=state.t + 1), aux


def diloco_round_h(state: DiLoCoXState,
                   inner_fn_h: Callable,    # (params, inner_opt, round_idx,
                                            #   h_vec) -> (params_H, opt',
                                            #   aux)
                   compressor: Compressor,
                   cluster_mean: Callable,
                   cfg: RoundConfig,
                   h_vec,                   # (n_clusters,) local-step
                                            # counts, one per cluster row
                   rank_scalar=None):
    """Per-cluster-H round: ``diloco_round`` with an inner function that
    receives a per-cluster local-step vector (cluster c runs the first
    ``h_vec[c]`` steps; see ``masked_local_steps``). A uniform ``h_vec``
    through the same ``inner_fn_h`` is bit for bit the scalar-H round; the
    schedule comes from ``core.adaptive.plan_h``."""
    inner = lambda params, inner_opt, t: inner_fn_h(params, inner_opt, t,
                                                    h_vec)
    return diloco_round(state, inner, compressor, cluster_mean, cfg,
                        rank_scalar)
