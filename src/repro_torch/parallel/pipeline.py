"""Pipeline parallelism (port of ``repro.parallel.pipeline``, the paper's
§2.2 Mode B): GPipe stages of a uniform decoder stack.

Each stage holds ``layers_per_stage`` stacked decoder layers; microbatches
flow stage to stage. The JAX package runs the loop as a ``shard_map`` over
the "model" axis with ``lax.ppermute`` handoffs and differentiates through
it. Here the schedule is written out, as torch's own GPipe schedule does:
every microbatch forward through the stage (no grad; the stage's input
kept), then every microbatch backward in reverse order, each one
recomputing its stage (the JAX package's ``jax.checkpoint`` of the stage)
and calling ``torch.autograd.grad`` with the gradient from the next stage.
Activations are sent forward and their gradients backward explicitly, so
no rank depends on autograd running a communication op's backward. The
bubble ticks that the JAX loop computes and discards never reach the loss
and are not run.

One schedule, two transports for the handoff (the ``ppermute``):
``InProcess`` (every stage in this process: the trainer, and the mesh
driver with no process group) and ``StageGroup`` (one stage per rank of a
process group: point-to-point sends, NCCL on the card, gloo on the CPU).
The two give the same bits: each stage accumulates its gradients over the
microbatches in the same order, and the replicated leaves' gradients are
summed over stages in a way every order of which is exact (see
``InProcess.reduce_replicated``).

Scope: uniform decoder-only stacks (the dense family, no ``global_every``;
gemma3-1b is refused), as in the JAX package.

Layer padding: n_layers is padded up to a multiple of n_stages; padded
slots carry an ``active`` flag of 0 and pass activations through
(``y * a + x * (1 - a)``), so their parameters get exactly zero gradient.

Parameters: ``{"embed","final_norm","stages","active"[,"head"]}``;
``stages`` leaves are ``(n_stages, layers_per_stage, ...)`` and ``active``
is the float (n_stages, layers_per_stage) mask. The placement rule
(``pp_param_specs``): leaves under ``stages`` and ``active`` are split by
stage; ``embed``, ``final_norm`` and ``head`` live on every stage, and
their gradients are the sums of the stages' contributions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import model as M
from repro_torch.models.layers import dense_init, embed_init, init_norm
from repro_torch.parallel import comm

REPLICATED = ("embed", "final_norm", "head")
AXIS = "model"          # the mesh axis that holds a cluster's stages


@dataclass(frozen=True)
class PipelineConfig:
    n_stages: int = 4
    n_micro: int = 16             # microbatches per (cluster, data) column


def layers_per_stage(cfg: ModelConfig, pcfg: PipelineConfig
                     ) -> Tuple[int, int]:
    lps = math.ceil(cfg.n_layers / pcfg.n_stages)
    pad = lps * pcfg.n_stages - cfg.n_layers
    return lps, pad


def check_pp(cfg: ModelConfig) -> None:
    """The JAX package's scope for Mode B: uniform decoder stacks."""
    if cfg.family not in ("dense", "vlm") or cfg.global_every:
        raise ValueError(
            f"{cfg.name}: the pipeline-parallel engine takes uniform decoder "
            f"stacks (dense or vlm family, no global_every); got family "
            f"{cfg.family!r}, global_every {cfg.global_every}")


# ---------------------------------------------------------------------------
# params and their placement
# ---------------------------------------------------------------------------

def init_pp_params(cfg: ModelConfig, generator, pcfg: PipelineConfig,
                   device=None) -> Dict[str, Any]:
    """The pp parameter tree, drawn with the port's initializers (another
    random stream than the JAX package's). ``device="meta"`` (no
    generator) gives the shapes without allocating."""
    check_pp(cfg)
    dt = torch_dtype(cfg.param_dtype)
    lps, _ = layers_per_stage(cfg, pcfg)
    n = pcfg.n_stages
    seg = M.build_segments(cfg)[0]          # uniform => single segment
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype=dt,
                            device=device),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype=dt,
                                device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                    dtype=dt, device=device)
    units = seg.init_unit(generator, n * lps, device)
    params["stages"] = T.tree_map(
        lambda x: x.reshape((n, lps) + tuple(x.shape[1:])), units)
    # float mask (not bool), as in the JAX tree; padded slots contribute
    # exactly zero gradient through the lerp in the stage
    params["active"] = (torch.arange(n * lps, device=device)
                        < cfg.n_layers).reshape(n, lps).float()
    return params


def is_stage_path(path: str) -> bool:
    """Whether a leaf (by its keystr path) has a stage dim."""
    return "['stages']" in path or "['active']" in path


def pp_param_specs(tree, *, cluster_stacked: bool = False
                   ) -> Dict[str, Tuple]:
    """The placement rule, as the JAX package's PartitionSpecs: per leaf
    (by keystr, in tree order) one mesh axis name or None per dim; the
    stage dim -> ``"model"``, everything else replicated within the
    cluster, a leading cluster dim -> ``"clusters"``."""
    lead = ("clusters",) if cluster_stacked else ()

    def spec(path, x):
        rest = x.dim() - len(lead)
        if is_stage_path(path):
            return (*lead, "model", *(None,) * (rest - 1))
        return (*lead, *(None,) * rest)

    return {k: spec(k, x) for k, x in T.keystr_items(tree)}


def stage_slice(tree, start: int, stop: int):
    """Stages ``[start, stop)`` of every stage-split leaf of a pp tree
    (views; the replicated leaves as they are): what a process holding
    those stages keeps."""
    return T.unflatten_like(tree, [
        x.narrow(0, start, stop - start) if is_stage_path(k) else x
        for k, x in T.keystr_items(tree)])


def to_pp_params(params, cfg: ModelConfig, pcfg: PipelineConfig):
    """A sequential (``models.model``) tree as a pp tree: the segment's
    units split into stages, padded slots zero and inactive."""
    check_pp(cfg)
    if len(params["segments"]) != 1:
        raise ValueError("a pp tree holds one uniform segment")
    lps, pad = layers_per_stage(cfg, pcfg)
    n = pcfg.n_stages

    def stage_rows(x):
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x.reshape((n, lps) + tuple(x.shape[1:]))

    out = {k: params[k] for k in REPLICATED if k in params}
    out["stages"] = T.tree_map(stage_rows, params["segments"][0])
    dev = params["embed"].device
    out["active"] = (torch.arange(n * lps, device=dev)
                     < cfg.n_layers).reshape(n, lps).float()
    return out


def sequential_params(pp_params, cfg: ModelConfig):
    """The sequential model's tree over the same tensors (views, so
    autograd reaches the pp leaves), padded slots dropped: the reference
    that ``tests/test_pipeline.py`` builds as ``ref_loss_from_pp``."""
    sp = T.tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
                    [:cfg.n_layers], pp_params["stages"])
    out = {k: pp_params[k] for k in REPLICATED if k in pp_params}
    out["segments"] = [sp]
    return out


# ---------------------------------------------------------------------------
# transports: the handoff between stages
# ---------------------------------------------------------------------------

class InProcess:
    """Every stage in this process: a handoff is a reference kept until
    the next stage takes it (first in, first out per pair of stages)."""

    def __init__(self, n_stages: int):
        self.n_stages = n_stages
        self.stages = list(range(n_stages))
        self._box: Dict[Tuple[int, int], List[torch.Tensor]] = {}

    def send(self, x, src: int, dst: int) -> None:
        self._box.setdefault((src, dst), []).append(x)

    def recv(self, src: int, dst: int, shape, dtype, device):
        return self._box[(src, dst)].pop(0)

    def finish(self) -> None:
        left = {k: len(v) for k, v in self._box.items() if v}
        assert not left, f"handoffs never taken: {left}"
        self._box.clear()

    def reduce_replicated(self, by_stage: Dict[int, List], like: List):
        """Per replicated leaf, the sum of the stages' gradients in stage
        order. At most two stages contribute to any leaf (stage 0 to
        ``embed``; the last stage to ``final_norm``, ``head`` and a tied
        ``embed``), and a sum of two values, or of one and zeros, is the
        same in every order: what ``StageGroup``'s all-reduce gives."""
        out = []
        for j, ref in enumerate(like):
            total = None
            for s in self.stages:
                g = by_stage[s][j]
                if g is not None:
                    total = g if total is None else total + g
            out.append(torch.zeros_like(ref) if total is None else total)
        return out

    def stage_scalars(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every stage's scalar, in stage order (here: all of them)."""
        return parts

    def on_owner(self, j: int, x: torch.Tensor, split: bool, fn,
                 shared=()) -> torch.Tensor:
        """``fn(whole leaf) -> whole result`` on leaf ``j``'s owner stage,
        this process's rows of the result back (here every stage is in
        process: ``x`` is the whole leaf and the result is returned as it
        is; see ``StageGroup.on_owner``)."""
        return fn(x)

    def share_loss(self, loss: Optional[torch.Tensor], like) -> torch.Tensor:
        return loss


class StageGroup:
    """One stage per rank of ``group`` (the mesh's "model" group, whose
    group rank is the stage index): handoffs are point-to-point sends,
    the replicated leaves' gradients an all-reduce (sum), the gradient
    norm's per-stage parts an all-gather summed in stage order. ``group``
    may be a ``comm.MetaGroup``: stage ``stage`` on the ``meta``
    device."""

    def __init__(self, group, stage: int, n_stages: int):
        if comm.size(group) != n_stages:
            raise ValueError(f"the stage group has {comm.size(group)} "
                             f"ranks for {n_stages} stages")
        self.group, self.n_stages = group, n_stages
        self.stages = [stage]
        self._pending: List[Tuple[Any, torch.Tensor]] = []

    def send(self, x, src: int, dst: int) -> None:
        x = x.contiguous()
        # the tensor stays referenced until its send has completed
        self._pending.append((comm.isend(x, dst, self.group, AXIS), x))

    def recv(self, src: int, dst: int, shape, dtype, device):
        buf = torch.empty(shape, dtype=dtype, device=device)
        return comm.recv(buf, src, self.group, AXIS)

    def finish(self) -> None:
        for work, _ in self._pending:
            work.wait()
        self._pending.clear()

    def reduce_replicated(self, by_stage: Dict[int, List], like: List):
        out = []
        for j, ref in enumerate(like):
            g = by_stage[self.stages[0]][j]
            g = torch.zeros_like(ref) if g is None else g
            out.append(comm.all_reduce(g, self.group, AXIS))
        return out

    def stage_scalars(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        return comm.all_gather(parts[0], self.group, AXIS)

    def on_owner(self, j: int, x: torch.Tensor, split: bool, fn,
                 shared=()) -> torch.Tensor:
        """``fn(whole leaf) -> whole result`` once, on leaf ``j``'s owner
        (stage ``j % n_stages``, so the leaves' work is spread round-robin
        over the stages), and this rank's rows of the result back. A
        stage-split leaf (``split``; ``x`` this rank's rows) is gathered
        whole on the owner alone and the result's rows scattered back; a
        replicated one (``x`` the same on every rank) is the owner's, and
        the result is broadcast. ``fn`` may update the tensors in
        ``shared`` in place on the owner; they are broadcast after it."""
        n, own = self.n_stages, j % self.n_stages
        mine = self.stages[0] == own
        x = x.contiguous()
        if split:
            whole = (x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
                     if mine else None)
            comm.gather(x, list(whole.chunk(n)) if mine else None, own,
                        self.group, AXIS)
        else:
            whole = x if mine else None
        out = fn(whole) if mine else None
        del whole
        if split:
            rows = comm.scatter(torch.empty_like(x),
                                [r.contiguous() for r in out.chunk(n)]
                                if mine else None, own, self.group, AXIS)
        else:
            rows = out.contiguous() if mine else torch.empty_like(x)
            comm.broadcast(rows, own, self.group, AXIS)
        for t in shared:
            if t.numel():
                comm.broadcast(t, own, self.group, AXIS)
        return rows

    def share_loss(self, loss: Optional[torch.Tensor], like) -> torch.Tensor:
        """The last stage's loss on every rank (the others add zero)."""
        loss = torch.zeros_like(like) if loss is None else loss.clone()
        comm.all_reduce(loss, self.group, AXIS)
        return loss


# ---------------------------------------------------------------------------
# the pipelined loss
# ---------------------------------------------------------------------------

class PipelineLoss:
    """``loss(params, tokens)`` (forward only) and ``value_and_grad(params,
    tokens) -> (loss, grads)`` through the GPipe schedule, for one
    cluster's tokens (B, S). ``params`` hold the transport's stages (every
    stage in process, or one rank's). The loss is the cluster's mean NLL
    over the whole batch, only the last stage's NLL counting. (The JAX
    function also takes cluster-stacked trees and sums the clusters'
    losses; the port's callers step each cluster in turn.)"""

    def __init__(self, cfg: ModelConfig, pcfg: PipelineConfig, *,
                 flash: bool = False, transport=None):
        check_pp(cfg)
        self.cfg, self.pcfg, self.flash = cfg, pcfg, flash
        self.transport = transport or InProcess(pcfg.n_stages)
        if self.transport.n_stages != pcfg.n_stages:
            raise ValueError("the transport's stage count is not the "
                             "pipeline's")
        self.seg = M.build_segments(cfg)[0]
        self.lps, _ = layers_per_stage(cfg, pcfg)
        self.cd = torch_dtype(cfg.compute_dtype)

    # -- one stage on one microbatch --------------------------------------
    def _nll(self, rep, h, tgt, msk):
        """Chunked head + CE (``lc`` as in the JAX loop), each chunk
        recomputed in backward."""
        S = h.shape[1]
        lc = 512 if S % 512 == 0 and S > 512 else S
        total = None
        for i in range(0, S, lc):
            sl = slice(i, i + lc)
            args = (rep, self.cfg, h[:, sl], tgt[:, sl], msk[:, sl])
            if torch.is_grad_enabled():
                t, _ = checkpoint(M._ce_from_hidden, *args,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                t, _ = M._ce_from_hidden(*args)
            total = t if total is None else total + t
        return total

    def _stage(self, s, sp, rep, act, x, tok, tgt, msk):
        """Stage ``s`` on one microbatch: the embedding first on stage 0,
        the NLL sum last on the last stage."""
        if s == 0:
            # the embedding lookup; its backward sums each row's
            # contributions in a fixed order (an indexing's index_put
            # accumulates them in another order from run to run)
            x = torch.nn.functional.embedding(tok.long(),
                                              rep["embed"].to(self.cd))
        mb, S = tok.shape
        ctx = M.make_ctx(self.cfg, mb, S, tok.device, flash=self.flash)
        for l, p in enumerate(M.unbind_units(sp, self.lps)):
            y = self.seg.apply_unit(p, x, ctx)
            a = act[l].to(y.dtype)
            x = y * a + x * (1.0 - a)
        if s < self.pcfg.n_stages - 1:
            return x
        return self._nll(rep, x, tgt, msk)

    # -- one cluster --------------------------------------------------------
    def _run(self, params, tokens, want_grad: bool):
        tr, pcfg = self.transport, self.pcfg
        last = pcfg.n_stages - 1
        B, S = tokens.shape
        if B % pcfg.n_micro:
            raise ValueError(f"batch {B} does not split into "
                             f"{pcfg.n_micro} microbatches")
        mb = B // pcfg.n_micro
        dev = tokens.device
        tgt = torch.cat([tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype,
                                                    device=dev)], 1)
        msk = torch.cat([torch.ones((B, S - 1), device=dev),
                         torch.zeros((B, 1), device=dev)], 1)
        cnt = msk.sum()
        act_shape = (mb, S, self.cfg.d_model)
        rep = {k: params[k] for k in REPLICATED if k in params}
        stage_tree = params["stages"]
        stage_leaves = T.leaves(stage_tree)
        rep_leaves = T.leaves(rep)
        local = list(enumerate(tr.stages))
        act = params["active"]
        rows = [slice(m * mb, (m + 1) * mb) for m in range(pcfg.n_micro)]

        def stage_args(i, m, sp, rp, x):
            return (tr.stages[i], sp, rp, act[i], x, tokens[rows[m]],
                    tgt[rows[m]], msk[rows[m]])

        inputs: Dict[Tuple[int, int], torch.Tensor] = {}
        nll = None
        with torch.no_grad():
            stage_trees = [T.unflatten_like(stage_tree,
                                            [x[i] for x in stage_leaves])
                           for i, _ in local]
            for m in range(pcfg.n_micro):
                for i, s in local:
                    x = None if s == 0 else tr.recv(s - 1, s, act_shape,
                                                    self.cd, dev)
                    if want_grad and s > 0:
                        inputs[(s, m)] = x
                    out = self._stage(*stage_args(i, m, stage_trees[i], rep,
                                                  x))
                    if s < last:
                        tr.send(out, s, s + 1)
                    else:
                        nll = out if nll is None else nll + out
            del stage_trees
        loss = tr.share_loss(None if nll is None else nll / cnt,
                             torch.zeros((), device=dev))
        if not want_grad:
            tr.finish()
            return loss, None

        inv_cnt = 1.0 / cnt
        g_stage = [torch.zeros_like(x) for x in stage_leaves]
        g_rep = {s: [None] * len(rep_leaves) for _, s in local}
        for m in reversed(range(pcfg.n_micro)):
            for i, s in reversed(local):
                g_out = inv_cnt if s == last else tr.recv(s + 1, s, act_shape,
                                                          self.cd, dev)
                with torch.enable_grad():
                    sp = [x[i].detach().requires_grad_(True)
                          for x in stage_leaves]
                    rp = [x.detach().requires_grad_(True) for x in rep_leaves]
                    x_in = (None if s == 0 else
                            inputs.pop((s, m)).requires_grad_(True))
                    out = self._stage(*stage_args(
                        i, m, T.unflatten_like(stage_tree, sp),
                        T.unflatten_like(rep, rp), x_in))
                    wrt = ([] if s == 0 else [x_in]) + sp + rp
                    gs = list(torch.autograd.grad(out, wrt, g_out,
                                                  allow_unused=True))
                    del out, sp, rp, x_in
                if s > 0:
                    tr.send(gs.pop(0), s, s - 1)
                for acc, g in zip(g_stage, gs[:len(stage_leaves)]):
                    acc[i].add_(g)
                for j, g in enumerate(gs[len(stage_leaves):]):
                    if g is not None:
                        prev = g_rep[s][j]
                        g_rep[s][j] = g if prev is None else prev + g
                del gs
        tr.finish()
        grads = dict(T.unflatten_like(
            rep, tr.reduce_replicated(g_rep, rep_leaves)))
        grads["stages"] = T.unflatten_like(stage_tree, g_stage)
        grads["active"] = torch.zeros_like(act)
        return loss, grads

    def __call__(self, params, tokens) -> torch.Tensor:
        return self._run(params, tokens, False)[0]

    def value_and_grad(self, params, tokens):
        return self._run(params, tokens, True)


def make_pp_loss(cfg: ModelConfig, pcfg: PipelineConfig, *,
                 flash: bool = False, transport=None) -> PipelineLoss:
    """The pipelined loss (the JAX function's ``loss_fn(params, tokens)``;
    its gradients through ``.value_and_grad``). ``flash`` routes the
    stages' attention to the flash kernels (``models.model.make_ctx``);
    ``transport``: ``InProcess`` (default) or ``StageGroup``."""
    return PipelineLoss(cfg, pcfg, flash=flash, transport=transport)
