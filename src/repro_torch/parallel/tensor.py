"""Tensor parallelism and FSDP placement by hand: the collectives that GSPMD
inserts for the JAX package's mesh training step, written out for one
cluster's (data, model) shards.

Storage follows ``parallel.sharding.param_placements``: the shard at
(j, m) keeps block (j, m) of every leaf, so params, AdamW moments, the
anchor, the Nesterov momentum, the pending delta and the EF buffer take
about 1 / (D * M) of a whole copy each wherever the dims divide.

Compute, one transformer unit at a time inside its remat'd body (so the
backward gathers again):
  - every weight is gathered over "data" (FSDP); its gradient is the sum
    of the data shards' gradients, scattered back to the blocks;
  - over "model", Megatron-style: wq, wk, wv, w_in, w_gate and w_up split
    by columns, wo, w_out and w_down by rows, their partial outputs summed
    and the bias added once after the sum. Attention runs on the shard's
    query heads ``[m H/M, (m+1) H/M)`` and the KV heads they read
    (``h // G``, ``kv_heads``): its KV/M heads where M divides the KV
    heads, or a copy of the one KV head its query heads share where M is
    a multiple of them, whose wk/wv gradient is then the sum of the
    gradients of the shards that share it, in shard order (``check_tp``
    refuses an M whose shards would straddle KV groups). A weight whose
    stored "model" dim is not the dim the layer splits, or whose stored
    block is not the shard's cut (wo at square shapes, wk/wv under GQA),
    is gathered over "model" too and cut. A layer
    whose heads or d_ff do not divide M runs whole on every model shard,
    as does a head whose vocab the rule leaves whole;
  - the embedding is looked up on the shard's d_model columns
    (``F.embedding``, whose backward sums in a fixed order) and gathered;
  - the head and cross entropy use the stored vocab split: the max and the
    sum of exponentials over "model", then the target logit from the shard
    that holds it.

Every cross-shard sum is a fixed-order sum, the parts gathered and added
in shard order (no NCCL all-reduce: "No atomics in a sum"): the
row-parallel outputs, the CE's partial sums, the data shards' gradients,
the clip norm's squares and the loss. The collectives are autograd
Functions with explicit backwards, issued by every rank in the same
order.

Serving (``TPDecode``, ``launch/serve.py --data/--model``) places the
weights over "model" only (``serve_index``), keeps each shard's KV heads
of the cache, splits the batch or the engine's slots over "data", and
sums and gathers the same way; there M may also be a multiple of the KV
heads, each shard keeping a copy of the one KV head it reads, as in
training. ``TPDecode(..., placement="2d")`` takes the training placement
instead (FSDP over "data" as well, each unit's weights gathered before
it runs) and ``TPLoss.prefill`` is the sharded prefill: the JAX dry-run's
default serving layouts.

Two forms, one arithmetic: ``ShardGroup(D, M)`` holds every shard of a
cluster in this process, its blocks views of whole tensors (the tests and
one card), and ``ShardGroup(D, M, data_group=..., ...)`` one shard per
rank. The forms give the same bits: each shard does the same operations
on the same shapes in both, and the sums are taken in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.layers import apply_gelu_mlp, apply_norm, apply_swiglu
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh


def check_tp(cfg: ModelConfig, n_model: int) -> None:
    """Refuses a "model" size whose shards would straddle KV groups: the
    shards of a GQA layer hold whole groups of query heads and their KV
    heads (M divides the KV heads), or each lies inside one group and
    keeps a replicated copy of its one KV head (M a multiple of the KV
    heads), in training and in serving alike. (An M that does not divide
    the query heads runs attention whole on every shard.)"""
    if n_model <= 1 or cfg.n_heads % n_model or cfg.n_kv_heads % n_model == 0 \
            or n_model % cfg.n_kv_heads == 0:
        return
    raise ValueError(
        f"{cfg.name}: --model {n_model} would split a KV group "
        f"({cfg.n_heads} query heads over {cfg.n_kv_heads} KV heads); "
        f"the model size must divide the KV heads or be a multiple of them")


def ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, left to right; parts narrower than
    f32 (bf16 partial products, their gradients) are summed in f32 and
    rounded once, as the unsharded product accumulates in f32."""
    low = parts[0].dtype == torch.bfloat16 and len(parts) > 1
    acc = parts[0].float() if low else parts[0]
    for p in parts[1:]:
        acc = acc + (p.float() if low else p)
    return acc.to(parts[0].dtype) if low else acc


def _max(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out


# ---------------------------------------------------------------------------
# one mesh axis as seen by this process
# ---------------------------------------------------------------------------

class _Fanout(torch.autograd.Function):
    """One value handed to ``n`` shards; the gradient is their gradients'
    sum in shard order."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        return ordered_sum(grads), None


class LocalAxis:
    """Every index of an axis in this process: a sum is an ordered sum,
    a gather a concatenation."""

    def __init__(self, size: int):
        self.size, self.local = size, list(range(size))

    def reduce(self, parts):
        """Partials -> their sum (replicated); gradient: each its own."""
        return ordered_sum(parts)

    def fanout(self, x) -> List[torch.Tensor]:
        """A replicated value -> one per index; gradient: the sum."""
        return list(_Fanout.apply(x, self.size)) if self.size > 1 else [x]

    def gather(self, parts, dim: int):
        """Blocks -> the whole along ``dim`` (replicated); gradient: each
        block its own slice."""
        return torch.cat(parts, dim) if len(parts) > 1 else parts[0]

    def gather_fanout(self, parts, dim: int) -> List[torch.Tensor]:
        """Blocks -> the whole, one per index (FSDP's gather); gradient:
        the indices' gradients summed, each block its slice."""
        return self.fanout(self.gather(parts, dim))

    def max(self, parts):
        return _max(parts)

    def collect(self, parts) -> List[torch.Tensor]:
        """Every index's value, in index order."""
        return list(parts)


def _all_gather(x, axis) -> List[torch.Tensor]:
    return comm.all_gather(x, axis.group, axis.name)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return ordered_sum(_all_gather(x, axis))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(_all_gather(g, ctx.axis)), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return torch.cat(_all_gather(x, axis), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


class _GatherSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return torch.cat(_all_gather(x, axis), dim)

    @staticmethod
    def backward(ctx, g):
        chunks = [c.contiguous() for c in g.chunk(ctx.axis.size, ctx.dim)]
        got = comm.all_to_all(chunks, ctx.axis.group, ctx.axis.name)
        return ordered_sum(got), None, None


class GroupAxis:
    """One index of an axis per rank of ``group`` (this rank's:
    ``index``): the same operations as ``LocalAxis``, the other indices'
    values gathered from their ranks (``parallel.comm``, which records
    each collective under the axis ``name``)."""

    def __init__(self, group, index: int, size: int, name: str):
        self.group, self.index, self.size = group, index, size
        self.name = name
        self.local = [index]

    def reduce(self, parts):
        return _AllSum.apply(parts[0], self)

    def fanout(self, x):
        return [_SumGrad.apply(x, self)]

    def gather(self, parts, dim: int):
        return _Gather.apply(parts[0], self, dim)

    def gather_fanout(self, parts, dim: int):
        return [_GatherSumScatter.apply(parts[0], self, dim)]

    def max(self, parts):
        return _max(_all_gather(parts[0], self))

    def collect(self, parts) -> List[torch.Tensor]:
        return _all_gather(parts[0], self)


class MetaAxis(GroupAxis):
    """One index of an axis on the ``meta`` device (the dry-run's rank):
    ``GroupAxis``'s operations over a ``comm.MetaGroup``, so a gather
    returns the shapes the ranks' would and records the same entries,
    and nothing is sent."""

    def __init__(self, name: str, index: int, size: int):
        super().__init__(comm.MetaGroup(size, index), index, size, name)


def _axis(group, index: int, size: int, name: str):
    if size == 1:
        return LocalAxis(1)
    if comm.is_meta(group):
        return MetaAxis(name, index, size)
    return GroupAxis(group, index, size, name)


# ---------------------------------------------------------------------------
# a cluster's (data, model) shards
# ---------------------------------------------------------------------------

class ShardGroup:
    """The D x M shards of one cluster. With no groups every shard is in
    this process and a leaf is its whole tensor, its blocks views of it;
    with ``data_group``, ``model_group`` and ``group`` (the cluster's
    D x M ranks, group rank j * M + m) this rank is shard ``coords`` and
    a leaf is its block. The groups may be ``comm.MetaGroup``s: one
    rank's shard on the ``meta`` device, its axes ``MetaAxis``es."""

    name = "data,model"

    def __init__(self, n_data: int, n_model: int, *, data_group=None,
                 model_group=None, group=None, coords=None):
        self.D, self.M = n_data, n_model
        self.mesh = {"data": n_data, "model": n_model}
        self.size = n_data * n_model
        self.in_process = coords is None
        if self.in_process:
            self.data, self.model = LocalAxis(n_data), LocalAxis(n_model)
            self.shards = [(j, m) for j in range(n_data)
                           for m in range(n_model)]
            return
        j, m = coords
        self.data = _axis(data_group, j, n_data, "data")
        self.model = _axis(model_group, m, n_model, "model")
        self.shards = [(j, m)]
        self.group, self.index = group, j * n_model + m

    # -- blocks ------------------------------------------------------------
    def coords_of(self, r: int) -> Dict[str, int]:
        return {"data": r // self.M, "model": r % self.M}

    def parts(self, x, spec) -> List[List[torch.Tensor]]:
        """The distinct blocks of a leaf here, ``[data][model]``: one per
        index of an axis the leaf is split over, one for an axis it is
        replicated on (a rank: ``[[x]]``)."""
        if not self.in_process:
            return [[x]]
        A = range(self.D) if "data" in spec else [0]
        B = range(self.M) if "model" in spec else [0]
        return [[x[sh.block_slices(x.shape, spec, self.mesh,
                                   {"data": a, "model": b})] for b in B]
                for a in A]

    def whole_shape(self, block_shape, spec) -> Tuple[int, ...]:
        return tuple(n * (self.mesh[a] if a else 1) for n, a in zip(
            block_shape, tuple(spec) + (None,) * len(block_shape)))

    # -- fixed-order sums over the whole group -------------------------------
    def sum_scalars(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """One scalar per local shard -> their sum in shard order."""
        if self.in_process:
            return ordered_sum(parts)
        return ordered_sum(_all_gather(parts[0], self))

    def sum_int(self, n: int, device) -> int:
        """The ranks' ``n`` summed (on ``meta``, which holds no values:
        this rank's own)."""
        got = _all_gather(torch.tensor([n], dtype=torch.int64,
                                       device=device), self)
        if device.type == "meta":
            return n
        return int(sum(int(g) for g in got))

    # -- ranks only: the owner pattern of the outer step, whole leaves ------
    def gather_to(self, owner: int, block, spec):
        """The whole leaf on group rank ``owner`` (None elsewhere) from
        every rank's block."""
        block = block.contiguous()
        mine = self.index == owner
        got = [torch.empty_like(block) for _ in range(self.size)] \
            if mine else None
        comm.gather(block, got, owner, self.group, self.name)
        if not mine:
            return None
        return sh.unshard_leaf([(self.coords_of(r), b)
                                for r, b in enumerate(got)], spec, self.mesh)

    def scatter_from(self, owner: int, whole, spec, like):
        """Each rank's block of ``whole`` (given on group rank ``owner``)."""
        out = torch.empty_like(like)
        parts = None
        if self.index == owner:
            parts = [whole[sh.block_slices(whole.shape, spec, self.mesh,
                                           self.coords_of(r))].contiguous()
                     for r in range(self.size)]
        return comm.scatter(out, parts, owner, self.group, self.name)

    def broadcast_from(self, owner: int, t) -> None:
        if t.numel():
            comm.broadcast(t, owner, self.group, self.name)

    def gather_whole(self, block, spec):
        """The whole leaf on every rank."""
        return sh.unshard_leaf([(self.coords_of(r), b) for r, b in
                                enumerate(_all_gather(block, self))],
                               spec, self.mesh)


# ---------------------------------------------------------------------------
# the sharded loss
# ---------------------------------------------------------------------------

_COLUMN = ("wq", "wk", "wv", "w_in", "w_gate", "w_up", "b_in")
_ROW = ("wo", "w_out", "w_down")


class TPLoss:
    """The cluster's next-token CE (``models.model.loss_fn``'s) and its
    gradient over a ``ShardGroup``, for leaves placed by ``specs`` (the
    unstacked ``param_placements`` of the param tree)."""

    def __init__(self, cfg: ModelConfig, shards: ShardGroup,
                 specs: Dict[str, Tuple], *, flash: bool = False):
        M.check_ported(cfg)
        check_tp(cfg, shards.M)
        self.cfg, self.shards, self.specs = cfg, shards, specs
        self.flash = flash          # ``models.model.make_ctx``'s
        self.segs = M.build_segments(cfg)
        nm = shards.M
        self.split_attn = nm > 1 and cfg.n_heads % nm == 0
        self.split_mlp = nm > 1 and cfg.d_ff > 0 and cfg.d_ff % nm == 0
        lo, hi = kv_heads(cfg, nm, 0)
        self.n_kv = hi - lo
        # M a multiple of the KV heads: each shard's wk/wv columns are a
        # copy of its one KV head, not a 1/M block of them
        self.kv_replicated = self.split_attn and cfg.n_kv_heads % nm != 0

    # -- weights -------------------------------------------------------------
    def _split(self, key: str, spec) -> Optional[int]:
        """The dim of a leaf's unit (a segment leaf without its unit dim)
        that its layer splits over "model" (None: whole)."""
        name = key.rsplit("['", 1)[-1][:-2]
        if key.startswith("['segments']"):
            split = (self.split_attn if "['attn']" in key else
                     self.split_mlp if "['mlp']" in key else False)
            if split and name in _COLUMN:
                return len(spec) - 2
            if split and name in _ROW:
                return 0
            return None
        if key in ("['embed']", "['head']") and spec[1] == "model":
            return 1        # the lookup's d_model columns; the vocab split
        return None

    def _cut(self, key: str) -> Optional[Callable[[int], Tuple[int, int]]]:
        """Model shard i's (offset, width) along the split dim where it is
        not the i-th of M equal parts: wk/wv's replicated KV head."""
        name = key.rsplit("['", 1)[-1][:-2]
        if not (self.kv_replicated and name in ("wk", "wv")):
            return None
        hd, nm = self.cfg.resolved_head_dim, self.shards.M
        return lambda i: (kv_heads(self.cfg, nm, i)[0] * hd, self.n_kv * hd)

    def prep_key(self, key: str, parts, spec=None):
        """``prep`` of leaf ``key``'s blocks (``spec``: its placement, a
        segment leaf's without the unit dim; default the stored one)."""
        return self.prep(parts, self.specs[key] if spec is None else spec,
                         self._split(key, self.specs[key]), self._cut(key))

    def prep(self, parts, spec, split, cut=None):
        """One leaf's blocks -> per local data index, ("rep", whole) or
        ("shard", [the local model shards' slices along ``split``]: the
        i-th of M equal parts, or ``cut(i)`` = (offset, width))."""
        data, model = self.shards.data, self.shards.model
        spec = tuple(spec) + (None,) * (parts[0][0].dim() - len(spec))
        cols = []
        for b in range(len(parts[0])):
            col = [parts[a][b] for a in range(len(parts))]
            cols.append(data.gather_fanout(col, spec.index("data"))
                        if "data" in spec else data.fanout(col[0]))
        out = []
        for jj in range(len(data.local)):
            ws = [c[jj] for c in cols]
            if "model" in spec and split == spec.index("model") \
                    and cut is None:
                out.append(("shard", [w.contiguous() for w in ws]))
                continue
            W = (model.gather(ws, spec.index("model")) if "model" in spec
                 else ws[0])
            if split is None:
                out.append(("rep", W.contiguous()))
                continue
            n = W.shape[split] // model.size
            cuts = [cut(i) if cut else (i * n, n) for i in model.local]
            out.append(("shard", [w.narrow(split, a, b).contiguous()
                                  for (a, b), w in zip(cuts,
                                                       model.fanout(W))]))
        return out

    # -- one unit ------------------------------------------------------------
    def _attention(self, W, h, ctx, window):
        cfg, model = self.cfg, self.shards.model
        kw = dict(head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                  causal=True, window=window, chunk=ctx["chunk"],
                  flash=ctx["flash"])
        names = ("wq", "wk", "wv", "wo")
        if not self.split_attn:
            return attn.apply_gqa({k: W[k][1] for k in names}, h,
                                  ctx["positions"], n_heads=cfg.n_heads,
                                  n_kv=cfg.n_kv_heads, **kw)
        parts = [attn.apply_gqa({k: W[k][1][i] for k in names}, hm,
                                ctx["positions"],
                                n_heads=cfg.n_heads // model.size,
                                n_kv=self.n_kv, **kw)
                 for i, hm in enumerate(model.fanout(h))]
        return model.reduce(parts)

    def _mlp(self, mlp, h):
        """The MLP split over "model": each shard's column and row blocks,
        the partial outputs summed and the output bias added once."""
        model = self.shards.model
        apply = apply_swiglu if "w_gate" in mlp else apply_gelu_mlp
        parts = [apply({k: v[1][i] for k, v in mlp.items()
                        if v[0] == "shard"}, hm)
                 for i, hm in enumerate(model.fanout(h))]
        y = model.reduce(parts)
        return y + mlp["b_out"][1] if "b_out" in mlp else y

    def _unit(self, W, x, ctx, window):
        """``models.model``'s unit: ln1, attention, and ``add_residual``
        with the FFN, its MLP split where ``split_mlp``."""
        rep = {k: {n: v[1] for n, v in W[k].items() if v[0] == "rep"}
               for k in ("ln1", "ln2", "mlp") if k in W}
        h = apply_norm(rep["ln1"], x, self.cfg.norm)
        a = self._attention(W["attn"], h, ctx, window)
        mlp = (lambda y: self._mlp(W["mlp"], y)) \
            if "mlp" in W and self.split_mlp else None
        return M.add_residual(rep, x, a, self.cfg, mlp)

    # -- head + CE -----------------------------------------------------------
    def _nll(self, W_norm, W_head, tied, h, tgt, mask):
        """Summed NLL of one chunk: the final norm, the head, the CE."""
        model = self.shards.model
        kind, w = W_head
        if kind == "rep":
            p = {"final_norm": W_norm, "embed" if tied else "head": w}
            return M._ce_from_hidden(p, self.cfg, h, tgt, mask)[0]
        h = apply_norm(W_norm, h, self.cfg.norm)
        lgs = [(hm @ wm.to(hm.dtype)).float()
               for hm, wm in zip(model.fanout(h), w)]
        nv = w[0].shape[-1]
        with torch.no_grad():
            mx = model.max([lg.amax(dim=-1) for lg in lgs])
        s = model.reduce([torch.exp(lg - mx[..., None]).sum(dim=-1)
                          for lg in lgs])
        picks = []
        for i, lg in zip(model.local, lgs):
            loc = tgt.long() - i * nv
            inside = (loc >= 0) & (loc < nv)
            p = torch.gather(lg, -1, loc.clamp(0, nv - 1)[..., None])[..., 0]
            picks.append(torch.where(inside, p, torch.zeros_like(p)))
        tl = model.reduce(picks)
        return ((mx + torch.log(s) - tl) * mask).sum()

    # -- the trunk and the loss of every local data shard ---------------------
    def hidden(self, parts: Dict[str, List[List[torch.Tensor]]],
               toks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each local data shard's final hidden states (B_j, S, d) before
        the final norm, from its rows ``toks[jj]`` and the leaves' blocks
        ``parts`` (by keystr): the embedding, then every unit."""
        cfg, specs = self.cfg, self.specs
        dev = toks[0].device
        # embedding: the shard's d_model columns, gathered over "model"
        emb = self.prep_key("['embed']", parts["['embed']"])
        xs = []
        for jj, tok in enumerate(toks):
            kind, e = emb[jj]
            xs.append(self.shards.model.gather(
                [M.embed_rows(em, cfg, tok) for em in e], 2)
                if kind == "shard" else M.embed_rows(e, cfg, tok))
        ctxs = [M.make_ctx(cfg, t.shape[0], t.shape[1], dev, flash=self.flash)
                for t in toks]
        # the units, each remat'd with its weights' gathers
        for s, seg in enumerate(self.segs):
            pre = f"['segments'][{s}]"
            keys = [k for k in parts if k.startswith(pre)]
            units = {k: [[b.unbind(0) for b in row] for row in parts[k]]
                     for k in keys}
            for i in range(seg.n):
                def body(*xs_, _i=i, _keys=keys, _units=units, _pre=pre,
                         _w=seg.window):
                    W = {}
                    for k in _keys:
                        blocks = [[u[_i] for u in row] for row in _units[k]]
                        W[k[len(_pre):]] = self.prep_key(k, blocks,
                                                         specs[k][1:])
                    return tuple(self._unit(
                        _unit_tree({k: v[jj] for k, v in W.items()}), x_,
                        ctxs[jj], _w) for jj, x_ in enumerate(xs_))
                xs = list(checkpoint(body, *xs, use_reentrant=False))
        return xs

    def _head(self, parts):
        """(final norm per local data index, the head's prepped weights:
        the tied table whole, else the stored vocab split)."""
        norm_w = {k[len("['final_norm']['"):-2]: self.prep_key(k, parts[k])
                  for k in parts if k.startswith("['final_norm']")}
        head = self.prep(parts["['embed']"], self.specs["['embed']"], None) \
            if self.cfg.tie_embeddings else \
            self.prep_key("['head']", parts["['head']"])
        return norm_w, head

    def losses(self, parts: Dict[str, List[List[torch.Tensor]]],
               toks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each local data shard's mean NLL over its rows ``toks[jj]``
        (B_j, S), from the leaves' blocks ``parts`` (by keystr)."""
        dev = toks[0].device
        xs = self.hidden(parts, toks)
        # head + CE, chunk by chunk over the sequence like loss_fn
        norm_w, head = self._head(parts)
        tied = self.cfg.tie_embeddings
        out = []
        for jj, (tok, h) in enumerate(zip(toks, xs)):
            B, S = tok.shape
            tgt = torch.cat([tok[:, 1:], torch.zeros((B, 1), dtype=tok.dtype,
                                                     device=dev)], 1)
            mask = torch.cat([torch.ones((B, S - 1), device=dev),
                              torch.zeros((B, 1), device=dev)], 1)
            wn = {k: v[jj][1] for k, v in norm_w.items()}
            lc = M.LOSS_CHUNK if S % M.LOSS_CHUNK == 0 \
                and S > M.LOSS_CHUNK else S
            total = None
            for c0 in range(0, S, lc):
                sl = slice(c0, c0 + lc)
                args = (wn, head[jj], tied, h[:, sl], tgt[:, sl],
                        mask[:, sl])
                t = (checkpoint(self._nll, *args, use_reentrant=False)
                     if lc < S else self._nll(*args))
                total = t if total is None else total + t
            out.append(total / torch.clamp(mask.sum(), min=1.0))
        return out

    @torch.no_grad()
    def prefill(self, parts: Dict[str, List[List[torch.Tensor]]],
                toks: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sharded prefill (``launch.steps.make_prefill_step``): each
        local data shard's last-position logits (B_j, V), the units'
        forward as in training, then the final norm and the head at the
        last position, a vocab-split head's blocks gathered over
        "model"."""
        xs = self.hidden(parts, toks)
        norm_w, head = self._head(parts)
        out = []
        for jj, h in enumerate(xs):
            x = apply_norm({k: v[jj][1] for k, v in norm_w.items()},
                           h[:, -1:], self.cfg.norm)
            kind, w = head[jj]
            if kind == "rep" and self.cfg.tie_embeddings:
                w = w.T
            lg = (x @ w.to(x.dtype) if kind == "rep" else
                  self.shards.model.gather([x @ wm.to(x.dtype) for wm in w],
                                           2))
            out.append(lg[:, 0])
        return out

    def value_and_grad(self, parts, toks):
        """(the cluster's loss: the data shards' mean, replicated; the
        gradient of every distinct block in ``parts``, in the order
        ``flat_parts`` lists them). Each data shard's loss is weighted
        1 / D, so the summed gradient is the whole batch's mean."""
        leaves = flat_parts(parts)
        live = {id(x): x.detach().requires_grad_(True) for x in leaves}
        tp = {k: [[live[id(b)] for b in row] for row in rows]
              for k, rows in parts.items()}
        with torch.enable_grad():
            losses = self.losses(tp, toks)
            w = torch.full((), 1.0 / self.shards.D, device=toks[0].device)
            grads = torch.autograd.grad(losses, [live[id(x)] for x in leaves],
                                        grad_outputs=[w] * len(losses),
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        with torch.no_grad():
            loss = self.shards.data.reduce(
                [l.detach().float() for l in losses]) / self.shards.D
        return loss, grads


def _unit_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"['attn']['wq']": v, ...}`` -> ``{"attn": {"wq": v}, ...}``."""
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        names = [n[1:-1] for n in k[1:-1].split("][")]
        d = out
        for n in names[:-1]:
            d = d.setdefault(n, {})
        d[names[-1]] = v
    return out


def flat_parts(parts: Dict[str, List[List[torch.Tensor]]]
               ) -> List[torch.Tensor]:
    """Every distinct block of ``parts`` once, in key order, data-major."""
    return [b for rows in parts.values() for row in rows for b in row]


# ---------------------------------------------------------------------------
# the inner step's clip and update on blocks
# ---------------------------------------------------------------------------

def block_index(shards: ShardGroup, spec, j: int, m: int):
    """(a, b) of shard (j, m)'s block in ``ShardGroup.parts``, and whether
    that shard is the block's canonical holder (index 0 along the axes
    the leaf is replicated on)."""
    ds, ms = "data" in spec, "model" in spec
    a, b = (j if ds else 0), (m if ms else 0)
    return a, b, (ds or j == 0) and (ms or m == 0)


def clip_(shards: ShardGroup, specs: Dict[str, Tuple],
          grads: Dict[str, List[List[torch.Tensor]]],
          grad_clip: float = 1.0) -> List[torch.Tensor]:
    """AdamW's global-norm clip over the cluster's whole gradient: each
    shard's squares of the blocks it canonically holds, in leaf order,
    then those partials summed in shard order. Returns the clipped blocks
    in ``flat_parts`` order (``adamw.scaled``)."""
    dev = next(iter(grads.values()))[0][0].device
    partials = []
    for j, m in shards.shards:
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for key, rows in grads.items():
            a, b, mine = block_index(shards, specs[key], j, m)
            if not shards.in_process:
                a = b = 0
            if mine:
                g = rows[a][b].float().contiguous()
                total = total + torch.sum(torch.square(g))
        partials.append(total)
    sq = shards.sum_scalars(partials)
    scale = torch.clamp(grad_clip / torch.sqrt(sq + 1e-16), max=1.0)
    return [adamw.scaled(g, scale) for g in flat_parts(grads)]


def regroup(parts, flat: List[torch.Tensor]):
    """``flat`` (in ``flat_parts`` order) in ``parts``' layout."""
    it = iter(flat)
    return {k: [[next(it) for _ in row] for row in rows]
            for k, rows in parts.items()}


# ---------------------------------------------------------------------------
# serving: greedy decode over the model shards
# ---------------------------------------------------------------------------

def kv_heads(cfg: ModelConfig, n_model: int, m: int) -> Tuple[int, int]:
    """``[lo, hi)``: the KV heads that model shard m's query heads ``[m H/M,
    (m+1) H/M)`` read (``h // G``): its KV/M heads, or the one head it
    replicates where M is a multiple of KV; all of them where M does not
    divide H (attention then runs whole on every shard)."""
    if n_model == 1 or cfg.n_heads % n_model:
        return 0, cfg.n_kv_heads
    hl, g = cfg.n_heads // n_model, cfg.n_heads // cfg.n_kv_heads
    return m * hl // g, ((m + 1) * hl - 1) // g + 1


def _head_split(cfg: ModelConfig, n_model: int, key: str, shape) -> Tuple:
    """The serving placement of the embedding or the head, and whether it
    splits the dim ``TPLoss._split`` splits (the embedding's d_model
    columns, the head's vocab). A tied head is computed whole, as
    ``TPLoss._nll`` computes it, so the tied table stays whole."""
    spec = sh.param_placements(
        {key[2:-2]: torch.empty(shape, device="meta")},
        {"data": 1, "model": n_model}, cluster_stacked=False,
        serve=True)[key]
    return spec, spec[1] == "model" and not cfg.tie_embeddings


def serve_index(cfg: ModelConfig, n_model: int, m: int) -> Callable:
    """``index_of(keystr, whole shape)``: what model shard m keeps of each
    leaf to decode (for ``sharding.serve_blocks`` and
    ``models.model.draw_params``). Weights are placed over "model" only
    (``param_placements(..., serve=True)``, no FSDP dim). Where a leaf's
    "model" dim is the one its layer splits, that is its block
    (``sharding.block_slices``); where not (wo at square shapes, wk/wv
    under GQA, the KV head a shard replicates) the layer's own cut, made
    once at load and never gathered per token. A layer whose heads or d_ff
    do not divide M stays whole, as do norms, the output bias and a tied
    embedding."""
    M.check_ported(cfg)
    check_tp(cfg, n_model)
    hd = cfg.resolved_head_dim
    split_attn = n_model > 1 and cfg.n_heads % n_model == 0
    split_mlp = n_model > 1 and cfg.d_ff > 0 and cfg.d_ff % n_model == 0
    hl = cfg.n_heads // n_model
    lo, hi = kv_heads(cfg, n_model, m)
    q = (m * hl * hd, (m + 1) * hl * hd)
    f = cfg.d_ff // n_model
    cuts = {"attn": {"wq": (-1,) + q, "wk": (-1, lo * hd, hi * hd),
                     "wv": (-1, lo * hd, hi * hd), "wo": (1,) + q},
            "mlp": {**{n: (-1, m * f, (m + 1) * f) for n in _COLUMN},
                    **{n: (1, m * f, (m + 1) * f) for n in _ROW}}}

    def index_of(key: str, shape) -> Tuple[slice, ...]:
        out = [slice(None)] * len(shape)
        name = key.rsplit("['", 1)[-1][:-2]
        if key in ("['embed']", "['head']") and n_model > 1:
            spec, split = _head_split(cfg, n_model, key, shape)
            if split:
                return sh.block_slices(shape, spec, {"data": 1,
                                                     "model": n_model},
                                       {"data": 0, "model": m})
        for part, on in (("attn", split_attn), ("mlp", split_mlp)):
            if on and f"['{part}']" in key and name in cuts[part]:
                dim, a, b = cuts[part][name]
                out[dim] = slice(a, b)
        return tuple(out)

    return index_of


class TPDecode:
    """Greedy decode (``models.model.decode_step`` and the paged engine's
    step) over a ``ShardGroup``, from each local model shard's blocks
    (``serve_index``): a list ``blocks``, one tree per index of
    ``shards.model.local``.

    Over "model", Megatron-style as ``TPLoss`` splits training: attention
    on the shard's query heads and the KV heads they read, its cache
    holding only those heads (``kv_heads``); the MLP's column and row
    blocks; the row-parallel outputs (wo, w_out / w_down), (B, 1, d) a
    layer, all-gathered and summed in shard order, the bias added once
    after the sum; the embedding looked up on the shard's d_model columns
    and gathered; the head vocab-split where its placement splits V, the
    next token the largest of the gathered per-shard (max, index) pairs,
    the lower vocab index on an exact tie (what ``torch.argmax`` of the
    whole row gives). Over "data", a batch whose size D divides splits
    into D contiguous blocks, each data shard running its own and the
    tokens all-gathered in shard order; any other batch runs whole on
    every data shard. In process every block and shard runs in turn with
    the shapes a rank gives it, so the ranks give the same bits.

    ``placement="2d"``: the weights are placed as for training
    (``param_placements(..., serve=False)``: FSDP over "data" too), and
    ``blocks`` is a ``{keystr: [[block]]}`` dict of ``ShardGroup.parts``
    of the whole tree (in process) or of this rank's blocks; each step
    gathers the embedding, the final norm and the head, and each unit's
    weights before the unit runs, as ``TPLoss.prep`` gathers them in
    training, into the blocks ``serve_index`` would cut, and computes as
    above (the JAX dry-run's default decode layout)."""

    def __init__(self, cfg: ModelConfig, shards: ShardGroup, *,
                 placement: str = "serve"):
        M.check_ported(cfg)
        check_tp(cfg, shards.M)
        if placement not in ("serve", "2d"):
            raise ValueError(f"placement {placement!r}: 'serve' or '2d'")
        self.cfg, self.shards, self.placement = cfg, shards, placement
        self.gathers = None
        if placement == "2d":
            self.gathers = TPLoss(cfg, shards, sh.param_placements(
                M.init_params(cfg, device="meta"), shards.mesh,
                cluster_stacked=False))
        nm = shards.M
        self.split_attn = nm > 1 and cfg.n_heads % nm == 0
        self.split_mlp = nm > 1 and cfg.d_ff > 0 and cfg.d_ff % nm == 0
        self.n_heads = cfg.n_heads // nm if self.split_attn else cfg.n_heads
        lo, hi = kv_heads(cfg, nm, 0)
        self.n_kv = hi - lo
        self.vocab_split = nm > 1 and _head_split(
            cfg, nm, "['head']", (cfg.d_model, cfg.vocab_size))[1]
        self.segs = M.build_segments(cfg)
        # caches a process keeps per data block: one per local model shard,
        # one where attention runs whole
        self.n_caches = len(shards.model.local) if self.split_attn else 1
        # on_logits(rows, [(model index or None, logits (B, 1, V_i))]):
        # sees each data block's head outputs (None: the whole row)
        self.on_logits: Optional[Callable] = None

    def shard_config(self) -> ModelConfig:
        """The config whose caches hold one shard's KV heads."""
        return dataclasses.replace(self.cfg, n_kv_heads=self.n_kv)

    def rows(self, n: int) -> List[Tuple[int, int]]:
        """``[lo, hi)`` of the rows of an n-row batch that each local data
        index runs (one block of all n where D does not divide n)."""
        D = self.shards.D
        if n % D:
            return [(0, n)]
        w = n // D
        return [(j * w, (j + 1) * w) for j in self.shards.data.local]

    # -- the weights, per local model shard ------------------------------------
    def _trees(self, W) -> List[Dict[str, Any]]:
        """``TPLoss.prep``'s outputs (data index 0: every data index holds
        the same whole) as one serving tree per local model shard."""
        return [_unit_tree({k: v[0][1] if v[0][0] == "rep" else v[0][1][i]
                            for k, v in W.items()})
                for i in range(len(self.shards.model.local))]

    def top_blocks(self, blocks) -> List[Dict[str, Any]]:
        """The embedding, final norm and head of each local model shard
        (``placement="2d"``: gathered; a tied table whole, as
        ``serve_index`` leaves it)."""
        if self.gathers is None:
            return blocks
        g = self.gathers
        return self._trees({
            k: (g.prep(v, g.specs[k], None)
                if k == "['embed']" and self.cfg.tie_embeddings
                else g.prep_key(k, v))
            for k, v in blocks.items() if not k.startswith("['segments']")})

    def unit_blocks(self, blocks, s: int, u: int) -> List[Dict[str, Any]]:
        """Unit ``u`` of segment ``s`` for each local model shard
        (``placement="2d"``: its weights gathered)."""
        if self.gathers is None:
            return [M.unit(b["segments"][s], u) for b in blocks]
        g, pre = self.gathers, f"['segments'][{s}]"
        return self._trees({
            k[len(pre):]: g.prep_key(k, [[b[u] for b in row] for row in v],
                                     g.specs[k][1:])
            for k, v in blocks.items() if k.startswith(pre)})

    # -- the model's pieces over the shards ----------------------------------
    def embed(self, blocks, tokens):
        cfg = self.cfg
        if blocks[0]["embed"].shape[1] == cfg.d_model:
            return M.embed_rows(blocks[0]["embed"], cfg, tokens)
        return self.shards.model.gather(
            [M.embed_rows(b["embed"], cfg, tokens) for b in blocks], 2)

    def unit(self, Ws, x, attend):
        """``models.model``'s decode unit (ln1, attention, ``add_residual``
        with the FFN, its MLP split where ``split_mlp``) over the local
        shards' unit blocks ``Ws``; ``attend(i, p_attn, h)`` is local shard
        i's ``o @ wo`` partial, its cache written."""
        cfg, model = self.cfg, self.shards.model
        p = Ws[0]
        h = apply_norm(p["ln1"], x, cfg.norm)
        if self.split_attn:
            a = model.reduce([attend(i, W["attn"], h)
                              for i, W in enumerate(Ws)])
        else:
            a = attend(0, p["attn"], h)
        mlp = None
        if self.split_mlp and "mlp" in p:
            apply = apply_swiglu if "w_gate" in p["mlp"] else apply_gelu_mlp

            def mlp(y):
                out = model.reduce([apply({k: v for k, v in W["mlp"].items()
                                           if k != "b_out"}, y) for W in Ws])
                return out + p["mlp"]["b_out"] if "b_out" in p["mlp"] \
                    else out
        return M.add_residual(p, x, a, cfg, mlp)

    def logits(self, blocks, x) -> List[Tuple[Optional[int], torch.Tensor]]:
        """The head's outputs: each local shard's vocab block, or the whole
        row (``models.model.logits_fn`` on a shard's blocks)."""
        if not self.vocab_split:
            return [(None, M.logits_fn(blocks[0], self.cfg, x))]
        return [(m, M.logits_fn(b, self.cfg, x))
                for m, b in zip(self.shards.model.local, blocks)]

    def argmax(self, parts) -> torch.Tensor:
        """The next token (B,) from ``logits``' last position."""
        if not self.vocab_split:
            return torch.argmax(parts[0][1][:, -1], dim=-1)
        vals, idx = [], []
        for m, lg in parts:
            lg = lg[:, -1]
            j = torch.argmax(lg, dim=-1)
            vals.append(torch.gather(lg, -1, j[:, None])[:, 0])
            idx.append(j + m * lg.shape[-1])
        vals = self.shards.model.collect(vals)
        idx = self.shards.model.collect(idx)
        best, arg = vals[0], idx[0]
        for v, k in zip(vals[1:], idx[1:]):
            take = v > best                 # a tie keeps the lower index
            best, arg = torch.where(take, v, best), torch.where(take, k, arg)
        return arg

    def next_tokens(self, blocks, tokens, attend) -> torch.Tensor:
        """One decode step of the batch ``tokens`` (B, 1): each local data
        block through every unit and the head. ``attend(c, i, p_attn, h)``
        gives local model shard i's attention partial in context ``c``
        (``rows``, block index ``jj``, segment ``s``, unit ``u``,
        ``window``). Returns every row's next token (B,) int32."""
        B = tokens.shape[0]
        rows = self.rows(B)
        top = self.top_blocks(blocks)
        xs = [self.embed(top, tokens[lo:hi]) for lo, hi in rows]
        for s, seg in enumerate(self.segs):
            for u in range(seg.n):
                Ws = self.unit_blocks(blocks, s, u)
                xs = [self.unit(Ws, x, lambda i, p, h, _c=dict(
                    rows=rows[jj], jj=jj, s=s, u=u, window=seg.window):
                    attend(_c, i, p, h)) for jj, x in enumerate(xs)]
        out = []
        for r, x in zip(rows, xs):
            parts = self.logits(top, x)
            if self.on_logits is not None:
                self.on_logits(r, parts)
            out.append(self.argmax(parts).to(torch.int32))
        return self.shards.data.gather(out, 0) if B % self.shards.D == 0 \
            else out[0]

    # -- the dense loop -------------------------------------------------------
    def init_decode_state(self, batch: int, s_max: int, device=None):
        """``models.model.init_decode_state`` per local data block and
        cache, each holding the shard's KV heads."""
        scfg = self.shard_config()
        return {"caches": [[M.init_decode_state(scfg, hi - lo, s_max,
                                                device)["caches"]
                            for _ in range(self.n_caches)]
                           for lo, hi in self.rows(batch)], "index": 0}

    def decode_next(self, blocks, state, tokens):
        """``models.model.decode_step`` and the greedy pick: (next tokens
        (B, 1) int32, state); the caches are written in place."""
        index = int(state["index"])

        def attend(c, i, p, h):
            cache = M.unit(state["caches"][c["jj"]][i][c["s"]], c["u"])
            return M.decode_attention(p, h, cache["self"], index, self.cfg,
                                      window=c["window"],
                                      n_heads=self.n_heads, n_kv=self.n_kv)

        nxt = self.next_tokens(blocks, tokens, attend)
        state["index"] = index + 1
        return nxt[:, None], state
