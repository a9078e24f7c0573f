"""The placement rules (port of ``repro.parallel.sharding``, Mode A): 2-D
weight sharding = FSDP over "data" x tensor parallelism over "model", per
parameter family. Cluster-stacked leaves get a leading "clusters" axis.

A mesh is a ``{axis: size}`` mapping (or an object whose ``.shape`` is
one, as a ``jax.sharding.Mesh`` or the tests' duck-typed mesh). A
placement is a tuple with one axis name or ``None`` per dim (what
``tuple(PartitionSpec)`` gives), and a tree's placements are a
``{keystr: placement}`` dict in flatten order, keyed by the names of
``checkpoint.checkpoint._flatten``.

Rules are path+shape based:
  - expert-stacked weights (path contains 'experts'): expert dim -> "model"
    (expert parallelism), d_model dim -> "data".
  - 2-D weights (d_in, d_out): the *larger* of the two trailing dims gets
    "model" (keeps TP on the fat dim: ff/heads/vocab), the other "data".
  - the embedding table: d_model -> "model", the vocab dim whole.
  - scanned-layer leading dims and 1-D params: replicated.
A dim is only sharded if divisible by the axis size, otherwise left
replicated.

The JAX package also installs activation constraints inside the model
(``make_activation_sharder``) and lets GSPMD insert the collectives. The
port has no runtime that reads such constraints: ``parallel/tensor.py``
writes the compute split out by hand, and the layouts those constraints
name are the ones it computes in:
  - "act" (B,S,d) and "act4" (B,S,heads,dh): batch over "data" (each data
    rank's slice of the cluster's batch), d_model whole;
  - "logits" (B,S,V): batch over "data", vocab over "model" where the
    head's stored placement splits V (the vocab-parallel cross entropy);
  - "head_w" (d,V): the head's own placement;
  - "ctx3", "ctx4", "moe_buf": no dense-family counterpart.

``decode_state_placements`` stays the JAX rule, which puts "model" on the
last divisible dim of a (units, B, S, KV, hd) cache, i.e. ``hd``. The
serving path (``parallel/tensor.py::TPDecode``) stores the cache split by
KV head instead, the split its attention and the paged kernel read, so
no cache is gathered per token: the same 1/M of the bytes a card.
``serve_blocks`` cuts a whole tree, or a checkpoint's arrays leaf by
leaf, into one rank's serving blocks.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch

from repro_torch import tree as T

Placement = Tuple[Optional[str], ...]


def _sizes(mesh) -> Mapping[str, int]:
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def _divisible(n: int, mesh, axis: str) -> bool:
    return n % _sizes(mesh)[axis] == 0


def spec_for_param(path_names, shape: Tuple[int, ...], mesh, *,
                   cluster_stacked: bool, n_scan_dims: int) -> Placement:
    """The placement of one parameter leaf.

    n_scan_dims: number of leading stacked dims that are scan/cluster dims
    (cluster dim first if cluster_stacked, then segment-stack dim)."""
    names = [str(n) for n in path_names]
    lead: List[Optional[str]] = []
    if cluster_stacked:
        lead.append("clusters" if _divisible(shape[0], mesh, "clusters")
                    else None)
    while len(lead) < n_scan_dims:
        lead.append(None)
    body_shape = shape[n_scan_dims:]
    is_expert = any("experts" in n for n in names)
    if len(body_shape) == 0:
        entries = lead
    elif len(body_shape) == 1:
        entries = lead + [None]
    elif is_expert and len(body_shape) >= 3:
        # (E, d_in, d_out): expert parallel + FSDP on d_in
        e, din = body_shape[-3], body_shape[-2]
        entries = lead + [None] * (len(body_shape) - 3)
        entries += ["model" if _divisible(e, mesh, "model") else None,
                    "data" if _divisible(din, mesh, "data") else None,
                    None]
    else:
        # generic 2D+ weight: fat trailing dim -> model, other -> data
        din, dout = body_shape[-2], body_shape[-1]
        mid = [None] * (len(body_shape) - 2)
        if dout >= din:
            a = "data" if _divisible(din, mesh, "data") else None
            b = "model" if _divisible(dout, mesh, "model") else None
        else:
            a = "model" if _divisible(din, mesh, "model") else None
            b = "data" if _divisible(dout, mesh, "data") else None
        entries = lead + mid + [a, b]
    return tuple(entries)


def _named_items(tree, prefix: str = "", names=()
                 ) -> Iterator[Tuple[str, List[str], Any]]:
    """(keystr, path names, leaf) in flatten order; the names are the JAX
    rule's: a dict key's string, ``""`` for a list index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_items(tree[k], f"{prefix}[{k!r}]",
                                    names + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _named_items(getattr(tree, f), f"{prefix}.{f}",
                                    names + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_items(v, f"{prefix}[{i}]", names + ("",))
    else:
        yield prefix, list(names), tree


def param_placements(params, mesh, *, cluster_stacked: bool,
                     serve: bool = False) -> Dict[str, Placement]:
    """The placement of every leaf of an (optionally cluster-stacked)
    parameter tree (the JAX ``param_shardings``; leaves need ``.shape``
    only, so a ``meta`` tree will do).

    serve=True: weights shard over "model" ONLY (no FSDP dim), for decode,
    which is latency-bound."""
    out = {}
    for key, names, leaf in _named_items(params):
        shape = tuple(leaf.shape)
        if any(n == "embed" for n in names):
            # embedding table: d_model -> "model" (the lookup stays local
            # in vocab)
            lead = (["clusters"] if cluster_stacked
                    and _divisible(shape[0], mesh, "clusters") else
                    [None] * (1 if cluster_stacked else 0))
            spec = tuple(lead) + (
                None, "model" if _divisible(shape[-1], mesh, "model")
                else None)
        else:
            # scan dims: the cluster dim (if stacked) and the unit dim of
            # leaves under 'segments'
            n_scan = (1 if cluster_stacked else 0)
            if any("segments" in n for n in names):
                n_scan += 1
            n_scan = min(n_scan, max(0, len(shape) - 1))
            spec = spec_for_param(names, shape, mesh,
                                  cluster_stacked=cluster_stacked,
                                  n_scan_dims=n_scan)
        if serve:   # drop the "data" (FSDP) dim; keep tensor parallelism
            spec = tuple(None if e == "data" else e for e in spec)
        out[key] = spec
    return out


def batch_placements(batch, mesh, *, cluster_stacked: bool
                     ) -> Dict[str, Placement]:
    """Tokens/labels/frontend: leading (cluster,) batch dims sharded."""
    out = {}
    for key, leaf in T.keystr_items(batch):
        dims: List[Optional[str]] = []
        if cluster_stacked:
            dims.append("clusters")
        dims.append("data" if _divisible(leaf.shape[len(dims)], mesh, "data")
                    else None)
        dims += [None] * (len(leaf.shape) - len(dims))
        out[key] = tuple(dims)
    return out


def decode_state_placements(state, mesh, *, seq_shard: bool
                            ) -> Dict[str, Placement]:
    """KV caches for serving. Batched decode shards batch over "data";
    long-context (batch=1) shards the cache sequence dim over "data"
    instead (context parallelism). Heads/state dims go to "model".

    Cache leaves look like (n_units, B, S, KV, hd) / (n_units, B, S)."""
    sizes = _sizes(mesh)
    out = {}
    for key, names, leaf in _named_items(state):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            out[key] = ()
            continue
        shape = tuple(leaf.shape)
        dims: List[Optional[str]] = [None] * len(shape)
        if len(shape) >= 2:
            # dim 1 is batch for unit-stacked caches
            bdim = 1 if len(shape) >= 3 else 0
            if not seq_shard and _divisible(shape[bdim], mesh, "data"):
                dims[bdim] = "data"
            if seq_shard and len(shape) >= 4 and "pos" not in names[-1:]:
                if _divisible(shape[2], mesh, "data"):
                    dims[2] = "data"
            # shard a heads-like dim over model if present & divisible
            for di in range(len(shape) - 1, 1, -1):
                if dims[di] is None and _divisible(shape[di], mesh, "model") \
                        and shape[di] >= sizes["model"] and di != 2:
                    dims[di] = "model"
                    break
        out[key] = tuple(dims)
    return out


def replicated(tree) -> Dict[str, Placement]:
    return {key: () for key, _ in T.keystr_items(tree)}


# ---------------------------------------------------------------------------
# blocks: what a rank at mesh coordinates holds of a placed leaf
# ---------------------------------------------------------------------------

def block_slices(shape, placement: Placement, mesh,
                 coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index of the block of a leaf of ``shape`` that the rank at
    ``coords`` (``{axis: index}``) holds: each dim placed on an axis is
    cut into that axis's size of equal parts."""
    sizes = _sizes(mesh)
    out = []
    for n, axis in zip(shape, tuple(placement) + (None,) * len(shape)):
        if axis is None:
            out.append(slice(None))
        else:
            w = n // sizes[axis]
            out.append(slice(coords[axis] * w, (coords[axis] + 1) * w))
    return tuple(out)


def shard_tree(tree, placements: Dict[str, Placement], mesh,
               coords: Mapping[str, int]):
    """The blocks of ``tree`` (tensors or numpy arrays) that the rank at
    ``coords`` holds, as copies: the bridge that carries whole trees (the
    JAX package's, as numpy) into a rank's state."""
    def cut(key, x):
        blk = x[block_slices(x.shape, placements[key], mesh, coords)]
        return blk.clone() if isinstance(blk, torch.Tensor) else blk.copy()

    return T.unflatten_like(tree, [cut(k, x) for k, x in T.keystr_items(tree)])


def unshard_leaf(blocks: List[Tuple[Mapping[str, int], Any]],
                 placement: Placement, mesh):
    """A whole leaf from ``(coords, block)`` pairs that cover it (the
    inverse of ``shard_tree`` for one leaf; replicated copies may repeat)."""
    coords0, b0 = blocks[0]
    sizes = _sizes(mesh)
    shape = [n * (sizes[a] if a is not None else 1) for n, a in zip(
        b0.shape, tuple(placement) + (None,) * len(b0.shape))]
    if isinstance(b0, torch.Tensor):
        whole = b0.new_empty(shape)
    else:
        import numpy as np
        whole = np.empty(shape, dtype=b0.dtype)
    for coords, b in blocks:
        whole[block_slices(shape, placement, mesh, coords)] = b
    return whole


def unshard_tree(blocks: List[Tuple[Mapping[str, int], Any]],
                 placements: Dict[str, Placement], mesh):
    """The whole tree from every rank's ``(coords, block tree)``."""
    flat = [T.keystr_items(t) for _, t in blocks]
    items = list(zip(*flat))
    leaves = [unshard_leaf([(c, x) for (c, _), (_, x) in zip(blocks, row)],
                           placements[row[0][0]], mesh) for row in items]
    return T.unflatten_like(blocks[0][1], leaves)


def serve_blocks(flat: Mapping[str, Any], index_of, like, device, *,
                 allow_stacked: bool = False):
    """One rank's serving blocks of a whole parameter tree given as
    ``{keystr: array}`` (a tree's ``tree.keystr_items``, or a JAX
    checkpoint's arrays, which may be an ``np.load`` archive read leaf by
    leaf): each leaf cut to ``index_of(keystr, whole shape)`` (e.g.
    ``parallel.tensor.serve_index``) where it lies, then carried to
    ``device``, so no whole stacked leaf is ever on the card. ``like``
    (e.g. ``init_params(cfg, device="meta")``) gives the tree, its shapes
    and dtypes. NumPy blocks cross through the weight bridge
    (``checkpoint.tree_from_flat``, which ``params_from_flat`` is), with
    ``allow_stacked`` taking row 0 of a cluster-stacked leaf."""
    import numpy as np

    from repro_torch.checkpoint import checkpoint as ckpt

    out, shapes = {}, {}
    for key, ref in T.keystr_items(like):
        shape = tuple(ref.shape)
        x = flat[key]
        if allow_stacked and tuple(x.shape) != shape \
                and tuple(x.shape[1:]) == shape:
            x = x[0]
        if tuple(x.shape) != shape:
            raise ValueError(f"{key}: array shape {tuple(x.shape)} vs model "
                             f"{shape}")
        blk = x[index_of(key, shape)]
        out[key] = (blk.to(device=device, dtype=ref.dtype, copy=True)
                    .contiguous() if isinstance(blk, torch.Tensor)
                    else np.ascontiguousarray(blk))
        shapes[key] = torch.empty(blk.shape, dtype=ref.dtype, device="meta")
        del x
    if any(isinstance(v, torch.Tensor) for v in out.values()):
        return T.unflatten_like(like, [out[k] for k, _ in
                                       T.keystr_items(like)])
    return ckpt.tree_from_flat(out, T.unflatten_like(
        like, [shapes[k] for k, _ in T.keystr_items(like)]), device)
