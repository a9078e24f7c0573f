"""Pytree helpers for the port's parameter and state trees (what
``jax.tree`` gives the JAX package).

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
other leaves) at the bottom. Leaves are visited in the order
``jax.tree_util`` flattens: dict keys sorted, sequences in order,
NamedTuple fields in declaration order. So a positional zip of two trees'
leaves pairs the same entries in both packages (``LowRankQuant`` zips the
parameter leaves with their warm starts that way).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def keystr_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in flatten order; the path is the string
    ``jax.tree_util.keystr`` gives (``.params['segments'][0]['attn']``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keystr_items(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from keystr_items(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from keystr_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def leaves(tree) -> List[Any]:
    return [v for _, v in keystr_items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest`` (same
    structure); returns a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, flat: List[Any]):
    """A tree of ``tree``'s structure whose leaves are ``flat``, in flatten
    order (the inverse of ``leaves``)."""
    it = iter(flat)
    order = [k for k, _ in keystr_items(tree)]
    by_key = {k: next(it) for k in order}

    def build(t, prefix=""):
        if isinstance(t, dict):
            return {k: build(t[k], f"{prefix}[{k!r}]") for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f), f"{prefix}.{f}")
                             for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, f"{prefix}[{i}]") for i, v in enumerate(t))
        return by_key[prefix]

    return build(tree)


def bit_digest(x) -> int:
    """An exact integer digest of a tensor's bits: its f32 (or integer)
    values (+0.0 for -0.0) as int64, weighted by position and summed in
    integer arithmetic on the tensor's device. Equal digests mean equal
    bits up to the sign of zero (what ``np.array_equal`` compares), without
    copying the tensor to the host."""
    import torch

    x = x.contiguous().reshape(-1)
    if x.dtype.is_floating_point:
        x = (x.float() + 0.0).view(torch.int32)
    total = 0
    for i in range(0, x.numel(), 1 << 26):
        v = x[i:i + (1 << 26)].to(torch.int64)
        w = torch.arange(i, i + v.numel(), device=v.device) % 1000003 + 1
        total += int((v * w).sum())
    return total
