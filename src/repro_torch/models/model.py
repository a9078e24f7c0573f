"""Dense decoder model (port of the dense subset of ``repro.models.model``):
segments, parameters, embedding and logits, the FFN unit, the training
forward and loss, and single-token decode.

A model is a list of *segments*, runs of identical layer units whose
parameters are stacked along a leading unit dim. The JAX package scans
each segment with ``lax.scan``; here a Python loop walks the unit index of
the stacked tensors (``torch.unbind`` views, so backward stacks the unit
gradients once). ``jax.checkpoint`` remat becomes ``torch.utils.checkpoint``
(non-reentrant). Parameters are a nested dict of tensors with the JAX
package's tree and layouts, so checkpoints map 1:1 (``checkpoint``).

Only the dense family is ported; the others raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_gelu_mlp, apply_norm,
                                       apply_swiglu, dense_init, embed_init,
                                       init_gelu_mlp, init_norm, init_swiglu)


def check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP A.16)")


# ---------------------------------------------------------------------------
# segment protocol
# ---------------------------------------------------------------------------

@dataclass
class Segment:
    kind: str
    n: int
    window: int
    init_unit: Callable          # (gen, n, device) -> stacked unit params
    apply_unit: Callable         # (p, x, ctx) -> x
    init_cache: Callable         # (batch, s_max, n, dtype, device) -> cache
    decode_unit: Callable        # (p, x1, cache, index) -> (x1, cache)


def _rle(specs: List[str]) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for s in specs:
        if out and out[-1][0] == s:
            out[-1] = (s, out[-1][1] + 1)
        else:
            out.append((s, 1))
    return out


def apply_ffn_unit(p, x, cfg: ModelConfig, mlp=None):
    """FFN half of a dense transformer unit: ln2 + MLP (the layernorm/gelu
    family, swiglu, and the mlp-less variant). Shared by the decode unit
    here and the paged engine, which must stay bitwise-identical to this
    path. ``mlp``, where given, computes the MLP from ln2's output in
    place of ``p["mlp"]`` (the tensor-parallel split). (The JAX function
    also returns the MoE aux loss, always 0.0 for the dense family.)"""
    if "mlp" not in p:
        return torch.zeros_like(x)
    h = apply_norm(p["ln2"], x, cfg.norm)
    if mlp is not None:
        return mlp(h)
    if "w_gate" in p["mlp"]:
        return apply_swiglu(p["mlp"], h)
    return apply_gelu_mlp(p["mlp"], h)


def add_residual(p, x, a, cfg: ModelConfig, mlp=None):
    """The unit's output from its input ``x`` and its attention output
    ``a``: sequential (``x + a``, then the FFN of that), or under
    ``cfg.parallel_residual`` (stablelm-2) the FFN of ``x`` itself and
    ``x + a + f``, summed left to right as the JAX package does. Shared
    by the training and decode units, the paged engine and the
    tensor-parallel unit (``mlp`` as in ``apply_ffn_unit``), which must
    stay bitwise-identical to them."""
    if cfg.parallel_residual:
        return x + a + apply_ffn_unit(p, x, cfg, mlp)
    x = x + a
    return x + apply_ffn_unit(p, x, cfg, mlp)


def decode_attention(p, h, cache, index: int, cfg: ModelConfig, *,
                     window: int, n_heads: int = 0, n_kv: int = 0):
    """A decode unit's attention output ``o @ wo`` (B,1,d) for its normed
    input ``h``, the cache (ring buffer or full length) written in place
    at ``index``. ``n_heads`` / ``n_kv`` (default: the config's) are a
    tensor-parallel shard's heads, ``p`` its column and row blocks."""
    kw = dict(n_heads=n_heads or cfg.n_heads, n_kv=n_kv or cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)
    if "pos" in cache:
        return attn.decode_gqa_ring(p, h, cache, index, **kw)[0]
    return attn.decode_gqa(p, h, cache, index, window=window, **kw)[0]


def _mk_attn_layer(cfg: ModelConfig, *, window: int, kind: str) -> Segment:
    """Builds a Segment unit for one dense transformer layer."""
    d, dt = cfg.d_model, torch_dtype(cfg.param_dtype)
    hd = cfg.resolved_head_dim

    def init_unit(gen, n, device):
        lead = (n,)
        kw = dict(lead=lead, dtype=dt, device=device)
        p: Dict[str, Any] = {"ln1": init_norm(cfg.norm, d, **kw)}
        p["attn"] = attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads, hd,
                                  **kw)
        if cfg.d_ff > 0:
            p["ln2"] = init_norm(cfg.norm, d, **kw)
            if cfg.norm == "layernorm":
                p["mlp"] = init_gelu_mlp(gen, d, cfg.d_ff, **kw)
            else:
                p["mlp"] = init_swiglu(gen, d, cfg.d_ff, **kw)
        return p

    def apply_unit(p, x, ctx):
        h = apply_norm(p["ln1"], x, cfg.norm)
        a = attn.apply_gqa(
            p["attn"], h, ctx["positions"], n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=hd, rope_theta=cfg.rope_theta,
            causal=True, window=window, chunk=ctx["chunk"],
            flash=ctx["flash"])
        return add_residual(p, x, a, cfg)

    def init_cache(batch, s_max, n, dtype, device):
        return {"self": attn.init_gqa_cache(batch, s_max, cfg.n_kv_heads, hd,
                                            window=window, lead=(n,),
                                            dtype=dtype, device=device)}

    def decode_unit(p, x1, cache, index):
        h = apply_norm(p["ln1"], x1, cfg.norm)
        a = decode_attention(p["attn"], h, cache["self"], index, cfg,
                             window=window)
        return add_residual(p, x1, a, cfg), cache

    return Segment(kind, 1, window, init_unit, apply_unit, init_cache,
                   decode_unit)


def build_segments(cfg: ModelConfig) -> List[Segment]:
    """Returns the decoder's segment list (dense family only)."""
    check_ported(cfg)
    specs = []
    for i in range(cfg.n_layers):
        if cfg.global_every and (i % cfg.global_every != cfg.global_every - 1):
            specs.append("local")
        elif cfg.global_every:
            specs.append("global")
        else:
            specs.append("global" if not cfg.sliding_window else "local")
    segs = []
    for kind, n in _rle(specs):
        w = cfg.sliding_window if kind == "local" else 0
        s = _mk_attn_layer(cfg, window=w, kind=kind)
        s.n = n
        segs.append(s)
    return segs


def unit(tree, i: int):
    """Unit ``i`` of a stacked segment tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: unit(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator=None, device=None
                ) -> Dict[str, Any]:
    """Random parameters with the JAX package's distributions and tree.
    ``generator`` is a ``torch.Generator`` on ``device``; ``device="meta"``
    (no generator) gives the tree's shapes without allocating."""
    dt = torch_dtype(cfg.param_dtype)
    segs = build_segments(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype=dt,
                            device=device),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype=dt,
                                device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                    dtype=dt, device=device)
    params["segments"] = [s.init_unit(generator, s.n, device) for s in segs]
    return params


def _seeded(device, seed: int, *key: int):
    g = torch.Generator(device=device)
    for k in key:
        seed = (seed * 1_000_003 + k) % (1 << 62)
    g.manual_seed(seed)
    return g


def draw_params(cfg: ModelConfig, seed: int, device=None, index_of=None
                ) -> Dict[str, Any]:
    """Random parameters with ``init_params``' distributions and tree, drawn
    unit by unit: the embedding, final norm and head from a generator seeded
    (seed, 0), unit i of segment s (``init_unit`` of one unit) from one
    seeded (seed, s + 1, i). Each leaf is cut to ``index_of(keystr, whole
    shape)`` (a tuple of slices, the unit dim first for segment leaves;
    default: all of it) as it is drawn, so no whole stacked leaf exists on
    ``device`` and a shard's blocks hold the same values as the whole tree
    from the same seed. (Another stream from ``init_params``'.)"""
    dt = torch_dtype(cfg.param_dtype)
    meta = init_params(cfg, device="meta")
    if index_of is None:
        def index_of(key, shape):
            return tuple(slice(None) for _ in shape)
    g = _seeded(device, seed, 0)
    top = {"embed": embed_init(g, cfg.vocab_size, cfg.d_model, dtype=dt,
                               device=device),
           "final_norm": init_norm(cfg.norm, cfg.d_model, dtype=dt,
                                   device=device)}
    if not cfg.tie_embeddings:
        top["head"] = dense_init(g, cfg.d_model, cfg.vocab_size, dtype=dt,
                                 device=device)
    out = {key: x[index_of(key, tuple(x.shape))].clone()
           for key, x in T.keystr_items(top)}
    del top
    for s, seg in enumerate(build_segments(cfg)):
        pre = f"['segments'][{s}]"
        whole = dict(T.keystr_items(meta["segments"][s]))
        idx = {k: index_of(pre + k, tuple(x.shape)) for k, x in whole.items()}
        blocks = {k: torch.empty(x[idx[k]].shape, dtype=x.dtype,
                                 device=device) for k, x in whole.items()}
        for i in range(seg.n):
            u = dict(T.keystr_items(seg.init_unit(
                _seeded(device, seed, s + 1, i), 1, device)))
            for k, b in blocks.items():
                b[i] = u[k][0][idx[k][1:]]
            del u
        out.update({pre + k: b for k, b in blocks.items()})
    return T.unflatten_like(meta, [out[k] for k, _ in T.keystr_items(meta)])


def params_device(params) -> torch.device:
    return params["embed"].device


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def embed_rows(table, cfg, tokens):
    """``tokens``' rows of ``table`` (the embedding, or a block of its
    d_model columns) in the compute dtype, scaled as the family wants.
    ``F.embedding``: its backward sums each row's contributions in a fixed
    order, where indexing's ``index_put_`` summed them in another order
    from run to run."""
    x = F.embedding(tokens.long(), table.to(torch_dtype(cfg.compute_dtype)))
    if cfg.name.startswith("gemma"):
        x = x * (cfg.d_model ** 0.5)
    return x


def embed_tokens(params, cfg, tokens):
    return embed_rows(params["embed"], cfg, tokens)


def logits_fn(params, cfg, x):
    h = apply_norm(params["final_norm"], x, cfg.norm)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ w.to(h.dtype)


# ---------------------------------------------------------------------------
# forward / loss (training path)
# ---------------------------------------------------------------------------

def unbind_units(tree, n: int):
    """The ``n`` unit trees of a stacked segment tree, as views."""
    flat = [leaf.unbind(0) for leaf in T.leaves(tree)]
    return [T.unflatten_like(tree, [u[i] for u in flat]) for i in range(n)]


def _run_segments(segs, seg_params, x, ctx, *, remat: bool = True):
    for s, sp in zip(segs, seg_params):
        for p in unbind_units(sp, s.n):
            body = (lambda x_, _p=p, _u=s.apply_unit: _u(_p, x_, ctx))
            if remat:
                x = checkpoint(body, x, use_reentrant=False)
            else:
                x = body(x)
    return x


def _positions(B, S, device=None):
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None, :].expand(B, S)


def make_ctx(cfg, B, S, device=None, *, flash: bool = False):
    """``flash`` routes plain causal self-attention to the flash kernels
    (the port's counterpart of ``REPRO_USE_PALLAS=1`` for attention)."""
    chunk = 512 if S >= 4096 else 0
    return {"positions": _positions(B, S, device), "chunk": chunk,
            "flash": flash}


def forward_hidden(params, cfg, batch, *, remat: bool = True,
                   flash: bool = False):
    """Trunk only: returns (final hidden (B,S,d) pre-final-norm, aux); aux
    is the MoE loss in the JAX package, 0.0 for the dense family. Under
    ``remat`` each unit's forward runs again in backward, the flash
    kernel's included."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    ctx = make_ctx(cfg, B, S, tokens.device, flash=flash)
    return _run_segments(build_segments(cfg), params["segments"], x, ctx,
                         remat=remat), 0.0


def forward(params, cfg, batch, *, remat: bool = True, flash: bool = False):
    """Full-sequence logits (tests / small models)."""
    x, aux = forward_hidden(params, cfg, batch, remat=remat, flash=flash)
    return logits_fn(params, cfg, x), aux


def _ce_from_hidden(params, cfg, h_c, tgt_c, mask_c):
    """CE over one sequence chunk: head matmul, logsumexp, target logit."""
    lg = logits_fn(params, cfg, h_c).float()
    lse = torch.logsumexp(lg, dim=-1)
    tgt_logit = torch.gather(lg, -1, tgt_c.long()[..., None])[..., 0]
    nll = (lse - tgt_logit) * mask_c
    return nll.sum(), mask_c.sum()


LOSS_CHUNK = 1024      # loss_fn's chunk of the sequence for the head + CE


def loss_fn(params, cfg, batch, *, remat: bool = True,
            loss_chunk: int = LOSS_CHUNK, flash: bool = False):
    """Next-token CE. When ``loss_chunk`` divides S and is smaller, the
    head + CE goes chunk by chunk over the sequence, so the (B,S,V) f32
    logits never exist at once; backward recomputes each chunk. ``flash``
    as in ``make_ctx``."""
    h, aux = forward_hidden(params, cfg, batch, remat=remat, flash=flash)
    tokens = batch["tokens"]
    B, S = tokens.shape
    tgt = torch.cat([tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype,
                                                device=tokens.device)], 1)
    mask = torch.cat([torch.ones((B, S - 1), device=tokens.device),
                      torch.zeros((B, 1), device=tokens.device)], 1)
    if S % loss_chunk == 0 and S > loss_chunk:
        total = cnt = 0.0
        for i in range(0, S, loss_chunk):
            sl = slice(i, i + loss_chunk)
            t, c = checkpoint(_ce_from_hidden, params, cfg, h[:, sl],
                              tgt[:, sl], mask[:, sl], use_reentrant=False)
            total, cnt = total + t, cnt + c
    else:
        total, cnt = _ce_from_hidden(params, cfg, h, tgt, mask)
    loss = total / torch.clamp(cnt, min=1.0)
    return loss + aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, s_max: int,
                      device=None, dtype=None) -> Dict[str, Any]:
    """Every segment's caches (``dtype``: default the param dtype) and
    the write index 0."""
    dt = dtype or torch_dtype(cfg.param_dtype)
    caches = [s.init_cache(batch, s_max, s.n, dt, device)
              for s in build_segments(cfg)]
    return {"caches": caches, "index": 0}


def decode_step(params, cfg: ModelConfig, state, tokens):
    """tokens: (B,1) current token. Returns (logits (B,1,V), state); the
    caches in ``state`` are updated in place and ``state["index"]``
    advances."""
    index = int(state["index"])
    x1 = embed_tokens(params, cfg, tokens)
    for s, sp, cache in zip(build_segments(cfg), params["segments"],
                            state["caches"]):
        for i in range(s.n):
            x1, _ = s.decode_unit(unit(sp, i), x1, unit(cache, i), index)
    logits = logits_fn(params, cfg, x1)
    state["index"] = index + 1
    return logits, state
