"""Pseudo-gradient compressors (port of ``repro.core.compression``, paper
§2.4).

The DiLoCoX compressor (Alg. 1) is ``Quantize_q o LowRank_r``: a
single-iteration PowerSGD projection with a persistent warm-start Q per
2-D-reshaped parameter, then block-wise symmetric int-q quantization of
both factors. Baselines: Top-K, random sparsification, CocktailSGD
(random o top-k o quant), fp16 (OpenDiLoCo), quantization only. The two
random baselines draw their masks from torch generators seeded by (seed,
step, leaf path), so the masks match the JAX package's in law, not in
bits (its stream is threefry).

Trees are the port's nested dicts/lists (``repro_torch.tree``); leaves are
zipped in ``jax.tree_util`` flatten order, so a warm-start tree carried
over from the JAX package lines up leaf for leaf.

Adaptive rank: factors are allocated at ``r_max`` and columns >= r_t are
zero-masked; wire-byte accounting uses r_t.
"""
from __future__ import annotations

import hashlib
import math
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as T


# ---------------------------------------------------------------------------
# quantization (simulation numerics; kernels/quant4.py is the wire format)
# ---------------------------------------------------------------------------

def quantize_sim(x: torch.Tensor, bits: int, block: int = 256) -> torch.Tensor:
    """Symmetric per-block quantize -> dequantize. The scale is
    ``amax * f32(1/qmax)``, as the jitted JAX function computes it (XLA
    turns the division by the constant into a reciprocal multiply)."""
    if bits >= 32:
        return x
    if bits == 16:
        return x.to(torch.bfloat16).to(x.dtype)
    n = x.numel()
    pad = (-n) % block
    xf = torch.nn.functional.pad(x.reshape(-1).float(), (0, pad))
    xf = xf.reshape(-1, block)
    qmax = 2.0 ** (bits - 1) - 1
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    scale = xf.abs().amax(dim=1, keepdim=True) * inv
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax)
    out = (q * scale).reshape(-1)[:n].reshape(x.shape)
    return out.to(x.dtype)


def quant_wire_bytes(n_elems: int, bits: int, block: int = 256) -> int:
    payload = math.ceil(n_elems * bits / 8)
    scales = math.ceil(n_elems / block) * 2          # bf16 scales
    return payload + scales


# ---------------------------------------------------------------------------
# 2-D reshape helpers (PowerSGD operates per matrix)
# ---------------------------------------------------------------------------

def to_matrix(x: torch.Tensor) -> torch.Tensor:
    if x.dim() <= 1:
        return x.reshape(1, -1)
    return x.reshape(-1, x.shape[-1])


def matrix_shape(shape: Tuple[int, ...]) -> Tuple[int, int]:
    if len(shape) <= 1:
        return (1, math.prod(shape) if shape else 1)
    return (math.prod(shape[:-1]), shape[-1])


def _orthonormalize(P: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Cholesky-QR: G = P^T P + eps_rel*I, P <- P L^{-T}; zero (rank-masked)
    columns stay zero.

    eps is RELATIVE to mean(diag(G)): pseudo-gradients are ~1e-2 scale, so
    an absolute 1e-6 ridge dominates P^T P and mangles the reconstruction
    (the JAX package's training silently stalled with one)."""
    Pf = P.float()
    r = Pf.shape[-1]
    G = Pf.T @ Pf
    scale = torch.trace(G) / r
    ridge = eps * torch.clamp(scale, min=1e-30) + 1e-30
    eye = torch.eye(r, dtype=torch.float32, device=P.device)
    L = torch.linalg.cholesky(G + ridge * eye)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    out = Pf @ Linv.T
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# compressor protocol
# ---------------------------------------------------------------------------

class Compressor:
    """``roundtrip(tree, state, rank_scalar) -> (tree_hat, state)``;
    ``wire_bytes(tree_shapes)`` is the analytic on-the-wire size."""

    name = "identity"

    def init_state(self, params) -> Any:
        return torch.zeros((), dtype=torch.int32,
                           device=T.leaves(params)[0].device)

    def roundtrip(self, tree, state, rank_scalar=None):
        return tree, state

    def wire_bytes(self, shapes: Dict[str, Tuple[int, ...]],
                   rank: Optional[int] = None) -> int:
        return sum(math.prod(s) * 4 for s in shapes.values())

    def wire_bytes_per_edge(self, shapes: Dict[str, Tuple[int, ...]],
                            ranks: Dict[int, int]) -> Dict[int, int]:
        return {c: int(self.wire_bytes(shapes, rank=r))
                for c, r in ranks.items()}


def tree_shapes(tree) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(x.shape) for k, x in T.keystr_items(tree)}


@dataclass
class Identity(Compressor):
    name: str = "allreduce_fp32"


@dataclass
class FP16(Compressor):
    """OpenDiLoCo's FP16 pseudo-gradient compression (bf16 numerics, as in
    the JAX package)."""
    name: str = "fp16"

    def roundtrip(self, tree, state, rank_scalar=None):
        return T.tree_map(lambda x: x.to(torch.bfloat16).to(x.dtype),
                          tree), state

    def wire_bytes(self, shapes, rank=None):
        return sum(math.prod(s) * 2 for s in shapes.values())


@dataclass
class QuantOnly(Compressor):
    bits: int = 4
    block: int = 256
    name: str = "quant"

    def roundtrip(self, tree, state, rank_scalar=None):
        return T.tree_map(lambda x: quantize_sim(x, self.bits, self.block),
                          tree), state

    def wire_bytes(self, shapes, rank=None):
        return sum(quant_wire_bytes(math.prod(s), self.bits, self.block)
                   for s in shapes.values())


# ---------------------------------------------------------------------------
# DiLoCoX: LowRank r o Quantize q  (Alg. 1)
# ---------------------------------------------------------------------------

@dataclass
class LowRankQuant(Compressor):
    rank: int = 64                 # r_max (adaptive r_t <= rank)
    bits: int = 4
    block: int = 256
    min_dim_for_lowrank: int = 64  # small tensors skip the low-rank stage
    name: str = "diloco_x"
    # "ref": the unfused op chain in plain PyTorch. "pallas" (the JAX
    # package's name, kept so configs carry across): the fused pipeline of
    # kernels/fused_compress.py and kernels/quant4.py, i.e. the hand-written
    # CUDA kernels for CUDA tensors and their plain versions for CPU
    # tensors. Same wire format bit for bit, reconstruction within a
    # reordering ulp bound of the ref chain, same adaptive-rank masking.
    backend: str = "ref"

    def __post_init__(self):
        if self.backend not in ("ref", "pallas"):
            raise ValueError(f"backend must be 'ref' or 'pallas', "
                             f"got {self.backend!r}")
        if self.backend == "pallas" and self.bits != 4:
            raise ValueError("the pallas backend implements the int4 wire "
                             f"format (bits=4); got bits={self.bits}")

    def init_state(self, params) -> Any:
        """Warm-start Q per matrix-shaped param (PowerSGD memory), standard
        normal from a generator seeded by crc32 of the shape, as the JAX
        package keys it (another stream: parity tests carry JAX's over)."""
        def mk(x):
            m, n = matrix_shape(tuple(x.shape))
            if min(m, n) < self.min_dim_for_lowrank:
                return torch.zeros((0,), dtype=torch.float32, device=x.device)
            r = min(self.rank, m, n)
            gen = torch.Generator()
            gen.manual_seed(zlib.crc32(str(tuple(x.shape)).encode())
                            % (2 ** 31))
            return torch.randn((n, r), generator=gen).to(x.device)
        return T.tree_map(mk, params)

    def _quant_only_fused(self, x):
        """quantize_sim through the quant4 pack and unpack kernels."""
        from repro_torch.kernels.quant4 import quant4_pack, quant4_unpack

        flat = x.reshape(-1).float().contiguous()
        p, s = quant4_pack(flat, self.block)
        out = quant4_unpack(p, s, flat.numel(), self.block)
        return out.reshape(x.shape).to(x.dtype)

    def _one(self, x, q_prev, rank_scalar):
        if q_prev.numel() == 0:     # quant-only path for small/1-D tensors
            if self.backend == "pallas":
                return self._quant_only_fused(x), q_prev
            return quantize_sim(x, self.bits, self.block), q_prev
        M = to_matrix(x).float()
        if self.backend == "pallas":
            from repro_torch.kernels.fused_compress import fused_compress_ef
            hat, _, q_new, _ = fused_compress_ef(
                M, None, q_prev, rank_scalar, block=self.block,
                compute_error=False)
            return hat.reshape(x.shape).to(x.dtype), q_new
        from repro_torch.kernels.ref import col_mask
        cm = col_mask(q_prev.shape[1], rank_scalar, x.device)
        P = M @ (q_prev * cm)                        # (m, r)
        P = _orthonormalize(P) * cm
        Q = M.T @ P                                  # (n, r)
        Pq = quantize_sim(P, self.bits, self.block)
        Qq = quantize_sim(Q, self.bits, self.block)
        out = (Pq @ Qq.T).reshape(x.shape).to(x.dtype)
        # zero-input guard: with the one-step delay the FIRST pending delta
        # is all-zero; M.T P == 0 would zero the warm start and the
        # compressor never recovers (P = M @ 0 forever). Keep q_prev then.
        q_new = torch.where((Q * Q).sum() > 0, Q, q_prev * cm)
        return out, q_new        # warm start with the *unquantized* Q

    def roundtrip(self, tree, state, rank_scalar=None):
        flat = T.leaves(tree)
        flat_q = T.leaves(state)
        outs, new_q = [], []
        for x, q in zip(flat, flat_q):
            o, nq = self._one(x, q, rank_scalar)
            outs.append(o)
            new_q.append(nq)
        return T.unflatten_like(tree, outs), T.unflatten_like(tree, new_q)

    def wire_bytes(self, shapes, rank=None):
        r_eff = rank if rank is not None else self.rank
        total = 0
        for s in shapes.values():
            m, n = matrix_shape(s)
            if min(m, n) < self.min_dim_for_lowrank:
                total += quant_wire_bytes(m * n, self.bits, self.block)
            else:
                r = min(r_eff, self.rank, m, n)
                total += quant_wire_bytes((m + n) * r, self.bits, self.block)
        return total


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

@dataclass
class TopK(Compressor):
    ratio: float = 0.01
    name: str = "topk"

    def roundtrip(self, tree, state, rank_scalar=None):
        def one(x):
            flat = x.reshape(-1)
            k = max(1, int(flat.numel() * self.ratio))
            _, idx = torch.topk(flat.abs(), k)
            mask = torch.zeros_like(flat)
            mask[idx] = 1.0
            return (flat * mask).reshape(x.shape)
        return T.tree_map(one, tree), state

    def wire_bytes(self, shapes, rank=None):
        total = 0
        for s in shapes.values():
            k = max(1, int(math.prod(s) * self.ratio))
            total += k * 4 + k * 4          # values + int32 indices
        return total


def _mask_seed(seed: int, step: int, path: str) -> int:
    """A 63-bit generator seed from (seed, step, crc32 of the leaf's keystr
    path) alone, the three numbers the JAX package folds into its key."""
    crc = zlib.crc32(path.encode()) % (2 ** 31)
    digest = hashlib.blake2b(struct.pack("<qqq", seed, step, crc),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _mask(seed: int, step: int, path: str, shape, ratio: float,
          device) -> torch.Tensor:
    """The random mask of one leaf at one step: uniform draws < ``ratio``
    from a ``torch.Generator`` on ``device`` seeded by ``_mask_seed``. It
    depends on nothing else, so every cluster (and every rank) draws the
    same mask, as the JAX package's clusters do under one key. Torch's
    stream is not threefry: the parity tests pass JAX's mask in."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mask_seed(seed, step, path))
    return torch.rand(tuple(shape), generator=gen, device=device) < ratio


def random_sparse_apply(x: torch.Tensor, mask: torch.Tensor,
                        ratio: float) -> torch.Tensor:
    """Random sparsification given the mask: kept values scaled by
    1 / ratio (unbiased), the rest 0. The scale is x * f32(1 / f32(ratio)),
    as the jitted JAX function computes x / ratio (XLA turns the division
    by a constant into a multiply by its f32 reciprocal)."""
    r = torch.tensor(ratio, dtype=torch.float32, device=x.device)
    kept = x * (torch.ones_like(r) / r)
    return torch.where(mask, kept, torch.zeros_like(kept))


def cocktail_apply(x: torch.Tensor, mask: torch.Tensor, random_ratio: float,
                   topk_ratio: float, bits: int) -> torch.Tensor:
    """CocktailSGD given the random mask: the sampled values, the k =
    max(1, int(n random_ratio topk_ratio)) largest of them in magnitude,
    then ``quantize_sim``."""
    flat = x.reshape(-1)
    sampled = torch.where(mask.reshape(-1), flat, torch.zeros_like(flat))
    k = max(1, int(flat.numel() * random_ratio * topk_ratio))
    _, idx = torch.topk(sampled.abs(), k)
    tmask = torch.zeros_like(flat)
    tmask[idx] = 1.0
    return quantize_sim(sampled * tmask, bits).reshape(x.shape)


@dataclass
class RandomSparse(Compressor):
    ratio: float = 0.1
    seed: int = 0
    name: str = "random_sparse"

    def roundtrip(self, tree, state, rank_scalar=None):
        step = int(state)
        leaves = [random_sparse_apply(
            x, _mask(self.seed, step, path, x.shape, self.ratio, x.device),
            self.ratio) for path, x in T.keystr_items(tree)]
        return T.unflatten_like(tree, leaves), state + 1

    def wire_bytes(self, shapes, rank=None):
        # the seed is free; the values are ratio * n
        return sum(int(math.prod(s) * self.ratio) * 4
                   for s in shapes.values())


@dataclass
class CocktailSGD(Compressor):
    """Random sparsify -> Top-K within the sample -> quantize (Wang et al.
    2023). Ratios per the paper's §4.1.3 hyperparameters."""
    random_ratio: float = 0.1
    topk_ratio: float = 0.08
    bits: int = 4
    seed: int = 0
    name: str = "cocktail"

    def roundtrip(self, tree, state, rank_scalar=None):
        step = int(state)
        leaves = [cocktail_apply(
            x, _mask(self.seed, step, path, (x.numel(),), self.random_ratio,
                     x.device),
            self.random_ratio, self.topk_ratio, self.bits)
            for path, x in T.keystr_items(tree)]
        return T.unflatten_like(tree, leaves), state + 1

    def wire_bytes(self, shapes, rank=None):
        total = 0
        for s in shapes.values():
            k = max(1, int(math.prod(s) * self.random_ratio
                           * self.topk_ratio))
            total += quant_wire_bytes(k, self.bits) + k * 4   # + indices
        return total


def make_compressor(name: str, **kw) -> Compressor:
    table = {"identity": Identity, "allreduce_fp32": Identity, "fp16": FP16,
             "quant": QuantOnly, "diloco_x": LowRankQuant,
             "lowrank_quant": LowRankQuant, "topk": TopK,
             "random_sparse": RandomSparse, "cocktail": CocktailSGD}
    return table[name](**kw)
