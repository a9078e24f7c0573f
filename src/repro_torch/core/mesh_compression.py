"""Wire-honest mesh compression for the outer step (port of
``repro.core.mesh_compression``).

Per 2-D parameter matrix (per stacked unit, per cluster):

    P = M Q_warm ; P <- CholeskyQR(P) ; Q = M^T P          (PowerSGD step)
    payload = (pack_int4(P), scales_P, pack_int4(Q), scales_Q)
    Delta   = mean_over_clusters( unpack(payload) P Q^T )  <- only the
                                                              payload crosses
                                                              the slow axis

1-D and small leaves are quantized without low-rank. The three products
go through ``kernels.lowrank_mm.matmul`` (the CUDA kernel on the card),
one launch per leaf each, batched over the leaf's C * lead matrices; the
packs and unpacks through ``kernels.quant4``'s batched entry points, one
launch per leaf and factor (P, Q, or a quant-only leaf's rows), as the
JAX package ``vmap``s them.

Across processes the clusters axis is a ``torch.distributed`` process
group: each rank compresses its local clusters, then one all-gather per
round moves every rank's packed uint8 codes and f32 scales as one flat
byte buffer, and every rank unpacks all clusters' payloads, reconstructs
and takes the mean over clusters in cluster order. With no group the
local stack is the whole stack.

What the JAX package's ``vmap`` keeps per matrix stays per matrix here:
the zero-input guard on the warm start, the Cholesky-QR, and the int4
padding (each matrix's P and Q, and each cluster's quant-only row, is a
row of the batched pack, padded to whole blocks on its own, so a
quantization block never spans two matrices). A payload's tensors are
views of the batched pack's rows; the unpacks read them where they lie,
in the pack's outputs or in the gathered buffer.

The scales on the wire are the f32 scales the pack returns (4 bytes per
256-value block), while ``wire_bytes_tree`` keeps the JAX package's
accounting with 2-byte scales; ``gather_bytes`` counts what is sent.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core.compression import _orthonormalize, quant_wire_bytes
from repro_torch.kernels import lowrank_mm, quant4
from repro_torch.kernels.ref import col_mask


@dataclass(frozen=True)
class MeshCompressionConfig:
    rank: int = 128
    bits: int = 4      # wire format is int4 (kernels/quant4) — Alg. 1's q=4;
                       # `bits` is used by the analytic accounting only
    block: int = 256
    min_dim_for_lowrank: int = 64


def _leaf_matrix_dims(shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(n_lead, m, n): leading stacked dims (cluster/scan) are batched; the
    trailing 2 dims are the PowerSGD matrix."""
    if len(shape) <= 1:
        return (1, 1, shape[0] if shape else 1)
    m, n = shape[-2], shape[-1]
    lead = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return lead, m, n


def init_q_state(params, cfg: MeshCompressionConfig):
    """Warm-start Q per leaf: (lead..., n, r), or empty for quant-only
    leaves. Standard normal from a generator seeded by the JAX package's
    crc32 key: the same distribution, another stream."""
    def mk(x):
        shape = tuple(x.shape)
        lead, m, n = _leaf_matrix_dims(shape)
        if min(m, n) < cfg.min_dim_for_lowrank:
            return torch.zeros((0,), dtype=torch.float32, device=x.device)
        r = min(cfg.rank, m, n)
        gen = torch.Generator()
        gen.manual_seed(zlib.crc32(str((shape, "q")).encode()) % (2 ** 31))
        q = torch.randn((n, r), generator=gen).to(x.device)
        return q.expand(shape[:-2] + (n, r)).clone()

    return T.tree_map(mk, params)


# ---------------------------------------------------------------------------
# compress (local clusters) -> gather (the clusters group) -> mean
# ---------------------------------------------------------------------------

def _compress_matrices(dm, qm, rank_scalar, cfg: MeshCompressionConfig):
    """dm: (B, m, n) f32, qm: (B, n, r) warm starts. Returns the B
    matrices' payloads ``[pP, sP, pQ, sQ]`` each and q_new (B, n, r)."""
    r = qm.shape[-1]
    cm = col_mask(r, rank_scalar, dm.device)
    q_masked = qm * cm
    P = lowrank_mm.matmul(dm, q_masked)                       # (B, m, r)
    for i in range(P.shape[0]):
        P[i] = _orthonormalize(P[i]) * cm
    Q = lowrank_mm.matmul(dm.transpose(1, 2), P)              # (B, n, r)
    B = P.shape[0]
    pP, sP = quant4.quant4_pack_batched(P.reshape(B, -1), cfg.block)
    pQ, sQ = quant4.quant4_pack_batched(Q.reshape(B, -1), cfg.block)
    payloads = [[pP[i], sP[i], pQ[i], sQ[i]] for i in range(B)]
    # zero-input guard (first delayed round): never zero the warm start
    live = (Q * Q).sum(dim=(1, 2)) > 0
    q_new = torch.where(live[:, None, None], Q, q_masked)
    return payloads, q_new


def compress_local(delta_stacked, q_state, rank_scalar,
                   cfg: MeshCompressionConfig):
    """Compresses every local cluster row of every leaf. Returns
    (payloads, q_new): ``payloads[leaf][cluster]`` is a list of tensors
    (per matrix ``pP, sP, pQ, sQ`` in order for low-rank leaves; ``p, s``
    for quant-only ones), ``q_new`` the new warm starts (a tree)."""
    payloads, q_new = [], []
    for d, q in zip(T.leaves(delta_stacked), T.leaves(q_state)):
        C = d.shape[0]
        if q.numel() == 0:
            p, s = quant4.quant4_pack_batched(d.reshape(C, -1).float(),
                                              cfg.block)
            payloads.append([[p[c], s[c]] for c in range(C)])
            q_new.append(q)
            continue
        lead, m, n = _leaf_matrix_dims(tuple(d.shape[1:]))
        pays, qn = _compress_matrices(d.reshape(C * lead, m, n).float(),
                                      q.reshape(C * lead, n, q.shape[-1]),
                                      rank_scalar, cfg)
        payloads.append([sum(pays[c * lead:(c + 1) * lead], [])
                         for c in range(C)])
        q_new.append(qn.reshape(q.shape))
    return payloads, T.unflatten_like(q_state, q_new)


def _wire_order(payloads) -> List[Tuple[int, int, int, torch.Tensor]]:
    """One rank's payload tensors as (leaf, cluster, slot, tensor) in wire
    order: every f32 scale tensor, then every uint8 code tensor (so each
    scale starts 4-byte aligned in the flat buffer)."""
    parts = [(li, ci, ti, t) for li, leaf in enumerate(payloads)
             for ci, row in enumerate(leaf) for ti, t in enumerate(row)]
    return ([p for p in parts if p[3].dtype == torch.float32]
            + [p for p in parts if p[3].dtype == torch.uint8])


def gather_bytes(payloads) -> int:
    """Bytes one rank hands to the all-gather: its packed codes plus 4
    bytes per scale."""
    return sum(t.numel() * t.element_size()
               for _, _, _, t in _wire_order(payloads))


def gather_payloads(payloads, group=None):
    """All clusters' payloads, in cluster order, on every rank of the
    clusters ``group``: one all-gather of a flat uint8 buffer (every
    rank's buffer has the same layout, since every rank holds the same
    number of clusters of the same shapes). With no group the local
    payloads are all there is."""
    if group is None:
        return payloads
    from repro_torch.parallel import comm

    order = _wire_order(payloads)
    buf = torch.cat([t.reshape(-1).view(torch.uint8) for *_, t in order])
    # one storage for all ranks' buffers, so that a leaf's chunks lie at
    # a row stride inside each rank's buffer and a buffer apart across
    # ranks: the batched unpack reads them in place
    recv = torch.empty((comm.size(group), buf.numel()),
                       dtype=torch.uint8, device=buf.device)
    comm.all_gather_into(recv.view(-1), buf, group, "clusters")
    sizes = [t.numel() * t.element_size() for *_, t in order]
    out = [[] for _ in payloads]
    for rb in recv:
        rows = [[[None] * len(row) for row in leaf] for leaf in payloads]
        for (li, ci, ti, t), chunk in zip(order, torch.split(rb, sizes)):
            rows[li][ci][ti] = chunk.view(t.dtype)
        for li, leaf_rows in enumerate(rows):
            out[li].extend(leaf_rows)
    return out


def decompress_mean_leaf(rows: Sequence[List[torch.Tensor]], shape,
                         r: int, cfg: MeshCompressionConfig) -> torch.Tensor:
    """The mean over clusters of one leaf (``shape`` without the cluster
    axis) from every cluster's payload ``rows``; ``r`` is the factor
    width (0 for a quant-only leaf)."""
    shape = tuple(shape)
    C = len(rows)
    if r == 0:
        vals = quant4.quant4_unpack_batched(
            [p for p, _ in rows], [s for _, s in rows], math.prod(shape),
            cfg.block)
        return vals.mean(0).reshape(shape)
    lead, m, n = _leaf_matrix_dims(shape)
    dev = rows[0][0].device
    P = torch.empty((C * lead, m, r), dtype=torch.float32, device=dev)
    Q = torch.empty((C * lead, n, r), dtype=torch.float32, device=dev)
    for slot, F in ((0, P), (2, Q)):
        quant4.quant4_unpack_batched(
            [row[4 * i + slot] for row in rows for i in range(lead)],
            [row[4 * i + slot + 1] for row in rows for i in range(lead)],
            F[0].numel(), cfg.block, out=F.view(C * lead, -1))
    dec = lowrank_mm.matmul(P, Q.transpose(1, 2))               # (C*lead,m,n)
    del P, Q
    return dec.reshape(C, lead, m, n).mean(0).reshape(shape)


def factor_width(q: torch.Tensor) -> int:
    """r of a warm-start leaf (0 for a quant-only leaf)."""
    return 0 if q.numel() == 0 else q.shape[-1]


def compress_gather_mean(delta_stacked, q_state, rank_scalar,
                         cfg: MeshCompressionConfig, group=None):
    """delta_stacked: cluster-stacked tree (C_local, ...). Returns
    (Delta mean tree (...), new q_state). The cross-cluster data movement
    is the packed payload (uint8 codes + f32 scales)."""
    payloads, q_new = compress_local(delta_stacked, q_state, rank_scalar,
                                     cfg)
    gathered = gather_payloads(payloads, group)
    Delta = [decompress_mean_leaf(rows, d.shape[1:], factor_width(q), cfg)
             .to(d.dtype)
             for rows, d, q in zip(gathered, T.leaves(delta_stacked),
                                   T.leaves(q_state))]
    return T.unflatten_like(delta_stacked, Delta), q_new


def wire_bytes_tree(params, cfg: MeshCompressionConfig,
                    rank: Optional[int] = None) -> int:
    """Analytic per-cluster payload bytes (for the comm model; 2-byte
    scales, as the JAX package counts them)."""
    total = 0
    for x in T.leaves(params):
        lead, m, n = _leaf_matrix_dims(tuple(x.shape))
        if min(m, n) < cfg.min_dim_for_lowrank:
            total += quant_wire_bytes(lead * m * n, cfg.bits, cfg.block)
        else:
            r = min(rank if rank is not None else cfg.rank, m, n)
            total += lead * (quant_wire_bytes(m * r, cfg.bits, cfg.block)
                             + quant_wire_bytes(n * r, cfg.bits, cfg.block))
    return total
