"""Work plans of the kernels that split a reduction over blocks:

- the split-K plan of the projection GEMM (``csrc/proj_gemm.cuh``), shared
  by its two users: the compressor's projections (``fused_compress``) and
  ``lowrank_mm``'s split route;
- the dK/dV and dQ plans of the flash backward
  (``csrc/flash_attention.cu``);
- the page chunks of paged decode attention
  (``csrc/paged_attention.cu``).

Each plan depends on the shape alone, never on a batch or on the
operands' strides, so every output bit is the same function of the inputs
in every call: a batched launch gives each matrix the bits of its own
launch, and a transposed view the bits of its contiguous copy.
"""
from __future__ import annotations

import functools
from typing import Tuple

BM = 128           # rows of the GEMM's output tile (its columns: r <= 64)
BK = 16            # the GEMM's K step
R_MAX = 64         # widest output the GEMM takes
MIN_CHUNK = 256    # fewest terms of a split-K chunk (but the last)
SMS = 132          # streaming multiprocessors of an H100 SXM: a constant,
                   # so the plan, and the sum order, depend on the shape alone
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=None)
def split_k(tiles: int, K: int) -> Tuple[int, int]:
    """The split-K plan ``(S, chunk)`` of a GEMM with ``tiles`` output
    tiles of BM rows and K terms per output element: split s sums terms
    [s * chunk, min(K, (s + 1) * chunk)). ``chunk`` is a multiple of the
    K step and S = ceil(K / chunk), so the chunks cover [0, K) once and
    none is empty; every chunk but the last holds at least MIN_CHUNK
    terms (or all K). Where such a plan gives two waves of blocks
    (tiles * S >= 2 * SMS), only those count; of them the plan with the
    least modelled time wins: the busiest SM's FMAs (ceil(tiles * S / SMS)
    blocks of ``chunk`` terms at the f32 rate) plus the HBM traffic of the
    S partials (written, then read by the second pass)."""
    steps = -(-K // BK)
    term_s = 2 * BM * R_MAX / (F32_FLOPS_PER_S / SMS)   # one block, one term
    plans = {}
    for c in range(min(MIN_CHUNK // BK, steps), steps + 1):
        chunk = c * BK
        S = -(-K // chunk)
        t = (-(-tiles * S // SMS) * chunk * term_s
             + (S > 1) * S * tiles * BM * R_MAX * 8 / HBM_BYTES_PER_S)
        if S not in plans or t < plans[S][0]:
            plans[S] = (t, chunk)
    wide = [S for S in plans if tiles * S >= 2 * SMS] or list(plans)
    S = min(wide, key=lambda S: (plans[S][0], S))
    return S, plans[S][1]


def row_plan(rows: int, K: int) -> Tuple[int, int, int]:
    """(tiles, S, chunk) of a GEMM with ``rows`` output rows and K terms."""
    tiles = -(-rows // BM)
    return (tiles,) + split_k(tiles, K)


def workspace_floats(S: int, elems: int) -> int:
    """Floats of the S partials of ``elems`` outputs, each ceil4(elems)
    (0 at S = 1: the GEMM writes the output)."""
    return 0 if S == 1 else S * (-(-elems // 4) * 4)


FLASH_ROWS = 64    # resident rows of a flash block (4 warps x 16)


def flash_tile(d: int) -> int:
    """Rows of the k tiles the forward and dQ kernels stream at head dim
    ``d`` (the kernels' ``tile_rows``)."""
    return 64 if d <= 64 else 32 if d == 128 else 16


def flash_q_tile(d: int) -> int:
    """Rows of the q tiles the dK/dV kernel streams at head dim ``d`` (the
    kernels' ``q_tile_rows``: 32 where it splits them to TF32 once, d <=
    64)."""
    return 32 if d <= 64 else flash_tile(d)


def flash_col_chunks(d: int) -> int:
    """dK/dV column chunks of 128 a block accumulates at head dim ``d``
    (the kernels' D / ``col_chunk``)."""
    return d // 128 if d > 128 else 1


def flash_dkdv_blocks(B: int, H: int, Sk: int, d: int, split: int) -> int:
    """Blocks of the dK/dV kernel's grid: (k tile, b * H + h, range *
    column chunks + chunk)."""
    return B * H * -(-Sk // FLASH_ROWS) * flash_col_chunks(d) * split


@functools.lru_cache(maxsize=None)
def flash_dkdv_plan(B: int, H: int, KV: int, Sq: int, Sk: int,
                    d: int) -> Tuple[int, int]:
    """``(split, parts)`` of the flash backward's dK/dV kernel. A block owns
    one (b, query head, k tile of FLASH_ROWS keys, column chunk); where
    those blocks are fewer than the card's SMS, each k tile's q tiles are
    also cut into ``split`` ranges (at most one q tile of
    ``flash_q_tile(d)`` rows each), enough for SMS blocks. ``parts`` =
    (H / KV) split partial dK/dV the sum pass adds in order (query head of
    the group, then range); at 1 the blocks write dK/dV themselves."""
    blocks = flash_dkdv_blocks(B, H, Sk, d, 1)
    split = 1
    if blocks < SMS:
        split = min(-(-SMS // blocks), -(-Sq // flash_q_tile(d)))
    return split, (H // KV) * split


@functools.lru_cache(maxsize=None)
def flash_dq_plan(B: int, H: int, Sq: int, Sk: int, d: int) -> int:
    """Ranges of k tiles (of ``flash_tile(d)`` keys) a dQ block's q tile is
    cut into: 1 where the B H ceil(Sq / FLASH_ROWS) blocks of one q tile
    each fill the card's SMS, else enough for SMS blocks, at most the k
    tiles of Sk. More than one range means as many partial dQ, summed in
    order."""
    blocks = B * H * -(-Sq // FLASH_ROWS)
    if blocks >= SMS:
        return 1
    return min(-(-SMS // blocks), -(-Sk // flash_tile(d)))


def flash_parts_floats(B: int, H: int, KV: int, Sq: int, Sk: int,
                       d: int) -> int:
    """Floats of the backward's partials at this shape: 2 parts of dk's
    size (dk's and dv's) where the dK/dV plan has more than one part, then
    the dQ plan's ranges of dq's size where it has more than one."""
    _, parts = flash_dkdv_plan(B, H, KV, Sq, Sk, d)
    dq_split = flash_dq_plan(B, H, Sq, Sk, d)
    return ((parts > 1) * 2 * parts * B * Sk * KV * d
            + (dq_split > 1) * dq_split * B * Sq * H * d)


PAGED_CHUNK_FLOATS = 4096   # most K floats of one (slot, KV head) chunk: 16 KB
PAGED_CHUNK_KEYS = 256      # most keys of a chunk (its scores stay in shared)
PAGED_THREADS = 128         # threads of a paged-attention block


@functools.lru_cache(maxsize=None)
def paged_plan(P: int, ps: int, dh: int) -> Tuple[int, int]:
    """``(pages_per_chunk, n_chunks)`` of paged decode attention with a page
    table of P pages of ``ps`` keys and head dim ``dh``.

    Chunk c holds table columns [c * pages_per_chunk, (c + 1) *
    pages_per_chunk) of every slot; one block reduces one (chunk, KV head,
    slot) to a partial (m, l, acc), and a second kernel merges a slot's
    partials in increasing chunk order. The rule: the most pages whose K
    rows of one KV head fit in PAGED_CHUNK_FLOATS floats and whose keys
    number at most PAGED_CHUNK_KEYS, at least one page and at most P;
    n_chunks = ceil(P / pages_per_chunk). A block stages its whole chunk
    (K and V) in shared memory, so the rule bounds a block's bytes and
    gives a long context many blocks per slot. It reads neither the
    slots' count S nor their lengths, so each slot's sums run in the same
    order in every batch. The KV heads only multiply the blocks, and the G
    query heads of a group share each staged row (they enter
    ``paged_smem_bytes``), so neither sizes the chunk."""
    pages = min(PAGED_CHUNK_FLOATS // (ps * dh), PAGED_CHUNK_KEYS // ps)
    pages = max(1, min(P, pages))
    return pages, -(-P // pages)


def paged_key_lanes(C: int, quads: int) -> int:
    """Lanes per key of the score loop (``csrc/paged_attention.cu::
    key_lanes``): the largest power of two at most ``quads`` (dh / 4) and
    32 with LK * C within the block's PAGED_THREADS."""
    LK = 1
    while 2 * LK <= min(quads, 32) and 2 * LK * C <= PAGED_THREADS:
        LK *= 2
    return LK


def paged_smem_bytes(pages_per_chunk: int, ps: int, G: int, dh: int) -> int:
    """Shared memory of one paged-attention block
    (``csrc/paged_attention.cu::smem_floats``): the K rows of a chunk of C =
    pages_per_chunk * ps keys at a padded pitch (``k_pitch``), its V rows
    (C, dh), q (G, dh), the P.V partial sums (4 PAGED_THREADS float4), the
    scores (G, C) and the keys' cache rows (C int32)."""
    C = pages_per_chunk * ps
    quads = dh // 4
    LK = paged_key_lanes(C, quads)
    pitch = dh + 4 * ((LK - quads) % 8 if LK < 8 else 0)
    return 4 * (C * pitch + C * dh + G * dh + 16 * PAGED_THREADS + G * C + C)
