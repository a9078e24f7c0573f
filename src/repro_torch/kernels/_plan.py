"""Work plans of the kernels that split a reduction over blocks:

- the split-K plan of the projection GEMM (``csrc/proj_gemm.cuh``), shared
  by its two users: the compressor's projections (``fused_compress``) and
  ``lowrank_mm``'s split route;
- the forward's k-range plan and the dK/dV and dQ plans of flash
  attention (``csrc/flash_attention.cu``);
- the page chunks of paged decode attention
  (``csrc/paged_attention.cu``).

Each plan depends on the shape and the element type alone (``esize``,
the bytes of an element: 4 for float32, 2 for bfloat16), never on a batch,
the lengths or the operands' strides, so every output bit is the same
function of the inputs in every call: a batched launch gives each matrix
the bits of its own launch, and a transposed view the bits of its
contiguous copy.
"""
from __future__ import annotations

import functools
import heapq
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
SM_SMEM = 233_472  # shared memory of an H100 SM (228 KB) ...
BLOCK_SMEM = 1_024  # ... of which each resident block reserves 1 KB
FLASH_BLOCK_TILES = 2   # a block's set-up and write-out, in its streamed tiles
FLASH_MERGE_TILES = 2   # the merge or sum pass of the partials, likewise
FLASH_CHUNK_STEPS = 32  # the range planner tries chunks at n / 32 steps


FLASH_FWD_BLOCKS_BF16 = {32: 4, 64: 3, 128: 2, 256: 2}
# the bf16 backward's (dK/dV, dQ) blocks an SM (WgmmaBwd's KV_BLOCKS,
# Q_BLOCKS): one block of two warpgroups at d = 256
FLASH_BWD_BLOCKS_BF16 = {32: (3, 4), 64: (3, 3), 128: (2, 2), 256: (1, 1)}


def flash_tile(d: int, esize: int = 4) -> int:
    """Rows of the k tiles the forward kernel streams at head dim ``d``:
    the f32 kernel's ``tile_rows`` (64, 64, 32, 16), or the bf16
    ``wgmma`` kernel's ``WgmmaFwd::BK`` (the N of its S product: 64, and
    32 at d = 256, where the O accumulator takes 128 registers a
    thread)."""
    if esize == 2:
        return 32 if d == 256 else 64
    return 64 if d <= 64 else 32 if d == 128 else 16


def flash_fwd_blocks(d: int, esize: int = 4) -> int:
    """Forward blocks an SM holds, the kernel's launch bound: 2 in f32; in
    bf16 (``WgmmaFwd::BLOCKS``) 4, 3, 2, 2 at d = 32, 64, 128, 256, each
    block taking that share of the SM's shared memory
    (``flash_fwd_smem``), its S, P and O in the registers the bound
    leaves a thread."""
    return FLASH_FWD_BLOCKS_BF16[d] if esize == 2 else 2


def flash_dq_tile(d: int, esize: int = 4) -> int:
    """Rows of the k tiles the dQ kernel streams at head dim ``d``: the f32
    kernel's ``dq_tile_rows`` (16 at d >= 128, so that two blocks share an
    SM at d = 128), or the bf16 ``wgmma`` kernel's ``WgmmaBwd::BK`` (the N
    of its S and dP products: 64, and 32 at d = 256)."""
    if esize == 2:
        return 32 if d == 256 else 64
    return 64 if d <= 64 else 16


def flash_q_tile(d: int, esize: int = 4) -> int:
    """Rows of the q tiles the dK/dV kernel streams at head dim ``d``: the
    f32 kernel's ``q_tile_rows`` (32 where it splits them to TF32 once, d
    <= 64, else 16), or the bf16 ``wgmma`` kernel's ``WgmmaBwd::BQ`` (the
    N of its S^T and dP^T products: 64, and 32 at d >= 128, where the dK
    and dV accumulators take 128 registers a thread)."""
    if esize == 2:
        return 32 if d >= 128 else 64
    return 32 if d <= 64 else 16


def flash_groups(d: int) -> int:
    """Warp groups of 4 warps in a backward block (the kernels'
    ``groups``): two at d = 256, which split S and dP and each own half of
    the dK/dV (dQ) columns, else one."""
    return 2 if d == 256 else 1


def flash_pitch(d: int, esize: int = 4) -> int:
    """Elements of a tile row in shared memory: d and 16 bytes (the
    kernels' ``pitch``)."""
    return d + 16 // esize


def _xchg_floats(d: int, rows: int) -> int:
    # the P / dP exchange of a two-group block: 2 groups x 4 warps x the
    # warp's C fragments (rows / 8 n-tiles of 4 floats a lane)
    return 2 * 4 * (rows // 8) * 4 * 32 if flash_groups(d) == 2 else 0


# The three sizes below model csrc/flash_attention.cu's fwd_smem, dkdv_smem
# and dq_smem; chip_smoke.py phase 3c and tests/test_torch_cuda.py hold
# them, and flash_blocks_per_sm, to the library's flash_attention_occupancy
# (and flash_attention_occupancy_bf16). f32 tiles are padded to a pitch of
# d + 4 floats; lse, D and the exchange are f32. A bf16 ``wgmma`` block
# (the forward, dK/dV and dQ) asks for the SM's share of one of its launch
# bound's blocks, which holds its ``mbarrier``s, up to 1 KB that aligns
# the swizzled, unpadded tiles, the resident tiles and as many ring stages
# as fit (``WgmmaFwd::STAGES``, ``WgmmaBwd::KV_STAGES``, ``Q_STAGES``).
def flash_fwd_smem(d: int, esize: int = 4) -> int:
    """Shared memory bytes of a forward block (``launch_fwd``). f32: the
    resident Q tile and two stages of K and V tiles. bf16: the SM's
    share of one of ``flash_fwd_blocks`` blocks (the Q tile and the K and
    V ring)."""
    if esize == 2:
        return SM_SMEM // flash_fwd_blocks(d, 2) - BLOCK_SMEM
    return esize * (FLASH_ROWS + 4 * flash_tile(d)) * flash_pitch(d, esize)


def flash_bwd_blocks(d: int, esize: int = 4) -> Tuple[int, int]:
    """(dK/dV, dQ) blocks an SM the backward kernels' launch bounds
    promise: in f32 two blocks of 4 warps, one of 8 at d = 256; in bf16
    ``WgmmaBwd``'s KV_BLOCKS and Q_BLOCKS (3/4, 3/3, 2/2, 1/1 at d = 32,
    64, 128, 256), what the registers of each block's accumulators, score
    tiles and bf16 fragments leave room for."""
    if esize == 2:
        return FLASH_BWD_BLOCKS_BF16[d]
    blocks = 2 // flash_groups(d)
    return blocks, blocks


def flash_dkdv_smem(d: int, esize: int = 4) -> int:
    """Shared memory bytes of a dK/dV block (``launch_bwd``). f32: resident
    K and V, two stages of (Q, dO, lse, D) tiles, the TF32 parts of a Q
    and a dO tile at d <= 64, the P / dP exchange at d = 256. bf16: the
    SM's share of one of ``flash_bwd_blocks``'s dK/dV blocks (resident K
    and V, the Q and dO ring, two lse and D slices, the exchange)."""
    if esize == 2:
        return SM_SMEM // flash_bwd_blocks(d, 2)[0] - BLOCK_SMEM
    bq, ld = flash_q_tile(d), flash_pitch(d)
    presplit = d <= 64
    return (4 * (2 * FLASH_ROWS * ld + 4 * bq * ld)
            + 4 * (4 * bq + presplit * 4 * bq * ld + _xchg_floats(d, bq)))


def flash_dq_smem(d: int, esize: int = 4) -> int:
    """Shared memory bytes of a dQ block (``launch_bwd``). f32: resident Q
    and dO, two stages of K and V tiles, the P / dP exchange at d = 256.
    bf16: the SM's share of one of ``flash_bwd_blocks``'s dQ blocks
    (resident Q and dO, the K and V ring, the exchange)."""
    if esize == 2:
        return SM_SMEM // flash_bwd_blocks(d, 2)[1] - BLOCK_SMEM
    bt, ld = flash_dq_tile(d), flash_pitch(d)
    return 4 * (2 * FLASH_ROWS * ld + 4 * bt * ld) + 4 * _xchg_floats(d, bt)


def flash_blocks_per_sm(smem: int, bound: int = 2) -> int:
    """Blocks of one flash kernel an SM holds at once: as many as its
    shared memory fits, at most ``bound``, what the kernel's launch bounds
    promise (``flash_fwd_blocks``, ``flash_bwd_blocks``; 2 for the f32
    kernels of 4 warps)."""
    return max(1, min(bound, SM_SMEM // (smem + BLOCK_SMEM)))


def flash_warps_per_sm(d: int, esize: int = 4) -> Tuple[int, int, int]:
    """Resident warps per SM of the forward, dK/dV and dQ kernels at head
    dim ``d``."""
    warps = 4 * flash_groups(d)
    kv, q = flash_bwd_blocks(d, esize)
    return (4 * flash_blocks_per_sm(flash_fwd_smem(d, esize),
                                    flash_fwd_blocks(d, esize)),
            warps * flash_blocks_per_sm(flash_dkdv_smem(d, esize), kv),
            warps * flash_blocks_per_sm(flash_dq_smem(d, esize), q))


def _makespan(costs, cap: int) -> float:
    """When the last of ``costs`` (one per block, in launch order) ends on
    a card that holds ``cap`` blocks at once, each block starting on the
    first slot to free up, as the card's block scheduler starts them."""
    if len(costs) <= cap:
        return max(costs)
    slots = [0.0] * cap
    for c in costs:
        heapq.heappush(slots, heapq.heappop(slots) + c)
    return max(slots)


def _range_plan(counts, n_all: int, copies: int, cap: int,
                enough: int) -> Tuple[int, int]:
    """``(split, chunk)``: ranges of ``chunk`` tiles that cut the
    ``counts[i]`` causal tiles of the blocks i of one (b, head), in launch
    order, repeated for ``copies`` = B H. Range r holds tiles [r chunk,
    (r + 1) chunk) of its block's, and ``split`` = ceil(n_all / chunk)
    ranges cover ``n_all``, the most tiles a block may have (with the
    causal mask or without); a range past its block's tiles has no work.

    With ``enough`` unsplit blocks or more, no split. Else each candidate
    chunk, ceil(n_all j / FLASH_CHUNK_STEPS) for j = 1 .. FLASH_CHUNK_STEPS
    - 1 (every chunk below n_all while n_all <= FLASH_CHUNK_STEPS, as at
    every split shape of phase 3c), is timed on the card's ``cap`` slots
    by ``_makespan`` (a block costs its
    tiles plus FLASH_BLOCK_TILES for its set-up and write-out, one with no
    work nothing; the pass that merges or sums the partials
    FLASH_MERGE_TILES), under the causal mask and without it, each
    against the unsplit blocks under the same mask. The chunk that is
    fastest under the causal mask (the port's training path) wins among
    those whose two ratios sum to less than 2; a tie keeps the longer
    chunk (fewer partials). The mask is the caller's, not the plan's: a
    chunk that gains a little under the causal mask but loses more
    without it (a grid of one wave without the mask) is not taken.

    Cost: at most 2 (FLASH_CHUNK_STEPS - 1) timings, each O(b log cap)
    for the b < ``enough`` copies x len(counts) x split blocks it lays
    out; the plans are cached per shape."""
    if copies * len(counts) >= enough:
        return 1, n_all

    def time(work_of, chunk):
        blocks = []
        for z in range(-(-n_all // chunk)):
            work = [max(0, min(c, (z + 1) * chunk) - z * chunk)
                    for c in work_of]
            blocks += [w + FLASH_BLOCK_TILES if w > 0 else 0
                       for w in work] * copies
        return _makespan(blocks, cap)

    full = [n_all] * len(counts)
    causal, plain = time(counts, n_all), time(full, n_all)
    best, best_chunk = 1.0, n_all
    steps = range(1, FLASH_CHUNK_STEPS)
    for chunk in sorted({-(-n_all * j // FLASH_CHUNK_STEPS) for j in steps}
                        - {n_all}, reverse=True):
        t = (time(counts, chunk) + FLASH_MERGE_TILES) / causal
        t_plain = (time(full, chunk) + FLASH_MERGE_TILES) / plain
        if t + t_plain < 2 and t < best:
            best, best_chunk = t, chunk
    return -(-n_all // best_chunk), best_chunk


def _causal_k_tiles(Sq: int, Sk: int, tile: int):
    """k tiles of ``tile`` keys each q tile of FLASH_ROWS queries visits
    under the causal mask (the kernels' ``k_tiles``), longest first, as
    the forward and dQ grids launch them."""
    nk = -(-Sk // tile)
    return [min(nk, (min(q0 + FLASH_ROWS, Sq) - 1) // tile + 1)
            for q0 in range(0, Sq, FLASH_ROWS)][::-1]


@functools.lru_cache(maxsize=None)
def flash_fwd_plan(B: int, H: int, Sq: int, Sk: int, d: int,
                   esize: int = 4) -> Tuple[int, int]:
    """``(split, chunk)`` of the flash forward: each q tile's k tiles (of
    ``flash_tile(d)`` keys) are cut into ranges of ``chunk`` tiles, range
    r holding tiles [r chunk, (r + 1) chunk), and the grid has ``split`` =
    ceil(k tiles of Sk / chunk) ranges per q tile, so the ranges cover
    every key with or without the causal mask; a range past its q tile's
    causal tiles returns at once. More than one range means partial
    (m, l, O) per range and a merge of each row's ranges in order.

    Why. A block holds one q tile of FLASH_ROWS queries and walks its k
    tiles one after the other. Where the B H ceil(Sq / FLASH_ROWS) blocks
    reach the card's SMS, there is no split: the merge would re-read
    every partial O, while the forward does only two products a tile (on
    the card, every split of hundred-m's 384 blocks or the non-causal
    case's 256 was slower). Where they do not (gemma3-1b's global layers,
    B 1 H 4 Sq 512 d 256: 32 blocks for 132 SMs, the last q tile 32 tiles
    of 16 keys), SMs sit idle and the forward takes as long as its longest
    q tile; splitting shortens it. The causal work is uneven (q tile 0
    has 4 tiles there, q tile 7 has 32), so ranges of a fixed length, not
    a fixed count per q tile, balance it: a short q tile gets few ranges.
    The card holds SMS x ``flash_blocks_per_sm`` blocks at once: in f32
    two an SM at d <= 128, one at d = 256 (133,120 B of shared memory);
    in bf16 ``flash_fwd_blocks`` (4, 3, 2, 2), with k tiles of
    ``flash_tile(d, 2)`` keys.
    ``_range_plan`` times each chunk on that many slots. At gemma3-1b
    global in f32: chunk 5, 7 ranges, 128 live blocks, the longest 5
    tiles instead of 32.

    The plan is a function of (B, H, Sq, Sk, d, esize) alone: a shape
    gets the same ranges, and the same bits, with either mask."""
    tile = flash_tile(d, esize)
    cap = SMS * flash_blocks_per_sm(flash_fwd_smem(d, esize),
                                    flash_fwd_blocks(d, esize))
    return _range_plan(_causal_k_tiles(Sq, Sk, tile), -(-Sk // tile),
                       B * H, cap, SMS)


def flash_fwd_ws_floats(B: int, H: int, Sq: int, Sk: int, d: int,
                        esize: int = 4) -> int:
    """Floats of the forward's partials: per range, an accumulator of o's
    size and an (m, l) pair per row (0 with one range)."""
    split, _ = flash_fwd_plan(B, H, Sq, Sk, d, esize)
    return 0 if split == 1 else split * B * H * Sq * (d + 2)


def flash_dkdv_blocks(B: int, H: int, Sk: int, split: int) -> int:
    """Blocks of the dK/dV kernel's grid: (k tile, b * H + h, range)."""
    return B * H * -(-Sk // FLASH_ROWS) * split


@functools.lru_cache(maxsize=None)
def flash_dkdv_plan(B: int, H: int, KV: int, Sq: int, Sk: int, d: int,
                    esize: int = 4) -> Tuple[int, int, int]:
    """``(split, chunk, parts)`` of the flash backward's dK/dV kernel. A
    block owns one (b, query head, k tile of FLASH_ROWS keys), all d
    columns, and walks the q tiles (of ``flash_q_tile(d, esize)`` rows)
    at or above its diagonal: k tile 0 has them all, the last one few.
    Where those blocks come to less than two waves of the card (SMS x
    ``flash_blocks_per_sm`` at the launch bound ``flash_bwd_blocks``: in
    f32 two 4-warp blocks an SM at d <= 128, one 8-warp block at d = 256),
    so that the scheduler cannot even out their
    causal lengths, each k tile's q tiles are cut into ranges of
    ``chunk`` tiles (``_range_plan``, which times the blocks on the
    card's slots), ``split`` ranges a k tile. granite-3-8b (B 1 H 32 S 512
    d 128): 256 blocks for 264 slots, the longest 32 q tiles against 18
    on average; chunk 23. ``parts`` = (H / KV) split partial dK/dV the sum
    pass adds in order (query head of the group, then range; a range with
    no q tile is skipped); at 1 the blocks write dK/dV themselves."""
    bq = flash_q_tile(d, esize)
    nq = -(-Sq // bq)
    counts = [nq - min(k0 // bq, nq) for k0 in range(0, Sk, FLASH_ROWS)]
    cap = SMS * flash_blocks_per_sm(flash_dkdv_smem(d, esize),
                                    flash_bwd_blocks(d, esize)[0])
    split, chunk = _range_plan(counts, nq, B * H, cap, 2 * cap)
    return split, chunk, (H // KV) * split


@functools.lru_cache(maxsize=None)
def flash_dq_plan(B: int, H: int, Sq: int, Sk: int, d: int,
                  esize: int = 4) -> Tuple[int, int]:
    """``(split, chunk)`` of the dQ kernel: a block owns one (b, h, q tile
    of FLASH_ROWS queries) and walks its causal k tiles (of
    ``flash_dq_tile(d, esize)`` keys); where those blocks come to less than two
    waves of the card, each q tile's k tiles are cut into ranges of
    ``chunk`` tiles (``_range_plan``), ``split`` ranges a q tile. More
    than one range means as many partial dQ, summed in range order (a
    range with no k tile is skipped)."""
    tile = flash_dq_tile(d, esize)
    cap = SMS * flash_blocks_per_sm(flash_dq_smem(d, esize),
                                    flash_bwd_blocks(d, esize)[1])
    return _range_plan(_causal_k_tiles(Sq, Sk, tile), -(-Sk // tile),
                       B * H, cap, 2 * cap)


def flash_parts_floats(B: int, H: int, KV: int, Sq: int, Sk: int, d: int,
                       esize: int = 4) -> int:
    """Floats of the backward's partials at this shape: 2 parts of dk's
    size (dk's and dv's) where the dK/dV plan has more than one part, then
    the dQ plan's ranges of dq's size where it has more than one (f32 for
    either element type)."""
    _, _, parts = flash_dkdv_plan(B, H, KV, Sq, Sk, d, esize)
    dq_split, _ = flash_dq_plan(B, H, Sq, Sk, d, esize)
    return ((parts > 1) * 2 * parts * B * Sk * KV * d
            + (dq_split > 1) * dq_split * B * Sq * H * d)


PAGED_CHUNK_FLOATS = 4096   # most K floats of one (slot, KV head) chunk: 16 KB
PAGED_CHUNK_BYTES = 4 * PAGED_CHUNK_FLOATS   # (8,192 bf16)
PAGED_CHUNK_KEYS = 256      # most keys of a chunk (its scores stay in shared)
PAGED_THREADS = 128         # threads of a paged-attention block


@functools.lru_cache(maxsize=None)
def paged_plan(P: int, ps: int, dh: int, esize: int = 4) -> Tuple[int, int]:
    """``(pages_per_chunk, n_chunks)`` of paged decode attention with a page
    table of P pages of ``ps`` keys, head dim ``dh`` and a K/V pool of
    ``esize``-byte elements.

    Chunk c holds table columns [c * pages_per_chunk, (c + 1) *
    pages_per_chunk) of every slot; one block reduces one (chunk, KV head,
    slot) to a partial (m, l, acc), and a second kernel merges a slot's
    partials in increasing chunk order. The rule: the most pages whose K
    rows of one KV head fit in PAGED_CHUNK_BYTES bytes and whose keys
    number at most PAGED_CHUNK_KEYS, at least one page and at most P;
    n_chunks = ceil(P / pages_per_chunk). A block stages its whole chunk
    (K and V) in shared memory, so the rule bounds a block's bytes and
    gives a long context many blocks per slot. It reads neither the
    slots' count S nor their lengths, so each slot's sums run in the same
    order in every batch. The KV heads only multiply the blocks, and the G
    query heads of a group share each staged row (they enter
    ``paged_smem_bytes``), so neither sizes the chunk."""
    pages = min(PAGED_CHUNK_BYTES // (ps * dh * esize),
                PAGED_CHUNK_KEYS // ps)
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


def paged_k_pitch(dh: int, LK: int, esize: int = 4) -> int:
    """Elements of a staged K row (``csrc/paged_attention.cu::k_pitch``):
    f32 rows padded by whole float4s so that the 8 lanes of each 16-byte
    load phase fall on distinct banks; bf16 rows (8-byte loads) by 8
    elements where a lane's keys are not read whole by neighbouring lanes
    (LK < dh / 4), which keeps 16-byte rows and leaves 2-way conflicts."""
    quads = dh // 4
    if esize == 2:
        return dh + 8 * (LK < quads)
    return dh + 4 * ((LK - quads) % 8 if LK < 8 else 0)


def paged_smem_bytes(pages_per_chunk: int, ps: int, G: int, dh: int,
                     esize: int = 4) -> int:
    """Shared memory of one paged-attention block
    (``csrc/paged_attention.cu::smem_bytes``): the K rows of a chunk of C =
    pages_per_chunk * ps keys at a padded pitch (``paged_k_pitch``), its V
    rows (C, dh) and q (G, dh), all of ``esize``-byte elements, then in f32
    the P.V partial sums (4 PAGED_THREADS float4) and the scores (G, C),
    and the keys' cache rows (C int32)."""
    C = pages_per_chunk * ps
    LK = paged_key_lanes(C, dh // 4)
    pitch = paged_k_pitch(dh, LK, esize)
    return (esize * (C * pitch + C * dh + G * dh)
            + 4 * (16 * PAGED_THREADS + G * C + C))
