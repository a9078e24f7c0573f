"""The split-K plan of the projection GEMM (``csrc/proj_gemm.cuh``), shared
by its two users: the compressor's projections (``fused_compress``) and
``lowrank_mm``'s split route.

The plan depends on the output's row tiles and the reduction length K
alone, never on a batch or on the operands' strides, so every output bit
is the same function of the inputs in every call: a batched launch gives
each matrix the bits of its own launch, and a transposed view the bits of
its contiguous copy.
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
