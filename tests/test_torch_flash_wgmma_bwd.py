"""The bf16 flash backward on ``wgmma`` (``flash_bwd_dkdv_wgmma_kernel`` and
``flash_bwd_dq_wgmma_kernel`` in ``csrc/flash_attention.cu``), checked on
the CPU, where it cannot run:

- the plan's model of its blocks (``_plan.flash_q_tile(d, 2)``,
  ``flash_dq_tile(d, 2)``, ``flash_bwd_blocks(d, 2)``,
  ``flash_dkdv_smem(d, 2)``, ``flash_dq_smem(d, 2)``) is what the kernel
  source's ``WgmmaBwd<D>`` states, at every head dim, and exactly that
  many blocks fit an SM;
- the dK/dV and dQ plans' ranges at the bf16 tiles cover every causal
  tile of every block, at phase 3c's twelve shapes and at ragged ones;
  the sum pass reads the ranges that have work, and the partials fit the
  workspace;
- a numpy emulation of the kernels' arithmetic (f32 sums of bf16
  products, scores in log2 units with exp2, P^T and dS^T rounded to bf16
  as they enter dV and dK, dS as it enters dQ, the plans' partials
  summed in their order) against ``jax.vjp`` of JAX's flash reference
  and the port's plain backward on the same bf16 inputs, within
  ``chip_smoke.py``'s phase 3c-bf16 bound, at G = 1, 2, 4 and 8 and at
  Sq != Sk;
- the wrapper hands the library the bf16 backward plans of the shape.

The kernels themselves run in ``tests/test_torch_cuda.py`` and phase
3c-bf16.
"""
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from _fused_contract import load_chip_smoke
from repro_torch.kernels import _build, _plan, ref
from repro_torch.kernels import flash_attention as fa
from test_torch_flash_wgmma import (LOG2E, SHAPES, SOURCE, _bf16, _c_expr,
                                    _k_tiles)

ROWS = _plan.FLASH_ROWS


def _wgmma_bwd_source(d):
    """The constants of ``WgmmaBwd<D>`` at D = ``d``, evaluated from the
    kernel source in the order it states them."""
    src = SOURCE.read_text()
    env = {"D": d, "ROWS": int(re.search(r"#define ROWS (\d+)", src)[1])}
    for name in ("SM_SMEM", "BLOCK_SMEM"):
        env[name] = int(re.search(rf"#define {name} (\d+)", src)[1])
    body = re.search(r"struct WgmmaBwd \{(.*?)\n\};", src, re.S)[1]
    for name, expr in re.findall(
            r"static constexpr (?:int|uint32_t) (\w+) =\s*([^;]+);", body):
        env[name] = eval(_c_expr(" ".join(expr.split())), {}, env)
    return env


@pytest.mark.parametrize("d,bq,bk,blocks,smem,stages,warps", [
    (32, 64, 64, (3, 4), (76_800, 57_344), (8, 5), (12, 16)),
    (64, 64, 64, (3, 3), (76_800, 76_800), (3, 3), (12, 12)),
    (128, 32, 64, (2, 2), (115_712, 115_712), (4, 2), (8, 8)),
    (256, 32, 32, (1, 1), (232_448, 232_448), (4, 4), (8, 8))])
def test_plan_models_the_backward_blocks(d, bq, bk, blocks, smem, stages,
                                         warps):
    """Tiles, launch bounds and shared memory of the bf16 dK/dV and dQ
    kernels as ``_plan`` models them are the kernel source's
    ``WgmmaBwd<D>``; each asks for the SM's share of one of its launch
    bound's blocks, so exactly that many fit, within the 227 KB a block
    may have, and its ring has the stages that share holds beside the
    resident tiles, the lse / D slices, the exchange and the barriers."""
    c = _wgmma_bwd_source(d)
    assert (_plan.flash_q_tile(d, 2), _plan.flash_dq_tile(d, 2),
            _plan.flash_bwd_blocks(d, 2),
            (_plan.flash_dkdv_smem(d, 2), _plan.flash_dq_smem(d, 2)),
            stages, _plan.flash_groups(d)) == (
        c["BQ"], c["BK"], (c["KV_BLOCKS"], c["Q_BLOCKS"]),
        (c["KV_SMEM"], c["Q_SMEM"]), (c["KV_STAGES"], c["Q_STAGES"]),
        c["WG"])
    assert (bq, bk, blocks, smem) == (
        c["BQ"], c["BK"], (c["KV_BLOCKS"], c["Q_BLOCKS"]),
        (c["KV_SMEM"], c["Q_SMEM"]))
    assert _plan.flash_warps_per_sm(d, 2)[1:] == warps
    assert c["SLAB"] * c["SLABS"] == d and c["DC"] * c["WG"] == d
    for n, size in zip(blocks, smem):
        assert _plan.SM_SMEM // (size + _plan.BLOCK_SMEM) == n
        assert _plan.flash_blocks_per_sm(size, n) == n
        assert size <= 232_448
    # what TMA writes: every tile and every slab of it a whole number of
    # 1,024-byte swizzle atoms (512 at d = 32)
    for rows in (ROWS, bq, bk):
        assert (rows * c["ROW_BYTES"]) % (16 * c["ROW_BYTES"] // 2) == 0
    assert c["RES_BYTES"] % 1024 == 0 and c["KV_STAGE"] % 1024 == 0
    assert c["Q_STAGE"] % 1024 == 0
    barriers = 8 * (max(c["KV_STAGES"], c["Q_STAGES"]) + 1)
    assert (1024 + 2 * c["RES_BYTES"] + c["KV_STAGES"] * c["KV_STAGE"]
            + c["VEC_BYTES"] + c["KV_XCHG"] + barriers <= c["KV_SMEM"])
    assert (1024 + 2 * c["RES_BYTES"] + c["Q_STAGES"] * c["Q_STAGE"]
            + c["Q_XCHG"] + barriers <= c["Q_SMEM"])
    # registers a thread: the dK and dV (dQ) accumulators and both score
    # tiles at most 4/5 of what the launch bound leaves (ptxas's counts,
    # with the bf16 fragments and addresses, are in PERF.md)
    kv_regs = c["DC"] + bq
    q_regs = c["DC"] // 2 + bk
    for regs, n in ((kv_regs, blocks[0]), (q_regs, blocks[1])):
        assert 5 * regs <= 4 * min(255, 65_536 // (128 * c["WG"] * n))


def _live(counts, split, chunk):
    """Ranges with work of blocks with ``counts`` tiles each."""
    return [[z for z in range(split) if z * chunk < c] for c in counts]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,d", SHAPES)
def test_bf16_backward_ranges_cover_every_causal_tile(B, Sq, Sk, H, KV, d):
    """At the bf16 tiles, the dK/dV plan's ranges cover each k tile's q
    tiles at or above its diagonal once (all of them without the causal
    mask), and the dQ plan's each q tile's causal k tiles once; each
    passes the launcher's check; the ranges with work are the ones the
    sum pass reads (``live_ranges``); the partials fit the workspace; the
    plans are the shape's alone."""
    bq, bk = _plan.flash_q_tile(d, 2), _plan.flash_dq_tile(d, 2)
    split, chunk, parts = _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d, 2)
    dq_split, dq_chunk = _plan.flash_dq_plan(B, H, Sq, Sk, d, 2)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    assert split * chunk >= nq and split == -(-nq // chunk) and chunk >= 1
    assert dq_split * dq_chunk >= nk and dq_split == -(-nk // dq_chunk)
    assert parts == (H // KV) * split
    for causal in (True, False):
        for k0 in range(0, Sk, ROWS):
            first = min(k0 // bq, nq) if causal else 0
            seen = [qt for z in range(split)
                    for qt in range(min(nq, first + z * chunk),
                                    min(nq, first + (z + 1) * chunk))]
            assert seen == list(range(first, nq))
            # every query that sees a key of this k tile is in a seen tile
            if causal and k0 < Sq:
                assert first * bq <= k0
            live = -(-(nq - first) // chunk)       # live_ranges, key rows
            assert [z for z in range(split)
                    if min(nq, first + z * chunk) < nq] == list(range(live))
        counts = [_k_tiles(q0, Sq, Sk, bk, causal)
                  for q0 in range(0, Sq, ROWS)]
        for c, live in zip(counts, _live(counts, dq_split, dq_chunk)):
            seen = [kt for z in live
                    for kt in range(z * dq_chunk, min(c, (z + 1) * dq_chunk))]
            assert seen == list(range(c))
            assert live == list(range(-(-c // dq_chunk)))
    n_kv, n_q = B * Sk * KV * d, B * Sq * H * d
    assert _plan.flash_parts_floats(B, H, KV, Sq, Sk, d, 2) == (
        (parts > 1) * 2 * parts * n_kv + (dq_split > 1) * dq_split * n_q)
    assert _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d, 2) == (split, chunk,
                                                             parts)


@pytest.mark.parametrize("name", ["granite-3-8b", "gemma3-1b global",
                                  "qwen1.5-107b", "phi3-medium-14b",
                                  "opt-1.3b train"])
def test_bf16_backward_plans_at_the_profiled_shapes(name):
    """The bf16 plans of the five profiled shapes, pinned: the training
    shape and the qwen1.5-107b layer (64 heads, 4,096 keys) fill the card
    unsplit, the GQA shapes' short grids split into ranges."""
    _, B, Sq, Sk, H, KV, d, _ = next(c for c in load_chip_smoke().FLASH_CASES
                                     if c[0] == name)
    want = {"opt-1.3b train": ((1, 8, 1), (1, 8)),
            "granite-3-8b": ((1, 16, 4), (1, 8)),
            "gemma3-1b global": ((6, 3, 24), (6, 3)),
            "qwen1.5-107b": ((1, 128, 8), (1, 64)),
            "phi3-medium-14b": ((3, 7, 12), (1, 8))}[name]
    assert (_plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d, 2),
            _plan.flash_dq_plan(B, H, Sq, Sk, d, 2)) == want


def emulate_wgmma_backward(q, k, v, o, lse, do, causal):
    """(dq, dk, dv), each rounded to bf16, of the bf16 kernels' arithmetic
    on bf16 inputs (held in f32): D = rowsum(dO * O) in f32; dQ per (q
    tile of ROWS queries, range of the bf16 dQ plan) over its k tiles of
    ``flash_dq_tile(d, 2)``, the partials summed in range order; dK/dV per
    (query head, k tile of ROWS keys, range of the bf16 dK/dV plan) over
    its q tiles of ``flash_q_tile(d, 2)``, the (H / KV) split partials
    summed in order (query head of the group, then range). Per tile: S and
    dP f32 sums of exact bf16 products; P = 2^(S (scale log2 e) - lse log2
    e) with one rounding (the kernels' fmaf), masked; dS = P (dP - D); dV
    += bf16(P)^T dO, dK += bf16(dS)^T Q, dQ += bf16(dS) K; dK and dQ times
    the scale. At d = 256 two warpgroups share S, dP and take half the
    columns each: the same sums."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    bq, bk = _plan.flash_q_tile(d, 2), _plan.flash_dq_tile(d, 2)   # <= ROWS
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    sl2 = np.float64(scale * LOG2E)
    f32 = np.float32
    Dd = (do * o).sum(-1, dtype=f32).transpose(0, 2, 1)            # B,H,Sq
    L2 = (lse * LOG2E).astype(f32)
    Q, dO = q.transpose(0, 2, 1, 3), do.transpose(0, 2, 1, 3)
    K = np.repeat(k.transpose(0, 2, 1, 3), G, axis=1)
    V = np.repeat(v.transpose(0, 2, 1, 3), G, axis=1)
    pad_q, pad_k = -(-Sq // ROWS) * ROWS - Sq, -(-Sk // ROWS) * ROWS - Sk
    Q, dO = (np.pad(x, [(0, 0), (0, 0), (0, pad_q), (0, 0)]) for x in (Q, dO))
    K, V = (np.pad(x, [(0, 0), (0, 0), (0, pad_k), (0, 0)]) for x in (K, V))
    L2, Dd = (np.pad(x, [(0, 0), (0, 0), (0, pad_q)]) for x in (L2, Dd))

    def p_ds(qi, ki, hs):
        """P and dS of queries qi and keys ki at heads hs, (B, hs, qi,
        ki); rows past Sq or Sk are the padding's zeros (TMA's), masked."""
        at_q, at_k = np.ix_(np.arange(B), hs, qi), np.ix_(np.arange(B), hs, ki)
        s = Q[at_q] @ K[at_k].swapaxes(-1, -2)
        dp = dO[at_q] @ V[at_k].swapaxes(-1, -2)
        x = (s.astype(np.float64) * sl2 - L2[at_q][..., None]).astype(f32)
        p = np.exp2(x)
        off = ((qi[:, None] >= Sq) | (ki[None, :] >= Sk)
               | (causal & (ki[None, :] > qi[:, None])))
        p = np.where(off, f32(0), p)
        return p, p * (dp - Dd[at_q][..., None])

    all_h = np.arange(H)
    dq_split, dq_chunk = _plan.flash_dq_plan(B, H, Sq, Sk, d, 2)
    dq = np.zeros_like(Q)
    for q0 in range(0, Sq, ROWS):
        qi = np.arange(q0, q0 + ROWS)
        n_kt = _k_tiles(q0, Sq, Sk, bk, causal)
        total = None
        for lo in range(0, n_kt, dq_chunk):             # live ranges
            acc = np.zeros((B, H, ROWS, d), f32)
            for kt in range(lo, min(n_kt, lo + dq_chunk)):
                ki = np.arange(kt * bk, kt * bk + bk)
                _, ds = p_ds(qi, ki, all_h)
                acc = acc + _bf16(ds) @ K[:, :, ki]
            part = acc * scale
            total = part if total is None else total + part
        dq[:, :, qi] = total
    split, chunk, parts = _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d, 2)
    nq = -(-Sq // bq)
    dk = dv = None
    for g in range(G):
        for r in range(split):
            hs = np.arange(KV) * G + g
            pk = np.zeros((B, KV) + K.shape[2:], f32)
            pv = np.zeros_like(pk)
            for k0 in range(0, Sk, ROWS):
                ki = np.arange(k0, k0 + ROWS)
                first = min(k0 // bq, nq) if causal else 0
                lo = min(nq, first + r * chunk)
                acc_k = np.zeros((B, KV, ROWS, d), f32)
                acc_v = np.zeros_like(acc_k)
                for qt in range(lo, min(nq, lo + chunk)):
                    qi = np.arange(qt * bq, qt * bq + bq)
                    p, ds = p_ds(qi, ki, hs)
                    at_q = np.ix_(np.arange(B), hs, qi)
                    acc_v = acc_v + _bf16(p).swapaxes(-1, -2) @ dO[at_q]
                    acc_k = acc_k + _bf16(ds).swapaxes(-1, -2) @ Q[at_q]
                pk[:, :, ki] = acc_k * scale
                pv[:, :, ki] = acc_v
            # the sum pass: range 0 of head 0 first, then add the others
            # (a range without work adds its zeros, which change no sum)
            dk = pk if dk is None else dk + pk
            dv = pv if dv is None else dv + pv
    return (_bf16(dq[:, :, :Sq].transpose(0, 2, 1, 3)),
            _bf16(dk[:, :, :Sk].transpose(0, 2, 1, 3)),
            _bf16(dv[:, :, :Sk].transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,causal", [
    (1, 200, 200, 4, 4, 32, True),       # G 1, ragged
    (2, 96, 160, 8, 2, 64, True),        # G 4, Sq < Sk
    (1, 160, 96, 8, 1, 128, True),       # G 8, Sq > Sk
    (1, 136, 136, 2, 1, 256, True),      # d 256, two warpgroups
    (1, 128, 200, 4, 1, 64, False),      # non-causal, Sq < Sk
    (1, 512, 512, 4, 1, 256, True),      # gemma3-1b global: split plans
    (1, 256, 256, 8, 8, 128, True)])     # G 1 at d 128
def test_wgmma_backward_emulation_passes_the_bf16_bound(B, Sq, Sk, H, KV, d,
                                                        causal):
    """On the same bf16 inputs, fed the plain forward's o and lse as phase
    3c-bf16 feeds the kernels: dq, dk and dv within phase 3c-bf16's bound
    (``flash_tolerances`` at u = 2^-8, plus a bf16 ulp of the reference)
    of the port's plain backward and of ``jax.vjp`` of JAX's flash
    reference."""
    cs = load_chip_smoke()
    rng = np.random.default_rng(d + Sq + H + causal)
    q, k, v, do = (_bf16(rng.standard_normal(s).astype(np.float32)) for s in
                   ((B, Sq, H, d), (B, Sk, KV, d), (B, Sk, KV, d),
                    (B, Sq, H, d)))
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o_p, lse_p = ref.flash_attention_fwd_ref(tq, tk, tv, causal)
    want = ref.flash_attention_bwd_ref(tq, tk, tv, o_p, lse_p, tdo, causal)
    got = emulate_wgmma_backward(q, k, v, o_p.float().numpy(), lse_p.numpy(),
                                 do, causal)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: jref.flash_attention_ref(
        a, b_, c, causal=causal), jq, jk, jv)
    jax_grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    _, tols, _ = cs.flash_tolerances(
        tq.float(), tk.float(), tv.float(), o_p.float(), lse_p, tdo.float(),
        causal, u=2.0 ** -8)
    for name, g, w, jg, tol in zip(("dq", "dk", "dv"), got, want, jax_grads,
                                   tols):
        for ref_name, r in (("plain", w.float().numpy()), ("jax", jg)):
            bound = tol.numpy() + cs.BF16_ULP * np.abs(r)
            err = np.abs(g - r)
            assert (err <= bound).all(), (name, ref_name,
                                          float((err / bound).max()))


@pytest.fixture
def recording_bwd_bf16(monkeypatch):
    """The backward wrapper's calls into the bf16 entry point and its
    allocations, recorded (CPU tensors stand in for CUDA ones)."""
    calls, sizes = [], []
    empty = torch.empty
    names = ("q", "k", "v", "o", "do", "lse", "D", "dq", "dk", "dv", "B",
             "H", "KV", "Sq", "Sk", "d", "qsb", "qss", "qsh", "ksb", "kss",
             "ksh", "vsb", "vss", "vsh", "causal", "split", "chunk",
             "dq_split", "dq_chunk", "parts", "stream")

    def bwd(*args):
        assert len(args) == len(names)
        calls.append(dict(zip(names, args)))
        return 0

    def recording_empty(*shape, **kw):
        sizes.append(tuple(shape[0]) if len(shape) == 1 and isinstance(
            shape[0], (tuple, list)) else shape)
        return empty(*shape, **kw)

    # the wrapper's launch count is the process's: put it back afterwards
    monkeypatch.setattr(fa.cuda_flash_attention_bwd, "launches",
                        fa.cuda_flash_attention_bwd.launches)
    monkeypatch.setattr(_build, "load", lambda name: SimpleNamespace(
        flash_attention_bwd_bf16=bwd))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", recording_empty)
    return calls, sizes


@pytest.mark.parametrize("B,S,H,KV,d", [(1, 512, 4, 1, 256),
                                        (1, 512, 32, 8, 128),
                                        (4, 512, 32, 32, 64),
                                        (1, 200, 4, 2, 32)])
def test_bf16_wrapper_passes_the_bf16_backward_plans(recording_bwd_bf16, B, S,
                                                     H, KV, d):
    """bf16 q, k, v reach the bf16 backward entry point with the dK/dV and
    dQ plans of the shape at 2-byte elements and a partials workspace of
    their size, one launch a call."""
    calls, sizes = recording_bwd_bf16
    bf = torch.bfloat16
    q = torch.zeros((B, S, H, d), dtype=bf)
    k = v = torch.zeros((B, S, KV, d), dtype=bf)
    o, do = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros((B, H, S))
    before = fa.cuda_flash_attention_bwd.launches
    dq, dk, dv = fa.cuda_flash_attention_bwd(q, k, v, o, lse, do, True)
    call = calls[-1]
    split, chunk, _ = _plan.flash_dkdv_plan(B, H, KV, S, S, d, 2)
    assert (call["split"], call["chunk"]) == (split, chunk)
    assert (call["dq_split"], call["dq_chunk"]) == _plan.flash_dq_plan(
        B, H, S, S, d, 2)
    assert (_plan.flash_parts_floats(B, H, KV, S, S, d, 2),) in sizes
    assert all(t.dtype == bf for t in (dq, dk, dv))
    assert fa.cuda_flash_attention_bwd.launches == before + 1
