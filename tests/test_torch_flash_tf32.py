"""The design of the flash kernels (``csrc/flash_attention.cu``) checked on
the CPU, where they cannot run:

- a numpy emulation of their 3xTF32 tensor-core products (each f32 operand
  split into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest with
  ties away as cvt.rna.tf32.f32; each k = 8 slice of a_lo b_hi, a_hi b_lo,
  a_hi b_hi summed exactly, each added to the f32 accumulator rounded
  toward zero, the pessimistic case; at 16-row streamed tiles the score
  products' two k halves summed apart, then added), in the kernels'
  order: the forward plan's ranges of k tiles with the online softmax,
  merged in order, and the dK/dV and dQ partials of the plans summed in
  their order, passes ``chip_smoke.py``'s phase-3c gate
  (``flash_tolerances``) at 0.05 of the tolerance or less;
- the same emulation with one TF32 product (a_hi b_hi) fails that gate,
  so the gate tells apart the route the kernels may not take;
- the forward, dK/dV and dQ plans (``_plan.flash_fwd_plan``,
  ``flash_dkdv_plan``, ``flash_dq_plan``) are functions of the shape: the
  wrapper passes the same plans for a strided view and its copy; they
  split the GQA shapes' short grids and are 1 at the training shape;
- ``chip_smoke.flash_bound`` at the training shape, 3xTF32 and f32 SIMT.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _fused_contract import load_chip_smoke as _chip_smoke
from repro_torch.kernels import _build, _plan, ref
from repro_torch.kernels import flash_attention as fa

ROWS = _plan.FLASH_ROWS


def _tf32(x):
    """Round float32 to TF32, nearest with ties away (cvt.rna.tf32.f32)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def _rtz(x):
    """float64 to float32, rounded toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _mma(c, a, b, passes):
    """c + a @ b as the kernels take it on the tensor cores: k in slices of
    8 (``passes`` 3: a_lo b_hi, a_hi b_lo, a_hi b_hi; 1: a_hi b_hi), each
    slice's products summed exactly and added to c rounded toward zero."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    terms = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if passes == 3
             else [(a_hi, b_hi)])
    c = c.astype(np.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            c = _rtz(c.astype(np.float64)
                     + x[..., k0:k0 + 8].astype(np.float64)
                     @ y[..., k0:k0 + 8, :].astype(np.float64))
    return c


def _scores(a, b, passes, halves):
    """a @ b from zero, as the kernels' score products take it: with
    ``halves`` (16-row streamed tiles) the two halves of the k range
    accumulate apart and are then added, else one accumulator."""
    zero = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    if not halves:
        return _mma(zero, a, b, passes)
    h = a.shape[-1] // 2
    return (_mma(zero, a[..., :h], b[..., :h, :], passes)
            + _mma(zero, a[..., h:], b[..., h:, :], passes))


def _pad(x, axis, mult):
    n = -(-x.shape[axis] // mult) * mult - x.shape[axis]
    width = [(0, 0)] * x.ndim
    width[axis] = (0, n)
    return np.pad(x, width)


def _heads(q, k):
    """q (B,Sq,H,d) -> (B,H,Sq,d); k (B,Sk,KV,d) -> (B,H,Sk,d), head h
    reading KV head h // G."""
    G = q.shape[2] // k.shape[2]
    return (q.transpose(0, 2, 1, 3),
            np.repeat(k.transpose(0, 2, 1, 3), G, axis=1))


def emulate_forward(q, k, v, causal, passes):
    """(o (B,Sq,H,d), lse (B,H,Sq)) of the forward kernels' arithmetic:
    each q tile of ROWS queries walks its k tiles (of ``flash_tile(d)``
    keys; under the causal mask those at or below its diagonal), cut into
    the ranges of ``chunk`` tiles of ``_plan.flash_fwd_plan``; each range
    runs the online softmax from m = -1e30, l = 0, O = 0, and a row's
    ranges are merged in increasing order (``csrc/online_merge.cuh``): m =
    max m_c, l = sum l_c e^(m_c - m), o = sum O_c e^(m_c - m) / max(l,
    1e-30), lse = m + log l. One range gives the unsplit kernel's o and
    lse (its weight is e^0 = 1). A row whose keys in a range are all
    masked keeps m = -1e30 there and weighs e^(-1e30 - m) = 0."""
    B, Sq, H, d = q.shape
    Sk, bk = k.shape[1], _plan.flash_tile(d)
    _, chunk = _plan.flash_fwd_plan(B, H, Sq, Sk, d)
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    Q, K = _heads(q, k)
    V = _heads(q, v)[1]
    Q, K, V = _pad(Q, 2, ROWS), _pad(K, 2, bk), _pad(V, 2, bk)
    nk = -(-Sk // bk)
    o = np.zeros(Q.shape, np.float32)
    lse = np.zeros(Q.shape[:3], np.float32)
    for q0 in range(0, Sq, ROWS):
        rows = np.arange(q0, q0 + ROWS)[:, None]
        Qt = Q[:, :, q0:q0 + ROWS]
        n_kt = min(nk, (min(q0 + ROWS, Sq) - 1) // bk + 1) if causal else nk
        parts = []
        for lo in range(0, n_kt, chunk):
            m = np.full(Qt.shape[:3], -1e30, np.float32)
            l = np.zeros(Qt.shape[:3], np.float32)
            acc = np.zeros(Qt.shape, np.float32)
            for kt in range(lo, min(n_kt, lo + chunk)):
                k0 = kt * bk
                s = _scores(Qt, K[:, :, k0:k0 + bk].swapaxes(-1, -2),
                            passes, bk <= 16) * scale
                cols = k0 + np.arange(bk)[None, :]
                s = np.where((cols >= Sk) | (causal & (cols > rows)),
                             np.float32(-1e30), s)
                m_new = np.maximum(m, s.max(-1))
                alpha = np.exp(m - m_new)
                p = np.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1, dtype=np.float32)
                acc = _mma(acc * alpha[..., None], p, V[:, :, k0:k0 + bk],
                           passes)
                m = m_new
            parts.append((m, l, acc))
        m = np.maximum.reduce([m_c for m_c, _, _ in parts])
        l_sum = np.zeros_like(m)
        o_sum = np.zeros_like(Qt)
        for m_c, l_c, acc_c in parts:
            w = np.exp(m_c - m)
            l_sum = l_sum + l_c * w
            o_sum = o_sum + acc_c * w[..., None]
        o[:, :, q0:q0 + ROWS] = o_sum / np.maximum(
            l_sum, np.float32(1e-30))[..., None]
        lse[:, :, q0:q0 + ROWS] = m + np.log(l_sum)
    return o[:, :, :Sq].transpose(0, 2, 1, 3), lse[:, :, :Sq]


def emulate_backward(q, k, v, o, lse, do, causal, passes):
    """(dq, dk, dv) of the backward kernels' arithmetic: dQ per (q tile of
    ROWS queries, range of the dQ plan) over its k tiles of
    ``flash_dq_tile(d)``, the partials then summed in range order; dK/dV
    per (query head, k tile of ROWS keys, range of the dK/dV plan) over
    its q tiles of ``flash_q_tile(d)``, the (H / KV) split partials then
    summed in order (query head of the group, then range). Range r holds
    tiles [r chunk, (r + 1) chunk) of a block's (from its diagonal, for
    dK/dV); the kernels skip a range past them, whose zeros here change no
    sum. At d = 256 two warp groups share S and dP and take half the
    columns each: the same sums."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, bt, bq = H // KV, _plan.flash_dq_tile(d), _plan.flash_q_tile(d)
    halves = max(bt, bq) <= 16      # 16-row streamed tiles in both passes
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    Dd = (do * o).sum(-1, dtype=np.float32).transpose(0, 2, 1)   # B,H,Sq
    Q, K = _heads(q, k)
    V, dO = _heads(q, v)[1], do.transpose(0, 2, 1, 3)
    nq = -(-Sq // bq)
    Q, dO = _pad(Q, 2, max(ROWS, bt)), _pad(dO, 2, max(ROWS, bt))
    K, V = _pad(K, 2, max(ROWS, bt)), _pad(V, 2, max(ROWS, bt))
    L, Dp = _pad(lse, 2, max(ROWS, bt)), _pad(Dd, 2, max(ROWS, bt))

    def p_ds(Qt, dOt, Kt, Vt, Lt, Dt, qi, ki):
        """P and dS of queries qi and keys ki, (.., len(qi), len(ki)), from
        their rows of Q, dO, K, V and entries of lse and D."""
        s = _scores(Qt, Kt.swapaxes(-1, -2), passes, halves)
        dp = _scores(dOt, Vt.swapaxes(-1, -2), passes, halves)
        p = np.exp(s * scale - Lt[..., None])
        off = ((qi[:, None] >= Sq) | (ki[None, :] >= Sk)
               | (causal & (ki[None, :] > qi[:, None])))
        p = np.where(off, np.float32(0), p)
        return p, p * (dp - Dt[..., None])

    dq_split, dq_chunk = _plan.flash_dq_plan(B, H, Sq, Sk, d)
    nk = -(-Sk // bt)
    parts_q = np.zeros((dq_split,) + Q.shape, np.float32)
    for q0 in range(0, Sq, ROWS):
        qi = np.arange(q0, q0 + ROWS)
        n_kt = min(nk, (min(q0 + ROWS, Sq) - 1) // bt + 1) if causal else nk
        for r in range(dq_split):
            acc = np.zeros(Q.shape[:2] + (ROWS, d), np.float32)
            lo = min(n_kt, r * dq_chunk)
            for kt in range(lo, min(n_kt, lo + dq_chunk)):
                ki = np.arange(kt * bt, kt * bt + bt)
                _, ds = p_ds(Q[:, :, qi], dO[:, :, qi], K[:, :, ki],
                             V[:, :, ki], L[:, :, qi], Dp[:, :, qi], qi, ki)
                acc = _mma(acc, ds, K[:, :, ki], passes)
            parts_q[r][:, :, qi] = acc * scale
    dq = parts_q[0]
    for r in range(1, dq_split):
        dq = dq + parts_q[r]
    dq = dq[:, :, :Sq].transpose(0, 2, 1, 3)

    split, chunk, parts = _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d)
    part_k = np.zeros((parts, B, KV) + K.shape[2:], np.float32)
    part_v = np.zeros_like(part_k)
    for k0 in range(0, Sk, ROWS):
        ki = np.arange(k0, k0 + ROWS)
        first = min(k0 // bq, nq) if causal else 0
        for r in range(split):
            lo = min(nq, first + r * chunk)
            hi = min(nq, lo + chunk)
            for g in range(G):
                hs = np.arange(KV) * G + g
                dk = np.zeros((B, KV, ROWS, d), np.float32)
                dv = np.zeros_like(dk)
                for qt in range(lo, hi):
                    qi = np.arange(qt * bq, qt * bq + bq)
                    sub = np.ix_(np.arange(B), hs, qi)
                    kub = np.ix_(np.arange(B), hs, ki)
                    p, ds = p_ds(Q[sub], dO[sub], K[kub], V[kub], L[sub],
                                 Dp[sub], qi, ki)
                    dv = _mma(dv, p.swapaxes(-1, -2), dO[sub], passes)
                    dk = _mma(dk, ds.swapaxes(-1, -2), Q[sub], passes)
                part_k[g * split + r][:, :, ki] = dk * scale
                part_v[g * split + r][:, :, ki] = dv
    dk, dv = part_k[0], part_v[0]
    for p in range(1, parts):
        dk, dv = dk + part_k[p], dv + part_v[p]
    return (dq, dk[:, :, :Sk].transpose(0, 2, 1, 3),
            dv[:, :, :Sk].transpose(0, 2, 1, 3))


CASES = [
    # name, B, S, H, KV, d (causal, Sq = Sk = S)
    ("MHA d64", 1, 256, 2, 2, 64),
    ("MHA d64 ragged", 1, 200, 2, 2, 64),
    ("GQA d128 ragged", 1, 200, 4, 2, 128),
    ("d256 KV1 ragged", 1, 136, 2, 1, 256),
]


def _inputs(B, S, H, KV, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(B, S, H, d), (B, S, KV, d), (B, S, KV, d),
                      (B, S, H, d)]]


def _emulated_vs_gate(case, passes):
    """[(name, got, want, tol)] for o, dq, dk, dv: the emulation with
    ``passes`` TF32 products, the plain versions and the phase-3c
    tolerances (the backward fed the plain forward's o and lse, as phase
    3c feeds the kernels)."""
    cs = _chip_smoke()
    _, B, S, H, KV, d = case
    q, k, v, do = _inputs(B, S, H, KV, d)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o_p, lse_p = ref.flash_attention_fwd_ref(tq, tk, tv, True)
    grads_p = ref.flash_attention_bwd_ref(tq, tk, tv, o_p, lse_p, tdo, True)
    tol_o, tol_g, _ = cs.flash_tolerances(tq, tk, tv, o_p, lse_p, tdo, True)
    o, _ = emulate_forward(q, k, v, True, passes)
    grads = emulate_backward(q, k, v, o_p.numpy(), lse_p.numpy(), do, True,
                             passes)
    return cs, [("o", o, o_p, tol_o)] + [
        (n, g, w, t) for n, g, w, t in zip(("dq", "dk", "dv"), grads,
                                           grads_p, tol_g)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_3xtf32_products_pass_the_flash_gate(case):
    cs, outs = _emulated_vs_gate(case, passes=3)
    for name, got, want, tol in outs:
        got = torch.from_numpy(np.ascontiguousarray(got))
        ratio_of = (got - want).abs() / tol.clamp_min(1e-30)
        worst = np.unravel_index(int(ratio_of.argmax()), tuple(got.shape))
        where = (f"{case[0]} {name}: worst at {tuple(map(int, worst))}, "
                 f"got {float(got[worst])!r} want {float(want[worst])!r} "
                 f"tol {float(tol[worst])!r}, torch threads "
                 f"{torch.get_num_threads()}")
        _, ratio = cs._gate(f"3xTF32 {where}", got, want, tol)
        assert ratio <= 0.05, (name, ratio, where)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_pass_tf32_fails_the_flash_gate(case):
    cs, outs = _emulated_vs_gate(case, passes=1)
    failed = []
    for name, got, want, tol in outs:
        try:
            cs._gate(f"TF32 {case[0]} {name}",
                     torch.from_numpy(np.ascontiguousarray(got)), want, tol)
        except SystemExit:
            failed.append(name)
    assert failed, "one-pass TF32 passed every gate"


def test_tf32_split_rounds_to_nearest_ties_away():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                  -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-8],
                 np.float32)
    hi = _tf32(x)
    assert list(hi[:5]) == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                            -(1.0 + 2.0 ** -10), 1.0]
    assert np.all(hi.view(np.uint32) & np.uint32(0x1fff) == 0)
    lo = _tf32(x - hi)
    # hi + lo carries about 22 bits: the split loses at most 2^-22 |x|
    assert np.all(np.abs((hi.astype(np.float64) + lo) - x)
                  <= 2.0 ** -22 * np.abs(x))


# ---------------------------------------------------------------------------
# the dK/dV plan
# ---------------------------------------------------------------------------

def _case(name):
    cs = _chip_smoke()
    return next(c for c in cs.FLASH_CASES if c[0] == name)


# the (split, chunk) of the forward, dK/dV and dQ plans the kernels were
# timed at (PERF.md): a change to the planner or to a model's shape shows
# up here
PINNED = {"gemma3-1b global": ((7, 5), (7, 5), (7, 5)),
          "granite-3-8b": ((1, 16), (2, 23), (2, 23))}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_plans_are_pinned_at_the_timed_shapes(name):
    _, B, Sq, Sk, H, KV, d, _ = _case(name)
    split, chunk, _ = _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d)
    assert (_plan.flash_fwd_plan(B, H, Sq, Sk, d), (split, chunk),
            _plan.flash_dq_plan(B, H, Sq, Sk, d)) == PINNED[name]


@pytest.mark.parametrize("name", ["gemma3-1b global", "granite-3-8b"])
def test_dkdv_plan_fills_the_card_at_the_gqa_shapes(name):
    """The unsplit blocks come to less than two waves of the card, so the
    plan cuts the k tiles' q tiles into ranges: a launched grid of at
    least SMS blocks, more live blocks than without, and the longest block
    shorter than k tile 0's q tiles."""
    _, B, Sq, Sk, H, KV, d, _ = _case(name)
    split, chunk, parts = _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d)
    nq = -(-Sq // _plan.flash_q_tile(d))
    counts = [nq - min(k0 // _plan.flash_q_tile(d), nq)
              for k0 in range(0, Sk, ROWS)]
    live = B * H * sum(-(-c // chunk) for c in counts)
    assert _plan.flash_dkdv_blocks(B, H, Sk, split) >= _plan.SMS
    assert split > 1 and chunk < nq
    assert live > _plan.flash_dkdv_blocks(B, H, Sk, 1)
    assert parts == (H // KV) * split
    assert (split, chunk) == PINNED[name][1]


def test_plans_are_one_at_the_training_shape():
    _, B, Sq, Sk, H, KV, d, _ = _case("opt-1.3b train")
    nq, nk = -(-Sq // _plan.flash_q_tile(d)), -(-Sk // _plan.flash_tile(d))
    assert _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d) == (1, nq, 1)
    assert _plan.flash_dq_plan(B, H, Sq, Sk, d) == (
        1, -(-Sk // _plan.flash_dq_tile(d)))
    assert _plan.flash_fwd_plan(B, H, Sq, Sk, d) == (1, nk)
    assert _plan.flash_parts_floats(B, H, KV, Sq, Sk, d) == 0
    assert _plan.flash_fwd_ws_floats(B, H, Sq, Sk, d) == 0


def test_dq_plan_fills_the_card_at_gemma3_global():
    """B H ceil(Sq / 64) = 32 blocks of one q tile each: the plan cuts
    each q tile's k tiles into ranges of a fixed length, more live blocks
    than q tiles, the longest range shorter than the last q tile's tiles,
    and no range past Sk's tiles."""
    _, B, Sq, Sk, H, KV, d, _ = _case("gemma3-1b global")
    split, chunk = _plan.flash_dq_plan(B, H, Sq, Sk, d)
    nk = -(-Sk // _plan.flash_dq_tile(d))
    assert B * H * -(-Sq // ROWS) * split >= _plan.SMS
    assert (split, chunk) == (7, 5)
    counts = [min(nk, (min(q0 + ROWS, Sq) - 1) // _plan.flash_dq_tile(d) + 1)
              for q0 in range(0, Sq, ROWS)]
    assert (B * H * sum(-(-c // chunk) for c in counts)
            > B * H * len(counts))
    assert chunk < max(counts)
    assert split == -(-nk // chunk) and split <= nk


@pytest.mark.parametrize("case", range(11))
def test_plan_invariants_at_every_phase_3c_case(case):
    """Each plan's ranges cover its blocks' tiles (split x chunk at least
    the tiles a block can have, the last range not empty), split = 1 where
    the unsplit blocks come to two waves of the card, a backward grid
    under SMS blocks only where every tile already has its own range, and
    partials exist iff a plan has more than one part."""
    _, B, Sq, Sk, H, KV, d, _ = _chip_smoke().FLASH_CASES[case]
    nq = -(-Sq // _plan.flash_q_tile(d))
    nk_q = -(-Sk // _plan.flash_dq_tile(d))
    nk_f = -(-Sk // _plan.flash_tile(d))
    split, chunk, parts = _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d)
    dq_split, dq_chunk = _plan.flash_dq_plan(B, H, Sq, Sk, d)
    f_split, f_chunk = _plan.flash_fwd_plan(B, H, Sq, Sk, d)
    for s_, c_, n in ((split, chunk, nq), (dq_split, dq_chunk, nk_q),
                      (f_split, f_chunk, nk_f)):
        assert 1 <= c_ <= n and s_ == -(-n // c_), (s_, c_, n)
    assert parts == (H // KV) * split
    assert (_plan.flash_dkdv_blocks(B, H, Sk, split) >= _plan.SMS
            or split == nq)
    assert (B * H * -(-Sq // ROWS) * dq_split >= _plan.SMS
            or dq_split == nk_q)
    blocks_kv = _plan.flash_dkdv_blocks(B, H, Sk, 1)
    cap = _plan.SMS * _plan.flash_blocks_per_sm(_plan.flash_dkdv_smem(d))
    assert blocks_kv < 2 * cap or split == 1
    blocks_q = B * H * -(-Sq // ROWS)
    cap = _plan.SMS * _plan.flash_blocks_per_sm(_plan.flash_dq_smem(d))
    assert blocks_q < 2 * cap or dq_split == 1
    cap = _plan.SMS * _plan.flash_blocks_per_sm(_plan.flash_fwd_smem(d))
    assert blocks_q < 2 * cap or f_split == 1
    assert ((_plan.flash_parts_floats(B, H, KV, Sq, Sk, d) > 0)
            == (parts > 1 or dq_split > 1))
    assert ((_plan.flash_fwd_ws_floats(B, H, Sq, Sk, d) > 0)
            == (f_split > 1))


@pytest.fixture
def recording_lib(monkeypatch):
    """The wrapper's calls into the kernel library, recorded instead of
    launched (CPU tensors stand in for CUDA ones)."""
    calls = []
    names = ("q", "k", "v", "o", "do", "lse", "D", "dq", "dk", "dv", "B",
             "H", "KV", "Sq", "Sk", "d", "qsb", "qss", "qsh", "ksb", "kss",
             "ksh", "vsb", "vss", "vsh", "causal", "split", "chunk",
             "dq_split", "dq_chunk", "parts", "stream")

    def bwd(*args):
        calls.append(dict(zip(names, args)))
        return 0

    # the wrapper's launch count is the process's: put it back afterwards
    monkeypatch.setattr(fa.cuda_flash_attention_bwd, "launches",
                        fa.cuda_flash_attention_bwd.launches)
    monkeypatch.setattr(_build, "load", lambda name: SimpleNamespace(
        flash_attention_bwd_f32=bwd))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("B,S,H,KV,d", [(1, 512, 4, 1, 256),
                                        (1, 200, 32, 8, 128),
                                        (4, 512, 32, 32, 64)])
def test_wrapper_passes_the_plan_of_the_shape_for_every_layout(
        recording_lib, B, S, H, KV, d):
    """A strided view of one (B,S,3,H,d) buffer, its contiguous copy and a
    view whose start is not 16-byte aligned (which the wrapper copies) get
    the same plan, the plan of the shape, and partials of its size."""
    split, chunk, parts = _plan.flash_dkdv_plan(B, H, KV, S, S, d)
    dq_split, dq_chunk = _plan.flash_dq_plan(B, H, S, S, d)
    qkv = torch.zeros((B, S, 3, H, d))
    odd = torch.zeros(B * S * H * d + 1)[1:].view(B, S, H, d)
    layouts = {"view": qkv.unbind(2), "copy": [
        t.contiguous() for t in qkv.unbind(2)], "odd start": (odd,) * 3}
    lse = torch.zeros((B, H, S))
    o = torch.zeros((B, S, H, d))
    for name, (q, k, v) in layouts.items():
        k, v = k[:, :, :KV], v[:, :, :KV]
        fa.cuda_flash_attention_bwd(q, k, v, o, lse, o, True)
        call = recording_lib[-1]
        assert (call["split"], call["chunk"], call["dq_split"],
                call["dq_chunk"], call["KV"]) == (
            split, chunk, dq_split, dq_chunk, KV), name
        assert all(call[p] % 16 == 0 for p in ("q", "k", "v", "do")), name
        assert all(call[s] % 4 == 0 for s in ("qsb", "qss", "qsh", "ksb",
                                              "kss", "ksh")), name
        assert bool(call["parts"]) == (parts > 1 or dq_split > 1), name
    assert [c["split"] for c in recording_lib] == [split] * 3


def test_flash_bound_at_the_training_shape():
    """3 x flops at 495 TFLOP/s (3xTF32) bounds both passes, with the f32
    SIMT time of the same flops beside it."""
    cs = _chip_smoke()
    _, B, Sq, Sk, H, KV, d, causal = _case("opt-1.3b train")
    assert B * H * cs.flash_pairs(Sq, Sk, causal) == 16_809_984
    fwd = cs.flash_bound(B, Sq, Sk, H, KV, d, causal, bwd=False)
    bwd = cs.flash_bound(B, Sq, Sk, H, KV, d, causal, bwd=True)
    assert fwd[1] == bwd[1] == "operations"
    assert [round(x, 4) for x in (fwd[0], fwd[2])] == [0.0261, 0.0642]
    assert [round(x, 4) for x in (bwd[0], bwd[2])] == [0.0652, 0.1606]
