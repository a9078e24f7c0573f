"""The bf16 flash forward on ``wgmma`` (``flash_fwd_wgmma_kernel`` in
``csrc/flash_attention.cu``), checked on the CPU, where it cannot run:

- the plan's model of its block (``_plan.flash_tile(d, 2)``,
  ``flash_fwd_blocks``, ``flash_fwd_smem(d, 2)``) is what the kernel
  source's ``WgmmaFwd<D>`` states, at every head dim, and exactly that
  many blocks fit an SM; the f32 model is unchanged;
- the forward plan's ranges at the bf16 tile cover every causal k tile of
  every q tile, at phase 3c's twelve shapes and at ragged ones, and the
  workspace holds what the ranges write and the merge reads;
- a numpy emulation of the kernel's arithmetic (f32 sums of bf16
  products, scores in log2 units with exp2, P rounded to bf16 for P V,
  the plan's ranges merged in order) against JAX's flash reference and
  the port's plain version on the same bf16 inputs, within the JAX bf16
  gate and ``chip_smoke.py``'s phase 3c-bf16 bound;
- the wrapper hands the library the bf16 plan of the shape.

The kernel itself runs in ``tests/test_torch_cuda.py`` and phase 3c-bf16.
"""
import math
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from _fused_contract import load_chip_smoke
from repro_torch.kernels import _build, _plan, ref
from repro_torch.kernels import flash_attention as fa

ROWS = _plan.FLASH_ROWS
HEAD_DIMS = (32, 64, 128, 256)
SOURCE = Path(_build.CSRC) / "flash_attention.cu"
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
FLASH_CASES = load_chip_smoke().FLASH_CASES
RAGGED = [
    # B, Sq, Sk, H, KV, d: tails of every tile size, Sq != Sk both ways,
    # one query, fewer keys than a tile
    (2, 200, 200, 4, 2, 32), (1, 384, 384, 8, 2, 128), (1, 96, 160, 4, 2, 64),
    (1, 160, 96, 4, 2, 256), (3, 1, 77, 2, 1, 64), (1, 65, 17, 8, 8, 128),
    (1, 1000, 1000, 2, 1, 256), (2, 129, 700, 4, 4, 32)]


def _c_expr(expr):
    """A C constant expression over ints (``a ? b : c`` chains, ``/`` on
    ints) as Python."""
    expr = expr.strip()
    if "?" in expr:
        cond, rest = expr.split("?", 1)
        then, other = rest.split(":", 1)
        return f"({_c_expr(then)} if {cond.strip()} else {_c_expr(other)})"
    return expr.replace("/", "//")


def _wgmma_fwd_source(d):
    """The constants of ``WgmmaFwd<D>`` at D = ``d``, evaluated from the
    kernel source in the order it states them."""
    src = SOURCE.read_text()
    env = {"D": d, "ROWS": int(re.search(r"#define ROWS (\d+)", src)[1])}
    for name in ("SM_SMEM", "BLOCK_SMEM"):
        env[name] = int(re.search(rf"#define {name} (\d+)", src)[1])
    body = re.search(r"struct WgmmaFwd \{(.*?)\n\};", src, re.S)[1]
    for name, expr in re.findall(
            r"static constexpr (?:int|uint32_t) (\w+) = ([^;]+);", body):
        env[name] = eval(_c_expr(expr), {}, env)
    return env


@pytest.mark.parametrize("d,stages", [(32, 6), (64, 4), (128, 3), (256, 2)])
def test_plan_models_the_kernels_block(d, stages):
    """k tile, launch bound and shared memory of the bf16 forward as
    ``_plan`` models them are the kernel source's; its ring has the
    stages that memory holds."""
    c = _wgmma_fwd_source(d)
    assert (_plan.flash_tile(d, 2), _plan.flash_fwd_blocks(d, 2),
            _plan.flash_fwd_smem(d, 2), stages) == (
        c["BK"], c["BLOCKS"], c["SMEM"], c["STAGES"])
    assert (c["SM_SMEM"], c["BLOCK_SMEM"], c["ROWS"]) == (
        _plan.SM_SMEM, _plan.BLOCK_SMEM, ROWS)
    # what TMA writes: slabs of the swizzle's width, each tile a whole
    # number of 1,024-byte atoms, the ring and the 1 KB alignment inside
    # the block's shared memory
    assert c["SLAB"] * c["SLABS"] == d and c["ROW_BYTES"] in (64, 128)
    assert c["Q_BYTES"] % 1024 == 0 and c["TILE_BYTES"] % 1024 == 0
    assert (c["SLAB"] * 2 * c["BK"]) % 1024 == 0
    assert (1024 + c["Q_BYTES"] + 2 * c["STAGES"] * c["TILE_BYTES"]
            <= c["SMEM"])


@pytest.mark.parametrize("d,tile,blocks,smem,warps", [
    (32, 64, 4, 57_344, 16), (64, 64, 3, 76_800, 12),
    (128, 64, 2, 115_712, 8), (256, 32, 2, 115_712, 8)])
def test_bf16_forward_occupancy_model(d, tile, blocks, smem, warps):
    """The SM's shared memory split evenly among the launch bound's blocks,
    so that exactly that many fit, within the 227 KB a block may have;
    the registers of S, P and O (BK / 2 + BK / 8 + d / 2 a thread) at
    most 2/3 of what the launch bound leaves a thread."""
    assert (_plan.flash_tile(d, 2), _plan.flash_fwd_blocks(d, 2),
            _plan.flash_fwd_smem(d, 2)) == (tile, blocks, smem)
    assert _plan.SM_SMEM // (smem + _plan.BLOCK_SMEM) == blocks
    assert _plan.flash_blocks_per_sm(smem, bound=blocks) == blocks
    assert smem <= 232_448
    assert _plan.flash_warps_per_sm(d, 2)[0] == warps
    regs = tile // 2 + tile // 8 + d // 2
    assert 3 * regs <= 2 * min(255, 65_536 // (128 * blocks))


@pytest.mark.parametrize("d,tile,smem,blocks,dkdv,dq,warps", [
    (32, 64, 46_080, 2, (55_808, 2), (55_296, 2), (8, 8, 8)),
    (64, 64, 87_040, 2, (104_960, 2), (104_448, 2), (8, 8, 8)),
    (128, 32, 101_376, 2, (101_632, 2), (101_376, 2), (8, 8, 8)),
    (256, 16, 133_120, 1, (208_128, 1), (207_872, 1), (4, 8, 8))])
def test_f32_and_backward_models_unchanged(d, tile, smem, blocks, dkdv, dq,
                                           warps):
    """The f32 forward's tile and shared memory, the blocks its launch
    bound of 2 gives, and the f32 backward's shared memory and blocks an
    SM (dkdv, dq), are as before the bf16 kernels moved to ``wgmma``. The
    bf16 backward's sizes: ``tests/test_torch_flash_wgmma_bwd.py``."""
    assert (_plan.flash_tile(d), _plan.flash_fwd_smem(d),
            _plan.flash_fwd_blocks(d)) == (tile, smem, 2)
    assert _plan.flash_blocks_per_sm(_plan.flash_fwd_smem(d)) == blocks
    bound = _plan.flash_bwd_blocks(d)
    for i, (smem_of, (size, n)) in enumerate(((_plan.flash_dkdv_smem, dkdv),
                                              (_plan.flash_dq_smem, dq))):
        assert smem_of(d) == size
        assert _plan.flash_blocks_per_sm(size, bound[i]) == n
    assert _plan.flash_warps_per_sm(d) == warps


def _k_tiles(q0, Sq, Sk, bk, causal):
    # csrc/flash_attention.cu::k_tiles
    n = -(-Sk // bk)
    return min(n, (min(q0 + ROWS, Sq) - 1) // bk + 1) if causal else n


SHAPES = [c[1:7] for c in FLASH_CASES] + RAGGED


@pytest.mark.parametrize("B,Sq,Sk,H,KV,d", SHAPES)
def test_bf16_ranges_cover_every_causal_k_tile(B, Sq, Sk, H, KV, d):
    """At the bf16 tile, ``split`` ranges of ``chunk`` tiles pass the
    launcher's check and cover each q tile's k tiles once, with the causal
    mask and without it; the live ranges of a q tile are the ones the
    merge reads; the plan is the shape's alone."""
    split, chunk = _plan.flash_fwd_plan(B, H, Sq, Sk, d, 2)
    bk = _plan.flash_tile(d, 2)
    nk = -(-Sk // bk)
    assert split * chunk >= nk and split == -(-nk // chunk) and chunk >= 1
    for causal in (True, False):
        for q0 in range(0, Sq, ROWS):
            n_kt = _k_tiles(q0, Sq, Sk, bk, causal)
            live = [z for z in range(split) if z * chunk < n_kt]
            seen = [kt for z in live
                    for kt in range(z * chunk, min(n_kt, (z + 1) * chunk))]
            assert seen == list(range(n_kt))
            assert live == list(range((n_kt - 1) // chunk + 1))
            keys = min(Sk, n_kt * bk)
            last = min(q0 + ROWS, Sq) - 1
            assert keys >= (min(Sk, last + 1) if causal else Sk)
    assert _plan.flash_fwd_plan(B, H, Sq, Sk, d, 2) == (split, chunk)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,d", [
    s for s in SHAPES if _plan.flash_fwd_plan(s[0], s[3], s[1], s[2],
                                              s[5], 2)[0] > 1])
def test_bf16_workspace_is_what_the_ranges_write_and_the_merge_reads(
        B, Sq, Sk, H, KV, d):
    """Range z writes its partial O at z n_o + ((b Sq + row) H + h) d + c
    and its (m, l) at split n_o + 2 ((z B H + b H + h) Sq + row); the
    merge reads the same places for the live ranges of the row's q tile:
    the highest lies inside ``flash_fwd_ws_floats`` and the lowest (m, l)
    after every partial O."""
    split, chunk = _plan.flash_fwd_plan(B, H, Sq, Sk, d, 2)
    ws = _plan.flash_fwd_ws_floats(B, H, Sq, Sk, d, 2)
    n_o = B * Sq * H * d
    top_o = (split - 1) * n_o + (((B - 1) * Sq + Sq - 1) * H + H - 1) * d \
        + d - 1
    top_ml = split * n_o + 2 * (((split - 1) * B * H + B * H - 1) * Sq
                                + Sq - 1) + 1
    assert top_o < split * n_o <= top_ml < ws == top_ml + 1
    bk = _plan.flash_tile(d, 2)
    assert max((_k_tiles(q0, Sq, Sk, bk, False) - 1) // chunk
               for q0 in range(0, Sq, ROWS)) == split - 1


def _bf16(x):
    """float32 rounded to bfloat16 (nearest even), as float32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7fff) + ((bits >> 16) & np.uint32(1))) \
        & np.uint32(0xffff0000)
    return bits.view(np.float32)


def emulate_wgmma_forward(q, k, v, causal):
    """(o (B,Sq,H,d) rounded to bf16, lse (B,H,Sq)) of the bf16 kernel's
    arithmetic on bf16 inputs (held in f32): each q tile's k tiles of
    ``flash_tile(d, 2)`` keys in the ranges of the bf16 plan; per tile S =
    Q K^T in f32, x = S (scale log2 e), masked to -1e30, m = max, alpha =
    2^(m_old - m), p = 2^(x - m) summed unrounded into l, O = alpha O +
    bf16(p) V; the ranges merged in order with m in natural-log units (m
    ln 2), as ``online_merge.cuh``; lse = m ln 2 + log l."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    bk = _plan.flash_tile(d, 2)
    _, chunk = _plan.flash_fwd_plan(B, H, Sq, Sk, d, 2)
    sl2 = (np.float32(1.0) / np.sqrt(np.float32(d))) * LOG2E
    G = H // KV
    Q = q.transpose(0, 2, 1, 3)
    K = np.repeat(k.transpose(0, 2, 1, 3), G, axis=1)
    V = np.repeat(v.transpose(0, 2, 1, 3), G, axis=1)
    pad = -(-Sk // bk) * bk - Sk
    K = np.pad(K, [(0, 0), (0, 0), (0, pad), (0, 0)])
    V = np.pad(V, [(0, 0), (0, 0), (0, pad), (0, 0)])
    o = np.zeros(Q.shape, np.float32)
    lse = np.zeros(Q.shape[:3], np.float32)
    for q0 in range(0, Sq, ROWS):
        Qt = Q[:, :, q0:q0 + ROWS]
        rows = np.arange(q0, q0 + Qt.shape[2])[:, None]
        n_kt = _k_tiles(q0, Sq, Sk, bk, causal)
        parts = []
        for lo in range(0, n_kt, chunk):
            m = np.full(Qt.shape[:3], -1e30, np.float32)
            l = np.zeros(Qt.shape[:3], np.float32)
            acc = np.zeros(Qt.shape, np.float32)
            for kt in range(lo, min(n_kt, lo + chunk)):
                k0 = kt * bk
                x = (Qt @ K[:, :, k0:k0 + bk].swapaxes(-1, -2)) * sl2
                cols = k0 + np.arange(bk)[None, :]
                x = np.where((cols >= Sk) | (causal & (cols > rows)),
                             np.float32(-1e30), x)
                m_new = np.maximum(m, x.max(-1))
                alpha = np.exp2(m - m_new)
                p = np.exp2(x - m_new[..., None])
                l = l * alpha + p.sum(-1, dtype=np.float32)
                acc = acc * alpha[..., None] + _bf16(p) @ V[:, :, k0:k0 + bk]
                m = m_new
            parts.append((m * LN2, l, acc))
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
    return _bf16(o).transpose(0, 2, 1, 3), lse


@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,causal", [
    (2, 200, 200, 4, 2, 32, True), (1, 192, 192, 4, 1, 64, True),
    (1, 160, 96, 4, 2, 128, True), (1, 96, 160, 8, 2, 64, True),
    (1, 128, 128, 4, 4, 64, False), (1, 512, 512, 4, 1, 256, True),
    (1, 130, 300, 2, 1, 128, False)])
def test_wgmma_forward_emulation_passes_the_bf16_gates(B, Sq, Sk, H, KV, d,
                                                       causal):
    """On the same bf16 inputs: o within the JAX bf16 gate (rtol/atol 2e-2)
    of JAX's flash reference, and within phase 3c-bf16's bound of the
    port's plain version (the f32-accumulation bound with P's rounding u =
    2^-8, plus a bf16 ulp of the plain value), lse within its bound. The
    gemma3-1b global shape splits into ranges at the bf16 tile."""
    cs = load_chip_smoke()
    rng = np.random.default_rng(d + Sq + causal)
    q, k, v = (_bf16(rng.standard_normal(s).astype(np.float32)) for s in
               ((B, Sq, H, d), (B, Sk, KV, d), (B, Sk, KV, d)))
    o, lse = emulate_wgmma_forward(q, k, v, causal)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal)
                      .astype(jnp.float32))
    np.testing.assert_allclose(o, want, rtol=2e-2, atol=2e-2)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    o_p, lse_p = ref.flash_attention_fwd_ref(tq, tk, tv, causal)
    tol_o, _, a = cs.flash_tolerances(
        tq.float(), tk.float(), tv.float(), o_p.float(), lse_p,
        torch.zeros(q.shape), causal, u=2.0 ** -8)
    tol = (tol_o + cs.BF16_ULP * o_p.float().abs()).numpy()
    err = np.abs(o - o_p.float().numpy())
    assert (err <= tol).all(), float((err / tol).max())
    lse_tol = 16 * np.finfo(np.float32).eps * (
        float(lse_p.abs().max()) + math.sqrt(d) * (1 + a))
    assert float(np.abs(lse - lse_p.numpy()).max()) <= lse_tol


@pytest.fixture
def recording_fwd_bf16(monkeypatch):
    """The forward wrapper's calls into the bf16 entry point and its
    allocations, recorded (CPU tensors stand in for CUDA ones)."""
    calls, sizes = [], []
    empty = torch.empty
    names = ("q", "k", "v", "o", "lse", "B", "H", "KV", "Sq", "Sk", "d",
             "qsb", "qss", "qsh", "ksb", "kss", "ksh", "vsb", "vss", "vsh",
             "causal", "split", "chunk", "ws", "stream")

    def fwd(*args):
        assert len(args) == len(names)
        calls.append(dict(zip(names, args)))
        return 0

    def recording_empty(*shape, **kw):
        sizes.append(tuple(shape[0]) if len(shape) == 1 and isinstance(
            shape[0], (tuple, list)) else shape)
        return empty(*shape, **kw)

    # the wrapper's launch count is the process's: put it back afterwards
    monkeypatch.setattr(fa.cuda_flash_attention_fwd, "launches",
                        fa.cuda_flash_attention_fwd.launches)
    monkeypatch.setattr(_build, "load", lambda name: SimpleNamespace(
        flash_attention_fwd_bf16=fwd))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", recording_empty)
    return calls, sizes


@pytest.mark.parametrize("B,S,H,KV,d", [(1, 512, 4, 1, 256),
                                        (1, 384, 16, 4, 64),
                                        (1, 200, 4, 2, 32),
                                        (1, 4096, 64, 8, 128)])
def test_bf16_wrapper_passes_the_bf16_plan(recording_fwd_bf16, B, S, H, KV,
                                           d):
    """bf16 views of one packed (B,S,3,H,d) buffer reach the bf16 entry
    point with their strides (multiples of 16 bytes, as the tensor maps
    need), the plan of the shape at 2-byte elements and a workspace of its
    size, one launch a call."""
    calls, sizes = recording_fwd_bf16
    split, chunk = _plan.flash_fwd_plan(B, H, S, S, d, 2)
    qkv = torch.zeros((B, S, 3, H, d), dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    before = fa.cuda_flash_attention_fwd.launches
    o, lse = fa.cuda_flash_attention_fwd(q, k[:, :, :KV], v[:, :, :KV], True)
    call = calls[-1]
    assert (call["split"], call["chunk"], call["KV"], call["d"]) == (
        split, chunk, KV, d)
    assert (_plan.flash_fwd_ws_floats(B, H, S, S, d, 2),) in sizes
    assert all(call[s] % 8 == 0 for s in ("qsb", "qss", "qsh", "ksb", "kss",
                                          "ksh", "vsb", "vss", "vsh"))
    assert (call["qss"], call["qsh"]) == (3 * H * d, d)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert fa.cuda_flash_attention_fwd.launches == before + 1
