"""The flash forward's k-range split and ordered merge
(``csrc/flash_attention.cu``, ``csrc/online_merge.cuh``), on the CPU:

- the forward plan (``repro_torch.kernels._plan.flash_fwd_plan``) reads
  the shape alone, splits gemma3-1b's global layers over more blocks than
  their 32 q tiles, and nothing at the training shape;
- the numpy emulation of the kernels' arithmetic (``emulate_forward`` of
  ``tests/test_torch_flash_tf32.py``: 3xTF32 products, the plan's ranges
  of k tiles, each range's online softmax, the merge in range order)
  against the JAX package's ``flash_attention_ref`` and its Pallas kernel
  in interpret mode, and against ``chip_smoke.py``'s phase-3c gate at
  gemma3-1b global's own shape and plan;
- the wrapper ``cuda_flash_attention_fwd`` driven on CPU tensors with a
  recording stand-in for the kernel library: the plan of the shape and a
  workspace of its size for strided views, copies and misaligned starts,
  and the plain version on CPU tensors.

The kernels themselves run in ``tests/test_torch_cuda.py``."""
import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from _fused_contract import load_chip_smoke
from test_torch_flash_tf32 import emulate_forward
from repro_torch.kernels import _build, _plan, ref
from repro_torch.kernels import flash_attention as fa

ROWS = _plan.FLASH_ROWS
# the JAX package's gate for its Pallas flash kernel (tests/test_kernels.py)
FLASH_GATE = 2e-3
# the emulated 3xTF32 forward against an f32 reference: both are f32
# results of the same sums, 3xTF32 keeping about 22 bits of each product;
# o is a convex combination of rows of v (|v| < 5), so 1e-5 absolute is
# some 40 f32 ulps of its largest entries, and lse (up to ~15) gets 16
# ulps more (rtol 2e-6); the emulation's worst is 7.6e-6 (lse at d 256)
EMU_TOL = dict(rtol=2e-6, atol=1e-5)


def _case(name):
    return next(c for c in load_chip_smoke().FLASH_CASES if c[0] == name)


def _live_blocks(B, H, Sq, Sk, d, chunk):
    tile = _plan.flash_tile(d)
    nk = -(-Sk // tile)
    counts = [min(nk, (min(q0 + ROWS, Sq) - 1) // tile + 1)
              for q0 in range(0, Sq, ROWS)]
    return B * H * sum(-(-c // chunk) for c in counts)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_fwd_plan_reads_the_shape_alone():
    """No batch contents, strides, lengths or mask: the same ranges, and
    so the same sum order, for every call of a shape (and element size:
    bf16 tiles take half the shared memory, so more blocks an SM)."""
    assert list(inspect.signature(_plan.flash_fwd_plan).parameters) == [
        "B", "H", "Sq", "Sk", "d", "esize"]


def test_fwd_plan_splits_gemma3_global_over_more_blocks():
    """32 q tiles (B 1, H 4, Sq 512) for 132 SMs: ranges of a fixed
    number of k tiles give more live blocks than 32 and a longest block
    shorter than the last q tile's 32 tiles."""
    _, B, Sq, Sk, H, KV, d, _ = _case("gemma3-1b global")
    split, chunk = _plan.flash_fwd_plan(B, H, Sq, Sk, d)
    nk = -(-Sk // _plan.flash_tile(d))
    assert split > 1 and chunk < nk and split == -(-nk // chunk)
    assert _live_blocks(B, H, Sq, Sk, d, chunk) > B * H * -(-Sq // ROWS)
    assert B * H * -(-Sq // ROWS) * split > 32         # the launched grid
    assert B * H * -(-Sq // ROWS) * split >= _plan.SMS
    assert (split, chunk) == (7, 5)
    assert _plan.flash_fwd_ws_floats(B, H, Sq, Sk, d) == (
        split * B * H * Sq * (d + 2))


@pytest.mark.parametrize("name", ["opt-1.3b train", "opt-1.3b 2048",
                                  "hundred-m", "non-causal", "qwen1.5-107b"])
def test_fwd_plan_does_not_split_grids_that_fill_the_card(name):
    """B H ceil(Sq / 64) >= 132 blocks: one range, the kernel writes o and
    lse itself (the training shape keeps its bits), no workspace."""
    _, B, Sq, Sk, H, KV, d, _ = _case(name)
    assert B * H * -(-Sq // ROWS) >= _plan.SMS
    assert _plan.flash_fwd_plan(B, H, Sq, Sk, d) == (
        1, -(-Sk // _plan.flash_tile(d)))
    assert _plan.flash_fwd_ws_floats(B, H, Sq, Sk, d) == 0


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_resident_warps_per_sm(d):
    """The backward keeps 8 warps on each SM at every head dim: two 4-warp
    blocks an SM at d <= 128, one 8-warp block at d = 256; every block's
    shared memory within the 227 KB a block may have."""
    fwd, dkdv, dq = _plan.flash_warps_per_sm(d)
    assert dkdv >= 8 and dq >= 8
    assert fwd == (4 if d == 256 else 8)
    for smem in (_plan.flash_fwd_smem(d), _plan.flash_dkdv_smem(d),
                 _plan.flash_dq_smem(d)):
        assert smem <= 232_448


def test_backward_shared_memory_at_the_wide_head_dims():
    """The sizes the kernels' launchers compute (``launch_bwd``): d = 128
    under half an SM, d = 256 with the 8 KB P / dP exchange."""
    assert [_plan.flash_dkdv_smem(128), _plan.flash_dq_smem(128)] == [
        101_632, 101_376]
    assert [_plan.flash_dkdv_smem(256), _plan.flash_dq_smem(256)] == [
        208_128, 207_872]
    assert _plan.flash_fwd_smem(256) == 133_120


# ---------------------------------------------------------------------------
# the emulation against the JAX package
# ---------------------------------------------------------------------------

def _inputs(B, S, H, KV, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(B, S, H, d), (B, S, KV, d), (B, S, KV, d)]]


@pytest.mark.parametrize("B,S,H,KV,d", [(1, 256, 4, 2, 64),
                                        (1, 256, 2, 1, 128),
                                        (1, 512, 4, 1, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_split_emulation_matches_jax_ref_and_pallas(B, S, H, KV, d, causal):
    """The plan splits each of these shapes (fewer than 132 q tiles); the
    emulated kernels' o agrees with JAX's f32 reference within EMU_TOL
    and with its Pallas kernel (interpret mode, 128-row blocks) within
    the gate the JAX package holds that kernel to; lse within EMU_TOL of
    the port's plain forward."""
    split, chunk = _plan.flash_fwd_plan(B, H, S, S, d)
    assert split > 1
    q, k, v = _inputs(B, S, H, KV, d, seed=d + causal)
    o, lse = emulate_forward(q, k, v, causal, passes=3)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=128, bk=128, interpret=True))
    np.testing.assert_allclose(o, want, **EMU_TOL)
    np.testing.assert_allclose(o, pallas, rtol=FLASH_GATE, atol=FLASH_GATE)
    _, lse_p = ref.flash_attention_fwd_ref(*map(torch.from_numpy, (q, k, v)),
                                           causal)
    np.testing.assert_allclose(lse, lse_p.numpy(), **EMU_TOL)


def test_split_emulation_passes_the_flash_gate_at_gemma3_global():
    """gemma3-1b's global layer at its real shape and plan (ranges of
    several k tiles, rows whose keys in a range are all masked): within
    0.05 of phase 3c's elementwise f32 bound, as the unsplit kernels."""
    cs = load_chip_smoke()
    _, B, S, _, H, KV, d, causal = _case("gemma3-1b global")
    q, k, v = _inputs(B, S, H, KV, d, seed=7)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o_p, lse_p = ref.flash_attention_fwd_ref(tq, tk, tv, causal)
    tol_o, _, _ = cs.flash_tolerances(tq, tk, tv, o_p, lse_p,
                                      torch.zeros_like(tq), causal)
    o, _ = emulate_forward(q, k, v, causal, passes=3)
    _, ratio = cs._gate("3xTF32 gemma3-1b global o",
                        torch.from_numpy(np.ascontiguousarray(o)), o_p, tol_o)
    assert ratio <= 0.05, ratio


# ---------------------------------------------------------------------------
# the wrapper, with a recording stand-in for the kernel library
# ---------------------------------------------------------------------------

FWD_ARGS = ("q", "k", "v", "o", "lse", "B", "H", "KV", "Sq", "Sk", "d",
            "qsb", "qss", "qsh", "ksb", "kss", "ksh", "vsb", "vss", "vsh",
            "causal", "split", "chunk", "ws", "stream")


@pytest.fixture
def recording_fwd(monkeypatch):
    """The forward wrapper's calls into the kernel library and its
    allocations, recorded (CPU tensors stand in for CUDA ones)."""
    calls, sizes = [], []
    empty = torch.empty

    def fwd(*args):
        assert len(args) == len(FWD_ARGS)
        calls.append(dict(zip(FWD_ARGS, args)))
        return 0

    def recording_empty(*shape, **kw):
        sizes.append(tuple(shape[0]) if len(shape) == 1 and isinstance(
            shape[0], (tuple, list)) else shape)
        return empty(*shape, **kw)

    # the wrapper's launch count is the process's: put it back afterwards
    monkeypatch.setattr(fa.cuda_flash_attention_fwd, "launches",
                        fa.cuda_flash_attention_fwd.launches)
    monkeypatch.setattr(_build, "load", lambda name: SimpleNamespace(
        flash_attention_fwd_f32=fwd))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", recording_empty)
    return calls, sizes


@pytest.mark.parametrize("B,S,H,KV,d", [(1, 512, 4, 1, 256),
                                        (1, 200, 32, 8, 128),
                                        (4, 512, 32, 32, 64)])
def test_fwd_wrapper_passes_the_plan_of_the_shape_for_every_layout(
        recording_fwd, B, S, H, KV, d):
    """A strided view of one (B,S,3,H,d) buffer, its contiguous copy and a
    view whose start is not 16-byte aligned (which the wrapper copies) get
    the plan of the shape, a workspace of its size (none with one range)
    and one launch each."""
    calls, sizes = recording_fwd
    split, chunk = _plan.flash_fwd_plan(B, H, S, S, d)
    ws = _plan.flash_fwd_ws_floats(B, H, S, S, d)
    qkv = torch.zeros((B, S, 3, H, d))
    odd = torch.zeros(B * S * H * d + 1)[1:].view(B, S, H, d)
    layouts = {"view": qkv.unbind(2), "copy": [
        t.contiguous() for t in qkv.unbind(2)], "odd start": (odd,) * 3}
    before = fa.cuda_flash_attention_fwd.launches
    for name, (q, k, v) in layouts.items():
        k, v = k[:, :, :KV], v[:, :, :KV]
        del sizes[:]
        o, lse = fa.cuda_flash_attention_fwd(q, k, v, True)
        call = calls[-1]
        assert (call["split"], call["chunk"], call["KV"]) == (
            split, chunk, KV), name
        assert (ws,) in sizes, (name, sizes)
        assert all(call[p] % 16 == 0 for p in ("q", "k", "v")), name
        assert call["o"] == o.data_ptr() and call["lse"] == lse.data_ptr()
    assert fa.cuda_flash_attention_fwd.launches == before + 3
    assert [c["split"] for c in calls] == [split] * 3


def test_fwd_on_cpu_tensors_is_the_plain_version():
    """``flash_attention_fwd`` takes the plain version for CPU tensors,
    whatever the plan of the shape, and launches nothing."""
    q, k, v = map(torch.from_numpy, _inputs(1, 128, 4, 1, 256, seed=3))
    before = fa.cuda_flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert fa.cuda_flash_attention_fwd.launches == before
