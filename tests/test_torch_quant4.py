"""Port parity: the plain int4 pack/unpack of ``repro_torch.kernels`` (the
CUDA kernels' plain versions) against the JAX package's jitted
``quant4_pack_ref`` and its Pallas kernels in interpret mode. Inputs cover
n not a multiple of 256, an all-zero block and exact .5 ties. The gate is
bit identity: the scale is amax * f32(1/7), as XLA computes ``amax / 7``
under jit. The CUDA kernels' own test is ``tests/test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fused_contract import load_chip_smoke, quant_inputs
from repro.kernels import ref as jref
from repro.kernels.quant4 import quant4_pack_pallas, quant4_unpack_pallas
from repro_torch.kernels import quant4 as q4
from repro_torch.kernels import ref

SIZES = [4, 255, 1000, 1024, 256 * 37, 5000]

_jit_pack = jax.jit(jref.quant4_pack_ref, static_argnums=1)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_bit_identical_to_jitted_jax_ref(n, seed):
    x = quant_inputs(n, seed=seed)
    p_j, s_j, _ = _jit_pack(jnp.asarray(x), 256)
    p, s, n_out = ref.quant4_pack_ref(torch.from_numpy(x))
    assert n_out == n
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("n", SIZES)
def test_pack_bit_identical_to_pallas_interpret(n):
    x = quant_inputs(n, seed=3)
    p_pl, s_pl = quant4_pack_pallas(jnp.asarray(x))
    p, s = q4.quant4_pack(torch.from_numpy(x))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_pl))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_pl))


@pytest.mark.parametrize("n", SIZES)
def test_unpack_exact(n):
    x = quant_inputs(n, seed=5)
    p_j, s_j, _ = _jit_pack(jnp.asarray(x), 256)
    want = np.asarray(jax.jit(jref.quant4_unpack_ref, static_argnums=(2, 3))(
        p_j, s_j, n, 256))
    want_pl = np.asarray(quant4_unpack_pallas(p_j, s_j, n))
    got = q4.quant4_unpack(torch.from_numpy(np.array(p_j)),
                           torch.from_numpy(np.array(s_j)), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_pl)


def test_ties_round_half_to_even():
    """A block of 2.5s at scale 1 packs to code 2, not 3; -2.5 to -2."""
    x = np.full(256, 2.5, np.float32)
    x[0], x[1] = 7.0, -2.5
    p, s, _ = ref.quant4_pack_ref(torch.from_numpy(x))
    assert float(s[0]) == 1.0
    codes = ref.quant4_unpack_ref(p, s, 256).numpy()
    assert codes[0] == 7.0 and codes[1] == -2.0 and (codes[2:] == 2.0).all()


def test_zero_block_scale_is_one():
    p, s, _ = ref.quant4_pack_ref(torch.zeros(300))
    assert s.tolist() == [1.0, 1.0] and not p.any()


def test_cpu_dispatch_runs_the_plain_version():
    x = torch.from_numpy(quant_inputs(1000))
    p, s = q4.quant4_pack(x)
    p_ref, s_ref, _ = ref.quant4_pack_ref(x)
    assert torch.equal(p, p_ref) and torch.equal(s, s_ref)
    assert torch.equal(q4.quant4_unpack(p, s, 1000),
                       ref.quant4_unpack_ref(p, s, 1000))


# ---------------------------------------------------------------------------
# the batched entry points (one launch per leaf and factor on the card)
# ---------------------------------------------------------------------------

_vmap_pack = jax.jit(jax.vmap(lambda v: jref.quant4_pack_ref(v, 256)[:2]))


def _batch(B, n, seed):
    """(B, n) f32 rows of ``quant_inputs`` (ties, a zero block, ragged n);
    row 1 all zero."""
    x = np.stack([quant_inputs(n, seed=seed + b) for b in range(B)])
    if B > 1:
        x[1] = 0
    return x


BATCHES = [(1, 1000), (3, 255), (3, 256 * 37), (24, 1000), (24, 5000)]


@pytest.mark.parametrize("B,n", BATCHES)
def test_batched_pack_bit_identical_to_rows_vmap_and_pallas(B, n):
    """The batched plain pack row by row equals the single-row pack, the
    jitted JAX ref under ``jax.vmap`` and, at three rows, the Pallas
    kernel (interpret mode)."""
    x = _batch(B, n, seed=B + n)
    p, s = q4.quant4_pack_batched(torch.from_numpy(x))
    assert p.shape == (B, -(-n // 256) * 128) and s.shape == (B, -(-n // 256))
    p_j, s_j = _vmap_pack(jnp.asarray(x))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    for b in range(B):
        p1, s1 = q4.quant4_pack(torch.from_numpy(x[b]))
        assert torch.equal(p1, p[b]) and torch.equal(s1, s[b])
    for b in sorted({0, min(1, B - 1), B - 1}):
        p_pl, s_pl = quant4_pack_pallas(jnp.asarray(x[b]))
        np.testing.assert_array_equal(p[b].numpy(), np.asarray(p_pl))
        np.testing.assert_array_equal(s[b].numpy(), np.asarray(s_pl))


@pytest.mark.parametrize("B,n", BATCHES)
def test_batched_unpack_exact_against_rows_vmap_and_pallas(B, n):
    """The batched plain unpack equals the single-row unpack, the jitted
    JAX ref under ``jax.vmap`` and, at three rows, the Pallas kernel; with
    ``out`` it writes a strided output's rows and nothing else."""
    p_j, s_j = _vmap_pack(jnp.asarray(_batch(B, n, seed=B * n)))
    p, s = torch.from_numpy(np.array(p_j)), torch.from_numpy(np.array(s_j))
    got = q4.quant4_unpack_batched(p, s, n)
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b: jref.quant4_unpack_ref(a, b, n, 256)))(p_j, s_j))
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(B):
        assert torch.equal(q4.quant4_unpack(p[b], s[b], n), got[b])
    for b in sorted({0, min(1, B - 1), B - 1}):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(quant4_unpack_pallas(p_j[b], s_j[b],
                                                            n)))
    buf = torch.full((B, n + 2), 9.0)
    q4.quant4_unpack_batched(list(p), list(s), n, out=buf[:, 1:n + 1])
    assert torch.equal(buf[:, 1:n + 1], got)
    assert (buf[:, 0] == 9).all() and (buf[:, -1] == 9).all()


PACK_ARGS = ("x", "xs0", "xs1", "packed", "ps0", "ps1", "scales", "ss0",
             "ss1", "B", "R", "n", "block", "stream")
UNPACK_ARGS = ("packed", "ps0", "ps1", "scales", "ss0", "ss1", "out", "os0",
               "os1", "B", "R", "n", "block", "stream")


@pytest.fixture
def recording_lib(monkeypatch):
    """The wrappers' calls into the kernel library, recorded instead of
    launched (CPU tensors stand in for CUDA ones)."""
    from types import SimpleNamespace

    from repro_torch.kernels import _build

    calls = []

    def record(kind, names):
        def fn(*args):
            assert len(args) == len(names)
            calls.append(dict(zip(names, args), kind=kind))
            return 0
        return fn

    monkeypatch.setattr(_build, "load", lambda name: SimpleNamespace(
        quant4_pack_f32=record("pack", PACK_ARGS),
        quant4_unpack_f32=record("unpack", UNPACK_ARGS)))
    monkeypatch.setattr(q4, "_stream", lambda t: 0)
    return calls


@pytest.mark.parametrize("layout,B,n,stride", [
    ("rows", 24, 1000, 1000),                 # contiguous rows
    ("factor view", 24, 640, 640),            # P.reshape(B, -1) of (B, 64, 10)
    ("row stride", 3, 300, 303),              # rows of a wider tensor
    ("odd start", 3, 300, 300)])              # 4 bytes off a 16-byte boundary
def test_pack_wrapper_passes_the_rows_as_they_lie(recording_lib, layout, B,
                                                  n, stride):
    """One launch a call, the input's first row and row stride passed as
    they are (no copy), fresh contiguous outputs of one row per input row."""
    if layout == "factor view":
        x = torch.zeros((B, 64, 10)).reshape(B, -1)
    elif layout == "row stride":
        x = torch.zeros((B, stride))[:, :n]
    elif layout == "odd start":
        x = torch.zeros(B * n + 1)[1:].view(B, n)
    else:
        x = torch.zeros((B, n))
    before = q4.cuda_quant4_pack.launches
    p, s = q4.cuda_quant4_pack_batched(x)
    call = recording_lib[-1]
    assert len(recording_lib) == 1
    assert q4.cuda_quant4_pack.launches == before + 1
    assert (call["x"], call["xs1"], call["B"], call["R"], call["n"]) == (
        x.data_ptr(), stride, B, B, n)
    nbytes, nblk = -(-n // 256) * 128, -(-n // 256)
    assert p.shape == (B, nbytes) and s.shape == (B, nblk)
    assert (call["packed"], call["ps1"], call["scales"], call["ss1"]) == (
        p.data_ptr(), nbytes, s.data_ptr(), nblk)
    assert call["block"] == 256


def _wire(B, nbytes, nblk, ranks, gap, start=0):
    """Chunks of one factor's codes and scales as ``gather_payloads`` lays
    them out: in each rank's buffer of a (ranks, L) receive tensor (L a
    multiple of 4), the scales region first, each row's chunk ``gap``
    bytes after the last."""
    L = -(-(4 * B * (nblk + 1) + B * (nbytes + gap) + start) // 4) * 4
    recv = torch.zeros((ranks, L), dtype=torch.uint8)
    at = 4 * B * (nblk + 1) + start
    codes = [recv[g, at + i * (nbytes + gap):][:nbytes]
             for g in range(ranks) for i in range(B)]
    scales = [recv[g, 4 * i * (nblk + 1):][:4 * nblk].view(torch.float32)
              for g in range(ranks) for i in range(B)]
    return recv, codes, scales


@pytest.mark.parametrize("ranks,gap,start", [(1, 0, 0), (1, 64, 0),
                                             (2, 64, 0), (3, 101, 1)])
def test_unpack_wrapper_reads_gathered_chunks_in_place(recording_lib, ranks,
                                                       gap, start):
    """Chunks of a gathered receive tensor (one rank's rows a stride apart,
    ranks a buffer apart; an odd gap and start put rows off any word
    boundary) go to one launch as (first row, group stride, row stride),
    rows R a group, and the output rows of a (B, m, r) factor at its row
    stride."""
    B, m, r = 4, 30, 10
    nbytes, nblk = 256, 2
    recv, codes, scales = _wire(B, nbytes, nblk, ranks, gap, start)
    P = torch.empty((ranks * B, m, r))
    before = q4.cuda_quant4_unpack.launches
    q4.cuda_quant4_unpack_batched(codes, scales, m * r, out=P.view(
        ranks * B, -1))
    call = recording_lib[-1]
    assert len(recording_lib) == 1
    assert q4.cuda_quant4_unpack.launches == before + 1
    R = B if ranks > 1 or gap else ranks * B
    assert (call["packed"], call["B"], call["R"]) == (
        codes[0].data_ptr(), ranks * B, R)
    assert call["ps1"] == nbytes + gap and call["ss1"] == nblk + 1
    if ranks > 1:
        assert (call["ps0"], call["ss0"]) == (recv.shape[1],
                                              recv.shape[1] // 4)
    assert (call["out"], call["os1"], call["os0"]) == (P.data_ptr(), m * r,
                                                       R * m * r)


@pytest.mark.parametrize("B", [2, 24])
def test_chip_smoke_wire_rows_reach_the_grouped_addressing(recording_lib, B):
    """``chip_smoke._wire_rows`` (phase 3b's two-rank wire layout and the
    ``cuda`` tests') puts the ranks a buffer apart, not a row stride: the
    wrapper hands the kernel 2 groups of B rows (R = B, not 2 B), and the
    plain unpack of those rows is the unpack of the pack's own rows."""
    cs = load_chip_smoke()
    n, gap, head = 1000, 101, 37
    x = torch.from_numpy(_batch(B, n, seed=B))
    p, s = q4.pack_batched_plain(x)
    pw, sw = cs._wire_rows(p, gap, head), cs._wire_rows(s, 3, 5)
    q4.cuda_quant4_unpack_batched(pw, sw, n)
    call = recording_lib[-1]
    step, L = gap + p.shape[1], head + B * (gap + p.shape[1])
    assert (call["B"], call["R"], call["ps1"], call["ps0"]) == (
        2 * B, B, step, L)
    assert (call["ss1"], call["ss0"]) == (3 + s.shape[1],
                                          5 + B * (3 + s.shape[1]))
    assert cs._wire_groups(pw, torch.uint8, p.shape[1]) == (B, L, step)
    assert torch.equal(q4.unpack_batched_plain(pw, sw, n),
                       q4.unpack_batched_plain(p, s, n).repeat(2, 1))


def test_batched_wrappers_refuse_what_the_kernel_cannot_address(
        recording_lib):
    """Overlapping rows, rows at no (group, row) stride, a wrong dtype and
    differently grouped operands raise, and nothing launches."""
    with pytest.raises(ValueError, match="overlap"):
        q4.cuda_quant4_pack_batched(
            torch.zeros(600).as_strided((3, 300), (100, 1)))
    with pytest.raises(ValueError, match="overlap"):
        q4.cuda_quant4_pack_batched(torch.zeros(300).expand(3, 300))
    with pytest.raises(TypeError):
        q4.cuda_quant4_pack_batched(torch.zeros((3, 300),
                                                dtype=torch.float64))
    p, s = torch.zeros((3, 256), dtype=torch.uint8), torch.ones((3, 2))
    buf = torch.zeros(1000, dtype=torch.uint8)
    with pytest.raises(ValueError, match="no \\(group stride"):
        q4.cuda_quant4_unpack_batched([buf[0:256], buf[300:556],
                                       buf[700:956]], s, 300)
    with pytest.raises(ValueError, match="overlap"):
        q4.cuda_quant4_unpack_batched([buf[0:256], buf[100:356],
                                       buf[200:456]], s, 300)
    with pytest.raises(ValueError, match="overlap"):
        q4.cuda_quant4_unpack_batched(p, s, 300, out=torch.zeros(
            900).as_strided((3, 300), (200, 1)))
    with pytest.raises(TypeError):
        q4.cuda_quant4_unpack_batched(p, s, 300, out=torch.zeros(
            (3, 300), dtype=torch.float64))
    recv, codes, scales = _wire(2, 256, 2, 2, 0)
    with pytest.raises(ValueError, match="grouped differently"):
        q4.cuda_quant4_unpack_batched(codes, torch.ones((4, 2)), 300)
    assert recording_lib == []
