"""Port parity for the tiled matmul (``repro_torch.kernels.lowrank_mm``):
the port's ``matmul`` on CPU tensors (its plain version) against the JAX
package's ``matmul_pallas`` in interpret mode at the shapes of
``tests/test_kernels.py``, in float32 and bfloat16, with that test's
tolerances (rtol/atol 1e-4, 2e-2 for bf16); transposed views and batched
operands against per-matrix products; mixed dtypes promote; the wrapper
refuses what the kernel does not take. The CUDA kernel's own legs are in
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lowrank_mm import matmul_pallas
from repro_torch.kernels import lowrank_mm as L
from repro_torch.kernels import ref

SHAPES = [(128, 128, 128), (256, 384, 128), (100, 70, 36), (1, 512, 64),
          (333, 129, 257)]


def _operands(shape, seed=0):
    rng = np.random.default_rng(seed)
    m, k, n = shape
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(shape, dtype):
    a, b = _operands(shape)
    ja = jnp.asarray(a).astype(dtype)
    jb = jnp.asarray(b).astype(dtype)
    want = np.asarray(matmul_pallas(ja, jb, interpret=True), np.float32)
    tdt = getattr(torch, dtype)
    got = L.matmul(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and got.shape == shape[::2]
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(100, 70, 36), (333, 129, 257)])
def test_transposed_views_equal_contiguous_copies(shape):
    """M^T P and P Q^T as the mesh compressor forms them: views, bit for
    bit the product of their contiguous copies."""
    a, b = (torch.from_numpy(x) for x in _operands(shape, 1))
    at = a.T.contiguous().T           # same values, column-major storage
    bt = b.T.contiguous().T
    assert not at.is_contiguous() and not bt.is_contiguous()
    want = L.matmul(a, b)
    for x, y in ((at, b), (a, bt), (at, bt)):
        assert torch.equal(L.matmul(x, y), want)


def test_batched_operands_match_per_matrix_products():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((3, 40, 70)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 40, 24)).astype(np.float32))
    got = L.matmul(a.transpose(1, 2), b)          # (3, 70, 24), strided a
    assert got.shape == (3, 70, 24) and got.is_contiguous()
    for i in range(3):
        assert torch.equal(got[i], ref.matmul_ref(a[i].T, b[i]))
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(matmul_pallas(
                jnp.asarray(a[i].numpy().T), jnp.asarray(b[i].numpy()))),
            rtol=1e-4, atol=1e-4)
    # a matrix's product does not depend on the batch it is computed in
    assert torch.equal(L.matmul(a[1:2].transpose(1, 2), b[1:2])[0], got[1])


def test_mixed_dtypes_promote_and_empty_operands():
    a, b = (torch.from_numpy(x) for x in _operands((100, 70, 36), 3))
    got = L.matmul(a.to(torch.bfloat16), b)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.matmul_ref(a.to(torch.bfloat16).float(), b))
    assert L.matmul(torch.zeros((0, 5)), torch.zeros((5, 3))).shape == (0, 3)
    assert torch.equal(L.matmul(torch.ones((2, 0)), torch.ones((0, 3))),
                       torch.zeros((2, 3)))


def test_matmul_refuses_outside_envelope():
    a = torch.zeros((4, 5))
    with pytest.raises(ValueError):
        L.matmul(a, torch.zeros((4, 5)))              # k mismatch
    with pytest.raises(ValueError):
        L.matmul(torch.zeros((2, 4, 5)), torch.zeros((3, 5, 2)))
    with pytest.raises(ValueError):
        L.matmul(torch.zeros((4,)), torch.zeros((4,)))
    with pytest.raises(TypeError):
        L.matmul(a.double(), torch.zeros((5, 2)).double())
    with pytest.raises(ValueError):
        L.matmul(a, torch.zeros((5, 2), device="meta"))


# ---------------------------------------------------------------------------
# the card's routes (split, rank, general) and the split plan, checked on
# the CPU through the real wrapper with a recording stand-in for the kernel
# library (the kernels themselves run in tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

from types import SimpleNamespace  # noqa: E402

from repro_torch.kernels import _build, _plan  # noqa: E402


def _rnd(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


ROUTE_CASES = [
    # name: (a, b) -> route
    ("M Q", lambda: (_rnd(2, 130, 300), _rnd(2, 300, 64)), "split"),
    ("M^T P", lambda: (_rnd(2, 300, 130).transpose(1, 2), _rnd(2, 300, 24)),
     "split"),
    ("r = 7", lambda: (_rnd(1, 50, 90), _rnd(1, 90, 7)), "split"),
    ("P Q^T", lambda: (_rnd(2, 130, 64), _rnd(2, 200, 64).transpose(1, 2)),
     "rank"),
    ("P Q^T, Q^T copied, n > 64", lambda: (_rnd(2, 130, 40),
                                           _rnd(2, 40, 200)), "rank"),
    ("k = 7", lambda: (_rnd(1, 30, 7), _rnd(1, 90, 7).transpose(1, 2)),
     "rank"),
    ("wide", lambda: (_rnd(1, 128, 128), _rnd(1, 128, 128)), "general"),
    ("n <= 64 but B column-major", lambda: (
        _rnd(1, 50, 300), _rnd(1, 24, 300).transpose(1, 2)), "general"),
    ("A without a unit stride", lambda: (
        _rnd(1, 100, 600)[:, ::2, ::2], _rnd(1, 300, 24)), "general"),
    ("bf16", lambda: (_rnd(1, 50, 300, dtype=torch.bfloat16),
                      _rnd(1, 300, 24, dtype=torch.bfloat16)), "general"),
    ("bf16 @ f32", lambda: (_rnd(1, 50, 40, dtype=torch.bfloat16),
                            _rnd(1, 40, 300)), "general"),
    ("k = 0", lambda: (torch.zeros(1, 5, 0), torch.zeros(1, 0, 3)),
     "general"),
]


@pytest.mark.parametrize("name,make,route", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_route_by_shape_dtype_and_layout(name, make, route):
    a, b = make()
    assert L._route(a, b) == route


@pytest.fixture
def recording_lib(monkeypatch):
    """The wrapper's calls into the kernel library, recorded instead of
    launched (CPU tensors stand in for CUDA ones)."""
    calls = []

    def lowrank_mm(*args):
        calls.append(dict(zip(
            ("a", "a_bf16", "b", "b_bf16", "c", "batch", "m", "n", "k",
             "sa_b", "sa_m", "sa_k", "sb_b", "sb_k", "sb_n", "route",
             "splits", "chunk", "ws", "stream"), args)))
        return 0

    monkeypatch.setattr(_build, "load",
                        lambda name: SimpleNamespace(lowrank_mm=lowrank_mm))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("m,K", [(2048, 50272), (2048, 2048), (2048, 8192),
                                 (8192, 2048), (50272, 2048), (130, 1030),
                                 (1, 512), (257, 20003)])
def test_split_plan_is_batch_and_layout_free_and_covers_k(recording_lib, m,
                                                          K):
    """The split route's (S, chunk) is the same for every batch and for a
    k-contiguous A or its transposed view; its chunks are multiples of the
    K step, cover [0, K) once, none empty; the workspace exists iff S > 1
    and holds S partials of the batch's whole output."""
    S, chunk = L._split_plan(m, K)
    assert (S, chunk) == _plan.split_k(-(-m // _plan.BM), K)
    assert chunk % _plan.BK == 0 and (S - 1) * chunk < K <= S * chunk
    seen = set()
    for batch in (1, 3, 24):
        for layout in ("rows", "view"):
            a = (torch.empty((batch, m, K)) if layout == "rows"
                 else torch.empty((batch, K, m)).transpose(1, 2))
            b = torch.empty((batch, K, 64))
            before = dict(L.cuda_matmul.routes)
            out = L.cuda_matmul(a, b)
            call = recording_lib[-1]
            assert call["route"] == L.ROUTES.index("split")
            assert out.shape == (batch, m, 64)
            seen.add((call["splits"], call["chunk"]))
            assert (call["ws"] is None) == (S == 1)
            assert L.cuda_matmul.routes["split"] == before["split"] + 1
    assert seen == {(S, chunk)}
    assert _plan.workspace_floats(S, 5 * 7) == (0 if S == 1 else S * 36)


def test_cuda_matmul_counts_calls_and_routes(recording_lib):
    """``launches`` counts calls; ``routes`` counts each route's calls (k = 0
    too: the general kernel writes its zero output), and an empty output
    launches nothing."""
    before = L.cuda_matmul.launches, dict(L.cuda_matmul.routes)
    for name, make, route in ROUTE_CASES:
        L.cuda_matmul(*make())
    assert L.cuda_matmul.launches == before[0] + len(ROUTE_CASES)
    for route in L.ROUTES:
        want = sum(r == route for _, _, r in ROUTE_CASES)
        assert L.cuda_matmul.routes[route] == before[1][route] + want
    L.cuda_matmul(torch.empty((0, 4)), torch.empty((4, 3)))
    assert L.cuda_matmul.launches == before[0] + len(ROUTE_CASES)
    assert [c["route"] for c in recording_lib] == [
        L.ROUTES.index(r) for _, _, r in ROUTE_CASES]
