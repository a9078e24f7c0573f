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
