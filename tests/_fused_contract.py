"""The fused compressor's contract, as ``tests/test_kernels.py``'s
``_assert_fused_contract`` states it for the Pallas pipeline, checked on
the port's outputs with the port's own plain oracles (no jax, so the GPU
tests use it too):

1. packed bytes equal ``quant4_pack_ref`` of the kernel's own factors,
   scales within rtol 1e-6;
2. the reconstruction within 16 eps (|Pq| |Qq|^T) of the payload's oracle
   Pq Qq^T (the only freedom is the order of the sums);
3. the EF residual e' = (delta + e) - recon within that bound;
4. the decompress dual reproduces the reconstruction exactly;
5. adaptive rank: masked columns of P, Q and q_new exactly 0.
"""
import importlib.util
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import ref

ULP_K = 16


def load_chip_smoke():
    """``chip_smoke.py`` at the repo root as a module, for its gates and
    shapes (it imports torch only; its ``main`` needs a GPU)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def assert_fused_contract(m, n, r, rt, d, e, hat, e_new, q_new, pay,
                          decompress):
    cpu = lambda t: torch.as_tensor(_np(t))
    pP, sP, _ = ref.quant4_pack_ref(cpu(pay.p_factor).reshape(-1))
    pQ, sQ, _ = ref.quant4_pack_ref(cpu(pay.q_factor).reshape(-1))
    np.testing.assert_array_equal(_np(pay.packed_p), pP.numpy())
    np.testing.assert_array_equal(_np(pay.packed_q), pQ.numpy())
    np.testing.assert_allclose(_np(pay.scales_p), sP.numpy(), rtol=1e-6)
    np.testing.assert_allclose(_np(pay.scales_q), sQ.numpy(), rtol=1e-6)

    Pq = ref.quant4_unpack_ref(cpu(pay.packed_p), cpu(pay.scales_p),
                               m * r).reshape(m, r).numpy()
    Qq = ref.quant4_unpack_ref(cpu(pay.packed_q), cpu(pay.scales_q),
                               n * r).reshape(n, r).numpy()
    oracle = Pq @ Qq.T
    bound = ULP_K * np.finfo(np.float32).eps * (np.abs(Pq) @ np.abs(Qq).T)
    gap = np.abs(_np(hat).astype(np.float32) - oracle)
    assert np.all(gap <= bound + 1e-30), \
        f"recon gap {gap.max()} exceeds ulp bound {bound.max()}"

    if e_new is not None:
        M = _np(d).astype(np.float32)
        if e is not None:
            M = M + _np(e).astype(np.float32)
        assert e_new.dtype == torch.float32 and tuple(e_new.shape) == (m, n)
        ef_gap = np.abs(_np(e_new) - (M - oracle))
        assert np.all(ef_gap <= bound + 2e-6 * np.abs(M) + 1e-6)

    dec = decompress(pay.packed_p, pay.scales_p, pay.packed_q, pay.scales_q,
                     m, n, r)
    np.testing.assert_array_equal(_np(dec), _np(hat))

    if rt is not None:
        assert not _np(pay.p_factor)[:, rt:].any()
        assert not _np(pay.q_factor)[:, rt:].any()
        assert not _np(q_new)[:, rt:].any()


def one_int4_step(pay):
    """The chain-vs-chain tolerance of ``test_fused_vs_ref_chain``: scales
    may differ by an ulp between two chains, which near a rounding tie can
    flip one code, so allow one int4 step per factor."""
    sP, sQ = float(_np(pay.scales_p).max()), float(_np(pay.scales_q).max())
    Pm = float(np.abs(_np(pay.p_factor)).max())
    Qm = float(np.abs(_np(pay.q_factor)).max())
    return sP * Qm + sQ * Pm


def fused_inputs(m, n, r, seed=0):
    """(delta, e, q_warm) f32 numpy, the scales of test_kernels.py's case."""
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((m, n)) * 0.3).astype(np.float32)
    e = (rng.standard_normal((m, n)) * 0.05).astype(np.float32)
    q = rng.standard_normal((n, r)).astype(np.float32)
    return d, e, q


def quant_inputs(n, seed=0):
    """Flat f32 input with all-zero blocks and exact .5 ties: a block of
    k + 0.5 multiples of its own scale, and a block of repeated values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3.0).astype(np.float32)
    if n >= 768:
        x[256:512] = 0.0                                   # all-zero block
        s = np.float32(np.float32(21.0) * np.float32(1.0 / 7.0))
        k = rng.integers(-7, 6, 256).astype(np.float32)
        x[512:768] = ((k + np.float32(0.5)) * s).astype(np.float32)
        x[512] = np.float32(21.0)                          # amax of the block
    if n >= 1024:
        x[768:1024] = np.float32(2.5)                      # ties at scale 1
        x[768] = np.float32(7.0)
    return x
