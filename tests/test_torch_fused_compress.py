"""Port parity: the fused outer-step compressor's plain pipeline
(``repro_torch.kernels.fused_compress``, what the CUDA kernels are held
to) against the JAX package's ``fused_compress_ef`` (Pallas, interpret
mode, jitted, as ``tests/test_kernels.py`` runs it) and its unfused
``outer_step_ref`` chain, on the same (delta, e, Q_warm, r_t).

Gates: the full contract of ``_assert_fused_contract`` on the port's
outputs (``tests/_fused_contract.py``); chain-vs-chain within one int4
step per factor (the two packages' Cholesky-QRs differ by ulps, which can
flip a code at a rounding tie); q_new within rtol/atol 1e-5; and the
port's decompress of JAX's own payload within the reordering ulp bound of
JAX's reconstruction (the wire format is shared)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fused_contract import (ULP_K, assert_fused_contract, fused_inputs,
                             load_chip_smoke, one_int4_step)
from repro.kernels import ref as jref
from repro.kernels.fused_compress import fused_compress_ef as j_fused
from repro_torch.kernels import _plan
from repro_torch.kernels import fused_compress as fc
from repro_torch.kernels import ref

CASES = [(64, 48, 8, None),       # the JAX smoke shape
         (257, 129, 8, 5),        # padding and adaptive rank
         (33, 500, 12, 7)]        # wide, blocks straddle rows


def _jax_run(fn, d, e, q, rt):
    rs = None if rt is None else jnp.int32(rt)
    return jax.jit(lambda a, b, c: fn(a, b, c, rs))(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(q))


@pytest.mark.parametrize("m,n,r,rt", CASES)
def test_plain_fused_compress_contract_and_chain(m, n, r, rt):
    d, e, q = fused_inputs(m, n, r, seed=m)
    hat, e_new, q_new, pay = fc.fused_compress_ef(
        torch.from_numpy(d), torch.from_numpy(e), torch.from_numpy(q), rt)
    assert_fused_contract(m, n, r, rt, d, e, hat, e_new, q_new, pay,
                          fc.fused_decompress)

    hat_f, e_f, qn_f, pay_f = _jax_run(j_fused, d, e, q, rt)
    hat_r, _, qn_r, pay_r = _jax_run(jref.outer_step_ref, d, e, q, rt)
    atol = one_int4_step(pay_r)
    np.testing.assert_allclose(hat.numpy(), np.asarray(hat_r), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(hat.numpy(), np.asarray(hat_f), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(e_new.numpy(), np.asarray(e_f), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(q_new.numpy(), np.asarray(qn_f), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(q_new.numpy(), np.asarray(qn_r), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("m,n,r,rt", CASES)
def test_port_decompresses_jax_payload(m, n, r, rt):
    d, e, q = fused_inputs(m, n, r, seed=m + 1)
    hat_f, _, _, pay_f = _jax_run(j_fused, d, e, q, rt)
    t = lambda a: torch.from_numpy(np.array(a))
    got = fc.fused_decompress(t(pay_f.packed_p), t(pay_f.scales_p),
                              t(pay_f.packed_q), t(pay_f.scales_q), m, n, r)
    Pq = ref.quant4_unpack_ref(t(pay_f.packed_p), t(pay_f.scales_p),
                               m * r).reshape(m, r).numpy()
    Qq = ref.quant4_unpack_ref(t(pay_f.packed_q), t(pay_f.scales_q),
                               n * r).reshape(n, r).numpy()
    bound = 2 * ULP_K * np.finfo(np.float32).eps * (np.abs(Pq) @ np.abs(Qq).T)
    assert np.all(np.abs(got.numpy() - np.asarray(hat_f)) <= bound + 1e-30)


def test_plain_matches_outer_step_ref_of_the_port():
    """Within the port, fused (plain) and the unfused chain are the same
    arithmetic: bitwise equal on the CPU."""
    d, e, q = (torch.from_numpy(a) for a in fused_inputs(128, 96, 16, 7))
    a = fc.fused_compress_ef(d, e, q, 10)
    b = ref.outer_step_ref(d, e, q, 10)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    for x, y in zip(a[3], b[3]):
        assert torch.equal(x, y)


def test_hoisted_ef_matches_fused():
    """The driver hoists the EF add (delta + e once, no e operand); the
    kernels' fused ``with_e`` form gives the same products, codes and
    residual on the same inputs."""
    from repro_torch.core.compression import _orthonormalize

    m, n, r = 96, 80, 8
    d, e, q = (torch.from_numpy(a) for a in fused_inputs(m, n, r, 9))
    de = d + e
    P = fc.project(d, e, q)
    assert torch.equal(P, fc.project(de, None, q))
    P = _orthonormalize(P)
    fused = fc.project_t_pack(d, e, P)
    for x, y in zip(fused, fc.project_t_pack(de, None, P)):
        assert torch.equal(x, y)
    pp, sp, _ = ref.quant4_pack_ref(P.reshape(-1))
    hat, e_new = fc.reconstruct(pp, sp, fused[1], fused[2], d, e, m, n, r)
    assert all(map(torch.equal, (hat, e_new), fc.reconstruct(
        pp, sp, fused[1], fused[2], de, None, m, n, r)))
    drv = fc.fused_compress_ef(d, e, q, None)
    assert torch.equal(drv[0], hat) and torch.equal(drv[1], e_new)
    assert torch.equal(drv[2], fused[0])


def test_zero_input_keeps_warm_start():
    """Round 0 in delay mode compresses an all-zero delta: the warm start
    must survive and the reconstruction is exactly 0."""
    q = torch.from_numpy(fused_inputs(80, 96, 16)[2])
    hat, e_new, q_new, _ = fc.fused_compress_ef(torch.zeros(80, 96), None, q)
    assert not hat.any() and not e_new.any()
    assert torch.equal(q_new, q)


def test_row_tile_packs_whole_blocks():
    for r in range(1, 65):
        t = fc._row_tile(r, 256)
        assert t % 64 == 0 and (t * r) % 256 == 0 and t * r <= fc.SMEM_FLOATS


# the low-rank leaves of chip_smoke.train_config() (opt-1.3b, 12 layers)
LEAF_SHAPES = [(2048, 50272), (24576, 2048), (24576, 8192), (50272, 2048),
               (98304, 2048)]


def test_leaf_shapes_are_the_training_configs():
    cs = load_chip_smoke()
    assert sorted(cs.leaf_shapes(cs.train_config())[0]) == LEAF_SHAPES


@pytest.mark.parametrize("tiles,K", sorted(
    {fc._proj_plan(m, n)[0:1] + (n,) for m, n in LEAF_SHAPES}
    | {fc._proj_t_plan(m, n)[0:1] + (m,) for m, n in LEAF_SHAPES}
    | {(16, 5000), (1, 5000), (16, 31), (393, 31), (1, 20004), (2, 257)}))
def test_split_k_plan_covers_k_and_fills_the_card(tiles, K):
    """The projections' split-K plan: chunks of whole K steps that cover
    [0, K) once with none empty, no chunk but the last under MIN_CHUNK
    terms, and two waves of blocks on the card wherever chunks of
    MIN_CHUNK terms allow them (the pack's row tile, whole quantization
    blocks at every rank: ``test_row_tile_packs_whole_blocks``)."""
    S, chunk = _plan.split_k(tiles, K)
    assert chunk % _plan.BK == 0 and S >= 1
    assert (S - 1) * chunk < K <= S * chunk
    assert S == 1 or chunk >= _plan.MIN_CHUNK
    if tiles * -(-K // _plan.MIN_CHUNK) >= 2 * _plan.SMS:
        assert tiles * S >= 2 * _plan.SMS
    assert (S, chunk) == _plan.split_k(tiles, K)
