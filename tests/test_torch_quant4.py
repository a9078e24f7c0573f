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

from _fused_contract import quant_inputs
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
