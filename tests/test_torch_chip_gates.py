"""The product gate ``chip_smoke.py`` holds the compressor's GEMM kernels
to (``_gate_product``), checked on the CPU against emulations of the
kernels' summation orders, at the reduction lengths of the training
configuration's leaves:

- a sequential float32 sum over K in index order (``lowrank_mm``'s
  order) passes it with a wide margin, and the same sum missing one
  32-wide K tile fails it;
- the split-K order of the two projections (``fused_compress.cu``):
  a sequential sum over each chunk of the plan (``_plan.split_k``), then the
  chunk partials added in split order, passes it below 0.1 of its
  tolerance, and the same sum missing one chunk partial, or one 16-wide
  K step inside a chunk, fails it;
- the same split order at ``lowrank_mm``'s plans for the mesh outer
  step's P = M Q products (m = 2,048 rows, K = 50,272, 8,192 and 2,048).
"""
import numpy as np
import pytest
import torch

from _fused_contract import load_chip_smoke as _chip_smoke
from repro_torch.core.compression import _orthonormalize
from repro_torch.kernels import _plan
from repro_torch.kernels import lowrank_mm as lm


def _sequential(a, b):
    """a @ b summed in index order in float32 (numpy's cumsum is a
    sequential float32 sum, unlike torch's, which accumulates in double)."""
    t = a.numpy()[:, :, None] * b.numpy()[None]
    return torch.from_numpy(np.cumsum(t, axis=1, dtype=np.float32)[:, -1])


def _operands(kind, K, seed):
    """(a, b) with a's rows as the kernel sees them: kernel 3's rows of
    delta against the warm start (independent terms); kernel 4's columns
    of delta against P = orth(delta @ Q) (terms correlated with the sum)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "project":
        a = torch.randn((4, K), generator=g) * 0.3
        return a, torch.randn((K, 64), generator=g)
    d = torch.randn((K, 256), generator=g) * 0.3
    P = _orthonormalize(d @ torch.randn((256, 64), generator=g))
    return d[:, :4].T.contiguous(), P.contiguous()


@pytest.mark.parametrize("kind,K", [("project", 2048), ("project", 50272),
                                    ("project_t_pack", 24576),
                                    ("project_t_pack", 98304)])
def test_product_gate_passes_kernel_order_and_catches_a_dropped_tile(kind,
                                                                     K):
    cs = _chip_smoke()
    a, b = _operands(kind, K, seed=K)
    want = a @ b
    _, ratio = cs._gate_product(kind, _sequential(a, b), want, a, b)
    assert ratio < 0.1
    k0 = 32 * (K // 64)
    dropped = _sequential(a, b) - a[:, k0:k0 + 32] @ b[k0:k0 + 32]
    with pytest.raises(SystemExit, match="off its plain version"):
        cs._gate_product(kind, dropped, want, a, b)


def _split_order(a, b, S, chunk):
    """a @ b in the projections' split-K order: each chunk summed
    sequentially in float32, then the S partials added left to right in
    float32. Returns the sum and the partials."""
    parts = [_sequential(a[:, s * chunk:(s + 1) * chunk],
                         b[s * chunk:(s + 1) * chunk]).numpy()
             for s in range(S)]
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return torch.from_numpy(acc), parts


@pytest.mark.parametrize("kind,K,tiles", [("project", 50272, 16),
                                          ("project_t_pack", 24576, 16),
                                          ("project_t_pack", 98304, 16)])
def test_product_gate_passes_split_k_order_and_catches_a_lost_chunk(kind, K,
                                                                    tiles):
    cs = _chip_smoke()
    a, b = _operands(kind, K, seed=K + 1)
    S, chunk = _plan.split_k(tiles, K)
    assert S > 1
    want = a @ b
    got, parts = _split_order(a, b, S, chunk)
    _, ratio = cs._gate_product(kind, got, want, a, b)
    assert ratio < 0.1
    lost = S // 2
    no_chunk = sum(parts[:lost] + parts[lost + 1:], np.zeros_like(parts[0]))
    with pytest.raises(SystemExit, match="off its plain version"):
        cs._gate_product(kind, torch.from_numpy(no_chunk), want, a, b)
    k0 = lost * chunk + _plan.BK * (chunk // _plan.BK // 2)
    no_step = got - a[:, k0:k0 + _plan.BK] @ b[k0:k0 + _plan.BK]
    with pytest.raises(SystemExit, match="off its plain version"):
        cs._gate_product(kind, no_step, want, a, b)


@pytest.mark.parametrize("K", [50272, 8192, 2048])
def test_product_gate_passes_lowrank_split_order_and_catches_a_lost_chunk(K):
    """lowrank_mm's split route at the plan of a 2,048-row output (the
    head's and the layers' P = M Q): the split order passes the gate below
    0.1 of its tolerance; a lost chunk partial or K step fails it."""
    cs = _chip_smoke()
    a, b = _operands("project", K, seed=K + 2)
    S, chunk = lm._split_plan(2048, K)
    assert S > 1
    want = a @ b
    got, parts = _split_order(a, b, S, chunk)
    _, ratio = cs._gate_product("lowrank_mm", got, want, a, b)
    assert ratio < 0.1
    lost = S - 1
    no_chunk = sum(parts[:lost], np.zeros_like(parts[0]))
    with pytest.raises(SystemExit, match="off its plain version"):
        cs._gate_product("lowrank_mm", torch.from_numpy(no_chunk), want, a, b)
    k0 = _plan.BK * (chunk // _plan.BK // 2)
    no_step = got - a[:, k0:k0 + _plan.BK] @ b[k0:k0 + _plan.BK]
    with pytest.raises(SystemExit, match="off its plain version"):
        cs._gate_product("lowrank_mm", no_step, want, a, b)
