"""The product gate ``chip_smoke.py`` holds the compressor's GEMM kernels
to (``_gate_product``), checked on the CPU against an emulation of the
kernels' arithmetic: a sequential float32 sum over K in index order (the
CUDA kernels' order) must pass it with a wide margin, and the same sum
missing one 32-wide K tile (the kernels' K step) must fail it, at the
reduction lengths of the training configuration's leaves."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.compression import _orthonormalize

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
