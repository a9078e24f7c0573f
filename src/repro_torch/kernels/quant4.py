"""Block-wise symmetric int4 pack/unpack (port of ``repro.kernels.quant4``):
the wire format of the DiLoCoX compressor.

``quant4_pack`` / ``quant4_unpack`` run the hand-written CUDA kernels of
``csrc/quant4.cu`` (which replace the TPU kernels ``_pack_kernel`` and
``_unpack_kernel``) for CUDA tensors, and their plain PyTorch versions,
``ref.quant4_pack_ref`` / ``ref.quant4_unpack_ref``, for CPU tensors.
There is no other switch and no fallback: a failed build or launch
raises. ``cuda_quant4_pack.launches`` / ``cuda_quant4_unpack.launches``
count kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_device
from repro_torch.kernels import ref


def _check(name: str, t: torch.Tensor, dtype, dim: int = 1):
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous {dim}-d {dtype} tensor, "
                        f"got {t.dtype} {tuple(t.shape)}")


def _check_block(block: int):
    if block <= 0 or block % 2:
        raise ValueError(f"block must be even and positive, got {block}")


def cuda_quant4_pack(x: torch.Tensor, block: int = 256):
    """x: flat (n,) f32 on the card -> (packed uint8, scales f32), the
    layout of ``ref.quant4_pack_ref``."""
    from repro_torch.kernels import _build

    _check("x", x, torch.float32)
    _check_block(block)
    n = x.shape[0]
    nblk = -(-n // block)
    packed = torch.empty(nblk * (block // 2), dtype=torch.uint8,
                         device=x.device)
    scales = torch.empty(nblk, dtype=torch.float32, device=x.device)
    lib = _build.load("quant4")
    err = lib.quant4_pack_f32(x.data_ptr(), n, block, packed.data_ptr(),
                              scales.data_ptr(),
                              torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant4 pack kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    cuda_quant4_pack.launches += 1
    return packed, scales


cuda_quant4_pack.launches = 0


def cuda_quant4_unpack(packed: torch.Tensor, scales: torch.Tensor, n: int,
                       block: int = 256) -> torch.Tensor:
    from repro_torch.kernels import _build

    _check("packed", packed, torch.uint8)
    _check("scales", scales, torch.float32)
    _check_block(block)
    nblk = -(-n // block)
    if packed.shape[0] < nblk * (block // 2) or scales.shape[0] < nblk \
            or packed.device != scales.device:
        raise ValueError(f"payload ({packed.shape[0]} B, {scales.shape[0]} "
                         f"scales on {packed.device}/{scales.device}) too "
                         f"short for n={n}, block={block}")
    out = torch.empty(n, dtype=torch.float32, device=packed.device)
    lib = _build.load("quant4")
    err = lib.quant4_unpack_f32(
        packed.data_ptr(), scales.data_ptr(), n, block, out.data_ptr(),
        torch.cuda.current_stream(packed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant4 unpack kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    cuda_quant4_unpack.launches += 1
    return out


cuda_quant4_unpack.launches = 0


def _pack_plain(x: torch.Tensor, block: int = 256):
    packed, scales, _ = ref.quant4_pack_ref(x, block)
    return packed, scales


def quant4_pack(x: torch.Tensor, block: int = 256):
    """flat (n,) f32 -> (packed uint8 (ceil(n/block)*block/2,), scales f32
    (ceil(n/block),)): the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    return on_device(x, cuda_quant4_pack, _pack_plain, x, block)


def quant4_unpack(packed: torch.Tensor, scales: torch.Tensor, n: int,
                  block: int = 256) -> torch.Tensor:
    return on_device(packed, cuda_quant4_unpack, ref.quant4_unpack_ref,
                     packed, scales, n, block)
