"""Block-wise symmetric int4 pack/unpack (port of ``repro.kernels.quant4``):
the wire format of the DiLoCoX compressor.

``quant4_pack_batched`` / ``quant4_unpack_batched`` take B rows of n
values in one call, each row padded to whole blocks on its own, as the
JAX package's ``jax.vmap`` of ``quant4_pack`` over a leaf's matrices;
``quant4_pack`` / ``quant4_unpack`` are one flat row. For CUDA tensors
they run the hand-written CUDA kernels of ``csrc/quant4.cu`` (which
replace the TPU kernels ``_pack_kernel`` and ``_unpack_kernel``), one
launch a call; for CPU tensors their plain PyTorch versions,
``ref.quant4_pack_ref`` / ``ref.quant4_unpack_ref``, row by row. There is
no other switch and no fallback: a failed build or launch raises.
``cuda_quant4_pack.launches`` / ``cuda_quant4_unpack.launches`` count
kernel launches, batched or not.

The kernels address row k of an operand at ``(k // R) * s0 + (k % R) *
s1`` elements from its first row. A tensor's rows are one stride (R = B);
a sequence of 1-D row tensors may also lie in groups, each group's rows
one stride apart and the groups another stride apart, as the chunks of a
gathered wire buffer do (``_rows``). Rows must not overlap, and each row
is contiguous.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import on_device
from repro_torch.kernels import ref

Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


def _check(name: str, t: torch.Tensor, dtype, dim: int = 1):
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous {dim}-d {dtype} tensor, "
                        f"got {t.dtype} {tuple(t.shape)}")


def _check_block(block: int):
    if block <= 0 or block % 2:
        raise ValueError(f"block must be even and positive, got {block}")


def _sizes(n: int, block: int) -> Tuple[int, int]:
    """(code bytes, scales) of one row of n values."""
    nblk = -(-n // block)
    return nblk * (block // 2), nblk


def _group(offsets, name: str):
    """(R, s0, s1) with offsets[k] == (k // R) * s0 + (k % R) * s1, R the
    longest run of equal steps from the first row; raises if the offsets
    follow no such pattern."""
    B = len(offsets)
    if B == 1:
        return 1, 0, 0
    s1 = offsets[1] - offsets[0]
    R = next((k for k in range(2, B) if offsets[k] - offsets[k - 1] != s1),
             B)
    s0 = offsets[R] - offsets[0] if R < B else R * s1
    if B % R or any(offsets[k] != (k // R) * s0 + (k % R) * s1
                    for k in range(B)):
        raise ValueError(f"{name}: the rows' starts {offsets[:8]}... follow "
                         f"no (group stride, row stride) the kernel can "
                         f"address")
    return R, s0, s1


def _rows(name: str, rows: Rows, dtype, width: int, exact: bool = False):
    """Checks B rows of at least (``exact``: exactly) ``width`` elements of
    ``dtype`` and returns (base tensor, B, R, s0, s1) in elements."""
    if isinstance(rows, torch.Tensor):
        if rows.dtype != dtype or rows.dim() != 2 or (
                rows.shape[1] > 1 and rows.stride(1) != 1):
            raise TypeError(f"{name} must be a (B, k) {dtype} tensor with "
                            f"contiguous rows, got {rows.dtype} "
                            f"{tuple(rows.shape)} strides {rows.stride()}")
        B, k = rows.shape
        R, s0, s1 = B, B * rows.stride(0), rows.stride(0)
        base = rows
    else:
        rows = list(rows)
        for t in rows:
            _check(name, t, dtype)
        if not rows or len({t.shape[0] for t in rows}) > 1 or len(
                {t.device for t in rows}) > 1:
            raise ValueError(f"{name}: no rows, or rows that differ in "
                             f"length or device")
        base, B, k = rows[0], len(rows), rows[0].shape[0]
        gaps = [t.data_ptr() - base.data_ptr() for t in rows]
        if any(g % base.element_size() for g in gaps):
            raise ValueError(f"{name}: rows are not whole elements apart")
        R, s0, s1 = _group([g // base.element_size() for g in gaps], name)
    if B > 65535:
        raise ValueError(f"{name}: {B} rows; the kernels take at most "
                         f"65,535 (the grid's y)")
    if k < width or (exact and k != width):
        raise ValueError(f"{name}: rows of {k} elements, need "
                         f"{'' if exact else 'at least '}{width}")
    G = B // R if B else 0
    if (R > 1 and s1 < k) or (G > 1 and s0 < (R - 1) * s1 + k):
        raise ValueError(f"{name}: rows overlap or are not in address order "
                         f"(row stride {s1}, group stride {s0}, {k} elements "
                         f"a row)")
    return base, B, R, s0, s1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cuda_quant4_pack_batched(x: torch.Tensor, block: int = 256):
    """x: (B, n) f32 on the card, rows at one stride -> (packed uint8 (B,
    nblk * block / 2), scales f32 (B, nblk)), each row in the layout of
    ``ref.quant4_pack_ref``. One launch."""
    from repro_torch.kernels import _build

    _check_block(block)
    n = x.shape[-1] if x.dim() == 2 else -1
    _, B, R, xs0, xs1 = _rows("x", x, torch.float32, n, exact=True)
    nbytes, nblk = _sizes(n, block)
    packed = torch.empty((B, nbytes), dtype=torch.uint8, device=x.device)
    scales = torch.empty((B, nblk), dtype=torch.float32, device=x.device)
    if B * nblk == 0:
        return packed, scales
    lib = _build.load("quant4")
    err = lib.quant4_pack_f32(x.data_ptr(), xs0, xs1, packed.data_ptr(),
                              B * nbytes, nbytes, scales.data_ptr(),
                              B * nblk, nblk, B, R, n, block, _stream(x))
    if err != 0:
        raise RuntimeError(f"quant4 pack kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    cuda_quant4_pack.launches += 1
    return packed, scales


def cuda_quant4_pack(x: torch.Tensor, block: int = 256):
    """x: flat (n,) f32 on the card -> (packed uint8, scales f32), the
    layout of ``ref.quant4_pack_ref``: the batched kernel at B = 1."""
    _check("x", x, torch.float32)
    packed, scales = cuda_quant4_pack_batched(x[None], block)
    return packed[0], scales[0]


cuda_quant4_pack.launches = 0


def cuda_quant4_unpack_batched(packed: Rows, scales: Rows, n: int,
                               block: int = 256,
                               out: torch.Tensor = None) -> torch.Tensor:
    """B rows of codes and of scales on the card (each a (B, k) tensor or
    a sequence of 1-D rows, grouped alike) -> (B, n) f32 values, written
    into ``out`` (rows at one stride) if given. One launch."""
    from repro_torch.kernels import _build

    _check_block(block)
    nbytes, nblk = _sizes(n, block)
    pbase, B, R, ps0, ps1 = _rows("packed", packed, torch.uint8, nbytes)
    sbase, Bs, Rs, ss0, ss1 = _rows("scales", scales, torch.float32, nblk)
    dev = pbase.device
    if out is None:
        out = torch.empty((B, n), dtype=torch.float32, device=dev)
    _, Bo, _, _, os1 = _rows("out", out, torch.float32, n, exact=True)
    if Bo != B or Bs != B:
        raise ValueError(f"packed, scales and out hold {B}, {Bs} and {Bo} "
                         f"rows")
    if Rs != R and B > 1:
        raise ValueError(f"packed ({R} rows a group) and scales ({Rs}) are "
                         f"grouped differently")
    if B * nblk == 0:
        return out
    if {pbase.device, sbase.device, out.device} != {dev}:
        raise ValueError(f"packed, scales and out lie on {pbase.device}, "
                         f"{sbase.device} and {out.device}")
    lib = _build.load("quant4")
    err = lib.quant4_unpack_f32(pbase.data_ptr(), ps0, ps1, sbase.data_ptr(),
                                ss0, ss1, out.data_ptr(), R * os1, os1, B, R,
                                n, block, _stream(out))
    if err != 0:
        raise RuntimeError(f"quant4 unpack kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    cuda_quant4_unpack.launches += 1
    return out


def cuda_quant4_unpack(packed: torch.Tensor, scales: torch.Tensor, n: int,
                       block: int = 256) -> torch.Tensor:
    """One flat row: the batched kernel at B = 1."""
    _check("packed", packed, torch.uint8)
    _check("scales", scales, torch.float32)
    return cuda_quant4_unpack_batched(packed[None], scales[None], n,
                                      block)[0]


cuda_quant4_unpack.launches = 0


def _pack_plain(x: torch.Tensor, block: int = 256):
    packed, scales, _ = ref.quant4_pack_ref(x, block)
    return packed, scales


def pack_batched_plain(x: torch.Tensor, block: int = 256):
    """The plain version of ``cuda_quant4_pack_batched``, row by row."""
    nbytes, nblk = _sizes(x.shape[1], block)
    packed = torch.empty((x.shape[0], nbytes), dtype=torch.uint8,
                         device=x.device)
    scales = torch.empty((x.shape[0], nblk), dtype=torch.float32,
                         device=x.device)
    for row, p, s in zip(x, packed, scales):
        p[:], s[:] = _pack_plain(row, block)
    return packed, scales


def unpack_batched_plain(packed: Rows, scales: Rows, n: int,
                         block: int = 256,
                         out: torch.Tensor = None) -> torch.Tensor:
    """The plain version of ``cuda_quant4_unpack_batched``, row by row."""
    nbytes, nblk = _sizes(n, block)
    rows = [ref.quant4_unpack_ref(p[:nbytes], s[:nblk], n, block)
            for p, s in zip(packed, scales)]
    if out is None:
        return torch.stack(rows)
    for o, v in zip(out, rows):
        o.copy_(v)
    return out


def _first(rows: Rows) -> torch.Tensor:
    return rows if isinstance(rows, torch.Tensor) else rows[0]


def quant4_pack(x: torch.Tensor, block: int = 256):
    """flat (n,) f32 -> (packed uint8 (ceil(n/block)*block/2,), scales f32
    (ceil(n/block),)): the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    return on_device(x, cuda_quant4_pack, _pack_plain, x, block)


def quant4_unpack(packed: torch.Tensor, scales: torch.Tensor, n: int,
                  block: int = 256) -> torch.Tensor:
    return on_device(packed, cuda_quant4_unpack, ref.quant4_unpack_ref,
                     packed, scales, n, block)


def quant4_pack_batched(x: torch.Tensor, block: int = 256):
    """(B, n) f32 -> (packed uint8 (B, ceil(n/block)*block/2), scales f32
    (B, ceil(n/block))): row b is ``quant4_pack(x[b])``."""
    return on_device(x, cuda_quant4_pack_batched, pack_batched_plain, x,
                     block)


def quant4_unpack_batched(packed: Rows, scales: Rows, n: int,
                          block: int = 256,
                          out: torch.Tensor = None) -> torch.Tensor:
    """B rows of codes and scales -> (B, n) f32 (into ``out`` if given):
    row b is ``quant4_unpack(packed[b], scales[b], n)``."""
    return on_device(_first(packed), cuda_quant4_unpack_batched,
                     unpack_batched_plain, packed, scales, n, block, out)
