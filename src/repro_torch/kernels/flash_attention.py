"""Causal GQA flash attention with a gradient (port of
``repro.kernels.flash_attention``).

``flash_attention(q, k, v, causal=True)`` applies ``FlashAttention``, a
``torch.autograd.Function``: its forward saves ``q, k, v, o, lse`` and its
backward returns ``dq, dk, dv``. For CUDA tensors they launch the
hand-written kernels of ``csrc/flash_attention.cu``, whose products run on
the tensor cores as 3xTF32 (three TF32 products per f32 product, which
keep the f32 gates): the forward replaces the TPU kernel
``_flash_kernel``, and the backward (D = rowsum(dO * O), dK/dV, dQ, no
atomics) is new, since the TPU kernel has none. Where the forward's
k-range plan, the dK/dV plan or the dQ plan (``_plan.flash_fwd_plan``,
``_plan.flash_dkdv_plan``, ``_plan.flash_dq_plan``, functions of the
shape) splits the work into partials, the wrapper allocates them and the
kernels merge or add them in a fixed order. For CPU tensors they run the plain
versions ``ref.flash_attention_fwd_ref`` / ``ref.flash_attention_bwd_ref``.
There is no other switch and no fallback: a failed build or launch
raises.
``cuda_flash_attention_fwd.launches`` and
``cuda_flash_attention_bwd.launches`` count the wrappers' launches.

Layouts are the JAX package's: q (B,Sq,H,d), k and v (B,Sk,KV,d), query
head h reading KV head h // (H // KV); the causal mask is top-left aligned
(key j is seen by query i iff j <= i). The kernels take float32 or
bfloat16 (q, k and v of one type) with head dims 32, 64, 128 and 256, any
Sq and Sk (ragged tails are masked), and q, k, v through their strides
(last dim contiguous); a view whose start or strides are not multiples of
16 bytes, which the kernels' 16-byte copies cannot read, is copied first
(the same bits: the kernels compute the same sums for every layout).

bfloat16 launches the kernels' bf16 versions, which read bf16 from device
memory and write o, dq, dk and dv in bf16 (lse stays f32): one bf16
tensor-core product per product, f32 accumulation, P and dS rounded to
bf16 where they enter a product. The bf16 kernels are Hopper's own: the
forward (``flash_fwd_wgmma_kernel``, the replacement of ``_flash_kernel``
in bf16) and the backward's dK/dV and dQ (``flash_bwd_dkdv_wgmma_kernel``,
``flash_bwd_dq_wgmma_kernel``) are ``wgmma`` products fed by TMA tile
loads through tensor maps of q, k, v (and dO) built per call from their
strides, on the f32 kernels' grids, range plans, partials and sums, with
tiles of ``_plan.flash_tile(d, 2)``, ``flash_q_tile(d, 2)`` and
``flash_dq_tile(d, 2)`` rows. Both passes are bound by HBM bytes at the
training shape (0.010 and 0.020 ms on an H100) and by the tensor cores'
operations at one qwen1.5-107b layer (0.278 and 0.695 ms); one warpgroup
a block (two in the backward at d = 256), several blocks an SM, and a
ring of streamed stages in flight let the products of one block run while
another does its softmax. The plain versions compute in f32 and return
the inputs' type, as ``repro.kernels.ref`` does.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_device
from repro_torch.kernels import _plan, ref

HEAD_DIMS = (32, 64, 128, 256)       # the kernels' template instantiations
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,Sq,H,d) and k, v (B,Sk,KV,d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, d = q.shape
    _, Sk, KV, dk = k.shape
    if k.shape[0] != B or dk != d or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}: "
                         f"batch and head dim must match and KV divide H")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or t.stride(-1) != 1:
            raise TypeError(f"{name} must be {q.dtype} on {q.device} with a "
                            f"contiguous last dim, got {t.dtype} on "
                            f"{t.device}, strides {t.stride()}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} outside the kernels' envelope "
                         f"{HEAD_DIMS}")
    if Sq == 0 or Sk == 0 or B == 0 or B * H > 65535:
        raise ValueError(f"shape q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"outside the kernels' envelope")
    return B, Sq, H, d, Sk, KV


def _aligned(t):
    """``t`` itself if the kernels' 16-byte copies can read it, else a
    contiguous copy."""
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(s % per16 == 0
                                      for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(q, k, v):
    return [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]


def _lib_call(fn_name, *args):
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _suffix(q):
    return "f32" if q.dtype == torch.float32 else "bf16"


def cuda_flash_attention_fwd(q, k, v, causal: bool = True):
    """(o (B,Sq,H,d) in q's dtype, lse (B,H,Sq) f32) from the forward
    kernel; where its plan cuts the k tiles into ranges, their partials go
    to a workspace and a merge kernel writes o and lse."""
    B, Sq, H, d, Sk, KV = _check(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    es = q.element_size()
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), **f32)
    split, chunk = _plan.flash_fwd_plan(B, H, Sq, Sk, d, es)
    ws = torch.empty(_plan.flash_fwd_ws_floats(B, H, Sq, Sk, d, es), **f32)
    _lib_call(f"flash_attention_fwd_{_suffix(q)}", q.data_ptr(),
              k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H,
              KV, Sq, Sk, d, *_strides(q, k, v), int(causal), split, chunk,
              ws.data_ptr(), _stream(q))
    cuda_flash_attention_fwd.launches += 1
    return o, lse


cuda_flash_attention_fwd.launches = 0


def cuda_flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv) in q's dtype from the backward kernels (D = rowsum(dO *
    O), then dK and dV, their partials summed where the plan splits, then
    dQ); ``o`` and ``do`` contiguous (B,Sq,H,d) in q's dtype, ``lse``
    (B,H,Sq) f32, as the forward returns them."""
    B, Sq, H, d, Sk, KV = _check(q, k, v)
    for name, t, shape, dt in (("o", o, q.shape, q.dtype),
                               ("do", do, q.shape, q.dtype),
                               ("lse", lse, (B, H, Sq), torch.float32)):
        if t.dtype != dt or not t.is_contiguous() \
                or tuple(t.shape) != tuple(shape) or t.device != q.device:
            raise TypeError(f"{name} must be a contiguous {dt} "
                            f"{tuple(shape)} tensor on {q.device}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    es = q.element_size()
    f32 = dict(dtype=torch.float32, device=q.device)
    out = dict(dtype=q.dtype, device=q.device)
    D = torch.empty((B, H, Sq), **f32)
    dq = torch.empty((B, Sq, H, d), **out)
    dk = torch.empty((B, Sk, KV, d), **out)
    dv = torch.empty((B, Sk, KV, d), **out)
    split, chunk, _ = _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d, es)
    dq_split, dq_chunk = _plan.flash_dq_plan(B, H, Sq, Sk, d, es)
    ws = torch.empty(_plan.flash_parts_floats(B, H, KV, Sq, Sk, d, es),
                     **f32)
    _lib_call(f"flash_attention_bwd_{_suffix(q)}", q.data_ptr(),
              k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
              lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), B, H, KV, Sq, Sk, d, *_strides(q, k, v),
              int(causal), split, chunk, dq_split, dq_chunk, ws.data_ptr(),
              _stream(q))
    cuda_flash_attention_bwd.launches += 1
    return dq, dk, dv


cuda_flash_attention_bwd.launches = 0


def cuda_flash_occupancy(d: int, dtype=torch.float32):
    """{"fwd" | "dkdv" | "dq": (threads, shared memory bytes, blocks an SM
    holds)} of the kernels at head dim ``d`` over ``dtype``, as the
    library launches them and the CUDA runtime reports them (``_plan``
    models the same numbers for the plans). Launches nothing."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    fn = (lib.flash_attention_occupancy if dtype == torch.float32
          else lib.flash_attention_occupancy_bf16)
    out = {}
    for kind, name in enumerate(("fwd", "dkdv", "dq")):
        vals = [ctypes.c_int() for _ in range(3)]
        err = fn(d, kind, *map(ctypes.byref, vals))
        if err != 0:
            raise RuntimeError(f"flash_attention_occupancy({d}, {name}) "
                               f"failed: {_build.cuda_error_string(lib, err)}")
        out[name] = tuple(x.value for x in vals)
    return out


def flash_attention_fwd(q, k, v, causal: bool = True):
    """(o, lse): the forward kernel for CUDA tensors, its plain version
    for CPU tensors."""
    return on_device(q, cuda_flash_attention_fwd, ref.flash_attention_fwd_ref,
                     q, k, v, causal)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv): the backward kernels for CUDA tensors, their plain
    version for CPU tensors."""
    return on_device(q, cuda_flash_attention_bwd, ref.flash_attention_bwd_ref,
                     q, k, v, o, lse, do, causal)


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the kernels above."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,H,d); k, v: (B,Sk,KV,d). Returns (B,Sq,H,d)."""
    return FlashAttention.apply(q, k, v, causal)
