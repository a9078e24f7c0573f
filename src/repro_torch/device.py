"""Device resolution shared by the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. With no GPU
and no such request they raise: nothing silently runs on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' (--device cpu) to "
                           "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(t, cuda_fn, plain_fn, *args, **kw):
    """The kernel wrappers' one dispatch rule: ``cuda_fn`` (which launches
    the hand-written kernel or raises) when ``t`` lies on a GPU,
    ``plain_fn`` (the plain PyTorch version) when it lies on the CPU or on
    the ``meta`` device, where it computes only shapes (the dry-run,
    ``launch/dryrun.py``)."""
    if t.device.type == "cuda":
        return cuda_fn(*args, **kw)
    if t.device.type in ("cpu", "meta"):
        return plain_fn(*args, **kw)
    raise ValueError(f"{cuda_fn.__name__}: unsupported device {t.device}")
