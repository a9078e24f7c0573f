"""What one rank's step needs, counted on the ``meta`` device (the
dry-run, ``launch/dryrun.py``): live bytes and their peak, the bytes the
ATen operations read and write, and the FLOPs.

``MetaTracker`` is a ``TorchDispatchMode``. Every storage that an
operation returns is counted live from its first appearance until it is
released (a weak reference to the storage: its finalizer subtracts the
bytes), so the peak is the most bytes alive at once: the storages the
step was handed (``hold``, the state) and every buffer it makes, views
counted once with their storage. Works on any device; on ``meta`` it
needs no memory.

Traffic is each operation's inputs read once and its outputs written
once, views and allocations moving nothing. There is no fusion, so this
is an upper bound on the bytes a fused program would move. FLOPs come
from ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
convolutions and attention; elementwise work is not counted).
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_FREE = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
         torch.ops.aten.new_empty_strided.default}


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MetaTracker(TorchDispatchMode):
    """``live``/``peak`` bytes of the storages alive, ``read``/``written``
    bytes of every operation, ``flops`` (from the flop counter while the
    tracker is entered)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.read = self.written = 0
        self._alive: Dict[int, tuple] = {}
        self._flops = None

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._flops.__exit__(*exc)
        return out

    @property
    def flops(self) -> int:
        return int(self._flops.get_total_flops()) if self._flops else 0

    def hold(self, tree) -> int:
        """Counts the storages of ``tree``'s tensors as live (the state a
        step is handed); returns the bytes newly counted."""
        before = self.live
        for t in _tensors(tree):
            self._add(t)
        return self.live - before

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._alive:
            return
        n = st.nbytes()
        self._alive[key] = (n, weakref.ref(st, lambda _, k=key:
                                           self._free(k)))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        n, _ = self._alive.pop(key, (0, None))
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _FREE:
            self.read += sum(map(_nbytes, _tensors((args, kwargs))))
            self.written += sum(map(_nbytes, _tensors(out)))
        for t in _tensors(out):
            self._add(t)
        return out
