"""npz checkpointing and the weight and state bridge (port of
``repro.checkpoint.checkpoint``).

A checkpoint is the same pair of files the JAX package writes: ``.npz``
arrays keyed by the tree path string that ``jax.tree_util.keystr`` gives
(``"['segments'][0]['attn']['wq']"``: dict keys sorted, list indices in
brackets, NamedTuple fields as ``.field``) and a ``.json`` manifest (step,
n_arrays, meta). The port builds these strings itself
(``repro_torch.tree.keystr_items``), and writes the arrays one at a time
(``save_items``), so a writer fed leaf by leaf never holds the whole tree;
its zip entries carry a fixed date, so the same arrays give the same bytes.

The bridge maps the JAX package's trees, as numpy arrays, 1:1 onto the
port's tensors: ``params_from_flat`` / ``params_to_flat`` for the
parameters, ``state_from_flat`` / ``state_to_flat`` for a whole state
tree: the trainer's ``DiLoCoXState`` (params, inner AdamW and outer
Nesterov states, pending deltas, EF buffers, the compressor's warm
starts, the round counter) or the mesh driver's ``launch.steps.
OuterState`` (anchor, Nesterov state, pending deltas, EF buffers, warm
starts). The pipeline-parallel engine's trees cross the same way:
``pp_params_from_flat`` and ``train_state_from_flat`` for
``repro.parallel.pipeline.init_pp_params``'s tree and a
``DiLoCoTrainState``; what a process holding one stage keeps of the
latter is ``parallel.inner_engine.shard_train_state`` of it.
Both packages keep the JAX layouts (``(d_in, d_out)`` weights, stacked
units with a leading ``n``, cluster-stacked rows with a leading ``C``), so
the bridge is a rename, not a transpose.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import keystr_items, unflatten_like


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:          # numpy has no bf16: f32
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in keystr_items(tree)}


def save_items(path: str, items: Iterable[Tuple[str, np.ndarray]], *,
               step: int = 0, meta: Optional[dict] = None) -> None:
    """Writes ``(keystr, array)`` pairs as they come into ``path.npz`` (the
    layout ``np.savez`` writes) and the manifest into ``path.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = 0
    with zipfile.ZipFile(path + ".npz", "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in items:
            info = zipfile.ZipInfo(key + ".npy", date_time=(1980, 1, 1, 0, 0,
                                                            0))
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
            n += 1
    manifest = {"step": int(step), "n_arrays": n, "meta": meta or {}}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def save(path: str, tree, *, step: int = 0, meta: Optional[dict] = None):
    save_items(path, ((k, _to_numpy(v)) for k, v in keystr_items(tree)),
               step=step, meta=meta)


def tree_from_flat(flat: Dict[str, np.ndarray], tree_like, device=None,
                   *, allow_stacked: bool = False):
    """Rebuilds ``tree_like``'s structure from ``flat`` arrays (cast to each
    leaf's dtype, placed on ``device``). With ``allow_stacked`` an array
    with one extra leading dim (the trainer's cluster-stacked layout, every
    row identical after a round) contributes its row 0. Missing or
    unexpected keys and shape mismatches raise."""
    want = dict(keystr_items(tree_like))
    extra = sorted(set(flat) - set(want))
    if extra:
        raise KeyError(f"unexpected arrays {extra[:5]} (of {len(extra)})")

    def leaf(key, ref):
        if key not in flat:
            raise KeyError(f"missing array {key}")
        arr = np.asarray(flat[key])
        shape = tuple(ref.shape)
        if arr.shape != shape:
            if allow_stacked and arr.shape[1:] == shape:
                arr = arr[0]
            else:
                raise ValueError(f"{key}: array shape {arr.shape} vs model "
                                 f"{shape}")
        t = torch.from_numpy(np.array(arr))       # a writable own copy
        return t.to(device=device if device is not None else ref.device,
                    dtype=ref.dtype)

    return unflatten_like(tree_like, [leaf(k, v) for k, v in want.items()])


def restore(path: str, tree_like, *, device=None):
    """tree_like provides the structure; returns (tree, step)."""
    with np.load(path + ".npz") as data:
        tree = tree_from_flat({k: data[k] for k in data.files}, tree_like,
                              device)
    with open(path + ".json") as f:
        manifest = json.load(f)
    return tree, manifest["step"]


def latest(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f[:-5] for f in os.listdir(ckpt_dir) if f.endswith(".json")]
    if not cands:
        return None

    def step_of(c):
        with open(os.path.join(ckpt_dir, c + ".json")) as f:
            return json.load(f)["step"]

    return os.path.join(ckpt_dir, max(cands, key=step_of))


# ---------------------------------------------------------------------------
# weight bridge: the JAX package's parameter tree <-> the port's tensors
# ---------------------------------------------------------------------------

def params_from_flat(flat: Dict[str, np.ndarray], cfg, device, *,
                     allow_stacked: bool = False):
    """``{keystr: ndarray}`` of ``repro.models.model.init_params``'s tree ->
    the port's parameter tree on ``device``."""
    from repro_torch.models import model as M

    return tree_from_flat(flat, M.init_params(cfg, device="meta"), device,
                          allow_stacked=allow_stacked)


def params_to_flat(params) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_flat``: ``{keystr: ndarray}``."""
    return _flatten(params)


def state_from_flat(flat: Dict[str, np.ndarray], state_like, device=None):
    """``{keystr: ndarray}`` of a JAX state tree (``core.diloco.
    DiLoCoXState``, ``launch.steps.OuterState``, as
    ``repro.checkpoint.checkpoint._flatten`` writes it) -> the port's state
    with ``state_like``'s structure, dtypes and device."""
    return tree_from_flat(flat, state_like, device)


def state_to_flat(state) -> Dict[str, np.ndarray]:
    """The inverse of ``state_from_flat``."""
    return _flatten(state)


# ---------------------------------------------------------------------------
# the pipeline-parallel trees
# ---------------------------------------------------------------------------

def pp_params_from_flat(flat: Dict[str, np.ndarray], cfg, pcfg, device):
    """``{keystr: ndarray}`` of ``repro.parallel.pipeline.init_pp_params``'s
    tree -> the port's pp tree on ``device`` (``params_to_flat`` is the
    inverse)."""
    from repro_torch.parallel import pipeline as PP

    return tree_from_flat(flat, PP.init_pp_params(cfg, None, pcfg, "meta"),
                          device)


def train_state_from_flat(flat: Dict[str, np.ndarray], cfg, pcfg, device):
    """``{keystr: ndarray}`` of a JAX ``repro.parallel.inner_engine.
    DiLoCoTrainState`` (one cluster, unstacked) -> the port's on
    ``device`` (``state_to_flat`` is the inverse)."""
    from repro_torch.parallel import inner_engine as IE

    return tree_from_flat(flat, IE.init_train_state(cfg, pcfg, None, "meta"),
                          device)

