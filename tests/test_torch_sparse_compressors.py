"""The two random baselines of ``repro_torch.core.compression``,
``RandomSparse`` and ``CocktailSGD``, against the JAX package.

Torch's random stream is not threefry, so a compressor is split into its
mask (``_mask``, drawn from a generator seeded by (seed, step, crc32 of
the leaf path) alone) and a deterministic function of (x, mask)
(``random_sparse_apply``, ``cocktail_apply``). Given the mask JAX's own
``jax.random.uniform`` draws for a (seed, step, path), the port's second
half equals the jitted JAX roundtrip bit for bit, cocktail included
(``quantize_sim`` is bit-identical to the jitted JAX function,
``tests/test_torch_compression.py``; the inputs are continuous, so top-k
has no ties). ``wire_bytes`` equals JAX's on every carried config's full
tree. The port's own mask: density within six binomial standard
deviations of the ratio, the same over two calls and for every cluster
of ``per_cluster_compress``, another at the next step; the state counts
calls."""
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import compression as JC
from repro.models import model as JM
from repro_torch import tree as T
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core import compression as C
from repro_torch.core import diloco
from repro_torch.models import model as M

KW = {"random_sparse": dict(ratio=0.1, seed=3),
      "cocktail": dict(random_ratio=0.1, topk_ratio=0.08, bits=4, seed=3)}


def _tree(seed):
    """Param-like leaves: a matrix, a stacked 3-D leaf, vectors (one
    shorter than a quantization block)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    return {"w": f(96, 80), "b": f(300), "tiny": f(40),
            "segments": [{"x": f(2, 70, 66), "bias": f(2, 40)}]}


def _jax_masks(tree, name, step):
    """The masks the JAX roundtrip draws: its key fold, its shapes
    (``x.shape`` for random-sparse, the flat leaf for cocktail)."""
    kw = KW[name]
    ratio = kw.get("ratio", kw.get("random_ratio"))

    def one(path, x):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(kw["seed"]), step),
            zlib.crc32(jax.tree_util.keystr(path).encode()) % (2 ** 31))
        shape = x.shape if name == "random_sparse" else (x.size,)
        return np.asarray(jax.random.uniform(key, shape) < ratio)

    return jax.tree_util.tree_map_with_path(one, tree)


def _apply(name, x, mask):
    kw = KW[name]
    if name == "random_sparse":
        return C.random_sparse_apply(x, mask, kw["ratio"])
    return C.cocktail_apply(x, mask, kw["random_ratio"], kw["topk_ratio"],
                            kw["bits"])


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["random_sparse", "cocktail"])
def test_apply_given_jax_mask_equals_jax_roundtrip(name, seed, step):
    tree = _tree(seed)
    jc = JC.make_compressor(name, **KW[name])
    jout, jstate = jax.jit(jc.roundtrip)(jax.tree.map(jnp.asarray, tree),
                                         jnp.int32(step))
    assert int(jstate) == step + 1
    masks = dict(T.keystr_items(_jax_masks(tree, name, step)))
    want = dict(T.keystr_items(jax.tree.map(np.asarray, jout)))
    for path, x in T.keystr_items(tree):
        got = _apply(name, torch.from_numpy(x),
                     torch.from_numpy(np.array(masks[path])))
        assert got.dtype == torch.float32 and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), want[path], err_msg=path)
        kept = np.count_nonzero(want[path])
        if name == "cocktail":
            k = max(1, int(x.size * 0.1 * 0.08))
            assert 0 < kept <= k, path
        else:
            assert kept == masks[path].sum(), path


def _shapes(arch, jax_side):
    if jax_side:
        cfg = jax_get_config(arch)
        tree = jax.eval_shape(lambda key: JM.init_params(cfg, key),
                              jax.random.PRNGKey(0))
        return JC.tree_shapes(tree)
    return C.tree_shapes(M.init_params(get_config(arch), device="meta"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_wire_bytes_equal_on_every_carried_config(arch):
    shapes = _shapes(arch, jax_side=True)
    assert _shapes(arch, jax_side=False) == shapes
    for name, kw in KW.items():
        want = JC.make_compressor(name, **kw).wire_bytes(shapes)
        assert C.make_compressor(name, **kw).wire_bytes(shapes) == want
        assert C.make_compressor(name).wire_bytes(shapes) == \
            JC.make_compressor(name).wire_bytes(shapes)


@pytest.mark.parametrize("ratio", [0.1, 0.3])
def test_mask_density_within_a_binomial_bound(ratio):
    """n draws at p = ratio: the kept count within 6 sqrt(n p (1 - p))."""
    n = 1 << 20
    for step in range(3):
        kept = int(C._mask(0, step, "['w']", (n,), ratio, "cpu").sum())
        assert abs(kept - n * ratio) <= 6 * math.sqrt(n * ratio * (1 - ratio))


def test_mask_depends_on_seed_step_and_path_alone():
    a = C._mask(7, 2, "['w']", (64, 64), 0.1, "cpu")
    assert a.dtype == torch.bool and a.shape == (64, 64)
    torch.manual_seed(123)                       # the global stream is unused
    assert torch.equal(a, C._mask(7, 2, "['w']", (64, 64), 0.1, "cpu"))
    for other in (C._mask(7, 3, "['w']", (64, 64), 0.1, "cpu"),
                  C._mask(8, 2, "['w']", (64, 64), 0.1, "cpu"),
                  C._mask(7, 2, "['b']", (64, 64), 0.1, "cpu")):
        assert not torch.equal(a, other)
    assert C._mask_seed(7, 2, "['w']") == C._mask_seed(7, 2, "['w']")
    assert 0 <= C._mask_seed(7, 2, "['w']") < 2 ** 63


@pytest.mark.parametrize("name", ["random_sparse", "cocktail"])
def test_every_cluster_draws_the_same_mask_and_the_state_counts(name):
    """Three clusters with different deltas through ``per_cluster_compress``
    (the trainer's loop): the kept positions of every cluster lie in the
    one mask of (seed, step, path); two calls at the same step agree bit
    for bit; the next step draws another mask; the state advances by one
    per call, in every cluster."""
    comp = C.make_compressor(name, **KW[name])
    rows = [T.tree_map(torch.from_numpy, _tree(s)) for s in range(3)]
    stacked = T.tree_map(lambda *xs: torch.stack(xs), *rows)
    state = diloco.stack_replicas(comp.init_state(rows[0]), 3)
    assert state.dtype == torch.int32 and state.tolist() == [0, 0, 0]
    hats, state1 = diloco.per_cluster_compress(comp, stacked, state)
    again, _ = diloco.per_cluster_compress(comp, stacked, state)
    nxt, state2 = diloco.per_cluster_compress(comp, stacked, state1)
    assert state1.tolist() == [1, 1, 1] and state2.tolist() == [2, 2, 2]
    ratio = KW[name].get("ratio", KW[name].get("random_ratio"))
    for path, h in T.keystr_items(hats):
        x = dict(T.keystr_items(stacked))[path]
        shape = x.shape[1:] if name == "random_sparse" else (x[0].numel(),)
        mask = C._mask(3, 0, path, shape, ratio, "cpu").reshape(x.shape[1:])
        for c in range(3):
            kept = h[c] != 0
            assert not (kept & ~mask).any(), (path, c)
            if name == "random_sparse":
                assert torch.equal(kept, mask), (path, c)
        assert torch.equal(h, dict(T.keystr_items(again))[path]), path
        assert not torch.equal(h, dict(T.keystr_items(nxt))[path]), path
