"""Port parity for the placement rules: ``repro_torch.parallel.sharding``
against ``repro.parallel.sharding``.

Every case of ``tests/test_sharding_rules.py`` is translated, with
``pytest.mark.parametrize`` over seeds and shapes where the reference
draws with Hypothesis; the ported rule must return exactly the JAX rule's
``PartitionSpec`` (as a tuple) at every leaf. ``spec_for_param`` runs on
the reference tests' duck-typed mesh; ``param_shardings`` (the embedding
rule, the scan dims) on a one-device ``jax.make_mesh``, and on the
duck-typed mesh at real axis sizes with ``NamedSharding`` replaced by the
bare spec (the test's monkeypatch; the reference file is not touched).
The full placement trees of all seven ported configs are compared at two
mesh shapes, cluster-stacked and not, for training and serving."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.launch import steps as JSteps
from repro.parallel import sharding as JSH
from repro_torch import tree as T
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models import model as M
from repro_torch.parallel import sharding as sh


class FakeMesh:
    """Duck-typed mesh: only .shape is consulted by the rule functions."""
    def __init__(self, shape):
        self.shape = shape


MESH = FakeMesh({"clusters": 2, "data": 8, "model": 16})
MESHES = [{"clusters": 1, "data": 2, "model": 2},
          {"clusters": 2, "data": 1, "model": 4}]


def _draws(seed, n, lo_hi):
    rng = np.random.default_rng(seed)
    return [tuple(int(rng.integers(lo, hi + 1)) for lo, hi in lo_hi)
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(5))
def test_spec_dims_always_divide(seed):
    for din, dout, n_scan in _draws(seed, 10, [(1, 4096), (1, 65536),
                                               (0, 2)]):
        shape = tuple([3] * n_scan + [din, dout])
        spec = sh.spec_for_param(["w"], shape, MESH, cluster_stacked=False,
                                 n_scan_dims=n_scan)
        assert spec == tuple(JSH.spec_for_param(
            ["w"], shape, MESH, cluster_stacked=False, n_scan_dims=n_scan))
        for dim_size, entry in zip(shape, spec):
            if entry is not None:
                assert dim_size % MESH.shape[entry] == 0, (shape, spec)


@pytest.mark.parametrize("seed", range(3))
def test_spec_axes_never_repeat(seed):
    for din, dout in _draws(100 + seed, 10, [(16, 4096), (16, 65536)]):
        spec = sh.spec_for_param(["w"], (2, 4, din, dout), MESH,
                                 cluster_stacked=True, n_scan_dims=2)
        assert spec == tuple(JSH.spec_for_param(
            ["w"], (2, 4, din, dout), MESH, cluster_stacked=True,
            n_scan_dims=2))
        used = [e for e in spec if e is not None]
        assert len(used) == len(set(used)), spec


def test_expert_rule_expert_parallel():
    args = (["segments", "moe", "experts", "w_gate"], (2, 59, 160, 5120, 1536),
            MESH)
    spec = sh.spec_for_param(*args, cluster_stacked=True, n_scan_dims=2)
    assert spec == ("clusters", None, "model", "data", None)
    assert spec == tuple(JSH.spec_for_param(*args, cluster_stacked=True,
                                            n_scan_dims=2))


@pytest.mark.parametrize("shape,want", [((4096, 12800), ("data", "model")),
                                        ((12800, 4096), ("model", "data"))])
def test_fat_dim_gets_model_axis(shape, want):
    # (d, ff): ff is fat -> model; (ff, d): din fat -> model
    spec = sh.spec_for_param(["w"], shape, MESH, cluster_stacked=False,
                             n_scan_dims=0)
    assert spec == want == tuple(JSH.spec_for_param(
        ["w"], shape, MESH, cluster_stacked=False, n_scan_dims=0))


def _port_tree(cfg, n_clusters=0):
    p = M.init_params(cfg, device="meta")
    if n_clusters:
        p = T.tree_map(lambda x: x.expand((n_clusters,) + tuple(x.shape)), p)
    return p


def _jax_items(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_specs_cover_all_archs(arch):
    """Every ported arch's full cluster-stacked tree, leaf by leaf through
    ``spec_for_param`` (the reference test's loop), on the big duck-typed
    mesh: legal and equal to the JAX rule."""
    jp = JSteps.params_specs(jax_get_config(arch), n_clusters=2)
    want = {}

    def check(path, leaf):
        names = [str(getattr(q, "key", getattr(q, "name", ""))) for q in path]
        n_scan = 1 + (1 if any("segments" in n for n in names) else 0)
        n_scan = min(n_scan, max(0, len(leaf.shape) - 1))
        want[jax.tree_util.keystr(path)] = tuple(JSH.spec_for_param(
            names, leaf.shape, MESH, cluster_stacked=True,
            n_scan_dims=n_scan))

    jax.tree_util.tree_map_with_path(check, jp)
    for key, leaf in T.keystr_items(_port_tree(get_config(arch), 2)):
        names = [n.strip("'") for n in key[1:-1].split("][")]
        names = ["" if n.isdigit() else n for n in names]
        n_scan = min(1 + ("segments" in names), max(0, leaf.dim() - 1))
        spec = sh.spec_for_param(names, tuple(leaf.shape), MESH,
                                 cluster_stacked=True, n_scan_dims=n_scan)
        assert spec == want[key], (arch, key)
        for dim_size, entry in zip(leaf.shape, spec):
            if entry is not None:
                assert dim_size % MESH.shape[entry] == 0, (arch, key, spec)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("serve", [False, True])
def test_param_shardings_on_one_device_mesh(stacked, serve):
    """The embedding rule and the scan dims through ``param_shardings`` on
    a real one-device mesh (every axis of size 1)."""
    mesh = jax.make_mesh((1, 1, 1), ("clusters", "data", "model"))
    cfg = get_config("granite-3-8b").reduced()
    jp = JSteps.params_specs(jax_get_config("granite-3-8b").reduced(),
                             n_clusters=2 if stacked else 0)
    want = _jax_items(jax.tree.map(lambda s: s.spec, JSH.param_shardings(
        jp, mesh, cluster_stacked=stacked, serve=serve)))
    got = sh.param_placements(_port_tree(cfg, 2 if stacked else 0),
                              {"clusters": 1, "data": 1, "model": 1},
                              cluster_stacked=stacked, serve=serve)
    assert list(got.items()) == want
    assert got["['embed']"] == (("clusters",) if stacked else ()) + (
        None, "model")


@pytest.fixture
def bare_specs(monkeypatch):
    """The JAX rule's functions returning their ``PartitionSpec``s, so they
    run on the duck-typed mesh at real axis sizes."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("mesh", MESHES, ids=["c1d2m2", "c2d1m4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_placement_trees_match_jax(arch, mesh, bare_specs):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for stacked, serve in ((True, False), (False, False), (False, True)):
        n = 2 if stacked else 0
        want = _jax_items(JSH.param_shardings(
            JSteps.params_specs(jcfg, n_clusters=n), FakeMesh(mesh),
            cluster_stacked=stacked, serve=serve))
        got = sh.param_placements(_port_tree(cfg, n), mesh,
                                  cluster_stacked=stacked, serve=serve)
        assert list(got.items()) == want, (arch, stacked, serve)


def test_placements_the_tensor_split_reads():
    """The placements the port's tensor-parallel split reads: opt-1.3b at
    data 2 x model 2 and granite-3-8b at data 1 x model 4."""
    opt = sh.param_placements(_port_tree(get_config("opt-1.3b"), 1),
                              {"clusters": 1, "data": 2, "model": 2},
                              cluster_stacked=True)
    gr = sh.param_placements(_port_tree(get_config("granite-3-8b"), 1),
                             {"clusters": 1, "data": 1, "model": 4},
                             cluster_stacked=True)
    seg = "['segments'][0]"
    lead = ("clusters", None)
    assert opt[seg + "['attn']['wq']"] == lead + ("data", "model")
    assert opt[seg + "['attn']['wo']"] == lead + ("data", "model")
    assert opt[seg + "['mlp']['w_out']"] == lead + ("model", "data")
    assert gr[seg + "['attn']['wk']"] == lead + ("model", "data")
    assert gr[seg + "['mlp']['w_down']"] == lead + ("model", "data")
    assert opt["['head']"] == ("clusters", "data", "model")
    assert gr["['embed']"] == ("clusters", None, "model")
    assert opt[seg + "['ln1']['scale']"] == lead + (None,)


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-3-8b"])
def test_decode_state_placements_match_jax(arch, seq_shard, bare_specs):
    shape = SHAPES["decode_32k"]
    jstate = JSteps.decode_state_specs(jax_get_config(arch), shape)
    state = M.init_decode_state(get_config(arch), shape.global_batch,
                                shape.seq_len, device="meta")
    for mesh in MESHES:
        want = _jax_items(JSH.decode_state_shardings(
            jstate, FakeMesh(mesh), seq_shard=seq_shard))
        got = sh.decode_state_placements(state, mesh, seq_shard=seq_shard)
        assert list(got.items()) == want


@pytest.mark.parametrize("stacked", [False, True])
def test_batch_placements_match_jax(stacked, bare_specs):
    jcfg = jax_get_config("granite-3-8b")
    jb = JSteps.input_specs(jcfg, SHAPES["train_4k"],
                            n_clusters=2 if stacked else 1)
    if not stacked:
        jb = {"tokens": jax.ShapeDtypeStruct(jb["tokens"].shape[1:],
                                             jnp.int32)}
    b = {"tokens": torch.empty(jb["tokens"].shape, device="meta")}
    for mesh in MESHES:
        want = _jax_items(JSH.batch_shardings(jb, FakeMesh(mesh),
                                              cluster_stacked=stacked))
        assert list(sh.batch_placements(b, mesh,
                                        cluster_stacked=stacked).items()) \
            == want
    tree = {"a": torch.zeros(()), "b": [torch.zeros(3)]}
    assert sh.replicated(tree) == {"['a']": (), "['b'][0]": ()}


@pytest.mark.parametrize("mesh", MESHES, ids=["c1d2m2", "c2d1m4"])
def test_shard_tree_roundtrip(mesh):
    """The bridge: a whole tree (numpy, as the JAX package's params cross)
    cut into every rank's blocks and put back together, bit for bit."""
    cfg = get_config("opt-1.3b").reduced()
    rng = np.random.default_rng(0)
    whole = T.tree_map(lambda x: rng.standard_normal(
        (mesh["clusters"],) + tuple(x.shape)).astype(np.float32),
        M.init_params(cfg, device="meta"))
    specs = sh.param_placements(whole, mesh, cluster_stacked=True)
    coords = [{"clusters": c, "data": j, "model": m}
              for c in range(mesh["clusters"]) for j in range(mesh["data"])
              for m in range(mesh["model"])]
    blocks = [(c, sh.shard_tree(whole, specs, mesh, c)) for c in coords]
    wq = "['segments'][0]['attn']['wq']"
    for c, b in blocks:
        got = dict(T.keystr_items(b))[wq]
        assert got.shape == (1, cfg.n_layers, 128 // mesh["data"],
                             128 // mesh["model"])
    back = sh.unshard_tree(blocks, specs, mesh)
    for (k, a), b in zip(T.keystr_items(whole), T.leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=k)
    t = sh.shard_tree(T.tree_map(torch.from_numpy, whole), specs, mesh,
                      coords[-1])
    assert all(isinstance(x, torch.Tensor) and x.is_contiguous()
               for x in T.leaves(t))


# ---------------------------------------------------------------------------
# serving blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_model", [2, 4])
def test_serve_blocks_are_shard_tree_where_the_placement_splits(n_model):
    """``serve_blocks`` with ``block_slices`` of the serving placements is
    ``shard_tree``; from numpy arrays (a checkpoint's) it gives the same
    tensors as from the whole tree, and a cluster-stacked array's row 0."""
    cfg = get_config("opt-1.3b").reduced()
    gen = torch.Generator()
    gen.manual_seed(n_model)
    params = M.init_params(cfg, gen, torch.device("cpu"))
    mesh = {"data": 1, "model": n_model}
    specs = sh.param_placements(params, mesh, cluster_stacked=False,
                                serve=True)
    like = M.init_params(cfg, device="meta")
    for m in range(n_model):
        coords = {"data": 0, "model": m}

        def index_of(key, shape):
            return sh.block_slices(shape, specs[key], mesh, coords)

        want = sh.shard_tree(params, specs, mesh, coords)
        flat = dict(T.keystr_items(params))
        for got in (sh.serve_blocks(flat, index_of, like, "cpu"),
                    sh.serve_blocks({k: v.numpy() for k, v in flat.items()},
                                    index_of, like, "cpu"),
                    sh.serve_blocks({k: np.stack([v.numpy()] * 2)
                                     for k, v in flat.items()}, index_of,
                                    like, "cpu", allow_stacked=True)):
            for (k, a), (_, b) in zip(T.keystr_items(got),
                                      T.keystr_items(want)):
                assert a.is_contiguous() and torch.equal(a, b), k


@pytest.mark.parametrize("arch,n_model", [("granite-3-8b", 2),
                                          ("gemma3-1b", 4),
                                          ("stablelm-12b", 4)])
def test_draw_params_blocks_are_the_whole_draws_blocks(arch, n_model):
    """``models.model.draw_params`` cut as it draws (one unit at a time)
    holds the values of the whole draw's blocks, so every layout serves
    the same weights."""
    from repro_torch.parallel.tensor import serve_index

    cfg = get_config(arch).reduced()
    whole = M.draw_params(cfg, 3, "cpu")
    for m in range(n_model):
        index_of = serve_index(cfg, n_model, m)
        got = M.draw_params(cfg, 3, "cpu", index_of)
        for (k, a), (_, b) in zip(T.keystr_items(got),
                                  T.keystr_items(whole)):
            assert torch.equal(a, b[index_of(k, tuple(b.shape))]), k
