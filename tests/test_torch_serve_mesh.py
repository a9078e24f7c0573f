"""Port parity for serving across cards (``repro_torch.launch.mesh``'s
serving meshes, ``parallel.tensor.TPDecode``, the sharded paged engine and
``launch/serve.py --devices/--data/--model``), f32 on the CPU at the
reduced sizes.

1. ``make_production_mesh`` / ``make_serving_mesh``: the JAX functions'
   axis names and shapes (JAX's device mesh faked: its ``make_mesh``
   recorded, its ``Mesh`` built over repeated CPU devices).
2. The dense decode over D x M shards in this process, weights carried
   from JAX ``init_params`` and cut by ``serve_index``, against JAX's
   ``decode_step`` logits step by step: rtol 1e-4, atol 1e-5 (the
   unsharded port's own gate, ``tests/test_torch_model.py``; the
   row-parallel sums and the vocab split only reorder f32 adds).
3. The paged engine sharded against the one-card engine: greedy tokens
   and admission fingerprint equal.
4. The vocab-split argmax on forced exact ties: ``torch.argmax`` of the
   whole row (the lower index).
5. gloo ranks (``serve.main``, spawned) bit for bit the in-process shards
   (``serve.run`` with no shards, one thread): every head output's
   ``tree.bit_digest`` and the tokens, paged and dense.
6. The driver as a user runs it, across processes, and ``--ckpt`` across
   shards.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.configs.base import get_config as jax_get_config
from repro.launch import mesh as jmesh
from repro.models import model as JM
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as S
from repro_torch.models import model as M
from repro_torch.parallel import sharding as sh
from repro_torch.parallel import tensor as TP
from repro_torch.serve.engine import ServeEngine

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# 1. the meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_and_serving_meshes_match_jax(monkeypatch, multi_pod):
    from jax.sharding import Mesh

    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    shape, axes = jmesh.make_production_mesh(multi_pod=multi_pod)
    port = tmesh.make_production_mesh(multi_pod=multi_pod)
    assert (tuple(port.values()), tuple(port)) == (shape, axes)
    # the serving flattening, on a small mesh of the same axes
    small = (2, 2, 3) if multi_pod else (4, 3)
    devs = np.array(jax.devices() * int(np.prod(small)),
                    dtype=object).reshape(small)
    jserve = jmesh.make_serving_mesh(Mesh(devs, axes))
    pserve = tmesh.make_serving_mesh(dict(zip(axes, small)))
    assert tuple(pserve) == tuple(jserve.axis_names) == ("data", "model")
    assert tuple(pserve.values()) == tuple(jserve.devices.shape)


def test_serving_mesh_from_a_device_mesh(tmp_path):
    """A ranks' ("pod", "data", "model") DeviceMesh flattens to ("data",
    "model") over the same ranks (one gloo rank here)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        base = init_device_mesh("cpu", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        mesh = tmesh.make_serving_mesh(base)
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert tmesh.make_serving_mesh(mesh) is mesh
        assert tmesh.describe(mesh) == "{'data': 1, 'model': 1}"
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# 2. the sharded dense decode against JAX
# ---------------------------------------------------------------------------

def _carried(arch, window=None):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = jflatten(jparams)
    return jcfg, tcfg, jparams, flat


def _blocks(tcfg, flat, shards):
    like = M.init_params(tcfg, device="meta")
    return [sh.serve_blocks(flat, TP.serve_index(tcfg, shards.M, m), like,
                            CPU) for m in shards.model.local]


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)],
                         ids=["d1m2", "d1m4", "d2m2"])
@pytest.mark.parametrize("arch,window", [("opt-1.3b", None),
                                         ("granite-3-8b", None),
                                         ("stablelm-12b", None),
                                         ("gemma3-1b", 4)])
def test_sharded_decode_matches_jax(arch, window, shape):
    """opt-1.3b: GELU MLP with biases, the untied vocab-split head;
    granite-3-8b: GQA (2 KV heads: split at M = 2, one replicated a shard
    at M = 4), the tied head whole; stablelm-12b: the parallel residual;
    gemma3-1b: its one KV head replicated on every shard, the ring cache
    of window 4 wrapping in 6 steps."""
    jcfg, tcfg, jparams, flat = _carried(arch, window)
    shards = TP.ShardGroup(*shape)
    tp = TP.TPDecode(tcfg, shards)
    blocks = _blocks(tcfg, flat, shards)
    B, steps, s_max = 4, 6, 8
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                             (steps, B, 1)).astype(np.int32)
    seen = []
    tp.on_logits = lambda rows, parts: seen.append(
        (rows, torch.cat([lg for _, lg in parts], dim=2)))
    state = tp.init_decode_state(B, s_max, CPU)
    jstate = JM.init_decode_state(jcfg, B, s_max)
    jstep = jax.jit(lambda p, s, t: JM.decode_step(p, jcfg, s, t))
    for t in range(steps):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(toks[t]))
        seen.clear()
        nxt, state = tp.decode_next(blocks, state, torch.from_numpy(toks[t]))
        got = torch.cat([lg for _, lg in sorted(seen, key=lambda x: x[0])])
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {t}")
        assert nxt.shape == (B, 1) and nxt.dtype == torch.int32
        assert torch.equal(nxt[:, 0].long(), torch.argmax(got[:, -1], -1))


def test_serve_index_cuts_once_what_the_layer_splits():
    """Where the serving placement puts "model" on the dim the layer splits
    (wq, w_in, the vocab), a shard's block is its ``block_slices``; wo (a
    square leaf placed by columns) and wk/wv (GQA, placed by rows) are cut
    by rows and by KV heads instead; a replicated KV head is whole on the
    shards that read it; norms, the output bias and a tied table stay
    whole."""
    cfg = get_config("granite-3-8b")        # 32 heads, 8 KV, d 4096
    meta = M.init_params(dataclasses.replace(cfg, n_layers=1),
                         device="meta")
    mesh = {"data": 1, "model": 4}
    specs = sh.param_placements(meta, mesh, cluster_stacked=False,
                                serve=True)
    shapes = {k: tuple(x.shape) for k, _, x in sh._named_items(meta)}
    ix = TP.serve_index(cfg, 4, 1)
    hd = cfg.resolved_head_dim
    at = "['segments'][0]['attn']"
    assert ix(at + "['wq']", shapes[at + "['wq']"]) == sh.block_slices(
        shapes[at + "['wq']"], specs[at + "['wq']"], mesh,
        {"data": 0, "model": 1})
    assert ix(at + "['wo']", shapes[at + "['wo']"])[1] == slice(
        8 * hd, 16 * hd)
    assert specs[at + "['wk']"][1] == "model"     # rows, not the heads
    assert ix(at + "['wk']", shapes[at + "['wk']"])[2] == slice(
        2 * hd, 4 * hd)
    assert ix("['embed']", shapes["['embed']"]) == (slice(None),) * 2
    assert ix("['final_norm']['scale']", (4096,)) == (slice(None),)
    # gemma3-1b at M = 2: each shard replicates the one KV head
    g = get_config("gemma3-1b")
    for m in range(2):
        assert TP.kv_heads(g, 2, m) == (0, 1)
        k = TP.serve_index(g, 2, m)("['segments'][0]['attn']['wk']",
                                    (5, 1152, 256))
        assert k[2] == slice(0, 256)
    # phi3-medium-14b at M = 4 (40 heads over 10 KV) is refused
    with pytest.raises(ValueError, match="or be a multiple of them"):
        TP.serve_index(get_config("phi3-medium-14b"), 4, 0)


def test_replicated_kv_head_is_serving_only():
    """gemma3-1b (4 query heads over 1 KV head): serving takes --model 2
    and 4, and training now takes them too (one ``check_tp`` for both);
    phi3-medium-14b at M = 4 and 8, whose shards would straddle KV
    groups, is refused in both."""
    g = get_config("gemma3-1b")
    TP.check_tp(g, 2)
    TP.check_tp(g, 4)
    for m in (4, 8):
        with pytest.raises(ValueError, match="would split a KV group"):
            TP.check_tp(get_config("phi3-medium-14b"), m)
    S._check_args(S._parse_args(["--arch", "gemma3-1b", "--devices", "4",
                                 "--data", "2", "--model", "2"]))
    with pytest.raises(ValueError, match="would split a KV group"):
        S._check_args(S._parse_args(["--arch", "phi3-medium-14b",
                                     "--devices", "4", "--model", "4"]))
    with pytest.raises(ValueError, match="must equal --data"):
        S._check_args(S._parse_args(["--devices", "3", "--model", "2"]))


# ---------------------------------------------------------------------------
# 3. the paged engine sharded against one card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("granite-3-8b", (2, 2)),
                                        ("gemma3-1b", (1, 4)),
                                        ("stablelm-12b", (1, 2))])
def test_sharded_paged_engine_matches_one_card(arch, shape):
    """6 requests through 3 slots (so admission waits): the sharded
    engine's tokens and admission fingerprint equal the one-card
    engine's on the same carried weights."""
    jcfg, tcfg, jparams, flat = _carried(arch)
    kw = dict(max_seqs=4, page_size=4, n_pages=16, max_pages_per_seq=4,
              eos_id=None, device=CPU)
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (6, 5)).astype(np.int32)
    shards = TP.ShardGroup(*shape)
    runs = []
    for eng in (ServeEngine(ckpt.params_from_flat(flat, tcfg, CPU), tcfg,
                            **kw),
                ServeEngine(_blocks(tcfg, flat, shards), tcfg, shards=shards,
                            **kw)):
        for p in prompts:
            eng.submit(p.tolist(), 6)
        st = eng.run()
        runs.append(([r.generated for r in sorted(eng.sched.done,
                                                  key=lambda r: r.rid)],
                     st["admission_fingerprint"]))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) == 6 and all(len(g) == 6 for g in runs[0][0])


# ---------------------------------------------------------------------------
# 4. the vocab-split argmax on exact ties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_vocab_split_argmax_on_exact_ties(n_model, seed):
    cfg = get_config("opt-1.3b").reduced()      # untied, V 512
    tp = TP.TPDecode(cfg, TP.ShardGroup(1, n_model))
    assert tp.vocab_split
    rng = np.random.default_rng(seed)
    V, B = cfg.vocab_size, 6
    whole = rng.integers(-3, 3, (B, 1, V)).astype(np.float32)
    whole[0, 0, :] = 7.0                        # every entry ties
    whole[1, 0, [5, V // n_model + 5, V - 1]] = 9.0    # across shards
    whole[2, 0, [V - 2, V - 1]] = 9.0           # inside the last shard
    whole[3, 0, :] = -1.0                       # ties at a negative value
    whole = torch.from_numpy(whole)
    nv = V // n_model
    parts = [(m, whole[..., m * nv:(m + 1) * nv]) for m in range(n_model)]
    got = tp.argmax(parts)
    assert torch.equal(got, torch.argmax(whole[:, -1], dim=-1))
    assert got[:4].tolist() == [0, 5, V - 2, 0]


# ---------------------------------------------------------------------------
# 5. gloo ranks against the in-process shards
# ---------------------------------------------------------------------------

def _argv(shape, paged, arch="granite-3-8b"):
    D, Mm = shape
    return (["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4",
             "--requests", "6", "--prompt-len", "4", "--gen-len", "4",
             "--page-size", "4", "--eos", "-1", "--cpu-threads", "1",
             "--devices", str(D * Mm), "--data", str(D), "--model",
             str(Mm)] + (["--paged"] if paged else []))


@pytest.mark.parametrize("shape,paged", [((1, 2), False), ((2, 1), True),
                                         ((2, 2), True), ((2, 2), False)],
                         ids=["d1m2-dense", "d2m1-paged", "d2m2-paged",
                              "d2m2-dense"])
def test_gloo_ranks_bit_for_bit_in_process(tmp_path, shape, paged):
    argv = _argv(shape, paged)
    ranks_dir, local_dir = tmp_path / "ranks", tmp_path / "local"
    summary = S.main(argv + ["--digests-out", str(ranks_dir)],
                     store_dir=str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        local = S.run(S._parse_args(argv + ["--digests-out",
                                            str(local_dir)]), CPU)
    finally:
        torch.set_num_threads(threads)
    with open(local_dir / "rank0.json") as f:
        want = json.load(f)["digests"]
    n = shape[0] * shape[1]
    for rank in range(n):
        with open(ranks_dir / f"rank{rank}.json") as f:
            got = json.load(f)
        keys = {(tuple(r), m) for r, m, _, _ in got["digests"]}
        mine = [d for d in want if (tuple(d[0]), d[1]) in keys]
        assert got["digests"] and got["digests"] == mine, rank
        assert got["tokens"] == local["tokens"]
    assert summary["tokens"] == local["tokens"]
    if paged:
        assert summary["admission_fingerprint"] == \
            local["admission_fingerprint"]


# ---------------------------------------------------------------------------
# 6. the driver
# ---------------------------------------------------------------------------

def test_driver_across_processes_prints_one_cards_tokens(capsys):
    """``--devices 2 --model 2 --paged --device cpu``, as a user runs it:
    rank 0 prints the driver's lines and SERVE-DRIVER-OK with the sample
    and admission fingerprint of ``--devices 1``."""
    argv = ["--arch", "gemma3-1b", "--smoke", "--paged", "--device", "cpu",
            "--batch", "3", "--requests", "4", "--prompt-len", "4",
            "--gen-len", "4", "--page-size", "4", "--eos", "-1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"]
                       + argv + ["--devices", "2", "--model", "2"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    S.main(argv)
    outs = [[line for line in out.splitlines()
             if line.startswith(("sample:", "admission", "SERVE-DRIVER"))]
            for out in (r.stdout, capsys.readouterr().out)]
    assert outs[0] == outs[1] and len(outs[0]) == 3
    assert "1 x 2 shards" in r.stdout


@pytest.mark.parametrize("stacked", [False, True])
def test_ckpt_across_shards(tmp_path, stacked):
    """A JAX-layout checkpoint (``{"params"}``, unstacked or
    cluster-stacked) served at ``--model 2`` in process reads each leaf,
    keeps its blocks and gives the tokens of ``--devices 1``."""
    jcfg, tcfg, jparams, flat = _carried("granite-3-8b")
    arrays = {f"['params']{k}": (np.stack([v, v]) if stacked else v)
              for k, v in flat.items()}
    ckpt.save_items(str(tmp_path / "ck" / "step_1"), arrays.items(), step=1)
    base = _argv((1, 1), True) + ["--ckpt", str(tmp_path / "ck")]
    one = S.main(base)
    args = S._parse_args(base)
    args.devices, args.model = 2, 2
    two = S.run(args, CPU)
    assert two["tokens"] == one["tokens"]
    assert two["admission_fingerprint"] == one["admission_fingerprint"]
