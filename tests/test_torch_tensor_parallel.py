"""Port parity for tensor parallelism and FSDP placement
(``repro_torch.parallel.tensor`` and the mesh driver's ``--data`` /
``--model``).

1. One transformer unit (attention and MLP, plus the embedding, final
   norm, head and CE) split over D data x M model shards in this process
   against the unsharded port and against JAX's ``loss_fn`` on the same
   params (carried from ``repro.models.model.init_params`` as numpy) and
   tokens, f32: the loss within rtol 1e-6 of the unsharded port's and
   1e-5 of JAX's; every leaf's gradient within 1e-5 of its norm of the
   unsharded port's and 1e-4 of JAX's (other sum orders: the shards'
   partial products, the vocab-split logsumexp).
2. The driver across gloo processes, one shard a rank, bit for bit its
   in-process sharded run (``run`` with no groups, one thread): every
   rank's blocks of the round state after each round, and the
   ``--ckpt-dir`` files byte for byte (also under ``--inner pp``), with
   ``--adaptive`` and ``--h-policy balance`` too.
3. The in-process sharded run against the unsharded ``--data 1 --model
   1`` run of the same cluster and data: round losses within rtol 1e-5;
   the AdamW moments and the pending delta after round 0 (before any
   nonzero outer update) within rtol 1e-4 / atol 1e-6 in 99.9 % of every
   leaf's elements and every element within the AdamW allowance of
   ``tests/test_torch_mesh.py`` (0.05 lr a step).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.launch import train as TR
from repro_torch.models import model as M
from repro_torch.parallel import sharding as sh
from repro_torch.parallel import tensor as TP

CPU = torch.device("cpu")
B, S = 4, 16


def _carried(arch, **over):
    over = {"n_layers": 1, "n_kv_heads": 4, **over}
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    # non-zero biases and norm scales, so their gradients' paths count
    leaves, tdef = jax.tree_util.tree_flatten(jparams)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    jparams = jax.tree_util.tree_unflatten(tdef, [
        x + 0.02 * jax.random.normal(k, x.shape, x.dtype)
        for x, k in zip(leaves, keys)])
    tparams = ckpt.params_from_flat(jflatten(jparams), tcfg, CPU)
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def _whole_grads(shards, specs, params, grads):
    """The sharded gradients (``flat_parts`` order) put back into whole
    leaves."""
    it = iter(grads)
    out = []
    for key, x in T.keystr_items(params):
        whole = torch.empty_like(x)
        for a, row in enumerate(shards.parts(x, specs[key])):
            for b in range(len(row)):
                whole[sh.block_slices(x.shape, specs[key], shards.mesh,
                                      {"data": a, "model": b})] = next(it)
        out.append(whole)
    return out


def _rel(a, b):
    return float((a.double() - b.double()).norm()
                 / max(float(b.double().norm()), 1e-30))


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)],
                         ids=["d1m2", "d1m4", "d2m2"])
@pytest.mark.parametrize("arch", ["opt-1.3b", "granite-3-8b",
                                  "stablelm-12b", "gemma3-1b"])
def test_unit_sharded_matches_unsharded_and_jax(arch, shape):
    """opt-1.3b: LayerNorm, GELU MLP with biases, untied vocab-split head;
    granite-3-8b: RMSNorm, SwiGLU, the tied head computed whole;
    stablelm-12b: the parallel residual; gemma3-1b: a sliding-window
    unit, the embedding scale (its KV heads set to 4 here, M dividing
    them; its own one KV head, replicated over the shards, is
    ``test_replicated_kv_head_matches_jax``'s)."""
    jcfg, tcfg, jparams, tparams, toks = _carried(arch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    jg = {k: np.array(v) for k, v in jflatten(jg).items()}
    p = T.tree_map(lambda x: x.detach().requires_grad_(True), tparams)
    loss_u, _ = M.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)})
    g_u = torch.autograd.grad(loss_u, T.leaves(p))
    loss_u = loss_u.detach()

    shards = TP.ShardGroup(*shape)
    specs = sh.param_placements(tparams, shards.mesh, cluster_stacked=False)
    parts = {k: shards.parts(x, specs[k]) for k, x in
             T.keystr_items(tparams)}
    n = B // shards.D
    t = torch.from_numpy(toks)
    loss_s, g_s = TP.TPLoss(tcfg, shards, specs).value_and_grad(
        parts, [t[j * n:(j + 1) * n] for j in range(shards.D)])
    assert abs(float(loss_s) - float(loss_u)) <= 1e-6 * abs(float(loss_u))
    assert abs(float(loss_s) - float(jl)) <= 1e-5 * abs(float(jl))
    for (key, _), gs, gu in zip(T.keystr_items(tparams),
                                _whole_grads(shards, specs, tparams, g_s),
                                g_u):
        assert _rel(gs, gu) <= 1e-5, key
        assert _rel(gs, torch.from_numpy(jg[key])) <= 1e-4, key


@pytest.mark.parametrize("arch,kv,shape", [
    ("gemma3-1b", 1, (1, 2)), ("gemma3-1b", 1, (1, 4)),
    ("gemma3-1b", 1, (2, 4)), ("granite-3-8b", 2, (1, 4))],
    ids=["gemma3-1b-d1m2", "gemma3-1b-d1m4", "gemma3-1b-d2m4",
         "granite-3-8b-kv2-d1m4"])
def test_replicated_kv_head_matches_jax(arch, kv, shape):
    """M a multiple of the KV heads (the reduced configs' own KV counts):
    each shard computes with a copy of the one KV head its query heads
    read, and that head's wk/wv gradient is the sum over the shards that
    share it. The loss within rtol 1e-5 of JAX's and every leaf's gradient
    within 1e-4 of its norm of JAX's ``loss_fn`` grads."""
    jcfg, tcfg, jparams, tparams, toks = _carried(arch, n_kv_heads=kv)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    jg = {k: np.array(v) for k, v in jflatten(jg).items()}
    shards = TP.ShardGroup(*shape)
    specs = sh.param_placements(tparams, shards.mesh, cluster_stacked=False)
    parts = {k: shards.parts(x, specs[k]) for k, x in
             T.keystr_items(tparams)}
    n = B // shards.D
    t = torch.from_numpy(toks)
    loss = TP.TPLoss(tcfg, shards, specs)
    assert loss.kv_replicated and loss.n_kv == 1
    loss_s, g_s = loss.value_and_grad(
        parts, [t[j * n:(j + 1) * n] for j in range(shards.D)])
    assert abs(float(loss_s) - float(jl)) <= 1e-5 * abs(float(jl))
    for (key, _), gs in zip(T.keystr_items(tparams),
                            _whole_grads(shards, specs, tparams, g_s)):
        assert _rel(gs, torch.from_numpy(jg[key])) <= 1e-4, key


def test_kv_group_split_is_refused():
    """The refusal that remains: shards that would straddle KV groups
    (phi3-medium-14b, 40 query heads over 10 KV heads, at M = 4 and 8:
    10 or 5 query heads a shard, groups of 4). A multiple of the KV heads
    is taken in training now (a replicated KV head a shard): granite-3-8b
    at M = 16 (8 KV heads), the reduced gemma3-1b (1 KV head) at 2 and
    4; an M that does not divide the query heads runs attention whole."""
    phi3 = TR._parse_args(["--arch", "phi3-medium-14b", "--devices", "4",
                           "--clusters", "1", "--data", "1", "--model",
                           "4"])
    with pytest.raises(ValueError, match="phi3-medium-14b: --model 4 would "
                                         "split a KV group"):
        TR._check_args(phi3)
    cfg = get_config("phi3-medium-14b")
    with pytest.raises(ValueError, match="--model 8"):
        TP.check_tp(cfg, 8)
    TP.check_tp(cfg, 16)              # 40 % 16: attention whole
    TP.check_tp(cfg, 2)               # 2 divides the 10 KV heads
    TR._check_args(TR._parse_args([
        "--arch", "granite-3-8b", "--devices", "32", "--clusters", "2",
        "--data", "1", "--model", "16", "--global-batch", "32"]))
    for m in (2, 4):
        TR._check_args(TR._parse_args([
            "--arch", "gemma3-1b", "--smoke", "--devices", str(m),
            "--clusters", "1", "--data", "1", "--model", str(m)]))


# ---------------------------------------------------------------------------
# the driver: ranks against the in-process sharded run
# ---------------------------------------------------------------------------

DRIVER = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
          "--rounds", "2", "--h-steps", "2", "--seq-len", "16",
          "--cpu-threads", "1", "--join-timeout", "180"]
STATE_TREES = ("['params']", "['opt'].m", "['opt'].v", "['outer']['anchor']",
               "['outer']['outer_opt'].momentum",
               "['outer']['delta_pending']", "['outer']['error']")


def _in_process(argv):
    """The driver's round loop with every cluster and shard in this
    process, one thread; the state after each round as flat arrays."""
    states = []

    def on_round(r, params, opt, outer):
        states.append({k: v.copy() for k, v in ckpt._flatten(
            {"params": params, "opt": opt, "outer": outer._asdict()}).items()})

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = TR._parse_args(argv)
        summary = TR.run(args, CPU, clusters=list(range(args.clusters)),
                         on_round=on_round)
    finally:
        torch.set_num_threads(threads)
    return summary, states


def _rank_block(key, arr, specs, mesh, c, coords):
    """Rank (c, coords)'s part of an in-process state leaf."""
    unstacked = key.startswith(("['outer']['anchor']",
                                "['outer']['outer_opt']"))
    if not unstacked:
        arr = arr[c:c + 1]
    pre = [p for p in STATE_TREES if key.startswith(p)]
    if pre:
        lead = () if unstacked else (None,)
        arr = arr[sh.block_slices(arr.shape,
                                  lead + specs[key[len(pre[0]):]], mesh,
                                  coords)]
    return arr


@pytest.mark.parametrize("C,D,Mm,extra", [
    (1, 1, 2, []), (1, 2, 2, []),
    (2, 1, 2, ["--adaptive", "--h-policy", "balance", "--step-times", "1,2"]),
    # a replicated KV head a shard: 2 KV heads over 4 shards, and gemma3-1b's
    # one KV head over 4
    (1, 1, 4, []), (1, 1, 4, ["--arch", "gemma3-1b"])],
    ids=["c1d1m2", "c1d2m2", "c2d1m2-adaptive-balance", "c1d1m4-kv-replicated",
         "c1d1m4-gemma3-1b"])
def test_driver_ranks_equal_in_process_bitwise(tmp_path, capfd, C, D, Mm,
                                               extra):
    arch = extra[extra.index("--arch") + 1] if "--arch" in extra \
        else "granite-3-8b"
    argv = DRIVER + extra + ["--devices", str(C * D * Mm), "--clusters",
                             str(C), "--data", str(D), "--model", str(Mm),
                             "--global-batch", str(4 * C)]
    summary = TR.main(argv + ["--state-out", str(tmp_path / "st"),
                              "--ckpt-dir", str(tmp_path / "ck")],
                      store_dir=str(tmp_path))
    assert capfd.readouterr().out.rstrip().endswith("TRAIN-DRIVER-OK")
    want_summary, want = _in_process(argv + ["--ckpt-dir",
                                             str(tmp_path / "ck1")])
    for key in ("mean_loss", "h", "rank"):
        assert summary[key] == want_summary[key], key
    # rank 0's cluster's bytes; the in-process run holds all C clusters
    assert [C * b for b in summary["gather_bytes"]] == \
        want_summary["gather_bytes"]
    mesh = {"data": D, "model": Mm}
    specs = sh.param_placements(
        M.init_params(get_config(arch).reduced(), device="meta"),
        mesh, cluster_stacked=False)
    for r, flat in enumerate(want):
        for rank in range(C * D * Mm):
            c = rank // (D * Mm)
            coords = {"data": rank // Mm % D, "model": rank % Mm}
            with np.load(tmp_path / "st" / f"round_{r:04d}.rank{rank}.npz") \
                    as z:
                assert sorted(z.files) == sorted(flat)
                for key, arr in flat.items():
                    np.testing.assert_array_equal(
                        z[key], _rank_block(key, arr, specs, mesh, c, coords),
                        err_msg=f"round {r} rank {rank} {key}")
        for ext in ("npz", "json"):
            a = (tmp_path / "ck" / f"round_{r:04d}.{ext}").read_bytes()
            assert a == (tmp_path / "ck1" / f"round_{r:04d}.{ext}"
                         ).read_bytes(), (r, ext)


def test_pp_checkpoint_across_ranks_is_the_in_process_one(tmp_path):
    argv = DRIVER + ["--inner", "pp", "--devices", "4", "--clusters", "2",
                     "--data", "1", "--pp-stages", "2", "--pp-micro", "2",
                     "--global-batch", "8"]
    TR.main(argv + ["--ckpt-dir", str(tmp_path / "ranks")],
            store_dir=str(tmp_path))
    _in_process(argv + ["--ckpt-dir", str(tmp_path / "one")])
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "ranks")) and len(names) == 4
    for name in names:
        assert (tmp_path / "ranks" / name).read_bytes() == \
            (tmp_path / "one" / name).read_bytes(), name


def test_in_process_sharded_run_matches_unsharded():
    argv = DRIVER + ["--devices", "4", "--clusters", "1", "--global-batch",
                     "4", "--inner-lr", "1e-3"]
    s_tp, tp = _in_process(argv + ["--data", "2", "--model", "2"])
    s_one, one = _in_process(argv + ["--data", "1", "--model", "1"])
    np.testing.assert_allclose(s_tp["mean_loss"], s_one["mean_loss"],
                               rtol=1e-5)
    assert s_tp["gather_bytes"] == s_one["gather_bytes"]
    allowance = 0.05 * 1e-3 * 2           # 0.05 lr a step, two steps
    for key, want in one[0].items():
        got = tp[0][key]
        if key.startswith(("['params']", "['outer']['anchor']")):
            # round 0's outer step applies Delta = 0: the initial params
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        if not key.startswith(("['opt'].m", "['opt'].v",
                               "['outer']['delta_pending']")):
            continue
        close = np.isclose(got, want, rtol=1e-4, atol=1e-6)
        assert close.mean() >= 0.999, (key, close.mean())
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=allowance + 1e-6, err_msg=key)
