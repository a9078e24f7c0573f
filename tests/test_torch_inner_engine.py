"""Port parity for the pipeline-parallel inner engine
(``repro_torch.parallel.inner_engine``), its trainer and driver entry
points and the meta-device dry-run.

 - ``extract_delta``/``apply_delta`` round-trip a ``DiLoCoTrainState``:
   structure, dtypes and the pinned ``active`` mask exactly; values to
   4 ulps of the largest operand (the JAX test's rtol 1e-5 is a known
   fault of the reference, ROADMAP §C: a - (a - p) re-rounds at the scale
   of a, not of p).
 - The placement rule places every leaf; a process's stage rows.
 - ``run_diloco_training(inner_engine="pp")`` over 2 rounds against a JAX
   ``core.diloco.diloco_round`` whose inner steps run JAX's sequential
   ``loss_fn`` on the same pp tree (reshaped), with the same batches and
   compressor warm starts. The bound is JAX's differential budget
   (``tests/test_inner_engine.py``): 0.5 lr (r + 1) on the params and the
   pending pseudo-gradients, losses within 1e-2 (r + 1), and the budget
   not vacuous (under half of the pseudo-gradients' own size). With the
   global and the ``balance`` h-policy.
 - The driver ``launch/train.py --inner pp`` with 2 clusters x 2 stages
   on 4 gloo ranks bit for bit equal to the in-process pipeline (all
   stages and clusters in one process) over 2 rounds; its refusals.
 - The meta dry-run of qwen1.5-107b at 8 stages: parameter count and
   every leaf's shape by keystr equal JAX's ``eval_shape`` of
   ``init_train_state``.

The ``slow`` test is the port's twin of JAX's
``test_pp_engine_differential_vs_scalar``."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.configs.base import get_config as jax_get_config
from repro.core import compression as JC
from repro.core import diloco as JD
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.parallel import inner_engine as JIE
from repro.parallel import pipeline as JPP
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core.compression import LowRankQuant
from repro_torch.launch import dryrun
from repro_torch.launch import train as TR
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import inner_engine as IE
from repro_torch.parallel import pipeline as PP
from repro_torch.train import trainer as TT

CPU = torch.device("cpu")
VOCAB, B, S = 128, 8, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: these shapes are tiny, and the suite's workers
    share the host's cores (several threads each stall in their barriers
    when the workers oversubscribe them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(layers=5, vocab=VOCAB):
    over = dict(n_layers=layers, vocab_size=vocab)
    return (dataclasses.replace(jax_get_config("granite-3-8b").reduced(),
                                **over),
            dataclasses.replace(get_config("granite-3-8b").reduced(), **over))


# ---------------------------------------------------------------------------
# delta extraction round-trips the DiLoCoTrainState
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 1e-2, 1e-1])
@pytest.mark.parametrize("seed", range(4))
def test_delta_extraction_roundtrips_train_state(seed, scale):
    _, tcfg = _cfgs(3, vocab=64)
    pcfg = PP.PipelineConfig(n_stages=2, n_micro=2)
    gen = torch.Generator()
    gen.manual_seed(seed)
    st0 = IE.init_train_state(tcfg, pcfg, gen, CPU)
    anchor = st0.params
    noise = lambda x: scale * torch.randn(x.shape, generator=gen)
    local = dict(T.tree_map(lambda x: x + noise(x).to(x.dtype), anchor))
    local["active"] = anchor["active"]
    error = T.tree_map(noise, anchor)
    state = st0._replace(params=local, error=error)
    delta = IE.extract_delta(anchor, state)
    keys = lambda t: [k for k, _ in T.keystr_items(t)]
    assert keys(delta) == keys(anchor)
    assert all(x.dtype == torch.float32 for x in T.leaves(delta))
    assert not delta["active"].any()
    back = IE.apply_delta(anchor, delta, error=error)
    assert keys(back) == keys(local)
    assert torch.equal(back["active"], anchor["active"])
    for (k, a), b, an, d, e in zip(T.keystr_items(back), T.leaves(local),
                                   T.leaves(anchor), T.leaves(delta),
                                   T.leaves(error)):
        assert a.dtype == b.dtype, k
        # a - ((a - p + e) - e): four roundings, each at most half an ulp
        # of an operand no larger than the largest of |a|, |p|, |d|, |e|
        big = torch.stack([an.abs(), b.abs(), d.abs(), e.abs()]).amax(0)
        ulp = torch.from_numpy(np.spacing(big.numpy().astype(np.float32)))
        assert bool(((a - b).abs() <= 4 * ulp).all()), k


def test_state_placement_and_stage_rows():
    _, tcfg = _cfgs(5)
    pcfg = PP.PipelineConfig(n_stages=2, n_micro=2)
    gen = torch.Generator()
    gen.manual_seed(0)
    st = IE.init_train_state(tcfg, pcfg, gen, CPU)
    specs = IE.state_shardings(st)
    assert list(specs) == [k for k, _ in T.keystr_items(st)]
    for k, x in T.keystr_items(st):
        assert len(specs[k]) == x.dim(), k
        assert ("model" in specs[k]) == PP.is_stage_path(k), k
    one = IE.shard_train_state(st, 1, 2)
    for (k, x), full in zip(T.keystr_items(one), T.leaves(st)):
        want = full.narrow(0, 1, 1) if PP.is_stage_path(k) else full
        assert torch.equal(x, want), k
        assert x.data_ptr() != full.data_ptr(), k      # copies
    # the stage's rows of a state read from the JAX package's flat layout
    flat = ckpt.state_to_flat(st)
    back = IE.shard_train_state(ckpt.train_state_from_flat(
        flat, tcfg, pcfg, CPU), 1, 2)
    for k, v in ckpt.state_to_flat(back).items():
        want = flat[k][1:2] if PP.is_stage_path(k) else flat[k]
        np.testing.assert_array_equal(v, want, err_msg=k)


# ---------------------------------------------------------------------------
# the inner loop pieces
# ---------------------------------------------------------------------------

def _tiny(stages=2, layers=5, micro=4):
    _, tcfg = _cfgs(layers)
    pcfg = PP.PipelineConfig(n_stages=stages, n_micro=micro)
    gen = torch.Generator()
    gen.manual_seed(0)
    return tcfg, pcfg, PP.init_pp_params(tcfg, gen, pcfg, CPU)


def _batch_fn(c, i):
    rng = np.random.default_rng(1000 * c + i)
    return torch.from_numpy(rng.integers(0, VOCAB, (B, S)).astype(np.int32))


def test_pp_train_step_is_deterministic_and_keeps_the_mask():
    tcfg, pcfg, params = _tiny()
    step = IE.make_pp_train_step(tcfg, pcfg, inner_lr=1e-3)
    runs = []
    for _ in range(2):
        p = T.tree_map(torch.clone, params)
        o = adamw.init(p)
        for i in range(2):
            p, o, loss = step(p, o, _batch_fn(0, i))
        runs.append((ckpt.params_to_flat(p), float(loss)))
        assert torch.equal(p["active"], params["active"])
        assert not o.m["active"].any() and int(o.step) == 2
    assert runs[0][1] == runs[1][1]
    for k, v in runs[0][0].items():
        np.testing.assert_array_equal(v, runs[1][0][k], err_msg=k)


def test_pp_inner_fns_unroll_clusters():
    """``make_pp_inner_fns``: each cluster's rows are ``one_cluster`` run
    alone from the same params; ``inner_fn_h`` with h = H is ``inner_fn``
    and with h < H the first h steps."""
    tcfg, pcfg, params = _tiny()
    one, one_h = IE.make_pp_one_cluster(
        tcfg, pcfg, inner_lr=1e-3, h_steps=2,
        batch_fn=lambda c, t, i: _batch_fn(c + t, i))
    inner_fn, inner_fn_h = IE.make_pp_inner_fns(one, one_h, 2)
    opt_s = lambda: T.tree_map(lambda x: torch.stack([x, x.clone()]),
                               adamw.init(params))
    p_s, o_s, losses = inner_fn(params, opt_s(), 0)
    assert tuple(losses.shape) == (2, 2) and o_s.step.tolist() == [2, 2]
    for c in range(2):
        p = T.tree_map(torch.clone, params)
        p, _, lc = one(p, adamw.init(p), c, 0)
        assert torch.equal(lc, losses[c])
        for a, b in zip(T.leaves(p), T.leaves(p_s)):
            assert torch.equal(a, b[c])
    _, _, later = inner_fn(params, opt_s(), 1)     # the round reaches
    assert torch.equal(later[0], losses[1])          # batch_fn
    p_h, o_h, mean = inner_fn_h(params, opt_s(), 0, [2, 1])
    assert o_h.step.tolist() == [2, 1]
    assert float(mean[0]) == pytest.approx(float(losses[0].mean()))
    assert float(mean[1]) == float(losses[1][0])
    for a, b in zip(T.leaves(p_h), T.leaves(p_s)):
        assert torch.equal(a[0], b[0])


# ---------------------------------------------------------------------------
# the trainer's pp rounds against a JAX round
# ---------------------------------------------------------------------------

LR, H, C, ROUNDS = 1e-3, 3, 2, 2
BUDGET = lambda r: 0.5 * LR * (r + 1)


def _jax_rounds(jcfg, jparams, batches, h_by, rank):
    """Two JAX ``diloco_round``s whose clusters run JAX's sequential loss
    on the reshaped pp tree (``active``'s gradient zeroed and the mask
    carried, as ``make_pp_train_step``). States after each round."""
    def ref_loss(p, toks):
        sp = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:])
                          [:jcfg.n_layers], p["stages"])
        rp = {"embed": p["embed"], "final_norm": p["final_norm"],
              "segments": [sp]}
        if "head" in p:
            rp["head"] = p["head"]
        return JM.loss_fn(rp, jcfg, {"tokens": toks}, remat=False)[0]

    @jax.jit
    def step(p, o, toks):
        loss, g = jax.value_and_grad(ref_loss)(p, toks)
        g = dict(g)
        g["active"] = jnp.zeros_like(g["active"])
        p2, o = JA.update(g, o, p, lr=LR)
        p2 = dict(p2)
        p2["active"] = p["active"]
        return p2, o, loss

    uniform = all(h == H for h in h_by)

    def inner_fn(params, opt_s, t):
        r = int(t)
        outs = []
        for c in range(C):
            p, o, ls = params, JD.take_row(opt_s, c), []
            for h in range(h_by[c]):
                p, o, loss = step(p, o, jnp.asarray(batches[r, c, h]))
                ls.append(loss)
            outs.append((p, o, jnp.stack(ls) if uniform
                         else jnp.mean(jnp.stack(ls))))
        st = lambda i: jax.tree.map(lambda *x: jnp.stack(x),
                                    *[o[i] for o in outs])
        return st(0), st(1), st(2)

    comp = JC.LowRankQuant(rank=rank)
    # the same compressor, its roundtrip jitted (as the JAX trainer's
    # jitted round runs it)
    jcomp = type("Jitted", (), {"roundtrip": staticmethod(
        jax.jit(comp.roundtrip)), "__getattr__":
        lambda self, name: getattr(comp, name)})()
    opt0 = JA.init(jparams)
    state = JD.init_state(jparams, jax.tree.map(
        lambda x: jnp.broadcast_to(x, (C,) + x.shape).copy(), opt0), C,
        comp)
    rcfg = JD.RoundConfig(outer_lr=0.5, outer_momentum=0.7)
    states, losses = [], []
    for _ in range(ROUNDS):
        state, aux = JD.diloco_round(state, inner_fn, jcomp,
                                     lambda x: jax.tree.map(
                                         lambda a: a.mean(0), x), rcfg,
                                     jnp.asarray(rank, jnp.int32))
        states.append(jflatten({"params": state.params,
                                "delta_pending": state.delta_pending}))
        losses.append(float(jnp.mean(aux)))
    return states, losses, comp


@pytest.mark.parametrize("h_policy", ["global", "balance"])
def test_pp_trainer_rounds_match_jax_round(h_policy):
    jcfg, tcfg = _cfgs(5)
    jpcfg = JPP.PipelineConfig(n_stages=2, n_micro=4)
    pcfg = PP.PipelineConfig(n_stages=2, n_micro=4)
    jparams = JPP.init_pp_params(jcfg, jax.random.PRNGKey(0), jpcfg)
    tparams = ckpt.pp_params_from_flat(jflatten(jparams), tcfg, pcfg, CPU)
    initial = {k: v.copy() for k, v in ckpt.params_to_flat(tparams).items()}
    batches = np.random.default_rng(5).integers(
        0, VOCAB, (ROUNDS, C, H, B, S)).astype(np.int32)
    step_times = (1.0, 1.5) if h_policy == "balance" else None
    h_by = (H, H)
    if step_times:
        from repro.core import adaptive as JAd
        plan = JAd.plan_h(JAd.HSpec(policy="balance", h_min=1), H,
                          np.asarray(step_times), np.ones(C, bool))
        h_by = tuple(int(plan[c]) for c in range(C))
        assert h_by[1] < H
    rank = 8
    want, want_losses, jcomp = _jax_rounds(jcfg, jparams, batches, h_by,
                                           rank)
    comp_state = ckpt.tree_from_flat(
        jflatten(jcomp.init_state(jparams)),
        LowRankQuant(rank=rank).init_state(tparams))
    got = []

    def on_round(r, state):        # copies: the state is in place
        got.append({k: v.copy() for k, v in ckpt._flatten(
            {"params": state.params,
             "delta_pending": state.delta_pending}).items()})

    tt = TT.TrainConfig(n_clusters=C, local_batch=B, seq_len=S, inner_lr=LR,
                        h_steps=H, outer_lr=0.5, outer_momentum=0.7,
                        compressor_kw=dict(rank=rank, backend="pallas"),
                        inner_engine="pp", pp_stages=2, pp_micro=4,
                        h_policy=h_policy, step_times=step_times)
    res = TT.run_diloco_training(
        tcfg, tt, ROUNDS, device="cpu", params=tparams,
        comp_state=comp_state, on_round=on_round,
        batch_fn=lambda c, r, h: batches[r, c, h],
        eval_batch={"tokens": batches[0, 0, 0]})
    if h_policy == "balance":
        assert res.h_by_per_round == [h_by] * ROUNDS
    for r in range(ROUNDS):
        assert list(got[r]) == list(want[r])
        d = max(float(np.abs(got[r][k] - want[r][k]).max())
                for k in want[r])
        moved = max(float(np.abs(want[r][k]).max()) for k in want[r]
                    if k.startswith("['delta_pending']"))
        assert d < BUDGET(r), (r, d, BUDGET(r))
        assert d < 0.5 * moved, (r, d, moved)        # not vacuous
        assert abs(res.losses[r] - want_losses[r]) < 1e-2 * (r + 1)
    # the delay mode's round 0 applies Delta = 0: the params as they were
    for k, v in initial.items():
        np.testing.assert_array_equal(got[0]["['params']" + k], v,
                                      err_msg=k)
    assert all(np.isfinite(res.eval_losses))


def test_pp_inner_engine_refusals_in_the_trainer():
    with pytest.raises(ValueError, match="uniform decoder"):
        TT.run_diloco_training(get_config("gemma3-1b").reduced(),
                               TT.TrainConfig(inner_engine="pp"), 1,
                               device="cpu")
    with pytest.raises(ValueError, match="inner_engine"):
        TT.run_diloco_training(get_config("opt-1.3b").reduced(),
                               TT.TrainConfig(inner_engine="gpipe"), 1,
                               device="cpu")


# ---------------------------------------------------------------------------
# the driver: ranks against the in-process pipeline
# ---------------------------------------------------------------------------

DRIVER = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
          "--inner", "pp", "--rounds", "2", "--h-steps", "2",
          "--global-batch", "8", "--seq-len", "16", "--pp-micro", "2",
          "--cpu-threads", "1", "--join-timeout", "180"]
UNSTACKED = ("['outer']['anchor']", "['outer']['outer_opt']")


def _in_process(argv, clusters):
    states = []

    def on_round(r, params, opt, outer):     # copies: the state is in place
        states.append({k: v.copy() for k, v in ckpt._flatten(
            {"params": params, "opt": opt, "outer": outer._asdict()}).items()})

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        summary = TR.run(TR._parse_args(argv), CPU, clusters=clusters,
                         on_round=on_round)
    finally:
        torch.set_num_threads(threads)
    return summary, states


def test_pp_driver_ranks_equal_in_process_bitwise(tmp_path, capfd):
    """2 clusters x 2 stages on 4 gloo ranks: every rank's rows of the
    params, the AdamW state and the outer state (anchor, Nesterov
    momentum, pending deltas, EF buffers, warm starts) equal its cluster's
    and stage's rows of the in-process run, bit for bit, in both
    rounds."""
    out = tmp_path / "state"
    argv = DRIVER + ["--devices", "4", "--clusters", "2", "--data", "1",
                     "--pp-stages", "2"]
    summary = TR.main(argv + ["--state-out", str(out)],
                      store_dir=str(tmp_path))
    printed = capfd.readouterr().out
    assert "round 1: mean_loss=" in printed and \
        printed.rstrip().endswith("TRAIN-DRIVER-OK")
    ref_summary, want = _in_process(argv, [0, 1])
    assert summary["mean_loss"] == ref_summary["mean_loss"]
    assert len(want) == 2
    for r, ref in enumerate(want):
        for rank in range(4):
            c, s = divmod(rank, 2)
            with np.load(out / f"round_{r:04d}.rank{rank}.npz") as z:
                got = {k: z[k] for k in z.files}
            assert sorted(got) == sorted(ref)
            for key, arr in ref.items():
                unstacked = key.startswith(UNSTACKED)
                arr = arr if unstacked else arr[c:c + 1]
                if "['q_state']" not in key and PP.is_stage_path(key):
                    arr = np.take(arr, [s], axis=0 if unstacked else 1)
                np.testing.assert_array_equal(got[key], arr,
                                              err_msg=f"{r} {rank} {key}")


def test_pp_driver_one_device_and_its_checkpoint(tmp_path):
    """``--devices 1`` (a process group of size 1, one stage): finite
    losses, round 0 leaves the anchor, the checkpoint holds JAX's pp tree
    keys, cluster-stacked."""
    anchors = []
    argv = DRIVER + ["--devices", "1", "--clusters", "1", "--data", "1",
                     "--pp-stages", "1", "--rounds", "1", "--ckpt-dir",
                     str(tmp_path / "ck")]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        summary = TR.main(argv, store_dir=str(tmp_path),
                          on_round=lambda r, p, o, st: anchors.append(
                              ckpt.params_to_flat(st.anchor)))
    assert out.getvalue().rstrip().endswith("TRAIN-DRIVER-OK")
    assert np.isfinite(summary["mean_loss"]).all()
    tcfg = get_config("granite-3-8b").reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    init = ckpt.params_to_flat(PP.init_pp_params(
        tcfg, gen, PP.PipelineConfig(1, 2), CPU))
    for k, v in init.items():
        np.testing.assert_array_equal(anchors[0][k], v, err_msg=k)
    n = sum(v.size for v in init.values())
    assert summary["allreduce_bytes"] == [4 * n]
    jcfg = jax_get_config("granite-3-8b").reduced()
    jp = jax.eval_shape(lambda: JPP.init_pp_params(
        jcfg, jax.random.PRNGKey(0), JPP.PipelineConfig(1, 2)))
    want = {"['params']" + k: (1,) + v.shape for k, v in jflatten(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jp)).items()}
    with np.load(tmp_path / "ck" / "round_0000.npz") as z:
        assert {k: z[k].shape for k in z.files} == want


def test_pp_driver_refusals():
    base = DRIVER + ["--data", "1"]
    # --model keeps its default (2): --inner pp ignores it, as JAX's does
    TR._check_args(TR._parse_args(base + ["--devices", "4", "--clusters",
                                          "2", "--pp-stages", "2"]))
    with pytest.raises(SystemExit, match="static round schedule"):
        TR.main(base + ["--devices", "2", "--clusters", "1",
                        "--pp-stages", "2", "--adaptive"])
    with pytest.raises(SystemExit, match="static round schedule"):
        TR.main(base + ["--devices", "2", "--clusters", "1",
                        "--pp-stages", "2", "--h-policy", "balance"])
    # --ckpt-dir across ranks is no longer refused (the checkpoint is
    # gathered leaf by leaf: tests/test_torch_tensor_parallel.py)
    TR._check_args(TR._parse_args(base + ["--devices", "4", "--clusters",
                                          "2", "--pp-stages", "2",
                                          "--ckpt-dir", "x"]))
    with pytest.raises(AssertionError, match="pp-stages"):
        TR.main(base + ["--devices", "3", "--clusters", "2",
                        "--pp-stages", "2"])
    with pytest.raises(ValueError, match="microbatches"):
        TR.main(base + ["--devices", "2", "--clusters", "1", "--data", "2",
                        "--pp-stages", "1", "--pp-micro", "8"])
    with pytest.raises(ValueError, match="uniform decoder"):
        TR.main(["--arch", "gemma3-1b"] + base[2:] + [
            "--devices", "1", "--clusters", "1", "--pp-stages", "1"])


# ---------------------------------------------------------------------------
# the meta-device dry-run
# ---------------------------------------------------------------------------

def test_dryrun_qwen107b_matches_jax_eval_shape(capsys):
    """qwen1.5-107b at 8 stages with production dtypes: JAX's parameter
    count (80 slots of 1,358,970,880, embed and head 2,491,424,768, 80
    floats of ``active``) and every leaf's shape and dtype by keystr. The
    train step runs 2 microbatches of 2 rows (the CLI's default is 8 of
    2: the same shapes per stage, more of them)."""
    res = dryrun.pp_inner_smoke("qwen1.5-107b", n_stages=8, n_micro=2,
                                batch=4)
    assert res["status"] == "ok", res
    assert "PP-INNER-SMOKE-OK arch=qwen1.5-107b stages=8 " \
        "layers_per_stage=10" in capsys.readouterr().out
    jcfg = dataclasses.replace(jax_get_config("qwen1.5-107b"),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    jst = jax.eval_shape(lambda k: JIE.init_train_state(
        jcfg, JPP.PipelineConfig(n_stages=8, n_micro=8), k),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(jst)[0]}
    tcfg = dryrun.production_dtypes(get_config("qwen1.5-107b"))
    st = IE.init_train_state(tcfg, PP.PipelineConfig(8, 8), None, "meta")
    got = {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for k, x in T.keystr_items(st)}
    assert got == want
    n = sum(int(np.prod(s)) for k, (s, _) in want.items()
            if k.startswith(".params"))
    assert res["param_count"] == n == 111_209_095_248


def test_dryrun_cli(capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "gemma3-1b", "--inner", "pp"])
    assert "DRYRUN SUMMARY ok=0 skipped=0 not_ported=0 fail=1" in \
        capsys.readouterr().out
    dryrun.main(["--arch", "hundred-m", "--inner", "pp", "--pp-stages",
                 "4"])
    out = capsys.readouterr().out
    assert "PP-INNER-SMOKE-OK arch=hundred-m stages=4" in out
    assert "DRYRUN SUMMARY ok=1 skipped=0 not_ported=0 fail=0" in out
    # the JAX CLI's default, ported now: the mesh step's dry-run
    dryrun.main(["--arch", "hundred-m", "--no-outer"])
    out = capsys.readouterr().out
    assert "PP-INNER-SMOKE-OK" not in out and '"mode": "gspmd"' in out
    assert out.rstrip().endswith(
        "DRYRUN SUMMARY ok=1 skipped=0 not_ported=0 fail=0")


# ---------------------------------------------------------------------------
# the port's twin of JAX's differential harness (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_pp_engine_differential_vs_scalar():
    """``make_pp_one_cluster`` against the same AdamW steps through the
    port's sequential loss on the same tree and data, 3 rounds of H = 3:
    bitwise deterministic, within JAX's budget 0.5 lr (r + 1), losses
    within 1e-2 (r + 1), the budget under half the distance moved."""
    tcfg, pcfg, params0 = _tiny(2, 5, 4)

    def batch_fn(c, i):
        rng = np.random.default_rng(13 + 100 * c + i)
        return torch.from_numpy(rng.integers(0, VOCAB, (B, S))
                                .astype(np.int32))

    one, _ = IE.make_pp_one_cluster(tcfg, pcfg, inner_lr=LR, h_steps=3,
                                    batch_fn=lambda c, t, i: batch_fn(c, i))

    def ref_one(params, opt, c):
        losses = []
        for i in range(3):
            p = T.tree_map(lambda x: x.detach().requires_grad_(True), params)
            loss, _ = M.loss_fn(PP.sequential_params(p, tcfg), tcfg,
                                {"tokens": batch_fn(c, i)}, remat=False)
            g = torch.autograd.grad(loss, T.leaves(p), allow_unused=True)
            g = T.unflatten_like(p, [torch.zeros_like(x) if y is None else y
                                     for x, y in zip(T.leaves(p), g)])
            keep = {k: v for k, v in p.items() if k != "active"}
            adamw.update({k: v for k, v in g.items() if k != "active"},
                         adamw.AdamWState(opt.step, {k: v for k, v in
                                                     opt.m.items()
                                                     if k != "active"},
                                          {k: v for k, v in opt.v.items()
                                           if k != "active"}),
                         keep, lr=LR)
            opt = opt._replace(step=opt.step + 1)
            params = T.tree_map(lambda x: x.detach(), p)
            losses.append(float(loss))
        return params, opt, losses

    clone = lambda: T.tree_map(torch.clone, params0)
    pA, oA = clone(), adamw.init(params0)
    pB, oB = clone(), adamw.init(params0)
    p_pp, o_pp = clone(), adamw.init(params0)
    p_rf, o_rf = clone(), adamw.init(params0)
    flat0 = ckpt.params_to_flat(params0)
    for r in range(3):
        pA, oA, _ = one(pA, oA, r, 0)
        pB, oB, _ = one(pB, oB, r, 0)
        for a, b in zip(T.leaves(pA), T.leaves(pB)):
            assert torch.equal(a, b), f"pp nondeterministic @r{r}"
        p_pp, o_pp, l_pp = one(p_pp, o_pp, r, 0)
        p_rf, o_rf, l_rf = ref_one(p_rf, o_rf, r)
        fp, fr = ckpt.params_to_flat(p_pp), ckpt.params_to_flat(p_rf)
        d = max(float(np.abs(fp[k] - fr[k]).max()) for k in fr)
        moved = max(float(np.abs(fr[k] - flat0[k]).max()) for k in fr)
        dl = max(abs(float(a) - b) for a, b in zip(l_pp, l_rf))
        assert d < BUDGET(r), (r, d)
        assert dl < 1e-2 * (r + 1), (r, dl)
        assert d < 0.5 * moved, (r, d, moved)
