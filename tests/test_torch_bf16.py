"""The port in bfloat16 (``param_dtype = compute_dtype = "bfloat16"``, the
JAX dry-run's production dtypes) against the JAX package on the CPU,
reduced configs, weights carried by ``params_from_flat``, inputs drawn
with numpy.

Tolerances, and why:
- the optimizers and the pseudo-gradient: bit for bit. Both sides take the
  same f32 operations and round once to bf16; the clip's norm is exact
  here (gradients are small multiples of 2^-6, so every partial sum of
  their squares is exact in f32 and the order of the sum cannot show);
- loss rtol 1e-3 and each gradient leaf within 2e-2 of its norm: bf16
  rounds at other places in the two frameworks (a product's output, a
  norm's upcast), each a relative 2^-8, over a few layers. Each side's
  bf16 gradients are 1.1-1.4 % (relative norm, worst leaf) from the f32
  gradients of the same weights, and the two sides 1.2-1.3 % apart;
- the plain flash forward against the Pallas kernel: the JAX bf16 gate
  2e-2 (tests/test_kernels.py:103-113); its gradient against ``jax.grad``
  of the JAX reference: rtol/atol 2e-2 (both f32 inside, bf16 out: one
  rounding of each output apart);
- the plain paged attention against the Pallas kernel: rtol/atol 2e-2;
- two DiLoCoX rounds: losses rtol 2e-3, wire bytes equal (the int4
  payload's size does not depend on the param dtype);
- the paged engine against JAX's: the admission fingerprint equal; the
  greedy tokens equal up to the first step whose top-two logits, in
  JAX's own teacher-forced forward, lie less than ``TOKEN_ULPS`` = 3 bf16
  ulps of the top logit apart: the port's bf16 logits are up to 1.5 ulps
  from JAX's, so a pair closer than 3 may swap (granite-3-8b's request 0
  starts with an exact tie);
- paged against dense within the port, and gloo ranks against the
  in-process run: bit for bit.
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
from repro.core import compression as JC
from repro.core import diloco as JD
from repro.data import synthetic as JS
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import nesterov as jnesterov
from repro.serve import attention_paged as jap
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train import trainer as JT
from _paged_fixture import paged_fixture, to_torch
from test_torch_train import B, S, VOCAB, _eval_batch, _jax_batches
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config, with_dtype
from repro_torch.core import diloco
from repro_torch.core.compression import LowRankQuant
from repro_torch.kernels import ref
from repro_torch.launch import serve as SV
from repro_torch.launch import train as TR
from repro_torch.models import model as M
from repro_torch.optim import adamw, nesterov
from repro_torch.serve import attention_paged as ap
from repro_torch.serve.engine import ServeEngine, kv_pool_bytes
from test_torch_serve import dense_greedy

CPU = torch.device("cpu")
BF = jnp.bfloat16
TOKEN_ULPS = 3


def _bf16(arch, **over):
    return (dataclasses.replace(jax_get_config(arch).reduced(),
                                param_dtype="bfloat16",
                                compute_dtype="bfloat16", **over),
            dataclasses.replace(with_dtype(get_config(arch).reduced(),
                                           "bfloat16"), **over))


def _carried(arch, seed=0, **over):
    jcfg, tcfg = _bf16(arch, **over)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, ckpt.params_from_flat(jflatten(jparams),
                                                      tcfg, CPU)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _j(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the four repairs: one rounding in both optimizers, an f32 pseudo-gradient
# ---------------------------------------------------------------------------

def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((256, 256)).astype(np.float32)
    g = (rng.integers(-8, 9, (256, 256)) * 2.0 ** -6).astype(np.float32)
    b = rng.standard_normal((256,)).astype(np.float32)
    gb = (rng.integers(-8, 9, (256,)) * 2.0 ** -6).astype(np.float32)
    return {"w": p, "b": b}, {"w": g, "b": gb}


@pytest.mark.parametrize("grad_clip", [1.0, 0.0], ids=["clip", "no-clip"])
def test_adamw_bf16_matches_jax_bitwise(grad_clip):
    """One AdamW step on bf16 leaves, lr 1e-3: JAX clips into f32 (bf16 x
    the f32 scale promotes) and rounds p - lr delta once; so does the
    port. The parent tree rounded the update to bf16 and again after the
    subtraction (110 of the (256, 256) leaf's 65,536 elements one ulp
    apart) and clipped in bf16."""
    p, g = _opt_inputs()
    jp = {k: jnp.asarray(v).astype(BF) for k, v in p.items()}
    jg = {k: jnp.asarray(v).astype(BF) for k, v in g.items()}
    jp2, jst = jadamw.update(jg, jadamw.init(jp), jp, lr=1e-3,
                             grad_clip=grad_clip)
    tp = {k: _t(v) for k, v in p.items()}
    tp2, tst = adamw.update({k: _t(v) for k, v in g.items()},
                            adamw.init(tp), tp, lr=1e-3, grad_clip=grad_clip)
    for k in p:
        assert tp2[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp2[k].float().numpy(), _j(jp2[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(tst.m[k].numpy(), np.asarray(jst.m[k]))
        np.testing.assert_array_equal(tst.v[k].numpy(), np.asarray(jst.v[k]))


def test_nesterov_bf16_matches_jax_bitwise():
    """One outer step at the defaults (lr 0.7, momentum 0.9) on a bf16
    leaf with an f32 pseudo-gradient; the parent tree's double rounding
    left 1,435 of 65,536 elements apart."""
    p, _ = _opt_inputs(1)
    d = (np.random.default_rng(2).standard_normal((256, 256)) * 0.01
         ).astype(np.float32)
    jp = {"w": jnp.asarray(p["w"]).astype(BF)}
    jp2, jst = jnesterov.update({"w": jnp.asarray(d)}, jnesterov.init(jp), jp)
    tp = {"w": _t(p["w"])}
    tp2, tst = nesterov.update({"w": torch.from_numpy(d)}, nesterov.init(tp),
                               tp)
    np.testing.assert_array_equal(tp2["w"].float().numpy(), _j(jp2["w"]))
    np.testing.assert_array_equal(tst.momentum["w"].numpy(),
                                  np.asarray(jst.momentum["w"]))


def test_pseudo_grad_bf16_is_f32_and_matches_jax_bitwise():
    """delta = (anchor - local) + e over bf16 params and an f32 error is
    f32 (JAX's ``_pseudo_grad``), written into the f32 buffer given; the
    parent tree wrote it over the bf16 local params and rounded e into
    it."""
    rng = np.random.default_rng(3)
    anchor = rng.standard_normal((64, 32)).astype(np.float32)
    local = anchor[None] + rng.standard_normal((2, 64, 32)).astype(
        np.float32) * 4e-3
    e = (rng.standard_normal((2, 64, 32)) * 1e-5).astype(np.float32)
    want = JD._pseudo_grad({"w": jnp.asarray(anchor).astype(BF)},
                           {"w": jnp.asarray(local).astype(BF)},
                           {"w": jnp.asarray(e)}, False)["w"]
    out = {"w": torch.full((2, 64, 32), float("nan"))}
    loc = {"w": torch.from_numpy(local).bfloat16()}
    got = diloco._pseudo_grad({"w": _t(anchor)}, loc,
                              {"w": torch.from_numpy(e)}, False, out)
    assert got["w"] is out["w"] and got["w"].dtype == torch.float32
    assert loc["w"].dtype == torch.bfloat16            # left as it was
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want))


def test_f32_optimizers_and_pseudo_grad_keep_their_bits():
    """In float32 the repaired forms are the in-place ones bit for bit:
    p.sub_(lr delta), g.mul_(scale) and (anchor - local) + e written over
    the local params."""
    p, g = _opt_inputs(4)
    g = {k: v * 64 for k, v in g.items()}                # the clip engages
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    got, st = adamw.update(tg, adamw.init(tp), tp, lr=1e-3)
    ref_p = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ref_g = [torch.from_numpy(g[k].copy()) for k in sorted(g)]
    sq = None
    for x in ref_g:
        s = torch.sum(torch.square(x))
        sq = s if sq is None else sq + s
    scale = torch.clamp(1.0 / torch.sqrt(sq + 1e-16), max=1.0)
    for k, x in zip(sorted(g), ref_g):
        x.mul_(scale)
        m = (1 - 0.9) * x
        v = (1 - 0.95) * torch.square(x)
        b1t = 1.0 - torch.pow(torch.tensor(0.9), torch.tensor(1.0))
        b2t = 1.0 - torch.pow(torch.tensor(0.95), torch.tensor(1.0))
        delta = (m / b1t) / (torch.sqrt(v / b2t) + 1e-8)
        delta.add_(0.1 * ref_p[k])
        ref_p[k].sub_(1e-3 * delta)
        assert torch.equal(got[k], ref_p[k]), k
    w = torch.from_numpy(p["w"].copy())
    d = torch.from_numpy(g["w"] * 1e-3)
    v = torch.zeros_like(w)
    nesterov.update_leaf(d, v, w)
    want = torch.from_numpy(p["w"].copy())
    want.sub_(0.7 * (0.9 * d + d))
    assert torch.equal(w, want)
    local = {"w": torch.from_numpy(np.stack([p["w"], p["w"] * 0.5]))}
    e = {"w": torch.full((2, 256, 256), 1e-3)}
    out = {"w": torch.empty((2, 256, 256))}
    diloco._pseudo_grad({"w": torch.from_numpy(p["w"])}, local, e, False,
                        out)
    want = torch.from_numpy(p["w"])[None] - local["w"]
    assert torch.equal(out["w"], want.add_(e["w"]))


# ---------------------------------------------------------------------------
# the model: loss and grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["opt-1.3b", "granite-3-8b"])
def test_loss_and_grads_bf16_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _carried(arch)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jparams)
    leaves = T.leaves(tparams)
    for p in leaves:
        assert p.dtype == torch.bfloat16
        p.requires_grad_(True)
    loss, _ = M.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    want = jflatten(jg)
    got = ckpt.params_to_flat(T.unflatten_like(tparams, list(grads)))
    assert list(got) == list(want)
    for k in want:
        w, g = want[k].astype(np.float64), got[k].astype(np.float64)
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w) + 1e-6, k


# ---------------------------------------------------------------------------
# the kernels' plain versions in bf16
# ---------------------------------------------------------------------------

def test_plain_flash_bf16_matches_pallas_and_jax_grad():
    """At tests/test_kernels.py::test_flash_attention_dtypes's shape: the
    plain forward (what the bf16 kernel is held to on the card) returns
    bf16 and is within the JAX bf16 gate of the Pallas kernel (interpret
    mode); the plain backward within 2e-2 of ``jax.grad`` of the JAX
    reference in bf16."""
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((1, 256, 2, 64), (1, 256, 2, 64), (1, 256, 2, 64),
                    (1, 256, 2, 64)))
    jq, jk, jv, jdo = (jnp.asarray(a).astype(BF) for a in (q, k, v, do))
    want = flash_attention_pallas(jq, jk, jv, bq=128, bk=128)
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention_fwd_ref(tq, tk, tv, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), _j(want), rtol=2e-2,
                               atol=2e-2)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c),
                     jq, jk, jv)
    jgrads = vjp(jdo)
    grads = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, True)
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), _j(w), rtol=2e-2,
                                   atol=2e-2, err_msg=name)


@pytest.mark.parametrize("window", [0, 5])
def test_plain_paged_bf16_matches_pallas(window):
    """``ref_paged_attention`` over a bf16 q and pool (f32 inside, bf16
    out) against the JAX Pallas kernel (interpret) on the same bf16
    inputs, at tests/test_kernels.py's fixture."""
    q, cache, table, lengths = paged_fixture(4, S=3, P=4, ps=4, KV=2, G=2,
                                             dh=16)
    jq = jnp.asarray(q).astype(BF)
    jcache = {n: jnp.asarray(c).astype(BF) for n, c in cache.items()}
    want = jap.paged_attention(jq, jcache, jnp.asarray(table),
                               jnp.asarray(lengths), window=window,
                               backend="pallas")
    tq, tcache, ttable, tlen = to_torch(q, cache, table, lengths)
    got = ap.paged_attention(tq.bfloat16(),
                             {n: c.bfloat16() for n, c in tcache.items()},
                             ttable, tlen, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _j(want), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_run_diloco_training_bf16_matches_jax():
    """Two DiLoCoX rounds (2 clusters, H 2, low-rank + int4 with the delay
    and EF) of bf16 opt-1.3b against the JAX trainer on JAX-drawn params,
    batches and warm starts."""
    jcfg, tcfg, jparams, tparams = _carried("opt-1.3b", vocab_size=VOCAB)
    kw = dict(n_clusters=2, local_batch=B, seq_len=S, inner_lr=3e-3,
              h_steps=2, outer_lr=0.5, outer_momentum=0.7)
    jt = JT.TrainConfig(**kw, compressor_kw=dict(rank=8))
    want = JT.run_diloco_training(jcfg, jt, 2)
    comp_state = ckpt.tree_from_flat(
        jflatten(JC.LowRankQuant(rank=8).init_state(jparams)),
        LowRankQuant(rank=8).init_state(tparams))
    table = JS.SyntheticLM(VOCAB, S, B, seed=0).table
    got = TT_run(tcfg, kw, tparams, comp_state, _jax_batches(jt, table),
                 _eval_batch(jt))
    assert all(p.dtype == torch.bfloat16 for p in T.leaves(tparams))
    np.testing.assert_allclose(got.losses, want.losses, rtol=2e-3)
    np.testing.assert_allclose(got.eval_losses, want.eval_losses, rtol=2e-3)
    assert got.wire_bytes_per_round == want.wire_bytes_per_round


def TT_run(tcfg, kw, params, comp_state, batch_fn, eval_batch):
    from repro_torch.train import trainer as TT

    return TT.run_diloco_training(
        tcfg, TT.TrainConfig(**kw, compressor_kw=dict(rank=8,
                                                      backend="pallas")),
        2, device="cpu", params=params, comp_state=comp_state,
        batch_fn=batch_fn, eval_batch=eval_batch)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _tokens_before_near_tie(jcfg, jparams, prompt, generated):
    """How many of ``generated`` JAX's greedy decode fixes: the steps
    before the first whose top-two logits in JAX's teacher-forced forward
    over prompt + generated (whose argmax is the engine's token) lie less
    than TOKEN_ULPS bf16 ulps of the top logit apart."""
    seq = np.asarray(prompt + generated[:-1], np.int32)[None]
    logits, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(seq)})
    lg = np.asarray(logits[0].astype(jnp.float32))[len(prompt) - 1:]
    assert lg.argmax(-1).tolist() == generated
    top2 = np.sort(lg, axis=-1)[:, -2:]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[:, 1]))) - 7)
    close = np.nonzero(top2[:, 1] - top2[:, 0] < TOKEN_ULPS * ulp)[0]
    return int(close[0]) if len(close) else len(generated)


@pytest.mark.parametrize("arch", ["opt-1.3b", "granite-3-8b"])
def test_paged_engine_bf16_matches_jax_engine(arch):
    """``test_torch_serve.py::test_paged_engine_matches_jax_engine``'s
    traffic in bf16: the same admission order, and the same greedy tokens
    up to each request's first bf16 near-tie in JAX's logits."""
    jcfg, tcfg, jparams, tparams = _carried(arch)
    rng = np.random.default_rng(5)
    reqs = [(0, rng.integers(0, tcfg.vocab_size, 3).tolist(), 5),
            (0, rng.integers(0, tcfg.vocab_size, 6).tolist(), 4),
            (2, rng.integers(0, tcfg.vocab_size, 4).tolist(), 5),
            (3, rng.integers(0, tcfg.vocab_size, 2).tolist(), 6)]
    kw = dict(max_seqs=2, page_size=4, n_pages=5, max_pages_per_seq=3,
              eos_id=None)
    jeng = JaxServeEngine(jparams, jcfg, backend="ref", **kw)
    teng = ServeEngine(tparams, tcfg, device="cpu", **kw)
    for arrival, prompt, max_new in reqs:
        jeng.submit(prompt, max_new, arrival=arrival)
        teng.submit(prompt, max_new, arrival=arrival)
    jst, tst = jeng.run(), teng.run()
    assert tst["requests_done"] == len(reqs)
    assert tst["admission_fingerprint"] == jst["admission_fingerprint"]
    compared = 0
    for j, t in zip(sorted(jeng.sched.done, key=lambda r: r.rid),
                    sorted(teng.sched.done, key=lambda r: r.rid)):
        n = _tokens_before_near_tie(jcfg, jparams, j.prompt, j.generated)
        assert t.generated[:n] == j.generated[:n], f"rid {t.rid}"
        compared += n
    assert compared >= len(reqs)


@pytest.mark.parametrize("arch", ["granite-3-8b", "opt-1.3b"])
def test_paged_equals_dense_bf16(arch):
    """bf16 weights and KV pool: the port's paged engine (plain attention
    on the CPU) is bit for bit its dense decode loop."""
    cfg = with_dtype(get_config(arch).reduced(), "bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = M.init_params(cfg, gen, CPU)
    P, G, ps, maxP, Bn = 5, 7, 4, 3, 2
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (Bn, P))
    dense = dense_greedy(cfg, params, prompts, G, s_max=maxP * ps)
    eng = ServeEngine(params, cfg, max_seqs=Bn, page_size=ps,
                      n_pages=Bn * maxP, max_pages_per_seq=maxP,
                      eos_id=None, device="cpu")
    for b in range(Bn):
        eng.submit(prompts[b].tolist(), G, arrival=0)
    eng.run()
    done = sorted(eng.sched.done, key=lambda r: r.rid)
    for b in range(Bn):
        assert done[b].generated == dense[b].tolist(), b


def test_kv_pool_in_param_dtype_halves():
    cfg = get_config("opt-1.3b")
    f32 = kv_pool_bytes(cfg, n_pages=64, page_size=16)
    bf = kv_pool_bytes(with_dtype(cfg, "bfloat16"), n_pages=64, page_size=16)
    assert 2 * bf == f32


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

MESH = ["--smoke", "--device", "cpu", "--dtype", "bfloat16", "--rounds",
        "2", "--h-steps", "2", "--seq-len", "16", "--cpu-threads", "1",
        "--join-timeout", "180"]


def test_dtype_flag_defaults_to_float32():
    for mod in (TR, SV):
        assert mod._parse_args([]).dtype == "float32"
        cfg = mod._model_config(mod._parse_args(["--arch", "opt-1.3b",
                                                 "--dtype", "bfloat16"]))
        assert (cfg.param_dtype, cfg.compute_dtype) == ("bfloat16",
                                                        "bfloat16")
    assert TR._model_config(TR._parse_args(["--arch", "opt-1.3b"])) == \
        get_config("opt-1.3b")


def _in_process_states(argv):
    states = []

    def on_round(r, params, opt, outer):
        states.append({k: v.copy() for k, v in ckpt._flatten(
            {"params": params, "opt": opt, "outer": outer._asdict()}).items()})

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = TR._parse_args(argv)
        TR.run(args, CPU, clusters=list(range(args.clusters)),
               on_round=on_round)
    finally:
        torch.set_num_threads(threads)
    return states


def test_train_driver_bf16_two_ranks_equal_in_process_bitwise(tmp_path,
                                                               capfd):
    """``--dtype bfloat16 --smoke --device cpu``, 2 clusters on 2 gloo
    ranks: TRAIN-DRIVER-OK, bf16 params, f32 optimizer and outer state,
    and every rank's state after each round bit for bit the in-process
    run's rows."""
    argv = MESH + ["--arch", "granite-3-8b", "--devices", "2", "--clusters",
                   "2", "--data", "1", "--model", "1", "--global-batch", "4"]
    TR.main(argv + ["--state-out", str(tmp_path / "st")],
            store_dir=str(tmp_path))
    assert capfd.readouterr().out.rstrip().endswith("TRAIN-DRIVER-OK")
    want = _in_process_states(argv)
    assert want[0]["['params']['embed']"].dtype == np.float32   # saved f32
    for r, flat in enumerate(want):
        ranks = [np.load(tmp_path / "st" / f"round_{r:04d}.rank{k}.npz")
                 for k in range(2)]
        for key, arr in flat.items():
            if key.startswith(("['outer']['anchor']",
                               "['outer']['outer_opt']")):
                got = ranks[0][key]
            else:
                got = np.concatenate([ranks[0][key], ranks[1][key]])
            np.testing.assert_array_equal(got, arr, err_msg=f"{r} {key}")


@pytest.mark.parametrize("extra", [
    ["--devices", "2", "--clusters", "1", "--data", "1", "--model", "2",
     "--global-batch", "4"],
    ["--inner", "pp", "--devices", "2", "--clusters", "1", "--data", "1",
     "--pp-stages", "2", "--pp-micro", "2", "--global-batch", "4"]],
    ids=["model2", "pp"])
def test_train_driver_bf16_tp_and_pp_ranks_equal_in_process(tmp_path, extra):
    """``--data 1 --model 2`` and ``--inner pp`` in bf16: the ranks'
    checkpoints byte for byte those of the in-process run."""
    argv = MESH + ["--arch", "granite-3-8b"] + extra
    TR.main(argv + ["--ckpt-dir", str(tmp_path / "ranks")],
            store_dir=str(tmp_path))
    _in_process_states(argv + ["--ckpt-dir", str(tmp_path / "one")])
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "ranks")) and names
    for name in names:
        assert (tmp_path / "ranks" / name).read_bytes() == \
            (tmp_path / "one" / name).read_bytes(), name


def test_serve_driver_bf16_smoke(capfd):
    SV.main(["--arch", "granite-3-8b", "--smoke", "--paged", "--device",
             "cpu", "--dtype", "bfloat16", "--batch", "2", "--prompt-len",
             "4", "--gen-len", "4", "--cpu-threads", "1"])
    out = capfd.readouterr().out
    assert out.rstrip().endswith("SERVE-DRIVER-OK")


def test_checkpoint_bf16_roundtrip(tmp_path):
    """bf16 leaves are written as f32 (as the JAX package writes them) and
    read back to bf16 bit for bit."""
    cfg = with_dtype(get_config("granite-3-8b").reduced(), "bfloat16")
    gen = torch.Generator()
    gen.manual_seed(3)
    params = M.init_params(cfg, gen, CPU)
    ckpt.save(str(tmp_path / "c"), params, step=7)
    with np.load(tmp_path / "c.npz") as z:
        assert all(z[k].dtype == np.float32 for k in z.files)
    back, step = ckpt.restore(str(tmp_path / "c"),
                              M.init_params(cfg, device="meta"), device=CPU)
    assert step == 7
    for (k, a), (_, b) in zip(T.keystr_items(params), T.keystr_items(back)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), k
