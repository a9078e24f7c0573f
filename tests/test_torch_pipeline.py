"""Port parity for the pipeline (``repro_torch.parallel.pipeline``): the
GPipe loss and its gradients against the JAX package's sequential
``loss_fn`` on the same pp tree (reshaped, padded slots dropped: the
reference ``tests/test_pipeline.py`` builds as ``ref_loss_from_pp``), at
(stages, layers) in {(1, 3), (2, 5), (4, 6)}: pads 0, 1 and 2; the same
against the port's own sequential ``loss_fn``; the flash route inside the
stages; the bridge of the pp tree; ``layers_per_stage``; the placement
rule against JAX's ``pp_param_specs``.

Config: the JAX tests' reduced granite-3-8b at vocab 128, B 8, S 16, 4
microbatches; weights from JAX's ``init_pp_params`` carried over.

Tolerances: against JAX, JAX's own pp gate (``tests/test_pipeline.py``):
loss within 1e-4 and every gradient but ``active``'s within 1e-3
max-abs. Against the port's sequential model (the same arithmetic per
microbatch, other summation orders over microbatches and CE chunks):
loss within 1e-6 relative and gradients within 1e-6 max-abs (measured on
the CPU: 4e-7 and 5e-8 at worst).

The ``slow`` test runs JAX's ``make_pp_loss`` itself (the shard_map
pipeline on 8 faked devices, in a subprocess as its reference does). The
pipeline's tests on the card are in ``tests/test_torch_cuda.py`` (no
JAX there)."""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro.parallel import pipeline as JPP
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
from repro_torch.parallel import pipeline as PP

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
VOCAB, B, S, MICRO = 128, 8, 16, 4
CASES = [(1, 3), (2, 5), (4, 6)]
PORT_LOSS_RTOL, PORT_GRAD_ATOL = 1e-6, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: these shapes are tiny, and the suite's workers
    share the host's cores (several threads each stall in their barriers
    when the workers oversubscribe them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _carried(stages, layers, seed=0):
    over = dict(n_layers=layers, vocab_size=VOCAB)
    jcfg = dataclasses.replace(jax_get_config("granite-3-8b").reduced(),
                               **over)
    tcfg = dataclasses.replace(get_config("granite-3-8b").reduced(), **over)
    jparams = JPP.init_pp_params(jcfg, jax.random.PRNGKey(seed),
                                 JPP.PipelineConfig(n_stages=stages,
                                                    n_micro=MICRO))
    pcfg = PP.PipelineConfig(n_stages=stages, n_micro=MICRO)
    tparams = ckpt.pp_params_from_flat(jflatten(jparams), tcfg, pcfg, CPU)
    return jcfg, tcfg, pcfg, jparams, tparams


def _tokens(seed=1, seq=S):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, seq)).astype(
        np.int32)


def _jax_ref(jcfg, jparams, toks):
    """value_and_grad of JAX's sequential loss on the reshaped pp tree."""
    def ref_loss(p):
        sp = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:])
                          [:jcfg.n_layers], p["stages"])
        rp = {"embed": p["embed"], "final_norm": p["final_norm"],
              "segments": [sp]}
        if "head" in p:
            rp["head"] = p["head"]
        return JM.loss_fn(rp, jcfg, {"tokens": jnp.asarray(toks)},
                          remat=False)[0]
    loss, g = jax.jit(jax.value_and_grad(ref_loss))(jparams)
    return float(loss), jflatten(g)


def _port_seq(tcfg, tparams, toks):
    leaves = T.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = M.loss_fn(PP.sequential_params(tparams, tcfg), tcfg,
                            {"tokens": torch.from_numpy(toks)}, remat=False)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return float(loss.detach()), ckpt.params_to_flat(
        T.unflatten_like(tparams, grads))


def _worst(got, want):
    assert list(got) == list(want)
    return max(float(np.abs(got[k] - want[k]).max())
               for k in want if "active" not in k)


@pytest.mark.parametrize("stages,layers", CASES)
def test_pp_loss_and_grads_match_jax_sequential(stages, layers):
    jcfg, tcfg, pcfg, jparams, tparams = _carried(stages, layers)
    toks = _tokens()
    want_loss, want = _jax_ref(jcfg, jparams, toks)
    loss, grads = PP.make_pp_loss(tcfg, pcfg).value_and_grad(
        tparams, torch.from_numpy(toks))
    assert abs(float(loss) - want_loss) < 1e-4
    got = ckpt.params_to_flat(grads)
    assert _worst(got, want) < 1e-3
    assert not got["['active']"].any()


@pytest.mark.parametrize("stages,layers", CASES)
def test_pp_matches_port_sequential(stages, layers):
    _, tcfg, pcfg, _, tparams = _carried(stages, layers)
    toks = _tokens()
    want_loss, want = _port_seq(tcfg, tparams, toks)
    pp = PP.make_pp_loss(tcfg, pcfg)
    loss, grads = pp.value_and_grad(tparams, torch.from_numpy(toks))
    assert abs(float(loss) - want_loss) <= PORT_LOSS_RTOL * abs(want_loss)
    assert _worst(ckpt.params_to_flat(grads), want) <= PORT_GRAD_ATOL
    # the forward-only call gives the same loss as the gradient pass
    assert float(pp(tparams, torch.from_numpy(toks))) == float(loss)


def test_pp_flash_stages_match_jax_sequential(monkeypatch):
    """flash=True at S 128 (the route needs S % 128 == 0; on the CPU the
    flash Function runs the plain forward and backward): the stages'
    attention goes through ``flash_attention`` once per layer slot and
    microbatch in the forward and again in the backward's recompute."""
    from repro_torch.kernels import flash_attention as fa

    stages, layers = 2, 5
    jcfg, tcfg, pcfg, jparams, tparams = _carried(stages, layers)
    toks = _tokens(seq=128)
    want_loss, want = _jax_ref(jcfg, jparams, toks)
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    loss, grads = PP.make_pp_loss(tcfg, pcfg, flash=True).value_and_grad(
        tparams, torch.from_numpy(toks))
    slots = stages * PP.layers_per_stage(tcfg, pcfg)[0]
    assert len(calls) == 2 * MICRO * slots
    assert abs(float(loss) - want_loss) < 1e-4
    assert _worst(ckpt.params_to_flat(grads), want) < 1e-3


@pytest.mark.parametrize("stages,layers", [(2, 5), (4, 6)])
def test_pp_bridge_roundtrips_bytes(stages, layers):
    from repro.parallel import inner_engine as JIE
    from repro_torch.parallel import inner_engine as IE

    jcfg, tcfg, pcfg, jparams, tparams = _carried(stages, layers)
    flat = jflatten(jparams)
    back = ckpt.params_to_flat(tparams)
    assert list(back) == list(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        assert back[k].tobytes() == flat[k].tobytes(), k
    jstate = JIE.init_train_state(jcfg, JPP.PipelineConfig(stages, MICRO),
                                  jax.random.PRNGKey(3))
    flat = jflatten(jstate)
    state = ckpt.train_state_from_flat(flat, tcfg, pcfg, CPU)
    assert isinstance(state, IE.DiLoCoTrainState)
    back = ckpt.state_to_flat(state)
    assert list(back) == list(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        assert back[k].tobytes() == flat[k].tobytes(), k


@pytest.mark.parametrize("n_stages", range(1, 9))
def test_layers_per_stage_partitions_exactly(n_stages):
    """Over JAX's test ranges (n_layers 1..64, n_stages 1..8), and equal to
    the JAX function."""
    for n_layers in range(1, 65):
        cfg = dataclasses.replace(get_config("granite-3-8b").reduced(),
                                  n_layers=n_layers)
        pcfg = PP.PipelineConfig(n_stages=n_stages, n_micro=2)
        lps, pad = PP.layers_per_stage(cfg, pcfg)
        assert lps * n_stages - pad == n_layers
        assert 0 <= pad < n_stages and lps >= 1
        jcfg = dataclasses.replace(jax_get_config("granite-3-8b").reduced(),
                                   n_layers=n_layers)
        assert (lps, pad) == JPP.layers_per_stage(
            jcfg, JPP.PipelineConfig(n_stages=n_stages, n_micro=2))


@pytest.mark.parametrize("stacked", [False, True])
def test_placement_rule_matches_jax(stacked):
    jcfg, tcfg, pcfg, jparams, tparams = _carried(2, 5)
    if stacked:
        jparams = jax.tree.map(lambda x: x[None], jparams)
        tparams = T.tree_map(lambda x: x[None], tparams)
    want = jax.tree_util.tree_flatten_with_path(
        JPP.pp_param_specs(jparams, None, cluster_stacked=stacked),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    got = list(PP.pp_param_specs(tparams, cluster_stacked=stacked).items())
    assert [k for k, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (k, sp), (_, jsp) in zip(got, want):
        assert sp == tuple(jsp), k
    if stacked:
        return
    # a process holding stage 1 keeps its rows of the split leaves only
    rows = PP.stage_slice(tparams, 1, 2)
    for (k, x), full in zip(T.keystr_items(rows), T.leaves(tparams)):
        if PP.is_stage_path(k):
            assert x.shape[0] == 1 and torch.equal(x, full.narrow(0, 1, 1))
        else:
            assert x is full


@pytest.mark.parametrize("stages,layers", [(2, 5), (4, 6)])
def test_to_pp_params_and_back(stages, layers):
    _, tcfg, pcfg, _, tparams = _carried(stages, layers)
    seq = PP.sequential_params(tparams, tcfg)
    again = PP.to_pp_params(T.tree_map(torch.clone, seq), tcfg, pcfg)
    lps, pad = PP.layers_per_stage(tcfg, pcfg)
    assert torch.equal(again["active"], tparams["active"])
    for (k, a), b in zip(T.keystr_items(again), T.leaves(tparams)):
        assert a.shape == b.shape, k
        if "['stages']" in k:       # the padded slots are zero, not drawn
            a, b = (x.reshape((-1,) + tuple(x.shape[2:]))[:layers]
                    for x in (a, b))
        assert torch.equal(a, b), k


def test_pp_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="uniform decoder"):
        PP.init_pp_params(get_config("gemma3-1b").reduced(), None,
                          PP.PipelineConfig(2, 2), "meta")
    moe = dataclasses.replace(get_config("granite-3-8b").reduced(),
                              family="moe")
    with pytest.raises(ValueError, match="uniform decoder"):
        PP.make_pp_loss(moe, PP.PipelineConfig(2, 2))
    _, tcfg, pcfg, _, tparams = _carried(2, 5)
    with pytest.raises(ValueError, match="microbatches"):
        PP.make_pp_loss(tcfg, pcfg).value_and_grad(
            tparams, torch.zeros((6, S), dtype=torch.int32))


# ---------------------------------------------------------------------------
# against JAX's make_pp_loss itself (shard_map on faked devices): slow, as
# tests/test_pipeline.py
# ---------------------------------------------------------------------------

JAX_PP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, numpy as np
    from repro.checkpoint.checkpoint import _flatten
    from repro.configs.base import get_config
    from repro.parallel import pipeline as PP
    stages, layers, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    cfg = dataclasses.replace(get_config('granite-3-8b').reduced(),
                              n_layers=layers, vocab_size=128)
    pcfg = PP.PipelineConfig(n_stages=stages, n_micro=4)
    mesh = jax.make_mesh((1, 2, stages), ("clusters", "data", "model"))
    params = jax.tree.map(lambda x: x[None], PP.init_pp_params(
        cfg, jax.random.PRNGKey(0), pcfg))
    toks = np.load(out + ".tokens.npy")[None]
    loss_fn = PP.make_pp_loss(cfg, mesh, pcfg, cluster_stacked=True)
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params, toks)
    flat = _flatten(jax.tree.map(lambda x: x[0], g))
    np.savez(out, loss=np.float32(loss), **flat)
""")


@pytest.mark.slow
@pytest.mark.parametrize("stages,layers", CASES)
def test_pp_matches_jax_pipeline(tmp_path, stages, layers):
    """The port's pipeline against JAX's pipeline (``make_pp_loss`` on a
    (1, 2, stages) mesh: the batch split over 2 data devices), JAX's pp
    gate."""
    _, tcfg, pcfg, _, tparams = _carried(stages, layers)
    toks = _tokens()
    out = str(tmp_path / "jax_pp")
    np.save(out + ".tokens.npy", toks)
    r = subprocess.run([sys.executable, "-c", JAX_PP, str(stages),
                        str(layers), out], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ,
                                             PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    with np.load(out + ".npz") as z:
        want = {k: z[k] for k in z.files}
    want_loss = float(want.pop("loss"))
    loss, grads = PP.make_pp_loss(tcfg, pcfg).value_and_grad(
        tparams, torch.from_numpy(toks))
    assert abs(float(loss) - want_loss) < 1e-4
    assert _worst(ckpt.params_to_flat(grads), want) < 1e-3
