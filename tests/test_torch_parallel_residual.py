"""Port parity for stablelm-12b's parallel residual (``models/model.py::
add_residual``, the paged engine's ``unit_step``) and the paged kernels'
new shapes, on the CPU against the JAX package with weights carried by
the bridge.

Two configs: reduced stablelm-12b (LayerNorm, GELU MLP, parallel
residual; ``reduced()`` forces head dim 32) and the same with head dim
160, stablelm-12b's own, at S = 16, so that the JAX package takes its
einsum route. For each: logits, loss and grads (``tests/test_torch_train.py``'s
tolerances: logits rtol 1e-4 / atol 1e-5, loss rtol 1e-5, grads rtol
1e-4 / atol 1e-6), decode logits (``tests/test_torch_model.py``'s rtol
1e-4 / atol 1e-5), the paged engine's greedy tokens against the JAX
engine's, and paged ≡ dense greedy tokens bitwise within the port.

The paged kernels' chunk-and-merge recurrence
(``tests/test_torch_paged_split.py``'s emulation) and the port's plain
version at head dim 160 (stablelm-12b) and at G = 8 (qwen1.5-107b),
against JAX's ``ref_paged_attention`` (rtol 1e-5 / atol 1e-6) and its
Pallas kernel in interpret mode (the JAX gate, rtol 1e-3 / atol 1e-5);
and the plan, lanes and shared memory at phase 3a's full-size shapes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro.serve import attention_paged as jap
from repro.serve.engine import ServeEngine as JaxServeEngine
from _paged_fixture import paged_case, to_torch
from test_torch_paged_split import split_emulation
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.kernels import _plan
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.serve import attention_paged as ap
from repro_torch.serve.engine import ServeEngine

CPU = torch.device("cpu")
TOL_REF = dict(rtol=1e-5, atol=1e-6)
TOL_PALLAS = dict(rtol=1e-3, atol=1e-5)
VARIANTS = {"reduced": {}, "head_dim 160": {"head_dim": 160}}


def _carried(variant, seed=0):
    over = VARIANTS[variant]
    jcfg = dataclasses.replace(jax_get_config("stablelm-12b").reduced(),
                               **over)
    tcfg = dataclasses.replace(get_config("stablelm-12b").reduced(), **over)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, ckpt.params_from_flat(jflatten(jparams),
                                                       tcfg, CPU)


def test_reduced_stablelm_is_parallel_residual_with_gelu():
    _, tcfg, _, tparams = _carried("head_dim 160")
    assert tcfg.parallel_residual and tcfg.norm == "layernorm"
    assert tcfg.resolved_head_dim == 160
    unit = tparams["segments"][0]
    assert "ln2" in unit and "w_gate" not in unit["mlp"]
    assert unit["attn"]["wq"].shape[-1] == tcfg.n_heads * 160


def test_parallel_residual_reads_the_unit_input():
    """The FFN sees x, not x + a: the unit's output is x + a + f(x)."""
    _, tcfg, _, tparams = _carried("reduced")
    p = M.unit(tparams["segments"][0], 0)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, tcfg.d_model), generator=gen)
    a = torch.randn((2, 3, tcfg.d_model), generator=gen)
    got = M.add_residual(p, x, a, tcfg)
    assert torch.equal(got, x + a + M.apply_ffn_unit(p, x, tcfg))
    seq = dataclasses.replace(tcfg, parallel_residual=False)
    assert not torch.equal(got, M.add_residual(p, x, a, seq))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_loss_and_grads_match_jax(variant):
    jcfg, tcfg, jparams, tparams = _carried(variant)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    jlog, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tlog, _ = M.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-5)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jparams)
    leaves = T.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = M.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = jflatten(jg)
    got = ckpt.params_to_flat(T.unflatten_like(tparams, list(grads)))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_logits_match_jax(variant):
    jcfg, tcfg, jparams, tparams = _carried(variant)
    B, n_steps, s_max = 2, 6, 8
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                             (n_steps, B, 1)).astype(np.int32)
    jstate = JM.init_decode_state(jcfg, B, s_max)
    tstate = M.init_decode_state(tcfg, B, s_max, device=CPU)
    jstep = jax.jit(lambda p, s, t: JM.decode_step(p, jcfg, s, t))
    for t in range(n_steps):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(toks[t]))
        tl, tstate = M.decode_step(tparams, tcfg, tstate,
                                   torch.from_numpy(toks[t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {t}")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_paged_engine_matches_jax_engine(variant):
    """Staggered arrivals, a pool smaller than the load: the same greedy
    tokens and admission order as the JAX engine."""
    jcfg, tcfg, jparams, tparams = _carried(variant)
    rng = np.random.default_rng(5)
    reqs = [(0, rng.integers(0, tcfg.vocab_size, 3).tolist(), 5),
            (0, rng.integers(0, tcfg.vocab_size, 6).tolist(), 4),
            (2, rng.integers(0, tcfg.vocab_size, 4).tolist(), 5)]
    kw = dict(max_seqs=2, page_size=4, n_pages=5, max_pages_per_seq=3,
              eos_id=None)
    jeng = JaxServeEngine(jparams, jcfg, backend="ref", **kw)
    teng = ServeEngine(tparams, tcfg, device="cpu", **kw)
    for arrival, prompt, max_new in reqs:
        jeng.submit(prompt, max_new, arrival=arrival)
        teng.submit(prompt, max_new, arrival=arrival)
    jst, tst = jeng.run(), teng.run()
    assert tst["admission_fingerprint"] == jst["admission_fingerprint"]
    jdone = sorted(jeng.sched.done, key=lambda r: r.rid)
    tdone = sorted(teng.sched.done, key=lambda r: r.rid)
    for j, t in zip(jdone, tdone):
        assert t.generated == j.generated, f"rid {t.rid}"


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_paged_equals_dense_greedy(variant):
    """max_pages * page_size == s_max, slots in lockstep: the paged step
    is bitwise the dense decode step, so the greedy tokens are equal."""
    _, cfg, _, params = _carried(variant, seed=3)
    P, gen_len, ps, max_pages, B = 5, 7, 4, 3, 2
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P))
    state = M.init_decode_state(cfg, B, max_pages * ps, device=CPU)
    serve_step = steps.make_serve_step(cfg)
    toks = torch.from_numpy(prompts.astype(np.int32))
    for t in range(P):
        nxt, state = serve_step(params, state, toks[:, t:t + 1])
    dense = [nxt]
    for _ in range(gen_len - 1):
        nxt, state = serve_step(params, state, nxt)
        dense.append(nxt)
    dense = torch.cat(dense, dim=1).numpy()
    eng = ServeEngine(params, cfg, max_seqs=B, page_size=ps,
                      n_pages=B * max_pages, max_pages_per_seq=max_pages,
                      eos_id=None, device="cpu")
    for b in range(B):
        eng.submit(prompts[b].tolist(), gen_len, arrival=0)
    eng.run()
    done = sorted(eng.sched.done, key=lambda r: r.rid)
    for b in range(B):
        assert done[b].generated == dense[b].tolist(), b


# ---------------------------------------------------------------------------
# the paged kernels' recurrence at head dim 160 and at G = 8
# ---------------------------------------------------------------------------

# (KV, G, dh): stablelm-12b's group shape, and qwen1.5-107b's
SHAPES = {"stablelm-12b dh 160": (2, 4, 160), "qwen1.5-107b G 8": (1, 8, 128)}


def _case(name, ps, seed=0, P=6):
    """Lengths on 2-page chunk edges, page edges, the last position and
    one inactive slot."""
    KV, G, dh = SHAPES[name]
    C = 2 * ps
    lengths = [C - 1, C, C + 1, 2 * C, P * ps - 1, 3, 0]
    return paged_case(seed, lengths, P=P, ps=ps, KV=KV, G=G, dh=dh,
                      inactive=(len(lengths) - 1,))


def _jax(q, cache, table, lengths):
    return (jnp.asarray(q), {k: jnp.asarray(v) for k, v in cache.items()},
            jnp.asarray(table), jnp.asarray(lengths))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("ps", [2, 4, 16])
@pytest.mark.parametrize("name", list(SHAPES))
def test_paged_plain_and_split_emulation_match_jax(name, ps, window):
    """The port's plain version and the kernels' chunk-and-merge order at
    the plan's chunks and at chunks of 1 and 2 pages."""
    case = _case(name, ps, seed=ps)
    jcase = _jax(*case)
    want_ref = np.asarray(jax.jit(jap.ref_paged_attention,
                                  static_argnames="window")(*jcase,
                                                            window=window))
    want_pallas = np.asarray(jax.jit(jap.pallas_paged_attention,
                                     static_argnames="window")(
        *jcase, window=window))
    tcase = to_torch(*case)
    plain = ap.ref_paged_attention(*tcase, window=window).numpy()
    np.testing.assert_allclose(plain, want_ref, **TOL_REF)
    np.testing.assert_allclose(plain, want_pallas, **TOL_PALLAS)
    P, dh = case[2].shape[1], case[0].shape[3]
    for chunk_pages in (_plan.paged_plan(P, ps, dh)[0], 1, 2):
        got = split_emulation(*tcase, window=window,
                              chunk_pages=chunk_pages).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want_ref, **TOL_PALLAS)
        np.testing.assert_allclose(got, want_pallas, **TOL_PALLAS)


@pytest.mark.parametrize("name,P,want", [
    # phase 3a's new cases: the serve phase's lengths and 2,048 tokens
    ("stablelm-12b dh 160", 12, dict(pages=1, chunks=12, lanes=8,
                                     smem=31552)),
    ("stablelm-12b dh 160", 128, dict(pages=1, chunks=128, lanes=8,
                                      smem=31552)),
    ("qwen1.5-107b G 8", 12, dict(pages=2, chunks=6, lanes=4, smem=48256)),
    ("qwen1.5-107b G 8", 128, dict(pages=2, chunks=64, lanes=4,
                                   smem=48256))])
def test_paged_plan_at_the_new_full_size_shapes(name, P, want):
    """16-key pages. At dh 160 a chunk is one page (its K rows are 2,560
    floats of the 4,096 a chunk may hold), 8 lanes a key share the 40
    float4s evenly, and the merge grid is ceil(G dh / 128) = 5 blocks."""
    _, G, dh = SHAPES[name]
    ps = 16
    pages, chunks = _plan.paged_plan(P, ps, dh)
    lanes = _plan.paged_key_lanes(pages * ps, dh // 4)
    got = dict(pages=pages, chunks=chunks, lanes=lanes,
               smem=_plan.paged_smem_bytes(pages, ps, G, dh))
    assert got == want
    assert ap.smem_bytes(P, ps, G, dh) == want["smem"] <= ap.MAX_SMEM_BYTES
    assert (dh // 4) % lanes == 0
