"""Port parity for flash attention (``repro_torch.kernels.flash_attention``)
on the CPU, where ``FlashAttention`` runs its plain forward and backward:

- the port's ``flash_attention_ref`` against JAX ``ref.flash_attention_ref``;
- the Function's forward against the JAX Pallas kernel in interpret mode,
  as tests/test_kernels.py runs it (atol 1e-5: the two are different f32
  summation orders of the same softmax; they differ by ~5e-7 here);
- its backward (dq, dk, dv) against ``jax.grad`` of the JAX ref, rtol/atol
  1e-4 (f32 on both sides, other summation orders), and ``gradcheck`` in
  float64;
- S = 384, where the JAX Pallas kernel raises, against JAX's einsum
  ``grouped_attend``;
- the route in ``grouped_attend`` (the JAX condition, flash=True in place
  of REPRO_USE_PALLAS=1), the model's ``loss_fn(flash=True)`` loss and
  grads against JAX's at S = 128 (rtol 1e-5 / 1e-4, as
  tests/test_torch_train.py), a trainer round with flash on against off
  (rtol 1e-4), and ``quickstart --flash``.

Inputs come from numpy seeds and cross as numpy arrays.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.configs.base import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.train import trainer as TT

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
HEADS = [(4, 4), (4, 2), (4, 1)]          # MHA, GQA 2:1, MQA


def _qkv(seed, B, Sq, H, KV, d, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.standard_normal((B, Sq, H, d)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, d)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, d)).astype(np.float32))


def _t(*arrays, requires_grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(requires_grad)
            for a in arrays]


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts calls of the flash forward's plain version (what a CPU
    tensor runs in place of the kernel)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ref.flash_attention_fwd_ref, ref.flash_attention_bwd_ref

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(ref, "flash_attention_fwd_ref", count_fwd)
    monkeypatch.setattr(ref, "flash_attention_bwd_ref", count_bwd)
    return calls


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", HEADS)
def test_flash_ref_matches_jax_ref(H, KV, causal):
    q, k, v = _qkv(0, 2, 256, H, KV, 32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    got = ref.flash_attention_ref(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_flash_ref_matches_jax_ref_sq_ne_sk():
    """Sq != Sk: both mask top-left (key j seen by query i iff j <= i)."""
    q, k, v = _qkv(1, 1, 96, 4, 2, 32, Sk=160)
    for causal in (True, False):
        want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal)
        got = ref.flash_attention_ref(*_t(q, k, v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1)])
def test_flash_function_matches_pallas_interpret(H, KV, causal):
    q, k, v = _qkv(2, 2, 256, H, KV, 32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, bq=128,
                                  bk=128)
    got = fa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_flash_fwd_ref_lse_is_the_row_logsumexp():
    q, k, v = _qkv(3, 1, 64, 4, 2, 32)
    o, lse = ref.flash_attention_fwd_ref(*_t(q, k, v))
    np.testing.assert_allclose(o.numpy(),
                               ref.flash_attention_ref(*_t(q, k, v)).numpy(),
                               rtol=1e-5, atol=1e-6)
    s = q.reshape(1, 64, 2, 2, 32).transpose(0, 2, 3, 1, 4) \
        @ k.transpose(0, 2, 3, 1)[:, :, None] / np.sqrt(32)
    s = np.where(np.tril(np.ones((64, 64), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want.reshape(1, 4, 64),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", HEADS)
def test_flash_backward_matches_jax_grad(H, KV, causal):
    q, k, v = _qkv(4, 2, 128, H, KV, 32)
    do = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        o = jref.flash_attention_ref(q_, k_, v_, causal=causal)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    tq, tk, tv = _t(q, k, v, requires_grad=True)
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("Sq,Sk,causal", [(6, 6, True), (5, 7, True),
                                          (6, 4, False)])
def test_flash_backward_gradcheck_float64(Sq, Sk, causal):
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, Sq, 4, 3))).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((1, Sk, 2, 3))).requires_grad_()
    v = torch.from_numpy(rng.standard_normal((1, Sk, 2, 3))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, causal=causal),
        (q, k, v))


def test_flash_s384_matches_jax_einsum_grouped_attend(flash_calls):
    """S = 384: the JAX Pallas kernel asserts S % 256 == 0 and raises; the
    port's route (kernels on the card, the plain version here) takes it.
    Forward and grads against the JAX einsum path."""
    q, k, v = _qkv(7, 1, 384, 4, 2, 32)
    do = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    with pytest.raises(AssertionError):
        flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), bq=256, bk=256)
    pos = jnp.arange(384, dtype=jnp.int32)[None]
    bias = JA._mask_bias(pos, pos, causal=True, window=0)

    def jout(q_, k_, v_):
        return JA.grouped_attend(q_, k_, v_, bias)

    want, vjp = jax.vjp(jout, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, k, v, requires_grad=True)
    tpos = torch.arange(384, dtype=torch.int32)[None]
    tbias = A._mask_bias(tpos, tpos, causal=True, window=0)
    o = A.grouped_attend(tq, tk, tv, tbias, plain_causal=True, flash=True)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{name}")
    assert flash_calls == {"fwd": 1, "bwd": 1}


@pytest.mark.parametrize("S,window,flash,routed", [
    (64, 0, True, False),       # Sq % 128 != 0: einsum
    (128, 0, True, True),       # the flash route
    (256, 0, True, True),
    (128, 0, False, False),     # flash off: einsum, as the JAX default
    (128, 16, True, False),     # sliding window: not plain causal
])
def test_grouped_attend_route(flash_calls, S, window, flash, routed):
    x = np.random.default_rng(9).standard_normal((1, S, 32)).astype(
        np.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = A.init_gqa(gen, 32, 4, 2, 32)
    pos = torch.arange(S, dtype=torch.int32)[None]
    kw = dict(n_heads=4, n_kv=2, head_dim=32, rope_theta=1e4)
    got = A.apply_gqa(p, torch.from_numpy(x), pos, window=window,
                      flash=flash, **kw)
    assert flash_calls["fwd"] == int(routed)
    want = A.apply_gqa(p, torch.from_numpy(x), pos, window=window, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_grouped_attend_route_needs_equal_lengths_and_dims(flash_calls):
    q, k, v = _t(*_qkv(10, 1, 128, 4, 2, 32, Sk=256))
    bias = torch.zeros(128, 256)
    A.grouped_attend(q, k, v, bias, plain_causal=True, flash=True)
    assert flash_calls["fwd"] == 0            # Sq != Sk
    q, k, v = _t(*_qkv(10, 1, 128, 4, 2, 32))
    A.grouped_attend(q, k, v[..., :16], torch.zeros(128, 128),
                     plain_causal=True, flash=True)
    assert flash_calls["fwd"] == 0            # dh != dv
    A.grouped_attend(q, k, v, torch.zeros(128, 128), plain_causal=True,
                     flash=True)
    assert flash_calls["fwd"] == 1


def test_cuda_wrappers_refuse_outside_envelope_before_building():
    """The kernel wrappers check dtype, head dim and shapes before they
    build or launch anything (so this runs without a GPU)."""
    q, k, v = _t(*_qkv(11, 1, 8, 4, 2, 32))
    with pytest.raises(TypeError):
        fa.cuda_flash_attention_fwd(q.double(), k.double(), v.double())
    q48, k48, v48 = _t(*_qkv(11, 1, 8, 4, 2, 48))
    with pytest.raises(ValueError, match="head dim"):
        fa.cuda_flash_attention_fwd(q48, k48, v48)
    with pytest.raises(ValueError):
        fa.cuda_flash_attention_fwd(q, k[:, :, :1].expand(1, 8, 3, 32), v)
    with pytest.raises(TypeError):
        fa.cuda_flash_attention_fwd(q.transpose(2, 3).contiguous()
                                    .transpose(2, 3), k, v)
    assert fa.cuda_flash_attention_fwd.launches == 0
    assert fa.cuda_flash_attention_bwd.launches == 0


# ---------------------------------------------------------------------------
# the model and the trainer through the flash route
# ---------------------------------------------------------------------------

def _carried(arch, seed=0, **over):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = ckpt.params_from_flat(jflatten(jparams), tcfg, CPU)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("arch", ["opt-1.3b", "granite-3-8b", "hundred-m"])
def test_loss_and_grads_with_flash_match_jax(monkeypatch, flash_calls, arch):
    """S = 128, so every layer takes the flash route; the JAX side is its
    default (einsum) path, since the Pallas kernel has no gradient."""
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    jcfg, tcfg, jparams, tparams = _carried(arch)
    toks = np.random.default_rng(12).integers(0, tcfg.vocab_size,
                                              (2, 128)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jparams)
    leaves = T.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = M.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                        flash=True)
    grads = torch.autograd.grad(loss, leaves)
    # remat: each layer's forward runs again in backward
    assert flash_calls == {"fwd": 2 * tcfg.n_layers, "bwd": tcfg.n_layers}
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = jflatten(jg)
    got = ckpt.params_to_flat(T.unflatten_like(tparams, list(grads)))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_trainer_round_with_flash_matches_einsum(flash_calls):
    """One DiLoCoX round (2 clusters, H = 2, low-rank + int4, delay, EF)
    with flash attention on against the same round with it off; the
    launch count follows the trainer: clusters x H x layers x 2 (remat)
    forwards plus one eval forward per layer, clusters x H x layers
    backwards."""
    cfg = dataclasses.replace(get_config("opt-1.3b").reduced(),
                              vocab_size=128)
    kw = dict(n_clusters=2, local_batch=2, seq_len=128, inner_lr=3e-3,
              h_steps=2, outer_lr=0.5, outer_momentum=0.7,
              compressor_kw=dict(rank=8, backend="pallas"))

    def run(flash):
        gen = torch.Generator()
        gen.manual_seed(0)
        params = M.init_params(cfg, gen, CPU)
        return TT.run_diloco_training(
            cfg, TT.TrainConfig(**kw, flash_attention=flash), 1,
            device="cpu", params=params)

    on = run(True)
    L = cfg.n_layers
    assert flash_calls == {"fwd": 2 * 2 * L * 2 + L, "bwd": 2 * 2 * L}
    off = run(False)
    assert flash_calls["fwd"] == 2 * 2 * L * 2 + L
    np.testing.assert_allclose(on.losses, off.losses, rtol=1e-4)
    np.testing.assert_allclose(on.eval_losses, off.eval_losses, rtol=1e-4)
    assert on.wire_bytes_per_round == off.wire_bytes_per_round


def test_quickstart_with_flash_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.train.quickstart", "--device",
         "cpu", "--flash", "--rounds", "1", "--h-steps", "1"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="2"), cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "attention: flash kernels" in res.stdout.splitlines()
