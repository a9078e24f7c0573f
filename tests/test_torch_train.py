"""Port parity for the training path: ``repro_torch.models.model.loss_fn``
(loss and grads) against ``jax.value_and_grad`` of the JAX package's
``loss_fn`` on carried weights, the chunked attention and CE paths, and
two DiLoCoX rounds of ``run_diloco_training`` (plus the AllReduce and
compressed-DDP baselines) on reduced opt-1.3b against the JAX trainer with
JAX-drawn token batches, params and warm starts. The quickstart driver
prints TRAIN-DRIVER-OK on the CPU.

Tolerances (float32 both sides, other summation orders): loss rtol 1e-5,
grads rtol 1e-4 / atol 1e-6; training losses rtol 1e-4 (two rounds of
AdamW steps and a compressed outer step in between)."""
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
from repro.core import compression as JC
from repro.data import synthetic as JS
from repro.models import attention as JA
from repro.models import model as JM
from repro.train import trainer as JT
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core.compression import LowRankQuant
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.train import trainer as TT

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _carried(arch, seed=0, **over):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = ckpt.params_from_flat(jflatten(jparams), tcfg, CPU)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("arch,S,loss_chunk", [("opt-1.3b", 16, 1024),
                                               ("granite-3-8b", 16, 1024),
                                               ("hundred-m", 16, 1024),
                                               ("opt-1.3b", 32, 16)])
def test_loss_and_grads_match_jax(arch, S, loss_chunk):
    jcfg, tcfg, jparams, tparams = _carried(arch)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                             (2, S)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)},
                             loss_chunk=loss_chunk), has_aux=True))(jparams)
    leaves = T.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = M.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                          loss_chunk=loss_chunk)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(aux["nll"].detach()), float(jl),
                               rtol=1e-5)
    want = jflatten(jg)
    got = ckpt.params_to_flat(T.unflatten_like(tparams, list(grads)))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_forward_logits_match_jax():
    jcfg, tcfg, jparams, tparams = _carried("granite-3-8b")
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    jlog, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tlog, _ = M.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-5)


def test_chunked_grouped_attend_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jbias = JA._mask_bias(jnp.asarray(pos), jnp.asarray(pos), causal=True,
                          window=0)
    want = np.asarray(JA.grouped_attend(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jbias, chunk=8))
    tpos = torch.from_numpy(np.array(pos))
    bias = A._mask_bias(tpos, tpos, causal=True, window=0)
    t = lambda a: torch.from_numpy(a)
    got = A.grouped_attend(t(q), t(k), t(v), bias, chunk=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    whole = A.grouped_attend(t(q), t(k), t(v), bias)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the trainer, fed the JAX trainer's own draws
# ---------------------------------------------------------------------------

VOCAB, B, S = 128, 2, 16


def _jax_batches(tcfg, table):
    """The tokens the JAX trainer's inner_fn draws for (cluster, round,
    step)."""
    def batch_fn(c, r, h):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(tcfg.seed + 7), c), r), h)
        return np.asarray(JS._gen_batch(key, B, S, 4, table, None))
    return batch_fn


def _eval_batch(tcfg):
    ev = JS.SyntheticLM(VOCAB, S, 16, seed=tcfg.seed, data_shard=9999)
    return {"tokens": np.asarray(ev.next_batch()["tokens"])}


@pytest.mark.parametrize("h_policy", ["global", "balance"])
def test_run_diloco_training_matches_jax(h_policy):
    """2 rounds, 2 clusters, H = 2, low-rank + int4 with the delay and EF;
    the port compresses with its fused pipeline (plain on the CPU).
    ``balance`` with step times (1, 2) gives cluster 1 one step of two:
    the h-masked inner path."""
    jcfg, tcfg, jparams, tparams = _carried("opt-1.3b", vocab_size=VOCAB)
    kw = dict(n_clusters=2, local_batch=B, seq_len=S, inner_lr=3e-3,
              h_steps=2, outer_lr=0.5, outer_momentum=0.7,
              h_policy=h_policy, step_times=(1.0, 2.0))
    jt = JT.TrainConfig(**kw, compressor_kw=dict(rank=8))
    want = JT.run_diloco_training(jcfg, jt, 2)
    comp_state = ckpt.tree_from_flat(
        jflatten(JC.LowRankQuant(rank=8).init_state(jparams)),
        LowRankQuant(rank=8).init_state(tparams))
    table = JS.SyntheticLM(VOCAB, S, B, seed=0).table
    got = TT.run_diloco_training(
        tcfg, TT.TrainConfig(**kw, compressor_kw=dict(rank=8,
                                                      backend="pallas")),
        2, device="cpu", params=tparams, comp_state=comp_state,
        batch_fn=_jax_batches(jt, table), eval_batch=_eval_batch(jt))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    np.testing.assert_allclose(got.eval_losses, want.eval_losses, rtol=1e-4)
    assert got.wire_bytes_per_round == want.wire_bytes_per_round
    assert got.r_per_round == want.r_per_round
    assert got.h_per_round == want.h_per_round
    assert got.h_by_per_round == want.h_by_per_round
    assert len(got.round_s) == len(got.compress_s) == 2


def test_allreduce_and_compressed_ddp_match_jax():
    jcfg, tcfg, jparams, tparams = _carried("opt-1.3b", vocab_size=VOCAB)
    kw = dict(n_clusters=2, local_batch=B, seq_len=S, inner_lr=3e-3,
              h_steps=1)
    jt = JT.TrainConfig(**kw, compressor="quant")
    shards = [JS.SyntheticLM(VOCAB, S, B, seed=0, data_shard=i)
              for i in range(2)]
    toks = {(c, s): np.asarray(shards[c].next_batch()["tokens"])
            for s in range(2) for c in range(2)}
    batch_fn = lambda c, r, s: toks[(c, s)]
    tt = TT.TrainConfig(**kw, compressor="quant")
    want = JT.run_allreduce_training(jcfg, jt, 2)
    got = TT.run_allreduce_training(
        tcfg, tt, 2, device="cpu",
        params=T.tree_map(torch.clone, tparams), batch_fn=batch_fn,
        eval_batch=_eval_batch(jt))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    np.testing.assert_allclose(got.eval_losses, want.eval_losses, rtol=1e-4)
    want = JT.run_compressed_ddp_training(jcfg, jt, 2)
    got = TT.run_compressed_ddp_training(
        tcfg, tt, 2, device="cpu", params=tparams, batch_fn=batch_fn,
        eval_batch=_eval_batch(jt))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    np.testing.assert_allclose(got.eval_losses, want.eval_losses, rtol=1e-4)
    assert got.wire_bytes_per_round == want.wire_bytes_per_round


def test_pp_inner_engine_refused():
    """The pipeline-parallel engine refuses what the JAX package's refuses
    (non-uniform stacks: gemma3-1b's global_every, non-dense families) and
    trains a dense config: one round of the pp trainer on reduced
    opt-1.3b."""
    with pytest.raises(ValueError, match="uniform decoder"):
        TT.run_diloco_training(get_config("gemma3-1b").reduced(),
                               TT.TrainConfig(inner_engine="pp"), 1,
                               device="cpu")
    moe = dataclasses.replace(get_config("opt-1.3b").reduced(), family="moe")
    with pytest.raises(ValueError, match="uniform decoder"):
        TT.run_diloco_training(moe, TT.TrainConfig(inner_engine="pp"), 1,
                               device="cpu")
    cfg = get_config("opt-1.3b").reduced()
    res = TT.run_diloco_training(
        cfg, TT.TrainConfig(inner_engine="pp", local_batch=4, seq_len=16,
                            h_steps=1, compressor_kw=dict(rank=8)), 1,
        device="cpu")
    assert np.isfinite(res.losses + res.eval_losses).all()


def test_quickstart_driver_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.train.quickstart", "--device",
         "cpu", "--rounds", "2", "--h-steps", "2"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="2"), cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1].startswith("TRAIN-DRIVER-OK")
