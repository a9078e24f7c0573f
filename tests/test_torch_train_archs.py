"""The three dense configs the port now carries (qwen1.5-107b,
phi3-medium-14b, stablelm-12b) through the training entry points, reduced,
on the CPU: two DiLoCoX rounds of ``run_diloco_training`` and two steps
of each baseline against the JAX trainer on JAX-drawn params, batches and
warm starts (``tests/test_torch_train.py``'s method and tolerances:
losses rtol 1e-4, AllReduce and compressed-DDP losses rtol 1e-5); the
mesh driver ``repro_torch.launch.train --smoke --device cpu``; and the flash
kernels' refusal of stablelm-12b's head dim 160 before the first step."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.core import compression as JC
from repro.data import synthetic as JS
from repro.train import trainer as JT
from test_torch_train import B, S, VOCAB, _carried, _eval_batch, _jax_batches
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core.compression import LowRankQuant
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.launch import train as TR
from repro_torch.train import trainer as TT

NEW = ["qwen1.5-107b", "phi3-medium-14b", "stablelm-12b"]


@pytest.mark.parametrize("arch", NEW)
def test_run_diloco_training_matches_jax(arch):
    """2 rounds, 2 clusters, H = 2, low-rank + int4 (the fused pipeline,
    plain on the CPU) with the delay and EF."""
    jcfg, tcfg, jparams, tparams = _carried(arch, vocab_size=VOCAB)
    kw = dict(n_clusters=2, local_batch=B, seq_len=S, inner_lr=3e-3,
              h_steps=2, outer_lr=0.5, outer_momentum=0.7)
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


@pytest.mark.parametrize("arch", NEW)
def test_allreduce_and_compressed_ddp_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _carried(arch, vocab_size=VOCAB)
    kw = dict(n_clusters=2, local_batch=B, seq_len=S, inner_lr=3e-3,
              h_steps=1, compressor="quant")
    jt = JT.TrainConfig(**kw)
    shards = [JS.SyntheticLM(VOCAB, S, B, seed=0, data_shard=i)
              for i in range(2)]
    toks = {(c, s): np.asarray(shards[c].next_batch()["tokens"])
            for s in range(2) for c in range(2)}
    batch_fn = lambda c, r, s: toks[(c, s)]
    tt = TT.TrainConfig(**kw)
    for jrun, trun, params in (
            (JT.run_allreduce_training, TT.run_allreduce_training,
             T.tree_map(torch.clone, tparams)),
            (JT.run_compressed_ddp_training, TT.run_compressed_ddp_training,
             tparams)):
        want = jrun(jcfg, jt, 2)
        got = trun(tcfg, tt, 2, device="cpu", params=params,
                   batch_fn=batch_fn, eval_batch=_eval_batch(jt))
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
        np.testing.assert_allclose(got.eval_losses, want.eval_losses,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", NEW)
def test_train_driver_smoke_on_cpu(arch, capfd):
    """``python -m repro_torch.launch.train --arch ARCH --smoke --device
    cpu``, one process (a process group of size 1)."""
    summary = TR.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--devices", "1", "--clusters", "1", "--data", "1",
                       "--model", "1", "--rounds", "2", "--h-steps", "2",
                       "--global-batch", "2", "--seq-len", "16",
                       "--cpu-threads", "1"])
    out = capfd.readouterr().out
    assert "round 1: mean_loss=" in out
    assert out.rstrip().endswith("TRAIN-DRIVER-OK")
    assert all(np.isfinite(summary["mean_loss"]))


def test_train_driver_cuts_depth_at_full_width(capfd):
    """``--n-layers`` keeps the config's width and cuts its depth (chip
    phase 4e runs stablelm-12b's full width at 2 of 40 layers)."""
    seen = []

    def on_round(r, params, opt, outer):
        seen.append({k: tuple(v.shape) for k, v in T.keystr_items(params)})

    TR.main(["--arch", "stablelm-12b", "--smoke", "--n-layers", "1",
             "--device", "cpu", "--devices", "1", "--clusters", "1",
             "--data", "1", "--model", "1", "--rounds", "1", "--h-steps",
             "1", "--global-batch", "1", "--seq-len", "8",
             "--cpu-threads", "1"], on_round=on_round)
    assert capfd.readouterr().out.rstrip().endswith("TRAIN-DRIVER-OK")
    cfg = get_config("stablelm-12b").reduced()
    shapes = seen[0]
    assert shapes["['embed']"] == (1, cfg.vocab_size, cfg.d_model)
    assert shapes["['segments'][0]['attn']['wq']"] == (
        1, 1, cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)


def test_flash_refuses_head_dim_160_before_the_first_step(monkeypatch):
    """stablelm-12b's head dim 160 is not among the flash kernels' head
    dims: every entry point refuses before it builds anything, naming the
    head dim and the ROADMAP item; the einsum route trains it."""
    cfg = dataclasses.replace(get_config("stablelm-12b").reduced(),
                              head_dim=160)
    assert 160 not in HEAD_DIMS
    tcfg = TT.TrainConfig(n_clusters=1, local_batch=1, seq_len=128,
                          h_steps=1, flash_attention=True)

    def no_step(*a, **kw):
        raise AssertionError("reached the model before the refusal")

    monkeypatch.setattr(TT.M, "loss_fn", no_step)
    monkeypatch.setattr(TT.M, "init_params", no_step)
    for run in (TT.run_diloco_training, TT.run_allreduce_training,
                TT.run_compressed_ddp_training):
        with pytest.raises(NotImplementedError,
                           match=r"head dim 160.*ROADMAP B item 9"):
            run(cfg, tcfg, 1, device="cpu")
    monkeypatch.undo()
    res = TT.run_diloco_training(
        cfg, dataclasses.replace(tcfg, flash_attention=False, seq_len=16),
        1, device="cpu")
    assert np.isfinite(res.losses).all()
