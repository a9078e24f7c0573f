"""Drives the PyTorch port's main paths on one NVIDIA GPU and checks them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches and
continues:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA kernel from src/repro_torch/csrc/, one nvcc each,
     all started together;
  3. kernel vs plain: each kernel against its plain PyTorch version at the
     shapes its path gives it, with its time, the plain version's, a
     library yardstick's and the least time the card could take:
     a. paged attention at the served models' shapes (opt-1.3b,
        granite-3-8b, gemma3-1b; stablelm-12b's head dim 160 and
        qwen1.5-107b's G = 8 at the serve phase's lengths and at 2,048
        tokens): each case within the JAX gate, two calls bit for bit
        equal, and slot 0 run alone bit for bit its row of the batch;
        each case's plan (pages per chunk, chunks, blocks) and, at the
        full-size cases, each kernel's time (``kernel_profile``); then
        (3a-bf16) the same cases with q and the pool in bf16, within
        rtol/atol 2e-2, bit for bit over two calls and slot 0 alone, the
        bytes bound at 2-byte K/V (``kernel_vs_plain(torch.bfloat16)``);
     b. the compressor's five kernels (int4 pack/unpack, project,
        project-transpose + pack, reconstruct) at every leaf shape of the
        training configuration, r = 64 and r_t in {64, 40}, held to the
        gates tests/test_kernels.py holds the Pallas kernels to, each
        product elementwise to its plain version within an f32
        accumulation bound (``_gate_product``), q_new to the ref chain's
        within rtol/atol 1e-5 sqrt(K / 2048) for a K-term reduction, the
        kernels' fused EF form bit for bit to the hoisted one, and two
        calls of each kernel (and of the whole pipeline) bit for bit
        equal, and the reconstruction bit for bit lowrank_mm(unpack P,
        unpack Q^T) (the mesh runtime's decompression of the same
        payload); each leaf's line names the projections' split-K plan
        (tiles, splits S, blocks); then the int4 kernels' batched
        launches of one mesh round (phase 4d's 24: each low-rank leaf's
        P and Q, each quant-only leaf) byte for byte their plain version,
        also when the rows are read from a two-rank gathered wire layout
        (2 groups of B rows, the kernel's grouped addressing), timed
        beside their bytes bound and beside the same rows launched one at
        a time (``mesh_quant4``), at opt-1.3b's leaves and again at
        stablelm-12b's (2 layers: phase 4e's launches);
     c. flash attention, the forward and the backward kernels, at the
        training shape (opt-1.3b, B 4 x S 512), opt-1.3b at 2,048 tokens,
        the GQA shapes of granite-3-8b, hundred-m and gemma3-1b's global
        layers (d 256), S = 384 and 200, non-causal, Sq != Sk, one
        layer of the paper's qwen1.5-107b at 4,096 keys and one of
        phi3-medium-14b (H 40, KV 10, d 128): the forward
        within the JAX gate rtol/atol 2e-3 and an elementwise f32 bound
        (``flash_tolerances``), the backward (fed the plain forward's o
        and lse) within the same kind of bound and bitwise equal over two
        calls, the worst ratio to the bound printed; each case's forward,
        dK/dV and dQ plans and resident warps an SM; times beside the
        plain versions and SDPA, and the least time at the 3xTF32
        tensor-core rate beside the f32 SIMT one (``flash_bound``); at the
        training shape, granite-3-8b, gemma3-1b global and qwen1.5-107b,
        each kernel's time (``kernel_profile``); then (3c-bf16) the bf16
        kernels (the forward, dK/dV and dQ on wgmma and TMA) at the same
        cases, the occupancy of each, and the registers and spills of the
        three wgmma kernels at each head dim from ptxas: within the JAX
        bf16 gate 2e-2 (forward) and an f32-accumulation bound plus an
        ulp of each output, two calls bit for bit; each case's bf16
        forward, dK/dV and dQ plans; times beside the bound at the bf16
        tensor rate, the plain versions and SDPA on bf16, and each
        kernel's at the five profiled shapes (``flash_kernels_bf16``);
     d. lowrank_mm, the mesh runtime's matmul, at every product of phase
        4d's tree (P = M Q, Q = M^T P and P Q^T per low-rank leaf, the
        transposes as strided views, batched over a leaf's stacked units)
        within the f32 accumulation bound (``_gate_product``), each view
        bit for bit equal to its contiguous copy, a batched launch bit for
        bit each matrix's own launch, two calls bit for bit equal, and at
        the five shapes of tests/test_kernels.py in f32 and bf16 within the
        JAX gate; each product's route (split, rank, general) and split
        plan, times beside the plain version and torch.matmul, summed per
        route, and at the batched split products the plan against S = 1;
        then the same at phase 4e's tree (stablelm-12b, 2 layers);
  4. train: ``run_diloco_training`` on opt-1.3b at full width, 12 of 24
     layers, 2 clusters, H = 4, batch 4 x 512, LowRankQuant(rank 64,
     int4, the fused kernels), 2 rounds with the delay and EF: finite
     losses, round 0 leaves the params bit for bit, and every compressor
     kernel launched as often as the tree's leaves say; then the
     compressor's ms per round beside phase 3b's kernel times of one
     cluster's call times the clusters (``compressor_share``);
     b. the same run with ``flash_attention=True`` (same seed, params and
        data): the same gates, the flash launches the path must make
        (``flash_launches_expected``), and each round's losses within
        rtol 1e-3 of phase 4's;
     c. granite-3-8b (GQA, G = 4) at full width, 2 of 40 layers: loss and
        gradients with flash against einsum;
     k. phase 4b's run in bf16 (params and compute; optimizer state,
        pseudo-gradients and the wire f32): round 0 bit for bit the
        initial bf16 params, the bf16 flash kernels and the compressor
        launched as in 4b, wire bytes 4b's; ms a step, round s and peak
        beside 4b's (``train_bf16``; bf16 matmuls reduce in f32 in every
        phase);
     d. the mesh driver ``repro_torch.launch.train.main`` on full opt-1.3b
        (24 layers, full width), one cluster on the card through a process
        group of size 1 (NCCL), 2 rounds of H = 4: finite losses, round 0
        leaves the params bit for bit, lowrank_mm (by route) and the int4
        kernels launched as often as the tree's leaves say
        (``mesh_launches_expected``: one batched pack and one unpack per
        leaf and factor), the all-gather handed the payload's bytes, peak
        memory; then the outer step run again on the last state, plain
        and split into its parts by CUDA events (``outer_split``);
     l. the same run at ``--dtype bfloat16``, with the same gates and the
        all-gather handed 4d's bytes exactly; ms a step and peak beside
        4d's (``mesh_driver_bf16``);
     e. the same driver on stablelm-12b (parallel residual, LayerNorm and
        GELU, head dim 160) at full width, cut to 2 of 40 layers
        (``--n-layers 2``), with the same gates;
     f. ``run_compressed_ddp_training`` with CocktailSGD (random 0.1, top-k
        0.08 of the sample, int4) on phase 4's opt-1.3b, 2 clusters, 4
        steps: finite losses, both clusters' masks bitwise equal in each
        step, every leaf's kept values inside the mask and at most k; the
        wire bytes per step beside DiLoCoX's per round (``cocktail_ddp``);
     g. the trainer's pipeline-parallel inner engine:
        ``run_diloco_training(inner_engine="pp", pp_stages=2, pp_micro=2,
        flash_attention=True)``, phase 4b's run (same params mapped into
        the pp tree, same warm starts and data), both stages on the card:
        finite losses, round 0 leaves the params bit for bit, the flash
        and compressor kernels launched as the path requires
        (``pp_flash_launches_expected``, ``pp_compressor_launches``), each
        round's losses within rtol 1e-5 of phase 4b's, two runs of one pp
        inner step bit for bit equal, one pp step's loss and every leaf's
        gradient against the sequential ``loss_fn`` on the same tree
        (``pp_grads_vs_sequential``); ms per inner step beside 4b's, peak
        memory, the GPipe bubble share (``train_pp``);
     h. the mesh driver with ``--inner pp`` on full opt-1.3b (24 layers,
        one stage: a second stage needs a second card), rank 64, H = 4,
        4 x 512, 2 rounds: finite losses, round 0 bitwise, the compressor
        kernels' launches, the f32 bytes handed to the clusters group,
        peak memory at most 1.5 x the round state's bytes over what the
        phase starts with (``pp_driver``);
     i. the mesh driver's tensor parallelism and FSDP placement:
        ``launch/train.py`` on full opt-1.3b (24 layers) at ``--data 2
        --model 2``, every shard of the cluster in one process on the card
        (``run`` with no groups), as 4d otherwise: round 0 bitwise, the
        round losses within ``TP_LOSS_RTOL`` of 4d's, ``lowrank_mm`` and
        the int4 kernels launched as in 4d, the all-gather handed 4d's
        bytes, each shard's stored blocks a quarter of a leaf wherever its
        dims divide (``tp_driver``); then one sharded ``value_and_grad``
        against the unsharded ``loss_fn`` per leaf (``TP_GRAD_RTOL`` of
        the leaf's norm) and two runs of one sharded step bit for bit
        (``tp_step_checks``); ms per step beside 4d's, peak memory;
     j. the dry-run against the card: ``launch/dryrun.py``'s ``lower_one``
        on the ``meta`` device at 4d's layout (opt-1.3b, one cluster, 1 x
        1, 4 x 512, rank 64, f32): its state bytes 4d's round state's and
        its cross-cluster bytes 4d's all-gather's, exactly, its peak
        within 20 % of 4d's measured one (the ratio printed), beside the
        H100 peaks it divides by and the card's SM count and max SM clock
        (``dryrun_vs_card``); then a replicated KV head in training:
        gemma3-1b at full width, 6 of 26 layers (one global), ``--data 1
        --model 2`` with ``--flash`` (d = 256), every shard in process:
        round 0 bitwise, losses within ``TP_LOSS_RTOL`` of the unsharded
        run's, flash, ``lowrank_mm`` and the int4 kernels launched
        (``tp_replicated_kv``);
     m. membership churn (``churn``, twin of tests/test_membership.py:48-95):
        ``diloco_round`` with ``make_inner_fn`` (flash on) and
        ``masked_cluster_mean`` on opt-1.3b at full width, 4 of 24 layers,
        4 clusters, H = 4, 4 x 512, rank 64 int4, 5 rounds: cluster 2
        dead in rounds 2 and 3, back in 4 through ``reset_rejoining``.
        Gates: Delta of a dead round bit for bit with the dead row of
        delta_hat replaced, the rejoined rows zero at their compress,
        ``trimmed_cluster_mean`` (trim 1) on the card bit for bit on CPU
        copies, finite losses, the compressor's and flash's launches; ms a
        round split into inner, compressor and mean, peak;
     n. gossip rounds (``gossip``, twin of tests/test_topology.py:155-196):
        a ring of 4 clusters, stacked params, constant displacements at
        the model's leaf shapes, 3 rounds with the delay and rank 64 int4
        through ``mixing_op``, cluster 3 dead in round 2. Gates:
        ``mix_row(W[c])`` bit for bit row c of ``mix_stacked``, the dead
        row through the masked mix bit for bit, the rows distinct, the
        compressor launched C times per leaf per round; compress off, the
        rows' mean against the gather run's params within a derived bound;
        ms a round split into compressor, mix and the rest, peak, modeled
        wire bytes and seconds a round at 1 Gbps, ring and gather;
     o. the simulator in barrier mode (``sim_barrier``): ``repro_torch.sim.
        simulate`` over a star on 4m's model, clusters and batch, 5
        rounds, flash on, rank 64 int4 through the compressor kernels,
        under a straggler (cluster 1 x3 in rounds 1-2), cluster 0's link
        at a quarter in round 2, cluster 2 gone in rounds 2-3 and back in
        4, and the balance H policy (so the straggler's rounds run
        ``diloco_round_h``). Gates: the timeline but loss and param_hash
        equal to a timing-only run's; each round's param_hash the
        ``tree_hash`` of a hand-driven ``diloco_round`` loop bit for bit;
        the rejoined cluster's inner moments zero and its warm start
        ``comp0`` bit for bit; finite losses; the compressor's and flash's
        launches. Prints each round's wall ms split into the numeric leg,
        ``tree_hash`` and the rest beside the modeled seconds, and the
        peak. Then the JAX tests' quadratic scenarios (``tests/test_sim.py
        :42``, ``:166``, ``tests/test_topology.py:219``) on the card with
        the ``ref`` and ``pallas`` backends against the port's CPU run:
        timing rows equal, losses and params within the stated
        tolerances, the int4 payload bytes charged per round identical
        (``sim_quadratic_cases``);
     p. the simulator's bounded-stale engine (``sim_bounded_stale``):
        ``simulate`` under ``sync="bounded_stale"`` (max staleness 1, a
        star) on opt-1.3b at full width, 2 of 24 layers, 4 clusters, H 4,
        4 x 512, flash on, rank 64 int4 through the compressor kernels, 5
        legs a cluster (20 commits), cluster 1 x3 in its legs 1-3 and
        cluster 3 publishing -8 x its delta in its legs 2-3 against the
        trimmed mean (trim 1). Gates: the timeline but its numeric fields
        equal to a timing-only run's, the staleness bound, versions mixed
        ahead of their publisher's commit; each cluster's final params bit
        for bit a hand-driven replay of the engine's sequence through the
        port's parts; the Byzantine copy -8 x the clean hat and its EF
        error raw - hat bit for bit; finite losses; the compressor's and
        flash's launches. Prints each commit's wall ms (publish leg,
        commit, ``tree_hash``, disagreement), the modeled makespan,
        tokens/s and barrier idle, and the peak. Then the JAX tests'
        async quadratic scenarios (``tests/test_engine.py:221-313``) on the
        card with both backends against the port's CPU run
        (``sim_async_quadratic_cases``);
  5. serve: ``repro_torch.launch.serve`` with the paged engine on
     full-width opt-1.3b (24 layers), then (5b) on stablelm-12b at full
     width and depth (40 layers); the kernel's launch count must equal
     device steps x layers;
     f. phase 5's opt-1.3b run at ``--dtype bfloat16`` (bf16 weights and
        KV pool, the bf16 paged kernel), its gates and a KV pool exactly
        half of 5's; tok/s and per-token p50/p99 beside 5's; then the paged
        engine's greedy tokens against the dense loop's in bf16, a
        divergence allowed only at a dense top-2 margin under 3 bf16 ulps
        (``serve_bf16``);
     c. the same driver's tensor-parallel shards, all in this process on
        the card (``serve.run`` with no shards): opt-1.3b at ``--data 2
        --model 2`` and ``--data 1 --model 4``, stablelm-12b at ``--model
        4``: greedy tokens and admission fingerprint those of 5 / 5b, the
        kernel launched device steps x layers x shards times; per-token ms
        and peak memory beside 5's (``serve_tp``);
     d. the paged kernel on each model shard's query heads and KV heads
        (KV/M, or gemma3-1b's one head replicated) at 2,048 tokens, bit for
        bit those heads of the whole-cache launch: opt-1.3b, stablelm-12b
        and qwen1.5-107b shapes at M = 2 and 4, gemma3-1b at M = 2
        (``paged_shards``);
     e. phase 5's opt-1.3b paged run through ``TPDecode``'s 2-D placement
        (weights placed as for training, each unit's gathered over "data"
        before it runs) at 2 x 2, every shard on the card: tokens and
        admission fingerprint 5's, the kernel launched device steps x
        layers x 4 times; then the sharded prefill's last logits against
        the one-card ``make_prefill_step``, within 1e-4 of their largest
        (``serve_2d``);
  6. paged vs dense: greedy tokens of the paged engine (kernel) and of the
     dense decode loop (plain attention) at full width must agree: opt-1.3b,
     then (6b) stablelm-12b (40 layers) and qwen1.5-107b cut to 2 of 78
     layers.
The line before the last holds the kernels' numbers as JSON; the last line
is ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12        # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS_PER_S = 989.4e12      # H100 SXM dense bf16 on the tensor cores
                                 # (launch/dryrun.py::BF16_FLOPS_PER_S)
ATOL, RTOL = 1e-5, 1e-3          # the JAX package's gate for this kernel
SCRATCH = 1e3                    # scratch-page garbage that must never leak


_START = time.monotonic()


def _phase(name):
    """A phase's header, with the seconds since the script started (what
    each phase costs of the run's time limit)."""
    print(f"== {name} (at {time.monotonic() - _START:.1f} s)", flush=True)


def card_name_and_power_limit():
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def environment():
    _phase("environment")
    smi = card_name_and_power_limit()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; matmul allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"allow_bf16_reduced_precision_reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    return smi


def build():
    from repro_torch.kernels import _build

    _phase("build")
    t0 = time.monotonic()
    paths = _build.build_all(_build.KERNEL_LIBS)
    for name, path in paths.items():
        print(f"built {name}: {path.name}")
        for line in _build.ptxas_report.get(name, "").splitlines():
            if "Compiling entry function" in line:
                print("  " + line.split("'")[1])
            elif "registers" in line or "smem" in line or "spill" in line:
                print("    " + line.strip())
    print(f"build seconds: {time.monotonic() - t0:.3f}")


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------

def paged_case(gen, *, S, P, ps, KV, G, dh, max_len, n_inactive, dev):
    """Random shuffled page pool and ragged lengths < max_len; pages up to
    position lengths[s] are allocated (the engine writes K/V before it
    attends); scratch page 0 is full of 1e3; the last ``n_inactive`` slots
    have length 0 and an all-zero table row."""
    lengths = torch.randint(1, max_len, (S,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[S - n_inactive:] = 0
    n_used = [0 if s >= S - n_inactive else int(lengths[s]) // ps + 1
              for s in range(S)]
    n_pages = max(1, sum(n_used))
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    perm += 1
    table = torch.zeros((S, P), dtype=torch.int32, device=dev)
    at = 0
    for s, n in enumerate(n_used):
        table[s, :n] = perm[at:at + n]
        at += n
    shape = (1 + n_pages, ps, KV, dh)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    k[0] = SCRATCH
    v[0] = SCRATCH
    q = torch.randn((S, 1, KV * G, dh), generator=gen, device=dev)
    return q, {"k": k, "v": v}, table, lengths


def jax_fixture_case(gen, *, S, P, ps, KV, G, dh, dev):
    """The JAX tests' fixture (tests/test_kernels.py::_paged_fixture):
    positions below lengths[s] are allocated in page-manager order."""
    from repro_torch.serve.pages import PageManager

    n_pages = S * P
    pm = PageManager(n_pages, ps, S, P)
    lengths = torch.randint(1, int(P * ps * 0.8) + 1, (S,), generator=gen,
                            device=dev, dtype=torch.int32)
    for s in range(S):
        pm.admit(s, int(lengths[s]))
        for pos in range(int(lengths[s])):
            pm.ensure(s, pos)
    shape = (1 + n_pages, ps, KV, dh)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    k[0] = SCRATCH
    v[0] = SCRATCH
    q = torch.randn((S, 1, KV * G, dh), generator=gen, device=dev)
    return (q, {"k": k, "v": v},
            torch.as_tensor(pm.page_table, device=dev), lengths)


def library_paged_attention(q, cache, table, lengths, *, window):
    """Yardstick only (the port never calls it): page gather +
    F.scaled_dot_product_attention with the same mask."""
    S, P = table.shape
    ps, KV, dh = cache["k"].shape[1:]
    G = q.shape[2] // KV
    idx = table.long()
    k = cache["k"][idx].reshape(S, P * ps, KV, dh).transpose(1, 2)
    v = cache["v"][idx].reshape(S, P * ps, KV, dh).transpose(1, 2)
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    k_pos = torch.arange(P * ps, device=q.device)
    ok = k_pos[None, :] <= lengths[:, None]
    if window:
        ok = ok & (k_pos[None, :] > lengths[:, None] - window)
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=ok[:, None, None, :])
    return o.transpose(1, 2)


def time_ms(fn, *, iters=30, flush=None):
    """Median device time of ``fn`` over ``iters`` launches (CUDA events),
    with the L2 cache overwritten before each one, as a decode step finds
    it after the previous layer's weights streamed through. A spin of
    ~0.5 ms keeps the stream busy before each start event, so the host's
    launch overhead of a short kernel falls outside the timed span."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def paged_bound(q, cache, table, lengths, *, window):
    """Least time for this call's data: live K/V rows plus q and o (at
    their element size), over HBM rate, against 4 flops per live K/V
    element over the f32 rate."""
    ps, KV, dh = cache["k"].shape[1:]
    S, _, H, _ = q.shape
    live = (lengths.long() + 1).clamp(max=table.shape[1] * ps)
    if window:
        live = live.clamp(max=window)
    n_live = int(live.sum())
    nbytes = (2 * n_live * KV * dh + 2 * S * H * dh) * q.element_size() \
        + table.numel() * 4 + lengths.numel() * 4
    flops = 4 * n_live * H * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


PAGED_CASES = [
    # name, shape kw, window
    ("opt-1.3b len<=192", dict(S=8, P=12, ps=16, KV=32, G=1, dh=64,
                               max_len=192, n_inactive=1), 0),
    ("opt-1.3b len<=2048", dict(S=8, P=128, ps=16, KV=32, G=1, dh=64,
                                max_len=2048, n_inactive=1), 0),
    ("granite-3-8b len<=2048", dict(S=8, P=128, ps=16, KV=8, G=4, dh=128,
                                    max_len=2048, n_inactive=1), 0),
    ("gemma3-1b len<=2048 w512", dict(S=8, P=128, ps=16, KV=1, G=4,
                                      dh=256, max_len=2048,
                                      n_inactive=1), 512),
    # stablelm-12b: head dim 160, 40 float4s a row (not a power of
    # two, more than a warp); qwen1.5-107b: G = 8
    ("stablelm-12b len<=192", dict(S=8, P=12, ps=16, KV=8, G=4, dh=160,
                                   max_len=192, n_inactive=1), 0),
    ("stablelm-12b len<=2048", dict(S=8, P=128, ps=16, KV=8, G=4,
                                    dh=160, max_len=2048,
                                    n_inactive=1), 0),
    ("qwen1.5-107b len<=192", dict(S=8, P=12, ps=16, KV=8, G=8, dh=128,
                                   max_len=192, n_inactive=1), 0),
    ("qwen1.5-107b len<=2048", dict(S=8, P=128, ps=16, KV=8, G=8,
                                    dh=128, max_len=2048,
                                    n_inactive=1), 0),
]
PAGED_GATE_BF16 = 2e-2   # atol and rtol in bf16: the flash kernel's JAX
                         # bf16 gate (tests/test_kernels.py:103-113)


def kernel_vs_plain(dtype=torch.float32):
    """Phase 3a (3a-bf16 with ``dtype=torch.bfloat16``: the same cases'
    q and K/V pool cast to bf16, the gate ``PAGED_GATE_BF16``)."""
    from repro_torch.serve import attention_paged as ap

    bf16 = dtype == torch.bfloat16
    _phase("kernel vs plain: paged_attention" + (" (bf16)" if bf16 else ""))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    gate = (PAGED_GATE_BF16, PAGED_GATE_BF16) if bf16 else (ATOL, RTOL)

    def cast(q, cache, table, lengths):
        return (q.to(dtype), {n: t.to(dtype) for n, t in cache.items()},
                table, lengths)

    rows = []
    worst = 0.0
    for name, kw, window in PAGED_CASES:
        q, cache, table, lengths = cast(*paged_case(gen, dev=dev, **kw))
        worst = max(worst, _compare(ap, name, q, cache, table, lengths,
                                    window, rows, flush, profile=True,
                                    gate=gate))
    for S, P, ps, KV, G, dh in [(3, 4, 4, 2, 2, 8), (2, 3, 8, 1, 4, 16)]:
        for window in (0, 5):
            q, cache, table, lengths = cast(*jax_fixture_case(
                gen, S=S, P=P, ps=ps, KV=KV, G=G, dh=dh, dev=dev))
            worst = max(worst, _compare(
                ap, f"jax-test S{S} P{P} ps{ps} KV{KV} G{G} dh{dh} w{window}",
                q, cache, table, lengths, window, rows, flush, gate=gate))
    return rows, worst


def _compare(ap, name, q, cache, table, lengths, window, rows, flush,
             profile=False, gate=(ATOL, RTOL)):
    from repro_torch.kernels import _plan

    atol, rtol = gate

    got = ap.cuda_paged_attention(q, cache, table, lengths, window=window)
    again = ap.cuda_paged_attention(q, cache, table, lengths, window=window)
    alone = ap.cuda_paged_attention(q[:1].contiguous(), cache,
                                    table[:1].contiguous(),
                                    lengths[:1].contiguous(), window=window)
    want = ap.ref_paged_attention(q, cache, table, lengths, window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    max_err = float(err.max())
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise SystemExit(f"FAIL {name}: kernel disagrees with the plain "
                         f"version (max abs err {max_err:.3e}, "
                         f"{int(bad.sum())} elements outside "
                         f"atol {atol} + rtol {rtol})")
    if not torch.equal(got, again):
        raise SystemExit(f"FAIL {name}: two calls differ bit for bit")
    if not torch.equal(alone[0], got[0]):
        raise SystemExit(f"FAIL {name}: slot 0 alone differs bit for bit "
                         f"from slot 0 among the other slots")
    S, P = table.shape
    ps, KV, dh = cache["k"].shape[1:]
    pages, n_chunks = _plan.paged_plan(P, ps, dh, q.element_size())
    blocks = n_chunks * KV * S
    ms = time_ms(lambda: ap.cuda_paged_attention(q, cache, table, lengths,
                                                 window=window), flush=flush)
    plain_ms = time_ms(lambda: ap.ref_paged_attention(
        q, cache, table, lengths, window=window), flush=flush)
    lib_ms = time_ms(lambda: library_paged_attention(
        q, cache, table, lengths, window=window), flush=flush)
    bound_ms, bound_by = paged_bound(q, cache, table, lengths, window=window)
    row = {"case": name, "max_abs_err": max_err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "plan": [pages, n_chunks], "blocks": blocks}
    rows.append(row)
    print(f"{name}: max_abs_err {max_err:.3e} kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms library {lib_ms:.4f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by}); plan {pages} pages x "
          f"{n_chunks} chunks, {blocks} blocks; two calls and slot 0 alone "
          f"bitwise equal", flush=True)
    if profile:
        prof = kernel_profile(lambda: ap.cuda_paged_attention(
            q, cache, table, lengths, window=window))
        print(f"{name} per kernel (torch.profiler, L2 warm): "
              + ", ".join(f"{k} {us:.1f} us" for k, us in prof.items()),
              flush=True)
    return max_err


# ---------------------------------------------------------------------------
# phase 3b: the compressor's kernels vs their plain versions
# ---------------------------------------------------------------------------

RANK = 64
TRAIN_LAYERS = 12                 # of opt-1.3b's 24: the round's ~15 model
                                  # copies must fit the card's 80 GB
COMPRESS_KERNELS = [
    # name, wrapper attribute, source, the TPU kernel it replaces
    ("quant4_pack", "quant4.cuda_quant4_pack", "src/repro_torch/csrc/quant4.cu",
     "src/repro/kernels/quant4.py:24"),
    ("quant4_unpack", "quant4.cuda_quant4_unpack",
     "src/repro_torch/csrc/quant4.cu", "src/repro/kernels/quant4.py:36"),
    ("fused_project", "fused_compress.cuda_project",
     "src/repro_torch/csrc/fused_compress.cu",
     "src/repro/kernels/fused_compress.py:105"),
    ("fused_project_t_pack", "fused_compress.cuda_project_t_pack",
     "src/repro_torch/csrc/fused_compress.cu",
     "src/repro/kernels/fused_compress.py:170"),
    ("fused_reconstruct", "fused_compress.cuda_reconstruct",
     "src/repro_torch/csrc/fused_compress.cu",
     "src/repro/kernels/fused_compress.py:249"),
]


def _wrapper(attr):
    import importlib
    mod, fn = attr.split(".")
    return getattr(importlib.import_module("repro_torch.kernels." + mod), fn)


def kernel_wrappers():
    """{name: wrapper} of every kernel a training phase counts: the
    compressor's five, ``lowrank_mm`` and the flash forward and backward
    (each wrapper's ``launches`` counts its launches)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lowrank_mm as lm

    wrappers = {name: _wrapper(attr) for name, attr, _, _ in COMPRESS_KERNELS}
    wrappers.update(lowrank_mm=lm.cuda_matmul,
                    flash_attention=fa.cuda_flash_attention_fwd,
                    flash_attention_bwd=fa.cuda_flash_attention_bwd)
    return wrappers


def train_config():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("opt-1.3b"), n_layers=TRAIN_LAYERS)


def leaf_shapes(cfg):
    """The compressor's work for one cluster and round: {(m, n): count} of
    the low-rank leaves and {n_elems: count} of the quant-only ones."""
    from repro_torch.core.compression import matrix_shape, tree_shapes
    from repro_torch.models import model as M

    low, quant = {}, {}
    for shape in tree_shapes(M.init_params(cfg, device="meta")).values():
        m, n = matrix_shape(shape)
        if min(m, n) >= 64:
            low[(m, n)] = low.get((m, n), 0) + 1
        else:
            quant[m * n] = quant.get(m * n, 0) + 1
    return low, quant


def _nblk(n_elems):
    return -(-n_elems // 256)


def _bound(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _fail(msg):
    raise SystemExit(f"FAIL {msg}")


def _check_payload(name, P, Q, pp, sp, pq, sq, hat, dec, rt):
    """The Pallas gates (tests/test_kernels.py::_assert_fused_contract) on
    the kernels' outputs, oracles on the CPU in exact IEEE arithmetic."""
    from repro_torch.kernels import ref

    m, r = P.shape
    n = Q.shape[0]
    for tag, f, pk, sc in (("P", P, pp, sp), ("Q", Q, pq, sq)):
        want_p, want_s, _ = ref.quant4_pack_ref(f.cpu().reshape(-1))
        if not torch.equal(pk.cpu(), want_p):
            _fail(f"{name}: packed {tag} bytes differ from quant4_pack_ref "
                  f"of the kernel's own factor")
        rel = ((sc.cpu() - want_s).abs() / want_s.abs()).max()
        if float(rel) > 1e-6:
            _fail(f"{name}: {tag} scales off by rtol {float(rel):.3e}")
    Pq = ref.quant4_unpack_ref(pp, sp, m * r).reshape(m, r)
    Qq = ref.quant4_unpack_ref(pq, sq, n * r).reshape(n, r)
    oracle = Pq @ Qq.T
    bound = 16 * torch.finfo(torch.float32).eps * (Pq.abs() @ Qq.abs().T)
    gap = (hat - oracle).abs()
    if bool((gap > bound + 1e-30).any()):
        _fail(f"{name}: reconstruction off the payload's oracle by "
              f"{float(gap.max()):.3e} > 16 eps |Pq||Qq|^T")
    if not torch.equal(dec, hat):
        _fail(f"{name}: decompress dual differs from the reconstruction")
    if rt < r and (P[:, rt:].any() or Q[:, rt:].any()):
        _fail(f"{name}: columns >= r_t = {rt} not exactly zero")
    return float((hat - oracle).abs().max())


def _gate_product(name, got, want, a, b):
    """``got`` (the kernel) against ``want`` (its plain version) for the
    f32 product a @ b of K = a.shape[1] terms per element, elementwise
    within 16 eps sqrt(K) (|want| + sqrt(a^2 @ b^2)): sixteen times the
    rounding error a K-term f32 sum in any order can be expected to carry
    (partial sums grow as the value, or as sqrt(k) times the terms). A
    dropped or doubled K tile, or a wrong ragged edge, misses by
    ~sqrt(32) terms, one to two orders over it. Returns (max abs err,
    max err / tolerance)."""
    K = a.shape[1]
    tol = (16 * torch.finfo(torch.float32).eps * math.sqrt(K)
           * (want.abs() + torch.sqrt((a * a) @ (b * b))))
    err = (got - want).abs()
    ratio = float((err / tol.clamp_min(1e-30)).max())
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        _fail(f"{name}: kernel off its plain version by {float(err.max()):.3e}"
              f" ({int((err > tol).sum())} elements over 16 eps sqrt(K) "
              f"(|want| + sqrt(a^2 @ b^2)), worst at {ratio:.2f}x)")
    return float(err.max()), ratio


def ef_forms(d, qm, P, pp, sp, gen, flush):
    """The EF add in the kernels (e as a second operand, added on the
    operand tile) against hoisted (delta + e once, one operand): the two
    must agree bit for bit, and the time of kernels 3-5 (with e') for
    each form decides which the driver uses (it hoists)."""
    from repro_torch.kernels import fused_compress as fc

    m, n = d.shape
    e = torch.randn((m, n), generator=gen, device=d.device) * 0.05

    def fused():
        P3 = fc.cuda_project(d, e, qm)
        Q, pq, sq = fc.cuda_project_t_pack(d, e, P)
        return (P3, Q, pq, sq) + fc.cuda_reconstruct(pp, sp, pq, sq, d, e, m,
                                                     n, RANK)

    def hoisted():
        de = d + e
        P3 = fc.cuda_project(de, None, qm)
        Q, pq, sq = fc.cuda_project_t_pack(de, None, P)
        return (P3, Q, pq, sq) + fc.cuda_reconstruct(pp, sp, pq, sq, de,
                                                     None, m, n, RANK)

    for a, b, what in zip(fused(), hoisted(), ("P", "Q", "packed Q",
                                               "scales Q", "recon", "e'")):
        if not torch.equal(a, b):
            _fail(f"EF m={m} n={n}: {what} of the fused EF form differs "
                  f"from the hoisted one")
    t_fused = time_ms(fused, iters=10, flush=flush)
    t_hoist = time_ms(hoisted, iters=10, flush=flush)
    print(f"EF add m={m} n={n}, kernels 3-5 with e': fused in the kernels "
          f"{t_fused:.4f} ms, hoisted into one add {t_hoist:.4f} ms "
          f"(bitwise equal)", flush=True)


def compressor_kernels():
    """Each compressor kernel against its plain version at every leaf shape
    of the training configuration; returns per-kernel rows whose times are
    summed over one cluster's compressor call (each shape times its count
    in the tree)."""
    from repro_torch.core.compression import LowRankQuant, _orthonormalize
    from repro_torch.kernels import fused_compress as fc
    from repro_torch.kernels import lowrank_mm as lm
    from repro_torch.kernels import quant4 as q4
    from repro_torch.kernels import ref

    _phase("kernel vs plain: the compressor (quant4, fused_compress)")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    low, quant = leaf_shapes(train_config())
    tot = {k[0]: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                      nbytes=0, flops=0, max_abs_err=0.0)
           for k in COMPRESS_KERNELS}

    def add(name, count, ms, plain_ms, lib_ms, nbytes, flops, err):
        t = tot[name]
        t["ms"] += count * ms
        t["plain_ms"] += count * plain_ms
        t["library_ms"] = (None if lib_ms is None
                           else t["library_ms"] + count * lib_ms)
        t["nbytes"] += count * nbytes
        t["flops"] += count * flops
        t["max_abs_err"] = max(t["max_abs_err"], err)

    # quant-only leaves: pack + unpack on the flat leaf
    for n_el, count in sorted(quant.items()):
        x = torch.randn(n_el, generator=gen, device=dev) * 0.05
        p, s = q4.quant4_pack(x)
        out = q4.quant4_unpack(p, s, n_el)
        p_ref, s_ref, _ = ref.quant4_pack_ref(x.cpu())
        if not torch.equal(p.cpu(), p_ref) or not torch.equal(s.cpu(), s_ref):
            _fail(f"quant4_pack n={n_el}: bytes or scales differ from the "
                  f"plain version")
        if not torch.equal(out.cpu(), ref.quant4_unpack_ref(p_ref, s_ref,
                                                            n_el)):
            _fail(f"quant4_unpack n={n_el}: not exact")
        nb_pack = 4 * n_el + _nblk(n_el) * (128 + 4)
        ms = time_ms(lambda: q4.cuda_quant4_pack(x), flush=flush)
        plain = time_ms(lambda: ref.quant4_pack_ref(x), flush=flush)
        add("quant4_pack", count, ms, plain, None, nb_pack, 5 * n_el, 0.0)
        ms_u = time_ms(lambda: q4.cuda_quant4_unpack(p, s, n_el), flush=flush)
        plain_u = time_ms(lambda: ref.quant4_unpack_ref(p, s, n_el),
                          flush=flush)
        add("quant4_unpack", count, ms_u, plain_u, None, nb_pack, n_el, 0.0)
        print(f"quant-only n={n_el} x{count}: pack {ms:.4f} ms (plain "
              f"{plain:.4f}), unpack {ms_u:.4f} ms (plain {plain_u:.4f})",
              flush=True)

    # low-rank leaves: the fused pipeline, gates at r_t = 64 and 40
    ref_comp = LowRankQuant(rank=RANK, backend="ref")
    for (m, n), count in sorted(low.items()):
        d = torch.randn((m, n), generator=gen, device=dev) * 0.3
        q = torch.randn((n, RANK), generator=gen, device=dev)
        # the tests' rtol/atol 1e-5 for q_new holds for sums of up to 2,048
        # terms; two f32 summation orders drift apart as sqrt(K)
        q_tol = 1e-5 * math.sqrt(max(m, n, 2048) / 2048)
        for rt in (RANK, 40):
            hat, _, q_new, pay = fc.fused_compress_ef(d, None, q, rt,
                                                      compute_error=False)
            dec = fc.fused_decompress(pay.packed_p, pay.scales_p,
                                      pay.packed_q, pay.scales_q, m, n, RANK)
            err = _check_payload(f"fused m={m} n={n} r_t={rt}",
                                 pay.p_factor, pay.q_factor, pay.packed_p,
                                 pay.scales_p, pay.packed_q, pay.scales_q,
                                 hat, dec, rt)
            hat_r, q_r = ref_comp._one(d, q, rt)
            one_step = (float(pay.scales_p.max()) * float(
                pay.q_factor.abs().max()) + float(pay.scales_q.max())
                * float(pay.p_factor.abs().max()))
            chain = float((hat - hat_r).abs().max())
            if chain > one_step:
                _fail(f"fused m={m} n={n} r_t={rt}: {chain:.3e} from the ref "
                      f"chain, more than one int4 step per factor "
                      f"({one_step:.3e})")
            if rt < RANK and q_new[:, rt:].any():
                _fail(f"fused m={m} n={n}: q_new columns >= {rt} not zero")
            # the mesh runtime's decompression of the same payload: the same
            # decode (quant4 unpack's rule) and the same K-resident GEMM
            Pu = q4.cuda_quant4_unpack(pay.packed_p, pay.scales_p,
                                       m * RANK).reshape(m, RANK)
            Qu = q4.cuda_quant4_unpack(pay.packed_q, pay.scales_q,
                                       n * RANK).reshape(n, RANK)
            if not torch.equal(hat, lm.cuda_matmul(Pu, Qu.T)):
                _fail(f"fused m={m} n={n} r_t={rt}: recon differs from "
                      f"lowrank_mm(unpack P, unpack Q^T)")
            del Pu, Qu
            q_gap = (q_new - q_r).abs()
            q_ratio = float((q_gap / (q_tol * (1 + q_r.abs()))).max())
            if q_ratio > 1.0:
                _fail(f"fused m={m} n={n} r_t={rt}: q_new off the ref "
                      f"chain's by {float(q_gap.max()):.3e}, over rtol/atol "
                      f"{q_tol:.3e} ({q_ratio:.2f}x)")
            again = fc.fused_compress_ef(d, None, q, rt, compute_error=False)
            for what, a, b in zip(("recon", "q_new") + pay._fields,
                                  (hat, q_new) + tuple(pay),
                                  (again[0], again[2]) + tuple(again[3])):
                if not torch.equal(a, b):
                    _fail(f"fused m={m} n={n} r_t={rt}: {what} differs "
                          f"between two calls")
            print(f"m={m} n={n} r_t={rt} x{count}: recon vs oracle "
                  f"{err:.3e}, vs ref chain {chain:.3e} (one int4 step "
                  f"{one_step:.3e}), q_new vs ref chain at {q_ratio:.3f}x "
                  f"rtol/atol {q_tol:.3e}; two calls bitwise equal; recon "
                  f"bitwise lowrank_mm(unpack P, unpack Q^T)", flush=True)
            del hat, dec, hat_r, q_r, q_new, again
        # times at r_t = 64, the trainer's variant (no EF operand)
        qm = q.contiguous()
        tag = f"m={m} n={n}"
        P = fc.cuda_project(d, None, qm)
        P_plain = fc.project_plain(d, None, qm)
        err3, ratio3 = _gate_product(f"fused_project {tag}", P, P_plain, d,
                                     qm)
        if not torch.equal(P, fc.cuda_project(d, None, qm)):
            _fail(f"fused_project {tag}: two calls differ")
        P = (_orthonormalize(P)).contiguous()
        Q, pq, sq = fc.cuda_project_t_pack(d, None, P)
        Q_plain, _, _ = fc.project_t_pack_plain(d, None, P)
        err4, ratio4 = _gate_product(f"fused_project_t_pack {tag}", Q,
                                     Q_plain, d.T, P)
        for a, b in zip((Q, pq, sq), fc.cuda_project_t_pack(d, None, P)):
            if not torch.equal(a, b):
                _fail(f"fused_project_t_pack {tag}: two calls differ")
        plans = {name: (tiles, S, tiles * S) for name, (tiles, S, _) in (
            ("project", fc._proj_plan(m, n)),
            ("t_pack", fc._proj_t_plan(m, n)))}
        pp, sp = q4.cuda_quant4_pack(P.reshape(-1))
        hat, _ = fc.cuda_reconstruct(pp, sp, pq, sq, None, None, m, n, RANK,
                                     with_ef=False)
        hat_plain, _ = fc.reconstruct_plain(pp, sp, pq, sq, None, None, m, n,
                                            RANK, with_ef=False)
        Pq = ref.quant4_unpack_ref(pp, sp, m * RANK).reshape(m, RANK)
        Qq = ref.quant4_unpack_ref(pq, sq, n * RANK).reshape(n, RANK)
        gap5 = (hat - hat_plain).abs()
        err5 = float(gap5.max())
        if bool((gap5 > 16 * torch.finfo(torch.float32).eps
                 * (Pq.abs() @ Qq.abs().T) + 1e-30).any()):
            _fail(f"fused_reconstruct {tag}: off its plain version by "
                  f"{err5:.3e} > 16 eps |Pq||Qq|^T")
        del gap5
        flops = 2 * m * n * RANK
        mn, mr, nr = m * n, m * RANK, n * RANK
        t3 = time_ms(lambda: fc.cuda_project(d, None, qm), flush=flush)
        p3 = time_ms(lambda: fc.project_plain(d, None, qm), flush=flush)
        l3 = time_ms(lambda: torch.matmul(d, qm), flush=flush)
        add("fused_project", count, t3, p3, l3, 4 * (mn + nr + mr), flops,
            err3)
        t4 = time_ms(lambda: fc.cuda_project_t_pack(d, None, P), flush=flush)
        p4 = time_ms(lambda: fc.project_t_pack_plain(d, None, P), flush=flush)
        l4 = time_ms(lambda: torch.matmul(d.T, P), flush=flush)
        add("fused_project_t_pack", count, t4, p4, l4,
            4 * (mn + mr + nr) + nr // 2 + 4 * _nblk(nr), flops, err4)
        t1 = time_ms(lambda: q4.cuda_quant4_pack(P.reshape(-1)), flush=flush)
        pl1 = time_ms(lambda: ref.quant4_pack_ref(P.reshape(-1)), flush=flush)
        add("quant4_pack", count, t1, pl1, None,
            4 * mr + mr // 2 + 4 * _nblk(mr), 5 * mr, 0.0)
        t5 = time_ms(lambda: fc.cuda_reconstruct(pp, sp, pq, sq, None, None,
                                                 m, n, RANK, with_ef=False),
                     flush=flush)
        p5 = time_ms(lambda: fc.reconstruct_plain(pp, sp, pq, sq, None, None,
                                                  m, n, RANK, with_ef=False),
                     flush=flush)
        l5 = time_ms(lambda: torch.matmul(Pq, Qq.T), flush=flush)
        add("fused_reconstruct", count, t5, p5, l5,
            (mr + nr) // 2 + 4 * (_nblk(mr) + _nblk(nr)) + 4 * mn, flops,
            err5)
        b3, _ = _bound(4 * (mn + nr + mr), flops)
        b4, _ = _bound(4 * (mn + mr + nr) + nr // 2 + 4 * _nblk(nr), flops)
        print(f"m={m} n={n} x{count} ms kernel/plain/matmul: project "
              f"{t3:.4f}/{p3:.4f}/{l3:.4f} t_pack {t4:.4f}/{p4:.4f}/{l4:.4f} "
              f"pack(P) {t1:.4f}/{pl1:.4f} recon {t5:.4f}/{p5:.4f}/{l5:.4f}; "
              f"max abs err vs plain {err3:.3e} {err4:.3e} {err5:.3e} "
              f"(project, t_pack at {ratio3:.4f}x, {ratio4:.4f}x their "
              f"tolerance, two calls bitwise equal); bound ms project "
              f"{b3:.4f} t_pack {b4:.4f}; split-K plan (tiles, S, blocks): "
              f"project {plans['project']} t_pack {plans['t_pack']}",
              flush=True)
        if (m, n) == max(low, key=lambda k: k[0] * k[1]):
            ef_forms(d, qm, P, pp, sp, gen, flush)
        del d, q, qm, P, P_plain, Q, Q_plain, pq, sq, pp, sp, hat
        del hat_plain, Pq, Qq
        torch.cuda.empty_cache()

    rows = []
    for name, attr, source, replaces in COMPRESS_KERNELS:
        t = tot[name]
        bound_ms, bound_by = _bound(t["nbytes"], t["flops"])
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "wrapper": attr,
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": t["library_ms"]})
        print(f"{name}: one cluster's compressor call: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"{t['library_ms']} ms, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
    return rows


def mesh_quant4_launches(cfg, rank=RANK):
    """The batched quant4 launches of one mesh round with one cluster
    (phase 4d): (what, rows, values a row) for each low-rank leaf's P and
    Q (a row per stacked matrix) and each quant-only leaf (one row)."""
    from repro_torch.core.compression import tree_shapes
    from repro_torch.core.mesh_compression import _leaf_matrix_dims
    from repro_torch.models import model as M

    out = []
    for path, shape in tree_shapes(M.init_params(cfg, device="meta")).items():
        lead, m, n = _leaf_matrix_dims(shape)
        if min(m, n) < 64:
            out.append((f"{path} quant-only", 1, lead * m * n))
            continue
        r = min(rank, m, n)
        out += [(f"{path} P", lead, m * r), (f"{path} Q", lead, n * r)]
    return out


def _wire_rows(t, gap, head, ranks=2):
    """The rows of ``t`` as a gathered wire buffer holds one factor's
    chunks: ``ranks`` equal buffers, each ``head`` other elements first
    (the scales region) and ``gap`` other elements before each row (the
    other factor's codes; an odd ``gap`` of bytes starts rows off any word
    boundary). A ``head`` > 0 puts the ranks a buffer apart, not a row
    stride, so the kernel takes them as groups of B rows (``_wire_groups``)."""
    B, k = t.shape
    zeros = lambda m: torch.zeros(m, dtype=t.dtype, device=t.device)
    buf = torch.cat([zeros(head)] + [x for row in t for x in (zeros(gap), row)])
    wire, L, step = buf.repeat(ranks), buf.numel(), gap + k
    return [wire[g * L + head + i * step + gap:][:k]
            for g in range(ranks) for i in range(B)]


def _wire_groups(rows, dtype, width):
    """(R, group stride, row stride) that the quant4 wrapper reads from
    ``rows``' starts, in elements."""
    from repro_torch.kernels import quant4 as q4

    return q4._rows("rows", rows, dtype, width)[2:]


def mesh_quant4(dev=None, cfg=None):
    """quant4's batched kernels at the launches of one mesh round (phase
    4d's shapes): each pack byte for byte its plain version row by row,
    each unpack exact, and a low-rank leaf's unpack of its rows' chunks
    as two ranks' gathered buffers hold them (``_wire_rows``: 2 groups
    of B rows, checked) bitwise the unpack of the pack's own rows. Times
    each batched launch beside its bytes bound and beside the same rows
    launched one at a time (the kernel at B = 1, back to back, so the
    host's launch gaps count); returns the sums over the round."""
    from repro_torch.kernels import quant4 as q4

    cfg = cfg or mesh_config()
    _phase(f"kernel vs plain: quant4 batched, one mesh round's launches "
           f"({cfg.name}, {cfg.n_layers} layers)")
    dev = dev or torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    tot = {k: dict(ms=0.0, one_ms=0.0, bound_ms=0.0, nbytes=0)
           for k in ("pack", "unpack")}
    launches = mesh_quant4_launches(cfg)
    for what, B, n in launches:
        x = torch.randn((B, n), generator=gen, device=dev) * 0.05
        p, s = q4.cuda_quant4_pack_batched(x)
        p_ref, s_ref = q4.pack_batched_plain(x)
        if not torch.equal(p, p_ref) or not torch.equal(s, s_ref):
            _fail(f"quant4_pack batched {what} ({B} x {n}): bytes or scales "
                  f"differ from the plain version")
        out = q4.cuda_quant4_unpack_batched(p, s, n)
        if not torch.equal(out, q4.unpack_batched_plain(p, s, n)):
            _fail(f"quant4_unpack batched {what} ({B} x {n}): not exact")
        if B > 1:
            pw, sw = _wire_rows(p, 101, 37), _wire_rows(s, 3, 5)
            if (_wire_groups(pw, torch.uint8, p.shape[1])[0] != B
                    or _wire_groups(sw, torch.float32, s.shape[1])[0] != B):
                _fail(f"quant4 {what}: the two-rank wire layout was not read "
                      f"as 2 groups of {B} rows")
            got = q4.cuda_quant4_unpack_batched(pw, sw, n)
            if not torch.equal(got, out.repeat(2, 1)):
                _fail(f"quant4_unpack batched {what}: rows read from a "
                      f"gathered wire layout differ from the pack's rows")
            del got, pw, sw
        nbytes = B * (4 * n + p.shape[1] + 4 * s.shape[1])
        times = {
            "pack": (time_ms(lambda: q4.cuda_quant4_pack_batched(x),
                             flush=flush),
                     time_ms(lambda: [q4.cuda_quant4_pack(row) for row in x],
                             flush=flush)),
            "unpack": (time_ms(lambda: q4.cuda_quant4_unpack_batched(
                p, s, n, out=out), flush=flush),
                time_ms(lambda: [q4.cuda_quant4_unpack(pr, sr, n)
                                 for pr, sr in zip(p, s)], flush=flush))}
        bound, _ = _bound(nbytes, 0)
        for k, (ms, one) in times.items():
            tot[k]["ms"] += ms
            tot[k]["one_ms"] += one
            tot[k]["bound_ms"] += bound
            tot[k]["nbytes"] += nbytes
        print(f"{what} ({B} x {n}): ms batched/one at a time/bound: pack "
              f"{times['pack'][0]:.4f}/{times['pack'][1]:.4f}/{bound:.4f}, "
              f"unpack {times['unpack'][0]:.4f}/{times['unpack'][1]:.4f}/"
              f"{bound:.4f}; bitwise the plain version", flush=True)
        del x, p, s, p_ref, s_ref, out
    for k, t in tot.items():
        print(f"quant4_{k}, one mesh round's {len(launches)} batched "
              f"launches: {t['ms']:.4f} ms (one row at a time "
              f"{t['one_ms']:.4f}), "
              f"bytes bound {t['bound_ms']:.4f} ms ({t['nbytes']} B): "
              f"{t['bound_ms'] / t['ms']:.3f} of the bound", flush=True)
    return tot


# ---------------------------------------------------------------------------
# phase 3c: flash attention, forward and backward kernels vs plain
# ---------------------------------------------------------------------------

FLASH_GATE = 2e-3      # the JAX gate, tests/test_kernels.py:99 (rtol, atol)
FLASH_CASES = [
    # name, B, Sq, Sk, H, KV, d, causal; the first is the training shape
    ("opt-1.3b train", 4, 512, 512, 32, 32, 64, True),
    ("opt-1.3b 2048", 1, 2048, 2048, 32, 32, 64, True),
    ("granite-3-8b", 1, 512, 512, 32, 8, 128, True),
    ("hundred-m", 4, 512, 512, 12, 4, 64, True),
    ("gemma3-1b global", 1, 512, 512, 4, 1, 256, True),
    ("tail S384", 1, 384, 384, 32, 32, 64, True),
    ("odd S200", 2, 200, 200, 4, 2, 32, True),
    ("non-causal", 1, 512, 512, 32, 32, 64, False),
    ("Sq384 < Sk512", 1, 384, 512, 16, 4, 64, True),
    ("Sq320 > Sk192", 1, 320, 192, 16, 4, 128, True),
    # one layer of the paper's model (section 4.1.1, configs/qwen1_5_107b):
    # G = 8, d 128, 4,096 keys
    ("qwen1.5-107b", 1, 4096, 4096, 64, 8, 128, True),
    # phi3-medium-14b: H 40 (not a power of two), KV 10, d 128
    ("phi3-medium-14b", 1, 512, 512, 40, 10, 128, True),
]
FLASH_PROFILED = ("opt-1.3b train", "granite-3-8b", "gemma3-1b global",
                  "qwen1.5-107b", "phi3-medium-14b")


def flash_pairs(Sq, Sk, causal):
    """Unmasked (query, key) pairs per head: key j is seen by query i iff
    j <= i under the top-left causal mask."""
    if not causal:
        return Sq * Sk
    return sum(min(i + 1, Sk) for i in range(Sq))


def flash_bound(B, Sq, Sk, H, KV, d, causal, bwd):
    """Least time of the forward (q, k, v -> o, lse: 4 d flops per pair)
    or the backward (q, k, v, o, lse, dO -> dq, dk, dv: 10 d flops per
    pair, S recomputed, then dP, dV, dK, dQ), each input read and each
    output written once. The kernels take each f32 product as three TF32
    tensor-core products (3xTF32), so the operations take 3 x flops at the
    TF32 rate. Returns (ms, "bytes" or "operations", and the same flops'
    time at the f32 SIMT rate, the bound before the tensor cores)."""
    pairs = B * H * flash_pairs(Sq, Sk, causal)
    n_q, n_kv, n_lse = B * Sq * H * d, B * Sk * KV * d, B * H * Sq
    if bwd:
        nbytes = 4 * (3 * n_q + 2 * n_kv + n_lse + n_q + 2 * n_kv)
        flops = 10 * d * pairs
    else:
        nbytes, flops = 4 * (2 * n_q + 2 * n_kv + n_lse), 4 * d * pairs
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 3 * flops / TF32_FLOPS_PER_S * 1e3
    return (max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            flops / F32_FLOPS_PER_S * 1e3)


def flash_tolerances(q, k, v, o, lse, do, causal, u=0.0):
    """Elementwise f32 bounds for o, dq, dk, dv: 16 eps (sqrt(n) + sqrt(d)
    (1 + a)) times the magnitude of the terms each output sums (|P||V|;
    scale |P (|dO||V|^T + D_abs + |dP - D|)| |K| or its transpose with |Q|;
    |P|^T |dO|). sqrt(n) covers an n-term f32 sum in any order (n = Sk for
    o and dq, G Sq for dk and dv); sqrt(d) (1 + a), a = max |q||k|^T /
    sqrt(d), covers the relative error a d-term score carries into P
    through exp. Sixteen times what a correct kernel can be expected to
    be off; a dropped k tile or a wrong mask lane misses by ~P |v|.
    ``u``: a relative error of P and dS as they enter their products (the
    bf16 kernels' rounding of them to bf16, ``flash_kernels_bf16``), added
    twice to each factor; the inputs are then the bf16 ones in f32."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    eps = torch.finfo(torch.float32).eps
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, Sq, KV, G, d)
    a = float(torch.einsum("bqkgd,bskd->bkgqs", qg.abs(), k.abs()).amax()
              ) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    if causal:
        keep = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    del s
    dog = do.reshape(B, Sq, KV, G, d)
    D = (do * o).sum(-1).reshape(B, Sq, KV, G).permute(0, 2, 3, 1)[..., None]
    D_abs = (do * o).abs().sum(-1).reshape(B, Sq, KV, G).permute(
        0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v)
    mag = p * (torch.einsum("bqkgd,bskd->bkgqs", dog.abs(), v.abs()) + D_abs
               + (dp - D).abs())
    del dp

    def factor(n):
        return 16 * eps * (math.sqrt(n) + math.sqrt(d) * (1 + a)) + 2 * u

    tol_o = factor(Sk) * torch.einsum("bkgqs,bskd->bqkgd", p, v.abs()
                                      ).reshape(B, Sq, H, d)
    tol_dq = factor(Sk) * scale * torch.einsum(
        "bkgqs,bskd->bqkgd", mag, k.abs()).reshape(B, Sq, H, d)
    tol_dk = factor(G * Sq) * scale * torch.einsum("bkgqs,bqkgd->bskd", mag,
                                                   qg.abs())
    tol_dv = factor(G * Sq) * torch.einsum("bkgqs,bqkgd->bskd", p, dog.abs())
    return tol_o, (tol_dq, tol_dk, tol_dv), a


def _gate(name, got, want, tol):
    """|got - want| <= tol elementwise; returns (max abs err, worst
    err / tol)."""
    err = (got - want).abs()
    ratio = float((err / tol.clamp_min(1e-30)).max())
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        _fail(f"{name}: kernel off its plain version by {float(err.max()):.3e}"
              f" ({int((err > tol).sum())} elements over the f32 bound, "
              f"worst at {ratio:.2f}x)")
    return float(err.max()), ratio


def kernel_profile(fn, reps=5):
    """Device microseconds per call of each CUDA kernel that ``fn``
    launches (``torch.profiler`` over ``reps`` calls after one, L2 warm)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0]: e.device_time_total / reps
            for e in prof.key_averages() if e.device_time_total > 0}


def library_attention(q, k, v, causal):
    """Yardstick only (the port never calls it): PyTorch's fused attention
    on the (B, heads, S, d) views of the same tensors."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True).transpose(1, 2)


def flash_occupancy_check(dtype=torch.float32):
    """The plans' model of each kernel (``_plan``: shared memory bytes, and
    blocks an SM as many as those fit, at most the launch bound's:
    ``flash_fwd_blocks`` for the forward, ``flash_bwd_blocks`` for dK/dV
    and dQ; in f32 2 of 4 warps or 1 of 8) against what the library
    launches and the CUDA runtime reports, at every head dim, for the f32
    or the bf16 kernels; prints the resident warps an SM."""
    from repro_torch.kernels import _plan
    from repro_torch.kernels import flash_attention as fa

    es = torch.empty((), dtype=dtype).element_size()
    model = {"fwd": _plan.flash_fwd_smem, "dkdv": _plan.flash_dkdv_smem,
             "dq": _plan.flash_dq_smem}
    for d in fa.HEAD_DIMS:
        occ = fa.cuda_flash_occupancy(d, dtype)
        bounds = dict(zip(("fwd", "dkdv", "dq"),
                          (_plan.flash_fwd_blocks(d, es),)
                          + _plan.flash_bwd_blocks(d, es)))
        warps = []
        for kind, (threads, smem, blocks) in occ.items():
            groups = 1 if kind == "fwd" else _plan.flash_groups(d)
            bound = bounds[kind]
            want = (128 * groups, model[kind](d, es),
                    _plan.flash_blocks_per_sm(model[kind](d, es), bound))
            if (threads, smem, min(blocks, bound)) != want:
                _fail(f"flash {kind} d {d} {dtype}: the library launches "
                      f"{threads} threads with {smem} B of shared memory, "
                      f"{blocks} blocks an SM; _plan models {want[0]} "
                      f"threads, {want[1]} B, {want[2]} blocks")
            warps.append(f"{kind} {blocks} x {threads // 32}")
        print(f"flash d {d} {dtype}: blocks x warps an SM (CUDA occupancy) "
              + ", ".join(warps) + "; _plan's warps an SM fwd/dkdv/dq "
              + "/".join(map(str, _plan.flash_warps_per_sm(d, es))),
              flush=True)


def ptxas_kernel_report(lib, kernel):
    """{template argument: (registers, spill store bytes, spill load bytes,
    ptxas's warnings)} of each instantiation of ``kernel`` in library
    ``lib``, from this run's ``nvcc -Xptxas -v`` output (empty where the
    library was built before this run)."""
    from repro_torch.kernels import _build

    out, at = {}, None
    for line in _build.ptxas_report.get(lib, "").splitlines():
        hit = re.search(rf"_Z\d+{kernel}ILi(\d+)E", line)
        if "warning" in line.lower():
            if hit:
                out.setdefault(int(hit[1]), [None, None, None, []])[3].append(
                    line.strip())
            continue
        if "Compiling entry function" in line or "Function properties" in line:
            at = int(hit[1]) if hit else None
            if at is not None:
                out.setdefault(at, [None, None, None, []])
        if at is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if spill:
            out[at][1:3] = [int(spill[1]), int(spill[2])]
        elif regs:
            out[at][0] = int(regs[1])
    return {k: tuple(v) for k, v in sorted(out.items())}


def flash_kernels(dev=None, cases=FLASH_CASES):
    """Forward and backward kernels against their plain versions at each
    case, the backward fed the plain forward's (o, lse) so that it is
    judged on its own; gates, times and bounds. Returns the rows of the
    two kernels at the training shape (the first case), with the worst
    errors over all cases."""
    from repro_torch.kernels import _plan, ref
    from repro_torch.kernels import flash_attention as fa

    _phase("kernel vs plain: flash attention, forward and backward")
    dev = dev or torch.device("cuda")
    flash_occupancy_check()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    worst = {"fwd": 0.0, "bwd": 0.0}
    worst_ratio = {"fwd": (0.0, ""), "bwd": (0.0, "")}
    rows, per_case = {}, {}
    for name, B, Sq, Sk, H, KV, d, causal in cases:
        q = torch.randn((B, Sq, H, d), generator=gen, device=dev)
        k = torch.randn((B, Sk, KV, d), generator=gen, device=dev)
        v = torch.randn((B, Sk, KV, d), generator=gen, device=dev)
        do = torch.randn((B, Sq, H, d), generator=gen, device=dev)
        o, lse = fa.cuda_flash_attention_fwd(q, k, v, causal)
        o2, lse2 = fa.cuda_flash_attention_fwd(q, k, v, causal)
        o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, causal)
        grads = fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
        again = fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
        grads_p = ref.flash_attention_bwd_ref(q, k, v, o_p, lse_p, do, causal)
        torch.cuda.synchronize()
        gap = (o - o_p).abs()
        if bool((gap > FLASH_GATE + FLASH_GATE * o_p.abs()).any()):
            _fail(f"flash fwd {name}: outside the JAX gate rtol/atol "
                  f"{FLASH_GATE} (max abs err {float(gap.max()):.3e})")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            _fail(f"flash fwd {name}: o or lse differs between two calls")
        del o2, lse2
        tol_o, tol_g, a = flash_tolerances(q, k, v, o_p, lse_p, do, causal)
        err_o, ratio_o = _gate(f"flash fwd {name} o", o, o_p, tol_o)
        err_lse = float((lse - lse_p).abs().max())
        if err_lse > 16 * torch.finfo(torch.float32).eps * (
                float(lse_p.abs().max()) + math.sqrt(d) * (1 + a)):
            _fail(f"flash fwd {name}: lse off by {err_lse:.3e}")
        errs, ratios = [], []
        for g_name, g, g2, w, t in zip(("dq", "dk", "dv"), grads, again,
                                       grads_p, tol_g):
            if not torch.equal(g, g2):
                _fail(f"flash bwd {name}: {g_name} differs between two calls")
            e, r = _gate(f"flash bwd {name} {g_name}", g, w, t)
            errs.append(e)
            ratios.append(r)
        del tol_o, tol_g, again
        worst["fwd"] = max(worst["fwd"], err_o)
        worst["bwd"] = max(worst["bwd"], *errs)
        worst_ratio["fwd"] = max(worst_ratio["fwd"], (ratio_o, f"{name} o"))
        worst_ratio["bwd"] = max(worst_ratio["bwd"], *(
            (r, f"{name} {g_name}")
            for r, g_name in zip(ratios, ("dq", "dk", "dv"))))

        ms_f = time_ms(lambda: fa.cuda_flash_attention_fwd(q, k, v, causal),
                       flush=flush)
        plain_f = time_ms(lambda: ref.flash_attention_fwd_ref(q, k, v, causal),
                          flush=flush)
        lib_f = time_ms(lambda: library_attention(q, k, v, causal),
                        flush=flush)
        ms_b = time_ms(lambda: fa.cuda_flash_attention_bwd(
            q, k, v, o_p, lse_p, do, causal), flush=flush)
        plain_b = time_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o_p, lse_p, do, causal), flush=flush)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o_l = library_attention(ql, kl, vl, causal)
        lib_b = time_ms(lambda: torch.autograd.grad(
            o_l, (ql, kl, vl), do, retain_graph=True), flush=flush)

        def lib_fwd_bwd():
            out = library_attention(ql, kl, vl, causal)
            return torch.autograd.grad(out, (ql, kl, vl), do)

        lib_fb = time_ms(lib_fwd_bwd, flush=flush)
        bound_f, by_f, simt_f = flash_bound(B, Sq, Sk, H, KV, d, causal,
                                            bwd=False)
        bound_b, by_b, simt_b = flash_bound(B, Sq, Sk, H, KV, d, causal,
                                            bwd=True)
        f_split, f_chunk = _plan.flash_fwd_plan(B, H, Sq, Sk, d)
        split, chunk, parts = _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d)
        blocks = _plan.flash_dkdv_blocks(B, H, Sk, split)
        dq_split, dq_chunk = _plan.flash_dq_plan(B, H, Sq, Sk, d)
        q_blocks = B * H * -(-Sq // _plan.FLASH_ROWS)
        print(f"{name} (B {B} Sq {Sq} Sk {Sk} H {H} KV {KV} d {d} causal "
              f"{causal}): fwd plan split {f_split} chunk {f_chunk} blocks "
              f"{q_blocks * f_split}, dK/dV plan split {split} chunk {chunk}"
              f" parts {parts} blocks {blocks}, dQ plan split {dq_split} "
              f"chunk {dq_chunk} blocks {q_blocks * dq_split}; warps an SM "
              f"fwd/dkdv/dq {'/'.join(map(str, _plan.flash_warps_per_sm(d)))}"
              f"; bound ms "
              f"3xTF32/f32 SIMT fwd {bound_f:.4f}/"
              f"{simt_f:.4f} bwd {bound_b:.4f}/{simt_b:.4f}; fwd max abs "
              f"err o {err_o:.3e} ({ratio_o:.4f}x "
              f"its f32 bound) lse {err_lse:.3e}; bwd dq/dk/dv "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} ({ratios[0]:.4f}/"
              f"{ratios[1]:.4f}/{ratios[2]:.4f}x), fwd and bwd bitwise "
              f"reproducible; "
              f"ms kernel/plain/sdpa/bound: fwd {ms_f:.4f}/{plain_f:.4f}/"
              f"{lib_f:.4f}/{bound_f:.4f} ({by_f}), bwd {ms_b:.4f}/"
              f"{plain_b:.4f}/{lib_b:.4f}/{bound_b:.4f} ({by_b}); sdpa "
              f"fwd+bwd {lib_fb:.4f}, kernels fwd+bwd {ms_f + ms_b:.4f}",
              flush=True)
        if name in FLASH_PROFILED:
            prof = kernel_profile(lambda: (
                fa.cuda_flash_attention_fwd(q, k, v, causal),
                fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)))
            print(f"{name}: us per call by kernel (torch.profiler, L2 warm): "
                  + ", ".join(f"{k_} {us:.1f}" for k_, us in prof.items()),
                  flush=True)
        per_case[name] = {"fwd": dict(ms=ms_f, plain_ms=plain_f,
                                   bound_ms=bound_f, library_ms=lib_f,
                                   max_abs_err=err_o),
                       "bwd": dict(ms=ms_b, plain_ms=plain_b,
                                   bound_ms=bound_b, library_ms=lib_b,
                                   max_abs_err=max(errs))}
        if not rows:
            src = "src/repro_torch/csrc/flash_attention.cu"
            tpu = "src/repro/kernels/flash_attention.py:24"
            rows = {
                "flash_attention": dict(
                    name="flash_attention", route="cuda", source=src,
                    replaces=tpu, ms=ms_f, plain_ms=plain_f, bound_ms=bound_f,
                    bound_by=by_f, library_ms=lib_f),
                "flash_attention_bwd": dict(
                    name="flash_attention_bwd", route="cuda", source=src,
                    replaces=tpu, ms=ms_b, plain_ms=plain_b, bound_ms=bound_b,
                    bound_by=by_b, library_ms=lib_b)}
        del q, k, v, do, o, lse, o_p, lse_p, grads, grads_p, ql, kl, vl, o_l
        torch.cuda.empty_cache()
    rows["flash_attention"]["max_abs_err"] = worst["fwd"]
    rows["flash_attention_bwd"]["max_abs_err"] = worst["bwd"]
    for kind, key in (("fwd", "flash_attention"),
                      ("bwd", "flash_attention_bwd")):
        rows[key]["cases"] = {name: c[kind] for name, c in per_case.items()}
    for kind in ("fwd", "bwd"):
        r, at = worst_ratio[kind]
        print(f"flash {kind}: worst error {r:.4f} of the f32 bound "
              f"(flash_tolerances), at {at}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 3c-bf16: the flash kernels' bf16 instantiations vs plain
# ---------------------------------------------------------------------------

FLASH_GATE_BF16 = 2e-2   # the JAX bf16 gate (tests/test_kernels.py:103-113,
                         # rtol and atol), on the forward
BF16_ULP = 2.0 ** -7     # a bf16 ulp, relative to the value (at most)


def flash_bound_bf16(B, Sq, Sk, H, KV, d, causal, bwd):
    """``flash_bound`` over bf16 tensors (lse and D f32): the bytes at 2 a
    q, k, v, o, dO, dq, dk, dv element, the flops once at the bf16 tensor
    rate."""
    pairs = B * H * flash_pairs(Sq, Sk, causal)
    n_q, n_kv, n_lse = B * Sq * H * d, B * Sk * KV * d, B * H * Sq
    if bwd:
        nbytes = 2 * (3 * n_q + 2 * n_kv + n_q + 2 * n_kv) + 4 * n_lse
        flops = 10 * d * pairs
    else:
        nbytes, flops = 2 * (2 * n_q + 2 * n_kv) + 4 * n_lse, 4 * d * pairs
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _gate_bf16(name, got, want, tol):
    """``_gate`` on bf16 outputs: the f32 bound ``tol`` plus one bf16
    rounding of each side (an ulp of the plain value)."""
    want = want.float()
    return _gate(name, got.float(), want, tol + BF16_ULP * want.abs())


def flash_kernels_bf16(dev=None, cases=FLASH_CASES):
    """Phase 3c-bf16: the bf16 forward and backward against their plain
    versions (f32 inside, bf16 out) on the same bf16 inputs at phase 3c's
    cases: each output within an f32-accumulation bound
    (``flash_tolerances`` with u = 2^-8, P's and dS's rounding to bf16 as
    they enter their products, plus an ulp of the output), the forward
    also within the JAX bf16 gate, two calls bit for bit; ms beside the
    bound at the bf16 tensor rate, the plain versions' and SDPA's on bf16,
    forward and backward. Returns the kernels' rows at the training shape
    with the worst errors."""
    from repro_torch.kernels import _plan, ref
    from repro_torch.kernels import flash_attention as fa

    _phase("kernel vs plain: flash attention bf16, forward and backward")
    dev = dev or torch.device("cuda")
    flash_occupancy_check(torch.bfloat16)
    for kind, kernel in (("fwd", "flash_fwd_wgmma_kernel"),
                         ("dkdv", "flash_bwd_dkdv_wgmma_kernel"),
                         ("dq", "flash_bwd_dq_wgmma_kernel")):
        report = ptxas_kernel_report("flash_attention", kernel)
        for d in fa.HEAD_DIMS:
            regs, st, ld, warns = report.get(d, (None, None, None, []))
            print(f"flash bf16 {kind} (wgmma) d {d}: ptxas "
                  + (f"{regs} registers, spill stores/loads {st}/{ld} B"
                     if regs is not None else "not in this run's build")
                  + "".join(f"; {w}" for w in warns), flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bf = torch.bfloat16
    worst = {kind: (0.0, 0.0, "") for kind in ("fwd", "bwd")}
    rows, per_case = {}, {}
    for name, B, Sq, Sk, H, KV, d, causal in cases:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(bf)
                       for shape in ((B, Sq, H, d), (B, Sk, KV, d),
                                     (B, Sk, KV, d), (B, Sq, H, d)))
        o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, causal)
        grads_p = ref.flash_attention_bwd_ref(q, k, v, o_p, lse_p, do, causal)
        o, lse = fa.cuda_flash_attention_fwd(q, k, v, causal)
        o2, lse2 = fa.cuda_flash_attention_fwd(q, k, v, causal)
        grads = fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
        again = fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)) or not all(
                torch.equal(g, g2) for g, g2 in zip(grads, again)):
            _fail(f"flash bf16 {name}: two calls differ")
        gap = (o.float() - o_p.float()).abs()
        if bool((gap > FLASH_GATE_BF16
                 + FLASH_GATE_BF16 * o_p.float().abs()).any()):
            _fail(f"flash bf16 fwd {name}: outside the JAX gate "
                  f"{FLASH_GATE_BF16} (max abs err {float(gap.max()):.3e})")
        tol_o, tol_g, a = flash_tolerances(
            q.float(), k.float(), v.float(), o_p.float(), lse_p, do.float(),
            causal, u=2.0 ** -8)
        err_f, r_o = _gate_bf16(f"flash bf16 fwd {name} o", o, o_p, tol_o)
        err_lse = float((lse - lse_p).abs().max())
        if err_lse > 16 * torch.finfo(torch.float32).eps * (
                float(lse_p.abs().max()) + math.sqrt(d) * (1 + a)):
            _fail(f"flash bf16 fwd {name}: lse off by {err_lse:.3e}")
        errs, ratios = [], []
        for g_name, g, w, t in zip(("dq", "dk", "dv"), grads, grads_p, tol_g):
            e, r = _gate_bf16(f"flash bf16 bwd {name} {g_name}", g, w, t)
            errs.append(e)
            ratios.append(r)
        err_b = max(errs)
        del tol_o, tol_g, again, o2, lse2, o, lse, grads
        worst["fwd"] = max(worst["fwd"], (r_o, err_f, name))
        worst["bwd"] = max(worst["bwd"], (max(ratios), err_b, name))
        ms_f = time_ms(lambda: fa.cuda_flash_attention_fwd(q, k, v, causal),
                       flush=flush)
        plain_f = time_ms(lambda: ref.flash_attention_fwd_ref(q, k, v, causal),
                          flush=flush)
        lib_f = time_ms(lambda: library_attention(q, k, v, causal),
                        flush=flush)
        ms_b = time_ms(lambda: fa.cuda_flash_attention_bwd(
            q, k, v, o_p, lse_p, do, causal), flush=flush)
        plain_b = time_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o_p, lse_p, do, causal), flush=flush)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o_l = library_attention(ql, kl, vl, causal)
        lib_b = time_ms(lambda: torch.autograd.grad(
            o_l, (ql, kl, vl), do, retain_graph=True), flush=flush)
        bound_f, by_f = flash_bound_bf16(B, Sq, Sk, H, KV, d, causal, False)
        bound_b, by_b = flash_bound_bf16(B, Sq, Sk, H, KV, d, causal, True)
        f_split, f_chunk = _plan.flash_fwd_plan(B, H, Sq, Sk, d, 2)
        split, chunk, parts = _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d, 2)
        dq_split, dq_chunk = _plan.flash_dq_plan(B, H, Sq, Sk, d, 2)
        print(f"{name} bf16 (B {B} Sq {Sq} Sk {Sk} H {H} KV {KV} d {d} "
              f"causal {causal}): fwd plan split {f_split} chunk {f_chunk}"
              f" (k tiles of {_plan.flash_tile(d, 2)}), dK/dV plan split "
              f"{split} chunk {chunk} parts {parts} (q tiles of "
              f"{_plan.flash_q_tile(d, 2)}), dQ plan split {dq_split} chunk "
              f"{dq_chunk} (k tiles of {_plan.flash_dq_tile(d, 2)}), warps "
              f"an SM fwd/"
              f"dkdv/dq {'/'.join(map(str, _plan.flash_warps_per_sm(d, 2)))}"
              f"; max abs err o {err_f:.3e} ({r_o:.4f}x "
              f"bound) lse {err_lse:.3e} dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/"
              f"{errs[2]:.3e} ({ratios[0]:.4f}/{ratios[1]:.4f}/"
              f"{ratios[2]:.4f}x); two calls bitwise; ms kernel/plain/sdpa/"
              f"bound: fwd {ms_f:.4f}/{plain_f:.4f}/{lib_f:.4f}/"
              f"{bound_f:.4f} ({by_f}), bwd {ms_b:.4f}/{plain_b:.4f}/"
              f"{lib_b:.4f}/{bound_b:.4f} ({by_b})", flush=True)
        if name in FLASH_PROFILED:
            prof = kernel_profile(lambda: (
                fa.cuda_flash_attention_fwd(q, k, v, causal),
                fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)))
            print(f"{name} bf16: us per call by kernel (torch.profiler, L2 "
                  f"warm): " + ", ".join(f"{k_} {us:.1f}"
                                         for k_, us in prof.items()),
                  flush=True)
        per_case[name] = {
            "fwd": dict(ms=ms_f, plain_ms=plain_f, bound_ms=bound_f,
                        library_ms=lib_f, max_abs_err=err_f),
            "bwd": dict(ms=ms_b, plain_ms=plain_b, bound_ms=bound_b,
                        library_ms=lib_b, max_abs_err=err_b)}
        if not rows:
            src = "src/repro_torch/csrc/flash_attention.cu"
            tpu = "src/repro/kernels/flash_attention.py:24"
            for key, ms, plain, bound, by, lib in (
                    ("flash_attention_bf16", ms_f, plain_f, bound_f, by_f,
                     lib_f),
                    ("flash_attention_bwd_bf16", ms_b, plain_b, bound_b, by_b,
                     lib_b)):
                rows[key] = dict(name=key, route="cuda", source=src,
                                 replaces=tpu, ms=ms, plain_ms=plain,
                                 bound_ms=bound, bound_by=by, library_ms=lib)
        del q, k, v, do, o_p, lse_p, grads_p, ql, kl, vl, o_l
        torch.cuda.empty_cache()
    for kind, key in (("fwd", "flash_attention_bf16"),
                      ("bwd", "flash_attention_bwd_bf16")):
        rows[key]["max_abs_err"] = max(c[kind]["max_abs_err"]
                                       for c in per_case.values())
        rows[key]["cases"] = {name: c[kind] for name, c in per_case.items()}
        r, e, at = worst[kind]
        print(f"flash bf16 {kind}: worst error {r:.4f} of its bound at {at} "
              f"(max abs err {e:.3e})", flush=True)
    for kind in ("fwd", "bwd"):
        print(f"flash bf16 {kind} at the profiled shapes, ms kernel/sdpa/"
              f"bound: " + "; ".join(
                  f"{name} {c[kind]['ms']:.4f}/{c[kind]['library_ms']:.4f}/"
                  f"{c[kind]['bound_ms']:.4f}"
                  for name, c in per_case.items() if name in FLASH_PROFILED),
              flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4: the training main path, through the user's entry point
# ---------------------------------------------------------------------------

TRAIN = dict(n_clusters=2, local_batch=4, seq_len=512, h_steps=4,
             inner_lr=1e-3, outer_lr=0.7, outer_momentum=0.9,
             compressor="diloco_x",
             compressor_kw=dict(rank=RANK, bits=4, block=256,
                                backend="pallas"),
             delay=True, error_feedback=True, seed=0)
TRAIN_ROUNDS = 2


def flash_launches_expected(cfg, tcfg, rounds):
    """Flash launches of ``run_diloco_training``: per inner step one
    forward per layer, run again by the remat recompute in backward, and
    one backward per layer; per round one eval forward per layer (no
    remat). Every layer of opt-1.3b is plain causal, and S % 128 == 0."""
    steps = rounds * tcfg.n_clusters * tcfg.h_steps
    return {"flash_attention": steps * 2 * cfg.n_layers
            + rounds * cfg.n_layers,
            "flash_attention_bwd": steps * cfg.n_layers}


def train(flash=False, dtype="float32"):
    """Phase 4 (einsum), 4b (``flash``) and 4k (``flash``, ``dtype``
    "bfloat16": the model's param and compute dtypes)."""
    from repro_torch.configs.base import with_dtype
    from repro_torch.models import model as M
    from repro_torch.train import trainer as T

    cfg = with_dtype(train_config(), dtype)
    tcfg = T.TrainConfig(**TRAIN, flash_attention=flash)
    _phase(f"train{' with flash attention' if flash else ''}: "
           f"run_diloco_training opt-1.3b d_model {cfg.d_model}, "
           f"{cfg.n_layers} of 24 layers, {TRAIN_ROUNDS} rounds, {TRAIN}, "
           f"flash_attention={flash}, dtype {dtype}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    initial = {k: v.cpu() for k, v in _items(params)}
    n_params = sum(v.numel() for v in initial.values())
    round0 = []

    def on_round(r, state):
        if r == 0:
            round0.append(all(torch.equal(v.cpu(), initial[k])
                              for k, v in _items(state.params)))

    low, quant = leaf_shapes(cfg)
    n_low, n_quant = sum(low.values()), sum(quant.values())
    want = compressor_launches_expected(cfg, TRAIN_ROUNDS * tcfg.n_clusters)
    # the stacked trainer's compressor is the fused kernels (recon runs the
    # K-resident GEMM inside its own call); lowrank_mm is the mesh runtime's
    want["lowrank_mm"] = 0
    want.update(flash_launches_expected(cfg, tcfg, TRAIN_ROUNDS) if flash
                else {"flash_attention": 0, "flash_attention_bwd": 0})
    wrappers = kernel_wrappers()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"memory in use before the run (params and their CPU copies "
          f"made): {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    for w in wrappers.values():
        w.launches = 0
    res = T.run_diloco_training(cfg, tcfg, TRAIN_ROUNDS, device=dev,
                                params=params, on_round=on_round)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    tokens = tcfg.n_clusters * tcfg.h_steps * tcfg.local_batch * tcfg.seq_len
    steps = tcfg.n_clusters * tcfg.h_steps
    for r in range(TRAIN_ROUNDS):
        print(f"round {r}: loss {res.losses[r]:.6f} eval {res.eval_losses[r]:.6f}"
              f" round {res.round_s[r]:.3f} s, inner steps "
              f"{res.inner_s[r]:.3f} s ({1e3 * res.inner_s[r] / steps:.1f} ms "
              f"per step), compressor {1e3 * res.compress_s[r]:.1f} ms, "
              f"other {res.round_s[r] - res.inner_s[r] - res.compress_s[r]:.3f}"
              f" s, {tokens / res.round_s[r]:.1f} tokens/s, wire "
              f"{res.wire_bytes_per_round[r]} B", flush=True)
    print(f"train: {n_params} params ({dtype}), {n_low} low-rank + {n_quant} "
          f"quant-only leaves, peak memory {peak / 2**30:.2f} GiB, launches "
          f"{launches} (expected {want}), round 0 params unchanged: "
          f"{round0}", flush=True)
    if not all(map(math.isfinite, res.losses + res.eval_losses)):
        _fail(f"train: non-finite losses {res.losses} {res.eval_losses}")
    if round0 != [True]:
        _fail("train: round 0 of the delay mode changed the params "
              "(Delta must be 0)")
    if launches != want:
        _fail(f"train: launches {launches}, expected {want}")
    return launches, res, peak


def train_bf16(flash_run):
    """Phase 4k: phase 4b's run at bf16 (params and compute; optimizer
    state, pseudo-gradients and the wire f32): round 0 bit for bit the
    initial bf16 params, the bf16 flash kernels and the compressor
    launched as 4b's, and each round's wire bytes 4b's; ms a step, round
    s and peak memory beside 4b's."""
    launches, res, peak = train(flash=True, dtype="bfloat16")
    _, ref, ref_peak = flash_run
    if res.wire_bytes_per_round != ref.wire_bytes_per_round:
        _fail(f"train bf16: wire bytes {res.wire_bytes_per_round}, phase "
              f"4b's {ref.wire_bytes_per_round}")
    steps = TRAIN["n_clusters"] * TRAIN["h_steps"]
    for r in range(TRAIN_ROUNDS):
        print(f"4k round {r}: bf16 {1e3 * res.inner_s[r] / steps:.1f} ms per "
              f"inner step, round {res.round_s[r]:.3f} s; 4b (f32) "
              f"{1e3 * ref.inner_s[r] / steps:.1f} ms, {ref.round_s[r]:.3f} s;"
              f" loss bf16 {res.losses[r]:.6f} f32 {ref.losses[r]:.6f}",
              flush=True)
    print(f"4k: peak {peak / 2**30:.2f} GiB (4b {ref_peak / 2**30:.2f}), "
          f"wire bytes {res.wire_bytes_per_round} (4b's)", flush=True)
    return launches, res, peak


def compressor_share(res, comp_rows):
    """Phase 4's compressor ms per round (``RunResult.compress_s``: the
    whole compressor, host steps included) beside phase 3b's kernel
    times of one cluster's call times the clusters: how much of the
    compressor the kernels are."""
    ms = {row["name"]: row["ms"] * TRAIN["n_clusters"] for row in comp_rows}
    kernels = sum(ms.values())
    for r, s in enumerate(res.compress_s):
        print(f"round {r}: compressor {1e3 * s:.1f} ms per round; its "
              f"kernels at phase 3b's times x {TRAIN['n_clusters']} "
              f"clusters {kernels:.1f} ms ({100 * kernels / (1e3 * s):.1f} "
              f"%: " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
              + ")", flush=True)


FLASH_TRAIN_RTOL = 1e-3


def compare_train(einsum, flash):
    """Phase 4b against phase 4: each round's mean inner loss and eval
    loss within rtol 1e-3 (the same arithmetic in other f32 orders), and
    the time and memory side by side."""
    (_, res_e, peak_e), (_, res_f, peak_f) = einsum, flash
    steps = TRAIN["n_clusters"] * TRAIN["h_steps"]
    gaps = []
    for what, e, f in (("loss", res_e.losses, res_f.losses),
                       ("eval", res_e.eval_losses, res_f.eval_losses)):
        for r, (a, b) in enumerate(zip(e, f)):
            gaps.append(abs(b - a) / abs(a))
            print(f"round {r} {what}: einsum {a:.6f} flash {b:.6f} relative "
                  f"gap {gaps[-1]:.3e}")
    for r in range(TRAIN_ROUNDS):
        print(f"round {r}: round s einsum {res_e.round_s[r]:.3f} flash "
              f"{res_f.round_s[r]:.3f}; ms per inner step einsum "
              f"{1e3 * res_e.inner_s[r] / steps:.1f} flash "
              f"{1e3 * res_f.inner_s[r] / steps:.1f}")
    print(f"peak memory einsum {peak_e / 2**30:.2f} GiB flash "
          f"{peak_f / 2**30:.2f} GiB; max relative loss gap {max(gaps):.3e} "
          f"(gate {FLASH_TRAIN_RTOL})", flush=True)
    if max(gaps) > FLASH_TRAIN_RTOL:
        _fail(f"train with flash: losses {max(gaps):.3e} from the einsum "
              f"run's, over rtol {FLASH_TRAIN_RTOL}")


def step_ab(reps=4):
    """One inner step's loss and gradients (no optimizer) of the training
    configuration, einsum and flash attention in turns (E F F E ...), on
    the same params and tokens: the two paths' step times within one call,
    free of the drift between phases 4 and 4b."""
    from repro_torch.models import model as M
    from repro_torch.tree import leaves

    cfg = train_config()
    dev = torch.device("cuda")
    _phase(f"inner step, einsum and flash in turns ({reps} each)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN["local_batch"],
                                             TRAIN["seq_len"]),
                         generator=gen, device=dev, dtype=torch.int32)
    times = {False: [], True: []}
    order = [False, True, True, False] * (reps // 2)
    for flash in [False, True] + order:            # one warm-up each
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = M.loss_fn(params, cfg, {"tokens": toks}, flash=flash)
        torch.autograd.grad(loss, ps)
        torch.cuda.synchronize()
        times[flash].append(1e3 * (time.perf_counter() - t0))
    e, f = (statistics.median(times[x][1:]) for x in (False, True))
    print(f"ms per step (loss + grads, median of {reps}): einsum {e:.1f} "
          f"flash {f:.1f} ({100 * (f - e) / e:+.1f} %); all einsum "
          f"{[round(t, 1) for t in times[False][1:]]} flash "
          f"{[round(t, 1) for t in times[True][1:]]}", flush=True)


# ---------------------------------------------------------------------------
# phase 4c: GQA through the model on the card, flash against einsum
# ---------------------------------------------------------------------------

GQA_LAYERS = 2          # of granite-3-8b's 40
GQA_LOSS_RTOL = 1e-5    # the parity tests' loss tolerance
GQA_GRAD_RTOL = 1e-4    # per leaf, in the Frobenius norm


def gqa_model(dev=None, S=512):
    """One ``loss_fn`` with its gradients on granite-3-8b at full width
    (H 32, KV 8, d 128: G = 4), flash=True against flash=False. The two
    are the same f32 function in other summation orders: the attention
    outputs agree to ~1e-6 relative (phase 3c), so the loss is held to
    rtol 1e-5 and each leaf's gradient to 1e-4 of its norm."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.tree import leaves

    dev = dev or torch.device("cuda")
    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=GQA_LAYERS)
    _phase(f"GQA through the model: {cfg.name} d_model {cfg.d_model}, H "
           f"{cfg.n_heads} KV {cfg.n_kv_heads} d {cfg.resolved_head_dim}, "
           f"{cfg.n_layers} layers, B 1 S {S}, flash vs einsum")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    tok_gen = torch.Generator(device=dev)
    tok_gen.manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=tok_gen,
                         device=dev, dtype=torch.int32)
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    out = {}
    for flash in (False, True):
        before = (fa.cuda_flash_attention_fwd.launches,
                  fa.cuda_flash_attention_bwd.launches)
        loss, _ = M.loss_fn(params, cfg, {"tokens": toks}, flash=flash)
        grads = torch.autograd.grad(loss, ps)
        torch.cuda.synchronize()
        n = (fa.cuda_flash_attention_fwd.launches - before[0],
             fa.cuda_flash_attention_bwd.launches - before[1])
        if n != ((2 * cfg.n_layers, cfg.n_layers) if flash else (0, 0)):
            _fail(f"GQA flash={flash}: {n} flash forward and backward "
                  f"launches, expected 2 and 1 per layer (remat) with "
                  f"flash, else none")
        out[flash] = (float(loss.detach()), grads)
    (loss_e, g_e), (loss_f, g_f) = out[False], out[True]
    rel_loss = abs(loss_f - loss_e) / abs(loss_e)
    rel = [float((a - b).norm() / b.norm().clamp_min(1e-30))
           for a, b in zip(g_f, g_e)]
    print(f"loss einsum {loss_e:.7f} flash {loss_f:.7f} (relative gap "
          f"{rel_loss:.3e}, gate {GQA_LOSS_RTOL}); worst leaf gradient "
          f"relative gap {max(rel):.3e} (gate {GQA_GRAD_RTOL}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if not math.isfinite(loss_f) or rel_loss > GQA_LOSS_RTOL:
        _fail(f"GQA: loss {loss_f} against {loss_e}")
    if max(rel) > GQA_GRAD_RTOL:
        _fail(f"GQA: gradients {max(rel):.3e} apart, over {GQA_GRAD_RTOL}")
    for p in ps:
        p.requires_grad_(False)


def _items(tree):
    from repro_torch.tree import keystr_items
    return list(keystr_items(tree))


# ---------------------------------------------------------------------------
# phase 3d: lowrank_mm, the mesh runtime's matmul, vs its plain version
# ---------------------------------------------------------------------------

MM_GATE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # test_kernels.py:64
MM_TEST_SHAPES = [(128, 128, 128), (256, 384, 128), (100, 70, 36),
                  (1, 512, 64), (333, 129, 257)]


def mesh_config():
    from repro_torch.configs.base import get_config
    return get_config("opt-1.3b")


STABLELM_LAYERS = 2     # of stablelm-12b's 40: phase 4e's mesh round keeps
                        # ~39 B a parameter (phase 4d), ~53 GiB at 2 layers


def stablelm_mesh_config():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("stablelm-12b"),
                               n_layers=STABLELM_LAYERS)


def mesh_products(cfg, rank=RANK):
    """{(batch, m, k, n, transposed operand): leaves} of the outer step's
    products per cluster and round: P = M Q, Q = M^T P (a transposed) and
    P Q^T (b transposed) for each low-rank leaf, batched over its lead."""
    from repro_torch.core.compression import tree_shapes
    from repro_torch.core.mesh_compression import _leaf_matrix_dims
    from repro_torch.models import model as M

    out = {}
    for shape in tree_shapes(M.init_params(cfg, device="meta")).values():
        lead, m, n = _leaf_matrix_dims(shape)
        if min(m, n) < 64:
            continue
        r = min(rank, m, n)
        for key in ((lead, m, n, r, "-"), (lead, n, m, r, "a"),
                    (lead, m, r, n, "b")):
            out[key] = out.get(key, 0) + 1
    return out


def _mm_operands(gen, dev, batch, m, k, n, trans):
    """M-like (0.3 scale) or factor-like operands; a transposed operand is
    a strided view of a row-major tensor, as the mesh compressor forms it."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    if trans == "a":
        return rnd(batch, k, m, scale=0.3).transpose(1, 2), rnd(
            batch, k, n, scale=k ** -0.5)
    if trans == "b":
        return rnd(batch, m, k, scale=m ** -0.5), rnd(batch, n, k).transpose(
            1, 2)
    return rnd(batch, m, k, scale=0.3), rnd(batch, k, n)


def _route_tag(lm, a, b):
    """A product's route on the card and, on the split route, its plan."""
    a3, b3 = (a, b) if a.dim() == 3 else (a[None], b[None])
    route = lm._route(a3, b3)
    if route != "split":
        return route, None
    return route, lm._split_plan(a3.shape[1], a3.shape[2])


def lowrank_mm_kernel(dev=None, cfg=None):
    """lowrank_mm against its plain version at every product of phase 4d
    and at the JAX test shapes; returns the kernel's row, its numbers
    summed over one cluster's outer step (each product times its leaves).
    Each product's line names its route and split plan; at the batched
    split products the plan is timed against S = 1 (batch-free plans
    cost the batched launches partial traffic; the plan rule may not
    look at the batch)."""
    from repro_torch.kernels import lowrank_mm as lm

    cfg = cfg or mesh_config()
    _phase(f"kernel vs plain: lowrank_mm (mesh outer-step products, "
           f"{cfg.name}, {cfg.n_layers} layers)")
    dev = dev or torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, flops=0)
    by_route = {}
    worst, worst_ratio = 0.0, 0.0
    for (batch, m, k, n, trans), count in sorted(mesh_products(
            cfg).items()):
        a, b = _mm_operands(gen, dev, batch, m, k, n, trans)
        route, plan = _route_tag(lm, a, b)
        tag = (f"batch {batch} ({m} x {k}) @ ({k} x {n}) transposed "
               f"{trans} x{count}")
        got = lm.cuda_matmul(a, b)
        want = lm.matmul_plain(a, b)
        errs = [_gate_product(f"lowrank_mm {tag} [{i}]", got[i], want[i],
                              a[i], b[i]) for i in range(batch)]
        err, ratio = max(e for e, _ in errs), max(r for _, r in errs)
        del want, errs
        if not torch.equal(got, lm.cuda_matmul(a, b)):
            _fail(f"lowrank_mm {tag}: two calls differ ({route} route)")
        if trans != "-" and not torch.equal(
                got, lm.cuda_matmul(a.contiguous(), b.contiguous())):
            _fail(f"lowrank_mm {tag}: the strided view differs from its "
                  f"contiguous copy")
        for i in sorted({0, batch - 1}) if batch > 1 else ():
            if not torch.equal(got[i], lm.cuda_matmul(a[i:i + 1],
                                                      b[i:i + 1])[0]):
                _fail(f"lowrank_mm {tag}: matrix {i} of the batched launch "
                      f"differs from its own launch")
        ms = time_ms(lambda: lm.cuda_matmul(a, b), flush=flush)
        plain = time_ms(lambda: lm.matmul_plain(a, b), flush=flush)
        lib = time_ms(lambda: torch.matmul(a, b), flush=flush)
        nbytes = 4 * batch * (m * k + k * n + m * n)
        flops = 2 * batch * m * k * n
        bound, by = _bound(nbytes, flops)
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("nbytes", nbytes), ("flops", flops)):
            tot[key] += count * val
        r_tot = by_route.setdefault(route, dict(ms=0.0, library_ms=0.0,
                                                bound_ms=0.0))
        r_tot["ms"] += count * ms
        r_tot["library_ms"] += count * lib
        r_tot["bound_ms"] += count * bound
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        s1 = ""
        if route == "split" and batch > 1 and plan[0] > 1:
            one = (1, -(-k // 16) * 16)
            g1 = lm.cuda_matmul(a[:1], b[:1], _plan_override=one)
            _gate_product(f"lowrank_mm {tag} at S = 1", g1[0],
                          lm.matmul_plain(a[:1], b[:1])[0], a[0], b[0])
            del g1
            t1 = time_ms(lambda: lm.cuda_matmul(a, b, _plan_override=one),
                         flush=flush)
            s1 = f"; at S = 1 {t1:.4f} ms"
        print(f"{tag}: route {route}, plan (S, chunk) {plan}; max abs err "
              f"{err:.3e} ({ratio:.4f}x the f32 bound), two calls, views "
              f"and batches bitwise; ms kernel/plain/torch.matmul/bound "
              f"{ms:.4f}/{plain:.4f}/{lib:.4f}/{bound:.4f} ({by}){s1}",
              flush=True)
        del a, b, got
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        tol = MM_GATE[dtype]
        for m, k, n in MM_TEST_SHAPES:
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            got = lm.cuda_matmul(a, b).float()
            want = lm.matmul_plain(a, b).float()
            gap = (got - want).abs()
            if bool((gap > tol + tol * want.abs()).any()):
                _fail(f"lowrank_mm {dtype} ({m}, {k}, {n}): outside the JAX "
                      f"gate rtol/atol {tol} (max abs err "
                      f"{float(gap.max()):.3e})")
            if not torch.equal(got, lm.cuda_matmul(a, b).float()):
                _fail(f"lowrank_mm {dtype} ({m}, {k}, {n}): two calls differ")
            route, plan = _route_tag(lm, a, b)
            print(f"JAX test shape {dtype} ({m} x {k}) @ ({k} x {n}): route "
                  f"{route}, plan {plan}; max abs err "
                  f"{float(gap.max()):.3e} (gate {tol}); two calls bitwise",
                  flush=True)
    bound_ms, bound_by = _bound(tot["nbytes"], tot["flops"])
    for route, r_tot in sorted(by_route.items()):
        print(f"lowrank_mm {route} route, one cluster's outer step: kernel "
              f"{r_tot['ms']:.4f} ms, torch.matmul {r_tot['library_ms']:.4f} "
              f"ms, bound {r_tot['bound_ms']:.4f} ms", flush=True)
    print(f"lowrank_mm: one cluster's outer step: kernel {tot['ms']:.4f} ms, "
          f"plain {tot['plain_ms']:.4f} ms, torch.matmul (TF32 off; here also "
          f"the plain version's product) {tot['library_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); worst {worst_ratio:.4f}x the f32 "
          f"bound", flush=True)
    return {"name": "lowrank_mm", "route": "cuda",
            "source": "src/repro_torch/csrc/lowrank_mm.cu",
            "replaces": "src/repro/kernels/lowrank_mm.py:19",
            "max_abs_err": worst, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": tot["library_ms"]}


# ---------------------------------------------------------------------------
# phase 4d: the mesh driver at full opt-1.3b, through the user's entry point
# ---------------------------------------------------------------------------

MESH_ARGS = ["--arch", "opt-1.3b", "--device", "cuda", "--devices", "1",
             "--clusters", "1", "--data", "1", "--model", "1", "--rounds",
             "2", "--h-steps", "4", "--global-batch", "4", "--seq-len", "512",
             "--rank", str(RANK)]


def mesh_launches_expected(cfg, rounds):
    """Launches of the mesh outer step: per round and low-rank leaf, one
    lowrank_mm each for P = M Q, Q = M^T P (batched over the leaf's
    local clusters x lead matrices) and P Q^T (over all clusters'
    matrices), counted also by route; one batched quant4 pack of the
    leaf's P and one of its Q (all local matrices), and one per
    quant-only leaf (all local clusters' rows); the same count of
    unpacks, each over all clusters' payloads. The counts do not depend
    on the number of clusters or of matrices in a leaf. No other kernel
    runs in the driver."""
    from repro_torch.core.compression import tree_shapes
    from repro_torch.core.mesh_compression import _leaf_matrix_dims
    from repro_torch.models import model as M

    n_low = n_quant = 0
    for shape in tree_shapes(M.init_params(cfg, device="meta")).values():
        lead, m, n = _leaf_matrix_dims(shape)
        if min(m, n) < 64:
            n_quant += 1
        else:
            n_low += 1
    packs = rounds * (2 * n_low + n_quant)
    # by route: P = M Q and Q = M^T P take the split route (f32, r <= 64
    # columns, a row-major factor), P Q^T the rank route (K = r <= 64);
    # nothing in the outer step takes the general route
    return {"lowrank_mm": rounds * 3 * n_low,
            "lowrank_mm_split": rounds * 2 * n_low,
            "lowrank_mm_rank": rounds * n_low, "lowrank_mm_general": 0,
            "quant4_pack": packs,
            "quant4_unpack": packs, "fused_project": 0,
            "fused_project_t_pack": 0, "fused_reconstruct": 0,
            "flash_attention": 0, "flash_attention_bwd": 0}


def mesh_gather_bytes(cfg, rank=RANK, block=256):
    """Bytes one cluster hands to the all-gather per round: every matrix's
    packed P and Q and every quant-only leaf's codes, padded to whole
    blocks of ``block`` values (block / 2 bytes each), plus a 4-byte f32
    scale per block."""
    from repro_torch.core.compression import tree_shapes
    from repro_torch.core.mesh_compression import _leaf_matrix_dims
    from repro_torch.models import model as M

    total = 0
    for shape in tree_shapes(M.init_params(cfg, device="meta")).values():
        lead, m, n = _leaf_matrix_dims(shape)
        if min(m, n) < 64:
            sizes = [lead * m * n]
        else:
            r = min(rank, m, n)
            sizes = [m * r, n * r] * lead
        total += sum(_nblk(s) * (block // 2 + 4) for s in sizes)
    return total


class OuterSplit:
    """The mesh outer step's time, split into its parts by CUDA events
    recorded around each call of the functions it is made of (no sync
    inside the step; one after it). A part's time is its calls' spans
    less the spans of the parts called inside them; the parts sum to the
    step's own span. The events see the device's timeline, on which a
    host-bound part lasts as long as the host takes to issue it."""

    PARTS = ["P = M Q", "orthonormalize", "Q = M^T P", "packs",
             "compress (rest: masks, orthonormalize's copies, guard)",
             "all-gather", "unpacks", "P Q^T",
             "decompress (rest: the mean, any row copies)",
             "Nesterov", "outer step (rest: EF, pending delta, replicas)"]

    def __init__(self):
        self.spans = []              # [name, start event, end event, parent]
        self.stack = []

    def wrap(self, name, fn):
        def timed(*args, **kw):
            label = name(*args) if callable(name) else name
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.spans.append([label, start, None,
                               self.stack[-1] if self.stack else None])
            self.stack.append(len(self.spans) - 1)
            try:
                return fn(*args, **kw)
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.spans[self.stack.pop()][2] = end
        return timed

    def patch(self, outer_step):
        """Patches the outer step's callees (quant4's entry points that
        exist in this tree) and returns the step wrapped; ``restore``
        undoes the patches."""
        from repro_torch.core import mesh_compression as mc
        from repro_torch.kernels import lowrank_mm as lm
        from repro_torch.kernels import quant4 as q4
        from repro_torch.launch import steps

        def product(a, b):
            if self.stack and self.spans[self.stack[-1]][0].startswith(
                    "decompress"):
                return "P Q^T"
            return "P = M Q" if a.is_contiguous() else "Q = M^T P"

        targets = [(mc, "_orthonormalize", "orthonormalize"),
                   (lm, "matmul", product),
                   (mc, "compress_local", self.PARTS[4]),
                   (mc, "gather_payloads", "all-gather"),
                   (mc, "decompress_mean_leaf", self.PARTS[8]),
                   (steps.nesterov, "update_leaf", "Nesterov")]
        targets += [(q4, f, "unpacks" if "unpack" in f else "packs")
                    for f in ("quant4_pack", "quant4_pack_batched",
                              "quant4_unpack", "quant4_unpack_batched")
                    if hasattr(q4, f)]
        self.saved = [(mod, attr, getattr(mod, attr))
                      for mod, attr, _ in targets]
        for mod, attr, name in targets:
            setattr(mod, attr, self.wrap(name, getattr(mod, attr)))
        return self.wrap(self.PARTS[-1], outer_step)

    def restore(self):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)

    def parts_ms(self):
        torch.cuda.synchronize()
        ms = [s[1].elapsed_time(s[2]) for s in self.spans]
        own = list(ms)
        for i, s in enumerate(self.spans):
            if s[3] is not None:
                own[s[3]] -= ms[i]
        out = dict.fromkeys(self.PARTS, 0.0)
        for s, t in zip(self.spans, own):
            out[s[0]] += t
        return out, {name: sum(s[0] == name for s in self.spans)
                     for name in out}


def outer_split(outer_step, params, outer, rank, reps=2):
    """Runs ``outer_step`` again on the driver's last state, ``reps``
    times plain (host clock, synchronized before and after) and ``reps``
    times split (``OuterSplit``), in turns, and prints each split."""
    plain, splits = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, outer = outer_step(params, outer, rank)
        torch.cuda.synchronize()
        plain.append(1e3 * (time.perf_counter() - t0))
        split = OuterSplit()
        step = split.patch(outer_step)
        try:
            params, outer = step(params, outer, rank)
        finally:
            split.restore()
        splits.append(split.parts_ms())
    print(f"outer step again on the last round's state: plain "
          f"{', '.join(f'{t:.1f}' for t in plain)} ms; split (CUDA events "
          f"around each part's calls) "
          f"{', '.join(f'{sum(p.values()):.1f}' for p, _ in splits)} ms",
          flush=True)
    for name in OuterSplit.PARTS:
        print(f"  {name}: " + ", ".join(f"{p[name]:.2f}" for p, _ in splits)
              + f" ms ({splits[0][1][name]} calls)", flush=True)
    return plain, splits


def mesh_driver(dev=None, argv=MESH_ARGS, cfg=None):
    import contextlib
    import io

    from repro_torch.kernels import lowrank_mm as lm
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model as M

    cfg = cfg or mesh_config()
    held = []
    _phase("mesh driver: python -m repro_torch.launch.train "
           + " ".join(argv))
    dev = dev or torch.device("cuda")
    # the driver's initial params (generator seeded 0 on the card), on the
    # host, to check that round 0 leaves them bit for bit
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    initial = {k: v.cpu() for k, v in _items(M.init_params(cfg, gen, dev))}
    n_params = sum(v.numel() for v in initial.values())
    round0 = []

    def on_round(r, params, opt, outer):
        if r == 0:
            anchor = dict(_items(outer.anchor))
            round0.append(all(
                torch.equal(anchor[k], initial[k].to(dev))
                and torch.equal(v[0], anchor[k]) for k, v in _items(params)))
            # the round state the driver holds (phase 4j's arg_bytes)
            held.append(DR.state_bytes({"params": params, "opt": opt,
                                        "outer": outer}))
        if r == args.rounds - 1:
            torch.cuda.synchronize()
            launches.update({name: w.launches for name, w in wrappers.items()})
            launches.update({f"lowrank_mm_{route}": n
                             for route, n in lm.cuda_matmul.routes.items()})
            # after the driver's last timed round: its state is not read
            # again, so the extra outer steps may move it
            outer_split(made[0], params, outer, args.rank)

    args = train_lib._parse_args(argv)
    made, launches = [], {}
    make_outer_step = steps.make_outer_step

    def capture(*a, **kw):
        made.append(make_outer_step(*a, **kw))
        return made[-1]
    want = mesh_launches_expected(cfg, args.rounds)
    wrappers = kernel_wrappers()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"memory in use before the run: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    for w in wrappers.values():
        w.launches = 0
    lm.cuda_matmul.routes = dict.fromkeys(lm.ROUTES, 0)
    out = io.StringIO()
    steps.make_outer_step = capture
    try:
        with contextlib.redirect_stdout(out):
            summary = train_lib.main(argv, on_round=on_round)
    finally:
        steps.make_outer_step = make_outer_step
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(out.getvalue(), end="")
    gather = mesh_gather_bytes(cfg, args.rank)
    tokens = args.global_batch * args.seq_len * args.h_steps
    for r in range(args.rounds):
        print(f"round {r}: mean loss {summary['mean_loss'][r]:.6f}, round "
              f"{summary['round_s'][r]:.3f} s: inner {summary['inner_s'][r]:.3f}"
              f" s ({1e3 * summary['inner_s'][r] / args.h_steps:.1f} ms per "
              f"step), outer "
              f"{summary['outer_s'][r]:.3f} s; {tokens / summary['round_s'][r]:.1f}"
              f" tokens/s; all-gather handed {summary['gather_bytes'][r]} B "
              f"(expected {gather}), wire_bytes_tree {summary['wire_bytes'][r]}"
              f" B (2-byte scales)", flush=True)
    print(f"mesh driver: {n_params} params, peak memory {peak / 2**30:.2f} "
          f"GiB, launches {launches} (expected {want}), round 0 params "
          f"unchanged: {round0}", flush=True)
    if "TRAIN-DRIVER-OK" not in out.getvalue():
        _fail("mesh driver: no TRAIN-DRIVER-OK")
    if not all(map(math.isfinite, summary["mean_loss"])):
        _fail(f"mesh driver: non-finite losses {summary['mean_loss']}")
    if round0 != [True]:
        _fail("mesh driver: round 0 changed the params (Delta must be 0)")
    if launches != want:
        _fail(f"mesh driver: launches {launches}, expected {want}")
    if summary["gather_bytes"] != [gather] * args.rounds:
        _fail(f"mesh driver: all-gather handed {summary['gather_bytes']} B, "
              f"expected {gather} per round")
    summary["state_bytes"], summary["peak_bytes"] = held[0], peak
    return launches, summary


# phase 4l: the mesh driver at --dtype bfloat16 on 4d's configuration
MESH_ARGS_BF16 = MESH_ARGS + ["--dtype", "bfloat16"]


def mesh_driver_bf16(mesh_summary):
    """Phase 4l: ``mesh_driver`` (its gates) at ``--dtype bfloat16``; the
    int4 payload does not depend on the param dtype, so the bytes handed
    to the all-gather are 4d's exactly; ms a step and peak beside 4d's."""
    from repro_torch.configs.base import with_dtype

    launches, summary = mesh_driver(
        argv=MESH_ARGS_BF16, cfg=with_dtype(mesh_config(), "bfloat16"))
    if summary["gather_bytes"] != mesh_summary["gather_bytes"]:
        _fail(f"mesh driver bf16: all-gather handed "
              f"{summary['gather_bytes']} B, 4d's {mesh_summary['gather_bytes']}")
    h = int(MESH_ARGS[MESH_ARGS.index("--h-steps") + 1])
    for r, (a, b) in enumerate(zip(summary["inner_s"],
                                   mesh_summary["inner_s"])):
        print(f"4l round {r}: bf16 {1e3 * a / h:.1f} ms per step, round "
              f"{summary['round_s'][r]:.3f} s, outer "
              f"{summary['outer_s'][r]:.3f} s; 4d (f32) {1e3 * b / h:.1f} ms, "
              f"{mesh_summary['round_s'][r]:.3f} s, outer "
              f"{mesh_summary['outer_s'][r]:.3f} s", flush=True)
    print(f"4l: peak {summary['peak_bytes'] / 2**30:.2f} GiB (4d "
          f"{mesh_summary['peak_bytes'] / 2**30:.2f}), gathered "
          f"{summary['gather_bytes']} B a round (4d's)", flush=True)
    return launches, summary


# phase 4e: the mesh driver on stablelm-12b (parallel residual, head dim
# 160) at full width, 2 of 40 layers
MESH_ARGS_STABLELM = ["--arch", "stablelm-12b", "--n-layers",
                      str(STABLELM_LAYERS)] + MESH_ARGS[2:]


# ---------------------------------------------------------------------------
# phase 4f: the CocktailSGD baseline, through the user's entry point
# ---------------------------------------------------------------------------

COCKTAIL = dict(n_clusters=2, local_batch=4, seq_len=512, inner_lr=1e-3,
                compressor="cocktail",
                compressor_kw=dict(random_ratio=0.1, topk_ratio=0.08, bits=4),
                seed=0)
COCKTAIL_STEPS = 4


def cocktail_ddp(dev=None, cfg=None, steps=COCKTAIL_STEPS):
    """``run_compressed_ddp_training`` with the CocktailSGD compressor
    (random 0.1, top-k 0.08 of the sample, int4) on opt-1.3b at phase 4's
    width and depth. Each leaf's random mask is recorded
    (``compression._mask``) and each roundtrip's result
    (``compression.cocktail_apply``): both clusters draw the same mask in
    each step (bitwise), every kept value lies in the mask, and a leaf
    keeps at most k = max(1, int(n 0.1 0.08)) values. No kernel runs on
    this path (plain attention, a plain compressor). Prints the wire
    bytes per step beside DiLoCoX's per round."""
    from repro_torch.core import compression as C
    from repro_torch.models import model as M
    from repro_torch.train import trainer as T

    cfg = cfg or train_config()
    tcfg = T.TrainConfig(**COCKTAIL)
    _phase(f"cocktail DDP: run_compressed_ddp_training {cfg.name} d_model "
           f"{cfg.d_model}, {cfg.n_layers} layers, {steps} steps, {COCKTAIL}")
    dev = dev or torch.device("cuda")
    kw = tcfg.compressor_kw
    first = {}                       # (step, path): cluster 0's mask
    stats = dict(pairs=0, calls=0, worst=0.0, outside=0)
    draw, apply = C._mask, C.cocktail_apply

    def record_mask(seed, step, path, shape, ratio, device):
        m = draw(seed, step, path, shape, ratio, device)
        other = first.pop((step, path), None)
        if other is None:
            first[(step, path)] = m
        elif not torch.equal(other, m):
            _fail(f"cocktail: step {step} {path}: the clusters' masks differ")
        else:
            stats["pairs"] += 1
        return m

    def record_apply(x, mask, random_ratio, topk_ratio, bits):
        out = apply(x, mask, random_ratio, topk_ratio, bits)
        kept = out.reshape(-1) != 0
        k = max(1, int(x.numel() * random_ratio * topk_ratio))
        stats["calls"] += 1
        stats["worst"] = max(stats["worst"], int(kept.sum()) / k)
        stats["outside"] += int((kept & ~mask.reshape(-1)).sum())
        return out

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    C._mask, C.cocktail_apply = record_mask, record_apply
    try:
        t0 = time.perf_counter()
        res = T.run_compressed_ddp_training(cfg, tcfg, steps, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        C._mask, C.cocktail_apply = draw, apply
    launches = {name: w.launches for name, w in wrappers.items()}
    shapes = C.tree_shapes(M.init_params(cfg, device="meta"))
    n_leaves = len(shapes)
    dlx = C.LowRankQuant(rank=RANK).wire_bytes(shapes)
    tokens = tcfg.n_clusters * tcfg.local_batch * tcfg.seq_len
    h = TRAIN["h_steps"]
    for i in range(steps):
        print(f"step {i}: loss {res.losses[i]:.6f} eval "
              f"{res.eval_losses[i]:.6f}", flush=True)
    print(f"cocktail: {steps} steps in {wall:.3f} s ({steps * tokens / wall:.1f}"
          f" tokens/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; masks of "
          f"both clusters bitwise equal in {stats['pairs']} (step, leaf) "
          f"pairs (expected {steps * n_leaves}); kept values at most "
          f"{stats['worst']:.4f} of k over {stats['calls']} roundtrips, "
          f"{stats['outside']} outside the mask; wire {res.wire_bytes_per_round[0]}"
          f" B per step and cluster ({h * res.wire_bytes_per_round[0]} B"
          f" per {h} steps) against DiLoCoX's {dlx} B per round of "
          f"H = {h} (rank {RANK}, int4); launches {launches}",
          flush=True)
    if not all(map(math.isfinite, res.losses + res.eval_losses)):
        _fail(f"cocktail: non-finite losses {res.losses} {res.eval_losses}")
    if first or stats["pairs"] != steps * n_leaves:
        _fail(f"cocktail: {stats['pairs']} mask pairs compared, "
              f"{len(first)} unpaired; expected {steps * n_leaves}")
    if stats["calls"] != steps * tcfg.n_clusters * n_leaves \
            or stats["worst"] > 1.0 or stats["outside"]:
        _fail(f"cocktail: {stats['calls']} roundtrips, kept up to "
              f"{stats['worst']} of k, {stats['outside']} kept values "
              f"outside the mask")
    if any(launches.values()):
        _fail(f"cocktail: kernels launched on a plain path: {launches}")
    return res


# ---------------------------------------------------------------------------
# phase 4g: the trainer's pipeline-parallel inner engine, both stages on the
# card
# ---------------------------------------------------------------------------

PP_STAGES, PP_MICRO = 2, 2
# 4g's own bounds. Its losses against 4b's: 17x the gap measured there
# (5.9e-7, round 1's eval; PR 25), far under what AdamW's normalised
# steps leave of a dropped microbatch or stage gradient, which the
# gradient gate holds instead: one pp value_and_grad against the
# sequential loss_fn on the same tree and tokens, each leaf to 1e-4 of its
# norm (4c's bound for another op schedule of the same f32 function).
PP_TRAIN_RTOL = 1e-5
PP_GRAD_RTOL = 1e-4


def pp_compressor_launches(cfg, pcfg, calls):
    """The compressor's launches for ``calls`` roundtrips of the pp tree:
    its leaves are the sequential tree's (a stage-split leaf is the same
    matrix: (n_stages * lps * d_in, d_out)) and the quant-only ``active``
    mask."""
    from repro_torch.core.compression import matrix_shape, tree_shapes
    from repro_torch.parallel import pipeline as PP

    n_low = n_quant = 0
    for shape in tree_shapes(PP.init_pp_params(cfg, None, pcfg,
                                               "meta")).values():
        m, n = matrix_shape(shape)
        if min(m, n) >= 64:
            n_low += 1
        else:
            n_quant += 1
    return {"quant4_pack": calls * (n_low + n_quant),
            "quant4_unpack": calls * n_quant,
            "fused_project": calls * n_low,
            "fused_project_t_pack": calls * n_low,
            "fused_reconstruct": calls * n_low, "lowrank_mm": 0}


def pp_flash_launches_expected(cfg, tcfg, pcfg, rounds):
    """Flash launches of the pp trainer: per inner step and microbatch one
    forward per layer slot (no grad), again in the backward's per-stage
    recompute, and one backward per slot; per round the eval's forward
    per slot and microbatch (the 16-row eval batch in ``n_micro``
    microbatches). Padded slots run too (opt-1.3b's 12 layers in 2 stages
    have none)."""
    from repro_torch.parallel import pipeline as PP

    slots = pcfg.n_stages * PP.layers_per_stage(cfg, pcfg)[0]
    per_step = pcfg.n_micro * slots
    steps = rounds * tcfg.n_clusters * tcfg.h_steps
    return {"flash_attention": steps * 2 * per_step
            + rounds * pcfg.n_micro * slots,
            "flash_attention_bwd": steps * per_step}


def pp_warm_starts(q_seq):
    """Phase 4b's compressor warm starts (of the sequential tree) as the pp
    tree's: the segment's under ``stages``, none for ``active``."""
    from repro_torch.parallel import pipeline as PP

    out = {k: q_seq[k] for k in PP.REPLICATED if k in q_seq}
    out["stages"] = q_seq["segments"][0]
    out["active"] = torch.zeros((0,), device=q_seq["embed"].device)
    return out


def train_pp(flash_run, dev=None, cfg=None):
    """Phase 4g: phase 4b's run through ``inner_engine="pp"``: phase 4b's
    params and warm starts mapped into the pp tree, the same data."""
    from repro_torch.core.compression import LowRankQuant
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import inner_engine as IE
    from repro_torch.parallel import pipeline as PP
    from repro_torch.train import trainer as T
    from repro_torch.tree import tree_map

    cfg = cfg or train_config()
    pcfg = PP.PipelineConfig(n_stages=PP_STAGES, n_micro=PP_MICRO)
    tcfg = T.TrainConfig(**TRAIN, flash_attention=True, inner_engine="pp",
                         pp_stages=pcfg.n_stages, pp_micro=pcfg.n_micro)
    _phase(f"train pp: run_diloco_training(inner_engine='pp', pp_stages="
           f"{pcfg.n_stages}, pp_micro={pcfg.n_micro}, flash_attention=True)"
           f" {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} layers, "
           f"{TRAIN_ROUNDS} rounds, both stages on the card")
    dev = dev or torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    seq = M.init_params(cfg, gen, dev)
    comp_state = pp_warm_starts(LowRankQuant(
        **TRAIN["compressor_kw"]).init_state(seq))
    params = PP.to_pp_params(seq, cfg, pcfg)
    del seq
    initial = {k: v.cpu() for k, v in _items(params)}
    round0 = []

    def on_round(r, state):
        if r == 0:
            round0.append(all(torch.equal(v.cpu(), initial[k])
                              for k, v in _items(state.params)))

    calls = TRAIN_ROUNDS * tcfg.n_clusters
    want = pp_compressor_launches(cfg, pcfg, calls)
    want.update(pp_flash_launches_expected(cfg, tcfg, pcfg, TRAIN_ROUNDS))
    wrappers = kernel_wrappers()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    res = T.run_diloco_training(cfg, tcfg, TRAIN_ROUNDS, device=dev,
                                params=params, comp_state=comp_state,
                                on_round=on_round)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    _, res_b, peak_b = flash_run
    steps = tcfg.n_clusters * tcfg.h_steps
    gaps = []
    for r in range(TRAIN_ROUNDS):
        for what, a, b in (("loss", res_b.losses[r], res.losses[r]),
                           ("eval", res_b.eval_losses[r],
                            res.eval_losses[r])):
            gaps.append(abs(b - a) / abs(a))
            print(f"round {r} {what}: sequential (4b) {a:.6f} pp {b:.6f} "
                  f"relative gap {gaps[-1]:.3e}")
        print(f"round {r}: round s pp {res.round_s[r]:.3f} (4b "
              f"{res_b.round_s[r]:.3f}); ms per inner step pp "
              f"{1e3 * res.inner_s[r] / steps:.1f} (4b "
              f"{1e3 * res_b.inner_s[r] / steps:.1f}); compressor "
              f"{1e3 * res.compress_s[r]:.1f} ms", flush=True)
    bubble = (pcfg.n_stages - 1) / (pcfg.n_micro + pcfg.n_stages - 1)
    print(f"train pp: peak memory {peak / 2**30:.2f} GiB (4b "
          f"{peak_b / 2**30:.2f}); GPipe bubble share (n_stages - 1) / "
          f"(n_micro + n_stages - 1) = {bubble:.3f} (the stages run one after "
          f"another on one card: stage idle time not measured); launches "
          f"{launches} (expected {want}), round 0 params unchanged: {round0};"
          f" max relative loss gap to 4b {max(gaps):.3e} (gate "
          f"{PP_TRAIN_RTOL})", flush=True)
    if not all(map(math.isfinite, res.losses + res.eval_losses)):
        _fail(f"train pp: non-finite losses {res.losses} {res.eval_losses}")
    if round0 != [True]:
        _fail("train pp: round 0 of the delay mode changed the params")
    if launches != want:
        _fail(f"train pp: launches {launches}, expected {want}")
    if max(gaps) > PP_TRAIN_RTOL:
        _fail(f"train pp: losses {max(gaps):.3e} from phase 4b's, over rtol "
              f"{PP_TRAIN_RTOL}")
    # one pp inner step twice from the same state: bit for bit
    step = IE.make_pp_train_step(cfg, pcfg, inner_lr=TRAIN["inner_lr"],
                                 flash=True)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN["local_batch"],
                                             TRAIN["seq_len"]),
                         generator=gen, device=dev, dtype=torch.int32)
    outs = []
    for _ in range(2):
        p = tree_map(torch.clone, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, _, loss = step(p, adamw.init(p), toks)
        torch.cuda.synchronize()
        outs.append((p, float(loss), 1e3 * (time.perf_counter() - t0)))
        del p
    same = outs[0][1] == outs[1][1] and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(_items(outs[0][0]),
                                                    _items(outs[1][0])))
    print(f"one pp inner step twice: {outs[0][2]:.1f} and {outs[1][2]:.1f} ms,"
          f" bit for bit equal: {same}", flush=True)
    if not same:
        _fail("train pp: two runs of one pp inner step differ")
    pp_grads_vs_sequential(cfg, pcfg, params, toks)
    return launches, res, peak


def pp_grads_vs_sequential(cfg, pcfg, params, toks):
    """One pp ``value_and_grad`` (flash) against the sequential
    ``loss_fn`` (flash) on the same tree and tokens: the loss to
    ``PP_TRAIN_RTOL``, each leaf's gradient (``active`` has none) to
    ``PP_GRAD_RTOL`` of its norm."""
    from repro_torch.models import model as M
    from repro_torch.parallel import pipeline as PP
    from repro_torch.tree import keystr_items, leaves, tree_map

    loss_pp, g_pp = PP.make_pp_loss(cfg, pcfg, flash=True).value_and_grad(
        params, toks)
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss_seq, _ = M.loss_fn(PP.sequential_params(p, cfg), cfg,
                            {"tokens": toks}, flash=True)
    g_seq = torch.autograd.grad(loss_seq, leaves(p), allow_unused=True)
    loss_seq = loss_seq.detach()
    rel_loss = abs(float(loss_pp) - float(loss_seq)) / abs(float(loss_seq))
    rel = {k: float((a - b).norm() / b.norm().clamp_min(1e-30))
           for (k, a), b in zip(keystr_items(g_pp), g_seq) if b is not None}
    worst = max(rel, key=rel.get)
    print(f"pp value_and_grad vs sequential loss_fn ({toks.shape[0]} x "
          f"{toks.shape[1]}): loss {float(loss_pp):.7f} / "
          f"{float(loss_seq):.7f} (relative gap {rel_loss:.3e}, gate "
          f"{PP_TRAIN_RTOL}); worst leaf gradient relative gap "
          f"{rel[worst]:.3e} at {worst} over {len(rel)} leaves (gate "
          f"{PP_GRAD_RTOL})", flush=True)
    if len(rel) != len(g_seq) - 1:
        _fail(f"train pp: the sequential loss reached {len(rel)} of "
              f"{len(g_seq) - 1} leaves")
    if not math.isfinite(rel_loss) or rel_loss > PP_TRAIN_RTOL:
        _fail(f"train pp: pp loss {float(loss_pp)} against sequential "
              f"{float(loss_seq)}")
    if rel[worst] > PP_GRAD_RTOL:
        _fail(f"train pp: gradient of {worst} {rel[worst]:.3e} from the "
              f"sequential model's, over {PP_GRAD_RTOL}")


# ---------------------------------------------------------------------------
# phase 4h: the mesh driver's pipeline-parallel inner engine (--inner pp)
# ---------------------------------------------------------------------------

# 4h's peak memory over what the phase starts with, in units of the round
# state's f32 bytes (params, AdamW m and v, anchor, Nesterov momentum,
# pending delta and EF residual: 7 x 4 B a parameter at one cluster): the
# state, one gradient tree (1/7 more) and the step's and outer round's
# working set (PR 25 measured 52.03 GiB in all against 36.88 GiB of state)
PP_DRIVER_PEAK_STATES = 1.5
PP_DRIVER_ARGS = ["--arch", "opt-1.3b", "--device", "cuda", "--inner", "pp",
                  "--devices", "1", "--clusters", "1", "--data", "1",
                  "--pp-stages", "1", "--pp-micro", "2", "--rounds", "2",
                  "--h-steps", "4", "--global-batch", "4", "--seq-len", "512",
                  "--rank", str(RANK)]


def pp_driver(dev=None, argv=PP_DRIVER_ARGS, cfg=None):
    import contextlib
    import io

    from repro_torch.launch import train as train_lib
    from repro_torch.parallel import pipeline as PP

    args = train_lib._parse_args(argv)
    cfg = cfg or mesh_config()
    pcfg = PP.PipelineConfig(n_stages=args.pp_stages, n_micro=args.pp_micro)
    _phase("pp driver: python -m repro_torch.launch.train " + " ".join(argv))
    dev = dev or torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    initial = {k: v.cpu() for k, v in _items(PP.init_pp_params(cfg, gen, pcfg,
                                                               dev))}
    n_params = sum(v.numel() for v in initial.values())
    round0 = []

    def on_round(r, params, opt, outer):
        if r == 0:
            anchor = dict(_items(outer.anchor))
            round0.append(all(
                torch.equal(anchor[k], initial[k].to(dev))
                and torch.equal(v[0], anchor[k]) for k, v in _items(params)))

    want = pp_compressor_launches(cfg, pcfg, args.rounds * args.clusters)
    want.update(flash_attention=0, flash_attention_bwd=0)
    wrappers = kernel_wrappers()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for w in wrappers.values():
        w.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = train_lib.main(argv, on_round=on_round)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    print(out.getvalue(), end="")
    tokens = args.global_batch * args.seq_len * args.h_steps
    for r in range(args.rounds):
        print(f"round {r}: mean loss {summary['mean_loss'][r]:.6f}, round "
              f"{summary['round_s'][r]:.3f} s: inner "
              f"{summary['inner_s'][r]:.3f} s "
              f"({1e3 * summary['inner_s'][r] / args.h_steps:.1f} ms per "
              f"step), outer {summary['outer_s'][r]:.3f} s; "
              f"{tokens / summary['round_s'][r]:.1f} tokens/s; clusters group "
              f"handed {summary['allreduce_bytes'][r]} B of f32 (expected "
              f"{4 * n_params}), wire_bytes {summary['wire_bytes'][r]} B",
              flush=True)
    state = 7 * 4 * n_params * args.clusters
    print(f"pp driver: {n_params} params, peak memory {peak / 2**30:.2f} GiB "
          f"(ranks {[round(b / 2**30, 2) for b in summary['peak_bytes']]}), "
          f"{(peak - base) / 2**30:.2f} GiB over the {base / 2**30:.2f} held "
          f"before: {(peak - base) / state:.3f} x the round state's "
          f"{state / 2**30:.2f} GiB (gate {PP_DRIVER_PEAK_STATES}); "
          f"launches {launches} (expected {want}), round 0 params unchanged:"
          f" {round0}", flush=True)
    if "TRAIN-DRIVER-OK" not in out.getvalue():
        _fail("pp driver: no TRAIN-DRIVER-OK")
    if not all(map(math.isfinite, summary["mean_loss"])):
        _fail(f"pp driver: non-finite losses {summary['mean_loss']}")
    if round0 != [True]:
        _fail("pp driver: round 0 changed the params (Delta must be 0)")
    if launches != want:
        _fail(f"pp driver: launches {launches}, expected {want}")
    if summary["allreduce_bytes"] != [4 * n_params] * args.rounds:
        _fail(f"pp driver: clusters group handed "
              f"{summary['allreduce_bytes']} B, expected {4 * n_params}")
    if peak - base > PP_DRIVER_PEAK_STATES * state:
        _fail(f"pp driver: peak memory {(peak - base) / 2**30:.2f} GiB over "
              f"the phase's start, over {PP_DRIVER_PEAK_STATES} x the round "
              f"state's {state / 2**30:.2f} GiB")
    return launches


# ---------------------------------------------------------------------------
# phase 4i: tensor parallelism and FSDP placement in the mesh driver
# ---------------------------------------------------------------------------

TP_ARGS = ["--arch", "opt-1.3b", "--device", "cuda", "--devices", "4",
           "--clusters", "1", "--data", "2", "--model", "2", "--rounds", "2",
           "--h-steps", "4", "--global-batch", "4", "--seq-len", "512",
           "--rank", str(RANK)]
TP_LOSS_RTOL = 1e-6     # 4i's round losses against 4d's: 6.3e-8 measured
TP_GRAD_RTOL = 1e-4     # a sharded leaf gradient against loss_fn's


def tp_block_shares(cfg, shards, specs):
    """Per shard, the f32 bytes of the blocks it keeps of one copy of the
    params (the step's ``ShardGroup.parts``), and the weight matrices
    (the embedding aside: its rule splits d_model alone) whose block is
    not a quarter though both their dims divide by 2."""
    from repro_torch.models import model as M
    from repro_torch.parallel import tensor as TP

    meta = M.init_params(cfg, device="meta")
    per_shard, off = {}, []
    for j, m in shards.shards:
        total = 0
        for key, x in _items(meta):
            a, b, _ = TP.block_index(shards, specs[key], j, m)
            blk = shards.parts(x, specs[key])[a][b]
            total += 4 * blk.numel()
            body = x.shape[1:] if key.startswith("['segments']") else x.shape
            if (j, m) == (0, 0) and len(body) >= 2 and key != "['embed']" \
                    and body[-1] % 2 == 0 and body[-2] % 2 == 0 \
                    and 4 * blk.numel() != x.numel():
                off.append(key)
        per_shard[(j, m)] = total
    return per_shard, off


def tp_driver(mesh_summary, mesh_launches, dev=None, argv=TP_ARGS, cfg=None):
    """Phase 4i: ``launch/train.py``'s ``run`` at ``--data 2 --model 2``,
    every shard in this process, beside phase 4d's run of the same
    cluster, data and seed."""
    import contextlib
    import io

    from repro_torch.kernels import lowrank_mm as lm
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel import tensor as TP

    args = train_lib._parse_args(argv)
    train_lib._check_args(args)
    cfg = cfg or mesh_config()
    _phase("tp driver: repro_torch.launch.train.run, every shard in one "
           "process: " + " ".join(argv))
    dev = dev or torch.device("cuda")
    shards = TP.ShardGroup(args.data, args.model)
    specs = sh.param_placements(M.init_params(cfg, device="meta"),
                                shards.mesh, cluster_stacked=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    initial = {k: v.cpu() for k, v in _items(M.init_params(cfg, gen, dev))}
    n_params = sum(v.numel() for v in initial.values())
    round0 = []

    def on_round(r, params, opt, outer):
        if r == 0:
            anchor = dict(_items(outer.anchor))
            round0.append(all(
                torch.equal(anchor[k], initial[k].to(dev))
                and torch.equal(v[0], anchor[k]) for k, v in _items(params)))

    wrappers = kernel_wrappers()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    lm.cuda_matmul.routes = dict.fromkeys(lm.ROUTES, 0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = train_lib.run(args, dev, clusters=[0], on_round=on_round)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    launches.update({f"lowrank_mm_{route}": n
                     for route, n in lm.cuda_matmul.routes.items()})
    peak = torch.cuda.max_memory_allocated()
    print(out.getvalue(), end="")
    gaps = [abs(a - b) / abs(b) for a, b in zip(summary["mean_loss"],
                                                mesh_summary["mean_loss"])]
    for r in range(args.rounds):
        print(f"round {r}: mean loss {summary['mean_loss'][r]:.6f} (4d: "
              f"{mesh_summary['mean_loss'][r]:.6f}, relative gap "
              f"{gaps[r]:.3e}), inner {summary['inner_s'][r]:.3f} s "
              f"({1e3 * summary['inner_s'][r] / args.h_steps:.1f} ms per "
              f"step; 4d: "
              f"{1e3 * mesh_summary['inner_s'][r] / args.h_steps:.1f}), "
              f"outer {summary['outer_s'][r]:.3f} s (4d: "
              f"{mesh_summary['outer_s'][r]:.3f}); all-gather handed "
              f"{summary['gather_bytes'][r]} B (4d: "
              f"{mesh_summary['gather_bytes'][r]})", flush=True)
    per_shard, off = tp_block_shares(cfg, shards, specs)
    whole = 4 * n_params
    print(f"tp driver: {n_params} params, peak memory {peak / 2**30:.2f} GiB;"
          f" one copy of the params {whole / 2**30:.3f} GiB, each shard's "
          f"blocks " + ", ".join(f"{jm}: {b / 2**30:.3f} GiB ({b / whole:.4f})"
                                 for jm, b in per_shard.items())
          + f"; the round state (7 copies) a shard: "
          f"{7 * max(per_shard.values()) / 2**30:.2f} GiB of "
          f"{7 * whole / 2**30:.2f}; launches {launches} (4d: "
          f"{mesh_launches}), round 0 params unchanged: {round0}", flush=True)
    if "TRAIN-DRIVER-OK" not in out.getvalue():
        _fail("tp driver: no TRAIN-DRIVER-OK")
    if not all(map(math.isfinite, summary["mean_loss"])):
        _fail(f"tp driver: non-finite losses {summary['mean_loss']}")
    if round0 != [True]:
        _fail("tp driver: round 0 changed the params (Delta must be 0)")
    if max(gaps) > TP_LOSS_RTOL:
        _fail(f"tp driver: losses {max(gaps):.3e} from 4d's, over "
              f"{TP_LOSS_RTOL}")
    if launches != mesh_launches:
        _fail(f"tp driver: launches {launches}, 4d's {mesh_launches}")
    if summary["gather_bytes"] != mesh_summary["gather_bytes"]:
        _fail(f"tp driver: all-gather handed {summary['gather_bytes']} B, "
              f"4d's {mesh_summary['gather_bytes']}")
    if off:
        _fail(f"tp driver: blocks not a quarter of their leaf: {off}")
    return launches


def _digest(tree):
    """{leaf: ``tree.bit_digest`` of its bits}, summed on the device."""
    from repro_torch.tree import bit_digest
    return {key: bit_digest(x) for key, x in _items(tree)}


def tp_step_checks(dev=None, argv=TP_ARGS, cfg=None):
    """Phase 4i, continued: one sharded ``value_and_grad`` (every shard in
    this process) against the unsharded ``loss_fn`` on the same params
    and tokens, leaf by leaf; then two runs of one sharded AdamW step from
    the same state, bit for bit."""
    from repro_torch import tree as T
    from repro_torch.core import diloco
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel import tensor as TP

    args = train_lib._parse_args(argv)
    cfg = cfg or mesh_config()
    dev = dev or torch.device("cuda")
    _phase(f"tp step: sharded value_and_grad against loss_fn, and one step "
           f"twice ({args.data} x {args.model} shards, {cfg.n_layers} "
           f"layers)")
    shards = TP.ShardGroup(args.data, args.model)
    specs = sh.param_placements(M.init_params(cfg, device="meta"),
                                shards.mesh, cluster_stacked=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size,
                         (args.global_batch, args.seq_len), generator=gen,
                         device=dev, dtype=torch.int32)
    gen.manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    p = T.tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss_u, _ = M.loss_fn(p, cfg, {"tokens": toks})
    g_u = torch.autograd.grad(loss_u, T.leaves(p))
    loss_u = loss_u.detach()
    del p
    loss_fn = TP.TPLoss(cfg, shards, specs)
    parts = {k: shards.parts(x, specs[k]) for k, x in _items(params)}
    n = args.global_batch // shards.D
    loss_s, g_s = loss_fn.value_and_grad(
        parts, [toks[j * n:(j + 1) * n] for j in range(shards.D)])
    it = iter(g_s)
    rel = {}
    for (key, x), gu in zip(_items(params), g_u):
        diff = 0.0
        for a, row in enumerate(parts[key]):
            for b in range(len(row)):
                blk = sh.block_slices(x.shape, specs[key], shards.mesh,
                                      {"data": a, "model": b})
                diff += float(torch.sum(torch.square(
                    next(it).double() - gu[blk].double())))
        rel[key] = math.sqrt(diff) / max(float(gu.double().norm()), 1e-30)
    del g_s, g_u
    rel_loss = abs(float(loss_s) - float(loss_u)) / abs(float(loss_u))
    worst = max(rel, key=rel.get)
    print(f"tp step: loss {float(loss_s):.8f} sharded, {float(loss_u):.8f} "
          f"loss_fn (relative gap {rel_loss:.3e}); worst leaf gradient "
          f"{worst} {rel[worst]:.3e} of its norm (gate {TP_GRAD_RTOL})",
          flush=True)
    del params, parts

    def one_step():
        gen.manual_seed(0)
        params = diloco.stack_replicas(M.init_params(cfg, gen, dev), 1)
        opt = steps.init_inner_state(params)
        step = steps.make_train_step(cfg, inner_lr=args.inner_lr,
                                     shards=shards)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, {"tokens": toks[None]})
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        return _digest({"params": params, "opt": opt}), float(loss), ms

    gc.collect()
    torch.cuda.empty_cache()
    first = one_step()
    gc.collect()
    torch.cuda.empty_cache()
    second = one_step()
    same = [k for k in first[0] if first[0][k] != second[0][k]]
    print(f"tp step: two runs of one sharded step: losses {first[1]!r}, "
          f"{second[1]!r}; {first[2]:.1f}, {second[2]:.1f} ms; leaves "
          f"that differ: {len(same)}", flush=True)
    if not math.isfinite(rel_loss) or rel_loss > TP_GRAD_RTOL:
        _fail(f"tp step: sharded loss {float(loss_s)} against loss_fn's "
              f"{float(loss_u)}")
    if rel[worst] > TP_GRAD_RTOL:
        _fail(f"tp step: gradient of {worst} {rel[worst]:.3e} from "
              f"loss_fn's, over {TP_GRAD_RTOL}")
    if same or first[1] != second[1]:
        _fail(f"tp step: two runs of one step differ in {same[:4]}")


# ---------------------------------------------------------------------------
# phase 4j: the dry-run against the card; a replicated KV head in training
# ---------------------------------------------------------------------------

DRYRUN_PEAK_RTOL = 0.2  # the meta run's peak against 4d's measured one


def dryrun_vs_card(mesh_summary, argv=MESH_ARGS, cfg=None):
    """Phase 4j: ``launch/dryrun.py``'s ``lower_one`` on the ``meta``
    device at phase 4d's layout (one cluster, 1 x 1, 4 x 512, rank 64,
    f32): its state bytes the bytes of the round state 4d held, exactly;
    its cross-cluster bytes what 4d handed the all-gather
    (``mesh_gather_bytes``), exactly; its peak within
    ``DRYRUN_PEAK_RTOL`` of 4d's measured peak. Prints the H100 peaks the
    dry-run divides by, beside the SM count and the max SM clock the card
    reports."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import train as train_lib

    args = train_lib._parse_args(argv)
    cfg = cfg or mesh_config()
    _phase("dry-run against the card: launch.dryrun.lower_one at 4d's "
           "layout, on the meta device")
    props = torch.cuda.get_device_properties(0)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"dry-run peaks (NVIDIA H100 80GB HBM3 SXM5 datasheet): bf16 "
          f"{DR.BF16_FLOPS_PER_S:.4g}, TF32 {DR.TF32_FLOPS_PER_S:.4g}, f32 "
          f"{DR.F32_FLOPS_PER_S:.4g} FLOP/s ({DR.SMS} SMs), HBM "
          f"{DR.HBM_BYTES_PER_S:.4g} B/s, NVLink {DR.NVLINK_BYTES_PER_S:.4g} "
          f"B/s a direction, clusters {DR.DCN_BYTES_PER_S:.4g} B/s; the card "
          f"reports {props.multi_processor_count} SMs, max SM clock {clock}",
          flush=True)
    t0 = time.monotonic()
    res = DR.lower_one(args.arch, mesh={"clusters": 1, "data": 1,
                                        "model": 1},
                       shape=ShapeConfig("mesh", args.seq_len,
                                         args.global_batch, "train"),
                       rank=args.rank, production=False, cfg=cfg,
                       verbose=False)
    if res["status"] != "ok":
        _fail(f"dry-run: {res.get('error')}")
    gather = mesh_gather_bytes(cfg, args.rank)
    ratio = res["per_device_memory_bytes"] / mesh_summary["peak_bytes"]
    print(f"dry-run ({time.monotonic() - t0:.1f} s on the host): arg_bytes "
          f"{res['arg_bytes']} (4d held {mesh_summary['state_bytes']}), "
          f"cross-cluster {res['cross_cluster_bytes']} B (4d's all-gather "
          f"{gather}), peak {res['per_device_memory_bytes'] / 2**30:.3f} GiB"
          f" (4d measured {mesh_summary['peak_bytes'] / 2**30:.3f}: ratio "
          f"{ratio:.4f}), phases' peaks " + ", ".join(
              f"{k} {v['peak_bytes'] / 2**30:.3f}"
              for k, v in res["phases"].items())
          + f" GiB; {res['flops_per_device']:.4g} FLOP, "
          f"{res['bytes_per_device']:.4g} B moved (no fusion), t_compute "
          f"{res['t_compute']:.4f} s, t_memory {res['t_memory']:.4f} s, "
          f"t_collective_dcn_1gbps {res['t_collective_dcn_1gbps']:.4f} s; "
          f"4d's step {1e3 * mesh_summary['inner_s'][-1] / args.h_steps:.1f}"
          f" ms", flush=True)
    if res["arg_bytes"] != mesh_summary["state_bytes"]:
        _fail(f"dry-run: arg_bytes {res['arg_bytes']}, 4d held "
              f"{mesh_summary['state_bytes']}")
    if res["cross_cluster_bytes"] != gather:
        _fail(f"dry-run: cross-cluster bytes {res['cross_cluster_bytes']}, "
              f"4d's all-gather {gather}")
    if abs(ratio - 1) > DRYRUN_PEAK_RTOL:
        _fail(f"dry-run: peak {ratio:.4f} of 4d's, outside "
              f"{DRYRUN_PEAK_RTOL}")
    return res


# gemma3-1b at full width, 6 of 26 layers (layer 5 is its first global
# one), its one KV head replicated over 2 model shards, flash at d = 256
KV_LAYERS = 6
TP_KV_ARGS = ["--arch", "gemma3-1b", "--n-layers", str(KV_LAYERS),
              "--device", "cuda", "--devices", "2", "--clusters", "1",
              "--data", "1", "--model", "2", "--rounds", "2", "--h-steps",
              "4", "--global-batch", "4", "--seq-len", "512", "--rank",
              str(RANK), "--flash"]


def tp_replicated_kv(dev=None, argv=TP_KV_ARGS, cfg=None):
    """Phase 4j, continued: ``launch/train.py``'s ``run`` on gemma3-1b at
    ``--data 1 --model 2`` (each shard a copy of the one KV head, its
    wk/wv gradient summed over the two), every shard in this process, as
    4i, with the flash kernels on; against the unsharded ``--model 1``
    run of the same seed and data: round 0 leaves the params bit for bit,
    round losses within ``TP_LOSS_RTOL``. Counts reset before the sharded
    run and read after: flash, ``lowrank_mm`` and the int4 kernels must
    each launch."""
    import contextlib
    import io

    from repro_torch.launch import train as train_lib
    from repro_torch.models import model as M

    args = train_lib._parse_args(argv)
    train_lib._check_args(args)
    unsharded = train_lib._parse_args(argv[:argv.index("--devices")] + [
        "--devices", "1", "--clusters", "1", "--data", "1", "--model", "1"]
        + argv[argv.index("--rounds"):])
    cfg = cfg or train_lib._model_config(args)
    dev = dev or torch.device("cuda")
    _phase("tp driver, a replicated KV head: repro_torch.launch.train.run, "
           "every shard in one process: " + " ".join(argv))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    initial = {k: v.cpu() for k, v in _items(M.init_params(cfg, gen, dev))}
    wrappers = kernel_wrappers()
    runs = {}
    for name, a in (("unsharded", unsharded), ("sharded", args)):
        round0 = []

        def on_round(r, params, opt, outer, round0=round0):
            if r == 0:
                anchor = dict(_items(outer.anchor))
                round0.append(all(
                    torch.equal(anchor[k], initial[k].to(dev))
                    and torch.equal(v[0], anchor[k])
                    for k, v in _items(params)))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            summary = train_lib.run(a, dev, clusters=[0], on_round=on_round)
        torch.cuda.synchronize()
        runs[name] = dict(summary=summary, round0=round0,
                          peak=torch.cuda.max_memory_allocated(),
                          launches={k: w.launches
                                    for k, w in wrappers.items()},
                          ok="TRAIN-DRIVER-OK" in out.getvalue())
    tp, one = runs["sharded"], runs["unsharded"]
    gaps = [abs(x - y) / abs(y) for x, y in zip(
        tp["summary"]["mean_loss"], one["summary"]["mean_loss"])]
    for r in range(args.rounds):
        print(f"round {r}: mean loss {tp['summary']['mean_loss'][r]:.6f} "
              f"(unsharded {one['summary']['mean_loss'][r]:.6f}, relative gap"
              f" {gaps[r]:.3e}), inner {tp['summary']['inner_s'][r]:.3f} s "
              f"(unsharded {one['summary']['inner_s'][r]:.3f})", flush=True)
    print(f"tp driver, replicated KV head: launches {tp['launches']} "
          f"(unsharded {one['launches']}), peak {tp['peak'] / 2**30:.2f} GiB "
          f"(unsharded {one['peak'] / 2**30:.2f}), round 0 params unchanged: "
          f"{tp['round0']}", flush=True)
    if not (tp["ok"] and one["ok"]):
        _fail("tp driver, replicated KV head: no TRAIN-DRIVER-OK")
    if not all(map(math.isfinite, tp["summary"]["mean_loss"])):
        _fail("tp driver, replicated KV head: non-finite losses")
    if tp["round0"] != [True] or one["round0"] != [True]:
        _fail("tp driver, replicated KV head: round 0 changed the params")
    if max(gaps) > TP_LOSS_RTOL:
        _fail(f"tp driver, replicated KV head: losses {max(gaps):.3e} from "
              f"the unsharded run's, over {TP_LOSS_RTOL}")
    unused = [k for k in ("flash_attention", "flash_attention_bwd",
                          "lowrank_mm", "quant4_pack", "quant4_unpack")
              if tp["launches"][k] == 0]
    if unused:
        _fail(f"tp driver, replicated KV head: {unused} never launched")
    return tp["launches"]


# ---------------------------------------------------------------------------
# phases 4m, 4n: membership churn and gossip rounds (core/membership.py,
# topology/), driven through diloco_round as the JAX package's tests drive it
# ---------------------------------------------------------------------------

CLUSTER_LAYERS = 4      # of opt-1.3b's 24 (1.52 GiB a copy of the model):
                        # 4m holds ~27 copies, 4n ~32
CLUSTERS = 4
CHURN = dict(n_clusters=CLUSTERS, local_batch=4, seq_len=512, h_steps=4,
             inner_lr=1e-3, outer_lr=0.7, outer_momentum=0.9,
             flash_attention=True, seed=0)
CHURN_ALIVE = [(1, 1, 1, 1), (1, 1, 1, 1), (1, 1, 0, 1), (1, 1, 0, 1),
               (1, 1, 1, 1)]    # cluster 2 dead in rounds 2 and 3, back in 4
TRIM_ROUND = 2          # the round whose delta_hat 4m's trimmed mean takes
GOSSIP_ROUNDS = 3
GOSSIP_DEAD_ROUND = 2   # 4n's round with cluster 3 dead
GOSSIP_STEP = 4e-3      # scale of 4n's constant per-cluster displacements
F32_EPS = 2.0 ** -24    # f32 unit roundoff


def cluster_config():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("opt-1.3b"),
                               n_layers=CLUSTER_LAYERS)


def compressor_launches_expected(cfg, calls):
    """The stacked round's compressor launches: ``calls`` roundtrips (one
    per cluster and round, dead or alive, as the JAX package compresses
    every row), each one pack per leaf, one unpack per quant-only leaf and
    the three fused kernels per low-rank leaf."""
    low, quant = leaf_shapes(cfg)
    n_low, n_quant = sum(low.values()), sum(quant.values())
    return {"quant4_pack": calls * (n_low + n_quant),
            "quant4_unpack": calls * n_quant,
            "fused_project": calls * n_low,
            "fused_project_t_pack": calls * n_low,
            "fused_reconstruct": calls * n_low}


def _sync_s(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _compressor():
    from repro_torch.core.compression import make_compressor
    return make_compressor("diloco_x", rank=RANK, bits=4, block=256,
                           backend="pallas")


def churn(dev=None, cfg=None):
    """Phase 4m (twin of tests/test_membership.py:48-95): ``diloco_round``
    with ``make_inner_fn`` (flash on) and ``masked_cluster_mean`` on
    opt-1.3b at full width, ``CLUSTER_LAYERS`` layers, 4 clusters,
    LowRankQuant rank 64 int4, 5 rounds: all alive, then cluster 2 dead in
    rounds 2-3, then back in round 4, where ``reset_rejoining`` zeroes its
    pending and EF rows. Gates: in a dead round Delta is bit for bit the
    same with the dead row of delta_hat replaced by other finite values;
    the rejoined rows reach that round's compress exactly zero;
    ``trimmed_cluster_mean`` (trim 1) of round 2's delta_hat on the card
    bit for bit the same function on CPU copies; finite losses; the
    compressor and flash launches as the path requires. Prints ms per
    round split into inner steps, compressor and mean, and the peak."""
    from repro_torch import tree as TR
    from repro_torch.core import diloco as D
    from repro_torch.core import membership as MB
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.train import trainer as T

    cfg = cfg or cluster_config()
    dev = dev or torch.device("cuda")
    tcfg = T.TrainConfig(**CHURN)
    C, H, rounds = tcfg.n_clusters, tcfg.h_steps, len(CHURN_ALIVE)
    _phase(f"churn: diloco_round, make_inner_fn and masked_cluster_mean on "
           f"opt-1.3b d_model {cfg.d_model}, {cfg.n_layers} of 24 layers, "
           f"vocab {cfg.vocab_size}, {CHURN}, LowRankQuant rank {RANK} int4,"
           f" alive per round {CHURN_ALIVE}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    comp = T._TimedCompressor(_compressor(), dev)
    timed_roundtrip = comp.roundtrip
    saw_zero = []                # per roundtrip: was the row all zero

    def roundtrip(tree, state, rank=None):
        saw_zero.append(not any(bool(x.any()) for x in TR.leaves(tree)))
        return timed_roundtrip(tree, state, rank)
    comp.roundtrip = roundtrip
    state = D.init_state(params, T._init_inner_stacked(params, C), C, comp)
    del params
    data = SyntheticLM(cfg.vocab_size, tcfg.seq_len, tcfg.local_batch,
                       seed=tcfg.seed)
    inner = T._Timed(T.make_inner_fn(cfg, tcfg, data.table), dev)
    mean = T._Timed(MB.masked_cluster_mean, dev)
    rcfg = D.RoundConfig(outer_lr=tcfg.outer_lr,
                         outer_momentum=tcfg.outer_momentum)
    gates = dict(dead=[], rejoin=[], trimmed=None)
    gate_s = [0.0]

    def cluster_mean(alive, r):
        m = torch.tensor(alive, dtype=torch.float32, device=dev)
        dead = [c for c in range(C) if not alive[c]]
        live = [c for c in range(C) if alive[c]]

        def cm(delta_hat):
            Delta = mean(delta_hat, m)
            t0 = _sync_s(dev)
            want = dict(_items(Delta))
            for k, x in (_items(delta_hat) if dead else ()):
                alt = x.clone()
                for c in dead:
                    torch.add(x[live[0]], x[c], alpha=-3.0, out=alt[c])
                    alt[c].add_(1.0)
                moved = not torch.equal(alt[dead[0]], x[dead[0]])
                same = torch.equal(MB.masked_cluster_mean({"x": alt}, m)["x"],
                                   want[k])
                gates["dead"].append((r, k, moved and same))
                del alt
            if r == TRIM_ROUND:
                worst, card_s, cpu_s = True, 0.0, 0.0
                m_cpu = m.cpu()
                for k, x in _items(delta_hat):
                    t1 = _sync_s(dev)
                    got = MB.trimmed_cluster_mean({"x": x}, m, 1)["x"]
                    t2 = _sync_s(dev)
                    ref = MB.trimmed_cluster_mean({"x": x.cpu()}, m_cpu, 1)
                    cpu_s += time.perf_counter() - t2
                    card_s += t2 - t1
                    worst &= torch.equal(got.cpu(), ref["x"])
                gates["trimmed"] = (worst, card_s, cpu_s)
            gate_s[0] += _sync_s(dev) - t0
            return Delta
        return cm

    wrappers = kernel_wrappers()
    want = compressor_launches_expected(cfg, rounds * C)
    steps = rounds * C * H
    want.update(flash_attention=steps * 2 * cfg.n_layers,
                flash_attention_bwd=steps * cfg.n_layers, lowrank_mm=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"memory in use before the rounds: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    for w in wrappers.values():
        w.launches = 0
    losses, prev = [], CHURN_ALIVE[0]
    for r, alive in enumerate(CHURN_ALIVE):
        rejoined = [a and not p for a, p in zip(alive, prev)]
        t0 = _sync_s(dev)
        before = (inner.total, timed_roundtrip.total, mean.total, gate_s[0])
        first_call = len(saw_zero)
        if any(rejoined):
            MB.reset_rejoining(state.delta_pending, rejoined)
            MB.reset_rejoining(state.error, rejoined)
        state, aux = D.diloco_round(state, inner, comp,
                                    cluster_mean(alive, r), rcfg, RANK)
        t1 = _sync_s(dev)
        for c in range(C):
            if rejoined[c]:
                gates["rejoin"].append((r, c, saw_zero[first_call + c]))
        losses.append(aux)
        inner_s, comp_s, mean_s, g_s = (
            a - b for a, b in zip((inner.total, timed_roundtrip.total,
                                   mean.total, gate_s[0]), before))
        round_s = t1 - t0 - g_s
        print(f"round {r}: alive {alive}, loss per cluster "
              f"{[round(float(x), 6) for x in aux.float().mean(1)]}, round "
              f"{1e3 * round_s:.1f} ms: inner {1e3 * inner_s:.1f} ms "
              f"({1e3 * inner_s / (C * H):.1f} a step), compressor "
              f"{1e3 * comp_s:.1f} ms, mean {1e3 * mean_s:.2f} ms, other "
              f"{1e3 * (round_s - inner_s - comp_s - mean_s):.1f} ms; gates "
              f"{1e3 * g_s:.1f} ms", flush=True)
        prev = alive
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    trim_ok, card_s, cpu_s = gates["trimmed"]
    n_dead = sum(ok for _, _, ok in gates["dead"])
    print(f"churn: peak {peak / 2**30:.2f} GiB at {cfg.n_layers} layers; "
          f"dead-row gate {n_dead}/{len(gates['dead'])} leaves bit for bit "
          f"over rounds {sorted({r for r, _, _ in gates['dead']})}; rejoined "
          f"rows zero at their compress {gates['rejoin']}; trimmed mean "
          f"(trim 1, round {TRIM_ROUND}) card = CPU bit for bit: {trim_ok} "
          f"(card {1e3 * card_s:.1f} ms, CPU {cpu_s:.1f} s); launches "
          f"{launches} (expected {want})", flush=True)
    if not all(torch.isfinite(x).all() for x in losses):
        _fail(f"churn: non-finite losses {losses}")
    if not gates["dead"] or n_dead != len(gates["dead"]):
        _fail(f"churn: Delta depends on a dead row: "
              f"{[g for g in gates['dead'] if not g[2]]}")
    if not gates["rejoin"] or not all(ok for _, _, ok in gates["rejoin"]):
        _fail(f"churn: a rejoined row reached its compress non-zero "
              f"{gates['rejoin']}")
    if not trim_ok:
        _fail("churn: trimmed_cluster_mean on the card differs from the CPU")
    if launches != want:
        _fail(f"churn: launches {launches}, expected {want}")
    return launches


def gossip(dev=None, cfg=None):
    """Phase 4n (twin of tests/test_topology.py:155-196 at width): a ring
    of 4 clusters, params stacked by ``stack_replicas``, constant
    per-cluster displacements from a seeded generator at the model's leaf
    shapes, 3 rounds with the delay and LowRankQuant rank 64 int4 through
    ``mixing_op(ring)``; in round 2 cluster 3 is dead. Gates:
    ``mix_row(W[c])`` bit for bit row c of ``mix_stacked`` on the card;
    the dead cluster's row passes through the masked mix bit for bit; the
    rows differ after the rounds; the compressor launched C times per leaf
    per round; then, compress off, the rows' mean against the gather
    run's params within a derived bound. Prints ms per round split into
    compressor, mix and the rest (pseudo-gradient, EF, outer step), the
    peak, and the modeled wire bytes and seconds of a round at 1 Gbps:
    the ring's from ``gossip_round_comm``, the gather's from
    ``round_wire_total``, at the compressor's payload."""
    import numpy as np

    from repro_torch import tree as TR
    from repro_torch.core import comm
    from repro_torch.core import diloco as D
    from repro_torch.core import membership as MB
    from repro_torch.core.compression import Identity, tree_shapes
    from repro_torch.models import model as M
    from repro_torch.topology import (gossip_round_comm, make_topology,
                                      mix_row, mixing_op, round_wire_total)
    from repro_torch.train import trainer as T

    cfg = cfg or cluster_config()
    dev = dev or torch.device("cuda")
    C, R = CLUSTERS, GOSSIP_ROUNDS
    ring = make_topology("ring", C)
    _phase(f"gossip: diloco_round through mixing_op({ring.describe()}) on "
           f"opt-1.3b d_model {cfg.d_model}, {cfg.n_layers} of 24 layers, "
           f"stacked params, {R} rounds, delay on, LowRankQuant rank {RANK} "
           f"int4, cluster 3 dead in round {GOSSIP_DEAD_ROUND}")

    def draw():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = M.init_params(cfg, gen, dev)
        gen.manual_seed(1)
        steps = TR.tree_map(
            lambda x: torch.randn((C,) + tuple(x.shape), generator=gen,
                                  device=dev).mul_(GOSSIP_STEP), params)
        return params, steps

    params, steps = draw()
    shapes = tree_shapes(params)
    stacked_inner = lambda p, o, t: (TR.tree_map(torch.sub, p, steps), o,
                                     None)
    comp = T._TimedCompressor(_compressor(), dev)
    state = D.init_state(D.stack_replicas(params, C), {}, C, comp,
                         stacked_params=True)
    del params
    inner = T._Timed(stacked_inner, dev)
    gates = dict(row=[], dead=[])
    gate_s = [0.0]

    def mixer(alive, r):
        op = mixing_op(ring, np.asarray(alive, bool))
        timed = T._Timed(op, dev)
        W = op.matrix.W

        def mix(delta_hat):
            Delta = timed(delta_hat)
            t0 = _sync_s(dev)
            if r == 1:          # the first round with non-zero deltas
                out = dict(_items(Delta))
                for k, x in _items(delta_hat):
                    parts = [{"x": x[j]} for j in range(C)]
                    gates["row"].append(all(
                        torch.equal(mix_row(W[c], parts)["x"], out[k][c])
                        for c in range(C)))
            for c in range(C):
                if not alive[c]:
                    gates["dead"].append(all(
                        torch.equal(a, b) for (_, a), (_, b) in zip(
                            _items(D.take_row(Delta, c)),
                            _items(D.take_row(delta_hat, c)))))
            gate_s[0] += _sync_s(dev) - t0
            return Delta
        mix.returns_stacked, mix.matrix, mix.timed = True, op.matrix, timed
        return mix

    wrappers = kernel_wrappers()
    want = compressor_launches_expected(cfg, R * C)
    want.update(flash_attention=0, flash_attention_bwd=0, lowrank_mm=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    payload = comp.wire_bytes(shapes, rank=RANK)
    for r in range(R):
        alive = tuple(0 if (r == GOSSIP_DEAD_ROUND and c == 3) else 1
                      for c in range(C))
        mix = mixer(alive, r)
        before = (inner.total, comp.roundtrip.total, gate_s[0])
        t0 = _sync_s(dev)
        state, _ = D.diloco_round(state, inner, comp, mix, D.RoundConfig(),
                                  RANK)
        t1 = _sync_s(dev)
        inner_s, comp_s, g_s = (a - b for a, b in zip(
            (inner.total, comp.roundtrip.total, gate_s[0]), before))
        round_s = t1 - t0 - g_s
        mix_s = mix.timed.total
        gc_ring = gossip_round_comm(ring, np.asarray(alive, bool), payload,
                                    [comm.GBPS] * C, 0.0)
        n_alive = sum(alive)
        gather_b = round_wire_total("gather", n_alive, payload)
        gather_s = comm.gather_time(payload, comm.CommScenario(
            n_clusters=n_alive))
        print(f"round {r}: alive {alive}, spectral gap "
              f"{mix.matrix.spectral_gap(np.asarray(alive, bool)):.6f}, "
              f"round {1e3 * round_s:.1f} ms: compressor {1e3 * comp_s:.1f} "
              f"ms, mix {1e3 * mix_s:.1f} ms, inner {1e3 * inner_s:.1f} ms, "
              f"rest (pseudo-gradient, EF, outer step) "
              f"{1e3 * (round_s - comp_s - mix_s - inner_s):.1f} ms; gates "
              f"{1e3 * g_s:.1f} ms; modeled at 1 Gbps, payload {payload} B"
              f" a cluster: ring {gc_ring.wire_bytes_total} B "
              f"{gc_ring.t_comm_s:.3f} s, gather {gather_b} B "
              f"{gather_s:.3f} s", flush=True)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    spread = max(float((x - x.mean(0)).abs().max())
                 for _, x in _items(state.params))
    distinct = all(any(not torch.equal(x[0], x[c]) for _, x in
                       _items(state.params)) for c in range(1, C))
    del state, inner, comp, mix
    gc.collect()
    torch.cuda.empty_cache()

    # compress off, EF off: the rows' mean against the gather trajectory
    off = D.RoundConfig(compress=False, error_feedback=False)
    ident = Identity()
    params, steps = draw()
    g = D.init_state(params, {}, C, ident)
    star = mixing_op(make_topology("star", C), np.ones(C, bool))
    g_inner = lambda p, o, t: (TR.tree_map(lambda a, s: a[None] - s, p,
                                           steps), o, None)
    for _ in range(R):
        g, _ = D.diloco_round(g, g_inner, ident, star, off)
    gathered = {k: v.cpu() for k, v in _items(g.params)}
    del g, params
    params, steps = draw()
    s = D.init_state(D.stack_replicas(params, C), {}, C, ident,
                     stacked_params=True)
    del params
    ring_op = mixing_op(ring, np.ones(C, bool))
    for _ in range(R):
        s, _ = D.diloco_round(s, stacked_inner, ident, ring_op, off)
    rows_mean = MB.masked_cluster_mean(s.params, torch.ones(C, device=dev))
    # each round touches an element with at most 6C roundings of the
    # params' size (pseudo-gradient, mix, Nesterov, the rows' mean), and
    # momentum carries a Delta's roundings for 1 / (1 - mu) rounds
    mu, lr = off.outer_momentum, off.outer_lr
    worst, steps_by = (0.0, 0.0, 1.0, ""), dict(_items(steps))
    for k, x in _items(rows_mean):
        ref = gathered[k]
        tol = R * 6 * C * F32_EPS * (
            float(ref.abs().max())
            + lr * (1 + mu) / (1 - mu) * float(steps_by[k].abs().max()))
        err = float((x.cpu() - ref).abs().max())
        worst = max(worst, (err / tol, err, tol, k))
    del s, rows_mean, steps, steps_by
    print(f"gossip: peak {peak / 2**30:.2f} GiB at {cfg.n_layers} layers; "
          f"mix_row = mix_stacked row bit for bit on {sum(gates['row'])}/"
          f"{len(gates['row'])} leaves; dead row through the mix bit for bit:"
          f" {gates['dead']}; rows distinct: {distinct} (largest distance "
          f"from the rows' mean {spread:.3e}); compress off, rows' mean vs "
          f"gather params: worst leaf {worst[3]} error {worst[1]:.3e}, bound "
          f"{worst[2]:.3e} (R 6 C eps (max|theta| + lr (1 + mu) / (1 - mu) "
          f"max|step|)), ratio {worst[0]:.3e}; launches "
          f"{launches} (expected {want})", flush=True)
    if not gates["row"] or not all(gates["row"]):
        _fail("gossip: mix_row differs from its row of mix_stacked")
    if not gates["dead"] or not all(gates["dead"]):
        _fail("gossip: the dead cluster's row did not pass through the mix")
    if not distinct:
        _fail("gossip: the rows are identical after the rounds")
    if worst[0] > 1.0:
        _fail(f"gossip: the rows' mean is {worst[0]:.3e} x the bound from "
              f"the gather trajectory")
    if launches != want:
        _fail(f"gossip: launches {launches}, expected {want}")
    return launches


# ---------------------------------------------------------------------------
# phase 4o: the simulator (sim/) in barrier mode at full opt-1.3b width under
# a straggler, a degraded link and churn, with a balanced H; then the JAX
# tests' quadratic scenarios on the card against the CPU
# ---------------------------------------------------------------------------

SIM_ROUNDS = 5
SIM_REJOIN = (4, 2)     # (round, cluster): 4o's rejoin
SIM_NUMERIC_FIELDS = ("loss", "param_hash", "disagreement")
# the quadratic scenarios on the card against the port's CPU run of the same
# scenario (same arrays and warm start: both are drawn on the host); the
# worst measured on an H100 80GB HBM3 at 700 W: losses 7.2e-7 relative,
# params 1.4e-5 of the leaf's max |value| (test_sim.py:166, ref)
SIM_QUAD_LOSS_RTOL = 1e-5
SIM_QUAD_PARAM_RTOL = 1e-4


def sim_scenario(shapes):
    """4o's scenario: 4 clusters, H = 4, 5 rounds, rank 64 int4 through the
    compressor kernels (``backend="pallas"``), the model's own leaf shapes
    for the wire accounting, a 1 Gbps link and 1 s modeled steps (the
    paper's §2.4.1 setting); cluster 1 three times slower in rounds 1-2,
    cluster 0's link at a quarter in round 2, cluster 2 gone in rounds 2-3
    and back in 4, and the balance H policy."""
    from repro_torch import sim as S
    from repro_torch.core.adaptive import HSpec

    return S.Scenario(
        n_clusters=CLUSTERS, rounds=SIM_ROUNDS, h_steps=CHURN["h_steps"],
        tokens_per_step=CLUSTERS * CHURN["local_batch"] * CHURN["seq_len"],
        faults=S.FaultSchedule((S.Straggler(1, 1, 3, 3.0),
                                S.LinkDegradation(2, 3, 0.25, cluster=0),
                                S.Leave(2, 2), S.Join(2, 4))),
        compressor="diloco_x",
        compressor_kw=dict(rank=RANK, bits=4, block=256, backend="pallas"),
        h_spec=HSpec(policy="balance"), param_shapes=shapes, seed=0)


def _het(e):
    """Did the round run ``diloco_round_h`` (a planned schedule that is
    not uniform at the budget)?"""
    return e.h_by is not None and any(h != e.h_steps for h in e.h_by)


def sim_flash_launches_expected(tl, n_clusters, n_layers):
    """Flash launches of the rounds of ``tl``: every cluster row trains,
    dead or alive (the JAX round trains every row); a uniform round runs H
    steps a row, a heterogeneous one h_c for an alive row and the budget H
    for a dead one (its filler). A masked step launches nothing:
    ``diloco.masked_local_steps`` runs only the first h_c steps. Each step
    launches the forward twice a layer (the step's forward and the
    recompute in the backward) and the backward once."""
    steps = 0
    for e in tl.events:
        if _het(e):
            steps += sum(e.h_by) + e.h_steps * (n_clusters - len(e.alive))
        else:
            steps += n_clusters * e.h_steps
    return {"flash_attention": steps * 2 * n_layers,
            "flash_attention_bwd": steps * n_layers}


def _timing_rows(tl):
    return [{k: v for k, v in dataclasses.asdict(e).items()
             if k not in SIM_NUMERIC_FIELDS} for e in tl.events]


def sim_problem(cfg, tcfg, params, table):
    """The trainer's inner functions as a ``NumericProblem``: 4m's
    ``make_inner_fn`` (flash on), its per-cluster-H form through
    ``make_inner_fn(..., h_vec)``."""
    from repro_torch.sim import NumericProblem
    from repro_torch.train import trainer as T

    def inner_fn_h(p, o, t, h_vec):
        return T.make_inner_fn(cfg, tcfg, table,
                               tuple(int(h) for h in h_vec))(p, o, t)

    return NumericProblem(
        params=params,
        inner_opt_stacked=T._init_inner_stacked(params, tcfg.n_clusters),
        inner_fn=T.make_inner_fn(cfg, tcfg, table), inner_fn_h=inner_fn_h,
        outer_lr=tcfg.outer_lr, outer_momentum=tcfg.outer_momentum)


def sim_barrier(dev=None, cfg=None):
    """Phase 4o: ``repro_torch.sim.simulate`` in barrier mode over a star
    (gather) on opt-1.3b at full width, ``CLUSTER_LAYERS`` layers, 4
    clusters, H = 4, 4 x 512, flash on, LowRankQuant rank 64 int4 through
    the compressor kernels, 5 rounds of ``sim_scenario``'s faults: the
    straggler's rounds (1, 2) are heterogeneous under the balance policy
    and run ``diloco_round_h``, the others ``diloco_round``; cluster 2's
    rejoin in round 4 re-initializes it. Gates: the timeline's every field
    but the numeric ones (loss, param_hash) equal to a timing-only
    ``simulate`` of the scenario; each round's ``param_hash`` equal to the
    ``tree_hash`` of a hand-driven loop (``diloco_round`` /
    ``diloco_round_h`` with ``masked_cluster_mean``, the same alive
    vectors, H schedule and resets: 4m's machinery) bit for bit; at round
    4 the rejoined cluster's inner moments and step zero when its inner
    leg starts, and the warm start it compresses with ``comp0`` bit for
    bit (not zero); finite losses; compressor launches
    ``compressor_launches_expected(cfg, 5 x 4)`` (every row compresses,
    dead or alive), flash launches ``sim_flash_launches_expected`` (a
    masked step of a heterogeneous round launches nothing). Prints each
    round's wall ms split into the numeric leg (its compressor share),
    ``tree_hash`` and the rest beside the modeled seconds, the hash's
    device-to-host and sha256 parts, the peak, and the card's name and
    power limit."""
    import numpy as np

    from repro_torch import sim as S
    from repro_torch import tree as TR
    from repro_torch.core import diloco as D
    from repro_torch.core import membership as MB
    from repro_torch.core.compression import tree_shapes
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.sim import simulator as SS
    from repro_torch.train import trainer as T

    cfg = cfg or cluster_config()
    dev = dev or torch.device("cuda")
    tcfg = T.TrainConfig(**CHURN)
    C, H = tcfg.n_clusters, tcfg.h_steps
    rejoin_r, rejoin_c = SIM_REJOIN

    def draw():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return M.init_params(cfg, gen, dev)

    params = draw()
    sc = sim_scenario(tree_shapes(params))
    _phase(f"simulator: repro_torch.sim.simulate, barrier mode, star, on "
           f"opt-1.3b d_model {cfg.d_model}, {cfg.n_layers} of 24 layers, "
           f"{C} clusters, H {H}, {tcfg.local_batch} x {tcfg.seq_len}, "
           f"flash, LowRankQuant rank {RANK} int4 (kernels), "
           f"{SIM_ROUNDS} rounds, faults "
           f"{[e.describe() for e in sc.faults.events]}, h_spec balance")
    timing = S.simulate(sc)
    data = SyntheticLM(cfg.vocab_size, tcfg.seq_len, tcfg.local_batch,
                       seed=tcfg.seed)
    comp0 = _compressor().init_state(params)
    prob = sim_problem(cfg, tcfg, params, data.table)
    del params
    gates = dict(moments=None, comp=None)
    comp_s = []              # seconds of each roundtrip, in call order

    def watch_moments(fn):
        def inner(p, o, t, *h):
            if int(t) == rejoin_r:
                gates["moments"] = all(not x[rejoin_c].any()
                                       for x in TR.leaves(o))
            return fn(p, o, t, *h)
        return inner

    prob.inner_fn = watch_moments(prob.inner_fn)
    prob.inner_fn_h = watch_moments(prob.inner_fn_h)

    class Watched:
        """The compressor ``simulate`` builds: times each roundtrip, and
        holds the rejoined row's warm start at its compress to ``comp0``."""

        def __init__(self, c):
            self._c = c

        def __getattr__(self, attr):
            return getattr(self._c, attr)

        def roundtrip(self, tree, state, rank_scalar=None):
            if len(comp_s) == rejoin_r * C + rejoin_c:
                got, want = TR.leaves(state), TR.leaves(comp0)
                gates["comp"] = (len(got) == len(want) and all(
                    torch.equal(x, y) for x, y in zip(got, want))
                    and any(bool(x.any()) for x in got))
            t0 = _sync_s(dev)
            out = self._c.roundtrip(tree, state, rank_scalar)
            comp_s.append(_sync_s(dev) - t0)
            return out

    wrappers = kernel_wrappers()
    want = compressor_launches_expected(cfg, SIM_ROUNDS * C)
    want.update(sim_flash_launches_expected(timing, C, cfg.n_layers),
                lowrank_mm=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    make = SS.make_compressor
    SS.make_compressor = lambda name, **kw: Watched(make(name, **kw))
    try:
        t0 = _sync_s(dev)
        tl = S.simulate(sc, numeric=prob)
        sim_s = _sync_s(dev) - t0
    finally:
        SS.make_compressor = make
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    del tl.final_params, prob
    gc.collect()
    torch.cuda.empty_cache()
    for e, w in zip(tl.events, tl.wall):
        r = e.round
        c_s = sum(comp_s[r * C:(r + 1) * C])
        print(f"round {r}: alive {e.alive}, rejoined {e.rejoined}, h_by "
              f"{e.h_by} ({'diloco_round_h' if _het(e) else 'diloco_round'}"
              f"), loss {e.loss:.6f}; wall {1e3 * w['round_s']:.1f} ms: "
              f"numeric leg {1e3 * w['numeric_s']:.1f} ms (compressor "
              f"{1e3 * c_s:.1f} ms), tree_hash {1e3 * w['hash_s']:.1f} ms, "
              f"rest {1e3 * (w['round_s'] - w['numeric_s'] - w['hash_s']):.1f}"
              f" ms; modeled t_compute {e.t_compute_s:.3f} s, t_comm "
              f"{e.t_comm_s:.3f} s, exposed {e.exposed_comm_s:.3f} s, "
              f"t_round {e.t_round_s:.3f} s, wire {e.wire_bytes} B, all "
              f"links {e.wire_bytes_total} B; faults {list(e.faults)}",
              flush=True)

    # the hand-driven loop: 4m's machinery on the timing run's schedule
    t0 = _sync_s(dev)
    params = draw()
    comp = _compressor()
    state = D.init_state(params, T._init_inner_stacked(params, C), C, comp)
    del params
    inner = T.make_inner_fn(cfg, tcfg, data.table)
    rcfg = D.RoundConfig(outer_lr=tcfg.outer_lr,
                         outer_momentum=tcfg.outer_momentum)
    hand = []
    for e in timing.events:
        alive = np.zeros(C, bool)
        alive[list(e.alive)] = True
        if e.rejoined:
            rej = np.zeros(C, bool)
            rej[list(e.rejoined)] = True
            for tree in (state.delta_pending, state.error, state.inner_opt):
                MB.reset_rejoining(tree, rej)
            for x, x0 in zip(TR.leaves(state.comp_state), TR.leaves(comp0)):
                for c in e.rejoined:
                    x[c].copy_(x0)
        m = torch.tensor(alive, dtype=torch.float32, device=dev)
        mean = lambda tree, m=m: MB.masked_cluster_mean(tree, m)
        h_vec = [H] * C
        for c, h in zip(e.alive, e.h_by or ()):
            h_vec[c] = h
        if _het(e):
            inner_h = (lambda p, o, t, hv: T.make_inner_fn(
                cfg, tcfg, data.table, tuple(hv))(p, o, t))
            state, _ = D.diloco_round_h(state, inner_h, comp, mean, rcfg,
                                        h_vec)
        else:
            state, _ = D.diloco_round(state, inner, comp, mean, rcfg)
        if not alive.all():
            MB.reset_rejoining(state.delta_pending, ~alive)
            MB.reset_rejoining(state.error, ~alive)
        hand.append(S.tree_hash(state.params))
    hand_s = _sync_s(dev) - t0
    # the hash's two parts on the last round's params
    t0 = _sync_s(dev)
    host = [x.cpu() for x in TR.leaves(state.params)]
    t1 = _sync_s(dev)
    S.tree_hash(host)
    split = (sum(x.numel() * x.element_size() for x in host) / 2**30,
             t1 - t0, time.perf_counter() - t1)
    del state, inner, comp, host
    gc.collect()
    torch.cuda.empty_cache()

    same_timing = _timing_rows(tl) == _timing_rows(timing)
    hashes = [e.param_hash for e in tl.events]
    losses = tl.losses()
    hash_s = [w["hash_s"] for w in tl.wall]
    smi = (card_name_and_power_limit() if dev.type == "cuda"
           else "no card")
    print(f"simulator on {smi}: {sim_s:.1f} s for {SIM_ROUNDS} rounds "
          f"(tree_hash "
          f"{sum(hash_s):.1f} s of it), peak {peak / 2**30:.2f} GiB at "
          f"{cfg.n_layers} layers; timeline = timing-only run but loss and "
          f"param_hash: {same_timing} (structural fingerprint "
          f"{timing.structural_fingerprint()[:16]}); param_hash = "
          f"hand-driven diloco_round loop bit for bit: "
          f"{hashes == hand} ({sum(a == b for a, b in zip(hashes, hand))}/"
          f"{len(hand)} rounds, hand loop {hand_s:.1f} s); tree_hash of "
          f"{split[0]:.2f} GiB: device to host {split[1]:.2f} s, sha256 on "
          f"the host {split[2]:.2f} s; round "
          f"{rejoin_r} cluster {rejoin_c}: inner moments zero "
          f"{gates['moments']}, warm start = comp0 bit for bit "
          f"{gates['comp']}; modeled {timing.total_time_s:.3f} s, "
          f"{timing.tokens_per_s:.1f} tok/s, barrier idle "
          f"{timing.barrier_idle_frac:.4f}; launches {launches} (expected "
          f"{want})", flush=True)
    if not same_timing:
        _fail("simulator: the numeric timeline's timing and structure "
              "differ from the timing-only run's")
    if hashes != hand:
        _fail(f"simulator: param_hash differs from the hand-driven loop in "
              f"rounds {[r for r, (a, b) in enumerate(zip(hashes, hand)) if a != b]}")
    if gates["moments"] is not True or gates["comp"] is not True:
        _fail(f"simulator: the rejoin did not re-initialize cluster "
              f"{rejoin_c}: {gates}")
    if not all(math.isfinite(x) for x in losses):
        _fail(f"simulator: non-finite losses {losses}")
    if launches != want:
        _fail(f"simulator: launches {launches}, expected {want}")
    return launches, sim_quadratic_cases(dev)


def sim_quadratic_scenario(name, backend):
    """The numeric quadratic scenarios of the JAX package's tests
    (``tests/test_sim.py:42``, ``:166``, ``tests/test_topology.py:219``),
    with the compressor's ``backend``: (Scenario, QuadraticSpec)."""
    from repro_torch import sim as S

    comp = dict(compressor="diloco_x", compressor_kw={
        "rank": 4, "min_dim_for_lowrank": 8, "backend": backend})
    clean = dict(n_clusters=4, h_steps=10, t_step_s=1.0, n_params=1e8,
                 seed=3, **comp)
    if name == "test_sim.py:42":
        sc = S.Scenario(**dict(clean, rounds=6, h_steps=4), faults=(
            S.FaultSchedule((S.Straggler(1, 2, 4, 3.0), S.Leave(2, 3),
                             S.Join(2, 5)))))
        return sc, S.QuadraticSpec(n_clusters=4, h_steps=4, seed=0)
    if name == "test_sim.py:166":
        sc = S.Scenario(**dict(clean, rounds=14, h_steps=6),
                        link=S.LinkProfile(jitter=0.05), faults=(
            S.FaultSchedule((S.Straggler(1, 3, 6, slowdown=4.0),
                             S.Leave(2, 4), S.Join(2, 9)))))
        return sc, S.QuadraticSpec(n_clusters=4, h_steps=6, seed=0)
    if name == "test_topology.py:219":
        sc = S.Scenario(n_clusters=4, rounds=6, h_steps=4, t_step_s=0.05,
                        link=S.LinkProfile(bytes_per_s=200_000), rank=4,
                        n_params=1e5, topology="ring", seed=0, **comp)
        return sc, S.QuadraticSpec(n_clusters=4, d=8, n_mats=2, h_steps=4,
                                   seed=0)
    raise KeyError(name)


SIM_QUAD_CASES = ("test_sim.py:42", "test_sim.py:166",
                  "test_topology.py:219")


def sim_quadratic_run(name, backend, device):
    from repro_torch import sim as S

    sc, spec = sim_quadratic_scenario(name, backend)
    return S.simulate(sc, numeric=spec.problem(device))


def sim_quadratic_gap(got, want):
    """(timing rows equal, worst loss relative error, worst param error
    over the leaf's max |value|, int4 payload bytes per round equal) of a
    run against the reference run of the same scenario."""
    import numpy as np

    from repro_torch import tree as TR

    gl, wl = np.asarray(got.losses()), np.asarray(want.losses())
    loss_err = float(np.max(np.abs(gl - wl) / np.abs(wl)))
    param_err = 0.0
    for (_, x), (_, y) in zip(TR.keystr_items(got.final_params),
                              TR.keystr_items(want.final_params)):
        x, y = x.cpu().double(), y.cpu().double()
        param_err = max(param_err,
                        float((x - y).abs().max() / y.abs().max()))
    wire = lambda tl: [(e.wire_bytes, e.wire_bytes_total) for e in tl.events]
    return (_timing_rows(got) == _timing_rows(want), loss_err, param_err,
            wire(got) == wire(want))


def _quadratic_launches(spec, rounds_x_clusters):
    """A quadratic run's compressor launches: every leaf low-rank (d >=
    min_dim_for_lowrank 8), one pack of P, one projection, one projection
    with the pack of Q and one reconstruction each."""
    n = rounds_x_clusters * spec.n_mats
    return {"quant4_pack": n, "quant4_unpack": 0, "fused_project": n,
            "fused_project_t_pack": n, "fused_reconstruct": n}


def sim_quadratic_cases(dev):
    """4o's second leg: each of ``SIM_QUAD_CASES`` on the card with the
    ``ref`` backend and with ``pallas`` (the compressor kernels at 16 x 16
    or 8 x 8, rank 4), each against the port's CPU run of the same
    scenario and backend (the same arrays and warm start, drawn on the
    host): timing rows equal, losses within ``SIM_QUAD_LOSS_RTOL``,
    params within ``SIM_QUAD_PARAM_RTOL`` of the leaf's max |value|, the
    int4 payload bytes charged per round identical across the backends and
    the CPU, and the pallas runs' kernel launches as the path requires."""
    import numpy as np

    cpu = torch.device("cpu")
    wrappers = kernel_wrappers()
    rows, failures = [], []
    for name in SIM_QUAD_CASES:
        wires = []
        for backend in ("ref", "pallas"):
            ref = sim_quadratic_run(name, backend, cpu)
            for w in wrappers.values():
                w.launches = 0
            t0 = _sync_s(dev)
            tl = sim_quadratic_run(name, backend, dev)
            run_s = _sync_s(dev) - t0
            launches = {k: wrappers[k].launches for k in
                        ("quant4_pack", "quant4_unpack", "fused_project",
                         "fused_project_t_pack", "fused_reconstruct")}
            sc, spec = sim_quadratic_scenario(name, backend)
            want = (_quadratic_launches(spec, sc.rounds * sc.n_clusters)
                    if backend == "pallas" else
                    {k: 0 for k in launches})
            timing_ok, loss_err, param_err, _ = sim_quadratic_gap(tl, ref)
            wires.append([(e.wire_bytes, e.wire_bytes_total)
                          for e in tl.events])
            wires.append([(e.wire_bytes, e.wire_bytes_total)
                          for e in ref.events])
            ok = (timing_ok and loss_err <= SIM_QUAD_LOSS_RTOL
                  and param_err <= SIM_QUAD_PARAM_RTOL and launches == want
                  and all(np.isfinite(tl.losses())))
            print(f"{name} backend {backend}: card {1e3 * run_s:.1f} ms, "
                  f"{len(tl.events)} rounds, last loss {tl.losses()[-1]:.6f}"
                  f" (CPU {ref.losses()[-1]:.6f}); timing rows = CPU run's "
                  f"{timing_ok}; worst loss rel err {loss_err:.3e} (tol "
                  f"{SIM_QUAD_LOSS_RTOL}), worst param err {param_err:.3e} "
                  f"(tol {SIM_QUAD_PARAM_RTOL}); launches {launches}",
                  flush=True)
            rows.append(dict(case=name, backend=backend, loss_err=loss_err,
                             param_err=param_err, ok=ok))
            if not ok:
                failures.append((name, backend))
        if any(w != wires[0] for w in wires):
            failures.append((name, "payload bytes differ across backends"))
    if failures:
        _fail(f"simulator, quadratic scenarios on the card: {failures}")
    return rows


# ---------------------------------------------------------------------------
# phase 4p: the simulator's bounded-stale engine (sim/engine.py's
# BoundedStaleEngine, sim/simulator.py's async executor) at full opt-1.3b
# width with a straggler and a Byzantine member under the trimmed mean; then
# the JAX tests' async quadratic scenarios on the card against the CPU
# ---------------------------------------------------------------------------

SIM_ASYNC_LAYERS = 2    # of opt-1.3b's 24 (1.14 GiB a copy): the executor
                        # holds 5 copies a cluster, up to 11 published
                        # versions and 4 in-flight EF buffers
SIM_ASYNC_BYZANTINE = (3, 2, 4, -8.0)   # (cluster, start, end, scale)
SIM_ASYNC_BYZ_LEG = 2   # the Byzantine leg whose published copy 4p checks


def sim_async_config():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("opt-1.3b"),
                               n_layers=SIM_ASYNC_LAYERS)


def sim_async_scenario(shapes):
    """4p's scenario: 4 clusters, H = 4, 5 legs each, rank 64 int4
    through the compressor kernels, the model's own leaf shapes for the
    wire accounting, 1 Gbps and 1 s modeled steps (§2.4.1), a star,
    ``sync="bounded_stale"`` at ``max_staleness=1``; cluster 1 three times
    slower in its legs 1-3, cluster 3 publishing ``-8 x`` its delta in its
    legs 2-3, and the trimmed mean (trim 1) against it."""
    from repro_torch import sim as S

    c, start, end, scale = SIM_ASYNC_BYZANTINE
    return S.Scenario(
        n_clusters=CLUSTERS, rounds=SIM_ROUNDS, h_steps=CHURN["h_steps"],
        tokens_per_step=CLUSTERS * CHURN["local_batch"] * CHURN["seq_len"],
        faults=S.FaultSchedule((S.Straggler(1, 1, 4, 3.0),
                                S.Byzantine(cluster=c, start_round=start,
                                            end_round=end, scale=scale))),
        compressor="diloco_x",
        compressor_kw=dict(rank=RANK, bits=4, block=256, backend="pallas"),
        sync="bounded_stale", max_staleness=1, topology="star",
        aggregation="trimmed_mean", trim_k=1, param_shapes=shapes, seed=0)


def sim_row_fn(cfg, tcfg, table):
    """The bounded-stale executor's row program built from the trainer's
    pieces (``make_inner_fn``'s step): ``(params_row, opt_row, cluster) ->
    (params_H, opt', losses)``, H AdamW steps from a copy of
    ``params_row`` with ``opt_row``'s moments updated in place. The
    signature carries no leg, so the leg's batches come from the trainer's
    stream at (cluster, step // H, h): each leg trains on fresh tokens."""
    from repro_torch import tree as TR
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as T

    batch_fn = T.default_batch_fn(tcfg, table)
    H = tcfg.h_steps

    def row(params, opt, c):
        dev = TR.leaves(params)[0].device
        leg = int(opt.step) // H
        p = TR.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                        params)
        losses = []
        for h in range(H):
            toks = T._as_tensor(batch_fn(c, leg, h), dev)
            with torch.enable_grad():
                loss, _ = M.loss_fn(p, cfg, {"tokens": toks},
                                    flash=tcfg.flash_attention)
                grads = torch.autograd.grad(loss, TR.leaves(p))
            grads = TR.unflatten_like(p, list(grads))
            p, opt = adamw.update(grads, opt, p, lr=tcfg.inner_lr)
            losses.append(loss.detach())
        return (TR.tree_map(lambda x: x.detach(), p), opt,
                torch.stack(losses))

    return row


def sim_async_schedule(sc):
    """The engine's callback sequence for ``sc`` without numerics:
    ``("publish", c, k)`` and ``("commit", AsyncCommit)`` in the order the
    executor sees them."""
    from repro_torch import sim as S
    from repro_torch.core.compression import make_compressor
    from repro_torch.topology import async_mix_weights

    comp = make_compressor(sc.compressor, **sc.compressor_kw)
    wire = int(comp.wire_bytes(sc.shapes(), rank=sc.rank))
    topo = sc.topo()
    W = async_mix_weights(topo)
    C = sc.n_clusters
    peers = [tuple(p for p in range(C) if p != c and W[c, p] > 0.0)
             for c in range(C)]
    leg_s, send_s, _ = S.async_modeled_times(sc, wire, topo)
    log = []
    S.BoundedStaleEngine(
        n_clusters=C, rounds=sc.rounds, max_staleness=sc.max_staleness,
        peers=peers, leg_seconds=leg_s, send_seconds=send_s,
        commit=lambda ev: log.append(("commit", ev)),
        on_publish=lambda c, k, t: log.append(("publish", c, k)),
        leaves=sc.faults.leave_events(),
        joins=sc.faults.join_events()).run()
    return log


def sim_async_replay(sc, log, draw, row, comp0, lr, momentum):
    """Phase 4p's hand-driven replay: ``log``'s publishes and commits
    through the port's parts directly (the row program, ``roundtrip``,
    the corrupt step, ``trimmed_cluster_mean`` over the whole stacked tree,
    ``nesterov.update``), from ``draw()``'s params. Returns each cluster's
    params."""
    from repro_torch import tree as TR
    from repro_torch.core import diloco as D
    from repro_torch.core import membership as MB
    from repro_torch.optim import adamw, nesterov

    C = sc.n_clusters
    comp = _compressor()
    p0 = draw()
    params = [p0] + [TR.tree_map(torch.clone, p0) for _ in range(1, C)]
    inner = [adamw.init(p0) for _ in range(C)]
    outer = [nesterov.init(p0) for _ in range(C)]
    error = [TR.tree_map(torch.zeros_like, p0) for _ in range(C)]
    warm = [TR.tree_map(torch.clone, comp0) for _ in range(C)]
    store, inflight = {}, {}
    with torch.no_grad():
        for entry in log:
            if entry[0] == "publish":
                _, c, k = entry
                p_in, opt, _ = row(params[c], inner[c], c)
                raw = D.pseudo_grad(params[c], p_in, error[c])
                del p_in
                hat, q = comp.roundtrip(raw, warm[c], sc.rank)
                err = TR.tree_map(lambda r, h: r - h, raw, hat)
                del raw
                scale = sc.faults.byzantine_scale(c, k)
                if scale is not None:
                    hat = TR.tree_map(lambda x: x * scale, hat)
                store[(c, k)] = hat
                inflight[c] = (err, opt, q)
                continue
            ev = entry[1]
            c, used = ev.cluster, dict(ev.used)
            zeros = TR.tree_map(torch.zeros_like, params[c])
            rows = [store[(p, used[p])] if p in used else zeros
                    for p in range(C)]
            stacked = TR.tree_map(lambda *xs: torch.stack(xs), *rows)
            del rows, zeros
            mask = [1.0 if p in used else 0.0 for p in range(C)]
            Delta = MB.trimmed_cluster_mean(stacked, mask, sc.trim_k)
            del stacked
            params[c], outer[c] = nesterov.update(
                Delta, outer[c], params[c], lr=lr, momentum=momentum)
            del Delta
            error[c], inner[c], warm[c] = inflight.pop(c)
            for key in [key for key in store if key[1] < ev.avail[key[0]]]:
                del store[key]
    return params


def _host_copy(tree):
    """The leaves of ``tree`` copied to the host (a copy also of a CPU
    tensor: the executor writes its buffers in place)."""
    from repro_torch import tree as TR
    return [x.detach().to("cpu", copy=True) for x in TR.leaves(tree)]


def sim_bounded_stale(dev=None, cfg=None):
    """Phase 4p: ``repro_torch.sim.simulate`` under ``sync="bounded_stale"``
    (``sim_async_scenario``) on opt-1.3b at full width,
    ``SIM_ASYNC_LAYERS`` layers, 4 clusters, H = 4, 4 x 512, flash on,
    LowRankQuant rank 64 int4 through the compressor kernels, the row
    program of ``sim_row_fn``: 20 commits, one per cluster and leg.
    Gates: the timeline but loss, param_hash and disagreement equal to a
    timing-only ``simulate`` of the scenario, every staleness <= 1 and each
    commit's own entry 0, some commit mixing a version ahead of its
    publisher's commit; each cluster's final params bit for bit those of a
    hand-driven replay of the engine's sequence (``sim_async_replay``, run
    after the first run's state is freed) and the last commit's param_hash
    the replay's ``tree_hash``; at Byzantine leg ``SIM_ASYNC_BYZ_LEG`` the
    stored version ``-8 x`` the clean hat and the EF error ``raw - hat``,
    bit for bit; finite losses; compressor launches
    ``compressor_launches_expected(cfg, 20)`` and flash launches 80 steps x
    layers x (2 forward, 1 backward). Prints each commit's wall ms (publish
    leg, commit, ``tree_hash``, disagreement) beside its modeled seconds,
    the modeled makespan, tokens/s and barrier idle, the peak and the
    card's name and power limit. Then ``sim_async_quadratic_cases``."""
    import numpy as np

    from repro_torch import sim as S
    from repro_torch import tree as TR
    from repro_torch.core.compression import tree_shapes
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.sim import NumericProblem
    from repro_torch.sim import simulator as SS
    from repro_torch.train import trainer as T

    cfg = cfg or sim_async_config()
    dev = dev or torch.device("cuda")
    tcfg = T.TrainConfig(**CHURN)
    C, H = tcfg.n_clusters, tcfg.h_steps
    byz_c, _, _, byz_scale = SIM_ASYNC_BYZANTINE

    def draw():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return M.init_params(cfg, gen, dev)

    params = draw()
    sc = sim_async_scenario(tree_shapes(params))
    _phase(f"simulator, bounded-stale: repro_torch.sim.simulate, "
           f"sync={sc.sync}, max_staleness {sc.max_staleness}, star, "
           f"{sc.aggregation} (trim {sc.trim_k}), on opt-1.3b d_model "
           f"{cfg.d_model}, {cfg.n_layers} of 24 layers, {C} clusters, H "
           f"{H}, {tcfg.local_batch} x {tcfg.seq_len}, flash, LowRankQuant "
           f"rank {RANK} int4 (kernels), {sc.rounds} legs a cluster, faults "
           f"{[e.describe() for e in sc.faults.events]}")
    timing = S.simulate(sc)
    log = sim_async_schedule(sc)
    commits = [e[1] for e in log if e[0] == "commit"]
    ahead = sum(1 for ev in commits for p, idx in ev.used
                if idx > ev.round_clock[p])
    data = SyntheticLM(cfg.vocab_size, tcfg.seq_len, tcfg.local_batch,
                       seed=tcfg.seed)
    row = sim_row_fn(cfg, tcfg, data.table)
    comp0 = _compressor().init_state(params)
    prob = NumericProblem(
        params=params,
        inner_opt_stacked=T._init_inner_stacked(params, C),
        inner_fn=None, inner_fn_row=row, outer_lr=tcfg.outer_lr,
        outer_momentum=tcfg.outer_momentum)
    del params
    byz = dict(armed=False, raw=None, hat=None, stored=None, error=None)

    class Watched:
        """The compressor ``simulate`` builds: keeps host copies of the
        Byzantine leg's input and clean output."""

        def __init__(self, c):
            self._c = c

        def __getattr__(self, attr):
            return getattr(self._c, attr)

        def roundtrip(self, tree, state, rank_scalar=None):
            out = self._c.roundtrip(tree, state, rank_scalar)
            if byz["armed"]:
                byz["raw"], byz["hat"] = _host_copy(tree), _host_copy(out[0])
            return out

    publish = SS._AsyncNumeric.publish

    def watched_publish(self, c, k, t):
        byz["armed"] = (c, k) == (byz_c, SIM_ASYNC_BYZ_LEG)
        publish(self, c, k, t)
        if byz["armed"]:
            byz["stored"] = _host_copy(self.store[c][k])
            byz["error"] = _host_copy(self._inflight[c][0])
            byz["armed"] = False

    wrappers = kernel_wrappers()
    steps = len(commits) * H
    want = compressor_launches_expected(cfg, len(commits))
    want.update(flash_attention=steps * 2 * cfg.n_layers,
                flash_attention_bwd=steps * cfg.n_layers, lowrank_mm=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    make = SS.make_compressor
    SS.make_compressor = lambda name, **kw: Watched(make(name, **kw))
    SS._AsyncNumeric.publish = watched_publish
    try:
        t0 = _sync_s(dev)
        tl = S.simulate(sc, numeric=prob)
        sim_s = _sync_s(dev) - t0
    finally:
        SS.make_compressor = make
        SS._AsyncNumeric.publish = publish
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    final = [_host_copy(TR.tree_map(lambda y: y[c], tl.final_params))
             for c in range(C)]
    del tl.final_params, prob
    gc.collect()
    torch.cuda.empty_cache()
    for e, w in zip(tl.events, tl.wall):
        print(f"commit c{e.cluster} leg {e.round}: staleness "
              f"{list(e.staleness)}, round_clock {e.round_clock}, loss "
              f"{e.loss:.6f}, disagreement {e.disagreement:.6e}; wall: "
              f"publish leg {1e3 * w['publish_s']:.1f} ms, commit "
              f"{1e3 * w['commit_s']:.1f} ms, tree_hash "
              f"{1e3 * w['hash_s']:.1f} ms, disagreement "
              f"{1e3 * w['disagreement_s']:.1f} ms; modeled t_start "
              f"{e.t_start_s:.3f} s, leg {e.t_compute_s:.3f} s, send "
              f"{e.t_comm_s:.3f} s, stale wait {e.exposed_comm_s:.3f} s",
              flush=True)

    # the Byzantine leg: the published copy and the EF error
    byz_ok = (byz["stored"] is not None and all(
        torch.equal(s, h * byz_scale) for s, h in zip(byz["stored"],
                                                      byz["hat"]))
        and all(torch.equal(e, r - h) for e, r, h in zip(
            byz["error"], byz["raw"], byz["hat"]))
        and any(bool(h.any()) for h in byz["hat"]))
    byz.clear()

    # the hand-driven replay, after the run's state is freed
    t0 = _sync_s(dev)
    replay = sim_async_replay(sc, log, draw, row, comp0, tcfg.outer_lr,
                              tcfg.outer_momentum)
    replay_s = _sync_s(dev) - t0
    last = tl.events[-1]
    replay_hash = S.tree_hash(replay[last.cluster])
    same_rows = [all(torch.equal(x.cpu(), y) for x, y in
                     zip(TR.leaves(replay[c]), final[c])) for c in range(C)]
    del replay, final
    gc.collect()
    torch.cuda.empty_cache()

    same_timing = _timing_rows(tl) == _timing_rows(timing)
    stale_ok = all(0 <= s <= sc.max_staleness and
                   (p != e.cluster or s == 0)
                   for e in tl.events for p, s in e.staleness)
    losses = tl.losses()
    w = tl.wall
    smi = (card_name_and_power_limit() if dev.type == "cuda"
           else "no card")
    total = lambda key: sum(x[key] for x in w)
    print(f"simulator, bounded-stale, on {smi}: {sim_s:.1f} s for "
          f"{len(tl.events)} commits: publish legs {total('publish_s'):.1f} "
          f"s, commits {total('commit_s'):.1f} s, tree_hash "
          f"{total('hash_s'):.1f} s, disagreement "
          f"{total('disagreement_s'):.1f} s; peak {peak / 2**30:.2f} GiB at "
          f"{cfg.n_layers} layers; timeline = timing-only run but loss, "
          f"param_hash and disagreement: {same_timing} (structural "
          f"fingerprint {timing.structural_fingerprint()[:16]}); staleness "
          f"<= {sc.max_staleness}, own 0: {stale_ok}; versions used ahead "
          f"of their publisher's commit: {ahead}; final params = replay bit "
          f"for bit per cluster: {same_rows} (replay {replay_s:.1f} s), last "
          f"param_hash = replay's tree_hash: "
          f"{replay_hash == last.param_hash}; cluster {byz_c} leg "
          f"{SIM_ASYNC_BYZ_LEG}: stored = {byz_scale} x clean hat and error "
          f"= raw - hat bit for bit: {byz_ok}; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; modeled makespan {timing.total_time_s:.3f} s, "
          f"{timing.tokens_per_s:.1f} tok/s, barrier idle "
          f"{timing.barrier_idle_frac:.4f}; launches {launches} (expected "
          f"{want})", flush=True)
    if not same_timing:
        _fail("bounded-stale simulator: the numeric timeline's timing and "
              "structure differ from the timing-only run's")
    if not stale_ok or ahead == 0:
        _fail(f"bounded-stale simulator: staleness bound or regime: "
              f"bound held {stale_ok}, versions ahead {ahead}")
    if not all(same_rows) or replay_hash != last.param_hash:
        _fail(f"bounded-stale simulator: final params differ from the "
              f"hand-driven replay: {same_rows}, last hash "
              f"{replay_hash == last.param_hash}")
    if not byz_ok:
        _fail("bounded-stale simulator: the Byzantine member's published "
              "copy or EF error is not scale x hat / raw - hat")
    if not all(math.isfinite(x) for x in losses):
        _fail(f"bounded-stale simulator: non-finite losses {losses}")
    if launches != want:
        _fail(f"bounded-stale simulator: launches {launches}, expected "
              f"{want}")
    return launches, sim_async_quadratic_cases(dev)


def sim_async_quadratic_scenario(name, backend):
    """The numeric quadratic scenarios of ``tests/test_engine.py:221-313``
    (bounded-stale: the mean over a star and a ring, the straggler regime,
    churn with a rejoin, a Byzantine member under the mean and under the
    trimmed mean), with the compressor's ``backend``: (Scenario,
    QuadraticSpec)."""
    from repro_torch import sim as S

    comp = dict(compressor="diloco_x",
                compressor_kw={"rank": 4, "backend": backend}, rank=4)
    link = S.LinkProfile(bytes_per_s=2e8, latency_s=0.01, jitter=0.1)
    base = dict(n_clusters=4, rounds=6, h_steps=4, seed=3, t_step_s=0.02,
                sync="bounded_stale", max_staleness=2, link=link, **comp)
    spec4 = S.QuadraticSpec(n_clusters=4, d=8, h_steps=4, seed=1)
    if name in ("test_engine.py:221 star", "test_engine.py:221 ring"):
        return S.Scenario(**base, topology=name.split()[-1]), spec4
    if name == "test_engine.py:237":
        return S.Scenario(**dict(base, n_clusters=3, rounds=8),
                          topology="star", faults=S.FaultSchedule((
                              S.Straggler(1, 1, 5, 3.0),))), \
            S.QuadraticSpec(n_clusters=3, d=8, h_steps=4, seed=1)
    if name == "test_engine.py:280":
        return S.Scenario(**base, faults=S.FaultSchedule((
            S.Leave(0, 2), S.Join(0, 4)))), spec4
    if name.startswith("test_engine.py:294"):
        kw = (dict(aggregation="trimmed_mean", trim_k=1)
              if name.endswith("trimmed") else {})
        return S.Scenario(
            n_clusters=5, rounds=10, h_steps=4, seed=11, t_step_s=0.02,
            sync="bounded_stale", max_staleness=1,
            link=S.LinkProfile(bytes_per_s=2e8, latency_s=0.01,
                               jitter=0.05),
            faults=S.FaultSchedule((S.Byzantine(cluster=2, start_round=2,
                                                end_round=8, scale=-8.0),)),
            **comp, **kw), S.QuadraticSpec(n_clusters=5, d=8, h_steps=4,
                                           seed=3)
    raise KeyError(name)


SIM_ASYNC_QUAD_CASES = ("test_engine.py:221 star", "test_engine.py:221 ring",
                        "test_engine.py:237", "test_engine.py:280",
                        "test_engine.py:294 mean",
                        "test_engine.py:294 trimmed")


def sim_async_quadratic_run(name, backend, device):
    from repro_torch import sim as S

    sc, spec = sim_async_quadratic_scenario(name, backend)
    return S.simulate(sc, numeric=spec.problem(device))


def sim_async_quadratic_cases(dev):
    """4p's second leg: each of ``SIM_ASYNC_QUAD_CASES`` on the card with
    the ``ref`` backend and with ``pallas`` (d 8 < min_dim_for_lowrank:
    every leaf quantize-only, one int4 pack and one unpack a leaf and
    commit), each against the port's CPU run of the same scenario and
    backend: timing rows equal, losses within ``SIM_QUAD_LOSS_RTOL``,
    params within ``SIM_QUAD_PARAM_RTOL`` of the leaf's max |value|, the
    launches as the path requires."""
    import numpy as np

    cpu = torch.device("cpu")
    wrappers = kernel_wrappers()
    names = ("quant4_pack", "quant4_unpack", "fused_project",
             "fused_project_t_pack", "fused_reconstruct")
    rows, failures = [], []
    for name in SIM_ASYNC_QUAD_CASES:
        for backend in ("ref", "pallas"):
            ref = sim_async_quadratic_run(name, backend, cpu)
            for w in wrappers.values():
                w.launches = 0
            t0 = _sync_s(dev)
            tl = sim_async_quadratic_run(name, backend, dev)
            run_s = _sync_s(dev) - t0
            launches = {k: wrappers[k].launches for k in names}
            sc, spec = sim_async_quadratic_scenario(name, backend)
            n = len(tl.events) * spec.n_mats if backend == "pallas" else 0
            want = {k: (n if k.startswith("quant4") else 0) for k in names}
            timing_ok, loss_err, param_err, _ = sim_quadratic_gap(tl, ref)
            ok = (timing_ok and loss_err <= SIM_QUAD_LOSS_RTOL
                  and param_err <= SIM_QUAD_PARAM_RTOL and launches == want
                  and all(np.isfinite(tl.losses())))
            print(f"{name} backend {backend}: card {1e3 * run_s:.1f} ms, "
                  f"{len(tl.events)} commits, last loss "
                  f"{tl.losses()[-1]:.6f} (CPU {ref.losses()[-1]:.6f}); "
                  f"timing rows = CPU run's {timing_ok}; worst loss rel err "
                  f"{loss_err:.3e} (tol {SIM_QUAD_LOSS_RTOL}), worst param "
                  f"err {param_err:.3e} (tol {SIM_QUAD_PARAM_RTOL}); "
                  f"launches {launches}", flush=True)
            rows.append(dict(case=name, backend=backend, loss_err=loss_err,
                             param_err=param_err, ok=ok))
            if not ok:
                failures.append((name, backend))
    if failures:
        _fail(f"bounded-stale simulator, quadratic scenarios on the card: "
              f"{failures}")
    return rows


# ---------------------------------------------------------------------------
# phase 5: the serving path, through the user's entry point
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "opt-1.3b", "--paged", "--batch", "8",
              "--requests", "12", "--prompt-len", "128", "--gen-len", "64",
              "--page-size", "16", "--eos", "-1", "--device", "cuda"]


def serve(arch="opt-1.3b", dtype="float32"):
    """Phase 5 (opt-1.3b), 5b (stablelm-12b, full width and depth) and the
    serve half of 5f (opt-1.3b, ``dtype`` "bfloat16": bf16 weights and KV
    pool)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.serve import attention_paged as ap

    argv = ["--arch", arch] + SERVE_ARGS[2:] + ["--dtype", dtype]
    _phase("serve: python -m repro_torch.launch.serve " + " ".join(argv))
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ap.cuda_paged_attention.launches = 0
    st = serve_lib.main(argv)
    torch.cuda.synchronize()
    launches = ap.cuda_paged_attention.launches
    want = st["device_steps"] * cfg.n_layers
    print(f"serve: {st['requests_done']} requests, {st['device_steps']} "
          f"device steps, paged_attention launches {launches} "
          f"(device steps x {cfg.n_layers} = {want}), pages in use after "
          f"{st['pages_in_use']}")
    print(f"serve: prefill {st['prefill_tok_s']:.1f} tok/s, decode "
          f"{st['decode_tok_s']:.1f} tok/s, per-token p50/p99 "
          f"{st['per_token_ms_p50']:.3f}/{st['per_token_ms_p99']:.3f} ms, "
          f"wall {st['wall_s']:.3f} s, kv pool {st['kv_pool_bytes']} B, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if st["requests_done"] != 12 or st["pages_in_use"] != 0:
        raise SystemExit(f"FAIL serve: {st['requests_done']} of 12 requests "
                         f"done, {st['pages_in_use']} pages still in use")
    if launches != want or launches == 0:
        raise SystemExit(f"FAIL serve: {launches} kernel launches, expected "
                         f"{want}")
    for req in st["done"]:
        g = req.generated
        if len(g) != 64 or min(g) < 0 or max(g) >= cfg.vocab_size:
            raise SystemExit(f"FAIL serve: request {req.rid} generated {g}")
    st["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return launches, st


def serve_bf16(ref):
    """Phase 5f: phase 5's run at ``--dtype bfloat16`` (its gates), the KV
    pool exactly half of 5's, tok/s and per-token p50/p99 beside 5's; then
    paged against dense greedy tokens in bf16 (``paged_vs_dense``)."""
    launches, st = serve("opt-1.3b", dtype="bfloat16")
    if 2 * st["kv_pool_bytes"] != ref["kv_pool_bytes"]:
        _fail(f"serve bf16: kv pool {st['kv_pool_bytes']} B, not half of "
              f"phase 5's {ref['kv_pool_bytes']}")
    print(f"5f: decode {st['decode_tok_s']:.1f} tok/s (5: "
          f"{ref['decode_tok_s']:.1f}), prefill {st['prefill_tok_s']:.1f} "
          f"(5: {ref['prefill_tok_s']:.1f}), per-token p50/p99 "
          f"{st['per_token_ms_p50']:.3f}/{st['per_token_ms_p99']:.3f} ms (5: "
          f"{ref['per_token_ms_p50']:.3f}/{ref['per_token_ms_p99']:.3f}), kv "
          f"pool {st['kv_pool_bytes']} B (5: {ref['kv_pool_bytes']}), peak "
          f"{st['peak_gib']:.2f} GiB (5: {ref['peak_gib']:.2f})", flush=True)
    equal = paged_vs_dense("opt-1.3b", dtype="bfloat16")
    print(f"5f: paged and dense greedy tokens bit for bit equal: {equal}",
          flush=True)
    return launches, st


# ---------------------------------------------------------------------------
# phase 5c: the serve driver's tensor-parallel shards, all on the card
# ---------------------------------------------------------------------------

SERVE_TP_LEGS = (("opt-1.3b", 2, 2), ("opt-1.3b", 1, 4),
                 ("stablelm-12b", 1, 4))     # arch, --data, --model


def serve_tp(ref, arch="opt-1.3b", data=2, model=2):
    """Phase 5c: ``launch/serve.py``'s in-process entry (``run`` with no
    shards: every (data, model) shard in this process) on phase 5's
    requests at ``--data`` x ``--model``: the greedy tokens and the
    admission fingerprint of the one-card run ``ref`` (phase 5 or 5b's
    stats), the paged kernel launched once a unit and step on every
    shard's pool. Returns the launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.serve import attention_paged as ap

    argv = (["--arch", arch] + SERVE_ARGS[2:]
            + ["--devices", str(data * model), "--data", str(data),
               "--model", str(model)])
    _phase("serve tp: repro_torch.launch.serve.run, every shard on the "
           "card: " + " ".join(argv))
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ap.cuda_paged_attention.launches = 0
    st = serve_lib.run(serve_lib._parse_args(argv), torch.device("cuda"))
    torch.cuda.synchronize()
    launches = ap.cuda_paged_attention.launches
    want = st["device_steps"] * cfg.n_layers * data * model
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve tp {data} x {model}: {st['requests_done']} requests, "
          f"{st['device_steps']} device steps, paged_attention launches "
          f"{launches} (device steps x {cfg.n_layers} x {data * model} "
          f"shards = {want})")
    print(f"serve tp {data} x {model}: per-token p50/p99 "
          f"{st['per_token_ms_p50']:.3f}/{st['per_token_ms_p99']:.3f} ms "
          f"(one card: {ref['per_token_ms_p50']:.3f}/"
          f"{ref['per_token_ms_p99']:.3f}), decode {st['decode_tok_s']:.1f} "
          f"tok/s (one card: {ref['decode_tok_s']:.1f}), peak memory "
          f"{peak:.2f} GiB (one card: {ref['peak_gib']:.2f})")
    same = [a == b for a, b in zip(st["tokens"], ref["tokens"])]
    print(f"serve tp {data} x {model}: {sum(same)} of {len(same)} requests' "
          f"tokens equal the one card's; admission fingerprint "
          f"{st['admission_fingerprint']} (one card: "
          f"{ref['admission_fingerprint']})")
    if not all(same) or len(st["tokens"]) != len(ref["tokens"]):
        bad = same.index(False) if False in same else len(same)
        _fail(f"serve tp {arch} {data} x {model}: request {bad}'s tokens "
              f"differ from the one-card run's")
    if st["admission_fingerprint"] != ref["admission_fingerprint"]:
        _fail(f"serve tp {arch} {data} x {model}: admission fingerprint "
              f"differs")
    if launches != want:
        _fail(f"serve tp {arch} {data} x {model}: {launches} kernel "
              f"launches, expected {want}")
    return launches


# ---------------------------------------------------------------------------
# phase 5d: the paged kernel on KV-head shards against the whole cache
# ---------------------------------------------------------------------------

SHARD_CASES = [
    # name, shape kw, window, model shards
    ("opt-1.3b", dict(KV=32, G=1, dh=64), 0, (2, 4)),
    ("stablelm-12b", dict(KV=8, G=4, dh=160), 0, (2, 4)),
    ("qwen1.5-107b", dict(KV=8, G=8, dh=128), 0, (2, 4)),
    ("gemma3-1b (replicated KV head)", dict(KV=1, G=4, dh=256), 512, (2,)),
    ("gemma3-1b global (replicated KV head)", dict(KV=1, G=4, dh=256), 0,
     (2,)),
]


def paged_shards():
    """Phase 5d: one decode step's paged attention at 2,048 tokens, the
    kernel launched on each model shard's query heads and its KV heads
    (``parallel.tensor.kv_heads``: KV/M, or the one head a shard
    replicates), must be bit for bit those heads of the whole-cache
    launch: the plan (``_plan.paged_plan``) reads neither the heads nor G,
    and each head's sums run in the same order."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.parallel.tensor import kv_heads
    from repro_torch.serve import attention_paged as ap

    _phase("paged attention on KV-head shards vs the whole cache")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for name, kw, window, ms in SHARD_CASES:
        q, cache, table, lengths = paged_case(
            gen, S=8, P=128, ps=16, max_len=2048, n_inactive=1, dev=dev,
            **kw)
        whole = ap.cuda_paged_attention(q, cache, table, lengths,
                                        window=window)
        H = q.shape[2]
        cfg = ModelConfig(n_heads=H, n_kv_heads=kw["KV"], head_dim=kw["dh"])
        for nm in ms:
            hl = H // nm
            equal = True
            for m in range(nm):
                lo, hi = kv_heads(cfg, nm, m)
                part = {k: v[:, :, lo:hi].contiguous()
                        for k, v in cache.items()}
                got = ap.cuda_paged_attention(
                    q[:, :, m * hl:(m + 1) * hl].contiguous(), part, table,
                    lengths, window=window)
                equal &= bool(torch.equal(got,
                                          whole[:, :, m * hl:(m + 1) * hl]))
            torch.cuda.synchronize()
            print(f"paged shards: {name} (H {H}, KV {kw['KV']}, dh "
                  f"{kw['dh']}, window {window}) at M = {nm}, "
                  f"{hi - lo} KV head(s) a shard: bit for bit the whole "
                  f"launch's heads: {equal}")
            if not equal:
                _fail(f"paged shards: {name} at M = {nm} differs from the "
                      f"whole-cache launch")


# ---------------------------------------------------------------------------
# phase 5e: the 2-D serving placement (the JAX dry-run's default)
# ---------------------------------------------------------------------------

PREFILL_RTOL = 1e-4     # the sharded prefill's last logits, of their max


def serve_2d(ref, arch="opt-1.3b", data=2, model=2):
    """Phase 5e: phase 5's requests through ``TPDecode``'s 2-D placement
    (weights placed as for training, FSDP over "data" too, each unit's
    gathered before it runs; ``serve.run(..., placement="2d")``), every
    shard in this process: tokens and admission fingerprint phase 5's,
    the paged kernel launched device steps x layers x shards times
    (counts reset before, read after). Then the sharded prefill
    (``TPLoss.prefill``) of phase 5's first 8 prompts against the one-card
    ``make_prefill_step``: last logits within ``PREFILL_RTOL`` of their
    largest magnitude."""
    from repro_torch import tree as T
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel import tensor as TP
    from repro_torch.serve import attention_paged as ap

    argv = (["--arch", arch] + SERVE_ARGS[2:]
            + ["--devices", str(data * model), "--data", str(data),
               "--model", str(model)])
    _phase("serve 2-D: repro_torch.launch.serve.run(placement=\"2d\"), "
           "every shard on the card: " + " ".join(argv))
    cfg = get_config(arch)
    args = serve_lib._parse_args(argv)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ap.cuda_paged_attention.launches = 0
    st = serve_lib.run(args, torch.device("cuda"), placement="2d")
    torch.cuda.synchronize()
    launches = ap.cuda_paged_attention.launches
    want = st["device_steps"] * cfg.n_layers * data * model
    same = [a == b for a, b in zip(st["tokens"], ref["tokens"])]
    print(f"serve 2-D {data} x {model}: {sum(same)} of {len(same)} "
          f"requests' tokens equal phase 5's; admission fingerprint "
          f"{st['admission_fingerprint']} (5: {ref['admission_fingerprint']})"
          f"; paged_attention launches {launches} (device steps x "
          f"{cfg.n_layers} x {data * model} = {want}); per-token p50/p99 "
          f"{st['per_token_ms_p50']:.3f}/{st['per_token_ms_p99']:.3f} ms "
          f"(5: {ref['per_token_ms_p50']:.3f}/{ref['per_token_ms_p99']:.3f})"
          f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if not all(same) or len(st["tokens"]) != len(ref["tokens"]):
        _fail("serve 2-D: tokens differ from phase 5's")
    if st["admission_fingerprint"] != ref["admission_fingerprint"]:
        _fail("serve 2-D: admission fingerprint differs")
    if launches != want or launches == 0:
        _fail(f"serve 2-D: {launches} kernel launches, expected {want}")
    # the sharded prefill against one card's
    dev = torch.device("cuda")
    params = M.draw_params(cfg, 0, dev)
    gen = torch.Generator()
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (8, args.prompt_len),
                         generator=gen, dtype=torch.int32).to(dev)
    one = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    shards = TP.ShardGroup(data, model)
    specs = sh.param_placements(params, shards.mesh, cluster_stacked=False)
    parts = {k: shards.parts(x, specs[k]) for k, x in T.keystr_items(params)}
    n = toks.shape[0] // data
    got = torch.cat(TP.TPLoss(cfg, shards, specs).prefill(
        parts, [toks[j * n:(j + 1) * n] for j in range(data)]))
    err = float((got - one).abs().max() / one.abs().max())
    print(f"sharded prefill {data} x {model} (8 x {args.prompt_len}): last "
          f"logits {err:.3e} of their max from one card's", flush=True)
    if not err <= PREFILL_RTOL:
        _fail(f"sharded prefill: {err:.3e} of the max, over {PREFILL_RTOL}")
    del params, parts
    return launches


# ---------------------------------------------------------------------------
# phase 6: paged (kernel) vs dense (plain attention) greedy tokens
# ---------------------------------------------------------------------------

BF16_TIE_ULPS = 3      # a bf16 near-tie: top-2 logits this many bf16 ulps of
                       # the top one apart (tests/test_torch_bf16.py)


def paged_vs_dense(arch="opt-1.3b", n_layers=0, n_prompts=2, prompt_len=16,
                   gen_len=32, ps=16, tie_margin=1e-4, dtype="float32"):
    """Phase 6 (opt-1.3b), 6b (stablelm-12b; qwen1.5-107b at ``n_layers``
    of 78) and the tokens half of 5f (opt-1.3b, ``dtype`` "bfloat16"):
    greedy tokens of the paged engine (kernel) against the dense decode
    loop (plain attention); a divergence passes only at a dense top-2
    margin below ``tie_margin`` (in bf16, below BF16_TIE_ULPS ulps of the
    top logit: the kernel and the plain version round the bf16 attention
    output apart by an ulp). Returns whether every token was equal."""
    from repro_torch.configs.base import get_config, with_dtype
    from repro_torch.models import model as M
    from repro_torch.serve import attention_paged as ap
    from repro_torch.serve.engine import ServeEngine

    cfg = with_dtype(get_config(arch), dtype)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    _phase(f"paged vs dense: {arch} full width, {cfg.n_layers} layers, "
           f"{n_prompts} prompts x {gen_len} tokens, {dtype}")
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    pgen = torch.Generator()
    pgen.manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (n_prompts, prompt_len),
                            generator=pgen, dtype=torch.int32)

    # dense: the model's decode loop, plain attention
    state = M.init_decode_state(cfg, n_prompts, prompt_len + gen_len,
                                device=dev)
    toks = prompts.to(dev)
    dense, margins = [], []
    nxt = None
    for t in range(prompt_len + gen_len - 1):
        cur = toks[:, t:t + 1] if t < prompt_len else nxt
        logits, state = M.decode_step(params, cfg, state, cur)
        top2 = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        if t >= prompt_len - 1:
            dense.append(nxt[:, 0].cpu())
            margin = top2[:, 0] - top2[:, 1]
            if dtype == "bfloat16":       # in bf16 ulps of the top logit
                margin = margin / 2.0 ** (torch.floor(torch.log2(
                    top2[:, 0].abs())) - 7)
            margins.append(margin.cpu())
    dense = torch.stack(dense, dim=1)
    margins = torch.stack(margins, dim=1)

    # paged: the engine, CUDA kernel
    max_pages = -(-(prompt_len + gen_len) // ps)
    eng = ServeEngine(params, cfg, max_seqs=n_prompts, page_size=ps,
                      n_pages=n_prompts * max_pages,
                      max_pages_per_seq=max_pages, eos_id=None, device=dev)
    for b in range(n_prompts):
        eng.submit(prompts[b].tolist(), gen_len)
    ap.cuda_paged_attention.launches = 0
    eng.run()
    torch.cuda.synchronize()
    if ap.cuda_paged_attention.launches != eng.device_steps * cfg.n_layers:
        _fail(f"paged vs dense {arch}: {ap.cuda_paged_attention.launches} "
              f"kernel launches, expected {eng.device_steps} device steps x "
              f"{cfg.n_layers}")
    paged = torch.tensor([r.generated for r in
                          sorted(eng.sched.done, key=lambda r: r.rid)])
    if dtype == "bfloat16":
        tie_margin = BF16_TIE_ULPS
    equal = bool(torch.equal(paged, dense))
    for b in range(n_prompts):
        diff = (paged[b] != dense[b]).nonzero()
        if len(diff) == 0:
            print(f"prompt {b}: {gen_len} tokens equal; smallest dense "
                  f"top-2 margin {float(margins[b].min()):.4e}")
            continue
        t = int(diff[0])
        m = float(margins[b, t])
        print(f"prompt {b}: first divergence at token {t}: paged "
              f"{int(paged[b, t])} dense {int(dense[b, t])}, dense top-2 "
              f"margin {m:.4e}")
        if m >= tie_margin:
            raise SystemExit(f"FAIL paged vs dense: prompt {b} diverges at "
                             f"token {t} with margin {m:.4e} >= {tie_margin}")
    return equal


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 matmuls reduce in f32 in every phase, timed or compared
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t0 = time.monotonic()
    smi = environment()
    build()
    rows, worst = kernel_vs_plain()
    rows_bf16, worst_bf16 = kernel_vs_plain(torch.bfloat16)
    comp_rows = compressor_kernels()
    mesh_q4 = mesh_quant4()
    mesh_q4_stablelm = mesh_quant4(cfg=stablelm_mesh_config())
    flash_rows = flash_kernels()
    torch.cuda.empty_cache()
    flash_rows_bf16 = flash_kernels_bf16()
    torch.cuda.empty_cache()
    mm_row = lowrank_mm_kernel()
    torch.cuda.empty_cache()
    mm_row_stablelm = lowrank_mm_kernel(cfg=stablelm_mesh_config())
    torch.cuda.empty_cache()
    einsum_run = train()
    compressor_share(einsum_run[1], comp_rows)
    torch.cuda.empty_cache()
    flash_run = train(flash=True)
    compare_train(einsum_run, flash_run)
    torch.cuda.empty_cache()
    bf16_run = train_bf16(flash_run)
    torch.cuda.empty_cache()
    step_ab()
    torch.cuda.empty_cache()
    gqa_model()
    torch.cuda.empty_cache()
    mesh_launches, mesh_summary = mesh_driver()
    torch.cuda.empty_cache()
    mesh_driver_bf16(mesh_summary)
    torch.cuda.empty_cache()
    mesh_launches_stablelm = mesh_driver(argv=MESH_ARGS_STABLELM,
                                         cfg=stablelm_mesh_config())[0]
    torch.cuda.empty_cache()
    cocktail_ddp()
    torch.cuda.empty_cache()
    pp_train_launches = train_pp(flash_run)[0]
    torch.cuda.empty_cache()
    pp_driver_launches = pp_driver()
    torch.cuda.empty_cache()
    tp_launches = tp_driver(mesh_summary, mesh_launches)
    torch.cuda.empty_cache()
    tp_step_checks()
    torch.cuda.empty_cache()
    dryrun_vs_card(mesh_summary)
    kv_launches = tp_replicated_kv()
    torch.cuda.empty_cache()
    churn_launches = churn()
    torch.cuda.empty_cache()
    gossip_launches = gossip()
    torch.cuda.empty_cache()
    sim_launches = sim_barrier()[0]
    torch.cuda.empty_cache()
    sim_async_launches = sim_bounded_stale()[0]
    torch.cuda.empty_cache()
    launches, serve_ref = serve()
    launches_bf16 = serve_bf16(serve_ref)[0]
    torch.cuda.empty_cache()
    launches_stablelm, serve_ref_stablelm = serve("stablelm-12b")
    launches_tp = {}
    for arch, data, model in SERVE_TP_LEGS:
        ref = serve_ref if arch == "opt-1.3b" else serve_ref_stablelm
        launches_tp[f"{arch} {data}x{model}"] = serve_tp(ref, arch, data,
                                                         model)
    del serve_ref_stablelm
    torch.cuda.empty_cache()
    paged_shards()
    launches_2d = serve_2d(serve_ref)
    del serve_ref
    torch.cuda.empty_cache()
    paged_vs_dense()
    paged_vs_dense("stablelm-12b")
    paged_vs_dense("qwen1.5-107b", n_layers=2)
    main_row = rows[0]                  # opt-1.3b, the served shape
    print(f"chip_smoke seconds: {time.monotonic() - t0:.1f}")
    print(smi)
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/serve/attention_paged.py:82",
        "launches": launches, "max_abs_err": worst,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "plan": main_row["plan"],
        "blocks": main_row["blocks"],
        "launches_serve_stablelm_12b": launches_stablelm,
        "launches_serve_tp": launches_tp,
        "launches_serve_2d": launches_2d,
        "cases": {row["case"]: {k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "plan", "blocks")} for row in rows}}]
    for row in comp_rows:
        row = dict(row)
        row.pop("wrapper")
        row["launches"] = einsum_run[0][row["name"]]
        # the pipeline-parallel trainer's (phase 4g) and driver's (4h)
        row["launches_pp_trainer"] = pp_train_launches[row["name"]]
        row["launches_pp_driver"] = pp_driver_launches[row["name"]]
        row["launches_tp_driver"] = tp_launches[row["name"]]
        row["launches_tp_kv_replicated"] = kv_launches[row["name"]]
        row["launches_churn_4m"] = churn_launches[row["name"]]
        row["launches_gossip_4n"] = gossip_launches[row["name"]]
        row["launches_sim_4o"] = sim_launches[row["name"]]
        row["launches_sim_async_4p"] = sim_async_launches[row["name"]]
        if row["name"].startswith("quant4_"):
            # the mesh round's batched launches (phase 3b) and phase 4d's,
            # and the same at stablelm-12b's leaves (phase 4e's)
            for key, q4, ml in (("mesh_round", mesh_q4, mesh_launches),
                                ("mesh_round_stablelm_12b", mesh_q4_stablelm,
                                 mesh_launches_stablelm)):
                mesh = q4[row["name"][len("quant4_"):]]
                row[key] = dict(
                    ms=mesh["ms"], one_row_at_a_time_ms=mesh["one_ms"],
                    bound_ms=mesh["bound_ms"], launches=ml[row["name"]])
        kernels.append(row)
    for name, row in flash_rows.items():
        kernels.append(dict(row, launches=flash_run[0][name],
                            launches_pp_trainer=pp_train_launches[name],
                            launches_tp_kv_replicated=kv_launches[name],
                            launches_churn_4m=churn_launches[name],
                            launches_sim_4o=sim_launches[name],
                            launches_sim_async_4p=sim_async_launches[name]))
    # the bf16 instantiations: launches of phase 4k's run (the wrappers
    # count both types; 4k trains in bf16 only)
    for name, row in flash_rows_bf16.items():
        kernels.append(dict(row, launches=bf16_run[0][name[:-len("_bf16")]]))
    main_bf16 = rows_bf16[0]
    kernels.append({
        "name": "paged_attention_bf16", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/serve/attention_paged.py:82",
        "launches": launches_bf16, "max_abs_err": worst_bf16,
        **{k: main_bf16[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "plan",
                                     "blocks")},
        "cases": {row["case"]: {k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "plan", "blocks")} for row in rows_bf16}})
    kernels.append(dict(mm_row, launches=mesh_launches["lowrank_mm"],
                        launches_tp_driver=tp_launches["lowrank_mm"],
                        launches_tp_kv_replicated=kv_launches["lowrank_mm"],
                        launches_by_path={
                            route: mesh_launches[f"lowrank_mm_{route}"]
                            for route in ("split", "rank", "general")},
                        stablelm_12b=dict(
                            {k: mm_row_stablelm[k] for k in (
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "max_abs_err")},
                            launches=mesh_launches_stablelm["lowrank_mm"])))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
