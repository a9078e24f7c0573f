"""Port parity for the mesh runtime: ``repro_torch.core.mesh_compression``
against ``repro.core.mesh_compression`` (jitted, as the JAX driver runs it;
the jnp route and, with ``REPRO_USE_PALLAS=1``, the Pallas kernels in
interpret mode), ``repro_torch.launch.steps`` against
``repro.launch.steps`` over three DiLoCoX rounds, and the driver
``repro_torch.launch.train`` across processes (gloo) against its own
in-process stacked run.

Tolerances (float32 both sides, other summation orders): the compressed
mean Delta and q_new rtol 1e-4 / atol 1e-6 and 1e-5 (ulps of the two
Cholesky-QRs); payload bytes and scales exact given JAX's factors; losses
rtol 1e-4. Round states are held to rtol 1e-4 / atol 1e-6 in at least
99.9 % of every leaf's elements (95 % where the outer step wrote them: a
flipped code moves a whole row or column), and every element to rtol
1e-4 plus two allowances that the arithmetic itself sets:
 - AdamW divides the first moment by the root of the second, so an
   element whose gradient is a sum at its f32 rounding floor moves by a
   different fraction of lr in the two packages: 0.05 lr per step taken;
 - a factor value within ulps of an int4 rounding boundary can land one
   code apart in the two packages; one code step in P and one in Q move
   a reconstructed element by at most 16 * max scale_P * max scale_Q of
   its matrix, and every state the outer step writes carries that.
The warm starts q_state are held per column to 1e-3 of the column's
norm: Q = M^T orth(M Q_warm) carries the Cholesky-QR's amplification of
the ulps between the two packages' P, up to the Gram matrix's condition
number (<= 1e6 with the relative ridge); the reduced configs' pseudo-
gradients reach 3e-4 in round 2.
Across processes the driver must equal the in-process run bit for bit
with one cluster per rank (the same arithmetic per cluster, the payload
moved as bytes), and match one process within the same round-state gate
when a cluster's batch is split over two data ranks, each holding its
FSDP blocks of the state (the gradient mean of two half batches sums in
another order)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten as jflatten
from repro.configs.base import get_config as jax_get_config
from repro.core import compression as JCmp
from repro.core import mesh_compression as JMC
from repro.data import synthetic as JS
from repro.kernels import ops as jops
from repro.launch import steps as JSteps
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core import diloco
from repro_torch.core import mesh_compression as MC
from repro_torch.kernels import quant4
from repro_torch.launch import steps as S
from repro_torch.launch import train as TR
from repro_torch.models import model as M
from repro_torch.parallel import sharding as sh

CPU = torch.device("cpu")
STATE_TOL = dict(rtol=1e-4, atol=1e-6)


def _tree(C=2):
    """The tree of tests/test_mesh_compression.py: (units, m, n) and a
    1-D leaf, two clusters (the second half the first)."""
    k = jax.random.PRNGKey(0)
    one = {"w": jax.random.normal(k, (3, 128, 96)) / 10,
           "b": jax.random.normal(jax.random.fold_in(k, 1), (96,))}
    return jax.tree.map(lambda x: jnp.stack([x, x * 0.5][:C]), one)


def _stacked_q(tree, cfg):
    q = JMC.init_q_state(jax.tree.map(lambda x: x[0], tree), cfg)
    C = jax.tree.leaves(tree)[0].shape[0]
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (C,) + x.shape).copy(),
                        q)


def _to_port(jtree):
    return T.tree_map(lambda x: torch.from_numpy(np.array(x)),
                      jax.tree.map(np.asarray, jtree))


def _assert_tree_close(got, want, **tol):
    g, w = ckpt._flatten(got), jflatten(want)
    assert list(g) == list(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


INNER_LR = 1e-3


# the warm start Q = M^T orth(M Q) carries the Cholesky-QR's amplification
# of the ulps between the two packages' P (up to the Gram matrix's condition
# number, <= 1e6 with the relative ridge): held per column to its norm
Q_COL_TOL = 1e-3
# one code flipped in P (Q) moves a row (column) of its matrix: 1/64 of a
# reduced config's (m, 64) or (64, n) matrix
INT4_TIGHT = 0.95


def _adam_atol(steps):
    return 0.05 * INNER_LR * steps


def _int4_steps(delta_pending, q_state, rank):
    """{leaf path: 16 * max scale_P * max scale_Q} over the leaf's
    matrices of the payload compressed from ``delta_pending`` (one scale
    for a quant-only leaf): the most one code step per factor moves an
    element of the reconstructed mean."""
    payloads, _ = MC.compress_local(delta_pending, q_state, rank,
                                    MC.MeshCompressionConfig(rank=rank))
    out = {}
    for (path, q), rows in zip(T.keystr_items(q_state), payloads):
        if q.numel() == 0:
            out[path] = max(float(row[1].max()) for row in rows)
            continue
        out[path] = max(16 * float(row[i + 1].max()) * float(row[i + 3].max())
                        for row in rows for i in range(0, len(row), 4))
    return out


def _assert_state_close(got, want, atol, where="", min_tight=0.999):
    """``got``/``want``: flat state dicts. Every element within rtol 1e-4
    plus ``atol(key)``, and a ``min_tight`` share of every leaf within
    STATE_TOL."""
    assert list(got) == list(want)
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        gap = np.abs(g - w)
        if "q_state" in k:
            col = np.sqrt((w * w).sum(axis=-2, keepdims=True))
            assert (gap <= Q_COL_TOL * col).all(), \
                f"{where} {k}: {float((gap / col).max()):.3e} of a column norm"
            continue
        bound = 1e-4 * np.abs(w) + atol(k)
        assert (gap <= bound).all(), \
            f"{where} {k}: gap {float(gap.max()):.3e}, " \
            f"{int((gap > bound).sum())} elements over rtol 1e-4 + " \
            f"{atol(k):.3e}"
        tight = gap <= STATE_TOL["atol"] + STATE_TOL["rtol"] * np.abs(w)
        assert tight.mean() >= min_tight if tight.size else True, \
            f"{where} {k}: {int((~tight).sum())} of {tight.size} elements " \
            f"outside rtol 1e-4 / atol 1e-6"


def _atol_for(adam, int4=None):
    """``atol(key)``: the AdamW allowance, plus the leaf's int4 step for
    every state the outer step writes (all but the inner optimizer)."""
    def atol(key):
        if int4 is None or key.startswith(("['opt']", ".m", ".v", ".step")):
            return adam
        return adam + max((s for p, s in int4.items() if key.endswith(p)),
                          default=0.0)
    return atol


@pytest.mark.parametrize("rank,pallas", [(16, False), (10, False),
                                         (16, True)])
def test_compress_gather_mean_matches_jax(rank, pallas, monkeypatch):
    """Rank 10 makes n * r = 960 no multiple of 256: each matrix's Q is
    padded on its own, as the vmapped reference pads it."""
    if pallas:
        monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    else:
        monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    cfg_j = JMC.MeshCompressionConfig(rank=rank, bits=4,
                                      min_dim_for_lowrank=64)
    cfg_t = MC.MeshCompressionConfig(rank=rank, bits=4,
                                     min_dim_for_lowrank=64)
    tree = _tree()
    q = _stacked_q(tree, cfg_j)
    rt = jnp.asarray(rank - 3, jnp.int32)
    Dj, qj = jax.jit(lambda d, qq, r: JMC.compress_gather_mean(
        d, qq, r, cfg_j))(tree, q, rt)
    Dt, qt = MC.compress_gather_mean(_to_port(tree), _to_port(q), rank - 3,
                                     cfg_t)
    _assert_tree_close(Dt, Dj, **STATE_TOL)
    _assert_tree_close(qt, qj, rtol=1e-5, atol=1e-5)
    assert not qt["w"][..., rank - 3:].any()          # masked columns


def test_payload_bytes_equal_given_jax_factors():
    """JAX's P and Q of every matrix pack to JAX's payload bytes and
    scales in the port, the port decompresses JAX's payload to JAX's
    Delta, and the bytes handed to the all-gather are the padded codes
    plus 4 bytes per scale, not ``wire_bytes_tree``'s accounting."""
    cfg_j = JMC.MeshCompressionConfig(rank=10, min_dim_for_lowrank=64)
    cfg_t = MC.MeshCompressionConfig(rank=10, min_dim_for_lowrank=64)
    tree = _tree()
    q = _stacked_q(tree, cfg_j)

    @jax.jit
    def factors(M_, qp):
        P = jops.matmul(M_, qp)
        P = JCmp._orthonormalize(P)
        Q = jops.matmul(M_.T, P)
        payload, _ = JMC._compress_leaf_matrix(M_, qp, None, cfg_j)
        return P, Q, payload

    rows = []
    for c in range(2):
        row = []
        for i in range(3):
            P, Q, pay = factors(tree["w"][c, i], q["w"][c, i])
            pP, sP = quant4.quant4_pack(torch.from_numpy(np.array(P))
                                        .reshape(-1))
            pQ, sQ = quant4.quant4_pack(torch.from_numpy(np.array(Q))
                                        .reshape(-1))
            for got, want in zip((pP, sP, pQ, sQ), pay):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            row += [pP, sP, pQ, sQ]
        rows.append(row)
    Dj, _ = jax.jit(lambda d, qq: JMC.compress_gather_mean(
        d, qq, None, cfg_j))(tree, q)
    Dw = MC.decompress_mean_leaf(rows, (3, 128, 96), 10, cfg_t)
    np.testing.assert_allclose(Dw.numpy(), np.asarray(Dj["w"]), rtol=1e-6,
                               atol=1e-7)

    payloads, _ = MC.compress_local(_to_port(tree), _to_port(q), None, cfg_t)
    blocks = 2 * (3 * (math.ceil(128 * 10 / 256) + math.ceil(96 * 10 / 256))
                  + math.ceil(96 / 256))
    packed = 2 * (3 * 128 * (math.ceil(128 * 10 / 256)
                             + math.ceil(96 * 10 / 256))
                  + 128 * math.ceil(96 / 256))
    assert MC.gather_bytes(payloads) == packed + 4 * blocks
    # the accounting counts unpadded codes and 2-byte scales
    one = jax.tree.map(lambda x: x[0], tree)
    accounted = (3 * (128 * 10 // 2 + 96 * 10 // 2) + 96 // 2
                 + 2 * blocks // 2)
    assert JMC.wire_bytes_tree(one, cfg_j) == accounted
    assert MC.wire_bytes_tree(_to_port(one), cfg_t) == accounted


def test_zero_input_keeps_warm_start_per_matrix():
    """The guard is per matrix: a zero matrix keeps its (masked) warm
    start while its neighbour in the same leaf takes the new Q."""
    cfg = MC.MeshCompressionConfig(rank=8, min_dim_for_lowrank=8)
    g = torch.Generator().manual_seed(0)
    d = torch.randn((1, 2, 32, 24), generator=g)
    d[0, 1] = 0
    q = MC.init_q_state({"w": d[0]}, cfg)["w"][None]
    _, q_new = MC.compress_gather_mean({"w": d}, {"w": q}, 5, cfg)
    cm = (torch.arange(8) < 5).float()
    assert torch.equal(q_new["w"][0, 1], q[0, 1] * cm)
    assert not torch.equal(q_new["w"][0, 0], q[0, 0] * cm)


def test_payload_wire_equals_a_per_matrix_pack():
    """The batched packs change no byte on the wire: ``compress_local``'s
    payload equals a loop in this test that packs each matrix's P and Q
    and each cluster's quant-only row on its own (the packing before the
    batched entry points), tensor for tensor, in the same
    ``_wire_order``, with the same ``gather_bytes`` and concatenated
    bytes; and the mean decompressed from it equals the mean from the
    loop's rows."""
    from repro_torch.core.compression import _orthonormalize
    from repro_torch.kernels import lowrank_mm
    from repro_torch.kernels.ref import col_mask

    cfg = MC.MeshCompressionConfig(rank=10, min_dim_for_lowrank=64)
    tree, q = _tree(), _stacked_q(_tree(), JMC.MeshCompressionConfig(
        rank=10, min_dim_for_lowrank=64))
    d_t, q_t = _to_port(tree), _to_port(q)
    payloads, _ = MC.compress_local(d_t, q_t, 7, cfg)
    loop = []
    for d, qq in zip(T.leaves(d_t), T.leaves(q_t)):
        C = d.shape[0]
        if qq.numel() == 0:
            loop.append([list(quant4.quant4_pack(d[c].reshape(-1)))
                         for c in range(C)])
            continue
        lead, m, n = MC._leaf_matrix_dims(tuple(d.shape[1:]))
        dm, qm = d.reshape(C * lead, m, n), qq.reshape(C * lead, n, -1)
        cm = col_mask(qm.shape[-1], 7, dm.device)
        P = lowrank_mm.matmul(dm, qm * cm)
        for i in range(C * lead):
            P[i] = _orthonormalize(P[i]) * cm
        Q = lowrank_mm.matmul(dm.transpose(1, 2), P)
        rows = []
        for c in range(C):
            row = []
            for i in range(c * lead, (c + 1) * lead):
                row += [*quant4.quant4_pack(P[i].reshape(-1)),
                        *quant4.quant4_pack(Q[i].reshape(-1))]
            rows.append(row)
        loop.append(rows)
    got, want = MC._wire_order(payloads), MC._wire_order(loop)
    assert [w[:3] for w in got] == [w[:3] for w in want]
    for (*_, a), (*_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert MC.gather_bytes(payloads) == MC.gather_bytes(loop)
    wire = [torch.cat([t.reshape(-1).view(torch.uint8) for *_, t in o])
            for o in (got, want)]
    assert torch.equal(*wire)
    for rows_b, rows_l, d in zip(payloads, loop, T.leaves(d_t)):
        r = 0 if len(rows_b[0]) == 2 else 10
        assert torch.equal(MC.decompress_mean_leaf(rows_b, d.shape[1:], r,
                                                   cfg),
                           MC.decompress_mean_leaf(rows_l, d.shape[1:], r,
                                                   cfg))


# ---------------------------------------------------------------------------
# three rounds of make_train_step + make_outer_step against JAX
# ---------------------------------------------------------------------------

NC, H, ROUNDS = 2, 2, 3


def _jax_round_state(jcfg, ccfg):
    p1 = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (NC,) + x.shape)
                          .copy(), p1)
    return params, jax.vmap(jadamw.init)(params), \
        JSteps.init_outer_state(p1, NC, ccfg)


@pytest.mark.parametrize("arch", ["granite-3-8b", "opt-1.3b"])
def test_rounds_match_jax_steps(arch):
    """Each round starts both packages from JAX's state (carried into the
    port by the state bridge) on JAX-drawn tokens: per-step losses, the
    params after the H inner steps, then the outer step from JAX's
    post-H params, and the whole state after the round must track JAX's.
    Round 0 applies the delayed Delta = 0: the anchor stays as it was."""
    jcfg = jax_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jc = JMC.MeshCompressionConfig(rank=16)
    tc = MC.MeshCompressionConfig(rank=16)
    j_train = jax.jit(JSteps.make_train_step(jcfg, inner_lr=INNER_LR))
    j_outer = jax.jit(JSteps.make_outer_step(jcfg, jc, outer_lr=0.5,
                                             outer_momentum=0.7))
    t_train = S.make_train_step(tcfg, inner_lr=INNER_LR)
    t_outer = S.make_outer_step(tcfg, tc, outer_lr=0.5, outer_momentum=0.7)
    jp, jopt, jst = _jax_round_state(jcfg, jc)
    like1 = M.init_params(tcfg, torch.Generator(), CPU)
    like = diloco.stack_replicas(like1, NC)
    data = [JS.SyntheticLM(jcfg.vocab_size, 16, 2, seed=0, data_shard=c)
            for c in range(NC)]
    for r in range(ROUNDS):
        tp = ckpt.tree_from_flat(jflatten(jp), like)
        topt = ckpt.state_from_flat(jflatten(jopt), S.init_inner_state(like))
        tst = ckpt.state_from_flat(jflatten(jst), S.init_outer_state(
            T.tree_map(torch.clone, like1), NC, tc))
        anchor0 = jflatten(jst.anchor)
        for h in range(H):
            toks = np.stack([np.asarray(d.next_batch()["tokens"])
                             for d in data])
            jp, jopt, jl = j_train(jp, jopt, {"tokens": jnp.asarray(toks)})
            tp, topt, tl = t_train(tp, topt,
                                   {"tokens": torch.from_numpy(toks)})
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4,
                                       err_msg=f"round {r} step {h}")
        _assert_state_close(ckpt._flatten(tp), jflatten(jp),
                            _atol_for(_adam_atol(H)), f"round {r} inner")
        tp = ckpt.tree_from_flat(jflatten(jp), like)
        int4 = _int4_steps(tst.delta_pending, tst.q_state, 16)
        jp, jst = j_outer(jp, jst, jnp.asarray(16, jnp.int32))
        tp, tst = t_outer(tp, tst, 16)
        _assert_state_close(ckpt._flatten({"params": tp, "outer": tst}),
                            jflatten({"params": jp, "outer": jst}),
                            _atol_for(0.0, int4), f"round {r} outer",
                            min_tight=INT4_TIGHT)
        if r == 0:
            for k, v in ckpt._flatten(tst.anchor).items():
                np.testing.assert_array_equal(v, anchor0[k], err_msg=k)


def test_outer_state_bridge_roundtrip_byte_equal():
    jcfg = jax_get_config("opt-1.3b").reduced()
    tcfg = get_config("opt-1.3b").reduced()
    jc = JMC.MeshCompressionConfig(rank=16)
    _, _, jst = _jax_round_state(jcfg, jc)
    flat = jflatten(jst)
    like = S.init_outer_state(M.init_params(tcfg, torch.Generator(), CPU),
                              NC, MC.MeshCompressionConfig(rank=16))
    back = ckpt.state_to_flat(ckpt.state_from_flat(flat, like))
    assert list(back) == list(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


# ---------------------------------------------------------------------------
# the driver across processes (gloo) against its in-process stacked run
# ---------------------------------------------------------------------------

DRIVER = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
          "--model", "1", "--rounds", "2", "--h-steps", "2",
          "--global-batch", "4", "--seq-len", "16", "--cpu-threads", "1",
          "--join-timeout", "180"]


def _rank_state(path, rank):
    with np.load(f"{path}.rank{rank}.npz") as z:
        return {k: z[k] for k in z.files}


def _in_process(argv, clusters):
    """The driver's round loop with every cluster in this process (no
    process group), one thread, as the ranks run; states after each
    round as flat arrays."""
    states = []

    def on_round(r, params, opt, outer):     # copies: the state is in place
        states.append({k: v.copy() for k, v in ckpt._flatten(
            {"params": params, "opt": opt, "outer": outer._asdict()}).items()})

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        TR.run(TR._parse_args(argv), CPU, clusters=clusters,
               on_round=on_round)
    finally:
        torch.set_num_threads(threads)
    return states


def test_driver_two_processes_equal_in_process_bitwise(tmp_path, capfd):
    out = tmp_path / "state"
    argv = DRIVER + ["--devices", "2", "--clusters", "2", "--data", "1"]
    summary = TR.main(argv + ["--state-out", str(out)],
                      store_dir=str(tmp_path))
    printed = capfd.readouterr().out
    assert "round 1: mean_loss=" in printed and \
        printed.rstrip().endswith("TRAIN-DRIVER-OK")
    want = _in_process(argv, [0, 1])
    assert len(want) == 2 and len(summary["gather_bytes"]) == 2
    for r, ref_flat in enumerate(want):
        ranks = [_rank_state(out / f"round_{r:04d}", k) for k in range(2)]
        for key, arr in ref_flat.items():
            unstacked = key.startswith(("['outer']['anchor']",
                                        "['outer']['outer_opt']"))
            got = ranks[0][key] if unstacked else np.concatenate(
                [ranks[0][key], ranks[1][key]])
            if unstacked:
                np.testing.assert_array_equal(ranks[1][key], got, err_msg=key)
            np.testing.assert_array_equal(got, arr, err_msg=f"{r} {key}")


def test_driver_data_ranks_match_one_process(tmp_path):
    argv = DRIVER + ["--clusters", "1"]
    TR.main(argv + ["--devices", "2", "--data", "2", "--state-out",
                    str(tmp_path / "two")], store_dir=str(tmp_path))
    TR.main(argv + ["--devices", "1", "--data", "1", "--state-out",
                    str(tmp_path / "one")], store_dir=str(tmp_path))
    tcfg = get_config("granite-3-8b").reduced()
    like = S.init_outer_state(M.init_params(tcfg, torch.Generator(), CPU), 1,
                              MC.MeshCompressionConfig(rank=16))
    # each data rank holds its FSDP blocks (parallel/sharding.py) of the
    # param-shaped leaves: held against the same blocks of one process
    mesh = {"data": 2, "model": 1}
    specs = sh.param_placements(M.init_params(tcfg, device="meta"), mesh,
                                cluster_stacked=False)
    trees = ("['params']", "['opt'].m", "['opt'].v", "['outer']['anchor']",
             "['outer']['outer_opt'].momentum", "['outer']['delta_pending']",
             "['outer']['error']")

    def blocks(flat, k):
        out = {}
        for key, arr in flat.items():
            pre = [t for t in trees if key.startswith(t)]
            if pre:
                lead = (() if key.startswith(trees[3:5]) else (None,))
                arr = arr[sh.block_slices(arr.shape, lead + specs[
                    key[len(pre[0]):]], mesh, {"data": k, "model": 0})]
            out[key] = arr
        return out

    int4 = None
    for r in range(2):
        one = _rank_state(tmp_path / "one" / f"round_{r:04d}", 0)
        atol = _atol_for(_adam_atol(2 * (r + 1)), int4)
        for k in range(2):
            two = _rank_state(tmp_path / "two" / f"round_{r:04d}", k)
            _assert_state_close(two, blocks(one, k), atol,
                                f"round {r} rank {k}",
                                min_tight=0.999 if int4 is None
                                else INT4_TIGHT)
        # the next outer step compresses this round's pending deltas
        prev = ckpt.state_from_flat(
            {k[len("['outer']"):]: v for k, v in one.items()
             if k.startswith("['outer']")}, like._asdict())
        int4 = _int4_steps(prev["delta_pending"], prev["q_state"], 16)


def test_driver_refusals_and_checkpoint_format(tmp_path, capfd):
    base = DRIVER + ["--data", "1"]
    # --inner pp keeps JAX's refusal
    with pytest.raises(SystemExit, match="static round schedule"):
        TR.main(base + ["--devices", "2", "--clusters", "2", "--inner",
                        "pp", "--pp-stages", "1", "--adaptive"])
    with pytest.raises(AssertionError):
        TR.main(base + ["--devices", "3", "--clusters", "2"])
    jcfg = jax_get_config("granite-3-8b").reduced()
    p1 = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    p1 = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), p1)

    def want(C):
        stacked = jax.tree.map(lambda x: jnp.stack([x] * C), p1)
        return jflatten({"params": stacked, "outer": JSteps.init_outer_state(
            p1, C, JMC.MeshCompressionConfig(rank=16))._asdict()})

    def check(ck, C):
        with np.load(ck / "round_0000.npz") as z:
            w = want(C)
            assert sorted(z.files) == sorted(w)
            for k in w:
                assert z[k].shape == w[k].shape, k

    one = ["--rounds", "1", "--h-steps", "1"]
    # one device: the JAX driver's checkpoint keys, cluster-stacked params
    TR.main(base + one + ["--devices", "1", "--clusters", "1", "--ckpt-dir",
                          str(tmp_path / "ck")], store_dir=str(tmp_path))
    check(tmp_path / "ck", 1)
    # the former refusals run: --ckpt-dir across ranks writes the same
    # layout with every cluster's rows, --model > 1 trains, and --inner pp
    # across ranks writes its {"params"} tree
    TR.main(base + one + ["--devices", "2", "--clusters", "2", "--ckpt-dir",
                          str(tmp_path / "ck2")], store_dir=str(tmp_path))
    check(tmp_path / "ck2", 2)
    TR.main(base + one + ["--devices", "2", "--clusters", "1", "--model",
                          "2"], store_dir=str(tmp_path))
    assert capfd.readouterr().out.rstrip().endswith("TRAIN-DRIVER-OK")
    TR.main(base + one + ["--devices", "2", "--clusters", "2", "--inner",
                          "pp", "--pp-stages", "1", "--pp-micro", "1",
                          "--ckpt-dir", str(tmp_path / "pp")],
            store_dir=str(tmp_path))
    with np.load(tmp_path / "pp" / "round_0000.npz") as z:
        assert "['params']['stages']['attn']['wq']" in z.files
        assert z["['params']['embed']"].shape[0] == 2
