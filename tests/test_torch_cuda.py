"""The CUDA kernels of the port against their plain PyTorch versions, on
the card. Every test here carries the ``cuda`` marker and skips itself
where there is no GPU (the kernels have no CPU mode); imports no jax, so
it runs on a GPU machine without the JAX package:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from _paged_fixture import paged_case, paged_fixture, to_torch
from repro_torch.serve import attention_paged as ap

TOL = dict(rtol=1e-3, atol=1e-5)        # the JAX package's gate, test_kernels.py


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("S,P,ps,KV,G,dh", [(3, 4, 4, 2, 2, 8),
                                            (2, 3, 8, 1, 4, 16),
                                            (4, 12, 16, 32, 1, 64),
                                            (3, 8, 16, 1, 4, 256),
                                            # stablelm-12b's head dim: 40
                                            # quads over 16 and 32 lanes
                                            (3, 4, 2, 2, 4, 160),
                                            (2, 1, 4, 2, 4, 160),
                                            # qwen1.5-107b's G
                                            (2, 3, 8, 8, 8, 128)])
def test_cuda_paged_attention_matches_plain(window, S, P, ps, KV, G, dh):
    _need_cuda()
    case = to_torch(*paged_fixture(0, S=S, P=P, ps=ps, KV=KV, G=G, dh=dh),
                    device="cuda")
    before = ap.cuda_paged_attention.launches
    got = ap.paged_attention(*case, window=window)
    want = ap.ref_paged_attention(*case, window=window)
    torch.cuda.synchronize()
    assert ap.cuda_paged_attention.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_cuda_paged_attention_refuses_outside_envelope():
    _need_cuda()
    q, cache, table, lengths = to_torch(*paged_fixture(
        0, S=2, P=3, ps=4, KV=2, G=2, dh=8), device="cuda")
    with pytest.raises(TypeError):
        ap.paged_attention(q.double(), cache, table, lengths)
    with pytest.raises(TypeError):
        ap.paged_attention(q, cache, table.cpu(), lengths)


def _chunk_edge_case(dh, G, KV=2, ps=16, seed=0):
    """Three and a bit chunks of the plan; lengths on chunk edges, on page
    edges and at the last position; two inactive slots."""
    from repro_torch.kernels import _plan

    pages = _plan.paged_plan(64, ps, dh)[0]
    P = 3 * pages + 1
    C = pages * ps
    lengths = [0, C - 1, C, C + 1, 2 * C - 1, 2 * C + ps, P * ps - 1, 0]
    return C, to_torch(*paged_case(seed, lengths, P=P, ps=ps, KV=KV, G=G,
                                   dh=dh, inactive=(0, 7)), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("dh", [32, 64, 128, 160, 256])
def test_cuda_paged_chunks_match_plain_and_are_batch_free(dh, G):
    """Page chunks and their merge at each head dim: within the gate with
    no window, a window of 5 and one that straddles a chunk edge; one
    launch a call; two calls bitwise equal; each slot alone, and slot 3
    among other slots, bitwise equal to its row of the batch."""
    _need_cuda()
    C, (q, cache, table, lengths) = _chunk_edge_case(dh, G)
    for window in (0, 5, C + C // 2 + 1):
        before = ap.cuda_paged_attention.launches
        got = ap.paged_attention(q, cache, table, lengths, window=window)
        again = ap.paged_attention(q, cache, table, lengths, window=window)
        want = ap.ref_paged_attention(q, cache, table, lengths, window=window)
        torch.cuda.synchronize()
        assert ap.cuda_paged_attention.launches == before + 2
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL)
        assert torch.equal(got, again)
        for s in range(q.shape[0]):
            alone = ap.paged_attention(
                q[s:s + 1].contiguous(), cache, table[s:s + 1].contiguous(),
                lengths[s:s + 1].contiguous(), window=window)
            assert torch.equal(alone[0], got[s]), s
        q2, table2, lengths2 = q.flip(0).contiguous(), table.flip(0), \
            lengths.flip(0)
        q2[3], table2[3], lengths2[3] = q[3], table[3], lengths[3]
        lengths2[0] = 0
        table2[0] = 0
        other = ap.paged_attention(q2, cache, table2.contiguous(),
                                   lengths2.contiguous(), window=window)
        assert torch.equal(other[3], got[3])


@pytest.mark.cuda
def test_cuda_paged_attention_refuses_what_the_kernels_cannot_read():
    _need_cuda()
    q, cache, table, lengths = to_torch(*paged_fixture(
        0, S=2, P=3, ps=4, KV=2, G=2, dh=8), device="cuda")
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError):                    # not 16-byte aligned
        ap.paged_attention(shifted, cache, table, lengths)
    odd = {"k": cache["k"][..., :6].contiguous(),
           "v": cache["v"][..., :6].contiguous()}
    with pytest.raises(ValueError):                    # dh % 4 != 0
        ap.paged_attention(q[..., :6].contiguous(), odd, table, lengths)
    with pytest.raises(ValueError):                    # window < 0
        ap.paged_attention(q, cache, table, lengths, window=-1)


# ---------------------------------------------------------------------------
# the compressor's kernels: quant4 (B.1, B.2) and fused_compress (B.3-B.5)
# ---------------------------------------------------------------------------

from _fused_contract import (assert_fused_contract, fused_inputs,  # noqa: E402
                             load_chip_smoke, one_int4_step, quant_inputs)
from repro_torch.kernels import fused_compress as fc  # noqa: E402
from repro_torch.kernels import quant4 as q4  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


@pytest.fixture
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 1000, 1024, 256 * 37, 5000, 98304])
def test_cuda_quant4_matches_plain(n):
    """Bytes and scales bit-identical to the plain pack; unpack exact."""
    _need_cuda()
    x = torch.from_numpy(quant_inputs(n, seed=n))
    before = (q4.cuda_quant4_pack.launches, q4.cuda_quant4_unpack.launches)
    p, s = q4.quant4_pack(x.cuda())
    out = q4.quant4_unpack(p, s, n)
    torch.cuda.synchronize()
    assert (q4.cuda_quant4_pack.launches,
            q4.cuda_quant4_unpack.launches) == (before[0] + 1, before[1] + 1)
    p_ref, s_ref, _ = ref.quant4_pack_ref(x)
    np.testing.assert_array_equal(p.cpu().numpy(), p_ref.numpy())
    np.testing.assert_array_equal(s.cpu().numpy(), s_ref.numpy())
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  ref.quant4_unpack_ref(p_ref, s_ref,
                                                        n).numpy())


def _q4_rows(B, n, layout, seed):
    """(B, n) f32 rows on the card with ties (x.5 steps at scale 1) in row
    0 and a zero row 1: contiguous, starting 4 bytes off a 16-byte
    boundary, or at a row stride of n + 3."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, n)).astype(np.float32))
    x[0, :min(n, 8)] = torch.tensor([7.0, 2.5, -2.5, 0.5, -0.5, 1.5, -1.5,
                                     3.5])[:min(n, 8)]
    if B > 1:
        x[1] = 0
    if layout == "rows":
        return x.cuda()
    if layout == "odd start":
        buf = torch.zeros(B * n + 1, device="cuda")
        buf[1:] = x.reshape(-1).cuda()
        return buf[1:].view(B, n)
    buf = torch.zeros((B, n + 3), device="cuda")
    buf[:, :n] = x.cuda()
    return buf[:, :n]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "odd start", "stride n + 3"])
@pytest.mark.parametrize("B,n,block", [(1, 1000, 256), (3, 255, 256),
                                       (24, 8192, 256), (24, 5000, 256),
                                       (3, 1000, 100), (3, 1500, 512)])
def test_cuda_quant4_batched_matches_plain_per_row(B, n, block, layout):
    """The batched kernels byte for byte the plain version row by row at
    aligned, ragged (n % block != 0) and misaligned rows, at blocks that
    are no multiple of 8 and wider than a warp's 256 values; one launch
    each; two calls bitwise equal; the unpack into a strided output and
    from a gathered wire layout (two ranks' buffers read as 2 groups of B
    rows, rows off any word boundary) bitwise the unpack of the pack's
    rows."""
    _need_cuda()
    x = _q4_rows(B, n, layout, seed=B * n + block)
    before = (q4.cuda_quant4_pack.launches, q4.cuda_quant4_unpack.launches)
    p, s = q4.quant4_pack_batched(x, block)
    out = q4.quant4_unpack_batched(p, s, n, block)
    torch.cuda.synchronize()
    assert (q4.cuda_quant4_pack.launches,
            q4.cuda_quant4_unpack.launches) == (before[0] + 1, before[1] + 1)
    p_ref, s_ref = q4.pack_batched_plain(x.cpu(), block)
    assert torch.equal(p.cpu(), p_ref) and torch.equal(s.cpu(), s_ref)
    want = q4.unpack_batched_plain(p_ref, s_ref, n, block)
    assert torch.equal(out.cpu(), want)
    for a, b in zip((p, s), q4.quant4_pack_batched(x, block)):
        assert torch.equal(a, b)
    strided = torch.full((B, n + 5), 9.0, device="cuda")
    q4.quant4_unpack_batched(p, s, n, block, out=strided[:, 1:n + 1])
    assert torch.equal(strided[:, 1:n + 1].cpu(), want)
    assert (strided[:, 0] == 9).all() and (strided[:, n + 1:] == 9).all()
    cs = load_chip_smoke()
    pw, sw = cs._wire_rows(p, 101, 37), cs._wire_rows(s, 3, 5)
    if B > 1:     # grouped: R = B rows a rank, not one stride over 2B
        assert cs._wire_groups(pw, torch.uint8, p.shape[1])[0] == B
        assert cs._wire_groups(sw, torch.float32, s.shape[1])[0] == B
    got = q4.quant4_unpack_batched(pw, sw, n, block)
    assert torch.equal(got.cpu(), want.repeat(2, 1))


@pytest.mark.cuda
def test_cuda_quant4_row_bits_do_not_depend_on_the_batch():
    """A row's codes and values at B = 1 equal the same row's inside a
    batch of 24, and the single-row entry points launch the same kernel
    once."""
    _need_cuda()
    x = _q4_rows(24, 3000, "rows", seed=7)
    p, s = q4.quant4_pack_batched(x)
    out = q4.quant4_unpack_batched(p, s, 3000)
    before = (q4.cuda_quant4_pack.launches, q4.cuda_quant4_unpack.launches)
    for i in (0, 1, 13, 23):
        p1, s1 = q4.quant4_pack(x[i].contiguous())
        assert torch.equal(p1, p[i]) and torch.equal(s1, s[i])
        assert torch.equal(q4.quant4_unpack(p1, s1, 3000), out[i])
        p1, s1 = q4.quant4_pack_batched(x[i:i + 1])
        assert torch.equal(p1[0], p[i]) and torch.equal(s1[0], s[i])
    assert (q4.cuda_quant4_pack.launches,
            q4.cuda_quant4_unpack.launches) == (before[0] + 8, before[1] + 4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r", [(257, 129, 8), (300, 200, 64)])
def test_cuda_t_pack_codes_equal_the_quant4_kernels(no_tf32, m, n, r):
    """fused_compress's t_pack writes the codes and scales the quant4
    kernels give its own Q (the shared rule of quant4_codes.cuh)."""
    _need_cuda()
    from repro_torch.core.compression import _orthonormalize

    d, _, q = (torch.from_numpy(a).cuda() for a in fused_inputs(m, n, r))
    P = _orthonormalize(fc.cuda_project(d, None, q)).contiguous()
    Q, pq, sq = fc.cuda_project_t_pack(d, None, P)
    p, s = q4.quant4_pack_batched(Q.reshape(1, -1))
    assert torch.equal(pq, p[0]) and torch.equal(sq, s[0])


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r,rt", [(64, 48, 8, None), (257, 129, 8, 5),
                                      (128, 128, 64, 32), (33, 500, 12, 7),
                                      (300, 200, 16, None),
                                      (2048, 512, 64, 48), (96, 70, 7, None)])
def test_cuda_fused_compress_contract(no_tf32, m, n, r, rt):
    """The full contract of test_kernels.py on the kernels' outputs, and
    chain-vs-chain against the plain pipeline on the CPU."""
    _need_cuda()
    d, e, q = (torch.from_numpy(a) for a in fused_inputs(m, n, r))
    before = [fc.cuda_project.launches, fc.cuda_project_t_pack.launches,
              fc.cuda_reconstruct.launches, q4.cuda_quant4_pack.launches]
    hat, e_new, q_new, pay = fc.fused_compress_ef(
        d.cuda(), e.cuda(), q.cuda(), rt)
    torch.cuda.synchronize()
    assert [fc.cuda_project.launches, fc.cuda_project_t_pack.launches,
            fc.cuda_reconstruct.launches,
            q4.cuda_quant4_pack.launches] == [b + 1 for b in before]
    assert_fused_contract(m, n, r, rt, d, e, hat, e_new, q_new, pay,
                          fc.fused_decompress)
    hat_p, _, qn_p, pay_p = fc.fused_compress_ef(d, e, q, rt)
    np.testing.assert_allclose(hat.cpu().numpy(), hat_p.numpy(), rtol=0,
                               atol=one_int4_step(pay_p))
    np.testing.assert_allclose(q_new.cpu().numpy(), qn_p.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r", [(257, 129, 8), (300, 200, 64)])
def test_cuda_fused_kernels_with_e_match_plain(no_tf32, m, n, r):
    """The kernels' fused EF form (e as a second operand, added on the
    tile) against the plain versions on the same inputs; the driver hoists
    the add, so only this test and chip_smoke.py launch it."""
    _need_cuda()
    from repro_torch.core.compression import _orthonormalize

    d, e, q = (torch.from_numpy(a).cuda() for a in fused_inputs(m, n, r))
    P = fc.cuda_project(d, e, q)
    np.testing.assert_allclose(P.cpu().numpy(),
                               fc.project_plain(d, e, q).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    P = _orthonormalize(P).contiguous()
    Q, pq, sq = fc.cuda_project_t_pack(d, e, P)
    Q_plain = fc.project_t_pack_plain(d, e, P)[0]
    np.testing.assert_allclose(Q.cpu().numpy(), Q_plain.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    p_ref, s_ref, _ = ref.quant4_pack_ref(Q.cpu().reshape(-1))
    np.testing.assert_array_equal(pq.cpu().numpy(), p_ref.numpy())
    np.testing.assert_array_equal(sq.cpu().numpy(), s_ref.numpy())
    pp, sp = q4.cuda_quant4_pack(P.reshape(-1))
    hat, e_new = fc.cuda_reconstruct(pp, sp, pq, sq, d, e, m, n, r)
    hat_p, e_new_p = fc.reconstruct_plain(pp, sp, pq, sq, d, e, m, n, r)
    torch.cuda.synchronize()
    np.testing.assert_allclose(hat.cpu().numpy(), hat_p.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(e_new.cpu().numpy(), e_new_p.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r,rt", [
    (128, 20004, 16, None),       # project S > 1, K % 16 = 4, float4 tiles
    (128, 20003, 64, 40),         # project S > 1, odd n: scalar tiles
    (20003, 96, 16, 12),          # t_pack S > 1, K % 16 = 3
    (20003, 97, 64, None),        # t_pack S > 1, odd n: scalar tiles
    (2048, 50272, 64, None)])     # the head leaf: project S > 1
def test_cuda_split_k_projections_match_plain(no_tf32, m, n, r, rt):
    """The split-K projections where K is no multiple of the chunk or of
    the K step: P and Q within chip_smoke.py's product gate of their plain
    versions, the packed Q bit-identical to quant4_pack_ref of the
    kernel's own Q, masked columns exactly 0, one count per call, and two
    calls bit for bit equal (a fixed split order, no atomics)."""
    _need_cuda()
    gate = load_chip_smoke()._gate_product
    rng = np.random.default_rng(m + n + r)
    d = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)
                         * 0.3).cuda()
    qm = torch.from_numpy(rng.standard_normal((n, r)).astype(np.float32))
    if rt is not None:
        qm[:, rt:] = 0
    qm = qm.cuda()
    (_, s3, c3), (_, s4, c4) = fc._proj_plan(m, n), fc._proj_t_plan(m, n)
    assert max(s3, s4) > 1 and (n % c3 or m % c4)
    before = (fc.cuda_project.launches, fc.cuda_project_t_pack.launches)
    P = fc.project(d, None, qm)
    gate("project", P, fc.project_plain(d, None, qm), d, qm)
    P = torch.linalg.qr(P)[0].contiguous()
    if rt is not None:
        P[:, rt:] = 0
    Q, pq, sq = fc.project_t_pack(d, None, P)
    gate("project_t_pack", Q, fc.project_t_pack_plain(d, None, P)[0], d.T, P)
    assert (fc.cuda_project.launches,
            fc.cuda_project_t_pack.launches) == (before[0] + 1, before[1] + 1)
    p_ref, s_ref, _ = ref.quant4_pack_ref(Q.cpu().reshape(-1))
    np.testing.assert_array_equal(pq.cpu().numpy(), p_ref.numpy())
    np.testing.assert_allclose(sq.cpu().numpy(), s_ref.numpy(), rtol=1e-6)
    if rt is not None:
        assert not Q[:, rt:].any()
    P3 = fc.cuda_project(d, None, qm)
    assert torch.equal(P3, fc.cuda_project(d, None, qm))
    for a, b in zip((Q, pq, sq), fc.cuda_project_t_pack(d, None, P)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_fused_compress_zero_input_keeps_warm_start(no_tf32):
    """Round 0 of the delay mode compresses an all-zero delta: the output
    is exactly 0 and the warm start survives."""
    _need_cuda()
    q = torch.randn(96, 16, device="cuda")
    hat, _, q_new, _ = fc.fused_compress_ef(
        torch.zeros(80, 96, device="cuda"), None, q, compute_error=False)
    assert not hat.any()
    assert torch.equal(q_new, q)


@pytest.mark.cuda
def test_cuda_kernels_refuse_outside_envelope():
    _need_cuda()
    d = torch.randn(64, 64, device="cuda")
    with pytest.raises(ValueError):
        fc.project(d, None, torch.randn(64, 65, device="cuda"))
    with pytest.raises(TypeError):
        fc.project(d.double(), None, torch.randn(64, 8, device="cuda"))
    with pytest.raises(TypeError):
        q4.quant4_pack(torch.randn(4, 4, device="cuda"))


# ---------------------------------------------------------------------------
# flash attention (B.6): the forward kernel and the backward kernels
# ---------------------------------------------------------------------------

from repro_torch.kernels import _plan  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def _flash_inputs(B, Sq, H, KV, d, Sk, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(B, Sq, H, d), (B, Sk, KV, d), (B, Sk, KV, d), (B, Sq, H, d)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .cuda() for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,causal", [
    (2, 128, 128, 4, 2, 32, True), (1, 200, 200, 4, 1, 64, True),
    (1, 384, 384, 8, 2, 128, True), (1, 256, 256, 4, 1, 256, True),
    (2, 128, 128, 4, 4, 64, False), (1, 96, 160, 4, 2, 64, True),
    (1, 160, 96, 4, 2, 32, True)])
def test_cuda_flash_attention_matches_plain(no_tf32, B, Sq, Sk, H, KV, d,
                                            causal):
    """Forward (o, lse) and backward (dq, dk, dv) kernels against their
    plain versions on the same inputs; the backward is fed the plain
    forward's o and lse, so it is judged on its own, and two calls of it
    are bitwise equal (no atomics)."""
    _need_cuda()
    q, k, v, do = _flash_inputs(B, Sq, H, KV, d, Sk)
    before = (fa.cuda_flash_attention_fwd.launches,
              fa.cuda_flash_attention_bwd.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, causal)
    np.testing.assert_allclose(o.cpu().numpy(), o_p.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    got = fa.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
    again = fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o_p, lse_p, do, causal)
    torch.cuda.synchronize()
    assert (fa.cuda_flash_attention_fwd.launches,
            fa.cuda_flash_attention_bwd.launches) == (before[0] + 1,
                                                      before[1] + 2)
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), f"d{name} not bitwise reproducible"
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=f"d{name}")


@pytest.mark.cuda
def test_cuda_flash_attention_function_and_strided_inputs(no_tf32):
    """Through autograd, with q, k, v as strided views of one (B,S,3,H,d)
    buffer (no copies): the kernels read them through their strides."""
    _need_cuda()
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 256, 3, 4, 64)).astype(
        np.float32)).cuda().requires_grad_()
    q, k, v = qkv.unbind(2)
    o = fa.flash_attention(q, k, v)
    (g,) = torch.autograd.grad(o.square().sum(), qkv)
    qkv_c = qkv.detach().clone().requires_grad_()
    qc, kc, vc = (t.contiguous() for t in qkv_c.unbind(2))
    o_p = ref.flash_attention_ref(qc, kc, vc)
    (g_p,) = torch.autograd.grad(o_p.square().sum(), qkv_c)
    np.testing.assert_allclose(o.detach().cpu().numpy(),
                               o_p.detach().cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_p.cpu().numpy(), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_outside_envelope():
    _need_cuda()
    q, k, v, _ = _flash_inputs(1, 128, 4, 2, 64, 128)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double())
    q48, k48, v48, _ = _flash_inputs(1, 128, 4, 2, 48, 128)
    with pytest.raises(ValueError):
        fa.flash_attention(q48, k48, v48)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,d", [(1, 200, 136, 4, 1, 256),
                                          (1, 136, 200, 4, 1, 256),
                                          (2, 72, 104, 4, 2, 128)])
def test_cuda_flash_dkdv_split_plan_matches_plain_bitwise(no_tf32, B, Sq, Sk,
                                                          H, KV, d):
    """GQA shapes where the dK/dV plan splits each k tile's q tiles into
    ranges and sums (H / KV) split partials (d 256 in two warp groups,
    ragged Sq != Sk): within phase 3c's f32 bounds of the plain backward,
    and two calls bitwise equal."""
    _need_cuda()
    split, _, parts = _plan.flash_dkdv_plan(B, H, KV, Sq, Sk, d)
    assert split > 1 and parts == (H // KV) * split
    cs = load_chip_smoke()
    q, k, v, do = _flash_inputs(B, Sq, H, KV, d, Sk, seed=2)
    o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, True)
    got = fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, True)
    again = fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, True)
    want = ref.flash_attention_bwd_ref(q, k, v, o_p, lse_p, do, True)
    _, tols, _ = cs.flash_tolerances(q, k, v, o_p, lse_p, do, True)
    torch.cuda.synchronize()
    for name, g, a, w, t in zip(("dq", "dk", "dv"), got, again, want, tols):
        assert torch.equal(g, a), f"{name} not bitwise reproducible"
        cs._gate(f"flash bwd {name}", g, w, t)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,d", [(1, 512, 512, 4, 1, 256),
                                          (1, 200, 328, 4, 2, 128),
                                          (1, 328, 200, 4, 1, 256)])
def test_cuda_flash_split_forward_matches_plain_bitwise(no_tf32, B, Sq, Sk,
                                                        H, KV, d):
    """Shapes where the forward plan cuts each q tile's k tiles into
    ranges (gemma3-1b's global layer; ragged Sq != Sk both ways): the
    ranges' partials merged in order within phase 3c's f32 bound of the
    plain forward (lse within its own), two calls bitwise equal, one
    launch a call."""
    _need_cuda()
    split, _ = _plan.flash_fwd_plan(B, H, Sq, Sk, d)
    assert split > 1
    cs = load_chip_smoke()
    q, k, v, do = _flash_inputs(B, Sq, H, KV, d, Sk, seed=4)
    before = fa.cuda_flash_attention_fwd.launches
    o, lse = fa.cuda_flash_attention_fwd(q, k, v, True)
    o2, lse2 = fa.cuda_flash_attention_fwd(q, k, v, True)
    o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, True)
    tol_o, _, a = cs.flash_tolerances(q, k, v, o_p, lse_p, do, True)
    torch.cuda.synchronize()
    assert fa.cuda_flash_attention_fwd.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    cs._gate("flash fwd o", o, o_p, tol_o)
    eps = torch.finfo(torch.float32).eps
    assert float((lse - lse_p).abs().max()) <= 16 * eps * (
        float(lse_p.abs().max()) + d ** 0.5 * (1 + a))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,d", [(1, 512, 32, 8, 128),
                                        (1, 512, 4, 1, 256),
                                        (2, 264, 8, 2, 128)])
def test_cuda_flash_wide_backward_matches_plain_bitwise(no_tf32, B, S, H, KV,
                                                        d):
    """The backward at d = 128 (two 4-warp blocks an SM, 16-row streamed
    tiles) and d = 256 (8-warp blocks, S and dP traded between two warp
    groups), at granite-3-8b's and gemma3-1b global's shapes and a ragged
    one: within phase 3c's f32 bounds of the plain backward, two calls
    bitwise equal."""
    _need_cuda()
    cs = load_chip_smoke()
    q, k, v, do = _flash_inputs(B, S, H, KV, d, S, seed=5)
    o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, True)
    got = fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, True)
    again = fa.cuda_flash_attention_bwd(q, k, v, o_p, lse_p, do, True)
    want = ref.flash_attention_bwd_ref(q, k, v, o_p, lse_p, do, True)
    _, tols, _ = cs.flash_tolerances(q, k, v, o_p, lse_p, do, True)
    torch.cuda.synchronize()
    for name, g, a_, w, t in zip(("dq", "dk", "dv"), got, again, want, tols):
        assert torch.equal(g, a_), f"{name} not bitwise reproducible"
        cs._gate(f"flash bwd d{d} {name}", g, w, t)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256])
def test_cuda_flash_strided_views_bitwise_equal_to_copies(no_tf32, d):
    """q, k, v as strided views of one (B,S,3,H,d) buffer (k, v: the first
    KV heads), as contiguous copies and as views at a start that is not
    16 bytes aligned (which the wrapper copies): the same bits forward and
    backward."""
    _need_cuda()
    B, S, H, KV = 2, 200, 4, 2
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3, H, d)).astype(
        np.float32)).cuda()
    views = [qkv[:, :, 0], qkv[:, :, 1, :KV], qkv[:, :, 2, :KV]]
    flat = torch.empty(sum(t.numel() for t in views) + 1, device="cuda")
    odd, at = [], 1
    for t in views:
        odd.append(flat[at:at + t.numel()].view(t.shape))
        odd[-1].copy_(t)
        at += t.numel()
    do = torch.from_numpy(rng.standard_normal((B, S, H, d)).astype(
        np.float32)).cuda()
    outs = []
    for q, k, v in (views, [t.contiguous() for t in views], odd):
        o, lse = fa.cuda_flash_attention_fwd(q, k, v, True)
        outs.append((o, lse) + fa.cuda_flash_attention_bwd(q, k, v, o, lse,
                                                           do, True))
    torch.cuda.synchronize()
    for layout, out in zip(("copy", "odd start"), outs[1:]):
        for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), outs[0], out):
            assert torch.equal(a, b), f"{name}: view vs {layout}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_cuda_flash_occupancy_is_the_plans_model(d):
    """The threads and shared memory bytes the library launches each flash
    kernel with, and the blocks an SM the CUDA runtime then reports (at
    most the launch bounds' 2), are those ``_plan`` plans with: 8 warps an
    SM for every backward kernel."""
    _need_cuda()
    from repro_torch.kernels import _plan

    model = {"fwd": _plan.flash_fwd_smem, "dkdv": _plan.flash_dkdv_smem,
             "dq": _plan.flash_dq_smem}
    bound = dict(zip(("fwd", "dkdv", "dq"),
                     (2,) + _plan.flash_bwd_blocks(d)))
    occ = fa.cuda_flash_occupancy(d)
    for kind, (threads, smem, blocks) in occ.items():
        groups = 1 if kind == "fwd" else _plan.flash_groups(d)
        assert (threads, smem, min(blocks, bound[kind])) == (
            128 * groups, model[kind](d),
            _plan.flash_blocks_per_sm(model[kind](d), bound[kind])), kind
    assert [occ[k][0] // 32 * min(occ[k][2], 2)
            for k in ("fwd", "dkdv", "dq")] == list(
        _plan.flash_warps_per_sm(d))
    assert _plan.flash_warps_per_sm(d)[1:] == (8, 8)


@pytest.mark.cuda
def test_cuda_flash_refuses_what_it_refused_before():
    """dtypes other than float32 and bfloat16 (float16 here; bfloat16 has
    its own kernels), a strided last dim, KV not dividing H, a head dim
    outside (32, 64, 128, 256), B H over 65535, empty sequences, and o /
    do / lse not as the forward returns them."""
    _need_cuda()
    q, k, v, do = _flash_inputs(1, 64, 4, 2, 64, 64)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :, :3], k, v)
    q16, k16, v16, _ = _flash_inputs(1, 64, 4, 2, 16, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q16, k16, v16)
    wide = torch.zeros((1, 1, 65536, 32), device="cuda")
    with pytest.raises(ValueError):
        fa.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :0], k, v)
    o, lse = fa.cuda_flash_attention_fwd(q, k, v, True)
    with pytest.raises(TypeError):
        fa.cuda_flash_attention_bwd(q, k, v, o, lse, do.transpose(1, 2),
                                    True)
    with pytest.raises(TypeError):
        fa.cuda_flash_attention_bwd(q, k, v, o, lse[:, :, :32], do, True)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,causal", [
    (2, 128, 128, 4, 2, 32, True), (1, 200, 200, 4, 1, 64, True),
    (1, 384, 384, 8, 2, 128, True), (1, 256, 256, 4, 1, 256, True),
    (2, 128, 128, 4, 4, 64, False), (1, 160, 96, 4, 2, 32, True)])
def test_cuda_flash_bf16_matches_plain(B, Sq, Sk, H, KV, d, causal):
    """The bf16 kernels (bf16 in and out, f32 lse) against the plain
    versions on the same bf16 inputs: rtol/atol 2e-2, the JAX bf16 gate
    (P and dS enter their products rounded to bf16); two calls bit for
    bit; one launch of each wrapper a call."""
    _need_cuda()
    q, k, v, do = (t.bfloat16() for t in _flash_inputs(B, Sq, H, KV, d, Sk))
    before = (fa.cuda_flash_attention_fwd.launches,
              fa.cuda_flash_attention_bwd.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o2, _ = fa.flash_attention_fwd(q, k, v, causal)
    o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
    grads_p = ref.flash_attention_bwd_ref(q, k, v, o_p, lse_p, do, causal)
    torch.cuda.synchronize()
    assert (fa.cuda_flash_attention_fwd.launches,
            fa.cuda_flash_attention_bwd.launches) == (before[0] + 2,
                                                      before[1] + 1)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(o, o2)
    for got, want in zip((o,) + tuple(grads), (o_p,) + tuple(grads_p)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=2e-2,
                                   atol=2e-2)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_cuda_flash_bf16_occupancy_is_the_plans_model(d):
    """The bf16 kernels' threads, shared memory and blocks an SM are those
    ``_plan`` models at esize 2: each ``wgmma`` kernel exactly its launch
    bound's blocks (the forward's ``flash_fwd_blocks``, the backward's
    ``flash_bwd_blocks``), its shared memory the SM's share of one of
    them; 128 threads a warpgroup, two in the backward at d = 256."""
    _need_cuda()
    from repro_torch.kernels import _plan

    model = {"fwd": _plan.flash_fwd_smem, "dkdv": _plan.flash_dkdv_smem,
             "dq": _plan.flash_dq_smem}
    bound = dict(zip(("fwd", "dkdv", "dq"), (_plan.flash_fwd_blocks(d, 2),)
                     + _plan.flash_bwd_blocks(d, 2)))
    occ = fa.cuda_flash_occupancy(d, torch.bfloat16)
    for kind, (threads, smem, blocks) in occ.items():
        groups = 1 if kind == "fwd" else _plan.flash_groups(d)
        assert (threads, smem, blocks) == (
            128 * groups, model[kind](d, 2), bound[kind]), kind
        assert _plan.flash_blocks_per_sm(smem, bound[kind]) == blocks
    assert [occ[k][0] // 32 * occ[k][2] for k in ("fwd", "dkdv", "dq")] == (
        list(_plan.flash_warps_per_sm(d, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,causal", [
    (2, 200, 200, 4, 1, 32, True),       # ragged, G 4
    (1, 384, 384, 8, 1, 64, True),       # G 8
    (1, 384, 384, 8, 8, 128, True),      # G 1
    (1, 200, 200, 4, 2, 256, True),
    (1, 96, 160, 8, 1, 128, True),       # Sq < Sk
    (1, 160, 96, 4, 4, 256, True),       # Sq > Sk
    (2, 200, 384, 4, 1, 64, False),      # non-causal, Sq < Sk
    (1, 384, 200, 8, 8, 32, False),      # non-causal, Sq > Sk
    (1, 512, 512, 4, 1, 256, True),      # ranges merged (gemma3-1b global)
    (1, 384, 512, 16, 4, 64, True)])     # ranges merged, Sq < Sk
def test_cuda_flash_bf16_wgmma_forward_matches_plain(B, Sq, Sk, H, KV, d,
                                                     causal):
    """The bf16 forward (``wgmma`` and TMA) against the plain version on the
    same bf16 inputs: o within the JAX bf16 gate and phase 3c-bf16's
    f32-accumulation bound plus a bf16 ulp, lse within its bound, two
    calls bitwise equal, one launch a call."""
    _need_cuda()
    cs = load_chip_smoke()
    q, k, v, _ = (t.bfloat16() for t in _flash_inputs(B, Sq, H, KV, d, Sk,
                                                       seed=6))
    before = fa.cuda_flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal)
    o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.cuda_flash_attention_fwd.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_p.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)
    tol_o, _, a = cs.flash_tolerances(
        q.float(), k.float(), v.float(), o_p.float(), lse_p,
        torch.zeros_like(o_p, dtype=torch.float32), causal, u=2.0 ** -8)
    cs._gate_bf16(f"flash bf16 fwd d{d} o", o, o_p, tol_o)
    eps = torch.finfo(torch.float32).eps
    assert float((lse - lse_p).abs().max()) <= 16 * eps * (
        float(lse_p.abs().max()) + d ** 0.5 * (1 + a))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("KV", [4, 1])
def test_cuda_flash_bf16_forward_reads_packed_views(d, KV):
    """q, k and v as strided views of one packed (B, S, 3, H, d) bf16
    buffer (k, v: its first KV heads), read through the tensor maps'
    strides: bitwise the same o and lse as their contiguous copies, and
    within phase 3c-bf16's bound of the plain version."""
    _need_cuda()
    cs = load_chip_smoke()
    B, S, H = 2, 200, 4
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3, H, d)).astype(
        np.float32)).cuda().bfloat16()
    views = [qkv[:, :, 0], qkv[:, :, 1, :KV], qkv[:, :, 2, :KV]]
    o, lse = fa.cuda_flash_attention_fwd(*views, True)
    o_c, lse_c = fa.cuda_flash_attention_fwd(
        *(t.contiguous() for t in views), True)
    o_p, lse_p = ref.flash_attention_fwd_ref(*views, True)
    torch.cuda.synchronize()
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    tol_o, _, _ = cs.flash_tolerances(
        *(t.float() for t in views), o_p.float(), lse_p,
        torch.zeros_like(o_p, dtype=torch.float32), True, u=2.0 ** -8)
    cs._gate_bf16(f"flash bf16 fwd packed d{d} o", o, o_p, tol_o)


def _bf16_backward_gate(cs, name, q, k, v, o_p, lse_p, do, grads, causal):
    """Phase 3c-bf16's gate on (dq, dk, dv): the f32-accumulation bound
    with P's and dS's rounding to bf16 (u = 2^-8), plus a bf16 ulp."""
    grads_p = ref.flash_attention_bwd_ref(q, k, v, o_p, lse_p, do, causal)
    _, tols, _ = cs.flash_tolerances(
        q.float(), k.float(), v.float(), o_p.float(), lse_p, do.float(),
        causal, u=2.0 ** -8)
    for g_name, g, w, tol in zip(("dq", "dk", "dv"), grads, grads_p, tols):
        assert g.dtype == torch.bfloat16
        cs._gate_bf16(f"flash bf16 bwd {name} {g_name}", g, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,causal", [
    (2, 200, 200, 4, 1, 32, True),       # ragged, G 4
    (1, 384, 384, 8, 1, 64, True),       # G 8
    (1, 384, 384, 8, 8, 128, True),      # G 1
    (1, 200, 200, 4, 2, 256, True),      # two warpgroups
    (1, 96, 160, 8, 1, 128, True),       # Sq < Sk: k tiles past Sq
    (1, 160, 96, 4, 4, 256, True),       # Sq > Sk
    (2, 200, 384, 4, 1, 64, False),      # non-causal, Sq < Sk
    (1, 384, 200, 8, 8, 32, False),      # non-causal, Sq > Sk
    (1, 512, 512, 4, 1, 256, True),      # split plans (gemma3-1b global)
    (1, 512, 512, 32, 8, 128, True),     # G 4, dK/dV partials (granite)
    (3, 1, 77, 2, 1, 64, True)])         # one query
def test_cuda_flash_bf16_wgmma_backward_matches_plain(B, Sq, Sk, H, KV, d,
                                                      causal):
    """The bf16 backward (``wgmma`` and TMA) against the plain version on
    the same bf16 inputs, fed the plain forward's o and lse: dq, dk and dv
    within phase 3c-bf16's bound; two calls bitwise equal; one launch a
    call."""
    _need_cuda()
    cs = load_chip_smoke()
    q, k, v, do = (t.bfloat16() for t in _flash_inputs(B, Sq, H, KV, d, Sk,
                                                        seed=8))
    o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, causal)
    before = fa.cuda_flash_attention_bwd.launches
    grads = fa.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
    again = fa.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal)
    torch.cuda.synchronize()
    assert fa.cuda_flash_attention_bwd.launches == before + 2
    assert all(torch.equal(g, g2) for g, g2 in zip(grads, again))
    _bf16_backward_gate(cs, f"d{d}", q, k, v, o_p, lse_p, do, grads, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("KV", [4, 1])
def test_cuda_flash_bf16_backward_reads_packed_views(d, KV):
    """q, k and v as strided views of one packed (B, S, 3, H, d) bf16
    buffer (k, v: its first KV heads), read through the tensor maps'
    strides: bitwise the same dq, dk and dv as their contiguous copies,
    and within phase 3c-bf16's bound of the plain version."""
    _need_cuda()
    cs = load_chip_smoke()
    B, S, H = 2, 200, 4
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3, H, d)).astype(
        np.float32)).cuda().bfloat16()
    do = torch.from_numpy(rng.standard_normal((B, S, H, d)).astype(
        np.float32)).cuda().bfloat16()
    views = [qkv[:, :, 0], qkv[:, :, 1, :KV], qkv[:, :, 2, :KV]]
    o_p, lse_p = ref.flash_attention_fwd_ref(*views, True)
    grads = fa.cuda_flash_attention_bwd(*views, o_p, lse_p, do, True)
    copies = fa.cuda_flash_attention_bwd(
        *(t.contiguous() for t in views), o_p, lse_p, do, True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, c) for g, c in zip(grads, copies))
    _bf16_backward_gate(cs, f"packed d{d}", *views, o_p, lse_p, do, grads,
                        True)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("S,P,ps,KV,G,dh", [(3, 4, 4, 2, 2, 8),
                                            (2, 3, 8, 1, 4, 16),
                                            (4, 12, 16, 32, 1, 64),
                                            (3, 8, 16, 1, 4, 256),
                                            (3, 12, 16, 8, 4, 160)])
def test_cuda_paged_attention_bf16_matches_plain(window, S, P, ps, KV, G,
                                                 dh):
    """The bf16 kernel (bf16 q and pool, f32 inside, bf16 out) against the
    plain version on the same bf16 inputs: rtol/atol 2e-2; two calls and
    slot 0 alone bit for bit its row."""
    _need_cuda()
    q, cache, table, lengths = to_torch(*paged_fixture(
        0, S=S, P=P, ps=ps, KV=KV, G=G, dh=dh), device="cuda")
    q = q.bfloat16()
    cache = {n: c.bfloat16() for n, c in cache.items()}
    before = ap.cuda_paged_attention.launches
    got = ap.paged_attention(q, cache, table, lengths, window=window)
    again = ap.paged_attention(q, cache, table, lengths, window=window)
    alone = ap.paged_attention(q[:1].contiguous(), cache,
                               table[:1].contiguous(),
                               lengths[:1].contiguous(), window=window)
    want = ap.ref_paged_attention(q, cache, table, lengths, window=window)
    torch.cuda.synchronize()
    assert ap.cuda_paged_attention.launches == before + 3
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, again) and torch.equal(alone[0], got[0])
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# lowrank_mm (B.7): the mesh runtime's batched, strided matmul
# ---------------------------------------------------------------------------

from repro_torch.kernels import lowrank_mm as lm  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (100, 70, 36), (1, 512, 64),
                                   (333, 129, 257)])
def test_cuda_matmul_matches_plain(no_tf32, m, k, n, dtype):
    """The JAX gate of test_kernels.py: rtol/atol 1e-4 (2e-2 for bf16)."""
    _need_cuda()
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    a, b = a.to(dtype).cuda(), b.to(dtype).cuda()
    before = lm.cuda_matmul.launches
    got = lm.matmul(a, b)
    torch.cuda.synchronize()
    assert lm.cuda_matmul.launches == before + 1 and got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               lm.matmul_plain(a, b).float().cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_matmul_views_and_batches_are_bitwise(no_tf32):
    """A transposed view gives the bits of its contiguous copy; a batched
    launch gives each matrix the bits of its own launch; mixed dtypes
    promote."""
    _need_cuda()
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.standard_normal((3, 130, 200)).astype(
        np.float32)).cuda()
    p = torch.from_numpy(rng.standard_normal((3, 130, 24)).astype(
        np.float32)).cuda()
    got = lm.matmul(d.transpose(1, 2), p)                      # M^T P
    assert torch.equal(got, lm.matmul(d.transpose(1, 2).contiguous(), p))
    for i in range(3):
        assert torch.equal(got[i], lm.matmul(d[i].T, p[i]))
    q = got
    hat = lm.matmul(p, q.transpose(1, 2))                      # P Q^T
    assert torch.equal(hat, lm.matmul(p, q.transpose(1, 2).contiguous()))
    np.testing.assert_allclose(hat.cpu().numpy(),
                               lm.matmul_plain(p, q.transpose(1, 2))
                               .cpu().numpy(), rtol=1e-4, atol=1e-3)
    mixed = lm.matmul(p[0].to(torch.bfloat16), q[0].T)
    assert mixed.dtype == torch.float32
    with pytest.raises(TypeError):
        lm.matmul(p.double(), q.double().transpose(1, 2))
    with pytest.raises(ValueError):
        lm.matmul(p, q.cpu().transpose(1, 2))


@pytest.mark.cuda
def test_cuda_mesh_compression_matches_cpu(no_tf32):
    """compress_gather_mean on the card (lowrank_mm and quant4 kernels)
    against its plain run on the CPU: the mean within one int4 step per
    factor (factor ulps may move a code), the warm start within 1e-4 of
    its column norm."""
    _need_cuda()
    from repro_torch.core import mesh_compression as mc

    rng = np.random.default_rng(6)
    tree = {"w": torch.from_numpy(rng.standard_normal((2, 3, 256, 192))
                                  .astype(np.float32) * 0.1),
            "b": torch.from_numpy(rng.standard_normal((2, 192))
                                  .astype(np.float32))}
    cfg = mc.MeshCompressionConfig(rank=24)
    q = {k: v.unsqueeze(0).expand((2,) + tuple(v.shape)).clone()
         for k, v in mc.init_q_state({k: v[0] for k, v in tree.items()},
                                     cfg).items()}
    before = (lm.cuda_matmul.launches, q4.cuda_quant4_pack.launches,
              q4.cuda_quant4_unpack.launches)
    D, qn = mc.compress_gather_mean({k: v.cuda() for k, v in tree.items()},
                                    {k: v.cuda() for k, v in q.items()},
                                    20, cfg)
    torch.cuda.synchronize()
    assert lm.cuda_matmul.launches == before[0] + 3
    # one batched launch per leaf and factor: w's P and Q, b's two rows
    assert q4.cuda_quant4_pack.launches == before[1] + 3
    assert q4.cuda_quant4_unpack.launches == before[2] + 3
    D_p, qn_p = mc.compress_gather_mean(tree, q, 20, cfg)
    payloads, _ = mc.compress_local(tree, q, 20, cfg)
    step = max(16 * float(row[i + 1].max()) * float(row[i + 3].max())
               for row in payloads[1] for i in range(0, len(row), 4))
    np.testing.assert_allclose(D["w"].cpu().numpy(), D_p["w"].numpy(),
                               rtol=0, atol=step)
    np.testing.assert_allclose(D["b"].cpu().numpy(), D_p["b"].numpy(),
                               rtol=0, atol=float(payloads[0][0][1].max()))
    col = qn_p["w"].norm(dim=-2, keepdim=True)
    assert ((qn["w"].cpu() - qn_p["w"]).abs() <= 1e-4 * col).all()


def _mm_case(batch, m, k, n, trans, seed):
    """(a, b) on the card; ``trans`` a or b: that operand is a transposed
    view of a row-major tensor, as the mesh compressor forms M^T and Q^T."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
    if trans == "a":
        return rnd(batch, k, m).transpose(1, 2) * 0.3, rnd(batch, k, n)
    if trans == "b":
        return rnd(batch, m, k), rnd(batch, n, k).transpose(1, 2)
    return rnd(batch, m, k) * 0.3, rnd(batch, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("route,batch,m,k,n,trans", [
    ("split", 2, 130, 1030, 24, "-"),     # S > 1, K % 16 = 6
    ("split", 3, 257, 2051, 40, "a"),     # M^T P, K % 4 = 3: scalar A tiles
    ("split", 1, 333, 20003, 64, "-"),    # K % 4 = 3: scalar tiles
    ("split", 2, 130, 1030, 7, "-"),      # r = 7: scalar tiles
    ("rank", 2, 130, 24, 203, "b"),       # P Q^T, n % 4 = 3: scalar stores
    ("rank", 3, 257, 40, 131, "b"),
    ("rank", 1, 300, 64, 50, "b"),        # n <= 64, Q^T a view
    ("rank", 2, 70, 64, 130, "-"),        # row-major B: column-fast staging
    ("rank", 2, 130, 7, 90, "b"),         # K % 4 = 3: scalar staging
    ("general", 2, 130, 70, 90, "-"),
    ("general", 1, 100, 333, 257, "a")])
def test_cuda_matmul_routes_at_ragged_shapes(no_tf32, route, batch, m, k, n,
                                             trans):
    """Each route of lowrank_mm where rows are no multiple of 128, K no
    multiple of 16 and n no multiple of 4: each matrix within
    chip_smoke.py's product gate of the plain version, one count for the
    route, two calls bitwise equal, a view bitwise its contiguous copy, a
    batched launch bitwise each matrix's own launch."""
    _need_cuda()
    gate = load_chip_smoke()._gate_product
    a, b = _mm_case(batch, m, k, n, trans, seed=m + k + n)
    assert lm._route(a, b) == route
    before = (lm.cuda_matmul.launches, dict(lm.cuda_matmul.routes))
    got = lm.matmul(a, b)
    assert lm.cuda_matmul.launches == before[0] + 1
    assert lm.cuda_matmul.routes == dict(before[1], **{
        route: before[1][route] + 1})
    want = lm.matmul_plain(a, b)
    for i in range(batch):
        gate(f"{route} [{i}]", got[i], want[i], a[i], b[i])
    assert torch.equal(got, lm.matmul(a, b))
    assert torch.equal(got, lm.matmul(a.contiguous(), b.contiguous()))
    for i in range(batch):
        assert torch.equal(got[i], lm.matmul(a[i:i + 1], b[i:i + 1])[0])


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,r", [(257, 129, 8), (300, 203, 64),
                                   (130, 1030, 40), (96, 70, 7)])
@pytest.mark.parametrize("ef", ["off", "without e", "with e"])
def test_cuda_reconstruct_matches_plain_and_lowrank_mm(no_tf32, m, n, r, ef):
    """The reconstruction (decode, then the K-resident GEMM with the EF
    epilogue) within 16 eps |Pq||Qq|^T of its plain version; hat bit for
    bit lowrank_mm(unpack P, unpack Q^T); e' = d (+ e) - hat exactly; two
    calls bitwise equal; one count per call."""
    _need_cuda()
    rng = np.random.default_rng(m * n + r)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda()
    P, Q = rnd(m * r, scale=0.1), rnd(n * r)
    d, e = rnd(m, n, scale=0.3), rnd(m, n, scale=0.05)
    pp, sp = q4.quant4_pack(P)
    pq, sq = q4.quant4_pack(Q)
    with_ef = ef != "off"
    e_arg = e if ef == "with e" else None
    before = fc.cuda_reconstruct.launches
    hat, e_new = fc.reconstruct(pp, sp, pq, sq, d, e_arg, m, n, r,
                                with_ef=with_ef)
    assert fc.cuda_reconstruct.launches == before + 1
    hat_p, e_new_p = fc.reconstruct_plain(pp, sp, pq, sq, d, e_arg, m, n, r,
                                          with_ef=with_ef)
    Pq = q4.quant4_unpack(pp, sp, m * r).reshape(m, r)
    Qq = q4.quant4_unpack(pq, sq, n * r).reshape(n, r)
    bound = 16 * torch.finfo(torch.float32).eps * (Pq.abs() @ Qq.abs().T)
    assert bool(((hat - hat_p).abs() <= bound + 1e-30).all())
    assert torch.equal(hat, lm.matmul(Pq, Qq.T))
    if with_ef:
        assert torch.equal(e_new, (d if e_arg is None else d + e_arg) - hat)
        np.testing.assert_allclose(e_new.cpu().numpy(),
                                   e_new_p.cpu().numpy(), rtol=1e-5,
                                   atol=1e-6)
    else:
        assert e_new is None
    again = fc.reconstruct(pp, sp, pq, sq, d, e_arg, m, n, r, with_ef=with_ef)
    assert torch.equal(hat, again[0])
    if with_ef:
        assert torch.equal(e_new, again[1])


# ---------------------------------------------------------------------------
# the random baselines (no kernel: torch RNG and plain ops on the card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_sparse", "cocktail"])
def test_cuda_random_baselines_match_cpu_given_one_mask(name):
    """On the card a mask depends on (seed, step, path) alone (two draws
    bitwise equal, another step another mask, density within six
    binomial sigmas), and given one mask the roundtrip's second half is
    bitwise its CPU result."""
    from repro_torch.core import compression as C

    _need_cuda()
    n, ratio = 1 << 20, 0.1
    m = C._mask(0, 3, "['w']", (n,), ratio, "cuda")
    assert m.is_cuda and torch.equal(m, C._mask(0, 3, "['w']", (n,), ratio,
                                                "cuda"))
    assert not torch.equal(m, C._mask(0, 4, "['w']", (n,), ratio, "cuda"))
    assert abs(int(m.sum()) - n * ratio) <= 6 * (n * ratio * (1 - ratio)) ** .5
    x = torch.randn((1024, 1024), generator=torch.Generator().manual_seed(0))
    mask = m.reshape(x.shape)
    if name == "random_sparse":
        apply = lambda t, mk: C.random_sparse_apply(t, mk, ratio)
    else:
        apply = lambda t, mk: C.cocktail_apply(t, mk, ratio, 0.08, 4)
    got = apply(x.cuda(), mask)
    assert got.is_cuda
    assert torch.equal(got.cpu(), apply(x, mask.cpu()))


# ---------------------------------------------------------------------------
# the pipeline-parallel engine (parallel/pipeline.py) on the card
# ---------------------------------------------------------------------------

PP_CASES = [(1, 3), (2, 5), (4, 6)]


def _pp_case(stages, layers, seq=16):
    """tests/test_torch_pipeline.py's configuration (reduced granite-3-8b,
    vocab 128, B 8, 4 microbatches), the port's own weights on the card."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.parallel import pipeline as PP

    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(),
                              n_layers=layers, vocab_size=128)
    pcfg = PP.PipelineConfig(n_stages=stages, n_micro=4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = PP.init_pp_params(cfg, gen, pcfg, "cuda")
    toks = torch.randint(0, 128, (8, seq), generator=gen, device="cuda",
                         dtype=torch.int32)
    return cfg, pcfg, params, toks


def _pp_grads_gap(a, b):
    from repro_torch import tree as T
    return max(float((x - y).abs().max()) for (k, x), y in
               zip(T.keystr_items(a), T.leaves(b)) if "active" not in k)


@pytest.mark.cuda
@pytest.mark.parametrize("stages,layers", PP_CASES)
def test_cuda_pp_matches_sequential(no_tf32, stages, layers):
    """The pipeline on the card against the sequential model on the card
    (the same tree through ``pipeline.sequential_params``), the CPU test's
    bound: loss within 1e-6 relative, gradients within 1e-6."""
    _need_cuda()
    from repro_torch import tree as T
    from repro_torch.models import model as M
    from repro_torch.parallel import pipeline as PP

    cfg, pcfg, params, toks = _pp_case(stages, layers)
    loss, grads = PP.make_pp_loss(cfg, pcfg).value_and_grad(params, toks)
    leaves = T.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ref, _ = M.loss_fn(PP.sequential_params(params, cfg), cfg,
                       {"tokens": toks}, remat=False)
    ref_g = torch.autograd.grad(ref, leaves, allow_unused=True)
    ref_g = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, ref_g)]
    assert abs(float(loss) - float(ref)) <= 1e-6 * abs(float(ref))
    assert _pp_grads_gap(grads, ref_g) <= 1e-6


@pytest.mark.cuda
def test_cuda_pp_flash_stages(no_tf32):
    """flash=True on the card: the flash kernels launch inside the stages
    (forward and the backward's recompute per layer slot and microbatch,
    one backward each), loss and gradients within JAX's pp gate (1e-4,
    1e-3) of the einsum pipeline, and two runs bit for bit equal."""
    _need_cuda()
    from repro_torch import tree as T
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.parallel import pipeline as PP

    cfg, pcfg, params, toks = _pp_case(2, 5, seq=128)
    want_loss, want = PP.make_pp_loss(cfg, pcfg).value_and_grad(params, toks)
    fwd, bwd = fa.cuda_flash_attention_fwd, fa.cuda_flash_attention_bwd
    f0, b0 = fwd.launches, bwd.launches
    pp = PP.make_pp_loss(cfg, pcfg, flash=True)
    loss, grads = pp.value_and_grad(params, toks)
    slots = 2 * PP.layers_per_stage(cfg, pcfg)[0]
    assert fwd.launches - f0 == 2 * 4 * slots
    assert bwd.launches - b0 == 4 * slots
    assert abs(float(loss) - float(want_loss)) < 1e-4
    assert _pp_grads_gap(grads, T.leaves(want)) < 1e-3
    loss2, grads2 = pp.value_and_grad(params, toks)
    assert float(loss2) == float(loss)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(grads),
                                                 T.leaves(grads2)))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 4, 5])
def test_cuda_membership_and_mix_match_cpu_bitwise(C):
    """The membership and mixing operations (plain PyTorch, no kernel of
    their own) on the card give the CPU's bits: the masked mean with a
    0/1 and a float mask, the trimmed mean, the gossip mix and one row of
    it, and the in-place rejoin reset (whose CPU bits
    tests/test_torch_membership.py holds to the JAX package's)."""
    _need_cuda()
    from repro_torch import tree as T
    from repro_torch.core import membership as MB
    from repro_torch.topology import MixingMatrix, make_topology, mix_row, \
        mix_stacked

    gen = torch.Generator().manual_seed(C)
    tree = {"w": torch.randn(C, 257, 129, generator=gen),
            "b": torch.randn(C, 33, generator=gen)}
    dev = lambda t: T.tree_map(lambda x: x.cuda(), t)
    eq = lambda a, b: all(torch.equal(x.cpu(), y) for x, y in zip(
        T.leaves(a), T.leaves(b)))
    masks = [torch.ones(C), (torch.arange(C) % 2).float(),
             torch.rand(C, generator=gen)]
    for m in masks:
        assert eq(MB.masked_cluster_mean(dev(tree), m.cuda()),
                  MB.masked_cluster_mean(tree, m))
        m01 = (m > 0.3).float()
        assert eq(MB.trimmed_cluster_mean(dev(tree), m01.cuda(), 1),
                  MB.trimmed_cluster_mean(tree, m01, 1))
    alive = torch.arange(C) != C - 1
    W = MixingMatrix.metropolis(make_topology("ring", C), alive.numpy()).W
    assert eq(mix_stacked(W, dev(tree)), mix_stacked(W, tree))
    parts = [T.tree_map(lambda x, j=j: x[j], dev(tree)) for j in range(C)]
    assert eq(mix_row(W[0], parts), T.tree_map(lambda x: x[0],
                                               mix_stacked(W, tree)))
    on_card = dev(tree)
    MB.reset_rejoining(on_card, alive.cuda())
    assert eq(on_card, MB.reset_rejoining(T.tree_map(torch.clone, tree),
                                          alive))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("name", ["test_sim.py:42", "test_sim.py:166",
                                  "test_topology.py:219"])
def test_cuda_simulator_quadratic_matches_cpu(no_tf32, name, backend):
    """The simulator's quadratic scenarios (chip_smoke.py 4o's second leg)
    on the card against the port's CPU run of the same scenario and
    compressor backend: the same timeline but its numeric fields, losses
    and params within 4o's stated tolerances, the same int4 payload bytes
    charged per round."""
    _need_cuda()
    cs = load_chip_smoke()
    got = cs.sim_quadratic_run(name, backend, torch.device("cuda"))
    want = cs.sim_quadratic_run(name, backend, torch.device("cpu"))
    timing_ok, loss_err, param_err, wire_ok = cs.sim_quadratic_gap(got, want)
    assert timing_ok and wire_ok
    assert loss_err <= cs.SIM_QUAD_LOSS_RTOL, loss_err
    assert param_err <= cs.SIM_QUAD_PARAM_RTOL, param_err


@pytest.mark.cuda
def test_cuda_tree_hash_is_the_host_copys():
    """``sim.tree_hash`` of a tree on the card is that of its host copy,
    bf16 and int32 leaves included."""
    _need_cuda()
    from repro_torch.sim import tree_hash

    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(33, 17, generator=gen),
            "b": [torch.randn(5, generator=gen).to(torch.bfloat16),
                  torch.arange(7, dtype=torch.int32)],
            "s": torch.tensor(3.0)}
    on_card = {"w": tree["w"].cuda(), "b": [x.cuda() for x in tree["b"]],
               "s": tree["s"].cuda()}
    assert tree_hash(on_card) == tree_hash(tree)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("name", ["test_engine.py:237",
                                  "test_engine.py:280",
                                  "test_engine.py:294 trimmed"])
def test_cuda_async_simulator_quadratic_matches_cpu(no_tf32, name, backend):
    """The bounded-stale executor (chip_smoke.py 4p's second leg) on the
    card against the port's CPU run of the same scenario and backend: the
    same timeline but its numeric fields, losses and params within 4p's
    stated tolerances."""
    _need_cuda()
    cs = load_chip_smoke()
    got = cs.sim_async_quadratic_run(name, backend, torch.device("cuda"))
    want = cs.sim_async_quadratic_run(name, backend, torch.device("cpu"))
    timing_ok, loss_err, param_err, wire_ok = cs.sim_quadratic_gap(got, want)
    assert timing_ok and wire_ok
    assert loss_err <= cs.SIM_QUAD_LOSS_RTOL, loss_err
    assert param_err <= cs.SIM_QUAD_PARAM_RTOL, param_err


@pytest.mark.cuda
def test_cuda_disagreement_on_the_card_equals_numpy():
    """``consensus_distance_trees`` on trees on the card against the numpy
    ``consensus_distance`` of their host copies, within 1e-10 relative
    (float64 on both sides, other summation orders)."""
    _need_cuda()
    from repro_torch.topology import mixing as PM

    gen = torch.Generator().manual_seed(0)
    C = 4
    trees = [{"w": torch.randn(301, 77, generator=gen),
              "b": torch.randn(4099, generator=gen) * 5}
             for _ in range(C)]
    flat = np.stack([np.concatenate([t["w"].numpy().ravel(),
                                     t["b"].numpy().ravel()])
                     for t in trees])
    for alive in (np.ones(C, bool), np.array([1, 0, 1, 1], bool)):
        want = PM.consensus_distance(flat, alive)
        on_card = [{k: v.cuda() for k, v in t.items()} for t in trees]
        got = PM.consensus_distance_trees(on_card, alive)
        assert abs(got - want) <= 1e-10 * want, (got, want)
