"""The paged kernel's page chunks and merge (``csrc/paged_attention.cu``), on
the CPU: the plan (``repro_torch.kernels._plan.paged_plan``) at the served
models' shapes and its independence of the batch; a plain-PyTorch
emulation of the kernels' chunk-and-merge recurrence, in their order,
against the JAX package's ``ref_paged_attention`` and its Pallas kernel
in interpret mode; and the wrapper ``cuda_paged_attention`` driven on CPU
tensors with a recording stand-in for the kernel library: what it hands
the kernels, that it reads no tensor on the host and runs no other
operator, and what it refuses. The kernels themselves run in
``tests/test_torch_cuda.py``."""
import inspect
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from repro.serve import attention_paged as jap
from _paged_fixture import paged_case, to_torch
from repro_torch.kernels import _build, _plan
from repro_torch.serve import attention_paged as ap

# the JAX package's gate for the Pallas kernel (tests/test_kernels.py)
TOL_PALLAS = dict(rtol=1e-3, atol=1e-5)

# phase 3a's full-size cases (chip_smoke.py): name -> (P, ps, dh)
FULL_SIZE = {"opt-1.3b served": (12, 16, 64),
             "opt-1.3b 2048": (128, 16, 64),
             "granite-3-8b 2048": (128, 16, 128),
             "gemma3-1b 2048 w512": (128, 16, 256)}


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,want", [("opt-1.3b served", (4, 3)),
                                       ("opt-1.3b 2048", (4, 32)),
                                       ("granite-3-8b 2048", (2, 64)),
                                       ("gemma3-1b 2048 w512", (1, 128))])
def test_paged_plan_at_the_full_size_shapes(name, want):
    P, ps, dh = FULL_SIZE[name]
    pages, n_chunks = _plan.paged_plan(P, ps, dh)
    assert (pages, n_chunks) == want
    assert pages * ps * dh <= _plan.PAGED_CHUNK_FLOATS
    assert (n_chunks - 1) * pages < P <= n_chunks * pages
    assert ap.smem_bytes(P, ps, 8, dh) <= ap.MAX_SMEM_BYTES


def test_paged_plan_reads_the_shape_alone():
    """No S, no lengths, no window: a slot's chunks, and so the order of
    its sums, are the same in every batch (the element size is part of
    the shape: a bf16 pool's chunks hold twice the keys)."""
    assert list(inspect.signature(_plan.paged_plan).parameters) == [
        "P", "ps", "dh", "esize"]


@pytest.mark.parametrize("ps", [1, 2, 16, 64])
@pytest.mark.parametrize("dh", [4, 8, 64, 256])
def test_paged_plan_covers_the_table_once(ps, dh):
    for P in (1, 3, 17, 128):
        pages, n_chunks = _plan.paged_plan(P, ps, dh)
        assert 1 <= pages <= P
        assert pages * ps <= max(ps, _plan.PAGED_CHUNK_KEYS)
        assert (n_chunks - 1) * pages < P <= n_chunks * pages


# ---------------------------------------------------------------------------
# the kernels' recurrence, emulated
# ---------------------------------------------------------------------------

def live_keys(length, window, n_keys):
    """The kernels' ``live_keys``: unmasked key positions [lo, hi]."""
    hi = min(length, n_keys - 1)
    lo = min(max(0, length - window + 1), hi) if window > 0 else 0
    return lo, hi


def split_emulation(q, cache, table, lengths, *, window, chunk_pages):
    """The partial and merge kernels' arithmetic in plain PyTorch: for each
    slot on its own (a block reads only its slot's length, table row and
    q), the live chunks' (m, l, acc), then their merge in increasing chunk
    order, m = max m_c, l = sum l_c exp(m_c - m), o = sum acc_c exp(m_c -
    m) / max(l, 1e-30)."""
    S, _, H, dh = q.shape
    P = table.shape[1]
    ps, KV = cache["k"].shape[1], cache["k"].shape[2]
    G = H // KV
    C = chunk_pages * ps
    k_rows = cache["k"].reshape(-1, KV, dh)
    v_rows = cache["v"].reshape(-1, KV, dh)
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty((S, 1, H, dh), dtype=torch.float32)
    for s in range(S):
        lo, hi = live_keys(int(lengths[s]), window, P * ps)
        qs = q[s, 0].reshape(KV, G, dh)
        parts = []
        for c in range(lo // C, hi // C + 1):
            pos = torch.arange(max(lo, c * C), min(hi, c * C + C - 1) + 1)
            rows = table[s, pos // ps].long() * ps + pos % ps
            sc = torch.einsum("kgd,nkd->kgn", qs, k_rows[rows]) * scale
            m = sc.max(dim=-1).values
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(dim=-1),
                          torch.einsum("kgn,nkd->kgd", p, v_rows[rows])))
        m = torch.stack([mc for mc, _, _ in parts]).max(dim=0).values
        l = torch.zeros_like(m)
        o = torch.zeros((KV, G, dh))
        for mc, lc, acc in parts:
            w = torch.exp(mc - m)
            l = l + lc * w
            o = o + acc * w[..., None]
        out[s, 0] = (o / torch.clamp(l, min=1e-30)[..., None]).reshape(H, dh)
    return out


def _edge_case(seed, ps, G, P=6, KV=2, dh=8):
    """Lengths on the edges of 2-page chunks, multiples of ps (their page
    allocated), the last position, and one inactive slot."""
    C = 2 * ps
    lengths = [C - 1, C, C + 1, 2 * C, P * ps - 1, 3, 0]
    return paged_case(seed, lengths, P=P, ps=ps, KV=KV, G=G, dh=dh,
                      inactive=(len(lengths) - 1,))


def _jax(q, cache, table, lengths):
    return (jnp.asarray(q), {k: jnp.asarray(v) for k, v in cache.items()},
            jnp.asarray(table), jnp.asarray(lengths))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("ps", [2, 4, 8, 16])
def test_split_emulation_matches_jax_ref_and_pallas(window, G, ps):
    """At the plan's chunks (one, at these sizes) and at chunks of 1 and 2
    pages, so that chunk edges and the merge are exercised."""
    case = _edge_case(ps * 10 + G, ps, G)
    jcase = _jax(*case)
    want_ref = np.asarray(jax.jit(jap.ref_paged_attention,
                                  static_argnames="window")(*jcase,
                                                            window=window))
    want_pallas = np.asarray(jax.jit(jap.pallas_paged_attention,
                                     static_argnames="window")(
        *jcase, window=window))
    tcase = to_torch(*case)
    P, dh = case[2].shape[1], case[0].shape[3]
    for chunk_pages in (_plan.paged_plan(P, ps, dh)[0], 1, 2):
        got = split_emulation(*tcase, window=window,
                              chunk_pages=chunk_pages).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want_ref, **TOL_PALLAS)
        np.testing.assert_allclose(got, want_pallas, **TOL_PALLAS)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_split_emulation_slot_is_independent_of_the_batch(G):
    """Slot 1's bits alone, among the others, and with the others'
    lengths, table rows, q and activity changed."""
    ps, window = 4, 5
    q, cache, table, lengths = to_torch(*_edge_case(G, ps, G))
    emulate = dict(window=window, chunk_pages=1)
    full = split_emulation(q, cache, table, lengths, **emulate)
    alone = split_emulation(q[1:2], cache, table[1:2], lengths[1:2],
                            **emulate)
    assert torch.equal(alone[0], full[1])
    q2, table2, lengths2 = q.clone(), table.flip(0).clone(), lengths.flip(0)
    q2[0] += 1.0
    table2[1], lengths2[1] = table[1], lengths[1]
    lengths2[2] = 0
    table2[2] = 0
    other = split_emulation(q2, cache, table2, lengths2, **emulate)
    assert torch.equal(other[1], full[1])


# ---------------------------------------------------------------------------
# the wrapper, on CPU tensors, with a recording stand-in for the library
# ---------------------------------------------------------------------------

class _Lib:
    """Records the kernel library's calls; launches nothing."""

    def __init__(self):
        self.calls = []

    def paged_attention_f32(self, *args):
        self.calls.append(args)
        return 0


class _Ops(TorchDispatchMode):
    """Every ATen operator run inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    monkeypatch.setattr(ap, "_stream", lambda t: 0)
    return fake


@pytest.mark.parametrize("S", [1, 7])
def test_wrapper_hands_the_kernels_the_plan_and_reads_nothing(lib, S):
    """Through the real wrapper: the plan and the workspace follow the
    shape (the same for every S and every lengths), the output is an
    empty tensor the kernels fill, the only operators run are the two
    allocations (no .item(), .tolist() or copy of a device tensor to the
    host, no library kernel), and the launch counter moves once."""
    ps, KV, G, dh, P = 16, 2, 4, 64, 9
    q, cache, table, lengths = to_torch(*paged_case(
        S, [5 + 17 * s for s in range(S)], P=P, ps=ps, KV=KV, G=G, dh=dh))
    before = ap.cuda_paged_attention.launches
    with _Ops() as ops:
        out = ap.cuda_paged_attention(q, cache, table, lengths, window=7)
    assert sorted(set(ops.ops)) == ["aten.empty", "aten.empty_like"]
    assert ap.cuda_paged_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.float32
    (args,) = lib.calls
    pages, n_chunks = _plan.paged_plan(P, ps, dh)
    assert args[7:14] == (S, P, ps, KV, G, dh, 7)
    assert args[15:17] == (pages, n_chunks)
    assert args[0] == q.data_ptr() and args[5] == out.data_ptr()


def test_wrapper_workspace_is_one_partial_per_chunk(lib, monkeypatch):
    sizes = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        sizes.append(shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", recording_empty)
    S, P, ps, KV, G, dh = 3, 13, 4, 2, 2, 8
    case = to_torch(*paged_case(0, [3, 20, 51], P=P, ps=ps, KV=KV, G=G,
                                dh=dh))
    ap.cuda_paged_attention(*case)
    n_chunks = _plan.paged_plan(P, ps, dh)[1]
    assert sizes == [(S * KV * n_chunks * G * (dh + 2),)]


def _shape_case(dh=8, ps=4, G=2, S=2, P=3, KV=2):
    return to_torch(*paged_case(0, [1] * S, P=P, ps=ps, KV=KV, G=G, dh=dh))


@pytest.mark.parametrize("bad,err", [
    (dict(dh=6), ValueError),              # dh not a multiple of 4
    (dict(dh=260), ValueError),            # dh > 256
    (dict(ps=128), ValueError),            # page size > 64
    (dict(G=160, dh=256, ps=64), ValueError),   # shared memory > 227 KB
])
def test_wrapper_refuses_shapes_outside_the_envelope(lib, bad, err):
    with pytest.raises(err):
        ap.cuda_paged_attention(*_shape_case(**bad))
    assert lib.calls == []


def test_wrapper_refuses_what_the_kernels_cannot_read(lib):
    q, cache, table, lengths = _shape_case()
    shifted = torch.empty(q.numel() + 1)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError):                    # not 16-byte aligned
        ap.cuda_paged_attention(shifted, cache, table, lengths)
    with pytest.raises(TypeError):
        ap.cuda_paged_attention(q.double(), cache, table, lengths)
    with pytest.raises(TypeError):
        ap.cuda_paged_attention(q, cache, table.long(), lengths)
    with pytest.raises(ValueError):
        ap.cuda_paged_attention(q, cache, table, lengths, window=-1)
    assert lib.calls == []
    ap.cuda_paged_attention(q, cache, table, lengths)   # inside: launches
    assert len(lib.calls) == 1
