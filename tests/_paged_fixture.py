"""The paged-attention fixture of ``tests/test_kernels.py::_paged_fixture``
rebuilt in numpy on the port's ``PageManager`` (no jax), shared by the
port's CPU parity tests and its GPU kernel test."""
import numpy as np
import torch

from repro_torch.serve.pages import PageManager


def paged_fixture(seed, *, S, P, ps, KV, G, dh, fill_frac=0.8):
    """numpy twin of tests/test_kernels.py::_paged_fixture."""
    rng = np.random.default_rng(seed)
    n_pages = S * P
    pm = PageManager(n_pages, ps, S, P)
    lengths = np.zeros(S, np.int32)
    for s in range(S):
        lengths[s] = rng.integers(1, int(P * ps * fill_frac) + 1)
        pm.admit(s, int(lengths[s]))
        for pos in range(int(lengths[s])):
            pm.ensure(s, pos)
    H = KV * G
    k = rng.normal(size=(1 + n_pages, ps, KV, dh)).astype(np.float32)
    v = rng.normal(size=(1 + n_pages, ps, KV, dh)).astype(np.float32)
    k[0] = 1e3          # scratch-page garbage must never leak into outputs
    v[0] = 1e3
    q = rng.normal(size=(S, 1, H, dh)).astype(np.float32)
    return q, {"k": k, "v": v}, pm.page_table.copy(), lengths


def to_torch(q, cache, table, lengths, device="cpu"):
    return (torch.from_numpy(q).to(device),
            {k: torch.from_numpy(v).to(device) for k, v in cache.items()},
            torch.from_numpy(table).to(device),
            torch.from_numpy(lengths).to(device))


def paged_case(seed, lengths, *, P, ps, KV, G, dh, inactive=()):
    """Slots of the given ``lengths`` with the engine's allocation: pages up
    to position lengths[s] (the key written before attention), so a length
    that is a multiple of ``ps`` has its page; a shuffled page pool;
    scratch page 0 full of 1e3; the slots in ``inactive`` with length 0
    and an all-zero table row."""
    rng = np.random.default_rng(seed)
    S = len(lengths)
    lengths = np.array(lengths, np.int32)
    lengths[list(inactive)] = 0
    n_used = [0 if s in inactive else int(lengths[s]) // ps + 1
              for s in range(S)]
    n_pages = max(1, sum(n_used))
    pool = rng.permutation(n_pages).astype(np.int32) + 1
    table = np.zeros((S, P), np.int32)
    at = 0
    for s, n in enumerate(n_used):
        table[s, :n] = pool[at:at + n]
        at += n
    k = rng.normal(size=(1 + n_pages, ps, KV, dh)).astype(np.float32)
    v = rng.normal(size=(1 + n_pages, ps, KV, dh)).astype(np.float32)
    k[0] = 1e3
    v[0] = 1e3
    q = rng.normal(size=(S, 1, KV * G, dh)).astype(np.float32)
    return q, {"k": k, "v": v}, table, lengths
