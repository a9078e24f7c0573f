"""Deterministic synthetic LM data (port of ``repro.data.synthetic``).

A learnable token stream: a first-order Markov chain with a sparse, seeded
successor table, so cross-entropy falls with training and methods give
distinguishable loss curves. ``make_markov_table`` is numpy and gives the
JAX package's table exactly. Batches come from ``torch.Generator``s: the
same distribution as the JAX package's threefry draws, another stream
(parity tests hand JAX-drawn tokens to the port instead).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch


def make_markov_table(vocab: int, branching: int = 4, seed: int = 0
                      ) -> np.ndarray:
    """(vocab, branching) int32 successor table: each token has
    ``branching`` plausible successors; the generator picks among them."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, size=(vocab, branching)).astype(np.int32)


def _gen_batch(gen: torch.Generator, batch: int, seq: int, branching: int,
               table: torch.Tensor, bias_logits: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """(batch, seq) int32 tokens on ``table``'s device: a uniform first
    token, then tok[t] = table[tok[t-1], choice[t-1]] with choices uniform
    or drawn from ``bias_logits`` (per-cluster successor preference, the
    paper's Assumption 3.3 heterogeneity)."""
    dev = table.device
    first = torch.randint(0, table.shape[0], (batch,), generator=gen,
                          device=gen.device).to(dev)
    if bias_logits is not None:
        probs = torch.softmax(bias_logits.float(), dim=-1).to(gen.device)
        choices = torch.multinomial(probs, batch * seq, replacement=True,
                                    generator=gen).reshape(batch, seq)
    else:
        choices = torch.randint(0, branching, (batch, seq), generator=gen,
                                device=gen.device)
    choices = choices.to(dev).long()
    tab = table.long()
    toks = torch.empty((batch, seq), dtype=torch.long, device=dev)
    toks[:, 0] = first
    for t in range(1, seq):
        toks[:, t] = tab[toks[:, t - 1], choices[:, t - 1]]
    return toks.to(torch.int32)


def stream_generator(*keys: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of ints (the JAX package folds
    them into a PRNG key)."""
    seed = 0
    for k in keys:
        seed = (seed * 1_000_003 + int(k) + 1) % (2 ** 63)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, batch: int, *,
                 branching: int = 4, seed: int = 0, data_shard: int = 0,
                 hetero: float = 0.0, device=None):
        self.vocab = vocab
        self.seq = seq_len
        self.batch = batch
        self.branching = branching
        self.table = torch.from_numpy(
            make_markov_table(vocab, branching, seed)).to(device or "cpu")
        self.seed, self.data_shard = seed, data_shard
        self.step = 0
        # heterogeneity: shard-specific successor preference (0 = IID)
        if hetero > 0:
            logits = torch.zeros((branching,), dtype=torch.float32)
            logits[data_shard % branching] = float(
                np.log(1.0 + hetero * branching / (1 - hetero + 1e-9)))
            self.bias_logits = logits
        else:
            self.bias_logits = None

    def next_batch(self) -> dict:
        gen = stream_generator(self.seed + 1, self.data_shard, self.step)
        self.step += 1
        return {"tokens": _gen_batch(gen, self.batch, self.seq,
                                     self.branching, self.table,
                                     self.bias_logits)}

    def batches(self, n: int) -> Iterator[dict]:
        for _ in range(n):
            yield self.next_batch()

    def entropy_floor(self) -> float:
        """Best achievable NLL = log(branching) if choices are uniform."""
        return float(np.log(self.branching))


def with_frontend(batch: dict, cfg, gen: Optional[torch.Generator] = None
                  ) -> dict:
    """Attach stub frontend embeddings for non-text modalities. The port
    carries text models only, so this returns text batches unchanged and
    refuses the others (ROADMAP A.16)."""
    modality = getattr(cfg, "modality", "text")
    if modality == "text":
        return batch
    raise NotImplementedError(f"modality {modality!r} is not ported yet "
                              f"(ROADMAP A.16)")
