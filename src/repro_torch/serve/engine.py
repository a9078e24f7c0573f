"""Paged continuous-batching serve engine (port of ``repro.serve.engine``).

One decode step serves every phase and occupancy: ``(params, caches,
tokens(S,), lengths(S,), active(S,), page_tables(S,P)) -> (next_tokens(S,),
caches)``. The page pool is updated in place (the JAX engine donates it
to the jitted step instead). Prefill is by decode: the scheduler feeds
prompt tokens one per step.

The per-unit math mirrors ``model.decode_step`` + ``attention.decode_gqa``
operation for operation, which makes paged and dense greedy tokens
bitwise equal on the CPU on matching shapes (``max_pages_per_seq *
page_size == s_max``). On the GPU, attention runs the CUDA kernel.

Given a ``parallel.tensor.ShardGroup`` the step runs tensor-parallel: each
model shard's pool holds its KV heads of every page (page ids stay
global), and the kernel runs on it with the shard's query heads.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.layers import apply_norm, apply_rope
from repro_torch.serve import attention_paged as pa
from repro_torch.serve.pages import PageManager
from repro_torch.serve.scheduler import Request, Scheduler


def supports_paged(cfg: ModelConfig) -> Tuple[bool, str]:
    """Which architectures the paged engine serves: the dense family in
    this slice. MoE paging comes with the MoE port; SSM/hybrid state is
    recurrent (nothing to page); MLA, enc-dec and M-RoPE are follow-ups."""
    if cfg.family != "dense":
        return False, (f"family {cfg.family!r} is not ported to the paged "
                       f"engine yet (ROADMAP A.16)")
    return True, ""


def init_kv_pages(cfg: ModelConfig, *, n_pages: int, page_size: int,
                  device=None) -> List[Dict[str, torch.Tensor]]:
    """Per-segment paged KV stores ``(n_units, 1 + n_pages, ps, KV, dh)``
    in ``cfg.param_dtype``. Index 0 along the page dim is the scratch page
    (PageManager contract); one physical page id addresses the same slot
    in every unit's store."""
    dt = torch_dtype(cfg.param_dtype)
    shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros((s.n,) + shape, dtype=dt, device=device),
             "v": torch.zeros((s.n,) + shape, dtype=dt, device=device)}
            for s in M.build_segments(cfg)]


def _itemsize(cfg) -> int:
    return torch_dtype(cfg.param_dtype).itemsize


def kv_pool_bytes(cfg: ModelConfig, *, n_pages: int, page_size: int) -> int:
    n_units = sum(s.n for s in M.build_segments(cfg))
    return (n_units * n_pages * page_size * cfg.n_kv_heads
            * cfg.resolved_head_dim * 2 * _itemsize(cfg))


def dense_kv_bytes(cfg: ModelConfig, *, n_seqs: int, s_max: int) -> int:
    """What the dense serving loop keeps resident for the same concurrency:
    every sequence owns a full (s_max, KV, dh) strip per unit for its whole
    lifetime, whether it uses it or not."""
    n_units = sum(s.n for s in M.build_segments(cfg))
    return (n_units * n_seqs * s_max * cfg.n_kv_heads
            * cfg.resolved_head_dim * 2 * _itemsize(cfg))


def paged_attention_unit(p, h, cache, lengths, active, page_tables, *,
                         cfg: ModelConfig, window: int, n_heads: int = 0,
                         n_kv: int = 0):
    """A unit's attention output ``o @ wo`` (S,1,d) for its normed input
    ``h``: ``attention.decode_gqa``'s projections and RoPE at each slot's
    length, this step's K/V written into its page before attention (so a
    token sees itself), the paged kernel over the slots' pages.
    ``n_heads`` / ``n_kv`` (default: the config's) are a tensor-parallel
    shard's heads, ``p`` its blocks and ``cache`` its KV heads' pool."""
    n_heads, n_kv = n_heads or cfg.n_heads, n_kv or cfg.n_kv_heads
    q, k_new, v_new = attn._qkv(p, h, n_heads, n_kv, cfg.resolved_head_dim)
    pos = lengths[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k_new = apply_rope(k_new, pos, cfg.rope_theta)
    pa.write_kv(cache, k_new[:, 0], v_new[:, 0], page_tables, lengths,
                active)
    o = pa.paged_attention(q, cache, page_tables, lengths, window=window)
    return o.reshape(h.shape[0], 1, -1) @ p["wo"]


def make_paged_decode_step(cfg: ModelConfig, tp=None):
    """The engine's device step. With ``tp`` (a ``parallel.tensor.
    TPDecode``) ``params`` is the local shards' blocks and ``caches`` one
    pool per local model shard (``TPDecode.n_caches``), each holding that
    shard's KV heads of every page; each data shard runs its block of the
    slots (``TPDecode.rows``), the kernel launched on its pool with the
    shard's query heads."""
    ok, why = supports_paged(cfg)
    if not ok:
        raise NotImplementedError(f"{cfg.name}: {why}")
    segs = M.build_segments(cfg)

    def unit_step(p, x1, cache, lengths, active, page_tables, *, window):
        # mirrors model decode_unit / attention.decode_gqa op for op
        h = apply_norm(p["ln1"], x1, cfg.norm)
        a = paged_attention_unit(p["attn"], h, cache, lengths, active,
                                 page_tables, cfg=cfg, window=window)
        return M.add_residual(p, x1, a, cfg)

    def step(params, caches, tokens, lengths, active, page_tables):
        x1 = M.embed_tokens(params, cfg, tokens[:, None])
        for s, sp, cache in zip(segs, params["segments"], caches):
            for i in range(s.n):
                x1 = unit_step(M.unit(sp, i), x1, M.unit(cache, i), lengths,
                               active, page_tables, window=s.window)
        logits = M.logits_fn(params, cfg, x1)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, caches

    if tp is None:
        return step

    def tp_step(params, caches, tokens, lengths, active, page_tables):
        def attend(c, i, p, h):
            lo, hi = c["rows"]
            return paged_attention_unit(
                p, h, M.unit(caches[i][c["s"]], c["u"]), lengths[lo:hi],
                active[lo:hi], page_tables[lo:hi], cfg=cfg,
                window=c["window"], n_heads=tp.n_heads, n_kv=tp.n_kv)

        return tp.next_tokens(params, tokens[:, None], attend), caches

    return tp_step


def _pct(vals, q):
    if not vals:
        return float("nan")
    return float(np.percentile(np.asarray(vals, np.float64), q))


class ServeEngine:
    """Ties the page manager, scheduler and paged step together.

    ``eos_id`` defaults to ``cfg.eos_id``; pass ``None`` to disable EOS.
    ``device`` defaults to CUDA and raises when there is none; the
    parameters must already be on it. With ``shards`` (a
    ``parallel.tensor.ShardGroup``) ``params`` is a list of the local
    model shards' blocks (``tensor.serve_index``) and the step runs
    tensor-parallel (``make_paged_decode_step``); every rank runs the same
    page manager and scheduler, host code that reads only the tokens all
    ranks share, so the admissions are the one-card engine's. With
    ``placement="2d"`` ``params`` is instead the ``{keystr: [[block]]}``
    parts of the training placement (``TPDecode``'s 2-D form).
    """

    def __init__(self, params, cfg: ModelConfig, *, max_seqs: int,
                 page_size: int, n_pages: int, max_pages_per_seq: int,
                 eos_id: Any = "cfg", policy: str = "continuous",
                 metrics=None, span=None, device=None, shards=None,
                 placement: str = "serve"):
        ok, why = supports_paged(cfg)
        if not ok:
            raise NotImplementedError(f"{cfg.name}: {why}")
        self.device = resolve_device(device)
        self.tp = None
        self.kv_cfg, n_pools = cfg, 1
        at = None
        if shards is not None:
            from repro_torch.parallel.tensor import TPDecode

            self.tp = TPDecode(cfg, shards, placement=placement)
            self.kv_cfg, n_pools = self.tp.shard_config(), self.tp.n_caches
            if placement == "2d":
                at = params["['embed']"][0][0].device
            elif len(params) != len(shards.model.local):
                raise ValueError(f"{len(params)} block trees for "
                                 f"{len(shards.model.local)} model shards")
        self.n_pools = n_pools
        at = at or M.params_device(params[0] if self.tp else params)
        if at.type != self.device.type:
            raise ValueError(f"params are on {at}, the engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.pages = PageManager(n_pages, page_size, max_seqs,
                                 max_pages_per_seq)
        self.sched = Scheduler(self.pages, max_seqs=max_seqs,
                               eos_id=(cfg.eos_id if eos_id == "cfg"
                                       else eos_id),
                               policy=policy)
        pools = [init_kv_pages(self.kv_cfg, n_pages=n_pages,
                               page_size=page_size, device=self.device)
                 for _ in range(n_pools)]
        self.caches = pools if self.tp else pools[0]
        self._fn = make_paged_decode_step(cfg, self.tp)
        self.step_count = 0
        self.device_steps = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self._metrics = metrics
        self._span = (span if span is not None
                      else (lambda name, **kw: contextlib.nullcontext()))
        self._rid = 0

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new: int, arrival: int = 0) -> Request:
        prompt = [int(t) for t in prompt]
        total = len(prompt) + int(max_new)
        cap = self.pages.max_pages_per_seq * self.page_size
        if total > cap:
            raise ValueError(f"request needs {total} tokens > "
                             f"max_pages_per_seq*page_size = {cap}")
        req = Request(rid=self._rid, prompt=prompt, max_new=int(max_new),
                      arrival=int(arrival))
        self._rid += 1
        self.sched.submit(req)
        return req

    # -- stepping ----------------------------------------------------------
    def _to_device(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def step(self) -> bool:
        """One engine iteration (admit -> plan -> device step -> commit).
        Returns False when there is nothing left to do."""
        sched = self.sched
        if not sched.has_work():
            return False
        with self._span("admit"):
            sched.admit_ready(self.step_count, time.monotonic())
        plan = sched.plan_step()
        if plan is None:
            # every remaining request arrives in the future: tick the clock
            self.step_count += 1
            return True
        tokens, lengths, active = plan
        with self._span("device_step", n_active=int(active.sum())):
            nxt, self.caches = self._fn(
                self.params, self.caches, self._to_device(tokens),
                self._to_device(lengths), self._to_device(active),
                self._to_device(self.pages.page_table))
            nxt = nxt.cpu().numpy()
        self.device_steps += 1
        n_prefill = sum(1 for s in sched.slots
                        if s is not None and s.fed < len(s.req.prompt) - 1)
        n_active = int(active.sum())
        self.prefill_tokens += n_prefill
        self.decode_tokens += n_active - n_prefill
        with self._span("commit"):
            sched.commit(nxt, self.step_count, time.monotonic())
        if self._metrics is not None:
            m = self._metrics
            m.counter("repro_serve_steps").inc()
            m.counter("repro_serve_prefill_tokens").inc(n_prefill)
            m.counter("repro_serve_decode_tokens").inc(n_active - n_prefill)
            m.gauge("repro_serve_pages_in_use").set(self.pages.used_pages)
            m.gauge("repro_serve_waiting").set(len(sched.waiting))
        self.step_count += 1
        return True

    def run(self, max_steps: int = 100_000) -> Dict[str, Any]:
        t0 = time.monotonic()
        while self.step():
            if self.step_count >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} "
                                   f"steps")
        wall = time.monotonic() - t0
        return self.stats(wall)

    # -- reporting ---------------------------------------------------------
    def stats(self, wall_s: float) -> Dict[str, Any]:
        done = self.sched.done
        ttft_steps = [r.first_token_step - r.arrival for r in done
                      if r.first_token_step is not None]
        ttft_ms = [(r.first_token_wall - r.admit_wall) * 1e3 for r in done
                   if r.first_token_wall is not None]
        per_tok_ms = [(r.done_wall - r.first_token_wall) * 1e3
                      / max(1, len(r.generated) - 1) for r in done
                      if r.done_wall is not None and len(r.generated) > 1]
        steps = max(1, self.step_count)
        return {
            "requests_done": len(done),
            "steps": self.step_count,
            "device_steps": self.device_steps,
            "wall_s": wall_s,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "prefill_tok_s": self.prefill_tokens / max(wall_s, 1e-9),
            "decode_tok_s": self.decode_tokens / max(wall_s, 1e-9),
            "decode_tok_per_step": self.decode_tokens / steps,
            "ttft_steps_p50": _pct(ttft_steps, 50),
            "ttft_steps_p99": _pct(ttft_steps, 99),
            "ttft_ms_p50": _pct(ttft_ms, 50),
            "ttft_ms_p99": _pct(ttft_ms, 99),
            "per_token_ms_p50": _pct(per_tok_ms, 50),
            "per_token_ms_p99": _pct(per_tok_ms, 99),
            "admission_fingerprint": self.sched.admission_fingerprint(),
            "admission_deferrals": self.sched.deferred,
            "peak_pages_used": self.pages.peak_pages_used,
            "pages_in_use": self.pages.used_pages,
            "kv_pool_bytes": self.kv_pool_bytes(),
            "kv_peak_bytes": self.kv_resident_bytes(
                self.pages.peak_pages_used),
            "dense_equiv_bytes": self.dense_equiv_bytes(),
        }

    # (the bytes this process holds: its shards' pools)
    def kv_pool_bytes(self) -> int:
        return self.n_pools * kv_pool_bytes(
            self.kv_cfg, n_pages=self.n_pages, page_size=self.page_size)

    def kv_resident_bytes(self, n_used: int) -> int:
        return self.n_pools * kv_pool_bytes(
            self.kv_cfg, n_pages=n_used, page_size=self.page_size)

    def dense_equiv_bytes(self) -> int:
        return self.n_pools * dense_kv_bytes(
            self.kv_cfg, n_seqs=self.pages.max_seqs,
            s_max=self.pages.max_pages_per_seq * self.page_size)
