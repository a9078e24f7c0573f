"""Adaptive compression controller, the parts the trainer calls (port of
``repro.core.adaptive``, paper Alg. 3): the Alg. 3 rank/H state and
update, the stable-rank estimator of the averaged pseudo-gradient, and the
per-cluster local-step planner ``plan_h``.

The controller arithmetic is host-side python/numpy, copied from the JAX
package; the spectral estimators run in PyTorch on the tensors' device.
Under a gossip topology ``plan_h``'s clamp (``gap_h_floor``) takes the
gap of the round's masked mixing matrix,
``topology.mixing.MixingMatrix.metropolis(topo, alive).spectral_gap(alive)``.
The simulator's ``AdaptiveController`` and ``AdaptiveSpec`` are not ported
yet (ROADMAP A.14, item 3).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.compression import matrix_shape, to_matrix


def stable_rank(mat, iters: int = 8):
    """||M||_F^2 / sigma_max(M)^2 via power iteration; in [1, min(m,n)]."""
    M = to_matrix(mat).float()
    m, n = M.shape
    v = torch.ones((n,), dtype=torch.float32, device=M.device) / (n ** 0.5)
    s = None
    for _ in range(iters):
        u = M @ v
        u = u / (torch.linalg.norm(u) + 1e-12)
        v = M.T @ u
        s = torch.linalg.norm(v)
        v = v / (s + 1e-12)
    fro2 = torch.sum(M * M)
    return fro2 / (s ** 2 + 1e-12)


def tree_effective_rank(tree, max_mats: int = 8):
    """Mean stable rank over the largest 2-D params (representative set)."""
    leaves = [(int(np.prod(x.shape)), x) for x in T.leaves(tree)
              if x.dim() >= 2 and min(matrix_shape(tuple(x.shape))) >= 8]
    leaves.sort(key=lambda t: -t[0])
    mats = [x for _, x in leaves[:max_mats]]
    if not mats:
        return torch.ones(())
    return torch.mean(torch.stack([stable_rank(m) for m in mats]))


@dataclass
class AdaGradCmpConfig:
    window: int = 5                # c
    r1: int = 64                   # initial rank
    h1: int = 125                  # initial local steps
    h_min: int = 8
    r_min: int = 4
    mode: str = "paper"            # paper | overlap


@dataclass
class AdaGradCmpState:
    r_hist: List[float] = field(default_factory=list)
    t: int = 0
    r_t: int = 0
    h_t: int = 0

    @classmethod
    def create(cls, cfg: AdaGradCmpConfig):
        return cls(r_hist=[], t=0, r_t=cfg.r1, h_t=cfg.h1)


def adagradcmp_update(state: AdaGradCmpState, r_prime_t: float,
                      cfg: AdaGradCmpConfig) -> AdaGradCmpState:
    """One controller step (Alg. 3), host-side (runs once per outer step)."""
    hist = (state.r_hist + [float(r_prime_t)])[-cfg.window:]
    t = state.t + 1
    if t < cfg.window:
        r_t, h_t = cfg.r1, cfg.h1
    else:
        r_t = max(cfg.r_min, int(round(float(np.mean(hist)))))
        r_t = min(r_t, cfg.r1)
        if cfg.mode == "paper":
            alpha = (cfg.r1 - r_t) / cfg.r1            # Alg. 3 verbatim
            h_t = max(cfg.h_min, int(round(cfg.h1 * alpha)))
        else:                                          # "overlap" correction
            h_t = max(cfg.h_min, int(round(cfg.h1 * r_t / cfg.r1)))
    return AdaGradCmpState(r_hist=hist, t=t, r_t=r_t, h_t=h_t)


def _quantized_rank(r_prime) -> float:
    """Host-side quantization of the r'_t float: a last-ulp difference
    between independently jitted producers must never flip the integer
    rank the controller rounds to."""
    return round(float(r_prime), 6)


def observe_mean_pseudo_grad(state: AdaGradCmpState, mean_pending,
                             cfg: AdaGradCmpConfig) -> AdaGradCmpState:
    """One Alg. 3 driver step from the realized averaged pseudo-gradient;
    its effective rank is the r'_t signal."""
    return adagradcmp_update(
        state, _quantized_rank(tree_effective_rank(mean_pending)), cfg)


# ---------------------------------------------------------------------------
# heterogeneous local-step scheduling: the per-cluster H leg
# ---------------------------------------------------------------------------

H_POLICIES = ("global", "balance")


@dataclass(frozen=True)
class HSpec:
    """Per-cluster local-step policy (JSON-able, embeddable in
    ``sim.Scenario``).

    The outer sync is a barrier on the slowest alive cluster, so a single
    global H makes every fast cluster idle for ``H*(t_slow - t_own)``
    seconds per round on heterogeneous hardware.  ``policy="balance"``
    sets each cluster's H from its *measured* step time so everyone lands
    near the barrier together: the fastest cluster keeps the full
    ``h_base`` budget and slower sites do proportionally fewer local
    steps (never more than ``h_base`` — the numeric legs mask a
    fixed-length scan, see ``core.diloco.masked_local_steps``).

    Under gossip topologies heterogeneous H is not free: a cluster that
    trains less drifts less per round, and the mixing graph only contracts
    the resulting disagreement at its spectral gap ``1 - |lambda_2|``.
    ``gap_clamp`` therefore floors every cluster's H at
    ``ceil(h_base * (1 - gap))`` — the slower the mixing, the closer the
    schedule must stay to uniform, so slow mixing cannot silently buy
    replica disagreement (the certificate is the masked mixing matrix's
    measured gap, quantized like the Alg. 3 rank signal).
    """
    policy: str = "balance"        # global | balance
    h_min: int = 1                 # hard floor (stragglers keep training)
    gap_clamp: bool = True         # gossip: clamp spread by spectral gap

    def __post_init__(self):
        if self.policy not in H_POLICIES:
            raise ValueError(f"h policy {self.policy!r} not in {H_POLICIES}")
        if self.h_min < 1:
            raise ValueError(f"h_min must be >= 1, got {self.h_min}")

    @property
    def active(self) -> bool:
        return self.policy != "global"

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "HSpec":
        return HSpec(**d)


def gap_h_floor(spec: Optional["HSpec"], h_base: int,
                spectral_gap: Optional[float]) -> int:
    """The gossip clamp: minimum per-cluster H allowed by the mixing
    matrix's spectral-gap certificate (``h_base`` itself when no gap is
    given, i.e. gather topologies realize the exact mean and never clamp).
    The gap is quantized before the arithmetic so a last-ulp difference
    between the two backends' eigensolves can never flip the floor."""
    floor = max(1, int(spec.h_min)) if spec is not None else 1
    if spec is not None and spec.gap_clamp and spectral_gap is not None:
        gap = min(1.0, max(0.0, round(float(spectral_gap), 6)))
        floor = max(floor, int(np.ceil(h_base * (1.0 - gap) - 1e-9)))
    return min(floor, int(h_base))


def plan_h(spec: Optional["HSpec"], h_base: int, t_steps: Sequence[float],
           alive: np.ndarray,
           spectral_gap: Optional[float] = None) -> Dict[int, int]:
    """One round's per-cluster local-step schedule: ``{cluster: h_c}`` over
    the alive set.

    ``balance`` anchors the round's compute target at the *fastest* alive
    cluster's full budget, ``T = h_base * min(t_c)``, and gives every
    cluster ``h_c = round(T / t_c)`` clamped to
    ``[max(h_min, gap floor), h_base]`` — slow sites do fewer local steps
    and the barrier tightens to ~T instead of ``h_base * max(t_c)``.
    Round-to-nearest (not floor) is what keeps the modeled barrier waste
    never above the global-H schedule's: a cluster whose ideal count
    rounds up to ``h_base`` simply reproduces the global schedule.

    Host-side python/numpy on the deterministic modeled step times — the
    ONE implementation both simulator backends call with identical inputs
    (same discipline as ``AdaptiveController.decide``), so the proc
    backend's broadcast H schedule cannot drift from the in-process one.
    Uniform step times produce the uniform ``h_base`` vector, which the
    numeric legs execute bit-for-bit identically to the scalar-H path.
    """
    alive = np.asarray(alive, bool)
    ids = [int(i) for i in np.flatnonzero(alive)]
    h_base = int(h_base)
    if spec is None or not spec.active or not ids:
        return {c: h_base for c in ids}
    floor = gap_h_floor(spec, h_base, spectral_gap)
    t_ref = min(float(t_steps[c]) for c in ids)
    target = h_base * t_ref
    out: Dict[int, int] = {}
    for c in ids:
        t_c = float(t_steps[c])
        h_c = h_base if t_c <= 0 else int(np.floor(target / t_c + 0.5))
        out[c] = max(floor, min(h_base, h_c))
    return out
