"""Serializable quadratic test problem for the simulator (port of
``repro.sim.quadratic``).

``QuadraticSpec`` builds the tiny per-cluster least-squares instance from
a JSON-able description, so a process that knows only ``to_dict()`` can
rebuild the same problem:

 - ``spec.problem()``          -> the in-process ``NumericProblem``, what
   ``simulate(sc, numeric=...)`` consumes;
 - ``spec.one_cluster_fn()``   -> the single-cluster H-step inner function
   (what one cluster's worker runs);
 - ``spec.init_params()``      -> deterministic initial global params.

The arrays come from a ``torch.Generator`` seeded by ``spec.seed`` on the
host (the JAX package draws them from ``jax.random`` threefry, another
stream); they are drawn on the CPU and moved, so a problem on the card and
one on the CPU start from the same bits.  Parity tests carry the JAX
package's arrays in by overriding ``_arrays`` on a subclass.

Clusters run one after another (no vmap), each through the same
``one_cluster`` function, so row c of ``problem()``'s stacked result is bit
for bit what ``one_cluster_fn()`` gives for cluster c alone.  The inner
functions update the stacked inner-optimizer state in place, row by row,
as ``train.trainer.make_inner_fn`` does.  ``problem()`` and
``init_params()`` run on CUDA unless ``device="cpu"`` is passed
(``repro_torch.device``).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import diloco
from repro_torch.device import resolve_device
from repro_torch.optim import adamw


@dataclass(frozen=True)
class QuadraticSpec:
    """Cluster c minimizes 0.5*||W - T_c||^2 with T_c = T* + hetero*off_c.
    Cheap enough for tier-1, but it exercises the full round machinery
    (AdamW inner, Nesterov outer, compression round-trips, error feedback,
    one-step delay)."""
    n_clusters: int
    d: int = 16
    n_mats: int = 2
    h_steps: int = 8
    inner_lr: float = 3e-2
    hetero: float = 0.1
    seed: int = 0
    outer_lr: float = 0.7
    outer_momentum: float = 0.5

    # ---- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "quadratic", **asdict(self)}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "QuadraticSpec":
        d = dict(d)
        if d.pop("kind", "quadratic") != "quadratic":
            raise ValueError(f"unknown problem kind {d!r}")
        return QuadraticSpec(**d)

    # ---- deterministic construction ---------------------------------------
    def _arrays(self):
        """(params, target, offsets): dicts of f32 CPU tensors, drawn in
        that order from one generator seeded by ``seed``."""
        gen = torch.Generator()
        gen.manual_seed(self.seed)
        shape = (self.d, self.d)
        params = {f"w{i}": 0.5 * torch.randn(shape, generator=gen)
                  for i in range(self.n_mats)}
        target = {k: torch.randn(shape, generator=gen) for k in params}
        offsets = {k: self.hetero * torch.randn((self.n_clusters,) + shape,
                                                generator=gen)
                   for k in params}
        return params, target, offsets

    def _arrays_on(self, device):
        params, target, offsets = self._arrays()
        to = lambda tree: {k: torch.as_tensor(v, dtype=torch.float32)
                           .to(device).clone() for k, v in tree.items()}
        return to(params), to(target), to(offsets)

    def init_params(self, device=None):
        return self._arrays_on(resolve_device(device))[0]

    def cluster_loss_fn(self, device=None):
        _, target, offsets = self._arrays_on(resolve_device(device))

        def cluster_loss(p, c):
            per = [torch.sum((p[k] - (target[k] + offsets[k][c])) ** 2)
                   for k in p]
            return 0.5 * sum(per) / len(per)

        return cluster_loss

    def _step_fn(self, device):
        cluster_loss = self.cluster_loss_fn(device)
        lr = self.inner_lr

        def step(carry, c):
            p, o = carry
            with torch.enable_grad():
                loss = cluster_loss(p, c)
                grads = torch.autograd.grad(loss, T.leaves(p))
            grads = T.unflatten_like(p, list(grads))
            p, o = adamw.update(grads, o, p, lr=lr)
            return (p, o), loss.detach()

        return step

    @staticmethod
    def _local_copy(params_g):
        return T.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                          params_g)

    def one_cluster_fn(self, device=None):
        """(params_global, inner_opt, c) -> (params_H, inner_opt', losses):
        H AdamW steps for one cluster from a copy of ``params_global``;
        ``inner_opt``'s moments are updated in place."""
        step = self._step_fn(resolve_device(device))
        h = self.h_steps

        def one_cluster(params_g, opt_state, c):
            carry = (self._local_copy(params_g), opt_state)
            losses = []
            for _ in range(h):
                carry, loss = step(carry, c)
                losses.append(loss)
            p, o = carry
            return (T.tree_map(lambda x: x.detach(), p), o,
                    torch.stack(losses))

        return one_cluster

    def one_cluster_fn_h(self, device=None):
        """(params_global, inner_opt, c, h) -> (params, opt', mean_loss):
        the per-cluster-H variant, the first ``h`` of ``self.h_steps``
        steps (``core.diloco.masked_local_steps``). With ``h == h_steps``
        the carried state is bit for bit ``one_cluster_fn()``'s."""
        step = self._step_fn(resolve_device(device))
        h_max = self.h_steps

        def one_cluster_h(params_g, opt_state, c, h):
            carry = (self._local_copy(params_g), opt_state)
            (p, o), mean_loss = diloco.masked_local_steps(
                lambda cr, _i: step(cr, c), carry, h_max, h)
            return T.tree_map(lambda x: x.detach(), p), o, mean_loss

        return one_cluster_h

    def problem(self, device=None):
        """The in-process ``NumericProblem``: the clusters' inner legs one
        after another, their results stacked along a leading axis."""
        from repro_torch.sim.simulator import NumericProblem

        device = resolve_device(device)
        params = self.init_params(device)
        cluster_loss = self.cluster_loss_fn(device)
        one_cluster = self.one_cluster_fn(device)
        one_cluster_h = self.one_cluster_fn_h(device)
        n = self.n_clusters

        inner_stacked = T.tree_map(
            lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone(),
            adamw.init(params))

        def row_opt(inner_opt_stacked, c):
            return adamw.AdamWState(
                step=inner_opt_stacked.step[c],
                m=diloco.take_row(inner_opt_stacked.m, c),
                v=diloco.take_row(inner_opt_stacked.v, c))

        def run_rows(inner_opt_stacked, row_fn):
            rows = [row_fn(row_opt(inner_opt_stacked, c), c)
                    for c in range(n)]
            params_s = T.tree_map(lambda *xs: torch.stack(xs),
                                  *[p for p, _, _ in rows])
            opt = adamw.AdamWState(
                step=torch.stack([o.step for _, o, _ in rows]),
                m=inner_opt_stacked.m, v=inner_opt_stacked.v)
            return params_s, opt, torch.stack([a for _, _, a in rows])

        def inner_fn(params_g, inner_opt_stacked, t):
            return run_rows(inner_opt_stacked,
                            lambda o, c: one_cluster(params_g, o, c))

        def inner_fn_stacked(params_stacked, inner_opt_stacked, t):
            # gossip mode: every cluster trains from its OWN params row
            return run_rows(inner_opt_stacked, lambda o, c: one_cluster(
                diloco.take_row(params_stacked, c), o, c))

        def inner_fn_h(params_g, inner_opt_stacked, t, h_vec):
            return run_rows(inner_opt_stacked, lambda o, c: one_cluster_h(
                params_g, o, c, int(h_vec[c])))

        def inner_fn_h_stacked(params_stacked, inner_opt_stacked, t, h_vec):
            return run_rows(inner_opt_stacked, lambda o, c: one_cluster_h(
                diloco.take_row(params_stacked, c), o, c, int(h_vec[c])))

        def eval_fn(p):
            with torch.no_grad():
                return float(np.mean([float(cluster_loss(p, c))
                                      for c in range(n)]))

        return NumericProblem(params=params, inner_opt_stacked=inner_stacked,
                              inner_fn=inner_fn, outer_lr=self.outer_lr,
                              outer_momentum=self.outer_momentum,
                              eval_fn=eval_fn,
                              inner_fn_stacked=inner_fn_stacked,
                              inner_fn_h=inner_fn_h,
                              inner_fn_h_stacked=inner_fn_h_stacked,
                              inner_fn_row=one_cluster)


def make_quadratic_problem(n_clusters: int, *, d: int = 16, n_mats: int = 2,
                           h_steps: int = 8, inner_lr: float = 3e-2,
                           hetero: float = 0.1, seed: int = 0,
                           outer_lr: float = 0.7, outer_momentum: float = 0.5,
                           device=None):
    """Build the spec and return its in-process ``NumericProblem``."""
    return QuadraticSpec(n_clusters=n_clusters, d=d, n_mats=n_mats,
                         h_steps=h_steps, inner_lr=inner_lr, hetero=hetero,
                         seed=seed, outer_lr=outer_lr,
                         outer_momentum=outer_momentum).problem(device)
