"""Topology & gossip-averaging subsystem (port of ``repro.topology``).

Makes the outer-step communication pattern a first-class, pluggable
object: a ``Topology`` (ring / 2D torus / random k-regular / star / full)
yields per-round doubly-stochastic ``MixingMatrix`` weights, and
``mixing_op(topology, alive)`` produces the ``cluster_mean``-shaped
callable ``core.diloco.diloco_round`` consumes — gather kinds reproduce
the seed repo's hub average bit-for-bit, gossip kinds mix each cluster
with its graph neighbors only (NoLoCo-style neighbor averaging).

Graph and accounting arithmetic is numpy (copies of the JAX package's);
the mix operators run in PyTorch on the rows' device.
"""
from repro_torch.topology.accounting import (ComputeLeg, GossipComm,
                                             compute_leg, gossip_round_comm,
                                             round_wire_total)
from repro_torch.topology.graphs import (GATHER_KINDS, GOSSIP_KINDS, KINDS,
                                         Digraph, Topology, as_digraph,
                                         directed_ring, full, make_topology,
                                         ring, random_regular, star, torus)
from repro_torch.topology.mixing import (MixingMatrix, async_mix_weights,
                                         consensus_distance,
                                         consensus_distance_trees, mix_row,
                                         mix_stacked, mixing_op,
                                         push_sum_average, push_sum_round,
                                         push_sum_weights)

__all__ = [
    "Topology", "make_topology", "ring", "torus", "random_regular", "star",
    "full", "KINDS", "GATHER_KINDS", "GOSSIP_KINDS",
    "Digraph", "as_digraph", "directed_ring",
    "MixingMatrix", "mixing_op", "mix_row", "mix_stacked",
    "consensus_distance", "consensus_distance_trees",
    "push_sum_weights", "push_sum_round", "push_sum_average",
    "async_mix_weights",
    "GossipComm", "gossip_round_comm", "round_wire_total",
    "ComputeLeg", "compute_leg",
]
