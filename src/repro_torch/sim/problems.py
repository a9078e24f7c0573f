"""Problem-kind registry for the simulator (port of ``repro.sim.problems``).

A numeric problem crosses a process boundary as a JSON dict with a
``kind`` discriminator (``spec.to_dict()``, the JAX package's format).
``problem_from_dict`` rebuilds its spec; ``xla_device_count`` keeps the
JAX package's name because it reads the same dict: the number of devices
the hosting process needs for the problem (1 = no pipeline mesh).

The pipeline-parallel language-model problem (``kind == "pp_lm"``, the
JAX package's ``sim/pp_problem.py`` ``PPSpec``) is ROADMAP A.14 item 4.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.sim.quadratic import QuadraticSpec


def problem_from_dict(d: Dict[str, Any]):
    """Rebuild a problem spec from its ``to_dict()`` payload."""
    kind = d.get("kind", "quadratic")
    if kind == "quadratic":
        return QuadraticSpec.from_dict(d)
    if kind == "pp_lm":
        raise NotImplementedError(
            "problem kind 'pp_lm' (PPSpec, the JAX package's "
            "sim/pp_problem.py) is not ported yet: ROADMAP A.14 item 4")
    raise ValueError(f"unknown problem kind {kind!r}")


def xla_device_count(d: Dict[str, Any]) -> int:
    """Devices the hosting process needs for this problem dict (1 = no
    pipeline mesh)."""
    if d.get("kind") == "pp_lm":
        return int(d.get("data_parallel", 1)) * int(d.get("n_stages", 1))
    return 1
