"""The DiLoCoX process meshes (port of ``repro.launch.mesh``).

``make_cluster_mesh`` lays the ranks of the initialized default process
group out as ("clusters", "data", "model"), row-major, with
``torch.distributed.device_mesh.init_device_mesh``: the ranks of one
"clusters" group share a data index and meet only in the outer step (the
slow links), the ranks of one "data" group share a cluster. Under the
pipeline-parallel engine (``launch/train.py --inner pp``) the "model"
axis holds a cluster's stages, one rank each; under the gspmd engine
it holds a cluster's tensor-parallel shards (``parallel/tensor.py``).

``make_production_mesh`` is the JAX package's 256- or 512-device
production mesh. No process group here has that many ranks, so it is the
``{axis: size}`` mapping that ``parallel/sharding.py`` takes as a mesh.
``make_serving_mesh`` flattens a "pod" axis into "data": serving has no
cluster boundary. It takes such a mapping or a ranks' ``DeviceMesh``;
``launch/serve.py`` lays its ranks out as ("data", "model") with it.
"""
from __future__ import annotations

from collections.abc import Mapping


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """{"data": 16, "model": 16}, or with ``multi_pod`` {"pod": 2, "data":
    16, "model": 16}: the JAX function's axes and shape."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_serving_mesh(base):
    """("data", "model"): a "pod" axis flattened into "data". ``base`` is
    an ``{axis: size}`` mapping (gives one) or a ``DeviceMesh`` of 2 or 3
    dims (gives one over the same ranks, in the same order; every rank of
    ``base`` must call it, as it makes new process groups)."""
    if isinstance(base, Mapping):
        if "pod" in base:
            return {"data": base["pod"] * base["data"], "model": base["model"]}
        return {"data": base["data"], "model": base["model"]}
    from torch.distributed.device_mesh import DeviceMesh

    ranks = base.mesh
    if ranks.dim() == 3:
        p, d, m = ranks.shape
        ranks = ranks.reshape(p * d, m)
    elif tuple(base.mesh_dim_names) == ("data", "model"):
        return base
    return DeviceMesh(base.device_type, ranks,
                      mesh_dim_names=("data", "model"))


def make_cluster_mesh(n_clusters: int, data: int = 1, model: int = 1, *,
                      device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (n_clusters, data, model) over the default
    process group, whose world size must be their product."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_clusters, data, model),
                            mesh_dim_names=("clusters", "data", "model"))


def describe(mesh) -> str:
    return f"{dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))}"
