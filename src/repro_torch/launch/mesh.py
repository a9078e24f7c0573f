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
``{axis: size}`` mapping that ``parallel/sharding.py`` takes as a mesh;
``make_cluster_mesh`` and ``make_serving_mesh`` derive the training and
serving views of such a mapping as the JAX functions do (the dry-run,
``launch/dryrun.py``).
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


def make_cluster_mesh(base, data: int = 1, model: int = 1, *,
                      n_clusters=None, device_type: str = "cuda"):
    """The DiLoCoX view ("clusters", "data", "model").

    ``base`` an ``{axis: size}`` mapping (the JAX function on a production
    mesh): a multi-pod base's pods are the clusters (the slow links cross
    pods only); a single-pod base's "data" axis splits into (clusters,
    data), by default 2 clusters: ``{"data": 16, "model": 16}`` ->
    ``{"clusters": 2, "data": 8, "model": 16}``.

    ``base`` an int: a ``DeviceMesh`` of shape (base, data, model) over
    the default process group, whose world size must be their product."""
    if isinstance(base, Mapping):
        if "pod" in base:
            if n_clusters not in (None, base["pod"]):
                raise ValueError("multi-pod clusters == pods")
            return {"clusters": base["pod"], "data": base["data"],
                    "model": base["model"]}
        n_clusters = n_clusters or 2
        if base["data"] % n_clusters:
            raise ValueError(f"data axis {base['data']} not divisible by "
                             f"{n_clusters} clusters")
        return {"clusters": n_clusters, "data": base["data"] // n_clusters,
                "model": base["model"]}
    from torch.distributed.device_mesh import init_device_mesh

    n_clusters = base

    return init_device_mesh(device_type, (n_clusters, data, model),
                            mesh_dim_names=("clusters", "data", "model"))


def describe(mesh) -> str:
    if isinstance(mesh, Mapping):
        return f"{dict(mesh)}"
    return f"{dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))}"
