"""The DiLoCoX process mesh (port of ``make_cluster_mesh`` and ``describe``
from ``repro.launch.mesh``).

``make_cluster_mesh`` lays the ranks of the initialized default process
group out as ("clusters", "data", "model"), row-major, with
``torch.distributed.device_mesh.init_device_mesh``: the ranks of one
"clusters" group share a data index and meet only in the outer step (the
slow links), the ranks of one "data" group share a cluster. Under the
pipeline-parallel engine (``launch/train.py --inner pp``) the "model"
axis holds a cluster's stages, one rank each; under the gspmd engine
it holds a cluster's tensor-parallel shards (``parallel/tensor.py``). The
production and serving meshes (a pod axis, the serving flattening) wait
for multi-card serving (ROADMAP A.11c).
"""
from __future__ import annotations


def make_cluster_mesh(n_clusters: int, data: int = 1, model: int = 1, *,
                      device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (n_clusters, data, model) over the default
    process group, whose world size must be their product."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_clusters, data, model),
                            mesh_dim_names=("clusters", "data", "model"))


def describe(mesh) -> str:
    return f"{dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))}"
