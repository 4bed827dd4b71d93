"""Production mesh construction (port of ``repro.launch.mesh``).

``make_production_mesh`` and ``make_smoke_mesh`` are FUNCTIONS (never
module-level state), so importing this module touches no process group
and no device. Both call ``init_device_mesh``, which needs an
initialized ``torch.distributed`` process group of the mesh's size
(``init_process_group`` with its address, world size and rank: nothing
on a machine announces a cluster). Single-pod: 16x16 (data, model).
Multi-pod: 2x16x16 (pod, data, model); the ``pod`` axis carries data
parallelism across pods (gradient all-reduce crosses pods; TP/EP stay
inside a pod).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_smoke_mesh(devices: int | None = None, device_type: str = "cpu"):
    """Tiny (data, model) mesh over the process group's ranks (or
    ``devices`` of them): model 4, 2 or 1, whichever divides first."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = devices or dist.get_world_size()
    model = 1
    for cand in (4, 2, 1):
        if n % cand == 0:
            model = cand
            break
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> dict:
    """{axis: size} of a ``DeviceMesh``, or of an {axis: size} dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {name: mesh.size(i)
            for i, name in enumerate(mesh.mesh_dim_names or ())}
