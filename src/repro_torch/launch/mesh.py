"""Production mesh construction (port of ``repro.launch.mesh``).

``make_production_mesh`` and ``make_smoke_mesh`` are FUNCTIONS (never
module-level state), so importing this module touches no process group
and no device. Both call ``init_device_mesh``, which needs an
initialized ``torch.distributed`` process group of the mesh's size
(``init_process_group`` with its address, world size and rank: nothing
on a machine announces a cluster). Single-pod: 16x16 (data, model).
Multi-pod: 2x16x16 (pod, data, model); the ``pod`` axis carries data
parallelism across pods (gradient all-reduce crosses pods; TP/EP stay
inside a pod). ``fake_world`` gives that group for a dry run: rank 0
of a ``fake`` group of the mesh's size.
"""
from __future__ import annotations

import contextlib


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(world_size: int):
    """Rank 0 of a ``fake`` process group of ``world_size`` ranks, torn
    down on exit. Its collectives return outputs of the right shape and
    move no data (no NCCL, no buffers of its own): one process runs or
    traces rank 0's share of a mesh of that size, on the CPU or on one
    card. An initialized group is an error (one group a process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    _forget_shardings()
    try:
        yield
    finally:
        dist.destroy_process_group()
        _forget_shardings()


def _forget_shardings() -> None:
    """Empty DTensor's sharding-propagation caches (Python's, this
    thread's, and C++'s where torch has one). A cached op's output spec
    holds the mesh it was computed on, and a mesh of a later group
    compares equal to one of the same shape and names of an earlier,
    destroyed group: without this, an op of the new group's step could
    run on the old group's mesh, whose process groups no longer
    resolve."""
    import torch
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding
    for clear in (getattr(prop, "cache_clear", None),
                  getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None)):
        if clear is not None:
            clear()


def production_shape(multi_pod: bool) -> tuple:
    """(shape, axis names) of the production mesh."""
    return (((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else ((16, 16), ("data", "model")))


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
