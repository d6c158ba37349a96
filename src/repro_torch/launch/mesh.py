"""Production and debug meshes of the port (``repro.launch.mesh``).

Defined as FUNCTIONS so importing this module never touches the process
group.  A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh`
with the reference's shapes and axis names over the world of an
initialized process group (:func:`repro_torch.launch.cluster.init_cluster`
or the caller's own ``init_process_group``); its layout alone, for the
placement rules of :mod:`repro_torch.sharding`, needs no process group.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.sharding import MeshLayout

__all__ = ["production_layout", "make_production_mesh", "make_debug_mesh"]


def production_layout(*, multi_pod: bool = False) -> MeshLayout:
    """16x16 = 256 devices per pod; 2 pods = 512 with a leading 'pod' axis.
    Axis meanings: 'pod' + 'data' carry FSDP/DP, 'model' carries TP/EP."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh over a world of 256 (or 512) ranks."""
    lay = production_layout(multi_pod=multi_pod)
    return init_device_mesh(resolve_device(device).type, lay.dims,
                            mesh_dim_names=lay.axis_names)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0, *,
                    device="cuda"):
    """Small mesh for multi-process tests: (data, model), or (pod, data,
    model) when ``pod``; the world size must be its number of devices."""
    if pod:
        shape, names = (pod, data, model), ("pod", "data", "model")
    else:
        shape, names = (data, model), ("data", "model")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)
