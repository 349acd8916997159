"""Production meshes, the counterpart of ``repro/launch/mesh.py``.  Functions,
not module-level constants: importing this module touches no process
group.  Each needs ``torch.distributed`` initialized with the mesh's world
size (a fake process group for a dry run)."""
from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 devices a pod ``("data", "model")``; multi-pod adds a
    leading ``"pod"`` axis (2 pods = 512 devices, pure DP across pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_snn_mesh(k: int, device_type: str = "cuda"):
    """1-D partition mesh for the distributed SNN simulator."""
    return init_device_mesh(device_type, (k,), mesh_dim_names=("parts",))
