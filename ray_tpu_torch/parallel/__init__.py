"""ray_tpu_torch.parallel — the mesh vocabulary on one device and the
data-parallel sync accounting (ports of `ray_tpu.parallel.mesh` and
`collectives.dp_sync_bytes`)."""

from .collectives import dp_sync_bytes  # noqa: F401
from .mesh import AXIS_ORDER, DATA_AXES, Mesh, MeshSpec, build_mesh, single_device_mesh  # noqa: F401
