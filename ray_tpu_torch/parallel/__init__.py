"""ray_tpu_torch.parallel — meshes over the ranks of a torch.distributed
job, sharding rules and collectives (port of `ray_tpu.parallel`; `dcn.py`
comes with a later part of ROADMAP A4, the pipeline schedule with A7)."""

from .collectives import (  # noqa: F401
    CollectiveGroup,
    Wire,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    dp_sync_bytes,
    get_group,
    init_collective_group,
    reducescatter,
)
from .mesh import (  # noqa: F401
    AXIS_ORDER,
    DATA_AXES,
    Mesh,
    MeshRegistry,
    MeshSpec,
    NamedSharding,
    PartitionSpec,
    build_mesh,
    data_sharding,
    mesh_registry,
    replicated,
    single_device_mesh,
)
from .sharding import (  # noqa: F401
    P,
    default_rules,
    logical_to_spec,
    override_rules,
    path_specs,
    shard_tree,
    tree_shardings,
    tree_specs,
    validate_divisibility,
)
