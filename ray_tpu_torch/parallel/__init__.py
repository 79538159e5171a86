"""ray_tpu_torch.parallel — meshes over the ranks of a torch.distributed
job (or, for TP serving, over this process's devices), sharding rules,
collectives, the explicit FSDP / TP / EP collectives that stand in for
GSPMD (`spmd.py`), the pipeline schedules over pp (`pipeline.py`) and
the cross-slice state replicator (`dcn.py`) (port of `ray_tpu.parallel`)."""

from .collectives import (  # noqa: F401
    CollectiveGroup,
    Wire,
    all_to_all,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    dp_sync_bytes,
    get_group,
    init_collective_group,
    reducescatter,
    shift,
)
from .dcn import CrossSliceReplicator, fetch_replica  # noqa: F401
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
from .spmd import ModelSharding, VocabShard  # noqa: F401
from .pipeline import (  # noqa: F401
    create_pp_train_state,
    make_pp_loss_and_grad,
    make_pp_loss_and_grad_1f1b,
    make_pp_loss_fn,
    make_pp_train_step,
    pp_state_specs,
    spmd_pipeline,
    spmd_pipeline_1f1b,
)
