"""ray_tpu_torch.experimental — channels and compiled actor graphs.

Port of `ray_tpu.experimental` (reference: python/ray/experimental/channel/
and python/ray/dag/).
"""

from .channel import Channel, ChannelClosedError, ChannelReader  # noqa: F401
from .dag import (  # noqa: F401
    SHM_CHANNEL_CAPACITY,
    ClassMethodNode,
    CompiledDAG,
    DAGNode,
    InputNode,
    MultiOutputNode,
)
from .shm_channel import ShmChannel, ShmChannelReader  # noqa: F401
