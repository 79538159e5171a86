"""ray_tpu_torch.data — streaming datasets (port of `ray_tpu.data`).

Lazy plans over columnar numpy blocks, executed as a streaming executor
on the port's runtime: stages run as thread or process tasks (or a pool
of thread or process actors) over object-store block refs, submission is
windowed in blocks
and bytes, and per-consumer splits pass refs so each gang rank fetches
its own blocks; `iter_torch_batches` and `lm_batch_iterator` land
batches on the card through a device-prefetch window.
"""

from .block import (  # noqa: F401
    Block,
    batches_from_blocks,
    block_concat,
    block_from_items,
    block_num_rows,
    block_slice,
    block_to_items,
)
from .dataset import (  # noqa: F401
    ActorPoolStrategy,
    DataContext,
    DataIterator,
    Dataset,
    DeviceBatch,
    from_generator,
    from_items,
    from_numpy,
    range,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_npy,
    read_parquet,
    read_text,
    read_tfrecord,
)
from .executor import BlockPrefetcher, StreamStats  # noqa: F401
from .lm import lm_batch_iterator, pack_tokens  # noqa: F401
