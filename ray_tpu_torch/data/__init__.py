"""ray_tpu_torch.data — LM token packing and the device-prefetch batch
feed (ports of `ray_tpu.data.lm` and of `DataContext` /
`_jax_batch_stream` from `ray_tpu.data.dataset`)."""

from .dataset import DataContext, DeviceBatch  # noqa: F401
from .lm import lm_batch_iterator, pack_tokens  # noqa: F401
