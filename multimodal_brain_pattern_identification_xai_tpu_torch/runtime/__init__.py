"""Host-side batch assembly (counterpart of the JAX package's
``runtime/``): the C++ host library's window and multimodal gathers and
its epoch batch queue, with plain numpy versions beside them."""

from .loader import (NativeBatchQueue, batch_queue_numpy,  # noqa: F401
                     epoch_order, gather_multimodal, gather_multimodal_numpy,
                     gather_windows, gather_windows_into,
                     gather_windows_numpy, native_available)
