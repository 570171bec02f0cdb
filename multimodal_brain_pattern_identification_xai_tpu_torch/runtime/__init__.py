"""Host-side batch assembly (counterpart of the JAX package's
``runtime/``): the numpy window gather and epoch batch queue."""

from .loader import (NativeBatchQueue, gather_windows,  # noqa: F401
                     gather_windows_into)
