"""Host-side batch assembly (counterpart of the JAX package's
``runtime/``); only the numpy gather the training path uses so far."""

from .loader import gather_windows, gather_windows_into  # noqa: F401
