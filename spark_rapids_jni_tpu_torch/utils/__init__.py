"""Host and device helpers of the PyTorch port."""

from . import bitmask, tracing  # noqa: F401
