"""Query models of the PyTorch port."""

from . import q6  # noqa: F401
