"""Streaming ingest + incremental query maintenance.

The port's counterpart of the JAX package's ``stream/``.  Append-only
fact tables version through :class:`DeltaTable` (epoch counter +
per-file row-group watermark); registered aggregate views refresh in
O(delta) by decoding only appended row groups and merging partial
aggregate states (:mod:`..ops.groupby`) instead of rescanning.
"""

from .delta import DeltaTable
from .view import MaterializedView, ViewRegistry

__all__ = ["DeltaTable", "MaterializedView", "ViewRegistry"]
