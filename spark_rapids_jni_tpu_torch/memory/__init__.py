"""Device-memory accounting of the PyTorch port: per-query budgets and
spill.

The port's copy of the JAX package's ``memory/``, so far without its
slab arena (``memory/arena.py``):

* :mod:`.budget` — per-query admission control (:func:`query_budget`
  composes with ``metrics.query_span``), limited by ``SRJT_HBM_BUDGET``
  or the card's memory; strict charges raise :class:`HbmBudgetExceeded`.
* :mod:`.spill` — LRU registry of evictable device residents that spill
  to pinned host memory under pressure and fault back bit-exactly.

Off by default: the ledger switches on with ``SRJT_HBM_BUDGET``.
"""

from . import budget, spill  # noqa: F401
from .budget import (HbmBudgetExceeded, active, enabled,  # noqa: F401
                     parse_bytes, query_budget, set_enabled)

__all__ = ["budget", "spill", "HbmBudgetExceeded", "active", "enabled",
           "parse_bytes", "query_budget", "set_enabled"]
