"""Device-memory subsystem of the PyTorch port: slab arena, per-query
budgets and spill.

The port's copy of the JAX package's ``memory/``:

* :mod:`.arena` — size-class slab pool (identity reuse of freed slabs),
  a pooled zeros cache and accounting reservations for transient
  buffers (the join's pair expansion, shuffle buckets); per-device
  bytes-in-use and high-water gauges.
* :mod:`.budget` — per-query admission control (:func:`query_budget`
  composes with ``metrics.query_span``), limited by ``SRJT_HBM_BUDGET``
  or the card's memory; strict charges raise :class:`HbmBudgetExceeded`.
* :mod:`.spill` — LRU registry of evictable device residents (the
  join's cached build indexes, staged request tables) that spill to
  pinned host memory under pressure and fault back bit-exactly.

Off by default: the subsystem switches on with ``SRJT_HBM_ARENA=1`` (or
a set ``SRJT_HBM_BUDGET``), and every call site is one bool check away
from the arena-off behavior.
"""

from . import arena, budget, spill  # noqa: F401
from .arena import reserve  # noqa: F401
from .budget import (HbmBudgetExceeded, active, enabled,  # noqa: F401
                     parse_bytes, query_budget, set_enabled)

__all__ = ["arena", "budget", "spill", "HbmBudgetExceeded", "active",
           "enabled", "parse_bytes", "query_budget", "reserve",
           "set_enabled"]
