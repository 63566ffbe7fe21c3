"""Cardinality statistics feeding the join-reorder rule.

Two sources, in priority order:

1. **Exact observations**: the executor (``plan/lower.py``) records every
   plan node's output row count (static shapes make this free) keyed by
   the node's structural fingerprint.  Recurring queries — the serving
   workload — reorder from exact cardinalities on the second sighting.
2. **Metrics priors**: for join-shaped nodes never seen before, fall back
   to the process-wide ``join.match_rows`` histogram that
   ``utils/metrics.py`` collects on every join while metrics are on — a
   coarse prior, but enough to rank a filtered dimension against an
   unfiltered one.

When neither source knows a subtree, ``rows_for`` returns ``None`` and
the reorder rule rejects (a deliberate no-op: never reorder blind).

With ``SRJT_PLAN_STATS_PATH`` set, the process-wide store additionally
persists to a JSON sidecar: loaded lazily on first use (a fresh process
re-optimizes with warm priors instead of cold defaults) and written back
atomically (tmp + ``os.replace``) at interpreter exit.  A corrupt or
missing sidecar is silently treated as empty — stats are advisory.
"""

from __future__ import annotations

import atexit
import json
import os
import tempfile
import threading
from collections import OrderedDict
from typing import Optional

from ..utils import knobs, metrics
from . import ir

_MAX_ENTRIES = 4096


def atomic_write_json(path: str, doc) -> bool:
    """Atomically write ``doc`` as JSON to ``path`` (tmp in the target
    directory + ``os.replace``, never a torn file).  Returns False on any
    OS failure — persistence is best-effort."""
    try:
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".sidecar.", dir=d)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(doc, f, separators=(",", ":"))
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError:
        return False
    return True


def _default_cap() -> int:
    try:
        return max(knobs.get("SRJT_PLAN_STATS_CAP"), 1)
    except ValueError:
        return _MAX_ENTRIES


class CardinalityStats:
    """Bounded fingerprint → observed-row-count LRU (thread-safe).

    Long-running serving processes see an unbounded stream of distinct
    fingerprints; the cap (``SRJT_PLAN_STATS_CAP``, default 4096) bounds
    the store and *reads refresh recency* — the fingerprints recurring
    queries actually reorder on survive one-off churn.  Evictions are
    counted in :attr:`evictions`."""

    def __init__(self, max_entries: Optional[int] = None):
        self._lock = threading.Lock()
        self._rows: OrderedDict[str, int] = OrderedDict()
        self._max = _default_cap() if max_entries is None else max(
            int(max_entries), 1)
        self._evictions = 0

    def observe(self, fp: str, rows: int) -> None:
        with self._lock:
            self._rows[fp] = int(rows)
            self._rows.move_to_end(fp)
            while len(self._rows) > self._max:
                self._rows.popitem(last=False)
                self._evictions += 1

    @property
    def evictions(self) -> int:
        with self._lock:
            return self._evictions

    def rows_for(self, node: ir.Plan):
        """Estimated output rows of ``node``, or None when unknowable."""
        fp = ir.fingerprint(node)
        with self._lock:
            got = self._rows.get(fp)
            if got is not None:
                self._rows.move_to_end(fp)    # a read IS a use (LRU)
        if got is not None:
            return float(got)
        if isinstance(node, (ir.Join, ir.FusedJoinAggregate)):
            return self._join_prior()
        return None

    @staticmethod
    def _join_prior():
        # mean of the join.match_rows histogram — the coarse process-wide
        # prior for "how big do joins come out around here"
        snap = metrics.snapshot()
        hist = snap.get("histograms", {}).get("join.match_rows")
        if hist and hist.get("count"):
            return float(hist["total"]) / float(hist["count"])
        return None

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    # --- JSON sidecar (SRJT_PLAN_STATS_PATH) -----------------------------

    def load_sidecar(self, path: str) -> int:
        """Merge fingerprint → rows entries from ``path`` (oldest-first,
        so live observations outrank persisted ones in the LRU).  Returns
        the number of entries merged; any read/parse failure counts as an
        empty sidecar."""
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            entries = doc.get("rows", {})
            if not isinstance(entries, dict):
                return 0
        except (OSError, ValueError):
            return 0
        n = 0
        with self._lock:
            for fp, rows in entries.items():
                if not isinstance(fp, str) or fp in self._rows:
                    continue
                try:
                    rows = int(rows)
                except (TypeError, ValueError):
                    continue
                self._rows[fp] = rows
                self._rows.move_to_end(fp, last=False)
                n += 1
            while len(self._rows) > self._max:
                self._rows.popitem(last=False)
        return n

    def save_sidecar(self, path: str) -> bool:
        """Atomically write the store to ``path`` (tmp + ``os.replace``,
        never a torn file).  Returns False on any OS failure — persistence
        is best-effort, stats are advisory."""
        with self._lock:
            snap = dict(self._rows)
        return atomic_write_json(path, {"version": 1, "rows": snap})


#: process-wide store the executor feeds; pass to ``rules.optimize`` to
#: let recurring queries reorder from observed cardinalities.
GLOBAL = CardinalityStats()

_sidecar_loaded = False


def ensure_sidecar_loaded() -> None:
    """Lazily merge the ``SRJT_PLAN_STATS_PATH`` sidecar into ``GLOBAL``
    (once per process; callers invoke before reading priors)."""
    global _sidecar_loaded
    if _sidecar_loaded:
        return
    _sidecar_loaded = True
    path = knobs.get("SRJT_PLAN_STATS_PATH")
    if path:
        GLOBAL.load_sidecar(path)


@atexit.register
def _save_sidecar_at_exit() -> None:
    # knob re-read at exit: tests that set the env var mid-process and
    # processes that never touched stats both do the right thing
    path = knobs.get("SRJT_PLAN_STATS_PATH")
    if path and len(GLOBAL):
        GLOBAL.save_sidecar(path)
