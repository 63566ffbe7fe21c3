"""Persistent AOT plan-artifact store: capture tapes as a fleet asset.

The port's counterpart of the JAX package's ``exec/artifacts.py``.  Every
fresh serving process pays, per plan, an eager capture run (the query
run once with every size it resolves read back from the card, recording
the tape) and a CUDA-graph capture before it serves its first request.
This module persists the first half:

* **the capture tape** — the recorded resolved-size vector that makes a
  plan shape-deterministic.  It is pure data (a tuple of ints), so it
  persists as a versioned JSON artifact keyed on ``(plan fingerprint ×
  input geometry × engine variant × torch + CUDA runtime + package
  version)``.  A fresh process *rehydrates* a
  :class:`~..models.compiled.CompiledQuery` from the persisted tape
  (``models/compiled.rehydrate_query``) without the eager capture run;
  the plan's first checked run validates the tape against the size
  vector its graph resolves, and a mismatch degrades to a live capture —
  a stale artifact is never wrong, only slower.
* **the graph** is not persisted: a CUDA graph cannot be serialized, so
  a rehydrated plan still captures its graph at its first checked run.
  What the store saves is the eager capture run, with its host
  synchronisation at every size.  The JAX package's second half, XLA's
  persistent executable cache under ``<dir>/xla``, has no counterpart:
  the port's kernels are built once, by content hash, into
  ``build/torch_kernels``, so ``SRJT_AOT_XLA_CACHE`` is not ported.

**Geometry bucketing** (``SRJT_AOT_GEOM_BUCKETS``, default on): artifact
keys bucket every input dimension up to the next power of two, so nearby
dataset sizes share one artifact instead of fragmenting the store.
Different true geometry under one bucket is safe by construction — the
size fingerprint inside the key still carries dtypes and ranks, and the
first checked run's tape guard rejects any artifact whose resolved sizes
don't match the live data.  Inputs whose fingerprint contains
process-local identity (opaque objects) have no stable cross-process key
and are never persisted.

**Warm-up manifest**: every write updates ``manifest.json`` with the
plan's compile cost (the capture wall the artifact saves a future
process).  ``ArtifactStore.preload`` reads the top-N costliest artifacts
into memory; ``exec/scheduler.py`` runs it on a background thread at
startup so the first requests' lookups are memory hits.

All writes are atomic (``plan/stats.atomic_write_json`` — tmp +
``os.replace``); corrupted, stale, or version-skewed artifacts are
ignored with an ``aot_reject`` flight incident, never an error.

Knobs: ``SRJT_AOT_DIR`` (root; unset disables), ``SRJT_AOT_GEOM_BUCKETS``,
``SRJT_AOT_WARMUP``.
Counters: ``aot.{hit,miss,write,reject,unstable_key,preloaded}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional

import torch

from ..analysis import sanitize
from ..models import compiled as C
from ..plan.stats import atomic_write_json
from ..utils import flight, knobs, metrics

#: bump on any incompatible change to the artifact document layout —
#: readers reject mismatched versions (forward AND backward skew)
STORE_VERSION = 1

# tags the size-fingerprint walker (models/compiled.plan_key) emits for
# structural entries; anything else in first position is a dtype string
# heading a (dtype, shape) leaf
_GEOM_TAGS = frozenset(("key", "table", "col", "dict", "lazy", "val", "obj",
                        "seq"))


def enabled() -> bool:
    """True when AOT persistence is configured (``SRJT_AOT_DIR``)."""
    return knobs.get("SRJT_AOT_DIR") is not None


def env_fingerprint() -> str:
    """The version key artifacts are stamped with: store layout + torch +
    CUDA runtime + package versions.  Any skew rejects the artifact (the
    tape encodes the op library's order of resolved sizes, which is only
    stable within one package version)."""
    from .. import __version__ as pkg
    return (f"store{STORE_VERSION};torch{torch.__version__};"
            f"cuda{torch.version.cuda};pkg{pkg}")


def _bucket(n) -> int:
    """Round ``n`` up to the next power of two (0 and 1 stay exact)."""
    n = int(n)
    if n <= 1:
        return n
    return 1 << (n - 1).bit_length()


def geometry_key(tables, buckets: Optional[bool] = None) -> Optional[str]:
    """Stable digest of the inputs' geometry — dtypes, ranks, and
    (bucketed) dimensions, NO tensor identity — usable as a cross-process
    artifact key.  Returns ``None`` when the fingerprint contains
    process-local identity (an opaque object the walker cannot see
    inside): such keys are not stable across processes and must never
    reach the disk store."""
    if buckets is None:
        buckets = knobs.get("SRJT_AOT_GEOM_BUCKETS")
    sfp, _ = C.plan_key(tables, by_size=True)
    parts = []
    for e in sfp:
        if not isinstance(e, tuple) or not e:
            parts.append(repr(e))
            continue
        tag = e[0]
        if tag == "obj":
            if metrics.recording():
                metrics.count("aot.unstable_key")
            return None
        if tag == "lazy":
            n = _bucket(e[-1]) if buckets else int(e[-1])
            parts.append(f"lazy:{e[1:-1]}:{n}")
        elif (len(e) == 2 and isinstance(e[1], tuple)
                and tag not in _GEOM_TAGS):
            shape = tuple(_bucket(d) for d in e[1]) if buckets \
                else tuple(int(d) for d in e[1])
            parts.append(f"{tag}:{shape}")
        else:
            parts.append(repr(e))
    digest = hashlib.sha256("|".join(parts).encode()).hexdigest()[:20]
    return ("b" if buckets else "x") + digest


class ArtifactStore:
    """One on-disk artifact root: ``plans/<digest>.json`` documents and a
    ``manifest.json`` ranked by compile cost.  Thread-safe; every disk
    write is atomic; every read failure degrades to a miss."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.plans_dir = os.path.join(self.root, "plans")
        self.manifest_path = os.path.join(self.root, "manifest.json")
        self._mu = sanitize.tracked_lock("exec.artifacts")
        self._mem: dict[str, dict] = {}     # digest → validated document
        self._env = env_fingerprint()

    # -- keys ---------------------------------------------------------------

    def _digest(self, plan: str, variant: str, geom: str) -> str:
        raw = f"{self._env}|{plan}|{variant}|{geom}"
        return hashlib.sha256(raw.encode()).hexdigest()[:24]

    def path_for(self, plan: str, variant: str, geom: str) -> str:
        return os.path.join(self.plans_dir,
                            self._digest(plan, variant, geom) + ".json")

    # -- read side ----------------------------------------------------------

    def _reject(self, digest: str, path: str, reason: str) -> None:
        with self._mu:
            self._mem.pop(digest, None)
        if metrics.recording():
            metrics.count("aot.reject")
        flight.incident("aot_reject", reason=reason,
                        artifact=os.path.basename(path))

    def _validate(self, doc, plan: str, variant: str,
                  geom: str) -> Optional[str]:
        """The reason ``doc`` cannot serve (plan, variant, geom), or
        ``None`` when it can."""
        if not isinstance(doc, dict):
            return "corrupt"
        if doc.get("version") != STORE_VERSION:
            return "version_skew"
        if doc.get("env") != self._env:
            return "env_skew"
        if (doc.get("plan") != plan or doc.get("variant") != variant
                or doc.get("geom") != geom):
            return "key_mismatch"
        tape = doc.get("tape")
        if not isinstance(tape, list) or any(
                not isinstance(v, int) or isinstance(v, bool)
                for v in tape):
            return "corrupt"
        return None

    def lookup(self, plan: str, variant: str,
               geom: str) -> Optional[tuple]:
        """The persisted capture tape for the key, or ``None`` (missing,
        corrupt, version-skewed, or mismatched — all misses, never
        errors)."""
        digest = self._digest(plan, variant, geom)
        path = os.path.join(self.plans_dir, digest + ".json")
        with self._mu:
            doc = self._mem.get(digest)
        if doc is None:
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except OSError:
                if metrics.recording():
                    metrics.count("aot.miss")
                return None
            except ValueError:
                self._reject(digest, path, "corrupt")
                return None
        reason = self._validate(doc, plan, variant, geom)
        if reason is not None:
            self._reject(digest, path, reason)
            return None
        with self._mu:
            self._mem[digest] = doc
        if metrics.recording():
            metrics.count("aot.hit")
        return tuple(doc["tape"])

    # -- write side ---------------------------------------------------------

    def put(self, plan: str, variant: str, geom: str, tape, *,
            name: str = "", cost_ms: float = 0.0) -> bool:
        """Persist one plan's capture tape (overwriting any previous
        artifact under the same key — the stale-rewrite path) and rank it
        in the warm-up manifest by ``cost_ms``, the capture wall a future
        process saves by rehydrating.  Best-effort: returns False on any
        OS failure."""
        digest = self._digest(plan, variant, geom)
        doc = {"version": STORE_VERSION, "env": self._env, "plan": plan,
               "variant": variant, "geom": geom, "name": name,
               "tape": [int(v) for v in tape],
               "created": round(time.time(), 3),
               "cost_ms": round(float(cost_ms), 3)}
        try:
            os.makedirs(self.plans_dir, exist_ok=True)
        except OSError:
            return False
        if not atomic_write_json(
                os.path.join(self.plans_dir, digest + ".json"), doc):
            return False
        with self._mu:
            self._mem[digest] = doc
        self._update_manifest(digest, {
            "plan": plan, "name": name, "variant": variant,
            "tape_len": len(doc["tape"]), "cost_ms": doc["cost_ms"],
            "created": doc["created"]})
        if metrics.recording():
            metrics.count("aot.write")
        return True

    def _read_manifest(self) -> dict:
        try:
            with open(self.manifest_path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if (isinstance(doc, dict) and doc.get("env") == self._env
                    and isinstance(doc.get("entries"), dict)):
                return doc
        except (OSError, ValueError):
            pass
        # missing/corrupt/skewed manifest: start fresh (it is derived
        # data — artifacts themselves still validate individually)
        return {"version": STORE_VERSION, "env": self._env, "entries": {}}

    def _update_manifest(self, digest: str, entry: dict) -> None:
        with self._mu:
            doc = self._read_manifest()
            doc["entries"][digest] = entry
            atomic_write_json(self.manifest_path, doc)

    def manifest_entries(self) -> list[tuple[str, dict]]:
        """(digest, entry) pairs ranked costliest-first — the warm-up
        order."""
        with self._mu:
            doc = self._read_manifest()
        return sorted(doc["entries"].items(),
                      key=lambda kv: -float(kv[1].get("cost_ms", 0)))

    # -- warm-up ------------------------------------------------------------

    def preload(self, top_n: int) -> int:
        """Pre-hydrate the ``top_n`` costliest manifest entries: read and
        validate their artifact documents into the in-memory index so
        the first request's lookup is a memory hit.  Returns the number
        resident."""
        n = 0
        for digest, entry in self.manifest_entries()[:max(int(top_n), 0)]:
            with self._mu:
                if digest in self._mem:
                    n += 1
                    continue
            path = os.path.join(self.plans_dir, digest + ".json")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                self._reject(digest, path, "corrupt")
                continue
            reason = self._validate(doc, doc.get("plan"),
                                    doc.get("variant"), doc.get("geom")) \
                if isinstance(doc, dict) else "corrupt"
            if reason is not None:
                self._reject(digest, path, reason)
                continue
            with self._mu:
                self._mem[digest] = doc
            n += 1
        if n and metrics.recording():
            metrics.count("aot.preloaded", n)
        return n

    def stats(self) -> dict:
        """Occupancy + lifetime counters (flight probe / ops surface)."""
        with self._mu:
            resident = len(self._mem)
        try:
            on_disk = sum(1 for f in os.listdir(self.plans_dir)
                          if f.endswith(".json"))
        except OSError:
            on_disk = 0
        out = {"root": self.root, "resident": resident,
               "on_disk": on_disk}
        for c in ("hit", "miss", "write", "reject", "unstable_key",
                  "preloaded"):
            out[c] = metrics.counter_value(f"aot.{c}")
        return out


# --- process-wide access -----------------------------------------------------

_stores: dict[str, ArtifactStore] = {}
_stores_mu = sanitize.tracked_lock("exec.artifacts.stores")


def get_store() -> Optional[ArtifactStore]:
    """The store for the current ``SRJT_AOT_DIR`` (None when unset).
    One instance per root path."""
    root = knobs.get("SRJT_AOT_DIR")
    if not root:
        return None
    root = os.path.abspath(root)
    with _stores_mu:
        st = _stores.get(root)
        if st is None:
            st = _stores[root] = ArtifactStore(root)
    return st
