"""Registry of the port's ``SRJT_*`` environment knobs.

The port's counterpart of the JAX package's ``utils/knobs.py``: one
:class:`Knob` per name with its raw default, its parser and a one-line
doc, and :func:`get`, which re-reads the environment on every call so
that a toggle takes effect at once.  The mechanics (parsers, ``register``,
``get``) are the JAX package's; the registry holds only the knobs the
port's modules read so far, each with the JAX package's default and
parser.  The others arrive with the modules that read them.

Stdlib only: no torch, so tools can load it on their own.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

__all__ = ["Knob", "REGISTRY", "register", "get", "is_registered",
           "parse_bytes", "markdown_table"]


# --- parsers ----------------------------------------------------------------
# Each turns the raw environment string into the knob's value; ``raw`` is
# None only for a knob whose default is None (unset means unset).


def _int(raw: str) -> int:
    return int(raw)


def _float(raw: str) -> float:
    return float(raw)


def _str(raw: Optional[str]) -> Optional[str]:
    return raw


def _on_unless_off(raw: str) -> bool:
    """The standard gate: anything but 0/off/false/empty."""
    return raw.lower() not in ("0", "off", "false", "")


def _on_unless_0_off(raw: str) -> bool:
    """The scan's gate: 0/off disable."""
    return raw.lower() not in ("0", "off")


def _opt_in(raw: str) -> bool:
    """Opt-in gate: only 1/true/on enable."""
    return raw.lower() in ("1", "true", "on")


def _is_1(raw: str) -> bool:
    return raw == "1"


def _not_0(raw: str) -> bool:
    return raw != "0"


def _opt_float(raw: Optional[str]) -> Optional[float]:
    """None/empty/whitespace → None, else float."""
    if raw is None or not raw.strip():
        return None
    return float(raw)


def _opt_int(raw: Optional[str]) -> Optional[int]:
    """None/empty → None, else int."""
    if raw is None or not raw:
        return None
    return int(raw)


def _opt_str(raw: Optional[str]) -> Optional[str]:
    """None/empty → None, else the string (paths, rule lists)."""
    return raw or None


def parse_bytes(raw) -> Optional[int]:
    """``"512m"`` / ``"2g"`` / ``"65536"`` → bytes; None/empty/``none``/
    ``unlimited``/``off`` → None (no limit)."""
    if raw is None:
        return None
    if isinstance(raw, (int, float)):
        return int(raw)
    t = raw.strip().lower()
    if t in ("", "none", "unlimited", "off"):
        return None
    mult = 1
    if t[-1] in "kmgt":
        mult = 1 << (10 * ("kmgt".index(t[-1]) + 1))
        t = t[:-1]
    return int(float(t) * mult)


class Knob:
    """One registered environment knob: name, raw default, parser, doc."""

    __slots__ = ("name", "default", "parse", "doc", "section")

    def __init__(self, name: str, default: Optional[str],
                 parse: Callable[[Optional[str]], Any], doc: str,
                 section: str):
        self.name = name
        self.default = default       # raw string default; None = unset
        self.parse = parse
        self.doc = doc
        self.section = section

    def value(self) -> Any:
        """Parsed current value: environment override, else the default."""
        return self.parse(os.environ.get(self.name, self.default))


REGISTRY: dict[str, Knob] = {}


def register(name: str, default: Optional[str], parse, doc: str,
             section: str = "general") -> Knob:
    k = Knob(name, default, parse, doc, section)
    REGISTRY[name] = k
    return k


def get(name: str) -> Any:
    """The parsed value of registered knob ``name`` (re-reads the
    environment on every call).  Raises ``KeyError`` for unregistered
    names."""
    return REGISTRY[name].value()


def is_registered(name: str) -> bool:
    return name in REGISTRY


# --- the registry -----------------------------------------------------------

# plan optimizer (plan/)
register("SRJT_PLAN_OPT", "1", _not_0,
         "`0` disables all plan rewrites (lower the raw tree)", "plan")
register("SRJT_PLAN_RULES", None, _opt_str,
         "comma-separated allowlist of optimizer rule names", "plan")
register("SRJT_PLAN_MAX_PASSES", "10", _int,
         "optimizer fixpoint pass bound", "plan")
register("SRJT_PLAN_STATS_CAP", "4096", _int,
         "cardinality-stats LRU entry cap", "plan")
register("SRJT_PLAN_STATS_PATH", None, _opt_str,
         "JSON sidecar for cardinality stats: loaded at first use for "
         "warm priors, saved atomically at exit", "plan")

register("SRJT_AQE", "0", _opt_in,
         "adaptive query execution: stage-wise replanning on observed "
         "cardinalities (join reorder, engine flips, skew salting)",
         "plan")
register("SRJT_AQE_SKEW_FACTOR", "4.0", _float,
         "hot-key skew ratio (hottest/mean) at or above which AQE salts "
         "the repartition join", "plan")
register("SRJT_AQE_REPLAN_MIN_ROWS", "64", _int,
         "AQE skips join reorder when every pending input is smaller "
         "than this (replan overhead not worth it)", "plan")

# join engine (ops/join_plan.py)
register("SRJT_JOIN_ENGINE", None, _str,
         "force the join engine: `dense` or `sorted` (default: planner "
         "choice)", "ops")

# SQL front end (sql/)
register("SRJT_SQL_CACHE", "1", _on_unless_0_off,
         "memoize SQL text → optimized plan tree per (text, params, "
         "schema) so repeat submissions skip parse+bind+optimize; "
         "`0`/`off` reparses every call", "sql")
register("SRJT_SQL_CACHE_CAP", "256", _int,
         "parsed-plan memo entry cap (LRU)", "sql")
register("SRJT_SQL_MAX_LEN", "262144", _int,
         "reject SQL text longer than this many characters before "
         "tokenizing", "sql")

# parquet scan (parquet/)
register("SRJT_FUSED_FILTER", "1", _on_unless_0_off,
         "fused scan→filter: planner row predicates prune rows on the "
         "walked host pages (dictionary entries evaluated once, codes "
         "masked) before anything is staged; `0`/`off` decodes all rows "
         "and filters after", "parquet")

# serving runtime (exec/)
register("SRJT_EXEC", "0", _on_unless_off,
         "serving-runtime gate for deployments (`exec.enabled()`)",
         "exec")
register("SRJT_EXEC_WORKERS", "4", _int,
         "worker threads pulling from the request queue", "exec")
register("SRJT_EXEC_QUEUE_DEPTH", "32", _int,
         "bounded queue depth; past it `submit` raises `ExecQueueFull`",
         "exec")
register("SRJT_EXEC_COALESCE_MS", "4", _float,
         "cross-request coalesce window (ms); `0` disables batching",
         "exec")
register("SRJT_EXEC_COALESCE_MAX", "16", _int,
         "max requests per coalesced batch", "exec")
register("SRJT_EXEC_DEADLINE", None, _opt_float,
         "default end-to-end timeout (s) for requests submitted without "
         "one", "exec")
register("SRJT_EXEC_INFLIGHT_BYTES", None, parse_bytes,
         "per-device in-flight admission cap (`512m` forms; unset = no "
         "gate)", "exec")
register("SRJT_EXEC_PREFETCH_DEPTH", "2", _int,
         "staged working sets held ahead of execution", "exec")
register("SRJT_EXEC_PLAN_CACHE_CAP", "32", _int,
         "compiled-plan LRU entry cap", "exec")
register("SRJT_EXEC_PLAN_SIZE_FP", "1", _on_unless_off,
         "size-fingerprint plan sharing across refreshed same-shape data",
         "exec")
register("SRJT_EXEC_DEVICES", "1", _int,
         "replicas (one per local device); `>1` enables multi-device "
         "serving", "exec")
register("SRJT_EXEC_RECOVERY", "1", _on_unless_off,
         "quarantine→probe→recovery lifecycle; `0` pins the legacy "
         "terminal-quarantine contract", "exec")
register("SRJT_EXEC_PROBE_BASE_S", "0.05", _float,
         "first recovery-probe delay (doubles per failure, jittered)",
         "exec")
register("SRJT_EXEC_PROBE_MAX_S", "2.0", _float,
         "probe backoff ceiling", "exec")
register("SRJT_EXEC_EJECT_AFTER", "3", _int,
         "consecutive failed canaries before permanent ejection", "exec")
register("SRJT_EXEC_RELOCATE_MAX", None, _opt_int,
         "max failover hops per request before it errors (default: the "
         "device count)", "exec")


# SLO watchdog (exec/slo.py)
register("SRJT_SLO_P50_MS", None, _opt_float,
         "rolling-window p50 latency objective per query class", "slo")
register("SRJT_SLO_P95_MS", None, _opt_float,
         "rolling-window p95 latency objective per query class", "slo")
register("SRJT_SLO_P99_MS", None, _opt_float,
         "rolling-window p99 latency objective per query class", "slo")
register("SRJT_SLO_ERROR_RATE", None, _opt_float,
         "error-rate objective in [0, 1]", "slo")
register("SRJT_SLO_DEADLINE_RATE", None, _opt_float,
         "deadline-breach-rate objective in [0, 1]", "slo")
register("SRJT_SLO_DEFER_RATE", None, _opt_float,
         "admission-defer-rate objective in [0, 1]", "slo")
register("SRJT_SLO_DEGRADE_RATE", None, _opt_float,
         "degraded-admission-rate objective in [0, 1]", "slo")
register("SRJT_SLO_RELOCATE_RATE", None, _opt_float,
         "failover-relocation-rate objective in [0, 1]", "slo")
register("SRJT_SLO_WINDOW_S", "60", _float,
         "rolling window length (s)", "slo")
register("SRJT_SLO_MIN_N", "8", _int,
         "minimum window population before any verdict", "slo")
register("SRJT_SLO_COOLDOWN_S", "30", _float,
         "per-(class, objective) re-alarm holdoff (s)", "slo")

# memory arena and budget (memory/)
register("SRJT_HBM_ARENA", "0", _on_unless_off,
         "master gate for the arena subsystem", "memory")
register("SRJT_HBM_BUDGET", None, _str,
         "process/query byte limit (`512m`, `2g`, plain bytes); setting "
         "it also enables the arena; unset, the process limit is the "
         "card's memory", "memory")
register("SRJT_INDEX_CACHE_CAP", "512m", _str,
         "build-index cache LRU byte cap "
         "(`join.build_index.evictions` counts)", "memory")
register("SRJT_ARENA_ZEROS_CAP", "16m", _str,
         "pooled-zeros cache cap (`0` disables pooling)", "memory")
register("SRJT_HOSTCACHE_CAP", "256m", _str,
         "host-mirror cache LRU byte cap "
         "(`arena.hostcache.evictions` counts)", "memory")

# observability (utils/)
register("SRJT_METRICS_WINDOW_N", "1024", _int,
         "bounded per-histogram sample tail feeding rolling percentiles",
         "observability")
register("SRJT_METRICS_PORT", None, _opt_str,
         "serve `metrics.to_prometheus()` on "
         "`http://0.0.0.0:<port>/metrics`", "observability")
register("SRJT_FLIGHT", "1", _on_unless_off,
         "flight-recorder master gate (leave on: steady-state cost "
         "budget <2%)", "observability")
register("SRJT_FLIGHT_N", "512", _int,
         "flight-recorder ring capacity in events", "observability")
register("SRJT_INCIDENT_DIR", None, _opt_str,
         "where incident snapshots land; unset = incidents counted + "
         "ring-recorded, not written", "observability")
register("SRJT_INCIDENT_PER_KIND", "5", _int,
         "per-kind snapshot cap per process (breach storms must not "
         "fill the disk)", "observability")
register("SRJT_SANITIZE", "0", _str,
         "runtime sanitizers: `1` files flight incidents on lock-order "
         "inversions and hot-path retraces, `strict` raises instead "
         "(CI smokes run strict)", "observability")
register("SRJT_PROFILE", "0", _on_unless_off,
         "per-plan-node runtime profiling (`plan/profile.py`): rows/"
         "bytes/time per executed node, `explain_analyze()` rendering; "
         "off = one bool check on the executor path", "observability")
register("SRJT_PROFILE_DEVICE_TIME", "1", _on_unless_0_off,
         "time each profiled node on the card by CUDA events recorded at "
         "its enter and exit, read once when the profile closes; `0`/"
         "`off` records host wall only", "observability")
register("SRJT_PROFILE_VALIDITY", "0", _opt_in,
         "per-node validity density in profiles (adds one scalar sync "
         "per nullable column per node, recorded on the capture/replay "
         "tape — keep the knob stable across a compiled plan's "
         "lifetime)", "observability")
register("SRJT_PROFILE_DIR", None, _opt_str,
         "directory where per-query profile JSON artifacts land on "
         "profile close; unset = profiles kept in memory only",
         "observability")

# AOT plan-artifact store (exec/artifacts.py)
register("SRJT_AOT_DIR", None, _opt_str,
         "root of the persistent plan-artifact store (capture tapes + "
         "warm-up manifest); unset disables AOT persistence", "aot")
register("SRJT_AOT_GEOM_BUCKETS", "1", _on_unless_off,
         "pow2-bucket input geometry in artifact keys so nearby dataset "
         "sizes share one artifact; `0` keys on exact shapes", "aot")
register("SRJT_AOT_WARMUP", "8", _int,
         "manifest entries (ranked by compile-ledger cost) the scheduler "
         "pre-hydrates in the background at startup; `0` disables the "
         "warm-up thread", "aot")

# ml handoff (ml/)
register("SRJT_ML_PACK", "rowconv", _str,
         "feature-pack engine: `rowconv` reinterprets the JCUDF "
         "fixed-width row stream as the feature matrix, `stack` is the "
         "reference lane-stack A/B", "ml")
register("SRJT_ML_BATCH", "256", _int,
         "default minibatch size for `ml.pipeline.BatchPipeline`", "ml")
register("SRJT_ML_SEED", "0", _int,
         "default PRNG seed for the epoch shuffle", "ml")
register("SRJT_ML_SHUFFLE", "feistel", _str,
         "epoch-shuffle engine: `feistel` is the sort-free O(n) Feistel "
         "bijection on the card, `sort` is the JAX package's "
         "`jax.random.permutation` (sorting rounds on the host) kept as "
         "the cross-check", "ml")
register("SRJT_ML_EPOCH_FUSE", "1", _on_unless_0_off,
         "each training epoch one CUDA-graph replay of its whole step "
         "loop (on the CPU one loop); `0`/`off` launches step by step",
         "ml")

# streaming (stream/)
register("SRJT_STREAM_ALLOW_APPROX", "0", _opt_in,
         "allow approximate incremental states (`1`/`true`/`on` only)",
         "stream")


# --- README table -----------------------------------------------------------

_SECTION_TITLES = {
    "exec": "Serving runtime (`exec/`)",
    "aot": "AOT artifact store (`exec/artifacts.py`)",
    "slo": "SLO watchdog (`exec/slo.py`)",
    "memory": "Memory arena (`memory/`)",
    "observability": "Observability (`utils/`)",
    "ops": "Joins (`ops/`)",
    "plan": "Plan optimizer (`plan/`)",
    "sql": "SQL front-end (`sql/`)",
    "parquet": "Parquet scan (`parquet/`)",
    "ml": "ML handoff (`ml/`)",
    "stream": "Streaming (`stream/`)",
    "general": "General",
}


def markdown_table() -> str:
    """The port's knob catalog as grouped markdown tables: the generator
    behind the port's block of the README's knob tables
    (``tools/torch_lint.py --knob-table`` refreshes it in place)."""
    out = []
    seen_sections = []
    for k in REGISTRY.values():
        if k.section not in seen_sections:
            seen_sections.append(k.section)
    for sec in seen_sections:
        out.append(f"**{_SECTION_TITLES.get(sec, sec)}**\n")
        out.append("| knob | default | meaning |")
        out.append("|---|---|---|")
        for k in REGISTRY.values():
            if k.section != sec:
                continue
            default = "unset" if k.default is None else f"`{k.default}`"
            out.append(f"| `{k.name}` | {default} | {k.doc} |")
        out.append("")
    return "\n".join(out)
