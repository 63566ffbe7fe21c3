"""The benchmark's generic part: cells from files, the run, the trace, the
result line.

Everything of one cell is found by name: the cell's entry in
``BENCHMARK.json`` and its file ``portbench/workloads/<cell>.json`` (the
config, the traffic mix, the chips, the why, the cell's own parameters and
the limits of its output check), the config's file (its ``loader`` names
``portbench/data/<loader>.py``), the traffic mix's file
``portbench/traffic/<mix>.json`` (its ``kind`` names
``portbench/traffic/<kind>.py``), and one reader a per-layer metric,
``portbench/metrics/<metric>.py``.

A traffic kind is a module with ``setup(run)``, ``window(run)``,
``end_to_end(run)``, ``release(run)``, ``check(run)`` and
``trace_facts(run, view)``; :func:`run_cell` calls them in that order
around the measured window.  A metric reader is a module with
``read(view)``, which returns a number or None when the trace holds
nothing for it.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
# a device idle gap is named by the innermost host range open at its
# middle; so many of the longest gaps are named
GAPS_NAMED = 400
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 96


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_of_cell


def resolve(name: str, man: Optional[dict] = None) -> dict:
    """Everything the run of cell ``name`` needs, from its files."""
    man = man or manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} {workload[key]!r} in its "
                             f"file, {entry[key]!r} in BENCHMARK.json")
    cfg = next(c for c in man["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / cfg["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _reports(m, name, names)]
    return {"name": name, "entry": entry, "workload": workload,
            "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": per_layer}


def load_reader(metric: str):
    """The reader module of per-layer metric ``metric``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_kind(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}")


def data_loader(loader: str):
    return importlib.import_module(f"portbench.data.{loader}")


# ---------------------------------------------------------------------------
# the profiled slice
# ---------------------------------------------------------------------------

def _profile(torch):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        # the host ranges of every thread (the serving clients and
        # workers), where the installed torch offers it
        from torch._C._profiler import _ExperimentalConfig
        return profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
    except (ImportError, TypeError):
        return profile(activities=acts)


class Tracer:
    """Profiles one slice of the window: from ``start_s`` after the window
    opens, for ``slice_s`` seconds, started and stopped by :meth:`tick`
    on the thread that drives the window."""

    def __init__(self, torch, device, enabled: bool, start_s: float = 0.0,
                 slice_s: float = 0.0):
        self.torch = torch
        self.device = device
        self.enabled = enabled
        self.start_s = start_s
        self.slice_s = slice_s
        self.prof = None
        self.t0 = self.t1 = None
        self.done = False

    def warm(self) -> None:
        """One short profile in set-up: the profiler's first session in a
        process starts slowly."""
        if not self.enabled:
            return
        with _profile(self.torch):
            x = self.torch.ones(1024, device=self.device)
            (x + 1).sum()
            self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def tick(self, elapsed: float) -> None:
        if not self.enabled or self.done:
            return
        if self.prof is None and elapsed >= self.start_s:
            self._sync()
            self.prof = _profile(self.torch)
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif self.prof is not None and elapsed >= self.start_s + self.slice_s:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.done = True


@dataclasses.dataclass
class TraceView:
    """What a profiled slice holds, in nanoseconds on the profiler's
    clock: device intervals (name, start, end, correlation), host ranges
    (name, start, end, thread), launch times by correlation,
    the slice's wall seconds, and the facts the traffic kind adds
    (``facts``: the program's counters over the window, the work the
    slice completed, the bytes a call needs)."""

    device: list
    host: list
    launch: dict
    window_s: float
    facts: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_profile(prof, window_s: float) -> "TraceView":
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        raw = prof.profiler.kineto_results.events()
        host, device, launch = [], [], {}
        host_names = set()
        for e in raw:
            if e.device_type() != cuda:
                s, d = e.start_ns(), e.duration_ns()
                host.append((e.name(), s, s + d, e.start_thread_id()))
                host_names.add(e.name())
                if e.correlation_id() and e.name().startswith("cuda"):
                    launch[e.correlation_id()] = (s, e.start_thread_id())
        for e in raw:
            if e.device_type() == cuda:
                if e.is_user_annotation() or e.name() in host_names:
                    continue
                s, d = e.start_ns(), e.duration_ns()
                if d > 0:
                    device.append((e.name(), s, s + d, e.correlation_id()))
        return TraceView(device, host, launch, window_s)

    # -- device time ---------------------------------------------------------

    @staticmethod
    def union_ns(intervals) -> float:
        busy, cur_s, cur_e = 0, None, None
        for s, e in sorted(intervals):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    @property
    def busy_s(self) -> float:
        return self.union_ns((s, e) for _, s, e, _ in self.device) / 1e9

    def ranges(self, name: str) -> list:
        """(start, end, thread) of the host ranges named ``name``."""
        return sorted((s, e, t) for n, s, e, t in self.host if n == name)

    def busy_in(self, name: str) -> Optional[float]:
        """Device seconds of the work launched inside ranges ``name`` (a
        launch is inside when its host call starts within a range on the
        same thread), as a union of intervals; None without such ranges
        or launches."""
        rng = collections.defaultdict(list)
        for s, e, t in self.ranges(name):
            rng[t].append((s, e))
        if not rng:
            return None
        picked = []
        for name_, s, e, corr in self.device:
            at = self.launch.get(corr)
            if at is None:
                continue
            ts, thread = at
            if any(a <= ts <= b for a, b in rng.get(thread, ())):
                picked.append((s, e))
        if not picked:
            return None
        return self.union_ns(picked) / 1e9

    # -- the breakdown -------------------------------------------------------

    def device_ops(self) -> list:
        tot = collections.Counter()
        for name, s, e, _ in self.device:
            tot[name[:NAME_CHARS]] += (e - s) / 1e9
        return [[n, v] for n, v in tot.most_common(BREAKDOWN_ENTRIES)]

    def idle_gaps(self) -> list:
        """Idle seconds between device intervals, summed by the innermost
        host range open at each gap's middle (the longest gaps first)."""
        import numpy as np
        if not self.host:
            return []
        lo = min(h[1] for h in self.host)
        hi = max(h[2] for h in self.host)
        merged = []
        for s, e in sorted((s, e) for _, s, e, _ in self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        gaps, at = [], lo
        for s, e in merged:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        hs = np.array([h[1] for h in self.host], np.int64)
        he = np.array([h[2] for h in self.host], np.int64)
        names = [h[0] for h in self.host]
        tot = collections.Counter()
        for a, b in gaps[:GAPS_NAMED]:
            mid = (a + b) // 2
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            name = ("no host range" if inside.shape[0] == 0
                    else names[int(inside[np.argmax(hs[inside])])])
            tot[name[:NAME_CHARS]] += (b - a) / 1e9
        return [[n, v] for n, v in tot.most_common(BREAKDOWN_ENTRIES)]


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """One run of one cell: what the traffic kind reads and leaves."""

    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    torch: object
    data: dict = dataclasses.field(default_factory=dict)
    state: dict = dataclasses.field(default_factory=dict)
    tracer: Optional[Tracer] = None

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    @property
    def params(self) -> dict:
        return self.cell["workload"].get("params", {})

    @property
    def limits(self) -> dict:
        return self.cell["workload"]["limits"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock, from
    ``/proc/self/stat``; the import of this module where that is not
    readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def seed_for_numpy(seed: int) -> int:
    """Any whole number as a numpy seed (non-negative, 64 bits)."""
    return int(seed) % (1 << 64)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, cell: Optional[dict] = None,
             t_start: Optional[float] = None) -> dict:
    """One run of cell ``name``: set-up, the measured window, the output
    check.  Returns the result line's object.  ``device`` defaults to the
    first card; ``cell`` (from :func:`resolve`) may come with its config
    cut to a size a test can hold."""
    import torch
    t_start = process_start() if t_start is None else t_start
    cell = cell or resolve(name)
    device = torch.device(device or "cuda:0")
    kind = traffic_kind(cell["traffic"]["kind"])
    run = Run(cell, seed_for_numpy(seed), float(seconds), bool(trace),
              device, torch)
    run.tracer = Tracer(torch, device, run.trace,
                        *_slice(run.traffic, run.seconds))
    loader = data_loader(cell["config"]["loader"])
    run.data = loader.prepare(cell["config"], run.seed, device)
    kind.setup(run)
    run.tracer.warm()
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    gc.collect()
    run.sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()
    kind.window(run)
    run.tracer.stop()
    run.sync()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    values = dict(kind.end_to_end(run))
    for err in run.state.get("errors", [])[:5]:
        print(f"portbench: failed: {err}", file=sys.stderr)
    values["setup_s"] = t_window - t_start
    values["peak_mem_gb"] = window_peak / 1e9
    print("portbench: " + ", ".join(f"{k} {v}" for k, v in values.items()),
          file=sys.stderr, flush=True)
    view = None
    if run.trace and run.tracer.prof is not None:
        view = TraceView.from_profile(run.tracer.prof,
                                      run.tracer.t1 - run.tracer.t0)
        view.facts = kind.trace_facts(run, view)
        run.tracer.prof = None
    kind.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = kind.check(run)
    attempted, failed = run.state["attempted"], run.state["failed"]
    correct = all(c["value"] <= c["limit"] for c in checks) and failed == 0
    metrics = {}
    if run.trace:
        for m in cell["per_layer"]:
            v = load_reader(m["name"]).read(view) if view else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if run.trace and view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        out["breakdown"] = {"device_ops": view.device_ops(),
                            "idle_gaps": view.idle_gaps()}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def _slice(traffic: dict, seconds: float) -> tuple:
    """(start, length) of the profiled slice: ``trace_slice_s`` seconds
    in the middle of the window."""
    length = min(float(traffic["trace_slice_s"]), seconds)
    return max(0.0, (seconds - length) / 2), length
