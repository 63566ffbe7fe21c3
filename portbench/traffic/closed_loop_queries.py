"""Served queries in a closed loop: ``clients`` threads, each submitting
its next query to one ``QueryScheduler`` as soon as its last reply came.

Parameters (the mix's file): ``clients``; ``workers`` of the scheduler
(its other settings are its defaults, with one ``PlanCache``);
``queries``, the names of ``models.tpcds.QUERIES`` a client draws from,
uniformly, in rounds that hold each query once, in orders drawn from the
seed (``sequence``: its length, repeated if a client gets that far); ``warmup_s`` of the whole mix in
set-up after each query has been served ``warmup_runs`` times alone (the
capture, the checked replay, a replay); ``checks_per_client`` moments of
each client, drawn from the seed uniformly over the window's seconds: the
client holds the answer of the request it is serving at each, for the
check; ``trace_slice_s``, the profiled slice.
Each query's parameters come from the data, as the oracle picks them.

A request is timed from its submission until its reply is in the client's
hands; one that fails counts as missing the tail.  Metrics: completed
requests over the window's seconds, and the 95th percentile of every
request submitted in it.  Check: each held answer against the NumPy oracle
(``answer_values_wrong``: the rows whose exact value or validity differs;
``float_error``: the largest relative error of a float column, in units of
the oracle's tolerance for that column over its ``FLOAT_RTOL``;
``answers_missing``: drawn moments whose request failed or never
replied).  The control (:func:`control`) holds the oracle's answer of
every query of the mix with its floats rounded to float32.
"""

from __future__ import annotations

import functools
import math
import threading
import time

import numpy as np

from ..reference import tpcds_oracle as O


def _rounds(rng, k: int, n: int) -> list:
    """``n`` draws from ``k`` queries in rounds, each round every query
    once in an order drawn from ``rng``: each query is as likely as any
    other at every step, and every seed serves the same mix."""
    rounds = -(-n // k)
    return np.concatenate([rng.permutation(k) for _ in range(rounds)]
                          )[:n].tolist()


def _client_plans(run, names: list) -> tuple:
    """Each client's query sequence (indices into ``names``) and the
    moments, in seconds from the window's start, whose requests it
    holds."""
    tr = run.traffic
    seqs, checks = [], []
    for c in range(int(tr["clients"])):
        rng = np.random.default_rng([run.seed, 2, c])
        seqs.append(_rounds(rng, len(names), int(tr["sequence"])))
        checks.append(sorted((rng.random(int(tr["checks_per_client"]))
                              * run.seconds).tolist()))
    return seqs, checks


def _serve(run, seconds: float, seqs, checks, tick) -> dict:
    """Every client's loop for ``seconds``; ``tick`` (the tracer's, or
    none in set-up) ticks on this thread.  A client holds the answer of
    the request it served at each of its moments ``checks[c]``; the
    first request also covers the moments before it.  Returns the
    records (name, submitted, replied, ok), the held answers and the
    number of moments that fell on a request that replied."""
    st = run.state
    sched, qfns, tables, names = (st["sched"], st["qfns"], run.data["tables"],
                                  st["names"])
    n = len(seqs)
    recs = [[] for _ in range(n)]
    held, errors, resolved = [], [], [0] * n
    start = threading.Barrier(n + 1)
    t0 = [0.0]

    def client(c):
        start.wait()
        t_end = t0[0] + seconds
        seq, moments = seqs[c], checks[c]
        i, j, prev = 0, 0, None
        while True:
            ts = time.perf_counter()
            hit = 0
            while i and j < len(moments) and t0[0] + moments[j] < ts:
                hit, j = hit + 1, j + 1
            if hit and prev is not None:    # the request just served
                held.append(prev)
                resolved[c] += hit
            prev = None
            if ts >= t_end:
                return
            name = names[seq[i % len(seq)]]
            try:
                out = sched.submit(name, qfns[name], tables).result()
                ok = True
            except Exception as e:          # a failed request is a record
                out, ok = None, False
                errors.append(f"{name}: {e!r}")
            recs[c].append((name, ts, time.perf_counter(), ok))
            if ok:
                prev = (name, out)
            i += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n)]
    for t in threads:
        t.start()
    t0[0] = time.perf_counter()
    start.wait()
    while any(t.is_alive() for t in threads):
        tick(time.perf_counter() - t0[0])
        time.sleep(0.005)
    for t in threads:
        t.join()
    return {"t0": t0[0], "records": [r for rs in recs for r in rs],
            "held": held, "errors": errors, "resolved": sum(resolved)}


def setup(run) -> None:
    from spark_rapids_jni_tpu_torch import exec as xc
    from spark_rapids_jni_tpu_torch.models import tpcds
    from spark_rapids_jni_tpu_torch.utils import metrics
    tr = run.traffic
    names = list(tr["queries"])
    params = O.query_params(run.data["arrays"])
    qfns = {q: functools.partial(tpcds.QUERIES[q], **params[q])
            for q in names}
    metrics.set_enabled(False)
    sched = xc.QueryScheduler(
        workers=int(tr["workers"]), plan_cache=xc.PlanCache(),
        device="cpu" if run.device.type == "cpu" else None)
    run.state.update(sched=sched, qfns=qfns, names=names, params=params)
    tables = run.data["tables"]
    for q in names:
        for _ in range(int(tr["warmup_runs"])):
            sched.submit(q, qfns[q], tables).result()
    seqs, checks = _client_plans(run, names)
    rng = np.random.default_rng([run.seed, 3])
    warm = [_rounds(rng, len(names), len(s)) for s in seqs]
    _serve(run, float(tr["warmup_s"]), warm, [[]] * len(seqs),
           lambda elapsed: None)
    run.sync()
    run.state.update(seqs=seqs, checks=checks)
    if run.trace:
        metrics.reset()
        metrics.set_enabled(True)


def window(run) -> None:
    st = run.state
    st["served"] = _serve(run, run.seconds, st["seqs"], st["checks"],
                          run.tracer.tick)
    recs = st["served"]["records"]
    st["attempted"] = len(recs)
    st["failed"] = sum(1 for r in recs if not r[3])
    st["errors"] = st["served"]["errors"]


def end_to_end(run) -> dict:
    served = run.state["served"]
    t_end = served["t0"] + run.seconds
    recs = served["records"]
    done = sum(1 for _, _, te, ok in recs if ok and te <= t_end)
    lat = sorted((te - ts) * 1e3 if ok else math.inf
                 for _, ts, te, ok in recs)
    p95 = lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] if lat else math.inf
    return {"queries_per_s": done / run.seconds,
            "query_p95_ms": p95 if math.isfinite(p95) else None}


def trace_facts(run, view) -> dict:
    from spark_rapids_jni_tpu_torch.utils import metrics
    t0, t1 = run.tracer.t0, run.tracer.t1
    recs = run.state["served"]["records"]
    snap = metrics.snapshot()
    return {"requests_in_slice": sum(1 for _, _, te, ok in recs
                                     if ok and t0 <= te <= t1),
            "counters": snap["counters"], "histograms": snap["histograms"]}


def _host_result(table) -> tuple:
    """A result table's columns as host arrays (strings as lists) and
    their validity."""
    cols, valid = [], []
    for col in table.columns:
        valid.append(col.validity_or_true().cpu().numpy())
        if col.dtype.id.name == "STRING":
            cols.append(np.array(col.to_pylist(), dtype=object))
        else:
            cols.append(col.data.cpu().numpy())
    return cols, valid


def release(run) -> None:
    from spark_rapids_jni_tpu_torch.utils import metrics
    st = run.state
    served = st["served"]
    st["held_host"] = [(name, _host_result(out))
                       for name, out in served.pop("held")]
    st.pop("sched").shutdown()
    st.pop("qfns")
    metrics.set_enabled(False)
    run.data.pop("tables", None)


def readings(held: list, answers: dict) -> dict:
    """The numbers the check compares, for held (name, (cols, valid))
    answers against the oracle's ``answers`` by name."""
    wrong, worst = 0, 0.0
    for name, (cols, valid) in held:
        bad, err = O.readings(cols, valid, answers[name])
        wrong += bad
        worst = max(worst, err)
    return {"answer_values_wrong": wrong, "float_error": worst}


def oracle_answers(arrays: dict, params: dict, names) -> dict:
    return {q: O.answer(q, arrays, params[q]) for q in sorted(set(names))}


def control(cell: dict, seed: int, host: dict) -> dict:
    """The check's readings with the oracle's answer of every query of
    the mix, its float columns rounded to float32, in the program's
    place: ``host`` is the config's loader's ``reference(config,
    seed)``."""
    arrays = host["arrays"]
    names = list(cell["traffic"]["queries"])
    answers = oracle_answers(arrays, O.query_params(arrays), names)
    held = []
    for q in names:
        lower = O.float32_answer(answers[q])
        valid = [v if v is not None else [True] * lower.num_rows
                 for v in lower.valid]
        held.append((q, (lower.cols, valid)))
    return readings(held, answers)


def check(run) -> list:
    st = run.state
    held = st["held_host"]
    answers = oracle_answers(run.data["arrays"], st["params"],
                             [q for q, _ in held])
    got = readings(held, answers)
    got["answers_missing"] = (int(run.traffic["clients"])
                              * int(run.traffic["checks_per_client"])
                              - st["served"]["resolved"])
    return [{"name": k, "value": v, "limit": run.limits[k]}
            for k, v in got.items()]
