"""Row conversion in a closed loop: one flow, each step ``convert_to_rows``
of a resident table and ``convert_from_rows`` of every batch it gives.

Each step hands ``convert_to_rows`` new views of the table's dictionary
string columns, as a freshly scanned batch would come: ``DictColumn``
memoizes its materialized chars, so a step on the same views would skip
that work after the first.  Only one step's outputs are alive on the card
at a time.

Parameters (the mix's file): ``warmup_steps`` run in set-up;
``keep_within`` bounds the step, drawn from the seed, whose outputs are
held for the check beside the last step's: the drawn step's go to the
host as soon as it ends, with the window's clock stopped for the copy (a
step that raises counts as failed, and as wrong in every byte where it is
held); ``trace_slice_s`` is the profiled slice.  The cell's ``table``
names the table of its config.

Check: every byte of the two held steps' batches against the NumPy JCUDF
encoding of the seed's arrays, and every value of the tables converted
back against those arrays (``row_bytes_wrong`` and ``values_back_wrong``,
each with the limit its workload file states).  The control
(:func:`control`) puts the reference, with every float64 rounded through
float32, in the program's place.
"""

from __future__ import annotations

import time

import numpy as np

from .. import yardstick
from ..reference import jcudf


def _fresh(col, DictColumn):
    if isinstance(col, DictColumn):
        return DictColumn(col.codes, col.dictionary, col.validity)
    return col


def setup(run) -> None:
    import spark_rapids_jni_tpu_torch as pt
    from spark_rapids_jni_tpu_torch.column import DictColumn, Table
    name = run.params["table"]
    table = run.data["tables"][name]
    ref = run.data["reference"][name]

    def step_table():
        return Table([_fresh(c, DictColumn) for c in table.columns])

    schema = table.schema
    for _ in range(int(run.traffic["warmup_steps"])):
        batches = pt.convert_to_rows(step_table())
        [pt.convert_from_rows(b, schema) for b in batches]
    run.sync()
    rng = np.random.default_rng([run.seed, 1])
    run.state.update(
        pt=pt, step_table=step_table, schema=schema, ref=ref,
        kinds=[c[0] for c in ref],
        dictionaries=run.data.get("dictionaries", {}).get(name),
        step_bytes=2 * yardstick.row_bytes(ref),
        keep=int(rng.integers(0, int(run.traffic["keep_within"]))))


def window(run) -> None:
    from torch.profiler import record_function
    st = run.state
    pt, step_table, schema = st["pt"], st["step_table"], st["schema"]
    steps, failed, drawn, last, paused = 0, 0, None, None, 0.0
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0 - paused
        run.tracer.tick(elapsed)
        if elapsed >= run.seconds:
            break
        last = None                 # the last step's outputs go first
        try:
            with record_function("portbench.rows_step"):
                batches = pt.convert_to_rows(step_table())
                backs = [pt.convert_from_rows(b, schema) for b in batches]
            last = (batches, backs)
            del batches, backs
        except Exception as e:              # a failed step is counted
            failed += 1
            st.setdefault("errors", []).append(repr(e))
        if steps == st["keep"]:
            run.sync()
            t_copy = time.perf_counter()
            drawn = _to_host(last, st["kinds"])
            paused += time.perf_counter() - t_copy
        steps += 1
    run.sync()
    st.update(elapsed=time.perf_counter() - t0 - paused,
              steps=steps - failed, last=last,
              held_host=[] if steps <= st["keep"] else [drawn])
    run.state["attempted"] = steps
    run.state["failed"] = failed


def end_to_end(run) -> dict:
    st = run.state
    return {"rows_gbps": st["steps"] * st["step_bytes"] / st["elapsed"]
            / 1e9}


def trace_facts(run, view) -> dict:
    ref = run.state["ref"]
    name = run.torch.cuda.get_device_name(run.device) \
        if run.device.type == "cuda" else ""
    return {"to_rows_bytes": yardstick.rows_least_bytes(
                ref, run.state["dictionaries"]),
            "from_rows_bytes": yardstick.rows_least_bytes(ref),
            "peak_bytes_per_s": yardstick.PEAK_BYTES_PER_S.get(name)}


def _host_rows(batches) -> tuple:
    """The batches' row bytes back to back and their int64 row offsets."""
    datas, offs, base = [], [np.zeros(1, np.int64)], 0
    for b in batches:
        datas.append(b.data.cpu().numpy().view(np.uint8).reshape(-1))
        o = b.offsets.cpu().numpy().astype(np.int64)
        offs.append(o[1:] + base)
        base += int(o[-1])
    return (np.concatenate(datas) if datas else np.zeros(0, np.uint8),
            np.concatenate(offs))


def _host_table(table, kinds) -> list:
    cols = []
    for col, kind in zip(table.columns, kinds):
        valid = None if col.validity is None else \
            col.validity.cpu().numpy().astype(bool)
        if kind == "string":
            values = (col.data.cpu().numpy().view(np.uint8),
                      col.offsets.cpu().numpy().astype(np.int64))
        else:
            values = col.data.cpu().numpy()
        cols.append((kind, values, valid))
    return cols


def _to_host(out, kinds):
    """A step's batches and tables back on the host (None where the step
    failed)."""
    if out is None:
        return None
    batches, backs = out
    return (_host_rows(batches), [_host_table(t, kinds) for t in backs])


def release(run) -> None:
    """Bring the last step's outputs to the host and drop the program's
    state."""
    st = run.state
    st["held_host"].append(_to_host(st.pop("last"), st["kinds"]))
    for key in ("pt", "step_table", "schema"):
        st.pop(key, None)
    run.data.pop("tables", None)


def concat_tables(parts: list, kinds: list) -> list:
    """Tables converted back from several batches, as one."""
    if len(parts) == 1:
        return parts[0]
    out = []
    for i, kind in enumerate(kinds):
        cols = [p[i] for p in parts]
        valid = (None if all(c[2] is None for c in cols) else
                 np.concatenate([np.ones(len(c[1][1]) - 1 if kind == "string"
                                         else len(c[1]), bool)
                                 if c[2] is None else c[2] for c in cols]))
        if kind == "string":
            chars = np.concatenate([c[1][0] for c in cols])
            lens = np.concatenate([np.diff(c[1][1]) for c in cols])
            offs = np.zeros(lens.shape[0] + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            values = (chars, offs)
        else:
            values = np.concatenate([c[1] for c in cols])
        out.append((kind, values, valid))
    return out


def readings(held: list, ref: list, kinds: list, want=None) -> dict:
    """The numbers the check compares, for held outputs against ``ref``
    (``want``: its encoding, when already made)."""
    want_bytes, want_offs = want or jcudf.encode(ref)
    wrong_bytes = wrong_values = 0
    for out in held:
        if out is None:                 # the step failed: nothing is right
            wrong_bytes += want_bytes.shape[0]
            wrong_values += jcudf.num_rows(ref) * len(ref)
            continue
        (data, offs), backs = out
        wrong_bytes += jcudf.byte_mismatches(data, want_bytes)
        if not np.array_equal(offs, want_offs):
            k = min(offs.shape[0], want_offs.shape[0])
            wrong_bytes += int(np.count_nonzero(offs[:k] != want_offs[:k])
                               ) + abs(offs.shape[0] - want_offs.shape[0])
        wrong_values += jcudf.value_mismatches(concat_tables(backs, kinds),
                                               ref)
    return {"row_bytes_wrong": wrong_bytes,
            "values_back_wrong": wrong_values}


def control(cell: dict, seed: int, host: dict) -> dict:
    """The check's readings with the reference in the program's place,
    every float64 rounded through float32: ``host`` is the config's
    loader's ``reference(config, seed)``."""
    ref = host["reference"][cell["workload"]["params"]["table"]]
    kinds = [c[0] for c in ref]
    rows = jcudf.encode(jcudf.in_float32(ref))
    back = jcudf.decode(*rows, kinds)
    return readings([(rows, [back])], ref, kinds)


def check(run) -> list:
    st = run.state
    got = readings(st["held_host"], st["ref"], st["kinds"])
    return [{"name": k, "value": v, "limit": run.limits[k]}
            for k, v in got.items()]
