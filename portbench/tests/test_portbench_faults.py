"""A whole run of each cell on the CPU at a tiny size, past the look for a
card: sound, it comes out correct; with the timed path broken underneath,
correct comes out false, once for each fault the cell can have (an answer
altered where it is made, half of the batch left out, a step that leaves
its output as it found it).  No cell spans chips, so no exchange can be
left out."""

from __future__ import annotations

import dataclasses

import pytest

from portbench import harness

from .conftest import tiny_cell

SEED = 2**31 + 11


def _run(cell_name: str, seconds: float = 1.5, trace: bool = False):
    return harness.run_cell(cell_name, SEED, seconds, trace, device="cpu",
                            cell=tiny_cell(cell_name))


def _alter(table):
    """The table with its first fixed-width value changed by one."""
    from spark_rapids_jni_tpu_torch.column import Table, force_column
    cols = [force_column(c) for c in table.columns]
    for i, c in enumerate(cols):
        if c.offsets is None and c.data.numel():
            data = c.data.clone()
            data.view(-1)[0] += 1
            cols[i] = dataclasses.replace(c, data=data)
            break
    return Table(cols)


def _half(table):
    from spark_rapids_jni_tpu_torch.rowconv.convert import slice_table
    return slice_table(table, 0, table.num_rows // 2)


@pytest.mark.parametrize("fault", ["none", "altered", "half", "unchanged"])
@pytest.mark.parametrize("cell", ["rows_lineitem_sf1",
                                  "rows_store_sales_sf10"])
def test_rows_cell_faults(monkeypatch, cell, fault):
    import torch

    import spark_rapids_jni_tpu_torch as pt
    real = pt.convert_to_rows
    calls = []
    warm = tiny_cell(cell)["traffic"]["warmup_steps"]

    def to_rows(table, *a, **k):
        calls.append(1)
        if len(calls) <= warm:              # set-up's steps run sound
            return real(table, *a, **k)
        if fault == "half":
            table = _half(table)
        batches = real(table, *a, **k)
        if fault == "altered":
            batches[0].data.view(torch.uint8)[17] ^= 1
        if fault == "unchanged":
            batches = [dataclasses.replace(b, data=torch.zeros_like(b.data))
                       for b in batches]
        return batches

    monkeypatch.setattr(pt, "convert_to_rows", to_rows)
    out = _run(cell)
    assert out["correct"] is (fault == "none"), out["checks"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("fault", ["none", "altered", "half", "unchanged"])
def test_serve_cell_faults(monkeypatch, fault):
    from spark_rapids_jni_tpu_torch.models import tpcds
    last = {}

    def broken(fn):
        def run(tables, **kw):
            out = fn(tables, **kw)
            if fault == "altered" and out.num_rows:
                return _alter(out)
            if fault == "half":
                return _half(out)
            if fault == "unchanged":
                prev = last.get("out", out)
                last["out"] = out
                return prev
            return out
        return run

    if fault != "none":
        for name, fn in list(tpcds.QUERIES.items()):
            monkeypatch.setitem(tpcds.QUERIES, name, broken(fn))
    out = _run("tpcds_serve_sf1", seconds=2.0)
    assert out["correct"] is (fault == "none"), out["checks"]


@pytest.mark.parametrize("cell,want", [
    ("rows_store_sales_sf10", set()),
    ("tpcds_serve_sf1", {"exec.queue_ms", "plan_cache.hit_share"})])
def test_traced_run_reads_its_metrics(cell, want):
    """A traced run on the CPU reads the metrics that need no device and
    leaves out those that do, printing no device number."""
    out = _run(cell, seconds=2.0, trace=True)
    assert out["correct"]
    assert set(out["metrics"]) == want
    assert out["device"]["busy_s"] == 0.0
