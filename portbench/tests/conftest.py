"""Fixtures of the benchmark's CPU tests: cells cut to a size a test run
holds, and the card for the tests marked ``gpu``."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny sizes of each loader's config
TINY = {
    "tpch_lineitem": {"rows": 20000, "writer": {
        "row_group_rows": 8192, "data_page_bytes": 1 << 20,
        "dict_page_bytes": 1 << 20, "page_row_limit": 20000}},
    "tpcds_star": {"store_sales_rows": 30000, "web_sales_rows": 10000,
                   "items": 300, "stores": 12},
}
TINY_TRAFFIC = {"closed_loop_queries": {"clients": 4,
                                        "checks_per_client": 2,
                                        "warmup_s": 0.3, "warmup_runs": 2}}


def tiny_cell(name: str) -> dict:
    """Cell ``name`` from its files, at a tiny size."""
    from portbench import harness
    cell = harness.resolve(name)
    cell["config"].update(TINY[cell["config"]["loader"]])
    cell["traffic"].update(TINY_TRAFFIC.get(cell["traffic"]["kind"], {}))
    return cell


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch
