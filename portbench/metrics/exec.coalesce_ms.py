"""Mean ms a request was held for coalescing over the window: the
program's ``exec.stage.coalesce_ms`` histogram (``utils/metrics.py``, on
in the traced run only)."""


def read(view):
    h = view.facts.get("histograms", {}).get("exec.stage.coalesce_ms")
    if not h or not h["count"]:
        return None
    return h["total"] / h["count"]
