"""Mean ms a request waited in the scheduler's queue over the window: the
program's ``exec.stage.queue_ms`` histogram (``utils/metrics.py``, on in
the traced run only)."""


def read(view):
    h = view.facts.get("histograms", {}).get("exec.stage.queue_ms")
    if not h or not h["count"]:
        return None
    return h["total"] / h["count"]
