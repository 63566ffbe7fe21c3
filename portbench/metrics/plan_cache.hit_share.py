"""Share of plan-cache lookups over the window that hit: the program's
``exec.plan_cache.hit`` over hit plus ``exec.plan_cache.miss``."""


def read(view):
    c = view.facts.get("counters", {})
    hit = c.get("exec.plan_cache.hit", 0)
    miss = c.get("exec.plan_cache.miss", 0)
    return hit / (hit + miss) if hit + miss else None
