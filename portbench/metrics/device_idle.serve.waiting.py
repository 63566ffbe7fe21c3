"""Share of the profiled slice's wall in device-idle gaps where every
worker thread of the scheduler waits: at the gap's middle each has an
``exec.wait``, ``exec.coalesce``, ``exec.admission`` or ``compiled.lock``
range open.  A worker thread is one with an ``exec.dispatch`` or
``exec.wait`` range in the slice.  Every gap counts, not only the
breakdown's longest: the idle the scheduler's own policy leaves."""

import numpy as np

WAITING = ("exec.wait", "exec.coalesce", "exec.admission", "compiled.lock")
WORKER = ("exec.dispatch", "exec.wait")


def idle_gaps(view):
    """(starts, ends) of the gaps between the slice's device intervals,
    from the first host range's start to the last one's end, as the
    breakdown takes them; None without device intervals or host ranges."""
    if not view.device or not view.host or view.window_s <= 0:
        return None
    lo = min(h[1] for h in view.host)
    hi = max(h[2] for h in view.host)
    starts, ends, at = [], [], lo
    for s, e in sorted((s, e) for _, s, e, _ in view.device):
        if s > at:
            starts.append(at)
            ends.append(s)
        at = max(at, e)
    if hi > at:
        starts.append(at)
        ends.append(hi)
    return np.array(starts, np.int64), np.array(ends, np.int64)


def covered(intervals, points):
    """Whether each of ``points`` lies in one of ``intervals``, (start,
    end) pairs."""
    ms, me = [], []
    for s, e in sorted(intervals):
        if ms and s <= me[-1]:
            me[-1] = max(me[-1], e)
        else:
            ms.append(s)
            me.append(e)
    if not ms:
        return np.zeros(len(points), bool)
    k = np.searchsorted(np.array(ms, np.int64), points, side="right") - 1
    return (k >= 0) & (points <= np.array(me, np.int64)[np.maximum(k, 0)])


def read(view):
    gaps = idle_gaps(view)
    workers = {t for n, _, _, t in view.host if n in WORKER}
    if gaps is None or not workers:
        return None
    starts, ends = gaps
    mid = (starts + ends) // 2
    waiting = np.ones(len(mid), bool)
    for thread in workers:
        waiting &= covered([(s, e) for n, s, e, t in view.host
                            if t == thread and n in WAITING], mid)
    return float(((ends - starts) * waiting).sum()) / 1e9 / view.window_s
