"""Share of the profiled slice's wall in device-idle gaps at whose middle
no host range of any kind is open on any thread: the idle the trace
cannot explain.  Every gap counts, as in ``device_idle.serve.waiting``."""

from portbench import harness

_gaps = harness.load_reader("device_idle.serve.waiting")


def read(view):
    gaps = _gaps.idle_gaps(view)
    if gaps is None:
        return None
    starts, ends = gaps
    named = _gaps.covered([(s, e) for _, s, e, _ in view.host],
                          (starts + ends) // 2)
    return float(((ends - starts) * ~named).sum()) / 1e9 / view.window_s
