"""Device busy ms in the profiled slice per request completed in it."""


def read(view):
    n = view.facts.get("requests_in_slice")
    if not n or not view.device:
        return None
    return view.busy_s * 1e3 / n
