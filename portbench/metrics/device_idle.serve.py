"""The card's idle share of the profiled slice: one less the union of its
device intervals over the slice's wall seconds."""


def read(view):
    if not view.device or view.window_s <= 0:
        return None
    return 1.0 - view.busy_s / view.window_s
