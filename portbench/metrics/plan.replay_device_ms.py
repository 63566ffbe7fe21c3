"""Device ms of a compiled plan's replay, mean per replay in the profiled
slice: the device time of the work launched inside the program's
``compiled.replay`` ranges (the input copies, the graph's launch, the
output clones), a union of intervals, over the number of replays."""


def read(view):
    replays = len(view.ranges("compiled.replay"))
    busy = view.busy_in("compiled.replay")
    return busy * 1e3 / replays if replays and busy else None
