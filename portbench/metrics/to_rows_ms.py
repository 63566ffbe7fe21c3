"""Device ms of the program's ``convert_to_rows``, mean per call in the
profiled slice: the device time of the work launched inside the calls'
ranges (a union of intervals) over the number of calls."""


def read(view):
    calls = len(view.ranges("convert_to_rows"))
    busy = view.busy_in("convert_to_rows")
    return busy * 1e3 / calls if calls and busy else None
