"""``convert_to_rows``'s share of its roofline, in %: the least bytes of
the calls in the profiled slice (each column byte read once, each row byte
written once, from the table's shapes) over the card's peak HBM bytes a
second, divided by the device time of the work launched inside the
calls' ranges."""


def read(view):
    peak = view.facts.get("peak_bytes_per_s")
    nbytes = view.facts.get("to_rows_bytes")
    calls = len(view.ranges("convert_to_rows"))
    busy = view.busy_in("convert_to_rows")
    if not (peak and nbytes and calls and busy):
        return None
    return 100.0 * calls * nbytes / peak / busy
