"""``convert_from_rows``'s share of its roofline, in %: as
``to_rows_roofline``, for the conversion back (each row byte read once,
each column byte written once)."""


def read(view):
    peak = view.facts.get("peak_bytes_per_s")
    nbytes = view.facts.get("from_rows_bytes")
    calls = len(view.ranges("convert_from_rows"))
    busy = view.busy_in("convert_from_rows")
    if not (peak and nbytes and calls and busy):
        return None
    return 100.0 * calls * nbytes / peak / busy
