"""Versioned append-only parquet table handle (the streaming ingest unit).

The port's counterpart of the JAX package's ``stream/delta.py``.  A
:class:`DeltaTable` owns an ordered list of parquet blobs for ONE fact
table.  Appends arrive either as new files (:meth:`append_file`) or as an
in-place rewrite of an existing file that strictly extends its row groups
(:meth:`extend_file` — validated against the footer, so a watermark taken
before the rewrite stays a prefix of the new layout).  Every mutation
bumps the epoch.

The position of a reader is a **watermark**: the per-file row-group count
tuple at the time of its last scan.  ``scan(since=watermark)`` decodes
ONLY the row groups appended past the watermark by driving
``parquet/device_scan.scan_table`` with an explicit ``row_groups``
selection — composing with the planner's ``columns`` /
``rowgroup_predicate`` pruning, so a delta scan still drops columns and
statistically-disjoint groups before any page decode.  Scans land on the
table's device: the GPU unless ``device`` says otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..analysis import sanitize
from ..column import Table, resolve_device
from ..parquet import decode as D
from ..parquet import device_scan
from ..parquet.footer import CMD, extract_footer_bytes
from ..parquet.thrift import parse_struct
from ..utils import metrics

Watermark = tuple[int, ...]     # row-group count per file, in file order


def _meta(file_bytes: bytes):
    return parse_struct(bytes(extract_footer_bytes(
        memoryview(file_bytes).cast("B"))))


def _file_meta(file_bytes: bytes):
    """(rows-per-row-group, compressed-bytes-per-row-group) from the footer."""
    meta = _meta(file_bytes)
    groups = meta.get(D.FMD.ROW_GROUPS)
    rows, nbytes = [], []
    for rg in (groups.values if groups is not None else []):
        rows.append(int(rg.get(D.RG.NUM_ROWS, 0)))
        total = 0
        for chunk in rg.get(D.RG.COLUMNS).values:
            md = chunk.get(D.CC.META_DATA)
            if md is not None:
                total += int(md.get(CMD.TOTAL_COMPRESSED_SIZE, 0) or 0)
        nbytes.append(total)
    return tuple(rows), tuple(nbytes)


class DeltaTable:
    """Append-only fact table: parquet files + epoch + row-group metadata.

    Thread-safe: scans snapshot the file list under the lock and decode
    outside it, so appends never block (or tear) an in-flight refresh.
    """

    def __init__(self, name: str = "fact",
                 files: Optional[Sequence[bytes]] = None, device=None):
        self.name = name
        self.device = resolve_device(device)
        self._lock = sanitize.tracked_rlock("stream.delta")
        self._files: list[bytes] = []
        self._rg_rows: list[tuple[int, ...]] = []
        self._rg_bytes: list[tuple[int, ...]] = []
        self._epoch = 0
        for b in (files or ()):
            self.append_file(b)

    # -- ingest -------------------------------------------------------------

    def append_file(self, file_bytes: bytes) -> int:
        """Append a new parquet file; returns the new epoch."""
        rows, nbytes = _file_meta(file_bytes)
        with self._lock:
            self._files.append(bytes(file_bytes))
            self._rg_rows.append(rows)
            self._rg_bytes.append(nbytes)
            self._epoch += 1
            epoch = self._epoch
        if metrics.recording():
            metrics.count("stream.append.files")
            metrics.count("stream.append.rows", sum(rows))
        return epoch

    def extend_file(self, index: int, file_bytes: bytes) -> int:
        """Replace file ``index`` with a rewrite that extends it: the new
        footer's row-group row counts must keep the old ones as a strict
        prefix (same group boundaries), so existing watermarks remain
        valid.  Returns the new epoch."""
        rows, nbytes = _file_meta(file_bytes)
        with self._lock:
            old = self._rg_rows[index]
            if len(rows) < len(old) or tuple(rows[:len(old)]) != old:
                raise ValueError(
                    f"extend_file({index}): new row-group layout "
                    f"{rows[:len(old)]}... does not keep the existing "
                    f"layout {old} as a prefix")
            appended = sum(rows[len(old):])
            self._files[index] = bytes(file_bytes)
            self._rg_rows[index] = rows
            self._rg_bytes[index] = nbytes
            self._epoch += 1
            epoch = self._epoch
        if metrics.recording():
            metrics.count("stream.append.extended_files")
            metrics.count("stream.append.rows", appended)
        return epoch

    # -- versioning ---------------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def watermark(self) -> Watermark:
        """Current per-file row-group counts — pass back as ``since``."""
        with self._lock:
            return tuple(len(r) for r in self._rg_rows)

    def rowgroup_counts(self) -> Watermark:
        return self.watermark()

    def num_files(self) -> int:
        with self._lock:
            return len(self._files)

    def total_rows(self, since: Optional[Watermark] = None) -> int:
        with self._lock:
            rg_rows = list(self._rg_rows)
        total = 0
        for i, rows in enumerate(rg_rows):
            lo = since[i] if since is not None and i < len(since) else 0
            total += sum(rows[lo:])
        return total

    def delta_bytes(self, since: Optional[Watermark] = None) -> int:
        """Compressed bytes of the row groups past ``since`` — the honest
        admission estimate for a refresh (it charges only the new decode
        work, not the whole table)."""
        with self._lock:
            rg_bytes = list(self._rg_bytes)
        total = 0
        for i, nb in enumerate(rg_bytes):
            lo = since[i] if since is not None and i < len(since) else 0
            total += sum(nb[lo:])
        return total

    # -- schema -------------------------------------------------------------

    def _leaves(self):
        with self._lock:
            if not self._files:
                raise ValueError(f"DeltaTable {self.name!r} has no files")
            head = self._files[0]
        return D.leaf_schema_elements(_meta(head))

    def schema(self) -> list[str]:
        return [leaf.name for leaf in self._leaves()]

    def column_dtype(self, name: str):
        for leaf in self._leaves():
            if leaf.name == name:
                return leaf.logical_dtype()
        raise KeyError(f"{self.name}.{name}")

    # -- scan ---------------------------------------------------------------

    def scan(self, columns: Optional[list[str]] = None,
             rowgroup_predicate=None,
             since: Optional[Watermark] = None,
             until: Optional[Watermark] = None) -> Table:
        """Decode rows past ``since`` (None = full scan).  Per file, only
        row groups ``[since[i], count)`` reach the decoder; files fully
        covered by the watermark are skipped outright.  ``until`` bounds
        the scan to a watermark snapshot so concurrent appends landing
        mid-scan are not decoded (they belong to the next epoch).
        Counters: ``stream.delta.rowgroups`` / ``stream.delta.rows`` for
        delta scans, ``stream.scan.rowgroups`` for full scans."""
        with self._lock:
            files = list(self._files)
            rg_rows = list(self._rg_rows)
        if not files:
            raise ValueError(f"DeltaTable {self.name!r} has no files")
        is_delta = since is not None
        with metrics.span("stream.delta_scan" if is_delta else "stream.scan",
                          table=self.name, files=len(files)):
            parts: list[Table] = []
            selected_groups = 0
            for i, b in enumerate(files):
                cnt = len(rg_rows[i])
                if until is not None:
                    cnt = min(cnt, until[i]) if i < len(until) else 0
                lo = since[i] if is_delta and i < len(since) else 0
                if lo >= cnt:
                    continue
                selected_groups += cnt - lo
                parts.append(device_scan.scan_table(
                    b, columns=columns, row_groups=list(range(lo, cnt)),
                    rowgroup_predicate=rowgroup_predicate,
                    device=self.device))
            if not parts:
                # empty delta: zero-row table with the file schema
                out = device_scan.scan_table(files[0], columns=columns,
                                             row_groups=[],
                                             device=self.device)
            elif len(parts) == 1:
                out = parts[0]
            else:
                from ..ops.copying import concat_tables
                out = concat_tables(parts)
            if metrics.recording():
                if is_delta:
                    metrics.count("stream.delta.rowgroups", selected_groups)
                    metrics.count("stream.delta.rows", out.num_rows)
                else:
                    metrics.count("stream.scan.rowgroups", selected_groups)
                metrics.annotate(rowgroups=selected_groups,
                                 rows=out.num_rows)
            return out
