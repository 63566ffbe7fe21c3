"""Host → device staging for the Parquet scan: capped slab waves.

The port's counterpart of the JAX package's ``parquet/staging.py``
(``SlabStager``, ``spark_rapids_jni_tpu/parquet/staging.py:78-166``).
The scan queues every byte range the device needs (PLAIN payloads, the
bit-packed payloads of definition levels and dictionary codes,
dictionary values and chars) and every int64 run table on a
:class:`SlabStager`; each comes back as a :class:`Ref`, which resolves to
a device view once its wave has shipped.

* A wave is one :class:`Slab`: its ranges back to back with no alignment
  padding, then its run tables at the first 8-byte boundary after them.
  A wave ships when adding the next range or table would take it past
  ``slab_cap`` (``SRJT_STAGE_SLAB_BYTES``, at least
  :data:`MIN_SLAB_BYTES`); shipping
  fills a pinned buffer and issues one non-blocking copy on the current
  stream, with its own CUDA event (:meth:`Slab.upload`).  A range is
  never split: one longer than the cap ships alone.  So a caller that
  queues column by column copies the full waves while it walks the next
  column; :meth:`SlabStager.flush` ships the last wave.
* A pinned buffer goes back to PyTorch's host allocator only after its
  copy's event (:meth:`Slab.release`): waves whose copy has finished are
  released as later ones ship, the rest by :meth:`SlabStager.release`.
* Each flush counts ``parquet.stage.slab_bytes``,
  ``parquet.stage.transfers`` and ``parquet.stage.buffers`` and records a
  ``parquet.stage.flush`` flight event (``slabs``, ``buffers``,
  ``bytes``), as the JAX package's does.
* ``SRJT_STAGE_SLABS=0`` uploads each range on its own through
  ``column.upload``, the constructors' funnel (the differential baseline;
  it still runs on the card).
* Donation (``SRJT_SCAN_DONATE``, :func:`donate_enabled`): the scan tells
  the stager which column it is staging (:meth:`SlabStager.begin_column`),
  and after decoding column k drops every wave whose last reader is k
  (:meth:`SlabStager.drop_read_by`): the stager's reference and every
  ``Ref``'s view go, so the caching allocator may hand the bytes to the
  next column's outputs.  The decoded columns own their storage
  (``bytepath.u8_to_u32`` copies each PLAIN range out, whatever its
  alignment), so nothing aliases a wave after it is dropped; without
  donation every wave goes when the scan returns
  (:meth:`SlabStager.release`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import column
from ..utils import flight, knobs, metrics
from ..utils.tracing import func_range


#: the least slab cap: ``SRJT_STAGE_SLAB_BYTES`` below it counts as it, as
#: in the JAX package's ``SlabStager``
MIN_SLAB_BYTES = 1 << 20


def enabled() -> bool:
    return bool(knobs.get("SRJT_STAGE_SLABS"))


def donate_enabled(device: torch.device) -> bool:
    """``SRJT_SCAN_DONATE``: ``auto`` donates on a CUDA device (on the CPU
    a wave is the host buffer itself); ``1``/``on`` forces, ``0``/``off``
    disables."""
    raw = str(knobs.get("SRJT_SCAN_DONATE") or "auto").strip().lower()
    if raw in ("1", "on", "true", "force"):
        return True
    if raw in ("0", "off", "false", ""):
        return False
    return device.type == "cuda"


class Slab:
    """Byte ranges and int64 run tables queued for one upload (one wave)."""

    def __init__(self):
        self._parts: list[tuple[int, memoryview]] = []
        self._meta: list[np.ndarray] = []
        self.nbytes = 0          # payload bytes queued
        self.meta_len = 0        # int64 entries queued
        self._pinned = None
        self._copied = None      # CUDA event after the copy

    def add(self, data) -> int:
        """Queue a byte range; returns its byte offset in the slab."""
        mv = memoryview(data).cast("B")
        off = self.nbytes
        if len(mv):
            self._parts.append((off, mv))
            self.nbytes += len(mv)
        return off

    def add_meta(self, arr: np.ndarray) -> int:
        """Queue int64 values; returns their offset in the int64 area."""
        arr = np.ascontiguousarray(arr, dtype=np.int64).reshape(-1)
        off = self.meta_len
        if arr.size:
            self._meta.append(arr)
            self.meta_len += arr.size
        return off

    @property
    def meta_start(self) -> int:
        return -(-self.nbytes // 8) * 8

    @property
    def total(self) -> int:
        """Bytes of the upload: the payload, its padding, the tables."""
        return self.total_with()

    def total_with(self, nbytes: int = 0, meta_len: int = 0) -> int:
        """:attr:`total` after ``nbytes`` more payload and ``meta_len``
        more int64 entries."""
        return (-(-(self.nbytes + nbytes) // 8) * 8
                + 8 * (self.meta_len + meta_len))

    def upload(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """One copy of the whole slab to ``device``: (uint8 payload bytes,
        int64 run-table area), both views of one device buffer."""
        total = self.total
        cuda = device.type == "cuda"
        host = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
        view = host.numpy()
        for off, mv in self._parts:
            view[off:off + len(mv)] = np.frombuffer(mv, dtype=np.uint8)
        view[self.nbytes:self.meta_start] = 0
        ms = self.meta_start
        meta_view = view[ms:].view(np.int64)
        pos = 0
        for arr in self._meta:
            meta_view[pos:pos + arr.size] = arr
            pos += arr.size
        self._parts, self._meta = [], []
        if cuda:
            dev = host.to(device, non_blocking=True)
            self._pinned = host
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(device))
        else:
            dev = host
        meta = (dev[ms:].view(torch.int64) if self.meta_len
                else torch.zeros(0, dtype=torch.int64, device=device))
        return dev[:self.nbytes], meta

    def copied(self) -> bool:
        """True once the copy out of the pinned buffer has finished."""
        return self._copied is None or self._copied.query()

    def release(self) -> None:
        """Wait for the copy out of the pinned buffer, then drop it."""
        if self._copied is not None:
            self._copied.synchronize()
        self._pinned = None
        self._copied = None


class Ref:
    """One queued byte range (uint8) or run table (int64); :meth:`get`
    is its device view once its wave has shipped."""

    __slots__ = ("_stager", "wave", "offset", "nbytes", "is_meta", "_dev")

    def __init__(self, stager: "SlabStager", wave: int, offset: int,
                 nbytes: int, is_meta: bool):
        self._stager = stager
        self.wave = wave
        self.offset = offset     # bytes in the wave's payload, or entries
        #                          in its int64 area
        self.nbytes = nbytes
        self.is_meta = is_meta
        self._dev: Optional[torch.Tensor] = None

    def get(self) -> torch.Tensor:
        """The device view; raises before its wave has shipped (the scan
        flushes before any decode reads) or once it was dropped."""
        if self._dev is None:
            if self.wave in self._stager.dropped:
                raise RuntimeError(f"staging: wave {self.wave} was dropped "
                                   "(donated, or the scan ended) before "
                                   "this range was read")
            raise RuntimeError(f"staging: wave {self.wave} was read before "
                               "it shipped (flush first)")
        return self._dev


class SlabStager:
    """Queue ranges and run tables; ship them as capped slab waves."""

    def __init__(self, device: torch.device, slab_cap: Optional[int] = None):
        if slab_cap is None:
            slab_cap = knobs.get("SRJT_STAGE_SLAB_BYTES") or (64 << 20)
        self.device = device
        self.slab_cap = max(int(slab_cap), MIN_SLAB_BYTES)
        self.slabs = enabled()
        self.slab_bytes = 0          # lifetime bytes shipped in waves
        self.transfers = 0           # lifetime host → device copies
        self.buffers = 0             # lifetime queued ranges and tables
        self.staged_bytes = 0        # every queued byte, in either mode
        self.wave_bytes: list[int] = []    # each shipped wave's upload
        self.wave_items: list[int] = []    # and its ranges and tables
        self._wave: Optional[Slab] = None
        self._wave_refs: list[Ref] = []
        self._shipped: list[Slab] = []     # waves whose pinned buffer lives
        self._flushed = (0, 0, 0)          # (transfers, buffers, bytes)
        self._column = 0
        self._last_reader: dict[int, int] = {}    # wave → last column
        self._refs: dict[int, list[Ref]] = {}     # wave → its refs
        self._storage: dict[int, int] = {}        # wave → device address
        self.dropped: set[int] = set()
        self.dropped_bytes = 0

    # -- queueing ------------------------------------------------------------
    def begin_column(self, k: int) -> None:
        """What is queued from now on is read by the ``k``-th decoded
        column (donation's bookkeeping)."""
        self._column = k

    def add(self, pieces) -> Ref:
        """Queue byte pieces back to back as one range; returns its ref."""
        mvs = [memoryview(p).cast("B") for p in pieces]
        nb = sum(len(m) for m in mvs)
        if nb == 0:
            return self._empty(torch.uint8)
        if not self.slabs:
            return self._eager(np.concatenate(
                [np.frombuffer(m, np.uint8) for m in mvs]), False)
        if self._over(nb, 0):
            self._ship()
        wave = self._filling()
        off = wave.nbytes
        for m in mvs:
            wave.add(m)
        return self._queued(off, nb, False)

    def add_meta(self, arr: np.ndarray) -> Ref:
        """Queue an int64 table as one range of the wave's table area."""
        arr = np.ascontiguousarray(arr, dtype=np.int64).reshape(-1)
        if arr.size == 0:
            return self._empty(torch.int64)
        if not self.slabs:
            return self._eager(arr, True)
        if self._over(0, arr.size):
            self._ship()
        off = self._filling().add_meta(arr)
        return self._queued(off, 8 * arr.size, True)

    def _over(self, nbytes: int, meta_len: int) -> bool:
        """Would the filling wave pass the cap with this range added?"""
        return (self._wave is not None and
                self._wave.total_with(nbytes, meta_len) > self.slab_cap)

    def _filling(self) -> Slab:
        if self._wave is None:
            self._wave = Slab()
        return self._wave

    def _empty(self, dtype: torch.dtype) -> Ref:
        """An empty range: resolved at once, it rides no wave."""
        ref = Ref(self, -1, 0, 0, dtype == torch.int64)
        ref._dev = torch.zeros(0, dtype=dtype, device=self.device)
        return ref

    def _queued(self, off: int, nb: int, is_meta: bool) -> Ref:
        ref = Ref(self, len(self.wave_bytes), off, nb, is_meta)
        self._wave_refs.append(ref)
        self._note(ref)
        return ref

    def _note(self, ref: Ref) -> None:
        self.buffers += 1
        self.staged_bytes += ref.nbytes
        self._last_reader[ref.wave] = self._column
        self._refs.setdefault(ref.wave, []).append(ref)

    def _eager(self, host: np.ndarray, is_meta: bool) -> Ref:
        """``SRJT_STAGE_SLABS=0``: the range's own upload, as a wave of
        one."""
        ref = Ref(self, len(self.wave_bytes), 0, host.nbytes, is_meta)
        with func_range("parquet.scan.upload"):
            ref._dev = column.upload(host, self.device)
        self._storage[ref.wave] = ref._dev.untyped_storage().data_ptr()
        self.transfers += 1
        self.wave_bytes.append(host.nbytes)
        self.wave_items.append(1)
        self._note(ref)
        return ref

    # -- transfer ------------------------------------------------------------
    def _ship(self) -> None:
        """Upload the filling wave (one non-blocking copy) and resolve its
        refs to views of it; release the pinned buffers whose copies have
        finished."""
        wave, refs = self._wave, self._wave_refs
        self._wave, self._wave_refs = None, []
        if wave is None:
            return
        index = len(self.wave_bytes)
        self.wave_bytes.append(wave.total)
        self.wave_items.append(len(refs))
        # its own range: the profiler ties a copy to the innermost range,
        # whose device-side annotation would otherwise span the walk
        with func_range("parquet.scan.upload"):
            data, meta = wave.upload(self.device)
        self._storage[index] = data.untyped_storage().data_ptr()
        for r in refs:
            r._dev = (meta[r.offset:r.offset + r.nbytes // 8]
                      if r.is_meta else data[r.offset:r.offset + r.nbytes])
        self.transfers += 1
        self.slab_bytes += wave.total
        self._shipped.append(wave)
        done = [w for w in self._shipped if w.copied()]
        for w in done:
            w.release()
        self._shipped = [w for w in self._shipped if w not in done]

    def flush(self) -> int:
        """Ship the filling wave; count the waves shipped since the last
        flush (metrics and a ``parquet.stage.flush`` flight event).
        Returns the number of transfers."""
        self._ship()
        t0, b0, n0 = self._flushed
        slabs, buffers = self.transfers - t0, self.buffers - b0
        nbytes = self.slab_bytes - n0
        self._flushed = (self.transfers, self.buffers, self.slab_bytes)
        if self.slabs and slabs:
            if metrics.recording():
                metrics.count("parquet.stage.slab_bytes", nbytes)
                metrics.count("parquet.stage.transfers", slabs)
                metrics.count("parquet.stage.buffers", buffers)
            flight.record("parquet.stage.flush", slabs=slabs,
                          buffers=buffers, bytes=nbytes)
        return slabs

    # -- donation ------------------------------------------------------------
    def drop_read_by(self, k: int) -> list[tuple[int, int]]:
        """Drop every wave whose last reader is column ``k`` or an earlier
        one: its refs' views go, and with them the stager's last hold on
        its device buffer.  Returns (device address, bytes) of each wave
        dropped."""
        out = []
        for wave, last in list(self._last_reader.items()):
            if last > k:
                continue
            del self._last_reader[wave]
            for r in self._refs.pop(wave, []):
                r._dev = None
            self.dropped.add(wave)
            self.dropped_bytes += self.wave_bytes[wave]
            out.append((self._storage.pop(wave), self.wave_bytes[wave]))
        return out

    def release(self) -> None:
        """The scan is over: wait for every copy out of a pinned buffer,
        then drop them, and drop every ref's view (the decoded columns
        own their storage), so that no wave outlives the scan."""
        for wave in self._shipped:
            wave.release()
        self._shipped = []
        for refs in self._refs.values():
            for r in refs:
                r._dev = None
        self._refs.clear()
        self._last_reader.clear()
        self.dropped.update(range(len(self.wave_bytes)))
