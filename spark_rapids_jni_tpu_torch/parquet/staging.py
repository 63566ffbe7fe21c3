"""Host → device staging for the Parquet scan: one slab per file.

The port's counterpart of the JAX package's ``parquet/staging.py``, which
packs queued buffers into one slab per dtype and ships each with one
``device_put``.  Here every raw byte range the device needs (PLAIN
payloads, the bit-packed payloads of definition levels and dictionary
codes, dictionary values and chars) is appended to ONE uint8 host slab,
back to back with no alignment padding, and the int64 run tables follow at
the first 8-byte boundary after them.  :meth:`Slab.upload` fills a pinned
buffer and issues one non-blocking host → device copy on the current
stream; :meth:`Slab.release` waits for that copy before it lets the pinned
buffer go.

The decoded columns own their storage (``bytepath.u8_to_u32`` copies each
PLAIN range out, whatever its alignment), so the device slab is freed when
the scan returns.
"""

from __future__ import annotations

import numpy as np
import torch


class Slab:
    """Byte ranges and int64 run tables queued for one upload."""

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

    def upload(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """One copy of the whole slab to ``device``: (uint8 payload bytes,
        int64 run-table area), both views of one device buffer."""
        total = self.meta_start + 8 * self.meta_len
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

    def release(self) -> None:
        """Wait for the copy out of the pinned buffer, then drop it."""
        if self._copied is not None:
            self._copied.synchronize()
        self._pinned = None
        self._copied = None
