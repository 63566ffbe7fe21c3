"""Hash shuffle of JCUDF row blobs over a device mesh.

The port's counterpart of the JAX package's ``parallel/shuffle.py``: the
replacement for the external RapidsShuffle path the reference feeds.
Rows are partitioned by key hash and bucketized into fixed-capacity
per-destination buckets (the counts carry the dynamic part), and the
buckets are exchanged all to all.  The JAX package exchanges with
``lax.all_to_all`` inside ``shard_map``; here the shards are a loop and
:func:`all_to_all_shuffle` copies shard ``s``'s bucket ``d`` to shard
``d``'s device (``parallel/mesh.py``).

Capacity discipline, as in the JAX package: senders bound each
destination's payload; rows past ``capacity`` count in ``dropped``
(callers size capacity by a count pass and treat ``dropped > 0`` as an
error, the two-phase discipline of the string path).  The bucket
layout, the counts and ``dropped`` are the JAX package's exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils import metrics


class Buckets(NamedTuple):
    rows: torch.Tensor      # [P, capacity, row_size]
    counts: torch.Tensor    # int32 [P]: valid rows per bucket (≤ capacity)
    dropped: torch.Tensor   # int32 []: rows that exceeded capacity


def bucketize_rows(rows: torch.Tensor, part_id: torch.Tensor,
                   num_partitions: int, capacity: int) -> Buckets:
    """Group one shard's rows by destination into padded buckets.

    ``rows``: [n, row_size] (any dtype); ``part_id``: int [n] in
    [0, P).  A stable sort by destination, each row's rank within its
    destination, and a scatter that drops ranks past ``capacity``.  An
    out-of-range destination (a partitioner bug) goes to a sentinel
    partition and counts in ``dropped``, never into another bucket."""
    n, row_size = rows.shape
    dev = rows.device
    if metrics.recording():
        metrics.count("shuffle.bucketize.calls")
        metrics.count("shuffle.bucketize.payload_bytes",
                      n * row_size * rows.element_size())
    P = int(num_partitions)
    part = part_id.to(torch.int64)
    part = torch.where((part >= 0) & (part < P), part, P)
    order = torch.sort(part, stable=True).indices
    sorted_part = part[order]
    full = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    full.index_add_(0, part, torch.ones_like(part))
    counts = full[:P]
    starts = torch.cumsum(full, 0) - full
    rank = torch.arange(n, dtype=torch.int64, device=dev) \
        - starts[sorted_part]
    keep = (sorted_part < P) & (rank < capacity)
    buckets = torch.zeros((P, capacity, row_size), dtype=rows.dtype,
                          device=dev)
    buckets[sorted_part[keep], rank[keep]] = rows[order[keep]]
    clipped = counts.clamp(max=capacity)
    dropped = (n - clipped.sum()).to(torch.int32)
    return Buckets(buckets, clipped.to(torch.int32), dropped)


def salted_partition_ids(key: torch.Tensor, num_partitions: int,
                         salt: int) -> torch.Tensor:
    """Probe (fact) side destinations under salt-``S`` sub-partitioning:
    ``G = P // S`` key groups × ``S`` sub-partitions; a key hashes to
    group ``g`` and each of its rows round-robins (by its index in the
    shard) over ``g·S + j``.  ``salt == 1`` is plain hash partitioning.
    A hot key spreads over ``S`` shards (the AQE skew split)."""
    from ..ops.hashing import hash_partition, murmur3_32
    if salt <= 1:
        return hash_partition(murmur3_32(key), num_partitions)
    groups = num_partitions // salt
    g = hash_partition(murmur3_32(key), groups)
    sub = torch.arange(key.shape[0], dtype=torch.int32,
                       device=key.device) % salt
    return (g.to(torch.int32) * salt + sub).to(torch.int32)


def replicated_partition_ids(key_tiled: torch.Tensor, num_partitions: int,
                             salt: int) -> torch.Tensor:
    """Build side twin of :func:`salted_partition_ids`: ``key_tiled`` is
    the shard's build keys tiled ``S`` times (replica-major), and replica
    ``j`` of a key in group ``g`` goes to ``g·S + j``.  Every fact row
    meets exactly one replica of each matching build row, so the merged
    aggregate counts each pair once: salting gives the unsalted result
    bit for bit."""
    from ..ops.hashing import hash_partition, murmur3_32
    if salt <= 1:
        return hash_partition(murmur3_32(key_tiled), num_partitions)
    groups = num_partitions // salt
    n = key_tiled.shape[0] // salt
    g = hash_partition(murmur3_32(key_tiled), groups)
    replica = torch.arange(salt * n, dtype=torch.int32,
                           device=key_tiled.device) // max(n, 1)
    return (g.to(torch.int32) * salt + replica).to(torch.int32)


def bucket_reservation(num_partitions: int, capacity: int,
                       row_nbytes: int, sides: int = 1,
                       tag: str = "shuffle"):
    """Arena admission (``memory/arena.py``) for a sized exchange's
    padded buckets: every shard makes a ``[P, capacity, row_size]`` send
    buffer and receives its transpose, ``P² · capacity · row_bytes`` a
    side over the mesh.  A no-op when the arena is off."""
    from ..memory import arena
    nbytes = (int(num_partitions) ** 2 * int(capacity) * int(row_nbytes)
              * int(sides))
    return arena.reserve(nbytes, tag=tag)


def all_to_all_shuffle(shards: Sequence[Buckets], devices) -> list:
    """Exchange every shard's buckets: shard ``d`` receives bucket ``d``
    of each shard ``s`` (as its row ``s``), copied to ``devices[d]``.
    ``dropped`` stays with its sender."""
    P = len(shards)
    out = []
    for d in range(P):
        dev = torch.device(devices[d])
        rows = torch.stack([shards[s].rows[d].to(dev, copy=True)
                            for s in range(P)])
        counts = torch.stack([shards[s].counts[d].to(dev)
                              for s in range(P)])
        out.append(Buckets(rows, counts, shards[d].dropped))
    return out


def received_mask(buckets: Buckets) -> torch.Tensor:
    """bool [P, capacity]: which received slots hold real rows."""
    capacity = buckets.rows.shape[1]
    return (torch.arange(capacity, dtype=torch.int32,
                         device=buckets.counts.device)[None, :]
            < buckets.counts[:, None])


def record_shuffle_stats(shards: Sequence[Buckets]) -> dict:
    """Accounting of an exchange (received buckets of every shard): rows
    and bytes moved, rows dropped, and partition skew (max / mean bucket
    fill, the straggler predictor); fed to the ``shuffle.*`` metrics when
    they record."""
    counts = np.concatenate([b.counts.cpu().numpy().reshape(-1)
                             for b in shards])
    rows0 = shards[0].rows
    row_size = rows0.shape[-1] * rows0.element_size()
    valid_rows = int(counts.sum())
    mean = counts.mean() if counts.size else 0.0
    skew = float(counts.max() / mean) if valid_rows and mean > 0 else 1.0
    stats = {"rows": valid_rows,
             "bytes_moved": valid_rows * row_size,
             "dropped": int(sum(int(b.dropped) for b in shards)),
             "partition_skew": round(skew, 4)}
    if metrics.recording():
        metrics.count("shuffle.rows_moved", stats["rows"])
        metrics.count("shuffle.bytes_moved", stats["bytes_moved"])
        metrics.count("shuffle.rows_dropped", stats["dropped"])
        metrics.gauge_max("shuffle.partition_skew.max", skew)
        metrics.observe("shuffle.partition_skew", skew)
    return stats
