"""Distributed star-join aggregate over a device mesh.

The port's counterpart of the JAX package's ``parallel/dist_query.py``:
``SELECT group, SUM(value), COUNT(*) FROM fact ⋈ dim GROUP BY group``
with the fact table sharded over the mesh and the dimension replicated,
pre-sorted by key:

* per shard: a ``searchsorted`` probe of the shard's fact keys, misses
  routed to a sentinel group, and a fixed-width partial aggregate
  (``index_add_`` into ``num_groups + 1`` slots);
* the partials summed in shard order on the first shard's device (the
  ``psum``).

No host synchronisation: the group count is static (dictionary codes)
and every shape is fixed.  The fact arrays are global ``[n]`` tensors, n
divisible by the shard count, cut into contiguous shards as
``PartitionSpec(axis)`` shards them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..column import Column
from ..ops import strings as S
from ..utils import metrics
from .mesh import Mesh


class Dimension(NamedTuple):
    """A replicated, probe-ready dimension: keys sorted ascending, one
    int32 group code a key (``strings.dictionary_encode`` codes or any
    bounded categorical), and the static group count."""
    keys: torch.Tensor          # int [m], sorted ascending, unique
    group_codes: torch.Tensor   # int32 [m] in [0, num_groups)
    num_groups: int


def prepare_dimension(key_col: Column, group_col: Column) -> Dimension:
    """Host-side prep: sort by key; dictionary-encode the group column
    (string or integer) into dense codes."""
    keys = key_col.data.cpu().numpy()
    if np.unique(keys).shape[0] != keys.shape[0]:
        # a probe resolves each fact key to ONE dimension row: duplicate
        # keys would drop the shadowed rows' groups
        raise ValueError("dimension join keys must be unique")
    order = np.argsort(keys, kind="stable")
    dev = key_col.device
    if group_col.dtype.is_variable_width:
        codes_col, uniq = S.dictionary_encode(group_col)
        codes = codes_col.data.cpu().numpy()
        num_groups = uniq.num_rows
    else:
        vals = group_col.data.cpu().numpy()
        uniq_vals, codes = np.unique(vals, return_inverse=True)
        num_groups = int(uniq_vals.shape[0])
    return Dimension(torch.from_numpy(keys[order].copy()).to(dev),
                     torch.from_numpy(codes[order].astype(np.int32)).to(dev),
                     num_groups)


def shard(t: torch.Tensor, mesh: Mesh, axis_name="data") -> list:
    """The contiguous shards of a global tensor over ``axis_name``, each
    on its shard's device (a row count divisible by the shard count, as
    the JAX package's sharding requires)."""
    P = mesh.axis_size(axis_name)
    n = t.shape[0]
    if n % P:
        raise ValueError(f"{n} rows do not divide over {P} shards")
    k = n // P
    return [t[i * k:(i + 1) * k].to(mesh.devices[i]) for i in range(P)]


def _local_star_agg(num_groups: int, dim_keys, dim_codes, fact_key,
                    fact_value):
    dk = dim_keys.to(fact_key.device)
    pos = torch.searchsorted(dk, fact_key).clamp(0, dk.shape[0] - 1)
    hit = dk[pos] == fact_key
    # the sentinel group num_groups takes the misses
    g = torch.where(hit, dim_codes.to(fact_key.device)[pos].to(torch.int64),
                    num_groups)
    sums = torch.zeros(num_groups + 1, dtype=fact_value.dtype,
                       device=fact_key.device)
    sums.index_add_(0, g, torch.where(hit, fact_value,
                                      torch.zeros_like(fact_value)))
    cnts = torch.zeros(num_groups + 1, dtype=torch.int32,
                       device=fact_key.device)
    cnts.index_add_(0, g, hit.to(torch.int32))
    return sums[:num_groups], cnts[:num_groups]


def psum(parts: list) -> torch.Tensor:
    """The sum of per-shard partials in shard order, on the first
    shard's device (the JAX package's ``lax.psum``)."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p.to(out.device)
    return out


def distributed_star_agg(mesh: Mesh, dim: Dimension,
                         fact_key: torch.Tensor, fact_value: torch.Tensor,
                         axis_name="data"):
    """SELECT group, SUM(value), COUNT(*) FROM fact ⋈ dim GROUP BY group
    over the mesh.  ``fact_key`` / ``fact_value`` are global [n] tensors
    (n divisible by the shard count), sharded over ``axis_name`` (a name,
    or a tuple of names of a 2-D mesh); the dimension is replicated.
    Returns ([num_groups] sums, [num_groups] int32 counts), indexed by
    group code."""
    axis = tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else axis_name
    keys = shard(fact_key, mesh, axis)
    vals = shard(fact_value, mesh, axis)
    if metrics.recording():
        metrics.count("dist.star_agg.calls")
        metrics.count("dist.star_agg.fact_bytes",
                      fact_key.numel() * fact_key.element_size()
                      + fact_value.numel() * fact_value.element_size())
    with metrics.span("dist.star_agg", groups=dim.num_groups,
                      devices=mesh.size):
        parts = [_local_star_agg(dim.num_groups, dim.keys, dim.group_codes,
                                 k, v) for k, v in zip(keys, vals)]
        return psum([p[0] for p in parts]), psum([p[1] for p in parts])
