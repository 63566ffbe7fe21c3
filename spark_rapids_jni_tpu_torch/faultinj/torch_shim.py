"""Torch-level fault interception (the CUPTI-shim analog).

The port's counterpart of the JAX package's ``faultinj/jax_shim.py``.
The reference's ``libcufaultinj.so`` subscribes to CUPTI's callback
domains and so sees every CUDA API call, not only named framework
functions.  The port's device work funnels through three seams of its
own, and this module patches them, routing each call to the same
injector and rule engine as the framework's sites:

==============  =============================================  ==============
site name       patched seam                                   CUDA analog
==============  =============================================  ==============
``torch.h2d``   ``column.upload`` (the constructors' copies),  cudaMemcpy
                ``parquet.staging.Slab.upload`` (the scan's)
``torch.build`` ``_native.build``, ``_native.library`` (a       cuModuleLoad
                library's first load since ``install``)
``torch.launch`` ``_native.launch`` (every hand-written        cuLaunchKernel
                kernel), ``models.compiled.graph_replay``
                (every CUDA-graph replay)
==============  =============================================  ==============

A launch made while a stream captures a graph is not intercepted: it
runs on the card only when the graph replays, and the replay is
intercepted.  PyTorch's own operators (aten) are not intercepted: the
seams are the launches this package makes itself, as the JAX shim's are
the programs JAX dispatches.

Rules use the injector's JSON schema (percent, interceptionCount,
injectionType), keyed by the site names above or ``"*"``.  A
``substitute`` rule has no return code to overwrite at these seams and
raises as ``device_error`` does, as in the JAX shim.  :data:`COUNTS`
counts each site's interceptions and the faults injected there
(``<site>.injected``) since :func:`install`.

Usage::

    from spark_rapids_jni_tpu_torch.faultinj import torch_shim
    torch_shim.install()        # idempotent
    ...
    torch_shim.uninstall()
"""

from __future__ import annotations

import collections
import functools

from ..analysis import sanitize
from .injector import InjectedDeviceError, InjectedOomError, get_injector

_LOCK = sanitize.tracked_lock("faultinj.torch_shim")
_PATCHED: dict[str, tuple] = {}
_LOADED: set = set()        # libraries loaded through the shim

#: interceptions per site, and faults injected (``<site>.injected``),
#: since :func:`install`
COUNTS: collections.Counter = collections.Counter()


def _capturing() -> bool:
    import torch
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _intercept(site: str, fn, *args, **kwargs):
    if site == "torch.launch" and _capturing():
        return fn(*args, **kwargs)
    COUNTS[site] += 1
    try:
        hit = get_injector().check(site)
    except (InjectedDeviceError, InjectedOomError):
        COUNTS[f"{site}.injected"] += 1
        raise
    if hit is not None:
        # a substituted value means nothing for a copy, build or launch:
        # escalate as the reference's trap kernel does
        COUNTS[f"{site}.injected"] += 1
        raise InjectedDeviceError(
            f"[faultinj] injected device error at site {site!r}")
    return fn(*args, **kwargs)


def _seams():
    """(holder, attribute, site) of every patched seam."""
    from .. import _native, column
    from ..models import compiled
    from ..parquet import staging
    return [(column, "upload", "torch.h2d"),
            (staging.Slab, "upload", "torch.h2d"),
            (_native, "build", "torch.build"),
            (_native, "library", "torch.build"),
            (_native, "launch", "torch.launch"),
            (compiled, "graph_replay", "torch.launch")]


def install() -> list[str]:
    """Patch the seams (idempotent).  Returns the site names active."""
    with _LOCK:
        if not _PATCHED:
            # resolve every seam before patching any, so that a failure
            # leaves nothing half-installed
            seams = [(h, a, site, getattr(h, a)) for h, a, site in _seams()]
            COUNTS.clear()
            for holder, attr, site, orig in seams:
                @functools.wraps(orig)
                def shim(*a, _orig=orig, _site=site, **k):
                    return _intercept(_site, _orig, *a, **k)
                if attr == "library":
                    shim = _library_shim(orig)
                setattr(holder, attr, shim)
                _PATCHED[f"{site}:{getattr(holder, '__name__', holder)}."
                         f"{attr}"] = (holder, attr, orig)
        return sorted({k.split(":")[0] for k in _PATCHED})


def _library_shim(orig):
    """``_native.library`` intercepted on a library's first load only:
    every launch asks for its (cached) library, which is no load."""
    @functools.wraps(orig)
    def shim(name):
        if name in _LOADED:
            return orig(name)
        lib = _intercept("torch.build", orig, name)
        _LOADED.add(name)
        return lib
    # keep the lru_cache's controls reachable
    shim.cache_clear = orig.cache_clear
    shim.cache_info = orig.cache_info
    return shim


def uninstall() -> None:
    with _LOCK:
        for holder, attr, orig in _PATCHED.values():
            setattr(holder, attr, orig)
        _PATCHED.clear()
        _LOADED.clear()


def installed() -> bool:
    return bool(_PATCHED)
