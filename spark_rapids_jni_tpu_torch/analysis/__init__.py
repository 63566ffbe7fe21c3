"""Static analysis and runtime sanitizers of the PyTorch port.

The port's copy of the JAX package's ``analysis/``, both halves:

* **Static** (``core``, ``concurrency``, ``tracepass``, ``knobpass``):
  AST passes over the port's package and ``chip_smoke.py``, run by
  ``tools/torch_lint.py`` (which loads them by file path: they are
  stdlib-only).  Lock-order inversions and unguarded shared mutation;
  host syncs (``.item()``, ``.tolist()``, ``.cpu()``, ``int()`` over a
  tensor) and tensor-valued branches in the code a CUDA graph captures;
  and knob drift (environment reads that bypass ``utils.knobs``).
* **Runtime** (:mod:`.sanitize`): ``SRJT_SANITIZE=1`` arms a lock-order
  watchdog and a recapture tripwire in the live process; ``strict``
  makes violations raise.

Import-light on purpose: the runtime modules import :mod:`.sanitize` at
process start, and the lint tool loads this package without torch.
"""

from __future__ import annotations

__all__ = ["core", "concurrency", "tracepass", "knobpass", "sanitize"]
