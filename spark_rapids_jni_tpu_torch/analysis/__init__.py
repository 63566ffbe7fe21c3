"""Runtime sanitizers of the PyTorch port.

The port's copy of the JAX package's ``analysis/``, so far only its
runtime half: :mod:`.sanitize` (``SRJT_SANITIZE=1`` arms a lock-order
watchdog and a recapture tripwire in the live process; ``strict`` makes
violations raise).  The static passes, retargeted to flag ``.item()`` and
``.cpu()`` syncs, are still to come.

Import-light on purpose: the runtime modules import
:mod:`.sanitize` at process start.
"""

from __future__ import annotations

__all__ = ["sanitize"]
