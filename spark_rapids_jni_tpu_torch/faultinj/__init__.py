"""Fault injection and the retry/quarantine/recovery executor (the
port's copy of the JAX package's ``faultinj/``; ``torch_shim`` is the
counterpart of its ``jax_shim``)."""

from .injector import (FaultInjector, get_injector, enable,  # noqa: F401
                       disable)
from .resilience import DeviceQuarantined, ResilientExecutor  # noqa: F401
from . import torch_shim  # noqa: F401
