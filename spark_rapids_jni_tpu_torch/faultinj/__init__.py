"""Fault injection and the retry/quarantine/recovery executor (the
port's copy of the JAX package's ``faultinj/``, without its JAX shim)."""

from .injector import (FaultInjector, get_injector, enable,  # noqa: F401
                       disable)
from .resilience import DeviceQuarantined, ResilientExecutor  # noqa: F401
