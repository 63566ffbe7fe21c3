"""Fault injection and the retry/quarantine/recovery executor (the
port's copy of the JAX package's ``faultinj/``; ``torch_shim`` is the
counterpart of its ``jax_shim``)."""

from .injector import (FaultInjector, fault_site, get_injector,  # noqa: F401
                       enable, disable)
from .resilience import DeviceQuarantined, ResilientExecutor  # noqa: F401
from . import torch_shim  # noqa: F401
