"""Canonical import surface of the fault-injection framework.

The implementation lives in :mod:`repro_torch.faults` (top-level and
stdlib-only, so the compression layer's store can register injection
points without importing ``repro_torch.core`` — which imports the store right
back).  Import from here::

    from repro_torch.core.faults import FaultSpec, inject_faults

See the :mod:`repro_torch.faults` module docs for the point registry, fault
kinds and spec syntax.
"""
from ..faults import (  # noqa: F401
    INJECTION_POINTS,
    FaultInjector,
    FaultSpec,
    InjectedCrash,
    active_injector,
    clear_faults,
    fault_point,
    inject_faults,
    install_faults,
)

__all__ = [
    "INJECTION_POINTS",
    "FaultInjector",
    "FaultSpec",
    "InjectedCrash",
    "active_injector",
    "clear_faults",
    "fault_point",
    "inject_faults",
    "install_faults",
]
