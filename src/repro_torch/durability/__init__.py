"""Durability layer: deterministic named crash points at the pipeline's
stage seams (``repro_torch.durability.faults``). The journal and recovery
coordinator are not ported yet."""
from repro_torch.durability.faults import (CRASH_POINTS,  # noqa: F401
                                           NULL_INJECTOR, FaultInjector,
                                           InjectedCrash)

__all__ = ["CRASH_POINTS", "FaultInjector", "InjectedCrash", "NULL_INJECTOR"]
