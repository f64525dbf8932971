"""Durability layer: incremental journal checkpoints of the data plane +
exactly-once crash recovery.

Public surface:

* ``FaultInjector`` / ``InjectedCrash`` — deterministic named crash
  points at the pipeline's stage seams (``repro_torch.durability.faults``);
* ``DurabilityJournal`` — atomic incremental checkpoint steps built on
  ``repro_torch.train.checkpoint`` (``repro_torch.durability.journal``);
* ``RecoveryCoordinator`` / ``recover_pipeline`` — consistent capture at
  commit boundaries and full cold-restart restore
  (``repro_torch.durability.recovery``).

The journal's file layout is the reference package's, so a journal
written by either package restores in the other.
"""
from repro_torch.durability.faults import (CRASH_POINTS, FaultInjector,
                                           InjectedCrash, NULL_INJECTOR)
from repro_torch.durability.journal import DurabilityJournal
from repro_torch.durability.recovery import (RecoveryCoordinator,
                                             recover_pipeline)

__all__ = ["CRASH_POINTS", "FaultInjector", "InjectedCrash",
           "NULL_INJECTOR", "DurabilityJournal", "RecoveryCoordinator",
           "recover_pipeline"]
