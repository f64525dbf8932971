"""The paper's own configuration: the DOD-ETL pipeline deployment knobs
(§3.1 "configuration process") plus the steelworks case-study schema
(§4: production / equipment / quality tables, OEE KPIs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """Per-table deployment parameters (paper §3.1)."""

    name: str
    nature: str                 # "operational" | "master"
    row_key: str                # unique row identifier column
    business_key: str           # domain partition/filter column
    columns: Tuple[str, ...]    # payload schema (fixed-width numeric rows)


@dataclasses.dataclass(frozen=True)
class ETLConfig:
    """Full DOD-ETL deployment configuration."""

    tables: Tuple[TableConfig, ...]
    n_partitions: int = 20       # operational-topic partitions (paper: 20)
    n_business_keys: int = 20    # distinct equipment units (paper: 20)
    cache_slots: int = 4096      # hash slots per in-memory master table
    cache_row_width: int = 8     # f32 payload lanes per master row
    buffer_capacity: int = 1024  # late-message ring buffer entries
    queue_retention: int = 1 << 20
    seed: int = 0
    backend: str = ""            # compute backend: "numpy" | "torch"
                                 # ("" = "torch")
    partition_strategy: str = "static"   # key->partition routing strategy:
                                 # "static" (hash%n), "consistent" (vnode
                                 # ring), "skew" (load-adaptive ranges)
    # --- concurrent runtime (repro.runtime.cluster.ConcurrentCluster) ---
    handoff_depth: int = 4       # bounded hand-off queue slots between the
                                 # ingest -> transform -> load worker stages
    idle_backoff_s: float = 0.001  # stage sleep when its input is drained
    credit_capacity: int = 4096  # per-worker flow-control credits (records):
                                 # ingest spends on fetch, load refunds at
                                 # commit — a stalled downstream exhausts the
                                 # ledger and throttles extraction

    def table(self, name: str) -> TableConfig:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(name)

    @property
    def operational_tables(self) -> Tuple[TableConfig, ...]:
        return tuple(t for t in self.tables if t.nature == "operational")

    @property
    def master_tables(self) -> Tuple[TableConfig, ...]:
        return tuple(t for t in self.tables if t.nature == "master")


def steelworks_config(n_partitions: int = 20, complex_model: bool = False,
                      backend: str = "",
                      partition_strategy: str = "static") -> ETLConfig:
    """The paper's steelworks deployment (§4).

    ``complex_model=True`` approximates the ISA-95 production workload of
    §4.1.4: each logical category is split across several normalized tables
    so the transform must perform deeper join chains.
    """
    if not complex_model:
        tables = (
            TableConfig("production", "operational", "prod_id", "equipment_id",
                        ("prod_id", "equipment_id", "txn_time", "t_start",
                         "t_end", "qty", "speed", "order_id")),
            TableConfig("equipment", "master", "equip_row_id", "equipment_id",
                        ("equip_row_id", "equipment_id", "txn_time", "t_start",
                         "t_end", "status", "max_speed", "planned")),
            TableConfig("quality", "master", "qual_row_id", "equipment_id",
                        ("qual_row_id", "equipment_id", "txn_time", "prod_id",
                         "defects", "grade", "scrap", "rework")),
        )
    else:
        # ISA-95-flavoured normalization: 9 tables, category split 3-ways.
        tables = tuple(
            TableConfig(f"{cat}_{part}",
                        "operational" if cat == "production" else "master",
                        f"{cat}_{part}_row", "equipment_id",
                        (f"{cat}_{part}_row", "equipment_id", "txn_time",
                         "a", "b", "c", "d", "e"))
            for cat in ("production", "equipment", "quality")
            for part in ("segment", "event", "detail")
        )
    return ETLConfig(tables=tables, n_partitions=n_partitions,
                     n_business_keys=n_partitions, backend=backend,
                     partition_strategy=partition_strategy)


# KPI definitions (paper §4): OEE = availability * performance * quality.
KPI_COLUMNS: Dict[str, int] = {
    "availability": 0,
    "performance": 1,
    "quality": 2,
    "oee": 3,
}
