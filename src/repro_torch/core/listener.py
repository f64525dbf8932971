"""Listener + Message Producer (paper §3.1.1, Change Tracker).

One Listener per extracted table. Each Listener scans the *shared* CDC log
from its own offset and filters its table's records — MySQL-binlog
semantics, which is exactly why the paper's Fig. 5 saturates: the scan cost
is O(total log), the yield is O(own-table records). Listeners never query
production tables.

The Message Producer partitions extracted records per the table nature
(master -> row key, operational -> business key) and publishes to the queue.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.dod_etl import ETLConfig, TableConfig
from repro_torch.core.cdc import ChangeLog
from repro_torch.core.message_queue import MessageQueue, TopicConfig
from repro_torch.core.records import RecordBatch


class Listener:
    def __init__(self, table: TableConfig, table_id: int, log: ChangeLog,
                 queue: MessageQueue, topic: str):
        self.table = table
        self.table_id = table_id
        self.log = log
        self.queue = queue
        self.topic = topic
        self.offset = 0              # LSN position in the shared log
        self.records_extracted = 0
        self.records_scanned = 0
        self.wall_s = 0.0

    def poll(self, limit: Optional[int] = None) -> int:
        """One extraction round: scan log from offset, filter own table,
        publish. Returns records extracted."""
        t0 = time.perf_counter()
        batch, scanned = self.log.read_from(self.offset, limit)
        self.records_scanned += scanned
        if len(batch):
            mine = batch.filter(batch.table_id == self.table_id)
            if len(mine):
                self.queue.publish(self.topic, mine)
                self.records_extracted += len(mine)
            # advance the offset only AFTER publishing: extraction-lag
            # watchers treat `offset == log head` as "everything scanned is
            # in the queue", so the reverse order opened a window where a
            # drain check could declare the stream complete mid-publish
            self.offset = int(batch.lsn[-1]) + 1
            n = len(mine)
        else:
            n = 0
        self.wall_s += time.perf_counter() - t0
        return n


class ChangeTracker:
    """All Listeners for a deployment + topic bootstrap."""

    def __init__(self, cfg: ETLConfig, log: ChangeLog, queue: MessageQueue):
        self.cfg = cfg
        self.listeners: List[Listener] = []
        self.table_ids: Dict[str, int] = {}
        # extraction lock: a durability capture acquires it so listener
        # offsets and broker content are snapshotted at a poll boundary —
        # capturing between a Listener's publish and its offset advance
        # would journal the records AND an offset that re-extracts them
        # (duplicates on replay)
        self.lock = threading.Lock()
        for tid, table in enumerate(cfg.tables):
            self.table_ids[table.name] = tid
            topic_name = f"topic.{table.name}"
            queue.create_topic(TopicConfig(
                name=topic_name,
                table_id=tid,
                n_partitions=cfg.n_partitions,
                partition_by=("business_key" if table.nature == "operational"
                              else "row_key"),
                compacted=table.nature == "master",
            ))
            self.listeners.append(Listener(table, tid, log, queue, topic_name))

    def poll_all(self, limit_per_table: Optional[int] = None) -> int:
        """One extraction round over every Listener. Master tables are
        polled FIRST: their records feed the In-memory caches (§3.1.2), so
        giving them extraction priority warms caches before the operational
        records that join against them — fewer records take the late-buffer
        detour on a cold start."""
        ordered = sorted(self.listeners,
                         key=lambda l: l.table.nature != "master")
        with self.lock:
            return sum(l.poll(limit_per_table) for l in ordered)

    def topic_of(self, table_name: str) -> str:
        return f"topic.{table_name}"
