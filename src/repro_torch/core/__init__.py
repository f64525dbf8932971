"""DOD-ETL core: the paper's contribution as a composable library.

Change Tracker (cdc + listener) -> Message Queue (partitioned topics with
compaction) -> Stream Processor (In-memory Table Updater = cache, Data
Transformer = transformer + buffer, Target Database Updater = loader),
wired by pipeline; baseline is the unmodified-framework comparison point.
"""
from repro_torch.core.records import RecordBatch, make_batch, PAYLOAD_WIDTH  # noqa: F401
from repro_torch.core.backend import (  # noqa: F401
    ComputeBackend,
    FactBlock,
    available_backends,
    get_backend,
    register_backend,
)
from repro_torch.core.cdc import ChangeLog, SourceDatabase  # noqa: F401
from repro_torch.core.message_queue import MessageQueue, Topic, TopicConfig  # noqa: F401
from repro_torch.core.listener import ChangeTracker, Listener  # noqa: F401
from repro_torch.core.cache import InMemoryTable  # noqa: F401
from repro_torch.core.buffer import OperationalMessageBuffer  # noqa: F401
from repro_torch.core.transformer import DataTransformer, FACT_COLUMNS  # noqa: F401
from repro_torch.core.loader import StarSchemaWarehouse, WarehouseView  # noqa: F401
from repro_torch.core.metrics import LatencyRecorder, percentiles_ms  # noqa: F401
from repro_torch.core.pipeline import DODETLPipeline, StreamProcessorWorker  # noqa: F401
from repro_torch.core.baseline import BaselineStreamProcessor  # noqa: F401
from repro_torch.core.partitioning import (  # noqa: F401
    PartitionAssignment,
    PartitionStrategy,
    RoutingTable,
    get_strategy,
    hash_key,
    partition_of,
)
