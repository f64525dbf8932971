"""Unified observability plane: lock-sharded metrics registry, stage-span
tracer (Chrome-trace/Perfetto export), and cluster/pipeline health
snapshots. See docs/OBSERVABILITY.md."""
from repro_torch.observability.health import (build_cluster_health,
                                        build_pipeline_health,
                                        merged_counters)
from repro_torch.observability.registry import (Counter, Gauge, MetricsRegistry,
                                          MetricsShard, global_registry)
from repro_torch.observability.tracer import NULL_TRACER, StageTracer

__all__ = [
    "Counter", "Gauge", "MetricsRegistry", "MetricsShard",
    "global_registry", "NULL_TRACER", "StageTracer",
    "build_cluster_health", "build_pipeline_health", "merged_counters",
]
