"""BI serving layer: incremental materialized report views with
snapshot-isolated near-real-time queries (the read-side subsystem the
paper's 'near real-time reports previously unavailable' claim is about).

  views   — declarative ``ViewSpec``s (OEE per equipment, per-unit/shift
            KPI rollups, top-N downtime, windowed production rates)
  engine  — ``MaterializedViewEngine``: folds warehouse fact deltas into
            per-view aggregate state via the compute backend's
            ``fold_segments`` op; publishes immutable epochs
  server  — ``ReportServer``: O(n_segments) report queries with epoch +
            staleness stamps
  batch   — batched query plane: packed query plans answering thousands
            of heterogeneous queries in one backend dispatch per view,
            plus the ``BatchedReportServer`` admission front
"""
from repro_torch.serving.batch import (BatchedReportServer,  # noqa: F401
                                 BatchResult, BatchTicket, QueryPlan,
                                 ReportQuery, compile_queries)
from repro_torch.serving.engine import (EpochSnapshot, FactDelta,  # noqa: F401
                                  MaterializedViewEngine, ViewState,
                                  serving_clock)
from repro_torch.serving.server import (Report, ReportServer,  # noqa: F401
                                  ReportSnapshot, downtime_rank_keys)
from repro_torch.serving.views import (ViewSpec,  # noqa: F401
                                 downtime_by_equipment, kpi_by_unit_shift,
                                 oee_by_equipment, production_rate_windows,
                                 steelworks_views)

__all__ = [
    "EpochSnapshot", "FactDelta", "MaterializedViewEngine", "ViewState",
    "serving_clock", "Report", "ReportServer", "ReportSnapshot", "ViewSpec",
    "downtime_by_equipment", "kpi_by_unit_shift", "oee_by_equipment",
    "production_rate_windows", "steelworks_views", "downtime_rank_keys",
    "BatchedReportServer", "BatchResult", "BatchTicket", "QueryPlan",
    "ReportQuery", "compile_queries",
]
