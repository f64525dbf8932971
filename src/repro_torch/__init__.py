"""DOD-ETL in PyTorch: the streaming ETL path (CDC log -> listeners ->
partitioned queue -> worker caches -> fused transform + rollup ->
warehouse load) and the report-serving views it feeds, with the hot ops
as hand-written CUDA kernels for Hopper (``repro_torch.kernels``).

Entry points (``DODETLPipeline``, ``MaterializedViewEngine``,
``get_backend``) run on ``device="cuda"`` unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version instead. The package imports ``torch`` and never ``jax``."""
