"""Training and serving steps: ``train_step`` (microbatched gradient
accumulation and the AdamW update), ``manual_dp`` (data parallel over
``torch.distributed``), ``compression`` (int8 error feedback),
``checkpoint`` (atomic steps for the durability journal and the trainer's
``CheckpointManager``) and ``serve_step`` (prefill and greedy decode)."""
