from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    abstract_state,
    apply_updates,
    global_norm,
    init_state,
    schedule,
)
