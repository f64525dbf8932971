"""Launch-time construction and analysis: the meshes (``mesh``: the
model's ("data", "model") mesh of ranks and the sharded serving plane's),
and the dry run (``dryrun``: every architecture x shape cell traced on
``meta`` tensors from ``specs``' abstract inputs and counted by
``step_analysis``, over ``--cards`` and a ``--model`` axis)."""
