"""Launch-time construction and analysis: the sharded serving plane's
device mesh (``mesh``), and the dry run (``dryrun``: every architecture x
shape cell traced on ``meta`` tensors from ``specs``' abstract inputs and
counted by ``step_analysis``)."""
