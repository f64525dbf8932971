"""Cluster runtimes (``cluster``: the concurrent stage-thread runtime and
the round-based simulated one) and their self-healing control plane
(``control``)."""
