"""Launch-time construction: the sharded serving plane's device mesh
(``mesh``)."""
