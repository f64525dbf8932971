"""Checkpoint files for the durability journal (``checkpoint``) and the LM
serving steps (``serve_step``)."""
