"""Checkpoint files for the durability journal (``checkpoint``)."""
