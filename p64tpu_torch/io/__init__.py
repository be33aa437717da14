"""Host I/O of the port (checkpoints)."""
