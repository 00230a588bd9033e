"""Training of the port: the supervised trainer (``trainer``), its
optimizer, schedules and metrics."""
