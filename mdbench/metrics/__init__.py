"""Per-layer metrics, one reader a file: ``read(ctx)`` returns the
metric's number, or None where the run has nothing to read for it
(``ctx`` is ``mdbench.harness.Context``)."""
