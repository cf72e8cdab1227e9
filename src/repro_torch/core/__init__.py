"""Paper-layer runtimes of the port (counterpart: ``repro/core``)."""
