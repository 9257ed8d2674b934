"""The port's benchmark: a data-driven harness over repro_torch (see README.md)."""
