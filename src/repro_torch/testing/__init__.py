"""Deterministic test harnesses for the port's execution engine (fault
injection, see :mod:`repro_torch.testing.faults`).  Importable from the
hot path: the hooks are no-ops unless a plan is installed."""
