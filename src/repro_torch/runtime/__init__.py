"""Training runtime of the port: the train step and the fault-tolerance
supervisor (``repro/runtime``'s one-card part, ported)."""
