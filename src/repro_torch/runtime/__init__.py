"""Execution backends: the host plan-IR executor, host-to-device staging
and the torch bitmap executor."""
