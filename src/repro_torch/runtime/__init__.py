"""Execution backends: the host plan-IR executor, host-to-device staging,
the torch bitmap executor (with its sharded layout), and sharded host
retrieval with its fault, replica and RPC layers."""
