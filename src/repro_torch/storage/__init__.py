from . import columnar, kv  # noqa: F401
