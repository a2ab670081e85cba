"""Entry points of the port: ``serve`` (LM serving, evolutionary queries
and the retrieval front ends), the query server (``server``) and the
per-shard daemon (``shardd``)."""
