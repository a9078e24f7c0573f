"""Parallelism within a cluster (port of ``repro.parallel``): the pipeline
and its inner engine, the placement rules (``sharding``) and the
tensor-parallel and FSDP compute split they imply (``tensor``), and the
one point where a rank issues a collective (``comm``)."""
