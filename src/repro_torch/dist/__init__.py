"""Graph-partitioned execution on one device (port of ``repro/dist/``:
``partition.py``).  The reference's mesh helpers (``sharding.py``,
``param_sharding.py``) wait for a multi-GPU arm."""
