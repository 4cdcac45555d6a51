"""The per-shard rounds of sharded window scheduling (``core.shard``)."""
