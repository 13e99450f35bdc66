"""The sharded (data x graph) mesh path of the torch port: an in-process
grid of shard slots, each bound to a torch device (parallel/sharding.py),
and the collectives that join them (parallel/collectives.py)."""
