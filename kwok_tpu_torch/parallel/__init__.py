"""The multi-card row split (the port of ``kwok_tpu.parallel``).

The scale axis of this domain is object count: rows are independent, so
a kind's rows split over the shards of a mesh (``mesh.py``) and each
shard ticks its own rows (``sharded_tick.py``); the only thing summed
across shards is the pair of transition counters. A mesh may place
several shards on one device: the CPU tests use 8 shards of the CPU, and
on a host with several cards ``make_mesh()`` takes each card once.
"""

from kwok_tpu_torch.parallel.mesh import make_mesh, row_sharding
from kwok_tpu_torch.parallel.sharded_tick import ShardedTickKernel

__all__ = ["make_mesh", "row_sharding", "ShardedTickKernel"]
