"""Host controller: wires watch-ingest -> device tick -> patch-egress.

One ingest queue, a tick thread owning device dispatch on its own CUDA
stream, and a bounded-parallelism patch executor; with ``drain_shards``
above one, the threaded lanes of ``engine/lanes.py`` (a router, drain and
emit workers per lane, a coordinator over one stacked state per kind).
The process lanes of ``kwok_tpu.engine`` are a later slice.
"""

from kwok_tpu_torch.engine.engine import ClusterEngine, EngineConfig

__all__ = ["ClusterEngine", "EngineConfig"]
