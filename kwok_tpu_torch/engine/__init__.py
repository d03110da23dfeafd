"""Host controller: wires watch-ingest -> device tick -> patch-egress.

One ingest queue, a tick thread owning device dispatch on its own CUDA
stream, and a bounded-parallelism patch executor; with ``drain_shards``
above one, the threaded lanes of ``engine/lanes.py`` (a router, drain and
emit workers per lane, a coordinator over one stacked state per kind),
or with ``lane_procs`` the process lanes of ``engine/proclanes.py`` (one
spawned process per lane, each running the single-lane engine, fed over
the shared-memory arenas of ``engine/shm.py``).
"""

from kwok_tpu_torch.engine.engine import ClusterEngine, EngineConfig

__all__ = ["ClusterEngine", "EngineConfig"]
