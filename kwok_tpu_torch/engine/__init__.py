"""Host controller: wires watch-ingest -> device tick -> patch-egress.

One ingest queue, a tick thread owning device dispatch on its own CUDA
stream, and a bounded-parallelism patch executor; with ``drain_shards``
above one, the threaded lanes of ``engine/lanes.py`` (a router, drain and
emit workers per lane, a coordinator over one stacked state per kind),
or with ``lane_procs`` the process lanes of ``engine/proclanes.py`` (one
spawned process per lane, each running the single-lane engine, fed over
the shared-memory arenas of ``engine/shm.py``). ``FederatedEngine``
(``engine/federation.py``) drives several apiservers' member engines from
one tick thread and one stacked state per rule-set group.
"""

from kwok_tpu_torch.engine.engine import ClusterEngine, EngineConfig
from kwok_tpu_torch.engine.federation import FederatedEngine

__all__ = ["ClusterEngine", "EngineConfig", "FederatedEngine"]
