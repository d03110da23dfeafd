"""Host controller: wires watch-ingest -> device tick -> patch-egress.

One ingest queue, a tick thread owning device dispatch on its own CUDA
stream, and a bounded-parallelism patch executor. Single lane: the
threaded and process lanes of ``kwok_tpu.engine`` are later slices.
"""

from kwok_tpu_torch.engine.engine import ClusterEngine, EngineConfig

__all__ = ["ClusterEngine", "EngineConfig"]
