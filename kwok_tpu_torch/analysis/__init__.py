"""kwoklint for the port: the static-analysis suite over ``kwok_tpu_torch``.

The port's copy of ``kwok_tpu.analysis``, with the port's own tables and
paths. The engine is concurrent (threaded and process lanes, a
federation, the fault plane, the auditor, warm-standby HA) and carries
native C++ of its own, so its invariants are checked here:

- ``locks``       — lock discipline against the port's declared lock
                    order (out-of-order nested acquisitions, blocking
                    calls held under a lock, locks created but never
                    acquired); ``locks.reclaimable()`` makes RLocks
- ``races``       — instance attributes of the concurrent classes
                    mutated from two thread roots outside a lock
- ``shmproto``    — the seqlock, slot and ring protocols of
                    ``engine/shm.py`` and the status bank's writer set
- ``spawnonly``   — multiprocessing only through a spawn context
- ``purity``      — no host syncs or host effects on the tick dispatch
                    path (the callers of ``cuda_tick.tick_steps`` and the
                    kernel launch, and ``pack_wire``)
- ``hygiene``     — no silent broad ``except``
- ``metrics_doc`` — the telemetry surface and
                    ``kwok_tpu_torch/docs/observability.md`` agree
- ``cclint``      — lock order, the write fence and socket writes under
                    a lock in ``kwok_tpu_torch/native/*.cc``

Run it as ``python -m kwok_tpu_torch.analysis``. Findings are
``file:line: severity [rule] message``; suppress one with an inline
``# kwoklint: disable=<rule> -- <justification>`` comment (the
justification is mandatory: a bare suppression is itself a finding).

The runtime complements are ``witness`` (an instrumented Lock/RLock
that fails on acquisition-order cycles or declared-order violations,
``KWOK_TPU_TORCH_LOCK_WITNESS=1``) and ``witness_shm`` (the shm
protocol's observable contract, ``KWOK_TPU_TORCH_SHM_WITNESS=1``).
"""

from kwok_tpu_torch.analysis.core import (
    Analyzer,
    Finding,
    Rule,
    all_rules,
    load_module,
)

__all__ = ["Analyzer", "Finding", "Rule", "all_rules", "load_module"]
