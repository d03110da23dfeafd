"""kwok_tpu_torch.resilience: degraded mode and crash-durable restarts.

- ``policy``: the ``Degradation`` ledger behind ``kwok_degraded{reason=}``
  and the ``/readyz`` 503 (lane queue shedding, a checkpoint writer that
  cannot reach its disk, a spent restart budget, a pump target down past
  its resend deadline), ``RetryPolicy`` and the shared
  ``WATCH_RECONNECT``/``PATCH_RETRY``/``PUMP_RESEND`` policies.
- ``faults``: the deterministic fault plane (``EngineConfig.faults``,
  ``--faults``, ``KWOK_TPU_FAULTS``) wrapping the client transport, the
  pumps and the supervised workers, and the process lanes' shared-memory
  surfaces; ``kwok_tpu``'s grammar and seeded decision streams. Without
  a spec nothing exists and nothing is wrapped.
- ``watchdog``: supervised workers (watch threads, the lanes' router,
  drain and emit workers, federation members' watch threads, the process
  lanes' router and supervisor) restarted in place within a budget that
  the process-lane supervisor also charges for every lane respawn.
- ``checkpoint``: the periodic atomic-rename checkpoint of the device
  timer state (``--checkpoint-dir``) and the cold-start reconcile that
  resumes matching rows' Stage delays after a restart. The file format is
  ``kwok_tpu.resilience.checkpoint``'s: a file written by either package
  restores in the other.
- ``ha``: warm-standby HA (``EngineConfig.ha_role``, ``--ha-role``): the
  lease elector, the write fence on the client and the pumps, the
  observe-only hold and the takeover from the primary's checkpoint;
  ``kwok_tpu.resilience.ha``'s lease dialect and fencing header.
"""
