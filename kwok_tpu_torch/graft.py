"""The port's twin of ``__graft_entry__.entry()``: the flagship step.

``entry(device="cuda")`` returns ``(step, example_args)``. ``step(state,
now, seed)`` advances a pod population one dispatch through the tick
kernel (``csrc/tick.cu``, launched by ``ops/cuda_tick.tick_steps``) and
returns ``(dirty, deleted, hb_fired, counts)``; the state is updated in
place. The workload is ``__graft_entry__.entry()``'s:

- 65,536 pod rows, every row active with ``sel_bits`` 0b11 (on a managed
  node, managed), as ``__graft_entry__._seeded_pod_state`` seeds them;
- the chaos rules, ``chaos_pod_rules(mean_run_seconds=5.0)``: the default
  pod lifecycle, then completion after an exponential delay;
- the heartbeat wheel of ``tick_body(..., 30.0, 0, -1)``: a 30 s interval,
  no heartbeat phases and no heartbeat selector bit;
- one substep (K=1) per dispatch.

The draws differ from the reference's: ``tick_body`` takes a threefry key,
the port's kernel hashes (row, substep, seed) as ``PallasTickKernel``
does, and ``example_args`` carries the seed of a port engine's first
dispatch (``SEED_BASE + 1``).

On a CUDA device the step launches the kernel or raises. The plain torch
version runs only when the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import torch

from kwok_tpu_torch.models import compile_rules
from kwok_tpu_torch.models.defaults import chaos_pod_rules
from kwok_tpu_torch.models.lifecycle import ResourceKind
from kwok_tpu_torch.ops import cuda_tick
from kwok_tpu_torch.ops.state import RowState, new_row_state

ROWS = 65536
MEAN_RUN_SECONDS = 5.0
HB_INTERVAL = 30.0
SEED = cuda_tick.SEED_BASE + 1


def seeded_pod_state(capacity: int, device) -> RowState:
    """``capacity`` active managed pod rows on ``device``."""
    state = new_row_state(capacity, device)
    state.active.fill_(True)
    state.sel_bits.fill_(0b11)  # on-managed-node | managed
    return state


class GraftStep:
    """One dispatch of the chaos pod rules, K=1."""

    def __init__(self) -> None:
        table = compile_rules(
            chaos_pod_rules(mean_run_seconds=MEAN_RUN_SECONDS), ResourceKind.POD
        )
        self.spec = cuda_tick.TickSpec(table, HB_INTERVAL, (), -1)

    def __call__(self, state: RowState, now: float, seed: int):
        return cuda_tick.tick_steps(state, self.spec, now, seed, 1, 0.0)


def entry(device="cuda"):
    """``(step, (state, now, seed))`` on ``device``; a CUDA device must be
    present when one is asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the graft step wants a CUDA device; pass device='cpu' for the plain version")
    return GraftStep(), (seeded_pod_state(ROWS, dev), 0.0, SEED)
