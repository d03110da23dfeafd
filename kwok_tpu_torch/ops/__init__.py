"""Device-side engine ops on torch: SoA row state, the tick kernel, the
fused dispatch with its packed wire, and the ingest scatters."""

from kwok_tpu_torch.ops.state import RowState, TickOutputs, new_row_state
from kwok_tpu_torch.ops.tick import MultiTickKernel

__all__ = ["RowState", "TickOutputs", "new_row_state", "MultiTickKernel"]
