"""kwok_tpu_torch: the kwok engine on PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``kwok_tpu``, which stays the reference it is
tested against. This package imports ``torch``, numpy and the standard
library only; the host modules it shares with ``kwok_tpu`` (rule models,
the API edge, the row pool) are its own copies.

- ``kwok_tpu_torch.ops``: the struct-of-arrays row state on a torch
  device, the K-substep tick kernel (``csrc/tick.cu``, bound through
  ``ops/cuda_tick.py``), the fused two-kind dispatch with its packed wire,
  and the ingest scatters.
- ``kwok_tpu_torch.engine``: the single-lane ``ClusterEngine`` (watch ->
  ingest -> fused tick -> wire -> status patches).
- ``kwok_tpu_torch.edge``: the KubeClient protocol, the HTTP client,
  renderers, strategic merge, and a small apiserver in memory and over
  HTTP (``edge/mockserver``).
- ``kwok_tpu_torch.config``: the config file, ``KWOK_*`` env overrides and
  Stage rules.
- ``kwok_tpu_torch.kwok``: the ``kwok`` entry point
  (``python -m kwok_tpu_torch.kwok``) and its healthz/metrics server.
"""

__version__ = "0.1.0"
