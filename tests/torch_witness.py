"""A pytest plugin: the port's runtime witnesses over a test run.

    KWOK_TPU_TORCH_LOCK_WITNESS=1 python -m pytest -p tests.torch_witness tests/test_torch_lanes.py
    KWOK_TPU_TORCH_SHM_WITNESS=1 python -m pytest -p tests.torch_witness tests/test_torch_proclanes.py

With ``KWOK_TPU_TORCH_LOCK_WITNESS=1`` every lock a test creates (the
RLocks of ``kwok_tpu_torch.locks.reclaimable()`` among them) is witnessed
(``kwok_tpu_torch/analysis/witness.py``): an acquisition-order cycle or a
violation of the port's declared order fails the test with both stacks.
With ``KWOK_TPU_TORCH_SHM_WITNESS=1`` every ``MetricsBank``,
``InflightSlot`` and ``RawRing`` call of ``kwok_tpu_torch.engine.shm`` is
held to its protocol (``kwok_tpu_torch/analysis/witness_shm.py``). Both
are off unless their variable is set: a witnessed acquisition captures a
stack.
"""

from __future__ import annotations

import os

import pytest


@pytest.fixture(autouse=True)
def port_lock_witness():
    if os.environ.get("KWOK_TPU_TORCH_LOCK_WITNESS") != "1":
        yield
        return
    from kwok_tpu_torch.analysis.witness import LockWitness

    w = LockWitness.install()
    try:
        yield
    finally:
        LockWitness.uninstall()
        w.assert_clean()


@pytest.fixture(autouse=True)
def port_shm_witness():
    if os.environ.get("KWOK_TPU_TORCH_SHM_WITNESS") != "1":
        yield
        return
    from kwok_tpu_torch.analysis.witness_shm import ShmWitness

    w = ShmWitness.install()
    try:
        yield
    finally:
        ShmWitness.uninstall()
        w.assert_clean()
