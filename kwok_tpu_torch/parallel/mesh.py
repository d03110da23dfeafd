"""The row split's mesh: an ordered list of torch devices, one per shard.

The port of ``kwok_tpu.parallel.mesh``. The JAX mesh is a 1-D
``jax.sharding.Mesh`` over distinct devices; here a mesh is a tuple of
torch devices that may repeat one: several shards can share a card (the
CPU tests split rows into 8 shards of the CPU, ``chip_smoke.py`` into 4
shards of one card), and on a host with more cards ``make_mesh()`` takes
each of them once. Shard ``i`` of a split state lives on ``devices[i]``
and all of its device work runs on ``streams[i]``, a CUDA stream of its
own (``on(i)``); on the CPU there are no streams.

``row_sharding(mesh)`` is the counterpart of the JAX ``NamedSharding``
over the row axis: a placement that turns a state (the port's torch
``RowState``, a split state, or ``kwok_tpu``'s numpy layout) into a
``SplitState`` whose shard ``i`` holds global rows ``[i*c/d, (i+1)*c/d)``.
"""

from __future__ import annotations

import contextlib

import torch

from kwok_tpu_torch.ops.state import SplitState, split_rows


def local_devices(device="cuda") -> list:
    """The devices of ``device``'s type this process sees, in index order
    (the counterpart of ``jax.devices()``): every visible card, or the CPU
    once. Raises when a card is asked for and none is visible."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu devices, not {kind}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "a cuda mesh needs a visible CUDA device (pass cpu devices to "
            "split rows on the CPU)"
        )
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """An ordered list of devices of one type, one per shard, with a CUDA
    stream per shard on a card."""

    def __init__(self, devices) -> None:
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices share one type: {devs}")
        self.devices = tuple(devs)
        self.streams = tuple(
            torch.cuda.Stream(d) if d.type == "cuda" else None for d in devs
        )
        # kernel launches per shard (the split dispatch adds one for each
        # shard it launches on a card; the CPU's plain version adds none)
        self.launches = [0] * len(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"

    def on(self, i: int):
        """Context that runs device work on shard ``i``'s stream (no-op
        on the CPU)."""
        s = self.streams[i]
        return contextlib.nullcontext() if s is None else torch.cuda.stream(s)

    def after_first(self, i: int) -> None:
        """Make shard ``i``'s stream wait for the work queued so far on
        the first device's current stream (call it outside ``on``): a
        dispatch's shard launches start after what its caller queued
        before it."""
        s = self.streams[i]
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(self.devices[0]))

    def to_first(self, i: int, tensors):
        """Shard ``i``'s tensors, made on its stream, ready for the current
        stream of the first device (call it outside ``on``). On that
        device the current stream waits for the shard's stream and the
        tensors are marked as used there; from another card they are
        copied over on the shard's stream, which PyTorch orders with the
        first device's current stream."""
        s = self.streams[i]
        if s is None:
            return list(tensors)
        dev0 = self.devices[0]
        if self.devices[i] == dev0:
            main = torch.cuda.current_stream(dev0)
            main.wait_stream(s)
            for t in tensors:
                t.record_stream(main)
            return list(tensors)
        with self.on(i):
            return [t.to(dev0) for t in tensors]


def make_mesh(n_devices: "int | None" = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: ``local_devices()``, every
    visible card once), cut to the first ``n_devices``. A device may
    repeat: each entry is one shard."""
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def row_sharding(mesh: Mesh):
    """The row placement over ``mesh``: a function from a state (torch
    ``RowState``, ``SplitState`` or ``kwok_tpu``'s numpy layout) to a
    ``SplitState`` on the mesh."""

    def place(state) -> SplitState:
        return split_rows(state, mesh)

    return place


def pad_to_multiple(n: int, mesh: Mesh) -> int:
    d = mesh.size
    return ((n + d - 1) // d) * d
