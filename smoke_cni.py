"""The CNI provider of chip_smoke.py's CNI phase.

``kwok --enable-cni true`` takes pod IPs from the provider that
``KWOK_TPU_CNI_PROVIDER`` names; the phase names this one
(``smoke_cni:PROVIDER``). It hands out addresses from 100.64.0.0/10, far
from the CIDR pool the phase gives kwok, and records every setup and
remove, so the phase can check each pod's IP and each deleted pod's
teardown.
"""

from __future__ import annotations

import ipaddress
import threading

FIRST = ipaddress.ip_address("100.64.0.1")


class Provider:
    """setup/remove as ``kwok_tpu_torch.cni`` calls them, thread-safe (the
    engine's executor workers call setup concurrently)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.next = 0
            self.setups: dict = {}  # (namespace, name) -> the IP handed out
            self.removes: list = []  # (namespace, name), in call order

    def setup(self, namespace: str, name: str, uid: str) -> list:
        with self._lock:
            ip = str(FIRST + self.next)
            self.next += 1
            self.setups[(namespace, name)] = ip
        return [ip]

    def remove(self, namespace: str, name: str, uid: str) -> None:
        with self._lock:
            self.removes.append((namespace, name))


PROVIDER = Provider()
