"""CNI hook (the pkg/cni equivalent): the port's copy of
``kwok_tpu.cni``.

kwok can hand pod-IP allocation to real CNI plugins through a netns
dance on Linux (pkg/cni/cni_linux.go:30-83, netns_linux.go:66-165) and
stubs it elsewhere (cni_other.go:26-36). Here IPs come from the CIDR pool
(``kwok_tpu_torch.edge.ippool``) unless a provider is registered: the
hook points delegate to a pluggable provider, and default to a stub that
reports unavailability as the reference's non-Linux build does.
"""

from __future__ import annotations

import importlib
import os
from typing import Callable

__all__ = ["available", "setup", "remove", "register", "load_from_env"]

# provider: (setup(ns, name, uid) -> list[str], remove(ns, name, uid) -> None)
_provider: tuple[Callable, Callable] | None = None


def register(setup_fn: Callable, remove_fn: Callable) -> None:
    """Install a CNI provider (tests, or a provider loaded from the
    environment)."""
    global _provider
    _provider = (setup_fn, remove_fn)


def load_from_env() -> bool:
    """Install the provider named by KWOK_TPU_CNI_PROVIDER ("module" or
    "module:attr"; the object must expose setup/remove): the counterpart
    of the reference picking its CNI plugin binaries from /etc/cni/net.d
    at runtime (cni_linux.go:30-83). Returns False when the variable is
    unset."""
    spec = os.environ.get("KWOK_TPU_CNI_PROVIDER")
    if not spec:
        return False
    try:
        modname, _, attr = spec.partition(":")
        obj = importlib.import_module(modname)
        if attr:
            obj = getattr(obj, attr)
        register(obj.setup, obj.remove)
    except (ImportError, AttributeError, ValueError) as e:
        raise RuntimeError(
            f"KWOK_TPU_CNI_PROVIDER={spec!r} could not be loaded: {e} "
            "(expected 'module' or 'module:attr' exposing setup/remove)"
        ) from e
    return True


def available() -> bool:
    return _provider is not None


def setup(namespace: str, name: str, uid: str) -> list[str]:
    """Allocate IPs for a pod via CNI (cni_linux.go:30 Setup).

    Raises RuntimeError when no provider is registered: the engine then
    takes an IP from the pool, as cni_other.go:26-36's unsupported-platform
    error does.
    """
    if _provider is None:
        raise RuntimeError("cni: no provider registered (unsupported platform)")
    return _provider[0](namespace, name, uid)


def remove(namespace: str, name: str, uid: str) -> None:
    """Release a pod's CNI resources (cni_linux.go Remove)."""
    if _provider is None:
        raise RuntimeError("cni: no provider registered (unsupported platform)")
    _provider[1](namespace, name, uid)
