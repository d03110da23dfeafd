"""The port stands alone: no module of kwok_tpu_torch/ and no line of
chip_smoke.py imports jax (or any jax* package) or kwok_tpu, and a "cuda"
engine on a host without a card raises instead of running on the CPU."""

from __future__ import annotations

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kwok_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative import stays inside the package
                out.append("kwok_tpu_torch." + (node.module or ""))
            else:
                out.append(node.module or "")
    return out


def forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top.startswith("jax") or top == "kwok_tpu"


def test_port_files_exist():
    assert (ROOT / "kwok_tpu_torch" / "csrc" / "tick.cu").exists()
    assert len(PORT_FILES) > 10


LANE_AND_RESILIENCE_MODULES = (
    "engine/lanes.py", "resilience/__init__.py", "resilience/policy.py",
    "resilience/checkpoint.py", "telemetry/lanes.py",
    "engine/proclanes.py", "engine/shm.py", "resilience/watchdog.py",
)


@pytest.mark.parametrize("rel", LANE_AND_RESILIENCE_MODULES)
def test_lane_and_resilience_modules_are_walked_and_import(rel):
    """The AST walk above covers the lane (threaded and process),
    shared-memory, resilience and lane-telemetry modules, and each
    imports without jax or kwok_tpu loaded for it."""
    import importlib

    path = ROOT / "kwok_tpu_torch" / rel
    assert path in PORT_FILES
    mod = "kwok_tpu_torch." + rel[:-3].replace("/", ".").removesuffix(".__init__")
    importlib.import_module(mod)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule():
    assert forbidden("jax") and forbidden("jaxlib.xla_client") and forbidden("jax.numpy")
    assert forbidden("kwok_tpu") and forbidden("kwok_tpu.ops.tick")
    assert not forbidden("kwok_tpu_torch.ops.tick") and not forbidden("torch")


def test_cuda_engine_without_card_raises(monkeypatch):
    from kwok_tpu_torch.edge.mockserver import FakeKube
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert EngineConfig(manage_all_nodes=True).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterEngine(FakeKube(), EngineConfig(manage_all_nodes=True))


@pytest.mark.parametrize("src", ["codec.cc", "pump.cc", "ingest.cc"])
def test_native_package_is_walked_and_its_sources_are_copies(src):
    """kwok_tpu_torch/native/ is in the walk above and imports alone; its
    C++ sources are byte-identical copies of kwok_tpu/native/'s, built into
    the port's own _build/ directory (nothing next to the sources)."""
    import importlib

    from kwok_tpu_torch import native

    assert ROOT / "kwok_tpu_torch" / "native" / "__init__.py" in PORT_FILES
    importlib.import_module("kwok_tpu_torch.native")
    port = ROOT / "kwok_tpu_torch" / "native" / src
    assert port.read_bytes() == (ROOT / "kwok_tpu" / "native" / src).read_bytes()
    assert str(port) in native.SOURCES
    assert pathlib.Path(native.library_path()).parent == ROOT / "kwok_tpu_torch" / "_build"
