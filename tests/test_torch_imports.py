"""The port stands alone: no module of kwok_tpu_torch/ and no line of
chip_smoke.py, mock_ab.py or drift_rig.py imports jax (or any jax* package) or kwok_tpu, and a "cuda"
engine on a host without a card raises instead of running on the CPU."""

from __future__ import annotations

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kwok_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "mock_ab.py", ROOT / "drift_rig.py"]


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
    "resilience/antientropy.py",
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


# the port's repairs to its copies of kwok_tpu/native/ (ROADMAP §3): each
# (reference text, port text); everything else is byte-identical
PORT_REPAIRS = {
    "apiserver.cc": [
        # a string holding malformed UTF-8 (a garbled byte in a patch) was
        # stored as it came and broke every later LIST's decode
        ("""  std::string string() {
    std::string out;""", """  // the length of the well-formed UTF-8 sequence at p (a lead byte of 2
  // to 4 bytes), or 0: truncated, a stray continuation byte, an overlong
  // form or past U+10FFFF. An encoded surrogate passes, as Python's
  // json.loads takes it from bytes
  static size_t utf8_len(const char* p, const char* end) {
    unsigned char c = (unsigned char)p[0];
    size_t n = c >= 0xC2 && c <= 0xDF ? 2 : c >= 0xE0 && c <= 0xEF ? 3
             : c >= 0xF0 && c <= 0xF4 ? 4 : 0;
    if (!n || (size_t)(end - p) < n) return 0;
    for (size_t i = 1; i < n; i++)
      if (((unsigned char)p[i] & 0xC0) != 0x80) return 0;
    unsigned char c1 = (unsigned char)p[1];
    if ((c == 0xE0 && c1 < 0xA0) || (c == 0xF0 && c1 < 0x90) ||
        (c == 0xF4 && c1 > 0x8F))
      return 0;
    return n;
  }

  std::string string() {
    std::string out;"""),
        ("""        p++;
      } else {
        out += *p++;
      }
    }
    if (p < end) p++;  // closing quote""", """        p++;
      } else if ((unsigned char)*p < 0x80) {
        out += *p++;
      } else {
        // JSON text is UTF-8: a malformed sequence (a garbled byte) makes
        // the body unparseable, as Python's json.loads finds it, instead
        // of landing in the store and in every later LIST
        size_t n = utf8_len(p, end);
        if (!n) {
          ok = false;
          return out;
        }
        out.append(p, n);
        p += n;
      }
    }
    if (p < end) p++;  // closing quote"""),
    ],
    "ingest.cc": [
        # an unterminated string (a watch line cut mid-string) left its
        # length unset and fp_value hashed that many bytes past the line
        ("""      c.p += 2;
      continue;""", """      c.p += 2;  // an escape at the very end leaves p past end: clamped below
      continue;"""),
        ("""    c.p++;
  }
  c.ok = false;
  return false;
}

uint64_t fp_value(Cursor& c);""", """    c.p++;
  }
  // unterminated (a line cut mid-string): no length to hand out, and the
  // cursor stays inside the line
  c.p = c.end;
  *len = 0;
  c.ok = false;
  return false;
}

uint64_t fp_value(Cursor& c);"""),
        ("""      raw_string(c, &s, &n);
      return fnv(s, n) ^ 0x5bd1e995u;""", """      if (!raw_string(c, &s, &n)) return 0;  // unterminated: c.ok is false
      return fnv(s, n) ^ 0x5bd1e995u;"""),
    ],
}


# the port's additions to its copies: each (reference text, port text).
# The drift rig's routes of the native mock (--rig-routes, off by
# default; drift_rig.py and chip_smoke.py's drift phase): a window the
# rig can set, the flag, the dispatch, and the routes themselves, the
# block between the two marker lines of apiserver.cc
RIG_BEGIN, RIG_END = "// >>> the port's drift rig routes\n", "// <<< the port's drift rig routes\n"


def _rig_block() -> str:
    text = (ROOT / "kwok_tpu_torch" / "native" / "apiserver.cc").read_text()
    return text[text.index(RIG_BEGIN):text.index(RIG_END) + len(RIG_END)]


PORT_ADDITIONS = {
    "apiserver.cc": [
        ("""static int rv_window() {
  static const int w = [] {
    const char* v = getenv("KWOK_TPU_RV_WINDOW");
    return v && *v ? atoi(v) : 4096;
  }();
  return w;
}""", """static std::atomic<int>& rv_window_cell() {
  static std::atomic<int> w{[] {
    const char* v = getenv("KWOK_TPU_RV_WINDOW");
    return v && *v ? atoi(v) : 4096;
  }()};
  return w;
}
// the drift rig's POST /rig/window sets it (--rig-routes)
static int rv_window() { return rv_window_cell().load(std::memory_order_relaxed); }

// --rig-routes: serve the drift rig's /rig/ routes (rig_route below)
static bool g_rig_routes = false;"""),
        ("""    return respond(200,
                   "{\\"compactedRevision\\":" + std::to_string(crv) + "}");
  }
""", """    return respond(200,
                   "{\\"compactedRevision\\":" + std::to_string(crv) + "}");
  }
  if (g_rig_routes && req.path.rfind("/rig/", 0) == 0) {
    int code;
    std::string body = rig_route(store, req, code);
    return respond(code, body);
  }
"""),
        ("""    else if (a == "--authorization") authorization = true;
  }""", """    else if (a == "--authorization") authorization = true;
    else if (a == "--rig-routes") g_rig_routes = true;
  }"""),
        ("bool App::handle_request(ConnIO& io, Request& req) {",
         None),  # the rig block goes in front of it (_rig_block)
    ],
}


@pytest.mark.parametrize("src", ["codec.cc", "pump.cc", "ingest.cc", "apiserver.cc"])
def test_native_package_is_walked_and_its_sources_are_copies(src):
    """kwok_tpu_torch/native/ is in the walk above and imports alone; its
    C++ sources are copies of kwok_tpu/native/'s, byte-identical but for
    the repairs in PORT_REPAIRS and the additions in PORT_ADDITIONS, built into the port's own _build/
    directory (nothing next to the sources): the library's three, and the
    mock apiserver, a program of its own that is not in the library's
    sources."""
    import importlib

    from kwok_tpu_torch import native

    assert ROOT / "kwok_tpu_torch" / "native" / "__init__.py" in PORT_FILES
    importlib.import_module("kwok_tpu_torch.native")
    port = ROOT / "kwok_tpu_torch" / "native" / src
    ref = (ROOT / "kwok_tpu" / "native" / src).read_text()
    for old, new in PORT_REPAIRS.get(src, []) + PORT_ADDITIONS.get(src, []):
        assert ref.count(old) == 1, old
        ref = ref.replace(old, _rig_block() + "\n" + old if new is None else new)
    assert port.read_text() == ref
    build = ROOT / "kwok_tpu_torch" / "_build"
    if src == "apiserver.cc":
        assert str(port) not in native.SOURCES and native.APISERVER_SOURCE == str(port)
        assert pathlib.Path(native.apiserver_path()).parent == build
    else:
        assert str(port) in native.SOURCES
    assert pathlib.Path(native.library_path()).parent == build
