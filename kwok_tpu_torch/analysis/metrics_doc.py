"""Metrics-contract rule: the telemetry surface and the docs agree.

Every metric family the port can export must be catalogued in its own
``kwok_tpu_torch/docs/observability.md``, and every ``kwok_*``/
``process_*`` family that catalogue names must exist in the port's code —
a dashboard built from the doc must never scrape a phantom, and a family
added in code must never ship undocumented. Label sets are also checked
for consistency: one family registered twice with different literal
label tuples is a runtime ``ValueError`` waiting for the second
registration to run.

Registered names come from three scans:

- literal first arguments of ``.counter(`` / ``.gauge(`` / ``.histogram(``
  calls anywhere in the tree (federation's aggregates, build info)
- all string constants in the registration surface — ``telemetry/``,
  ``kwok/server.py`` — which catches the dict-driven registrations
  (``_HELP`` / ``_COUNTERS`` in ``engine_metrics.py``) and the process
  collector the HTTP server appends
- the port's native apiserver (``kwok_tpu_torch/native/apiserver.cc``):
  every ``kwok_*`` name in a string literal there must be catalogued too

The package names ``kwok_tpu`` and ``kwok_tpu_torch`` match the family
pattern and are skipped on both sides: module docstrings and the
catalogue's prose name them.
"""

from __future__ import annotations

import ast
import os
import re

from kwok_tpu_torch.analysis.core import Finding, Module, Rule

# Family names: kwok_* (must not end in '_' — docs use `kwok_lane_*`
# wildcards) plus the one process collector the HTTP server appends.
# Chrome-trace metadata strings (process_name/thread_name) stay out.
_NAME_RE = re.compile(
    r"\b(?:kwok_[a-z0-9_]*[a-z0-9]|process_cpu_seconds_total)\b"
)
_REG_METHODS = ("counter", "gauge", "histogram")
# files whose string constants are treated as the registration surface
_SURFACE = ("telemetry" + os.sep, os.path.join("kwok", "server.py"))
_SUFFIXES = ("_bucket", "_count", "_sum")
# package names the family pattern matches in prose and paths
_PACKAGES = frozenset({"kwok_tpu", "kwok_tpu_torch"})


class MetricsContractRule(Rule):
    name = "metrics-doc"
    description = (
        "every registered metric family appears in the port's observability.md "
        "and vice versa; label sets are consistent across registrations"
    )

    def __init__(self, doc_path: str) -> None:
        self.doc_path = doc_path

    def check_project(self, mods: list[Module], root: str):
        registered: dict[str, tuple] = {}  # name -> (rel, line)
        labels: dict[str, dict] = {}       # name -> {labels tuple: (rel, line)}

        def note(name: str, rel: str, line: int) -> None:
            if name not in _PACKAGES:
                registered.setdefault(name, (rel, line))

        for mod in mods:
            surface = any(s in mod.rel for s in _SURFACE)
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ) and node.func.attr in _REG_METHODS and node.args:
                    first = node.args[0]
                    if isinstance(first, ast.Constant) and isinstance(
                        first.value, str
                    ) and _NAME_RE.fullmatch(first.value):
                        note(first.value, mod.rel, node.lineno)
                        lab = self._literal_labels(node)
                        if lab is not None:
                            prev = labels.setdefault(first.value, {})
                            prev.setdefault(lab, (mod.rel, node.lineno))
                elif surface and isinstance(node, ast.Constant) and \
                        isinstance(node.value, str):
                    for m in _NAME_RE.findall(node.value):
                        note(m, mod.rel, node.lineno)

        # native exposition surface: kwok_* names in the port's
        # apiserver.cc. Only QUOTED string literals are scanned — comments
        # routinely carry path references that would otherwise register a
        # phantom family. A histogram family's _bucket/_sum/_count sample
        # names fold into their parent via the same suffix rule the doc
        # side uses.
        cc_path = os.path.join(root, "kwok_tpu_torch", "native", "apiserver.cc")
        if os.path.exists(cc_path):
            cc_rel = os.path.relpath(cc_path, root)
            cc_str = re.compile(r'"((?:[^"\\]|\\.)*)"')
            with open(cc_path, encoding="utf-8") as fh:
                for i, line in enumerate(fh, 1):
                    for lit in cc_str.findall(line):
                        for m in _NAME_RE.findall(lit):
                            for suf in ("_bucket", "_count", "_sum"):
                                if m.endswith(suf):
                                    m = m[: -len(suf)]
                                    break
                            note(m, cc_rel, i)

        # label-set consistency across literal registrations
        for name, sets in labels.items():
            if len(sets) > 1:
                variants = sorted(sets.items())
                (rel, line) = variants[1][1]
                yield Finding(
                    rel, line, self.name,
                    f"{name} registered with inconsistent label sets: "
                    + " vs ".join(str(list(k)) for k, _ in variants),
                )

        if not os.path.exists(self.doc_path):
            yield Finding(
                os.path.relpath(self.doc_path, root), 1, self.name,
                "metric catalogue document is missing",
            )
            return
        with open(self.doc_path, encoding="utf-8") as fh:
            doc_lines = fh.read().splitlines()
        doc_rel = os.path.relpath(self.doc_path, root)
        documented: dict[str, int] = {}
        for i, line in enumerate(doc_lines, 1):
            for m in _NAME_RE.findall(line):
                if m not in _PACKAGES:
                    documented.setdefault(m, i)

        def base(name: str) -> str:
            for suf in _SUFFIXES:
                if name.endswith(suf) and name[: -len(suf)] in registered:
                    return name[: -len(suf)]
            return name

        for name, (rel, line) in sorted(registered.items()):
            if name not in documented:
                yield Finding(
                    rel, line, self.name,
                    f"metric {name} is registered/exported but not "
                    f"catalogued in {doc_rel}",
                )
        for name, line in sorted(documented.items()):
            if base(name) not in registered:
                yield Finding(
                    doc_rel, line, self.name,
                    f"metric {name} is catalogued in the doc but "
                    "registered nowhere in the tree",
                )

    @staticmethod
    def _literal_labels(call: ast.Call) -> "tuple | None":
        """The label-names argument when fully literal (positional third
        arg or label_names kwarg), else None."""
        cand = None
        if len(call.args) >= 3:
            cand = call.args[2]
        for kw in call.keywords:
            if kw.arg == "label_names":
                cand = kw.value
        if cand is None:
            return None
        if isinstance(cand, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in cand.elts
        ):
            return tuple(e.value for e in cand.elts)
        return None
