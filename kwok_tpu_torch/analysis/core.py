"""kwoklint framework: modules, findings, suppressions, the rule API.

Small on purpose. A rule sees parsed modules (``ast`` trees + raw source)
and yields :class:`Finding`s; the framework owns everything else — file
discovery, suppression comments, severity ordering, text/JSON rendering,
exit codes. Rules never import heavyweight runtime deps (no torch, no
engine), so ``python -m kwok_tpu_torch.analysis`` runs in seconds.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import time
import tokenize
from typing import Iterable, Iterator

SEVERITIES = ("error", "warning")

# Inline suppression: `# kwoklint: disable=rule-a,rule-b -- why this is ok`
# on the offending line or the line directly above it. The trailing text is
# the justification and is MANDATORY (acceptance criterion: every
# suppression carries one); a bare suppression is reported itself.
_SUPPRESS_RE = re.compile(
    r"#\s*kwoklint:\s*disable=([A-Za-z0-9_,\-]+)\s*(.*)$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: a file:line, the rule that fired, and the story."""

    path: str  # repo-relative path
    line: int
    rule: str
    message: str
    severity: str = "error"

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.severity} [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int
    rules: tuple[str, ...]
    justification: str


class Module:
    """One parsed source file plus its suppression table."""

    def __init__(self, path: str, rel: str, source: str) -> None:
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel)
        self.suppressions: dict[int, Suppression] = {}
        # suppression lines that silenced something this run (finding- or
        # scan-level); anything left over is stale and reported as such
        self.used_suppressions: set[int] = set()
        self.scan_suppressed = 0  # would-be findings silenced at scan time
        self._scan_suppressions()

    @property
    def modname(self) -> str:
        return os.path.basename(self.path).rsplit(".", 1)[0]

    def _scan_suppressions(self) -> None:
        # tokenize, not line-regex: a '#' inside a string literal must not
        # read as a comment (the rules' own sources mention the marker)
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(self.source).readline
            )
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                rules = tuple(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                just = m.group(2).strip().lstrip("-—:· ").strip()
                self.suppressions[tok.start[0]] = Suppression(
                    tok.start[0], rules, just
                )
        except tokenize.TokenError:
            # a half-written file still gets analyzed from its (already
            # parsed) AST; only the comment scan degrades
            pass

    def suppression_for(self, line: int, rule: str) -> Suppression | None:
        """A finding at `line` is suppressed by a marker on that line or on
        the directly preceding (comment-only) line."""
        for ln in (line, line - 1):
            s = self.suppressions.get(ln)
            if s is not None and (rule in s.rules or "all" in s.rules):
                return s
        return None

    def consume_suppression(self, line: int, rule: str) -> Suppression | None:
        """suppression_for + usage marking: consumed suppressions are
        live; any suppression never consumed by the full rule pack is
        stale and surfaces as an `unused-suppression` finding."""
        s = self.suppression_for(line, rule)
        if s is not None:
            self.used_suppressions.add(s.line)
        return s


class Rule:
    """Base rule. Subclasses set ``name``/``description`` and implement
    ``check_module`` (per file) or ``check_project`` (cross-file)."""

    name = "abstract"
    description = ""

    def check_module(self, mod: Module) -> Iterable[Finding]:
        return ()

    def check_project(self, mods: list[Module], root: str) -> Iterable[Finding]:
        for mod in mods:
            yield from self.check_module(mod)


def iter_py_files(paths: list[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [
                    d for d in sorted(dirnames) if d != "__pycache__"
                ]
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        yield os.path.join(dirpath, f)


def load_module(path: str, root: str) -> Module:
    rel = os.path.relpath(path, root)
    with open(path, encoding="utf-8") as fh:
        return Module(path, rel, fh.read())


class Analyzer:
    """Load modules, run rules, apply suppressions, report."""

    def __init__(self, root: str, rules: "list[Rule] | None" = None) -> None:
        self.root = root
        self.rules = rules if rules is not None else all_rules(root)

    def load(self, paths: list[str]) -> list[Module]:
        mods = []
        for path in iter_py_files(paths):
            try:
                mods.append(load_module(path, self.root))
            except SyntaxError as e:
                mods_rel = os.path.relpath(path, self.root)
                raise SystemExit(f"kwoklint: cannot parse {mods_rel}: {e}")
        return mods

    def run(self, paths: list[str]) -> tuple[list[Finding], int]:
        """Returns (unsuppressed findings, suppressed count). Suppressions
        without a justification surface as `bare-suppression` findings."""
        mods = self.load(paths)
        by_rel = {m.rel: m for m in mods}
        findings: list[Finding] = []
        suppressed = 0
        self.timings: dict[str, float] = {}
        for rule in self.rules:
            t0 = time.perf_counter()
            for f in rule.check_project(mods, self.root):
                mod = by_rel.get(f.path)
                s = mod.consume_suppression(f.line, f.rule) if mod else None
                if s is not None:
                    suppressed += 1
                else:
                    findings.append(f)
            self.timings[rule.name] = time.perf_counter() - t0
        # a suppression may also silence a would-be finding at scan time
        # (blocking-under-lock markers stop transitive propagation at the
        # source); rules count those on the module as they scan
        suppressed += sum(m.scan_suppressed for m in mods)
        # every suppression must justify itself AND stay live: staleness
        # is only judged when every rule the marker names actually ran
        # (a --rule subset must not flag markers for the rules it skipped)
        active = {r.name for r in self.rules}
        active |= {"bare-suppression", "unused-suppression"}
        for mod in mods:
            for s in mod.suppressions.values():
                if not s.justification:
                    findings.append(Finding(
                        mod.rel, s.line, "bare-suppression",
                        "suppression without a justification comment "
                        "(write `# kwoklint: disable=<rule> -- <why>`)",
                    ))
                elif (
                    s.line not in mod.used_suppressions
                    and set(s.rules) <= active
                ):
                    findings.append(Finding(
                        mod.rel, s.line, "unused-suppression",
                        "suppression matched no finding — stale: remove "
                        "it, or fix the rule list "
                        f"({', '.join(s.rules)})",
                    ))
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return findings, suppressed


def all_rules(root: str) -> list[Rule]:
    """The shipped rule pack. Imported lazily so `core` stays dependency-
    free for the witness (which loads in test processes)."""
    from kwok_tpu_torch.analysis.cclint import (
        CcFenceFirstRule,
        CcLockOrderRule,
        CcSocketUnderLockRule,
    )
    from kwok_tpu_torch.analysis.hygiene import SilentExceptRule
    from kwok_tpu_torch.analysis.locks import (
        BlockingUnderLockRule,
        LockOrderRule,
        UnusedLockRule,
    )
    from kwok_tpu_torch.analysis.metrics_doc import MetricsContractRule
    from kwok_tpu_torch.analysis.purity import KernelPurityRule
    from kwok_tpu_torch.analysis.races import SharedStateRule
    from kwok_tpu_torch.analysis.shmproto import ShmProtocolRule
    from kwok_tpu_torch.analysis.spawnonly import SpawnOnlyRule

    return [
        LockOrderRule(),
        BlockingUnderLockRule(),
        UnusedLockRule(),
        SharedStateRule(),
        ShmProtocolRule(),
        KernelPurityRule(),
        SilentExceptRule(),
        SpawnOnlyRule(),
        MetricsContractRule(doc_path=os.path.join(
            root, "kwok_tpu_torch", "docs", "observability.md")),
        CcLockOrderRule(),
        CcFenceFirstRule(),
        CcSocketUnderLockRule(),
    ]
