"""Kubernetes label-selector parsing and matching.

Replaces the reference's use of k8s.io/apimachinery labels.Parse
(pkg/kwok/controllers/utils.go:207-212, controller.go:90-96). Supports the
full string grammar: `k=v`, `k==v`, `k!=v`, `k in (a,b)`, `k notin (a,b)`,
`k` (exists), `!k` (not exists), comma-joined requirements.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Sequence

_IN_RE = re.compile(r"^(?P<key>[^\s!=]+)\s+(?P<op>in|notin)\s+\((?P<vals>[^)]*)\)$")


@dataclasses.dataclass(frozen=True)
class Requirement:
    key: str
    op: str  # "=", "!=", "in", "notin", "exists", "!"
    values: tuple[str, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        present = self.key in labels
        if self.op == "exists":
            return present
        if self.op == "!":
            return not present
        if self.op in ("=", "in"):
            return present and labels[self.key] in self.values
        if self.op in ("!=", "notin"):
            # k8s semantics: != / notin match when key is absent too
            return not present or labels[self.key] not in self.values
        raise ValueError(f"unknown op {self.op}")


@dataclasses.dataclass(frozen=True)
class LabelSelector:
    requirements: tuple[Requirement, ...]

    def matches(self, labels: Mapping[str, str] | None) -> bool:
        labels = labels or {}
        return all(r.matches(labels) for r in self.requirements)

    @property
    def empty(self) -> bool:
        return not self.requirements


def _split_top_level(s: str) -> Sequence[str]:
    """Split on commas not inside parentheses."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def parse_selector(s: str | None) -> LabelSelector | None:
    """Parse a selector string; empty/None -> None (matches nothing is the
    caller's decision, mirroring labelsParse returning nil)."""
    if not s or not s.strip():
        return None
    reqs: list[Requirement] = []
    for part in _split_top_level(s.strip()):
        m = _IN_RE.match(part)
        if m:
            vals = tuple(v.strip() for v in m.group("vals").split(",") if v.strip())
            reqs.append(Requirement(m.group("key"), m.group("op"), vals))
            continue
        if "!=" in part:
            k, v = part.split("!=", 1)
            reqs.append(Requirement(k.strip(), "!=", (v.strip(),)))
            continue
        if "==" in part:
            k, v = part.split("==", 1)
            reqs.append(Requirement(k.strip(), "=", (v.strip(),)))
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            reqs.append(Requirement(k.strip(), "=", (v.strip(),)))
            continue
        if part.startswith("!"):
            reqs.append(Requirement(part[1:].strip(), "!"))
            continue
        reqs.append(Requirement(part, "exists"))
    return LabelSelector(tuple(reqs))
