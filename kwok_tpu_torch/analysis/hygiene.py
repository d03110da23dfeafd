"""Exception-hygiene rule: no silent broad excepts.

A broad handler (``except Exception``, ``except BaseException``, or a bare
``except:``) that neither raises nor *does* anything observable — no call
(logging, counter bump, queue put, cleanup), just ``pass``/``continue``/
constant assignments — swallows failures invisibly. The fix is one of:

- narrow the exception type (an ``except ImportError`` fallback is fine)
- log it: ``logger.warning(..., exc_info=True)``
- count it: ``telemetry.errors.swallowed("site")`` — exported as
  ``kwok_swallowed_errors_total{site=...}``
- for the handful of genuinely-expected shutdown races (``__del__``
  safety nets), suppress with a justification:
  ``# kwoklint: disable=silent-except -- <why>``
"""

from __future__ import annotations

import ast

from kwok_tpu_torch.analysis.core import Finding, Module, Rule

_BROAD = ("Exception", "BaseException")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    names = []
    if isinstance(t, ast.Tuple):
        names = [e for e in t.elts]
    else:
        names = [t]
    for e in names:
        if isinstance(e, ast.Name) and e.id in _BROAD:
            return True
        if isinstance(e, ast.Attribute) and e.attr in _BROAD:
            return True
    return False


def _is_silent(handler: ast.ExceptHandler) -> bool:
    """True when the handler body neither raises nor performs any call —
    i.e. the exception vanishes without a trace."""
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Call)):
            return False
    return True


class SilentExceptRule(Rule):
    name = "silent-except"
    description = (
        "broad except handlers must log, count, re-raise, or carry a "
        "justified suppression"
    )

    def check_module(self, mod: Module):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node) and _is_silent(node):
                yield Finding(
                    mod.rel, node.lineno, self.name,
                    "broad except swallows the exception silently: narrow "
                    "the type, log it (exc_info=True), or bump "
                    "telemetry.errors.swallowed(site)",
                )
