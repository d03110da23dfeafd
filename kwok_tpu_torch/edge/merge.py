"""Strategic-merge-patch semantics for status documents + no-op suppression.

Mirrors the observable behavior of the reference's diff logic:
- configureNode (node_controller.go:356-391): render -> strategic-merge into
  current status -> **conditions excluded from the comparison** -> skip if
  equal.
- computePatchData (pod_controller.go:404-439): when phase != Pending,
  render -> strategic-merge -> skip if equal; when Pending, always patch.

Only the list merge strategies that occur in Node/Pod status are
implemented: conditions (merge key `type`), addresses (merge key `type`);
all other lists replace atomically (containerStatuses has no patch merge key
in core/v1).

`$patch: replace` / `$patch: delete` directives are honored the way the real
apiserver's strategicpatch does for these shapes: a map patch carrying
`$patch: replace` replaces the original wholesale (minus the directive);
`$patch: delete` empties it; a merge-list element `{"$patch": "delete",
<mergeKey>: v}` removes the matching element (deletes apply to the original
before the patch's own elements merge, as strategicpatch does), and a
`$patch: replace` element makes the patch's non-directive elements replace
the list. Unknown
directive values are dropped tolerantly rather than rejected
($deleteFromPrimitiveList/$setElementOrder/$retainKeys do not occur in
node/pod status traffic and are out of scope; see tests/merge_oracle.py).
"""

from __future__ import annotations

import copy
from typing import Any

# path (tuple of dict keys, "*" wildcard not needed here) -> merge key
_MERGE_KEYS: dict[str, str] = {
    "conditions": "type",
    "addresses": "type",
}

_DIRECTIVE = "$patch"


def _has_directive(item: Any) -> bool:
    return isinstance(item, dict) and _DIRECTIVE in item


def _clean(v: Any) -> bool:
    """True when a patch subtree carries no $patch markers and no nulls —
    the common case (everything the engine renders), letting insertion skip
    the sanitizing rebuild."""
    if isinstance(v, dict):
        for k, val in v.items():
            if k == _DIRECTIVE or val is None or not _clean(val):
                return False
        return True
    if isinstance(v, list):
        return all(_clean(x) for x in v)
    return True


def _sanitize(v: Any, mk: dict[str, str], field: str | None, *, copies: bool) -> Any:
    """A patch subtree being inserted where the original has no value: the
    stored object must never contain $patch markers or nulls (the real
    apiserver discards unmatched nulls — strategicpatch IgnoreUnmatchedNulls
    — and directives are instructions, not data). Equivalent to merging the
    subtree into an empty value, recursively.

    KNOWN DIVERGENCE from upstream strategicpatch removeDirectives (which
    only strips the $patch key on fresh inserts and keeps all remaining
    content): here a fresh-inserted map carrying `$patch: delete` becomes
    {} (the directive is honored against the absent original), and
    directive-carrying merge-list elements are dropped rather than kept
    marker-stripped. Deliberate tolerant behavior, mirrored by the
    independent oracle (tests/merge_oracle.py) and the C++ server
    (native/apiserver.cc sanitize_patch); engine-rendered traffic never
    contains directives, so only hand-crafted patches can observe it."""
    if _clean(v):
        return copy.deepcopy(v) if copies else v
    if isinstance(v, dict):
        if v.get(_DIRECTIVE) == "delete":
            return {}
        return {
            k: _sanitize(val, mk, k, copies=copies)
            for k, val in v.items()
            if k != _DIRECTIVE and val is not None
        }
    if isinstance(v, list) and field in mk:
        # delete/replace directives are no-ops against an empty list
        return [
            _sanitize(x, mk, None, copies=copies) for x in v if not _has_directive(x)
        ]
    return copy.deepcopy(v) if copies else v


def strategic_merge(original: Any, patch: Any, merge_keys: dict[str, str] | None = None) -> Any:
    merge_keys = _MERGE_KEYS if merge_keys is None else merge_keys
    return _merge_value(original, patch, merge_keys, field=None)


def _merge_value(
    orig: Any, patch: Any, mk: dict[str, str], field: str | None, *, copies: bool = True
) -> Any:
    """Directive-free traffic (everything the engine itself renders and
    ingests) stays on fast paths: the $patch machinery and the sanitizing
    rebuild only engage when a directive/null is actually present. This
    runs per watch event in the no-op-suppression check, so the common
    case must not pay for the rare one."""
    if isinstance(patch, dict):
        if not isinstance(orig, dict):
            return _sanitize(patch, mk, field, copies=copies)
        if _DIRECTIVE in patch:
            directive = patch[_DIRECTIVE]
            if directive == "replace":
                return {
                    k: _sanitize(v, mk, k, copies=copies)
                    for k, v in patch.items()
                    if k != _DIRECTIVE and v is not None
                }
            if directive == "delete":
                return {}
        out = dict(orig)
        for k, v in patch.items():
            if k == _DIRECTIVE:
                continue  # unknown directive value: tolerated, dropped
            if v is None:
                out.pop(k, None)
            elif k in out:
                out[k] = _merge_value(out[k], v, mk, field=k, copies=copies)
            else:
                out[k] = _sanitize(v, mk, k, copies=copies)
        return out
    if isinstance(patch, list):
        if isinstance(orig, list) and field in mk:
            return _merge_keyed_list(orig, patch, mk, mk[field], copies)
        # atomic-list replacement / type mismatch: sanitized like
        # missing-key insertions
        return _sanitize(patch, mk, field, copies=copies)
    return copy.deepcopy(patch) if copies else patch  # scalar leaf


def _merge_keyed_list(
    orig: list, patch: list, mk: dict[str, str], key: str, copies: bool
) -> list:
    cp = copy.deepcopy if copies else (lambda x: x)
    if any(_has_directive(it) for it in patch):
        if any(_has_directive(it) and it[_DIRECTIVE] == "replace" for it in patch):
            return [
                _sanitize(it, mk, None, copies=copies)
                for it in patch
                if not _has_directive(it)
            ]
        # strategicpatch applies every $patch:delete to the ORIGINAL before
        # merging any non-directive element, so a delete never removes an
        # element the same patch adds
        deleted = {
            it[key]
            for it in patch
            if _has_directive(it)
            and it[_DIRECTIVE] == "delete"
            and isinstance(it.get(key), str)
        }
        orig = [
            x
            for x in orig
            if not (
                isinstance(x, dict)
                and isinstance(x.get(key), str)
                and x[key] in deleted
            )
        ]
        patch = [it for it in patch if not _has_directive(it)]
    out_list = [cp(x) for x in orig] if copies else list(orig)
    # only string merge keys participate in matching (k8s merge keys are
    # always strings); first match wins on (malformed) duplicates
    index: dict[str, int] = {}
    for i, x in enumerate(out_list):
        if isinstance(x, dict):
            kv = x.get(key)
            if isinstance(kv, str) and kv not in index:
                index[kv] = i
    for item in patch:
        kv = item.get(key) if isinstance(item, dict) else None
        if isinstance(kv, str) and kv in index:
            i = index[kv]
            out_list[i] = _merge_value(out_list[i], item, mk, field=None, copies=copies)
        else:
            out_list.append(_sanitize(item, mk, None, copies=copies))
            if isinstance(kv, str):
                index[kv] = len(out_list) - 1
    return out_list


def _merge_view(orig: Any, patch: Any, mk: dict[str, str], field: str | None) -> Any:
    """strategic_merge without the defensive deepcopies: shares unmodified
    subtrees with its inputs. ONLY for read-only comparison (the no-op
    suppression checks below run once per watch event — at O(10k) events/s
    the copies dominated the engine's ingest profile). The comparisons use
    Python `==`, which unlike the former canonical-JSON compare treats
    1 == 1.0 == True — a deliberate narrowing (k8s numeric equality)."""
    return _merge_value(orig, patch, mk, field, copies=False)


def node_status_patch_needed(current_status: dict, rendered: dict) -> bool:
    """configureNode's check: merge, then compare with conditions pinned to
    the current value (node_controller.go:377 `nodeStatus.Conditions =
    node.Status.Conditions`) — heartbeat-only condition changes do not
    count as drift."""
    merged = _merge_view(current_status, rendered, _MERGE_KEYS, None)
    merged = dict(merged)
    if "conditions" in current_status:
        merged["conditions"] = current_status["conditions"]
    else:
        merged.pop("conditions", None)
    return merged != current_status


def pod_status_patch_needed(current_status: dict, rendered: dict) -> bool:
    """computePatchData's check: only suppress when phase != Pending."""
    if current_status.get("phase", "Pending") == "Pending":
        return True
    merged = _merge_view(current_status, rendered, _MERGE_KEYS, None)
    return merged != current_status
