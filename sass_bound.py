"""The tick kernel's operation bound, counted from the built library's SASS.

    python3 sass_bound.py [LIBRARY_OR_SASS_LISTING]

With no argument it builds (or finds) ``csrc/tick.cu``'s library through
``kwok_tpu_torch.ops.cuda_tick``; a file ending in ``.so`` is disassembled
with ``cuobjdump -sass`` (the CUDA toolkit's, so on a machine that has
one), any other file is read as such a listing. For each kernel
(``fused_tick_kernel``, the fused dispatch's entry, and ``tick_kernel``,
the per-kind entry) it finds the substep loop (the backward branch that
spans the most instructions: the loop over K substeps, which the source
keeps at one substep per trip with ``#pragma unroll 1``) and the
shortest path through its body from the loop's head to its back branch:
the instructions every row issues in every substep, whatever its data.
The path is held to pass through the loop's first shared-memory load
(the lookup of the row's phase in the rule masks, which every row of a
kind with rules makes each substep). A row that matches anew, draws,
fires or beats issues more, so a bound built from this path is a least
time. Prints the counts per functional unit as JSON.

``bound_ms(counts, rows, steps)`` turns them into the least time for
``rows`` rows and ``steps`` substeps on one NVIDIA H100 SXM: the larger,
over the units, of the path's instructions for that unit times rows and
steps over the unit's rate. Rates per SM and clock (the CUDA C++
programming guide's arithmetic-instruction throughput for compute
capability 9.0): 128 for any instruction issued (4 schedulers of one
warp instruction each), 128 for fp32 add, multiply and compare, 64 for
32-bit integer multiply-add, add, logic, shift and compare, 16 for the
special-function unit (MUFU); 132 SMs at 1.98 GHz (the data sheet's
boost clock; 132 x 128 x 2 x 1.98e9 is the 67 TFLOP/s fp32 peak of the
on-chip measurement table). Stores, loads, branches and barriers count
as issued instructions only.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import deque

SMS = 132
CLOCK_HZ = 1.98e9
# thread operations per SM and clock
RATES = {"issue": 128, "fp32": 128, "int32": 64, "mufu": 16}
KERNELS = ("fused_tick_kernel", "tick_kernel")

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P(?:T|\d+)\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);"
)
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")
_FP32 = ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FSET")
_INT32 = ("IMAD", "IADD", "IADD3", "VIADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
          "ISETP", "IMNMX", "VIMNMX", "LEA", "SEL", "PRMT", "IABS", "FLO", "POPC",
          "BREV", "BMSK", "SGXT", "PLOP3")


def unit_of(opcode: str) -> str:
    """The functional unit an opcode runs on, beyond its issue slot."""
    base = opcode.split(".")[0]
    if base == "MUFU":
        return "mufu"
    if base in _FP32:
        return "fp32"
    if base in _INT32:
        return "int32"
    return "other"


def parse(listing: str) -> dict:
    """``{mangled kernel name: [(address, predicate, opcode, operands)]}``
    (the predicate ``""`` when there is none)."""
    funcs: dict = {}
    cur = None
    for line in listing.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3),
                        m.group(4).strip()))
    return funcs


def _target(operands: str) -> "int | None":
    m = _TARGET.search(operands)
    return int(m.group(1), 16) if m else None


def substep_path(insns) -> dict:
    """The substep loop of one kernel's instructions and the shortest path
    through it: its instruction count per unit."""
    index = {a: i for i, (a, *_rest) in enumerate(insns)}
    loops = []
    for i, (addr, pred, op, ops) in enumerate(insns):
        if op.split(".")[0] == "BRA":
            t = _target(ops)
            if t is not None and t < addr and t in index:
                loops.append((addr - t, index[t], i))
    if not loops:
        raise ValueError("no backward branch: no substep loop")
    _span, head, back = max(loops)

    def successors(i):
        addr, pred, op, ops = insns[i]
        base = op.split(".")[0]
        # a branch is conditional when predicated (but not @PT) or when it
        # takes a predicate operand (BRA P2, target)
        conditional = pred not in ("", "@PT") or ops.startswith(("P", "!P"))
        out = []
        if base == "BRA":
            t = _target(ops)
            if t is not None and t in index and head <= index[t] <= back:
                out.append(index[t])
            if conditional and i + 1 <= back:
                out.append(i + 1)
        elif base in ("EXIT", "RET"):
            if conditional and i + 1 <= back:
                out.append(i + 1)
        elif i + 1 <= back:
            out.append(i + 1)
        return out

    def shortest(src: int, dst: int) -> list:
        parent = {src: None}
        queue = deque([src])
        while queue:
            i = queue.popleft()
            if i == dst:
                break
            for j in successors(i):
                if j not in parent:
                    parent[j] = i
                    queue.append(j)
        if dst not in parent:
            raise ValueError(f"{hex(insns[dst][0])} is not reachable from {hex(insns[src][0])}")
        out = []
        i = dst
        while i is not None:
            out.append(i)
            i = parent[i]
        return out[::-1]

    # every row of a kind with rules looks its phase's rule mask up in
    # shared memory each substep (the loop's first shared load); the path
    # is held to pass through it, or it would take a kind without rules'
    # shortcut around the matching
    lookup = next((i for i in range(head, back + 1) if insns[i][2].startswith("LDS")), None)
    if lookup is None:
        raise ValueError("no shared-memory load in the substep loop")
    path = shortest(head, lookup) + shortest(lookup, back)[1:]
    counts = {"issue": len(path), "fp32": 0, "int32": 0, "mufu": 0}
    for i in path:
        unit = unit_of(insns[i][2])
        if unit != "other":
            counts[unit] += 1
    return {"loop": [hex(insns[head][0]), hex(insns[back][0])],
            "body_instructions": back - head + 1, "path": counts}


def substep_counts(listing: str) -> dict:
    """Per kernel of ``KERNELS``: its substep loop and shortest path."""
    funcs = parse(listing)
    out = {}
    for name in KERNELS:
        hits = [f for f in funcs if re.search(rf"\d{name}E", f)]
        if len(hits) != 1:
            raise ValueError(f"{name}: {len(hits)} functions in the listing")
        out[name] = substep_path(funcs[hits[0]])
    return out


def disassemble(library: str) -> str:
    """``cuobjdump -sass`` of a shared library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=120).stdout


def bound_ms(kernel: dict, rows: int, steps: int) -> tuple:
    """``(ms, unit)``: the least time of ``steps`` substeps over ``rows``
    rows by the path's counts, and the unit that sets it."""
    best = (0.0, "issue")
    for unit, n in kernel["path"].items():
        ms = n * rows * steps / (RATES[unit] * SMS * CLOCK_HZ) * 1e3
        best = max(best, (ms, unit))
    return best


def main() -> int:
    arg = sys.argv[1] if len(sys.argv) > 1 else ""
    if not arg:
        from kwok_tpu_torch.ops import cuda_tick

        arg = cuda_tick.build_library()[0]
    if arg.endswith(".so"):
        listing = disassemble(arg)
    else:
        with open(arg) as f:
            listing = f.read()
    print(json.dumps(substep_counts(listing)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
