"""Instructions per test in a mesh kernel's inner loop, read from its SASS.

Disassembles a built kernel library with ``cuobjdump -sass`` (CUDA
toolkit), finds in each kernel function the innermost loops that hold the
test's marker instruction, and counts each such loop body's instructions
(NOPs left out) per test:

* ``face``: one Moller-Trumbore test per ``MUFU.RCP`` (its one IEEE
  reciprocal; the reciprocal's rare slow path is a subroutine outside the
  loop and is not counted);
* ``slab``: one slab test per six ``FMUL`` (two plane distances per axis);
* ``geom``: one geom test per loop body, in the loops that read shared
  memory (any ``LDS``): the render megakernel's geom loop, in a build whose
  face loop is compiled out (tools/k1_sweep.py).

A loop is a backward branch and the code from its target to it.  The count
is static: every instruction of the body once, including those that a
branch inside the body may skip.

Run where the toolkit is (the card's machine):

    python -m ai_path_tracer_denoiser_tpu_torch.tools.sass_count LIB.so --per face
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
from collections import Counter
from typing import Dict, List

# unit: (marker opcode, or its family before the first "." where it ends in
# "*"; markers per test, or None for one test per loop body)
MARKERS = {"face": ("MUFU.RCP", 1), "slab": ("FMUL", 6), "geom": ("LDS*", None)}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_RES_FUNC = re.compile(r"Function\s*:\s*(\S+)|Function\s+([^\s:]+)\s*:")
_BRANCH = re.compile(r"\bBRA\b(?:\.\S+)?\s+(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(default):
        return default
    raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")


def opcode(text: str) -> str:
    """The opcode of one SASS instruction, without its predicate."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def parse(sass: str) -> Dict[str, List[tuple]]:
    """{function: [(address, instruction text), ...]} of a cuobjdump listing;
    labels (where the listing has them) become the next address."""
    funcs: Dict[str, List[tuple]] = {}
    labels: Dict[str, Dict[str, int]] = {}
    cur, pending = None, []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur, pending = m.group(1), []
            funcs[cur], labels[cur] = [], {}
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m and m.group(2) and not m.group(2).startswith("0x"):
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(2)))
    for name, insns in funcs.items():
        funcs[name] = [(a, t, labels[name]) for a, t in insns]
    return funcs


def loops(insns) -> List[tuple]:
    """(first index, last index) of every backward branch's body."""
    index = {a: k for k, (a, _, _) in enumerate(insns)}
    out = []
    for k, (addr, text, labels) in enumerate(insns):
        m = _BRANCH.search(text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= addr and target in index:
            out.append((index[target], k))
    return out


def is_marker(op: str, marker: str) -> bool:
    if marker.endswith("*"):
        return op.split(".")[0] == marker[:-1]
    return op == marker


def count_loops(insns, per: str) -> List[dict]:
    """The innermost loops holding the marker of ``per``: instructions,
    tests and instructions per test of each body."""
    marker, per_test = MARKERS[per]
    ops = [opcode(t) for _, t, _ in insns]
    with_marker = [(a, b) for a, b in loops(insns)
                   if any(is_marker(o, marker) for o in ops[a:b + 1])]
    inner = [(a, b) for a, b in with_marker
             if not any((c, d) != (a, b) and a <= c and d <= b for c, d in with_marker)]
    out = []
    for a, b in sorted(set(inner)):
        body = [o for o in ops[a:b + 1] if o != "NOP"]
        tests = (1.0 if per_test is None
                 else sum(is_marker(o, marker) for o in body) / per_test)
        hist = Counter(o.split(".")[0] for o in body)
        out.append({"first_address": insns[a][0], "instructions": len(body),
                    "tests": tests, "instructions_per_test": len(body) / tests,
                    "by_opcode": dict(hist.most_common())})
    return out


def count_library(path: str, per: str) -> List[dict]:
    """Per kernel function of the library: its marker loops (``count_loops``)."""
    sass = subprocess.run([_cuobjdump(), "-sass", path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return [{"library": os.path.basename(path), "function": name, "per": per,
             "loops": count_loops(insns, per)}
            for name, insns in parse(sass).items() if insns]


def parse_resource_usage(text: str) -> Dict[str, dict]:
    """{kernel function: {"REG": registers, "STACK": .., "SHARED": .., "LOCAL": ..}} of a
    ``cuobjdump -res-usage`` listing."""
    usage, name = {}, None
    for line in text.splitlines():
        m = _RES_FUNC.search(line)
        if m:
            name = m.group(1) or m.group(2)
            continue
        if name is not None and "REG:" in line:
            usage[name] = {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)",
                                                            line)}
            name = None
    return usage


def resource_usage(path: str) -> Dict[str, dict]:
    """``parse_resource_usage`` of a built library."""
    return parse_resource_usage(subprocess.run(
        [_cuobjdump(), "-res-usage", path], capture_output=True, text=True, check=True,
        timeout=300).stdout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("libraries", nargs="+")
    ap.add_argument("--per", choices=sorted(MARKERS), required=True)
    args = ap.parse_args(argv)
    for path in args.libraries:
        for rec in count_library(path, args.per):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
