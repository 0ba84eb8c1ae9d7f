"""SASS instructions of one window tap, by opcode class, in the built
kernel libraries.

Disassembles each library with ``cuobjdump -sass``, finds every kernel's
tap loop (of the innermost loops, each a backward branch whose body holds
no other backward branch, one that reads device memory with at least one
reciprocal a global load: a tap divides twice, a staging loop reads ten
values a pixel and divides at most once; the one with the most loads,
the unrolled loop rather than a remainder) and divides the loop body's
static opcode counts (the divisions' slow-path calls included, which run
only for operands out of the fast path's range) by its global loads
(``LDG``): the tap loop reads one quad-table row a tap and nothing else
from device memory, so its ``LDG`` count is the number of taps an
iteration runs (the unroll factor). Per kernel it prints the
loop's taps an iteration and the instructions a tap by class, and every
tap loop's taps an iteration and instructions a tap (``loops``: a kernel
may hold several, one a window form or division path):

- ``fp32``: FADD, FMUL, FFMA, FSEL, FSETP, FMNMX, FCHK, ...;
- ``conv``: conversions and roundings (I2F, F2I, FRND, F2F, ...), issued at
  a fraction of the f32 rate on sm_90;
- ``mufu``: the special-function unit (the reciprocal of a division);
- ``int``: integer and predicate arithmetic (IMAD, IADD3, LEA, ISETP, PRMT,
  ...);
- ``mem``: loads and stores (LDG, LDS, STS, ...);
- ``ctrl``: branches and convergence (BRA, BSSY, BSYNC, CALL, ...);
- ``other``: moves, shuffles and the rest.

    python -m apde_mvs_tpu_torch.tools.sass_taps [LIB.so ...]

Without arguments it reads the libraries the package has built under
``build/kernels/``. Needs ``cuobjdump`` (the CUDA toolkit); the last line is
one JSON object ``{library: {kernel: {"taps": n, "per_tap": {class: x},
"opcodes": {opcode: x}, "loops": [[taps, per tap], ...]}}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FSET", "FMNMX",
             "FCHK", "FSWZADD", "FMUL32I", "FADD32I", "FFMA32I"),
    "conv": ("I2F", "F2I", "FRND", "F2F", "I2FP", "F2IP", "I2I"),
    "mufu": ("MUFU",),
    "int": ("IMAD", "IADD3", "IADD", "IMUL", "LEA", "LOP3", "LOP", "SHF",
            "SHL", "SHR", "ISETP", "IMNMX", "VIMNMX", "SEL", "PRMT", "IABS",
            "POPC", "FLO", "BREV", "PLOP3", "ISCADD", "BMSK", "SGXT"),
    "mem": ("LDG", "LDS", "STS", "STG", "LD", "ST", "LDL", "STL", "LDC",
            "ATOMS", "ATOMG", "ATOM", "RED", "LDSM", "LDGSTS"),
    "ctrl": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR", "WARPSYNC",
             "NOP", "YIELD", "BREAK", "JMP", "BRX", "JMX", "VOTE"),
}
_CLASS_OF = {op: cls for cls, ops in CLASSES.items() for op in ops}

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
_TARGET = re.compile(r"\s(0x[0-9a-f]+)\s*$")


def find_cuobjdump() -> str | None:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "cuobjdump"),
                 shutil.which("cuobjdump") or "",
                 "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.isfile(cand):
            return cand
    return None


def opcode_class(op: str) -> str:
    base = op.split(".")[0]
    if base.startswith("U") and base[1:] in _CLASS_OF:
        return "int"            # uniform-datapath twins (UIADD3, ULOP3, ...)
    return _CLASS_OF.get(base, "other")


def parse_functions(sass: str) -> dict:
    """{function name: ([(opcode, branch target address or None)],
    {address: instruction index})} from cuobjdump's text."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = m.group(1)
            funcs[cur] = ([], {})
            continue
        m = _INSN.match(line) if cur is not None else None
        if m:
            insns, at = funcs[cur]
            text = m.group(2).strip()
            if text.startswith("@"):
                text = text.split(None, 1)[1] if " " in text else ""
            op = text.split()[0] if text else ""
            t = _TARGET.search(text) if op.startswith("BRA") else None
            at[int(m.group(1), 16)] = len(insns)
            insns.append((op, int(t.group(1), 16) if t else None))
    return funcs


def innermost_loops(insns, at) -> list:
    """(first, last) instruction indices of each backward branch's loop that
    holds no other backward branch."""
    loops = []
    for i, (op, target) in enumerate(insns):
        if target is not None and target in at and at[target] < i:
            loops.append((at[target], i))
    return [(a, b) for a, b in loops
            if not any(a <= c and d <= b and (c, d) != (a, b)
                       for c, d in loops)]


def tap_loops(insns, at) -> list:
    """[(taps an iteration, reciprocals, Counter of opcodes)] of the
    innermost loops that read device memory and divide (``MUFU.RCP``)."""
    out = []
    for a, b in innermost_loops(insns, at):
        ops = Counter(insns[k][0] for k in range(a, b + 1))
        base = Counter()
        for op, n in ops.items():
            base[op.split(".")[0]] += n
        if base["LDG"] and base["MUFU"] >= base["LDG"]:
            out.append((base["LDG"], base["MUFU"], ops))
    return out


def demangle(names) -> dict:
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    proc = subprocess.run([filt], input="\n".join(names), text=True,
                          capture_output=True)
    got = proc.stdout.splitlines()
    return dict(zip(names, got)) if len(got) == len(names) \
        else {n: n for n in names}


def short_name(name: str) -> str:
    """``stage_sweep_kernel<unsigned char, false, 36>`` from the demangled
    signature (either demangler's spelling)."""
    name = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "", name)
    name = re.sub(r"\([^()]*\)$", "", name)           # the parameters
    name = name.replace("(bool)0", "false").replace("(bool)1", "true")
    return name.replace("(int)", "")


def library_taps(lib: Path, cuobjdump: str) -> dict:
    """``sass_taps`` of a built library's disassembly."""
    return sass_taps(subprocess.run([cuobjdump, "-sass", str(lib)], text=True,
                                    capture_output=True, check=True).stdout)


def sass_taps(sass: str) -> dict:
    """{kernel: {"taps", "per_tap_total", "per_tap" (by class), "opcodes"}}
    of every kernel in cuobjdump's text that has a tap loop."""
    funcs = parse_functions(sass)
    names = demangle(list(funcs))
    res = {}
    for fn, (insns, at) in funcs.items():
        loops = tap_loops(insns, at)
        if not loops:
            continue
        taps, _, ops = max(loops, key=lambda lo: lo[0])
        per_class = Counter()
        for op, n in ops.items():
            per_class[opcode_class(op)] += n
        total = sum(ops.values())
        res[short_name(names[fn])] = dict(
            taps=taps, per_tap_total=round(total / taps, 2),
            per_tap={c: round(n / taps, 2) for c, n in sorted(per_class.items())},
            opcodes={op: round(n / taps, 2) for op, n in sorted(ops.items())},
            loops=[[t, round(sum(o.values()) / t, 2)] for t, _, o in loops])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("libs", nargs="*", type=Path)
    args = ap.parse_args(argv)
    cuobjdump = find_cuobjdump()
    if cuobjdump is None:
        print("cuobjdump missing: no SASS counts")
        print(json.dumps({}))
        return 0
    libs = args.libs
    if not libs:
        from ..ops.cuda.build import BUILD_DIR
        libs = sorted(BUILD_DIR.glob("lib*.so"))
    out = {}
    for lib in libs:
        res = library_taps(lib, cuobjdump)
        out[lib.name] = res
        for kernel, r in res.items():
            cls = ", ".join(f"{c} {n:g}" for c, n in r["per_tap"].items())
            print(f"{lib.name} {kernel}: {r['per_tap_total']:g} a tap "
                  f"({r['taps']} taps an iteration): {cls}; every tap loop "
                  f"(taps, a tap): {r['loops']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
