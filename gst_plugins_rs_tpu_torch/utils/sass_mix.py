"""Instruction mix of a kernel's loops, read from its SASS.

    python -m gst_plugins_rs_tpu_torch.utils.sass_mix colorlut_lowrank \
        lowrank_packed_kernelILb1EjE

Builds csrc/<source>.cu (utils/build.py), disassembles the library with the
CUDA toolkit's cuobjdump -sass, and for every function whose mangled name
contains the pattern prints each loop (a backward branch) with its
instruction count by opcode.  Needs nvcc and cuobjdump, not a card.
"""
from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from .build import build, library_path, nvcc_path

_INS = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRA = re.compile(r"BRA\s.*?(0x[0-9a-f]+)")


def functions(sass: str) -> Dict[str, List[Tuple[int, str]]]:
    """{mangled name: [(address, instruction)]} of a cuobjdump -sass listing."""
    out: Dict[str, List[Tuple[int, str]]] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None and (m := _INS.match(line)):
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def loops(ins: List[Tuple[int, str]]):
    """(start, end, Counter of opcodes) for each backward branch."""
    for addr, text in ins:
        m = _BRA.search(text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            ops = collections.Counter(re.sub(r"^@!?P\w+\s+", "", t).split()[0]
                                      for a, t in ins if lo <= a <= addr)
            yield lo, addr, ops


def main(argv: List[str]) -> int:
    source, pattern = argv
    build(source)
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library_path(source))], check=True,
                          capture_output=True, text=True).stdout
    for name, ins in functions(sass).items():
        if pattern not in name:
            continue
        print(name)
        for lo, hi, ops in loops(ins):
            print(f"  loop {lo:#x}-{hi:#x}: {sum(ops.values())} instructions: "
                  + ", ".join(f"{op} {n}" for op, n in ops.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
