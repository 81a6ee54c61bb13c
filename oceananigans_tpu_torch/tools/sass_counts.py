"""Static instruction counts of the probe kernels, from their SASS.

    python -m oceananigans_tpu_torch.tools.sass_counts

Builds the port's kernels (``kernels/build.py``), disassembles the library
with the CUDA toolkit's ``cuobjdump -sass``, and prints one JSON line per
kernel of ``csrc/vpu_probes.cu``: the kernel's name and the number of each
opcode (the part before the first dot: FFMA, FMUL, FADD, MUFU, FCHK, I2F,
F2F, BRA, CALL, ...) in its machine code. The counts are static: a loop body
counts once, and the slow path of an IEEE division counts once however
rarely it runs. They explain the probes' rates: the operations the flop
accounting counts against the instructions the card issues.
"""

import collections
import json
import re
import subprocess
from pathlib import Path

from ..kernels import build

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def cuobjdump():
    nvcc = Path(build.find_nvcc())
    tool = nvcc.with_name("cuobjdump")
    return str(tool) if tool.exists() else "cuobjdump"


def counts(library, match="vpu_probes"):
    """{kernel: Counter(opcode)} for the kernels whose mangled name
    contains ``match``."""
    sass = subprocess.run([cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out, current = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = m.group(1) if match in m.group(1) else None
            if current:
                out[current] = collections.Counter()
            continue
        if current:
            m = _INSTRUCTION.search(line)
            if m:
                out[current][m.group(1)] += 1
    return out


def main():
    for name, c in counts(build.build()).items():
        print(json.dumps({"kernel": name, "instructions": sum(c.values()),
                          "opcodes": dict(c.most_common())}), flush=True)


if __name__ == "__main__":
    main()
