#!/usr/bin/env python3
"""Which instructions the tensor-core kernels compiled to: for every kernel
function of the built ``flash_attention``, ``varlen_attention``,
``decode_attention``, ``paged_decode_attention``, ``grouped_expert`` and
``ssd_scan`` libraries, the count of tensor-core (HMMA, HGMMA), fp32 FMA
(FFMA), ldmatrix (LDSM) and async-copy (LDGSTS) instructions in its SASS,
from ``cuobjdump -sass``.  Builds the
libraries first (nvcc), so it runs where the CUDA toolkit is, with or
without a card.

    PYTHONPATH=src python scripts/sass_census.py
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import build  # noqa: E402

OPCODES = ("HGMMA", "HMMA", "FFMA", "LDSM", "LDGSTS")
LIBRARIES = ("flash_attention", "varlen_attention", "decode_attention", "paged_decode_attention",
             "grouped_expert", "ssd_scan")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = Path(build.nvcc()).with_name("cuobjdump")
    if not path.is_file():
        raise RuntimeError("cuobjdump not found beside nvcc")
    return str(path)


def demangle(names):
    """c++filt of the mangled names, in order (names unchanged without it)."""
    tool = shutil.which("c++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def census(lib: Path) -> dict[str, dict[str, int]]:
    """Per kernel function of ``lib``, the count of each of OPCODES."""
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), dict.fromkeys(OPCODES, 0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if current is not None and m:
            op = m.group(1)
            if op in current:
                current[op] += 1
    return counts


def main():
    build.build(LIBRARIES)
    for name in LIBRARIES:
        counts = census(build.library_path(name))
        print(f"== {name}: {build.library_path(name).name}")
        for fn, readable in zip(counts, demangle(list(counts))):
            short = re.sub(r"\(.*", "", readable.replace("(anonymous namespace)::", ""))
            print(f"{short:60s} " + " ".join(f"{op}={n}" for op, n in counts[fn].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
