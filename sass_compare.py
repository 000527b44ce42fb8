#!/usr/bin/env python3
"""Compare the machine code (SASS) of the blend kernels' 16x16
instantiations between this checkout's CUDA sources and another version
of them, on a machine with nvcc and cuobjdump (the other version's 8x8
and 32x32 instantiations are not compared).

  python3 sass_compare.py --other DIR [--show N]

DIR holds the other version's tile_raster_fwd.cu and tile_raster_bwd.cu,
e.g. the parent commit's, unpacked with `git archive REV
gaussiansplattingviewer_tpu_torch/csrc | tar -x --strip-components 2 -C
DIR`.  Both versions are built with the port's own nvcc flags
(ops/kernels/build.py); every kernel of the other version is matched by
its demangled name to this version's 16x16 instantiation (the same name,
or the name with the tile edge 16 added as the first template argument,
for a kernel that has since been templated on it) and their instructions
are compared line by line.  Prints one line per kernel that differs (with
--show, its first N differing instruction pairs) and exits 1 if any
differs or has no match.  Needs no card.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCES = ("tile_raster_fwd", "tile_raster_bwd")


def _tool(name: str) -> str:
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build

    found = shutil.which(name)
    if found:
        return found
    path = Path(build._nvcc()).parent / name
    if not path.exists():
        raise RuntimeError(f"{name} not found beside nvcc")
    return str(path)


def sass(src: Path, out: Path) -> dict[str, list[str]]:
    """{demangled kernel name: its SASS lines} of one source as built."""
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build

    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(out)],
                          check=True, capture_output=True, text=True).stdout
    funcs: dict[str, list[str]] = {}
    lines = None
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("Function :"):
            lines = funcs.setdefault(line.split(":", 1)[1].strip(), [])
        elif lines is not None and line.startswith("/*"):
            # cuobjdump pads its columns to the file's widest instruction,
            # so spacing is not compared
            lines.append(" ".join(line.split()))
    names = list(funcs)
    filt = shutil.which("cu++filt") or _tool("cu++filt")
    plain = subprocess.run([filt], input="\n".join(names), check=True,
                           capture_output=True, text=True).stdout.split("\n")
    return {p.strip(): funcs[m] for m, p in zip(names, plain)}


def match(name: str, new: dict) -> str | None:
    """This version's kernel for the other version's ``name``."""
    if name in new:
        return name
    # the kernel's template arguments follow its last qualified name
    m = re.match(r"(.*::\w+)<(.*)", name)
    for edge in ("16, ", "(int)16, "):  # as cu++filt prints int arguments
        if m and f"{m[1]}<{edge}{m[2]}" in new:
            return f"{m[1]}<{edge}{m[2]}"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="directory with the other version's sources")
    ap.add_argument("--show", type=int, default=0, metavar="N",
                    help="print the first N differing instruction pairs of "
                         "each kernel that differs")
    args = ap.parse_args(argv)
    from gaussiansplattingviewer_tpu_torch.ops.kernels import build

    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in SOURCES:
            new = sass(build.SRC_DIR / f"{name}.cu", Path(tmp) / f"{name}.so")
            old = sass(args.other / f"{name}.cu",
                       Path(tmp) / f"{name}-other.so")
            same = skipped = 0
            for kernel, code in sorted(old.items()):
                if re.search(r"<\(int\)(8|32), ", kernel):
                    skipped += 1  # another tile edge
                    continue
                twin = match(kernel, new)
                if twin is None:
                    print(f"[sass] {name}: {kernel}: no match")
                    bad += 1
                    continue
                diff = sum(a != b for a, b in zip(code, new[twin])) \
                    + abs(len(code) - len(new[twin]))
                if diff:
                    print(f"[sass] {name}: {kernel} -> {twin}: {diff} of "
                          f"{len(code)} lines differ")
                    pairs = [(a, b) for a, b in zip(code, new[twin]) if a != b]
                    for a, b in pairs[:args.show]:
                        print(f"[sass]   other {a}\n[sass]   this  {b}")
                    bad += 1
                else:
                    same += 1
            print(f"[sass] {name}: {same} of {len(old) - skipped} 16x16 "
                  f"kernels of the other version identical to this "
                  f"version's ({len(new)} kernels in all)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
