"""Compare the machine code (SASS) of two versions of one CUDA source,
function by function, and print ptxas's registers and spills for each
function of the second.

Both files compile to a cubin with the flags the port builds its kernels
with (``repro_torch.kernels._build.NVCC_FLAGS``, less ``-shared`` and
``-fPIC``); ``cuobjdump -sass`` lists each function's instructions, and a
function counts as unchanged when its instruction text is the same after
addresses are dropped.  Run it on a machine with the CUDA toolkit, for
example to show that a new template instantiation left the others alone:

    git show HEAD~1:src/repro_torch/kernels/csrc/granule_step.cu > build/old.cu
    PYTHONPATH=src python scripts/torch_compare_sass.py build/old.cu \\
        src/repro_torch/kernels/csrc/granule_step.cu

Prints one line a function (``same``, ``differs``, ``only in old`` or
``only in new``), then the ptxas report of the new file; exits 1 when a
function of the old file differs or is gone.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path


def _flags() -> list:
    from repro_torch.kernels import _build

    return [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]


def _sass(src: str, out_dir: Path, tag: str) -> tuple[dict, str]:
    """({mangled name: instruction lines}, ptxas report) of ``src``."""
    from repro_torch.kernels import _build

    cubin = out_dir / f"{tag}.cubin"
    proc = subprocess.run([_build.nvcc(), *_flags(), "-cubin", "-o", str(cubin), src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    funcs: dict = {}
    name = None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name is not None and m:
            funcs[name].append(m.group(1))
    return funcs, proc.stdout + proc.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        old, _ = _sass(args.old, Path(tmp), "old")
        new, report = _sass(args.new, Path(tmp), "new")
    bad = 0
    for name in sorted(set(old) | set(new)):
        if name not in new:
            verdict, bad = "only in old", bad + 1
        elif name not in old:
            verdict = "only in new"
        elif old[name] == new[name]:
            verdict = "same"
        else:
            verdict, bad = "differs", bad + 1
        size = len(new.get(name, old.get(name, [])))
        print(f"{verdict:12s} {size:6d} instructions  {name}")
    for line in report.splitlines():
        if any(w in line for w in ("registers", "spill", "Function properties")):
            print(line.strip())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
