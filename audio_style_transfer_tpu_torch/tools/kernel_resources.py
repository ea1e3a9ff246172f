"""Registers, spills and static shared memory of every CUDA kernel in csrc/.

Run from the repository root on a machine with the CUDA toolkit:

    python3 -m audio_style_transfer_tpu_torch.tools.kernel_resources [gram.cu ...]

Compiles each source (all, or the named ones) with the build's flags plus
``-Xptxas -v``, side by side, and prints one line per kernel: registers a
thread, bytes of spill stores / loads, static shared memory, and the
demangled name. The notes at the top of the sources quote these lines.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile

from audio_style_transfer_tpu_torch.ops import _build

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse_ptxas(log: str) -> list[tuple[str, int, int, int, int]]:
    """(mangled name, registers, spill stores, spill loads, static smem) per
    entry function of one ``nvcc -Xptxas -v`` log."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            name, spill = m.group(1), (0, 0)
        elif m := _SPILL.search(line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := _USED.search(line)) and name:
            rows.append((name, int(m.group(1)), *spill, int(m.group(2) or 0)))
            name = None
    return rows


def compile_resources(names: list[str]) -> dict[str, list[tuple[str, int, int, int, int]]]:
    """Source file name -> ``parse_ptxas`` rows of every kernel in it, for
    the named sources of csrc/ (all when ``names`` is empty), compiled side
    by side with the build's flags plus ``-Xptxas -v``."""
    nvcc = _build._nvcc()
    sources = [s for s in _build._sources() if not names or s.name in names]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-c", "-o",
             os.path.join(tmp, s.stem + ".o"), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for s in sources]
        logs = [p.communicate()[0] for p in procs]
    out = {}
    for src, proc, log in zip(sources, procs, logs):
        if proc.returncode != 0:
            print(log)
            raise RuntimeError(f"nvcc failed on {src.name}")
        out[src.name] = parse_ptxas(log)
    return out


def main(argv: list[str]) -> int:
    filt = shutil.which("cu++filt") or os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    for src, rows in compile_resources(argv).items():
        print(f"{src}:")
        for name, regs, st, ld, smem in rows:
            if os.path.exists(filt):
                name = subprocess.run([filt, name], capture_output=True, text=True,
                                      check=True).stdout.strip()
            print(f"  {regs:4d} registers, spill {st}/{ld} B, static smem {smem:6d} B  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
