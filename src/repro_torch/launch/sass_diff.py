"""Compare the SASS of the port's CUDA libraries between two source trees.

Builds each named source of ``csrc/`` from this checkout and from another
checkout (``--base``: the root of an unpacked earlier commit) with the
flags of :mod:`repro_torch.kernels._build`, disassembles both with
``cuobjdump -sass`` and compares their instructions, kernel by kernel
(addresses, headers and the per-file tag of the anonymous namespace in
mangled names left out). Prints one JSON line per library (the base's
kernels that changed or went, and the kernels the checkout added) and
exits 1 if any kernel of the base changed or went:

    PYTHONPATH=src python -m repro_torch.launch.sass_diff \\
        --base build/parent gmm_wgmma flash_fwd_wgmma flash_bwd_wgmma

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); no card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from repro_torch.kernels import _build

_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
# nvcc names a file's anonymous namespace _GLOBAL__N__<hash of the file>_
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def instructions(lib: pathlib.Path) -> dict:
    """{kernel name: [instruction, ...]} of a built library's SASS."""
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        line = _ANON.sub("_GLOBAL__N__", line)
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = _INSTR.search(line)
            if m:
                out[name].append(m.group(1))
    return out


def build(csrc: pathlib.Path, stem: str, out_dir: pathlib.Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{stem}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(lib), str(csrc / f"{stem}.cu")],
                   check=True, capture_output=True, text=True, timeout=900)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=pathlib.Path,
                    help="root of the other checkout")
    ap.add_argument("--work", type=pathlib.Path,
                    default=_build.BUILD_ROOT.parent / "sass_diff")
    ap.add_argument("libs", nargs="+", help="source stems, e.g. gmm_wgmma")
    args = ap.parse_args(argv)
    trees = {"base": args.base.resolve() / "src/repro_torch/csrc",
             "head": _build.CSRC}
    jobs = {(side, stem): (trees[side], stem, args.work / side)
            for side in trees for stem in args.libs}
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
    same = True
    for stem in args.libs:
        base, head = (instructions(libs[(s, stem)]) for s in ("base", "head"))
        changed = sorted(k for k in base if base[k] != head.get(k))
        same &= not changed
        print(json.dumps({
            "lib": stem, "identical": base == head,
            "base_kernels_unchanged": not changed, "kernels": len(head),
            "instructions": sum(map(len, head.values())),
            "base_instructions": sum(map(len, base.values())),
            "changed_or_gone_kernels": changed,
            "added_kernels": sorted(set(head) - set(base))}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
