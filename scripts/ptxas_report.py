#!/usr/bin/env python3
"""Registers and spills of every CUDA kernel of the port, and of another
tree's, as ptxas reports them.

    python3 scripts/ptxas_report.py [--base DIR]

Compiles each ``src/repro_torch/csrc/*.cu`` of this tree (and, with
``--base``, of the tree unpacked at DIR, e.g. ``git archive <commit> | tar
-x -C build/ptxas_base``) with the port's own nvcc flags into
``build/ptxas_report/``, one nvcc per source, all started together, and
prints one JSON line per source: every kernel instantiation with its
registers and spill bytes here and in the base.  With ``--base`` it exits
1 if a kernel that both trees build changed its registers or spills, so a
new template instantiation can be shown to leave the others' code alone.
Needs nvcc (``CUDA_HOME``, ``/usr/local/cuda`` or the PATH); no card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "ptxas_report"


def compile_tree(tree: pathlib.Path, tag: str):
    """{source: {kernel: {registers, spill_stores, spill_loads}}}."""
    csrc = tree / "src" / "repro_torch" / "csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cu in sorted(csrc.glob("*.cu")):
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
               str(OUT / f"{tag}-{cu.stem}.so"), str(cu)]
        procs[cu.stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {tag} csrc/{name}.cu:\n{log}")
        out[name] = _build.ptxas_report(log)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=pathlib.Path, default=None,
                    help="another tree to compare with (its root)")
    args = ap.parse_args(argv)
    here = compile_tree(ROOT, "here")
    base = compile_tree(args.base.resolve(), "base") if args.base else {}
    changed = 0
    for src, kernels in here.items():
        old = base.get(src, {})
        rows = {}
        for k, v in sorted(kernels.items()):
            row = dict(v)
            if k in old:
                row["base"] = old[k]
                row["same_as_base"] = old[k] == v
                changed += old[k] != v
            rows[k] = row
        line = {"source": f"src/repro_torch/csrc/{src}.cu", "kernels": rows}
        if args.base:
            line["in_base_only"] = sorted(set(old) - set(kernels))
            line["new_here"] = sorted(set(kernels) - set(old))
            line["changed"] = sum(1 for r in rows.values()
                                  if r.get("same_as_base") is False)
        print(json.dumps(line), flush=True)
    if args.base:
        print(json.dumps({"kernels_in_both_changed": changed}), flush=True)
    return 1 if changed else 0


if __name__ == "__main__":
    sys.exit(main())
