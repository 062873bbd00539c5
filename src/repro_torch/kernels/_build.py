"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/<name>.cu`` (with the headers it includes from ``csrc/``)
is compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface, under ``build/kernels/`` at the
repository root (listed in ``.gitignore``).  The library's file name
carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded.  Nothing is built when a module is
imported: the CPU tests import every module with no ``nvcc`` present.

    python -c "from repro_torch.kernels import _build; print(_build.build_all())"
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on the PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([pathlib.Path(home) / "bin" / "nvcc"] if home else []) + [
            pathlib.Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from src/repro_torch/csrc at first use")
    return found


def library_path(name: str) -> pathlib.Path:
    """The library's path; its name hashes the source, every header of
    ``csrc/`` (``attention_tile.cuh`` is shared) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc for ``csrc/<name>.cu``; returns (process, temp output,
    final path), or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent loader never sees
    #                               a half-written library


def build_all() -> Dict[str, float]:
    """Compile every ``csrc/*.cu`` that is not built yet, one nvcc per
    source, all started together.  Returns {name: seconds to build}
    (0.0 for a library already on disk)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    times, errors = {}, []
    for n in names:                # wait for every nvcc, even after a failure
        if started[n] is not None:
            try:
                _finish(n, started[n])
            except RuntimeError as e:
                errors.append(e)
        times[n] = 0.0 if started[n] is None else time.perf_counter() - t0
    if errors:
        raise errors[0]
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    from the last build of ``csrc/<name>.cu``, or '' if none."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of a ``-Xptxas -v`` log: {name: {"registers",
    "spill_stores", "spill_loads"}} (spills in bytes).  Names are
    demangled with the toolkit's ``cu++filt`` (or ``c++filt``) where one
    is found, else left mangled."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([^' ]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    entries = {k: v for k, v in out.items() if "registers" in v}
    return dict(zip(_demangle(list(entries)), entries.values()))


def _demangle(names):
    try:
        nvcc_dir = pathlib.Path(nvcc_path()).parent
    except RuntimeError:
        nvcc_dir = None
    for tool in ([str(nvcc_dir / "cu++filt")] if nvcc_dir else []) + [
            "c++filt"]:
        if shutil.which(tool) is None:
            continue
        res = subprocess.run([tool], input="\n".join(names), text=True,
                             capture_output=True)
        lines = res.stdout.splitlines()
        if res.returncode == 0 and len(lines) == len(names):
            return lines
    return names
