"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its
own into a shared library for ``sm_90a`` (Hopper).  Builds happen on
first use, on the machine with the card, into ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``); a library's file
name carries a digest of its source and of every header it includes
(``#include "..."``, followed recursively), so an edited source or
shared header is rebuilt and never mixed up with a stale library.  ``build_all`` starts one ``nvcc``
per missing library and waits for all of them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from ..sanitize import note_trace

_PKG = Path(__file__).resolve().parent
#: Library name -> CUDA source, relative to this directory.
SOURCES: Dict[str, str] = {
    "fleet_ragged": "sketch_update/csrc/fleet_ragged.cu",
    "sketch_update": "sketch_update/csrc/sketch_update.cu",
    "fleet_dense": "sketch_update/csrc/fleet_dense.cu",
}
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path) -> List[Path]:
    """``path`` and every local header it includes, recursively, each once
    and in a fixed order."""
    seen: List[Path] = []
    todo = [path.resolve()]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        todo += [(p.parent / m.decode()).resolve()
                 for m in _INCLUDE.findall(p.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for p in _sources(_PKG / SOURCES[name]):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` process each, started together.  Returns
    ``{name: {"seconds": wall time, "log": nvcc output}}`` for the
    libraries it built; raises with the compiler's output on failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_PKG / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    built, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return built


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing.  Each
    cache miss is one ``build.<name>`` count of ``sanitize.note_trace``:
    a steady-state run loads nothing."""
    note_trace(f"build.{name}")
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
