"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` into ``build/lib<name>.so`` beside ``csrc/`` (listed in
``.gitignore``), at first use or when the source is newer than the library.
``build()`` starts one ``nvcc`` per stale source, all at once.  Libraries are
loaded with ``ctypes``; each wrapper declares ``argtypes`` with ``c_void_p``
for every pointer and for the stream.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "a machine with the CUDA toolkit")


def _stale(name: str, src: Path) -> bool:
    lib = lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names: Optional[Iterable[str]] = None, *, force: bool = False,
          verbose: bool = False) -> Dict[str, dict]:
    """Compile the named sources (all by default) in parallel.

    Returns ``{name: {"seconds": wall, "log": nvcc stderr}}`` for the sources
    it compiled; ``verbose`` adds ``-Xptxas -v`` (registers, shared memory,
    spills per kernel) to the log.  Raises with nvcc's output on failure."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    todo = [n for n in names if force or _stale(n, srcs[n])]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", tmp, str(srcs[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, time.perf_counter())
    out, failed = {}, []
    for n, (proc, tmp, t0) in procs.items():
        stdout, stderr = proc.communicate()
        out[n] = {"seconds": time.perf_counter() - t0, "log": stdout + stderr}
        if proc.returncode != 0:
            failed.append(f"--- {n} (rc={proc.returncode}) ---\n{stdout}{stderr}")
            os.unlink(tmp)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, built first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
