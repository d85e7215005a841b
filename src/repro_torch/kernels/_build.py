"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` into ``build/lib<name>.so`` beside ``csrc/`` (listed in
``.gitignore``), at first use or when the source is newer than the library.
``build()`` starts one ``nvcc`` per stale source, all at once, with
``-Xptxas -v``: ``ptxas_report`` reads each kernel's registers and spill
bytes from the log.  A source may export ``<name>_kernel_info`` (registers,
local bytes, shared bytes and resident blocks per SM of each of its kernels,
from the runtime); ``kernel_info`` reads it.  Libraries are loaded with
``ctypes``; each wrapper declares ``argtypes`` with ``c_void_p`` for every
pointer and for the stream.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def build(names: Optional[Iterable[str]] = None, *,
          force: bool = False) -> Dict[str, dict]:
    """Compile the named sources (all by default) in parallel.

    Returns ``{name: {"seconds": wall, "log": nvcc output}}`` for the sources
    it compiled.  Raises with nvcc's output on failure."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    todo = [n for n in names if force or _stale(n, srcs[n])]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(srcs[n])]
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


def ptxas_report(log: str) -> List[dict]:
    """Per kernel of an ``-Xptxas -v`` log: its (mangled) name, registers,
    static shared bytes and spill store/load bytes."""
    out: List[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append({"kernel": m.group(1), "registers": None, "smem_static": 0,
                        "spill_stores": None, "spill_loads": None})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[-1]["spill_stores"], out[-1]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem_static"] = int(sm.group(1)) if sm else 0
    return out


def kernel_info(name: str) -> List[dict]:
    """What the runtime says of each kernel of ``lib<name>.so`` at its launch
    configuration, through its ``<name>_kernel_info`` export: registers,
    local (spill) bytes a thread, shared bytes a block and resident blocks
    an SM.  Empty if the source exports none.  Needs the card."""
    lib = load(name)
    fn = getattr(lib, f"{name}_kernel_info", None)
    if fn is None:
        return []
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = []
    for i in range(64):
        kname, info = ctypes.c_char_p(), (ctypes.c_int * 4)()
        err = fn(i, ctypes.byref(kname), info)
        if err == -1:           # past the last kernel
            break
        if err:
            raise RuntimeError(f"{name}_kernel_info({i}): cudaError {err}")
        out.append({"kernel": kname.value.decode(), "registers": info[0],
                    "local_bytes": info[1], "smem_bytes": info[2],
                    "blocks_per_sm": info[3]})
    return out
