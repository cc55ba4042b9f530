"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles into its
own shared library for sm_90a, at first use, into ``adamml_tpu_torch/_build``
(listed in .gitignore). The file name carries a hash of the source and the
flags, so an edited source is rebuilt. ``build`` starts one nvcc per
missing library, all at once, and waits for every one; the first use of any
library builds every missing one so. A missing nvcc or a
failed compile raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> Optional[str]:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default place."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    return None


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of the current source."""
    return library_path(name).with_suffix(".log").read_text()


def ptxas_entries(name: str) -> List[dict]:
    """Each kernel instantiation in the build log of ``name``: its mangled
    entry name, registers a thread, static shared memory, stack frame and
    spill stores and loads (bytes), as ``-Xptxas -v`` reports them."""
    entries: List[dict] = []
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append({"entry": m.group(1)})
            continue
        if not entries:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entries[-1].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entries[-1]["smem"] = int(m.group(1)) if m else 0
    return entries


def build(names: Iterable[str]) -> None:
    """Compile every named source whose library is missing, one nvcc each,
    all started together."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
            "/usr/local/cuda/bin); the port's CUDA kernels need the CUDA "
            "toolkit to build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {source_path(name)} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))


def sources() -> List[str]:
    """The names of every ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``. When it is missing, every
    missing library is built, in one round: a train step's first BN call
    then builds the epilogue kernels it launches next as well."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            build(sources())
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
