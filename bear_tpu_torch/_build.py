"""Build the port's native code from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher and is compiled
by ``nvcc`` into ``csrc/build/lib<name>-<digest>.so``, then loaded with
``ctypes``. The digest covers the source, every shared header
``csrc/*.cuh`` and the flags, so an edited source or header never loads a
stale library. ``SOURCE_FLAGS`` adds a source's own flags: ``keyed_draw.cu``
is compiled with ``-fmad=false``, so that its float chain rounds each
multiply and add as its plain PyTorch version does. ``extra`` flags (a
timing-only ``-D`` build of a source, which no wrapper loads) name a
library of their own. Sources are compiled in parallel, one ``nvcc``
process each. ``ptxas -v`` output (registers, shared memory, spills) is
kept beside each library as ``.log``.

The host route (:func:`build_host`) compiles ``csrc/<name>.cpp`` with
``g++`` the same way, linking zlib where it links (``-DBEAR_HAS_ZLIB
-lz``) and without it otherwise. A failed build raises with the
compiler's output: there is no silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCE_FLAGS = {"keyed_draw": ("-fmad=false",)}


def _flags(name: str, extra: tuple = ()) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ()) + tuple(extra)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str, extra: tuple = ()) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (with ``extra``
    flags) lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name, extra)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str], extra: tuple = ()) -> Dict[str, Path]:
    """Compile every named source that has no current library (with
    ``extra`` flags), all at once, and return {name: library path}. Raises
    with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n, extra) for n in names}
    procs = {}
    for name, so in out.items():
        if so.exists():
            continue
        # Per-process temp name + atomic rename: concurrent first uses never
        # load a half-written library.
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name, extra), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        so = out[name]
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it if it has none."""
    return ctypes.CDLL(str(build([name])[name]))


HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
ZLIB_FLAGS = ("-DBEAR_HAS_ZLIB", "-lz")


def host_library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cpp`` lives."""
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(HOST_FLAGS + ZLIB_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` with g++ unless its library is current;
    with zlib where it links, else without. Raises with both attempts'
    compiler output when neither builds."""
    so = host_library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError(f"no C++ compiler (g++) on PATH to build csrc/{name}.cpp")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    logs = []
    for extra in (ZLIB_FLAGS, ()):
        cmd = [gxx, *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp"), *extra]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode == 0:
            so.with_suffix(".log").write_text(logs[-1])
            os.replace(tmp, so)
            return so
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"g++ failed for {name}.cpp:\n" + "\n".join(logs))
