"""Build and load the hand-written CUDA kernels.

Each source under ``gpssim_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/kernels/`` at the repository root, and loaded with ctypes.
The library's file name carries a hash of its source and of every header
under ``csrc`` that it includes, so an edited kernel or header is rebuilt
and a stale library never loads. A missing compiler or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build from source on the machine with the card"
        )
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources() -> list[str]:
    """Every kernel source under ``csrc``: the ``*.cu`` files."""
    return sorted(n for n in os.listdir(CSRC) if n.endswith(".cu"))


def _closure(source: str) -> list[str]:
    """``source`` and the ``csrc`` headers it includes, transitively (by
    ``#include "..."``), in the order first reached."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(CSRC, name), "rb") as fp:
            for inc in _INCLUDE.findall(fp.read()):
                inc = inc.decode()
                if os.path.exists(os.path.join(CSRC, inc)):
                    todo.append(inc)
    return seen


def lib_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` goes: its name
    hashes the source and every header it includes."""
    h = hashlib.sha256()
    for name in _closure(source):
        with open(os.path.join(CSRC, name), "rb") as fp:
            h.update(name.encode() + b"\0" + fp.read() + b"\0")
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(source: str) -> tuple[str, str]:
    """Compile ``csrc/<source>`` unless its library exists; returns
    (library path, the compiler's ptxas report: each kernel's registers,
    shared memory and spills, kept beside the library)."""
    out = lib_path(source)
    if os.path.exists(out):
        try:
            with open(out + ".ptxas") as fp:
                return out, fp.read()
        except FileNotFoundError:
            return out, ""
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {source} (rc {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    with open(out + ".ptxas", "w") as fp:
        fp.write(proc.stderr)
    os.replace(tmp, out)
    return out, proc.stderr


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source)[0])
            _libs[source] = lib
        return lib
