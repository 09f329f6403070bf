"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and compiles on
its own into ``build/kernels/<name>-<sha>.so`` at the repository root.  The
digest covers the source, every header of ``csrc/`` it includes (followed
through the headers' own includes) and the nvcc flags, so an edited source,
header or flag never loads a stale library.  Nothing is compiled when a module is imported: the first wrapper
call that launches a kernel builds its library, and ``build_all`` compiles
every source at once, one nvcc process per source running side by side.

``launch`` is the one way a wrapper calls an entry point: the entry
launches on the calling thread's current device, so the wrapper makes its
operands' card current first, as ATen enters an operand's device guard for
each of its own ops.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
SOURCES = ("paged_attention", "paged_decode", "kv_block_copy", "flash_attention", "gemm", "norm",
           "contract", "wgmma_probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _local_files(path: Path, seen: Dict[Path, bytes]) -> None:
    """``path`` and every ``#include "..."`` it reaches under ``csrc/``."""
    if path in seen:
        return
    text = path.read_bytes()
    seen[path] = text
    for inc in _INCLUDE.findall(text):
        dep = (path.parent / inc.decode()).resolve()
        if not dep.is_file():
            raise RuntimeError(f"{path.name} includes {inc.decode()}, which is not in {CSRC}")
        _local_files(dep, seen)


def library_path(name: str) -> Path:
    files: Dict[Path, bytes] = {}
    _local_files(CSRC / f"{name}.cu", files)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(files):
        h.update(path.name.encode() + b"\0" + files[path])
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def compile_source(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    nvcc's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def build_all() -> Dict[str, float]:
    """Compile every source in parallel; returns wall seconds per source."""

    def one(name: str) -> float:
        t0 = time.monotonic()
        compile_source(name)
        return time.monotonic() - t0

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        secs = list(pool.map(one, SOURCES))
    return dict(zip(SOURCES, secs))


def launch(entry, device, *args) -> int:
    """``entry(*args, stream)`` with ``device`` (the operands' card) current
    and its current stream: a tensor on ``cuda:2`` launches on card 2 even
    when the process's current card is 0, and ``allow_smem``'s per-card flag
    (``csrc/common.cuh``) reads card 2.  Returns the entry's CUDA error."""
    import torch

    with torch.cuda.device(device):
        return entry(*args, torch.cuda.current_stream(device).cuda_stream)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            _libs[name] = lib
        return lib
