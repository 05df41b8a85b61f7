"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``versecrafter_tpu_torch/csrc/<name>.cu`` compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``versecrafter_tpu_torch/build/<name>-<source hash>.so`` (git-ignored),
exposing a plain C interface — no PyTorch headers, so a build takes seconds.
Shared device helpers live in ``csrc/*.cuh``; the hash covers them too. A
library whose hash matches is reused; a changed source builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source, every shared
    csrc/*.cuh header (a changed header rebuilds every library) and the
    flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            h.update(f.encode() + b"\0" + src.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str, verbose: bool = False) -> str:
    """Compile csrc/<name>.cu unless an up-to-date library exists; returns
    the library path. The output is written to a temporary file and renamed,
    so concurrent builders never load a half-written library."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names: Iterable[str], verbose: bool = False) -> None:
    """Build several sources at once, one nvcc per source, all started
    together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for fut in [pool.submit(build, n, verbose) for n in names]:
            fut.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name))
        return _libs[name]


def ptxas_report(name: str) -> str:
    """ptxas's resource report (``-Xptxas -v``) for csrc/<name>.cu: every
    kernel's registers, spills and shared memory, and ptxas's warnings. The
    source is compiled to a cubin in a temporary directory with the
    library's code-generation flags; the library itself is untouched."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_nvcc(), *NVCC_FLAGS[:4], "-cubin", "-Xptxas", "-v", "-o",
               os.path.join(tmp, name + ".cubin"), os.path.join(CSRC_DIR, name + ".cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    return proc.stderr


def ptxas_kernels(report: str) -> Dict[str, dict]:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from a ptxas_report."""
    kernels: Dict[str, dict] = {}
    current = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = kernels.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return kernels


def kernel_sources() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
