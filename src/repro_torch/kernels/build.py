"""Build and load the port's CUDA C++ kernels (``csrc/*.cu``).

Each source has a plain C interface. At first use ``nvcc`` compiles it for
the card (``sm_90a`` on an H100) into ``build/cuda/`` at the repository
root, as a shared library whose file name carries a hash of the source,
the headers of its directory that it includes (``csrc/*.cuh``) and the
target, so an edit of any of them rebuilds; ``ctypes`` loads it. ``compile_all``
starts one ``nvcc`` per source at once and waits for all of them (what
``chip_smoke.py`` does before its first launch); ``load`` builds one
source if it is not built yet and binds its functions (each kernel module
calls it once, at its first launch).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Mapping

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda): the CUDA kernels are built "
                           "from source at first use")
    return path


def _arch() -> str:
    major, minor = torch.cuda.get_device_capability()
    return f"{major}{minor}" + ("a" if (major, minor) == (9, 0) else "")


def dependencies(source: Path) -> List[Path]:
    """``source``, then every header it includes by ``#include "..."``
    that lies beside the including file, directly or through another such
    header."""
    found: List[Path] = []
    todo = [source]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            header = path.parent / name
            if header.exists():
                todo.append(header)
    return found


def library_path(source: Path) -> Path:
    """Where the library of ``source`` for this card goes: the name hashes
    the source with its headers (``dependencies``) and the target."""
    arch = _arch()
    digest = hashlib.sha256()
    for path in dependencies(source):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(arch.encode())
    return BUILD_DIR / f"{source.stem}_sm{arch}_{digest.hexdigest()[:16]}.so"


def report_path(lib: Path) -> Path:
    """Where the compiler report of the library ``lib`` is kept."""
    return lib.with_suffix(".log")


def compile_all(sources: Iterable[Path]) -> Dict[str, str]:
    """Build every source not built yet, one ``nvcc`` each, all started
    together; returns the compiler reports (``-Xptxas -v``: registers,
    shared memory, spills) by file name, each under a first line ``nvcc
    <file>: <s> s`` with that build's wall seconds. Each report is kept
    beside its library (``report_path``); for a library already built the
    report returned is that file's, under a first line that says it was
    cached. Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, arch = _nvcc(), _arch()
    logs: Dict[str, str] = {}
    running: List = []
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            report = report_path(lib)
            logs[source.name] = f"cached build; its report, {report}:\n" + (
                report.read_text() if report.exists() else "(missing)\n")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        out = tmp.with_suffix(".log")
        cmd = [nvcc, "-gencode", f"arch=compute_{arch},code=sm_{arch}",
               "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(source)]
        with open(out, "w") as sink:
            proc = subprocess.Popen(cmd, stdout=sink,
                                    stderr=subprocess.STDOUT, text=True)
        running.append((source, lib, tmp, out, proc, time.perf_counter()))
    done: Dict[str, float] = {}
    while len(done) < len(running):
        for source, *_, proc, t0 in running:
            if source.name not in done and proc.poll() is not None:
                done[source.name] = time.perf_counter() - t0
        time.sleep(0.05)
    failed = []
    for source, lib, tmp, out, proc, _ in running:
        logs[source.name] = (f"nvcc {source.name}: "
                             f"{done[source.name]:.1f} s\n" + out.read_text())
        out.unlink()
        if proc.returncode != 0:
            failed.append(source.name)
        else:
            report_path(lib).write_text(logs[source.name])
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name}:\n{logs[name]}" for name in failed))
    return logs


def load(source: Path, signatures: Mapping[str, list]) -> ctypes.CDLL:
    """The library of ``source`` (built first if needed), with every
    function of ``signatures`` bound: ``argtypes`` as given, ``restype``
    int (a ``cudaError_t``, or -1 for a shape without an instantiation)."""
    lib_path = library_path(source)
    if not lib_path.exists():
        compile_all([source])
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
