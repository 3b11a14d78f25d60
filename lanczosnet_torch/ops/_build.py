"""Build the port's CUDA sources with ``nvcc`` on first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries go to ``build/kernels/`` beside the package,
a directory ``.gitignore`` lists, named by a hash of the source and the
flags, so an edited source is never served from a stale build.
``build_all`` starts one ``nvcc`` per source, all at once. ``build_cxx``
builds a C++ source of ``native/`` with ``g++`` the same way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No --use_fast_math: it changes sqrtf and division, which the Lanczos
# recursion depends on. -Xptxas -v reports registers, shared memory and
# spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass
class Built:
    """One compiled source: the library path, the seconds its build took
    (0.0 when an earlier build was reused) and the compiler's output."""

    name: str
    path: Path
    seconds: float
    log: str


def nvcc() -> str:
    """Path of ``nvcc``; raises if the CUDA toolkit is not installed."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from csrc/ on first use"
    )


def library_path(src: Path, flags: tuple[str, ...], build_dir: Path) -> Path:
    """Where the library of ``src`` built with ``flags`` goes: named by a
    hash of both, so an edited source or flag is never served stale."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    return build_dir / f"{src.stem}-{digest[:16]}.so"


def build_cxx(name: str, src: Path, flags: tuple[str, ...], build_dir: Path) -> Built:
    """Compile the C++ source ``src`` with ``g++`` and ``flags`` into
    ``build_dir`` unless a build of this source and these flags exists
    (``Built.seconds`` is then 0.0); raises with g++'s output if the
    build fails."""
    out = library_path(src, flags, build_dir)
    if out.exists():
        return Built(name, out, 0.0, "")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(["g++", *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return Built(name, out, time.perf_counter() - t0, proc.stdout + proc.stderr)


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    return src, library_path(src, NVCC_FLAGS, BUILD_DIR)


def build_all(names: list[str]) -> list[Built]:
    """Compile every named source not yet built, one ``nvcc`` each, all
    started together; raises with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    built = []
    for name in names:
        src, out = _target(name)
        if out.exists():
            log = out.with_suffix(".log")
            built.append(Built(name, out, 0.0, log.read_text() if log.exists() else ""))
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in jobs:  # wait for every nvcc, then report
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        built.append(Built(name, out, seconds, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it first if no
    build of this source exists."""
    (built,) = build_all([name])
    return ctypes.CDLL(str(built.path))
