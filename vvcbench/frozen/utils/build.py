"""Build helpers for the port's native pieces.

Everything is compiled at first use from the sources in the checkout
into the git-ignored `vvcbench/frozen/_build/`: the host parser with
make (models/vvc/host.py), the stream generator's CABAC encoder with the
C++ compiler (encoder/native_cabac.py) and each CUDA kernel with nvcc,
each into a shared library with a plain C interface, bound with ctypes.  A file lock
serialises concurrent builders (test workers, parse threads); a library
that is newer than all of its sources is reused.
"""
from __future__ import annotations

import fcntl
import os
import subprocess
import time
from contextlib import contextmanager

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra",
             "-Wno-unused-parameter"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# what the last nvcc build printed (ptxas register / shared-memory lines)
# and how long it took, keyed by library name
BUILD_LOG: dict = {}


@contextmanager
def _lock(name: str):
    """One lock per built library, so different libraries build in
    parallel while concurrent builders of one library wait."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".lock.{name}"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_locked(name: str, cmd, cwd=None) -> None:
    with _lock(name):
        subprocess.run(cmd, cwd=cwd, check=True)


def _nvcc() -> str:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _fresh(out: str, deps) -> bool:
    return os.path.exists(out) and all(
        os.path.getmtime(s) <= os.path.getmtime(out) for s in deps)


def build_cxx(name: str, sources, headers=()) -> str:
    """Compile `sources` with the host's C++ compiler ($CXX, else g++)
    into _build/lib<name>.so unless a library newer than them and the
    `headers` they include exists; returns the library path.  A failed
    build raises with the compiler's output."""
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    with _lock(name):
        if _fresh(out, (*sources, *headers)):
            return out
        cxx = os.environ.get("CXX", "g++")
        tmp = f"{out}.tmp.{os.getpid()}"
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *sources],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{cxx} failed for {name}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {name}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def build_cuda(name: str, sources, defines=(), headers=()) -> str:
    """nvcc `sources` into _build/lib<name>.so (sm_90a) unless a library
    newer than them and the `headers` they include exists; returns the
    library path.  defines: (macro, value) pairs passed as -D, whose
    values also name the library, so that other values build another
    one.  A failed build raises with the compiler's output."""
    tag = name + "".join(f"_{v}" for _, v in defines)
    out = os.path.join(BUILD_DIR, f"lib{tag}.so")
    with _lock(tag):
        if _fresh(out, (*sources, *headers)):
            return out
        tmp = f"{out}.tmp.{os.getpid()}"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS,
                               *(f"-D{k}={v}" for k, v in defines),
                               "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_LOG[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [ln.strip() for ln in proc.stderr.splitlines()
                      if "registers" in ln or "Compiling entry" in ln
                      or "spill" in ln],
        }
    return out
