"""Build and load the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``; ``csrc/<name>.cpp`` (the native graph
builder) likewise by the host compiler (``$CXX``, else ``g++``).  Libraries
go to ``build/torch_kernels/`` at the root of the checkout, keyed by a hash
of the source, the headers of ``csrc/`` and the flags (and, for host code
compiled for the host's own CPU, the host), so an edited source or header is
rebuilt.  A build writes a temporary file and renames it into place under
an ``fcntl`` lock beside the library, so that concurrent processes (test
workers) wait for one build instead of loading a half-written file.  There
is no fallback: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# The JAX package's native/Makefile flags (less its -Wall), so that the port's
# graph builder computes the JAX package's bits on one machine.
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or shutil.which(
        "nvcc", path=os.path.join(cuda_home, "bin")
    )
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from source and have no fallback"
        )
    return nvcc


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every header beside it (``csrc/*.cuh``:
    a source may include any of them) and the flags: the key of its
    library, so that an edited source or header is rebuilt."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out: Path, cmd, what: str) -> Path:
    """Run ``cmd + ["-o", tmp]`` and rename ``tmp`` to ``out``, under an
    exclusive lock on ``out``'s lock file; a process that finds ``out``
    once it holds the lock uses it (another built it meanwhile)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{what} (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_digest(name)}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    return _compile(out, [nvcc, *NVCC_FLAGS, str(src)], f"nvcc failed to build {src}")


def host_compiler() -> str:
    """``$CXX`` if set, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` with the host compiler and HOST_FLAGS
    unless an up-to-date library exists.  The key holds the compiler, the
    flags and the machine (``-march=native`` code is for its CPU)."""
    src = CSRC_DIR / f"{name}.cpp"
    cxx = host_compiler()
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join([cxx, *HOST_FLAGS, platform.machine(), platform.node()]).encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    return _compile(out, [cxx, *HOST_FLAGS, str(src)],
                    f"{cxx} failed to build {src}")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return ctypes.CDLL(str(build(name)))
