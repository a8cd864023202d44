"""Build the port's native libraries from source at first use.

Every shared object lands in ``src/repro_torch/_build/`` (listed in
``.gitignore``), named by a hash of its sources and its compiler command,
so a changed source or flag rebuilds and no library is shared with another
package or checkout. The compiler's diagnostics of a successful build are
kept beside the library (``<name>.log``: with ``-Xptxas -v`` they hold each
CUDA kernel's registers, shared memory and spills). A missing compiler or a
failed build raises; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_library(name: str, sources, command, deps=()) -> Path:
    """Compile ``sources`` with ``command`` (the compiler and its flags)
    into ``BUILD_DIR/<name>_<hash>.so``, unless that file exists. ``deps``
    (headers the sources include) count in the hash but are not compiled."""
    sources = [Path(s) for s in sources]
    h = hashlib.sha256("\0".join(command).encode())
    for s in [*sources, *map(Path, deps)]:
        h.update(s.read_bytes())
    so = BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*command, "-o", str(tmp), *map(str, sources)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"building {name} failed ({command[0]} exit "
                           f"{proc.returncode}):\n{proc.stderr[-6000:]}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: concurrent builders race benignly
    return so


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    the PATH. Raises when there is none."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    path = str(cand) if cand.exists() else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are compiled from source at first use")
    return path


def build_cuda(name: str, sources, deps=()) -> Path:
    """Build CUDA sources for sm_90a into a shared library with a plain C
    interface (loaded with ctypes); ``deps`` as for :func:`build_library`."""
    return build_library(name, sources, [nvcc(), *NVCC_FLAGS], deps)
