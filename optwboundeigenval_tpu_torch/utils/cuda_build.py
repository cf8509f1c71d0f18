"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/torch_kernels/<name>-<hash>.so`` at the root of
the checkout (``build/`` is git-ignored), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

The file name carries a hash of the source and flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing here
falls back: without ``nvcc`` a build raises.  Builds of several sources
run as parallel ``nvcc`` processes (:func:`build`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of optwboundeigenval_tpu_torch cannot be built"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no current library,
    one ``nvcc`` process per source, all started together.  Returns the
    library path of each name; raises ``RuntimeError`` with the compiler
    output if any build fails."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        # write to a temporary name and rename, so a concurrent build
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{n}: nvcc exited {proc.returncode}\n"
                          f"{out.decode(errors='replace')}")
        else:
            os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed (callers
    keep the handle: each call opens the library again)."""
    return ctypes.CDLL(str(build([name])[name]))
