"""Host-side C++ augmentation, built with g++ and loaded with ctypes
(counterpart of ``optwboundeigenval_tpu/native/__init__.py``).

``augment.cpp`` is compiled on first use into
``build/torch_kernels/augment-<hash>.so`` at the root of the checkout
(``build/`` is git-ignored), with the JAX package's flags

    g++ -O3 -shared -fPIC -std=c++17

so both packages run the same machine code on a batch.  The file name
carries a hash of the source and flags: an edited source is rebuilt and a
stale library is never loaded.  Nothing here falls back: where the JAX
package returns ``None`` when the build or the load fails (and its
caller switches to scipy, another random stream), the port raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from optwboundeigenval_tpu_torch.utils.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().with_name("augment.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(src: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode())
    return build_dir / f"{src.stem}-{digest.hexdigest()[:12]}.so"


def build(src: Path = SOURCE, build_dir: Path = BUILD_DIR, cxx: str = "g++") -> Path:
    """Compile ``src`` unless its library exists; returns the library's
    path.  Raises ``RuntimeError`` when the compiler is missing or fails."""
    path = library_path(src, build_dir)
    if path.exists():
        return path
    build_dir.mkdir(parents=True, exist_ok=True)
    # a temporary name renamed on success: a concurrent build never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build {src.name} with {cxx}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed on {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load(path: Path) -> ctypes.CDLL:
    """Open the library at ``path`` and declare its two entry points.
    Raises ``RuntimeError`` when it does not load."""
    try:
        handle = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    handle.crop_pad_rotate_f32.argtypes = [f32p, f32p, i64, i64, i64, i64, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_uint64]
    handle.crop_pad_rotate_f32.restype = None
    handle.translate_hflip_f32.argtypes = [f32p, f32p, i64, i64, i64, i64,
                                           ctypes.c_float, ctypes.c_uint64]
    handle.translate_hflip_f32.restype = None
    return handle


@functools.cache
def lib() -> ctypes.CDLL:
    """The library of ``augment.cpp``, built first if needed."""
    return load(build())


def _batch(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 4:
        raise ValueError(f"expected an NHWC batch, got shape {x.shape}")
    return x


def crop_pad_rotate(x: np.ndarray, pad: int, max_deg: float, seed: int) -> np.ndarray:
    """Random crop after zero padding by ``pad`` and a random bilinear
    rotation within ``+-max_deg`` of each NHWC float32 image (the USPS
    recipe), drawn from ``seed``."""
    x = _batch(x)
    out = np.empty_like(x)
    lib().crop_pad_rotate_f32(x, out, *x.shape, pad, max_deg,
                               np.uint64(seed & (2**64 - 1)))
    return out


def translate_hflip(x: np.ndarray, frac: float, seed: int) -> np.ndarray:
    """Random translation within ``+-frac`` of the size and a random
    horizontal flip of each NHWC float32 image (the CIFAR recipe), drawn
    from ``seed``."""
    x = _batch(x)
    out = np.empty_like(x)
    lib().translate_hflip_f32(x, out, *x.shape, frac, np.uint64(seed & (2**64 - 1)))
    return out
