"""The DREAM loader's host C++ (`dream_ops.cpp`), built with g++ and
loaded with ctypes.

Port of `horopose_tpu/native/`: the fused square-pad crop and bilinear
resize (`crop_resize_bilinear`, `crop_resize_bilinear_batch`) and, where
libjpeg's header exists, the JPEG decode (`decode_jpeg`). The library is
compiled at first use into `horopose_tpu_torch/_build/dream_ops-<hash>.so`
(the hash covers the source and the flags, so a changed source is
rebuilt) with the JAX package's flags, `-march=native` included, so both
packages compile the same code and their crops are byte-identical. The
build holds a file lock and renames a finished library into place, so two
processes never load a half-written one. `_build/` belongs to the machine
that built it.

The crop has no fallback: a failed build or load raises with the
compiler's message. The decode is built when the compiler finds
`jpeglib.h` and linked with `-ljpeg`; without the header the library is
built with `-DHOROPOSE_NO_JPEG` and PIL decodes (`decoder()` says which).
Once a process, a canary holds the native decode of a small JPEG against
PIL's and turns the decode off if they differ: the decode cache assumes
that a frame decodes to the same bytes in every worker.

The dataset loads the library in its constructor, so a loader's parent
builds it before forking its workers.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import io
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "dream_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SOURCE)), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_decode_ok: Optional[bool] = None


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "horopose_tpu_torch.native: g++ not found on PATH; the DREAM "
            f"loader's crop ({SOURCE}) is built with g++ at first use")
    return cxx


def has_jpeg_header(cxx: str) -> bool:
    """Whether `cxx` finds libjpeg's header (the preprocessor alone)."""
    res = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                         input="#include <cstdio>\n#include <jpeglib.h>\n",
                         capture_output=True, text=True, timeout=60)
    return res.returncode == 0


def _flags(with_jpeg: bool) -> tuple:
    return CXX_FLAGS + (("-ljpeg",) if with_jpeg else ("-DHOROPOSE_NO_JPEG",))


def library_path(with_jpeg: bool) -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(with_jpeg))
                                .encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"dream_ops-{digest}.so")


def _compile(cxx: str, with_jpeg: bool, out: str):
    """One g++ run into a temporary name, renamed into place."""
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, SOURCE, "-o", tmp]
    cmd += ["-ljpeg"] if with_jpeg else ["-DHOROPOSE_NO_JPEG"]
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=BUILD_TIMEOUT_S)
    if res.returncode != 0:
        raise RuntimeError(f"horopose_tpu_torch.native: {' '.join(cmd)} "
                           f"failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)


def build() -> str:
    """The library's path, compiled first when it is missing."""
    cxx = _compiler()
    with_jpeg = has_jpeg_header(cxx)
    out = library_path(with_jpeg)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "dream_ops.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):      # another process may have built it
            _compile(cxx, with_jpeg, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built if needed, loaded once a process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.crop_resize_bilinear.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int]
            lib.crop_resize_bilinear.restype = None
            lib.crop_resize_bilinear_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.crop_resize_bilinear_batch.restype = None
            if hasattr(lib, "jpeg_dims"):   # absent without libjpeg
                lib.jpeg_dims.argtypes = [
                    ctypes.c_void_p, ctypes.c_long,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int)]
                lib.jpeg_dims.restype = ctypes.c_int
                lib.jpeg_decode_rgb.argtypes = [
                    ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int]
                lib.jpeg_decode_rgb.restype = ctypes.c_int
            _lib = lib
        return _lib


def _decode(lib, data: bytes) -> Optional[np.ndarray]:
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    if lib.jpeg_dims(buf.ctypes.data, len(data), ctypes.byref(h),
                     ctypes.byref(w)):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode_rgb(buf.ctypes.data, len(data), out.ctypes.data,
                           h.value, w.value):
        return None
    return out


def _verify_decode_parity(lib) -> bool:
    """The one-time canary: a seeded 64x80 JPEG decoded natively must equal
    PIL's decode of it, byte for byte."""
    global _decode_ok
    if _decode_ok is None:
        from PIL import Image
        arr = np.random.RandomState(0).randint(0, 255, (64, 80, 3),
                                               dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=92)
        data = buf.getvalue()
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        ours = _decode(lib, data)
        _decode_ok = ours is not None and np.array_equal(ours, ref)
        if not _decode_ok:
            print("[native] the system libjpeg disagrees with PIL's; the "
                  "native JPEG decode is off on this host")
    return _decode_ok


def decoder() -> str:
    """"libjpeg" when `decode_jpeg` decodes natively, else "PIL"."""
    lib = load()
    if hasattr(lib, "jpeg_dims") and _verify_decode_parity(lib):
        return "libjpeg"
    return "PIL"


def decode_jpeg(path_or_bytes) -> Optional[np.ndarray]:
    """A JPEG (a path or its bytes) decoded to (H, W, 3) uint8 RGB by the
    system libjpeg, byte-identical to PIL's `Image.open(...).convert("RGB")`.
    None when the decode is not built, the canary turned it off, or the
    file is not a plain JPEG: the caller decodes with PIL."""
    if decoder() != "libjpeg":
        return None
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    return _decode(load(), data)


def crop_resize_bilinear(src: np.ndarray, bbox, size: int) -> np.ndarray:
    """The fused square-pad crop and bilinear resize of one frame:
    src (H, W, 3) uint8, bbox [wmin, hmin, wmax, hmax] (truncated to ints)
    -> (size, size, 3) uint8."""
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"src must be (H, W, 3) uint8, got {src.shape}")
    out = np.empty((size, size, 3), np.uint8)
    wmin, hmin, wmax, hmax = [int(v) for v in bbox]
    load().crop_resize_bilinear(src.ctypes.data, src.shape[0], src.shape[1],
                                wmin, hmin, wmax, hmax, out.ctypes.data,
                                size)
    return out


def crop_resize_bilinear_batch(src: np.ndarray, bboxes, size: int
                               ) -> np.ndarray:
    """`crop_resize_bilinear` of N frames of one size: src (N, H, W, 3)
    uint8, bboxes (N, 4) -> (N, size, size, 3) uint8."""
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 4 or src.shape[3] != 3:
        raise ValueError(f"src must be (N, H, W, 3) uint8, got {src.shape}")
    n = src.shape[0]
    boxes = np.ascontiguousarray(np.asarray(bboxes).astype(np.int32)
                                 .reshape(n, 4))
    out = np.empty((n, size, size, 3), np.uint8)
    load().crop_resize_bilinear_batch(src.ctypes.data, n, src.shape[1],
                                      src.shape[2], boxes.ctypes.data,
                                      out.ctypes.data, size)
    return out
