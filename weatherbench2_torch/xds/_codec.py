"""Build and load the port's host codec library (C++ compiler + ctypes).

``csrc/codecs.cpp`` decodes every blosc1 chunk (BloscLZ, LZ4, LZ4HC,
Snappy, zlib, zstd; byte and bit shuffle), whole or a range of its blocks,
and encodes blosc-lz4 and blosc-zstd.  It is
compiled with the host's C++ compiler (``$CXX``, else ``c++``, else ``g++``)
at first use into ``build/weatherbench2_torch/libwb2codecs.so`` beside the
package, and rebuilt when the source's hash changes.  There is no decoder in
Python and no fallback: without a compiler a blosc store cannot be opened.
ctypes releases the GIL during a call, so threads decode chunks in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "codecs.cpp"
CXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-pthread"]
# the writer's threads a chunk (blocks encode independently)
ENCODE_THREADS = min(8, os.cpu_count() or 1)
LIBRARY = "libwb2codecs.so"
# beside the CUDA kernels' library (ops/_build.py)
BUILD_DIR = _PKG.parent / "build" / "weatherbench2_torch"
_HEADER_BYTES = 16

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "wb2_blosc_decode": [ctypes.c_char_p, _I64, _P, _I64],
    "wb2_blosc_decode_blocks": [ctypes.c_char_p, _I64, _P, _I64, _I64, _I64],
    "wb2_blosc_encode": [_INT, _INT, _INT, _INT, _I64, _INT, _P, _I64, _P,
                         _I64, ctypes.POINTER(_I64)],
}
# blosc's codec numbers of the codecs the writer encodes
ENCODERS = {"lz4": 1, "zstd": 4}


def compiler() -> str:
  """The host's C++ compiler, or a RuntimeError that names what was tried."""
  for name in (os.environ.get("CXX"), "c++", "g++"):
    path = name and shutil.which(name)
    if path:
      return path
  raise RuntimeError(
      "no C++ compiler found ($CXX, c++, g++): the blosc codec is built "
      f"from {SOURCE} at first use")


def build() -> str:
  """Compile the codec library if its source hash changed; its path."""
  src = SOURCE.read_bytes()
  digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
  lib_path = BUILD_DIR / LIBRARY
  stamp = BUILD_DIR / "libwb2codecs.sha256"
  if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
    return str(lib_path)
  cmd = [compiler(), *CXX_FLAGS]
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
  cmd += ["-o", str(tmp), str(SOURCE)]
  proc = subprocess.run(cmd, capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(
        f"C++ build failed ({proc.returncode}): {' '.join(cmd)}\n"
        f"{proc.stderr}")
  os.replace(tmp, lib_path)
  stamp.write_text(digest)
  return str(lib_path)


def library(context: str):
  """The loaded codec library (built on first use); a build failure raises
  a RuntimeError that starts with ``context`` (the store being opened)."""
  global _lib
  with _lock:
    if _lib is None:
      try:
        path = build()
      except (RuntimeError, OSError) as err:
        raise RuntimeError(f"{context}: {err}") from err
      lib = ctypes.CDLL(path)
      for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
      lib.wb2_codec_error_string.argtypes = [ctypes.c_int]
      lib.wb2_codec_error_string.restype = ctypes.c_char_p
      _lib = lib
  return _lib


def _check(lib, err: int, where: str) -> None:
  if err:
    raise ValueError(
        f"{where}: {lib.wb2_codec_error_string(err).decode()} (code {err})")


def decode_into(raw: bytes, out: np.ndarray, where: str) -> None:
  """Decode the blosc1 chunk ``raw`` into the C-contiguous ``out``, which
  it must fill exactly; a ValueError names ``where`` otherwise."""
  if not out.flags.c_contiguous:
    raise ValueError(f"{where}: decode target is not C-contiguous")
  lib = library(where)
  _check(lib, lib.wb2_blosc_decode(raw, len(raw), out.ctypes.data,
                                   out.nbytes), where)


def decode_blocks_into(raw: bytes, first: int, last: int, out: np.ndarray,
                       where: str) -> None:
  """Decode blocks ``first``..``last`` of the blosc1 chunk ``raw`` into the
  C-contiguous ``out``: block j at byte (j - first) * blocksize, ``out``
  the bytes of those blocks (``blosc_header``)."""
  if not out.flags.c_contiguous:
    raise ValueError(f"{where}: decode target is not C-contiguous")
  lib = library(where)
  _check(lib, lib.wb2_blosc_decode_blocks(raw, len(raw), out.ctypes.data,
                                          out.nbytes, first, last), where)


def blosc_header(raw: bytes) -> dict:
  """The fields of a blosc1 chunk's 16-byte header."""
  if len(raw) < _HEADER_BYTES:
    raise ValueError("a blosc chunk is at least 16 bytes")
  version, versionlz, flags, typesize, nbytes, blocksize, cbytes = (
      struct.unpack_from("<BBBBiii", raw))
  return {"version": version, "versionlz": versionlz, "flags": flags,
          "typesize": typesize, "nbytes": nbytes, "blocksize": blocksize,
          "cbytes": cbytes}


def encode(data: np.ndarray, cname: str, clevel: int, shuffle: int,
           blocksize: int, where: str) -> np.ndarray:
  """``data`` as one blosc1 chunk with codec ``cname`` ("lz4" or "zstd")
  at ``clevel``, its typesize the dtype's itemsize, as a uint8 array;
  ``ENCODE_THREADS`` threads encode its blocks.  A failure raises a
  ValueError naming ``where``."""
  data = np.ascontiguousarray(data)
  lib = library(where)
  cap = data.nbytes + _HEADER_BYTES
  dst = np.empty(cap, np.uint8)
  n = _I64()
  _check(lib, lib.wb2_blosc_encode(
      ENCODERS[cname], clevel, data.dtype.itemsize, shuffle, blocksize,
      ENCODE_THREADS, data.ctypes.data, data.nbytes, dst.ctypes.data, cap,
      ctypes.byref(n)), where)
  return dst[:n.value]
