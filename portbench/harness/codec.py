"""The benchmark's own blosc codec: a frozen copy of the port's C++ codec.

``portbench/codec/codecs.cpp`` is a copy of the port's
``weatherbench2_torch/csrc/codecs.cpp`` taken when the benchmark was
written, so a later change to the port's encoder cannot change the bytes a
cell reads.  It is built with the host's C++ compiler into the fixed
directory ``portbench/build/`` inside the checkout (rebuilt only when the
source or the flags change) and bound with ctypes.  The harness encodes the
cells' stores with it and decodes the results stores the program writes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "codec" / "codecs.cpp"
BUILD_DIR = ROOT / "build"
LIBRARY = BUILD_DIR / "libportbench_codecs.so"
STAMP = BUILD_DIR / "libportbench_codecs.sha256"
# -Bsymbolic: the port loads its own copy of these symbols in the same
# process; each library binds to its own functions
CXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-pthread",
             "-Wl,-Bsymbolic"]
HEADER_BYTES = 16
# the frozen library's codec ids (``enum Codec`` in ``codecs.cpp``)
CODECS = {"lz4": 1, "zstd": 4}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "wb2_blosc_decode": [ctypes.c_char_p, _I64, _P, _I64],
    "wb2_blosc_encode": [_INT, _INT, _INT, _INT, _I64, _INT, _P, _I64, _P,
                         _I64, ctypes.POINTER(_I64)],
}
_lib = None


def build() -> Path:
  """Compile the library unless the stamp matches the source and flags."""
  digest = hashlib.sha256(
      SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
  if LIBRARY.exists() and STAMP.exists() and STAMP.read_text() == digest:
    return LIBRARY
  cxx = next((p for p in (os.environ.get("CXX"), "c++", "g++")
              if p and shutil.which(p)), None)
  if cxx is None:
    raise RuntimeError(f"no C++ compiler ($CXX, c++, g++) to build {SOURCE}")
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = LIBRARY.with_suffix(".so.tmp")
  cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  if proc.returncode:
    raise RuntimeError(f"codec build failed: {' '.join(cmd)}\n{proc.stderr}")
  os.replace(tmp, LIBRARY)
  STAMP.write_text(digest)
  return LIBRARY


def library():
  """The loaded library, built at the first call."""
  global _lib
  if _lib is None:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
      getattr(lib, name).argtypes = argtypes
      getattr(lib, name).restype = ctypes.c_int
    lib.wb2_codec_error_string.argtypes = [ctypes.c_int]
    lib.wb2_codec_error_string.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def _check(lib, err: int, where: str) -> None:
  if err:
    raise ValueError(f"{where}: {lib.wb2_codec_error_string(err).decode()}")


def encode(data: np.ndarray, cname: str, clevel: int, shuffle: int,
           threads: int, where: str = "encode") -> bytes:
  """``data`` as one blosc1 chunk (c-blosc's default blocksize)."""
  data = np.ascontiguousarray(data)
  lib = library()
  cap = data.nbytes + HEADER_BYTES
  dst = np.empty(cap, np.uint8)
  n = _I64()
  _check(lib, lib.wb2_blosc_encode(
      CODECS[cname], clevel, data.dtype.itemsize, shuffle, 0, threads,
      data.ctypes.data, data.nbytes, dst.ctypes.data, cap, ctypes.byref(n)),
         where)
  return dst[:n.value].tobytes()


def decode_into(raw: bytes, out: np.ndarray, where: str = "decode") -> None:
  """Decode the blosc1 chunk ``raw`` into the C-contiguous ``out``."""
  if not out.flags.c_contiguous:
    raise ValueError(f"{where}: target is not C-contiguous")
  lib = library()
  _check(lib, lib.wb2_blosc_decode(raw, len(raw), out.ctypes.data,
                                   out.nbytes), where)
