"""Build and load the port's CUDA kernels (nvcc + ctypes).

``csrc/reductions.cu`` has a plain C interface, so it compiles with nvcc
alone in seconds (no PyTorch headers) into
``build/weatherbench2_torch/libwb2kernels.so`` beside the package, at first
use.  The library is rebuilt when the source's hash changes.  Nothing here
runs at import time: machines without nvcc import the package freely and
only a launch on a CUDA tensor needs the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "reductions.cu"
BUILD_DIR = _PKG.parent / "build" / "weatherbench2_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "wb2_fused_deterministic_sums": [_P, _P, _P, _P, ctypes.c_int, _I64,
                                     ctypes.c_int, ctypes.c_int, _I64, _P,
                                     _P, _P],
    "wb2_fused_region_sums": [_P, _P, ctypes.c_int, _I64, ctypes.c_int,
                              ctypes.c_int, _I64, _P, _P, _P],
}


def _nvcc() -> str:
  nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
  if not os.path.exists(nvcc):
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built on the machine "
        "with the card (CUDA toolkit under /usr/local/cuda)"
    )
  return nvcc


def build(verbose: bool = False) -> Path:
  """Compile the kernel library if its source hash changed; its path."""
  src = SOURCE.read_bytes()
  digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
  lib_path = BUILD_DIR / "libwb2kernels.so"
  stamp = BUILD_DIR / "libwb2kernels.sha256"
  if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
    return lib_path
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
  cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
         "-o", str(tmp), str(SOURCE)]
  proc = subprocess.run(cmd, capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(
        f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
  if verbose:
    print(proc.stderr, flush=True)
  os.replace(tmp, lib_path)
  stamp.write_text(digest)
  return lib_path


def library():
  """The loaded kernel library (built on first use)."""
  global _lib
  with _lock:
    if _lib is None:
      lib = ctypes.CDLL(str(build()))
      for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
      lib.wb2_error_string.argtypes = [ctypes.c_int]
      lib.wb2_error_string.restype = ctypes.c_char_p
      _lib = lib
  return _lib


def check(err: int, what: str) -> None:
  """Raise if a C entry point returned a CUDA error."""
  if err:
    msg = library().wb2_error_string(err).decode()
    raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
