"""Reads the results files a job wrote and holds them to the reference.

NetCDF files are read with ``scipy.io.netcdf_file`` and Zarr stores with
the benchmark's own reader: the program's readers are not used.  Two
numbers come out:

* ``worst_gap``: over every finite value compared, |program - reference|
  over the largest |reference| of its metric (and level), the widest;
* ``mismatched``: values whose NaN or infinity differs from the
  reference's, plus every expected value that is missing (an array, a
  label of the metric, region or quantile axes, or a shape that differs),
  every value of an array the reference has not that is not NaN, and every
  value under a label that the reference has not or that is written twice.
"""
from __future__ import annotations

import os

import numpy as np
from scipy.io import netcdf_file

from harness import zarrv2

LABELED = ("metric", "region", "quantile")


def _strings(chars) -> list:
  return [b"".join(row).rstrip(b"\x00").decode() for row in np.asarray(chars)]


def read_netcdf(path: str):
  """({name: (dims, float64 values)}, {axis: labels}) of a results file."""
  arrays, labels = {}, {}
  with netcdf_file(path, "r", mmap=False) as f:
    for name, v in f.variables.items():
      dims = tuple(v.dimensions)
      if name in LABELED:
        labels[name] = (_strings(v.data) if v.data.dtype.kind == "S"
                        else np.asarray(v.data, np.float64).tolist())
      elif name not in dims:
        arrays[name] = (dims, np.asarray(v.data, np.float64))
  return arrays, labels


def read_zarr(path: str):
  arrays, labels = {}, {}
  for name, (values, dims, _) in zarrv2.read_group(path).items():
    if name in LABELED:
      labels[name] = [str(x) if values.dtype == object else float(x)
                      for x in values]
    elif name not in dims:
      arrays[name] = (dims, np.asarray(values, np.float64))
  return arrays, labels


def read_results(path: str):
  return read_zarr(path) if os.path.isdir(path) else read_netcdf(path)


class Tally:
  """The comparison's numbers, and where the widest gap was."""

  def __init__(self):
    self.worst_gap = 0.0
    self.where = ""
    self.mismatched = 0
    self.compared = 0
    self.notes: list = []

  def miss(self, n: int, what: str) -> None:
    self.mismatched += int(n)
    if len(self.notes) < 8:
      self.notes.append(f"{what}: {int(n)}")


def _compare_block(got, want, tally: Tally, where: str) -> None:
  """One metric's (and level's) values."""
  bad = (np.isnan(got) != np.isnan(want)) | (
      np.isposinf(got) != np.isposinf(want)) | (
          np.isneginf(got) != np.isneginf(want))
  if bad.any():
    tally.miss(bad.sum(), f"{where} NaN/inf pattern")
  both = np.isfinite(got) & np.isfinite(want)
  if not both.any():
    return
  scale = np.abs(want[both]).max()
  gap = np.abs(got[both] - want[both]).max() / (scale if scale > 0 else 1.0)
  tally.compared += int(both.sum())
  if gap > tally.worst_gap:
    tally.worst_gap = float(gap)
    tally.where = where


def compare_config(got_arrays, got_labels, want: dict, tally: Tally,
                   config: str) -> None:
  for name in sorted(set(want) | set(got_arrays)):
    where = f"{config}/{name}"
    if name not in got_arrays:
      tally.miss(want[name][2].size, f"{where} missing")
      continue
    dims, values = got_arrays[name]
    if name not in want:
      extra = ~np.isnan(values)
      if extra.any():
        tally.miss(extra.sum(), f"{where} not expected")
      continue
    want_dims, labels, expected = want[name]
    if dims != want_dims:
      tally.miss(expected.size, f"{where} dims {dims} != {want_dims}")
      continue
    try:
      for axis, wanted in labels.items():
        have = list(got_labels[axis])
        # a label the reference has not, or one written twice, is a value
        # the program should not have written: each of its values counts
        extra = [i for i, x in enumerate(have)
                 if x not in wanted or have.index(x) != i]
        if extra:
          tally.miss(np.take(values, extra, axis=dims.index(axis)).size,
                     f"{where} {axis} labels not expected or repeated "
                     f"{[have[i] for i in extra][:4]}")
        pos = [have.index(x) for x in wanted]
        values = np.take(values, pos, axis=dims.index(axis))
    except (KeyError, ValueError) as err:
      tally.miss(expected.size, f"{where} labels ({err})")
      continue
    if values.shape != expected.shape:
      tally.miss(expected.size,
                 f"{where} shape {values.shape} != {expected.shape}")
      continue
    level_axis = dims.index("level") if "level" in dims else None
    for k, metric in enumerate(labels["metric"]):
      got_m, want_m = values[k], expected[k]
      if level_axis is None:
        _compare_block(got_m, want_m, tally, f"{where}/{metric}")
        continue
      for l in range(values.shape[level_axis]):
        _compare_block(np.take(got_m, l, axis=level_axis - 1),
                       np.take(want_m, l, axis=level_axis - 1), tally,
                       f"{where}/{metric}/level{l}")


def compare(outputs: dict, expected: dict) -> Tally:
  """Hold every results file in ``outputs`` ({config: path}) to the
  reference's ``expected`` ({config: {variable: (dims, labels, values)}})."""
  tally = Tally()
  for config, want in expected.items():
    path = outputs.get(config)
    if path is None or not os.path.exists(path):
      tally.miss(sum(v[2].size for v in want.values()), f"{config} missing")
      continue
    arrays, labels = read_results(path)
    compare_config(arrays, labels, want, tally, config)
  return tally
