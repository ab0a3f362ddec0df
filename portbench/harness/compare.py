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

A reference entry for a variable is ``(dims, labels, values)``: each value
is the one number the program has to give.  Where the program's result is
defined only up to a random draw (rank histograms break ties at random),
the entry is ``(dims, labels, Bounds(...))`` instead, and each block (one
metric, and level) is held to what the draw allows:

* per-value bounds ``low <= high``, with one NaN/inf pattern in both: the
  program's pattern is held to ``low``'s as above, and a finite value's gap
  is ``max(low - got, got - high, 0)`` over the largest finite ``|low|``,
  ``|high|`` of the values compared in its block; it feeds ``worst_gap``
  as above.  Where ``low == high`` the tally (``worst_gap``, ``where``,
  ``mismatched``, ``compared``, ``notes``) is the exact form's, bit for
  bit;
* optional ``Sums``: the program's values summed along one named axis,
  held as exact values under the rule above (a rank histogram's bins sum
  to 1 in every cell: a point counted in two bins, or in none, fails);
* optional ``Statistic``: weights along one named axis (a histogram's bin
  index), and the expected mean over the block of the weighted sum with
  its standard deviation under the draw, both from the reference.  The
  block's values count in ``mismatched`` where the program's mean lies
  more than ``SIGMAS`` standard deviations (plus float32 rounding,
  ``ROUNDING`` of the weighted sum's scale) from the expected mean: a draw
  that breaks every tie the same way fails, an honest one with a
  probability under 1e-8 a block.  The mean is over the cells where the
  reference is finite along the whole axis.

Each failed check leaves a note that names it.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
from scipy.io import netcdf_file

from harness import zarrv2

LABELED = ("metric", "region", "quantile")
BLOCK_AXES = ("metric", "level")  # a block is one metric (and level)
SIGMAS = 6.0
ROUNDING = 1e-6


@dataclasses.dataclass
class Sums:
  """The program's values summed along ``axis`` are ``values`` (the
  values' shape without that axis), held as exact values."""

  axis: str
  values: np.ndarray


@dataclasses.dataclass
class Statistic:
  """Over each block, the mean over its cells of the values weighted by
  ``weights`` along ``axis`` and summed along it: ``mean`` expected, with
  the standard deviation ``std`` under the random draw; both indexed like
  the blocks (``[metric]``, or ``[metric, level]``)."""

  axis: str
  weights: np.ndarray
  mean: np.ndarray
  std: np.ndarray


@dataclasses.dataclass
class Bounds:
  """Expected values known within ``low <= high`` (one NaN/inf pattern in
  both), with optional checks of their sums and of a block statistic."""

  low: np.ndarray
  high: np.ndarray
  sums: Sums | None = None
  statistic: Statistic | None = None

  def __post_init__(self):
    self.low = np.asarray(self.low, np.float64)
    self.high = np.asarray(self.high, np.float64)
    if self.low.shape != self.high.shape:
      raise ValueError(f"bounds of shapes {self.low.shape} and "
                       f"{self.high.shape}")
    for test in (np.isnan, np.isposinf, np.isneginf):
      if not np.array_equal(test(self.low), test(self.high)):
        raise ValueError("low and high differ in their NaN/inf pattern")
    if (self.low > self.high).any():
      raise ValueError("a low bound above its high bound")

  @property
  def shape(self):
    return self.low.shape

  @property
  def size(self):
    return self.low.size


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


def _compare_block(got, want, tally: Tally, where: str, high=None) -> None:
  """One metric's (and level's) values; ``want`` is the low bound where
  ``high`` is given."""
  bad = (np.isnan(got) != np.isnan(want)) | (
      np.isposinf(got) != np.isposinf(want)) | (
          np.isneginf(got) != np.isneginf(want))
  if bad.any():
    tally.miss(bad.sum(), f"{where} NaN/inf pattern")
  both = np.isfinite(got) & np.isfinite(want)
  if not both.any():
    return
  low, high = want[both], (want if high is None else high)[both]
  scale = max(np.abs(low).max(), np.abs(high).max())
  got = got[both]
  gap = np.maximum(np.maximum(low - got, got - high), 0.0).max() / (
      scale if scale > 0 else 1.0)
  tally.compared += int(both.sum())
  if gap > tally.worst_gap:
    tally.worst_gap = float(gap)
    tally.where = where


def _check_statistic(got, low, high, axis: int, weights, mean: float,
                     std: float, tally: Tally, where: str) -> None:
  """The block's mean weighted sum along ``axis`` against its expectation
  under the draw."""
  cells = np.isfinite(low).all(axis=axis)
  if not cells.any():
    return
  got = np.moveaxis(got, axis, -1)[cells]
  if not np.isfinite(got).all():
    return  # already counted by the NaN/inf pattern
  weights = np.asarray(weights, np.float64)
  bound = np.maximum(np.abs(low), np.abs(high))
  scale = (np.moveaxis(bound, axis, -1)[cells] @ np.abs(weights)).mean()
  program = float((got @ weights).mean())
  if abs(program - mean) > SIGMAS * std + ROUNDING * scale:
    tally.miss(low.size, f"{where} statistic: mean {program!r}, expected "
               f"{mean!r} with sd {std!r}")


def _compare_bounded(values, dims, want: Bounds, k: int, l, tally: Tally,
                     where: str) -> None:
  """Block ``k`` (metric) and ``l`` (level, or None) of a bounded entry."""

  def take(array, array_dims):
    block = array[k]
    if l is not None:
      block = np.take(block, l, axis=array_dims.index("level") - 1)
    return block

  got, low, high = (take(a, dims) for a in (values, want.low, want.high))
  _compare_block(got, low, tally, where, high)
  block_dims = [d for d in dims if d not in BLOCK_AXES]
  if want.sums is not None:
    axis = want.sums.axis
    expected = take(np.asarray(want.sums.values, np.float64),
                    [d for d in dims if d != axis])
    _compare_block(got.sum(axis=block_dims.index(axis)), expected, tally,
                   f"{where} sums over {axis}")
  stat = want.statistic
  if stat is not None:
    index = k if l is None else (k, l)
    _check_statistic(got, low, high, block_dims.index(stat.axis),
                     stat.weights, float(np.asarray(stat.mean)[index]),
                     float(np.asarray(stat.std)[index]), tally, where)


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
    if not isinstance(expected, Bounds):
      expected = Bounds(expected, expected)
    levels = ([None] if "level" not in dims
              else range(values.shape[dims.index("level")]))
    for k, metric in enumerate(labels["metric"]):
      for l in levels:
        _compare_bounded(values, dims, expected, k, l, tally,
                         f"{where}/{metric}" + (
                             "" if l is None else f"/level{l}"))


def compare(outputs: dict, expected: dict) -> Tally:
  """Hold every results file in ``outputs`` ({config: path}) to the
  reference's ``expected`` ({config: {variable: (dims, labels, values)}},
  where ``values`` may be ``Bounds``)."""
  tally = Tally()
  for config, want in expected.items():
    path = outputs.get(config)
    if path is None or not os.path.exists(path):
      tally.miss(sum(v[2].size for v in want.values()), f"{config} missing")
      continue
    arrays, labels = read_results(path)
    compare_config(arrays, labels, want, tally, config)
  return tally
