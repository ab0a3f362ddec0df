"""The port's regridding held to the JAX package's.

Geometry is the JAX package's numpy, copied: the weight matrices, the
interpolation plans and the nearest-neighbour map must be equal bit for bit
(through ``convert.regridder_from_reference``).  Applying them:

  * on numpy the port runs the JAX package's numpy code: equal bit for bit;
  * on CPU tensors (float32 matmuls and gathers, as on the card) against
    the JAX package on jax arrays (float32, ``precision="highest"``):
    ``rtol=1e-5`` plus ``atol=1e-5·max|reference|`` (float32 sums in
    another order), NaN in the same places.

Cases mirror ``tests/test_regridding.py``: poles and none, a no-pole source
(NaN outside it), CENTER_AT_ZERO longitudes, an all-NaN source cell, a
decreasing latitude, and a dataset whose variables keep their dim order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherbench2_tpu import regridding as jregridding
from weatherbench2_tpu import xds as jxds
from weatherbench2_torch import convert, regridding, xds

RTOL = 1e-5
METHODS = ("nearest", "bilinear", "conservative")
CLASSES = {"nearest": "NearestRegridder", "bilinear": "BilinearRegridder",
           "conservative": "ConservativeRegridder"}


def make_grid(mod, n_lon, n_lat, with_poles=True, center=False):
  return mod.Grid(
      longitudes=mod.longitude_values(
          mod.LongitudeScheme.CENTER_AT_ZERO if center
          else mod.LongitudeScheme.START_AT_ZERO, n_lon),
      latitudes=mod.latitude_values(
          mod.LatitudeSpacing.EQUIANGULAR_WITH_POLES if with_poles
          else mod.LatitudeSpacing.EQUIANGULAR_WITHOUT_POLES, n_lat),
      periodic=True, includes_poles=with_poles)


GRIDS = {
    "poles": ((64, 33, True, False), (24, 13, True, False)),
    "no_pole_source": ((64, 32, False, False), (24, 13, True, False)),
    "center_at_zero": ((64, 33, True, True), (32, 17, False, False)),
}


def _pair(case, method):
  src, tgt = GRIDS[case]
  ref = getattr(jregridding, CLASSES[method])(make_grid(jregridding, *src),
                                              make_grid(jregridding, *tgt))
  return ref, convert.regridder_from_reference(ref)


def assert_close(got, want, what):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
  fin = ~np.isnan(want)
  np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                             atol=RTOL * np.abs(want[fin]).max(),
                             err_msg=what)


@pytest.mark.parametrize("case", list(GRIDS))
def test_geometry_is_the_jax_packages_bit_for_bit(case):
  cons_ref, cons = _pair(case, "conservative")
  assert cons.source == convert.grid_from_reference(cons_ref.source)
  for attr in ("_lat_weights", "_lon_weights"):
    np.testing.assert_array_equal(getattr(cons, attr),
                                  getattr(cons_ref, attr), err_msg=attr)
  near_ref, near = _pair(case, "nearest")
  np.testing.assert_array_equal(near.indices, near_ref.indices)
  bil_ref, bil = _pair(case, "bilinear")
  for attr in ("_lat_plan", "_lon_plan"):
    for got, want in zip(getattr(bil, attr), getattr(bil_ref, attr)):
      np.testing.assert_array_equal(got, want, err_msg=attr)
  src, tgt = GRIDS[case]
  for mod_fn in ("latitude_values", "longitude_values"):
    for spacing in ("EQUIANGULAR_WITH_POLES", "EQUIANGULAR_WITHOUT_POLES"):
      if mod_fn == "longitude_values":
        spacing = spacing.replace("EQUIANGULAR_WITH_POLES", "START_AT_ZERO")
        spacing = spacing.replace("EQUIANGULAR_WITHOUT_POLES",
                                  "CENTER_AT_ZERO")
        enum_name = "LongitudeScheme"
      else:
        enum_name = "LatitudeSpacing"
      np.testing.assert_array_equal(
          getattr(regridding, mod_fn)(
              getattr(regridding, enum_name)[spacing], tgt[1]),
          getattr(jregridding, mod_fn)(
              getattr(jregridding, enum_name)[spacing], tgt[1]))


def _field(case, seed=0):
  src, _ = GRIDS[case]
  rs = np.random.RandomState(seed)
  field = (280 + 10 * rs.randn(3, src[0], src[1])).astype(np.float32)
  field[0, 5, 7] = np.nan
  field[1, :, :] = np.where(rs.rand(src[0], src[1]) < 0.1, np.nan, field[1])
  field[2, :8, :6] = np.nan  # a block bigger than a target cell: all NaN
  return field


@pytest.mark.parametrize("case", list(GRIDS))
@pytest.mark.parametrize("method", METHODS)
def test_regrid_array_on_numpy_and_tensors(case, method):
  ref, port = _pair(case, method)
  field = _field(case)
  want64 = ref.regrid_array(field)
  got64 = port.regrid_array(field)
  assert got64.dtype == want64.dtype
  np.testing.assert_array_equal(got64, want64)
  want32 = np.asarray(ref.regrid_array(jnp.asarray(field)))
  got32 = port.regrid_array(torch.as_tensor(field))
  assert got32.dtype == torch.float32 and got32.shape == want32.shape
  assert_close(got32.numpy(), want32, f"{case}/{method}")
  if method == "conservative":
    # the all-NaN block leaves a target cell with no valid data: NaN
    assert np.isnan(got32[2].numpy()).any()
  if case == "no_pole_source" and method == "bilinear":
    # no source data beyond the outermost latitudes: NaN at the poles
    assert np.isnan(got32[0, :, [0, -1]].numpy()).all()


def _dataset(mod, decreasing):
  rs = np.random.RandomState(3)
  lat = np.linspace(-90, 90, 33)
  lon = np.arange(64) * 360 / 64
  data = rs.randn(2, 33, 64).astype(np.float32)  # (time, lat, lon)
  if decreasing:
    lat, data = lat[::-1], data[:, ::-1]
  return mod.Dataset(
      {"t": mod.Variable(("time", "latitude", "longitude"),
                         np.ascontiguousarray(data)),
       "static": mod.Variable(("time",), np.arange(2.0))},
      coords={"time": np.arange(2), "latitude": lat, "longitude": lon})


@pytest.mark.parametrize("decreasing", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_regrid_dataset_matches(method, decreasing):
  ref, port = _pair("poles", method)
  want = ref.regrid_dataset(_dataset(jxds, decreasing))
  got = port.regrid_dataset(_dataset(xds, decreasing))
  assert got["t"].dims == want["t"].dims == ("time", "latitude", "longitude")
  np.testing.assert_array_equal(got["t"].values, want["t"].values)
  np.testing.assert_array_equal(got["static"].values, want["static"].values)
  for c in ("latitude", "longitude"):
    np.testing.assert_array_equal(got.coords_dict()[c].data,
                                  want.coords_dict()[c].data)
  on_tensors = port.regrid_dataset(xds.to_device(_dataset(xds, decreasing),
                                                 torch.device("cpu")))
  assert torch.is_tensor(on_tensors["t"].data)
  assert_close(on_tensors["t"].data.numpy(), want["t"].values, method)


def test_conservative_keeps_the_area_weighted_mean():
  _, port = _pair("poles", "conservative")
  field = torch.as_tensor(_field("poles")[:1])
  field = torch.nan_to_num(field, nan=280.0)
  out = port.regrid_array(field)

  def mean(x, grid):
    w = np.cos(np.deg2rad(grid.latitudes))
    w = torch.as_tensor(w / w.sum(), dtype=torch.float64)
    return float((x.double().mean(-2) * w).sum())

  # cos-weighted point means of two grids agree to the grid's resolution
  assert abs(mean(out, port.target) - mean(field, port.source)) < 0.1
