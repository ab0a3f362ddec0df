"""The port's plain-numpy Zarr and NetCDF IO against the JAX package's.

Stores written by the port open in ``weatherbench2_tpu.xds.open_zarr``
(tensorstore), uncompressed JAX-written stores open in the port, with the
same arrays, coords and CF time values; results files written by the port
open in ``weatherbench2_tpu.xds.open_netcdf``; a blosc store is refused.
"""
import os

import numpy as np
import pytest

from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import utils as jutils
from weatherbench2_tpu import xds as jxds
from weatherbench2_torch import convert
from weatherbench2_torch import xds


def _sample():
  """Floats of two widths, ints, datetimes, timedeltas and strings."""
  rs = np.random.RandomState(0)
  time = np.arange(np.datetime64("2020-01-01T00", "ns"),
                   np.datetime64("2020-01-04T00", "ns"),
                   np.timedelta64(6, "h"))
  lead = np.arange(0, 5) * np.timedelta64(12, "h").astype("m8[ns]")
  return convert.dataset_from_arrays(
      {
          "z": (("time", "lead_time", "longitude", "latitude"),
                rs.randn(12, 5, 8, 5).astype(np.float32)),
          "t2m": (("time", "longitude", "latitude"), rs.randn(12, 8, 5)),
          "count": (("time",), np.arange(12, dtype=np.int64)),
          "stamp": (("time",), time + np.timedelta64(1, "h")),
      },
      coords={
          "time": time,
          "lead_time": lead,
          "latitude": np.linspace(-90, 90, 5),
          "longitude": np.linspace(0, 315, 8),
          "valid_time": (("time", "lead_time"),
                         time[:, None] + lead[None, :]),
          "region": np.asarray(["global", "tropics", "x"], dtype=object),
      },
      attrs={"title": "sample"},
  )


def _assert_same(port_ds, jax_ds):
  assert sorted(port_ds.keys()) == sorted(jax_ds.keys())
  assert sorted(port_ds.coords_dict()) == sorted(jax_ds.coords_dict())
  for name in list(port_ds.keys()) + list(port_ds.coords_dict()):
    p, j = port_ds[name], jax_ds[name]
    assert p.dims == j.dims, name
    pv, jv = np.asarray(p.values), np.asarray(j.values)
    # NetCDF3 stores int64 as int32
    assert pv.dtype.kind == jv.dtype.kind and (
        pv.dtype.kind == "i" or pv.dtype.itemsize == jv.dtype.itemsize), (
            name, pv.dtype, jv.dtype)
    np.testing.assert_array_equal(pv, jv, err_msg=name)


@pytest.mark.parametrize("chunks, compressor", [
    (None, None),
    ({"time": 5, "longitude": 3}, None),  # ragged edge chunks
    ({"time": 4}, "zlib"),
])
def test_port_store_opens_in_jax(tmp_path, chunks, compressor):
  ds = _sample()
  path = str(tmp_path / "port.zarr")
  xds.to_zarr(ds, path, chunks=chunks, compressor=compressor)
  _assert_same(ds, jxds.open_zarr(path))
  _assert_same(ds, xds.open_zarr(path))


@pytest.mark.parametrize("lazy", [False, True])
def test_jax_store_opens_in_port(tmp_path, monkeypatch, lazy):
  monkeypatch.setenv("WB2_ZARR_COMPRESSOR", "none")
  truth = jutils.random_like(jschema.mock_truth_data(
      variables_3d=["geopotential"], variables_2d=["2m_temperature"],
      time_start="2020-01-01", time_stop="2020-01-09",
      spatial_resolution_in_degrees=30.0, time_resolution="12 hours"),
      seed=5)
  path = str(tmp_path / "jax.zarr")
  jxds.to_zarr(truth, path, chunks={"time": 3})
  port = xds.open_zarr(path, lazy=lazy)
  _assert_same(port, jxds.open_zarr(path))


def test_lazy_views_read_like_numpy(tmp_path):
  ds = _sample()
  path = str(tmp_path / "lazy.zarr")
  xds.to_zarr(ds, path, chunks={"time": 5, "lead_time": 2, "longitude": 3})
  lazy = xds.open_zarr(path, lazy=True)["z"].data
  eager = np.asarray(ds["z"].values)
  keys = [
      (slice(2, 9), 1),
      (slice(None, None, -1), slice(1, 4), slice(None, None, -2)),
      (np.array([7, 0, 3, 3]), slice(None), 2),
      (slice(1, 11, 3), np.array([4, 1])),
      (5, 0, slice(2, 8), slice(None)),
  ]
  for key in keys:
    got = lazy[key]
    np.testing.assert_array_equal(np.asarray(got), eager[key], err_msg=key)
  # a view of a view composes
  np.testing.assert_array_equal(
      np.asarray(lazy[2:10][::-1][1:5, 3]), eager[2:10][::-1][1:5, 3])


def test_region_writer_template_fills_nan(tmp_path):
  ds = _sample()
  template = xds.Dataset(
      {"z": xds.stub_variable(ds["z"].dims, ds["z"].sizes, np.float32)},
      coords=dict(ds.coords_dict()))
  path = str(tmp_path / "tmpl.zarr")
  writer = xds.RegionWriter(path, template, chunks={"time": 4})
  block = np.asarray(ds["z"].values)[2:6]
  writer.write_array("z", (slice(2, 6),), block)  # crosses a chunk edge
  writer.finish()
  for opened in (xds.open_zarr(path), jxds.open_zarr(path)):
    got = np.asarray(opened["z"].values)
    np.testing.assert_array_equal(got[2:6], block)
    assert np.isnan(got[:2]).all() and np.isnan(got[6:]).all()


def test_blosc_store_is_refused(tmp_path, monkeypatch):
  monkeypatch.setenv("WB2_ZARR_COMPRESSOR", "zstd3")
  path = str(tmp_path / "blosc.zarr")
  jxds.to_zarr(jschema.mock_truth_data(
      variables_3d=[], variables_2d=["2m_temperature"],
      time_start="2020-01-01", time_stop="2020-01-03",
      spatial_resolution_in_degrees=30.0), path)
  with pytest.raises(ValueError, match="blosc") as err:
    xds.open_zarr(path)
  assert path in str(err.value)


def test_missing_store_raises(tmp_path):
  with pytest.raises(FileNotFoundError):
    xds.open_zarr(str(tmp_path / "absent.zarr"))


def test_results_netcdf_opens_in_jax(tmp_path):
  rs = np.random.RandomState(3)
  lead = np.arange(4) * np.timedelta64(1, "D").astype("m8[ns]")
  results = convert.dataset_from_arrays(
      {
          "geopotential": (("metric", "region", "lead_time", "level"),
                           rs.randn(2, 3, 4, 2)),
          "2m_temperature": (("metric", "region", "lead_time"),
                             rs.randn(2, 3, 4)),
      },
      coords={
          "metric": np.asarray(["mse", "acc"], dtype=object),
          "region": np.asarray(["global", "tropics", "extra-tropics"],
                               dtype=object),
          "lead_time": lead,
          "level": np.asarray([500, 850]),
      },
  )
  results["geopotential"].values[0, 1, 2, 0] = np.nan
  path = str(tmp_path / "results.nc")
  xds.to_netcdf(results, path)
  _assert_same(results, jxds.open_netcdf(path))
  _assert_same(results, xds.open_netcdf(path))
  assert os.path.getsize(path) > 0
