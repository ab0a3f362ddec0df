"""The labeled operations, stream helpers and flags that the port's
data-prep CLIs added, each against the JAX package's, on the CPU: on numpy
payloads and on CPU tensors (the card's code path), equal to the JAX
package's results (min, max and clip exactly; NaNs in the same places).
"""
import numpy as np
import pytest
import torch

from weatherbench2_tpu import flag_utils as jflag_utils
from weatherbench2_tpu import xds as jxds
from weatherbench2_tpu.xds import stream as jstream
from weatherbench2_torch import flag_utils
from weatherbench2_torch import xds
from weatherbench2_torch.xds import io_zarr


def _pair(seed=0):
  """The same (time, level, longitude) Dataset in both packages."""
  rs = np.random.RandomState(seed)
  x = rs.randn(4, 3, 5).astype(np.float32)
  x[1, 2, :] = np.nan  # a whole pencil
  x[0, 0, 3] = np.nan
  y = rs.randn(4).astype(np.float32)
  coords = {"time": np.arange(4) * 10, "level": np.array([850, 500, 700]),
            "longitude": np.arange(5) * 72.0}
  dims = ("time", "level", "longitude")
  j = jxds.Dataset({"x": (dims, x), "y": (("time",), y)}, coords=coords)
  t = xds.Dataset({"x": (dims, x), "y": (("time",), y)}, coords=coords)
  return j, t


def _values(obj):
  data = obj.data
  return data.numpy() if torch.is_tensor(data) else np.asarray(data)


def _on_tensors(ds):
  return ds.copy(data={k: torch.as_tensor(np.asarray(v.data))
                       for k, v in ds.variables_dict().items()})


@pytest.mark.parametrize("op,dim,skipna", [
    ("min", "time", False), ("min", ["time", "longitude"], True),
    ("max", "level", True), ("max", None, False), ("min", None, True)])
@pytest.mark.parametrize("on_tensors", [False, True])
def test_min_and_max_match_the_jax_package(op, dim, skipna, on_tensors):
  j, t = _pair()
  if on_tensors:
    t = _on_tensors(t)
  want = getattr(j["x"], op)(dim, skipna=skipna)
  got = getattr(t["x"], op)(dim, skipna=skipna)
  assert got.dims == want.dims
  np.testing.assert_array_equal(_values(got), np.asarray(want.values))
  want_ds = getattr(j, op)(dim, skipna=skipna)
  got_ds = getattr(t, op)(dim, skipna=skipna)
  for k in want_ds.keys():
    np.testing.assert_array_equal(_values(got_ds[k]),
                                  np.asarray(want_ds[k].values))


@pytest.mark.parametrize("on_tensors", [False, True])
def test_clip_roll_pad_wrap_and_sortby_match_the_jax_package(on_tensors):
  j, t = _pair(1)
  if on_tensors:
    t = _on_tensors(t)
  cases = [
      (lambda ds: ds["x"].clip(-0.5, 0.5)),
      (lambda ds: ds["x"].clip(min=0.0)),
      (lambda ds: ds.clip(max=0.25)["x"]),
      (lambda ds: ds["x"].roll(longitude=2, time=-1)),
      (lambda ds: ds["x"].pad_wrap({"longitude": 2})),
      (lambda ds: ds["x"].sortby("level")),
  ]
  for i, case in enumerate(cases):
    want, got = case(j), case(t)
    assert got.dims == want.dims, i
    np.testing.assert_array_equal(_values(got), np.asarray(want.values),
                                  err_msg=str(i))
    assert sorted(got.coords) == sorted(want.coords), i
  np.testing.assert_array_equal(
      t["x"].sortby("level").coords["level"].data, [500, 700, 850])


def test_squeeze_matches_the_jax_package():
  j, t = _pair(2)
  j1, t1 = j.isel(time=slice(1, 2)), t.isel(time=slice(1, 2))
  assert t1.squeeze().sizes == j1.squeeze().sizes
  assert t1["x"].squeeze("time").dims == j1["x"].squeeze("time").dims
  np.testing.assert_array_equal(t1["x"].squeeze().values,
                                j1["x"].squeeze().values)
  with pytest.raises(ValueError, match="cannot squeeze"):
    t.squeeze("level")


@pytest.mark.parametrize("op,indexers", [
    ("drop_sel", {"level": [500]}), ("drop_sel", {"time": [0, 30]}),
    ("drop_isel", {"longitude": [0, -1]}), ("drop_isel", {"level": 1})])
def test_drop_sel_and_drop_isel_match_the_jax_package(op, indexers):
  j, t = _pair(3)
  want, got = getattr(j, op)(indexers), getattr(t, op)(indexers)
  assert got.sizes == want.sizes
  for k in want.keys():
    np.testing.assert_array_equal(got[k].values, want[k].values)
  for c in want.coords_dict():
    np.testing.assert_array_equal(got.coords_dict()[c].data,
                                  want.coords_dict()[c].data)


@pytest.mark.parametrize("on_tensors", [False, True])
def test_ones_like_and_full_like_match_the_jax_package(on_tensors):
  j, t = _pair(4)
  if on_tensors:
    t = _on_tensors(t)
  for fn, args in (("ones_like", ()), ("full_like", (2.5,)),
                   ("zeros_like", ())):
    want = getattr(jxds, fn)(j, *args)
    got = getattr(xds, fn)(t, *args)
    for k in want.keys():
      assert _values(got[k]).dtype == np.asarray(want[k].values).dtype
      np.testing.assert_array_equal(_values(got[k]), want[k].values)


def test_orthogonal_select_reads_only_its_positions(tmp_path):
  rs = np.random.RandomState(5)
  x = rs.randn(40, 6, 1100).astype(np.float32)  # rows of 4400 bytes
  path = str(tmp_path / "s.zarr")
  # uncompressed: the rows of a chunk are read on their own
  xds.to_zarr(xds.Dataset({"x": (("time", "level", "cell"), x)}), path,
              chunks={"time": 10}, compressor=None)
  lazy = xds.open_zarr(path, lazy=True)["x"].data
  for keys in ([np.array([3, 1, 33, 1]), slice(2, 5), slice(None)],
               [np.array([3, 1, 33]), np.array([5, 0]), np.array([7, 1])]):
    want = jstream.orthogonal_select(x, keys)
    io_zarr.READS.reset()
    got = xds.orthogonal_select(lazy, keys)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(xds.orthogonal_select(x, keys), want)
  # the first keys: three distinct times x three levels, whole rows of
  # cells; the second select cells too, so their chunks are read whole
  io_zarr.READS.reset()
  xds.orthogonal_select(lazy, [np.array([3, 1, 33, 1]), slice(2, 5),
                               slice(None)])
  assert io_zarr.READS.bytes == 3 * 3 * 1100 * 4


@pytest.mark.parametrize("positions,max_gap", [
    ([5, 1, 2, 40, 41, 90, 3], 16), ([7], 4), ([], 16),
    (np.arange(0, 200, 9), 8)])
def test_clustered_positions_match_the_jax_package(positions, max_gap):
  assert xds.clustered_positions(np.asarray(positions, np.int64),
                                 max_gap) == jstream.clustered_positions(
                                     np.asarray(positions, np.int64),
                                     max_gap)


@pytest.mark.parametrize("text", [
    "", "level=500", "time_start=2020-01-01,time_stop=2020-02-01T12",
    "level_list=500+850,lat_step=-1,x=1.5"])
def test_dim_value_pair_flags_parse_as_the_jax_package(text):
  f = flag_utils.Flags("prog", "")
  f.dim_value_pairs("sel", text, "")
  assert f.parser.parse_args([]).sel == jflag_utils.parse_dim_value_pairs(
      text)
  assert f.parser.parse_args([f"--sel={text}"]).sel == (
      jflag_utils.parse_dim_value_pairs(text))
