"""Lazy reads of the probabilistic climatology's members read only the
positions in use.

``ProbabilisticClimatology.compact_members`` gathers, from a 6-hourly
truth, the times of each (year, day of year, hour) a chunk's valid times
need.  For 12-hourly valid times that is every other time: the 06 and 18
UTC times between them must not be read.  The truth here is chunked by 8
times (as a store chunked by day would be), so a chunk holds positions
that are used and positions that are not; each time of one variable is a
64 x 32 float32 field, 8 KiB.  The bytes read from the chunk files must be
the used positions' bytes exactly, and the members the same bits as from
an eagerly read store.
"""
import numpy as np
import pytest

from weatherbench2_torch import utils, xds
from weatherbench2_torch.xds import io_zarr

N_LON, N_LAT = 64, 32
YEARS = (2001, 2003)


@pytest.fixture(scope="module")
def truth_path(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_member_reads")
  rs = np.random.RandomState(5)
  times = np.concatenate([
      np.datetime64(f"{y}-01-01", "ns")
      + np.arange(12 * 4) * np.timedelta64(6, "h")
      for y in range(YEARS[0], YEARS[1] + 2)])
  ds = xds.Dataset(
      {"2m_temperature": xds.Variable(
          ("time", "longitude", "latitude"),
          rs.randn(len(times), N_LON, N_LAT).astype(np.float32)),
       "geopotential": xds.Variable(
           ("time", "level", "longitude", "latitude"),
           rs.randn(len(times), 2, N_LON, N_LAT).astype(np.float32))},
      coords={"time": times, "level": np.array([500, 850]),
              "longitude": np.arange(N_LON) * 360 / N_LON,
              "latitude": np.linspace(-90, 90, N_LAT)})
  path = str(tmp / "truth.zarr")
  # uncompressed: the rows of a chunk are read on their own
  xds.to_zarr(ds, path, chunks={"time": 8}, compressor=None)
  return path


def _valid_times():
  """12-hourly valid times of two inits x 4 leads: 2004-01-02 .. 01-04."""
  init = np.datetime64("2004-01-02", "ns") + np.arange(2) * np.timedelta64(
      12, "h")
  lead = np.arange(4) * np.timedelta64(12, "h")
  return xds.DataArray(init[:, None] + lead[None, :],
                       dims=("init_time", "lead_time"))


def test_compact_members_read_only_the_positions_in_use(truth_path):
  names = ["2m_temperature", "geopotential"]
  times = _valid_times()
  lazy = utils.ProbabilisticClimatology(
      xds.open_zarr(truth_path, lazy=True), *YEARS, hour_interval=6)
  io_zarr.READS.reset()
  members, index = lazy.compact_members(times, names)
  read = io_zarr.READS.bytes

  pairs = members.sizes[utils.MEMBER_PAIR]
  assert pairs == 5  # 01-02 00 UTC to 01-04 00 UTC, 12-hourly
  per_time = N_LON * N_LAT * 4 * (1 + 2)  # both variables, float32
  used = pairs * lazy.size  # one position per pair and year
  assert read == used * per_time

  eager = utils.ProbabilisticClimatology(
      xds.open_zarr(truth_path), *YEARS, hour_interval=6)
  want, want_index = eager.compact_members(times, names)
  np.testing.assert_array_equal(np.asarray(index.data),
                                np.asarray(want_index.data))
  for name in names:
    np.testing.assert_array_equal(
        np.asarray(members[name].data).view(np.uint32),
        np.asarray(want[name].data).view(np.uint32), err_msg=name)


def test_a_strided_view_reads_only_its_rows(truth_path):
  """A lazy strided slice and a position array read their rows alone; a
  row under the partial-read size reads its chunk whole."""
  ds = xds.open_zarr(truth_path, lazy=True)
  data = ds["2m_temperature"].data
  per_time = N_LON * N_LAT * 4
  eager = np.asarray(data)
  for key in (slice(1, 40, 2), np.array([3, 17, 4, 4, 30])):
    io_zarr.READS.reset()
    got = np.asarray(data[key])
    np.testing.assert_array_equal(got, eager[key])
    assert io_zarr.READS.bytes == len(np.unique(np.arange(48)[key])) * per_time
  # a latitude band: each row is 32 bytes, so the chunks are read whole
  io_zarr.READS.reset()
  band = np.asarray(data[0:8, :, 4:12])
  np.testing.assert_array_equal(band, eager[0:8, :, 4:12])
  assert io_zarr.READS.bytes == 8 * per_time
