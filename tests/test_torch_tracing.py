"""Spans and counters of the port's chunk pipeline, on the CPU.

``evaluation.evaluate_with_mesh`` keeps spans only while ``torch.profiler``
records its calling thread, and hands them over in ``stats["spans"]``; the
counters (``read_s``, ``decode_s``, ``pin_s``, ``prepare_s``, ``d2h_s``,
``stage_tasks``, ``offload_s``, ``metric_prep_s``, ``generic_s``,
``write_bytes``, ``encode_bytes``, ``encode_s``, ``finalize_device_bytes``,
``finalize_host_merges``) are always there, and ``write_direct_bytes``
where a config writes Zarr.  The
stores are 30-degree, two 2-d variables, 8 daily inits of 3 leads, written
by the port uncompressed or as blosc-lz4.  The Zarr writer's counts
(``io_zarr.WRITES``) are held to the bytes it writes.
"""
import contextlib
import hashlib
import os
import sys
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from weatherbench2_torch import config
from weatherbench2_torch import evaluation
from weatherbench2_torch import metrics
from weatherbench2_torch import schema
from weatherbench2_torch import tracing
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.parallel import streaming
from weatherbench2_torch.regions import SliceRegion
from weatherbench2_torch.xds import _codec
from weatherbench2_torch.xds import io_zarr

VARIABLES = ["2m_temperature", "10m_u_component_of_wind"]
LZ4 = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}
COUNTERS = ("read_s", "decode_s", "pin_s", "prepare_s", "d2h_s",
            "stage_tasks", "offload_s", "metric_prep_s", "generic_s",
            "write_bytes", "encode_bytes", "encode_s", "finalize_device_bytes",
            "finalize_host_merges")
# every span of the pipeline; wb2.wait_device waits for a CUDA device's
# queue, which a CPU run does not have
SPANS = {"wb2.job", "wb2.open", "wb2.prepare", "wb2.wait_host",
         "wb2.chunk_program", "wb2.d2h", "wb2.finalize", "wb2.write"}
PER_CHUNK = ("wb2.prepare", "wb2.wait_host", "wb2.chunk_program")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_tracing")
  kwargs = dict(variables_3d=[], variables_2d=VARIABLES,
                spatial_resolution_in_degrees=30.0, time_start="2020-01-01")
  truth = utils.random_like(
      schema.mock_truth_data(time_stop="2020-01-15", **kwargs), seed=0)
  forecast = utils.random_like(
      schema.mock_forecast_data(lead_stop="2 days", time_stop="2020-01-09",
                                **kwargs), seed=1)
  paths = {}
  for name, comp in (("raw", None), ("lz4", LZ4)):
    paths[name] = {"truth": str(tmp / f"{name}_t.zarr"),
                   "forecast": str(tmp / f"{name}_f.zarr")}
    xds.to_zarr(truth, paths[name]["truth"], compressor=comp)
    xds.to_zarr(forecast, paths[name]["forecast"], compressor=comp)
  return tmp, paths


def _data_config(paths, out_dir):
  return config.Data(
      selection=config.Selection(variables=VARIABLES,
                                 time_slice=slice("2020-01-01", "2020-01-08")),
      paths=config.Paths(forecast=paths["forecast"], obs=paths["truth"],
                         output_dir=str(out_dir)),
      by_init=True)


def _configs():
  return {
      "det": config.Eval(metrics={"mse": metrics.MSE(), "bias": metrics.Bias()},
                         regions={"global": SliceRegion()}),
      "det_temporal": config.Eval(metrics={"mae": metrics.MAE()},
                                  regions={"global": SliceRegion()},
                                  temporal_mean=False),
  }


def _spatial_configs():
  """Per-cell maps written to Zarr: metrics no fused tier takes, so they
  run in the engine's per-metric loop."""
  return {
      "spatial": config.Eval(
          metrics={"mse": metrics.SpatialMSE(), "bias": metrics.SpatialBias()},
          output_format="zarr"),
      "det": _configs()["det"],
  }


def _run(stores, store="raw", chunk=4, profiled=False, configs=_configs):
  tmp, paths = stores
  out = tmp / f"out_{store}_{chunk}_{profiled}_{configs.__name__}"
  args = (_data_config(paths[store], out), configs())
  kwargs = dict(device="cpu", input_chunks={"init_time": chunk})
  if not profiled:
    return evaluation.evaluate_with_mesh(*args, **kwargs), None
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    stats = evaluation.evaluate_with_mesh(*args, **kwargs)
  return stats, prof


def _duration_s(span):
  return (span["end_ns"] - span["start_ns"]) / 1e9


def test_a_profiled_run_keeps_every_span_of_its_two_chunks(stores):
  stats, _ = _run(stores, profiled=True)
  spans = stats["spans"]
  assert {s["name"] for s in spans} == SPANS
  assert stats["chunks"] == 2
  for name in PER_CHUNK:
    assert sorted(s["chunk"] for s in spans if s["name"] == name) == [0, 1]
  waits = {s["chunk"]: s for s in spans if s["name"] == "wb2.wait_host"}
  assert (waits[0]["ordinal"], waits[1]["ordinal"]) == (0, 1)
  by_id = {s["id"]: s for s in spans}
  assert len(by_id) == len(spans)
  (root,) = [s for s in spans if s["parent"] is None]
  assert root["name"] == "wb2.job"
  assert root["configs"] == ["det", "det_temporal"]
  for s in spans:
    assert s["job"] == root["id"]
    assert s["parent"] is None or s["parent"] in by_id
    assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"]
  assert {s["thread"] for s in spans if s["name"] == "wb2.prepare"}.isdisjoint(
      {root["thread"]})
  writes = sorted((s["config"], s["format"]) for s in spans
                  if s["name"] == "wb2.write")
  assert writes == [("det", "netcdf"), ("det_temporal", "netcdf")]
  (d2h,) = [s for s in spans if s["name"] == "wb2.d2h"]
  assert d2h["bytes"] > 0


def test_main_thread_spans_land_in_the_profiler_on_its_clock(stores):
  stats, prof = _run(stores, profiled=True)
  events = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("wb2.")]
  (job,) = [s for s in stats["spans"] if s["name"] == "wb2.job"]
  (job_event,) = [e for e in events if e.name() == "wb2.job"]
  assert abs(job_event.start_ns() - job["start_ns"]) < 2e6
  main = {s["name"] for s in stats["spans"] if s["thread"] == job["thread"]}
  # the prefetch threads are not the profiled thread
  assert {e.name() for e in events} == main == SPANS - {"wb2.prepare"}


def test_an_unprofiled_run_keeps_no_spans_and_every_counter(stores):
  stats, _ = _run(stores)
  assert "spans" not in stats
  # the contract that the benchmark's metrics and the card's smoke read by
  # name: a one-device run has no "ranks"
  assert set(stats) == set(COUNTERS) | {
      "chunks", "h2d_bytes", "read_bytes", "wait_host_s", "wait_device_s",
      "finalize_s", "write_s", "wall_s", "lead_slices", "lead_refill_s"}
  assert (stats["lead_slices"], stats["lead_refill_s"]) == (1, 0.0)
  for key in COUNTERS:
    assert stats[key] >= 0, key
  assert stats["prepare_s"] > 0 and stats["read_s"] > 0
  assert stats["d2h_s"] <= stats["wait_device_s"]
  assert stats["read_s"] + stats["decode_s"] + stats["pin_s"] <= (
      stats["prepare_s"])


@pytest.mark.parametrize("store", ["raw", "lz4"])
def test_read_seconds_on_every_store_decode_seconds_on_compressed(stores,
                                                                  store):
  stats, _ = _run(stores, store)
  assert stats["read_s"] > 0
  assert (stats["decode_s"] > 0) == (store == "lz4")


def test_each_prepare_span_carries_its_own_chunk(stores):
  """Four chunks prepared at once on four threads: each span's reads,
  decodes and pinning fit inside its thread-seconds (``busy_s``: its tasks
  may run on other threads at once), which cover its wall less the time it
  waited on them, and the spans' tallies add up to the run's counts."""
  stats, _ = _run(stores, "lz4", chunk=2, profiled=True)
  prepares = [s for s in stats["spans"] if s["name"] == "wb2.prepare"]
  assert sorted(s["chunk"] for s in prepares) == [0, 1, 2, 3]
  assert len({s["thread"] for s in prepares}) > 1
  for s in prepares:
    assert s["read_s"] + s["decode_s"] + s["pin_s"] <= s["busy_s"], s
    assert s["busy_s"] >= _duration_s(s) - s["blocked_s"], s
    assert s["read_bytes"] > 0 and s["decode_bytes"] > 0
  assert sum(s["read_bytes"] for s in prepares) == stats["read_bytes"]
  assert sum(s["h2d_bytes"] for s in prepares) == stats["h2d_bytes"]
  assert sum(s["read_s"] for s in prepares) == pytest.approx(stats["read_s"])
  assert sum(s["decode_s"] for s in prepares) == pytest.approx(
      stats["decode_s"])
  assert sum(_duration_s(s) for s in prepares) <= stats["prepare_s"]


@pytest.mark.parametrize("case", ["unprofiled", "profiled", "spans_off"])
def test_a_direct_streaming_call_reads_the_flag_itself(stores, case):
  """Called directly, the engine keeps spans while the profiler records its
  thread (none of the entry's, and no root), unless told not to."""
  tmp, paths = stores
  data_config = _data_config(paths["raw"], tmp / "direct")
  cfgs = {"det": _configs()["det"]}
  forecast, truth, climatology = evaluation.open_forecast_and_truth_datasets(
      data_config, cfgs["det"], lazy=True)
  stats = {}
  with (profile(activities=[ProfilerActivity.CPU]) if case != "unprofiled"
        else contextlib.nullcontext()):
    results = streaming.evaluate_streaming_multi(
        forecast, truth, climatology, cfgs, data_config, {"init_time": 4},
        device="cpu", stats=stats,
        **({"spans": False} if case == "spans_off" else {}))
  assert set(results) == {"det"}
  if case != "profiled":
    assert "spans" not in stats
    return
  assert {s["name"] for s in stats["spans"]} == SPANS - {
      "wb2.job", "wb2.open", "wb2.write"}
  assert all(s["parent"] is None and s["job"] is None
             for s in stats["spans"])


def test_spans_of_a_call_nest_under_its_root():
  spans = tracing.Spans()
  with spans.span("wb2.job", root=True, configs=["a"]):
    with spans.span("wb2.wait_host", chunk=3, ordinal=0) as rec:
      rec["extra"] = 1
  inner, root = spans.records
  assert root["parent"] is None and root["job"] == root["id"]
  assert inner["parent"] == root["id"] and inner["job"] == root["id"]
  assert (inner["chunk"], inner["ordinal"], inner["extra"]) == (3, 0, 1)
  assert root["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= (
      root["end_ns"])
  assert not tracing.profiling()


def test_counters_lose_no_update_and_keep_each_threads_tally():
  """More threads than cores add to one counter at once, with the
  interpreter switching threads often: the sums lose no update and each
  thread's own tally is what it added."""
  counter = io_zarr.ReadCounter()
  n_threads, n_adds = 32, 2000
  tallies, errors = {}, []

  def work(i):
    try:
      with io_zarr.tally(tracing.Counts()) as counts:
        for _ in range(n_adds):
          counter.add(i + 1, 0.5)
      tallies[i] = (counts["read_bytes"], counts["read_s"])
    except Exception as err:  # reported below
      errors.append(err)

  old = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=60)
  finally:
    sys.setswitchinterval(old)
  assert not any(t.is_alive() for t in threads)
  assert not errors, errors[:3]
  assert counter.bytes == n_adds * sum(range(1, n_threads + 1))
  assert counter.seconds == n_threads * n_adds * 0.5
  assert tallies == {i: ((i + 1) * n_adds, n_adds * 0.5)
                     for i in range(n_threads)}
  assert io_zarr.tallied() is None


def _stored_bytes(path):
  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(path) for f in files)


def test_every_run_counts_its_metric_preparation_loop_and_writes(stores):
  """Without spans the counters are in ``stats``: the per-metric loop's
  seconds where a config has metrics no fused tier takes, none where
  every metric is fused, and the results' bytes as stored."""
  fused, _ = _run(stores)
  spatial, _ = _run(stores, configs=_spatial_configs)
  for stats in (fused, spatial):
    assert stats["metric_prep_s"] > 0
    assert stats["write_bytes"] > 0
  assert fused["generic_s"] == 0.0
  assert spatial["generic_s"] > 0
  # netCDF files have no chunks to encode; the Zarr maps have
  assert fused["encode_bytes"] == 0 and fused["encode_s"] == 0.0
  assert spatial["encode_bytes"] > 0 and spatial["encode_s"] > 0


def test_write_spans_carry_the_files_stored_bytes(stores):
  """Each ``wb2.write`` span's ``bytes`` are its results file's bytes on
  disk (every file of a Zarr store), and they add up to
  ``write_bytes``; the encode seconds of the spans to ``encode_s``."""
  stats, _ = _run(stores, profiled=True, configs=_spatial_configs)
  tmp, _ = stores
  out = tmp / "out_raw_4_True__spatial_configs"
  writes = {s["config"]: s for s in stats["spans"] if s["name"] == "wb2.write"}
  assert sorted(writes) == ["det", "spatial"]
  assert writes["spatial"]["bytes"] == _stored_bytes(out / "spatial.zarr")
  assert writes["det"]["bytes"] == os.path.getsize(out / "det.nc")
  assert writes["det"]["encode_s"] == 0.0
  assert sum(w["bytes"] for w in writes.values()) == stats["write_bytes"]
  assert sum(w["encode_s"] for w in writes.values()) == pytest.approx(
      stats["encode_s"])
  programs = [s for s in stats["spans"] if s["name"] == "wb2.chunk_program"]
  assert sum(s["generic_s"] for s in programs) == pytest.approx(
      stats["generic_s"])
  prepares = [s for s in stats["spans"] if s["name"] == "wb2.prepare"]
  assert sum(s["metric_prep_s"] for s in prepares) == pytest.approx(
      stats["metric_prep_s"])


def _mixed_configs():
  """A config whose metrics differ in dims (a global mean beside per-cell
  maps), so its means are joined on the host, beside one stacked on the
  device."""
  return {
      "mixed": config.Eval(
          metrics={"mse": metrics.MSE(), "smse": metrics.SpatialMSE()},
          output_format="zarr"),
      "spatial": _spatial_configs()["spatial"],
  }


def _means_bytes(path, global_metrics=()):
  """The bytes of a results file's float64 means, less the cells the
  merge filled in for ``global_metrics``, which have no latitude or
  longitude of their own."""
  total = 0
  for v in xds.open_zarr(str(path)).variables_dict().values():
    assert v.dtype == np.float64
    per_metric = v.size // v.sizes["metric"]
    cells = v.sizes["latitude"] * v.sizes["longitude"]
    total += 8 * sum(per_metric // cells if m in global_metrics else per_metric
                     for m in ("mse", "smse")[-v.sizes["metric"]:])
  return total


@pytest.mark.parametrize("configs", [_spatial_configs, _mixed_configs])
def test_the_finalize_counts_the_means_it_stacked_on_the_device(stores,
                                                                configs):
  """Only the temporal means cross: ``wb2.d2h``'s ``bytes`` are the
  results' float64 values, not the sums and counts.  The means of a
  config whose metrics share variables and coordinates are stacked on the
  device (``finalize_device_bytes``); a config whose metrics differ is
  joined on the host (``finalize_host_merges``); both are in ``stats`` and
  on the ``wb2.finalize`` span."""
  stats, _ = _run(stores, profiled=True, configs=configs)
  tmp, _ = stores
  out = tmp / f"out_raw_4_True_{configs.__name__}"
  (d2h,) = [s for s in stats["spans"] if s["name"] == "wb2.d2h"]
  (fin,) = [s for s in stats["spans"] if s["name"] == "wb2.finalize"]
  spatial = _means_bytes(out / "spatial.zarr")
  if configs is _spatial_configs:
    # the det config's regional means are stacked too
    det_means = sum(np.asarray(v.data).nbytes for v in xds.open_netcdf(
        str(out / "det.nc")).variables_dict().values())
    assert d2h["bytes"] == spatial + det_means
    want = (spatial + det_means, 0)
  else:
    mixed = _means_bytes(out / "mixed.zarr", global_metrics=("mse",))
    assert d2h["bytes"] == spatial + mixed
    want = (spatial, 1)
  assert (stats["finalize_device_bytes"], stats["finalize_host_merges"]) == want
  assert (fin["finalize_device_bytes"], fin["finalize_host_merges"]) == want


# sha256 of the files (relative path, then bytes) of the fixed store below
# as the writer wrote it before it counted its writes: counting changes no
# byte written
WRITTEN = {
    "zstd3": "ca90653ca300c207fee83922b9e5f4c0de9e9a7af546ad3857dc3eacafdc9fd0",
    "lz4": "25447b43dd243f852d408ae4d381e20f5c847692dd25c8956f37b8f2a363df5c",
    "none": "e7f01c8c993683334677e17b9ec3450bbd41ff1c715b1fc2c5fdecb2e195ba1f",
}


@pytest.mark.parametrize("compressor", sorted(WRITTEN))
def test_counted_writes_are_the_bytes_written_before(tmp_path, compressor):
  rng = np.random.default_rng(7)
  shape = (2, 12, 7, 4)
  dims = ("metric", "longitude", "latitude", "bins")
  ds = xds.Dataset(
      {"2m_temperature": xds.Variable(dims, rng.standard_normal(shape)),
       "hist": xds.Variable(dims,
                            np.round(rng.uniform(size=shape) * 2) / 2)},
      coords={"metric": np.array(["crps", "mse"], object),
              "longitude": np.arange(12) * 30.0,
              "latitude": np.linspace(-90, 90, 7), "bins": np.arange(4)})
  path = str(tmp_path / "r.zarr")
  before = (io_zarr.WRITES.bytes, io_zarr.WRITES.decoded)
  xds.to_zarr(ds, path, compressor=compressor)
  digest = hashlib.sha256()
  for root, dirs, files in sorted(os.walk(path)):
    dirs.sort()
    for f in sorted(files):
      full = os.path.join(root, f)
      digest.update(os.path.relpath(full, path).encode())
      with open(full, "rb") as fh:
        digest.update(fh.read())
  assert digest.hexdigest() == WRITTEN[compressor]
  assert io_zarr.WRITES.bytes - before[0] == _stored_bytes(path)
  assert io_zarr.WRITES.decoded - before[1] == 2 * 8 * np.prod(shape) + (
      8 * (12 + 7 + 4))  # the two variables and the numeric coordinates


def _grid_dataset(values, dims=("x", "y")):
  return xds.Dataset({"v": xds.Variable(dims, values)},
                     coords={d: np.arange(n) * 1.5
                             for d, n in zip(dims, values.shape)})


# (chunks, region writes into a template or None for to_zarr, the bytes
# encoded, those encoded from the caller's data): on a (64, 32) float64
# variable, whole chunks inside the array go direct, with the coordinates'
# whole chunks; edge chunks (padded past the array's end, and encoded at
# their padded size) and partial chunks are staged
DIRECT_CASES = {
    "one_chunk": (None, None, 8 * (64 * 32 + 64 + 32),
                  8 * (64 * 32 + 64 + 32)),
    "edge_chunks": ({"x": 24, "y": 12}, None,
                    8 * (9 * 24 * 12 + 3 * 24 + 3 * 12),
                    8 * (4 * 24 * 12 + 2 * 24 + 2 * 12)),
    "edge_and_partial_only": ({"x": 24, "y": 12},
                              [(slice(48, 64), slice(0, 32)),
                               (slice(5, 30), slice(3, 9)),
                               (slice(0, 48), slice(24, 32))],
                              8 * 24 * 12 * (3 + 2 + 2), 0),
}


@pytest.mark.parametrize("case", sorted(DIRECT_CASES))
def test_direct_writes_count_the_whole_chunks_inside_the_array(tmp_path,
                                                                case):
  chunks, regions, decoded, direct = DIRECT_CASES[case]
  values = np.random.default_rng(3).standard_normal((64, 32))
  path = str(tmp_path / "d.zarr")
  if regions is None:
    before = (io_zarr.WRITES.direct, io_zarr.WRITES.decoded)
    xds.to_zarr(_grid_dataset(values), path, chunks=chunks,
                compressor="zstd3")
  else:
    writer = xds.RegionWriter(path, _grid_dataset(values), chunks=chunks,
                              compressor="zstd3")
    before = (io_zarr.WRITES.direct, io_zarr.WRITES.decoded)
    for xs, ys in regions:
      writer.write(_grid_dataset(values[xs, ys]), {"x": xs, "y": ys})
  assert io_zarr.WRITES.decoded - before[1] == decoded
  assert io_zarr.WRITES.direct - before[0] == direct


def test_a_single_chunk_is_encoded_from_the_callers_buffer(tmp_path,
                                                           monkeypatch):
  """The encoder reads the caller's own C-contiguous array, and leaves it
  as it was, NaN payloads too."""
  values = np.random.default_rng(4).standard_normal((16, 8))
  values.view(np.uint64)[3, :4] = 0x7FF8000000000123
  kept = values.copy()
  shared = []
  encode = _codec.encode

  def spy(data, *args):
    shared.append(np.shares_memory(data, values))
    return encode(data, *args)

  monkeypatch.setattr(_codec, "encode", spy)
  xds.to_zarr(_grid_dataset(values), str(tmp_path / "s.zarr"),
              compressor="zstd3")
  # x, y, then v
  assert shared == [False, False, True]
  assert values.tobytes() == kept.tobytes()


def _chunk_files(path):
  out = {}
  for root, _, files in os.walk(path):
    for f in files:
      if not f.startswith("."):
        with open(os.path.join(root, f), "rb") as fh:
          out[os.path.relpath(os.path.join(root, f), path)] = fh.read()
  return out


@pytest.mark.parametrize("chunks", [None, {"x": 5, "y": 24}])
def test_a_transposed_callers_array_writes_the_same_bytes(tmp_path, chunks):
  values = np.random.default_rng(5).standard_normal((32, 13)).T
  assert not values.flags.c_contiguous
  paths = [str(tmp_path / "t.zarr"), str(tmp_path / "c.zarr")]
  for path, data in zip(paths, (values, np.ascontiguousarray(values))):
    xds.to_zarr(_grid_dataset(data), path, chunks=chunks, compressor="lz4")
  assert _chunk_files(paths[0]) == _chunk_files(paths[1])
  np.testing.assert_array_equal(np.asarray(xds.open_zarr(paths[0])["v"].data),
                                values)


def test_zarr_results_count_their_direct_bytes_and_netcdf_none(stores):
  """A Zarr results store's ``wb2.write`` span carries ``direct_bytes``,
  every byte it encoded (one chunk a variable), and ``stats`` their sum
  as ``write_direct_bytes``; a netCDF file carries neither."""
  stats, _ = _run(stores, profiled=True, configs=_spatial_configs)
  writes = {s["config"]: s for s in stats["spans"] if s["name"] == "wb2.write"}
  assert writes["spatial"]["direct_bytes"] == (
      writes["spatial"]["encode_bytes"]) > 0
  assert "direct_bytes" not in writes["det"]
  assert stats["write_direct_bytes"] == writes["spatial"]["direct_bytes"]
  netcdf, _ = _run(stores)
  assert "write_direct_bytes" not in netcdf
