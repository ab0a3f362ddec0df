"""Payload tasks of ``xds.to_device`` over the streaming engine's prefetch
threads, on the CPU.

With a ``xds.Staging``, ``to_device`` hands each payload of at least
``xds.stream.STAGE_TASK_BYTES`` to a ``StageQueue`` whose idle threads may
read, narrow and pin it, and runs the rest and its own queued tasks itself;
without one it stages every payload itself, one after the other.  Both give
the same tensors, bytes and errors.  The engine's payloads here are small,
so the engine tests set the task size to 0 (every payload a task) and hold
the run to one with no tasks at all (the size above every payload).  On the
card a task reads a lazy view of stored values straight into pinned memory
(``LazyArray.read_into``), held here to ``np.asarray`` of the view.
"""
import concurrent.futures
import sys
import threading

import numpy as np
import pytest
import torch

from weatherbench2_torch import config
from weatherbench2_torch import evaluation
from weatherbench2_torch import metrics
from weatherbench2_torch import schema
from weatherbench2_torch import tracing
from weatherbench2_torch import utils
from weatherbench2_torch import xds
from weatherbench2_torch.parallel import streaming
from weatherbench2_torch.regions import SliceRegion
from weatherbench2_torch.xds import io_zarr
from weatherbench2_torch.xds import stream

VARIABLES = ["2m_temperature", "10m_u_component_of_wind"]
LZ4 = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}
# entries of one large payload: 2 MiB of float32, two chunk files of 1 MiB
FIELD = (2, 512, 512)
NO_TASKS = 1 << 62
JOIN_S = 120


class _OtherThread(concurrent.futures.Executor):
  """Runs each call to its end on a new thread before ``submit`` returns,
  so that every task handed to a ``StageQueue`` over it runs on a thread
  other than its caller's."""

  def __init__(self):
    self.threads = set()

  def submit(self, fn, /, *args, **kwargs):
    def call():
      self.threads.add(threading.get_ident())
      try:
        fn(*args, **kwargs)
      except Exception:  # pylint: disable=broad-except
        pass  # the task keeps it; its caller raises it
    thread = threading.Thread(target=call)
    thread.start()
    thread.join(timeout=JOIN_S)
    assert not thread.is_alive()


def _payloads(tmp_path, kind):
  """Large and small payloads, one of them twice, and an array of times;
  the large ones lazy views of a Zarr store for ``raw`` and ``lz4``."""
  rng = np.random.default_rng(0)
  dims = ("time", "latitude", "longitude")
  big = {f"f{i}": xds.DataArray(rng.standard_normal(FIELD).astype(dt),
                                dims=dims)
         for i, dt in enumerate((np.float32, np.float32, np.float64))}
  ds = xds.Dataset({k: v.variable for k, v in big.items()})
  if kind != "numpy":
    path = str(tmp_path / f"{kind}.zarr")
    xds.to_zarr(ds, path, chunks={"time": 1},
                compressor=LZ4 if kind == "lz4" else None)
    ds = xds.open_zarr(path, lazy=True)
    assert all(isinstance(v.data, xds.core.LazyArrayBase)
               for v in ds.variables_dict().values())
  shared = xds.DataArray(rng.standard_normal(FIELD).astype(np.float32),
                         dims=dims)
  small = xds.DataArray(np.arange(8.0), dims=("x",))
  times = xds.DataArray(np.arange(4).astype("datetime64[D]"), dims=("t",))
  return (ds, {"acc": shared, "rmse": shared}, small, times)


def _leaves(obj):
  if isinstance(obj, xds.Dataset):
    return [v.data for v in obj.variables_dict().values()]
  if isinstance(obj, xds.DataArray):
    return [obj.data]
  if isinstance(obj, dict):
    return [x for v in obj.values() for x in _leaves(v)]
  if isinstance(obj, (list, tuple)):
    return [x for v in obj for x in _leaves(v)]
  return []


def _staged(obj, transfer_dtype, pool):
  counter, tally = {}, tracing.Counts()
  staging = xds.Staging(xds.StageQueue(pool), 0)
  with io_zarr.tally(tally):
    out = xds.to_device(obj, torch.device("cpu"), None, counter,
                        transfer_dtype, staging=staging)
  return out, counter, staging, tally


@pytest.mark.parametrize("kind,transfer_dtype", [
    ("numpy", None), ("raw", None), ("lz4", None), ("raw", torch.bfloat16)])
def test_staged_payloads_equal_the_serial_ones_bit_for_bit(tmp_path, kind,
                                                           transfer_dtype):
  obj = _payloads(tmp_path, kind)
  serial_counter = {}
  serial = xds.to_device(obj, torch.device("cpu"), None, serial_counter,
                         transfer_dtype)
  pool = _OtherThread()
  staged, counter, staging, tally = _staged(obj, transfer_dtype, pool)
  assert counter == serial_counter
  # three fields and the shared one cross once, 2 MiB or 4 MiB each
  assert staging.tasks == 4 and pool.threads
  assert staging.offload_s > 0 and staging.blocked_s == 0
  # the tasks ran on other threads: their reads and decodes are the caller's
  if kind != "numpy":
    assert tally["read_bytes"] > 0
    assert (tally.get("decode_bytes", 0) > 0) == (kind == "lz4")
  want, got = _leaves(serial), _leaves(staged)
  assert len(got) == len(want) == 7
  for a, b in zip(want, got):
    assert type(a) is type(b)
    if torch.is_tensor(a):
      assert a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8),
                                                b.view(-1).view(torch.uint8))
    else:
      np.testing.assert_array_equal(a, b)
  shared = staged[1]
  assert shared["acc"].data is shared["rmse"].data
  n = int(np.prod(FIELD))
  # the small payload's 8 float64 cross as they are; the times stay
  assert serial_counter["h2d_bytes"] == 64 + (
      4 * n * 2 if transfer_dtype else 3 * n * 4 + n * 8)


@pytest.mark.parametrize("kind,fault", [
    ("raw", "short"), ("lz4", "short"), ("raw", "missing")])
def test_a_bad_chunk_file_fails_a_task_as_it_fails_the_serial_path(
    tmp_path, kind, fault):
  """A short chunk file raises the same ValueError from a task on another
  thread as from the serial path; a missing one reads as the fill value
  (Zarr's rule) in both."""
  ds = _payloads(tmp_path, kind)[0]
  chunk = tmp_path / f"{kind}.zarr" / "f1" / "1.0.0"
  if fault == "short":
    chunk.write_bytes(chunk.read_bytes()[:1000])
  else:
    chunk.unlink()
  if fault == "short":
    with pytest.raises(ValueError) as serial:
      xds.to_device(ds, torch.device("cpu"))
    with pytest.raises(ValueError) as staged:
      _staged(ds, None, _OtherThread())
    assert type(staged.value) is type(serial.value)
    assert str(staged.value) == str(serial.value)
    assert "f1" in str(serial.value)
    return
  serial = xds.to_device(ds, torch.device("cpu"))
  staged = _staged(ds, None, _OtherThread())[0]
  fill = io_zarr.open_zarr_array(str(chunk.parent.parent), "f1").fill_value
  assert (serial["f1"].data[1] == fill).all()
  for name in serial.variables_dict():
    assert torch.equal(serial[name].data, staged[name].data)


def test_the_caller_runs_its_own_tasks_when_no_thread_is_free():
  """A pool that never runs a helper: the caller stages every payload
  itself, and nothing waits."""

  class Never(concurrent.futures.Executor):

    def submit(self, fn, /, *args, **kwargs):
      return None

  obj = xds.Dataset({f"v{i}": xds.DataArray(np.full(FIELD, i, np.float32),
                                            dims=("a", "b", "c")).variable
                     for i in range(3)})
  out, counter, staging, _ = _staged(obj, None, Never())
  assert staging.tasks == 3 and staging.offload_s == 0
  assert counter["h2d_bytes"] == 3 * 4 * np.prod(FIELD)
  assert [float(out[f"v{i}"].data[0, 0, 0]) for i in range(3)] == [0, 1, 2]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  """Nine daily inits of 3 leads at 30 degrees, and their truth."""
  tmp = tmp_path_factory.mktemp("torch_stage_tasks")
  kwargs = dict(variables_3d=[], variables_2d=VARIABLES,
                spatial_resolution_in_degrees=30.0, time_start="2020-01-01")
  truth = utils.random_like(
      schema.mock_truth_data(time_stop="2020-01-15", **kwargs), seed=0)
  forecast = utils.random_like(
      schema.mock_forecast_data(lead_stop="2 days", time_stop="2020-01-10",
                                **kwargs), seed=1)
  paths = {"truth": str(tmp / "t.zarr"), "forecast": str(tmp / "f.zarr")}
  xds.to_zarr(truth, paths["truth"], compressor=LZ4)
  xds.to_zarr(forecast, paths["forecast"], compressor=LZ4)
  data_config = config.Data(
      selection=config.Selection(variables=VARIABLES,
                                 time_slice=slice("2020-01-01",
                                                  "2020-01-09")),
      paths=config.Paths(forecast=paths["forecast"], obs=paths["truth"],
                         output_dir=str(tmp / "out")),
      by_init=True)
  return data_config


def _configs():
  return {
      "det": config.Eval(metrics={"mse": metrics.MSE(), "bias": metrics.Bias()},
                         regions={"global": SliceRegion()}),
      "det_temporal": config.Eval(metrics={"mae": metrics.MAE()},
                                  regions={"global": SliceRegion()},
                                  temporal_mean=False),
  }


def _engine(data_config, monkeypatch, task_bytes, spans=False):
  """One chunk an init (9 chunks, more than ``PREFETCH_DEPTH``) through the
  engine on a thread of its own, joined with a time limit."""
  monkeypatch.setattr(stream, "STAGE_TASK_BYTES", task_bytes)
  cfgs = _configs()
  forecast, truth, climatology = evaluation.open_forecast_and_truth_datasets(
      data_config, cfgs["det"], lazy=True)
  stats, out = {}, {}

  def run():
    try:
      out["results"] = streaming.evaluate_streaming_multi(
          forecast, truth, climatology, cfgs, data_config, {"init_time": 1},
          device="cpu", stats=stats, spans=spans)
    except Exception as err:  # pylint: disable=broad-except
      out["error"] = err

  thread = threading.Thread(target=run, daemon=True)
  thread.start()
  thread.join(timeout=JOIN_S)
  assert not thread.is_alive(), "the engine did not finish"
  if "error" in out:
    raise out["error"]
  assert stats["chunks"] == 9 > streaming.PREFETCH_DEPTH
  return out["results"], stats


def test_more_chunks_than_threads_finish_equal_to_the_serial_run(
    stores, monkeypatch):
  serial, serial_stats = _engine(stores, monkeypatch, NO_TASKS)
  staged, stats = _engine(stores, monkeypatch, 0)
  assert serial_stats["stage_tasks"] == 0 == serial_stats["offload_s"]
  assert stats["stage_tasks"] > 9 and 0 <= stats["offload_s"]
  assert stats["offload_s"] <= stats["prepare_s"]
  for key in ("h2d_bytes", "read_bytes"):
    assert stats[key] == serial_stats[key], key
  assert set(staged) == set(serial)
  for cname, ds in serial.items():
    got = staged[cname]
    assert set(got.variables_dict()) == set(ds.variables_dict())
    for name, v in ds.variables_dict().items():
      np.testing.assert_array_equal(np.asarray(got[name].data),
                                    np.asarray(v.data))


def test_no_more_threads_prepare_at_once_than_the_pool_has(stores,
                                                           monkeypatch):
  """Threads inside a chunk's serial part, its ``to_device`` or a payload
  task, counted at every entry."""
  inside, most, lock = set(), [0], threading.Lock()

  def counted(fn):
    def wrapper(*args, **kwargs):
      me = threading.get_ident()
      with lock:
        nested = me in inside
        inside.add(me)
        most[0] = max(most[0], len(inside))
      try:
        return fn(*args, **kwargs)
      finally:
        if not nested:
          with lock:
            inside.discard(me)
    return wrapper

  monkeypatch.setattr(streaming, "_make_truth_chunk",
                      counted(streaming._make_truth_chunk))
  monkeypatch.setattr(xds, "to_device", counted(xds.to_device))
  monkeypatch.setattr(stream._Task, "run", counted(stream._Task.run))
  _, stats = _engine(stores, monkeypatch, 0)
  assert stats["stage_tasks"] > 0
  assert 1 <= most[0] <= streaming.PREFETCH_DEPTH


def test_each_chunk_span_counts_its_tasks_wherever_they_ran(stores,
                                                            monkeypatch):
  spans = tracing.Spans()
  _, stats = _engine(stores, monkeypatch, 0, spans=spans)
  prepares = [s for s in spans.records if s["name"] == "wb2.prepare"]
  assert sorted(s["chunk"] for s in prepares) == list(range(9))
  for s in prepares:
    duration = (s["end_ns"] - s["start_ns"]) / 1e9
    assert s["stage_tasks"] > 0 and s["offload_s"] >= 0, s
    assert s["busy_s"] >= duration - s["blocked_s"], s
    assert s["read_s"] + s["decode_s"] + s["pin_s"] <= s["busy_s"], s
  for key in ("read_bytes", "h2d_bytes", "stage_tasks"):
    assert sum(s[key] for s in prepares) == stats[key], key
  for key in ("read_s", "decode_s", "offload_s"):
    assert sum(s[key] for s in prepares) == pytest.approx(stats[key]), key
  assert sum(s["busy_s"] for s in prepares) == pytest.approx(
      stats["prepare_s"])


@pytest.mark.parametrize("kind", ["raw", "lz4"])
@pytest.mark.parametrize("key", [
    (slice(None),), (1,), (slice(None), slice(100, 300)),
    (slice(None), slice(None), 7), (np.array([0, 1]),)])
def test_a_plain_view_reads_into_an_array_as_it_materialises(tmp_path, kind,
                                                             key):
  """What a staging task reads straight into pinned memory on the card:
  the view's bytes, whole chunks, rows of them and dropped axes alike."""
  lazy = _payloads(tmp_path, kind)[0]["f2"].data[key]
  assert isinstance(lazy, io_zarr.LazyArray) and lazy.plain
  out = np.full(lazy.shape, np.nan, lazy.dtype)
  lazy.read_into(out)
  np.testing.assert_array_equal(out, np.asarray(lazy))


def test_a_view_that_reorders_or_repeats_is_not_plain(tmp_path):
  lazy = _payloads(tmp_path, "raw")[0]["f0"].data
  for key in (np.array([1, 0]), np.array([0, 0])):
    view = lazy[key]
    assert isinstance(view, io_zarr.LazyArray) and not view.plain
    with pytest.raises(ValueError, match="plain view"):
      view.read_into(np.empty(view.shape, view.dtype))
  with pytest.raises(ValueError, match="plain view"):
    lazy.read_into(np.empty(lazy.shape, np.float64))


def test_many_callers_share_one_queue_and_lose_no_task(monkeypatch):
  """More callers than cores hand tasks to one queue over four threads,
  with the interpreter switching threads often: every payload is staged
  once, and each caller gets its own values back."""
  monkeypatch.setattr(stream, "STAGE_TASK_BYTES", 0)
  runs, lock, errors, outs = {}, threading.Lock(), [], {}
  stage = stream._stage

  def counted(x, *args):
    with lock:
      runs[id(x)] = runs.get(id(x), 0) + 1
    return stage(x, *args)

  monkeypatch.setattr(stream, "_stage", counted)
  n_callers, n_payloads = 16, 6
  inputs = {i: xds.Dataset({f"v{j}": xds.DataArray(
      np.full((4, 8), 100 * i + j, np.float32), dims=("a", "b")).variable
                            for j in range(n_payloads)})
            for i in range(n_callers)}
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
  queue = xds.StageQueue(pool)

  def call(i):
    try:
      outs[i] = xds.to_device(inputs[i], torch.device("cpu"),
                              staging=xds.Staging(queue, i))
    except Exception as err:  # pylint: disable=broad-except
      errors.append(err)

  old = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(n_callers)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=JOIN_S)
  finally:
    sys.setswitchinterval(old)
    pool.shutdown(wait=True)
  assert not any(t.is_alive() for t in threads)
  assert not errors, errors[:3]
  assert len(runs) == n_callers * n_payloads
  assert set(runs.values()) == {1}
  for i, out in outs.items():
    for j in range(n_payloads):
      assert (out[f"v{j}"].data == 100 * i + j).all()
