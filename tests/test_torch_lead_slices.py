"""Lead slices of the port's streaming engine, on the CPU.

WeatherBench 2's official deterministic pair (``deterministic`` and
``deterministic_temporal``, wind vectors, SEEPS, ``--regions=all`` with the
obs store's land-sea mask: 16 regions) runs through the port's CLI on the
stores of ``tests/test_torch_official_configs.py`` (16 inits of 7 leads
at 30 degrees), in chunks of 4 inits and of 2, 3 or all 7 leads.  Every
lead chunking gives the whole run's results within float32 rounding
(``rtol=1e-5`` plus ``atol=1e-5 x max|whole run|`` per variable); the
counters ``lead_slices`` and ``lead_refill_s`` count the slices and the
waits for each later slice's first chunk; and a ``wb2.lead_slice`` span
covers each slice's stream and finalize only where there is more than one.
SEEPS's dry fraction, a mean over every day and hour of the climatology
(6 GB at 0.25 degrees), is computed once however many prefetch threads ask
for it at once.
"""
import threading
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_official_configs import (
    PRECIP, VARIABLES, _seeps_climatology, assert_results_close, build_stores,
    open_result)
from weatherbench2_torch import metrics
from weatherbench2_torch import xds
from weatherbench2_torch.cli import evaluate as cli

CONFIGS = ["deterministic", "deterministic_temporal"]
LEADS = 7
INITS_PER_CHUNK = 4
CHUNKS_PER_SLICE = 16 // INITS_PER_CHUNK


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("torch_lead_slices")
  return tmp, build_stores(str(tmp))


def _run(stores, tag, lead_chunk=None):
  """The official pair through the CLI in lead slices of ``lead_chunk``
  (None: the whole axis); (its counts, {config: results})."""
  tmp, paths = stores
  out = tmp / tag
  chunks = f"init_time={INITS_PER_CHUNK}" + (
      f",lead_time={lead_chunk}" if lead_chunk else "")
  stats = cli.main([
      f"--forecast_path={paths['forecast']}", f"--obs_path={paths['truth']}",
      f"--climatology_path={paths['climatology']}", f"--output_dir={out}",
      "--variables=" + ",".join(VARIABLES), "--time_start=2020-02-24",
      "--time_stop=2020-03-02T12", "--eval_configs=" + ",".join(CONFIGS),
      "--compute_seeps", "--regions=all", "--use_mesh", "--by_init",
      f"--input_chunks={chunks}", "--device=cpu"])
  return stats, {name: open_result(out, name) for name in CONFIGS}


@pytest.fixture(scope="module")
def whole(stores):
  return _run(stores, "whole")[1]


@pytest.mark.parametrize("lead_chunk", [2, 3, None])
def test_lead_slices_give_the_whole_run_and_are_counted(stores, whole,
                                                        lead_chunk):
  """7 leads in slices of 2 (ragged: 4 slices), 3 (ragged: 3) and the whole
  axis (one slice), profiled so that the spans are kept."""
  with profile(activities=[ProfilerActivity.CPU]):
    stats, got = _run(stores, f"lead{lead_chunk}", lead_chunk)
  for name in CONFIGS:
    assert got[name].sizes["region"] == 16
    assert got[name].sizes["lead_time"] == LEADS
    assert_results_close(got[name], whole[name], f"lead {lead_chunk}/{name}")

  n_slices = -(-LEADS // lead_chunk) if lead_chunk else 1
  assert stats["lead_slices"] == n_slices
  assert stats["chunks"] == CHUNKS_PER_SLICE * n_slices
  if n_slices == 1:
    assert stats["lead_refill_s"] == 0.0
  else:
    assert 0.0 < stats["lead_refill_s"] <= stats["wait_host_s"]

  spans = stats["spans"]
  slices = [s for s in spans if s["name"] == "wb2.lead_slice"]
  if n_slices == 1:
    assert not slices
  else:
    assert [(s["lead"], s["leads"], s["chunks"]) for s in slices] == [
        (i, min(lead_chunk, LEADS - i * lead_chunk), CHUNKS_PER_SLICE)
        for i in range(n_slices)]
  waits = [s for s in spans if s["name"] == "wb2.wait_host"]
  assert sorted({s["lead"] for s in waits}) == list(range(n_slices))
  for lead, s in enumerate(slices):
    # a slice's span covers its waits, its copy back and its finalize
    inside = [w for w in spans if w.get("lead") == lead
              and w["name"] == "wb2.wait_host"]
    assert len(inside) == CHUNKS_PER_SLICE
    assert all(s["start_ns"] <= w["start_ns"] <= w["end_ns"] <= s["end_ns"]
               for w in inside)
  d2h = [s for s in spans if s["name"] == "wb2.d2h"]
  assert len(d2h) == n_slices
  for d, s in zip(d2h, slices):
    assert s["start_ns"] <= d["start_ns"] <= d["end_ns"] <= s["end_ns"]


def test_seeps_dry_fraction_is_averaged_once_for_every_thread(monkeypatch):
  """Four threads ask a SEEPS metric for its dry fraction at once, as the
  prefetch threads preparing the first chunks of a stream do: one mean is
  taken, and every thread gets it."""
  lat, lon = np.linspace(-90, 90, 7), np.linspace(0, 360, 12, endpoint=False)
  _, clim = _seeps_climatology(3, lat, lon)
  metric = metrics.SEEPS(climatology=clim, precip_name=PRECIP)
  mean, calls = xds.DataArray.mean, []

  def slow_mean(self, *args, **kwargs):
    calls.append(args)
    time.sleep(0.2)  # long enough for every thread to ask meanwhile
    return mean(self, *args, **kwargs)

  monkeypatch.setattr(xds.DataArray, "mean", slow_mean)
  start = threading.Barrier(4, timeout=30)
  got = []

  def ask():
    start.wait()
    got.append(metric.p1)

  threads = [threading.Thread(target=ask) for _ in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=60)
    assert not t.is_alive()
  assert len(calls) == 1
  assert len(got) == 4 and all(p is got[0] for p in got)
  want = clim[f"{PRECIP}_seeps_dry_fraction"].values.mean((0, 1))
  np.testing.assert_allclose(got[0].values, want, rtol=1e-6)
