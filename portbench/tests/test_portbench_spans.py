"""The per-layer metrics that read the program's spans and prefetch
counters, fed synthetic jobs and a synthetic trace; and, on a card, every
span of the chunk pipeline in a traced run."""
import json
import pathlib
import types

import pytest

import run
from conftest import tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
NEW = ("read_ms_per_init", "prep_ms_per_init", "pin_ms_per_init",
       "fill_wait_share", "d2h_share", "write_share", "idle_in_wait_share")
S = 10**9  # ns a second


def _span(name, start_s, end_s, **attrs):
  return {"name": name, "start_ns": int(start_s * S), "end_ns": int(end_s * S),
          **attrs}


def _trace(start_s, end_s, kernels=(), copies=()):
  """The parts of ``harness.trace.Trace`` the readers use."""
  as_ns = lambda items: [(n, int(a * S), int(b * S)) for n, a, b in items]
  return types.SimpleNamespace(start=int(start_s * S), end=int(end_s * S),
                               window_s=end_s - start_s,
                               kernels=as_ns(kernels), copies=as_ns(copies))


def _job(wall_s, spans, **counts):
  return {"wall_s": wall_s, "spans": spans, **counts}


@pytest.fixture
def ctx():
  """Two jobs of 4 s and 6 s, 20 inits, on a 10 s window with the device
  busy over [1, 2] s and [6, 7] s."""
  jobs = [
      _job(4.0, [_span("wb2.wait_host", 1.5, 3.5, chunk=0, ordinal=0),
                 _span("wb2.wait_host", 3.5, 3.6, chunk=1, ordinal=1),
                 _span("wb2.write", 3.6, 4.0, config="a", format="zarr")],
           read_s=0.5, prepare_s=2.0, pin_s=0.1, d2h_s=0.2, decode_s=0.0),
      _job(6.0, [_span("wb2.wait_host", 4.0, 5.5, chunk=0, ordinal=0),
                 _span("wb2.write", 9.0, 10.5, config="a", format="zarr")],
           read_s=1.5, prepare_s=3.0, pin_s=0.3, d2h_s=0.3, decode_s=0.0),
  ]
  return {"jobs": jobs, "inits": 20, "window_s": 10.0,
          "trace": _trace(0.0, 10.0, kernels=[("k", 1.0, 2.0)],
                          copies=[("Memcpy HtoD", 6.0, 7.0)]),
          "decodes": (0, 0.0), "peak_bytes": 0, "step_bytes": 0}


def _read(name, ctx):
  # pylint: disable-next=protected-access
  return run._read_metric({"name": name}, ctx)


def test_the_readers_known_answers(ctx):
  got = {name: _read(name, ctx) for name in NEW}
  want = {"read_ms_per_init": 1e3 * 2.0 / 20,
          "prep_ms_per_init": 1e3 * 5.0 / 20,
          "pin_ms_per_init": 1e3 * 0.4 / 20,
          # the waits of ordinal 0: 2.0 s + 1.5 s of 10 s of wall
          "fill_wait_share": 100 * 3.5 / 10,
          "d2h_share": 100 * 0.5 / 10,
          "write_share": 100 * (0.4 + 1.5) / 10,
          # idle 8 s; waiting and idle: [2, 3.6] and [4, 5.5] = 3.1 s
          "idle_in_wait_share": 100 * 3.1 / 8}
  assert got == pytest.approx(want)


def test_idle_in_wait_share_of_two_device_intervals_and_one_wait(ctx):
  ctx["jobs"] = [_job(10.0, [_span("wb2.wait_host", 1.5, 5.5, ordinal=0)])]
  # idle 8 s of the window; waiting over it from 2 s to 5.5 s
  assert _read("idle_in_wait_share", ctx) == pytest.approx(100 * 3.5 / 8)


def test_idle_in_wait_share_clips_waits_to_the_window(ctx):
  ctx["jobs"] = [_job(10.0, [_span("wb2.wait_host", -3.0, 0.5),
                             _span("wb2.wait_host", 9.5, 12.0)])]
  assert _read("idle_in_wait_share", ctx) == pytest.approx(100 * 1.0 / 8)
  ctx["jobs"] = [_job(10.0, [_span("wb2.wait_host", 11.0, 12.0)])]
  assert _read("idle_in_wait_share", ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_from_a_program_without_spans_or_counters(ctx, name):
  """A program that keeps neither (the parent of these metrics) reads as
  missing, without raising."""
  ctx["jobs"] = [{"wall_s": 4.0, "read_bytes": 1, "wait_host_s": 1.0}]
  assert _read(name, ctx) is None


def test_every_new_entry_has_its_reader_and_cells():
  bench = json.loads((ROOT / "BENCHMARK.json").read_text())
  forms = {}
  for m in bench["per_layer"]:
    base, form = m["name"].split(".")
    if base in NEW:
      forms.setdefault(base, set()).add((form, tuple(m["workloads"])))
  want = {"det": ("det15-raw",), "ens": ("ens15-raw",), "lz4": ("det15-lz4",)}
  # the zstd cell reads two of them: its reads and its fill
  zstd3 = {("zstd3", ("det15-zstd3",))}
  assert forms["read_ms_per_init"] == set(want.items()) | zstd3
  for base in NEW[1:]:
    assert forms[base] == {("det", want["det"]), ("ens", want["ens"])} | (
        zstd3 if base == "fill_wait_share" else set())


@pytest.mark.card
def test_every_span_of_a_traced_run_on_the_card(card, tmp_path):
  """Four chunks a job on the card: the main thread waits for the device
  (``wb2.wait_device``) as well, and every new metric reads a number."""
  cell = tiny_cell("det15-raw", inits=8)
  cell.traffic["input_chunks"] = "init_time=2"
  captured = []
  job_run = cell.job.run

  def keep(*args, **kwargs):
    captured.append(job_run(*args, **kwargs))
    return captured[-1]

  cell.job.run = keep
  line, _ = run.run_cell(cell, 2**31 + 5, 0.0, True, device=card,
                         scratch=str(tmp_path))
  assert line["correct"] is True, line["checks"]
  spans = [s for stats in captured for s in stats.get("spans", ())]
  assert {s["name"] for s in spans} == {
      "wb2.job", "wb2.open", "wb2.prepare", "wb2.wait_host",
      "wb2.chunk_program", "wb2.wait_device", "wb2.d2h", "wb2.finalize",
      "wb2.write"}
  for name in NEW:
    assert f"{name}.det" in line["metrics"], name
