"""``det025-raw``, the official deterministic command at 0.25 degrees in
lead slices of 10, at a tiny size on the CPU: the harness's run is correct;
it is not when one lead slice's results are shifted or left out; the
reader of ``lead_refill_share`` on synthetic jobs; and, on a card, the
cell at its real size traced."""
import pytest

import run
from conftest import tiny_cell

SEED = 2**33 + 17


def _tiny():
  """36x19, 5 leads, 2 inits in chunks of one init and 2 leads: three
  lead slices (2, 2, 1), as the cell's 21 leads stream in 10, 10, 1."""
  cell = tiny_cell("det025-raw", inits=2)
  # tiny_cell keeps the chunks' inits only: put the lead slices back
  cell.traffic["input_chunks"] = "init_time=1,lead_time=2"
  return cell


def _lead_slice_fault(monkeypatch, fault):
  """The second lead slice's results left out, or replaced by the first's
  under its own labels (a slice that read the leads of another)."""
  from weatherbench2_torch.parallel import streaming

  stream, finalize = streaming._stream_lead_slice, streaming._finalize
  now = {}

  def streamed(plan, lead_i, *args):
    now["lead"] = lead_i
    return stream(plan, lead_i, *args)

  def finalized(*args):
    out = finalize(*args)
    if now["lead"] == 0:
      now["first"] = out
    elif now["lead"] == 1 and fault == "left_out":
      out = {c: ds.isel(lead_time=slice(0, 0)) for c, ds in out.items()}
    elif now["lead"] == 1:
      out = {c: now["first"][c].assign_coords(
          lead_time=ds.coords_dict()["lead_time"]) for c, ds in out.items()}
    return out

  monkeypatch.setattr(streaming, "_stream_lead_slice", streamed)
  monkeypatch.setattr(streaming, "_finalize", finalized)


def test_tiny_cell_is_correct(tmp_path):
  captured = []
  cell = _tiny()
  job_run = cell.job.run

  def keep(*args, **kwargs):
    captured.append(job_run(*args, **kwargs))
    return captured[-1]

  cell.job.run = keep
  line, notes = run.run_cell(cell, SEED, 0.0, False, device="cpu",
                             scratch=str(tmp_path))
  assert line["correct"] is True, (line["checks"], notes)
  assert notes["compared"] > 0
  # the warm-up job and one timed job, three slices each
  assert [s["lead_slices"] for s in captured] == [3, 3]
  assert all(s["lead_refill_s"] > 0 for s in captured)


@pytest.mark.parametrize("fault", ["left_out", "shifted"])
def test_a_lead_slice_at_fault_is_not_correct(monkeypatch, tmp_path, fault):
  _lead_slice_fault(monkeypatch, fault)
  line, notes = run.run_cell(_tiny(), SEED, 0.0, False, device="cpu",
                             scratch=str(tmp_path))
  assert line["failed"] == 0, notes  # caught by the comparison, not a crash
  assert line["correct"] is False, (line["checks"], notes)


def _read(ctx):
  # pylint: disable-next=protected-access
  return run._read_metric({"name": "lead_refill_share.det025"}, ctx)


def test_lead_refill_share_known_answers():
  jobs = [{"wall_s": 4.0, "lead_refill_s": 0.5, "wait_host_s": 2.0},
          {"wall_s": 6.0, "lead_refill_s": 1.5, "wait_host_s": 3.0}]
  assert _read({"jobs": jobs}) == pytest.approx(100 * 2.0 / 10)
  # one slice a job: counted, and 0
  assert _read({"jobs": [{"wall_s": 4.0, "lead_refill_s": 0.0}]}) == 0.0


def test_lead_refill_share_of_a_program_without_the_counter():
  """A program that does not count it (the parent of this metric) reads as
  missing, without raising."""
  assert _read({"jobs": [{"wall_s": 4.0, "wait_host_s": 1.0}]}) is None
  assert _read({"jobs": []}) is None


@pytest.mark.card
def test_the_cell_traced_on_the_card(card, tmp_path):
  """The cell at 1440x721: correct, three ``wb2.lead_slice`` spans a job,
  and every ``.det025`` metric read."""
  cell = run.Cell("det025-raw")
  captured = []
  job_run = cell.job.run

  def keep(*args, **kwargs):
    captured.append(job_run(*args, **kwargs))
    return captured[-1]

  cell.job.run = keep
  line, _ = run.run_cell(cell, 2**31 + 25, 0.0, True, device=card,
                         scratch=str(tmp_path))
  assert line["correct"] is True, line["checks"]
  assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
  assert line["metrics"]["lead_refill_share.det025"]["value"] > 0
  for stats in captured[1:]:  # the timed jobs, traced
    slices = [s for s in stats["spans"] if s["name"] == "wb2.lead_slice"]
    assert [(s["lead"], s["leads"]) for s in slices] == [
        (0, 10), (1, 10), (2, 1)]
