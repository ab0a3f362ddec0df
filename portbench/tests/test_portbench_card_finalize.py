"""card_finalize_share reads the program's finalize counters against the
``wb2.d2h`` spans' bytes, and nothing from a program that lacks them."""
import pytest

import run


def _job(device_bytes, d2h_bytes, counted=True):
  stats = {"wall_s": 1.0,
           "spans": [{"name": "wb2.d2h", "start_ns": 0, "end_ns": 1,
                      "bytes": d2h_bytes},
                     {"name": "wb2.finalize", "start_ns": 1, "end_ns": 2}]}
  if counted:
    stats.update(finalize_device_bytes=device_bytes, finalize_host_merges=0)
  return stats


def _read(jobs):
  # pylint: disable-next=protected-access
  return run._read_metric({"name": "card_finalize_share.spatial"},
                          {"jobs": jobs})


def test_card_finalize_share_of_the_copied_bytes():
  assert _read([_job(300, 300), _job(100, 300)]) == pytest.approx(
      100 * 400 / 600)


@pytest.mark.parametrize("jobs", [[_job(0, 300, counted=False)], [],
                                  [_job(0, 0)]])
def test_card_finalize_share_reads_nothing_without_counts(jobs):
  assert _read(jobs) is None
