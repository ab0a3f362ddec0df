"""write_direct_share reads the program's direct-write counter against the
bytes its Zarr chunks encoded, and nothing from a program that lacks it."""
import pytest

import run


def _job(direct_bytes, encode_bytes, counted=True):
  stats = {"wall_s": 1.0, "encode_bytes": encode_bytes, "encode_s": 0.5}
  if counted:
    stats["write_direct_bytes"] = direct_bytes
  return stats


def _read(jobs):
  # pylint: disable-next=protected-access
  return run._read_metric({"name": "write_direct_share.spatial"},
                          {"jobs": jobs})


def test_write_direct_share_is_100_when_every_byte_went_direct():
  assert _read([_job(500, 500), _job(700, 700)]) == 100.0


def test_write_direct_share_of_a_mixed_window():
  assert _read([_job(300, 300), _job(100, 500)]) == pytest.approx(
      100 * 400 / 800)


@pytest.mark.parametrize("jobs", [[_job(0, 300, counted=False)], [],
                                  [_job(0, 0)]])
def test_write_direct_share_reads_nothing_without_counts(jobs):
  assert _read(jobs) is None
