"""Reduces a ``torch.profiler`` trace of the measured window to intervals.

The harness marks its own spans with ``record_function``: the window
(``portbench.window``) and each job (``portbench.job``).  Device events
(kernels, memory copies and sets) are kept as intervals in the window;
host (CPU) operations only to say what the host was doing in the device's
longest idle gaps.  The profiler records the main thread only: the
program's own ``wb2.*`` spans, the prefetch threads' among them, reach the
metrics through each job's ``stats["spans"]``, and those of the main thread
also appear here as host operations.
"""
from __future__ import annotations

import collections

import numpy as np

WINDOW = "portbench.window"
JOB = "portbench.job"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def _ns(event, which):
  fn = getattr(event, f"{which}_ns", None)
  if fn is not None:
    return int(fn())
  return int(getattr(event, f"{which}_us")() * 1000)


def union_seconds(intervals) -> float:
  """Length of the union of (start_ns, end_ns) intervals, in seconds."""
  total, end = 0, None
  for s, e in sorted(intervals):
    if end is None or s > end:
      total += e - s
      end = e
    elif e > end:
      total += e - end
      end = e
  return total / 1e9


class Trace:
  """Device intervals and host operations inside the window's span."""

  def __init__(self, prof):
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW
           and str(e.device_type()).endswith("CPU")]
    if not win:
      raise RuntimeError(f"the trace holds no {WINDOW} span")
    self.start = _ns(win[0], "start")
    self.end = _ns(win[0], "end")
    self.kernels, self.copies, host = [], [], []
    for e in events:
      start, end = _ns(e, "start"), _ns(e, "end")
      if end <= self.start or start >= self.end:
        continue
      start, end = max(start, self.start), min(end, self.end)
      kind = str(e.device_type())
      if e.name() in (WINDOW, JOB):
        continue  # the harness's own spans, mirrored on the device too
      if kind.endswith("CUDA"):
        item = (e.name(), start, end)
        (self.copies if e.name().startswith(COPY_PREFIXES)
         else self.kernels).append(item)
      elif kind.endswith("CPU"):
        host.append((start, end, e.name()))
    self.host = host

  @property
  def window_s(self) -> float:
    return (self.end - self.start) / 1e9

  def busy_s(self) -> float:
    """Seconds in which a kernel, copy or set ran on the device."""
    return union_seconds([(s, e) for _, s, e in self.kernels + self.copies])

  def kernel_union_s(self) -> float:
    return union_seconds([(s, e) for _, s, e in self.kernels])

  def device_ops(self, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    by_name = collections.Counter()
    for name, s, e in self.kernels + self.copies:
      by_name[name[:120]] += (e - s) / 1e9
    return [[n, t] for n, t in by_name.most_common(top)]

  def idle_gaps(self, top: int = 10) -> list:
    """[label, seconds] of the longest idle gaps of the device, labelled by
    the innermost host operation at the gap's middle."""
    spans = sorted((s, e) for _, s, e in self.kernels + self.copies)
    gaps, at = [], self.start
    for s, e in spans:
      if s > at:
        gaps.append((s - at, at, s))
      at = max(at, e)
    if self.end > at:
      gaps.append((self.end - at, at, self.end))
    gaps.sort(reverse=True)
    if self.host:
      starts = np.asarray([h[0] for h in self.host], np.int64)
      ends = np.asarray([h[1] for h in self.host], np.int64)
    out = []
    for length, s, e in gaps[:top]:
      mid = (s + e) // 2
      label = "host: no torch operation"
      if self.host:
        covering = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(covering):
          label = "host: " + self.host[covering[np.argmax(
              starts[covering])]][2][:100]
      out.append([label, length / 1e9])
    return out
