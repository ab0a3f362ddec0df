"""Spans of an evaluation call, kept while ``torch.profiler`` records the
calling thread, and the named counts of a run.

``evaluation.evaluate_with_mesh`` asks once, on its calling thread, whether
the profiler records that thread (``profiling()``); only then does its
``Spans`` keep what the chunk pipeline's sites record.  A span is one
record, a dict: ``name``; ``start_ns`` and ``end_ns`` in
``time.time_ns()``, the clock of the profiler's event stamps; ``thread``
(its name); ``id``; ``parent``, the id of the span that caused it (the
job's root span, or None for the root); ``job``, the root span's id;
``chunk`` where there is one; and the attributes its site gives.  The
records are handed over at the end of the call, in ``stats["spans"]``.

Every span also opens a profiler range of its name.  On the profiled
thread it lands among the trace's host operations; a prefetch thread's
lands there only when the profiler records every thread (started with
``experimental_config=torch._C._profiler._ExperimentalConfig(
profile_all_threads=True)``).  The range is a plain function scope, not a
user annotation: the profiler mirrors a user annotation on the device
timeline over the kernels launched inside it, which would read as device
work.  A ``Spans`` that keeps nothing yields a throwaway record and opens no
range, so that every site enters its span unconditionally.

``Counts`` are a run's numbers by name (bytes, events, seconds): the
evaluation engine's, a chunk's, a data-prep CLI's.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

# Span ids, unique in the process, so that the spans of several jobs merge.
_IDS = itertools.count(1)


def profiling() -> bool:
  """Whether ``torch.profiler`` records the calling thread."""
  # pylint: disable-next=protected-access
  return torch._C._autograd._profiler_enabled()


class Counts(dict):
  """Counts by name; a count that is added to or timed before it is set
  starts at 0."""

  @contextlib.contextmanager
  def timing(self, *keys: str):
    """Add the seconds of the ``with`` block to each of ``keys``."""
    t = time.perf_counter()
    try:
      yield
    finally:
      seconds = time.perf_counter() - t
      for key in keys:
        self[key] = self.get(key, 0.0) + seconds

  def add(self, other=(), **more) -> "Counts":
    """Add the counts of ``other`` (a mapping) and ``more`` to these."""
    for key, value in itertools.chain(dict(other).items(), more.items()):
      self[key] = self.get(key, 0) + value
    return self


class Spans:
  """The span records of one call, appended as the spans close, from any
  thread; ``keep=False`` keeps none."""

  def __init__(self, keep: bool = True):
    self.keep = keep
    self.records: list = []
    self.root = None  # the id of the job's root span

  @contextlib.contextmanager
  def span(self, name: str, chunk=None, root: bool = False, **attrs):
    """A span of ``name`` over the ``with`` block, yielding its record (a
    site may add attributes to it before the block ends).  ``root`` makes
    it the job's root: the parent of every later span of this object."""
    if not self.keep:
      yield dict(attrs)
      return
    rec = {"name": name, "id": next(_IDS),
           "parent": None if root else self.root,
           "thread": threading.current_thread().name}
    if root:
      self.root = rec["id"]
    rec["job"] = self.root
    if chunk is not None:
      rec["chunk"] = int(chunk)
    rec.update(attrs)
    # pylint: disable-next=protected-access
    with torch._C._profiler._RecordFunctionFast(name):
      rec["start_ns"] = time.time_ns()
      try:
        yield rec
      finally:
        rec["end_ns"] = time.time_ns()
        self.records.append(rec)
