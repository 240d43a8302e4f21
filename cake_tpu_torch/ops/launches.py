"""Launch counts of the port's kernels, eager and replayed from CUDA graphs.

Each kernel wrapper keeps its counters as attributes of its function:
``launches`` (its kernel ran) and side counts such as
``fused_norm_matmul.unfused`` (calls left to the unfused composition). The
wrappers add to them through :func:`count`, at the place where they launch.

A decode chunk on the card runs as a captured CUDA graph
(models/llama/fused.py). A capture launches nothing: it records the kernels,
and every replay runs them again. So while a graph is being prepared (its
warm-up run and its capture, each inside :func:`diverted`) the wrappers'
counts go to a record of that graph instead of their counters, and each
replay adds the capture's record to the counters (:func:`replayed`). A
counter therefore says how many times its kernel ran, eagerly or in a
replay. The one warm-up run a graph makes before its capture is not
counted.
"""

from __future__ import annotations

import collections
import contextlib
import threading

_local = threading.local()


def count(fn, what: str = "launches") -> None:
    """One more ``what`` of wrapper ``fn``: added to ``fn.<what>``, or to
    the record of the graph this thread is preparing."""
    record = getattr(_local, "record", None)
    if record is not None:
        record[(fn, what)] += 1
    else:
        setattr(fn, what, getattr(fn, what) + 1)


@contextlib.contextmanager
def diverted():
    """Tally this thread's counts into a Counter of their own, keyed by
    (wrapper, counter name), instead of the wrappers' counters."""
    outer = getattr(_local, "record", None)
    record = _local.record = collections.Counter()
    try:
        yield record
    finally:
        _local.record = outer


def replayed(record) -> None:
    """Add a capture's record to the wrappers' counters: one replay ran
    every kernel the capture recorded."""
    for (fn, what), n in record.items():
        setattr(fn, what, getattr(fn, what) + n)

