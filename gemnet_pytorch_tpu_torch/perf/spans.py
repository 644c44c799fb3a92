"""The port's spans and counters: where its host time goes, from inside.

    from gemnet_pytorch_tpu_torch.perf import spans

    with spans.span("pad"):          # a span of this thread
        ...
    spans.count("pad.real_rows", n)  # a process-wide counter
    spans.records(), spans.counters()

A span records `Record(name, thread, start, end, parent, id)` into one
bounded in-memory store (`STORE_LEN` records, the oldest dropped first);
`start` and `end` are `time.perf_counter_ns()`, `parent` the name of the
span this thread had open, `id` what ties the spans of one batch or one
call together (given, or else the open span's, or else the thread's `tag`).

Spans record only while a `torch.profiler` records, in every thread: the
test is the profiler's process-wide flag. With it off a span costs that
one read and returns a shared null context. On the thread that started the
profiler each span is also a `record_function("gemnet.<name>")` range, so a
profile shows it on the device's clock; the profiler does not see ranges
of other threads (the provider's prefetch threads), which this store keeps.

Counters always count: they fire once per batch or per capture.
`timed(name)` is a span that always reads the clock, for a caller that
needs its seconds (`graphs.capture`).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler
from torch._C._autograd import _profiler_enabled as _profiling_here

# records the store keeps, the oldest dropped first
STORE_LEN = 100_000
# prefix of the profiler ranges of the profiling thread's spans
RANGE_PREFIX = "gemnet."


class Record(NamedTuple):
    name: str
    thread: int  # threading.get_ident() of the thread that ran it
    start: int  # time.perf_counter_ns()
    end: int
    parent: Optional[str]  # the name of the span open on the same thread
    id: Optional[int]


_store: collections.deque = collections.deque(maxlen=STORE_LEN)
_counters: dict = collections.defaultdict(float)
_lock = threading.Lock()  # of the store and the counters: threads record
_local = threading.local()  # .stack: the open spans; .id: the thread's tag


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "id", "record", "parent", "start", "end", "_range")

    def __init__(self, name: str, id: Optional[int], record: bool):
        self.name, self.id, self.record = name, id, record
        self.parent, self._range, self.end = None, None, None

    def __enter__(self):
        if self.record:
            stack = _stack()
            if stack:
                self.parent = stack[-1].name
                if self.id is None:
                    self.id = stack[-1].id
            elif self.id is None:
                self.id = getattr(_local, "id", None)
            stack.append(self)
            # the thread-local profiler state: set only on the profiling thread
            if _profiling_here():
                self._range = _profiler.record_function(RANGE_PREFIX + self.name)
                self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.record:
            if self._range is not None:
                self._range.__exit__(*exc)
            _stack().pop()
            record = Record(self.name, threading.get_ident(), self.start, self.end,
                            self.parent, self.id)
            with _lock:
                _store.append(record)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def span(name: str, id: Optional[int] = None):
    """A context manager that records span `name` while a profiler records
    (module docstring); else a shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, id, True)


def timed(name: str, id: Optional[int] = None) -> _Span:
    """`span(name, id)` that reads the clock whether or not it records:
    `.seconds` after the block."""
    return _Span(name, id, _profiler._is_profiler_enabled)


def tag(id: Optional[int]) -> None:
    """The id that this thread's spans without an id and without an open
    span take from now on (the batch it works on or has received)."""
    _local.id = id


def count(name: str, n: float = 1) -> None:
    """Add `n` to the process-wide counter `name`."""
    with _lock:
        _counters[name] += n


def records() -> list[Record]:
    """A copy of the store, oldest first."""
    with _lock:
        return list(_store)


def counters() -> dict[str, float]:
    """A copy of the counters."""
    with _lock:
        return dict(_counters)
