"""Spans and counters of the port: where a step's time and work go, layer by
layer, on the clock of ``torch.profiler``'s trace.

Spans.  ``with obs.span(name):`` marks a layer's work.  Off, the default, it
reads one flag and returns one shared no-op context: no allocation, no CUDA
event, no ``record_function``, no device operation.  Recording is on while a
``torch.profiler`` profile records (PyTorch's own flag for this check,
``torch.autograd.profiler._is_profiler_enabled``) and inside
:func:`recording`.  A recorded span keeps its name, its parent (the span
open on its thread; on a thread with none open, such as autograd's device
thread during ``backward()``, the span open on the thread that holds the
root), the step it belongs to (the root's ``step``, ``Trainer.global_step``)
and its host start and end from ``time.time_ns()``: the epoch clock of the
profiler's chrome trace once its ``baseTimeNanoseconds`` is added.  On a
card it also records a pair of CUDA events on the current stream, whose
interval is the device time the stream spent on the span's work, and it
enters ``torch.profiler.record_function(name)``, so an exported trace shows
it.  A span opened with none open is a root: the first root after spans
were off starts a new recording (the buffer is cleared), and while a root is
open on a card the sync debug mode is "warn", each synchronising call it
reports counted as ``host_sync.implicit`` (the warning is not printed) and
the mode put back when the root ends.  At most :data:`MAX_SPANS` spans are
kept a recording; the rest are counted as dropped.

Counters.  :func:`count` adds to a host int in :data:`COUNTERS`, always, and
:func:`count_later` keeps a device tensor (while recording only) whose
elements are summed when read, so counting launches nothing inside a step.
The port's counters: ``launches.<symbol>`` (``ops/_cuda.py``), ``host_sync``
and ``host_sync.implicit``, ``march.slots`` and ``march.samples`` (a train
step's march, the main pass's under the indirect render),
``march.pack.rows``, ``march.pack.slots`` and ``march.pack.dense`` (a
training render's packing, ``render/scene.py``), ``cp_rows.*``
(``ops/cp_rows.py``), ``indirect.rays``, ``indirect.ref_rays``,
``indirect.geometry.samples``, ``indirect.reflect.slots`` and
``indirect.reflect.samples`` (``render/indirect.py``), and ``renv.samples``
and ``renv.open`` (the renv branch, ``models/network.py``).  Each root
span keeps what the counters gained while it was open; :func:`snapshot`
synchronises once and returns the spans with their device milliseconds and
the counters summed over the roots.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 16
SYNC_WARNING = "called a synchronizing CUDA operation"   # the sync debug mode's text
COUNTERS: Dict[str, int] = {}        # host counters, always on

_explicit = 0          # depth of open recording() blocks
_stale = True          # spans were off since the last recording: a new root starts one
_rec: Optional["_Recording"] = None
_owner: Optional[list] = None       # the stack of the thread that holds the open root
_tls = threading.local()


@dataclasses.dataclass
class SpanRecord:
    """One recorded span; ``parent`` and ``root`` index ``Snapshot.spans``."""

    name: str
    parent: Optional[int]
    root: int
    depth: int
    step: Optional[int]
    thread: int
    t0_ns: int
    t1_ns: Optional[int] = None              # None while open
    device_ms: Optional[float] = None        # None without a card
    self_device_ms: Optional[float] = None   # device_ms less its children's
    counters: Optional[Dict[str, float]] = None   # a root's: what it counted
    tag: object = None                       # what the caller gave to tell like spans apart

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.t1_ns is None else (self.t1_ns - self.t0_ns) / 1e6


@dataclasses.dataclass
class Snapshot:
    """The last recording: its spans in the order opened, the counters over
    its root spans, and how many spans the cap dropped."""

    spans: List[SpanRecord]
    counters: Dict[str, float]
    dropped: int = 0

    def path(self, i: int) -> Tuple[str, ...]:
        """The names from span ``i``'s root down to it."""
        names = []
        while i is not None:
            names.append(self.spans[i].name)
            i = self.spans[i].parent
        return tuple(reversed(names))

    def roots(self, name: str) -> List[int]:
        """Indices of the closed root spans called ``name``."""
        return [i for i, s in enumerate(self.spans)
                if s.parent is None and s.name == name and s.t1_ns is not None]


class _Recording:
    def __init__(self):
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.spans: List[SpanRecord] = []
        self.events: Dict[int, tuple] = {}     # span index -> (start, end) CUDA events
        self.later: List[tuple] = []           # (name, tensor, scale, root index)
        self.dropped = 0
        self.snap: Optional[Snapshot] = None


class _Off:
    """The shared context of a span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _on_warning(show, message, category, filename, lineno, file=None, line=None):
    if SYNC_WARNING in str(message):
        if not getattr(_tls, "explicit", False):
            count("host_sync.implicit")
        return
    show(message, category, filename, lineno, file, line)


class _Span:
    __slots__ = ("name", "step", "tag", "index", "stack", "rf", "root_state")

    def __init__(self, name: str, step: Optional[int], tag):
        self.name, self.step, self.tag = name, step, tag
        self.index = None

    def __enter__(self):
        global _rec, _stale, _owner
        stack = _stack()
        if stack:
            parent = stack[-1]
        elif _owner and _owner is not stack:       # autograd's thread, in backward()
            parent = _owner[-1]
        else:
            parent = None
        if parent is None and (_stale or _rec is None):
            _rec, _stale = _Recording(), False
        rec = _rec
        if len(rec.spans) >= MAX_SPANS:
            rec.dropped += 1
            return self
        rec.snap = None
        i = self.index = len(rec.spans)
        up = rec.spans[parent] if parent is not None else None
        rec.spans.append(SpanRecord(
            self.name, parent, i if up is None else up.root, 0 if up is None else up.depth + 1,
            self.step if up is None or self.step is not None else up.step,
            threading.get_ident(), 0, tag=self.tag))
        stack.append(i)
        self.stack = stack
        self.root_state = None
        if up is None:
            _owner = stack
            self.root_state = self._enter_root(rec)
        if rec.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            rec.events[i] = (start, end)
            start.record()
        rec.spans[i].t0_ns = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    @staticmethod
    def _enter_root(rec: _Recording):
        caught = warnings.catch_warnings()
        caught.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        show = warnings.showwarning
        warnings.showwarning = (lambda *a, **k: _on_warning(show, *a, **k))
        mode = None
        if rec.cuda:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return caught, mode, dict(COUNTERS)

    def __exit__(self, *exc):
        global _owner
        i = self.index
        if i is None:
            return False
        rec = _rec
        self.rf.__exit__(*exc)
        rec.spans[i].t1_ns = time.time_ns()
        if i in rec.events:
            rec.events[i][1].record()
        self.stack.pop()
        if self.root_state is not None:
            caught, mode, before = self.root_state
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            caught.__exit__(None, None, None)
            rec.spans[i].counters = {k: v - before.get(k, 0) for k, v in COUNTERS.items()
                                     if v != before.get(k, 0)}
            _owner = None
        return False


def span(name: str, step: Optional[int] = None, tag=None):
    """A context marking one layer's work as ``name``; ``step`` names the
    step a root belongs to (its children take their root's); ``tag`` is kept
    with the span to tell spans of one name apart (a table's size)."""
    global _stale
    if not (_explicit or _profiler._is_profiler_enabled):
        _stale = True
        return _OFF
    return _Span(name, step, tag)


@contextlib.contextmanager
def recording():
    """Record spans inside the block whether or not a profiler runs; the
    block starts a new recording."""
    global _explicit, _rec, _stale
    if _owner is None:           # not inside a root: a new recording
        _rec, _stale = _Recording(), False
    _explicit += 1
    try:
        yield
    finally:
        _explicit -= 1
        _stale = True


def count(name: str, n: int = 1):
    """Add ``n`` to the host counter ``name`` (always on)."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def count_later(name: str, t: torch.Tensor, scale: float = 1.0):
    """While recording, count ``scale`` times the sum of the device tensor
    ``t`` (a scalar, or a per-ray count or mask), summed when :func:`snapshot`
    reads it, in the open root's counters."""
    rec = _rec
    if _owner is None or rec is None or not (_explicit or _profiler._is_profiler_enabled):
        return
    rec.snap = None
    rec.later.append((name, t.detach(), scale, _owner[0]))


@contextlib.contextmanager
def host_sync():
    """A blocking read the program makes on purpose: counted as ``host_sync``,
    and not again as ``host_sync.implicit``."""
    count("host_sync")
    _tls.explicit = True
    try:
        yield
    finally:
        _tls.explicit = False


def snapshot() -> Snapshot:
    """The last recording's spans with their device ms (one synchronisation)
    and the counters summed over its closed root spans; empty if nothing was
    recorded."""
    rec = _rec
    if rec is None:
        return Snapshot([], {})
    if rec.snap is not None:
        return rec.snap
    if rec.cuda and rec.events:
        torch.cuda.synchronize()
    spans = [dataclasses.replace(s, counters=None if s.counters is None else dict(s.counters))
             for s in rec.spans]
    for i, (start, end) in rec.events.items():
        if spans[i].t1_ns is not None:
            spans[i].device_ms = start.elapsed_time(end)
    child_ms: Dict[int, float] = {}
    for s in spans:
        if s.parent is not None and s.device_ms is not None:
            child_ms[s.parent] = child_ms.get(s.parent, 0.0) + s.device_ms
    for i, s in enumerate(spans):
        if s.device_ms is not None:
            s.self_device_ms = s.device_ms - child_ms.get(i, 0.0)
    for name, t, scale, root in rec.later:
        c = spans[root].counters
        if c is not None:
            c[name] = c.get(name, 0.0) + float(t.sum()) * scale
    total: Dict[str, float] = {}
    for s in spans:
        if s.parent is None and s.counters:
            for k, v in s.counters.items():
                total[k] = total.get(k, 0) + v
    rec.snap = Snapshot(spans, total, rec.dropped)
    return rec.snap
