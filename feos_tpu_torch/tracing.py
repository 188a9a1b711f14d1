"""The port's one recorder of where a call spends its time: spans and counters.

Spans mark the layer boundaries of a call, from the entry point through the
solver down to the kernel wrapper.  Each is a :class:`Span` ``(id, parent,
root, name, t0_ns, t1_ns, rows)`` timed on ``time.time_ns()``, the clock of
``torch.profiler``'s events; ``root`` is the id of the outermost span open
when it began (the entry call), so every span of one call shares it.  The
names start with :data:`PREFIX`, then the layer:

* ``feos.entry.*``: ``vapor_pressure``, ``liquid_density``,
  ``equilibrium_liquid_density``, ``bubble_point``, ``dew_point``;
* ``feos.solver.*``: ``pure_vle``, ``npt_density``, ``mix_vle``,
  ``precompute_mix``;
* ``feos.kernel.*``: the wrappers of ``pure_vle``, ``vp_identity`` and
  ``phi_d2``, on the CPU path too;
* ``feos.setup.library``: building or loading the kernel library.

Loops are counted, not spanned.  Counters count work at the line that does
it:

* ``calls.<layer>.<name>``: each span opened; ``rows.entry.<name>``: the
  rows of each entry call;
* ``launch.<kernel>``: each kernel launch, and ``launch.phi_d2.k<k>`` those
  of ``phi_d2`` at ``k`` densities a row;
* ``sync.<site>``: each pass through a line of the solver and model code
  that makes the host wait for the card: a device-to-host read (a loop's
  stop test, once an iteration) or a copy from host memory to the card
  (a table of constants, a sign or a grid);
* ``<solver>.<key>``: the values a solver also puts in its ``stats`` dict
  (:func:`report` fills both from one line).

The ``pure_vle`` kernel counts its own phi evaluations a row; the recorder
keeps the newest launch's counts and reduces them only when read
(:meth:`Recorder.phi_evals_per_row`), so a step pays no sync for them.

The tracer records only while it is on: inside ``with record() as rec:``,
into ``rec``, and while a ``torch.profiler`` window records, into
:data:`profiled` (unless a ``record()`` is open).  While a profiler records,
each span is also a FUNCTION-scope event of its trace
(``_RecordFunctionFast``), on the profiler's own clock, never a USER-scope
``record_function``, which the profiler mirrors onto the device's timeline.
Off, a site costs one test of the open recorders and one
``_profiler_enabled()`` call: no object, no torch op, no sync.

Spans nest in the order one thread opens them; the port calls from one
thread.
"""

from __future__ import annotations

import functools
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import torch

PREFIX = "feos."
CAPACITY = 100_000  # spans a recorder keeps, the newest

_profiling = torch._C._autograd._profiler_enabled
_profiler_event = torch._C._profiler._RecordFunctionFast
_OFF = nullcontext()


class Span(NamedTuple):
    id: int
    parent: int | None  # the span open when this one began
    root: int           # the outermost open span's id (this one's if none)
    name: str
    t0_ns: int
    t1_ns: int
    rows: int | None


class Recorder:
    """Spans (the newest :data:`CAPACITY`, with a count of those dropped)
    and counters of what ran while it recorded."""

    def __init__(self):
        self.spans: deque[Span] = deque(maxlen=CAPACITY)
        self.dropped = 0
        self.counters: dict[str, int] = {}
        self._open: list[tuple[int, int]] = []  # (id, root) of the open spans
        self._ids = 0
        self._iters = None  # the newest pure_vle launch's (B, 3) counts

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def phi_evals_per_row(self) -> float | None:
        """The mean phi evaluations a row of the newest ``pure_vle`` kernel
        launch (its ``iters[:, 2]``), or None if none launched; reading it
        waits for that launch."""
        if self._iters is None or not len(self._iters):
            return None
        return int(self._iters[:, 2].sum()) / len(self._iters)


_recording: list[Recorder] = []  # the open record() recorders, innermost last
#: What the tracer records while a torch.profiler window records and no
#: :func:`record` is open.
profiled = Recorder()


def on() -> bool:
    """Whether the tracer records now."""
    return bool(_recording) or _profiling()


def _target() -> Recorder:
    return _recording[-1] if _recording else profiled


@contextmanager
def record():
    """Record every span and counter of the calls made inside: ``with
    record() as rec: ...``, then read ``rec.spans`` and ``rec.counters``."""
    rec = Recorder()
    _recording.append(rec)
    try:
        yield rec
    finally:
        _recording.remove(rec)


class _Span:
    __slots__ = ("rec", "name", "calls", "rows", "id", "parent", "root", "t0", "event")

    def __init__(self, rec: Recorder, name: str, calls: str, rows):
        self.rec, self.name, self.calls, self.rows = rec, name, calls, rows

    def __enter__(self):
        rec = self.rec
        rec._ids += 1
        self.id = rec._ids
        self.parent, self.root = rec._open[-1] if rec._open else (None, self.id)
        rec._open.append((self.id, self.root))
        rec.counters[self.calls] = rec.counters.get(self.calls, 0) + 1
        self.event = None
        self.t0 = time.time_ns()
        if _profiling():
            self.event = _profiler_event(self.name)
            self.event.__enter__()

    def __exit__(self, *exc):
        if self.event is not None:
            self.event.__exit__(*exc)
        t1 = time.time_ns()
        rec = self.rec
        rec._open.pop()
        if len(rec.spans) == rec.spans.maxlen:
            rec.dropped += 1
        # tuple.__new__ skips the named tuple's own __new__, a Python call
        rec.spans.append(tuple.__new__(Span, (self.id, self.parent, self.root, self.name,
                                              self.t0, t1, self.rows)))
        return False


def span(name: str):
    """A ``with`` block as the span ``feos.<name>`` while the tracer is on."""
    if not (_recording or _profiling()):
        return _OFF
    return _Span(_target(), PREFIX + name, "calls." + name, None)


def traced(layer: str, rows_arg: int = 0):
    """Decorator: each call made while the tracer is on is the span
    ``feos.<layer>.<function name>``, its rows the ``shape[0]`` of
    positional argument ``rows_arg``; an ``entry`` call also adds them to
    ``rows.entry.<name>``."""

    def wrap(fn):
        name = f"{layer}.{fn.__name__}"
        full, calls = PREFIX + name, "calls." + name
        rows_key = "rows." + name if layer == "entry" else None

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_recording or _profiling()):
                return fn(*args, **kwargs)
            x = args[rows_arg] if len(args) > rows_arg else None
            rows = int(x.shape[0]) if isinstance(x, torch.Tensor) and x.dim() else None
            rec = _target()
            if rows_key is not None and rows is not None:
                rec.count(rows_key, rows)
            with _Span(rec, full, calls, rows):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if _recording or _profiling():
        _target().count(name, n)


def launched(kernel: str, k: int | None = None, iters=None):
    """Count a launch of ``kernel`` (and, with ``k``, under ``k<k>``); keep
    ``pure_vle``'s ``iters`` for :meth:`Recorder.phi_evals_per_row`."""
    if _recording or _profiling():
        rec = _target()
        rec.count("launch." + kernel)
        if k is not None:
            rec.count(f"launch.{kernel}.k{k}")
        if iters is not None:
            rec._iters = iters


def report(stats: dict | None, site: str, **values):
    """A solver's per-call values into ``stats`` (if a dict) and, while the
    tracer is on, added to the counters ``<site>.<key>``: one line feeds
    both.  Call sites guard it with ``stats is not None or on()``."""
    if stats is not None:
        stats.update(values)
    if _recording or _profiling():
        rec = _target()
        for key, n in values.items():
            rec.count(f"{site}.{key}", n)
