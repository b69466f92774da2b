"""Ray-count profiling (counterpart of `utils/profile.py`), and the spans
and counters a render records while tracing is on.

The renderer keeps one [5] counter vector in this slot order on the device
and converts it to a `Profile` after a host fetch.

Tracing is off unless a caller turns it on for a stretch of its own code:

    with profile.tracing() as rec:
        film, prof, _ = render_regen(world, camera, settings, w, h, spp)
        torch.cuda.synchronize()
    rec.resolve()
    rec.spans, rec.total("lanes_live")

Off, `span(name)` returns one shared no-op object and `count` returns at
once: no allocation, no device op, no host sync. On, a span records its
name, start and end on the `time.perf_counter_ns` clock, its parent's
index and the index of the `render` span it falls under; a count records a
host number or a device tensor, which `Recorder.resolve` turns into Python
numbers once the device is done. The recorder is the process's, for one
thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

N_COUNTERS = 5
CAMERA_RAYS, BOUNCE_RAYS, SHADOW_RAYS, LIGHT_RAYS, ENV_HITS = range(N_COUNTERS)


@dataclasses.dataclass
class Profile:
    camera_rays: int = 0
    bounce_rays: int = 0
    shadow_rays: int = 0
    light_rays: int = 0
    env_hits: int = 0

    def add_device_counts(self, counts):
        c = [int(round(float(x))) for x in counts]
        self.camera_rays += c[CAMERA_RAYS]
        self.bounce_rays += c[BOUNCE_RAYS]
        self.shadow_rays += c[SHADOW_RAYS]
        self.light_rays += c[LIGHT_RAYS]
        self.env_hits += c[ENV_HITS]
        return self

    @property
    def total_rays(self):
        return self.camera_rays + self.bounce_rays + self.shadow_rays + self.light_rays


# ------------------------------------------------------------ tracing

_RECORDER = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


@dataclasses.dataclass
class Span:
    """One recorded span: `parent` is the index of the enclosing span in
    `Recorder.spans` (None at the top), `render` the index of the `render`
    span it falls under (its own for a `render` span; None outside any)."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    render: int | None


class _OpenSpan:
    __slots__ = ("rec", "name", "index")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.index = self.rec._open(self.name)

    def __exit__(self, *exc):
        self.rec._close(self.index)
        return False


class Recorder:
    """The spans and counts of one `tracing()` stretch. `counts` holds
    [name, value, render index]; a value is a host number, a list of them,
    or a device tensor until `resolve()`."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counts: list = []
        self._stack: list[int] = []

    def _open(self, name):
        i = len(self.spans)
        parent = self._stack[-1] if self._stack else None
        render = i if name == "render" else (
            None if parent is None else self.spans[parent].render)
        self.spans.append(Span(name, time.perf_counter_ns(), None, parent,
                               render))
        self._stack.append(i)
        return i

    def _close(self, i):
        self.spans[i].end_ns = time.perf_counter_ns()
        self._stack.pop()

    def count(self, name, value):
        top = self.spans[self._stack[-1]].render if self._stack else None
        self.counts.append([name, value, top])

    def resolve(self):
        """Turn every device tensor among the counts into Python numbers (a
        number for a one-element tensor, else a list), with one copy to the
        host. Call it after the device has finished the recorded work."""
        import torch

        held = [c for c in self.counts if isinstance(c[1], torch.Tensor)]
        if not held:
            return self
        flat = torch.cat([c[1].detach().reshape(-1).to("cpu", torch.float64)
                          for c in held]).tolist()
        k = 0
        for c in held:
            n = c[1].numel()
            c[1] = flat[k] if c[1].dim() == 0 else flat[k:k + n]
            k += n
        return self

    def values(self, name) -> list:
        """Every resolved number counted under `name`, in order."""
        out = []
        for n, v, _ in self.counts:
            if n == name:
                out += v if isinstance(v, list) else [v]
        return out

    def total(self, name):
        return sum(self.values(name))


@contextlib.contextmanager
def tracing():
    """Install a Recorder for the stretch of the `with` block and yield
    it. Nested `tracing()` is refused."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("tracing is already on")
    rec = _RECORDER = Recorder()
    try:
        yield rec
    finally:
        _RECORDER = None


def recorder():
    """The installed Recorder, or None when tracing is off."""
    return _RECORDER


def span(name: str):
    """A context manager that records a span named `name` while tracing is
    on; off, the shared no-op NO_SPAN."""
    rec = _RECORDER
    if rec is None:
        return NO_SPAN
    return _OpenSpan(rec, name)


def count(name: str, value):
    """Record `value` (a host number, a list of them, or a device tensor)
    under `name` while tracing is on."""
    rec = _RECORDER
    if rec is not None:
        rec.count(name, value)
