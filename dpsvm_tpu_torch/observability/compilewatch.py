"""Capture and build accounting for the port's programs (the port of
``dpsvm_tpu/observability/compilewatch.py``).

On the TPU every chunk program is an XLA compile, and the JAX package
times each one. On the card the costs of the same kind are the CUDA-graph
captures of the chunk programs and the serving ladders, and the ``nvcc``
builds of the port's kernels; a program that launches a hand-written
kernel without a graph (kernel A's chunk, the decomposition's round)
pays its library load and first launch instead. Each of these is one
observation here:

* every capture through ``solver/smo.capture`` (the one helper every
  graph of the port is captured with) observes its program name, its
  seconds and the shapes it was captured at;
* every ``nvcc`` of ``build.build_all`` observes ``build:<library>``;
* ``instrument(fn, program, ...)`` observes the first call of a runner
  that launches a hand-written kernel without a graph (kernel A's chunk,
  the decomposition's round); a runner, like a graph, is made once a
  fit.

Observations queue in a process-wide log; the training driver (and the
shrinking manager, the cascade, the grid) ``drain()`` it into the run
trace as ``compile`` records at the next poll boundary, and the serving
pool drains it for its stray count. ``flops`` and ``bytes`` are work
counts per iteration where the program's work is known (kernel A's chunk,
kernel B in the decomposition's round, the counts ``chip_smoke.py``'s
bound column uses); every other program records null, and consumers print
"n/a". Stdlib only: the report and compare paths import this without
touching a device.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, List, Optional

_LOG: List[dict] = []
_LOCK = threading.Lock()


def shape_signature(*tensors) -> str:
    """The shapes and dtypes of ``tensors`` as one string, the signature a
    capture or a first launch is keyed and recorded under."""
    return str(tuple((tuple(getattr(t, "shape", ())),
                      str(getattr(t, "dtype", type(t).__name__)))
                     for t in tensors))


def observe(program: str, seconds: float, *,
            signature: Optional[str] = None,
            flops: Optional[float] = None,
            bytes: Optional[float] = None) -> None:
    """Append one observation."""
    with _LOCK:
        _LOG.append({"program": str(program),
                     "seconds": float(seconds),
                     "signature": signature,
                     "flops": None if flops is None else float(flops),
                     "bytes": None if bytes is None else float(bytes),
                     "wall": time.perf_counter()})


@contextlib.contextmanager
def observing(program: str, *, signature: Optional[str] = None,
              flops: Optional[float] = None,
              bytes: Optional[float] = None):
    """Observe the block's wall seconds as one program's capture or
    build (nothing is recorded when the block raises)."""
    t0 = time.perf_counter()
    yield
    observe(program, time.perf_counter() - t0, signature=signature,
            flops=flops, bytes=bytes)


def drain() -> List[dict]:
    """Take every pending observation (oldest first). A consumer with no
    trace still drains, so observations never leak into the next run."""
    with _LOCK:
        out, _LOG[:] = _LOG[:], []
    return out


def pending() -> int:
    with _LOCK:
        return len(_LOG)


def instrument(fn: Callable, program: str, *,
               signature: Optional[str] = None,
               flops: Optional[float] = None,
               bytes: Optional[float] = None) -> Callable:
    """Wrap a program's runner so that its first call is observed with
    that call's wall seconds (on the card: the library load, a build if
    one is due, and the first launch's enqueue; on the CPU, the plain
    version's first call). A runner is built once a fit, as a graph is
    captured once a fit, so every fit records its programs."""
    state = {"first": True}
    lock = threading.Lock()

    def wrapped(*args, **kwargs):
        with lock:
            first, state["first"] = state["first"], False
        if not first:
            return fn(*args, **kwargs)
        with observing(program, signature=signature, flops=flops,
                       bytes=bytes):
            return fn(*args, **kwargs)

    wrapped.__name__ = f"observed[{program}]"
    return wrapped
