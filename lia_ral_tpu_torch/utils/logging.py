"""Observability: tiered logging (port of lia_ral_tpu/utils/logging.py).

The reference has only the verbose/verboseLevel/debug globals
(liatools.h:83-85, SURVEY.md §5 "Tracing/profiling: none").  This is a
structured logger honouring the same config keys, a wall-clock timing
block, and ``torch.profiler`` in the place of the JAX package's
``jax.profiler``: ``profile_trace`` writes a trace of a block, ``annotate``
names a span inside it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

_logger = logging.getLogger("lia_ral_tpu_torch")
_handler = logging.StreamHandler()
_handler.setFormatter(logging.Formatter(
    "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
_logger.addHandler(_handler)
_logger.setLevel(logging.WARNING)

# reference globals (liatools.h:83-85)
verbose: bool = False
verbose_level: int = 0
debug: bool = False


def configure_from(cfg) -> None:
    """Honour the reference config keys verbose/verboseLevel/debug."""
    global verbose, verbose_level, debug
    verbose = cfg.get_bool("verbose", False)
    verbose_level = cfg.get_int("verboseLevel", 1 if verbose else 0)
    debug = cfg.get_bool("debug", False)
    if debug:
        _logger.setLevel(logging.DEBUG)
    elif verbose:
        _logger.setLevel(logging.INFO)
    else:
        _logger.setLevel(logging.WARNING)


def get_logger(name: str | None = None) -> logging.Logger:
    return _logger if name is None else _logger.getChild(name)


@contextlib.contextmanager
def timed(label: str, level: int = 1):
    """Wall-clock timing block logged at the given verbose level."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if verbose_level >= level:
        _logger.info("%s: %.3fs", label, dt)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the enclosed block with ``torch.profiler`` (host activity,
    and the card's kernels where CUDA is available) and write it to
    ``logdir/trace.json`` as a Chrome trace (Perfetto, chrome://tracing).
    Yields the profiler, whose ``key_averages()`` sums time by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named span in the trace timeline: ``record_function`` for
    ``torch.profiler``, plus an NVTX range where CUDA is available."""
    import torch

    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
