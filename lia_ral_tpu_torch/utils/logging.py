"""Observability: tiered logging (port of lia_ral_tpu/utils/logging.py).

The reference has only the verbose/verboseLevel/debug globals
(liatools.h:83-85, SURVEY.md §5 "Tracing/profiling: none").  This is a
structured logger honouring the same config keys, and a wall-clock
timing block.  The JAX package's ``profile_trace`` and ``annotate`` wrap
``jax.profiler`` and have no counterpart here: ``torch.profiler`` traces
the port directly.
"""

from __future__ import annotations

import contextlib
import logging
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
