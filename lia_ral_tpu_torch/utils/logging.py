"""Observability: tiered logging (port of lia_ral_tpu/utils/logging.py).

The reference has only the verbose/verboseLevel/debug globals
(liatools.h:83-85, SURVEY.md §5 "Tracing/profiling: none").  This is a
structured logger honouring the same config keys, and ``torch.profiler``
in the place of the JAX package's ``jax.profiler``: ``profile_trace``
writes a trace of a block, ``span`` names a range inside it and ``count``
adds to one of the program's ``counters``.

Spans and counters are on only while a profiler records.  A span is then
a ``record_function`` range, so it lands in the profiler's trace beside
the launches and device operations it encloses, on their clock, and the
profiler's correlation ties each kernel and copy to the span open on its
launching thread; parenthood is nesting on a thread.  With no profiler a
span is one flag check and a shared no-op context (``record_function``
itself costs microseconds even then), and ``count`` returns at once.
Every program span and counter name starts with ``lia.``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading

import torch
from torch.autograd import profiler as _profiler

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


# what the program counts while a profiler records (see ``count``)
counters = {name: 0 for name in (
    "lia.stats.batches",        # padded batches of fa.stats.bw_stats_bucketed
    "lia.stats.frames_sent",    # their frames, padding included (rows x len)
    "lia.stats.frames_carried",  # their utterances' own frames
    "lia.stats.h2d_bytes",      # bytes of their packed staging slots sent
                                # (own frames x (D + 1) x 4, and row offsets)
    "lia.stats.pinned_batches",  # batches sent from page-locked host memory
    "lia.stats.slot_waits",     # packs that waited for their slot's last copy
    "lia.tv.blocks",            # solve blocks of fa.tv.estimate_w
    "lia.tv.pcg_iters",         # PCG iterations run, summed over blocks
    "lia.tv.host_syncs",        # host reads of a device value in estimate_w
    "lia.tv.e_chunks",          # session chunks of fa.tv.tv_e_step
    "lia.tv.e_sessions",        # their real sessions
    "lia.tv.e_pad_sessions",    # zero-occupancy sessions that pad its last
                                # chunk
    "lia.seg.decodes",          # decodes of seg.diarization's E-HMM and
                                # ReSegmentation (emissions, then Viterbi)
    "lia.seg.viterbi_frames",   # their frames, summed over decodes
    "lia.seg.viterbi_bp_rows",  # back pointer rows the Viterbi kernel
                                # derives: N - 1 a decode on the card
    "lia.seg.viterbi_tail_rows",  # of those, the rows not yet derived when
                                # its forward's last step was stored
    "lia.seg.state_adapts",     # state rows MAP-adapted: the rows of the
                                # (S, N) masks of each batched adaptation
    "lia.seg.empty_adapts",     # of those, rows adapted on an all-zero mask
    "lia.seg.grouped_launches",  # grouped stats passes of those adaptations
                                # (one K1 launch each on the card; none where
                                # no row has a frame): nb_it an adaptation
    "lia.seg.grouped_frames",   # frames of non-zero mask they take, padding
                                # excluded, summed over passes
    "lia.seg.grouped_pad_frames",  # frames of weight 0 that align the rows
                                # to the kernel's 256-frame unit, likewise
    "lia.seg.h2d_bytes",        # bytes they hand the device: host frames,
                                # (S, N) masks, transitions and activity rows,
                                # and on a card each adaptation's row layout
    "lia.seg.d2h_bytes",        # bytes they read back: each path and, in the
                                # E-HMM, each (N, S) emission block
    "lia.svm.solves",           # C-SVC dual solves of backend.svm.svm_train
    "lia.svm.vectors",          # their training vectors N, summed over solves
    "lia.svm.q_entries",        # their Q entries N², summed over solves
    "lia.svm.dual_steps",       # FISTA steps times N², summed over solves
    "lia.svm.dual_step_vectors",  # FISTA steps times N, summed over solves
    "lia.svm.support",          # support vectors the models keep
    "lia.svm.h2d_bytes",        # bytes copied from the host to a card: y of
                                # each solve from host memory, the support
                                # rows and α·y of a host-held model (one
                                # loaded from a file) in each decision
    "lia.svm.d2h_bytes",        # bytes read from a card to the host: each
                                # solve's support count and bias (16), a
                                # card-held model's rows scoring host rows
                                # or read by SvmModel.host
    "lia.svm.host_syncs",       # blocking host reads in svm_train (one a
                                # solve, on any device), in decision and
                                # in SvmModel.host
)}
_counter_lock = threading.Lock()    # the shards of a mesh run in threads
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the profiler's trace around a ``with`` block; the
    shared no-op context while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def recording() -> bool:
    """Whether a profiler records (spans and counters are on): a guard
    for counts that cost work to compute."""
    return _profiler._is_profiler_enabled


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``counters[name]`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    with _counter_lock:
        counters[name] += int(n)


def reset_counters() -> None:
    """Zero every counter (as ``cuda_kernels.reset_launch_counts`` does
    its launches)."""
    for name in counters:
        counters[name] = 0


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the enclosed block with ``torch.profiler`` (host activity,
    and the card's kernels where CUDA is available) and write it to
    ``logdir/trace.json`` as a Chrome trace (Perfetto, chrome://tracing),
    and what the block added to ``counters`` to ``logdir/counters.json``.
    Yields the profiler, whose ``key_averages()`` sums time by name."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    before = dict(counters)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        with open(os.path.join(logdir, "counters.json"), "w") as f:
            json.dump({k: v - before[k] for k, v in counters.items()}, f,
                      indent=1)
