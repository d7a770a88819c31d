"""The Viterbi kernel's share of its roofline: the least time of the
pass's decodes (``flops_seg``'s operations over 989 TFLOP/s and bytes
over 3.35 TB/s, the larger; the bytes bind) over the device time of
every operation launched under the harness's span around each decode.
The kernel is bound by its dependent chain of N steps, so this reads far
under 1 % (PERF.md gives the chain's estimate beside it)."""

from benchmark import core


def read(ctx):
    return core.roofline_pct(ctx, "bench.viterbi")
