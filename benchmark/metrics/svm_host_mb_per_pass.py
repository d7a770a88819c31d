"""Megabytes (10^6 B) a pass that the SVM back end moves between host and
card: the program's ``lia.svm.h2d_bytes`` (y and C of each solve, the
support vectors and α·y of each decision) and ``lia.svm.d2h_bytes`` (X,
α and the kernel matrix of each solve) counters in the profiled
sub-window, over its passes."""

from benchmark import program


def read(ctx):
    h2d = program.counter("lia.svm.h2d_bytes")
    d2h = program.counter("lia.svm.d2h_bytes")
    n = program.passes(ctx)
    if h2d is None or d2h is None or not n or not h2d + d2h:
        return None
    return (h2d + d2h) / 1e6 / n
