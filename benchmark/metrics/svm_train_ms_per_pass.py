"""Host milliseconds a pass in SvmTrain: the summed length of the
program's ``lia.svm.train`` spans (each target's host read of X and
``default_c``, the kernel matrix, the dual solve, the read-back of α and
K, the bias and the support selection) in the profiled sub-window, over
its passes."""

from benchmark import program


def read(ctx):
    secs, n = program.span_seconds(ctx, "lia.svm.train"), program.passes(ctx)
    return 1e3 * secs / n if secs is not None and n else None
