"""The SVM dual solver's share of its roofline: the least time of the
profiled pass's solves (``flops_svm``'s operations over 989 TFLOP/s and
bytes over 3.35 TB/s, the larger; at N = 4,096 the bytes bind) over the
device time of every operation launched under the program's
``lia.svm.dual`` spans (the ``svm_dual`` kernel alone on a card).  The
solves' sizes come from the program's ``lia.svm.*`` counters: ΣN², Σ
steps·N², ΣN and Σ steps·N, summed over solves, which is exact where
every solve has the same N and steps, as in the cell.  The kernel is
bound by its chain of 500 dependent FISTA steps, each a bisection of
cluster-wide rounds, so this reads far under 1 %."""

from benchmark import flops, flops_svm, program


def read(ctx):
    q = program.counter("lia.svm.q_entries")
    if not q or ctx.trace is None:
        return None
    secs = ctx.trace.span_device_seconds("lia.svm.dual")
    if not secs:
        return None
    n = program.counter("lia.svm.vectors")
    ops = flops_svm.dual_ops_summed(
        q, program.counter("lia.svm.dual_steps"), n,
        program.counter("lia.svm.dual_step_vectors"))
    least, _ = flops.least_seconds(ops, flops_svm.dual_bytes_summed(q, n))
    return 100.0 * least / secs
