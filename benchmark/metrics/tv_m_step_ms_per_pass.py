"""Host milliseconds a pass in the T-matrix M-step and the minimum
divergence: the summed length of the program's ``lia.tv.m_step`` spans
(the K batched solves T_c = A_c⁻¹ C_c) and ``lia.tv.min_div`` spans (T's
whitening and the means' update) in the profiled sub-window, over its
passes."""

from benchmark import program


def read(ctx):
    n = program.passes(ctx)
    m_step = program.span_seconds(ctx, "lia.tv.m_step")
    if m_step is None or not n:
        return None
    min_div = program.span_seconds(ctx, "lia.tv.min_div") or 0.0
    return 1e3 * (m_step + min_div) / n
