"""Total-variability training, as the TotalVariability tool runs it once
its statistics are accumulated: ``fa.tv.init_t`` at the tool's defaults,
then one ``fa.tv.tv_em_iteration`` (E-step over ``speakerChunk``
sessions at a time, M-step, minimum divergence) a pass, each from the
last pass's model, as the tool's ``nbIt`` loop runs them.

Set-up draws the generating UBM and a generating T on the card, then the
sessions ``speakerChunk`` at a time: frames of the UBM whose component
means move by the session's supervector shift T_genᵀw (w ~ N(0, I)),
turned into zero- and first-order statistics by
``fa.stats.bw_stats_batch`` (kernel K2, the default tier) and dropped,
so that only (N, F) of every session stays on the card; the frames of
the first draw are kept for the comparison.  Then T is drawn by
``init_t`` from a seeded generator and one pass runs, which also warms
every shape; its input and output are kept for the comparison.

The comparison holds K2's (N, F) of the first draw's sessions to their
float64 posteriors (``benchmark/reference/gmm.py``), then takes two
passes: the set-up's and the last one run.  The float64 reference
(``benchmark/reference/tv_em.py``) recomputes each from the same input
model and the same resident statistics, ``speakerChunk`` sessions at a
time: T after the pass, the means the minimum divergence moved, and
every session's i-vector.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark import core, flops_tv, gen
from benchmark.reference import gmm as ref_gmm
from benchmark.reference import tv_em as ref

from lia_ral_tpu_torch.fa import stats as stats_mod
from lia_ral_tpu_torch.fa import tv
from lia_ral_tpu_torch.fa.stats import BwStats
from lia_ral_tpu_torch.gmm.model import GmmDiag


def _statistics(g, gmm, world, t_gen, t, dev):
    """(N (S, K), F (S, K, D)) of every session, drawn and reduced
    ``speakerChunk`` sessions at a time, and the frames and mask of the
    first draw."""
    ww, wm, wv = world
    k, d = wm.shape
    s, frames = t["sessions"], t["session_frames"]
    draw = t["tool"]["speakerChunk"]
    n = torch.empty(s, k, device=dev)
    f = torch.empty(s, k, d, device=dev)
    first = None
    for s0 in range(0, s, draw):
        s1 = min(s, s0 + draw)
        lengths = torch.full((s1 - s0,), frames, device=dev)
        x, mask = gen.ivector_corpus(g, ww, wm, wv, t_gen, lengths, frames)
        st = stats_mod.bw_stats_batch(x, mask, gmm, stats_pass="x3")
        n[s0:s1], f[s0:s1] = st.n, st.f
        if first is None:
            first = (x, mask)
        del x, mask, st
    return BwStats(n=n, f=f), first


def setup(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    dev, seed = ctx.device, ctx.seed
    k, d, r = cfg["n_components"], cfg["feature_dim"], cfg["tv_rank"]
    g = gen.stream(seed, "tv_train", dev)
    ww, wm, wv = gen.random_gmm(g, k, d, t["mean_spread"])
    t_gen = (torch.randn(r, k, d, generator=g, device=dev)
             * (t["tv_scale"] / r ** 0.5) * torch.sqrt(wv)[None])
    gmm = GmmDiag(weights=ww, means=wm, cov_inv=1.0 / wv)
    t0 = time.perf_counter()
    stats, frames = _statistics(g, gmm, (ww, wm, wv), t_gen, t, dev)
    del t_gen
    core.sync(dev)
    print(f"set-up: statistics of {t['sessions']} sessions x "
          f"{t['session_frames']} frames in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    o = t["tool"]
    model = tv.init_t(gen.stream(seed, "tv_train.init_t", dev), r, gmm,
                      scale=o["initScale"])
    st = {"stats": stats, "model": model, "world": (ww, wm, wv),
          "device": dev, "k": k, "d": d, "r": r, "traffic": t,
          "chunk": o["speakerChunk"], "min_div": o["minDivergence"],
          "frames": frames, "last": None}
    _pass(st, core.Recorder(dev))
    st["setup_pass"] = st["last"]
    return st


def _pass(st, rec):
    """One EM iteration from the last pass's model."""
    with rec.span("bench.pass"):
        model_in = st["model"]
        model, w = tv.tv_em_iteration(st["stats"], model_in,
                                      chunk=st["chunk"],
                                      min_div=st["min_div"])
    st["model"] = model
    st["last"] = (model_in, model, w)


def window(st, seconds, rec):
    passes, elapsed = core.run_passes(lambda i: _pass(st, rec), seconds,
                                      st["device"])
    t = st["traffic"]
    # the frames whose statistics a pass trains on; reported under the
    # 0.25 bound: a pass waits on the host in part, and 51-s runs of it
    # spread by ~10 % (PERF.md §2)
    audio_s = passes * t["sessions"] * t["session_frames"] / 100.0
    model_flops = passes * flops_tv.pass_flops(t["sessions"], st["k"],
                                               st["d"], st["r"])
    return core.Window(values={"audio_s_per_s.extract": audio_s / elapsed},
                       attempted=passes, failed=0, elapsed=elapsed,
                       extra={"model_flops": model_flops})


def profiled(st, rec):
    """One pass under the profiler; the readers take the program's
    ``lia.tv.*`` spans."""
    _pass(st, rec)
    return {"passes": 1}


def release(st):
    """Keep each judged pass's input model and outputs and the first
    draw's statistics; free the rest of the program's state (the
    statistics stay: they are the input)."""
    passes = {"set-up": st.pop("setup_pass"), "last": st.pop("last")}
    st["inputs"] = {name: (m_in.t, m_in.ubm_means)
                    for name, (m_in, _, _) in passes.items()}
    st["got"] = {name: (m_out.t, m_out.ubm_means, w)
                 for name, (_, m_out, w) in passes.items()}
    b = st["frames"][0].shape[0]
    st["got_stats"] = (st["stats"].n[:b], st["stats"].f[:b])
    st.pop("model", None)


def _reference_stats(st, dtype):
    """The reference's (N, F) of the first draw's sessions from their
    frames, in ``dtype``."""
    world = tuple(a.to(dtype) for a in st["world"])
    x, mask = st["frames"]
    ns, fs = zip(*(ref_gmm.bw_stats(x[i].to(dtype), mask[i].to(dtype),
                                    world)
                   for i in range(x.shape[0])))
    return torch.stack(ns), torch.stack(fs)


def _reference(st, dtype):
    """The reference's (T, means, i-vectors) of each judged pass from its
    input model, in ``dtype``."""
    var = st["world"][2].to(dtype)
    out = {}
    for name, (t_in, m_in) in st["inputs"].items():
        s = st["stats"]
        out[name] = ref.em_iteration(s.n, s.f, t_in.to(dtype),
                                     m_in.to(dtype), var,
                                     block=st["chunk"],
                                     min_div=st["min_div"])
    return out


def _stats_gaps(got, want) -> dict:
    n, f = (a.double() for a in got)
    nr, fr = (a.double() for a in want)
    return {
        "occupancy_gap": float(((n - nr).abs().amax(1)
                                / nr.amax(1).clamp(min=1.0)).max()),
        "first_order_gap": float(((f - fr).abs().amax((1, 2))
                                  / fr.abs().amax((1, 2))).max()),
    }


def _gaps(got, want, weights, var) -> dict:
    t, m, w = (a.double() for a in got)
    tr, mr, wr = (a.double() for a in want)
    per_c = ((t - tr).square().sum((0, 2)).sqrt()
             / tr.square().sum((0, 2)).sqrt())
    sigma = var.double().sqrt()
    return {
        "t_gap_rel": float(per_c.max()),
        "tv_mean_gap_sigma_w": float((weights.double() * ((m - mr).abs()
                                      / sigma).amax(1)).sum()),
        "ivector_gap_rel": float(((w - wr).norm(dim=1)
                                  / wr.norm(dim=1)).max()),
    }


def judge(st, limits):
    readings = _stats_gaps(st["got_stats"],
                           _reference_stats(st, torch.float64))
    print("statistics of the first draw: " + ", ".join(
        f"{n} {v!r}" for n, v in readings.items()), file=sys.stderr)
    want = _reference(st, torch.float64)
    ww, _, wv = st["world"]
    for name in want:
        gaps = _gaps(st["got"][name], want[name], ww, wv)
        print(f"pass {name}: " + ", ".join(f"{n} {v!r}"
                                           for n, v in gaps.items()),
              file=sys.stderr)
        for n, v in gaps.items():
            readings[n] = max(readings.get(n, 0.0), v)
    return [(n, v, limits.get(n)) for n, v in readings.items()]


def control(st, limits):
    """The reference in float32 with TF32 on, in the program's place,
    judged like the program's output."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        st["got_stats"] = _reference_stats(st, torch.float32)
        st["got"] = _reference(st, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return judge(st, limits)


# -- faults planted under the timed path (control.py --fault, the CPU tests) --

def _unchanged(mp):
    def unchanged(stats, model, chunk=64, min_div=True):
        return model, torch.zeros(stats.n.shape[0], model.rank,
                                  device=stats.n.device)
    mp.setattr(tv, "tv_em_iteration", unchanged)


def _half(mp):
    inner = tv.tv_e_step

    def half(stats, model, **kw):
        s = stats.n.shape[0]
        keep = (torch.arange(s, device=stats.n.device) < s // 2).to(stats.n)
        return inner(BwStats(n=stats.n * keep[:, None],
                             f=stats.f * keep[:, None, None]), model, **kw)
    mp.setattr(tv, "tv_e_step", half)


def _no_min_div(mp):
    mp.setattr(tv, "min_divergence", lambda model, acc: model)


def _altered(mp):
    inner = tv.tv_em_iteration

    def altered(stats, model, **kw):
        out, w = inner(stats, model, **kw)
        t = out.t.clone()
        t[:, int(stats.n.sum(0).argmax())] *= 1.01
        return out.replace(t=t), w
    mp.setattr(tv, "tv_em_iteration", altered)


FAULTS = {"unchanged": _unchanged, "half": _half, "no_min_div": _no_min_div,
          "altered": _altered}
