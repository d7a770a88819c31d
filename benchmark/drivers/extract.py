"""i-vector extraction of short segments, as the IvExtractor tool runs
it once its feature files are read: ``fa.stats.bw_stats_bucketed`` on the
segments as host arrays (each padded to a multiple of
``statsBucketFrames``, cut into batches of ``statsBatchSize``, each batch
padded and copied to the card and given to kernel K2), then
``fa.tv.estimate_w`` (exact extraction, the tool's default solver), both
with the tool's options as the workload file gives them.

Set-up draws a UBM, a total-variability matrix T and the segments: each
a length uniform in the traffic's range, frames of the UBM whose means
move by the segment's supervector shift Tᵀw, brought to the host as the
tool holds them.  A pass extracts every segment once.  The comparison
recomputes, in float64, the zero- and first-order statistics and the
i-vectors of a sample of the last pass's segments (drawn from the seed,
the longest in it) from the same frames, UBM and T.
"""

from __future__ import annotations

import torch

from benchmark import core, flops, gen
from benchmark.reference import gmm as ref
from benchmark.reference import tv as ref_tv

from lia_ral_tpu_torch.fa import stats as stats_mod
from lia_ral_tpu_torch.fa import tv
from lia_ral_tpu_torch.fa.tv import TvModel
from lia_ral_tpu_torch.gmm.model import GmmDiag


def setup(ctx):
    k, d = ctx.cfg["n_components"], ctx.cfg["feature_dim"]
    r = ctx.cfg["tv_rank"]
    t = ctx.traffic
    dev = ctx.device
    g = gen.stream(ctx.seed, "ivec", dev)
    ww, wm, wv = gen.random_gmm(g, k, d, t["mean_spread"])
    t_mat = (torch.randn(r, k, d, generator=g, device=dev)
             * (t["tv_scale"] / r ** 0.5) * torch.sqrt(wv)[None])
    lengths = gen.spread_ints(g, t["frames_min"], t["frames_max"],
                               t["segments"])
    x, mask = gen.ivector_corpus(g, ww, wm, wv, t_mat, lengths,
                                 t["frames_max"])
    lens = lengths.cpu().tolist()
    x_host, mask_host = x.cpu().numpy(), mask.cpu().numpy()
    del x, mask
    entries = [(x_host[i, :n], mask_host[i, :n]) for i, n in enumerate(lens)]
    gmm = GmmDiag(weights=ww, means=wm, cov_inv=1.0 / wv)
    model = TvModel(t=t_mat, ubm_means=wm, ubm_inv_var=1.0 / wv)
    st = {"entries": entries, "gmm": gmm, "model": model, "device": dev,
          "tool": t["tool"], "lengths": lens, "frames": sum(lens),
          "k": k, "d": d, "r": r, "world": (ww, wm, wv), "t_mat": t_mat,
          "seed": ctx.seed, "judge_segments": t["judge_segments"],
          "out": None}
    _pass(st, core.Recorder(dev))
    return st


def _pass(st, rec):
    o = st["tool"]
    with rec.span("bench.bw_stats"):
        stats = stats_mod.bw_stats_bucketed(
            st["entries"], st["gmm"], bucket=o["statsBucketFrames"],
            batch_size=o["statsBatchSize"], stats_pass="x3")
    with rec.span("bench.estimate_w"):
        w = tv.estimate_w(stats, st["model"], chunk=o["speakerChunk"],
                          solver=o["ivSolver"],
                          pcg_iters=o["ivSolverPcgIterations"],
                          pcg_tol=o["ivSolverPcgTolerance"])
    st["out"] = (stats.n, stats.f, w)


def _pass_flops(st) -> float:
    k, d, r = st["k"], st["d"], st["r"]
    s = len(st["lengths"])
    return (flops.k2_flops(st["frames"], k, d)
            + flops.extraction_flops(s, k, d, r))


def window(st, seconds, rec):
    passes, elapsed = core.run_passes(lambda i: _pass(st, rec), seconds,
                                      st["device"])
    audio_s = passes * st["frames"] / 100.0
    return core.Window(values={"audio_s_per_s.extract": audio_s / elapsed},
                       attempted=passes, failed=0, elapsed=elapsed,
                       extra={"model_flops": passes * _pass_flops(st)})


def profiled(st, rec):
    """Two passes with a span around each K2 launch.  A launch's unpadded
    frames and segments are its mask's sum and its rows with any weight,
    taken on the card and read once the sub-window has closed."""
    k, d = st["k"], st["d"]
    inner = stats_mod.bw_stats_fused

    def k2(x, w, gmm, **kw):
        frames = w.sum()
        rows = (w.sum(-1) > 0).sum()
        rec.cost("bench.k2", flops.k2_flops(frames, k, d),
                 flops.k2_bytes(frames, rows, k, d))
        with rec.span("bench.k2"):
            return inner(x, w, gmm, **kw)

    stats_mod.bw_stats_fused = k2
    try:
        for _ in range(2):
            with rec.span("bench.pass"):
                _pass(st, rec)
    finally:
        stats_mod.bw_stats_fused = inner
    return {"passes": 2}


def _sample(st) -> list[int]:
    n = len(st["lengths"])
    rng = gen.host_rng(st["seed"], "judge")
    pick = set(rng.choice(n, min(st["judge_segments"], n),
                          replace=False).tolist())
    pick.add(max(range(n), key=lambda i: st["lengths"][i]))
    return sorted(pick)


def release(st):
    idx = torch.as_tensor(_sample(st), device=st["device"])
    n, f, w = st.pop("out")
    st["got"] = (n[idx].double(), f[idx].double(), w[idx].double())
    st["idx"] = idx
    for key in ("gmm", "model"):
        st.pop(key, None)


def _reference(st, dtype):
    ww, wm, wv = (a.to(dtype) for a in st["world"])
    ns, fs = [], []
    for i in st["idx"].tolist():
        xs, ms = (torch.as_tensor(a, device=st["device"], dtype=dtype)
                  for a in st["entries"][i])
        n, f = ref.bw_stats(xs, ms, (ww, wm, wv))
        ns.append(n)
        fs.append(f)
    n, f = torch.stack(ns), torch.stack(fs)
    w = ref_tv.ivectors(n, f, wm, wv, st["t_mat"].to(dtype))
    return n, f, w


def judge(st, limits):
    n_r, f_r, w_r = _reference(st, torch.float64)
    n_p, f_p, w_p = st["got"]
    readings = {
        "occupancy_gap": float(((n_p - n_r).abs().amax(1)
                                / n_r.amax(1).clamp(min=1.0)).max()),
        "first_order_gap": float(((f_p - f_r).abs().amax((1, 2))
                                  / f_r.abs().amax((1, 2))).max()),
        "ivector_gap_rel": float(((w_p - w_r).norm(dim=1)
                                  / w_r.norm(dim=1)).max()),
    }
    return [(n, v, limits.get(n)) for n, v in readings.items()]


def control(st, limits):
    """The reference in TF32 in the program's place, judged like the
    program's output."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        st["got"] = tuple(a.double() for a in _reference(st, torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return judge(st, limits)


# -- faults planted under the timed path (control.py --fault, the CPU tests) --

def _unchanged(mp):
    mp.setattr(tv, "estimate_w", lambda stats, model, **kw: torch.zeros(
        stats.n.shape[0], model.rank, dtype=stats.n.dtype))


def _half(mp):
    inner = stats_mod.bw_stats_batch

    def half(x, mask, gmm, **kw):
        return inner(x, mask * core.first_half(mask), gmm, **kw)
    mp.setattr(stats_mod, "bw_stats_batch", half)


def _altered(mp):
    inner = tv.estimate_w

    def altered(stats, model, **kw):
        w = inner(stats, model, **kw).clone()
        w[:, 0] += 0.01 * w.norm(dim=1)
        return w
    mp.setattr(tv, "estimate_w", altered)


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}
