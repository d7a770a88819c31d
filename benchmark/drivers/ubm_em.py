"""TrainWorld's EM loop: ``gmm.em.train_model`` over a corpus resident on
the card, each call starting from the previous call's model.

Set-up draws the conversation sides from a seeded generating mixture
with per-side speaker shifts, and the first UBM (k frames as means, the
global variance, equal weights), then makes one call to load K1 and warm
its shapes.  A pass is one call (``nbTrainIt`` EM iterations over every
frame).  The comparison follows the program from its own state: the
model the window's last call started from goes through the same
iterations in float64, and the set-up call from the seeded start does
too; each program model is held against its reference.
"""

from __future__ import annotations

import sys

import torch

from benchmark import core, flops, gen
from benchmark.reference import gmm as ref

from lia_ral_tpu_torch.gmm import em
from lia_ral_tpu_torch.gmm.em import TrainCfg
from lia_ral_tpu_torch.gmm.model import GmmDiag


def _as_ref(model: GmmDiag, dtype=torch.float64):
    return (model.weights.to(dtype), model.means.to(dtype),
            (1.0 / model.cov_inv).to(dtype))


def setup(ctx):
    k, d = ctx.cfg["n_components"], ctx.cfg["feature_dim"]
    t = ctx.traffic
    g = gen.stream(ctx.seed, "corpus", ctx.device)
    gw, gm, gv = gen.random_gmm(g, k, d, t["mean_spread"])
    x = gen.sides_corpus(g, gw, gm, gv, t["sides"], t["frames_per_side"],
                         t["speaker_shift"])
    w = torch.ones(x.shape[0], device=ctx.device)
    pick = torch.randperm(x.shape[0], generator=g, device=ctx.device)[:k]
    gvar = x.var(0, unbiased=False)
    init = GmmDiag(weights=torch.full((k,), 1.0 / k, device=ctx.device),
                   means=x[pick].clone(),
                   cov_inv=(1.0 / gvar).expand(k, d).contiguous())
    cfg = TrainCfg(nb_train_it=t["nb_train_it"],
                   bagged_frame_probability=1.0)
    tg = torch.Generator(device=ctx.device)
    tg.manual_seed(0)
    first = em.train_model(tg, x, w, init, cfg)
    st = {"x": x, "w": w, "cfg": cfg, "gen": tg, "model": first,
          "start": (init, first), "last": None, "device": ctx.device,
          "frames": x.shape[0], "k": k, "d": d}
    return st


def _call(st, rec):
    before = st["model"]
    with rec.span("bench.pass"):
        st["model"] = em.train_model(st["gen"], st["x"], st["w"], before,
                                     st["cfg"])
    st["last"] = (before, st["model"])


def _pass_flops(st) -> float:
    return st["cfg"].nb_train_it * flops.k1_flops(st["frames"], st["k"],
                                                 st["d"])


def window(st, seconds, rec):
    passes, elapsed = core.run_passes(lambda i: _call(st, rec), seconds,
                                      st["device"])
    audio_s = passes * st["cfg"].nb_train_it * st["frames"] / 100.0
    return core.Window(values={"audio_s_per_s.train": audio_s / elapsed},
                       attempted=passes, failed=0, elapsed=elapsed,
                       extra={"model_flops": passes * _pass_flops(st)})


def profiled(st, rec):
    """Two calls with a span around each K1 launch."""
    n, k, d = st["frames"], st["k"], st["d"]
    inner = em.em_stats_fused

    def k1(x, w, gmm, **kw):
        rec.cost("bench.k1", flops.k1_flops(n, k, d), flops.k1_bytes(n, k, d))
        with rec.span("bench.k1"):
            return inner(x, w, gmm, **kw)

    em.em_stats_fused = k1
    try:
        for _ in range(2):
            _call(st, rec)
    finally:
        em.em_stats_fused = inner
    return {"passes": 2}


def release(st):
    st["judged"] = {name: (_as_ref(p[0]), _as_ref(p[1]))
                    for name, p in (("start", st["start"]),
                                    ("last", st["last"])) if p is not None}
    for key in ("model", "start", "last", "gen"):
        st.pop(key, None)


def _readings(st, pairs, dtype=torch.float64):
    """Gaps between each program model and the reference's from the same
    input model, all in float64, the worst over the pairs: each taken
    over the components weighted by the reference's mixture weights (a
    component's widest gap, printed, rests on its few frames and swings
    from seed to seed; see PERF.md)."""
    x = st["x"].to(dtype)
    fw = st["w"].to(dtype)
    nb = st["cfg"].nb_train_it
    worst: dict = {}
    for start, got in pairs:
        want = ref.train(x, fw, tuple(a.to(dtype) for a in start), nb)
        want = tuple(a.double() for a in want)
        got = tuple(a.double() for a in got)
        w_ref = want[0]
        per = ((got[1] - want[1]).abs() / want[2].sqrt()).amax(1)
        lvar = (got[2].log() - want[2].log()).abs().amax(1)
        gap = {
            "mean_gap_sigma_w": float((per * w_ref).sum()),
            "log_var_gap_w": float((lvar * w_ref).sum()),
            "weight_gap_l1": float((got[0] - w_ref).abs().sum()),
        }
        k_max = int(per.argmax())
        print(f"widest mean gap {float(per[k_max]):.4g} sigma at component "
              f"{k_max} ({float(w_ref[k_max] * x.shape[0]):.1f} frames; "
              f"median component {float(w_ref.median() * x.shape[0]):.1f}"
              f"); widest log-variance gap "
              f"{float(lvar.max()):.4g}; widest weight gap "
              f"{float(((got[0] - w_ref).abs() / w_ref).max()):.4g}",
              file=sys.stderr)
        for name, v in gap.items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def judge(st, limits):
    readings = _readings(st, st["judged"].values())
    return [(n, v, limits.get(n)) for n, v in readings.items()]


def control(st, limits):
    """The reference in TF32 in the program's place for the window's last
    call (the set-up call where no window ran), judged like the
    program's."""
    start = st["judged"].get("last", st["judged"]["start"])[0]
    x32 = st["x"]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = ref.train(x32, st["w"].float(),
                        tuple(a.float() for a in start),
                        st["cfg"].nb_train_it)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    st["judged"] = {"control": (start, tuple(a.double() for a in got))}
    return judge(st, limits)


# -- faults planted under the timed path (control.py --fault, the CPU tests) --

def _unchanged(mp):
    mp.setattr(em, "train_model", lambda g, x, w, init, cfg, **kw: init)


def _half(mp):
    inner = em.train_model

    def half(g, x, w, init, cfg, **kw):
        keep = (torch.arange(w.shape[0], device=w.device)
                < w.shape[0] // 2).to(w)
        return inner(g, x, w * keep, init, cfg, **kw)
    mp.setattr(em, "train_model", half)


def _altered(mp):
    inner = em.train_model

    def altered(*a, **kw):
        out = inner(*a, **kw)
        means = out.means.clone()
        k = int(out.weights.argmax())
        means[k] += 1.0 / out.cov_inv[k].sqrt()
        return out.replace(means=means)
    mp.setattr(em, "train_model", altered)


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}
