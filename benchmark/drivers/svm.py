"""The GMM-supervector SVM with NAP (Campbell et al. 2006) as LIA_RAL's
tools run it once their files are read, one call per side or per target
as the tools loop: TrainTarget ``outputAdaptParam`` (``gmm.map_adapt.
adapt_model`` of the means, then ``backend.supervector.get_supervector
("KL")``), NAPSV (``nap_project_vectors``), SvmTrain (``backend.svm.
svm_train`` of a target's supervector against the background, C from
``default_c``) and SvmPredict (``SvmModel.decision`` over the pass's test
supervectors).

Set-up draws the world (the generating mixture), a rank-r channel
subspace of the mean supervector and every side on the card from the
seed.  A side's frames come from the world whose component means are
moved, in units of each component's σ, by its speaker's offset and by
its session's point in the channel subspace; each speaker and each side
has a generator of its own, so that the reference draws any side again.
The background's sides go through TrainTarget's path and CovIntra
(``train_nap_subspace``, speaker-labelled) once, then NAPSV projects
them once.  The pass's sides go to the host as arrays (TrainTarget reads
its features there); one target's enrolment, SVM and scoring warm every
shape.  A pass enrols ``targets`` sides and scores each target's model on
every test side: the targets' second sessions and ``test_others`` sides
of other speakers.

The comparison takes what the window's last pass produced: the NAP
subspace, the pass's projected supervectors, each target's primal weights
w = supportᵀ·α_y and the scores.  The float64 reference
(``benchmark/reference/svm.py``) draws the background again, adapts every
side from the same frames and world, trains NAP through the dual Gram,
solves each target's C-SVC by SMO and scores the same trials.
"""

from __future__ import annotations

import inspect
import sys
import time
import types

import numpy as np
import torch

from benchmark import core, flops, flops_svm, gen
from benchmark.reference import svm as ref

from lia_ral_tpu_torch.backend import supervector as sv
from lia_ral_tpu_torch.backend import svm
from lia_ral_tpu_torch.gmm.map_adapt import MapCfg, adapt_model
from lia_ral_tpu_torch.gmm.model import GmmDiag

# SMO's stopping violation, far under the spread of the cell's scores
# (~4e-4), so that the reference's own error stays under a tenth of each
# limit (PERF.md §2); the float32 control stops near where float32
# gradients can
REF_EPS = {torch.float64: 1e-9, torch.float32: 1e-6}
# the program's FISTA steps a solve (``svm_train``'s default), read once,
# before a planted fault can replace the function
STEPS = inspect.signature(svm.svm_train).parameters["n_iter"].default


def _world(seed, cfg, t, dev):
    g = gen.stream(seed, "svm.world", dev)
    return gen.random_gmm(g, cfg["n_components"], cfg["feature_dim"],
                          t["mean_spread"])


def _channel(seed, cfg, t, dev):
    """(r, K·D): a point h ~ N(0, I_r) of the subspace moves the means by
    h·U, each entry of standard deviation ``channel_shift``."""
    g = gen.stream(seed, "svm.channel", dev)
    r = t["channel_rank"]
    width = cfg["n_components"] * cfg["feature_dim"]
    return (torch.randn(r, width, generator=g, device=dev)
            * (t["channel_shift"] / r ** 0.5))


def _side(seed, world, chan, t, kind, spk, sess):
    """The frames (T, D) of side ``sess`` of speaker ``spk`` of ``kind``
    ("bg" or "pass"), on the world's device."""
    ww, wm, wv = world
    dev = wm.device
    k, d = wm.shape
    gs = gen.stream(seed, f"svm.speaker.{kind}.{spk}", dev)
    off = torch.randn(k, d, generator=gs, device=dev) * t["speaker_shift"]
    g = gen.stream(seed, f"svm.side.{kind}.{spk}.{sess}", dev)
    h = torch.randn(chan.shape[0], generator=g, device=dev)
    off = (off + (h @ chan).reshape(k, d)) * torch.sqrt(wv)
    return gen.gmm_frames(g, ww, wm, wv, t["side_frames"], offsets=off)


def _background_sides(t):
    return [(s, j) for s in range(t["background_speakers"])
            for j in range(t["background_sessions"])]


def _pass_sides(t):
    """Enrolment sides of the targets, then the test sides: the targets'
    second sessions, then one side of each other speaker."""
    n = t["targets"]
    return ([(s, 0) for s in range(n)] + [(s, 1) for s in range(n)]
            + [(n + s, 0) for s in range(t["test_others"])])


def _enrol(st, x):
    """TrainTarget outputAdaptParam, superVector KL: one side's KL
    supervector."""
    w = torch.ones(x.shape[0], device=x.device)
    client = adapt_model(st["map_gen"], x, w, st["gmm"], st["mcfg"])
    return sv.get_supervector("KL", st["gmm"], client)


def _predict(models, test):
    """SvmPredict: each target's model on every test supervector, (T, S)
    on the host."""
    return torch.stack([m.decision(test) for m in models]).cpu()


# the pass's steps that a planted fault replaces
HOOKS = types.SimpleNamespace(predict=_predict)


def setup(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    dev, seed = ctx.device, ctx.seed
    k, d = cfg["n_components"], cfg["feature_dim"]
    world = _world(seed, cfg, t, dev)
    chan = _channel(seed, cfg, t, dev)
    ww, wm, wv = world
    st = {"world": world, "chan": chan, "seed": seed, "traffic": t,
          "device": dev, "k": k, "d": d, "rank": cfg["nap_rank"],
          "reg": cfg["map"]["reg"],
          "gmm": GmmDiag(weights=ww, means=wm, cov_inv=1.0 / wv),
          "mcfg": MapCfg(method="MAPOccDep", mean_adapt=True,
                         mean_r=cfg["map"]["reg"],
                         nb_train_it=cfg["map"]["nb_train_it"]),
          "map_gen": torch.Generator(device=dev).manual_seed(seed % 2**63),
          "count": False, "model_flops": 0.0, "out": None}
    bg_sides = _background_sides(t)
    bg = torch.empty(len(bg_sides), k * d, device=dev)
    t0 = time.perf_counter()
    for i, (s, j) in enumerate(bg_sides):
        bg[i] = _enrol(st, _side(seed, world, chan, t, "bg", s, j))
    spk = torch.tensor([s for s, _ in bg_sides], device=dev)
    core.sync(dev)
    t1 = time.perf_counter()
    # CovIntra once, then NAPSV of the background once
    st["u"] = sv.train_nap_subspace(bg, spk, t["background_speakers"],
                                    cfg["nap_rank"])
    st["bg"] = sv.nap_project_vectors(bg, st["u"])
    del bg
    core.sync(dev)
    print(f"set-up: {len(bg_sides)} background sides drawn and adapted in "
          f"{t1 - t0:.3f} s, CovIntra and NAPSV in "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    st["y"] = np.r_[1.0, -np.ones(len(bg_sides))].astype(np.float32)
    st["sides"] = [_side(seed, world, chan, t, "pass", s, j).cpu().numpy()
                   for s, j in _pass_sides(t)]
    # warm-up: one side's enrolment and NAPSV, one target's SVM and its
    # scores on as many background vectors as the pass has test sides
    v = sv.nap_project_vectors(
        _enrol(st, torch.as_tensor(st["sides"][0], device=dev))[None],
        st["u"])
    model = svm.svm_train(torch.cat([v, st["bg"]]), st["y"])
    n_test = len(st["sides"]) - t["targets"]
    HOOKS.predict([model], st["bg"][:n_test])
    return st


def _pass(st, rec):
    dev, n_t = st["device"], st["traffic"]["targets"]
    with rec.span("bench.enrol"):
        svs = []
        for xh in st["sides"]:
            v = _enrol(st, torch.as_tensor(xh, device=dev))
            svs.append(sv.nap_project_vectors(v[None], st["u"])[0])
        svs = torch.stack(svs)
    with rec.span("bench.svm_train"):
        models = [svm.svm_train(torch.cat([svs[i:i + 1], st["bg"]]), st["y"])
                  for i in range(n_t)]
    with rec.span("bench.svm_predict"):
        scores = HOOKS.predict(models, svs[n_t:])
    st["out"] = (svs, models, scores)
    if st["count"]:
        st["model_flops"] += _model_flops(st, models, len(svs) - n_t)


def _model_flops(st, models, n_test):
    """A pass's logical flops: K1's of every side's frames (the MAP's one
    stats pass), each target's Gram and dual solve, NAP of every side and
    each decision."""
    t, k, d = st["traffic"], st["k"], st["d"]
    width, n = k * d, len(st["y"])
    sides = len(st["sides"])
    out = flops.k1_flops(sides * t["side_frames"], k, d)
    out += sides * flops_svm.nap_flops(width, st["rank"])
    for m in models:
        out += (flops_svm.gram_flops(n, width)
                + flops_svm.dual_ops(n, STEPS)
                + n_test * flops_svm.decision_flops(m.support.shape[0],
                                                    width))
    return out


def window(st, seconds, rec):
    st["count"], st["model_flops"] = True, 0.0
    try:
        passes, elapsed = core.run_passes(lambda i: _pass(st, rec), seconds,
                                          st["device"])
    finally:
        st["count"] = False
    t = st["traffic"]
    audio_s = passes * len(st["sides"]) * t["side_frames"] / 100.0
    return core.Window(values={"audio_s_per_s.extract": audio_s / elapsed},
                       attempted=passes, failed=0, elapsed=elapsed,
                       extra={"model_flops": st["model_flops"]})


def profiled(st, rec):
    """One pass under the profiler; the readers take the program's
    ``lia.svm.*`` spans and counters."""
    with rec.span("bench.pass"):
        _pass(st, rec)
    return {"passes": 1}


def _weights(models, dev):
    """w = supportᵀ·α_y of each model, float64 on ``dev``; the biases."""
    w = torch.stack([torch.as_tensor(m.alpha_y, device=dev).double()
                     @ torch.as_tensor(m.support, device=dev).double()
                     for m in models])
    b = torch.tensor([m.bias for m in models], dtype=torch.float64,
                     device=dev)
    return w, b


def release(st):
    dev = st["device"]
    svs, models, scores = st.pop("out")
    w, b = _weights(models, dev)
    print(f"support vectors a target: "
          f"{sorted(m.support.shape[0] for m in models)}", file=sys.stderr)
    st["got"] = {"u": st.pop("u").double(), "svs": svs.double(), "w": w,
                 "b": b, "scores": scores.double()}
    for key in ("bg", "gmm", "map_gen"):
        st.pop(key, None)


def _supervectors(st, sides, dtype, block=4):
    """KL supervectors of ``sides`` ((kind, speaker, session), or host
    arrays), MAP-adapted by the reference in ``dtype``."""
    dev, t = st["device"], st["traffic"]
    world32 = st["world"]
    world = tuple(a.to(dev, dtype) for a in world32)
    out = []
    for i in range(0, len(sides), block):
        xs = []
        for s in sides[i:i + block]:
            if isinstance(s, np.ndarray):
                xs.append(torch.as_tensor(s, device=dev))
            else:
                xs.append(_side(st["seed"], world32, st["chan"], t, *s))
        x = torch.stack(xs).to(dtype)
        out.append(ref.kl_supervectors(ref.map_means(x, world, st["reg"]),
                                       world))
    return torch.cat(out)


def _reference(st, dtype):
    """The reference's NAP subspace, projected supervectors of the pass's
    sides, weights, biases and scores, computed in ``dtype``."""
    t = st["traffic"]
    dev = st["device"]
    bg_sides = _background_sides(t)
    bg = _supervectors(st, [("bg", s, j) for s, j in bg_sides], dtype)
    spk = torch.tensor([s for s, _ in bg_sides], device=dev)
    u = ref.nap_subspace(bg, spk, st["rank"])
    bg = ref.nap_project(bg, u)
    svs = ref.nap_project(_supervectors(st, st["sides"], dtype), u)
    n_t = t["targets"]
    w, b, a, iters = ref.svm_train(svs[:n_t], bg, eps=REF_EPS[dtype])
    print(f"reference SMO ({dtype}): {iters} iterations, support vectors "
          f"{sorted(int(v) for v in (a > 0).sum(1))}", file=sys.stderr)
    scores = ref.scores(w, b, svs[n_t:])
    return {"u": u.double(), "svs": svs.double(), "w": w.double(),
            "b": b.double(), "scores": scores.double().cpu()}


def _readings(got, want) -> dict:
    """The gaps between the program's outputs and the reference's."""
    u, ur = got["u"], want["u"].to(got["u"].device)
    # sine of the largest principal angle: ‖U(I − UrᵀUr)‖₂
    resid = u - (u @ ur.T) @ ur
    nap_angle = float(torch.linalg.matrix_norm(resid, ord=2))
    ds = got["svs"] - want["svs"]
    sv_gap = float((ds.norm(dim=1) / want["svs"].norm(dim=1)).max())
    dw = got["w"] - want["w"]
    w_gap = float((dw.norm(dim=1) / want["w"].norm(dim=1)).max())
    ref_scores = want["scores"]
    score_gap = float((got["scores"] - ref_scores).abs().max()
                      / ref_scores.std())
    return {"nap_angle": nap_angle, "sv_gap_rel": sv_gap,
            "w_gap_rel": w_gap, "score_gap": score_gap}


def _print_trials(scores, n_t):
    """Target against impostor trials: the margin between the lowest
    target score and the highest impostor score (printed, not compared)."""
    s = scores.cpu().numpy()
    tgt = np.array([s[i, i] for i in range(n_t)])
    mask = np.ones_like(s, bool)
    mask[np.arange(n_t), np.arange(n_t)] = False
    print(f"trials: target scores {tgt.min():.4f}..{tgt.max():.4f}, "
          f"impostor scores {s[mask].min():.4f}..{s[mask].max():.4f}",
          file=sys.stderr)


def judge(st, limits):
    want = _reference(st, torch.float64)
    st["want"] = want
    _print_trials(st["got"]["scores"], st["traffic"]["targets"])
    readings = _readings(st["got"], want)
    return [(n, v, limits.get(n)) for n, v in readings.items()]


def control(st, limits):
    """The reference in float32 with TF32 on, in the program's place:
    its NAP, supervectors, SVMs and scores from the same frames, judged
    like the program's."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        st["got"] = _reference(st, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for key in ("u", "svs", "w", "b"):
        st["got"][key] = st["got"][key].to(st["device"])
    return judge(st, limits)


# -- faults planted under the timed path (control.py --fault, the CPU tests) --

def _nap_skipped(mp):
    mp.setattr(sv, "nap_project_vectors", lambda vectors, u: vectors)


def _half_cohort(mp):
    inner = svm.svm_train

    def half(x, y, *a, **kw):
        keep = 1 + (len(y) - 1) // 2
        return inner(x[:keep], y[:keep], *a, **kw)
    mp.setattr(svm, "svm_train", half)


def _altered(mp):
    inner = HOOKS.predict

    def altered(models, test):
        out = inner(models, test)
        out[0, 0] += out.std()
        return out
    mp.setattr(HOOKS, "predict", altered)


FAULTS = {"nap_skipped": _nap_skipped, "half_cohort": _half_cohort,
          "altered": _altered}
