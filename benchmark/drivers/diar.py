"""Broadcast-news diarization as LIA_SpkSeg runs it once a show's speech
frames are read: ``seg.diarization.e_hmm_segmentation`` (the E-HMM grows
its HMM one speaker at a time to ``max_speakers`` states, adapting every
state by MAP through kernel K1 and decoding through the Viterbi kernel),
then ``seg.diarization.resegmentation`` on the segments it returns, both
on the show's frames as a host array and with the tools' options as the
configuration file gives them.

Set-up draws the world (the generating mixture) and a show on the card:
turns of lengths log-uniform over the traffic's range, each turn's
speaker drawn by talk-time share (the anchor's share, the others' by a
Zipf law; a draw equal to the last speaker lengthens that turn), each
speaker the world with its own shift of every component's mean (in
units of the component's σ).  The frames go to the host once; one small
E-HMM and ReSegmentation warm both kernels.  A pass diarizes the show.

The comparison takes what the window's last pass produced: the masks of
the E-HMM's last adaptation and the bank it returned, and the last
ReSegmentation decode's bank, activity, emissions and path.  The float64
reference (``benchmark/reference/diar.py``) recomputes the MAP of the
world on the same masks, the emissions of the same bank, and the best
path of those emissions, on the card in blocks (the Viterbi recursion on
the host).  The diarization error rate against the drawn truth is
printed, not compared.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from benchmark import core, flops, flops_seg, gen
from benchmark.reference import diar as ref

from lia_ral_tpu_torch.backend.eval import der
from lia_ral_tpu_torch.gmm import em
from lia_ral_tpu_torch.gmm.model import GmmDiag
from lia_ral_tpu_torch.seg import diarization as dz

def _shares(t) -> np.ndarray:
    """Talk-time shares: the anchor's, the others' by Zipf."""
    z = np.arange(1, t["speakers"], dtype=np.float64) ** -t["zipf_exponent"]
    return np.concatenate([[t["anchor_share"]],
                           (1.0 - t["anchor_share"]) * z / z.sum()])


def _show(g, t, world):
    """(frames (N, D), truth (N,) speaker ids) on the card."""
    ww, wm, wv = world
    dev = wm.device
    n, spk = t["frames"], t["speakers"]
    k, d = wm.shape
    most = -(-n // t["turn_frames_min"]) + 1
    lo, hi = math.log(t["turn_frames_min"]), math.log(t["turn_frames_max"])
    u = torch.rand(most, generator=g, device=dev, dtype=torch.float64)
    lengths = torch.exp(lo + (hi - lo) * u).round().long()
    shares = torch.as_tensor(_shares(t), device=dev)
    who = gen.draw_components(g, shares, most)
    truth = torch.repeat_interleave(who, lengths)[:n]
    offsets = (torch.randn(spk, k, d, generator=g, device=dev)
               * t["speaker_shift"] * torch.sqrt(wv)[None])
    comp = gen.draw_components(g, ww, n)
    noise = torch.randn(n, d, generator=g, device=dev)
    x = wm[comp] + offsets[truth, comp] + torch.sqrt(wv)[comp] * noise
    return x, truth


class _Later:
    """A number read from the card only when asked (``float``): a K1
    call's or a decode's count, kept as a 0-d tensor through the
    profiled sub-window."""

    def __init__(self, fn):
        self.fn = fn

    def __float__(self) -> float:
        return float(self.fn())


def _install_taps(st):
    """Wrap the names ``seg.diarization`` looks up so that each pass keeps
    what the comparison needs (references only, the last call of each
    phase) and the window's model flops (a mask sum a batched adaptation,
    on the card, read after the window)."""
    patch = core.Patch()
    adapt_inner = dz._batched_state_adapt
    emis_inner = dz._masked_emissions
    vit_inner = dz._viterbi

    def adapt(generator, x, masks, world, **kw):
        bank = adapt_inner(generator, x, masks, world, **kw)
        if st["phase"] == "e_hmm":
            st["taps"]["adapt"] = (masks, bank)
        if st["count"]:
            st["mask_sums"].append(masks.sum())
        return bank

    def emis(x, gmms, active_mask):
        out = emis_inner(x, gmms, active_mask)
        if st["phase"] == "reseg":
            st["taps"]["bank"] = (gmms, np.array(active_mask, bool))
        if st["count"]:
            st["emission_flops"] += flops_seg.emission_flops(
                x.shape[0], int(np.count_nonzero(active_mask)), st["k"],
                st["d"])
        return out

    def vit(emissions, log_trans):
        path = vit_inner(emissions, log_trans)
        if st["phase"] == "reseg":
            st["taps"]["decode"] = (emissions, log_trans, path)
        return path

    patch.setattr(dz, "_batched_state_adapt", adapt)
    patch.setattr(dz, "_masked_emissions", emis)
    patch.setattr(dz, "_viterbi", vit)
    return patch


def setup(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    k, d = cfg["n_components"], cfg["feature_dim"]
    dev = ctx.device
    g = gen.stream(ctx.seed, "diar", dev)
    world = gen.random_gmm(g, k, d, t["mean_spread"])
    x, truth = _show(g, t, world)
    ww, wm, wv = world
    st = {"x": x.cpu().numpy(), "truth": truth.cpu().numpy(),
          "world": world, "gmm": GmmDiag(weights=ww, means=wm,
                                         cov_inv=1.0 / wv),
          "seg": cfg["segmentation"], "reseg": cfg["resegmentation"],
          "max_speakers": cfg["max_speakers"], "device": dev,
          "map_it": cfg["map_iterations"], "frames": t["frames"],
          "k": k, "d": d, "phase": None,
          "count": False, "mask_sums": [], "emission_flops": 0.0,
          "taps": {}, "out": None}
    del x, truth
    st["patch"] = _install_taps(st)
    warm = dict(st, x=st["x"][:t["warmup_frames"]],
                max_speakers=min(3, cfg["max_speakers"]))
    _pass(warm, core.Recorder(dev))
    st["taps"] = {}
    return st


def _pass(st, rec):
    s, r = st["seg"], st["reseg"]
    st["phase"] = "e_hmm"
    with rec.span("bench.e_hmm"):
        segs, path = dz.e_hmm_segmentation(
            st["x"], st["gmm"], max_speakers=st["max_speakers"],
            init_seg_frames=s["init_seg_frames"],
            nb_decode_it=s["nb_decode_it"], min_duration=s["min_duration"],
            map_reg=s["map_reg"])
    st["phase"] = "reseg"
    with rec.span("bench.reseg"):
        _, rpath = dz.resegmentation(
            st["x"], segs, st["gmm"], nb_it=r["nb_it"],
            min_duration=r["min_duration"],
            min_state_frames=r["min_state_frames"], map_reg=r["map_reg"])
    st["phase"] = None
    st["out"] = (path, rpath)


def window(st, seconds, rec):
    st["count"], st["mask_sums"], st["emission_flops"] = True, [], 0.0
    try:
        passes, elapsed = core.run_passes(lambda i: _pass(st, rec), seconds,
                                          st["device"])
    finally:
        st["count"] = False
    frames = float(torch.stack(st["mask_sums"]).sum()) if st["mask_sums"] \
        else 0.0
    model_flops = (st["map_it"] * flops.k1_flops(frames, st["k"], st["d"])
                   + st["emission_flops"])
    audio_s = passes * st["frames"] / 100.0
    return core.Window(values={"audio_s_per_s.extract": audio_s / elapsed},
                       attempted=passes, failed=0, elapsed=elapsed,
                       extra={"model_flops": model_flops})


def profiled(st, rec):
    """One pass with a span around each K1 launch and each Viterbi
    decode.  A K1 call's work counts the frames of non-zero weight it is
    handed (a later change that gathers a state's frames reads the same
    work); a decode's, the states in the HMM.  ``k1_roofline_pct.diar``
    reads the K1 ranges through ``trace_index``."""
    k, d = st["k"], st["d"]
    k1_inner = em.em_stats_fused
    vit_inner = dz._viterbi

    def k1(x, w, gmm, **kw):
        nz = torch.count_nonzero(w)
        rec.cost("bench.k1", _Later(lambda: flops.k1_flops(int(nz), k, d)),
                 _Later(lambda: flops.k1_bytes(int(nz), k, d)))
        # a profiler range alone, kept out of ``rec.spans``: the result
        # line's idle split tests every gap against every one of those,
        # and ~7,000 K1 ranges a pass would take it minutes
        with torch.profiler.record_function("bench.k1"):
            return k1_inner(x, w, gmm, **kw)

    def vit(emissions, log_trans):
        n = emissions.shape[0]
        active = (emissions[0] > ref.INACTIVE / 2).sum()
        rec.cost("bench.viterbi",
                 _Later(lambda: flops_seg.viterbi_ops(n, int(active))),
                 _Later(lambda: flops_seg.viterbi_bytes(n, int(active))))
        with rec.span("bench.viterbi"):
            return vit_inner(emissions, log_trans)

    patch = core.Patch()
    patch.setattr(em, "em_stats_fused", k1)
    patch.setattr(dz, "_viterbi", vit)
    try:
        with rec.span("bench.pass"):
            _pass(st, rec)
    finally:
        patch.undo()
    return {"passes": 1}


def release(st):
    st.pop("patch").undo()
    st["out_der"] = st.pop("out", None)
    taps = st.pop("taps")
    dev = st["device"]
    got = {}
    if "adapt" in taps:
        masks, bank = taps["adapt"]
        got["masks"] = masks.to(dev, torch.float64)
        got["adapt"] = (bank.weights.double(), bank.means.double())
    if "decode" in taps:
        gmms, active = taps["bank"]
        emissions, _, path = taps["decode"]
        got["bank"] = (gmms.weights.double(), gmms.means.double(),
                       (1.0 / gmms.cov_inv.double()))
        got["active"] = torch.as_tensor(active)
        got["emissions"] = emissions.double()
        got["path"] = path.cpu()
    st["got"] = got
    st.pop("gmm", None)


def _readings(st) -> dict:
    """The gaps between the program's outputs in ``st["got"]`` and the
    float64 reference's from the same inputs."""
    got = st["got"]
    dev = st["device"]
    x = torch.as_tensor(st["x"], device=dev, dtype=torch.float64)
    world = tuple(a.to(dev, torch.float64) for a in st["world"])
    out = {}
    if "adapt" in got:
        w_ref, m_ref, _ = ref.map_adapt(x, got["masks"], world,
                                        st["map_it"],
                                        st["seg"]["map_reg"])
        w_p, m_p = got["adapt"]
        per = ((m_p - m_ref).abs() / world[2].sqrt()[None]).amax(-1)
        out["adapt_mean_gap_sigma_w"] = float((per * w_ref).sum(1).max())
        out["adapt_weight_gap_l1"] = float((w_p - w_ref).abs().sum(1).max())
    if "emissions" in got:
        active = got["active"]
        em_ref = ref.emissions(x, got["bank"], active.to(dev)).cpu()
        em_p = got["emissions"].cpu()
        out["emission_gap_nats"] = float(
            (em_p[:, active] - em_ref[:, active]).abs().max())
        lt = ref.log_transitions(active.shape[0], active)
        best, _ = ref.viterbi(em_ref, lt)
        mine = ref.states_of_labels(got["path"], em_ref, lt)
        out["path_score_gap"] = float(
            (ref.path_score(em_ref, lt, best)
             - ref.path_score(em_ref, lt, mine)) / em_ref.shape[0])
    return out


def _print_der(st):
    if st.get("out_der") is None:
        return
    truth = st["truth"][:len(st["out_der"][0])]
    e, r = (der(truth, p) for p in st["out_der"])
    print(f"DER against the drawn truth: E-HMM {e:.4f}, after "
          f"ReSegmentation {r:.4f}; speakers {len(np.unique(truth))}, "
          f"states {len(np.unique(st['out_der'][0]))} / "
          f"{len(np.unique(st['out_der'][1]))}", file=sys.stderr)


def judge(st, limits):
    _print_der(st)
    readings = _readings(st)
    return [(n, v, limits.get(n)) for n, v in readings.items()]


def control(st, limits):
    """The reference in float32 with TF32 on, in the program's place: its
    MAP on the same masks, its emissions of the same bank and the path a
    float32 decoder takes through them, judged like the program's."""
    got = st["got"]
    dev = st["device"]
    x = torch.as_tensor(st["x"], device=dev)
    world = tuple(a.to(dev, torch.float32) for a in st["world"])
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        if "adapt" in got:
            w, m, _ = ref.map_adapt(x, got["masks"].float(), world,
                                    st["map_it"],
                                    st["seg"]["map_reg"])
            got["adapt"] = (w.double(), m.double())
        if "emissions" in got:
            active = got["active"]
            bank = tuple(a.float() for a in got["bank"])
            em32 = ref.emissions(x, bank, active.to(dev)).cpu()
            lt = ref.log_transitions(active.shape[0], active, torch.float32)
            states, _ = ref.viterbi(em32, lt)
            got["emissions"] = em32.double()
            got["path"] = ref.port_labels(states)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return judge(st, limits)


# -- faults planted under the timed path (control.py --fault, the CPU tests) --

def _half(mp):
    inner = dz._batched_state_adapt

    def half(generator, x, masks, world, **kw):
        return inner(generator, x, masks * core.first_half(masks), world,
                     **kw)
    mp.setattr(dz, "_batched_state_adapt", half)


def _shifted(mp):
    inner = dz._viterbi

    def shifted(emissions, log_trans):
        path = inner(emissions, log_trans)
        out = path.clone()
        turn = path[1:] != path[:-1]
        out[1:][turn] = path[:-1][turn]
        return out
    mp.setattr(dz, "_viterbi", shifted)


def _altered(mp):
    inner = dz._masked_emissions

    def altered(x, gmms, active_mask):
        out = inner(x, gmms, active_mask).clone()
        out[:, 0] += ALTERED_NATS
        return out
    mp.setattr(dz, "_masked_emissions", altered)


ALTERED_NATS = 0.1
FAULTS = {"half": _half, "shifted": _shifted, "altered": _altered}
