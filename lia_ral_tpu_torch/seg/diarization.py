"""Diarization processes: turn detection, E-HMM segmentation,
resegmentation, acoustic segmentation (port of
lia_ral_tpu/seg/diarization.py).

Equivalents of the LIA_SpkSeg tools (SURVEY.md §2.3):
* TurnDetection (TurnDetection.cpp:54-101): GLR/BIC over two sliding
  0.5 s windows, peak picking at α·σ;
* Segmentation (Segmentation.cpp:63-484): one-step E-HMM — iteratively
  add speakers (addSpeaker cpp:211), EM-train state models, Viterbi
  decode (cpp:459), stop criteria (cpp:275/332);
* ReSegmentation (ReSegmentation.cpp:55-328): rebuild the HMM from an
  existing segmentation, MAP-adapt speaker models + Viterbi loop;
* AcousticSegmentation (AcousticSegmentation.cpp:55-354): decode with
  pretrained event GMMs + minimum-duration rules.

Orchestration is host-side (matching the reference's loop structure over
small HMMs).  The per-frame compute runs on the device of ``world`` (or
of the event models): the emissions are one matrix product and a
logsumexp, the MAP statistics of all state rows are one launch of K1's
grouped entry a MAP iteration, over each row's own frames
(``gmm.em.grouped_stats_fn``), and the Viterbi recursion is the kernel of
``seg.hmm`` on CUDA tensors; CPU tensors take the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gmm.cuda_kernels import Groups, group_rows
from ..gmm.em import TrainCfg, grouped_stats_fn, m_step, train_model
from ..gmm.kernels import EmStats
from ..gmm.map_adapt import MapCfg, map_adapt
from ..gmm.model import GmmDiag
from ..utils.logging import count, recording, span
from .hmm import (DiarHmm, _log_trans, _viterbi, compute_transitions,
                  path_to_segments, stacked_emission_llk, viterbi_decode)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _frames(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def create_world(generator: torch.Generator, x: torch.Tensor,
                 w: torch.Tensor, max_distrib: int,
                 nb_train_it: int = 3) -> GmmDiag:
    """World model for diarization by binary-split init + EM (reference
    createWorld, Tools.cpp:1243-1271 → mixtureInitBySplit)."""
    from ..gmm.em import mixture_init_by_split
    return mixture_init_by_split(generator, x, w, max_distrib,
                                 TrainCfg(nb_train_it=nb_train_it))


def seg_em(generator: torch.Generator, x: torch.Tensor, w: torch.Tensor,
           init: GmmDiag, nb_train_it: int = 5) -> GmmDiag:
    """EM-train a state model on the frames of one segmentation mask
    (reference segEM, Tools.h:153)."""
    return train_model(generator, x, w, init,
                       TrainCfg(nb_train_it=nb_train_it))


def seg_adaptation(generator: torch.Generator, x: torch.Tensor,
                   hmm: DiarHmm, path: np.ndarray, world: GmmDiag,
                   min_state_frames: int = 1) -> tuple[DiarHmm, list[int]]:
    """MAP-adapt every HMM state on its currently assigned frames and drop
    states that lost all data (reference segAdaptation, Tools.cpp:1276 →
    NoDataSpeakerVerification, Tools.cpp:862-908).  Returns the updated
    HMM and the kept state indices."""
    s = hmm.n_states
    masks = (np.asarray(path)[None, :] == np.arange(s)[:, None]
             ).astype(np.float32)
    keep = [si for si in range(s) if masks[si].sum() >= min_state_frames]
    adapted = _batched_state_adapt(generator, x,
                                   torch.as_tensor(masks, device=x.device),
                                   world)
    idx = torch.as_tensor(np.asarray(keep, np.int64), device=x.device)
    kept = GmmDiag(adapted.weights[idx], adapted.means[idx],
                   adapted.cov_inv[idx])
    names = [hmm.names[si] for si in keep]
    return DiarHmm(gmms=kept, names=names,
                   log_trans=_log_trans(compute_transitions(len(keep)),
                                        x.device)), keep


def glr_distance_curve(x: torch.Tensor, window: int) -> torch.Tensor:
    """GLR between the two ``window``-frame windows around every frame
    (reference TurnDetection.cpp:54-78 runs the two-window scatter per
    frame from the host — a classic prefix sum):

        d[t] = 2w·log|Σ_merged| − w·(log|Σ_left| + log|Σ_right|)

    with diagonal covariances from cumulative Σx / Σx² (globally centred
    first so the f32 cumsums keep precision over long signals).
    Returns (N,) with zeros outside [window, N − window)."""
    n, d = x.shape
    x = x - torch.mean(x, dim=0)[None, :]
    zero = torch.zeros((1, d), dtype=x.dtype, device=x.device)
    c1 = torch.cat([zero, torch.cumsum(x, dim=0)])
    c2 = torch.cat([zero, torch.cumsum(x * x, dim=0)])

    def win_logdet(lo, hi):
        cnt = (hi - lo).to(x.dtype)[:, None]
        mean = (c1[hi] - c1[lo]) / cnt
        var = (c2[hi] - c2[lo]) / cnt - mean * mean
        return torch.sum(torch.log(torch.clamp(var, min=1e-8)), dim=1)

    t = torch.arange(n, device=x.device)
    t_lo = torch.clamp(t - window, 0, n)
    t_hi = torch.clamp(t + window, 0, n)
    ld_l = win_logdet(t_lo, t)
    ld_r = win_logdet(t, t_hi)
    ld_m = win_logdet(t_lo, t_hi)
    dist = (2 * window) * ld_m - window * (ld_l + ld_r)
    valid = (t >= window) & (t < n - window)
    return torch.where(valid, dist, torch.zeros_like(dist))


def turn_detection(x, window: int = 50, alpha: float = 0.6,
                   min_gap: int = 25, device=None) -> np.ndarray:
    """Speaker-turn candidates: GLR distance between the two windows
    around each frame, peaks above mean+α·σ, local-maximum pick with a
    minimum gap (reference TurnDetection.cpp:54-101).
    Returns frame indices of detected turns.

    ``x``: a numpy array (moved to ``device``) or a tensor (used where it
    lies).  The distance curve is one prefix-sum pass on the device
    (``glr_distance_curve``); only the tiny sequential peak pick stays on
    the host."""
    n = x.shape[0]
    if n < 2 * window + 1:
        return np.zeros(0, np.int64)
    xt = _frames(x, x.device if isinstance(x, torch.Tensor) else device)
    dists = glr_distance_curve(xt, window).cpu().numpy().astype(np.float64)
    thr = dists.mean() + alpha * dists.std()
    turns = []
    for t in range(window, n - window):
        lo, hi = max(t - min_gap, 0), min(t + min_gap + 1, n)
        if dists[t] >= thr and dists[t] == dists[lo:hi].max():
            if not turns or t - turns[-1] >= min_gap:
                turns.append(t)
    return np.asarray(turns, np.int64)


def _train_state_model(generator: torch.Generator, x, w, world: GmmDiag,
                       map_reg: float = 16.0, nb_it: int = 3) -> GmmDiag:
    """Speaker state model by MAP adaptation from the world (the
    reference's segEM/segAdaptation, Tools.h:152-153): the one row of
    ``_batched_state_adapt`` on the frame weights ``w``."""
    bank = _batched_state_adapt(generator, x, w[None], world,
                                map_reg=map_reg, nb_it=nb_it)
    return GmmDiag(bank.weights[0], bank.means[0], bank.cov_inv[0])


def _gather_rows(x: torch.Tensor, masks: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor, Groups]:
    """The frames of non-zero mask of each row of ``masks`` (S, N), for
    the grouped stats pass of K = ``k`` components: frames (P, D) and
    weights (P,) (the mask values), laid out by row as the returned
    ``Groups`` says, with weight 0 in the frames that align the rows.
    One host read, of the rows' frame counts."""
    nz = masks != 0
    counts = nz.sum(1).tolist()
    groups = group_rows(counts, k, x.device)
    nnz = sum(counts)
    pos = torch.nonzero_static(nz, size=nnz)           # row-major
    rows, frames = pos[:, 0], pos[:, 1]
    # the i-th frame of row r goes to groups.starts[r] + i
    first = np.cumsum([0] + counts[:-1])
    shift = torch.as_tensor(np.asarray(groups.starts) - first,
                            device=x.device)
    dest = torch.arange(nnz, device=x.device) + shift[rows]
    xc = x.new_zeros((groups.n_frames, x.shape[1]))
    xc.index_copy_(0, dest, x.index_select(0, frames))
    wc = masks.new_zeros(groups.n_frames)
    wc.index_copy_(0, dest, masks[rows, frames])
    if x.device.type == "cuda":
        count("lia.seg.h2d_bytes", shift.nbytes + (
            groups.table.nbytes if groups.table is not None else 0))
    return xc, wc, groups


def _batched_state_adapt(generator: torch.Generator, x: torch.Tensor,
                         masks: torch.Tensor, world: GmmDiag,
                         map_reg: float = 16.0, nb_it: int = 3) -> GmmDiag:
    """MAP-adapt one state model per mask row, stacked with a leading
    state axis — the reference's per-speaker segAdaptation loop
    (Tools.cpp:1276): for each row what ``adapt_model`` gives with
    MAPOccDep on means and weights (relevance factor ``map_reg``,
    ``nb_it`` iterations, no bagging, so ``generator`` draws nothing).
    Each row's frames of non-zero mask are gathered once, the mask values
    as weights; each iteration takes every row's stats under its own
    model in one grouped pass (on the card one launch of K1's grouped
    entry; none where no row has a frame) and updates every row at once.
    A row whose mask is all zero comes back as the world (zero occupancy
    keeps the prior, every number finite), so callers can pad to a fixed
    state count."""
    s = masks.shape[0]
    k, d = world.means.shape
    xc, wc, groups = _gather_rows(x, masks, k)
    frames = sum(groups.counts)
    stats_fn = grouped_stats_fn()
    cfg = MapCfg(method="MAPOccDep", mean_adapt=True, weight_adapt=True,
                 mean_r=map_reg, weight_r=map_reg, nb_train_it=nb_it)
    cov_inv = world.cov_inv.expand(s, k, d).contiguous()
    bank = GmmDiag(world.weights.expand(s, k).contiguous(),
                   world.means.expand(s, k, d).contiguous(), cov_inv)
    none = (None if frames
            else EmStats.stack([EmStats.zeros(k, d, device=x.device)] * s))
    for _ in range(nb_it):
        st = stats_fn(xc, wc, bank, groups) if frames else none
        bank = map_adapt(world, m_step(st), st.count, cfg).replace(
            cov_inv=cov_inv)
    if frames:
        count("lia.seg.grouped_launches", nb_it)
        count("lia.seg.grouped_frames", nb_it * frames)
        count("lia.seg.grouped_pad_frames", nb_it * groups.pad_frames)
    return bank


def _merge_state_rows(old: GmmDiag, new: GmmDiag, take_new) -> GmmDiag:
    """Per-state select between two stacked GmmDiags."""
    take = torch.as_tensor(np.asarray(take_new, bool), device=old.device)

    def pick(o, nw):
        return torch.where(take.reshape((-1,) + (1,) * (o.dim() - 1)), nw, o)
    return GmmDiag(pick(old.weights, new.weights),
                   pick(old.means, new.means),
                   pick(old.cov_inv, new.cov_inv))


def _masked_emissions(x: torch.Tensor, gmms: GmmDiag,
                      active_mask) -> torch.Tensor:
    """Per-frame per-state emissions with inactive (padding) states forced
    to −1e30 so Viterbi never enters them."""
    em = stacked_emission_llk(x, gmms)
    active = torch.as_tensor(np.asarray(active_mask, np.float32),
                             device=x.device)
    return torch.where(active[None, :] > 0, em,
                       torch.full_like(em, -1e30))


def _host_frames(x, device) -> torch.Tensor:
    """``_frames``, counting the bytes of a host array sent to the device."""
    xt = _frames(x, device)
    if not isinstance(x, torch.Tensor):
        count("lia.seg.h2d_bytes", xt.numel() * 4)
    return xt


def _path_masks(path: np.ndarray, s: int) -> np.ndarray:
    """(S, N) 0/1 float32 masks of a state path: row i marks the frames
    labelled i (a label outside 0..S−1 marks none)."""
    return (path[None, :] == np.arange(s)[:, None]).astype(np.float32)


def _adapt_states(generator: torch.Generator, x: torch.Tensor, build,
                  world: GmmDiag, map_reg: float) -> GmmDiag:
    """``_batched_state_adapt`` on the (S, N) masks that ``build()``
    makes on the host, copied to ``x``'s device."""
    with span("lia.seg.adapt"):
        with span("lia.seg.masks"):
            masks_np = build()
            masks = torch.as_tensor(masks_np, device=x.device)
        if recording():
            count("lia.seg.state_adapts", masks_np.shape[0])
            count("lia.seg.empty_adapts",
                  int((~masks_np.any(axis=1)).sum()))
            count("lia.seg.h2d_bytes", masks_np.nbytes)
        return _batched_state_adapt(generator, x, masks, world,
                                    map_reg=map_reg)


def _decode(x: torch.Tensor, bank: GmmDiag, active_mask, trans: np.ndarray,
            with_emissions: bool = False):
    """One decode of the stacked states: the emissions (inactive states at
    −1e30), the Viterbi path under the (S, S) transition probabilities
    ``trans`` on the device, and the path read back to the host, with the
    (N, S) emissions too where ``with_emissions``.  Returns (path,
    emissions or None) as numpy arrays."""
    with span("lia.seg.decode"):
        log_trans = torch.log(torch.as_tensor(trans, dtype=torch.float32,
                                              device=x.device))
        with span("lia.seg.emissions"):
            em = _masked_emissions(x, bank, active_mask)
        with span("lia.seg.viterbi"):
            path_t = _viterbi(em, log_trans)
        with span("lia.seg.d2h"):
            path = path_t.cpu().numpy()
            em_host = em.cpu().numpy() if with_emissions else None
        n, s = em.shape
        count("lia.seg.decodes")
        count("lia.seg.viterbi_frames", n)
        count("lia.seg.h2d_bytes", (s * s + s) * 4)
        count("lia.seg.d2h_bytes",
              path.nbytes + (em_host.nbytes if with_emissions else 0))
    return path, em_host


def e_hmm_segmentation(
    x,
    world: GmmDiag,
    max_speakers: int = 5,
    init_seg_frames: int = 300,
    nb_decode_it: int = 3,
    min_duration: int = 50,
    frame_length: float = 0.01,
    seed: int = 0,
    map_reg: float = 16.0,
    verbose: bool = False,
):
    """E-HMM speaker segmentation (reference Segmentation.cpp:356-484).

    Iteratively: pick the region worst-explained by existing speakers as
    the seed of a new speaker, MAP-train its model, re-decode with the
    grown HMM, until max_speakers or no region left.

    Runs on ``world``'s device.  The state bank is padded to
    ``max_speakers`` rows with an activity mask, as in the JAX package
    (there for one compiled executable a run; here it keeps the two
    packages' arithmetic the same row for row).  A run with S =
    ``max_speakers`` makes 1 + (S−1)·(1 + nbDecodeIt) batched adaptations
    (each 3 MAP iterations, one grouped K1 launch each over the S rows'
    own frames) and 2 + (S−1)·(nbDecodeIt + 1) decodes.  Returns
    (segments, state path)."""
    with span("lia.seg.e_hmm"):
        return _e_hmm(x, world, max_speakers, init_seg_frames, nb_decode_it,
                      min_duration, frame_length, seed, map_reg, verbose)


def _e_hmm(x, world, max_speakers, init_seg_frames, nb_decode_it,
           min_duration, frame_length, seed, map_reg, verbose):
    dev = world.device
    xt = _host_frames(x, dev)
    n = xt.shape[0]
    s_max = max(max_speakers, 1)
    gen = _generator(seed, dev)

    def full_trans(active: int) -> np.ndarray:
        t = np.full((s_max, s_max), 1e-30)
        t[:active, :active] = compute_transitions(active)
        return t

    def adapt(build) -> GmmDiag:
        # map_reg is the reference's MAPRegFactor reaching segAdaptation
        # (Tools.cpp:1276); a seed of init_seg_frames frames over K
        # components moves its means only occ/(occ+r) per iteration, so
        # strong priors can starve new speakers of any Viterbi frames
        return _adapt_states(gen, xt, build, world, map_reg)

    def first_masks() -> np.ndarray:
        # state 0 trained on all frames (reference addSpeaker on L0 world)
        masks = np.zeros((s_max, n), np.float32)
        masks[0] = 1.0
        return masks

    bank = adapt(first_masks)
    active = 1
    names = ["S0"]

    def decode(bank, active):
        return _decode(xt, bank, np.arange(s_max) < active,
                       full_trans(active), with_emissions=True)

    path, em = decode(bank, active)
    for spk in range(1, max_speakers):
        # per-frame LLK of the assigned state → worst window seeds S_spk
        assigned = em[np.arange(n), path]
        if n <= init_seg_frames:
            break
        window_scores = np.convolve(assigned,
                                    np.ones(init_seg_frames) / init_seg_frames,
                                    mode="valid")
        start = int(np.argmin(window_scores))

        def seed_masks(spk=spk, start=start) -> np.ndarray:
            masks = np.zeros((s_max, n), np.float32)
            masks[spk, start:start + init_seg_frames] = 1.0
            return masks

        bank = _merge_state_rows(bank, adapt(seed_masks),
                                 np.arange(s_max) == spk)
        active = spk + 1
        names.append(f"S{spk}")
        # iterative decode + batched re-adapt (reference nbDecodeIt loop)
        for _ in range(nb_decode_it):
            path, em = decode(bank, active)
            counts = np.bincount(path, minlength=s_max)
            # states with <10 assigned frames keep their previous model
            bank = _merge_state_rows(
                bank, adapt(lambda path=path: _path_masks(path, s_max)),
                counts >= 10)
        # re-decode with the final adapted bank so the NEXT speaker's
        # worst-window seeding (and the loop-exit path) uses fresh
        # emissions — the reference re-decodes with the current HMM
        # before seeding (Segmentation.cpp:459 then addSpeaker cpp:211)
        path, em = decode(bank, active)
        if verbose:
            print(f"E-HMM: {active} speakers, "
                  f"frames/state={np.bincount(path, minlength=active)}")
    path, _ = decode(bank, active)
    segs = path_to_segments(path, names, frame_length, min_duration)
    return segs, path


def resegmentation(
    x,
    segments,
    world: GmmDiag,
    nb_it: int = 3,
    min_duration: int = 50,
    min_state_frames: int = 25,
    frame_length: float = 0.01,
    seed: int = 0,
    map_reg: float = 16.0,
):
    """Refinement pass (reference ReSegmentation.cpp:245-328): rebuild the
    HMM from an existing segmentation, MAP-adapt state models, Viterbi
    re-decode, drop speakers that lose all their frames.  Runs on
    ``world``'s device.  With S the segments' labels it makes 1 + nb_it
    batched adaptations of S rows and nb_it + 1 decodes."""
    with span("lia.seg.reseg"):
        return _reseg(x, segments, world, nb_it, min_duration,
                      min_state_frames, frame_length, seed, map_reg)


def _reseg(x, segments, world, nb_it, min_duration, min_state_frames,
           frame_length, seed, map_reg):
    from ..io.labels import segments_to_frame_mask
    dev = world.device
    xt = _host_frames(x, dev)
    n = xt.shape[0]
    names = sorted({s.label for s in segments})
    s = len(names)
    gen = _generator(seed, dev)

    def label_masks() -> np.ndarray:
        return np.stack([
            np.asarray(segments_to_frame_mask(
                [sg for sg in segments if sg.label == nm], n, frame_length),
                np.float32)
            for nm in names])                               # (S, N)

    def adapt(build) -> GmmDiag:
        return _adapt_states(gen, xt, build, world, map_reg)

    bank = adapt(label_masks)
    # fixed (S,)-shaped state bank + activity mask: dropped speakers get
    # −1e30 emissions instead of a shape change, as in the JAX package
    active = np.ones(s, bool)

    def trans(act: np.ndarray) -> np.ndarray:
        """Transitions over the REMAINING states embedded in the fixed
        (s, s) matrix — the reference rebuilds the HMM over the surviving
        speakers after a drop (ReSegmentation.cpp:245-328), so the
        off-diagonal mass must be split over (n_active − 1) states, not
        the original (s − 1)."""
        t = np.full((s, s), 1e-30)
        idx = np.nonzero(act)[0]
        t[np.ix_(idx, idx)] = compute_transitions(max(len(idx), 1))
        return t

    def decode() -> np.ndarray:
        return _decode(xt, bank, active, trans(active))[0]

    for _ in range(nb_it):
        path = decode()
        counts = np.bincount(path, minlength=s)
        active &= counts >= min_state_frames   # drop irrelevant speakers
        bank = adapt(lambda path=path: _path_masks(
            np.where(active[path], path, -1), s))
    path = decode()
    return path_to_segments(path, names, frame_length, min_duration), path


def acoustic_segmentation(
    x,
    event_models: list[GmmDiag],
    event_names: list[str],
    min_duration: int = 30,
    frame_length: float = 0.01,
):
    """SAD/acoustic event segmentation with pretrained GMMs (reference
    AcousticSegmentation.cpp:258-354): Viterbi over the event HMM with
    minimum-duration post-rules.  Runs on the event models' device."""
    hmm = DiarHmm.from_gmms(event_models, event_names)
    path = viterbi_decode(_frames(x, hmm.gmms.device), hmm)
    return path_to_segments(path, event_names, frame_length, min_duration), path
