"""Plain reference of LIA_SpkSeg's E-HMM speaker segmentation and of its
ReSegmentation: the LIA broadcast-news diarization system of Meignier,
Moraru, Fredouille, Bonastre and Besacier, "Step-by-step and integrated
approaches in broadcast news speaker diarization", Computer Speech &
Language 20(2-3), 2006, as Segmentation.cpp and ReSegmentation.cpp run it.

Plain ``torch`` in the dtype of the caller's tensors: float64 for the
reference, float32 where a control runs it in a lower precision.  TF32 is
set off on import, so a float32 product is a float32 product unless a
caller turns TF32 on around a call.  Imports nothing of the program and
no JAX.  A model is a (weights (K,), means (K, D), variances (K, D))
tuple; a bank of S states stacks them as (S, K), (S, K, D), (S, K, D).

What it holds:

* ``logdens``, ``emissions``: diagonal-GMM log-densities log(w_k N(x;
  μ_k, σ²_k)) and each state's log-likelihood (a logsumexp over its
  components), in blocks of frames;
* ``viterbi``: the log-domain decoder, a loop over frames vectorised over
  states, the first index on a tie, back pointers and a backtrace;
  ``path_score`` scores any state sequence;
* ``map_adapt``: MAPOccDep adaptation of means and weights from the world
  (the relevance factor ``reg`` for both, variances kept), ``nb_it``
  iterations, one state per row of a stack of 0/1 frame masks;
* ``compute_transitions``: the self-loop 0.8, the rest spread evenly;
* ``e_hmm``: the E-HMM loop: state 0 adapted on every frame, then for
  each new speaker the worst-explained window of ``init_seg_frames``
  frames seeds it, ``nb_decode_it`` rounds of decoding and re-adapting
  every state follow (a state left with under 10 frames keeps its model),
  then one re-decode;
* ``reseg_masks``, ``resegmentation``: the label file that the E-HMM
  writes, read back as ReSegmentation reads it, then ``nb_it`` rounds of
  decoding and re-adapting, states under ``min_state_frames`` dropped.

Departures from the C++ tools, each shared with the port it is held
against:

* no stop criterion (Segmentation.cpp:275/332): the model always grows
  to ``max_speakers`` states;
* masked adaptation over all frames: a state's MAP statistics are summed
  over every frame of the show under a 0/1 weight, where the tools gather
  the state's own segments; zero weights add nothing, so only rounding
  differs;
* the state bank keeps ``max_speakers`` rows (ReSegmentation: the label
  file's states); a state not yet added or dropped has emissions of
  −1e30 and transition probabilities of 1e-30, where the tools rebuild a
  smaller HMM;
* a decoded path labels frame t with the best state of frame t + 1 and
  the last frame with its own (``port_labels``): the labelling of the JAX
  package's reverse scan, which the port keeps;
* every frame is kept in each MAP iteration (no bagging), and the
  iterations of one adaptation start from the world each time with the
  statistics of the model the last one gave (TrainTools.cpp adaptModel).
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

INACTIVE = -1e30        # emission of a state not in the HMM
NO_TRANS = 1e-30        # transition probability into or out of one
MIN_KEEP = 10           # E-HMM: fewer frames keep a state's last model
BLOCK = 32768           # frames a block


def compute_transitions(n_states: int, gamma: float = 0.8,
                        dtype=torch.float64) -> torch.Tensor:
    """(S, S) transition probabilities: ``gamma`` on the diagonal, the
    rest spread over the other states (Tools.h computeTransitions)."""
    if n_states == 1:
        return torch.ones((1, 1), dtype=dtype)
    t = torch.full((n_states, n_states), (1.0 - gamma) / (n_states - 1),
                   dtype=dtype)
    t.fill_diagonal_(gamma)
    return t


def log_transitions(n_rows: int, active: torch.Tensor,
                    dtype=torch.float64) -> torch.Tensor:
    """log of the (n_rows, n_rows) transitions among the ``active``
    states (bool (n_rows,)), ``NO_TRANS`` everywhere else."""
    t = torch.full((n_rows, n_rows), NO_TRANS, dtype=dtype)
    idx = torch.nonzero(active.cpu()).flatten()
    if len(idx):
        t[idx[:, None], idx[None, :]] = compute_transitions(len(idx),
                                                            dtype=dtype)
    return torch.log(t)


def logdens(x: torch.Tensor, weights, means, var) -> torch.Tensor:
    """log(w_k N(x; μ_k, σ²_k)), (B, ..., K) for frames x (B, D) and a
    model or a bank (weights (..., K), means and variances (..., K, D))."""
    d = means.shape[-1]
    ivar = 1.0 / var
    const = (torch.log(weights) - 0.5 * (d * math.log(2 * math.pi)
                                        + torch.log(var).sum(-1))
             - 0.5 * (means * means * ivar).sum(-1))
    ld = (-0.5 * (x * x) @ ivar.reshape(-1, d).T
          + x @ (means * ivar).reshape(-1, d).T + const.reshape(-1))
    return ld.reshape((x.shape[0],) + tuple(weights.shape))


def emissions(x: torch.Tensor, bank, active: torch.Tensor | None = None,
              block: int = BLOCK) -> torch.Tensor:
    """(N, S) log-likelihood of each frame under each state of ``bank``;
    states outside ``active`` (bool (S,)) at ``INACTIVE``."""
    out = torch.cat([torch.logsumexp(logdens(x[a:a + block], *bank), -1)
                     for a in range(0, x.shape[0], block)])
    if active is not None:
        out[:, ~active.to(out.device)] = INACTIVE
    return out


def viterbi(em: torch.Tensor, log_trans: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The best state sequence (N,) of emissions (N, S) and its score:
    δ₀ = em₀ − log S; δ_t(j) = max_i (δ_{t−1}(i) + log a_ij) + em_t(j),
    the first i on a tie; the last state is the first argmax of δ, and
    the back pointers give the rest."""
    n, s = em.shape
    em = em.cpu()
    lt = log_trans.to(em)
    delta = em[0] - math.log(s)
    back = torch.empty((max(n - 1, 0), s), dtype=torch.int64)
    for t in range(1, n):
        best, arg = torch.max(delta[:, None] + lt, dim=0)
        back[t - 1] = arg
        delta = best + em[t]
    states = torch.empty(n, dtype=torch.int64)
    state = int(torch.argmax(delta))
    states[n - 1] = state
    bp = back.numpy()
    for t in range(n - 2, -1, -1):
        state = int(bp[t, state])
        states[t] = state
    return states, delta.max()


def path_score(em: torch.Tensor, log_trans: torch.Tensor,
               states: torch.Tensor) -> torch.Tensor:
    """em₀(s₀) − log S + Σ_t (log a(s_{t−1}, s_t) + em_t(s_t))."""
    em = em.cpu()
    lt = log_trans.to(em)
    states = states.cpu()
    n, s = em.shape
    return (em[torch.arange(n), states].sum() - math.log(s)
            + lt[states[:-1], states[1:]].sum())


def port_labels(states: torch.Tensor) -> torch.Tensor:
    """A state sequence as the port labels it: frame t takes the state of
    frame t + 1, the last frame its own."""
    return torch.cat([states[1:], states[-1:]])


def states_of_labels(labels: torch.Tensor, em: torch.Tensor,
                     log_trans: torch.Tensor) -> torch.Tensor:
    """The state sequence that port labels stand for: frames 1..N−1 from
    the labels, frame 0 the best start into frame 1's state."""
    em = em.cpu()
    lt = log_trans.to(em)
    labels = labels.cpu()
    if labels.shape[0] < 2:
        return labels.clone()
    first = torch.argmax(em[0] + lt[:, labels[0]])
    return torch.cat([first[None], labels[:-1]])


def map_adapt(x: torch.Tensor, masks: torch.Tensor, world, nb_it: int = 3,
              reg: float = 16.0, block: int = BLOCK):
    """MAPOccDep of means and weights, one state per row of the 0/1 masks
    (S, N), each from the world over ``nb_it`` iterations; returns the
    bank.  Each iteration: the statistics of the masked frames under the
    last model (n_k, Σ γ x), the M-step (means Σγx / max(n, 1e-6),
    weights n / Σ mask renormalised, uniform where nothing was counted),
    then α_k = occ_k / (occ_k + reg) with occ_k = w_k Σ mask, means
    (1 − α) μ_world + α μ_em and weights α w_em + (1 − α) w_world,
    renormalised.  A row of zeros gives the world back."""
    ww, wm, wv = world
    s = masks.shape[0]
    k, d = wm.shape
    weights = ww.expand(s, k).clone()
    means = wm.expand(s, k, d).clone()
    var = wv.expand(s, k, d).clone()
    count = masks.sum(1)                                     # (S,)
    for _ in range(nb_it):
        n = torch.zeros((s, k), dtype=x.dtype, device=x.device)
        sx = torch.zeros((s, k, d), dtype=x.dtype, device=x.device)
        for a in range(0, x.shape[0], block):
            xb = x[a:a + block]
            p = torch.softmax(logdens(xb, weights, means, var), -1)
            p = p * masks[:, a:a + block].T[:, :, None]      # (B, S, K)
            n += p.sum(0)
            sx += (p.reshape(xb.shape[0], s * k).T @ xb).reshape(s, k, d)
        em_means = sx / torch.clamp(n, min=1e-6)[..., None]
        em_w = n / torch.clamp(count, min=1e-30)[:, None]
        wsum = em_w.sum(1, keepdim=True)
        em_w = torch.where(wsum > 0, em_w / torch.clamp(wsum, min=1e-30),
                           torch.full_like(em_w, 1.0 / k))
        occ = em_w * count[:, None]
        alpha = occ / (occ + reg)
        means = ((1.0 - alpha)[..., None] * wm[None]
                 + alpha[..., None] * em_means)
        w = alpha * em_w + (1.0 - alpha) * ww[None]
        weights = w / w.sum(1, keepdim=True)
    return weights, means, var


def _one_hot(labels: torch.Tensor, s: int, dtype) -> torch.Tensor:
    return (labels[None, :] == torch.arange(s, device=labels.device)[:, None]
            ).to(dtype)


def _pick(take: torch.Tensor, new, old):
    """Rows of bank ``new`` where ``take`` (S,), else of ``old``."""
    return tuple(torch.where(take.reshape((-1,) + (1,) * (a.dim() - 1)),
                             a, b) for a, b in zip(new, old))


def e_hmm(x: torch.Tensor, world, max_speakers: int,
          init_seg_frames: int = 300, nb_decode_it: int = 3,
          reg: float = 16.0, nb_it: int = 3):
    """E-HMM segmentation of frames x (N, D); returns (port labels (N,),
    the number of states in the HMM)."""
    n = x.shape[0]
    s_max = max(max_speakers, 1)
    dt, dev = x.dtype, x.device
    rows = torch.arange(s_max)

    def decode(bank, active: int):
        act = rows < active
        em = emissions(x, bank, act)
        states, _ = viterbi(em, log_transitions(s_max, act, dt))
        return port_labels(states), em.cpu()

    masks = torch.zeros((s_max, n), dtype=dt, device=dev)
    masks[0] = 1.0
    bank = map_adapt(x, masks, world, nb_it, reg)
    active = 1
    path, em = decode(bank, active)
    for spk in range(1, max_speakers):
        if n <= init_seg_frames:
            break
        assigned = em[torch.arange(n), path]
        c = torch.cat([torch.zeros(1, dtype=dt), torch.cumsum(assigned, 0)])
        window = (c[init_seg_frames:] - c[:-init_seg_frames]) / init_seg_frames
        start = int(torch.argmin(window))
        seed = torch.zeros((s_max, n), dtype=dt, device=dev)
        seed[spk, start:start + init_seg_frames] = 1.0
        bank = _pick((rows == spk).to(dev), map_adapt(x, seed, world, nb_it,
                                                     reg), bank)
        active = spk + 1
        for _ in range(nb_decode_it):
            path, em = decode(bank, active)
            masks = _one_hot(path.to(dev), s_max, dt)
            keep = (masks.sum(1) >= MIN_KEEP)
            bank = _pick(keep, map_adapt(x, masks, world, nb_it, reg), bank)
        path, em = decode(bank, active)
    path, _ = decode(bank, active)
    return path, active


def runs(labels: torch.Tensor, min_duration: int = 0) -> list:
    """[start, stop, state] runs of per-frame labels; a run shorter than
    ``min_duration`` frames (not the first) joins the run before it, and
    neighbouring runs of one state then merge."""
    lab = labels.cpu().tolist()
    out = []
    start = 0
    for i in range(1, len(lab) + 1):
        if i == len(lab) or lab[i] != lab[start]:
            out.append([start, i, lab[start]])
            start = i
    if min_duration > 0:
        merged = []
        for r in out:
            if merged and r[1] - r[0] < min_duration:
                merged[-1][1] = r[1]
            else:
                merged.append(r)
        out = []
        for r in merged:
            if out and out[-1][2] == r[2]:
                out[-1][1] = r[1]
            else:
                out.append(r)
    return out


def reseg_masks(labels: torch.Tensor, min_duration: int = 50,
                dtype=torch.float64):
    """The (S, N) masks that ReSegmentation reads from the E-HMM's label
    file: states named S<i>, in the order of their names (as strings), a
    run [a, b) of the labels after the minimum-duration rule written as
    times and read back as frames a..b, end inclusive (SegTools.cpp
    208-209).  Returns (masks, the state of each row)."""
    n = labels.shape[0]
    segs = runs(labels, min_duration)
    states = sorted({st for _, _, st in segs}, key=lambda st: f"S{st}")
    row = {st: i for i, st in enumerate(states)}
    masks = torch.zeros((len(states), n), dtype=dtype)
    for a, b, st in segs:
        masks[row[st], a:min(b + 1, n)] = 1.0
    return masks, states


def resegmentation(x: torch.Tensor, masks: torch.Tensor, world,
                   nb_it: int = 3, min_state_frames: int = 25,
                   reg: float = 16.0, nb_map_it: int = 3):
    """ReSegmentation of frames x from the masks (S, N) of its label file;
    returns (port labels (N,), the states left in the HMM)."""
    s = masks.shape[0]
    dt, dev = x.dtype, x.device
    masks = masks.to(dev, dt)
    bank = map_adapt(x, masks, world, nb_map_it, reg)
    active = torch.ones(s, dtype=torch.bool)

    def decode():
        em = emissions(x, bank, active)
        states, _ = viterbi(em, log_transitions(s, active, dt))
        return port_labels(states)

    for _ in range(nb_it):
        path = decode()
        counts = torch.bincount(path, minlength=s)
        active &= counts >= min_state_frames
        masks = _one_hot(path, s, dt) * active[:, None].to(dt)
        bank = map_adapt(x, masks.to(dev), world, nb_map_it, reg)
    return decode(), int(active.sum())
