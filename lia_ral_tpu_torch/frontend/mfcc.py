"""MFCC extraction (filter-bank cepstra) — replaces the external SPro L0
(port of lia_ral_tpu/frontend/mfcc.py).

The reference does not extract features itself (README.md "Feature
extraction": SPro or HTK produce the .prm files; SimpleSpkDetSystem calls
spro_cepstral_analysis, SimpleSpkDetSystem.cpp:470).  This module provides
an MFCC front end with the SPro-style pipeline: pre-emphasis → framing →
Hamming window → |FFT| → mel filter bank → log → DCT → optional
log-energy and deltas.  Batched over frames on the signal's device:
``torch.fft.rfft`` and two small matrix products.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class MfccCfg:
    sample_rate: float = 8000.0
    frame_length_s: float = 0.020     # SPro default 20 ms
    frame_shift_s: float = 0.010      # 10 ms (reference frameLength 0.01)
    n_filters: int = 24
    n_ceps: int = 19                  # BASELINE config 1: 19-dim MFCC
    pre_emphasis: float = 0.95
    with_energy: bool = True
    freq_min: float = 0.0
    freq_max: float = 0.0             # 0 → Nyquist


def _mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _imel(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(n_fft: int, n_filters: int, sample_rate: float,
                   fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filter bank (n_fft//2+1, n_filters)."""
    if fmax <= 0:
        fmax = sample_rate / 2
    mels = np.linspace(_mel(fmin), _mel(fmax), n_filters + 2)
    hz = _imel(mels)
    bins = np.floor((n_fft + 1) * hz / sample_rate).astype(int)
    fb = np.zeros((n_fft // 2 + 1, n_filters))
    for j in range(n_filters):
        lo, c, hi = bins[j], bins[j + 1], bins[j + 2]
        for i in range(lo, c):
            if c > lo:
                fb[i, j] = (i - lo) / (c - lo)
        for i in range(c, hi):
            if hi > c:
                fb[i, j] = (hi - i) / (hi - c)
    return fb


def dct_matrix(n_ceps: int, n_filters: int) -> np.ndarray:
    """DCT-II basis (n_filters, n_ceps), c0 excluded (SPro convention)."""
    j = np.arange(n_filters)
    out = np.zeros((n_filters, n_ceps))
    for i in range(1, n_ceps + 1):
        out[:, i - 1] = np.cos(math.pi * i * (j + 0.5) / n_filters)
    return out * math.sqrt(2.0 / n_filters)


def mfcc(signal: torch.Tensor, cfg: MfccCfg | None = None) -> torch.Tensor:
    """signal (S,) float → (N, n_ceps[+1]) MFCC frames (energy last,
    matching the fixture layout where featureServerMask drops column 16)."""
    cfg = cfg or MfccCfg()
    flen = int(round(cfg.frame_length_s * cfg.sample_rate))
    shift = int(round(cfg.frame_shift_s * cfg.sample_rate))
    n_fft = 1 << max(8, (flen - 1).bit_length())
    sig = torch.as_tensor(signal).to(torch.float32)
    dev = sig.device
    # pre-emphasis
    sig = torch.cat([sig[:1], sig[1:] - cfg.pre_emphasis * sig[:-1]])
    n_frames = max((sig.shape[0] - flen) // shift + 1, 0)
    if n_frames == 0:       # shorter than one frame (an FFT of nothing raises)
        return torch.zeros((0, cfg.n_ceps + int(cfg.with_energy)),
                           dtype=torch.float32, device=dev)
    idx = (torch.arange(n_frames, device=dev)[:, None] * shift
           + torch.arange(flen, device=dev)[None, :])          # (N,flen)
    frames = sig[idx]
    window = torch.as_tensor(np.hamming(flen), dtype=torch.float32,
                             device=dev)
    fw = frames * window[None, :]
    spec = torch.abs(torch.fft.rfft(fw, n=n_fft, dim=-1))     # (N,F)
    fb = torch.as_tensor(mel_filterbank(n_fft, cfg.n_filters,
                                        cfg.sample_rate, cfg.freq_min,
                                        cfg.freq_max),
                         dtype=torch.float32, device=dev)
    logmel = torch.log(torch.clamp(spec @ fb, min=1e-10))     # (N,M)
    dct = torch.as_tensor(dct_matrix(cfg.n_ceps, cfg.n_filters),
                          dtype=torch.float32, device=dev)
    ceps = logmel @ dct                                       # (N,C)
    if cfg.with_energy:
        energy = torch.log(torch.clamp(torch.sum(fw * fw, dim=-1),
                                       min=1e-10))
        ceps = torch.cat([ceps, energy[:, None]], dim=-1)
    return ceps


def add_deltas(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Append delta coefficients (SPro WITHD): regression over ±window."""
    num = torch.zeros_like(x)
    den = 0.0
    for t in range(1, window + 1):
        fwd = torch.cat([x[t:], x[-1:].repeat_interleave(t, dim=0)])
        bwd = torch.cat([x[:1].repeat_interleave(t, dim=0), x[:-t]])
        num = num + t * (fwd - bwd)
        den += 2.0 * t * t
    return torch.cat([x, num / den], dim=-1)
