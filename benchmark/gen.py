"""Traffic and data made from the seed, on the device.

Everything a cell feeds the program and the reference comes from here:
the generating GMMs, frames drawn from them with speaker shifts, the
i-vector corpus, and the draws of the traffic (lengths, claims).  Each
purpose has its own stream, ``stream(seed, name)``, so adding a draw to
one purpose moves no other.  Imports torch and numpy only.

Patterns copied from the repo's ``chip_smoke.py`` (``random_gmm``,
``corpus``) and rewritten to draw on the device in a few large calls.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def stream(seed: int, name: str, device) -> torch.Generator:
    """A generator on ``device`` keyed by the run's seed and a purpose."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return g


def host_rng(seed: int, name: str) -> np.random.Generator:
    """A numpy generator keyed like ``stream``, for small host draws."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def random_gmm(g: torch.Generator, k: int, d: int, spread: float):
    """(weights (K,), means (K,D), variances (K,D)) in float32: weights
    0.5-1.5 normalised, means N(0, spread²), variances 0.5-1.5.  A spread
    near 4/sqrt(2D) puts two components' means about 4σ apart, so that a
    frame's posterior is shared among a few components, as with a
    trained UBM."""
    dev = g.device
    w = torch.rand(k, generator=g, device=dev) + 0.5
    means = torch.randn(k, d, generator=g, device=dev) * spread
    var = torch.rand(k, d, generator=g, device=dev) + 0.5
    return w / w.sum(), means, var


def draw_components(g: torch.Generator, weights: torch.Tensor,
                    n: int) -> torch.Tensor:
    """n component indices drawn by the mixture weights."""
    cdf = torch.cumsum(weights.double(), 0)
    u = torch.rand(n, generator=g, device=weights.device,
                   dtype=torch.float64) * cdf[-1]
    return torch.clamp(torch.searchsorted(cdf, u), max=weights.shape[0] - 1)


def gmm_frames(g: torch.Generator, weights, means, var, n: int,
               offsets: torch.Tensor | None = None) -> torch.Tensor:
    """n frames of the mixture; ``offsets`` (K,D), if given, moves each
    component's mean (a speaker's own component offsets)."""
    comp = draw_components(g, weights, n)
    noise = torch.randn(n, means.shape[1], generator=g, device=means.device)
    mu = means if offsets is None else means + offsets
    return mu[comp] + torch.sqrt(var)[comp] * noise


def sides_corpus(g: torch.Generator, weights, means, var, sides: int,
                 frames: int, shift_scale: float, block: int = 32
                 ) -> torch.Tensor:
    """``sides`` conversation sides of ``frames`` frames each, (S·T, D):
    frames of the generating mixture, each side moved by its own
    speaker shift, made ``block`` sides at a time."""
    d = means.shape[1]
    out = torch.empty(sides * frames, d, device=means.device)
    for s0 in range(0, sides, block):
        s1 = min(sides, s0 + block)
        n = (s1 - s0) * frames
        shift = torch.randn(s1 - s0, d, generator=g, device=means.device)
        x = gmm_frames(g, weights, means, var, n)
        x += (shift * shift_scale).repeat_interleave(frames, 0)
        out[s0 * frames:s1 * frames] = x
    return out


def spread_ints(g: torch.Generator, lo: int, hi: int, n: int
                ) -> torch.Tensor:
    """n integers spread evenly over [lo, hi] (the quantiles of the uniform
    law), in an order drawn from the generator: every seed gets the same
    set of sizes, so the work of a pass does not move with the seed."""
    vals = torch.round(torch.linspace(lo, hi, n, dtype=torch.float64))
    perm = torch.randperm(n, generator=g, device=g.device)
    return vals.to(g.device)[perm].long()


def ivector_corpus(g: torch.Generator, weights, means, var, t_mat,
                   lengths: torch.Tensor, t_max: int, block: int = 128):
    """Padded segments (S, t_max, D) and their mask (S, t_max): frames of
    the UBM whose component means are moved by the segment's supervector
    shift Tᵀw (w ~ N(0, I)), the tail past each length zero."""
    s = lengths.shape[0]
    r, k, d = t_mat.shape
    dev = means.device
    x = torch.zeros(s, t_max, d, device=dev)
    pos = torch.arange(t_max, device=dev)
    mask = (pos[None, :] < lengths[:, None]).float()
    t_flat = t_mat.reshape(r, k * d)
    std = torch.sqrt(var)
    for s0 in range(0, s, block):
        s1 = min(s, s0 + block)
        b = s1 - s0
        w = torch.randn(b, r, generator=g, device=dev)
        shift = (w @ t_flat).reshape(b, k, d)
        comp = draw_components(g, weights, b * t_max).reshape(b, t_max)
        noise = torch.randn(b, t_max, d, generator=g, device=dev)
        rows = torch.arange(b, device=dev)[:, None].expand(b, t_max)
        xb = means[comp] + shift[rows, comp] + std[comp] * noise
        x[s0:s1] = xb * mask[s0:s1, :, None]
    return x, mask

