"""Plain references of the GMM entries: log-densities, EM statistics, the
EM M-step with LIA_RAL's variance control, and Baum-Welch statistics.

Written from the LIA_RAL semantics (TrainTools.cpp trainModel,
varianceControl), in whatever dtype the caller gives:
float64 for the reference, float32 with TF32 for the control.  Models
are plain (weights (K,), means (K,D), variances (K,D)) tuples.  Imports
torch only: nothing of the program.
"""

from __future__ import annotations

import math

import torch


def logdens(x: torch.Tensor, weights, means, var) -> torch.Tensor:
    """log(w_k N(x; μ_k, σ²_k)) for every frame and component: (N, K)."""
    ivar = 1.0 / var
    d = means.shape[-1]
    const = (torch.log(weights) - 0.5 * (d * math.log(2 * math.pi)
                                        + torch.log(var).sum(-1))
             - 0.5 * (means * means * ivar).sum(-1))
    return (-0.5 * (x * x) @ ivar.T + x @ (means * ivar).T
            + const[None, :])


def em_stats(x, fw, model, chunk: int = 65536):
    """(n (K,), Σγx (K,D), Σγx² (K,D), Σ w·llk, Σ w) over weighted frames."""
    w, m, v = model
    k, d = m.shape
    n = torch.zeros(k, dtype=x.dtype, device=x.device)
    sx = torch.zeros(k, d, dtype=x.dtype, device=x.device)
    sxx = torch.zeros(k, d, dtype=x.dtype, device=x.device)
    llk = torch.zeros((), dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[0], chunk):
        xb, wb = x[s:s + chunk], fw[s:s + chunk]
        ld = logdens(xb, w, m, v)
        lse = torch.logsumexp(ld, -1)
        p = ld.sub_(lse[:, None]).exp_()
        both = p.T @ torch.cat([xb * wb[:, None], xb * xb * wb[:, None],
                                wb[:, None]], 1)
        sx += both[:, :d]
        sxx += both[:, d:2 * d]
        n += both[:, 2 * d]
        llk += (lse * wb).sum()
        del ld, p
    return n, sx, sxx, llk, fw.sum()


def mean_llk(x, fw, model, chunk: int = 65536) -> torch.Tensor:
    """Σ w·log p(x) / Σ w."""
    tot = torch.zeros((), dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[0], chunk):
        lse = torch.logsumexp(logdens(x[s:s + chunk], *model), -1)
        tot += (lse * fw[s:s + chunk]).sum()
    return tot / fw.sum()


def global_var(x, fw):
    cnt = fw.sum()
    mean = (x * fw[:, None]).sum(0) / cnt
    return (x * x * fw[:, None]).sum(0) / cnt - mean * mean


def schedule(begin: float, end: float, nb_it: int, it: int) -> float:
    """LIA_RAL setItParameter: linear from begin to end over the run."""
    return begin if nb_it < 2 else begin - (begin - end) / (nb_it - 1) * it


def train(x, fw, init, nb_it: int, floors=(1.0, 0.5), ceils=(10.0, 5.0),
          chunk: int = 65536):
    """nb_it EM iterations from ``init`` with every frame kept: each
    iteration's statistics, the closed-form M-step, and the variances
    held between floor·σ²_global and ceil·σ²_global on a linear
    schedule."""
    gvar = global_var(x, fw)
    model = init
    for it in range(nb_it):
        n, sx, sxx, _, cnt = em_stats(x, fw, model, chunk)
        occ = torch.clamp(n, min=1e-6)[:, None]
        means = sx / occ
        var = torch.clamp(sxx / occ - means * means, min=1e-8)
        weights = n / cnt
        weights = weights / weights.sum()
        lo = schedule(floors[0], floors[1], nb_it, it)
        hi = schedule(ceils[0], ceils[1], nb_it, it)
        var = torch.minimum(torch.maximum(var, lo * gvar[None]),
                            hi * gvar[None])
        model = (weights, means, var)
    return model


def bw_stats(x, mask, model):
    """Zero- and first-order statistics of one segment: (n (K,), f (K,D))."""
    ld = logdens(x, *model)
    p = torch.softmax(ld, -1) * mask[:, None]
    return p.sum(0), p.T @ x
