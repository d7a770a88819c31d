"""Plain reference of the MIT-LL GMM-supervector SVM with nuisance
attribute projection: Campbell, Sturim, Reynolds and Solomonoff, "SVM
based speaker verification using a GMM supervector kernel and NAP
variability compensation", ICASSP 2006, with the kernel of Campbell,
Sturim and Reynolds, "Support vector machines using GMM supervectors for
speaker verification", IEEE SPL 13(5), 2006; as LIA_RAL's tool chain runs
it: TrainTarget ``outputAdaptParam`` (MAP, then ``superVector KL``) →
CovIntra → NAPSV → SvmTrain → SvmPredict.

Plain ``torch`` in the dtype of the caller's tensors: float64 for the
reference, float32 where a control runs it in a lower precision.  TF32 is
set off on import, so a float32 product is a float32 product unless a
caller turns TF32 on around a call.  Imports nothing of the program and
no JAX.  A model is a (weights (K,), means (K, D), variances (K, D))
tuple.

What it holds:

* ``map_means``: MAPOccDep adaptation of the means from the world (the
  relevance factor ``reg``), one iteration, for a stack of sides: the
  world's posteriors of every frame, n_k and F_k, then
  (reg·μ_k + F_k) / (reg + n_k);
* ``kl_supervectors``: μ_kd·√(w_k / σ²_kd) of each side's adapted means,
  with the world's weights and variances, flattened to K·D;
* ``nap_subspace``: the top ``rank`` eigenvectors of the within-speaker
  scatter (each vector less its speaker's mean), from the eigenvectors of
  the (n × n) Gram of the centred vectors (u = Cᵀv / √λ), so that a
  77,824-wide problem fits; ``nap_project`` removes them;
* ``default_c``: C = 1 / mean‖x‖² (libsvm's getC in LIA);
* ``smo``: the C-SVC dual, min ½αᵀQα − Σα s.t. yᵀα = 0, 0 ≤ α ≤ C, by
  libsvm's SMO with its second-order working-set selection (Fan, Chen
  and Lin, JMLR 6, 2005), no shrinking, stopped where the largest KKT
  violation max_{I_up} −y_t G_t − min_{I_low} −y_t G_t is under ``eps``;
  a batch of problems on a leading axis, each stopped on its own;
  ``rho`` is libsvm's (the mean of y_t G_t over free vectors);
* ``svm_train``: the linear kernel on the vectors as given, one problem a
  target (its vectors +1 against the background −1): the primal weights
  w = Σ α_t y_t x_t and the bias −ρ; ``scores`` are w·x + b.

Departures from the source and the tools, each shared with the port it
is held against:

* one MAP iteration with every frame kept (no bagging), means only;
* the background doubles as NAP's development set (the source uses
  separate NIST and Switchboard sets);
* NAP's eigenvectors come from an exact eigendecomposition, where
  CovIntra runs SVDLIBC's Lanczos; the subspace is the same;
* the SVM is solved to a tighter violation than libsvm's default 1e-3.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def log_densities(x: torch.Tensor, world) -> torch.Tensor:
    """log(w_k N(x_t; μ_k, σ²_k)) of frames x (..., T, D): (..., T, K)."""
    w, m, v = world
    d = m.shape[1]
    inv = 1.0 / v
    const = (torch.log(w) - 0.5 * (d * math.log(2.0 * math.pi)
                                   + torch.log(v).sum(1)
                                   + (m * m * inv).sum(1)))
    return (const - 0.5 * ((x * x) @ inv.T) + x @ (m * inv).T)


def map_means(x: torch.Tensor, world, reg: float) -> torch.Tensor:
    """MAPOccDep means of each side of x (B, T, D) from the world, one
    iteration over every frame: (B, K, D)."""
    _, m, _ = world
    ld = log_densities(x, world)
    post = torch.exp(ld - torch.logsumexp(ld, -1, keepdim=True))
    n = post.sum(-2)                                   # (B, K)
    f = post.transpose(-1, -2) @ x                     # (B, K, D)
    return (reg * m + f) / (reg + n)[..., None]


def kl_supervectors(means: torch.Tensor, world) -> torch.Tensor:
    """μ_kd·√(w_k/σ²_kd) of each side's means (B, K, D): (B, K·D)."""
    w, _, v = world
    scale = torch.sqrt(w[:, None] / v)
    return (means * scale).reshape(means.shape[0], -1)


def nap_subspace(vectors: torch.Tensor, spk_ids: torch.Tensor,
                 rank: int) -> torch.Tensor:
    """(rank, dim) orthonormal rows spanning the top eigenvectors of the
    within-speaker scatter of ``vectors`` (n, dim), through the (n × n)
    Gram of the speaker-centred vectors."""
    n_spk = int(spk_ids.max()) + 1
    one_hot = torch.nn.functional.one_hot(spk_ids.long(), n_spk).to(vectors)
    means = (one_hot.T @ vectors) / one_hot.sum(0)[:, None]
    c = vectors - means[spk_ids.long()]
    lam, vecs = torch.linalg.eigh(c @ c.T)
    lam, vecs = lam.flip(0)[:rank], vecs.flip(1)[:, :rank]
    return (c.T @ vecs / torch.sqrt(lam)[None]).T


def nap_project(vectors: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The vectors less their part in the rows' span."""
    return vectors - (vectors @ u.T) @ u


def default_c(x: torch.Tensor) -> float:
    """libsvm's getC in LIA: 1 / mean‖x‖²."""
    return float(1.0 / (x * x).sum(1).mean())


def smo(q: torch.Tensor, y: torch.Tensor, c: torch.Tensor,
        eps: float = 1e-9, max_iter: int = 200_000, check: int = 32):
    """libsvm's SMO (WSS 2) on B problems: q (B, N, N) = yyᵀ∘K, y and c
    (B, N).  Returns (α (B, N), ρ (B,), iterations run: ``max_iter``
    where a problem did not reach ``eps``)."""
    b, n = y.shape
    rows = torch.arange(b, device=q.device)
    diag = q.diagonal(dim1=-2, dim2=-1)
    a = torch.zeros_like(y)
    g = -torch.ones_like(y)
    pos, neg = y > 0, y < 0
    inf = torch.tensor(float("inf"), dtype=y.dtype, device=y.device)
    it = 0
    for it in range(max_iter):
        up = (pos & (a < c)) | (neg & (a > 0))
        low = (pos & (a > 0)) | (neg & (a < c))
        myg = -y * g
        gmax, i = torch.where(up, myg, -inf).max(-1)
        gmin = torch.where(low, myg, inf).min(-1).values
        live = (gmax - gmin) > eps
        if it % check == 0 and not bool(live.any()):
            break
        qi = q[rows, i]
        yi = y[rows, i]
        quad = diag[rows, i][:, None] + diag - 2.0 * yi[:, None] * y * qi
        quad = torch.where(quad > 0, quad, torch.full_like(quad, 1e-12))
        gap = gmax[:, None] - myg
        obj = torch.where(low & (gap > 0), -gap * gap / quad, inf)
        j = obj.argmin(-1)
        qj = q[rows, j]
        ai, aj = a[rows, i], a[rows, j]
        ci, cj = c[rows, i], c[rows, j]
        gi, gj = g[rows, i], g[rows, j]
        qij = qi[rows, j]
        dii, djj = diag[rows, i], diag[rows, j]
        # y_i ≠ y_j
        quad_d = dii + djj + 2.0 * qij
        quad_d = torch.where(quad_d > 0, quad_d, torch.full_like(quad_d, 1e-12))
        delta = (-gi - gj) / quad_d
        diff = ai - aj
        ni, nj = ai + delta, aj + delta
        fix = (diff > 0) & (nj < 0)
        ni, nj = torch.where(fix, diff, ni), torch.where(fix, 0.0, nj)
        fix = (diff <= 0) & (ni < 0)
        ni, nj = torch.where(fix, 0.0, ni), torch.where(fix, -diff, nj)
        fix = (diff > ci - cj) & (ni > ci)
        ni, nj = torch.where(fix, ci, ni), torch.where(fix, ci - diff, nj)
        fix = (diff <= ci - cj) & (nj > cj)
        ni, nj = torch.where(fix, cj + diff, ni), torch.where(fix, cj, nj)
        # y_i = y_j
        quad_s = dii + djj - 2.0 * qij
        quad_s = torch.where(quad_s > 0, quad_s, torch.full_like(quad_s, 1e-12))
        delta = (gi - gj) / quad_s
        tot = ai + aj
        si, sj = ai - delta, aj + delta
        fix = (tot > ci) & (si > ci)
        si, sj = torch.where(fix, ci, si), torch.where(fix, tot - ci, sj)
        fix = (tot <= ci) & (sj < 0)
        si, sj = torch.where(fix, tot, si), torch.where(fix, 0.0, sj)
        fix = (tot > cj) & (sj > cj)
        si, sj = torch.where(fix, tot - cj, si), torch.where(fix, cj, sj)
        fix = (tot <= cj) & (si < 0)
        si, sj = torch.where(fix, 0.0, si), torch.where(fix, tot, sj)
        same = yi == y[rows, j]
        new_i = torch.where(same, si, ni)
        new_j = torch.where(same, sj, nj)
        dai = torch.where(live, new_i - ai, 0.0)
        daj = torch.where(live, new_j - aj, 0.0)
        a[rows, i] = ai + dai
        a[rows, j] = aj + daj
        g += qi * dai[:, None] + qj * daj[:, None]
    return a, _rho(a, y, g, c), it


def _rho(a, y, g, c):
    """libsvm's calculate_rho: the mean of y_t G_t over free vectors, or
    the middle of its bounds where none is free."""
    yg = y * g
    at_up, at_low = a >= c, a <= 0
    free = ~(at_up | at_low)
    inf = torch.full_like(yg, float("inf"))
    ub_mask = (at_up & (y < 0)) | (at_low & (y > 0))
    lb_mask = (at_up & (y > 0)) | (at_low & (y < 0))
    ub = torch.where(ub_mask, yg, inf).min(-1).values
    lb = torch.where(lb_mask, yg, -inf).max(-1).values
    nf = free.sum(-1)
    mean_free = torch.where(free, yg, 0.0).sum(-1) / nf.clamp(min=1)
    return torch.where(nf > 0, mean_free, 0.5 * (ub + lb))


def svm_train(targets: torch.Tensor, background: torch.Tensor,
              eps: float = 1e-9):
    """One linear C-SVC a target: row t of ``targets`` (T, dim) +1 against
    every row of ``background`` (M, dim) −1, C = ``default_c`` of the
    problem's vectors.  Returns (w (T, dim), b (T,), α (T, M + 1),
    iterations)."""
    kb = background @ background.T                    # (M, M)
    kt = targets @ background.T                       # (T, M)
    tt = (targets * targets).sum(1)                   # (T,)
    nt, m = kt.shape
    k = torch.empty(nt, m + 1, m + 1, dtype=kb.dtype, device=kb.device)
    k[:, 1:, 1:] = kb
    k[:, 0, 1:] = kt
    k[:, 1:, 0] = kt
    k[:, 0, 0] = tt
    y = torch.cat([torch.ones(nt, 1, dtype=kb.dtype, device=kb.device),
                   -torch.ones(nt, m, dtype=kb.dtype, device=kb.device)], 1)
    bg_sq = (background * background).sum(1)
    c = 1.0 / ((tt + bg_sq.sum()) / (m + 1))           # default_c a problem
    cv = c[:, None].expand(nt, m + 1).contiguous()
    q = k * (y[:, :, None] * y[:, None, :])
    del k
    a, rho, iters = smo(q, y, cv, eps=eps)
    ay = a * y
    w = ay[:, :1] * targets + ay[:, 1:] @ background
    return w, -rho, a, iters


def scores(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor
           ) -> torch.Tensor:
    """(T, S) decision values w·x + b of each target on each vector."""
    return w @ x.T + b[:, None]
