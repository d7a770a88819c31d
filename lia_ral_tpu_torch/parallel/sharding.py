"""Sharded sufficient-statistics accumulation (port of
lia_ral_tpu/parallel/sharding.py).

The reference's threaded EM (``AccumulateStat.cpp:234-299``: dynamic
segment queue, per-thread MixtureStat, ``addAccEM`` merge) maps to: shard
the frame axis over the "data" mesh axis, run the stats pass per shard,
sum the EmStats over the axis.  The merge is associative, so sharded ==
serial to float tolerance.  Each function runs its per-shard body through
``Mesh.run`` (one thread and, on a card, one stream a shard) with the
collectives where the JAX bodies call ``psum``/``pmax``; the padding
corrections are the JAX package's.  Inputs are whole tensors, as the JAX
functions take global arrays; every output comes back whole: a
replicated one from the first shard, a sharded one joined in grid order
(across processes too).
"""

from __future__ import annotations

import torch

from ..gmm.kernels import EmStats, em_stats_chunked
from ..gmm.model import GmmDiag
from .mesh import Mesh


def shard_frames(x: torch.Tensor, w: torch.Tensor, n_shards: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad the frame axis to a multiple of n_shards (zero weights on pad)."""
    n = x.shape[0]
    pad = (-n) % n_shards
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        w = torch.cat([w, w.new_zeros((pad,))])
    return x, w


def _piece(t: torch.Tensor, index: int, count: int, device) -> torch.Tensor:
    """Shard ``index`` of ``count`` equal pieces of the leading axis."""
    per = t.shape[0] // count
    return t[index * per:(index + 1) * per].to(device)


def sharded_em_stats(mesh: Mesh, x: torch.Tensor, w: torch.Tensor,
                     gmm: GmmDiag, chunk: int = 4096, local_fn=None
                     ) -> EmStats:
    """EM sufficient stats with the frame axis sharded over mesh axis
    "data"; the model is replicated; the stats are summed over the axis.
    ``local_fn`` is the per-shard stats pass (default: the plain chunked
    path; ``gmm.em.default_stats_fn(...)`` runs kernel K1, in its tier, on
    every shard of a card)."""
    if local_fn is None:
        def local_fn(xs, ws, g):
            return em_stats_chunked(xs, ws, g, chunk=chunk)

    n_data = mesh.shape["data"]
    x, w = shard_frames(x, w, n_data)

    def body(sh):
        g = gmm.to(sh.device)
        return sh.psum(local_fn(_piece(x, sh.data, n_data, sh.device),
                                _piece(w, sh.data, n_data, sh.device), g),
                       "data")

    return mesh.replicated(mesh.run(body))


def sharded_stats_fn(mesh: Mesh, chunk: int = 4096,
                     fast_math: bool = False, fast_stats: bool = False):
    """stats_fn drop-in for gmm.em.train_model / map_adapt.adapt_model:
    the same (x, w, gmm) → EmStats signature over the mesh.  The per-shard
    pass is ``gmm.em.default_stats_fn`` in the requested tier, so on a
    card each shard is one launch of K1 in that tier."""
    from ..gmm.em import default_stats_fn
    local = default_stats_fn(chunk=chunk, fast_math=fast_math,
                             fast_stats=fast_stats)

    def fn(x, w, gmm):
        return sharded_em_stats(mesh, x, w, gmm, chunk=chunk, local_fn=local)

    return fn


def sharded_em_stats_2d(mesh: Mesh, x: torch.Tensor, w: torch.Tensor,
                        gmm: GmmDiag, chunk: int = 4096) -> EmStats:
    """2-D sharded stats: frames over "data" AND components over "model".

    Each shard holds K/m components; the posterior normalisation needs the
    global logsumexp over K, a pmax and a psum over "model" per frame
    chunk before the local stat products.  n, sum_x and sum_xx come back
    joined over "model"; llk and count are divided by n_model before
    their sum over both axes, so the double sum is exact."""
    from ..gmm.kernels import weighted_logdens

    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    k, d = gmm.means.shape
    assert k % n_model == 0, (k, n_model)
    kl = k // n_model
    x, w = shard_frames(x, w, n_data)

    def body(sh):
        xs = _piece(x, sh.data, n_data, sh.device)
        ws = _piece(w, sh.data, n_data, sh.device)
        sl = slice(sh.model * kl, (sh.model + 1) * kl)
        g = GmmDiag(weights=gmm.weights[sl], means=gmm.means[sl],
                    cov_inv=gmm.cov_inv[sl]).to(sh.device)
        pad = (-xs.shape[0]) % chunk
        xs = torch.cat([xs, xs.new_zeros((pad, d))])
        ws = torch.cat([ws, ws.new_zeros((pad,))])
        acc = EmStats.zeros(kl, d, xs.dtype, sh.device)
        for s0 in range(0, xs.shape[0], chunk):
            xb, wb = xs[s0:s0 + chunk], ws[s0:s0 + chunk]
            ld = weighted_logdens(xb, g)                     # (B, K/m)
            m_glob = sh.pmax(torch.amax(ld, dim=-1), "model")
            s_glob = sh.psum(torch.sum(torch.exp(ld - m_glob[:, None]),
                                       dim=-1), "model")
            llk = torch.log(s_glob) + m_glob                 # (B,)
            pw = torch.exp(ld - llk[:, None]) * wb[:, None]  # local γ·w
            acc = EmStats(n=acc.n + torch.sum(pw, dim=0),
                          sum_x=acc.sum_x + pw.T @ xb,
                          sum_xx=acc.sum_xx + pw.T @ (xb * xb),
                          llk=acc.llk + torch.sum(llk * wb) / n_model,
                          count=acc.count + torch.sum(wb) / n_model)
        # frame-axis merge over "data"; llk/count also over "model"
        return (sh.psum((acc.n, acc.sum_x, acc.sum_xx), "data"),
                sh.psum((acc.llk, acc.count), ("data", "model")))

    outs = mesh.run(body)
    per = {key: out[0] for key, out in outs.items()}
    n, sx, sxx = (mesh.concat({kk: v[i] for kk, v in per.items()}, "model")
                  for i in range(3))
    llk, count = mesh.replicated(outs)[1]
    return EmStats(n=n, sum_x=sx, sum_xx=sxx, llk=llk.to(n.device),
                   count=count.to(n.device))


def replicate(mesh: Mesh, tree) -> list:
    """``tree`` (a tensor or an object with ``.to(device)``) placed on
    every local shard's device, one copy a shard in shard order."""
    return [tree.to(mesh.device_of(key)) for key in mesh.local_keys()]


def shard_along_axis(mesh: Mesh, arr: torch.Tensor,
                     axis_name: str = "data") -> list[torch.Tensor]:
    """The local shards' pieces of ``arr``'s leading axis split over
    ``axis_name``, each on its shard's device, in shard order."""
    count = mesh.shape[axis_name]
    pos = 0 if axis_name == "data" else 1
    return [_piece(arr, key[pos], count, mesh.device_of(key))
            for key in mesh.local_keys()]


def _pad_leading(arrs, n_shards: int):
    """Zero-pad the shared leading axis of a list of tensors to a multiple
    of n_shards.  Zero rows carry zero stats/weights, so every consumer
    below is exact under padding."""
    n = arrs[0].shape[0]
    pad = (-n) % n_shards
    if not pad:
        return arrs, n
    return [torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
            for a in arrs], n


def _rows(t: torch.Tensor, sh, n_data: int) -> torch.Tensor:
    return _piece(t, sh.data, n_data, sh.device)


def _correct_padding(acc, pad: int):
    """A zero-stat padding row contributes exactly I to r_mat (its
    posterior covariance is the prior) and 1 to n_utts: remove them, so
    sharded == serial."""
    if not pad:
        return acc
    eye = torch.eye(acc.r_mat.shape[0], dtype=acc.r_mat.dtype,
                    device=acc.r_mat.device)
    return type(acc)(a=acc.a, c=acc.c, r_mat=acc.r_mat - pad * eye,
                     r_vec=acc.r_vec, n_utts=acc.n_utts - pad)


def sharded_tv_e_step(mesh: Mesh, stats, model, chunk: int = 64):
    """TV E-step with the speaker axis sharded over mesh axis "data".

    The reference threads estimateAandC over speakers with shared A/C
    accumulators under mutexes (AccumulateTVStat.cpp:1798-1799,1944); here
    each shard accumulates its speakers' TvAccums and they are summed
    over the axis.  Returns (w (S,R), TvAccums)."""
    from ..fa.stats import BwStats
    from ..fa.tv import tv_e_step

    n_data = mesh.shape["data"]
    s_real = stats.n.shape[0]
    (n_p, f_p), _ = _pad_leading([stats.n, stats.f], n_data)
    pad = n_p.shape[0] - s_real

    def body(sh):
        w, acc = tv_e_step(BwStats(n=_rows(n_p, sh, n_data),
                                   f=_rows(f_p, sh, n_data)),
                           model.to(sh.device), chunk=chunk)
        return w, sh.psum(acc, "data")

    outs = mesh.run(body)
    w = mesh.concat({key: out[0] for key, out in outs.items()}, "data")
    return w[:s_real], _correct_padding(mesh.replicated(outs)[1], pad)


def sharded_subspace_accums(mesh: Mesh, t: torch.Tensor,
                            inv_var: torch.Tensor, n: torch.Tensor,
                            fbar: torch.Tensor):
    """JFA/TV subspace A/C accumulation with the entity (speaker or
    session) axis sharded over mesh axis "data" (the reference's threaded
    estimateVEVT/estimateYandV, AccumulateJFAStat.cpp:1255/2457).  Zero-
    stat padding rows contribute nothing.  Returns (latent means of the
    padded rows, SubspaceAccums)."""
    from ..fa.jfa import (_accumulate_subspace, _latent_posterior,
                          _subspace_gram)

    n_data = mesh.shape["data"]
    (n, fbar), _ = _pad_leading([n, fbar], n_data)
    gram = _subspace_gram(t, inv_var)

    def body(sh):
        t_, iv_, g_ = (a.to(sh.device) for a in (t, inv_var, gram))
        n_loc, f_loc = _rows(n, sh, n_data), _rows(fbar, sh, n_data)
        mean, cov = _latent_posterior(t_, iv_, g_, n_loc, f_loc)
        return mean, sh.psum(_accumulate_subspace(n_loc, f_loc, mean, cov),
                             "data")

    outs = mesh.run(body)
    mean = mesh.concat({key: out[0] for key, out in outs.items()}, "data")
    return mean, mesh.replicated(outs)[1]


def sharded_jfa_v_iteration(mesh: Mesh, stats, model, x: torch.Tensor,
                            z: torch.Tensor):
    """EigenVoice EM iteration with speakers sharded over "data".  The
    residual construction (session → speaker channel stats) stays global;
    the per-speaker L-solves and A/C accumulation shard."""
    from ..fa.jfa import _solve_subspace, v_residual

    n, fbar = v_residual(stats, model, x, z)
    s = n.shape[0]
    y, acc = sharded_subspace_accums(mesh, model.v, model.ubm_inv_var,
                                     n, fbar)
    return model.replace(v=_solve_subspace(acc).to(model.v.device)), \
        y[:s].to(model.v.device)


def sharded_jfa_u_iteration(mesh: Mesh, stats, model, y: torch.Tensor,
                            z: torch.Tensor):
    """EigenChannel EM iteration with sessions sharded over "data"."""
    from ..fa.jfa import _solve_subspace, u_residual

    n, fbar = u_residual(stats, model, y, z)
    h = n.shape[0]
    x, acc = sharded_subspace_accums(mesh, model.u, model.ubm_inv_var,
                                     n, fbar)
    return model.replace(u=_solve_subspace(acc).to(model.u.device)), \
        x[:h].to(model.u.device)


def sharded_plda_em_iteration(mesh: Mesh, model, dev):
    """PLDA EM iteration with the SESSION axis sharded over "data" (the
    reference's threaded getExpectedValues, PldaTools.cpp:2647): the
    session-level products shard, ``plda_em_core``'s cross-session sums
    go through the collective, and the (S,rf,rf) speaker solves are the
    same on every shard."""
    from ..backend.plda import plda_em_core

    n_data = mesh.shape["data"]
    vecs = torch.as_tensor(dev.vectors, dtype=torch.float32)
    w = torch.ones(vecs.shape[0], dtype=torch.float32, device=vecs.device)
    ids = torch.as_tensor(dev.spk_ids, dtype=torch.int64, device=vecs.device)
    (xv, w, ids), _ = _pad_leading([vecs, w, ids], n_data)
    n_speakers = int(dev.n_speakers)

    def body(sh):
        return plda_em_core(model.to(sh.device), _rows(xv, sh, n_data),
                            _rows(ids, sh, n_data), n_speakers,
                            w=_rows(w, sh, n_data),
                            reduce_fn=lambda v: sh.psum(v, "data"))

    return mesh.replicated(mesh.run(body)).to(vecs.device)


def sharded_plda_llr(mesh: Mesh, model, enroll: torch.Tensor,
                     n_sessions: torch.Tensor, test: torch.Tensor
                     ) -> torch.Tensor:
    """Batched PLDA trial scoring with the MODEL axis sharded over "data"
    (the reference's threaded scoring loop, PldaTools.cpp:4061): each
    shard scores its models against the whole test set.  Returns (M, T)."""
    from ..backend.plda import plda_llr

    n_data = mesh.shape["data"]
    m = enroll.shape[0]
    ns = torch.clamp(torch.as_tensor(n_sessions, dtype=torch.float32,
                                     device=enroll.device), min=1.0)
    (enroll_p, ns_p), _ = _pad_leading([enroll, ns], n_data)

    def body(sh):
        return plda_llr(model.to(sh.device), _rows(enroll_p, sh, n_data),
                        _rows(ns_p, sh, n_data), test.to(sh.device))

    return mesh.concat(mesh.run(body), "data")[:m].to(enroll.device)


def sharded_estimate_w(mesh: Mesh, stats, model, chunk: int = 64,
                       solver: str = "pcg", pcg_iters: int = 16,
                       pcg_tol: float = 1e-7) -> torch.Tensor:
    """i-vector extraction with the utterance axis sharded over "data".

    Extraction is embarrassingly parallel (estimateW[Un]Threaded,
    AccumulateTVStat.cpp:2103-2267), so no collective is needed: tett/tn
    and the PCG preconditioner basis (from the GLOBAL mean occupancy,
    computed before the shards start) enter every shard whole, so every
    iterate is the serial path's to reduction order.  Each shard pads its
    rows to a multiple of ``chunk``.  With ``pcg_tol > 0`` the early exit
    is decided per local block, as in the JAX function.  Returns (S, R)."""
    from ..fa.tv import (_pcg_basis, _posterior_mean, _posterior_mean_pcg,
                         _tn_flat, estimate_tett)

    if solver not in ("pcg", "cholesky"):
        raise ValueError(f"unknown estimate_w solver {solver}")
    tett = estimate_tett(model)
    tn_flat = _tn_flat(model)
    if solver == "pcg":
        q, dk = _pcg_basis(model, torch.mean(stats.n, dim=0))
    n_data = mesh.shape["data"]
    s_real = stats.n.shape[0]
    fbar = stats.centered(model.ubm_means)             # F̄ = F − N·m
    (n_p, f_p), _ = _pad_leading([stats.n, fbar], n_data)

    def body(sh):
        dv = sh.device
        mdl, tt, tn = model.to(dv), tett.to(dv), tn_flat.to(dv)
        n_loc, f_loc = _rows(n_p, sh, n_data), _rows(f_p, sh, n_data)
        s_loc = n_loc.shape[0]
        pad = (-s_loc) % chunk
        n_loc = torch.cat([n_loc, n_loc.new_zeros((pad,) + n_loc.shape[1:])])
        f_loc = torch.cat([f_loc, f_loc.new_zeros((pad,) + f_loc.shape[1:])])
        ws = []
        for s0 in range(0, n_loc.shape[0], chunk):
            n_blk, f_blk = n_loc[s0:s0 + chunk], f_loc[s0:s0 + chunk]
            if solver == "pcg":
                w_blk, _ = _posterior_mean_pcg(n_blk, f_blk, mdl, tt, tn,
                                               q.to(dv), dk.to(dv),
                                               pcg_iters, pcg_tol)
            else:
                w_blk = _posterior_mean(n_blk, f_blk, mdl, tt, tn)
            ws.append(w_blk)
        return torch.cat(ws)[:s_loc]

    w = mesh.concat(mesh.run(body), "data")
    return w[:s_real].to(stats.n.device)


def sharded_tv_e_step_2d(mesh: Mesh, stats, model, chunk: int = 32):
    """TV E-step sharded over BOTH axes: speakers over "data" AND the GMM
    component axis over "model".

    Each shard holds only its K/m slice of T, tett, F̄ and the A/C
    accumulators; the per-utterance (B,R,R) L build and (B,R) aux are
    partial sums over local components, summed over "model" per block
    (the only cross-component collectives), after which the batched
    Cholesky solve runs the same in every model group, so sharded ==
    serial to reduction order.  Returns (w (S,R), TvAccums with a and c
    joined over "model" and r_mat, r_vec, n_utts summed over "data")."""
    from ..fa.tv import TvAccums

    r = model.rank
    k, d = model.ubm_means.shape
    n_model, n_data = mesh.shape["model"], mesh.shape["data"]
    assert k % n_model == 0, (k, n_model)
    kl = k // n_model
    s_real = stats.n.shape[0]
    (n_p, f_p), _ = _pad_leading([stats.n, stats.f], n_data)
    pad = n_p.shape[0] - s_real

    def body(sh):
        dv = sh.device
        sl = slice(sh.model * kl, (sh.model + 1) * kl)
        n_loc = _rows(n_p, sh, n_data)[:, sl]
        f_loc = _rows(f_p, sh, n_data)[:, sl]
        t_loc = model.t[:, sl].to(dv)
        iv_loc = model.ubm_inv_var[sl].to(dv)
        means_loc = model.ubm_means[sl].to(dv)
        s_loc = n_loc.shape[0]
        # local tett / T·Σ⁻¹ over this shard's components
        tn = t_loc * iv_loc[None]
        tett = torch.bmm(tn.permute(1, 0, 2), t_loc.permute(1, 2, 0))
        tn_flat = tn.reshape(r, -1)
        fbar = f_loc - n_loc[..., None] * means_loc[None]
        cpad = (-s_loc) % chunk
        n_c = torch.cat([n_loc, n_loc.new_zeros((cpad, kl))])
        f_c = torch.cat([fbar, fbar.new_zeros((cpad, kl, d))])
        valid = torch.cat([torch.ones(s_loc, device=dv),
                           torch.zeros(cpad, device=dv)])
        eye = torch.eye(r, dtype=torch.float32, device=dv)
        acc = TvAccums.zeros(r, kl, d, device=dv)
        ws = []
        for s0 in range(0, n_c.shape[0], chunk):
            n_blk, f_blk = n_c[s0:s0 + chunk], f_c[s0:s0 + chunk]
            v_blk = valid[s0:s0 + chunk]
            b = n_blk.shape[0]
            # partial L/aux over LOCAL components → summed over "model"
            l_part = (n_blk @ tett.reshape(kl, r * r)).reshape(b, r, r)
            l_mat = eye[None] + sh.psum(l_part, "model")
            aux = sh.psum(f_blk.reshape(b, -1) @ tn_flat.T, "model")
            chol = torch.linalg.cholesky(l_mat)
            w = torch.cholesky_solve(aux[..., None], chol)[..., 0]
            linv = torch.cholesky_solve(eye.expand_as(l_mat), chol)
            w = w * v_blk[:, None]
            cov = (linv + w[:, :, None] * w[:, None, :]) * v_blk[:, None, None]
            acc = TvAccums(
                a=acc.a + (n_blk.T @ cov.reshape(b, r * r)).reshape(kl, r, r),
                c=acc.c + (w.T @ f_blk.reshape(b, kl * d)).reshape(r, kl, d),
                r_mat=acc.r_mat + torch.sum(cov, dim=0),
                r_vec=acc.r_vec + torch.sum(w, dim=0),
                n_utts=acc.n_utts + torch.sum(v_blk))
            ws.append(w)
        # a/c stay component-sharded; everything merges over "data"
        return torch.cat(ws)[:s_loc], sh.psum(acc, "data")

    outs = mesh.run(body)
    w = mesh.concat({key: out[0] for key, out in outs.items()}, "data")
    accs = {key: out[1] for key, out in outs.items()}
    whole = mesh.replicated(outs)[1]
    acc = TvAccums(a=mesh.concat({kk: v.a for kk, v in accs.items()},
                                 "model", dim=0),
                   c=mesh.concat({kk: v.c for kk, v in accs.items()},
                                 "model", dim=1),
                   r_mat=whole.r_mat, r_vec=whole.r_vec,
                   n_utts=whole.n_utts)
    return w[:s_real], _correct_padding(acc, pad)
