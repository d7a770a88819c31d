"""The JAX package's record drivers (scripts/milestone_*.py) started from
the torch drivers' numpy-made inits: what tests/test_torch_milestones.py
and a CPU reproduction of an eer record share.

The torch drivers (scripts/torch_milestone_*.py) draw every random init
with numpy (``init_gmm``, ``normal_init``); the JAX tools draw theirs from
``jax.random``.  ``patch_jax_inits`` makes TotalVariability's T, PLDA's F
and G and JFA's V and U of the JAX tools the torch drivers' draws, and
``patch_jax_train_world`` makes JAX TrainWorld start from an init model
file.  PLDA runs in the space of IvTest's EFR, whose basis is made of
``eigh`` vectors that LAPACK signs differently in the two packages, so F
and G are carried into the JAX basis by ``efr_basis_change``.

    python tests/_torch_milestone_parity.py [--driver eer|adapt|diar]
        [--scale small] [--workdir D] [--threads N]

runs on the CPU scripts/torch_milestone_<driver>.py (eer at the scale;
adapt and diar at their one size), then the JAX driver from its own
``jax.random`` inits and from the torch run's inits, and prints the
three runs' results (EERs; DERs) against each other: for eer and adapt
the per-trial deviation of each score file between the torch run and the
JAX run from the same inits, for diar whether their label files are
equal; then one JSON line of all of it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_milestone_eer as teer  # noqa: E402
from lia_ral_tpu.backend.plda import PldaModel as JPlda  # noqa: E402
from lia_ral_tpu.fa import tv as jtv  # noqa: E402
from lia_ral_tpu.fa.jfa import JfaModel as JJfa  # noqa: E402
from lia_ral_tpu.tools import total_variability as j_tv_tool  # noqa: E402
from lia_ral_tpu.tools import train_world as j_train_world  # noqa: E402
from lia_ral_tpu_torch.backend.eval import eer  # noqa: E402
from lia_ral_tpu_torch.io.lists import read_ndx  # noqa: E402
from lia_ral_tpu_torch.io.matrix import read_matrix_file  # noqa: E402
from lia_ral_tpu_torch.io.nist import read_nist_scores  # noqa: E402

EER_SCORE_FILES = ("scores_main.nist", "scores_zt.nist",
                   "scores_iv_cos.nist", "scores_iv_plda_s0.nist",
                   "scores_iv_plda_s1.nist", "scores_iv_plda_s2.nist")


def seed_of(key) -> int:
    """The seed a ``jax.random.key(seed)`` was made from."""
    return int(jax.random.key_data(key)[-1])


def efr_basis_change(dev_ndx: str, n_it: int, read) -> np.ndarray:
    """The orthogonal Q with JAX EFR(x) = port EFR(x)·Qᵀ on the dev
    vectors of ``dev_ndx`` (``read(name)`` loads one)."""
    from lia_ral_tpu.backend import ivnorm as jiv
    from lia_ral_tpu_torch.backend import ivnorm as tiv

    names, labels = [], []
    for spk, files in read_ndx(dev_ndx):
        for f in files:
            names.append(f)
            labels.append(spk)
    x = np.concatenate([read(n) for n in names]).astype(np.float32)
    jn = np.asarray(jiv.efr_iterations(jiv.DevSet.from_labels(x, labels),
                                       n_it)[0])
    tn = tiv.efr_iterations(tiv.DevSet.from_labels(x, labels),
                            n_it)[0].numpy()
    # orthogonal Procrustes: a signed permutation where the covariances'
    # eigenvalues are distinct, a rotation inside a repeated one
    u, _, vt = np.linalg.svd(tn.T.astype(np.float64) @ jn)
    q = (u @ vt).T
    assert np.abs(tn @ q.T - jn).max() < 1e-3
    return q.astype(np.float32)


def dev_basis(workdir: str, ext: str, n_it: int = 2):
    """``efr_basis_change`` of a JAX run's dev list (``dev.ndx`` under
    ``workdir``, vectors ``<name><ext>``), computed when called."""
    return lambda: efr_basis_change(
        os.path.join(workdir, "dev.ndx"), n_it,
        lambda n: read_matrix_file(os.path.join(workdir, n + ext)))


def patch_jax_inits(setattr_, q_of=None) -> None:
    """The JAX tools' random inits become the torch drivers'
    ``normal_init`` draws (driver seed 0) with the JAX scales; PLDA's F
    and G are multiplied by ``q_of()`` (the EFR basis change) unless
    ``q_of`` or its result is None.  ``setattr_(obj, name, value)``
    applies each patch (``monkeypatch.setattr`` in a test)."""
    def init_t(key, rank, gmm, scale=1.0):
        k, d = gmm.means.shape
        t = teer.normal_init(0, seed_of(key), "T", (rank, k, d)) * scale
        return jtv.TvModel.from_ubm(jnp.asarray(t), gmm)

    def plda(cls, key, dim, rank_f, rank_g=0, data_mean=None, data_cov=None):
        s = seed_of(key)
        q = q_of() if q_of is not None else None

        def draw(stream, rank):
            m = teer.normal_init(0, s, stream, (dim, rank)) * 0.1
            return jnp.asarray(m if q is None else q @ m)

        return cls(mean=jnp.asarray(data_mean, jnp.float32),
                   f=draw("F", rank_f), g=draw("G", rank_g),
                   sigma=jnp.asarray(data_cov, jnp.float32))

    def jfa(cls, key, rank_v, rank_u, gmm, scale=0.001):
        k, d = gmm.means.shape
        s = seed_of(key)

        def draw(stream, rank):
            return jnp.asarray(teer.normal_init(0, s, stream, (rank, k, d))
                               * scale)

        return cls(v=draw("V", rank_v), u=draw("U", rank_u),
                   d=jnp.zeros((k, d), jnp.float32),
                   ubm_means=jnp.asarray(gmm.means, jnp.float32),
                   ubm_inv_var=jnp.asarray(gmm.cov_inv, jnp.float32))

    setattr_(j_tv_tool, "init_t", init_t)
    setattr_(JPlda, "init", classmethod(plda))
    setattr_(JJfa, "init", classmethod(jfa))


def patch_jax_train_world(setattr_, init_of) -> None:
    """JAX TrainWorld starts from the model file ``init_of(output
    name)`` (under mixtureFilesPath) instead of its random init."""
    original = j_train_world.main

    def main(cfg):
        cfg["inputWorldFilename"] = init_of(
            cfg.get_str("outputWorldFilename"))
        return original(cfg)

    setattr_(j_train_world, "main", main)


def run_jax_main(module, *args) -> None:
    """A JAX driver's ``main`` with ``args`` as its command line."""
    argv = sys.argv
    sys.argv = [module.__name__, *args]
    try:
        module.main()
    finally:
        sys.argv = argv


def eer_target(model: str, seg: str) -> bool:
    """Whether a trial of the eer, adapt or jfa driver (segments
    ``..._s<speaker>_<n>``, models ``model<speaker>``) is a target
    trial."""
    return model == f"model{int(seg.split('_s')[1].split('_')[0])}"


def score_deviation(tdir: str, jdir: str, name: str, is_target) -> dict:
    """Score file ``name`` of a torch run against a JAX run's, trial by
    trial: the trial keys of each, the largest deviation and the JAX
    scores' scale, both runs' EERs and the smallest target-impostor gap
    of the JAX scores."""
    st = {(ln.model, ln.seg): ln.score
          for ln in read_nist_scores(os.path.join(tdir, name))}
    sj = {(ln.model, ln.seg): ln.score
          for ln in read_nist_scores(os.path.join(jdir, name))}
    keys = sorted(sj)
    out = {"same_trials": sorted(st) == keys and bool(keys),
           "n": len(keys)}
    if not out["same_trials"]:
        return out
    got = np.asarray([st[k] for k in keys])
    want = np.asarray([sj[k] for k in keys])
    tgt = np.asarray([is_target(*k) for k in keys])
    out.update(
        finite=bool(np.isfinite(got).all()),
        max_dev=float(np.abs(got - want).max()),
        scale=float(np.abs(want).max()),
        eer_port=eer(got[tgt], got[~tgt]), eer_jax=eer(want[tgt], want[~tgt]),
        n_target=int(tgt.sum()), n_impostor=int((~tgt).sum()),
        gap=float(np.abs(want[tgt][:, None] - want[~tgt][None, :]).min()))
    return out


DIAR_LABEL_FILES = ("conv.sad.lbl", "convsp.turn.lbl", "convsp.seg.lbl",
                    "convsp.reseg.lbl", "convsp.turnclust.lbl",
                    "convsp.turnreseg.lbl")


def same_labels(tdir: str, jdir: str, name: str) -> bool:
    """Whether two runs wrote label file ``name`` alike, segment for
    segment."""
    from lia_ral_tpu_torch.io.labels import read_label_file

    got, want = ([(s.begin, s.end, s.label)
                  for s in read_label_file(os.path.join(d, name))]
                 for d in (tdir, jdir))
    return bool(got) and got == want


def _eer_runs(d: str, scale: str) -> dict:
    import milestone_eer as jeer

    tdir, own, same = (os.path.join(d, n)
                       for n in ("torch", "jax_own", "jax_same"))
    rec = teer.run(tdir, teer.SCALES[scale], "cpu", scale=scale)
    run_jax_main(jeer, "--scale", scale, "--workdir", own, "--out",
                 os.path.join(d, "jax_own.jsonl"))
    os.makedirs(same, exist_ok=True)
    shutil.copy(os.path.join(tdir, "wld_init.gmm"), same)
    patch_jax_train_world(setattr, lambda out: "wld_init")
    patch_jax_inits(setattr, dev_basis(same, ".y"))
    run_jax_main(jeer, "--scale", scale, "--workdir", same, "--out",
                 os.path.join(d, "jax_same.jsonl"))
    devs = {name: score_deviation(tdir, same, name, eer_target)
            for name in EER_SCORE_FILES}
    for name, dv in devs.items():
        print(f"{name}: max|torch - JAX same inits| {dv['max_dev']:.3e} of "
              f"{dv['scale']:.3e}; EER {100 * dv['eer_port']:.3f} / "
              f"{100 * dv['eer_jax']:.3f} %")
    return {"torch": rec["results"], "deviations": devs}


def _diar_runs(d: str) -> dict:
    import milestone_diar as jdiar
    import torch_milestone_diar as tdiar

    tdir, own, same = (os.path.join(d, n)
                       for n in ("torch", "jax_own", "jax_same"))
    rec = tdiar.run(tdir, "cpu")
    for jdir in (own, same):
        os.makedirs(jdir, exist_ok=True)
        if jdir == same:
            for f in os.listdir(tdir):
                if f.startswith("init_"):
                    shutil.copy(os.path.join(tdir, f), same)
            patch_jax_train_world(setattr, lambda out: f"init_{out}")
        jdiar.tempfile.mkdtemp = lambda prefix="", _d=jdir: _d
        run_jax_main(jdiar, "--out", jdir + ".jsonl")
    labels = {name: same_labels(tdir, same, name)
              for name in DIAR_LABEL_FILES}
    print("label files equal to the JAX run's from the same inits: "
          + ", ".join(f"{k} {v}" for k, v in labels.items()))
    return {"torch": rec["results"], "labels_equal": labels}


def _adapt_runs(d: str) -> dict:
    import milestone_adapt as jadapt
    import torch_milestone_adapt as tadapt

    tdir, own, same = (os.path.join(d, n)
                       for n in ("torch", "jax_own", "jax_same"))
    rec = tadapt.run(tdir, tadapt.P, "cpu")
    for jdir in (own, same):
        os.makedirs(jdir, exist_ok=True)
        if jdir == same:
            shutil.copy(os.path.join(tdir, "wld_init.gmm"), same)
            patch_jax_train_world(setattr, lambda out: "wld_init")
        jadapt.tempfile.mkdtemp = lambda prefix="", _d=jdir: _d
        run_jax_main(jadapt, "--out", jdir + ".jsonl")
    devs = {f"scores_{tag}.nist": score_deviation(
        tdir, same, f"scores_{tag}.nist", eer_target)
        for tag in ("static", "static_znorm", "adapt", "oracle")}
    for name, dv in devs.items():
        print(f"{name}: max|torch - JAX same inits| {dv['max_dev']:.3e} of "
              f"{dv['scale']:.3e}")
    return {"torch": rec["results"], "deviations": devs}


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--driver", default="eer",
                    choices=["eer", "adapt", "diar"])
    ap.add_argument("--scale", default="small", choices=list(teer.SCALES))
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    d = args.workdir or tempfile.mkdtemp(prefix="torch_milestone_parity_")
    out = (_eer_runs(d, args.scale) if args.driver == "eer"
           else _adapt_runs(d) if args.driver == "adapt" else _diar_runs(d))
    for run in ("jax_own", "jax_same"):
        with open(os.path.join(d, run + ".jsonl")) as f:
            out[run] = json.loads(f.readline())["results"]
    keys = {"eer": ("gmm_raw_eer", "gmm_ztnorm_eer", "iv_cosine_eer",
                    "iv_plda_eer"),
            "adapt": ("static_eer", "static_znorm_eer", "adapted_eer",
                      "oracle_eer", "static_eer_h2", "adapted_eer_h2"),
            "diar": ("sad_frame_err", "der_segmentation",
                     "der_resegmentation", "der_turn_clustering",
                     "der_turn_resegmentation")}[args.driver]
    for run in ("torch", "jax_own", "jax_same"):
        print(f"{run}: " + ", ".join(f"{k} {100 * out[run][k]:.3f} %"
                                     for k in keys))
    print(json.dumps({"driver": args.driver, "scale": args.scale,
                      "device": "cpu", **out}))


if __name__ == "__main__":
    main()
