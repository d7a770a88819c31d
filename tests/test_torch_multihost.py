"""The port's multi-process runtime (lia_ral_tpu_torch/parallel/distributed)
against the JAX package, mirroring tests/test_multihost.py.

Two coordinated CPU processes (gloo, two shards of the CPU each, so a
global 4 × 1 mesh) accumulate EM sufficient statistics over process-local
frame blocks, and run the PLDA EM iteration, the TV E-step, the JFA V
iteration and i-vector extraction over the global mesh.  Their results
must equal the JAX package's single-process functions on the same
inputs (its random inits carried across as numpy) within
tests/test_multihost.py's tolerances, and the two ranks' copies must be
equal to the digit.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def write_problems(outdir):
    """The JAX worker's problems (tests/_multihost_worker.py) as numpy."""
    from tests._multihost_worker import (corpus, jfa_problem, plda_problem,
                                         tv_problem)
    from lia_ral_tpu.backend.ivnorm import DevSet

    x, w, gmm = corpus()
    vecs, labels, plda = plda_problem()
    dev = DevSet.from_labels(vecs, labels)
    stats_tv, tv_model = tv_problem()
    jstats, jmodel, jx, jz = jfa_problem()
    arr = np.asarray
    np.savez(os.path.join(outdir, "problems.npz"),
             x=x, w=w, gmm_w=arr(gmm.weights), gmm_m=arr(gmm.means),
             gmm_ci=arr(gmm.cov_inv),
             plda_x=vecs, plda_ids=arr(dev.spk_ids),
             plda_n_spk=int(dev.n_speakers), plda_mean=arr(plda.mean),
             plda_f=arr(plda.f), plda_g=arr(plda.g),
             plda_sigma=arr(plda.sigma),
             tv_n=arr(stats_tv.n), tv_f=arr(stats_tv.f), tv_t=arr(tv_model.t),
             tv_means=arr(tv_model.ubm_means),
             tv_iv=arr(tv_model.ubm_inv_var),
             jfa_n=arr(jstats.sess.n), jfa_f=arr(jstats.sess.f),
             jfa_spk=arr(jstats.sess_spk), jfa_n_spk=jstats.spk.n.shape[0],
             jfa_v=arr(jmodel.v), jfa_u=arr(jmodel.u), jfa_d=arr(jmodel.d),
             jfa_means=arr(jmodel.ubm_means), jfa_iv=arr(jmodel.ubm_inv_var),
             jfa_x=arr(jx), jfa_z=arr(jz), pcg_tol=1e-7)


def run_workers(outdir, n=2):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, str(n), str(pid), outdir, "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(n)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out


def test_two_process_results_equal_single_process(tmp_path):
    out = str(tmp_path)
    write_problems(out)
    run_workers(out)

    def load(name):
        """Rank 0's copy, after asserting rank 1's equal to the digit."""
        got = [dict(np.load(os.path.join(out, f"{name}_{pid}.npz")))
               for pid in range(2)]
        for key in got[0]:
            np.testing.assert_array_equal(got[1][key], got[0][key])
        return got[0]

    # the file-list shards are disjoint and cover everything; the global
    # mesh has 4 shards, 2 a process, each running the stats pass once
    info = [json.load(open(os.path.join(out, f"names_{pid}.json")))
            for pid in range(2)]
    shards = [i["names"] for i in info]
    assert not set(shards[0]) & set(shards[1])
    assert sorted(shards[0] + shards[1]) == sorted(f"f{i}" for i in range(10))
    assert all(i["mesh"] == {"data": 4, "model": 1} and i["local"] == 2
               for i in info)

    # global summed stats == single-process reference
    from tests._multihost_worker import corpus
    from lia_ral_tpu.gmm.kernels import em_stats
    x, w, gmm = corpus()
    ref = em_stats(x, w, gmm)
    got = load("stats")
    for key in ("n", "sum_x", "sum_xx"):
        np.testing.assert_allclose(got[key], np.asarray(getattr(ref, key)),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["llk"], np.asarray(ref.llk),
                               rtol=1e-5, atol=1e-3)
    assert float(got["count"]) == pytest.approx(float(ref.count))

    # cross-process PLDA EM == single-process serial iteration
    from tests._multihost_worker import plda_problem
    from lia_ral_tpu.backend.ivnorm import DevSet
    from lia_ral_tpu.backend.plda import plda_em_iteration
    vecs, labels, model = plda_problem()
    ref_p = plda_em_iteration(model, DevSet.from_labels(vecs, labels))
    got_p = load("plda")
    np.testing.assert_allclose(got_p["f"], np.asarray(ref_p.f),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_p["sigma"], np.asarray(ref_p.sigma),
                               rtol=1e-4, atol=1e-4)

    # cross-process TV E-step == single-process serial E-step
    from tests._multihost_worker import tv_problem
    from lia_ral_tpu.fa.tv import estimate_w, tv_e_step
    stats_tv, tv_model = tv_problem()
    _, ref_tv = tv_e_step(stats_tv, tv_model, chunk=4)
    got_tv = load("tv")
    for key in ("a", "c", "r_mat", "r_vec"):
        np.testing.assert_allclose(got_tv[key],
                                   np.asarray(getattr(ref_tv, key)),
                                   rtol=2e-3, atol=2e-3)

    # cross-process JFA V iteration == single-process serial iteration
    from tests._multihost_worker import jfa_problem
    from lia_ral_tpu.fa.jfa import jfa_v_iteration
    jstats, jmodel, jx, jz = jfa_problem()
    ref_m, ref_y = jfa_v_iteration(jstats, jmodel, jx, jz)
    got_j = load("jfa")
    np.testing.assert_allclose(got_j["v"], np.asarray(ref_m.v),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_j["y"], np.asarray(ref_y),
                               rtol=2e-4, atol=2e-5)

    # cross-process i-vector extraction == single-process estimate_w
    ref_w = estimate_w(stats_tv, tv_model, chunk=2, pcg_iters=12)
    np.testing.assert_allclose(load("w_iv")["w"], np.asarray(ref_w),
                               rtol=2e-3, atol=2e-3)
