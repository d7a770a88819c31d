"""The port's sharded accumulators (lia_ral_tpu_torch/parallel) against the
JAX package's, mirroring tests/test_parallel.py.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port runs on an 8-shard mesh of one repeated CPU device (its counterpart
of that flag), one thread a shard.  The same seeded numpy inputs go
through both packages; random inits of the JAX tests (jax.random) are
carried across with ``convert``.  Tolerances are the JAX tests' own:
rtol 1e-4, atol 1e-4 for the stats; 2e-4 for the 2-D stats; 2e-3 for the
TV E-step; rtol 2e-4, atol 2e-5 for JFA and i-vector extraction; 5e-4 /
5e-5 for PLDA EM and 2e-4 for its scores; rtol 2e-3, atol 2e-4 for the
TotalVariability T matrix under numThread; 5e-3 for trained means.
Every sharded function is also run twice: the reruns are equal to the
digit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lia_ral_tpu.gmm import GmmDiag as JGmm
from lia_ral_tpu.gmm import em as jem
from lia_ral_tpu.gmm.kernels import em_stats_chunked as j_em_stats_chunked
from lia_ral_tpu.parallel import make_mesh as j_make_mesh
from lia_ral_tpu.parallel import sharding as jsh

from lia_ral_tpu_torch import convert
from lia_ral_tpu_torch.gmm import em as tem
from lia_ral_tpu_torch.parallel import mesh as tmesh
from lia_ral_tpu_torch.parallel import sharding as tsh

from _torch_parity import assert_close_scaled, np_of, random_gmm_np

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)


def port_mesh(n_data=8, n_model=1):
    return tmesh.make_mesh(n_data, n_model, [CPU] * (n_data * n_model))


def gmm_pair(rng, k, d):
    w, m, ci = random_gmm_np(rng, k, d)
    return JGmm.create(w, m, ci), convert.gmm_from_numpy(w, m, ci)


def frames(rng, n, d, ones=False):
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (np.ones(n) if ones else rng.random(n)).astype(np.float32)
    return x, w


def assert_tree_close(got, want, **tol):
    """Port state (dataclass of tensors) against a JAX pytree with the
    same field names."""
    for name, v in convert.to_numpy(got).items():
        np.testing.assert_allclose(v, np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)


def assert_same_digits(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _leaves(o)]
    return [torch.as_tensor(v) for v in convert.to_numpy(obj).values()]


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8
    mesh = port_mesh()
    assert mesh.shape == {"data": 8, "model": 1} and mesh.size == 8
    assert mesh.axis_names == ("data", "model")
    assert mesh.local_keys() == [(i, 0) for i in range(8)]
    assert tmesh.make_mesh(4, 2, [CPU] * 8).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        tmesh.make_mesh(4, 3, [CPU] * 8)


def test_sharded_equals_serial(rng):
    k, d, n = 6, 5, 1000
    jg, tg = gmm_pair(rng, k, d)
    x, w = frames(rng, n, d)
    j_serial = j_em_stats_chunked(jnp.asarray(x), jnp.asarray(w), jg,
                                  chunk=128)
    j_shard = jsh.sharded_em_stats(j_make_mesh(), jnp.asarray(x),
                                   jnp.asarray(w), jg, chunk=128)
    got = tsh.sharded_em_stats(port_mesh(), torch.from_numpy(x),
                               torch.from_numpy(w), tg, chunk=128)
    assert_tree_close(got, j_serial, **TOL)
    assert_tree_close(got, j_shard, **TOL)


def test_sharded_unpadded_frame_count(rng):
    k, d, n = 4, 3, 1001       # 1001 % 8 != 0
    jg, tg = gmm_pair(rng, k, d)
    x, w = frames(rng, n, d, ones=True)
    got = tsh.sharded_em_stats(port_mesh(), torch.from_numpy(x),
                               torch.from_numpy(w), tg, chunk=64)
    assert abs(float(got.count) - n) < 0.5
    want = jsh.sharded_em_stats(j_make_mesh(), jnp.asarray(x),
                                jnp.asarray(w), jg, chunk=64)
    assert_tree_close(got, want, **TOL)


def test_train_model_with_sharded_stats(rng):
    d, k, n = 4, 8, 4000
    centers = rng.standard_normal((k, d)) * 3
    x = (centers[rng.integers(0, k, n)]
         + rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    cfg = dict(nb_train_it=3, bagged_frame_probability=1.0)
    init = jem.mixture_init(jax.random.key(0), jnp.asarray(x),
                            jnp.asarray(w), k, 1.0)
    j_serial = jem.train_model(jax.random.key(1), jnp.asarray(x),
                               jnp.asarray(w), init, jem.TrainCfg(**cfg))
    t_init = convert.gmm_from_numpy(np.asarray(init.weights),
                                    np.asarray(init.means),
                                    np.asarray(init.cov_inv))
    got = tem.train_model(torch.Generator().manual_seed(1),
                          torch.from_numpy(x), torch.from_numpy(w), t_init,
                          tem.TrainCfg(**cfg),
                          stats_fn=tsh.sharded_stats_fn(port_mesh(),
                                                        chunk=512))
    np.testing.assert_allclose(np_of(got.means), np.asarray(j_serial.means),
                               rtol=5e-3, atol=5e-3)


def test_2d_sharded_equals_serial(rng):
    k, d, n = 8, 5, 1000
    jg, tg = gmm_pair(rng, k, d)
    x, w = frames(rng, n, d)
    j_serial = j_em_stats_chunked(jnp.asarray(x), jnp.asarray(w), jg,
                                  chunk=128)
    j_shard = jsh.sharded_em_stats_2d(j_make_mesh(n_data=4, n_model=2),
                                      jnp.asarray(x), jnp.asarray(w), jg,
                                      chunk=128)
    mesh = port_mesh(4, 2)
    got = tsh.sharded_em_stats_2d(mesh, torch.from_numpy(x),
                                  torch.from_numpy(w), tg, chunk=128)
    assert_tree_close(got, j_serial, rtol=2e-4, atol=2e-4)
    assert_tree_close(got, j_shard, rtol=2e-4, atol=2e-4)


def tv_case(rng, k, d, r, s, key, n_scale, n_off, f_scale):
    from lia_ral_tpu.fa.stats import BwStats as JBw
    from lia_ral_tpu.fa.tv import init_t as j_init_t

    jg, _ = gmm_pair(rng, k, d)
    jmodel = j_init_t(jax.random.key(key), r, jg)
    n = (rng.random((s, k)) * n_scale + n_off).astype(np.float32)
    f = (rng.standard_normal((s, k, d)) * f_scale).astype(np.float32)
    tmodel = convert.tv_from_numpy(np.asarray(jmodel.t),
                                   np.asarray(jmodel.ubm_means),
                                   np.asarray(jmodel.ubm_inv_var))
    return (JBw(n=jnp.asarray(n), f=jnp.asarray(f)), jmodel,
            convert.bw_stats_from_numpy(n, f), tmodel)


def test_sharded_tv_e_step_equals_serial(rng):
    from lia_ral_tpu.fa.tv import tv_e_step as j_tv_e_step

    jstats, jmodel, tstats, tmodel = tv_case(rng, 4, 3, 2, 16, 0, 20, 1, 5)
    w_ser, acc_ser = j_tv_e_step(jstats, jmodel, chunk=4)
    w_shd, acc_shd = tsh.sharded_tv_e_step(port_mesh(), tstats, tmodel,
                                           chunk=2)
    np.testing.assert_allclose(np_of(w_shd), np.asarray(w_ser),
                               rtol=2e-3, atol=2e-3)
    assert_tree_close(acc_shd, acc_ser, rtol=2e-3, atol=2e-3)


def test_sharded_jfa_iterations_equal_serial(rng):
    from lia_ral_tpu.fa.jfa import JfaModel as JJfa
    from lia_ral_tpu.fa.jfa import jfa_u_iteration, jfa_v_iteration
    from tests.test_jfa import synth_jfa_data

    gmm, jstats, *_ = synth_jfa_data(rng, n_spk=11, sess_per_spk=3)
    jmodel = JJfa.init(jax.random.key(0), 2, 2, gmm, scale=0.1)
    s, h = jstats.spk.n.shape[0], jstats.sess.n.shape[0]
    x = (rng.standard_normal((h, 2)) * 0.1).astype(np.float32)
    z = np.zeros(jstats.spk.f.shape, np.float32)
    y0 = (rng.standard_normal((s, 2)) * 0.1).astype(np.float32)
    tstats = convert.jfa_stats_from_numpy(
        np.asarray(jstats.sess.n), np.asarray(jstats.sess.f),
        np.asarray(jstats.sess_spk), s)
    tmodel = convert.jfa_from_numpy(*(np.asarray(getattr(jmodel, f)) for f in
                                      ("v", "u", "d", "ubm_means",
                                       "ubm_inv_var")))
    mesh = port_mesh()
    tol = dict(rtol=2e-4, atol=2e-5)
    mv_ser, y_ser = jfa_v_iteration(jstats, jmodel, jnp.asarray(x),
                                    jnp.asarray(z))
    mv_shd, y_shd = tsh.sharded_jfa_v_iteration(
        mesh, tstats, tmodel, torch.from_numpy(x), torch.from_numpy(z))
    np.testing.assert_allclose(np_of(mv_shd.v), np.asarray(mv_ser.v), **tol)
    np.testing.assert_allclose(np_of(y_shd), np.asarray(y_ser), **tol)
    mu_ser, x_ser = jfa_u_iteration(jstats, jmodel, jnp.asarray(y0),
                                    jnp.asarray(z))
    mu_shd, x_shd = tsh.sharded_jfa_u_iteration(
        mesh, tstats, tmodel, torch.from_numpy(y0), torch.from_numpy(z))
    np.testing.assert_allclose(np_of(mu_shd.u), np.asarray(mu_ser.u), **tol)
    np.testing.assert_allclose(np_of(x_shd), np.asarray(x_ser), **tol)


def plda_case(rng):
    from lia_ral_tpu.backend.ivnorm import DevSet as JDev
    from lia_ral_tpu.backend.plda import PldaModel as JPlda

    r, rf, rg, n_spk, sess = 20, 6, 3, 13, 3
    h = rng.standard_normal((n_spk, rf))
    f_true = rng.standard_normal((r, rf))
    g_true = rng.standard_normal((r, rg)) * 0.5
    vecs, labels = [], []
    for s_ in range(n_spk):
        for _ in range(sess):
            vecs.append(f_true @ h[s_] + g_true @ rng.standard_normal(rg)
                        + rng.standard_normal(r) * 0.3)
            labels.append(f"s{s_}")
    vecs = np.asarray(vecs, np.float32)
    jdev = JDev.from_labels(vecs, labels)
    jmodel = JPlda.init(jax.random.key(1), r, rf, rg,
                        data_mean=np.mean(vecs, 0),
                        data_cov=np.cov(vecs.T))
    tdev = convert.dev_set_from_numpy(vecs, np.asarray(jdev.spk_ids),
                                      int(jdev.n_speakers))
    return jdev, jmodel, tdev, plda_to_port(jmodel), (r, rf, rg)


def plda_to_port(jmodel):
    return convert.plda_from_numpy(*(np.asarray(getattr(jmodel, f))
                                     for f in ("mean", "f", "g", "sigma")))


def test_sharded_plda_em_and_scoring_equal_serial(rng):
    from lia_ral_tpu.backend.plda import (plda_em_iteration, plda_llr,
                                          plda_train)

    from lia_ral_tpu_torch.backend.plda import plda_llr as t_plda_llr

    jdev, jmodel, tdev, tmodel, (r, rf, rg) = plda_case(rng)
    mesh = port_mesh()
    ser = plda_em_iteration(jmodel, jdev)
    shd = tsh.sharded_plda_em_iteration(mesh, tmodel, tdev)
    assert_tree_close(shd, ser, rtol=5e-4, atol=5e-5)
    # scoring: 7 models (pads to 8) x 9 tests
    plda = plda_train(jax.random.key(2), jdev, rf, rg, n_iterations=4)
    enroll = rng.standard_normal((7, r)).astype(np.float32)
    ns = rng.integers(1, 4, 7).astype(np.float32)
    test = rng.standard_normal((9, r)).astype(np.float32)
    s_ser = np.asarray(plda_llr(plda, jnp.asarray(enroll), jnp.asarray(ns),
                                jnp.asarray(test)))
    tplda = plda_to_port(plda)
    args = [torch.from_numpy(a) for a in (enroll, ns, test)]
    s_shd = tsh.sharded_plda_llr(mesh, tplda, *args)
    # sharded against serial: the JAX test's budget; against the JAX
    # scores: tests/test_torch_backend.py's cross-package one
    np.testing.assert_allclose(np_of(s_shd), np_of(t_plda_llr(tplda, *args)),
                               rtol=2e-4, atol=2e-4)
    assert_close_scaled(s_shd, s_ser, 1e-4)


def _tv_tool_corpus(rng, tmp_path):
    from lia_ral_tpu_torch.io.features import write_feature_file
    from lia_ral_tpu_torch.io.lists import write_xlist

    k, d = 8, 5
    w, m, ci = random_gmm_np(rng, k, d)
    m = m * 2
    ci = (rng.random((k, d)) * 0.5 + 0.8).astype(np.float32)
    convert.gmm_from_numpy(w, m, ci).save(str(tmp_path / "wld.gmm"))
    rows = []
    for s_ in range(10):
        nm = f"sess{s_}"
        comp = rng.integers(0, k, 300)
        x = (m[comp] + rng.standard_normal((300, d)) * 0.6).astype(np.float32)
        write_feature_file(str(tmp_path / (nm + ".prm")), x, fmt="SPRO4")
        rows.append([nm])
    write_xlist(str(tmp_path / "tv.ndx"), rows)
    return {
        "featureFilesPath": str(tmp_path) + "/",
        "mixtureFilesPath": str(tmp_path) + "/",
        "matrixFilesPath": str(tmp_path) + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".prm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "ndxFilename": str(tmp_path / "tv.ndx"),
        "inputWorldFilename": "wld",
        "totalVariabilityNumber": 4, "nbIt": 3, "initScale": 0.5,
    }


def test_tools_numthread_sharded_equal_serial(rng, tmp_path, monkeypatch):
    """numThread reaches TotalVariability through the tools: an 8-shard
    run gives the JAX tool's T matrix (both from one T init, patched on
    both sides, as tests/test_torch_tools.py does)."""
    from lia_ral_tpu.config import Config as JConfig
    from lia_ral_tpu.fa import tv as jtv
    from lia_ral_tpu.tools import total_variability as j_tv_tool
    from lia_ral_tpu_torch.config import Config as TConfig
    from lia_ral_tpu_torch.fa import tv as ttv
    from lia_ral_tpu_torch.io.matrix import read_matrix_file
    from lia_ral_tpu_torch.tools import total_variability as t_tv_tool

    base = _tv_tool_corpus(rng, tmp_path)
    t0 = (rng.standard_normal((4, 8, 5)) * 0.5).astype(np.float32)
    monkeypatch.setattr(j_tv_tool, "init_t", lambda key, rank, gmm,
                        scale=1.0: jtv.TvModel.from_ubm(jnp.asarray(t0), gmm))
    monkeypatch.setattr(t_tv_tool, "init_t", lambda gen, rank, gmm,
                        scale=1.0: ttv.TvModel.from_ubm(
                            torch.from_numpy(t0), gmm))
    monkeypatch.setattr(tmesh, "visible_devices", lambda kind="cuda":
                        [torch.device(kind)] * 8)
    calls = []
    real = tsh.sharded_tv_e_step
    monkeypatch.setattr(tsh, "sharded_tv_e_step", lambda mesh, *a, **kw:
                        calls.append(mesh.shape) or real(mesh, *a, **kw))
    j_tv_tool.main(JConfig(dict(base, totalVariabilityMatrix="TV1")))
    j_tv_tool.main(JConfig(dict(base, totalVariabilityMatrix="TV8",
                                numThread=8)))
    t_tv_tool.main(TConfig(dict(base, totalVariabilityMatrix="PT8",
                                numThread=8, torchDevice="cpu")))
    assert calls == [{"data": 8, "model": 1}] * 3
    read = {n: read_matrix_file(str(tmp_path / f"{n}.matx"))
            for n in ("TV1", "TV8", "PT8")}
    np.testing.assert_allclose(read["PT8"], read["TV1"], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(read["PT8"], read["TV8"], rtol=2e-3,
                               atol=2e-4)


@pytest.mark.parametrize("solver", ["pcg", "cholesky"])
def test_sharded_estimate_w_equals_serial(rng, solver):
    from lia_ral_tpu.fa.tv import estimate_w as j_estimate_w

    jstats, jmodel, tstats, tmodel = tv_case(rng, 12, 5, 6, 19, 4, 30, 0.5,
                                             4)   # 19 pads to 24 over 8
    w_ser = np.asarray(j_estimate_w(jstats, jmodel, chunk=4, solver=solver))
    w_shd = tsh.sharded_estimate_w(port_mesh(), tstats, tmodel, chunk=2,
                                   solver=solver)
    np.testing.assert_allclose(np_of(w_shd), w_ser, rtol=2e-4, atol=2e-5)


def test_sharded_tv_e_step_2d_equals_serial(rng):
    from lia_ral_tpu.fa.tv import tv_e_step as j_tv_e_step
    from lia_ral_tpu.fa.tv import tv_m_step as j_tv_m_step
    from lia_ral_tpu_torch.fa.tv import tv_m_step as t_tv_m_step

    jstats, jmodel, tstats, tmodel = tv_case(rng, 8, 3, 4, 11, 7, 25, 1, 4)
    w_ser, acc_ser = j_tv_e_step(jstats, jmodel, chunk=4)
    w_shd, acc_shd = tsh.sharded_tv_e_step_2d(port_mesh(4, 2), tstats,
                                              tmodel, chunk=2)
    np.testing.assert_allclose(np_of(w_shd), np.asarray(w_ser),
                               rtol=2e-3, atol=2e-3)
    assert_tree_close(acc_shd, acc_ser, rtol=2e-3, atol=2e-3)
    # the M-step consumes the sharded accums directly
    np.testing.assert_allclose(np_of(t_tv_m_step(tmodel, acc_shd).t),
                               np.asarray(j_tv_m_step(jmodel, acc_ser).t),
                               rtol=5e-3, atol=5e-3)


def test_every_collective_reruns_equal_to_the_digit(rng):
    """Two runs of every sharded function give the same digits: the
    collectives reduce in shard-index order, whatever order the shard
    threads arrive in."""
    jg, tg = gmm_pair(rng, 8, 5)
    x, w = (torch.from_numpy(a) for a in frames(rng, 1001, 5))
    _, _, tstats, tmodel = tv_case(rng, 8, 3, 4, 11, 7, 25, 1, 4)
    _, _, tdev, tplda, (r, _, _) = plda_case(rng)
    enroll = torch.from_numpy(rng.standard_normal((7, r)).astype(np.float32))
    ns = torch.from_numpy(rng.integers(1, 4, 7).astype(np.float32))
    test = torch.from_numpy(rng.standard_normal((9, r)).astype(np.float32))
    jstats = convert.jfa_stats_from_numpy(
        (rng.random((12, 8)) * 20 + 1).astype(np.float32),
        rng.standard_normal((12, 8, 3)).astype(np.float32),
        np.arange(12) % 5, 5)
    jmodel = convert.jfa_from_numpy(
        *(rng.standard_normal((2, 8, 3)).astype(np.float32) * 0.1
          for _ in range(2)), np.zeros((8, 3), np.float32),
        np.asarray(tmodel.ubm_means), np.asarray(tmodel.ubm_inv_var))
    y0 = torch.zeros((5, 2))
    x0 = torch.zeros((12, 2))
    z0 = torch.zeros((5, 8, 3))
    m1, m2 = port_mesh(), port_mesh(4, 2)
    calls = {
        "em": lambda: tsh.sharded_em_stats(m1, x, w, tg, chunk=64),
        "stats_fn": lambda: tsh.sharded_stats_fn(m1, chunk=64)(x, w, tg),
        "em_2d": lambda: tsh.sharded_em_stats_2d(m2, x, w, tg, chunk=64),
        "tv": lambda: tsh.sharded_tv_e_step(m1, tstats, tmodel, chunk=2),
        "tv_2d": lambda: tsh.sharded_tv_e_step_2d(m2, tstats, tmodel,
                                                  chunk=2),
        "subspace": lambda: tsh.sharded_subspace_accums(
            m1, tmodel.t, tmodel.ubm_inv_var, tstats.n,
            tstats.centered(tmodel.ubm_means)),
        "w": lambda: tsh.sharded_estimate_w(m1, tstats, tmodel, chunk=2),
        "jfa_v": lambda: tsh.sharded_jfa_v_iteration(m1, jstats, jmodel, x0,
                                                     z0),
        "jfa_u": lambda: tsh.sharded_jfa_u_iteration(m1, jstats, jmodel, y0,
                                                     z0),
        "plda": lambda: tsh.sharded_plda_em_iteration(m1, tplda, tdev),
        "plda_llr": lambda: tsh.sharded_plda_llr(m1, tplda, enroll, ns,
                                                 test),
    }
    for name, fn in calls.items():
        assert_same_digits(fn(), fn())


def test_resolve_mesh_needs_threads_and_devices(monkeypatch):
    """numThread 1 gives no mesh; numThread 4 with one visible device
    gives none either (as the JAX function with one device); with four
    visible shards of the device, a 4 × 1 mesh and the sharded stats."""
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.tools.common import (resolve_mesh,
                                                resolve_stats_fn)

    cpu = {"torchDevice": "cpu"}
    assert resolve_mesh(Config(dict(cpu, numThread=1))) is None
    assert resolve_mesh(Config(dict(cpu, numThread=4))) is None
    assert resolve_stats_fn(Config(dict(cpu, numThread=4))) is None
    monkeypatch.setattr(tmesh, "visible_devices", lambda kind="cuda":
                        [torch.device(kind)] * 4)
    assert resolve_mesh(Config(dict(cpu, numThread=1))) is None
    mesh = resolve_mesh(Config(dict(cpu, numThread=8)))
    assert mesh.shape == {"data": 4, "model": 1}
    assert resolve_stats_fn(Config(dict(cpu, numThread=4))) is not None


def test_a_failing_shard_releases_the_others():
    """A shard that raises makes the shards waiting in a collective leave
    it, and the error comes back to the caller."""
    mesh = port_mesh(4)

    def body(sh):
        if sh.data == 2:
            raise ValueError("shard 2 failed")
        return sh.psum(torch.ones(3), "data")

    with pytest.raises(ValueError, match="shard 2 failed"):
        mesh.run(body)
