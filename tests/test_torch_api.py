"""The serving API and the unsupervised-adaptation layer of the PyTorch
port against the JAX package's: ``frontend/mfcc`` and ``frontend/sdc``,
every function of ``backend/unsupervised``, ``UnsupervisedAdapter`` over a
trial sequence, SpkAdapt through both CLIs, ``SimpleSpkDetSystem`` in both
packages, and the port's ``SpkDetServer`` / ``RemoteSpkDetClient`` over a
real socket.

Inputs are made with numpy from a seed and handed to both packages; each
test states its tolerance.  Everything runs on the CPU here
(``device="cpu"`` / ``--torchDevice cpu``).
"""

import importlib
import os
import shutil
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lia_ral_tpu.api import SimpleSpkDetSystem as JSystem
from lia_ral_tpu.backend import unsupervised as jun
from lia_ral_tpu.config import Config as JConfig
from lia_ral_tpu.frontend import sdc as jsdc
from lia_ral_tpu.gmm import em as jem
from lia_ral_tpu.gmm.map_adapt import MapCfg as JMapCfg
from lia_ral_tpu.gmm.model import GmmDiag as JGmm
from lia_ral_tpu.io.gmm_io import read_gmm_file
from lia_ral_tpu.io.nist import read_nist_scores
from lia_ral_tpu.tools import spk_adapt as j_spk_adapt

from lia_ral_tpu_torch import __main__ as tmain
from lia_ral_tpu_torch import convert
from lia_ral_tpu_torch.api import (RemoteSpkDetClient, SimpleSpkDetSystem,
                                   SpkDetServer)
from lia_ral_tpu_torch.api import server as tserver
from lia_ral_tpu_torch.backend import unsupervised as tun
from lia_ral_tpu_torch.config import Config as TConfig
from lia_ral_tpu_torch.frontend import sdc as tsdc
from lia_ral_tpu_torch.gmm import cuda_kernels as ck
from lia_ral_tpu_torch.gmm.map_adapt import MapCfg as TMapCfg
from lia_ral_tpu_torch.gmm.scoring import compute_test_llr, stack_gmms
from lia_ral_tpu_torch.io.features import (read_feature_file,
                                           write_feature_file)
from lia_ral_tpu_torch.io.lists import write_xlist
from lia_ral_tpu_torch.io.nist import ScoreLine, write_nist_scores

from _torch_parity import both_gmms, np_of

# both ``frontend`` packages export the function ``mfcc``, which hides the
# module of that name from ``from ... import``
jmfcc = importlib.import_module("lia_ral_tpu.frontend.mfcc")
tmfcc = importlib.import_module("lia_ral_tpu_torch.frontend.mfcc")

DIM, K = 8, 16


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _tgmm(jg):
    return convert.gmm_from_numpy(np.asarray(jg.weights),
                                  np.asarray(jg.means),
                                  np.asarray(jg.cov_inv))


@pytest.fixture(scope="module")
def world_and_data():
    """A K=16, D=8 world trained by the JAX package (shared with the port
    as numpy) and a generator of speaker-shifted utterances."""
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((K, DIM)) * 2

    def utt(shift, n=1500):
        comp = rng.integers(0, K, n)
        return (centers[comp] + shift
                + rng.standard_normal((n, DIM)) * 0.5).astype(np.float32)

    bg = utt(0.0, 8000)
    xj = jnp.asarray(bg)
    w = jnp.ones(bg.shape[0], jnp.float32)
    init = jem.mixture_init(jax.random.key(0), xj, w, K, 1.0)
    ubm = jem.train_model(jax.random.key(1), xj, w, init,
                          jem.TrainCfg(nb_train_it=4))
    spk1 = rng.standard_normal(DIM) * 1.0
    return ubm, _tgmm(ubm), utt, spk1, -spk1


# -- MFCC, SDC ------------------------------------------------------------------

def test_mfcc_matrices_equal_and_cepstra_match_jax(rng):
    """The filterbank and DCT matrices (numpy) are equal to the digit.  The
    cepstra of a 1 s noisy two-tone signal: atol 2e-4·max|c| (the two FFTs
    and the log of the filterbank energies in f32), the energy column rtol
    1e-5."""
    for n_fft, nf in ((256, 24), (512, 20)):
        np.testing.assert_array_equal(
            tmfcc.mel_filterbank(n_fft, nf, 8000.0, 0.0, 0.0),
            jmfcc.mel_filterbank(n_fft, nf, 8000.0, 0.0, 0.0))
    np.testing.assert_array_equal(tmfcc.dct_matrix(19, 24),
                                  jmfcc.dct_matrix(19, 24))
    t = np.arange(8000) / 8000.0
    sig = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1800 * t)
           + 0.05 * rng.standard_normal(8000)).astype(np.float32)
    for cfg_kw in ({}, {"with_energy": False, "n_ceps": 12, "n_filters": 20,
                        "freq_min": 200.0, "freq_max": 3400.0}):
        got = np_of(tmfcc.mfcc(torch.from_numpy(sig),
                               tmfcc.MfccCfg(**cfg_kw)))
        want = np.asarray(jmfcc.mfcc(jnp.asarray(sig),
                                     jmfcc.MfccCfg(**cfg_kw)))
        assert got.shape == want.shape == (99, want.shape[1])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-4 * np.abs(want).max())
    np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=1e-5, atol=1e-4)
    assert tmfcc.mfcc(torch.zeros(50)).shape == (0, 20)


def test_add_deltas_and_sdc_match_jax(rng):
    """Pure gathers and f32 differences: rtol 1e-6."""
    x = rng.standard_normal((40, 9)).astype(np.float32)
    for window in (1, 2, 3):
        np.testing.assert_allclose(
            np_of(tmfcc.add_deltas(torch.from_numpy(x), window)),
            np.asarray(jmfcc.add_deltas(jnp.asarray(x), window)), rtol=1e-6,
            atol=1e-6)
    for kw in ({}, {"n": 5, "d": 2, "p": 2, "k": 3}):
        got = np_of(tsdc.shifted_delta_cepstra(torch.from_numpy(x), **kw))
        want = np.asarray(jsdc.shifted_delta_cepstra(jnp.asarray(x), **kw))
        np.testing.assert_array_equal(got, want)


# -- backend/unsupervised: the score arithmetic ---------------------------------------

def test_wmap_expand_priors_match_jax(rng):
    """numpy on the host in both packages: equal to the digit (wmap_gmm
    through each package's f32 ``frame_llk``: rtol 1e-5)."""
    s = rng.standard_normal(30) * 3
    np.testing.assert_array_equal(tun.wmap(s, 1.0, 1.5, -1.0, 0.7, 0.2),
                                  jun.wmap(s, 1.0, 1.5, -1.0, 0.7, 0.2))
    np.testing.assert_array_equal(tun.expand_llr(s, 0.3, 1.7),
                                  jun.expand_llr(s, 0.3, 1.7))
    for a, b in zip(tun.compute_priors(s, 2.0, 5.0, 0.5),
                    jun.compute_priors(s, 2.0, 5.0, 0.5)):
        np.testing.assert_array_equal(a, b)
    jt, tt = both_gmms(rng, 2, 1)
    ji, ti = both_gmms(rng, 3, 1)
    np.testing.assert_allclose(tun.wmap_gmm(s, tt, ti, prior_tar=0.3),
                               jun.wmap_gmm(s, jt, ji, prior_tar=0.3),
                               rtol=1e-5, atol=1e-7)
    st, ms = tun.windowed_llr(s, 8, 3)
    sj, mj = jun.windowed_llr(s, 8, 3)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(ms, mj)


def test_oracle_norm_caches_and_lookup_match_jax(rng):
    jt, tt = both_gmms(rng, 2, 1)
    ji, ti = both_gmms(rng, 2, 1)
    tests = [("m1", "t1"), ("m2", "t3")]
    for args in (("m1", "t1", 0.7), ("m1", "t2", 0.7)):
        assert tun.oracle(*args, tests) == jun.oracle(*args, tests)
        np.testing.assert_allclose(
            tun.oracle(*args, tests, wmap_type=True, tar=tt, imp=ti),
            jun.oracle(*args, tests, wmap_type=True, tar=jt, imp=ji),
            rtol=1e-5)
    assert tun.oracle("m1", "t1", 0.0, tests, classical_type=False) == 0.0
    res = [(f"imp{i}", f"t{j}", float(rng.standard_normal()))
           for i in range(5) for j in range(3)]
    for field, ents in (("test", ["t0", "t2", "nope"]),
                        ("model", ["imp1", "imp4"])):
        got = tun.load_tnorm_param(ents, res, field)
        want = jun.load_tnorm_param(ents, res, field)
        assert set(got) == set(want) and "nope" not in got
        for k in got:
            assert (got[k].mu, got[k].sigma) == (want[k].mu, want[k].sigma)
    cache = tun.load_tnorm_param(["t0"], res)
    jcache = jun.load_tnorm_param(["t0"], res)
    assert tun.normalize_score("t0", 0.4, cache, 0.1) == \
        jun.normalize_score("t0", 0.4, jcache, 0.1)
    assert tun.normalize_score("zz", 0.4, cache) == 0.4
    assert tun.search_llr_from_res_file(res, "imp2", "t1") == \
        jun.search_llr_from_res_file(res, "imp2", "t1")
    assert tun.search_llr_from_res_file(res, "x", "y") is None
    j1, t1 = both_gmms(rng, 4, 3)
    j2, t2 = both_gmms(rng, 4, 3)
    np.testing.assert_allclose(
        np_of(tun.fuse_map_means(t1, 2.0, t2, 0.5).means),
        np.asarray(jun.fuse_map_means(j1, 2.0, j2, 0.5).means), rtol=1e-6)


# -- backend/unsupervised: the model side -------------------------------------------

def test_unsupervised_adapter_matches_jax_over_four_trials(world_and_data):
    """Enrolment and four weighted trials (one under the 1e-4 floor, which
    both packages skip): the adapted means after every step within
    1e-4·max|μ|, the scores before each trial within 1e-3 (the LLR
    budget of the top-K scorer), and no K1 launch (the adapter's stats
    are the f32 path by name)."""
    jubm, tubm, utt, spk1, spk2 = world_and_data
    jmc = JMapCfg(method="MAPOccDep", mean_adapt=True, mean_r=14.0)
    tmc = TMapCfg(method="MAPOccDep", mean_adapt=True, mean_r=14.0)
    ja = jun.UnsupervisedAdapter(world=jubm, map_cfg=jmc)
    ta = tun.UnsupervisedAdapter(world=tubm, map_cfg=tmc)
    before = dict(ck.launch_counts)
    x = utt(spk1, 600)
    w = np.ones(600, np.float32)
    ja.enroll(jnp.asarray(x), jnp.asarray(w))
    ta.enroll(torch.from_numpy(x), torch.from_numpy(w))
    scale = float(np.abs(np.asarray(jubm.means)).max())
    for shift, weight in ((spk1, 0.9), (spk2, 0.00005), (spk1, 0.4),
                          (spk2, 0.1)):
        x = utt(shift, 500)
        w = (np.arange(500) % 7 != 0).astype(np.float32)
        sj = ja.score(jnp.asarray(x), jnp.asarray(w))
        st = ta.score(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_allclose(st, sj, rtol=0, atol=1e-3)
        ja.process_trial(jnp.asarray(x), jnp.asarray(w), weight)
        ta.process_trial(torch.from_numpy(x), torch.from_numpy(w), weight)
        np.testing.assert_allclose(np_of(ta.model.means),
                                   np.asarray(ja.model.means), rtol=0,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(float(ta.stats.count),
                                   float(ja.stats.count), rtol=1e-6)
    assert ck.launch_counts == before


def test_znorm_params_match_jax(world_and_data):
    """compute_and_store_znorm_param (with and without a T-norm cache) and
    online_znorm_params on a padded cohort: μ and σ within 1e-3 (LLR
    budget); fewer than two cohort files raise; a degenerate cohort warns."""
    jubm, tubm, utt, spk1, spk2 = world_and_data
    x = utt(spk1, 700)
    w = np.ones(700, np.float32)
    jcl = jun.UnsupervisedAdapter(world=jubm, map_cfg=JMapCfg(mean_adapt=True))
    tcl = tun.UnsupervisedAdapter(world=tubm, map_cfg=TMapCfg(mean_adapt=True))
    jcl.enroll(jnp.asarray(x), jnp.asarray(w))
    tcl.enroll(torch.from_numpy(x), torch.from_numpy(w))
    imps = [utt(spk2 * f, 300 + 40 * i) for i, f in enumerate((1.0, 0.5, -0.3))]
    ids = ["i0", "i1", "i2"]
    cache = {"i0": tun.NormParams(0.1, 2.0)}
    jcache = {"i0": jun.NormParams(0.1, 2.0)}
    for tc, jc in ((None, None), (cache, jcache)):
        got = tun.compute_and_store_znorm_param(
            tcl.model, tubm, [(torch.from_numpy(i),
                               torch.ones(i.shape[0])) for i in imps],
            ids, tc)
        want = jun.compute_and_store_znorm_param(
            jcl.model, jubm, [(jnp.asarray(i), jnp.ones(i.shape[0]))
                              for i in imps], ids, jc)
        np.testing.assert_allclose([got.mu, got.sigma],
                                   [want.mu, want.sigma], rtol=0, atol=1e-3)
    t_max = max(i.shape[0] for i in imps)
    cx = np.zeros((3, t_max, DIM), np.float32)
    cw = np.zeros((3, t_max), np.float32)
    for i, m in enumerate(imps):
        cx[i, :m.shape[0]] = m
        cw[i, :m.shape[0]] = 1.0
    got = tun.online_znorm_params(tcl.model, tubm, torch.from_numpy(cx),
                                  torch.from_numpy(cw))
    want = jun.online_znorm_params(jcl.model, jubm, jnp.asarray(cx),
                                   jnp.asarray(cw))
    np.testing.assert_allclose([got.mu, got.sigma], [want.mu, want.sigma],
                               rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="need >= 2"):
        tun.online_znorm_params(tcl.model, tubm, torch.from_numpy(cx[:1]),
                                torch.from_numpy(cw[:1]))
    with pytest.warns(RuntimeWarning, match="near-degenerate"):
        p = tun.online_znorm_params(tubm, tubm, torch.from_numpy(cx),
                                    torch.from_numpy(cw))
    assert p.sigma >= 1e-6


def test_cross_valid_selects_the_lowest_held_out_llr(world_and_data):
    """The bagged splits come from each package's own random stream, so
    the port is held to the function's contract: the returned split has
    the lowest held-out LLR of the ``average_it`` it drew (re-derived here
    from the same generator seed), its mask keeps about ``selected_train``
    of the frames, and the JAX package's LLR lies in the same range."""
    jubm, tubm, utt, spk1, _ = world_and_data
    x = utt(spk1, 900)
    w = np.ones(900, np.float32)
    tmc = TMapCfg(method="MAPOccDep", mean_adapt=True, mean_r=14.0)
    em_model, sel, llr = tun.cross_valid(_gen(3), torch.from_numpy(x),
                                         torch.from_numpy(w), tubm, tmc,
                                         average_it=3)
    assert 0.6 < float(sel.mean()) < 0.95
    assert em_model.means.shape == (K, DIM)
    # the same draws again, one split at a time
    from lia_ral_tpu_torch.gmm.em import bagged_frame_mask, m_step
    from lia_ral_tpu_torch.gmm.kernels import em_stats_chunked
    from lia_ral_tpu_torch.gmm.map_adapt import map_adapt
    g = _gen(3)
    llrs = []
    for _ in range(3):
        s = bagged_frame_mask(g, torch.from_numpy(w), 0.8)
        st = em_stats_chunked(torch.from_numpy(x), s, tubm)
        client = map_adapt(tubm, m_step(st), st.count, tmc)
        llrs.append(float(compute_test_llr(
            torch.from_numpy(x), torch.where(s > 0, 0.0, 1.0), tubm,
            stack_gmms([client]))[0]))
    assert llr == min(llrs)
    _, _, jllr = jun.cross_valid(
        jax.random.key(3), jnp.asarray(x), jnp.asarray(w), jubm,
        JMapCfg(method="MAPOccDep", mean_adapt=True, mean_r=14.0),
        average_it=3)
    assert abs(llr - jllr) < 0.5 and llr > 0 and jllr > 0


# -- SpkAdapt through both CLIs --------------------------------------------------------

@pytest.fixture(scope="module")
def adapt_corpus(tmp_path_factory, world_and_data):
    jubm, _, utt, spk1, spk2 = world_and_data
    d = str(tmp_path_factory.mktemp("torch_adapt"))
    jubm.save(os.path.join(d, "wld.gmm"))
    shifts = {"alice": spk1, "bob": spk2}
    for name, sh in shifts.items():
        write_feature_file(os.path.join(d, f"enr_{name}.prm"), utt(sh, 700),
                           fmt="SPRO4")
    tests = []
    for i, sh in enumerate((spk1, spk2, spk1, spk2 * 0.5)):
        write_feature_file(os.path.join(d, f"tst{i}.prm"), utt(sh, 500),
                           fmt="SPRO4")
        tests.append(f"tst{i}")
    for i in range(3):
        write_feature_file(os.path.join(d, f"coh{i}.prm"),
                           utt(spk1 * (0.3 * i - 0.4), 400 + 30 * i),
                           fmt="SPRO4")
    write_xlist(os.path.join(d, "targets.ndx"),
                [[n, f"enr_{n}"] for n in shifts])
    write_xlist(os.path.join(d, "trials.ndx"),
                [[t, "alice", "bob"] for t in tests])
    write_xlist(os.path.join(d, "cohort.lst"), [[f"coh{i}"] for i in range(3)])
    write_xlist(os.path.join(d, "tartests.ndx"),
                [["alice", "tst0"], ["bob", "tst1"]])
    write_nist_scores(os.path.join(d, "imp.res"), [
        ScoreLine("M", f"imp{i}", "0", t, float(0.1 * i - 0.2 + 0.05 * j))
        for i in range(4) for j, t in enumerate(tests)])
    return d


ADAPT_MODES = {
    "wmap": {},
    "regress": {"REGRESS": "true", "THETA": "-0.5", "BETA": "2.0"},
    "oracle": {"Oracle": "true", "targetTests": "tartests.ndx"},
    "tnorm": {"TNORM": "true", "tnormResFilename": "imp.res"},
    "znorm": {"ZNORM": "true", "impCohortFile": "cohort.lst"},
    "map-keys": {"MAPAlgo": "MAPOccDep", "meanAdapt": "true",
                 "MAPRegFactorMean": "8.0"},
}


@pytest.mark.parametrize("mode", list(ADAPT_MODES))
def test_spk_adapt_through_both_clis(adapt_corpus, tmp_path, mode):
    """SpkAdapt through ``python -m lia_ral_tpu_torch`` (in process) and
    the JAX tool's ``main``, in each trial-weighting mode: scores within
    2e-3 (the LLR budget, carried through up to four weighted updates;
    Z-normed scores 2e-3·(1/σ) ≤ 2e-2), decisions equal where |score| >
    0.05, adapted means within 2e-4·max|μ|."""
    d = adapt_corpus
    outs = {}
    for side in ("t", "j"):
        work = str(tmp_path / side)
        os.makedirs(work)
        cfg = {"featureFilesPath": d + "/", "labelFilesPath": d + "/",
               "lstPath": d + "/", "mixtureFilesPath": work + "/",
               "loadFeatureFileFormat": "SPRO4",
               "loadFeatureFileExtension": ".prm",
               "saveMixtureFileFormat": "RAW",
               "saveMixtureFileExtension": ".gmm",
               "loadMixtureFileExtension": ".gmm",
               "addDefaultLabel": "true", "defaultLabel": "speech",
               "labelSelectedFrames": "speech",
               "inputWorldFilename": "wld",
               "targetIdList": os.path.join(d, "targets.ndx"),
               "ndxFilename": os.path.join(d, "trials.ndx"),
               "outputFilename": os.path.join(work, "adapt.res"),
               "WMAPtarMean": "0.8", "WMAPimpMean": "-0.5",
               "WMAPtarPrior": "0.3"}
        cfg.update(ADAPT_MODES[mode])
        for key in ("targetTests", "tnormResFilename", "impCohortFile"):
            if key in cfg:
                cfg[key] = os.path.join(d, cfg[key])
        # the world is read from mixtureFilesPath: give each side its copy
        shutil.copy(os.path.join(d, "wld.gmm"), os.path.join(work, "wld.gmm"))
        if side == "t":
            args = []
            for k, v in cfg.items():
                args += [f"--{k}", str(v)]
            assert tmain.main(["SpkAdapt"] + args
                              + ["--torchDevice", "cpu"]) == 0
        else:
            j_spk_adapt.main(JConfig(cfg))
        outs[side] = (read_nist_scores(os.path.join(work, "adapt.res")),
                      {n: read_gmm_file(os.path.join(work, n + ".gmm"))
                       for n in ("alice", "bob")})
    (t_sc, t_m), (j_sc, j_m) = outs["t"], outs["j"]
    assert [(s.model, s.seg) for s in t_sc] == [(s.model, s.seg) for s in j_sc]
    assert len(t_sc) == 8
    tol = 2e-2 if mode == "znorm" else 2e-3
    for a, b in zip(t_sc, j_sc):
        assert abs(a.score - b.score) <= tol, (a, b)
        if abs(b.score) > 0.05:
            assert a.decision == b.decision
    # the true speaker's first trial scores above the other speaker's
    by = {(s.model, s.seg): s.score for s in t_sc}
    assert by[("alice", "tst0")] > by[("bob", "tst0")]
    for n in ("alice", "bob"):
        scale = np.abs(j_m[n][1]).max()
        np.testing.assert_allclose(t_m[n][1], j_m[n][1], rtol=0,
                                   atol=2e-4 * scale)
        assert np.isfinite(t_m[n][1]).all()


# -- SimpleSpkDetSystem in both packages ------------------------------------------------

def _enrol_both(world_and_data):
    jubm, tubm, utt, spk1, spk2 = world_and_data
    js, ts = JSystem(), SimpleSpkDetSystem(device="cpu")
    js.set_background_model(jubm)
    ts.set_background_model(tubm)
    for uid, sh in (("alice", spk1), ("bob", spk2), ("carol", spk1 * 0.3)):
        x = utt(sh)
        for s in (js, ts):
            s.reset_features()
            s.add_features(x)
            s.create_speaker_model(uid)
    return js, ts


def test_simple_system_enrol_verify_identify_accumulate(world_and_data):
    """Enrol three speakers, then verify / identify / accumulate on two
    test sessions in both packages: enrolled means within 1e-4·max|μ|,
    LLRs within 1e-3, the same decisions and identities; no K1 launch on
    the CPU."""
    _, _, utt, spk1, spk2 = world_and_data
    before = dict(ck.launch_counts)
    js, ts = _enrol_both(world_and_data)
    assert ts.speaker_ids() == js.speaker_ids() == ["alice", "bob", "carol"]
    for uid in ts.speaker_ids():
        b = np.asarray(js.speakers[uid].means)
        np.testing.assert_allclose(np_of(ts.speakers[uid].means), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    for sh, n in ((spk1, 800), (spk2, 333)):
        x = utt(sh, n)
        for s in (js, ts):
            s.reset_features()
            s.add_features(x)
        assert ts.feature_count() == n
        for uid in ("alice", "bob"):
            (dj, sj), (dt, st) = js.verify_speaker(uid), ts.verify_speaker(uid)
            assert dj == dt and abs(sj - st) <= 1e-3
            (dj, sj), (dt, st) = (s.verify_speaker(uid, True)
                                  for s in (js, ts))
            assert dj == dt and abs(sj - st) <= 1e-3
        (dj, sj, uj), (dt, st, ut) = js.identify_speaker(), \
            ts.identify_speaker()
        assert (dj, uj) == (dt, ut) and abs(sj - st) <= 1e-3
        (dj, sj, uj), (dt, st, ut) = (s.identify_speaker(True)
                                      for s in (js, ts))
        assert uj == ut and abs(sj - st) <= 1e-3
    for (ua, sa), (ub, sb) in zip(ts.accumulated_scores(),
                                  js.accumulated_scores()):
        assert ua == ub and abs(sa - sb) <= 1e-3
    # adapt, remove, errors
    for s in (js, ts):
        s.adapt_speaker_model("alice")
    b = np.asarray(js.speakers["alice"].means)
    np.testing.assert_allclose(np_of(ts.speakers["alice"].means), b, rtol=0,
                               atol=1e-4 * np.abs(b).max())
    ts.remove_speaker("carol")
    assert ts.speaker_ids() == ["alice", "bob"]
    with pytest.raises(KeyError):
        ts.verify_speaker("carol")
    ts.reset_accumulated_scores()
    assert ts.accumulated_scores() == []
    ts.reset_features()
    with pytest.raises(ValueError, match="feature buffer is empty"):
        ts.verify_speaker("alice")
    ts.reset_speakers()
    with pytest.raises(KeyError):
        ts.identify_speaker()
    assert ck.launch_counts == before


def test_system_normalize_features_and_audio_match_jax(rng):
    """The audio path (MFCC + deltas, 40 columns) and normalize_features
    (energy VAD on the energy column, then CMVN over the kept frames) in
    both packages: the same frames kept, normalised features within
    rtol 2e-3 + atol 2e-3 (the MFCC budget, 2e-4 of the largest cepstrum,
    divided by each column's std, which is small for the deltas)."""
    t = np.arange(12000) / 8000.0
    sig = (0.4 * np.sin(2 * np.pi * 300 * t) * (t % 0.5 < 0.3)
           + 0.01 * rng.standard_normal(12000)).astype(np.float32)
    js, ts = JSystem(), SimpleSpkDetSystem(device="cpu")
    for s in (js, ts):
        s.add_audio(sig)
    assert ts.features.shape == js.features.shape == (149, 40)
    for s in (js, ts):
        s.normalize_features(energy_column=19)
    assert ts.features.shape == js.features.shape
    assert 0 < ts.feature_count() < 149
    np.testing.assert_allclose(ts.features, js.features, rtol=2e-3,
                               atol=2e-3)
    kept = ts.features
    np.testing.assert_allclose(kept.mean(0), 0.0, atol=1e-4)
    ts.reset_features()
    ts.normalize_features()                       # empty buffer: a no-op
    assert ts.feature_count() == 0


def test_system_device_rule(world_and_data, tmp_path):
    """The default device is the card: without one the constructor raises
    and nothing runs on the CPU unasked; models are moved to the system's
    device on load."""
    _, tubm, utt, spk1, _ = world_and_data
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SimpleSpkDetSystem()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SpkDetServer(port=0)
    ts = SimpleSpkDetSystem(device="cpu")
    path = str(tmp_path / "wld.gmm")
    tubm.save(path)
    ts.load_background_model(path)
    assert ts.ubm.device.type == "cpu"
    ts.add_features(utt(spk1, 300))
    ts.create_speaker_model("a")
    ts.save_speaker_model("a", str(tmp_path / "a.gmm"))
    ts.load_speaker_model("b", str(tmp_path / "a.gmm"))
    assert torch.equal(ts.speakers["a"].means, ts.speakers["b"].means)
    feat = str(tmp_path / "f.prm")
    write_feature_file(feat, utt(spk1, 50), fmt="SPRO4")
    ts.add_feature_file(feat)
    assert ts.feature_count() == 350


# -- the port's server and client over a real socket -----------------------------------

@pytest.fixture
def served(world_and_data, tmp_path):
    _, tubm, utt, spk1, spk2 = world_and_data
    wpath = str(tmp_path / "wld.gmm")
    tubm.save(wpath)
    srv = SpkDetServer(port=0, device="cpu")
    port = srv.start()
    cli = RemoteSpkDetClient(port=port)
    yield srv, cli, wpath
    cli.close()
    srv.stop()


def test_tcp_server_client_round_trip(served, world_and_data, tmp_path):
    """Every command of the wire protocol against a live server on an
    ephemeral port; the LLRs that come back are the in-process system's
    within 1e-5 (the wire carries f32; a CPU product may split its sums
    differently from call to call and between a 1-client and a 2-client
    batch)."""
    srv, cli, wpath = served
    _, tubm, utt, spk1, spk2 = world_and_data
    assert "I_IDCUMGETLIST" in cli.list_commands()
    cli.load_world(wpath)
    local = SimpleSpkDetSystem(device="cpu")
    local.set_background_model(tubm)
    for uid, sh in (("alice", spk1), ("bob", spk2)):
        x = utt(sh)
        cli.reset_features()
        cli.send_features(x)
        cli.train_speaker(uid)
        local.reset_features()
        local.add_features(x)
        local.create_speaker_model(uid)
    assert "speakers=alice,bob" in cli.status()
    x = utt(spk1, 640)
    cli.reset_features()
    cli.send_features(x[:300])
    cli.send_features(x[300:])
    local.reset_features()
    local.add_features(x)
    assert "features=640" in cli.status()
    ok, score = cli.verify("alice")
    l_ok, l_score = local.verify_speaker("alice")
    assert ok == l_ok and abs(score - l_score) <= 1e-5 and ok
    ok_b, score_b = cli.verify("bob")
    assert not ok_b and score_b < score
    dec, s, uid = cli.identify()
    assert uid == "alice" and abs(s - score) <= 1e-5
    # cumulative scoring and its list
    cli.verify("alice", cumulative=True)
    cli.identify(cumulative=True)
    res = cli.cumulated_results()
    assert [u for u, _ in res] == ["alice", "bob"]
    cli.reset_accumulated_scores()
    assert cli.cumulated_results() == []
    # adapt, save, load, delete
    cli.adapt_speaker("alice")
    local.adapt_speaker_model("alice")
    mpath = str(tmp_path / "alice.gmm")
    cli.save_speaker("alice", mpath)
    np.testing.assert_array_equal(read_gmm_file(mpath)[1],
                                  np_of(local.speakers["alice"].means)
                                  .astype(np.float64))
    cli.load_speaker("alice2", mpath)
    cli.delete_speaker("bob")
    assert "speakers=alice,alice2" in cli.status()
    fpath = str(tmp_path / "f.prm")
    cli.save_features(fpath)
    np.testing.assert_array_equal(read_feature_file(fpath).data, x)
    cli.reset_features()
    cli.load_feature_file(fpath)
    assert "features=640" in cli.status()
    cli.send_option("decisionThreshold", "100.0")
    cli.reset_speakers()
    assert "speakers=" in cli.status()
    # G_RESET builds a new worker on the same device, with the new option
    cli.reset()
    assert srv.worker.device.type == "cpu"
    assert srv.worker.threshold == 100.0
    assert "features=0" in cli.status()


def test_tcp_errors_keep_the_server_alive(served):
    srv, cli, wpath = served
    with pytest.raises(RuntimeError, match="server error"):
        cli.verify("nobody")                 # no such model
    with pytest.raises(RuntimeError, match="server error"):
        cli.load_world("/nonexistent/file.gmm")
    tserver.send_command(cli.sock, 99)       # unknown command code
    with pytest.raises(RuntimeError, match="server error"):
        cli._status()
    cli.load_world(wpath)
    assert "features=0" in cli.status()
    # a second connection shares the one worker
    other = RemoteSpkDetClient(port=srv.port)
    other.send_features(np.zeros((5, DIM), np.float32))
    assert "features=5" in cli.status()
    other.close()


def test_tcp_audio_commands(served, tmp_path, rng):
    """A_SEND in several packets, A_SAVE, A_RESET, A_LOAD: the server's
    features equal the in-process system's on the same 16-bit PCM."""
    srv, cli, _ = served
    sig = (0.3 * np.sin(2 * np.pi * 500 * np.arange(8000) / 8000.0)
           + 0.01 * rng.standard_normal(8000)).astype(np.float32)
    cli.send_audio(sig, chunk_frames=3000)
    pcm = (np.clip(sig, -1, 1) * 32767.0).astype("<i2")
    local = SimpleSpkDetSystem(device="cpu")
    local.add_audio(pcm.astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(srv.worker.features, local.features)
    assert srv.worker.features.shape == (99, 40)
    apath = str(tmp_path / "a.pcm")
    cli.send_audio(sig[:4000])
    cli.reset_audio()
    cli.save_audio(apath)
    assert os.path.getsize(apath) == 0
    with open(apath, "wb") as f:
        f.write(pcm.tobytes())
    cli.reset_features()
    cli.load_audio_file(apath)
    np.testing.assert_array_equal(srv.worker.features, local.features)


def test_wire_format_helpers():
    """read_command / send_command frame a command as [cmd][size BE]
    [payload], the same bytes as the JAX package's server module."""
    import socket

    from lia_ral_tpu.api import server as jserver

    a, b = socket.socketpair()
    try:
        tserver.send_command(a, tserver.F_SEND, b"abc")
        assert jserver.read_command(b) == (jserver.F_SEND, b"abc")
        jserver.send_command(b, jserver.I_DET, b"")
        assert tserver.read_command(a) == (tserver.I_DET, b"")
    finally:
        a.close()
        b.close()
    codes = [n for n in dir(jserver) if n[:2] in ("G_", "A_", "F_", "M_",
                                                  "I_") or n[:4] == "RSD_"]
    assert len(codes) >= 30
    for n in codes:
        assert getattr(tserver, n) == getattr(jserver, n), n
    assert struct.pack("!I", 3) == b"\x00\x00\x00\x03"
