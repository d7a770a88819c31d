"""The port's file IO against the JAX package's: each format written by
one package and read by the other, both ways — features, labels, lists,
configs, matrices, NIST scores, GMMs (RAW bit-exact), Baum-Welch stats
and the T matrix — plus the port's streaming EM against the JAX one.

Tolerances: every round trip is exact (the formats store f32 or f64 and
both packages write the same bytes); XML mixtures keep 19 significant
digits, so they round-trip to the f64 of the value.  Streaming EM: the
in-RAM EM budget of tests/test_torch_gmm.py (rtol 1e-4, atol 1e-5).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lia_ral_tpu import config as jconfig
from lia_ral_tpu.fa import stats as jstats
from lia_ral_tpu.fa import tv as jtv
from lia_ral_tpu.gmm import em as jem
from lia_ral_tpu.gmm.model import GmmDiag as JGmm
from lia_ral_tpu.io import features as jfeat
from lia_ral_tpu.io import gmm_io as jgmm_io
from lia_ral_tpu.io import labels as jlabels
from lia_ral_tpu.io import lists as jlists
from lia_ral_tpu.io import matrix as jmatrix
from lia_ral_tpu.io import nist as jnist
from lia_ral_tpu.tools import common as jcommon

from lia_ral_tpu_torch import config as tconfig
from lia_ral_tpu_torch.fa import stats as tstats
from lia_ral_tpu_torch.fa import tv as ttv
from lia_ral_tpu_torch.gmm import em as tem
from lia_ral_tpu_torch.gmm.model import GmmDiag as TGmm
from lia_ral_tpu_torch.io import features as tfeat
from lia_ral_tpu_torch.io import gmm_io as tgmm_io
from lia_ral_tpu_torch.io import labels as tlabels
from lia_ral_tpu_torch.io import lists as tlists
from lia_ral_tpu_torch.io import matrix as tmatrix
from lia_ral_tpu_torch.io import nist as tnist
from lia_ral_tpu_torch.tools import common as tcommon

from _torch_parity import np_of, random_gmm_np

PAIRS = [("torch", "jax"), ("jax", "torch")]


@pytest.mark.parametrize("fmt,big_endian", [("SPRO4", False),
                                            ("SPRO4", True),
                                            ("SPRO3", False), ("RAW", False),
                                            ("HTK", False)])
@pytest.mark.parametrize("writer,reader", PAIRS)
def test_features_round_trip(rng, tmp_path, fmt, big_endian, writer, reader):
    x = rng.standard_normal((37, 6)).astype(np.float32)
    path = str(tmp_path / "f.prm")
    mods = {"torch": tfeat, "jax": jfeat}
    mods[writer].write_feature_file(path, x, fmt=fmt, big_endian=big_endian)
    kw = dict(fmt=fmt, big_endian=big_endian, vect_size=6)
    got = mods[reader].read_feature_file(path, **kw)
    np.testing.assert_array_equal(got.data, x)
    if reader == "torch":
        want = jfeat.read_feature_file(path, use_native=False, **kw)
        assert (got.rate, got.kind, got.flag) == (want.rate, want.kind,
                                                  want.flag)


def test_feature_server_mask_and_config(rng, tmp_path):
    xs = [rng.standard_normal((n, 5)).astype(np.float32) for n in (9, 14)]
    for i, x in enumerate(xs):
        tfeat.write_feature_file(str(tmp_path / f"u{i}.prm"), x)
    base = {"featureFilesPath": str(tmp_path) + "/",
            "featureServerMask": "0-1,3"}
    fs_t = tfeat.server_from_config(["u0", "u1"], tconfig.Config(base))
    fs_j = jfeat.server_from_config(["u0", "u1"], jconfig.Config(base))
    np.testing.assert_array_equal(fs_t.data, fs_j.data)
    np.testing.assert_array_equal(fs_t.data[9:], xs[1][:, [0, 1, 3]])
    assert fs_t.source_range(1) == fs_j.source_range(1) == (9, 23)
    assert tfeat.parse_mask("0-2,5") == jfeat.parse_mask("0-2,5")


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_labels_lists_scores_round_trip(tmp_path, writer, reader):
    m = {"torch": (tlabels, tlists, tnist), "jax": (jlabels, jlists, jnist)}
    lab_w, lst_w, nist_w = m[writer]
    lab_r, lst_r, nist_r = m[reader]
    segs = [lab_w.Segment(0.0, 0.25, "speech"), lab_w.Segment(0.4, 0.61,
                                                              "speech"),
            lab_w.Segment(0.3, 0.35, "noise")]
    lab_w.write_label_file(str(tmp_path / "a.lbl"), segs)
    back = lab_r.read_label_file(str(tmp_path / "a.lbl"))
    assert [(s.begin, s.end, s.label) for s in back] == [
        (s.begin, s.end, s.label) for s in segs]
    store = lab_r.SegmentStore.from_label_file(str(tmp_path / "a.lbl"), 80)
    want = jlabels.SegmentStore.from_label_file(str(tmp_path / "a.lbl"), 80)
    np.testing.assert_array_equal(store.mask("speech", 80),
                                  want.mask("speech", 80))
    assert store.total_frames("speech", 80) == 26 + 22
    mask = store.mask("speech", 80)
    assert [(s.begin, s.end) for s in lab_r.frame_mask_to_segments(mask)] \
        == [(s.begin, s.end)
            for s in jlabels.frame_mask_to_segments(mask)]
    lst_w.write_xlist(str(tmp_path / "l.ndx"), [["t1", "m1", "m2"], ["t2"]])
    assert lst_r.read_ndx(str(tmp_path / "l.ndx")) == [("t1", ["m1", "m2"]),
                                                       ("t2", [])]
    assert lst_r.read_simple_list(str(tmp_path / "l.ndx")) == [
        "t1", "m1", "m2", "t2"]
    lines = [nist_w.ScoreLine("M", "m1", "1", "t1", 0.25),
             nist_w.ScoreLine("F", "m2", "0", "t1", -1.5e-3, 0.5, 2.0)]
    nist_w.write_nist_scores(str(tmp_path / "s.nist"), lines)
    back = nist_r.read_nist_scores(str(tmp_path / "s.nist"))
    assert [(b.model, b.seg, b.score, b.begin) for b in back] == [
        ("m1", "t1", 0.25, None), ("m2", "t1", -1.5e-3, 0.5)]


def test_config_matches_jax(tmp_path):
    path = str(tmp_path / "tw.cfg")
    with open(path, "w") as f:
        f.write("*** comment\nmixtureDistribCount 16\nverbose true\n"
                "frameLength 0.01\nfeatureFilesPath ./feat/\n")
    argv = ["--config", path, "--mixtureDistribCount", "32", "--debug"]
    got = tconfig.Config.from_cli(argv)
    want = jconfig.Config.from_cli(argv)
    assert dict(got.items()) == dict(want.items())
    assert got.get_int("mixtureDistribCount") == 32
    assert got.get_bool("verbose") and got.get_bool("debug")
    assert got.get_float("frameLength") == 0.01
    with pytest.raises(tconfig.ConfigError):
        got.get_str("missing")
    got.save(str(tmp_path / "back.cfg"))
    assert dict(jconfig.Config.load(str(tmp_path / "back.cfg")).items()) \
        == dict(got.items())


@pytest.mark.parametrize("fmt", ["DB", "DT"])
@pytest.mark.parametrize("writer,reader", PAIRS)
def test_matrix_round_trip(rng, tmp_path, fmt, writer, reader):
    mods = {"torch": tmatrix, "jax": jmatrix}
    mat = rng.standard_normal((4, 7))
    path = str(tmp_path / "m.matx")
    mods[writer].write_matrix_file(path, mat, fmt)
    np.testing.assert_array_equal(mods[reader].read_matrix_file(path), mat)


@pytest.mark.parametrize("fmt", ["RAW", "XML"])
@pytest.mark.parametrize("writer,reader", PAIRS)
def test_gmm_round_trip(rng, tmp_path, fmt, writer, reader):
    """RAW must be bit-exact both ways (f32 → f64 on disk → f32)."""
    w, m, ci = random_gmm_np(rng, 8, 5)
    path = str(tmp_path / "wld.gmm")
    if writer == "torch":
        TGmm.create(w, m, ci).save(path, fmt=fmt, model_id="wld")
    else:
        JGmm.create(w, m, ci).save(path, fmt=fmt, model_id="wld")
    g = (TGmm.load(path) if reader == "torch" else JGmm.load(path))
    for got, want in zip((g.weights, g.means, g.cov_inv), (w, m, ci)):
        got = np_of(got)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    raw_t = tgmm_io.read_gmm_file(path)
    raw_j = jgmm_io.read_gmm_file(path)
    for a, b in zip(raw_t, raw_j):
        np.testing.assert_array_equal(a, b)


def test_gmm_files_are_byte_identical(rng, tmp_path):
    w, m, ci = random_gmm_np(rng, 8, 5)
    for fmt in ("RAW", "XML"):
        TGmm.create(w, m, ci).save(str(tmp_path / "t.gmm"), fmt=fmt)
        JGmm.create(w, m, ci).save(str(tmp_path / "j.gmm"), fmt=fmt)
        assert ((tmp_path / "t.gmm").read_bytes()
                == (tmp_path / "j.gmm").read_bytes())


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_stats_and_tv_round_trip(rng, tmp_path, writer, reader):
    n = (rng.random((3, 8)) * 10).astype(np.float32)
    f = rng.standard_normal((3, 8, 5)).astype(np.float32)
    names = ["a", "b", "c"]
    stats = {"torch": tstats.BwStats(torch.from_numpy(n), torch.from_numpy(f)),
             "jax": jstats.BwStats(jnp.asarray(n), jnp.asarray(f))}
    mods = {"torch": tstats, "jax": jstats}
    npz = str(tmp_path / "acc.npz")
    mods[writer].save_stats(npz, stats[writer], names)
    back, back_names = mods[reader].load_stats(npz)
    assert back_names == names
    np.testing.assert_array_equal(np_of(back.n), n)
    np.testing.assert_array_equal(np_of(back.f), f)
    prefix = str(tmp_path / "acc")
    mods[writer].save_stats_matx(prefix, stats[writer])
    back = mods[reader].load_stats_matx(prefix, 5)
    np.testing.assert_array_equal(np_of(back.n), n)
    np.testing.assert_array_equal(np_of(back.f), f)
    # the T matrix: (R, K·D) .matx
    w, m, ci = random_gmm_np(rng, 8, 5)
    t = rng.standard_normal((4, 8, 5)).astype(np.float32)
    gmms = {"torch": TGmm.create(w, m, ci), "jax": JGmm.create(w, m, ci)}
    tvs = {"torch": ttv.TvModel.from_ubm(torch.from_numpy(t),
                                         gmms["torch"]),
           "jax": jtv.TvModel.from_ubm(t, gmms["jax"])}
    path = str(tmp_path / "TV.matx")
    tvs[writer].save(path)
    cls = ttv.TvModel if reader == "torch" else jtv.TvModel
    back = cls.load(path, gmms[reader])
    np.testing.assert_array_equal(np_of(back.t), t)
    np.testing.assert_array_equal(np_of(back.ubm_means), m)


def test_train_model_streaming_matches_jax(rng, tmp_path):
    """featureServerBufferSize EM from one numpy init: the JAX and port
    streaming trainers over the same files, and the port's streaming
    result against its in-RAM trainer (bagging off, so no random draw)."""
    k, d = 6, 4
    centers = rng.standard_normal((k, d)) * 3.0
    names = []
    for i, n in enumerate((170, 95, 230)):
        x = (centers[rng.integers(0, k, n)]
             + rng.standard_normal((n, d))).astype(np.float32)
        tfeat.write_feature_file(str(tmp_path / f"s{i}.prm"), x)
        names.append(f"s{i}")
    base = {"featureFilesPath": str(tmp_path) + "/",
            "labelFilesPath": str(tmp_path) + "/",
            "addDefaultLabel": "true"}
    init = random_gmm_np(rng, k, d)
    kw = dict(nb_train_it=3, init_variance_flooring=0.1,
              final_variance_flooring=0.05)
    t_loader = tcommon.feature_chunk_loader(names, tconfig.Config(base), 128)
    j_loader = jcommon.feature_chunk_loader(names, jconfig.Config(base), 128)
    gt = tem.train_model_streaming(torch.Generator().manual_seed(0),
                                   t_loader, TGmm.create(*init),
                                   tem.TrainCfg(**kw), chunk=64)
    gj = jem.train_model_streaming(jax.random.key(0), j_loader,
                                   JGmm.create(*init), jem.TrainCfg(**kw),
                                   chunk=64)
    for f in ("weights", "means", "cov_inv"):
        np.testing.assert_allclose(np_of(getattr(gt, f)),
                                   np_of(getattr(gj, f)), rtol=1e-4,
                                   atol=1e-5)
    mt, ct = tem.streaming_global_mean_cov(t_loader)
    mj, cj = jem.streaming_global_mean_cov(j_loader)
    np.testing.assert_allclose(np_of(mt), np_of(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_of(ct), np_of(cj), rtol=1e-5, atol=1e-6)
    fs, mask = tcommon.load_features_and_mask(names, tconfig.Config(base))
    g_ram = tem.train_model(torch.Generator().manual_seed(0),
                            torch.from_numpy(fs.data),
                            torch.from_numpy(mask), TGmm.create(*init),
                            tem.TrainCfg(**kw), chunk=64)
    for f in ("weights", "means", "cov_inv"):
        np.testing.assert_allclose(np_of(getattr(gt, f)),
                                   np_of(getattr(g_ram, f)), rtol=1e-4,
                                   atol=1e-5)
