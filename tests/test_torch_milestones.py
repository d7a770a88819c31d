"""The port's record drivers (scripts/torch_milestone_*.py) against the JAX
package's (scripts/milestone_*.py) on the CPU.

Generators: each torch driver's corpus is the JAX driver's, array for
array, from the same seed (the JAX scripts are imported as modules here
only).  Runs: the eer, jfa, plda and diar drivers at cut scales (the
eer corpus as tests/test_torch_oracle.py cuts it: K=16, D=6, R=8, a few
speakers) with ``device="cpu"`` against the JAX driver's ``main``, whose
cut scale goes into its ``SCALES`` (or module constants) through
monkeypatch; the JAX files are not edited.  The torch drivers draw their
random inits with numpy (torch_milestone_eer.init_gmm / normal_init); the
JAX side is patched to start from the same ones (tests/_torch_milestone_
parity.py): TrainWorld from the torch run's init file, TotalVariability's
T, PLDA's F and G and JFA's V and U from ``normal_init`` with the
``randomSeed`` of the tool's key, F and G carried into the JAX package's
EFR basis (LAPACK signs the ``eigh`` vectors differently in the two
packages; EM and scoring are equivariant under the orthogonal map).

Tolerances: per-trial scores within 1e-3·max|·| of the JAX driver's;
EERs equal, or one quantum apart where a target and an impostor score lie
within twice that tolerance of each other (a tie the tolerance can flip);
the diarization label files equal segment for segment.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from lia_ral_tpu.tools import iv_test as j_iv_test

from lia_ral_tpu_torch.gmm.cuda_kernels import launch_counts
from lia_ral_tpu_torch.io.features import read_feature_file
from lia_ral_tpu_torch.io.labels import read_label_file
from lia_ral_tpu_torch.io.matrix import read_matrix_file
from lia_ral_tpu_torch.io.nist import read_nist_scores

import _torch_milestone_parity as mp  # noqa: E402  (puts scripts/ on the path)
import milestone_audio as jaudio  # noqa: E402
import milestone_diar as jdiar  # noqa: E402
import milestone_eer as jeer  # noqa: E402
import milestone_jfa as jjfa  # noqa: E402
import milestone_plda as jplda  # noqa: E402
import torch_milestone_adapt as tadapt  # noqa: E402
import torch_milestone_audio as taudio  # noqa: E402
import torch_milestone_diar as tdiar  # noqa: E402
import torch_milestone_eer as teer  # noqa: E402
import torch_milestone_jfa as tjfa  # noqa: E402
import torch_milestone_plda as tplda  # noqa: E402

SCORE_TOL = 1e-3

# the cut scales
EER_TINY = dict(teer.SCALES["small"], k=16, d=6, r=8, plda=4, n_spk=4,
                n_imp=2, n_dev=8, sess=3, t_utt=200, t_test=100, n_test=3,
                bg=4000, ubm_it=2, tv_it=2)
JFA_TINY = dict(tjfa.SCALES["small"], k=16, d=6, rv=4, ru=2, n_dev=8,
                n_spk=4, n_imp=2, sess=3, t_utt=200, it_v=2, it_u=2, it_d=2)
PLDA_TINY = dict(tplda.P, r=16, plda=4, n_dev=20, dev_sess=3, n_spk=6,
                 tests_per_spk=2)
ADAPT_TINY = dict(tadapt.P, k=16, d=6, n_spk=4, n_imp=2, t_utt=300,
                  t_test=200, n_test=4, bg=4000)
DIAR_MINUTES = 0.6


class _Stop(Exception):
    """Ends a JAX driver's main where a test has what it needs."""


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def jax_inits(monkeypatch):
    """The JAX tools' random inits patched to the torch drivers' draws;
    a test sets ``["q"]`` to its run's EFR basis change."""
    basis = {}
    mp.patch_jax_inits(monkeypatch.setattr,
                       lambda: basis["q"]() if "q" in basis else None)
    return basis


def _compare_score_files(tdir, jdir, name, is_target):
    """Per-trial scores of ``name`` within SCORE_TOL·max|·| of the JAX
    run's, and the EERs equal or one quantum apart at a near-tie."""
    dv = mp.score_deviation(tdir, jdir, name, is_target)
    assert dv["same_trials"] and dv["finite"], (name, dv)
    tol = SCORE_TOL * dv["scale"]
    print(f"{name}: max|port-JAX| {dv['max_dev']:.3e} of {dv['scale']:.3e}; "
          f"EER port {100 * dv['eer_port']:.3f} %, JAX "
          f"{100 * dv['eer_jax']:.3f} %")
    assert dv["max_dev"] <= tol, (name, dv)
    if dv["eer_port"] != dv["eer_jax"]:
        quantum = max(1.0 / dv["n_target"], 1.0 / dv["n_impostor"])
        assert abs(dv["eer_port"] - dv["eer_jax"]) <= quantum + 1e-12, dv
        assert dv["gap"] <= 2 * tol, (name, dv)


def _same_features(tdir, jdir, names):
    for nm in names:
        a = read_feature_file(os.path.join(tdir, nm), fmt="SPRO4").data
        b = read_feature_file(os.path.join(jdir, nm), fmt="SPRO4").data
        np.testing.assert_array_equal(a, b, err_msg=nm)


# -- generators ----------------------------------------------------------------

@pytest.mark.parametrize("with_dev,p", [(True, EER_TINY),
                                        (False, ADAPT_TINY)],
                         ids=["eer", "adapt"])
def test_eer_corpus_equals_jax(tmp_path, with_dev, p):
    t, j = tmp_path / "t", tmp_path / "j"
    t.mkdir(), j.mkdir()
    names = teer.gen_corpus(str(t), p, np.random.default_rng(20260820),
                            with_dev)
    assert names == jeer.gen_corpus(str(j), p,
                                    np.random.default_rng(20260820), with_dev)
    files = sorted(os.listdir(j))
    assert files == sorted(os.listdir(t)) and len(files) > 10
    _same_features(str(t), str(j), files)


def test_jfa_corpus_equals_jax(tmp_path):
    t, j = tmp_path / "t", tmp_path / "j"
    t.mkdir(), j.mkdir()
    ubm_t, names = tjfa.gen_corpus(str(t), JFA_TINY,
                                   np.random.default_rng(20260821))
    ubm_j, names_j = jjfa.gen_corpus(str(j), JFA_TINY,
                                     np.random.default_rng(20260821))
    assert names == names_j
    for f in ("weights", "means", "cov_inv"):
        np.testing.assert_array_equal(getattr(ubm_t, f).numpy(),
                                      np.asarray(getattr(ubm_j, f)))
    files = sorted(os.listdir(j))
    assert files == sorted(os.listdir(t))
    _same_features(str(t), str(j), files)


def test_diar_conversation_equals_jax():
    got = tdiar.gen_conversation(np.random.default_rng(20260823))
    want = jdiar.gen_conversation(np.random.default_rng(20260823))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k])
    assert got[0].shape == (30573, tdiar.D_FEAT)


def test_audio_voices_equal_jax(monkeypatch):
    """The JAX driver's first utterance (speakers, tilt, samples) is the
    torch generator's: its ``voice`` is recorded and the run stopped."""
    seen, original = [], jaudio.voice

    def voice(rng, phonemes, tilt, seconds):
        seen.append((phonemes, tilt, seconds,
                     original(rng, phonemes, tilt, seconds)))
        raise _Stop

    monkeypatch.setattr(jaudio, "voice", voice)
    with pytest.raises(_Stop):
        mp.run_jax_main(jaudio)
    rng = np.random.default_rng(20260822)
    speakers = taudio.gen_speakers(rng)
    tilt = rng.uniform(-1.0, 1.0)
    phonemes, j_tilt, seconds, j_sig = seen[0]
    assert phonemes == speakers[0] and tilt == j_tilt and seconds == 4.0
    np.testing.assert_array_equal(
        taudio.voice(rng, speakers[0], tilt, seconds), j_sig)
    for s in (3, 14):       # more draws: other speakers, other lengths
        r1, r2 = np.random.default_rng(s), np.random.default_rng(s)
        np.testing.assert_array_equal(
            taudio.voice(r1, speakers[s], 0.3, 1.0 + s / 10),
            original(r2, speakers[s], 0.3, 1.0 + s / 10))


# -- runs against the JAX drivers ----------------------------------------------

def test_eer_driver_matches_jax(tmp_path, monkeypatch, jax_inits):
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    before = dict(launch_counts)
    rec = teer.run(tdir, EER_TINY, device="cpu", scale="tiny")
    assert launch_counts == before          # CPU tensors: plain versions
    assert rec["device"] == "cpu" and rec["launches"] == {}
    assert rec["shapes"]["dev_trial_shared_files"] == 0
    os.makedirs(jdir)
    shutil.copy(os.path.join(tdir, "wld_init.gmm"), jdir)
    mp.patch_jax_train_world(monkeypatch.setattr, lambda out: "wld_init")
    jax_inits["q"] = mp.dev_basis(jdir, ".y")
    monkeypatch.setitem(jeer.SCALES, "tiny", EER_TINY)
    mp.run_jax_main(jeer, "--scale", "tiny", "--workdir", jdir,
                    "--out", str(tmp_path / "jax.jsonl"))
    for name in mp.EER_SCORE_FILES:
        _compare_score_files(tdir, jdir, name, mp.eer_target)


def test_jfa_driver_matches_jax(tmp_path, monkeypatch, jax_inits):
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    rec = tjfa.run(tdir, JFA_TINY, device="cpu", scale="tiny")
    assert rec["launches"] == {}
    monkeypatch.setitem(jjfa.SCALES, "tiny", JFA_TINY)
    mp.run_jax_main(jjfa, "--scale", "tiny", "--workdir", jdir)
    for name in ("EV.matx", "EC.matx"):
        got = read_matrix_file(os.path.join(tdir, name))
        want = read_matrix_file(os.path.join(jdir, name))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-3 * np.abs(want).max())
    _compare_score_files(tdir, jdir, "scores_jfa.nist", mp.eer_target)


def test_plda_driver_serial_sharded_and_jax(tmp_path, monkeypatch,
                                            jax_inits):
    """The port's serial and 8-shard runs agree (the driver asserts 1e-3
    of scale) and its serial scores equal the JAX driver's serial ones;
    the JAX sharded side (its 8 virtual devices) is stopped before it
    runs, and the JAX vectors equal the torch generator's."""
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    rec = tplda.run(str(tdir), PLDA_TINY, device="cpu")
    assert rec["results"]["sharded_vs_serial_rel"] < tplda.SHARD_TOL
    assert rec["device"] == f"cpu x{tplda.SHARDS} shards"
    ser, shd = ({(ln.model, ln.seg): ln.score for ln in
                 read_nist_scores(str(tdir / f"scores_{tag}.nist"))}
                for tag in ("serial", "sharded"))
    assert sorted(ser) == sorted(shd)
    assert len(ser) == rec["shapes"]["n_trials"]
    scale = max(abs(v) for v in ser.values())
    assert max(abs(ser[k] - shd[k]) for k in ser) <= tplda.SHARD_TOL * scale

    original = j_iv_test.main

    def iv_main(cfg):
        if cfg.get_int("numThread", 1) > 1:
            raise _Stop
        return original(cfg)

    jdir.mkdir()
    jax_inits["q"] = mp.dev_basis(str(jdir), ".vect")
    monkeypatch.setattr(j_iv_test, "main", iv_main)
    monkeypatch.setattr(jplda.tempfile, "mkdtemp",
                        lambda prefix="": str(jdir))
    for k, v in PLDA_TINY.items():
        monkeypatch.setitem(jplda.P, k, v)
    with pytest.raises(_Stop):
        mp.run_jax_main(jplda)
    vects = sorted(f for f in os.listdir(jdir) if f.endswith(".vect"))
    assert vects == sorted(f for f in os.listdir(tdir)
                           if f.endswith(".vect"))
    for f in vects:
        np.testing.assert_array_equal(read_matrix_file(str(tdir / f)),
                                      read_matrix_file(str(jdir / f)))
    for f in ("dev.ndx", "targets.ndx", "trials.ndx"):
        assert (tdir / f).read_text() == (jdir / f).read_text(), f

    def target(model, seg):
        return model == f"model{seg[3:].split('_')[0]}"

    _compare_score_files(str(tdir), str(jdir), "scores_serial.nist", target)


def test_diar_driver_matches_jax(tmp_path, monkeypatch):
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    monkeypatch.setattr(tdiar, "MINUTES", DIAR_MINUTES)
    monkeypatch.setattr(jdiar, "MINUTES", DIAR_MINUTES)
    rec = tdiar.run(str(tdir), device="cpu")
    res = rec["results"]
    jdir.mkdir()
    for f in tdir.glob("init_*.gmm"):
        shutil.copy(f, jdir)
    mp.patch_jax_train_world(monkeypatch.setattr, lambda out: f"init_{out}")
    monkeypatch.setattr(jdiar.tempfile, "mkdtemp",
                        lambda prefix="": str(jdir))
    out = tmp_path / "jax.jsonl"
    mp.run_jax_main(jdiar, "--out", str(out))
    want = json.loads(out.read_text())["results"]
    for name in ("conv.sad.lbl", "convsp.turn.lbl", "convsp.seg.lbl",
                 "convsp.reseg.lbl", "convsp.turnclust.lbl",
                 "convsp.turnreseg.lbl"):
        got = [(s.begin, s.end, s.label)
               for s in read_label_file(str(tdir / name))]
        assert got == [(s.begin, s.end, s.label)
                       for s in read_label_file(str(jdir / name))], name
        assert got, name
    for k in ("der_segmentation", "der_resegmentation",
              "der_turn_resegmentation", "sad_frame_err",
              "turn_recall_250ms", "turn_precision_250ms"):
        assert round(res[k], 5) == want[k], k
    assert res["n_hyp_speakers_seg"] == want["n_hyp_speakers_seg"]


@pytest.mark.parametrize("driver", [teer, tjfa, tplda, tadapt, taudio, tdiar],
                         ids=lambda m: m.__name__)
def test_driver_defaults_to_the_card_and_raises_without_one(
        driver, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [driver.__name__, "--out",
                                      str(tmp_path / "out.jsonl")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        driver.main()
    assert not (tmp_path / "out.jsonl").exists()
    assert list(tmp_path.iterdir()) == []
