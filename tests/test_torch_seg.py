"""The diarization stack of the PyTorch port against the JAX package's:
``seg/hmm`` (Viterbi, emissions), ``seg/clustering`` (every criterion),
``seg/diarization`` (GLR curve, turn detection, E-HMM segmentation,
resegmentation, acoustic segmentation), ``gmm.em.mixture_init_by_split``,
``backend.eval.der`` and the four LIA_SpkSeg tools through both CLIs.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are stated per test.  Viterbi is compared EXACTLY on shared
emissions (f32 adds and maxima only).  The two packages' emissions differ
by f32 rounding, so whole pipelines are compared on well-separated
corpora by frame agreement after the optimal label mapping and by DER
against the truth.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lia_ral_tpu.backend.eval import der as jder
from lia_ral_tpu.config import Config as JConfig
from lia_ral_tpu.gmm import em as jem
from lia_ral_tpu.gmm.model import GmmDiag as JGmm
from lia_ral_tpu.seg import clustering as jcl
from lia_ral_tpu.seg import diarization as jdz
from lia_ral_tpu.seg import hmm as jhmm
from lia_ral_tpu.tools import spkseg_tools as j_spkseg

from lia_ral_tpu_torch import __main__ as tmain
from lia_ral_tpu_torch import convert
from lia_ral_tpu_torch.backend.eval import der as tder
from lia_ral_tpu_torch.gmm import cuda_kernels as ck
from lia_ral_tpu_torch.gmm import em as tem
from lia_ral_tpu_torch.gmm.scoring import stack_gmms
from lia_ral_tpu_torch.io.features import write_feature_file
from lia_ral_tpu_torch.io.labels import (Segment, read_label_file,
                                         write_label_file)
from lia_ral_tpu_torch.seg import clustering as tcl
from lia_ral_tpu_torch.seg import diarization as tdz
from lia_ral_tpu_torch.seg import hmm as thmm

from _torch_parity import both_gmms, np_of, random_gmm_np

CPU = torch.device("cpu")


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _gauss_np(mean, var=0.3, d=4):
    return (np.ones(1, np.float32), np.full((1, d), mean, np.float32),
            np.full((1, d), 1.0 / var, np.float32))


def _pair(triple):
    return JGmm.create(*triple), convert.gmm_from_numpy(*triple)


def _turns(rng, n_turns=6, turn_len=200, d=4, sep=3.0, n_spk=2):
    xs, truth = [], []
    means = np.linspace(sep, -sep, n_spk)
    for i in range(n_turns):
        spk = i % n_spk
        xs.append(means[spk] + rng.standard_normal((turn_len, d)) * 0.5)
        truth.extend([spk] * turn_len)
    return np.concatenate(xs).astype(np.float32), np.asarray(truth)


def _mapped_agreement(a, b) -> float:
    """Share of frames on which two labelings agree after the optimal
    one-to-one label mapping (1 − DER of one against the other)."""
    return 1.0 - tder(np.asarray(a), np.asarray(b))


def _labels_of(segs, n, frame=0.01):
    out = np.full(n, -1, np.int64)
    names = {}
    for s in segs:
        b, e = int(round(s.begin / frame)), min(int(round(s.end / frame)), n)
        out[b:e] = names.setdefault(s.label, len(names))
    return out


# -- Viterbi ----------------------------------------------------------------

@pytest.mark.parametrize("n,s", [(1, 1), (1, 4), (2, 3), (400, 5), (257, 2),
                                 (300, 1), (150, 32)])
def test_viterbi_reference_equals_jax_exactly(rng, n, s):
    """The same emissions and transitions through both packages: equal
    paths, state for state."""
    em = (rng.standard_normal((n, s)) * 3).astype(np.float32)
    lt = np.log(jhmm.compute_transitions(s) + 1e-30).astype(np.float32)
    want = np.asarray(jhmm._viterbi(jnp.asarray(em), jnp.asarray(lt)))
    got = thmm.viterbi_reference(torch.from_numpy(em), torch.from_numpy(lt))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_viterbi_ties_take_the_first_index(rng):
    """Emissions on a coarse grid and uniform transitions make ties at
    every step (in the best previous state and in the last state); both
    packages break them toward the first index."""
    n, s = 200, 4
    em = rng.integers(0, 2, (n, s)).astype(np.float32)
    em[-1] = 1.0
    lt = np.zeros((s, s), np.float32)
    want = np.asarray(jhmm._viterbi(jnp.asarray(em), jnp.asarray(lt)))
    got = thmm.viterbi_reference(torch.from_numpy(em), torch.from_numpy(lt))
    np.testing.assert_array_equal(got.numpy(), want)
    # all-equal emissions: every argmax is a tie → state 0 throughout
    flat = thmm.viterbi_reference(torch.zeros((50, s)), torch.zeros((s, s)))
    assert torch.all(flat == 0)


def test_viterbi_inactive_states_are_never_entered(rng):
    """The E-HMM's padding: emission −1e30 and transition log 1e-30 keep
    the path inside the active states; equal to the JAX path."""
    n, s, active = 300, 5, 3
    em = (rng.standard_normal((n, s)) * 2).astype(np.float32)
    em[:, active:] = -1e30
    t = np.full((s, s), 1e-30)
    t[:active, :active] = jhmm.compute_transitions(active)
    lt = np.log(t).astype(np.float32)
    got = thmm.viterbi_reference(torch.from_numpy(em), torch.from_numpy(lt))
    assert int(got.max()) < active
    want = np.asarray(jhmm._viterbi(jnp.asarray(em), jnp.asarray(lt)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_viterbi_dispatch_on_cpu_and_cuda_checks(rng):
    """A CPU tensor takes the plain loop and counts no launch; the kernel's
    wrapper refuses CPU tensors, wrong types and more than 32 states."""
    em = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    lt = torch.zeros((3, 3))
    before = dict(thmm.launch_counts)
    got = thmm._viterbi(em, lt)
    assert thmm.launch_counts == before
    assert torch.equal(got, thmm.viterbi_reference(em, lt))
    with pytest.raises(ValueError, match="no kernel"):
        thmm.viterbi_cuda(em, lt)
    thmm.reset_launch_counts()
    assert thmm.launch_counts == {"viterbi": 0}


# -- HMM container and emissions ------------------------------------------------

def test_emission_llk_matches_jax(rng):
    """(N, S) emissions of a stacked 3-state bank: rtol 1e-5, atol 1e-4
    (f32 roundoff of the quadratic expansion, as the GMM tests)."""
    triples = [random_gmm_np(rng, 8, 5) for _ in range(3)]
    jh = jhmm.DiarHmm.from_gmms([JGmm.create(*t) for t in triples],
                                ["a", "b", "c"])
    th = thmm.DiarHmm.from_gmms([convert.gmm_from_numpy(*t) for t in triples],
                                ["a", "b", "c"])
    x = rng.standard_normal((120, 5)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(thmm.emission_llk(torch.from_numpy(x), th)),
        np.asarray(jhmm.emission_llk(jnp.asarray(x), jh)),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np_of(th.log_trans), np.asarray(jh.log_trans),
                               rtol=1e-6, atol=1e-6)
    assert th.n_states == 3


def test_hmm_replace_state_and_convert_round_trip(rng):
    triples = [random_gmm_np(rng, 4, 3) for _ in range(3)]
    th = thmm.DiarHmm.from_gmms([convert.gmm_from_numpy(*t) for t in triples],
                                ["a", "b", "c"])
    new = convert.gmm_from_numpy(*random_gmm_np(rng, 4, 3))
    th2 = th.replace_state(1, new)
    assert torch.equal(th2.gmms.means[1], new.means)
    assert torch.equal(th2.gmms.means[0], th.gmms.means[0])
    assert torch.equal(th.gmms.means[1],
                       torch.from_numpy(triples[1][1]))     # not in place
    jh = jhmm.DiarHmm.from_gmms([JGmm.create(*t) for t in triples],
                                ["a", "b", "c"]).replace_state(
                                    1, JGmm.create(*convert.to_numpy(new)
                                                   .values()))
    np.testing.assert_array_equal(np_of(th2.gmms.means),
                                  np.asarray(jh.gmms.means))
    # the state bank as numpy and back
    d = convert.to_numpy(th2)
    assert d["names"] == ["a", "b", "c"] and d["log_trans"].shape == (3, 3)
    back = convert.hmm_from_numpy(d["weights"], d["means"], d["cov_inv"],
                                  d["names"],
                                  thmm.compute_transitions(3))
    assert torch.equal(back.gmms.cov_inv, th2.gmms.cov_inv)
    np.testing.assert_allclose(np_of(back.log_trans), d["log_trans"],
                               rtol=1e-6)


def test_transitions_and_path_to_segments_match_jax():
    for s in (1, 2, 5):
        np.testing.assert_array_equal(thmm.compute_transitions(s),
                                      jhmm.compute_transitions(s))
    path = np.asarray([0] * 50 + [1] * 3 + [0] * 50 + [1] * 60 + [2] * 4)
    for md in (0, 10):
        got = thmm.path_to_segments(path, ["A", "B", "C"], 0.01, md)
        want = jhmm.path_to_segments(path, ["A", "B", "C"], 0.01, md)
        assert [(s.begin, s.end, s.label) for s in got] == \
            [(s.begin, s.end, s.label) for s in want]
    assert thmm.path_to_segments(np.zeros(0, np.int64), ["A"]) == []


def test_viterbi_decode_matches_jax(rng):
    """Well-separated two-speaker signal: both packages recover the truth
    (> 98 %) and agree on every frame; with a mask, masked frames get
    uniform emissions in both."""
    x, truth = _turns(rng)
    jh = jhmm.DiarHmm.from_gmms([JGmm.create(*_gauss_np(3.0)),
                                 JGmm.create(*_gauss_np(-3.0))], ["A", "B"])
    th = thmm.DiarHmm.from_gmms([convert.gmm_from_numpy(*_gauss_np(3.0)),
                                 convert.gmm_from_numpy(*_gauss_np(-3.0))],
                                ["A", "B"])
    got = thmm.viterbi_decode(torch.from_numpy(x), th)
    want = jhmm.viterbi_decode(jnp.asarray(x), jh)
    assert (got == truth).mean() > 0.98
    np.testing.assert_array_equal(got, want)
    mask = (rng.random(x.shape[0]) > 0.3).astype(np.float32)
    got = thmm.viterbi_decode(torch.from_numpy(x), th,
                              torch.from_numpy(mask))
    want = jhmm.viterbi_decode(jnp.asarray(x), jh, jnp.asarray(mask))
    np.testing.assert_array_equal(got, want)


# -- clustering criteria ----------------------------------------------------------

def _fit_pair(x, w, d):
    """The same 3-step single-Gaussian EM fit in both packages (JAX side),
    handed to the port as numpy."""
    from lia_ral_tpu.gmm.kernels import em_stats
    g = JGmm.uniform_init(1, d)
    for _ in range(3):
        g = jem.m_step(em_stats(jnp.asarray(x), jnp.asarray(w), g))
    return g, convert.gmm_from_numpy(np.asarray(g.weights),
                                     np.asarray(g.means),
                                     np.asarray(g.cov_inv))


def test_clustering_criteria_match_jax(rng):
    """clr, gllr, bic, delta-bic on distinct and on same-speaker halves:
    rel 1e-4 of the criterion (accumulated LLKs of 600 frames in f32), and
    the signs the JAX suite asserts."""
    d = 4
    for sep in (3.0, 0.0):
        x = np.concatenate([rng.standard_normal((300, d)) + sep,
                            rng.standard_normal((300, d)) - sep]
                           ).astype(np.float32)
        w1 = np.r_[np.ones(300), np.zeros(300)].astype(np.float32)
        w2 = 1.0 - w1
        (j1, t1), (j2, t2), (j12, t12) = (
            _fit_pair(x, w, d) for w in (w1, w2, np.ones(600, np.float32)))
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        a1, a2 = jnp.asarray(w1), jnp.asarray(w2)
        b1, b2 = torch.from_numpy(w1), torch.from_numpy(w2)
        pairs = [
            (tcl.gllr_crit(xt, b1, b2, t1, t2, t12),
             jcl.gllr_crit(xj, a1, a2, j1, j2, j12)),
            (tcl.clr_crit(xt, b1, b2, t1, t2, t12),
             jcl.clr_crit(xj, a1, a2, j1, j2, j12)),
            (tcl.bic_crit(xt, b1, b2, t1, t2, t12, lam=0.7),
             jcl.bic_crit(xj, a1, a2, j1, j2, j12, lam=0.7)),
            (tcl.delta_bic_crit(xt, b1, b2, t1, t2, t12),
             jcl.delta_bic_crit(xj, a1, a2, j1, j2, j12)),
        ]
        for got, want in pairs:
            assert isinstance(got, float)
            # atol 0.05: gllr of same-speaker halves is a small difference
            # of accumulated LLKs near 2,000 each
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)
        if sep:
            assert pairs[0][0] < 0 and pairs[1][0] < 0
        assert pairs[3][0] == pairs[0][0]


def test_segment_llk_helpers_match_jax(rng):
    """segment_mean_llk, cohort_max_likelihood, best_fitting_segment (world
    and cohort normalisation), best_fitting_cluster, merge_cluster:
    means rtol 1e-5 / atol 1e-4, indices equal."""
    x = rng.standard_normal((900, 5)).astype(np.float32)
    x[300:600] += 2.0
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    models = [both_gmms(rng, 4, 5) for _ in range(3)]
    jm, tm = [m[0] for m in models], [m[1] for m in models]
    segs = [(0, 300), (300, 600), (600, 900), (100, 150)]
    np.testing.assert_allclose(tcl.segment_mean_llk(xt, segs, tm[0]),
                               jcl.segment_mean_llk(xj, segs, jm[0]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        tcl.cohort_max_likelihood(xt, tm, segs[1], except_ind=0),
        jcl.cohort_max_likelihood(xj, jm, segs[1], except_ind=0),
        rtol=1e-5, atol=1e-4)
    for kw_t, kw_j in (({"world": tm[1]}, {"world": jm[1]}),
                       ({"cohort": tm, "except_ind": 0},
                        {"cohort": jm, "except_ind": 0}), ({}, {})):
        for min_len in (100, 250, 600):
            assert tcl.best_fitting_segment(xt, segs, tm[0], min_len=min_len,
                                            **kw_t) == \
                jcl.best_fitting_segment(xj, segs, jm[0], min_len=min_len,
                                         **kw_j)
    assert tcl.best_fitting_segment(xt, [], tm[0]) is None
    for ex in (None, 1):
        assert tcl.best_fitting_cluster(xt, tm, segs[1], except_ind=ex) == \
            jcl.best_fitting_cluster(xj, jm, segs[1], except_ind=ex)
    assert tcl.merge_cluster([(5, 9)], [(0, 3)]) == \
        jcl.merge_cluster([(5, 9)], [(0, 3)])
    np.testing.assert_allclose(tcl.glr_window_distance(x[:50], x[300:350]),
                               jcl.glr_window_distance(x[:50], x[300:350]),
                               rtol=1e-12)


@pytest.mark.parametrize("crit", ["GLR", "BIC", "CLR", "DELTABIC"])
def test_clustering_criterion_by_adapt_matches_jax(rng, crit):
    """MAP-adapted segment models (bagged probability 1: no draw in
    either package): the criterion within rel 1e-4 (atol 0.05 on
    accumulated LLKs of ~400 frames)."""
    jw, tw = both_gmms(rng, 8, 4)
    x = (rng.standard_normal((600, 4)) * 1.2).astype(np.float32)
    x[:200] += 1.0
    got = tcl.clustering_criterion_by_adapt(
        _gen(), torch.from_numpy(x), (0, 200), (300, 500), tw, crit)
    want = jcl.clustering_criterion_by_adapt(
        jax.random.key(0), jnp.asarray(x), (0, 200), (300, 500), jw, crit)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)
    with pytest.raises(ValueError):
        tcl.clustering_criterion_by_adapt(_gen(), torch.from_numpy(x),
                                          (0, 10), (10, 20), tw, "nope")


@pytest.mark.parametrize("crit", ["GLR", "BIC", "CLR", "DELTABIC"])
def test_clustering_criterion_em_matches_jax(rng, crit):
    """EM-trained segment models with bagged probability 1 (the default
    0.8 draws frames from each package's own random stream): rel 2e-4 /
    atol 0.1 after 4 EM iterations with variance control."""
    jw, tw = both_gmms(rng, 4, 4)
    x = (rng.standard_normal((500, 4)) * 1.2).astype(np.float32)
    x[:250] += 2.0
    kw = dict(nb_train_it=4, bagged_frame_probability=1.0)
    got = tcl.clustering_criterion_em(
        _gen(), torch.from_numpy(x), (0, 250), (250, 500), tw, crit, **kw)
    want = jcl.clustering_criterion_em(
        jax.random.key(0), jnp.asarray(x), (0, 250), (250, 500), jw, crit,
        **kw)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=0.1)
    with pytest.raises(ValueError):
        tcl.clustering_criterion_em(_gen(), torch.from_numpy(x), (0, 10),
                                    (10, 20), tw, "nope", **kw)


def test_similarity_and_purity_passes(rng):
    """is_similar_segment, intra_cluster, inter_cluster draw bagged masks
    (probability 0.8) from each package's own stream, so they are held to
    what both must decide on well-separated data: halves of one speaker
    are similar, different speakers are not, and the purity passes flag
    exactly the foreign segment."""
    d = 4
    x = np.concatenate([rng.standard_normal((700, d)) * 0.5 + 2.5,
                        rng.standard_normal((700, d)) * 0.5 - 2.5,
                        rng.standard_normal((700, d)) * 0.5 + 2.5]
                       ).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    w_np = (np.full(2, 0.5, np.float32),
            np.asarray([[2.5] * d, [-2.5] * d], np.float32),
            np.ones((2, d), np.float32))
    jw, tw = _pair(w_np)
    same, diff = ((0, 700), (1400, 2100)), ((0, 700), (700, 1400))
    # GLR here is LLK(merged) − LLK(apart) ≤ 0 and "similar" means below
    # the threshold (the reference's rule, kept by both packages), so at
    # −200 the decisions come out the other way round than CLR's
    for crit, thr, flip in (("CLR", -2.0, False), ("GLR", -200.0, True),
                            ("BIC", 0.0, True), ("DELTABIC", -200.0, False)):
        for segs, want in ((same, True), (diff, False)):
            assert bool(tcl.is_similar_segment(_gen(1), xt, *segs, tw, crit,
                                               thr)) is (want != flip)
            assert jcl.is_similar_segment(jax.random.key(1), xj, *segs, jw,
                                          crit, thr) == (want != flip)
    clusters = [[(0, 700), (1400, 2100), (700, 1000)], [(1000, 1400)]]
    ja, ta = _pair(_gauss_np(2.5, 0.25))
    jb, tb = _pair(_gauss_np(-2.5, 0.25))
    got = tcl.intra_cluster(_gen(2), xt, clusters, [ta, tb], tw, "CLR",
                            threshold=-2.0, min_len=600)
    want = jcl.intra_cluster(jax.random.key(2), xj, clusters, [ja, jb], jw,
                             "CLR", threshold=-2.0, min_len=600)
    assert got == want == [[True, True, False], [True]]
    clusters = [[(0, 700)], [(700, 1400), (1400, 2100)]]
    got = tcl.inter_cluster(_gen(3), xt, clusters, [ta, tb], tw, "CLR",
                            threshold=-2.0, min_len=600)
    want = jcl.inter_cluster(jax.random.key(3), xj, clusters, [ja, jb], jw,
                             "CLR", threshold=-2.0, min_len=600)
    assert got == want == [[(1, 1)], []]


# -- split init, der ------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 6])
def test_mixture_init_by_split_matches_jax(rng, k):
    """Binary splits to 4, then (k = 6) two unitary splits of the heaviest
    component, 3 EM iterations after each round; bagged probability 1, so
    neither package draws.  Parameters rtol 2e-3 / atol 2e-3·max (f32
    roundoff through up to 12 M-steps with variance control)."""
    x = np.concatenate([rng.standard_normal((300, 3)) + m
                        for m in (-4.0, 0.0, 4.0, 8.0)]).astype(np.float32)
    w = (rng.random(1200) > 0.1).astype(np.float32)
    got = tem.mixture_init_by_split(_gen(), torch.from_numpy(x),
                                    torch.from_numpy(w), k)
    want = jem.mixture_init_by_split(jax.random.key(0), jnp.asarray(x),
                                     jnp.asarray(w), k)
    assert got.n_components == k
    for a, b in ((got.weights, want.weights), (got.means, want.means),
                 (got.cov_inv, want.cov_inv)):
        b = np.asarray(b)
        np.testing.assert_allclose(np_of(a), b, rtol=2e-3,
                                   atol=2e-3 * np.abs(b).max())


def test_split_component_takes_first_heaviest(rng):
    jg, tg = both_gmms(rng, 3, 2)
    got = tem._split_component(tg, 1)
    want = jem._split_component(jg, 1)
    for f in ("weights", "means", "cov_inv"):
        np.testing.assert_allclose(np_of(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-6)
    assert torch.equal(tg.weights, torch.from_numpy(np.asarray(jg.weights)))
    tie = torch.tensor([0.2, 0.4, 0.4])
    assert int(torch.argmax(tie)) == int(jnp.argmax(jnp.asarray(tie.numpy())))


@pytest.mark.parametrize("collar", [0, 5])
def test_der_matches_jax(rng, collar):
    ref = np.repeat(rng.integers(-1, 3, 40), 25)
    hyp = ref.copy()
    flip = rng.random(ref.shape[0]) < 0.15
    hyp[flip] = rng.integers(-1, 4, int(flip.sum()))
    hyp = (hyp + 1) % 4 - 1                       # relabelled speakers
    assert tder(ref, hyp, collar) == jder(ref, hyp, collar)
    assert tder(ref, ref) == 0.0
    assert tder(np.full(10, -1), np.zeros(10, int)) == 0.0
    with pytest.raises(ValueError):
        tder(ref, hyp[:-1])


# -- diarization processes --------------------------------------------------------

def test_glr_curve_and_turns_match_jax(rng):
    """The GLR curve within 2e-4·2·window·|logdet| (f32 prefix sums in a
    different order); the detected turns, on a corpus with clear turns,
    the same count and each within 2 frames of the JAX package's, and
    within 20 frames of the true changes."""
    x, truth = _turns(rng, n_turns=8, turn_len=150)
    window = 50
    got = np_of(tdz.glr_distance_curve(torch.from_numpy(x), window))
    want = np.asarray(jdz.glr_distance_curve(jnp.asarray(x), window))
    xc = x - x.mean(0)
    logdet = abs(float(np.sum(np.log(xc.var(0)))))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * 2 * window * max(logdet, 1.0))
    assert np.all(got[:window] == 0) and np.all(got[-window:] == 0)
    t_got = tdz.turn_detection(x, window=window, alpha=0.6, device=CPU)
    t_want = jdz.turn_detection(x, window=window, alpha=0.6)
    assert len(t_got) == len(t_want)
    assert np.max(np.abs(t_got - t_want)) <= 2
    changes = np.nonzero(np.diff(truth))[0] + 1
    assert all(np.min(np.abs(t_got - c)) <= 20 for c in changes)
    assert tdz.turn_detection(x[:60], window=50).size == 0
    # a tensor is used where it lies
    np.testing.assert_array_equal(
        tdz.turn_detection(torch.from_numpy(x), window=window), t_got)


def _world_pair(rng, x, k=4):
    w = np.ones(x.shape[0], np.float32)
    init = jem.mixture_init(jax.random.key(0), jnp.asarray(x), jnp.asarray(w),
                            k, bagged_probability_init=1.0)
    jw = jem.train_model(jax.random.key(1), jnp.asarray(x), jnp.asarray(w),
                         init, jem.TrainCfg(nb_train_it=3))
    return jw, convert.gmm_from_numpy(np.asarray(jw.weights),
                                      np.asarray(jw.means),
                                      np.asarray(jw.cov_inv))


def test_batched_state_adapt_matches_jax_and_keeps_empty_rows(rng):
    """One MAP model per mask row, rtol 1e-4 / atol 1e-4·max against the
    JAX vmap; a row whose mask is all zero comes back as the world with
    every number finite (zero occupancy keeps the prior)."""
    x, truth = _turns(rng, n_turns=4, turn_len=100)
    jw, tw = _world_pair(rng, x)
    masks = np.stack([truth == 0, truth == 1,
                      np.zeros_like(truth)]).astype(np.float32)
    got = tdz._batched_state_adapt(_gen(), torch.from_numpy(x),
                                   torch.from_numpy(masks), tw, map_reg=3.0)
    want = jdz._batched_state_adapt(jax.random.split(jax.random.key(0), 3),
                                    jnp.asarray(x), jnp.asarray(masks), jw,
                                    map_reg=3.0)
    for f in ("weights", "means", "cov_inv"):
        b = np.asarray(getattr(want, f))
        np.testing.assert_allclose(np_of(getattr(got, f)), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
        assert torch.isfinite(getattr(got, f)).all()
    assert torch.equal(got.means[2], tw.means)
    assert torch.equal(got.cov_inv[2], tw.cov_inv)
    np.testing.assert_allclose(np_of(got.weights[2]), np_of(tw.weights),
                               rtol=1e-6)
    # one state model alone, and the merge of two banks
    one = tdz._train_state_model(_gen(), torch.from_numpy(x),
                                 torch.from_numpy(masks[0]), tw, map_reg=3.0)
    assert torch.equal(one.means, got.means[0])
    world3 = stack_gmms([tw, tw, tw])
    merged = tdz._merge_state_rows(world3, got, np.array([True, False, True]))
    assert torch.equal(merged.means[0], got.means[0])
    assert torch.equal(merged.means[1], tw.means)
    # masked emissions: inactive states at −1e30
    em = tdz._masked_emissions(torch.from_numpy(x), got, [1, 1, 0])
    want_em = jdz._masked_emissions(jnp.asarray(x), want,
                                    jnp.asarray([1.0, 1.0, 0.0]))
    np.testing.assert_allclose(np_of(em), np.asarray(want_em), rtol=1e-5,
                               atol=1e-3)
    assert torch.all(em[:, 2] == -1e30)


def test_seg_em_create_world_seg_adaptation(rng):
    """seg_em and create_world against the JAX functions (bagged
    probability 1; rtol 2e-3 / atol 2e-3·max as the split init), and
    seg_adaptation dropping a state that lost its frames."""
    x, truth = _turns(rng, n_turns=4, turn_len=120)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    w = np.ones(x.shape[0], np.float32)
    jw, tw = _world_pair(rng, x)
    pairs = [
        (tdz.seg_em(_gen(), xt, torch.from_numpy(w), tw, nb_train_it=2),
         jdz.seg_em(jax.random.key(0), xj, jnp.asarray(w), jw,
                    nb_train_it=2)),
        (tdz.create_world(_gen(), xt, torch.from_numpy(w), 4, nb_train_it=2),
         jdz.create_world(jax.random.key(0), xj, jnp.asarray(w), 4,
                          nb_train_it=2)),
    ]
    for got, want in pairs:
        for f in ("weights", "means", "cov_inv"):
            b = np.asarray(getattr(want, f))
            np.testing.assert_allclose(np_of(getattr(got, f)), b, rtol=2e-3,
                                       atol=2e-3 * np.abs(b).max())
    th = thmm.DiarHmm.from_gmms([tw, tw, tw], ["S0", "S1", "S2"])
    jh = jhmm.DiarHmm.from_gmms([jw, jw, jw], ["S0", "S1", "S2"])
    path = np.where(truth == 0, 0, 2)               # state 1 has no frames
    got, keep = tdz.seg_adaptation(_gen(), xt, th, path, tw)
    want, jkeep = jdz.seg_adaptation(jax.random.key(0), xj, jh, path, jw)
    assert keep == jkeep == [0, 2] and got.names == want.names
    b = np.asarray(want.gmms.means)
    np.testing.assert_allclose(np_of(got.gmms.means), b, rtol=1e-4,
                               atol=1e-4 * np.abs(b).max())
    np.testing.assert_allclose(np_of(got.log_trans),
                               np.asarray(want.log_trans), rtol=1e-6)


def test_e_hmm_and_resegmentation_match_jax(rng):
    """Three well-separated speakers, 9 turns of 200 frames: both packages
    find 3 speakers with DER < 2 % against the truth, their DERs within
    0.5 % of each other, and their paths agree on ≥ 99 % of the frames
    after the optimal label mapping; the same for the resegmentation of a
    perturbed truth."""
    x, truth = _turns(rng, n_turns=9, turn_len=200, n_spk=3, sep=4.0)
    jw, tw = _world_pair(rng, x, k=4)
    kw = dict(max_speakers=4, init_seg_frames=150, nb_decode_it=2,
              map_reg=3.0)
    before = dict(ck.launch_counts)
    t_segs, t_path = tdz.e_hmm_segmentation(x, tw, **kw)
    j_segs, j_path = jdz.e_hmm_segmentation(x, jw, **kw)
    assert ck.launch_counts == before                  # CPU: no launch
    d_t, d_j = tder(truth, t_path), tder(truth, j_path)
    assert d_t < 0.02 and d_j < 0.02 and abs(d_t - d_j) <= 0.005
    assert _mapped_agreement(t_path, j_path) >= 0.99
    assert len({s.label for s in t_segs}) >= 3
    # a rerun reproduces the path
    np.testing.assert_array_equal(
        tdz.e_hmm_segmentation(x, tw, **kw)[1], t_path)
    # resegmentation from a truth with every 7th turn given to a speaker
    # that then loses all frames (min_state_frames drops it)
    init = [Segment(i * 2.0, (i + 1) * 2.0, f"S{truth[i * 200]}")
            for i in range(9)]
    init[4] = Segment(init[4].begin, init[4].begin + 0.2, "ghost")
    t_rs, t_rpath = tdz.resegmentation(x, init, tw, nb_it=2, map_reg=3.0)
    j_rs, j_rpath = jdz.resegmentation(x, init, jw, nb_it=2, map_reg=3.0)
    d_t, d_j = tder(truth, t_rpath), tder(truth, j_rpath)
    assert d_t < 0.02 and abs(d_t - d_j) <= 0.005
    assert _mapped_agreement(t_rpath, j_rpath) >= 0.99
    assert {s.label for s in t_rs} == {s.label for s in j_rs}


def test_acoustic_segmentation_matches_jax(rng):
    x, truth = _turns(rng, n_turns=6, turn_len=120)
    x[300:303] = -3.0                                   # a 3-frame blip
    trip = [_gauss_np(3.0), _gauss_np(-3.0)]
    t_segs, t_path = tdz.acoustic_segmentation(
        x, [convert.gmm_from_numpy(*t) for t in trip], ["sp", "sil"],
        min_duration=10)
    j_segs, j_path = jdz.acoustic_segmentation(
        x, [JGmm.create(*t) for t in trip], ["sp", "sil"], min_duration=10)
    np.testing.assert_array_equal(t_path, j_path)
    assert [(s.begin, s.end, s.label) for s in t_segs] == \
        [(s.begin, s.end, s.label) for s in j_segs]


# -- the four tools through both CLIs -----------------------------------------------

@pytest.fixture(scope="module")
def seg_corpus(tmp_path_factory):
    """One conversation file (3 speakers + silence), event models and a
    world, written once; each package works in a directory of its own."""
    d = str(tmp_path_factory.mktemp("torch_seg"))
    rng = np.random.default_rng(5)
    dim = 6
    spk = rng.standard_normal((3, dim)) * 3.0
    frames, ref = [], []
    for i in range(12):
        s = i % 3
        frames.append(spk[s] + rng.standard_normal((150, dim)) * 0.5)
        ref += [s] * 150
        if i % 4 == 3:
            frames.append(-6.0 + rng.standard_normal((60, dim)) * 0.2)
            ref += [-1] * 60
    x = np.concatenate(frames).astype(np.float32)
    write_feature_file(os.path.join(d, "conv.prm"), x, fmt="SPRO4")
    sp = x[np.asarray(ref) >= 0]
    write_feature_file(os.path.join(d, "convsp.prm"), sp, fmt="SPRO4")
    # event models: speech (4 components on the speakers) and silence
    ev_speech = (np.full(4, 0.25, np.float32),
                 np.concatenate([spk, spk[:1] * 0.5]).astype(np.float32),
                 np.full((4, dim), 2.0, np.float32))
    ev_sil = (np.full(4, 0.25, np.float32),
              np.full((4, dim), -6.0, np.float32)
              + np.arange(4, dtype=np.float32)[:, None] * 0.05,
              np.full((4, dim), 10.0, np.float32))
    JGmm.create(*ev_speech).save(os.path.join(d, "evt_speech.gmm"))
    JGmm.create(*ev_sil).save(os.path.join(d, "evt_silence.gmm"))
    w = np.ones(sp.shape[0], np.float32)
    init = jem.mixture_init(jax.random.key(0), jnp.asarray(sp),
                            jnp.asarray(w), 4, bagged_probability_init=1.0)
    jem.train_model(jax.random.key(1), jnp.asarray(sp), jnp.asarray(w), init,
                    jem.TrainCfg(nb_train_it=3)).save(
                        os.path.join(d, "wld.gmm"))
    return d, np.asarray(ref)


def _seg_cfg(d, lbl_dir, **extra):
    cfg = {"featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
           "labelFilesPath": lbl_dir + "/", "lstPath": d + "/",
           "loadFeatureFileFormat": "SPRO4",
           "loadFeatureFileExtension": ".prm",
           "loadMixtureFileExtension": ".gmm",
           "addDefaultLabel": "true", "defaultLabel": "speech",
           "labelSelectedFrames": "speech"}
    cfg.update(extra)
    return cfg


def _cli_args(cfg):
    out = []
    for k, v in cfg.items():
        out += [f"--{k}", str(v)]
    return out + ["--torchDevice", "cpu"]


def test_seg_tools_through_both_clis(seg_corpus, tmp_path):
    """AcousticSegmentation → TurnDetection → Segmentation →
    ReSegmentation through ``python -m lia_ral_tpu_torch`` (in process)
    and the JAX tool's ``main``, each writing label files of its own.
    SAD labels equal; turns the same count and within 2 frames;
    Segmentation and ReSegmentation find 3 speakers, DER < 3 % against the
    truth in both and within 1 % of each other, ≥ 99 % frame agreement."""
    d, ref = seg_corpus
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    os.makedirs(tdir)
    os.makedirs(jdir)
    n_sp = int((ref >= 0).sum())

    def run(tool, mode, **extra):
        assert tmain.main([tool] + _cli_args(_seg_cfg(d, tdir, **extra))) == 0
        jcfg = JConfig(_seg_cfg(d, jdir, **extra))
        # the JAX umbrella presets a key its tool lacks for
        # AcousticSegmentation; drive the tool with the tool's own key
        jcfg["segMode"] = mode
        j_spkseg.main(jcfg)

    run("AcousticSegmentation", "acousticSegmentation",
        inputFeatureFilename="conv",
        acousticModels="evt_speech,evt_silence", minimumDuration=20,
        saveLabelFileExtension=".sad.lbl")
    t_sad = read_label_file(os.path.join(tdir, "conv.sad.lbl"))
    j_sad = read_label_file(os.path.join(jdir, "conv.sad.lbl"))
    assert [(s.begin, s.end, s.label) for s in t_sad] == \
        [(s.begin, s.end, s.label) for s in j_sad]
    sad = _labels_of(t_sad, ref.shape[0])
    names = [s.label for s in t_sad]
    speech_id = 0 if names[0] == "evt_speech" else 1
    assert ((sad == speech_id) != (ref >= 0)).mean() < 0.01

    run("TurnDetection", "turnDetection", inputFeatureFilename="convsp",
        windowDuration=0.5, alpha=0.6, saveLabelFileExtension=".turn.lbl")
    t_turn = read_label_file(os.path.join(tdir, "convsp.turn.lbl"))
    j_turn = read_label_file(os.path.join(jdir, "convsp.turn.lbl"))
    assert len(t_turn) == len(j_turn) >= 10
    assert max(abs(a.begin - b.begin) for a, b in zip(t_turn, j_turn)) <= 0.02

    run("Segmentation", "segmentation", inputFeatureFilename="convsp",
        inputWorldFilename="wld", maxSpeakers=4, initSegFrames=120,
        nbDecodeIt=2, MAPRegFactorMean=3.0, minimumDuration=20,
        saveLabelFileExtension=".seg.lbl")
    run("ReSegmentation", "resegmentation", inputFeatureFilename="convsp",
        inputWorldFilename="wld", MAPRegFactorMean=3.0, nbTrainIt=2,
        minimumDuration=20, loadLabelFileExtension=".seg.lbl",
        saveLabelFileExtension=".reseg.lbl")
    truth = ref[ref >= 0]
    for ext in (".seg.lbl", ".reseg.lbl"):
        t_l = _labels_of(read_label_file(
            os.path.join(tdir, "convsp" + ext)), n_sp)
        j_l = _labels_of(read_label_file(
            os.path.join(jdir, "convsp" + ext)), n_sp)
        d_t, d_j = tder(truth, t_l), tder(truth, j_l)
        assert d_t < 0.03 and d_j < 0.03 and abs(d_t - d_j) <= 0.01, ext
        assert _mapped_agreement(t_l, j_l) >= 0.99, ext
        assert len(set(t_l[t_l >= 0])) >= 3


def test_seg_tool_presets_and_unknown_mode(seg_corpus, tmp_path):
    """``TOOLS`` presets the tool's own mode keys; an unknown segMode is a
    KeyError as in the JAX tool; ``cuda`` without a card raises."""
    from lia_ral_tpu_torch.config import Config as TConfig
    from lia_ral_tpu_torch.tools import spkseg_tools as t_spkseg

    assert tmain.TOOLS["AcousticSegmentation"] == (
        "spkseg_tools", {"segMode": "acousticSegmentation"})
    assert tmain.TOOLS["TurnDetection"][1] == {"segMode": "turnDetection"}
    assert tmain.TOOLS["Segmentation"][1] == {"segMode": "segmentation"}
    assert tmain.TOOLS["ReSegmentation"][1] == {"segMode": "resegmentation"}
    assert sum(v is None for v in tmain.TOOLS.values()) == 0
    d, _ = seg_corpus
    cfg = TConfig(_seg_cfg(d, str(tmp_path), inputFeatureFilename="convsp",
                           segMode="acoustic", torchDevice="cpu"))
    with pytest.raises(KeyError):
        t_spkseg.main(cfg)
    if not torch.cuda.is_available():
        cfg = TConfig(_seg_cfg(d, str(tmp_path),
                               inputFeatureFilename="convsp",
                               segMode="turnDetection"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_spkseg.main(cfg)
