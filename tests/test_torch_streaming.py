"""The port's streaming corpus path and multi-stream EM against the JAX
package, mirroring tests/test_streaming.py (and the multi-stream case of
tests/test_unsupervised.py).

featureServerBufferSize is honoured: corpora stream through bounded
buffers and train as the in-RAM path does (the stat merge is
associative).  Bagging is off (probability 1), so neither package draws
and both start from one numpy-made init.  Tolerances are the JAX tests':
means rtol 1e-4, atol 1e-4; weights rtol 1e-4, atol 1e-5; covariances
rtol 1e-3, atol 1e-3; chunks and loaders exact.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp
from lia_ral_tpu.config import Config as JConfig
from lia_ral_tpu.gmm import em as jem
from lia_ral_tpu.gmm.model import GmmDiag as JGmm
from lia_ral_tpu.io.gmm_io import read_gmm_file
from lia_ral_tpu.tools import common as jcommon
from lia_ral_tpu.tools import train_world as j_train_world

from lia_ral_tpu_torch.config import Config as TConfig
from lia_ral_tpu_torch.gmm import em as tem
from lia_ral_tpu_torch.gmm.model import GmmDiag as TGmm
from lia_ral_tpu_torch.io.features import write_feature_file
from lia_ral_tpu_torch.io.gmm_io import write_gmm_file
from lia_ral_tpu_torch.tools import common as tcommon
from lia_ral_tpu_torch.tools import train_world as t_train_world

from _torch_parity import np_of


def _corpus(rng, n=1200, d=6, k=5):
    cent = rng.standard_normal((k, d)) * 2
    return (cent[rng.integers(0, k, n)]
            + rng.standard_normal((n, d)) * 0.4).astype(np.float32)


def _init(rng, k=5, d=6):
    return (np.full(k, 1.0 / k, np.float32),
            rng.standard_normal((k, d)).astype(np.float32),
            (rng.random((k, d)) + 0.5).astype(np.float32))


def _assert_gmm_close(got, want):
    np.testing.assert_allclose(np_of(got.means), np_of(want.means),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np_of(got.weights), np_of(want.weights),
                               rtol=1e-4, atol=1e-5)


def test_streaming_equals_in_ram(rng):
    x = _corpus(rng)
    w = np.ones(x.shape[0], np.float32)
    init = _init(rng)
    cfg = dict(nb_train_it=4, bagged_frame_probability=1.0)
    ref = tem.train_model(torch.Generator().manual_seed(0),
                          torch.from_numpy(x), torch.from_numpy(w),
                          TGmm.create(*init), tem.TrainCfg(**cfg))
    buf = 512   # corpus is 1200 frames → 3 chunks, last zero-padded

    def loader():
        for off in range(0, x.shape[0], buf):
            xc, wc = x[off:off + buf], w[off:off + buf]
            if xc.shape[0] < buf:
                pad = buf - xc.shape[0]
                xc = np.concatenate([xc, np.zeros((pad, x.shape[1]),
                                                  np.float32)])
                wc = np.concatenate([wc, np.zeros(pad, np.float32)])
            yield xc, wc

    got = tem.train_model_streaming(torch.Generator().manual_seed(0),
                                    loader, TGmm.create(*init),
                                    tem.TrainCfg(**cfg))
    _assert_gmm_close(got, ref)
    want = jem.train_model_streaming(jax.random.key(0), loader,
                                     JGmm.create(*init), jem.TrainCfg(**cfg))
    _assert_gmm_close(got, want)


def _config(d):
    return {"featureFilesPath": d + "/", "labelFilesPath": d + "/",
            "loadFeatureFileFormat": "SPRO4",
            "loadFeatureFileExtension": ".prm",
            "addDefaultLabel": "true", "defaultLabel": "speech",
            "labelSelectedFrames": "speech"}


def test_feature_chunk_loader_shapes(tmp_path, rng):
    d = str(tmp_path)
    sizes = [300, 450, 250]    # 1000 frames over 3 files, buffer 400
    for i, n in enumerate(sizes):
        write_feature_file(os.path.join(d, f"u{i}.prm"),
                           rng.standard_normal((n, 4)).astype(np.float32),
                           fmt="SPRO4")
    names = [f"u{i}" for i in range(3)]
    loader = tcommon.feature_chunk_loader(names, TConfig(_config(d)), 400)
    chunks = list(loader())
    assert [c[0].shape for c in chunks] == [(400, 4)] * 3
    # total selected weight = total real frames (padding is zero-weight)
    assert sum(float(c[1].sum()) for c in chunks) == sum(sizes)
    # epochs are repeatable (fresh generator per call)
    again = list(loader())
    np.testing.assert_array_equal(chunks[0][0], again[0][0])
    # the JAX loader gives the same chunks
    j_chunks = list(jcommon.feature_chunk_loader(names, JConfig(_config(d)),
                                                 400)())
    for (xt, wt), (xj, wj) in zip(chunks, j_chunks):
        np.testing.assert_array_equal(xt, np.asarray(xj))
        np.testing.assert_array_equal(wt, np.asarray(wj))


def test_train_world_tool_streaming(tmp_path, rng):
    """TrainWorld with a numeric featureServerBufferSize trains from
    bounded buffers and matches the ALL_FEATURES run (bagged probability
    1), and the JAX tool's streaming run."""
    d = str(tmp_path)
    x = _corpus(rng, n=1000)
    # two files so the buffer spans a file boundary
    write_feature_file(os.path.join(d, "a.prm"), x[:600], fmt="SPRO4")
    write_feature_file(os.path.join(d, "b.prm"), x[600:], fmt="SPRO4")
    with open(os.path.join(d, "corpus.lst"), "w") as f:
        f.write("a\nb\n")
    base = dict(_config(d), **{
        "mixtureFilesPath": d + "/", "lstPath": d + "/",
        "saveMixtureFileExtension": ".gmm", "loadMixtureFileExtension": ".gmm",
        "mixtureDistribCount": 5, "nbTrainIt": 3,
        "baggedFrameProbability": 1.0, "baggedFrameProbabilityInit": 1.0,
        "inputFeatureFilename": "corpus.lst", "inputWorldFilename": "init",
        "torchDevice": "cpu"})
    write_gmm_file(os.path.join(d, "init.gmm"), *_init(rng))
    t_train_world.main(TConfig(dict(base, outputWorldFilename="wld_ram",
                                    featureServerBufferSize="ALL_FEATURES")))
    t_train_world.main(TConfig(dict(base, outputWorldFilename="wld_stream",
                                    featureServerBufferSize="384")))
    j_train_world.main(JConfig(dict(base, outputWorldFilename="wld_jax",
                                    featureServerBufferSize="384")))
    w1, m1, c1 = read_gmm_file(os.path.join(d, "wld_ram.gmm"))
    for other in ("wld_stream", "wld_jax"):
        w2, m2, c2 = read_gmm_file(os.path.join(d, other + ".gmm"))
        np.testing.assert_allclose(m2, m1, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(w2, w1, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(c2, c1, rtol=1e-3, atol=1e-3)


def test_train_model_streams_matches_jax(rng):
    """Multi-stream weighted EM (reference trainModelStream) from one
    init, bagging off so that neither package draws: the same model as
    the JAX function, and the heavily weighted stream pulls the mass."""
    d, k = 3, 4
    x1 = (rng.standard_normal((1000, d)) + 2).astype(np.float32)
    x2 = (rng.standard_normal((1000, d)) - 2).astype(np.float32)
    w = np.ones(1000, np.float32)
    init = jem.mixture_init(jax.random.key(0),
                            jnp.asarray(np.concatenate([x1, x2])),
                            jnp.ones(2000, jnp.float32), k, 1.0)
    init_np = [np.array(a) for a in (init.weights, init.means,
                                     init.cov_inv)]
    cfg = dict(nb_train_it=3, bagged_frame_probability=1.0)
    want = jem.train_model_streams(
        jax.random.key(1), [(jnp.asarray(x1), jnp.asarray(w)),
                            (jnp.asarray(x2), jnp.asarray(w))],
        [10.0, 0.1], init, jem.TrainCfg(**cfg))
    tw = torch.from_numpy(w)
    got = tem.train_model_streams(
        torch.Generator().manual_seed(1),
        [(torch.from_numpy(x1), tw), (torch.from_numpy(x2), tw)],
        [10.0, 0.1], TGmm.create(*init_np), tem.TrainCfg(**cfg))
    _assert_gmm_close(got, want)
    np.testing.assert_allclose(np_of(got.cov_inv), np.asarray(want.cov_inv),
                               rtol=1e-3, atol=1e-3)
    mean_of_means = float(torch.sum(got.weights[:, None] * got.means) / d)
    assert mean_of_means > 0.5, mean_of_means
