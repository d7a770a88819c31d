"""Shared tool plumbing: feature/label loading per config, the device,
the mesh and the stats tier (port of lia_ral_tpu/tools/common.py).

Replaces the per-tool boilerplate of the reference mains
(FeatureServer construction + initializeClusters + verifyClusterFile,
e.g. TrainWorld.cpp:66-77).  Feature files go through the native liaio
reader (``io/native.py``), a batch of files at a time in
``load_files_batch``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import Config
from ..io.features import (FeatureServer, apply_mask, feature_path,
                           read_feature_file, server_from_config)
from ..io.labels import SegmentStore
from ..io.lists import read_simple_list


def resolve_device(cfg: Config) -> torch.device:
    """The device the tools compute on: config key ``torchDevice``
    (default ``cuda``), the port's counterpart of ``JAX_PLATFORMS``.  A
    ``cuda`` device without a card raises; nothing falls back to the
    CPU."""
    dev = torch.device(cfg.get_str("torchDevice", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"torchDevice {dev} asked for, but torch sees no CUDA device; "
            "pass --torchDevice cpu to run on the CPU")
    return dev


def resolve_list(cfg: Config, key: str) -> list[str]:
    """A config value that is either a list file (one name per line) or a
    direct basename (reference inputFeatureFilename semantics)."""
    val = cfg.get_str(key)
    lst_path = os.path.join(cfg.get_str("lstPath", "./"), val)
    for p in (val, lst_path):
        if os.path.isfile(p) and not p.endswith(
                cfg.get_str("loadFeatureFileExtension", ".prm")):
            try:
                names = read_simple_list(p)
                if names:
                    return names
            except UnicodeDecodeError:
                pass
    return [val]


def label_path(name: str, cfg: Config, save: bool = False) -> str:
    root = cfg.get_str("labelFilesPath", "./")
    key = "saveLabelFileExtension" if save else "loadLabelFileExtension"
    ext = cfg.get_str(key, ".lbl")
    return os.path.join(root, name + ext)


def file_frame_mask(name: str, nframes: int, cfg: Config) -> np.ndarray:
    """Frame-selection mask of ONE file from its label file
    (labelSelectedFrames / addDefaultLabel / defaultLabel)."""
    frame_length = cfg.get_float("frameLength", 0.01)
    label = cfg.get_str("labelSelectedFrames", "speech")
    add_default = cfg.get_bool("addDefaultLabel", False)
    default_label = cfg.get_str("defaultLabel", label)
    lp = label_path(name, cfg)
    store = SegmentStore.from_label_file(
        lp if os.path.isfile(lp) else None, nframes, frame_length,
        add_default, default_label)
    m = store.mask(label, nframes)
    if not m.any() and add_default and label == default_label:
        m[:] = True
    return m.astype(np.float32)


def load_features_and_mask(names: list[str], cfg: Config
                           ) -> tuple[FeatureServer, np.ndarray]:
    """FeatureServer over the listed files + the frame selection mask from
    the per-file label files."""
    fs = server_from_config(names, cfg)
    mask = np.zeros(fs.nframes, dtype=np.float32)
    for i, name in enumerate(names):
        a, b = fs.source_range(i)
        mask[a:b] = file_frame_mask(name, b - a, cfg)
    return fs, mask


def load_files_batch(names: list[str], cfg: Config, batch: int = 64
                     ) -> list[np.ndarray | None]:
    """Per-file feature arrays for a name list, read ``batch`` files at a
    time by the native batched loader (liaio_read_batch's thread pool),
    with the per-file reader for what it refuses — the data-loader hot
    path of thousands-of-files NIST runs.  Returns (T,D) float32 arrays
    in input order (featureServerMask applied), None for unreadable
    files."""
    from ..io.native import read_features_batch_native
    fmt = cfg.get_str("loadFeatureFileFormat", "SPRO4")
    mask_cfg = (cfg.get_str("featureServerMask")
                if cfg.exists("featureServerMask") else None)
    big_endian = cfg.get_bool("bigEndian", False)
    vect_size = cfg.get_int("loadFeatureFileVectSize", 0)
    paths = [feature_path(n, cfg) for n in names]
    out: list[np.ndarray | None] = [None] * len(names)
    for s0 in range(0, len(paths), batch):
        grp = paths[s0:s0 + batch]
        res = read_features_batch_native(grp, fmt, big_endian, vect_size)
        for j in range(len(grp)):
            x = res[j] if res is not None else None
            if x is None:
                # the per-file reader keeps the SPRO3/SPRO4 header
                # sniffing and the HTK path
                try:
                    x = read_feature_file(grp[j], fmt=fmt,
                                          big_endian=big_endian,
                                          vect_size=vect_size).data
                except Exception:
                    continue
            out[s0 + j] = apply_mask(x, mask_cfg)
    return out


def feature_buffer_size(cfg: Config) -> int | None:
    """Parse ``featureServerBufferSize``: frame count, or None for
    ALL_FEATURES (the reference's bounded feature buffer,
    TrainWorld.cfg)."""
    val = cfg.get_str("featureServerBufferSize", "ALL_FEATURES")
    return int(val) if val.isdigit() else None


def feature_chunk_loader(names: list[str], cfg: Config, buffer_size: int):
    """Streaming loader over a file list: a zero-arg callable yielding
    fixed-shape numpy ``(x[buffer,D], w[buffer])`` chunks per epoch, each
    built from at most ``buffer_size`` frames of host RAM (short tails are
    zero-weight padded)."""

    def loader():
        pend_x: list[np.ndarray] = []
        pend_w: list[np.ndarray] = []
        pending = 0

        def flush(pad: bool):
            nonlocal pend_x, pend_w, pending
            x = np.concatenate(pend_x) if pend_x else None
            w = np.concatenate(pend_w) if pend_w else None
            pend_x, pend_w, pending = [], [], 0
            if x is None or x.shape[0] == 0:
                return None
            if pad and x.shape[0] < buffer_size:
                short = buffer_size - x.shape[0]
                x = np.concatenate(
                    [x, np.zeros((short, x.shape[1]), x.dtype)])
                w = np.concatenate([w, np.zeros((short,), w.dtype)])
            return x, w

        for name in names:
            fs, mask = load_features_and_mask([name], cfg)
            x, w = fs.data, mask
            off = 0
            while off < x.shape[0]:
                take = min(buffer_size - pending, x.shape[0] - off)
                pend_x.append(x[off:off + take])
                pend_w.append(w[off:off + take])
                pending += take
                off += take
                if pending == buffer_size:
                    yield flush(pad=False)
        tail = flush(pad=True)
        if tail is not None:
            yield tail

    return loader


def mixture_path(name: str, cfg: Config, save: bool = False) -> str:
    root = cfg.get_str("mixtureFilesPath", "./")
    key = "saveMixtureFileExtension" if save else "loadMixtureFileExtension"
    ext = cfg.get_str(key, ".gmm")
    return os.path.join(root, name + ext)


def load_lfa_model(cfg: Config, world):
    """The LFA channel model of the feature-domain tools (TrainTarget
    LFA, NormFeat featFA/featLFA): U from ``eigenChannelMatrix``, D from
    the relevance factor ``regulationFactor``; on the world's device."""
    from ..fa.lfa import lfa_model
    from ..io.matrix import read_matrix_file
    u = read_matrix_file(os.path.join(
        cfg.get_str("matrixFilesPath", "./"),
        cfg.get_str("eigenChannelMatrix")
        + cfg.get_str("loadMatrixFilesExtension", ".matx")))
    k, d = world.means.shape
    return lfa_model(u.reshape(u.shape[0], k, d), world,
                     tau=cfg.get_float("regulationFactor", 16.0))


def compensate_session(x, w, world, fa_model, gram):
    """Feature-domain channel compensation of one session, x (T,D) with
    frame weights w: its channel factor from its own stats (z = y = 0),
    then x_t − Σ_g γ_g(t)·(U·x_h)_g.  ``gram``: ``channel_gram(fa_model)``."""
    from ..fa.lfa import compensate_features, estimate_channel
    from ..fa.stats import BwStats, accumulate_bw_stats
    n, f = accumulate_bw_stats(x, w, world)
    x_h = estimate_channel(BwStats(n=n[None], f=f[None]), fa_model,
                           gram=gram)[0]
    return compensate_features(x, world, fa_model, x_h)


def setup_verbose(cfg: Config) -> bool:
    return cfg.get_bool("verbose", False)


def resolve_mesh(cfg: Config):
    """numThread → a ("data",) mesh over min(numThread, visible devices)
    of the tool's device type, or None for one device (the reference's
    pthread pool size, AccumulateTVStat.cpp:1694, PldaTools.cpp:2647).
    With one card, numThread > 1 gives None, as the JAX package gives
    with one device; ``parallel.mesh.visible_devices`` is what a test
    patches to run several shards on one device."""
    n_thread = cfg.get_int("numThread", 1)
    if n_thread <= 1:
        return None
    from ..parallel import mesh as pmesh

    devs = pmesh.visible_devices(resolve_device(cfg).type)
    n = min(n_thread, len(devs))
    if n <= 1:
        return None
    return pmesh.make_mesh(n_data=n, devices=devs[:n])


def resolve_stats_fn(cfg: Config):
    """The EM stats pass the config asks for.  ``numThread`` shards the
    frame axis over ``resolve_mesh``'s mesh and sums the stats
    (AccumulateStat.cpp:236), each shard K1 in the tier of
    ``fastMath``/``fastStats`` (``gmm.em.default_stats_fn``); without a
    mesh the tier's stats pass, or None in the default tier.  The JAX
    function drops the tier keys when numThread > 1 finds one device; the
    port keeps them."""
    fast_math = cfg.get_bool("fastMath", False)
    fast_stats = cfg.get_bool("fastStats", False)
    mesh = resolve_mesh(cfg)
    if mesh is not None:
        from ..parallel.sharding import sharded_stats_fn
        return sharded_stats_fn(mesh, fast_math=fast_math,
                                fast_stats=fast_stats)
    if not (fast_math or fast_stats):
        return None
    from ..gmm.em import default_stats_fn
    return default_stats_fn(fast_math=fast_math, fast_stats=fast_stats)
