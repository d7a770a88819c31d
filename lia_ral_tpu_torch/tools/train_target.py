"""TrainTarget: MAP target-model training CLI (port of
lia_ral_tpu/tools/train_target.py).

Equivalent of reference ``LIA_SpkDet/TrainTarget`` (TrainTarget.cpp:
73-237): per line of ``targetIdList`` (client id, then its training
files), MAP-adapt the world model on the client's frames and save the
client model.  On a CUDA device the EM stats of every iteration run in
kernel K1.  ``channelCompensation``: ``JFA`` enrols every client by one
joint [V;U] estimate (TrainTargetJFA, its session stats in kernel K2);
``LFA`` (or a true boolean) removes each client's channel offset U·x
from its frames before MAP.  ``NAP`` removes the ``NAPChannelMatrix``
subspace from each MAP model's mean supervector (TrainTarget.cpp:154-157);
``outputAdaptParam`` writes the client's ``superVector`` (KL | SVMUBM) as
a ``.vect`` matrix in ``saveVectorFilesPath`` in place of the model file
(cpp:158-169).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..backend.supervector import compute_nap, get_supervector
from ..config import Config
from ..fa.jfa import JfaModel, enroll_targets_joint
from ..fa.lfa import channel_gram
from ..gmm.map_adapt import MapCfg, adapt_model
from ..gmm.model import GmmDiag
from ..io.lists import read_ndx
from ..io.matrix import read_matrix_file, write_matrix_file
from .common import (compensate_session, load_features_and_mask,
                     load_lfa_model, mixture_path, resolve_device,
                     setup_verbose)
from .jfa_tools import accumulate_session_stats, load_subspace


def train_target_jfa(cfg: Config) -> dict[str, GmmDiag]:
    """TrainTargetJFA (TrainTarget.cpp:393-560, channelCompensation JFA):
    joint per-speaker (y, x) over the stacked [V; U] subspace, residual z
    with unit prior (estimateZ, AccumulateJFAStat.cpp:3450), client model
    = m + V·y + D·z (channel factor dropped), optional Σ⁻¹-scaled
    supervector and y/x/z side files.  All clients are enrolled in one
    batched joint estimate (the reference loops speakers through
    storeAccs/substract/restore, TrainTarget.cpp:521-541)."""
    verbose = setup_verbose(cfg)
    world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg),
                         device=resolve_device(cfg))
    k, d = world.means.shape

    def sub(key: str) -> torch.Tensor:
        if not cfg.exists(key):
            return torch.zeros((1, k, d), device=world.device)
        return load_subspace(cfg, key, world)

    model = JfaModel(v=sub("eigenVoiceMatrix"), u=sub("eigenChannelMatrix"),
                     d=sub("DMatrix")[0],
                     ubm_means=world.means.to(torch.float32),
                     ubm_inv_var=world.cov_inv.to(torch.float32))
    cfg2 = cfg.copy()
    cfg2["ndxFilename"] = cfg.get_str("targetIdList")
    stats, spk_names, _ = accumulate_session_stats(cfg2, world, verbose)
    y, x_spk, z = enroll_targets_joint(stats, model, tau=1.0)
    vy_dz = torch.einsum("sr,rkd->skd", y, model.v) + model.d[None] * z
    out: dict[str, GmmDiag] = {}
    sv_path = cfg.get_str("saveVectorFilesPath", "./")
    sv_ext = cfg.get_str("vectorFilesExtension", ".vect")

    def write_vector(name: str, t: torch.Tensor) -> None:
        write_matrix_file(os.path.join(sv_path, name),
                          t.reshape(1, -1).cpu().numpy().astype(np.float64))

    for i, client in enumerate(spk_names):
        cm = world.replace(means=world.means + vy_dz[i])
        if cfg.get_bool("saveMixture", True):
            cm.save(mixture_path(client, cfg, save=True),
                    fmt=cfg.get_str("saveMixtureFileFormat", "RAW"),
                    model_id=client)
        if cfg.get_bool("saveSuperVector", True) and cfg.exists(
                "saveVectorFilesPath"):
            # only the supervector is Σ⁻¹-scaled (TrainTarget.cpp:575)
            write_vector(client + sv_ext, vy_dz[i] * world.cov_inv)
        for flag, arr, ext_key, dflt in (
                ("saveY", y[i], "yExtension", ".y"),
                ("saveX", x_spk[i], "xExtension", ".x"),
                ("saveZ", z[i], "zExtension", ".z")):
            if cfg.get_bool(flag, False):
                write_vector(client + cfg.get_str(ext_key, dflt), arr)
        out[client] = cm
        if verbose:
            print(f"JFA client [{client}] enrolled")
    return out


def main(cfg: Config) -> dict[str, GmmDiag]:
    # channelCompensation dispatch (TrainTargetMain.cpp:163-169): "JFA" →
    # TrainTargetJFA, "LFA" or a true boolean → the feature-domain variant
    cc = cfg.get_str("channelCompensation", "")
    if cc == "JFA":
        return train_target_jfa(cfg)
    verbose = setup_verbose(cfg)
    dev = resolve_device(cfg)
    world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg),
                         device=dev)
    mcfg = MapCfg.from_config(cfg)
    seed = cfg.get_int("randomSeed", 0)
    fmt = cfg.get_str("saveMixtureFileFormat", "RAW")
    # TrainTargetFA variant (TrainTarget.cpp:279-420): the session channel
    # factor is estimated on the client's data and U·x removed from its
    # frames before MAP
    fa_model = gram = None
    if cc == "LFA" or (cc and cfg.get_bool("channelCompensation", False)):
        fa_model = load_lfa_model(cfg, world)
        gram = channel_gram(fa_model)
    # optional NAP of the client supervector (TrainTarget.cpp:154-157) and
    # supervector output instead of a model file (outputAdaptParam,
    # cpp:158-169: getSuperVector KL|SVMUBM written as a .vect matrix)
    nap_u = None
    if cfg.get_bool("NAP", False):
        nap_u = torch.as_tensor(
            read_matrix_file(cfg.get_str("NAPChannelMatrix",
                                         cfg.get_str("channelMatrix", "U"))),
            dtype=torch.float32, device=dev)
    output_adapt_param = cfg.get_bool("outputAdaptParam", False)
    sv_path = cfg.get_str("saveVectorFilesPath", "./")
    sv_ext = cfg.get_str("vectorFilesExtension", ".vect")
    sv_mode = cfg.get_str("superVector", "KL")
    out: dict[str, GmmDiag] = {}
    for line_no, (client, files) in enumerate(
            read_ndx(cfg.get_str("targetIdList"))):
        try:
            # useIdForSelectedFrame (GeneralTools.cpp:866): the client id
            # is the frame-selection label for its own files
            ccfg = cfg
            if cfg.get_bool("useIdForSelectedFrame", False):
                ccfg = cfg.copy()
                ccfg["labelSelectedFrames"] = client
            fs, mask = load_features_and_mask(files, ccfg)
        except FileNotFoundError as e:
            # the reference warns and optionally falls back to the world
            print(f"WARNING: no data for client [{client}]: {e}")
            if cfg.get_bool("useModelData", False):
                out[client] = world
                world.save(mixture_path(client, cfg, save=True), fmt=fmt,
                           model_id=client)
            continue
        x = torch.as_tensor(fs.data, device=dev)
        w = torch.as_tensor(mask, device=dev)
        if fa_model is not None:
            x = compensate_session(x, w, world, fa_model, gram)
        gen = torch.Generator(device=dev).manual_seed(seed + line_no)
        client_model = adapt_model(gen, x, w, world, mcfg)
        if nap_u is not None:
            client_model = compute_nap(client_model, nap_u)
        if output_adapt_param:
            sv = get_supervector(sv_mode, world, client_model)
            write_matrix_file(os.path.join(sv_path, client + sv_ext),
                              sv.cpu().numpy().astype(np.float64)[None, :])
        else:
            client_model.save(mixture_path(client, cfg, save=True), fmt=fmt,
                              model_id=client)
        out[client] = client_model
        if verbose:
            print(f"client [{client}]: {int(mask.sum())} frames "
                  f"→ {mixture_path(client, cfg, save=True)}")
    return out


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
