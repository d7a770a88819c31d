"""PLDA: standalone G-PLDA trainer CLI (port of
lia_ral_tpu/tools/plda_tool.py).

Equivalent of reference ``LIA_SpkDet/PLDA`` (PLDA.cpp:74-99): load dev
i-vectors, center/length-norm, EM loop, save the model as one .npz
(``pldaModelFilename``) and as the reference's five .matx files.
"""

from __future__ import annotations

import os
import sys

import torch

from ..backend.ivnorm import length_norm
from ..backend.plda import PldaModel, plda_train
from ..config import Config
from .common import resolve_device, resolve_mesh, setup_verbose
from .iv_norm import load_dev_set


def _mat_path(cfg: Config, key: str, default: str, load: bool = False) -> str:
    ext_key = "loadMatrixFilesExtension" if load else "saveMatrixFilesExtension"
    return os.path.join(cfg.get_str("matrixFilesPath", "./"),
                        cfg.get_str(key, default)
                        + cfg.get_str(ext_key, ".matx"))


def main(cfg: Config) -> PldaModel:
    verbose = setup_verbose(cfg)
    device = resolve_device(cfg)
    dev, _ = load_dev_set(cfg, device)
    if cfg.get_bool("lengthNorm", True):
        dev = dev.replace(vectors=length_norm(dev.vectors))
    init = None
    if cfg.get_bool("pldaLoadInitMatrices", False):
        # warm-start EM from saved matrices (PldaTools.cpp:2074-2108)
        init = PldaModel.load_reference(
            _mat_path(cfg, "pldaMeanVecInit", "pldaMeanVec", load=True),
            _mat_path(cfg, "pldaEigenVoiceMatrixInit",
                      "pldaEigenVoiceMatrix", load=True),
            _mat_path(cfg, "pldaEigenChannelMatrixInit",
                      "pldaEigenChannelMatrix", load=True)
            if cfg.get_int("pldaEigenChannelNumber", 0) else None,
            _mat_path(cfg, "pldaSigmaMatrixInit", "pldaSigmaMatrix",
                      load=True), device=device)
    gen = torch.Generator(device=device).manual_seed(
        cfg.get_int("randomSeed", 0))
    model = plda_train(
        gen, dev, rank_f=cfg.get_int("pldaEigenVoiceNumber", 150),
        rank_g=cfg.get_int("pldaEigenChannelNumber", 0),
        n_iterations=cfg.get_int("pldaNbIt", 10), verbose=verbose, init=init,
        mesh=resolve_mesh(cfg))
    model.save(cfg.get_str("pldaModelFilename", "plda_model.npz"))
    # reference-format matrix set (PldaModel::saveModel naming keys)
    model.save_reference(
        _mat_path(cfg, "pldaMeanVec", "pldaMeanVec"),
        _mat_path(cfg, "pldaEigenVoiceMatrix", "pldaEigenVoiceMatrix"),
        _mat_path(cfg, "pldaEigenChannelMatrix", "pldaEigenChannelMatrix"),
        _mat_path(cfg, "pldaSigmaMatrix", "pldaSigmaMatrix"),
        _mat_path(cfg, "pldaMinDivMean", "pldaMinDivMean"))
    if verbose:
        print(f"saved PLDA model (rankF={model.rank_f}, "
              f"rankG={model.rank_g})")
    return model


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
