"""TrainWorld: GMM-UBM EM training CLI (port of
lia_ral_tpu/tools/train_world.py).

Equivalent of reference ``LIA_SpkDet/TrainWorld`` (trainWorld
TrainWorld.cpp:101-191; schema TrainWorldMain.cpp:61-87).  Same config
keys, plus ``torchDevice``; reads .prm features + .lbl labels, writes the
UBM as a .gmm file.  On a CUDA device the EM stats run in kernel K1.
"""

from __future__ import annotations

import sys

import torch

from ..config import Config
from ..gmm.em import (TrainCfg, mixture_init, train_model,
                      train_model_streaming)
from ..gmm.model import GmmDiag
from .common import (feature_buffer_size, feature_chunk_loader,
                     load_features_and_mask, mixture_path, resolve_device,
                     resolve_list, resolve_stats_fn, setup_verbose)


def main(cfg: Config) -> GmmDiag:
    verbose = setup_verbose(cfg)
    dev = resolve_device(cfg)
    names = resolve_list(cfg, "inputFeatureFilename")
    k = cfg.get_int("mixtureDistribCount")
    tcfg = TrainCfg.from_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(cfg.get_int("randomSeed",
                                                              0))
    buffer_size = feature_buffer_size(cfg)
    streaming = buffer_size is not None
    if streaming:
        # featureServerBufferSize is a frame count: stream the corpus in
        # bounded buffers (reference FeatureServer contract)
        loader = feature_chunk_loader(names, cfg, buffer_size)
        first = next(iter(loader()))
        x = torch.as_tensor(first[0], device=dev)
        w = torch.as_tensor(first[1], device=dev)
    else:
        fs, mask = load_features_and_mask(names, cfg)
        x = torch.as_tensor(fs.data, device=dev)
        w = torch.as_tensor(mask, device=dev)
    if cfg.exists("inputWorldFilename"):
        init = GmmDiag.load(
            mixture_path(cfg.get_str("inputWorldFilename"), cfg),
            cfg.get_str("loadMixtureFileFormat", None)
            if cfg.exists("loadMixtureFileFormat") else None, device=dev)
        if verbose:
            print(f"init from model [{cfg.get_str('inputWorldFilename')}]")
    else:
        # init by random frame picking from the (first buffer of the)
        # stream — the reference's mixtureInit also draws through the
        # bounded FeatureServer (TrainTools.cpp:674)
        init = mixture_init(gen, x, w, k,
                            tcfg.bagged_frame_probability_init or 0.1,
                            tcfg.bagged_minimal_length,
                            tcfg.bagged_maximal_length)
        if verbose:
            print(f"init from scratch: {k} components"
                  + ("" if streaming else
                     f", {fs.nframes} frames ({int(mask.sum())} selected)"))
    if cfg.exists("outputInitWorldFilename"):
        # the reference saves the initial model for reproducible restart
        # (TrainWorld.cpp:178)
        init_name = cfg.get_str("outputInitWorldFilename")
        init.save(mixture_path(init_name, cfg, save=True),
                  fmt=cfg.get_str("saveMixtureFileFormat", "RAW"),
                  model_id=init_name)
    if streaming:
        world = train_model_streaming(gen, loader, init, tcfg,
                                      stats_fn=resolve_stats_fn(cfg),
                                      verbose=verbose)
    else:
        world = train_model(gen, x, w, init, tcfg,
                            stats_fn=resolve_stats_fn(cfg), verbose=verbose)
    out = cfg.get_str("outputWorldFilename")
    world.save(mixture_path(out, cfg, save=True),
               fmt=cfg.get_str("saveMixtureFileFormat", "RAW"),
               model_id=out)
    if verbose:
        print(f"saved world model [{out}]")
    return world


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
