"""TrainTarget: MAP target-model training CLI (port of
lia_ral_tpu/tools/train_target.py).

Equivalent of reference ``LIA_SpkDet/TrainTarget`` (TrainTarget.cpp:
73-237): per line of ``targetIdList`` (client id, then its training
files), MAP-adapt the world model on the client's frames and save the
client model.  On a CUDA device the EM stats of every iteration run in
kernel K1.  The channel-compensated variants (``channelCompensation``
JFA/LFA), ``NAP`` and ``outputAdaptParam`` are not ported yet.
"""

from __future__ import annotations

import sys

import torch

from ..config import Config
from ..gmm.map_adapt import MapCfg, adapt_model
from ..gmm.model import GmmDiag
from ..io.lists import read_ndx
from .common import (load_features_and_mask, mixture_path, not_ported,
                     resolve_device, setup_verbose)


def main(cfg: Config) -> dict[str, GmmDiag]:
    cc = cfg.get_str("channelCompensation", "")
    if cc in ("JFA", "LFA") or (cc and cfg.get_bool("channelCompensation",
                                                    False)):
        raise not_ported(f"TrainTarget channelCompensation={cc}", 10)
    for key in ("NAP", "outputAdaptParam"):
        if cfg.get_bool(key, False):
            raise not_ported(f"TrainTarget {key}", 13)
    verbose = setup_verbose(cfg)
    dev = resolve_device(cfg)
    world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg),
                         device=dev)
    mcfg = MapCfg.from_config(cfg)
    seed = cfg.get_int("randomSeed", 0)
    fmt = cfg.get_str("saveMixtureFileFormat", "RAW")
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
        gen = torch.Generator(device=dev).manual_seed(seed + line_no)
        client_model = adapt_model(gen, x, w, world, mcfg)
        client_model.save(mixture_path(client, cfg, save=True), fmt=fmt,
                          model_id=client)
        out[client] = client_model
        if verbose:
            print(f"client [{client}]: {int(mask.sum())} frames "
                  f"→ {mixture_path(client, cfg, save=True)}")
    return out


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
