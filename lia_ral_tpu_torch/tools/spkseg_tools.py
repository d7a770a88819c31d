"""Diarization CLI tools: AcousticSegmentation, TurnDetection,
Segmentation, ReSegmentation (port of lia_ral_tpu/tools/spkseg_tools.py).

Equivalents of the reference LIA_SpkSeg binaries (SURVEY.md §2.3), driven
by the same config keys and writing .lbl label files.  ``segMode`` picks
the tool (turnDetection | segmentation | resegmentation |
acousticSegmentation); ``torchDevice`` (default ``cuda``) the device.
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import Config
from ..gmm.model import GmmDiag
from ..io.labels import Segment, read_label_file, write_label_file
from ..seg.diarization import (acoustic_segmentation, e_hmm_segmentation,
                               resegmentation, turn_detection)
from .common import (label_path, load_features_and_mask, mixture_path,
                     resolve_device, resolve_list, setup_verbose)


def _per_file(cfg: Config):
    names = resolve_list(cfg, "inputFeatureFilename"
                         if cfg.exists("inputFeatureFilename")
                         else "inputFeatureFileName")
    for name in names:
        fs, mask = load_features_and_mask([name], cfg)
        yield name, fs.data, mask


def turn_detection_main(cfg: Config):
    verbose = setup_verbose(cfg)
    frame_length = cfg.get_float("frameLength", 0.01)
    window = int(cfg.get_float("windowDuration", 0.5) / frame_length)
    alpha = cfg.get_float("alpha", 0.6)
    dev = resolve_device(cfg)
    out = {}
    for name, x, mask in _per_file(cfg):
        turns = turn_detection(x, window=window, alpha=alpha,
                               min_gap=window // 2, device=dev)
        bounds = [0] + [int(t) for t in turns] + [x.shape[0]]
        segs = [Segment(a * frame_length, b * frame_length, "turn")
                for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        write_label_file(label_path(name, cfg, save=True), segs)
        out[name] = segs
        if verbose:
            print(f"[{name}] {len(turns)} turns")
    return out


def segmentation_main(cfg: Config):
    verbose = setup_verbose(cfg)
    world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg),
                         device=resolve_device(cfg))
    frame_length = cfg.get_float("frameLength", 0.01)
    out = {}
    for name, x, mask in _per_file(cfg):
        segs, _ = e_hmm_segmentation(
            x, world,
            max_speakers=cfg.get_int("maxSpeakers", 5),
            init_seg_frames=cfg.get_int("initSegFrames", 300),
            nb_decode_it=cfg.get_int("nbDecodeIt", 3),
            min_duration=cfg.get_int("minimumDuration", 50),
            frame_length=frame_length,
            seed=cfg.get_int("randomSeed", 0),
            map_reg=cfg.get_float("MAPRegFactorMean", 16.0),
            verbose=verbose)
        write_label_file(label_path(name, cfg, save=True), segs)
        out[name] = segs
        if verbose:
            print(f"[{name}] {len(set(s.label for s in segs))} speakers")
    return out


def reseg_main(cfg: Config):
    verbose = setup_verbose(cfg)
    world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg),
                         device=resolve_device(cfg))
    frame_length = cfg.get_float("frameLength", 0.01)
    out = {}
    for name, x, mask in _per_file(cfg):
        in_segs = read_label_file(label_path(name, cfg, save=False))
        segs, _ = resegmentation(
            x, in_segs, world,
            nb_it=cfg.get_int("nbTrainIt", 3),
            min_duration=cfg.get_int("minimumDuration", 50),
            frame_length=frame_length,
            seed=cfg.get_int("randomSeed", 0),
            map_reg=cfg.get_float("MAPRegFactorMean", 16.0))
        write_label_file(label_path(name, cfg, save=True), segs)
        out[name] = segs
        if verbose:
            print(f"[{name}] resegmented into "
                  f"{len(set(s.label for s in segs))} speakers")
    return out


def acoustic_main(cfg: Config):
    verbose = setup_verbose(cfg)
    model_names = cfg.get_str("acousticModels").split(",")
    dev = resolve_device(cfg)
    models = [GmmDiag.load(mixture_path(m.strip(), cfg), device=dev)
              for m in model_names]
    frame_length = cfg.get_float("frameLength", 0.01)
    out = {}
    for name, x, mask in _per_file(cfg):
        segs, _ = acoustic_segmentation(
            x, models, [m.strip() for m in model_names],
            min_duration=cfg.get_int("minimumDuration", 30),
            frame_length=frame_length)
        write_label_file(label_path(name, cfg, save=True), segs)
        out[name] = segs
        if verbose:
            print(f"[{name}] events: "
                  f"{sorted(set(s.label for s in segs))}")
    return out


def main(cfg: Config):
    mode = cfg.get_str("segMode", "segmentation")
    return {"turnDetection": turn_detection_main,
            "segmentation": segmentation_main,
            "resegmentation": reseg_main,
            "acousticSegmentation": acoustic_main}[mode](cfg)


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
