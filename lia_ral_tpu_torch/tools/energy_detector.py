"""EnergyDetector: energy VAD CLI → .lbl speech segments (port of
lia_ral_tpu/tools/energy_detector.py).

Equivalent of reference ``LIA_SpkDet/EnergyDetector`` (energyDetector
EnergyDetector.cpp:200-280).  The energy coefficient is selected with
``featureServerMask`` as the reference does (fixture cfg:
``featureServerMask 16``, ``vectSize 1``).  On a CUDA device the 1-D EM
runs its stats in kernel K1.
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import Config
from ..frontend.energy_vad import EnergyDetectorCfg, energy_detector
from ..io.labels import Segment, frame_idx_to_time, write_label_file
from .common import (label_path, load_features_and_mask, resolve_device,
                     resolve_list, setup_verbose)


def _select_frames_segments(speech: np.ndarray, sel_mask: np.ndarray,
                            frame_length: float, label: str) -> list[Segment]:
    """Reference selectFrames (EnergyDetector.cpp:128-168) segment
    emission, with its end-of-input-segment quirk: a speech run still open
    when the input segment ends is emitted with length end−begin+2, i.e.
    ONE FRAME PAST the last selected frame (cpp:158-163; the in-tree
    golden ``0.21 0.26`` ends at frame 26 while the label stops at 25)."""
    segs: list[Segment] = []
    sel = np.asarray(sel_mask) > 0
    n = sel.size
    i = 0
    while i < n:
        if not sel[i]:
            i += 1
            continue
        j = i
        while j < n and sel[j]:
            j += 1
        # input segment frames [i, j)
        in_run = False
        beg = 0
        for t in range(i, j):
            if speech[t] and not in_run:
                in_run, beg = True, t
            elif not speech[t] and in_run:
                in_run = False
                segs.append(Segment(frame_idx_to_time(beg, frame_length),
                                    frame_idx_to_time(t - 1, frame_length),
                                    label))
        if in_run:
            segs.append(Segment(frame_idx_to_time(beg, frame_length),
                                frame_idx_to_time(j, frame_length), label))
        i = j
    return segs


def main(cfg: Config) -> dict[str, list]:
    verbose = setup_verbose(cfg)
    dev = resolve_device(cfg)
    names = resolve_list(cfg, "inputFeatureFilename"
                         if cfg.exists("inputFeatureFilename")
                         else "inputFeatureFileName")
    ecfg = EnergyDetectorCfg.from_config(cfg)
    frame_length = cfg.get_float("frameLength", 0.01)
    label_output = cfg.get_str("labelOutputFrames", "speech")
    out: dict[str, list] = {}
    for name in names:
        fs, mask = load_features_and_mask([name], cfg)
        energy = fs.data[:, 0]     # after featureServerMask: energy only
        speech = energy_detector(energy, mask, ecfg, verbose=verbose,
                                 device=dev)
        segs = _select_frames_segments(speech, mask, frame_length,
                                       label_output)
        write_label_file(label_path(name, cfg, save=True), segs)
        out[name] = segs
        if verbose:
            print(f"[{name}] {int(speech.sum())}/{len(speech)} frames "
                  f"speech → {label_path(name, cfg, save=True)}")
    return out


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
