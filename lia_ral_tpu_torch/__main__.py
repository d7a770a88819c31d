"""Umbrella CLI: ``python -m lia_ral_tpu_torch <Tool> --config file.cfg ...``
(port of lia_ral_tpu/__main__.py).

The tool names are the reference binaries' (and the JAX package's
``TOOLS``).  The port runs the GMM-UBM chain EnergyDetector → NormFeat →
TrainWorld → TrainTarget → ComputeTest → ComputeNorm and the i-vector
chain TrainWorld → TotalVariability → IvExtractor → IvTest; every other
tool prints that it is not ported yet and exits 2.  Config key ``torchDevice`` (default
``cuda``) names the device.
"""

from __future__ import annotations

import sys

# tool name → module under tools/ (None: not ported yet)
TOOLS: dict[str, str | None] = {
    "NormFeat": "norm_feat",
    "EnergyDetector": "energy_detector",
    "TrainWorld": "train_world",
    "TrainTarget": "train_target",
    "ComputeTest": "compute_test",
    "ComputeNorm": "compute_norm",
    "TotalVariability": "total_variability",
    "IvExtractor": "iv_extractor",
    "IvTest": "iv_test",
    **{name: None for name in (
        "IvNorm", "PLDA", "SpkAdapt", "ComputeJFAStats",
        "ComputeTVStats", "EigenVoice", "EigenChannel", "EstimateDMatrix",
        "AcousticSegmentation", "TurnDetection", "Segmentation",
        "ReSegmentation", "Scoring", "FusionScore", "ScoreWarp", "Hist",
        "ModelToSv", "NAPSV", "CovIntra", "ReadFeatFile", "ReadModel",
        "ExtractParams", "PolyExp", "GmmTokenizer", "BNGram", "LabelNGram",
        "SequenceDecode", "SequenceExtractor", "LabelFusion",
        "TimeCluster", "SvmTrain", "SvmPredict", "SpkDetServer")},
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        width = max(len(n) for n in TOOLS)
        print("usage: python -m lia_ral_tpu_torch <Tool> [--config FILE] "
              "[--key value ...] [--torchDevice cuda|cpu]\n\n"
              "tools (reference binary names):")
        for name, mod in sorted(TOOLS.items()):
            print(f"  {name:<{width}}  -> "
                  + (f"tools/{mod}" if mod else "not ported yet"))
        return 0
    name, rest = argv[0], argv[1:]
    if name not in TOOLS:
        print(f"unknown tool {name!r} — run with no arguments for the list",
              file=sys.stderr)
        return 2
    if TOOLS[name] is None:
        print(f"tool {name} is not ported to lia_ral_tpu_torch yet "
              "(see ROADMAP.md); the JAX package runs it: "
              f"python -m lia_ral_tpu {name}", file=sys.stderr)
        return 2
    import importlib

    from .config import Config
    mod = importlib.import_module(f".tools.{TOOLS[name]}", __package__)
    mod.main(Config.from_cli(rest))
    return 0


if __name__ == "__main__":
    sys.exit(main())
