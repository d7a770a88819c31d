"""Umbrella CLI: ``python -m lia_ral_tpu_torch <Tool> --config file.cfg ...``
(port of lia_ral_tpu/__main__.py).

The tool names are the reference binaries' (and the JAX package's
``TOOLS``); tools that share a module (EigenVoice → jfa_tools, Svm →
utils_tools, ...) get their mode key preset.  Every tool of the JAX
package runs: the GMM-UBM chain EnergyDetector → NormFeat → TrainWorld →
TrainTarget → ComputeTest → ComputeNorm, the i-vector chain TrainWorld →
TotalVariability → IvExtractor → IvNorm → PLDA → IvTest, the JFA chain
ComputeJFAStats → EigenVoice → EigenChannel → EstimateDMatrix, the
diarization chain AcousticSegmentation → TurnDetection → Segmentation →
ReSegmentation, SpkAdapt, SpkDetServer (the TCP server of ``api/server``,
config key ``port``) and the twenty LIA_Utils tools (Scoring …
SvmPredict, ``tools/utils_tools``), among them the GMM-supervector SVM
chain CovIntra → NAPSV → SvmTrain → SvmPredict.  Config key
``torchDevice`` (default ``cuda``) names the device.
"""

from __future__ import annotations

import sys

# tool name → (module under tools/, {preset config keys})
TOOLS: dict[str, tuple[str, dict[str, str]]] = {
    "NormFeat": ("norm_feat", {}),
    "EnergyDetector": ("energy_detector", {}),
    "TrainWorld": ("train_world", {}),
    "TrainTarget": ("train_target", {}),
    "ComputeTest": ("compute_test", {}),
    "ComputeNorm": ("compute_norm", {}),
    "TotalVariability": ("total_variability", {}),
    "IvExtractor": ("iv_extractor", {}),
    "IvNorm": ("iv_norm", {}),
    "IvTest": ("iv_test", {}),
    "PLDA": ("plda_tool", {}),
    "ComputeJFAStats": ("jfa_tools", {"jfaMode": "stats"}),
    "ComputeTVStats": ("jfa_tools", {"jfaMode": "stats"}),
    "EigenVoice": ("jfa_tools", {"jfaMode": "eigenVoice"}),
    "EigenChannel": ("jfa_tools", {"jfaMode": "eigenChannel"}),
    "EstimateDMatrix": ("jfa_tools", {"jfaMode": "estimateD"}),
    "SpkAdapt": ("spk_adapt", {}),
    # the JAX umbrella presets "acoustic", a key its tool does not have;
    # the port presets the tool's own key
    "AcousticSegmentation": ("spkseg_tools",
                             {"segMode": "acousticSegmentation"}),
    "TurnDetection": ("spkseg_tools", {"segMode": "turnDetection"}),
    "Segmentation": ("spkseg_tools", {"segMode": "segmentation"}),
    "ReSegmentation": ("spkseg_tools", {"segMode": "resegmentation"}),
    # LIA_Utils binaries → utils_tools modes
    "Scoring": ("utils_tools", {"utilMode": "scoring"}),
    "FusionScore": ("utils_tools", {"utilMode": "fusion"}),
    "ScoreWarp": ("utils_tools", {"utilMode": "scoreWarp"}),
    "Hist": ("utils_tools", {"utilMode": "hist"}),
    "ModelToSv": ("utils_tools", {"utilMode": "modelToSv"}),
    "NAPSV": ("utils_tools", {"utilMode": "napSv"}),
    "CovIntra": ("utils_tools", {"utilMode": "covIntra"}),
    "ReadFeatFile": ("utils_tools", {"utilMode": "readFeatFile"}),
    "ReadModel": ("utils_tools", {"utilMode": "readModel"}),
    "ExtractParams": ("utils_tools", {"utilMode": "extractParams"}),
    "PolyExp": ("utils_tools", {"utilMode": "polyExp"}),
    "GmmTokenizer": ("utils_tools", {"utilMode": "gmmTokenizer"}),
    "BNGram": ("utils_tools", {"utilMode": "bNgram"}),
    "LabelNGram": ("utils_tools", {"utilMode": "labelNgram"}),
    "SequenceDecode": ("utils_tools", {"utilMode": "sequenceDecode"}),
    "SequenceExtractor": ("utils_tools", {"utilMode": "sequenceExtract"}),
    "LabelFusion": ("utils_tools", {"utilMode": "labelFusion"}),
    "TimeCluster": ("utils_tools", {"utilMode": "timeCluster"}),
    "SvmTrain": ("utils_tools", {"utilMode": "svmTrain"}),
    "SvmPredict": ("utils_tools", {"utilMode": "svmPredict"}),
    "SpkDetServer": ("", {}),           # api/server, handled in main()
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        width = max(len(n) for n in TOOLS)
        print("usage: python -m lia_ral_tpu_torch <Tool> [--config FILE] "
              "[--key value ...] [--torchDevice cuda|cpu]\n\n"
              "tools (reference binary names):")
        for name, (mod, preset) in sorted(TOOLS.items()):
            mode = next(iter(preset.values()), "")
            target = f"tools/{mod}" if mod else "api/server"
            print(f"  {name:<{width}}  -> {target}"
                  + (f" [{mode}]" if mode else ""))
        return 0
    name, rest = argv[0], argv[1:]
    if name not in TOOLS:
        print(f"unknown tool {name!r} — run with no arguments for the list",
              file=sys.stderr)
        return 2
    import importlib

    from .config import Config
    if name == "SpkDetServer":
        from .api.server import serve_forever
        from .tools.common import resolve_device
        cfg = Config.from_cli(rest)
        serve_forever(cfg, port=cfg.get_int("port", 32114),
                      device=resolve_device(cfg))
        return 0
    mod_name, preset = TOOLS[name]
    mod = importlib.import_module(f".tools.{mod_name}", __package__)
    cfg = Config.from_cli(rest)
    for k, v in preset.items():
        if not cfg.exists(k):
            cfg[k] = v
    mod.main(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
