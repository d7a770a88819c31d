"""CLI tools of the port, run as ``python -m lia_ral_tpu_torch <Tool>``:
EnergyDetector, NormFeat, TrainWorld, TrainTarget, ComputeTest,
ComputeNorm, TotalVariability, IvExtractor and IvTest (cosine)."""
