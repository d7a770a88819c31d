"""CLI tools of the port: TrainWorld, TotalVariability, IvExtractor and
IvTest (cosine), run as ``python -m lia_ral_tpu_torch <Tool>``."""
