"""IvNorm: i-vector normalisation CLI (EFR/sphNorm + LDA; port of
lia_ral_tpu/tools/iv_norm.py).

Equivalent of reference ``LIA_SpkDet/IvNorm`` (IvNorm.cpp:72-130):
estimate EFR/sphNorm iterations (and optionally LDA) on a dev set of
i-vectors, save the per-iteration means and matrices, apply them to the
listed vectors and save the normalised per-file vectors.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..backend.ivnorm import DevSet, apply_efr, compute_lda, efr_iterations
from ..config import Config
from ..io.lists import read_ndx
from ..io.matrix import read_matrix_file, write_matrix_file
from .common import resolve_device, setup_verbose
from .total_variability import matrix_out_path


def load_vectors(names: list[str], cfg: Config) -> np.ndarray:
    """(len(names), R) float32 vectors from the per-session .matx files
    IvExtractor writes (loadVectorFilesPath, vectorFilesExtension)."""
    root = cfg.get_str("loadVectorFilesPath",
                       cfg.get_str("saveVectorFilesPath", "./"))
    ext = cfg.get_str("vectorFilesExtension", ".y")
    rows = [read_matrix_file(os.path.join(root, n + ext)).ravel()
            for n in names]
    return np.stack(rows).astype(np.float32)


def save_vectors(names: list[str], vecs: np.ndarray, cfg: Config) -> None:
    root = cfg.get_str("saveVectorFilesPath", "./")
    ext = cfg.get_str("vectorFilesExtension", ".y")
    for n, v in zip(names, vecs):
        write_matrix_file(os.path.join(root, n + ext),
                          np.asarray(v, np.float64)[None, :])


def load_dev_set(cfg: Config, device) -> tuple[DevSet, list[str]]:
    """The dev set of ``backgroundNdxFilename`` (lines "speaker file1
    file2 ...", a line without files naming its own vector) on
    ``device``, and its per-vector speaker labels."""
    names, labels = [], []
    for spk, files in read_ndx(cfg.get_str("backgroundNdxFilename")):
        for f in (files if files else [spk]):
            names.append(f)
            labels.append(spk)
    return (DevSet.from_labels(load_vectors(names, cfg), labels,
                               device=device), labels)


def efr_param_paths(cfg: Config, it: int, path_fn) -> tuple[str, str]:
    """(matrix file, mean file) of EFR iteration ``it`` under the
    reference's names <mode>_<base><it>; ``path_fn(name, cfg)`` maps a
    name to a path."""
    mode = cfg.get_str("ivNormEfrMode", "EFR")
    mat_base = cfg.get_str("ivNormEfrMatrixBaseName", "ivNormEfrMatrix_it")
    mean_base = cfg.get_str("ivNormEfrMeanBaseName", "ivNormEfrMean_it")
    return (path_fn(f"{mode}_{mat_base}{it}", cfg),
            path_fn(f"{mode}_{mean_base}{it}", cfg))


def save_efr_params(params, cfg: Config) -> None:
    """The per-iteration transforms, as the reference saves them during
    estimation (PldaDev::sphericalNuisanceNormalization)."""
    for it, (mean, m) in enumerate(params):
        mat_path, mean_path = efr_param_paths(cfg, it, matrix_out_path)
        write_matrix_file(mat_path, m.cpu().numpy().astype(np.float64))
        write_matrix_file(mean_path,
                          mean.cpu().numpy().astype(np.float64)[None, :])


def main(cfg: Config) -> dict[str, np.ndarray]:
    verbose = setup_verbose(cfg)
    device = resolve_device(cfg)
    dev, labels = load_dev_set(cfg, device)
    n_it = cfg.get_int("ivNormIterationNb", 1)
    mode = cfg.get_str("ivNormEfrMode", "EFR")
    normed_dev, params = efr_iterations(dev, n_it, mode)
    save_efr_params(params, cfg)
    if cfg.exists("LDA") and cfg.get_bool("LDA", False):
        proj = compute_lda(DevSet.from_labels(normed_dev, labels),
                           cfg.get_int("ldaRank"))
        write_matrix_file(matrix_out_path(
            cfg.get_str("ldaMatrix", "ldaMatrix"), cfg),
            proj.cpu().numpy().astype(np.float64))
    out: dict[str, np.ndarray] = {}
    if cfg.exists("inputVectorFilename"):
        test_lines = read_ndx(cfg.get_str("inputVectorFilename"))
        test_names = list(dict.fromkeys(
            n for name, fs in test_lines for n in (fs if fs else [name])))
        vecs = torch.as_tensor(load_vectors(test_names, cfg), device=device)
        normed = apply_efr(vecs, params).cpu().numpy()
        save_vectors(test_names, normed, cfg)
        out = dict(zip(test_names, normed))
        if verbose:
            print(f"normalised {len(test_names)} vectors ({mode}, {n_it} it)")
    return out


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
