"""One of N coordinated processes of the port's multi-process runtime
(tests/test_torch_multihost.py on the CPU; chip_smoke.py phase 14 on one
card, two ranks sharing it).

Usage: python _torch_multihost_worker.py <host:port> <num_procs> <pid>
           <outdir> <cpu|cuda>

Reads ``<outdir>/problems.npz`` (the corpus and GMM of the EM stats, and
the PLDA, TV, JFA and extraction problems), joins the gloo group, builds
the global mesh (two CPU shards a process, or one shard of ``cuda:0``),
and writes what it computed as ``<name>_<pid>.npz``: every rank writes
its own copy of each replicated or gathered result, so a test can check
that the ranks agree.  Imports torch and the port only.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

from lia_ral_tpu_torch import convert
from lia_ral_tpu_torch.gmm import cuda_kernels
from lia_ral_tpu_torch.gmm.em import default_stats_fn
from lia_ral_tpu_torch.parallel.distributed import (global_stats,
                                                    host_local_batch,
                                                    initialize_from_env,
                                                    make_global_mesh,
                                                    shard_file_list)
from lia_ral_tpu_torch.parallel.sharding import (sharded_estimate_w,
                                                 sharded_jfa_v_iteration,
                                                 sharded_plda_em_iteration,
                                                 sharded_tv_e_step)


def main():
    coord, nproc, pid, outdir, kind = (sys.argv[1], int(sys.argv[2]),
                                       int(sys.argv[3]), sys.argv[4],
                                       sys.argv[5])
    torch.set_num_threads(2)
    assert initialize_from_env(coord, nproc, pid)
    p = dict(np.load(os.path.join(outdir, "problems.npz")))
    dev = torch.device("cuda", 0) if kind == "cuda" else torch.device("cpu")
    local = [dev] if kind == "cuda" else [dev, dev]

    def save(name, **arrays):
        np.savez(os.path.join(outdir, f"{name}_{pid}.npz"),
                 **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
                    for k, v in arrays.items()})

    # EM stats: each process holds a contiguous block of the frames (as
    # shard_file_list would give it files) and sums with the others
    x, w = p["x"], p["w"]
    per = x.shape[0] // nproc
    gmm = convert.gmm_from_numpy(p["gmm_w"], p["gmm_m"], p["gmm_ci"], dev)
    mesh = make_global_mesh(devices=local)
    gx, gw = host_local_batch(mesh, torch.from_numpy(x[pid * per:
                                                       (pid + 1) * per]),
                              torch.from_numpy(w[pid * per:(pid + 1) * per]))
    cuda_kernels.reset_launch_counts()
    stats = global_stats(mesh, default_stats_fn(), gx, gw, gmm)
    launches = dict(cuda_kernels.launch_counts)
    save("stats", **convert.to_numpy(stats))
    names = shard_file_list([f"f{i}" for i in range(10)])
    with open(os.path.join(outdir, f"names_{pid}.json"), "w") as f:
        json.dump({"names": names, "launches": launches,
                   "mesh": mesh.shape, "local": len(mesh.local_keys())}, f)

    # PLDA EM: the session axis over the global mesh, plda_em_core's
    # cross-session sums through the gloo group
    dev_set = convert.dev_set_from_numpy(p["plda_x"], p["plda_ids"],
                                         int(p["plda_n_spk"]), dev)
    plda = convert.plda_from_numpy(p["plda_mean"], p["plda_f"], p["plda_g"],
                                   p["plda_sigma"], dev)
    save("plda", **convert.to_numpy(
        sharded_plda_em_iteration(mesh, plda, dev_set)))
    # TV E-step: speakers over the global mesh
    tv_stats = convert.bw_stats_from_numpy(p["tv_n"], p["tv_f"], dev)
    tv_model = convert.tv_from_numpy(p["tv_t"], p["tv_means"], p["tv_iv"],
                                     dev)
    w_tv, acc = sharded_tv_e_step(mesh, tv_stats, tv_model, chunk=2)
    save("tv", w=w_tv, **convert.to_numpy(acc))
    # JFA V iteration: speakers over the global mesh
    jstats = convert.jfa_stats_from_numpy(p["jfa_n"], p["jfa_f"],
                                          p["jfa_spk"], int(p["jfa_n_spk"]),
                                          dev)
    jmodel = convert.jfa_from_numpy(p["jfa_v"], p["jfa_u"], p["jfa_d"],
                                    p["jfa_means"], p["jfa_iv"], dev)
    new, y = sharded_jfa_v_iteration(mesh, jstats, jmodel,
                                     torch.from_numpy(p["jfa_x"]).to(dev),
                                     torch.from_numpy(p["jfa_z"]).to(dev))
    save("jfa", v=new.v, y=y)
    # i-vector extraction: utterances over the global mesh, no collective
    save("w_iv", w=sharded_estimate_w(mesh, tv_stats, tv_model, chunk=2,
                                      pcg_iters=12,
                                      pcg_tol=float(p["pcg_tol"])))
    print(f"proc {pid}: ok", flush=True)


if __name__ == "__main__":
    main()
