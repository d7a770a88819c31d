"""Audio-to-decision record of the PyTorch port: waveform in, verify
decision out.

The counterpart of scripts/milestone_audio.py for lia_ral_tpu_torch, which
imports torch, numpy and the port only.  It drives the serving path of
``lia_ral_tpu_torch.api`` (the reference SimpleSpkDetSystem.cpp flow:
parameterizeAudio 470 → energy VAD + CMVN normalizeFeatures 392 →
adaptSpeakerModel 901 → verifySpeaker 975), then one verify through
``SpkDetServer`` / ``RemoteSpkDetClient`` on a localhost port (the
SpkDetServer.cpp:845 wire protocol), on the card unless ``--device cpu``,
and records:

  * EER/minDCF over target and impostor verify trials,
  * p50/p95 verify latency per audio length (1/3/5/10 s; host clock
    around ``verify_speaker``, which returns a score on the host),
  * one TCP round-trip verify (its wall and score).

Synthetic voices (the JAX driver's generator, copied: the same draws in
the same order): each speaker is an inventory of phonemes, each phoneme
coloured noise shaped by three formant bumps; an utterance is a sequence
of 60-200 ms phonemes with a session spectral tilt, gated into bursts
with near-silent pauses.  The UBM (K=128) starts from a numpy-made init
(``--seed``) and trains through ``gmm.em.train_model``.

Usage: python scripts/torch_milestone_audio.py [--device cuda|cpu]
           [--seed N] [--out FILE]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from torch_milestone_eer import (Stages, check_device, common_args,
                                 device_line, emit, init_gmm, launches,
                                 reset_launches, warm_up)

SR = 8000.0
N_SPK = 10
N_IMP = 5
ENROLL_S = 6.0
TEST_LENS = [1.0, 3.0, 5.0, 10.0]
TESTS_PER_LEN = 2          # per target speaker per length
K_UBM = 128


def voice(rng, phonemes, tilt, seconds):
    """Speech-like synthetic voice: a sequence of 60-200 ms 'phoneme'
    segments, each coloured noise shaped by that phoneme's formant
    bumps, with a session spectral tilt, amplitude-modulated into
    bursts with near-silent pauses (so the energy VAD has real work).

    Non-stationarity matters: the serving path applies 0/1 CMVN, which
    deletes the per-utterance MFCC mean and scale; a speaker-specific
    phoneme inventory puts identity in the multimodal frame distribution,
    which CMVN keeps."""
    n = int(seconds * SR)
    sig = np.zeros(n, np.float32)
    t = 0
    while t < n:
        seg = int(rng.uniform(0.06, 0.2) * SR)
        seg = min(seg, n - t)
        formants = phonemes[rng.integers(len(phonemes))]
        spec = np.fft.rfft(rng.standard_normal(seg))
        f = np.fft.rfftfreq(seg, 1.0 / SR)
        env = 0.05 + sum(np.exp(-0.5 * ((f - f0) / bw) ** 2)
                         for f0, bw in formants)
        env = env * np.exp(tilt * (f / (SR / 2)))
        sig[t:t + seg] = np.fft.irfft(spec * env, seg)
        t += seg
    sig = sig / (np.abs(sig).max() + 1e-9) * 0.5
    # burst envelope: ~0.3-0.8 s speech, ~0.1-0.3 s pause (20 dB down)
    gate = np.full(n, 0.1, np.float32)
    t = 0
    while t < n:
        on = int(rng.uniform(0.3, 0.8) * SR)
        gate[t:t + on] = 1.0
        t += on + int(rng.uniform(0.1, 0.3) * SR)
    return (sig * gate).astype(np.float32)


def gen_speakers(rng, n=N_SPK + N_IMP):
    """Each speaker: an inventory of 6 phoneme formant sets (3 formants
    of (centre Hz, bandwidth Hz))."""
    def spk_formants():
        return [(rng.uniform(250, 900), rng.uniform(80, 160)),
                (rng.uniform(900, 2200), rng.uniform(120, 260)),
                (rng.uniform(2200, 3600), rng.uniform(180, 400))]

    return [[spk_formants() for _ in range(6)] for _ in range(n)]


def run(workdir: str, device: str = "cuda", seed: int = 0) -> dict:
    """Enrolment, verify trials and one TCP verify; returns the record."""
    from lia_ral_tpu_torch.api import (RemoteSpkDetClient,
                                       SimpleSpkDetSystem, SpkDetServer)
    from lia_ral_tpu_torch.backend.eval import eer, min_dcf
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.gmm.em import TrainCfg, train_model

    dev = check_device(device)
    os.makedirs(workdir, exist_ok=True)
    stage = Stages(dev)
    with stage("device_warmup"):
        warm_up(dev)
    reset_launches()
    rng = np.random.default_rng(20260822)
    speakers = gen_speakers(rng)

    def utt(spk, seconds):
        return voice(rng, speakers[spk], rng.uniform(-1.0, 1.0), seconds)

    sysm = SimpleSpkDetSystem(Config(), sample_rate=SR, device=device)
    # UBM from ~60 s of audio across all speakers, through add_audio
    with stage("ubm"):
        for s in range(N_SPK + N_IMP):
            sysm.add_audio(utt(s, 4.0))
        sysm.normalize_features(energy_column=19)
        x = sysm.features
        tcfg = TrainCfg(nb_train_it=4, bagged_frame_probability=1.0,
                        bagged_frame_probability_init=1.0)
        ubm = train_model(torch.Generator(device=dev).manual_seed(1),
                          torch.as_tensor(x, device=dev),
                          torch.ones(x.shape[0], device=dev),
                          init_gmm(x, K_UBM, seed).to(dev), tcfg)
        sysm.set_background_model(ubm)
        sysm.reset_features()

    # enrol targets and impostor models through the serving API
    with stage("enroll"):
        for s in range(N_SPK + N_IMP):
            sysm.add_audio(utt(s, ENROLL_S))
            sysm.normalize_features(energy_column=19)
            sysm.create_speaker_model(f"spk{s}")
            sysm.reset_features()

    # verify trials: per length, each target speaker against its own and
    # 3 impostor models; latency measured around verify_speaker only
    lat: dict[float, list[float]] = {L: [] for L in TEST_LENS}
    tgt, imp = [], []
    with stage("verify"):
        for L in TEST_LENS:
            for s in range(N_SPK):
                for _ in range(TESTS_PER_LEN):
                    sysm.add_audio(utt(s, L))
                    sysm.normalize_features(energy_column=19)
                    for uid in [f"spk{s}"] + [
                            f"spk{N_SPK + j}" for j in
                            rng.choice(N_IMP, 3, replace=False)]:
                        t0 = time.perf_counter()
                        _, score = sysm.verify_speaker(uid)
                        lat[L].append(time.perf_counter() - t0)
                        (tgt if uid == f"spk{s}" else imp).append(score)
                    sysm.reset_features()
    tgt_a, imp_a = np.asarray(tgt), np.asarray(imp)
    res = {"audio_eer": float(eer(tgt_a, imp_a)),
           "audio_mindcf": float(min_dcf(tgt_a, imp_a)),
           "n_target_trials": int(tgt_a.size),
           "n_impostor_trials": int(imp_a.size),
           "tgt_mean": float(tgt_a.mean()), "imp_mean": float(imp_a.mean()),
           "finite": bool(np.isfinite(np.concatenate([tgt_a, imp_a])).all())}
    lat_table = {}
    for L in TEST_LENS:
        a = np.asarray(lat[L]) * 1000.0
        lat_table[f"{L:g}s"] = {"p50_ms": float(np.percentile(a, 50)),
                                "p95_ms": float(np.percentile(a, 95))}
    p50s = [lat_table[f"{L:g}s"]["p50_ms"] for L in TEST_LENS]
    res["latency_flat_ratio"] = max(p50s) / max(min(p50s), 1e-9)

    # one TCP round trip: load the UBM and a model, stream audio, verify
    ubm_path = os.path.join(workdir, "wld.gmm")
    ubm.save(ubm_path)
    spk_path = os.path.join(workdir, "spk0.gmm")
    sysm.save_speaker_model("spk0", spk_path)
    with stage("tcp"):
        srv = SpkDetServer(Config(), port=0, device=device)
        port = srv.start()
        try:
            cli = RemoteSpkDetClient(port=port)
            try:
                cli.load_world(ubm_path)
                cli.load_speaker("spk0", spk_path)
                sig = utt(0, 3.0)
                t0 = time.perf_counter()
                cli.send_audio(sig)
                _, score = cli.verify("spk0")
                res["tcp_verify_wall_ms"] = (time.perf_counter() - t0) * 1e3
            finally:
                cli.close()
        finally:
            srv.stop()
    res["tcp_verify_score"] = float(score)
    res["tcp_verify_accept"] = bool(score > 0)
    return {
        "milestone": "audio-to-decision serving (waveform -> MFCC -> VAD "
                     "-> CMVN -> enroll/verify)",
        "device": device_line(dev),
        "shapes": {"sample_rate": SR, "K": K_UBM, "n_targets": N_SPK,
                   "enroll_s": ENROLL_S, "test_lens_s": TEST_LENS},
        "seed": seed,
        "results": res,
        "verify_latency_ms": lat_table,
        "stage_wall_s": stage.walls,
        "total_wall_s": sum(stage.walls.values()),
        "launches": launches(),
    }


def main():
    ap = argparse.ArgumentParser()
    common_args(ap)
    args = ap.parse_args()
    check_device(args.device)
    emit(run(tempfile.mkdtemp(prefix="torch_milestone_audio_"), args.device,
             args.seed), args.out)


if __name__ == "__main__":
    main()
