"""SimpleSpkDetSystem: embeddable speaker verification/identification API
(port of lia_ral_tpu/api/spkdet.py).

Equivalent of reference ``LIA_SpkDet/SimpleSpkDetSystem``
(SimpleSpkDetSystem.h:54-121, .cpp): audio/feature ingestion (MFCC
parameterisation replaces SPro, cpp:470), energy-VAD + CMVN
normalizeFeatures (cpp:392), UBM load, createSpeakerModel/
adaptSpeakerModel (cpp:948/901), verifySpeaker (cpp:975: top-10 LLR with
optional running score accumulation cpp:1075-1100), identifySpeaker
(cpp:1021: argmax over loaded speakers).

The system computes on one device (``device``, default the CUDA card;
without a card that raises, and ``device="cpu"`` asks for the CPU).  The
feature buffer stays numpy on the host; each request moves its padded
block to the device.  Models live on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..frontend.energy_vad import EnergyDetectorCfg, energy_detector
from ..frontend.mfcc import MfccCfg, add_deltas, mfcc
from ..frontend.normfeat import cmvn_global
from ..gmm.map_adapt import MapCfg, adapt_model
from ..gmm.model import GmmDiag
from ..gmm.scoring import compute_test_llr, stack_gmms


@dataclasses.dataclass
class _AccumScore:
    score: float = 0.0
    frame_count: float = 0.0


class SimpleSpkDetSystem:
    def __init__(self, cfg: Config | None = None,
                 sample_rate: float = 8000.0, device="cuda") -> None:
        self.cfg = cfg or Config()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SimpleSpkDetSystem: device {self.device} asked for, but "
                "torch sees no CUDA device; pass device='cpu' to run on "
                "the CPU")
        self.mfcc_cfg = MfccCfg(sample_rate=sample_rate)
        self.ubm: GmmDiag | None = None
        self.speakers: dict[str, GmmDiag] = {}
        self.features: np.ndarray = np.zeros((0, 0), np.float32)
        self.threshold = self.cfg.get_float("decisionThreshold", 0.0)
        self.top_k = self.cfg.get_int("topDistribsCount", 10)
        self._accum: dict[str, _AccumScore] = {}
        self._seed = 0

    # -- feature/audio ingestion ---------------------------------------------
    def add_audio(self, signal: np.ndarray) -> None:
        """parameterizeAudio (cpp:470): MFCC + deltas from raw samples."""
        sig = torch.as_tensor(np.asarray(signal, np.float32),
                              device=self.device)
        self.add_features(add_deltas(mfcc(sig, self.mfcc_cfg)).cpu().numpy())

    def add_features(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, np.float32)
        if self.features.size == 0:
            self.features = feats
        else:
            self.features = np.concatenate([self.features, feats])

    def add_feature_file(self, path: str, fmt: str = "SPRO4") -> None:
        from ..io.features import read_feature_file
        self.add_features(read_feature_file(path, fmt=fmt).data)

    def reset_features(self) -> None:
        self.features = np.zeros((0, 0), np.float32)

    def feature_count(self) -> int:
        return self.features.shape[0]

    def normalize_features(self, energy_column: int | None = None) -> None:
        """Energy VAD + CMVN (reference normalizeFeatures, cpp:392):
        select speech frames on the energy coefficient, then 0/1-normalise
        and keep only the selected frames."""
        if self.features.size == 0:
            return
        x = self.features
        if energy_column is not None:
            speech = energy_detector(
                x[:, energy_column], np.ones(x.shape[0], np.float32),
                EnergyDetectorCfg(nb_train_it=8,
                                  mixture_distrib_count=3),
                device=self.device)
        else:
            speech = np.ones(x.shape[0], bool)
        w = torch.as_tensor(speech.astype(np.float32), device=self.device)
        normed = cmvn_global(torch.as_tensor(x, device=self.device),
                             w).cpu().numpy()
        self.features = normed[speech]

    # -- models ---------------------------------------------------------------
    def load_background_model(self, path: str) -> None:
        self.ubm = GmmDiag.load(path, device=self.device)

    def set_background_model(self, gmm: GmmDiag) -> None:
        self.ubm = gmm.to(self.device)

    def save_speaker_model(self, uid: str, path: str) -> None:
        self.speakers[uid].save(path, model_id=uid)

    def load_speaker_model(self, uid: str, path: str) -> None:
        self.speakers[uid] = GmmDiag.load(path, device=self.device)

    def remove_speaker(self, uid: str) -> None:
        self.speakers.pop(uid, None)
        self._accum.pop(uid, None)

    def reset_speakers(self) -> None:
        self.speakers.clear()
        self._accum.clear()

    def speaker_ids(self) -> list[str]:
        return list(self.speakers.keys())

    def _padded_features(self):
        """(x, w) on the device, with the frame axis padded to the serving
        bucket (zero weights on padding — exact for stats/LLR; the JAX
        package pads for one compiled executable per bucket, the port
        keeps the same shapes)."""
        from ..tools.compute_test import _pad_frames
        x_np, w_np, _ = _pad_frames(np.asarray(self.features, np.float32))
        return (torch.as_tensor(x_np, device=self.device),
                torch.as_tensor(w_np, device=self.device))

    def _generator(self) -> torch.Generator:
        self._seed += 1
        g = torch.Generator(device=self.device)
        g.manual_seed(self._seed)
        return g

    def create_speaker_model(self, uid: str) -> None:
        """createSpeakerModel (cpp:948): MAP-adapt the UBM on the features
        in memory."""
        assert self.ubm is not None, "UBM not loaded"
        assert self.feature_count() > 0, "no features in memory"
        mcfg = MapCfg.from_config(self.cfg) if self.cfg.exists("MAPAlgo") \
            else MapCfg(method="MAPOccDep", mean_adapt=True, mean_r=14.0,
                        nb_train_it=3)
        x, w = self._padded_features()
        self.speakers[uid] = adapt_model(self._generator(), x, w, self.ubm,
                                         mcfg)

    def adapt_speaker_model(self, uid: str) -> None:
        """adaptSpeakerModel (cpp:901): further MAP passes from the
        existing speaker model."""
        assert uid in self.speakers, f"unknown speaker {uid}"
        mcfg = MapCfg(method="MAPOccDep", mean_adapt=True, mean_r=14.0,
                      nb_train_it=2)
        x, w = self._padded_features()
        self.speakers[uid] = adapt_model(self._generator(), x, w,
                                         self.speakers[uid], mcfg)

    # -- recognition ----------------------------------------------------------
    def _llr(self, uids: list[str]) -> np.ndarray:
        """Serving-shape discipline of the JAX package, kept: the audio
        length and speaker count vary per request, so frames are padded
        to buckets and the client axis to a power of two (zero-weight
        rows / discarded scores — exact, tools/compute_test.py
        contract)."""
        # explicit errors (not asserts): these are reachable through the
        # wire protocol — e.g. two clients interleaving reset/send/verify
        # on the server's single shared feature buffer (the reference's
        # one-session semantics, SpkDetServer.cpp:845) — and the message
        # travels back in the error reply
        if self.ubm is None:
            raise ValueError("no background model loaded")
        if self.feature_count() == 0:
            raise ValueError("feature buffer is empty (reset by a "
                             "concurrent session?) — the wire protocol is "
                             "single-session; scale out via the API")
        from ..tools.compute_test import _pad_clients, _pad_frames
        x_np, w_np, g_np = _pad_frames(
            np.asarray(self.features, np.float32))
        clients, c_real = _pad_clients([self.speakers[u] for u in uids])
        dev = self.device
        llr = compute_test_llr(
            torch.as_tensor(x_np, device=dev),
            torch.as_tensor(w_np, device=dev), self.ubm,
            stack_gmms(clients), groups=torch.as_tensor(g_np, device=dev),
            top_k=min(self.top_k, self.ubm.n_components))
        return llr.cpu().numpy()[:c_real]

    def _accumulate(self, uid: str, score: float) -> float:
        """Running frame-weighted score average (cpp:1075-1100)."""
        acc = self._accum.setdefault(uid, _AccumScore())
        n = float(self.feature_count())
        ratio = n / (n + acc.frame_count) if (n + acc.frame_count) > 0 else 1.0
        acc.score = ratio * score + (1.0 - ratio) * acc.score
        acc.frame_count += n
        return acc.score

    def reset_accumulated_scores(self) -> None:
        self._accum.clear()

    def accumulated_scores(self) -> list[tuple[str, float]]:
        """Snapshot of the per-speaker cumulated scores built up by the
        I_DETCUM/I_IDCUM commands (SpkDetServerConstants.h:46
        I_IDCUMGETLIST), ordered by descending score."""
        return sorted(((u, a.score) for u, a in self._accum.items()),
                      key=lambda t: -t[1])

    def verify_speaker(self, uid: str, with_score_accumulation: bool = False
                       ) -> tuple[bool, float]:
        """verifySpeaker (cpp:975) → (decision, LLR score)."""
        if uid not in self.speakers:
            raise KeyError(f"Mixture not found: {uid}")
        score = float(self._llr([uid])[0])
        if with_score_accumulation:
            score = self._accumulate(uid, score)
        return score > self.threshold, score

    def identify_speaker(self, with_score_accumulation: bool = False
                         ) -> tuple[bool, float, str]:
        """identifySpeaker (cpp:1021) → (decision, best score, best uid)."""
        uids = self.speaker_ids()
        if not uids:
            raise KeyError("no speaker models loaded")
        scores = self._llr(uids)
        if with_score_accumulation:
            scores = np.asarray([self._accumulate(u, float(s))
                                 for u, s in zip(uids, scores)])
        best = int(np.argmax(scores))
        score = float(scores[best])
        return score > self.threshold, score, uids[best]
