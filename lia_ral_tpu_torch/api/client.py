"""RemoteSpkDetClient: client for the SpkDetServer binary protocol (copy
of lia_ral_tpu/api/client.py; sockets and numpy only).

Equivalent of reference ``RemoteSpkDetClient.cpp`` (1118 LoC of socket
plumbing; SURVEY.md §2.2).
"""

from __future__ import annotations

import socket
import struct

import numpy as np

from .server import (A_LOAD, A_RESET, A_SAVE, A_SEND,
                     F_LOAD, F_RESET, F_SAVE, F_SEND, G_LIST,
                     G_QUIT, G_RESET, G_SENDOPT, G_STATUS, I_DET, I_DETCUM,
                     I_DETCUMR, I_ID, I_IDCUM, I_IDCUMGETLIST,
                     M_ADAPT, M_DEL, M_LOAD,
                     M_RESET, M_SAVE, M_TRAIN, M_WLOAD, RSD_NO_ERROR,
                     _recv_exact, send_command)


class RemoteSpkDetClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 32114) -> None:
        self.sock = socket.create_connection((host, port))

    def close(self) -> None:
        try:
            send_command(self.sock, G_QUIT)
            self._status()
        finally:
            self.sock.close()

    def _status(self) -> None:
        cc = _recv_exact(self.sock, 1)[0]
        if cc != RSD_NO_ERROR:
            raise RuntimeError(f"server error (code {cc})")

    def _read_cstring(self) -> str:
        out = b""
        while True:
            c = _recv_exact(self.sock, 1)
            if c == b"\0":
                return out.decode()
            out += c

    # -- general ----------------------------------------------------------
    def list_commands(self) -> str:
        send_command(self.sock, G_LIST)
        self._status()
        return self._read_cstring()

    def status(self) -> str:
        send_command(self.sock, G_STATUS)
        self._status()
        return self._read_cstring()

    def reset(self, config_path: str | None = None) -> None:
        send_command(self.sock, G_RESET,
                     (config_path + "\0").encode() if config_path else b"")
        self._status()

    def send_option(self, key: str, value: str) -> None:
        send_command(self.sock, G_SENDOPT, f"{key} {value}\0".encode())
        self._status()

    # -- audio (A_*: raw PCM parameterized server-side) ----------------------
    def reset_audio(self) -> None:
        send_command(self.sock, A_RESET)
        self._status()

    def send_audio(self, signal: np.ndarray, chunk_frames: int = 8192
                   ) -> None:
        """Stream a float [-1,1] signal as 16-bit PCM packets; a zero-size
        packet ends the stream and triggers MFCC parameterization
        (reference A_Send multi-packet protocol, SpkDetServer.cpp:294)."""
        pcm = (np.clip(np.asarray(signal), -1.0, 1.0)
               * 32767.0).astype("<i2").tobytes()
        step = chunk_frames * 2
        for off in range(0, len(pcm), step):
            send_command(self.sock, A_SEND, pcm[off:off + step])
            self._status()
        send_command(self.sock, A_SEND)
        self._status()

    def save_audio(self, path: str) -> None:
        send_command(self.sock, A_SAVE, (path + "\0").encode())
        self._status()

    def load_audio_file(self, path: str) -> None:
        send_command(self.sock, A_LOAD, (path + "\0").encode())
        self._status()

    # -- features ----------------------------------------------------------
    def reset_features(self) -> None:
        send_command(self.sock, F_RESET)
        self._status()

    def send_features(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, np.float32)
        payload = struct.pack("!I", feats.shape[1]) + feats.tobytes()
        send_command(self.sock, F_SEND, payload)
        self._status()

    def load_feature_file(self, path: str) -> None:
        send_command(self.sock, F_LOAD, (path + "\0").encode())
        self._status()

    def save_features(self, path: str) -> None:
        send_command(self.sock, F_SAVE, (path + "\0").encode())
        self._status()

    # -- models ------------------------------------------------------------
    def load_world(self, path: str) -> None:
        send_command(self.sock, M_WLOAD, (path + "\0").encode())
        self._status()

    def train_speaker(self, uid: str) -> None:
        send_command(self.sock, M_TRAIN, (uid + "\0").encode())
        self._status()

    def adapt_speaker(self, uid: str) -> None:
        send_command(self.sock, M_ADAPT, (uid + "\0").encode())
        self._status()

    def save_speaker(self, uid: str, path: str) -> None:
        send_command(self.sock, M_SAVE, f"{uid} {path}\0".encode())
        self._status()

    def load_speaker(self, uid: str, path: str) -> None:
        send_command(self.sock, M_LOAD, f"{uid} {path}\0".encode())
        self._status()

    def delete_speaker(self, uid: str) -> None:
        send_command(self.sock, M_DEL, (uid + "\0").encode())
        self._status()

    def reset_speakers(self) -> None:
        send_command(self.sock, M_RESET)
        self._status()

    # -- recognition ---------------------------------------------------------
    def verify(self, uid: str, cumulative: bool = False
               ) -> tuple[bool, float]:
        send_command(self.sock, I_DETCUM if cumulative else I_DET,
                     (uid + "\0").encode())
        self._status()
        score = struct.unpack("<f", _recv_exact(self.sock, 4))[0]
        decision = _recv_exact(self.sock, 1)[0]
        return decision == 1, score

    def identify(self, cumulative: bool = False
                 ) -> tuple[bool, float, str]:
        send_command(self.sock, I_IDCUM if cumulative else I_ID)
        self._status()
        score = struct.unpack("<f", _recv_exact(self.sock, 4))[0]
        decision = _recv_exact(self.sock, 1)[0]
        uid = self._read_cstring()
        return decision == 1, score, uid

    def reset_accumulated_scores(self) -> None:
        send_command(self.sock, I_DETCUMR)
        self._status()

    def cumulated_results(self) -> list[tuple[str, float]]:
        """I_IDCUMGETLIST: per-speaker cumulated identification scores,
        best first (SpkDetServerConstants.h:46)."""
        send_command(self.sock, I_IDCUMGETLIST)
        self._status()
        count = struct.unpack("!I", _recv_exact(self.sock, 4))[0]
        out = []
        for _ in range(count):
            score = struct.unpack("<f", _recv_exact(self.sock, 4))[0]
            out.append((self._read_cstring(), score))
        return out
