"""SpkDetServer: TCP server speaking the reference's binary protocol
(the port's own copy of the wire-protocol code of
lia_ral_tpu/api/server.py, bound to the torch ``SimpleSpkDetSystem``).

Wire format (reference SpkDetServer.cpp:100-116): request =
``[cmd:1B][size:4B big-endian][payload]``; responses start with a 1-byte
status (RSD_NO_ERROR=0) followed by command-specific data.  Command codes
from SpkDetServerConstants.h:16-46 (G_*/A_*/F_*/M_*/I_*).

The worker computes on ``device`` (default the CUDA card); commands from
every connection, and so every CUDA call, serialise on one lock.
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from ..config import Config
from .spkdet import SimpleSpkDetSystem

# command codes (SpkDetServerConstants.h)
G_QUIT, G_LIST, G_RESET, G_STATUS, G_SENDOPT = 0, 1, 2, 3, 4
A_RESET, A_SAVE, A_LOAD, A_SEND = 10, 11, 12, 13
F_RESET, F_SAVE, F_LOAD, F_SEND = 30, 31, 32, 33
M_RESET, M_SAVE, M_LOAD, M_WLOAD, M_DEL, M_ADAPT, M_TRAIN = \
    50, 51, 52, 53, 54, 55, 56
I_DET, I_ID, I_DETCUM, I_IDCUM, I_DETCUMR, I_IDCUMR, I_IDCUMGETLIST = \
    70, 71, 72, 73, 74, 75, 76

RSD_NO_ERROR = 0
RSD_UNDEFINED_ERROR = 1
RSD_ACCEPT = 1
RSD_REJECT = 0


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def read_command(sock: socket.socket) -> tuple[int, bytes]:
    head = _recv_exact(sock, 5)
    cmd = head[0]
    size = struct.unpack("!I", head[1:5])[0]
    data = _recv_exact(sock, size) if size else b""
    return cmd, data


def send_command(sock: socket.socket, cmd: int, payload: bytes = b"") -> None:
    sock.sendall(bytes([cmd]) + struct.pack("!I", len(payload)) + payload)


class _SendBuffer:
    """sendall-compatible response buffer (see serve_connection)."""

    def __init__(self) -> None:
        self.buf = bytearray()

    def sendall(self, data: bytes) -> None:
        self.buf += data


class SpkDetServer:
    """One server = one SimpleSpkDetSystem worker (reference SpkDetServer
    accept loop, SpkDetServer.cpp:845)."""

    def __init__(self, cfg: Config | None = None, host: str = "127.0.0.1",
                 port: int = 32114, device="cuda") -> None:
        self.cfg = cfg or Config()
        self.device = device
        self.worker = SimpleSpkDetSystem(self.cfg, device=device)
        self.host = host
        self.port = port
        self._sock: socket.socket | None = None
        self._audio = bytearray()   # raw PCM buffered across A_SEND packets
        # one worker serves every connection (the reference's model,
        # SpkDetServer.cpp:845); commands from concurrent clients
        # serialise on this lock so shared feature/speaker/audio state
        # never interleaves mid-command
        self._cmd_lock = threading.Lock()

    @staticmethod
    def _pcm_to_signal(pcm: bytes) -> np.ndarray:
        """16-bit little-endian PCM → float signal in [-1, 1]."""
        return np.frombuffer(pcm[:len(pcm) - len(pcm) % 2],
                             "<i2").astype(np.float32) / 32768.0

    # -- handlers -------------------------------------------------------------
    def _ok(self, sock, extra: bytes = b"") -> None:
        sock.sendall(bytes([RSD_NO_ERROR]) + extra)

    def _err(self, sock) -> None:
        sock.sendall(bytes([RSD_UNDEFINED_ERROR]))

    def handle(self, sock: socket.socket, cmd: int, data: bytes) -> bool:
        """Returns False when the connection should close (G_QUIT)."""
        w = self.worker
        try:
            if cmd == G_QUIT:
                self._ok(sock)
                return False
            if cmd == G_LIST:
                self._ok(sock, b"G_QUIT G_LIST G_RESET G_STATUS G_SENDOPT "
                               b"A_RESET A_SAVE A_LOAD A_SEND "
                               b"F_RESET F_SAVE F_LOAD F_SEND M_RESET M_SAVE "
                               b"M_LOAD M_WLOAD M_DEL M_ADAPT M_TRAIN I_DET "
                               b"I_ID I_DETCUM I_IDCUM I_DETCUMR I_IDCUMR "
                               b"I_IDCUMGETLIST\0")
            elif cmd == G_RESET:
                if data:
                    self.cfg = Config.load(data.decode().rstrip("\0"))
                self.worker = SimpleSpkDetSystem(self.cfg,
                                                 device=self.device)
                self._ok(sock)
            elif cmd == G_STATUS:
                txt = (f"features={w.feature_count()} "
                       f"speakers={','.join(w.speaker_ids())}\0")
                self._ok(sock, txt.encode())
            elif cmd == G_SENDOPT:
                key, _, val = data.decode().rstrip("\0").partition(" ")
                self.cfg[key] = val
                self._ok(sock)
            elif cmd == A_RESET:
                self._audio = bytearray()
                self._ok(sock)
            elif cmd == A_SAVE:
                with open(data.decode().rstrip("\0"), "wb") as f:
                    f.write(bytes(self._audio))
                self._ok(sock)
            elif cmd == A_LOAD:
                with open(data.decode().rstrip("\0"), "rb") as f:
                    pcm = f.read()
                w.add_audio(self._pcm_to_signal(pcm))
                self._audio = bytearray(pcm)
                self._ok(sock)
            elif cmd == A_SEND:
                # multi-packet raw-PCM stream; a zero-size packet ends the
                # stream and triggers parameterization (SpkDetServer.cpp:
                # 294-337: buffered to a temp file, then worker->addAudio)
                if data:
                    self._audio.extend(data)
                else:
                    w.add_audio(self._pcm_to_signal(bytes(self._audio)))
                    self._audio = bytearray()
                self._ok(sock)
            elif cmd == F_RESET:
                w.reset_features()
                self._ok(sock)
            elif cmd == F_SAVE:
                from ..io.features import write_feature_file
                write_feature_file(data.decode().rstrip("\0"), w.features)
                self._ok(sock)
            elif cmd == F_LOAD:
                w.add_feature_file(data.decode().rstrip("\0"))
                self._ok(sock)
            elif cmd == F_SEND:
                # payload: [dim:u32 BE][float32 frames...]
                dim = struct.unpack("!I", data[:4])[0]
                feats = np.frombuffer(data, "<f4", offset=4).reshape(-1, dim)
                w.add_features(feats)
                self._ok(sock)
            elif cmd == M_RESET:
                w.reset_speakers()
                self._ok(sock)
            elif cmd == M_SAVE:
                uid, _, path = data.decode().rstrip("\0").partition(" ")
                w.save_speaker_model(uid, path)
                self._ok(sock)
            elif cmd == M_LOAD:
                uid, _, path = data.decode().rstrip("\0").partition(" ")
                w.load_speaker_model(uid, path)
                self._ok(sock)
            elif cmd == M_WLOAD:
                w.load_background_model(data.decode().rstrip("\0"))
                self._ok(sock)
            elif cmd == M_DEL:
                w.remove_speaker(data.decode().rstrip("\0"))
                self._ok(sock)
            elif cmd == M_TRAIN:
                w.create_speaker_model(data.decode().rstrip("\0"))
                self._ok(sock)
            elif cmd == M_ADAPT:
                w.adapt_speaker_model(data.decode().rstrip("\0"))
                self._ok(sock)
            elif cmd in (I_DET, I_DETCUM):
                accept, score = w.verify_speaker(
                    data.decode().rstrip("\0"),
                    with_score_accumulation=(cmd == I_DETCUM))
                self._ok(sock, struct.pack("<f", score)
                         + bytes([RSD_ACCEPT if accept else RSD_REJECT]))
            elif cmd in (I_ID, I_IDCUM):
                accept, score, uid = w.identify_speaker(
                    with_score_accumulation=(cmd == I_IDCUM))
                self._ok(sock, struct.pack("<f", score)
                         + bytes([RSD_ACCEPT if accept else RSD_REJECT])
                         + uid.encode() + b"\0")
            elif cmd in (I_DETCUMR, I_IDCUMR):
                w.reset_accumulated_scores()
                self._ok(sock)
            elif cmd == I_IDCUMGETLIST:
                # cumulated identification results, best first
                # (SpkDetServerConstants.h:46; the reference declares the
                # code without a handler — wire format here:
                # [count:u32 BE] then per speaker [score:f32 LE][uid\0])
                entries = w.accumulated_scores()
                payload = struct.pack("!I", len(entries))
                for uid, score in entries:
                    payload += struct.pack("<f", score) + uid.encode() + b"\0"
                self._ok(sock, payload)
            else:
                self._err(sock)
        except Exception as e:  # reference catches and reports, keeps serving
            print(f"command {cmd} failed: {e}")
            self._err(sock)
        return True

    # -- socket loop ----------------------------------------------------------
    def serve_connection(self, sock: socket.socket) -> None:
        try:
            while True:
                cmd, data = read_command(sock)
                # handle() writes into a buffer while holding the state
                # lock; the actual socket send happens OUTSIDE it, so a
                # client that stops reading its replies cannot wedge
                # every other connection behind the lock
                out = _SendBuffer()
                with self._cmd_lock:
                    keep = self.handle(out, cmd, data)
                sock.sendall(bytes(out.buf))
                if not keep:
                    break
        except (ConnectionError, OSError):
            pass
        finally:
            sock.close()

    def start(self) -> int:
        """Bind and start accepting in a background thread; returns the
        bound port (0 → ephemeral)."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]

        def loop():
            while True:
                try:
                    conn, _ = self._sock.accept()
                except OSError:
                    return
                threading.Thread(target=self.serve_connection,
                                 args=(conn,), daemon=True).start()

        threading.Thread(target=loop, daemon=True).start()
        return self.port

    def stop(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


def serve_forever(cfg: Config, host: str = "0.0.0.0",
                  port: int = 32114, device="cuda") -> None:
    srv = SpkDetServer(cfg, host, port, device=device)
    srv.start()
    import time
    while True:
        time.sleep(3600)
