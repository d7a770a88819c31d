"""Application API layer: embeddable speaker-detection system + TCP
server/client speaking the reference's binary protocol.

Equivalents of reference ``SimpleSpkDetSystem`` (SimpleSpkDetSystem.h:
54-121) and ``RemoteSpkDet`` (SpkDetServer.cpp / RemoteSpkDetClient.cpp,
SURVEY.md §2.2/§3.5).
"""

from .spkdet import SimpleSpkDetSystem
from .server import SpkDetServer, serve_forever
from .client import RemoteSpkDetClient

__all__ = ["SimpleSpkDetSystem", "SpkDetServer", "serve_forever",
           "RemoteSpkDetClient"]
