"""Serving: the continuous-batching engine and the engine side of the serve
transport (file spool and shared-memory ring), in the JAX package's formats.
The router and its SLOs run in the supervisor (JAX package) and are not part
of the port."""

from .engine import Request, RequestResult, ServingEngine
from .shmring import EngineTransport, ShmRing
from .spool import Spool

__all__ = [
    "EngineTransport",
    "Request",
    "RequestResult",
    "ServingEngine",
    "ShmRing",
    "Spool",
]
