"""Typed errors of the port — its own copies of the reference's
``ptype_tpu/errors.py`` classes the serving path and the data plane
raise (the port imports nothing from ``ptype_tpu``)."""


class ClusterError(Exception):
    """Base class for every error raised by ptype_tpu_torch."""


class RPCError(ClusterError):
    """An actor call failed (transport or remote handler error)."""


class ShedError(RPCError):
    """The server refused admission (overload, drain, pool exhaustion).

    A typed, terminal error: callers back off ``retry_after_s`` and try
    again, or route elsewhere.
    """

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class NoKeyError(ClusterError, KeyError):
    """Key could not be found."""

    def __init__(self, key: str = ""):
        super().__init__(key)
        self.key = key

    def __str__(self) -> str:  # KeyError quotes its arg; keep a message
        return f"key could not be found: {self.key!r}"


class CoordinationError(ClusterError):
    """The coordination service is unreachable or rejected a request."""


class CheckpointError(ClusterError):
    """Checkpoint save/restore failed."""
