"""Typed errors of the port — its own copies of the reference's
``ptype_tpu/errors.py`` classes the serving path raises (the port
imports nothing from ``ptype_tpu``)."""


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
