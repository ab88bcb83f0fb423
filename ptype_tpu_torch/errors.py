"""Typed errors of the port — its own copies of the reference's
``ptype_tpu/errors.py`` classes (the port imports nothing from
``ptype_tpu``), with the reference's Go-spelled aliases."""


class ClusterError(Exception):
    """Base class for every error raised by ptype_tpu_torch."""


class ConfigError(ClusterError):
    """Configuration file missing, unparseable, or invalid."""


class RPCError(ClusterError):
    """An actor call failed (transport or remote handler error)."""


class RemoteError(RPCError):
    """The remote handler raised; carries the remote traceback text."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback


class NoClientAvailableError(RPCError):
    """No client nodes available (ref: cluster/rpc.go:15)."""


class ShedError(RPCError):
    """The server refused admission (overload, drain, pool exhaustion).

    A typed, terminal error: callers back off ``retry_after_s`` and try
    again, or route elsewhere.
    """

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class ServerClosingError(ShedError):
    """The server is closing and refused the request before running it
    (``ActorServer.quiesce``). A shed: route elsewhere."""


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


# Reference-named aliases (Go sentinel-error spelling).
ErrNoKey = NoKeyError
ErrNoClientAvailable = NoClientAvailableError
