"""Error types of the port: copies of the ones the search, storage and
generation slices raise or catch (``nornicdb_tpu/errors.py``), kept here so
the port imports nothing of the JAX package."""


class NornicError(Exception):
    """Base class for all framework errors."""


class NotFoundError(NornicError):
    """Entity (node/edge/database/index) does not exist. GraphRAG's graph
    expansion skips a hit whose node is gone."""


class AlreadyExistsError(NornicError):
    """Entity with this id already exists (``MemoryEngine.create_node`` /
    ``create_edge``)."""


class ResourceExhausted(NornicError):
    """Serving admission control shed this request (queue full or deadline
    passed). Clients should back off and retry. Raised by the bounded
    QueryBatcher."""

    def __init__(self, message: str, reason: str = "queue_full"):
        super().__init__(message)
        self.reason = reason  # queue_full | deadline


class ClosedError(NornicError):
    """Operation on a closed engine (the generation engine raises it on
    stop)."""


class DeviceUnavailable(NornicError):
    """The accelerator is not available. The port never falls back to the
    CPU on its own: a caller that wants the CPU passes ``device="cpu"``."""
