"""Error types of the port: copies of the ones the search, storage,
generation and training slices raise or catch (``nornicdb_tpu/errors.py``),
kept here so the port imports nothing of the JAX package."""


class NornicError(Exception):
    """Base class for all framework errors."""


class NotFoundError(NornicError):
    """Entity (node/edge/database/index) does not exist. GraphRAG's graph
    expansion skips a hit whose node is gone."""


class AlreadyExistsError(NornicError):
    """Entity already exists (duplicate id, unique-constraint violation)."""


class ConstraintViolationError(NornicError):
    """Schema constraint violated."""


class WALCorruptionError(NornicError):
    """WAL record failed CRC / magic validation."""


class DurabilityError(NornicError):
    """A WAL append could not be made durable (write/fsync failure, torn
    tail, ENOSPC).  The write was NOT acked and the log tail was repaired
    back to its last good record, so the WAL stays replayable.  Protocol
    layers surface this as a transient, retryable storage error; clients
    back off and retry.  Raised by ``WAL.append`` — real disk errors and
    the deterministic injector in ``storage/faults.py`` take the same
    path."""

    def __init__(self, message: str, kind: str = "io"):
        super().__init__(message)
        self.kind = kind  # enospc | io | fsync | wal_disabled


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


class StudentGateError(NornicError):
    """A distilled student embedder failed its eval gate (eval.py MRR below
    the configured threshold) — the serving config is rejected at startup
    rather than silently serving lower-quality embeddings."""


class DeviceUnavailable(NornicError):
    """The accelerator is not available. The port never falls back to the
    CPU on its own: a caller that wants the CPU passes ``device="cpu"``."""
