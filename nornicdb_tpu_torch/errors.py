"""Error types of the port: copies of the ones the search, storage,
generation, training, device-owner, Cypher and server slices raise or
catch (``nornicdb_tpu/errors.py``), kept here so the port imports nothing
of the JAX package."""


class NornicError(Exception):
    """Base class for all framework errors."""


class NotFoundError(NornicError):
    """Entity (node/edge/database/index) does not exist. GraphRAG's graph
    expansion skips a hit whose node is gone."""


class AlreadyExistsError(NornicError):
    """Entity already exists (duplicate id, unique-constraint violation)."""


class ConstraintViolationError(NornicError):
    """Schema constraint violated."""


class CypherSyntaxError(NornicError):
    """Cypher query failed to parse."""

    def __init__(self, message: str, position: int = -1, line: int = -1):
        super().__init__(message)
        self.position = position
        self.line = line


class CypherTypeError(NornicError):
    """Runtime type error during Cypher evaluation."""


class AuthError(NornicError):
    """Authentication / authorization failure."""


class TransactionError(NornicError):
    """Transaction lifecycle error."""


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
    CPU on its own: a caller that wants the CPU passes ``device="cpu"``,
    and the device owner (``nornicdb_tpu_torch.backend``) raises this for a
    card that is not serving."""


class BackendLockHeldError(NornicError):
    """A backend acquisition ran while the caller held a lock (the
    deadlock shape a hung first touch makes). Detection requires an
    instrumented-lock shim, so this raises only where one is installed."""
