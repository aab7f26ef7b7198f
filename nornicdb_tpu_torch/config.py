"""Configuration of the port: YAML file + environment + runtime feature
flags, a copy of ``nornicdb_tpu/config.py`` (``AppConfig`` and its
sections, ``find_config_file``, ``load_from_file``, ``load_from_env`` with
the reference's flat ``NORNICDB_*`` names, ``load``, ``FeatureFlags``,
``resolve_import_url``), kept here so the port imports nothing of the JAX
package. Precedence: explicit args > YAML > env > defaults.

``ServingConfig`` (embedding) and ``GenServeConfig`` (generation) are the
port's own copies with ``from_env``; they are the ``serving`` and
``genserve`` sections of ``AppConfig``. ``BackendConfig`` configures the
port's device owner (``nornicdb_tpu_torch.backend``). Its ``fallback`` and
``GenServeConfig.fallback`` default to ``"fail"`` where the JAX package has
``"cpu"``, and ``"fail"`` is the only value the port takes: it never serves
a request meant for the card from the host, and refuses a config that
names ``"cpu"``.

Behavioral reference: the upstream NornicDB pkg/config/config.go:82-420
(Config, LoadFromFile/LoadFromEnv, FindConfigFile discovery),
feature_flags.go:210-506 (mutex-guarded flag registry).
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field, fields
from typing import Any, Mapping, Optional, TypeVar

CONFIG_FILENAMES = ("nornicdb.yaml", "nornicdb.yml", ".nornicdb.yaml")
ENV_PREFIX = "NORNICDB_"

_C = TypeVar("_C")


def _from_env(cls: type[_C], prefix: str,
              environ: Optional[Mapping[str, str]]) -> _C:
    """``cls()`` overridden by ``<prefix><FIELD>`` variables, coerced by
    each field's default type (``_coerce_env``)."""
    env = os.environ if environ is None else environ
    cfg = cls()
    for f in fields(cls):
        raw = env.get(f"{prefix}{f.name.upper()}")
        if raw is not None:
            setattr(cfg, f.name, _coerce_env(getattr(cfg, f.name), raw))
    return cfg


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    http_port: int = 7474
    bolt_port: int = 7687
    auth_enabled: bool = False
    base_path: str = ""
    jwt_secret: str = ""
    token_ttl: float = 24 * 3600.0
    max_failed_logins: int = 5
    lockout_duration: float = 300.0


@dataclass
class DatabaseConfig:
    data_dir: str = ""
    encryption_enabled: bool = False
    encryption_key: str = ""
    async_writes: bool = True
    wal_sync: bool = False
    auto_compact_interval: float = 300.0


@dataclass
class EmbeddingConfig:
    enabled: bool = True
    provider: str = "tpu"  # tpu | hash
    dimensions: int = 1024
    chunk_tokens: int = 512
    chunk_overlap: int = 50
    workers: int = 1
    cache_size: int = 10000


@dataclass
class MemoryConfig:
    decay_enabled: bool = False
    decay_interval: float = 3600.0
    archive_threshold: float = 0.05
    query_cache_size: int = 1000
    query_cache_ttl: float = 60.0


@dataclass
class ComplianceConfig:
    audit_enabled: bool = False
    audit_path: str = ""
    retention_enabled: bool = False


@dataclass
class TelemetryConfig:
    """Knobs for the process-global telemetry layer
    (``nornicdb_tpu_torch.telemetry``), the JAX section's fields; the same
    knobs are env-readable at import time (NORNICDB_TRACING /
    NORNICDB_TRACE_SAMPLE / NORNICDB_SLOW_QUERY_MS)."""

    tracing_enabled: bool = True
    trace_sample: float = 1.0  # fraction of ingress requests traced
    trace_buffer: int = 256  # completed traces kept for /admin/traces
    slow_query_ms: float = 1000.0  # 0 disables slow-query capture
    slow_buffer: int = 128  # entries kept for /admin/slow-queries
    # fleet federation: a worker exposition older than this at scrape
    # time is dropped from the merged /metrics (dead worker / wedged
    # publisher segments must age out, not flatline forever)
    fleet_staleness_s: float = 10.0
    # upper bound for POST /admin/profile?seconds=N profiler captures
    profile_max_seconds: float = 60.0
    # predictive admission (telemetry/costmodel.py): predictions are
    # multiplied by cost_conservatism before the deadline comparison, and
    # admission fails OPEN while model confidence sits below
    # cost_min_confidence (a cold model must never turn traffic away)
    cost_conservatism: float = 1.5
    cost_min_confidence: float = 0.25
    predictive_admission: bool = True
    # per-route latency SLO targets, "route=ms,route=ms" — feeds the
    # nornicdb_slo_burn_rate gauges (docs/capacity.md)
    slo_targets: str = "embed=250,search=250,generate=5000"
    # SLO objective: burn rate = miss fraction / (1 - objective)
    slo_objective: float = 0.99


@dataclass
class BackendConfig:
    """Device lifecycle knobs of the port's device owner
    (``nornicdb_tpu_torch.backend.manager``; ``backend.manager()`` layers
    them over the environment). The fields are the JAX package's, so its
    config files load here. ``fallback`` defaults to ``"fail"``, where the
    JAX package has ``"cpu"``, and the manager refuses any other value. The
    port reads no ``recovery_reupload``: a failure CUDA recovers from loses
    no device memory, so a recovery always keeps the resident buffers and
    patches the blocks written meanwhile (JAX's ``"dirty"``)."""

    # seconds a caller waits for device init + first touch
    acquire_timeout: float = 15.0
    # health-probe cadence and per-probe budget
    probe_interval: float = 5.0
    probe_timeout: float = 5.0
    # a green probe slower than this counts as a failure (sick-but-alive
    # accelerators must degrade too, not just dead ones)
    probe_latency_threshold: float = 1.0
    # hysteresis: consecutive failures before READY -> DEGRADED_CPU, and
    # consecutive green probes before DEGRADED_CPU -> RECOVERING
    degrade_after: int = 3
    recover_after: int = 2
    # "fail" raises DeviceUnavailable to the caller; the only value the
    # port takes (the JAX package's "cpu" is refused)
    fallback: str = "fail"
    # the JAX package's recovery re-upload mode; not read by the port
    recovery_reupload: str = "full"


@dataclass
class ServingConfig:
    """Continuous batching engine knobs of the embed path
    (``nornicdb_tpu_torch.serving.ServingEngine``). Env form:
    ``NORNICDB_SERVING_<FIELD>`` (:meth:`from_env`).

    ``enabled``, ``embedder`` and the ``student_*`` fields are read by
    nothing in the port yet. The distilled-student gate they feed is
    ported (``serving.gate_student``: a student and ``student_min_mrr``,
    ``student_eval_suite``); the server's embedder selection that reads
    them (``cli serve`` of the JAX package, ``cli.py:85-125``) is not, so
    setting them changes nothing."""

    # master switch for the continuous batching engine
    enabled: bool = True
    # production embedder selection: "full" = the configured encoder as
    # is; "student" = the distilled checkpoint at student_model_dir,
    # admitted only when its eval MRR clears student_min_mrr
    embedder: str = "full"
    student_model_dir: str = ""
    student_min_mrr: float = 0.6
    student_eval_suite: str = ""  # JSON suite path; "" = builtin suite
    # admission control: queued texts/tokens beyond these shed new
    # requests with ResourceExhausted (an empty queue always admits)
    max_queue: int = 4096
    max_queue_tokens: int = 262144
    # per-request deadline; expired work is shed pre-dispatch and waiting
    # callers give up at deadline + grace. 0 disables (not recommended
    # for serving: the deadline is the no-indefinite-block guarantee)
    deadline_ms: float = 2000.0
    # batch window under low queue depth (a deep queue dispatches
    # immediately at max_batch_tokens)
    batch_wait_ms: float = 2.0
    # ragged scheduler: token budget per packed dispatch + row-grid bound
    max_batch_tokens: int = 8192
    max_rows: int = 16
    # host staging pipeline depth (double buffering; >=1)
    staging_depth: int = 2

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "ServingConfig":
        """Defaults overridden by ``NORNICDB_SERVING_<FIELD>`` variables."""
        return _from_env(cls, "NORNICDB_SERVING_", environ)


@dataclass
class GenServeConfig:
    """Continuous-batching generation engine knobs
    (``nornicdb_tpu_torch.genserve``). Env form:
    ``NORNICDB_GENSERVE_<FIELD>`` (:meth:`from_env`).

    ``GraphRAGService`` reads ``rag_context_nodes`` and
    ``rag_max_new_tokens``; ``DB`` reads ``enabled`` (off: Heimdall keeps
    the synchronous ``QwenGenerator``); the engine refuses a ``fallback``
    other than ``"fail"``."""

    # master switch: off = Heimdall keeps the synchronous per-request path
    enabled: bool = True
    # "paged" = paged-KV continuous batching; "dense" = the escape hatch, a
    # per-sequence dense KV cache (torch ops, no ragged kernel)
    mode: str = "paged"
    # KV page geometry: slots per page and physical pages in the pool
    # (one page is reserved as the null/scratch page)
    page_size: int = 16
    pool_pages: int = 129
    # concurrency + per-sequence bound (prompt + generated tokens; the
    # page-table width is max_seq_tokens / page_size)
    max_seqs: int = 8
    max_seq_tokens: int = 256
    # max tokens per interleaved prefill chunk (bucketed to powers of two)
    prefill_chunk: int = 64
    # admission control: queued requests beyond this shed with
    # ResourceExhausted (an empty queue always admits)
    max_queue: int = 64
    # per-request deadline; expired requests are shed (0 disables)
    deadline_ms: float = 10000.0
    # degraded backend policy: "fail" raises DeviceUnavailable, the only
    # value the port takes (the JAX package's "cpu" is refused)
    fallback: str = "fail"
    # GraphRAG answer endpoint: retrieved context nodes + decode budget
    rag_context_nodes: int = 5
    rag_max_new_tokens: int = 64

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "GenServeConfig":
        """Defaults overridden by ``NORNICDB_GENSERVE_<FIELD>`` variables."""
        return _from_env(cls, "NORNICDB_GENSERVE_", environ)


@dataclass
class WorkersConfig:
    """Prefork protocol workers of the JAX package's servers, kept for
    config compatibility: the workers are not ported yet (ROADMAP A6d), so
    ``serve`` refuses ``http`` or ``grpc`` above 0 and reads nothing else.
    Env form: ``NORNICDB_WORKERS_<FIELD>``."""

    # worker processes fronting the HTTP surface (0 disables the pool)
    http: int = 0
    # worker processes fronting the native gRPC search surface (needs
    # NORNICDB_GRPC_ENABLED; they share the HTTP pool's device broker)
    grpc: int = 0
    # public port the HTTP worker pool binds (0 = ephemeral, printed at
    # startup); gRPC workers use grpc_port the same way
    port: int = 0
    grpc_port: int = 0
    # device broker (one PJRT owner, fused cross-worker search/embed
    # batches over a Unix socket) — disabling it degrades workers to
    # cache + proxy only
    broker: bool = True
    # shared-memory read plane (corpus + CSR adjacency segments): the
    # workers' host-search fallback when the broker is down or the
    # backend is DEGRADED_CPU
    read_plane: bool = True
    # respawn crashed workers automatically
    respawn: bool = True
    # shared-segment republish cadence in seconds: worker reads are at
    # most this stale; each publish copies the corpus host arrays, so
    # raise it for very large corpora under constant writes
    publish_interval: float = 0.05
    # fleet telemetry: workers publish their metrics registry (and
    # slow-query ring) into per-proc shm segments the primary's /metrics
    # merges under a proc label (docs/observability.md "Metrics
    # federation & staleness")
    metrics: bool = True
    metrics_interval: float = 0.5
    # per-worker token bucket mirrored BEFORE the response cache
    # (effective ceiling is n_workers x rate); 0 disables
    rate_limit: float = 0.0
    rate_burst: float = 0.0


@dataclass
class SearchTuningConfig:
    """Vector-serving knobs (``nornicdb_tpu_torch.search.SearchConfig``),
    installed with ``search.service.configure_defaults(**vars(...))``
    before the first SearchService is built. The same knobs are
    env-readable as ``NORNICDB_SEARCH_<FIELD>`` for embedded processes.
    The sharded ones (``backend="sharded"``, ``sharded_min_rows``,
    ``local_k``, ``int8_residency``, ``rescore_factor``) wait for the
    multi-device port (ROADMAP A7): any value but their default is
    refused when installed."""

    # auto | tpu | sharded | hnsw — "auto" starts single-device and
    # promotes to the mesh-sharded path past sharded_min_rows
    backend: str = "auto"
    sharded_min_rows: int = 100_000
    # recall knobs: exact full-sort, per-shard candidate oversampling,
    # IVF probe count (0 = tuner-governed; explicit values bypass the
    # recall eval gate — debugging only, see docs/operations.md
    # "Recall tuning")
    exact: bool = False
    local_k: int = 0
    n_probe: int = 0
    # recall-governed IVF autotuning: operators set the floor, the tuner
    # measures and picks (n_probe, local_k); floors it can't meet serve
    # full scan (nornicdb_ivf_tunes_total{outcome="floor_unmet"})
    recall_target: float = 0.95
    tune_enabled: bool = True
    tune_sample: int = 64
    tune_k: int = 100
    tune_min_rows: int = 4096
    drift_threshold: float = 0.25
    cluster_fit_sample: int = 262_144
    # int8 compressed residency for the sharded corpus: device holds int8
    # codes + scales (≈4x rows/HBM byte), merged candidates exact-rescored
    # in f32 from the host mirror (oversampled rescore_factor × k)
    int8_residency: bool = False
    rescore_factor: int = 4
    # micro-batching + write-behind sync
    batching_enabled: bool = False
    batch_window: float = 0.002
    batch_max: int = 256
    # batched-search admission: pending queries beyond batch_max_queue
    # shed with 429/RESOURCE_EXHAUSTED (0 = unbounded); queries older
    # than batch_deadline_ms at dispatch are shed too (0 disables)
    batch_max_queue: int = 1024
    batch_deadline_ms: float = 0.0
    write_behind: bool = False


@dataclass
class AppConfig:
    server: ServerConfig = field(default_factory=ServerConfig)
    database: DatabaseConfig = field(default_factory=DatabaseConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    compliance: ComplianceConfig = field(default_factory=ComplianceConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)
    search: SearchTuningConfig = field(default_factory=SearchTuningConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    genserve: GenServeConfig = field(default_factory=GenServeConfig)
    workers: WorkersConfig = field(default_factory=WorkersConfig)


def find_config_file(start_dir: str = ".") -> Optional[str]:
    """(ref: FindConfigFile config.go)"""
    d = os.path.abspath(start_dir)
    while True:
        for name in CONFIG_FILENAMES:
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def _apply_dict(cfg: Any, data: dict) -> None:
    for f in fields(cfg):
        if f.name in data:
            v = data[f.name]
            current = getattr(cfg, f.name)
            if hasattr(current, "__dataclass_fields__") and isinstance(v, dict):
                _apply_dict(current, v)
            else:
                setattr(cfg, f.name, type(current)(v) if current is not None else v)


def load_from_file(path: str, cfg: Optional[AppConfig] = None) -> AppConfig:
    import yaml

    cfg = cfg or AppConfig()
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    _apply_dict(cfg, data)
    return cfg


# the reference's flat env names -> (section, field) here, so a user
# migrating from the reference keeps their environment working
# (ref: pkg/config/config.go LoadFromEnv + cmd/nornicdb/main.go:108-141)
ENV_ALIASES: dict[str, tuple[str, str]] = {
    "NORNICDB_DATA_DIR": ("database", "data_dir"),
    "NORNICDB_HTTP_PORT": ("server", "http_port"),
    "NORNICDB_BOLT_PORT": ("server", "bolt_port"),
    "NORNICDB_ADDRESS": ("server", "host"),
    "NORNICDB_HOST": ("server", "host"),
    "NORNICDB_AUTH": ("server", "auth_enabled"),
    "NORNICDB_AUTH_ENABLED": ("server", "auth_enabled"),
    "NORNICDB_BASE_PATH": ("server", "base_path"),
    "NORNICDB_AUTH_JWT_SECRET": ("server", "jwt_secret"),
    "NORNICDB_AUTH_TOKEN_EXPIRY": ("server", "token_ttl"),
    "NORNICDB_MAX_FAILED_LOGINS": ("server", "max_failed_logins"),
    "NORNICDB_LOCKOUT_DURATION": ("server", "lockout_duration"),
    "NORNICDB_ENCRYPTION_AT_REST": ("database", "encryption_enabled"),
    "NORNICDB_ENCRYPTION_KEY": ("database", "encryption_key"),
    "NORNICDB_ASYNC_WRITES_ENABLED": ("database", "async_writes"),
    "NORNICDB_STRICT_DURABILITY": ("database", "wal_sync"),
    "NORNICDB_EMBEDDING_ENABLED": ("embedding", "enabled"),
    "NORNICDB_EMBEDDING_PROVIDER": ("embedding", "provider"),
    "NORNICDB_EMBEDDING_DIMENSIONS": ("embedding", "dimensions"),
    "NORNICDB_EMBEDDING_CACHE_SIZE": ("embedding", "cache_size"),
    "NORNICDB_EMBEDDING_WORKERS": ("embedding", "workers"),
    "NORNICDB_MEMORY_DECAY_ENABLED": ("memory", "decay_enabled"),
    "NORNICDB_MEMORY_DECAY_INTERVAL": ("memory", "decay_interval"),
    "NORNICDB_QUERY_CACHE_SIZE": ("memory", "query_cache_size"),
    "NORNICDB_QUERY_CACHE_TTL": ("memory", "query_cache_ttl"),
    "NORNICDB_AUDIT_ENABLED": ("compliance", "audit_enabled"),
    "NORNICDB_AUDIT_LOG_PATH": ("compliance", "audit_path"),
    "NORNICDB_RETENTION_ENABLED": ("compliance", "retention_enabled"),
    # device lifecycle (the generic NORNICDB_BACKEND_<FIELD> forms work
    # too; these shorter aliases match the reference's GPU knob style)
    "NORNICDB_DEVICE_ACQUIRE_TIMEOUT": ("backend", "acquire_timeout"),
    "NORNICDB_DEVICE_PROBE_INTERVAL": ("backend", "probe_interval"),
    "NORNICDB_DEVICE_PROBE_TIMEOUT": ("backend", "probe_timeout"),
    "NORNICDB_DEVICE_FALLBACK": ("backend", "fallback"),
    "NORNICDB_DEVICE_RECOVERY_REUPLOAD": ("backend", "recovery_reupload"),
    # continuous batching engine (generic NORNICDB_SERVING_<FIELD> forms
    # work too; these short aliases cover the common operational knobs)
    "NORNICDB_EMBED_DEADLINE_MS": ("serving", "deadline_ms"),
    "NORNICDB_EMBED_MAX_QUEUE": ("serving", "max_queue"),
    "NORNICDB_STUDENT_MODEL": ("serving", "student_model_dir"),
    "NORNICDB_STUDENT_MIN_MRR": ("serving", "student_min_mrr"),
    # prefork worker pool (the generic NORNICDB_WORKERS_<FIELD> forms
    # work too; these aliases match the reference's worker knob style)
    "NORNICDB_HTTP_WORKERS": ("workers", "http"),
    "NORNICDB_GRPC_WORKERS": ("workers", "grpc"),
    "NORNICDB_WORKER_PORT": ("workers", "port"),
    "NORNICDB_TRACING": ("telemetry", "tracing_enabled"),
    "NORNICDB_TRACE_SAMPLE": ("telemetry", "trace_sample"),
    "NORNICDB_TRACE_BUFFER": ("telemetry", "trace_buffer"),
    "NORNICDB_SLOW_QUERY_MS": ("telemetry", "slow_query_ms"),
    "NORNICDB_SLOW_QUERY_BUFFER": ("telemetry", "slow_buffer"),
}


def _coerce_env(current: Any, raw: str) -> Any:
    if isinstance(current, bool):
        # the reference's WAL sync mode takes words, not just booleans
        return raw.lower() in ("1", "true", "yes", "always", "sync")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    return raw


def load_from_env(cfg: Optional[AppConfig] = None) -> AppConfig:
    """NORNICDB_<SECTION>_<FIELD>, plus the reference's flat names via
    ENV_ALIASES; the section form wins when both are set
    (ref: LoadFromEnv)."""
    cfg = cfg or AppConfig()
    for env, (section_name, field_name) in ENV_ALIASES.items():
        if env in os.environ:
            section = getattr(cfg, section_name)
            current = getattr(section, field_name)
            setattr(section, field_name, _coerce_env(current, os.environ[env]))
    for section_field in fields(cfg):
        section = getattr(cfg, section_field.name)
        for f in fields(section):
            env = f"{ENV_PREFIX}{section_field.name.upper()}_{f.name.upper()}"
            if env in os.environ:
                current = getattr(section, f.name)
                setattr(section, f.name,
                        _coerce_env(current, os.environ[env]))
    return cfg


def load(start_dir: str = ".") -> AppConfig:
    cfg = AppConfig()
    path = find_config_file(start_dir)
    if path:
        load_from_file(path, cfg)
    load_from_env(cfg)
    return cfg


# ---------------------------------------------------------------- flags
class FeatureFlags:
    """Runtime feature-flag registry (ref: feature_flags.go:210-506)."""

    DEFAULTS = {
        "kalman": True,
        "auto_tlp": True,
        "llm_qc": False,
        "gpu_clustering": True,  # kept name for parity; means TPU k-means
        "cooldowns": True,
        "mmr": False,
        "cross_encoder_rerank": False,
        "query_cache": True,
    }

    # the reference's flag env names (feature_flags.go) -> flag keys here
    ENV_FLAG_ALIASES = {
        "NORNICDB_KALMAN_ENABLED": "kalman",
        "NORNICDB_AUTO_TLP_ENABLED": "auto_tlp",
        "NORNICDB_AUTO_TLP_LLM_QC_ENABLED": "llm_qc",
        "NORNICDB_KMEANS_CLUSTERING_ENABLED": "gpu_clustering",
        "NORNICDB_COOLDOWNS_ENABLED": "cooldowns",
        "NORNICDB_MMR_ENABLED": "mmr",
        "NORNICDB_RERANK_ENABLED": "cross_encoder_rerank",
        "NORNICDB_QUERY_CACHE_ENABLED": "query_cache",
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._flags = dict(self.DEFAULTS)
        # reference-style names first, NORNICDB_FLAG_<NAME> wins over them
        for env, name in self.ENV_FLAG_ALIASES.items():
            raw = os.environ.get(env)
            if raw is not None:
                self._flags[name] = raw.lower() in ("1", "true", "yes")
        for name in list(self._flags):
            env = os.environ.get(f"{ENV_PREFIX}FLAG_{name.upper()}")
            if env is not None:
                self._flags[name] = env.lower() in ("1", "true", "yes")

    def is_enabled(self, name: str) -> bool:
        with self._lock:
            return bool(self._flags.get(name, False))

    def set(self, name: str, value: bool) -> None:
        with self._lock:
            self._flags[name] = value

    def all(self) -> dict[str, bool]:
        with self._lock:
            return dict(self._flags)

    @contextlib.contextmanager
    def with_enabled(self, name: str, value: bool = True):
        """Test helper (ref: WithXEnabled test helpers)."""
        with self._lock:
            old = self._flags.get(name)
            self._flags[name] = value
        try:
            yield
        finally:
            with self._lock:
                self._flags[name] = old

    # parity helpers (ref: IsKalmanEnabled :350, IsAutoTLPEnabled :430)
    def is_kalman_enabled(self) -> bool:
        return self.is_enabled("kalman")

    def is_auto_tlp_enabled(self) -> bool:
        return self.is_enabled("auto_tlp")


flags = FeatureFlags()


def resolve_import_url(url: str) -> str:
    """Gate + resolve a file-import URL for LOAD CSV / apoc.load.*.

    The reference refuses LOAD CSV outright in embedded mode
    (pkg/cypher/clauses.go:1800) and gates apoc file access behind its
    import setting; this framework supports local file import as an
    explicit operator opt-in:

    - NORNICDB_APOC_IMPORT_ENABLED=true must be set, else any file import
      raises (arbitrary local file reads are never a default capability).
    - Non-file URL schemes are refused (zero-egress).
    - If NORNICDB_IMPORT_DIR is set, the resolved real path must live
      under it (the reference's server.directories.import confinement);
      symlinks cannot escape because the check runs on os.path.realpath.
    """
    if os.environ.get("NORNICDB_APOC_IMPORT_ENABLED", "").lower() not in (
        "1", "true", "yes",
    ):
        raise PermissionError(
            "file import is disabled; set NORNICDB_APOC_IMPORT_ENABLED=true"
        )
    path = str(url)
    if path.startswith("file://"):
        path = path[7:]
    elif "://" in path:
        raise PermissionError(
            "only file:// URLs are supported for import (zero-egress)"
        )
    real = os.path.realpath(path)
    import_dir = os.environ.get("NORNICDB_IMPORT_DIR")
    if import_dir:
        root = os.path.realpath(import_dir)
        if not (real == root or real.startswith(root + os.sep)):
            raise PermissionError(
                f"import path escapes NORNICDB_IMPORT_DIR: {url}"
            )
    return real
