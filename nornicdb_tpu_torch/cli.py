"""Command line of the port: ``python -m nornicdb_tpu_torch <command>``.

The counterpart of ``nornicdb_tpu/cli.py``, one subcommand at a time as the
slices port what each drives. Ported: ``serve`` (HTTP, with GraphQL and
the Qdrant REST API, Bolt over the port's DB, and with
``NORNICDB_QDRANT_GRPC_ENABLED`` / ``NORNICDB_GRPC_ENABLED`` the Qdrant
gRPC services and the native gRPC search, on the port's own gRPC
transport, ``server/grpcwire.py``, so no grpcio is needed), ``init``,
``shell``, ``import``, ``export``, ``backup``, ``restore``, ``eval``,
``decay``, ``train`` and ``oauth-provider``. ``--device`` is the port's
device argument: it defaults to the card (CUDA) and names the CPU only
when asked (``--device cpu``). Not ported yet: ``dataset`` and
``kmeans-test-data`` (ROADMAP A8).

``serve`` refuses what is not ported yet, rather than ignoring it:
prefork workers, ``--workers`` or ``workers.http`` / ``workers.grpc``
above 0 (A6d), exit non-zero with a message naming the item.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

_TRUTHY = ("1", "true", "yes")


def _open_db(args, device):
    import nornicdb_tpu_torch
    from nornicdb_tpu_torch.db import Config

    cfg = Config(log_queries=bool(getattr(args, "log_queries", False)))
    if cfg.log_queries:
        import logging

        logging.basicConfig(level=logging.INFO)
    return nornicdb_tpu_torch.open_db(args.data_dir, cfg, device=device)


def _refuse_unported(args, app_cfg) -> None:
    """Exit non-zero on a surface that is not ported yet."""
    n_http = (args.workers if args.workers is not None
              else app_cfg.workers.http)
    if n_http > 0 or app_cfg.workers.grpc > 0:
        raise SystemExit("prefork protocol workers are not ported yet "
                         "(ROADMAP A6d); serve with --workers 0")


def _device(args):
    """The command's device: the card unless ``--device cpu``; no card, no
    data directory opened."""
    from nornicdb_tpu_torch._device import resolve_device
    from nornicdb_tpu_torch.errors import DeviceUnavailable

    try:
        return resolve_device(args.device)
    except DeviceUnavailable as e:
        raise SystemExit(f"{args.command}: {e}")


def cmd_serve(args) -> int:
    """(ref: runServe main.go:210) The JAX ``cmd_serve`` in its order:
    config and telemetry, the device owner, the DB, the embedder (with the
    student gate) behind ``ServingEngine`` and ``CachedEmbedder``, the
    generation engine's warm-up, the ``--auth`` admin user, HTTP and
    Bolt, the Qdrant gRPC services (``NORNICDB_QDRANT_GRPC_ENABLED``, port
    ``NORNICDB_QDRANT_GRPC_PORT``, 6334) over the DB's one Qdrant registry
    and the native gRPC search (``NORNICDB_GRPC_ENABLED``, port
    ``NORNICDB_GRPC_PORT``, 50051), and a shutdown on SIGINT / SIGTERM
    that stops every server and closes the DB."""
    import nornicdb_tpu_torch.telemetry as telemetry
    from nornicdb_tpu_torch.auth import ROLE_ADMIN, Authenticator
    from nornicdb_tpu_torch.config import load as load_app_config
    from nornicdb_tpu_torch.embed import CachedEmbedder, DeviceEmbedder, HashEmbedder
    from nornicdb_tpu_torch.multidb import SYSTEM_DB
    from nornicdb_tpu_torch.server import BoltServer, HttpServer

    app_cfg = load_app_config()
    _refuse_unported(args, app_cfg)
    device = _device(args)
    # fleet_staleness_s ages the workers' expositions out of the merged
    # /metrics; with no workers (A6d) there is no fleet to age
    tel = dict(vars(app_cfg.telemetry))
    tel.pop("fleet_staleness_s", None)
    telemetry.configure(**tel)
    from nornicdb_tpu_torch import backend as backend_mod

    backend_mod.configure(app_cfg.backend)
    # vector-serving knobs become the defaults for every SearchService
    # this process builds
    from nornicdb_tpu_torch.search import service as search_service

    search_service.configure_defaults(**vars(app_cfg.search))
    # generation-serving knobs become the defaults for the engine this
    # process builds behind Heimdall / GraphRAG
    from nornicdb_tpu_torch import genserve as genserve_mod

    genserve_mod.configure(app_cfg.genserve)
    if device.type == "cuda":
        # the device owner acquires the card on its own thread NOW, so the
        # first search or embed finds it READY instead of waiting inline
        # (a CPU server never creates one)
        backend_mod.manager().ensure_started()

    db = _open_db(args, device)
    # embedder: trained checkpoint > bge-m3 preset on the card > hash,
    # the one host embedder, only when named
    if args.embedder == "trained" or (
        args.embedder == "tpu" and os.environ.get("NORNICDB_EMBEDDER_MODEL")
    ):
        from nornicdb_tpu_torch.models.pretrain import load_embedder

        model_dir = os.environ.get("NORNICDB_EMBEDDER_MODEL", "")
        if not model_dir:
            raise SystemExit(
                "--embedder trained requires NORNICDB_EMBEDDER_MODEL=<dir>"
            )
        embedder = load_embedder(model_dir, device=device)
    elif args.embedder == "tpu":
        from nornicdb_tpu_torch.models import bge_m3

        cfg_name = getattr(bge_m3, args.model_preset.upper().replace("-", "_"))
        embedder = DeviceEmbedder(cfg=cfg_name, device=device)
    else:
        embedder = HashEmbedder(args.embed_dims)
    # distilled production embedder, behind the eval gate: the student
    # replaces the full encoder only when its retrieval MRR clears
    # serving.student_min_mrr, else the config is rejected at startup
    from nornicdb_tpu_torch.errors import StudentGateError
    from nornicdb_tpu_torch.serving import ServingEngine, gate_student
    from nornicdb_tpu_torch.serving.stats import set_embedder_selection

    serving_cfg = app_cfg.serving
    if args.embedder == "student":
        serving_cfg.embedder = "student"
        if not serving_cfg.student_model_dir:
            serving_cfg.student_model_dir = os.environ.get(
                "NORNICDB_EMBEDDER_MODEL", ""
            )
    if serving_cfg.embedder == "student":
        from nornicdb_tpu_torch.models.pretrain import load_embedder

        student_dir = serving_cfg.student_model_dir
        if not student_dir:
            raise SystemExit(
                "serving.embedder=student requires "
                "serving.student_model_dir (NORNICDB_STUDENT_MODEL)"
            )
        student = load_embedder(student_dir, device=device)
        try:
            report = gate_student(
                student,
                serving_cfg.student_min_mrr,
                serving_cfg.student_eval_suite,
            )
        except StudentGateError as e:
            raise SystemExit(f"serving config rejected: {e}")
        print(
            f"student embedder admitted: eval MRR "
            f"{report.metrics.mrr:.4f} >= {serving_cfg.student_min_mrr}"
        )
        embedder = student
        set_embedder_selection("student")
    else:
        set_embedder_selection("full")
    if serving_cfg.enabled:
        # the continuous ragged batching engine fronts every embed path;
        # the cache sits outside so hits skip the queue
        embedder = ServingEngine(embedder, serving_cfg)
    db.set_embedder(CachedEmbedder(embedder))
    # with an assistant checkpoint mounted, build and warm the generation
    # engine before traffic
    if os.environ.get("NORNICDB_ASSISTANT_MODEL") and \
            app_cfg.genserve.enabled:
        _ = db.heimdall
        gen_engine = db.genserve_engine()
        if gen_engine is not None:
            gen_engine.warmup()

    authenticator = None
    if args.auth:
        from nornicdb_tpu_torch.errors import AlreadyExistsError

        system = db.database_manager.get_storage(SYSTEM_DB)
        authenticator = Authenticator(system)
        try:
            authenticator.create_user(
                "admin", os.environ.get("NORNICDB_ADMIN_PASSWORD", "admin"),
                ROLE_ADMIN,
            )
        except AlreadyExistsError:
            pass  # exists from a previous run

    http_server = HttpServer(
        db, host=args.host, port=args.http_port,
        authenticator=authenticator, auth_required=args.auth,
        serve_ui=not args.headless,
    )
    http_server.start()
    bolt_server = BoltServer(
        lambda q, p, d: (db.executor_for(d) if d else db.executor).execute(q, p),
        host=args.host, port=args.bolt_port,
        authenticator=authenticator, auth_required=args.auth,
        session_executor_factory=db.session_executor,
    )
    bolt_server.start()
    # Qdrant gRPC on :6334, feature-flagged like the reference
    # (NORNICDB_QDRANT_GRPC_ENABLED, ref: server.go feature flag)
    qdrant_server = None
    if os.environ.get("NORNICDB_QDRANT_GRPC_ENABLED", "").lower() in _TRUTHY:
        from nornicdb_tpu_torch.server.qdrant_grpc import QdrantGrpcServer

        qdrant_server = QdrantGrpcServer(
            http_server.qdrant,  # shared registry: REST + gRPC, one index
            host=args.host,
            port=int(os.environ.get("NORNICDB_QDRANT_GRPC_PORT", "6334")),
            authenticator=authenticator,
            snapshot_dir=os.path.join(args.data_dir, "qdrant-snapshots")
            if args.data_dir else None,
        )
        qdrant_server.start()
    # native gRPC search on :50051, feature-flagged like the reference's
    # nornicgrpc service (ref: search_service.go)
    grpc_server = None
    if os.environ.get("NORNICDB_GRPC_ENABLED", "").lower() in _TRUTHY:
        from nornicdb_tpu_torch.server.grpc_search import GrpcSearchServer

        grpc_server = GrpcSearchServer(
            db, host=args.host,
            port=int(os.environ.get("NORNICDB_GRPC_PORT", "50051")),
        )
        grpc_server.start()
    print(f"NornicDB-TPU serving: bolt://{args.host}:{bolt_server.port} "
          f"http://{args.host}:{http_server.port}"
          + (f" qdrant-grpc://{args.host}:{qdrant_server.port}"
             if qdrant_server else "")
          + (f" grpc://{args.host}:{grpc_server.port}"
             if grpc_server else "")
          + f" on {device} (data: {args.data_dir or 'memory'})", flush=True)

    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        print("shutting down...", flush=True)
        if grpc_server is not None:
            grpc_server.stop()
        if qdrant_server is not None:
            qdrant_server.stop()
        bolt_server.stop()
        http_server.stop()
        db.close()
    return 0


def cmd_init(args) -> int:
    db = _open_db(args, _device(args))
    db.close()
    print(f"initialized data directory {args.data_dir}")
    return 0


def cmd_shell(args) -> int:
    """(ref: nornicdb shell)"""
    db = _open_db(args, _device(args))
    print("NornicDB-TPU shell. Cypher queries, or :quit")
    try:
        while True:
            try:
                line = input("cypher> ").strip()
            except EOFError:
                break
            if not line:
                continue
            if line in (":quit", ":exit", "quit", "exit"):
                break
            try:
                result = db.cypher(line)
                if result.columns:
                    print("\t".join(result.columns))
                    for row in result.rows:
                        print("\t".join(str(v) for v in row))
                stats = result.stats.as_dict()
                if stats:
                    print(f"-- {stats}")
            except Exception as e:
                print(f"error: {e}")
    finally:
        db.close()
    return 0


def cmd_import(args) -> int:
    """Neo4j-style JSON / Mimir JSONL import (ref: nornicdb import,
    storage loader.go + mimir_loader.go)."""
    from nornicdb_tpu_torch.storage.io import import_json, load_mimir

    db = _open_db(args, _device(args))
    try:
        if args.format == "mimir":
            n_nodes, n_edges = load_mimir(db.storage, args.file)
        else:
            with open(args.file) as f:
                data = json.load(f)
            n_nodes, n_edges = import_json(db.storage, data)
    finally:
        db.close()
    print(f"imported {n_nodes} nodes, {n_edges} relationships")
    return 0


def cmd_export(args) -> int:
    """Neo4j-style JSON export (ref: types.go:475-707)."""
    from nornicdb_tpu_torch.storage.io import export_json

    db = _open_db(args, _device(args))
    try:
        data = export_json(db.storage)
    finally:
        db.close()
    out = json.dumps(data, indent=2, default=str)
    if args.file == "-":
        print(out)
    else:
        with open(args.file, "w") as f:
            f.write(out)
        print(f"exported {len(data['nodes'])} nodes, "
              f"{len(data['relationships'])} relationships to {args.file}")
    return 0


def _require_data_dir(args) -> bool:
    """backup/restore against an empty data dir would silently operate on an
    ephemeral in-memory engine — success messages with nothing persisted."""
    if not args.data_dir:
        print("error: --data-dir (or NORNICDB_DATA_DIR) is required for "
              "this command", file=sys.stderr)
        return False
    return True


def cmd_backup(args) -> int:
    """Full-fidelity backup archive (ref: badger_backup.go role)."""
    if not _require_data_dir(args):
        return 2
    db = _open_db(args, _device(args))
    try:
        path = db.backup(args.file if args.file != "-" else None)
    finally:
        db.close()
    print(f"backup written to {path}")
    return 0


def cmd_restore(args) -> int:
    if not _require_data_dir(args):
        return 2
    db = _open_db(args, _device(args))
    try:
        counts = db.restore(args.file)
    finally:
        db.close()
    print(f"restored {counts['nodes']} nodes, {counts['edges']} edges")
    return 0


def cmd_eval(args) -> int:
    """Search-quality evaluation (ref: cmd/eval, pkg/eval harness) over
    the DB's search service on the command's device."""
    from nornicdb_tpu_torch.embed import HashEmbedder
    from nornicdb_tpu_torch.eval import Harness

    db = _open_db(args, _device(args))
    try:
        if db.embedder is None:
            db.set_embedder(HashEmbedder(args.embed_dims))
            db.process_pending_embeddings()
        cases = Harness.load_suite(args.suite)
        thresholds = json.loads(args.thresholds) if args.thresholds else {}
        harness = Harness(
            lambda q, k: [r["id"] for r in db.search.search(q, limit=k)],
            k=args.k, thresholds=thresholds,
        )
        report = harness.run(cases)
        print(json.dumps({"metrics": report.metrics.as_dict(),
                          "passed": report.passed}, indent=2))
        return 0 if report.passed else 1
    finally:
        db.close()


def cmd_decay(args) -> int:
    """(ref: nornicdb decay {recalculate,archive,stats})"""
    db = _open_db(args, _device(args))
    try:
        if args.action == "recalculate":
            scored, archived = db.decay.recalculate_all()
            print(f"scored {scored} nodes, archived {archived}")
        elif args.action == "stats":
            print(json.dumps(vars(db.decay.stats)))
        elif args.action == "archive":
            nodes = db.decay.archived_nodes()
            print(f"{len(nodes)} archived nodes")
    finally:
        db.close()
    return 0


def cmd_oauth_provider(args) -> int:
    """The standalone OAuth 2.0 test provider (ref: cmd/oauth-provider)."""
    from nornicdb_tpu_torch.server.oauth_provider import main as provider_main

    return provider_main(args.port, args.client_id, args.client_secret)


def cmd_train(args) -> int:
    """Train an in-image checkpoint (``models/pretrain.py``) with the JAX
    package's presets, and print its stats as one JSON line."""
    from nornicdb_tpu_torch.models import pretrain

    if args.model == "assistant":
        # facts + ACTION-MODE corpus: the served assistant must emit
        # machine-parseable query/status actions
        corpus = (pretrain.synth_corpus(0, repeats=6)
                  + pretrain.synth_action_corpus(0, repeats=6))
        stats = pretrain.train_assistant(
            args.out, steps=args.steps or 1400, batch=24, seq_len=64,
            hidden=128, lr=2e-3, corpus=corpus, device=args.device,
        )
    else:
        stats = pretrain.train_encoder(args.out, steps=args.steps or 250,
                                       device=args.device)
    print(json.dumps({"model": args.model, "out": args.out, **stats}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="nornicdb_tpu_torch",
        description="NornicDB's PyTorch/CUDA port")
    p.add_argument("--data-dir", default=os.environ.get("NORNICDB_DATA_DIR", ""),
                   help="data directory (empty = in-memory)")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("serve", help="run the database server")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--bolt-port", type=int, default=7687)
    s.add_argument("--http-port", type=int, default=7474)
    s.add_argument("--auth", action="store_true", help="require authentication")
    s.add_argument("--headless", action="store_true",
                   help="no browser UI (ref: -tags noui builds)")
    s.add_argument("--embedder", choices=["hash", "tpu", "trained", "student"],
                   default="tpu",
                   help="tpu: bge-m3 (--model-preset) on the server's device; "
                        "hash: the host hash embedder, only when named")
    s.add_argument("--embed-dims", type=int, default=1024)
    s.add_argument("--model-preset", default="bge_small")
    s.add_argument("--log-queries", action="store_true",
                   help="log every Cypher statement with wall time")
    s.add_argument("--workers", type=int, default=None,
                   help="prefork HTTP protocol workers: not ported yet "
                        "(ROADMAP A6d), so only 0 is accepted")
    s.add_argument("--device", default=None,
                   help="torch device to serve from (default: cuda; 'cpu' "
                        "only when named)")
    # also after the subcommand; the top-level value when not given here
    s.add_argument("--data-dir", default=argparse.SUPPRESS,
                   help="data directory (empty = in-memory)")
    s.set_defaults(fn=cmd_serve)

    def db_command(name: str, fn, help_: str):
        s = sub.add_parser(name, help=help_)
        s.add_argument("--device", default=None,
                       help="torch device of the DB (default: cuda; 'cpu' "
                            "only when named)")
        s.add_argument("--data-dir", default=argparse.SUPPRESS,
                       help="data directory (empty = in-memory)")
        s.set_defaults(fn=fn)
        return s

    db_command("init", cmd_init, "initialize a data directory")
    db_command("shell", cmd_shell, "interactive Cypher shell")

    s = db_command("import", cmd_import,
                   "import Neo4j-style JSON or Mimir JSONL")
    s.add_argument("file")
    s.add_argument("--format", choices=["json", "mimir"], default="json")

    s = db_command("export", cmd_export,
                   "export the graph as Neo4j-style JSON")
    s.add_argument("file", help="output path, or - for stdout")

    s = db_command("backup", cmd_backup,
                   "write a full-fidelity backup archive")
    s.add_argument("file", nargs="?", default="-",
                   help="output .json.gz path (default: <data-dir>/backups/)")

    s = db_command("restore", cmd_restore, "restore a backup archive")
    s.add_argument("file", help="backup .json.gz path")

    s = db_command("eval", cmd_eval, "run a search-quality evaluation suite")
    s.add_argument("suite", help="JSON suite: [{query, relevant: [ids]}]")
    s.add_argument("--k", type=int, default=10)
    s.add_argument("--embed-dims", type=int, default=256)
    s.add_argument("--thresholds", default="", help='JSON e.g. {"mrr": 0.8}')

    s = db_command("decay", cmd_decay, "memory decay operations")
    s.add_argument("action", choices=["recalculate", "archive", "stats"])

    s = sub.add_parser(
        "train",
        help="train in-image model checkpoints (assistant decoder via LM "
             "loss, embedding encoder via InfoNCE) on the synthetic domain "
             "corpus — the zero-egress replacement for mounting GGUF weights",
    )
    s.add_argument("model", choices=["assistant", "encoder"])
    s.add_argument("--out", required=True, help="checkpoint output directory")
    s.add_argument("--steps", type=int, default=0,
                   help="train steps (default: per-model preset)")
    s.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda; 'cpu' only "
                        "when named)")
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser(
        "oauth-provider",
        help="run the standalone OAuth 2.0 test provider "
             "(ref: cmd/oauth-provider — local OAuth integration testing)",
    )
    s.add_argument("--port", type=int, default=8888)
    s.add_argument("--client-id", default="nornicdb-local-test")
    s.add_argument("--client-secret", default="local-test-secret-123")
    s.set_defaults(fn=cmd_oauth_provider)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
