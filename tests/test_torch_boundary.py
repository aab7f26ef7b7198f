"""Import boundary and device policy of the PyTorch port (nornicdb_tpu_torch).

The port imports torch and never jax or anything of the JAX package, and
it never runs on the CPU unless the caller asks for it. Neither the port
nor ``chip_smoke.py`` imports ``grpc`` or ``google.protobuf``: the card's
machine has neither, and the gRPC servers run on the port's own
``server/grpcwire.py``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import nornicdb_tpu_torch
from nornicdb_tpu_torch import DeviceUnavailable, resolve_device
from nornicdb_tpu_torch.config import ServingConfig
from nornicdb_tpu_torch.embed import DeviceEmbedder
from nornicdb_tpu_torch.heimdall import QwenGenerator
from nornicdb_tpu_torch.models import BGE_SMALL, QWEN_SMALL, init_params
from nornicdb_tpu_torch.models import weights
from nornicdb_tpu_torch.models.pretrain import load_generator
from nornicdb_tpu_torch.ops.similarity import DeviceCorpus
from nornicdb_tpu_torch.embed import HashEmbedder
from nornicdb_tpu_torch.search import CrossEncoderReranker, SearchService
from nornicdb_tpu_torch.serving import ServingEngine
from nornicdb_tpu_torch.storage import MemoryEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the device owner, the Cypher engine, GDS, APOC and the Kalman filters
# (ROADMAP A4, A5a, A5b), the servers, auth and retention (A6a), the gRPC
# servers and their transport, OAuth (A6b-2), decay, temporal and the
# audit log (A6c)
NEW_MODULES = (
    "nornicdb_tpu_torch.backend",
    "nornicdb_tpu_torch.backend.manager",
    "nornicdb_tpu_torch.cypher",
    "nornicdb_tpu_torch.cypher.ast",
    "nornicdb_tpu_torch.cypher.lexer",
    "nornicdb_tpu_torch.cypher.parser",
    "nornicdb_tpu_torch.cypher.validator",
    "nornicdb_tpu_torch.cypher.functions",
    "nornicdb_tpu_torch.cypher.temporal_fns",
    "nornicdb_tpu_torch.cypher.expr",
    "nornicdb_tpu_torch.cypher.matcher",
    "nornicdb_tpu_torch.cypher.plan",
    "nornicdb_tpu_torch.cypher.parallel",
    "nornicdb_tpu_torch.cypher.colindex",
    "nornicdb_tpu_torch.cypher.columnar",
    "nornicdb_tpu_torch.cypher.executor",
    "nornicdb_tpu_torch.cypher.gds_procedures",
    "nornicdb_tpu_torch.filter",
    "nornicdb_tpu_torch.filter.kalman",
    "nornicdb_tpu_torch.apoc",
    "nornicdb_tpu_torch.apoc.registry",
    "nornicdb_tpu_torch.apoc.functions",
    "nornicdb_tpu_torch.apoc.functions_ext",
    "nornicdb_tpu_torch.apoc.functions_pure",
    "nornicdb_tpu_torch.apoc.functions_tail",
    "nornicdb_tpu_torch.apoc.functions_graph",
    "nornicdb_tpu_torch.apoc.functions_graph2",
    "nornicdb_tpu_torch.apoc.functions_ops",
    "nornicdb_tpu_torch.apoc.triggers",
    "nornicdb_tpu_torch.apoc.procedures",
    "nornicdb_tpu_torch.apoc.export_import",
    "nornicdb_tpu_torch.server",
    "nornicdb_tpu_torch.server.packstream",
    "nornicdb_tpu_torch.server.bolt",
    "nornicdb_tpu_torch.server.respcache",
    "nornicdb_tpu_torch.server.ui",
    "nornicdb_tpu_torch.server.openapi",
    "nornicdb_tpu_torch.server.http",
    "nornicdb_tpu_torch.server.broker",
    "nornicdb_tpu_torch.server.shm",
    "nornicdb_tpu_torch.server.grpc_search",
    "nornicdb_tpu_torch.telemetry.federation",
    "nornicdb_tpu_torch.auth",
    "nornicdb_tpu_torch.auth.auth",
    "nornicdb_tpu_torch.retention",
    "nornicdb_tpu_torch.server.grpcwire",
    "nornicdb_tpu_torch.server.qdrant_grpc",
    "nornicdb_tpu_torch.server.oauth_provider",
    "nornicdb_tpu_torch.decay",
    "nornicdb_tpu_torch.decay.decay",
    "nornicdb_tpu_torch.temporal",
    "nornicdb_tpu_torch.temporal.tracker",
    "nornicdb_tpu_torch.temporal.patterns",
    "nornicdb_tpu_torch.temporal.evolution",
    "nornicdb_tpu_torch.temporal.query_load",
    "nornicdb_tpu_torch.temporal.decay_integration",
    "nornicdb_tpu_torch.audit",
)
# what the card's machine does not have
CARD_ABSENT = ("grpc", "google")

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import nornicdb_tpu_torch as pkg
names = [pkg.__name__]
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    names.append(m.name)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def _import_everything() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


class TestImportBoundary:
    def test_no_jax_and_no_jax_package(self):
        res = _import_everything()
        mods = res["modules"]
        assert "jax" not in mods
        assert not [m for m in mods if m.startswith("jax.")]
        # nornicdb_tpu_torch itself starts with "nornicdb_tpu": match the dot
        assert not [m for m in mods
                    if m == "nornicdb_tpu" or m.startswith("nornicdb_tpu.")]

    def test_no_grpcio_and_no_protobuf_at_import(self):
        mods = _import_everything()["modules"]
        assert not [m for m in mods if m == "grpc" or m.startswith("grpc.")
                    or m.startswith("google.protobuf")]

    def test_no_module_imports_grpcio_or_protobuf(self):
        """A static scan of every import statement of every port module
        and of ``chip_smoke.py``, function bodies included."""
        import ast

        files = [os.path.join(ROOT, "chip_smoke.py")]
        for base, _, names in os.walk(os.path.join(ROOT,
                                                   "nornicdb_tpu_torch")):
            files += [os.path.join(base, n) for n in names
                      if n.endswith(".py")]
        assert len(files) > 100
        for path in files:
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                else:
                    continue
                for name in names:
                    top = name.split(".")[0]
                    assert top not in CARD_ABSENT + (
                        "jax", "jaxlib", "nornicdb_tpu"), (path, name)

    def test_every_module_imported(self):
        imported = set(_import_everything()["imported"])
        for name in ("nornicdb_tpu_torch.ops.kernels",
                     "nornicdb_tpu_torch.ops.kernels_ref",
                     "nornicdb_tpu_torch.ops._build",
                     "nornicdb_tpu_torch.ops.similarity",
                     "nornicdb_tpu_torch.ops.host_search",
                     "nornicdb_tpu_torch.ops.kmeans",
                     "nornicdb_tpu_torch.ops.ivf",
                     "nornicdb_tpu_torch.search.batcher",
                     "nornicdb_tpu_torch.search.bm25",
                     "nornicdb_tpu_torch.search.fusion",
                     "nornicdb_tpu_torch.search.hnsw",
                     "nornicdb_tpu_torch.search.rerank",
                     "nornicdb_tpu_torch.search.service",
                     "nornicdb_tpu_torch.search.tuner",
                     "nornicdb_tpu_torch.storage",
                     "nornicdb_tpu_torch.storage.types",
                     "nornicdb_tpu_torch.storage.faults",
                     "nornicdb_tpu_torch.storage.native",
                     "nornicdb_tpu_torch.storage.wal",
                     "nornicdb_tpu_torch.storage.async_engine",
                     "nornicdb_tpu_torch.storage.namespaced",
                     "nornicdb_tpu_torch.storage.schema",
                     "nornicdb_tpu_torch.storage.io",
                     "nornicdb_tpu_torch.storage.segment",
                     "nornicdb_tpu_torch.storage.adjacency",
                     "nornicdb_tpu_torch.encryption",
                     "nornicdb_tpu_torch.multidb",
                     "nornicdb_tpu_torch.multidb.manager",
                     "nornicdb_tpu_torch.convert",
                     "nornicdb_tpu_torch.config",
                     "nornicdb_tpu_torch.models",
                     "nornicdb_tpu_torch.models.layers",
                     "nornicdb_tpu_torch.models.qwen2",
                     "nornicdb_tpu_torch.models.tokenizer",
                     "nornicdb_tpu_torch.models.bge_m3",
                     "nornicdb_tpu_torch.models.weights",
                     "nornicdb_tpu_torch.models.pretrain",
                     "nornicdb_tpu_torch.heimdall",
                     "nornicdb_tpu_torch.heimdall.manager",
                     "nornicdb_tpu_torch.genserve",
                     "nornicdb_tpu_torch.genserve.engine",
                     "nornicdb_tpu_torch.genserve.graphrag",
                     "nornicdb_tpu_torch.embed",
                     "nornicdb_tpu_torch.embed.base",
                     "nornicdb_tpu_torch.embed.queue",
                     "nornicdb_tpu_torch.serving",
                     "nornicdb_tpu_torch.serving.engine",
                     "nornicdb_tpu_torch.serving.ragged",
                     "nornicdb_tpu_torch.serving.student_gate",
                     "nornicdb_tpu_torch.models.training",
                     "nornicdb_tpu_torch.eval",
                     "nornicdb_tpu_torch.cli",
                     "nornicdb_tpu_torch.__main__",
                     "nornicdb_tpu_torch.ops.graph_algos",
                     "nornicdb_tpu_torch.linkpredict",
                     "nornicdb_tpu_torch.linkpredict.topology",
                     "nornicdb_tpu_torch.telemetry",
                     "nornicdb_tpu_torch.telemetry.metrics",
                     "nornicdb_tpu_torch.telemetry.tracing",
                     "nornicdb_tpu_torch.telemetry.budget",
                     "nornicdb_tpu_torch.telemetry.slowlog",
                     "nornicdb_tpu_torch.telemetry.deviceprof",
                     "nornicdb_tpu_torch.telemetry.costmodel",
                     "nornicdb_tpu_torch.serving.stats",
                     "nornicdb_tpu_torch.genserve.stats",
                     "nornicdb_tpu_torch.db",
                     "nornicdb_tpu_torch.vectorspace",
                     "nornicdb_tpu_torch.cache",
                     "nornicdb_tpu_torch.inference",
                     "nornicdb_tpu_torch.inference.engine",
                     "nornicdb_tpu_torch.inference.integrations",
                     "nornicdb_tpu_torch.heimdall.context",
                     "nornicdb_tpu_torch.heimdall.registry",
                     "nornicdb_tpu_torch.heimdall.plugins",
                     *NEW_MODULES):
            assert name in imported

    def test_device_owner_and_cypher_import_neither_jax_nor_jax_package(self):
        """A static scan of every import statement in ``backend/``,
        ``cypher/``, ``apoc/``, ``filter/``, ``server/``, ``auth/`` and
        ``retention.py`` (the runtime check above sees only what an import
        executes, not the imports a function makes when it runs)."""
        import ast

        for mod in NEW_MODULES:
            path = os.path.join(ROOT, *mod.split(".")) + ".py"
            if not os.path.exists(path):
                path = os.path.join(ROOT, *mod.split("."), "__init__.py")
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                else:
                    continue
                for name in names:
                    top = name.split(".")[0]
                    assert top not in ("jax", "jaxlib", "nornicdb_tpu"), (
                        mod, name)


class TestDevicePolicy:
    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            assert DeviceCorpus(dims=8).device.type == "cuda"
            return
        with pytest.raises(DeviceUnavailable, match="device='cpu'"):
            DeviceCorpus(dims=8)
        with pytest.raises(DeviceUnavailable):
            SearchService(dims=8)
        with pytest.raises(DeviceUnavailable):
            SearchService(MemoryEngine(), HashEmbedder(8))
        with pytest.raises(DeviceUnavailable):
            CrossEncoderReranker()
        with pytest.raises(DeviceUnavailable):
            resolve_device(None)

    def test_embedder_and_serving_engine_default_to_cuda(self):
        if torch.cuda.is_available():
            emb = DeviceEmbedder(cfg=BGE_SMALL)
            assert emb.device.type == "cuda"
            assert emb.params["tok_emb"].device.type == "cuda"
            return
        with pytest.raises(DeviceUnavailable, match="device='cpu'"):
            DeviceEmbedder(cfg=BGE_SMALL)
        with pytest.raises(DeviceUnavailable):
            ServingEngine(DeviceEmbedder(cfg=BGE_SMALL), ServingConfig())
        emb = DeviceEmbedder(cfg=BGE_SMALL, device="cpu")
        assert emb.params["tok_emb"].device.type == "cpu"

    def test_generators_and_checkpoints_default_to_cuda(self, tmp_path):
        path = str(tmp_path / "model.safetensors")
        weights.save_params(path, init_params(QWEN_SMALL, 0, "cpu"))
        template = init_params(QWEN_SMALL, 1, "cpu")
        if torch.cuda.is_available():
            gen = QwenGenerator()
            assert gen.device.type == "cuda"
            assert gen.params["tok_emb"].device.type == "cuda"
            loaded = weights.load_params(path, template)
            assert loaded["tok_emb"].device.type == "cuda"
            return
        with pytest.raises(DeviceUnavailable, match="device='cpu'"):
            QwenGenerator()
        with pytest.raises(DeviceUnavailable):
            QwenGenerator(params=template)
        with pytest.raises(DeviceUnavailable):
            weights.load_params(path, template)
        # the device is resolved before the directory is read
        with pytest.raises(DeviceUnavailable):
            load_generator(str(tmp_path))
        loaded = weights.load_params(path, template, device="cpu")
        assert loaded["tok_emb"].device.type == "cpu"
        assert QwenGenerator(device="cpu").device.type == "cpu"

    def test_training_defaults_to_cuda(self, tmp_path):
        from nornicdb_tpu_torch.models import pretrain, training

        opt = training.make_optimizer()
        if torch.cuda.is_available():
            state = training.init_train_state(BGE_SMALL, opt)
            assert state.params["tok_emb"].device.type == "cuda"
            return
        with pytest.raises(DeviceUnavailable, match="device='cpu'"):
            training.init_lm_train_state(QWEN_SMALL, opt)
        with pytest.raises(DeviceUnavailable):
            training.init_train_state(BGE_SMALL, opt)
        # the device is resolved before any corpus is built or file read
        out = str(tmp_path / "out")
        with pytest.raises(DeviceUnavailable):
            pretrain.train_assistant(out, steps=1)
        with pytest.raises(DeviceUnavailable):
            pretrain.train_encoder(out, steps=1)
        with pytest.raises(DeviceUnavailable):
            pretrain.distill_encoder(str(tmp_path), out, steps=1)
        with pytest.raises(DeviceUnavailable):
            pretrain.load_embedder(str(tmp_path))
        assert not (tmp_path / "out").exists()
        state = training.init_train_state(BGE_SMALL, opt, device="cpu")
        assert state.params["tok_emb"].device.type == "cpu"

    def test_db_defaults_to_cuda(self, tmp_path):
        from nornicdb_tpu_torch import DB, open_db

        d = tmp_path / "db"
        if torch.cuda.is_available():
            db = open_db(str(d))
            try:
                assert db.device.type == "cuda"
            finally:
                db.close()
            return
        with pytest.raises(DeviceUnavailable, match="device='cpu'"):
            open_db(str(d))
        with pytest.raises(DeviceUnavailable):
            DB(str(d))
        # the device is resolved before the data directory is opened
        assert not d.exists()
        db = open_db(str(d), device="cpu")
        try:
            assert db.device.type == "cpu" and d.exists()
        finally:
            db.close()

    def test_cypher_executor_and_devices_default_to_cuda(self, tmp_path):
        from nornicdb_tpu_torch import backend
        from nornicdb_tpu_torch.cypher import CypherExecutor

        if torch.cuda.is_available():
            assert CypherExecutor(MemoryEngine()).device.type == "cuda"
            assert all(d.type == "cuda" for d in backend.devices())
            return
        with pytest.raises(DeviceUnavailable, match="device='cpu'"):
            CypherExecutor(MemoryEngine())
        ex = CypherExecutor(MemoryEngine(), device="cpu")
        assert ex.device.type == "cpu"
        assert ex.execute("RETURN 1 AS one").rows == [[1]]
        # devices() waits (bounded) for the device owner to acquire the
        # card; without one that is DeviceUnavailable, never the CPU
        backend.reset_default()
        try:
            backend.configure(acquire_timeout=2.0)
            with pytest.raises(DeviceUnavailable):
                backend.devices()
        finally:
            backend.reset_default()
            backend.configure()

    def test_offloads_never_catch_into_the_host_path(self):
        """The two Cypher offloads, their device scoring and the corpus's
        and the embedder's device paths raise device errors instead of
        serving from the host: no ``except`` clause in them catches
        Exception (or everything) or DeviceUnavailable."""
        import ast

        targets = {
            ("cypher", "columnar.py"): {"_offload_candidates",
                                        "_vector_rank"},
            ("search", "service.py"): {"graph_masked_scores"},
            ("ops", "similarity.py"): {"search", "score_subset",
                                       "device_gate"},
            ("embed", "base.py"): {"embed_batch", "embed_packed"},
        }
        for parts, names in targets.items():
            path = os.path.join(ROOT, "nornicdb_tpu_torch", *parts)
            tree = ast.parse(open(path).read())
            found = set()
            for fn in ast.walk(tree):
                if not (isinstance(fn, ast.FunctionDef)
                        and fn.name in names):
                    continue
                found.add(fn.name)
                for node in ast.walk(fn):
                    if not isinstance(node, ast.ExceptHandler):
                        continue
                    caught = node.type
                    broad = caught is None or any(
                        isinstance(n, ast.Name)
                        and n.id in ("Exception", "BaseException",
                                     "RuntimeError", "DeviceUnavailable")
                        for n in ast.walk(caught))
                    # _vector_rank's exact rescore re-raises scoring
                    # errors as _Bail for the generic engine, which
                    # reproduces the user-facing error: not a host path
                    reraises = any(isinstance(n, ast.Raise)
                                   for n in node.body)
                    assert not broad or reraises, (fn.name, node.lineno)
            assert found == names

    def test_cpu_only_when_named(self):
        assert resolve_device("cpu") == torch.device("cpu")
        assert DeviceCorpus(dims=8, device="cpu").device.type == "cpu"

    def test_unsupported_device_rejected(self):
        with pytest.raises(ValueError):
            resolve_device("meta")

    def test_public_errors(self):
        assert issubclass(nornicdb_tpu_torch.ResourceExhausted,
                          nornicdb_tpu_torch.NornicError)
        assert nornicdb_tpu_torch.ResourceExhausted("x").reason == "queue_full"
        assert issubclass(nornicdb_tpu_torch.ClosedError,
                          nornicdb_tpu_torch.NornicError)
