"""Import boundary and device policy of the PyTorch port (nornicdb_tpu_torch).

The port imports torch and never jax or anything of the JAX package, and
it never runs on the CPU unless the caller asks for it.
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
                     "nornicdb_tpu_torch.serving.ragged"):
            assert name in imported


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
