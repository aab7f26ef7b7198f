"""The port's in-image pretraining (nornicdb_tpu_torch.models.pretrain)
against the JAX package's on the CPU: the corpora, the augmentation, micro
runs of train_assistant / train_encoder / distill_encoder from carried
initial parameters, checkpoints loading in the other package, the learning
checks of tests/test_pretrain.py, and the ``train`` command.

Tolerances: the corpora, the evaluation cases and the augmented views are
equal strings. Micro runs are bf16, as both packages' defaults are, and
start from JAX's initial parameters carried over bit for bit: their first
and last logged losses agree within 2e-2 relative (bf16 activations; after
the first step Adam's near-sign updates move elements that differ in
rounding by up to ~2 lr), the distilled agreement within 0.02. A checkpoint
either package writes loads in the other with every tensor bit for bit.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nornicdb_tpu.models import bge_m3 as jbge
from nornicdb_tpu.models import pretrain as jpre
from nornicdb_tpu.models import qwen2 as jqwen
from nornicdb_tpu.models import weights as jweights
from nornicdb_tpu_torch import convert
from nornicdb_tpu_torch.models import bge_m3 as tbge
from nornicdb_tpu_torch.models import pretrain as tpre
from nornicdb_tpu_torch.models import qwen2 as tqwen
from nornicdb_tpu_torch.models import weights as tweights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ASSISTANT_MICRO = dict(steps=10, batch=8, seq_len=24, hidden=32, log_every=5)
ENCODER_MICRO = dict(steps=10, batch=8, hidden=32, dims=16, max_len=16,
                     log_every=5)
DISTILL_MICRO = dict(layers=1, steps=10, batch=8, log_every=5)
LOSS_RTOL = 2e-2


def _carried_qwen(cfg, seed=0, device=None):
    jcfg = jqwen.QwenConfig(**dataclasses.asdict(cfg))
    params = jqwen.init_params(jcfg, jax.random.PRNGKey(int(seed)))
    return convert.qwen2_params_from_jax(jax.tree.map(np.asarray, params),
                                         device)


def _carried_bge(cfg, seed=0, device=None):
    jcfg = jbge.BgeConfig(**dataclasses.asdict(cfg))
    params = jbge.init_params(jcfg, jax.random.PRNGKey(int(seed)))
    return convert.bge_params_from_jax(jax.tree.map(np.asarray, params),
                                       device)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """Micro runs of both packages from the same initial parameters: the
    port's init_params draw JAX's and carry them over."""
    root = tmp_path_factory.mktemp("micro")
    d = {k: str(root / k) for k in ("ja", "ta", "je", "te", "jd", "td")}
    out = {"dirs": d}
    out["ja"] = jpre.train_assistant(d["ja"], **ASSISTANT_MICRO)
    out["je"] = jpre.train_encoder(d["je"], **ENCODER_MICRO)
    out["jd"] = jpre.distill_encoder(d["je"], d["jd"], **DISTILL_MICRO)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tqwen, "init_params", _carried_qwen)
        mp.setattr(tbge, "init_params", _carried_bge)
        out["ta"] = tpre.train_assistant(d["ta"], device="cpu",
                                         **ASSISTANT_MICRO)
        out["te"] = tpre.train_encoder(d["te"], device="cpu",
                                       **ENCODER_MICRO)
        # distilled from the JAX teacher, so both students see one teacher
        out["td"] = tpre.distill_encoder(d["je"], d["td"], device="cpu",
                                         **DISTILL_MICRO)
    return out


class TestCorpora:
    @pytest.mark.parametrize("name,kwargs", [
        ("synth_corpus", {}),
        ("synth_corpus", {"seed": 3, "repeats": 5}),
        ("synth_action_corpus", {}),
        ("synth_action_corpus", {"seed": 2, "repeats": 1}),
        ("action_eval_cases", {}),
        ("_serving_preamble_lines", {}),
        ("_action_pairs", {}),
    ])
    def test_equal_to_jax(self, name, kwargs):
        assert getattr(tpre, name)(**kwargs) == getattr(jpre, name)(**kwargs)

    def test_tables_equal_to_jax(self):
        for name in ("_CAPITALS", "_GRAPH_FACTS", "_QA_TEMPLATES", "_LABELS",
                     "_ACTION_INTENTS", "_STATUS_PROMPTS", "_ACTION_LABELS",
                     "_SERVED_TAIL"):
            assert getattr(tpre, name) == getattr(jpre, name), name

    def test_augment_equal_for_one_rng(self):
        texts = jpre.synth_corpus(0, repeats=1)[:40] + ["", "one"]
        ja, ta = np.random.default_rng(11), np.random.default_rng(11)
        for t in texts:
            assert tpre._augment(t, ta) == jpre._augment(t, ja)
        assert ta.random() == ja.random()  # the same draws were taken


def _loss_close(port: dict, ref: dict) -> None:
    for key in ("loss_first", "loss_last"):
        assert abs(port[key] - ref[key]) <= LOSS_RTOL * abs(ref[key]), (
            key, port, ref)


def _same_bits(port_params, jax_params) -> None:
    """Every tensor of the two loaded trees equal bit for bit."""
    ft = tweights.flatten_params(port_params)
    fj = jweights.flatten_params(jax_params)
    assert set(ft) == set(fj)
    for name, t in ft.items():
        want = convert._leaf_to_torch(fj[name], torch.device("cpu"))
        assert t.dtype == want.dtype and torch.equal(t.cpu(), want), name


class TestMicroRuns:
    def test_assistant_losses_match_jax(self, micro):
        port, ref = micro["ta"], micro["ja"]
        _loss_close(port, ref)
        assert {k: port[k] for k in ("steps", "vocab", "tokens")} == {
            k: ref[k] for k in ("steps", "vocab", "tokens")}

    def test_encoder_losses_match_jax(self, micro):
        _loss_close(micro["te"], micro["je"])
        assert set(micro["te"]) == set(micro["je"])

    def test_distill_matches_jax(self, micro):
        port, ref = micro["td"], micro["jd"]
        _loss_close(port, ref)
        assert abs(port["agreement"] - ref["agreement"]) <= 0.02
        assert set(port) == set(ref)
        assert (port["teacher_layers"], port["student_layers"]) == (
            ref["teacher_layers"], ref["student_layers"])

    @pytest.mark.parametrize("pair", [("ta", "ja"), ("te", "je"),
                                      ("td", "jd")])
    def test_config_json_is_the_jax_layout(self, micro, pair):
        port_dir, jax_dir = (micro["dirs"][p] for p in pair)
        with open(os.path.join(port_dir, "config.json")) as f:
            port = json.load(f)
        with open(os.path.join(jax_dir, "config.json")) as f:
            ref = json.load(f)
        # both students name the same teacher directory ("je")
        assert port == ref
        with open(os.path.join(port_dir, "vocab.json")) as a, open(
                os.path.join(jax_dir, "vocab.json")) as b:
            assert json.load(a) == json.load(b)

    @pytest.mark.parametrize("name", ["ta", "ja"])
    def test_assistant_checkpoints_load_both_ways(self, micro, name):
        d = micro["dirs"][name]
        port = tpre.load_generator(d, device="cpu")
        ref = jpre.load_generator(d)
        _same_bits(port.params, ref.params)
        assert port.max_context == ref.max_context == ASSISTANT_MICRO[
            "seq_len"]

    @pytest.mark.parametrize("name", ["te", "je", "td", "jd"])
    def test_encoder_checkpoints_load_both_ways(self, micro, name):
        d = micro["dirs"][name]
        port = tpre.load_embedder(d, device="cpu")
        ref = jpre.load_embedder(d)
        _same_bits(port.params, ref.params)
        assert port.cfg == tbge.BgeConfig(**dataclasses.asdict(ref.cfg))
        assert port.max_len == ref.max_len
        text = "the capital of norway is oslo."
        got = np.asarray(port.embed(text))
        want = np.asarray(ref.embed(text), np.float32)
        assert float(got @ want) >= 0.99  # bf16 forwards, same weights

    def test_checkpoints_reject_the_other_kind(self, micro):
        d = micro["dirs"]
        with pytest.raises(ValueError):
            tpre.load_generator(d["te"], device="cpu")
        with pytest.raises(ValueError):
            tpre.load_embedder(d["ta"], device="cpu")
        with pytest.raises(ValueError):
            tpre.distill_encoder(d["ta"], d["ta"] + "-x", device="cpu")


@pytest.fixture(scope="module")
def assistant_ckpt(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("assistant"))
    # tests/test_pretrain.py's settings
    stats = tpre.train_assistant(out, steps=450, batch=16, seq_len=48,
                                 hidden=96, log_every=100, device="cpu")
    return out, stats


@pytest.fixture(scope="module")
def encoder_ckpt(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("encoder"))
    stats = tpre.train_encoder(out, steps=120, batch=16, hidden=64, dims=32,
                               log_every=40, device="cpu")
    return out, stats


def _capitals_learned(gen) -> tuple[int, dict]:
    correct, answers = 0, {}
    for country, capital in tpre._CAPITALS.items():
        ids = gen.tokenizer.encode(f"the capital of {country} is",
                                   add_special=False)
        toks = gen.qwen2.generate(gen.params, gen.cfg, ids, max_new_tokens=4,
                                  eos_id=gen.tokenizer.eos_id)
        answers[country] = gen.tokenizer.decode(toks)
        correct += capital in answers[country]
    return correct, answers


class TestLearning:
    """The learning checks of tests/test_pretrain.py on the port's trainer:
    random weights cannot pass them."""

    def test_assistant_loss_drops_and_facts_learned(self, assistant_ckpt):
        out, stats = assistant_ckpt
        assert stats["loss_last"] < stats["loss_first"] * 0.3, stats
        correct, answers = _capitals_learned(
            tpre.load_generator(out, device="cpu"))
        assert correct >= 8, answers

    def test_encoder_loss_drops_and_retrieval_works(self, encoder_ckpt):
        out, stats = encoder_ckpt
        assert stats["loss_last"] < stats["loss_first"], stats
        emb = tpre.load_embedder(out, device="cpu")
        docs = [
            "the capital of norway is oslo.",
            "match finds nodes and return sends them back.",
            "memory decay lowers the score of unused memories over time.",
        ]
        queries = ["capital norway oslo", "match return nodes",
                   "decay unused memories"]
        dv = np.stack(emb.embed_batch(docs))
        qv = np.stack(emb.embed_batch(queries))
        top1 = (qv @ dv.T).argmax(axis=1)
        assert (top1 == np.arange(3)).sum() >= 2, top1

    def test_distill_student_agrees_and_serves(self, encoder_ckpt, tmp_path):
        teacher_dir, _ = encoder_ckpt
        out = str(tmp_path / "student")
        stats = tpre.distill_encoder(teacher_dir, out, layers=1, steps=150,
                                     batch=16, log_every=50, device="cpu")
        assert stats["loss_last"] < stats["loss_first"]
        assert stats["agreement"] > 0.7, stats
        assert stats["student_layers"] < stats["teacher_layers"]
        student = tpre.load_embedder(out, device="cpu")
        teacher = tpre.load_embedder(teacher_dir, device="cpu")
        docs = [
            "cypher is the query language for the graph.",
            "the wal makes every write durable before it is acknowledged.",
            "vector search finds the most similar memories.",
        ]
        q = "which language queries the graph?"

        def rank(emb):
            dv = np.stack([emb.embed(d) for d in docs])
            return int(np.argmax(dv @ emb.embed(q)))

        assert rank(student) == rank(teacher)

    def test_pre_projection_checkpoint_still_loads(self, tmp_path):
        """Port twin of tests/test_pretrain.py's: dims != hidden but no proj
        tensors loads with its true output width (hidden)."""
        d = str(tmp_path)
        cfg = tbge.BgeConfig(vocab_size=64, hidden=64, layers=1, heads=4,
                             intermediate=128, max_positions=40, dims=32,
                             pad_token_id=1)
        params = tbge.init_params(cfg, 0, "cpu")
        params.pop("proj")  # pre-projection files carry no proj tensors
        tweights.save_params(os.path.join(d, "model.safetensors"), params)
        tpre.VocabTokenizer.from_corpus(["hello world"]).save(
            os.path.join(d, "vocab.json"))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"kind": "bge", "vocab_size": 64, "hidden": 64,
                       "layers": 1, "heads": 4, "intermediate": 128,
                       "max_positions": 40, "dims": 32, "pad_token_id": 1}, f)
        emb = tpre.load_embedder(d, device="cpu")
        assert np.asarray(emb.embed_batch(["hello"])).shape == (1, 64)


class TestTrainCommand:
    def test_train_encoder_prints_the_jax_keys(self, tmp_path, micro):
        out = str(tmp_path / "enc")
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        res = subprocess.run(
            [sys.executable, "-m", "nornicdb_tpu_torch", "train", "encoder",
             "--steps", "5", "--device", "cpu", "--out", out],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 0, res.stderr
        line = json.loads(res.stdout.strip().splitlines()[-1])
        # nornicdb_tpu/cli.py cmd_train: {"model", "out", **stats}
        assert set(line) == {"model", "out"} | set(micro["je"])
        assert line["model"] == "encoder" and line["steps"] == 5
        assert sorted(os.listdir(out)) == ["config.json", "model.safetensors",
                                           "vocab.json"]

    def test_device_defaults_to_the_card(self, tmp_path):
        from nornicdb_tpu_torch import DeviceUnavailable
        from nornicdb_tpu_torch.cli import main

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(DeviceUnavailable):
            main(["train", "encoder", "--steps", "1",
                  "--out", str(tmp_path / "x")])
        assert not os.path.exists(tmp_path / "x")
