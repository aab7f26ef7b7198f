"""The port's synchronous generation paths against the JAX package's, on the
CPU: ``qwen2.decode`` / ``qwen2.generate``, Heimdall's ``QwenGenerator`` and
``EngineGenerator``, and ``pretrain.load_generator``.

The same numpy-seeded prompts go through both packages on QWEN_SMALL with
the JAX parameters carried over (``convert.qwen2_params_from_jax``).
Greedy decoding is held to JAX's tokens: in float32 every token (the logits
agree within 1e-5, tests/test_torch_qwen2.py). In bf16 the random small
model's top-2 margins are mostly below the logit tolerance, so tokens may
part at the first step; there every port token's logit in JAX's dense path
(teacher-forced on the port's tokens) lies within BF16_LOGIT_TOL of JAX's
largest.

Sampling (``temperature > 0``) is not held to JAX's tokens:
``jax.random.categorical`` and a ``torch.Generator`` draw different tokens
from one seed. It is held to determinism for a seed, to greedy at a
near-zero temperature, and to ``softmax(logits / T)`` by a chi-square test
(p = 1e-6) over many draws.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from nornicdb_tpu.backend import BackendManager, FakeHooks
from nornicdb_tpu.config import GenServeConfig as JaxGenServeConfig
from nornicdb_tpu.genserve import GenerationEngine as JaxEngine
from nornicdb_tpu.heimdall import EngineGenerator as JaxEngineGenerator
from nornicdb_tpu.heimdall import QwenGenerator as JaxQwenGenerator
from nornicdb_tpu.models import pretrain as JP
from nornicdb_tpu.models import qwen2 as JQ
from nornicdb_tpu.models import weights as JW
from nornicdb_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from nornicdb_tpu_torch.config import GenServeConfig
from nornicdb_tpu_torch.convert import qwen2_params_from_jax
from nornicdb_tpu_torch.genserve import GenerationEngine
from nornicdb_tpu_torch.heimdall import EngineGenerator, QwenGenerator
from nornicdb_tpu_torch.models import pretrain as TP
from nornicdb_tpu_torch.models import qwen2 as TQ
from nornicdb_tpu_torch.models import weights as TW
from nornicdb_tpu_torch.models.tokenizer import HashTokenizer

BF16_LOGIT_TOL = 2e-2  # tests/test_torch_qwen2.py
CHI2_P = 1e-6


def _models(dt: str):
    jcfg = dataclasses.replace(JQ.QWEN_SMALL, dtype=dt)
    tcfg = dataclasses.replace(TQ.QWEN_SMALL, dtype=dt)
    jp = JQ.init_params(jcfg, jax.random.PRNGKey(0))
    tp = qwen2_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


F32 = _models("float32")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    return (request.param,) + (F32 if request.param == "float32"
                               else _models(request.param))


def _prompt(n: int, seed: int = 0, vocab: int = 512) -> list[int]:
    rng = np.random.default_rng(seed * 1000 + n)
    return [int(x) for x in rng.integers(4, vocab, n)]


def _jax_shortfalls(jp, jcfg, prompt, toks, max_len) -> np.ndarray:
    """At each generated position, JAX's largest logit less its logit of the
    token in ``toks``, teacher-forced on ``toks`` through its dense path
    (prefill + decode_step)."""
    logits, caches = JQ.prefill(jp, jcfg, jnp.asarray([prompt], jnp.int32),
                                max_len)
    out = []
    for j, tok in enumerate(toks):
        row = np.asarray(logits[0], np.float32)
        out.append(row.max() - row[tok])
        if j + 1 < len(toks):
            logits, caches = JQ.decode_step(
                jp, jcfg, jnp.asarray([tok], jnp.int32), caches,
                jnp.asarray(len(prompt) + j))
    return np.asarray(out)


class TestDecodeAndGenerate:
    @pytest.mark.parametrize("plen,max_new", [(1, 12), (7, 20), (33, 9),
                                              (64, 16)])
    def test_greedy_generate_matches_jax(self, model, plen, max_new):
        dt, jcfg, jp, tcfg, tp = model
        for seed in range(3):
            prompt = _prompt(plen, seed)
            want = JQ.generate(jp, jcfg, prompt, max_new_tokens=max_new)
            got = TQ.generate(tp, tcfg, prompt, max_new_tokens=max_new)
            assert len(got) == max_new
            if dt == "float32":
                assert got == want
            else:
                short = _jax_shortfalls(jp, jcfg, prompt, got, plen + max_new)
                assert short.max() <= BF16_LOGIT_TOL, (short, want, got)

    def test_greedy_decode_matches_jax_batched(self):
        """decode over a batch of two prompts of one length, from the same
        prefill: (B, steps) tokens equal to JAX's."""
        jcfg, jp, tcfg, tp = F32
        prompts = [_prompt(11, 1), _prompt(11, 2)]
        max_len, steps = 11 + 14, 13
        jl, jc = JQ.prefill(jp, jcfg, jnp.asarray(prompts, jnp.int32), max_len)
        tl, tc = TQ.prefill(tp, tcfg, torch.tensor(prompts), max_len)
        jfirst = jnp.argmax(jl, axis=-1)
        tfirst = torch.argmax(tl, dim=-1)
        assert tfirst.tolist() == np.asarray(jfirst).tolist()
        want = JQ.decode(jp, jcfg, jfirst, jc, jnp.asarray(11), steps=steps)
        got = TQ.decode(tp, tcfg, tfirst, tc, 11, steps=steps)
        assert got.shape == (2, steps)
        assert got.tolist() == np.asarray(want).tolist()

    def test_eos_forcing_and_truncation(self):
        """An eos taken from the middle of the free greedy output: decode
        emits eos for every later step of that row, generate cuts before
        it, both as JAX does."""
        jcfg, jp, tcfg, tp = F32
        prompt = _prompt(9, 4)
        free = TQ.generate(tp, tcfg, prompt, max_new_tokens=16)
        eos = free[5]
        idx = free.index(eos)
        want = JQ.generate(jp, jcfg, prompt, max_new_tokens=16, eos_id=eos)
        got = TQ.generate(tp, tcfg, prompt, max_new_tokens=16, eos_id=eos)
        assert got == want == free[:idx]
        logits, caches = TQ.prefill(tp, tcfg, torch.tensor([prompt]), 9 + 16)
        first = torch.argmax(logits, dim=-1)
        toks = TQ.decode(tp, tcfg, first, caches, 9, steps=15,
                         eos_id=eos)[0].tolist()
        jl, jc = JQ.prefill(jp, jcfg, jnp.asarray([prompt], jnp.int32), 25)
        jtoks = np.asarray(JQ.decode(jp, jcfg, jnp.argmax(jl, axis=-1), jc,
                                     jnp.asarray(9), steps=15,
                                     eos_id=eos))[0].tolist()
        assert toks == jtoks
        k = toks.index(eos)
        assert toks[k:] == [eos] * (15 - k)

    def test_one_new_token(self):
        jcfg, jp, tcfg, tp = F32
        for seed in range(3):
            prompt = _prompt(6, seed)
            got = TQ.generate(tp, tcfg, prompt, max_new_tokens=1)
            assert got == JQ.generate(jp, jcfg, prompt, max_new_tokens=1)
            assert len(got) == 1
        logits, caches = TQ.prefill(tp, tcfg, torch.tensor([prompt]), 7)
        assert TQ.decode(tp, tcfg, torch.argmax(logits, -1), caches, 6,
                         steps=0).shape == (1, 0)
        # an eos as the first token: nothing is returned, as in JAX
        eos = got[0]
        assert TQ.generate(tp, tcfg, prompt, 1, eos_id=eos) == [] == \
            JQ.generate(jp, jcfg, prompt, 1, eos_id=eos)


    def test_step_at_a_device_position_is_decode_step(self, model):
        """The step body that ``DecodeGraph`` captures, fed its position as
        a (1,) tensor, gives decode_step's logits and caches bit for bit."""
        dt, jcfg, jp, tcfg, tp = model
        prompt = _prompt(13, 5)
        max_len = 32
        logits, ref = TQ.prefill(tp, tcfg, torch.tensor([prompt]), max_len)
        _, cur = TQ.prefill(tp, tcfg, torch.tensor([prompt]), max_len)
        angles = TQ._angles(tcfg.hidden // tcfg.heads, max_len,
                            tcfg.rope_theta, torch.device("cpu"))
        tok = torch.argmax(logits, dim=-1)
        for pos in range(13, 20):
            want, ref = TQ.decode_step(tp, tcfg, tok, ref, pos)
            got, cur = TQ._cached_step(tp, tcfg, tok, cur,
                                       torch.tensor([pos]), angles)
            assert torch.equal(got, want), pos
            for (ck, cv), (rk, rv) in zip(cur, ref):
                assert torch.equal(ck, rk) and torch.equal(cv, rv)
            tok = torch.argmax(want, dim=-1)


class TestSampling:
    def test_same_seed_same_tokens_other_seed_differs(self):
        jcfg, jp, tcfg, tp = F32
        prompts = [_prompt(n, 5) for n in (3, 8, 13, 21)]
        def sampled(seed):
            return [TQ.generate(tp, tcfg, p, 16, temperature=0.8, seed=seed)
                    for p in prompts]

        first, again, other = sampled(7), sampled(7), sampled(8)
        assert first == again
        assert other != first
        greedy = [TQ.generate(tp, tcfg, p, 16) for p in prompts]
        assert first != greedy
        # the first token is the prefill's argmax at any temperature
        assert [r[0] for r in other] == [g[0] for g in greedy]
        assert all(0 <= t < tcfg.vocab_size for r in other for t in r)

    def test_near_zero_temperature_is_greedy(self, model):
        dt, jcfg, jp, tcfg, tp = model
        for seed in range(4):
            prompt = _prompt(10, seed)
            assert TQ.generate(tp, tcfg, prompt, 16, temperature=1e-7,
                               seed=seed) == TQ.generate(tp, tcfg, prompt, 16)

    @pytest.mark.parametrize("scale,temperature", [(1.0, 1.0), (30.0, 0.8)])
    def test_draws_follow_softmax(self, scale, temperature):
        """64,000 draws from one row of real logits (scaled, so one case is
        near uniform and one peaked) against softmax(logits / T): cells
        expected below 5 draws are pooled; the chi-square statistic stays
        under its 1 - 1e-6 quantile."""
        jcfg, jp, tcfg, tp = F32
        logits, _ = TQ.prefill(tp, tcfg, torch.tensor([_prompt(12, 9)]), 16)
        row = logits[0] * scale
        n = 64_000
        gen = torch.Generator()
        gen.manual_seed(3)
        draws = torch.cat([
            TQ.sample_tokens(row.expand(8_000, -1), temperature, gen)
            for _ in range(n // 8_000)])
        counts = np.bincount(draws.numpy(), minlength=row.shape[0])
        p = torch.softmax(row.double() / temperature, -1).numpy()
        expected = p * n
        big = expected >= 5
        obs = np.append(counts[big], counts[~big].sum())
        exp = np.append(expected[big], expected[~big].sum())
        keep = exp > 0
        stat = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
        bound = float(scipy.stats.chi2.ppf(1 - CHI2_P, keep.sum() - 1))
        assert stat < bound, (stat, bound)
        assert big.sum() >= 4  # the test had cells to compare

    def test_decode_samples_through_the_generator(self):
        """decode at T > 0 with a given generator equals the tokens its own
        loop of ``sample_tokens`` gives from the same state."""
        jcfg, jp, tcfg, tp = F32
        prompt = _prompt(5, 6)
        gen = torch.Generator()
        gen.manual_seed(11)
        logits, caches = TQ.prefill(tp, tcfg, torch.tensor([prompt]), 13)
        first = torch.argmax(logits, -1)
        got = TQ.decode(tp, tcfg, first, caches, 5, steps=7, temperature=0.7,
                        generator=gen)[0].tolist()
        gen.manual_seed(11)
        logits, caches = TQ.prefill(tp, tcfg, torch.tensor([prompt]), 13)
        tok, want = first, []
        for i in range(7):
            lg, caches = TQ.decode_step(tp, tcfg, tok, caches, 5 + i)
            tok = TQ.sample_tokens(lg, 0.7, gen)
            want.append(int(tok[0]))
        assert got == want


def _jax_engine(jcfg, jp, **kw):
    mgr = BackendManager(hooks=FakeHooks("ok"), acquire_timeout=0.5,
                         probe_interval=0.05, probe_timeout=0.4,
                         degrade_after=1, recover_after=1)
    # no deadline: the JAX engine's predictive admission reads a
    # process-wide cost model that other test files train
    cfg = JaxGenServeConfig(page_size=16, pool_pages=33, max_seqs=4,
                            max_seq_tokens=128, prefill_chunk=32,
                            deadline_ms=0, **kw)
    return mgr, JaxEngine(jp, jcfg, tokenizer=JaxHashTokenizer(jcfg.vocab_size),
                          config=cfg, manager=mgr)


def _port_engine(tcfg, tp, **kw):
    cfg = GenServeConfig(page_size=16, pool_pages=33, max_seqs=4,
                         max_seq_tokens=128, prefill_chunk=32, deadline_ms=0,
                         **kw)
    return GenerationEngine(tp, tcfg, tokenizer=HashTokenizer(tcfg.vocab_size),
                            config=cfg, device="cpu")


def _texts(n: int, seed: int, words: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{x}" for x in rng.integers(0, 300, words))
            for _ in range(n)]


class TestGenerators:
    def test_qwen_generator_matches_jax(self):
        jcfg, jp, tcfg, tp = F32
        jgen = JaxQwenGenerator(cfg=jcfg, params=jp,
                                tokenizer=JaxHashTokenizer(jcfg.vocab_size),
                                max_context=24)
        tgen = QwenGenerator(cfg=tcfg, params=tp,
                             tokenizer=HashTokenizer(tcfg.vocab_size),
                             max_context=24, device="cpu")
        assert tgen.params["tok_emb_f32"].dtype == torch.float32
        # the last prompt is longer than max_context: its tail is kept
        for text in _texts(3, 0, 9) + _texts(1, 1, 40):
            for max_tokens in (1, 12, 100):
                want = jgen.generate(text, max_tokens)
                assert tgen.generate(text, max_tokens) == want
                stream = list(tgen.generate_stream(text, max_tokens))
                assert "".join(stream) == "".join(
                    jgen.generate_stream(text, max_tokens))
                assert "".join(stream) == want
                # max_tokens beyond the window is capped to max_context
                assert len(want.split()) == min(max_tokens, 24)
        assert tgen.generate_many(["a b", "c"], 4) == [
            tgen.generate("a b", 4), tgen.generate("c", 4)]

    def test_qwen_generator_defaults(self):
        gen = QwenGenerator(device="cpu")
        assert gen.cfg == TQ.QWEN_SMALL and gen.max_context == 256
        assert isinstance(gen.tokenizer, HashTokenizer)
        assert gen.params["tok_emb"].device.type == "cpu"
        assert gen.generate("hello", 3).count("<") == 3

    def test_engine_generator_matches_jax(self):
        jcfg, jp, tcfg, tp = F32
        mgr, jeng = _jax_engine(jcfg, jp)
        teng = _port_engine(tcfg, tp)
        try:
            jgen = JaxEngineGenerator(jeng, max_context=32)
            tgen = EngineGenerator(teng, max_context=32)
            assert tgen.cfg is tcfg and tgen.params is teng.params
            texts = _texts(5, 2, 11) + _texts(1, 3, 60)
            want = jgen.generate_many(texts, 10)
            assert tgen.generate_many(texts, 10) == want
            assert [tgen.generate(t, 10) for t in texts] == want
            for text, whole in zip(texts[:3], want):
                assert "".join(tgen.generate_stream(text, 10)) == whole
            # the QC batch rode one continuous batch
            assert teng.stats.decode_steps < teng.stats.generated_tokens
        finally:
            teng.stop()
            jeng.stop()
            mgr.stop()


def _write_checkpoint(path, params, cfg, tok, trained_seq_len, dtype=None):
    """A checkpoint directory as the JAX package's ``train_assistant``
    writes it (config.json, model.safetensors, vocab.json), through its
    own writers; ``dtype`` adds the config's dtype field."""
    os.makedirs(path, exist_ok=True)
    c = {"kind": "qwen2", "vocab_size": cfg.vocab_size, "hidden": cfg.hidden,
         "layers": cfg.layers, "heads": cfg.heads, "kv_heads": cfg.kv_heads,
         "intermediate": cfg.intermediate,
         "max_positions": cfg.max_positions, "rope_theta": cfg.rope_theta,
         "trained_seq_len": trained_seq_len}
    if dtype is not None:
        c["dtype"] = dtype
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f)
    JW.save_params(os.path.join(path, "model.safetensors"), params)
    tok.save(os.path.join(path, "vocab.json"))


class TestLoadGenerator:
    CORPUS = ["the graph holds nodes and edges .",
              "a node has labels , and an edge has a type !",
              "vector search finds the nearest memories"]

    def test_vocab_tokenizer_is_the_jax_one(self, tmp_path):
        jtok = JP.VocabTokenizer.from_corpus(self.CORPUS, max_vocab=20)
        ttok = TP.VocabTokenizer.from_corpus(self.CORPUS, max_vocab=20)
        assert ttok.itos == jtok.itos and ttok.vocab_size == jtok.vocab_size
        text = "The graph, and an unknown node!"
        assert ttok.encode(text) == jtok.encode(text)
        assert ttok.encode_batch([text, "a"], 4) == jtok.encode_batch(
            [text, "a"], 4)
        ids = ttok.encode(text, add_special=False) + [2, 5]
        assert ttok.decode(ids) == jtok.decode(ids)
        jtok.save(str(tmp_path / "v.json"))
        assert TP.VocabTokenizer.load(str(tmp_path / "v.json")).itos == \
            jtok.itos

    def test_jax_checkpoint_generates_jax_tokens(self, tmp_path):
        """A float32 checkpoint directory written by the JAX package's
        writers: the port's load_generator gives the JAX loader's text."""
        jcfg = dataclasses.replace(JQ.QWEN_SMALL, dtype="float32")
        jp = JQ.init_params(jcfg, jax.random.PRNGKey(2))
        tok = JP.VocabTokenizer.from_corpus(self.CORPUS)
        d = str(tmp_path / "ckpt")
        _write_checkpoint(d, jp, jcfg, tok, 48, dtype="float32")
        want = JP.load_generator(d)
        got = TP.load_generator(d, device="cpu")
        assert isinstance(got, QwenGenerator)
        assert got.cfg == dataclasses.replace(TQ.QWEN_SMALL, dtype="float32")
        assert got.max_context == want.max_context == 48
        assert got.tokenizer.itos == tok.itos
        for text in self.CORPUS + ["nodes " * 60]:
            assert got.generate(text, 20) == want.generate(text, 20)
            assert "".join(got.generate_stream(text, 20)) == \
                "".join(want.generate_stream(text, 20))

    def test_default_bf16_checkpoint_loads_bit_for_bit(self, tmp_path):
        """The directory as train_assistant writes it (no dtype field, so
        bf16 weights): the port's tensors hold the JAX loader's bits."""
        jp = JQ.init_params(JQ.QWEN_SMALL, jax.random.PRNGKey(3))
        d = str(tmp_path / "ckpt")
        _write_checkpoint(d, jp, JQ.QWEN_SMALL,
                          JP.VocabTokenizer.from_corpus(self.CORPUS), 0)
        want = JW.flatten_params(JP.load_generator(d).params)
        got = TP.load_generator(d, device="cpu")
        assert got.max_context == 256
        flat = TW.flatten_params(got.params)
        assert sorted(flat) == sorted(want)
        for name, t in flat.items():
            w = np.asarray(want[name])
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy(), w.view(np.int16), err_msg=name)
            else:
                np.testing.assert_array_equal(t.numpy(), w, err_msg=name)

    def test_refuses_other_checkpoints(self, tmp_path):
        with open(tmp_path / "config.json", "w") as f:
            json.dump({"kind": "bge", "hidden": 8}, f)
        with pytest.raises(ValueError, match="not an assistant checkpoint"):
            TP.load_generator(str(tmp_path), device="cpu")
