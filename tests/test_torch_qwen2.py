"""The port's Qwen2 decoder (``nornicdb_tpu_torch.models``) against the JAX
package's, on the CPU.

The same inputs, made with numpy from fixed seeds, go through both; the JAX
parameters are carried over with ``convert.qwen2_params_from_jax``. Every
function is held against its JAX twin on QWEN_SMALL twice:

- float32: logits and real pool pages within 1e-5 (relative and absolute).
  Not bit-exact: XLA and torch compute cos/sin and order their sums
  differently on the CPU (the differences seen are below 3e-6).
- bfloat16: XLA rounds to bf16 after each elementwise op (silu, the gate
  product) where torch rounds once, so a hidden value can land a bf16 ulp
  away, and the K/V projections carry that as an absolute error at the
  scale of the whole row. Pool pages and caches (rope'd K/V, |x| < 8)
  within 2**-6 relative plus 2**-6 of the largest value (two bf16 ulps at
  the tensor's scale); logits (float32 products of the bf16 hidden state,
  |logit| < 1) within BF16_LOGIT_TOL absolute, and greedy ids equal
  wherever JAX's top-2 margin exceeds it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.models import layers as JL
from nornicdb_tpu.models import qwen2 as JQ
from nornicdb_tpu_torch.convert import qwen2_params_from_jax
from nornicdb_tpu_torch.models import layers as TL
from nornicdb_tpu_torch.models import qwen2 as TQ

DTYPES = ("float32", "bfloat16")
BF16_LOGIT_TOL = 2e-2
PAGE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _assert_kv(dt, want, got):
    want, got = _np(want), _np(got)
    tol = PAGE_TOL[dt]
    scale = 1.0 if dt == "float32" else float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module", params=DTYPES)
def model(request):
    """(dtype, JAX cfg, JAX params, port cfg, port params) on QWEN_SMALL."""
    dt = request.param
    jcfg = dataclasses.replace(JQ.QWEN_SMALL, dtype=dt)
    tcfg = dataclasses.replace(TQ.QWEN_SMALL, dtype=dt)
    jp = JQ.init_params(jcfg, jax.random.PRNGKey(0))
    tp = qwen2_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return dt, jcfg, jp, tcfg, tp


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_logits(dt, want, got) -> int:
    """Logits within the tolerance; greedy ids equal on every row (float32)
    or every row whose JAX top-2 margin exceeds it (bf16). Returns the
    number of rows whose ids were compared."""
    want, got = _np(want), _np(got)
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        clear = np.ones(want.shape[:-1], bool)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_TOL)
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > BF16_LOGIT_TOL
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])
    return int(clear.sum())


def _assert_pages(dt, want, got):
    """Real pages only (page 0 is the null/dump page)."""
    _assert_kv(dt, _np(want)[:, :, 1:], _np(got)[:, :, 1:])


def _prompt(n: int, seed: int = 0, vocab: int = 512) -> list[int]:
    rng = np.random.default_rng(seed * 1000 + n)
    return [int(x) for x in rng.integers(4, vocab, n)]


class TestLayers:
    @pytest.mark.parametrize("dt", DTYPES)
    def test_ops_match(self, dt):
        rng = np.random.default_rng(0)
        tdt = getattr(torch, dt)
        x = rng.standard_normal((2, 5, 32)).astype(np.float32)
        w = (rng.standard_normal((32, 24)) * 0.2).astype(np.float32)
        b = rng.standard_normal(24).astype(np.float32)
        scale = rng.random(32).astype(np.float32) + 0.5
        jx = jnp.asarray(x, dt)
        tx = torch.from_numpy(x).to(tdt)
        pairs = []
        for bias in (False, True):
            jp = {"w": jnp.asarray(w, dt)}
            tp = {"w": torch.from_numpy(w).to(tdt)}
            if bias:
                jp["b"], tp["b"] = jnp.asarray(b, dt), torch.from_numpy(b).to(tdt)
            pairs.append((JL.dense(jp, jx), TL.dense(tp, tx)))
        pairs.append((JL.rms_norm({"scale": jnp.asarray(scale)}, jx),
                      TL.rms_norm({"scale": torch.from_numpy(scale)}, tx)))
        ja = JL.rope_freqs(8, 5)
        ta = TL.rope_freqs(8, 5)
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
        kv = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
        jq, tq = jnp.asarray(q, dt), torch.from_numpy(q).to(tdt)
        pairs.append((JL.apply_rope(jq, ja), TL.apply_rope(tq, ta)))
        jk = JL.repeat_kv(jnp.asarray(kv, dt), 2)
        tk = TL.repeat_kv(torch.from_numpy(kv).to(tdt), 2)
        pairs.append((jk, tk))
        mask = np.where(np.arange(7)[None, :] <= np.arange(5)[:, None] + 2,
                        0.0, -1e30).astype(np.float32)
        pairs.append((JL.attention(jq, jk, jk, jnp.asarray(mask)[None, None]),
                      TL.attention(tq, tk, tk, torch.from_numpy(mask)[None, None])))
        # bf16: the same rounding points, so at most one bf16 ulp apart
        tol = 1e-6 if dt == "float32" else 2.0 ** -7
        for want, got in pairs:
            assert got.dtype == tdt
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


class TestDense:
    def test_forward(self, model):
        dt, jcfg, jp, tcfg, tp = model
        ids = np.random.default_rng(1).integers(4, 512, (2, 13)).astype(np.int32)
        want = JQ.forward(jp, jcfg, jnp.asarray(ids))
        got = TQ.forward(tp, tcfg, torch.from_numpy(ids).long())
        assert got.dtype == torch.float32 and got.shape == (2, 13, 512)
        assert _assert_logits(dt, want, got) > 0

    def test_prefill_and_decode_steps(self, model):
        dt, jcfg, jp, tcfg, tp = model
        prompt = _prompt(21, seed=2)
        jl, jc = JQ.prefill(jp, jcfg, jnp.asarray([prompt], jnp.int32), 64)
        tl, tc = TQ.prefill(tp, tcfg, torch.tensor([prompt]), 64)
        _assert_logits(dt, jl, tl)
        tok, pos = int(np.asarray(jl)[0].argmax()), len(prompt)
        for _ in range(4):
            jl, jc = JQ.decode_step(jp, jcfg, jnp.asarray([tok], jnp.int32), jc,
                                    jnp.asarray(pos))
            tl, tc = TQ.decode_step(tp, tcfg, torch.tensor([tok]), tc, pos)
            _assert_logits(dt, jl, tl)
            tok, pos = int(np.asarray(jl)[0].argmax()), pos + 1
        for (jk, jv), (tk, tv) in zip(jc, tc):
            _assert_kv(dt, jk, tk)
            _assert_kv(dt, jv, tv)


def _prefill_both(model, pool_pages, ps, tables, prompts, width=32):
    """paged_prefill_chunk of each prompt into its table's pages, on both
    sides. Returns (JAX pages, port pages, first tokens)."""
    dt, jcfg, jp, tcfg, tp = model
    pj = JQ.init_kv_pages(jcfg, pool_pages, ps)
    pt = TQ.init_kv_pages(tcfg, pool_pages, ps, "cpu")
    toks = []
    for table, prompt in zip(tables, prompts):
        chunk = prompt + [0] * (width - len(prompt))
        jl, pj = JQ.paged_prefill_chunk(
            jp, jcfg, jnp.asarray(chunk, jnp.int32), pj, jnp.asarray(table),
            jnp.asarray(0), jnp.asarray(len(prompt)))
        tl, pt = TQ.paged_prefill_chunk(
            tp, tcfg, torch.tensor(chunk), pt, torch.from_numpy(table), 0,
            len(prompt))
        _assert_logits(dt, jl, tl)
        toks.append(int(np.asarray(jl).argmax()))
    return pj, pt, toks


class TestPaged:
    def test_prefill_chunk_and_decode_step(self, model):
        dt, jcfg, jp, tcfg, tp = model
        tables = np.zeros((2, 4), np.int32)
        tables[0, :2], tables[1, :2] = [1, 2], [3, 4]
        prompts = [_prompt(7, seed=1), _prompt(19, seed=2)]
        pj, pt, toks = _prefill_both(model, 12, 16, tables, prompts)
        _assert_pages(dt, pj, pt)
        lengths = np.asarray([len(p) for p in prompts], np.int32)
        for _ in range(3):
            jl, pj = JQ.paged_decode_step(
                jp, jcfg, jnp.asarray(toks, jnp.int32), pj,
                jnp.asarray(tables), jnp.asarray(lengths))
            tl, pt = TQ.paged_decode_step(
                tp, tcfg, torch.tensor(toks), pt, torch.from_numpy(tables),
                torch.from_numpy(lengths))
            _assert_logits(dt, jl, tl)
            _assert_pages(dt, pj, pt)
            toks = [int(t) for t in np.asarray(jl).argmax(-1)]
            lengths = lengths + 1

    def test_prefill_chunk_mid_prompt(self, model):
        """A second chunk starting at slot 16 attends the first through the
        pool; padded positions write only the null page."""
        dt, jcfg, jp, tcfg, tp = model
        table = np.asarray([2, 5, 0, 0], np.int32)
        prompt = _prompt(27, seed=4)
        pj = JQ.init_kv_pages(jcfg, 8, 16)
        pt = TQ.init_kv_pages(tcfg, 8, 16, "cpu")
        for start in (0, 16):
            piece = prompt[start:start + 16]
            chunk = piece + [0] * (16 - len(piece))
            jl, pj = JQ.paged_prefill_chunk(
                jp, jcfg, jnp.asarray(chunk, jnp.int32), pj,
                jnp.asarray(table), jnp.asarray(start), jnp.asarray(len(piece)))
            tl, pt = TQ.paged_prefill_chunk(
                tp, tcfg, torch.tensor(chunk), pt, torch.from_numpy(table),
                start, len(piece))
            _assert_logits(dt, jl, tl)
        _assert_pages(dt, pj, pt)
        untouched = [1, 3, 4, 6, 7]
        assert bool((pt[:, :, untouched] == 0).all())


def _fused_meta(lmax, w, f, dec, chunk=None, chunk_table=None):
    """Packed metadata of one fused step: ``dec`` = [(token, position,
    table)] decode lanes, ``chunk`` = [(token, position)] rows of the chunk
    lane; the rest padding."""
    meta, (tokens, lane_id, lane_pos, positions, logit_rows,
           lane_tables) = JQ.pack_ragged_meta(lmax, w, f)
    tokens[:], lane_id[:], lane_pos[:], positions[:] = 0, lmax - 1, 0, -1
    logit_rows[:], lane_tables[:] = 0, 0
    for i, (tok, pos, table) in enumerate(dec):
        tokens[i], lane_id[i], positions[i], logit_rows[i] = tok, i, pos, i
        lane_tables[i] = table
    for j, (tok, pos) in enumerate(chunk or []):
        fi = len(dec) + j
        tokens[fi], lane_id[fi], lane_pos[fi], positions[fi] = (
            tok, lmax - 2, j, pos)
    if chunk:
        lane_tables[lmax - 2] = chunk_table
        logit_rows[len(dec)] = len(dec) + len(chunk) - 1
    return meta


class TestRaggedFusedStep:
    @pytest.mark.parametrize("attn_impl", TQ.ATTN_IMPLS)
    def test_decode_lanes_plus_mid_prompt_chunk(self, model, attn_impl):
        """Two decode lanes and the second chunk of a third prompt (slots
        16..36, behind a first chunk already in the pool) in one fused step:
        logits, greedy ids and pool pages against the JAX step (its "xla"
        path). "cuda" on CPU tensors runs the kernel's plain version."""
        dt, jcfg, jp, tcfg, tp = model
        ps, w, lmax, tq = 16, 4, 8, 32
        tables = np.zeros((3, w), np.int32)
        tables[0, :2], tables[1, :2], tables[2, :3] = [1, 2], [3, 4], [5, 6, 7]
        prompts = [_prompt(7, seed=1), _prompt(19, seed=2)]
        chunk_prompt = _prompt(37, seed=3)
        pj, pt, toks = _prefill_both(model, 12, ps, tables, prompts + [
            chunk_prompt[:16]], width=32)
        toks = toks[:2]
        rows = [(chunk_prompt[16 + j], 16 + j) for j in range(21)]
        meta = _fused_meta(lmax, w, 32, [
            (toks[i], len(prompts[i]), tables[i]) for i in range(2)],
            rows, tables[2])
        jid, jl, pj = JQ.ragged_fused_step(jp, jcfg, jnp.asarray(meta), pj,
                                           lmax=lmax, w=w, tq=tq,
                                           attn_impl="xla")
        tid, tl, pt = TQ.ragged_fused_step(tp, tcfg, torch.from_numpy(meta),
                                           pt, lmax=lmax, w=w, tq=tq,
                                           attn_impl=attn_impl)
        assert tid.shape == (lmax,) and tl.shape == (lmax, 512)
        _assert_logits(dt, np.asarray(jl)[:3], tl[:3])
        if dt == "float32":
            np.testing.assert_array_equal(tid.numpy()[:3], np.asarray(jid)[:3])
        _assert_pages(dt, pj, pt)

    @pytest.mark.parametrize("attn_impl", TQ.ATTN_IMPLS)
    def test_decode_only_step(self, model, attn_impl):
        """tq == 1: no chunk block; three lanes at mixed lengths, one of
        them across a page boundary."""
        dt, jcfg, jp, tcfg, tp = model
        ps, w, lmax = 16, 4, 6
        tables = np.zeros((3, w), np.int32)
        tables[0, :1], tables[1, :2], tables[2, :3] = [1], [2, 3], [4, 5, 6]
        prompts = [_prompt(n, seed=6) for n in (5, 16, 40)]
        pj, pt, toks = _prefill_both(model, 8, ps, tables, prompts, width=64)
        meta = _fused_meta(lmax, w, 8, [
            (toks[i], len(prompts[i]), tables[i]) for i in range(3)])
        _, jl, pj = JQ.ragged_fused_step(jp, jcfg, jnp.asarray(meta), pj,
                                         lmax=lmax, w=w, tq=1,
                                         attn_impl="xla")
        _, tl, pt = TQ.ragged_fused_step(tp, tcfg, torch.from_numpy(meta), pt,
                                         lmax=lmax, w=w, tq=1,
                                         attn_impl=attn_impl)
        _assert_logits(dt, np.asarray(jl)[:3], tl[:3])
        _assert_pages(dt, pj, pt)

    def test_unknown_attn_impl_refused(self, model):
        _, _, _, tcfg, tp = model
        pt = TQ.init_kv_pages(tcfg, 4, 16, "cpu")
        meta = _fused_meta(4, 2, 8, [(5, 0, np.asarray([1, 0], np.int32))])
        with pytest.raises(ValueError):
            TQ.ragged_fused_step(tp, tcfg, torch.from_numpy(meta), pt, lmax=4,
                                 w=2, tq=1, attn_impl="xla")


class TestHelpersAndParams:
    def test_pack_meta_and_buckets_match(self):
        jm, jv = JQ.pack_ragged_meta(6, 4, 16)
        tm, tv = TQ.pack_ragged_meta(6, 4, 16)
        assert jm.shape == tm.shape and jm.dtype == tm.dtype
        assert [v.shape for v in jv] == [v.shape for v in tv]
        for n in (1, 15, 16, 17, 64, 65, 300):
            assert TQ.round_up_pow2(n) == JQ.round_up_pow2(n)
            assert TQ.round_up_pow2(n, 8) == JQ.round_up_pow2(n, 8)
            assert TQ.pages_for(n, 16) == JQ.pages_for(n, 16)
        assert TQ.NULL_PAGE == JQ.NULL_PAGE

    def test_convert_is_bit_exact(self, model):
        dt, _, jp, _, tp = model
        jleaves = jax.tree.leaves(jp)
        tleaves = jax.tree.leaves(tp)
        assert len(jleaves) == len(tleaves)
        for a, b in zip(jleaves, tleaves):
            a = np.asarray(a)
            assert b.dtype == getattr(torch, str(a.dtype))
            assert tuple(b.shape) == a.shape
            if b.dtype == torch.bfloat16:
                np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                              a.view(np.int16))
            else:
                np.testing.assert_array_equal(b.numpy(), a)

    def test_init_params_layout_and_distributions(self, model):
        """Same tree, shapes and dtypes as the JAX init; the reference's
        distributions (the numbers differ: torch.Generator, not
        jax.random)."""
        dt, jcfg, jp, tcfg, _ = model
        tp = TQ.init_params(tcfg, seed=3, device="cpu")
        jl, _ = jax.tree.flatten(jax.tree.map(np.asarray, jp))
        tl, _ = jax.tree.flatten(tp)
        assert [(x.shape, str(x.dtype)) for x in jl] == [
            (tuple(x.shape), str(x.dtype).replace("torch.", "")) for x in tl]
        emb = tp["tok_emb"].float()
        assert abs(float(emb.std()) - 0.02) < 0.002
        blk = tp["blocks"][0]
        lim = float(np.sqrt(6.0 / (tcfg.hidden + tcfg.intermediate)))
        g = blk["gate"]["w"].float()
        assert float(g.abs().max()) <= lim * 1.01
        assert float(g.std()) == pytest.approx(lim / np.sqrt(3), rel=0.1)
        assert bool((blk["q"]["b"] == 0).all())
        assert bool((blk["attn_norm"]["scale"] == 1).all())
        assert blk["attn_norm"]["scale"].dtype == torch.float32
        again = TQ.init_params(tcfg, seed=3, device="cpu")
        assert torch.equal(again["tok_emb"], tp["tok_emb"])

    def test_f32_logit_weights_give_the_same_logits(self, model):
        dt, _, _, tcfg, tp = model
        ids = torch.tensor([[5, 9, 300]])
        a = TQ.forward(tp, tcfg, ids)
        b = TQ.forward(TQ.with_f32_logit_weights(tp), tcfg, ids)
        assert torch.equal(a, b)
