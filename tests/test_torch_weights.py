"""Safetensors checkpoints of the port (``nornicdb_tpu_torch.models.weights``)
against the JAX package's ``nornicdb_tpu.models.weights``, on the CPU.

A file either package writes loads on the other bit for bit, for every
dtype of the format (bf16 included: the JAX package decodes it to float32,
the port to ``torch.bfloat16``, and the two hold the same values); the
same parameters make byte-identical files. Special values (-0.0, inf, nan)
are compared by their bits.
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.models import qwen2 as JQ
from nornicdb_tpu.models import weights as JW
from nornicdb_tpu_torch.convert import qwen2_params_from_jax
from nornicdb_tpu_torch.models import qwen2 as TQ
from nornicdb_tpu_torch.models import weights as TW

JCFG = JQ.QWEN_SMALL  # bf16, as checkpoints are written
TCFG = TQ.QWEN_SMALL
JPARAMS = JQ.init_params(JCFG, jax.random.PRNGKey(0))
TPARAMS = qwen2_params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")

_SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -2.5,
                     3.0e-39, 65504.0])


def _arrays() -> dict[str, np.ndarray]:
    """One numpy array a safetensors dtype, from a fixed seed: floats hold
    special values beside random ones, bf16 as ml_dtypes' bfloat16."""
    rng = np.random.default_rng(0)
    floats = np.concatenate([_SPECIAL, rng.standard_normal(23) * 100])
    out = {
        "F64": floats.astype(np.float64).reshape(4, 8),
        "F32": floats.astype(np.float32).reshape(2, 16),
        "F16": floats.astype(np.float16).reshape(32),
        "BF16": np.asarray(jnp.asarray(floats.astype(np.float32),
                                       jnp.bfloat16)).reshape(8, 4),
        "I64": rng.integers(-2**62, 2**62, (3, 5), dtype=np.int64),
        "I32": rng.integers(-2**31, 2**31 - 1, (7,), dtype=np.int32),
        "I16": rng.integers(-2**15, 2**15 - 1, (2, 3, 2), dtype=np.int16),
        "I8": rng.integers(-128, 127, (9,), dtype=np.int8),
        "U8": rng.integers(0, 255, (4, 4), dtype=np.uint8),
        "BOOL": rng.random((5, 2)) > 0.5,
        "scalar": np.array(1.25, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }
    assert set(JW._DTYPES) <= set(out)
    return out


def _bits(x) -> np.ndarray:
    """The raw bits of a numpy array or tensor, as unsigned integers (bool
    as uint8)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    if x.dtype == np.bool_:
        return x.view(np.uint8)
    return x.view(f"u{x.dtype.itemsize}")


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _header(path) -> dict:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n))


class TestFilesCrossBitForBit:
    def test_jax_file_loads_in_port(self, tmp_path):
        arrays = _arrays()
        path = str(tmp_path / "jax.safetensors")
        JW.save_safetensors(path, arrays)
        got = TW.load_safetensors(path)
        assert list(got) == list(arrays)
        for name, want in arrays.items():
            t = got[name]
            assert tuple(t.shape) == want.shape, name
            assert t.device.type == "cpu"
            if want.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16
            else:
                assert t.dtype == torch.from_numpy(want).dtype, name
            np.testing.assert_array_equal(_bits(t), _bits(want), err_msg=name)

    def test_port_file_loads_in_jax(self, tmp_path):
        arrays = _arrays()
        path = str(tmp_path / "port.safetensors")
        TW.save_safetensors(path, {k: _as_tensor(a) for k, a in arrays.items()})
        got = JW.load_safetensors(path)
        assert list(got) == list(arrays)
        for name, want in arrays.items():
            if want.dtype.name == "bfloat16":
                # the JAX reader decodes bf16 to float32
                want = want.astype(np.float32)
            assert got[name].dtype == want.dtype, name
            np.testing.assert_array_equal(_bits(got[name]), _bits(want),
                                          err_msg=name)

    def test_same_tensors_make_byte_identical_files(self, tmp_path):
        arrays = _arrays()
        jpath, tpath = tmp_path / "j.safetensors", tmp_path / "t.safetensors"
        JW.save_safetensors(str(jpath), arrays)
        TW.save_safetensors(str(tpath),
                            {k: _as_tensor(a) for k, a in arrays.items()})
        assert tpath.read_bytes() == jpath.read_bytes()

    def test_unsupported_dtype_refused(self, tmp_path):
        with pytest.raises(ValueError, match="unsupported"):
            TW.save_safetensors(str(tmp_path / "x"),
                                {"c": torch.zeros(2, dtype=torch.complex64)})


class TestParams:
    def test_derived_f32_table_never_written(self, tmp_path):
        """A tree holding ``tok_emb_f32`` (the engine's and the generators'
        params) saves the JAX tree's names and bytes."""
        jpath, tpath = tmp_path / "j.safetensors", tmp_path / "t.safetensors"
        # the converted tree holds jax.tree.map's (sorted) key order: the
        # JAX file is written from a tree in that order
        JW.save_params(str(jpath), jax.tree.map(np.asarray, JPARAMS))
        served = TQ.with_f32_logit_weights(TPARAMS)
        assert "tok_emb_f32" in served
        TW.save_params(str(tpath), served)
        names = list(_header(tpath))
        assert "tok_emb_f32" not in names
        assert sorted(names) == sorted(JW.flatten_params(JPARAMS))
        assert tpath.read_bytes() == jpath.read_bytes()

    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_jax_checkpoint_onto_port_template(self, tmp_path, dtype):
        """JAX-written bf16 parameters onto a port template of either dtype:
        the same values as the JAX loader gives, on the named device, with
        the template's dtypes and shapes."""
        path = str(tmp_path / "model.safetensors")
        JW.save_params(path, JPARAMS)
        tcfg = dataclasses.replace(TCFG, dtype=dtype)
        template = TQ.init_params(tcfg, 0, "cpu")
        got = TW.load_params(path, template, device="cpu")
        jcfg = dataclasses.replace(JCFG, dtype=dtype)
        want = JW.load_params(path, JQ.init_params(jcfg,
                                                   jax.random.PRNGKey(1)))
        flat_got = TW.flatten_params(got)
        flat_want = JW.flatten_params(want)
        flat_tmpl = TW.flatten_params(template)
        assert sorted(flat_got) == sorted(flat_want)
        for name, t in flat_got.items():
            assert t.device.type == "cpu"
            assert t.dtype == flat_tmpl[name].dtype, name
            assert t.shape == flat_tmpl[name].shape, name
            np.testing.assert_array_equal(_bits(t), _bits(flat_want[name]),
                                          err_msg=name)

    def test_port_checkpoint_into_jax(self, tmp_path):
        path = str(tmp_path / "model.safetensors")
        TW.save_params(path, TQ.with_f32_logit_weights(TPARAMS))
        got = JW.load_params(path, JPARAMS)
        jax.tree.map(
            lambda a, b: np.testing.assert_array_equal(_bits(np.asarray(a)),
                                                       _bits(np.asarray(b))),
            got, JPARAMS)

    def test_round_trip_drops_derived_leaves_of_the_template(self, tmp_path):
        path = str(tmp_path / "model.safetensors")
        TW.save_params(path, TPARAMS)
        got = TW.load_params(path, TQ.with_f32_logit_weights(TPARAMS),
                             device="cpu")
        assert "tok_emb_f32" not in got
        want = TW.flatten_params(TPARAMS)
        flat = TW.flatten_params(got)
        assert list(flat) == list(want)
        for name, t in flat.items():
            np.testing.assert_array_equal(_bits(t), _bits(want[name]),
                                          err_msg=name)
