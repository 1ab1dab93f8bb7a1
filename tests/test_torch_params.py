"""PyTorch port: carrying JAX parameters across, and the port's own
parameter initialiser (same strategies and std rules, its own draws)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config
from paddle_tpu.trainer.trainer import Trainer
from paddle_tpu_torch.config.schema import ModelConfig, ParameterConfig
from paddle_tpu_torch.models import transformer_lm_config
from paddle_tpu_torch.parameter import init_params, params_from_jax


def test_params_from_jax_round_trip(tmp_path):
    """Trainer.params (and the same arrays through an .npz file) carry over
    by name with shapes, dtypes and values unchanged."""
    cfg = parse_config("demo/model_zoo/transformer_lm.py",
                       "vocab=61,dim=32,layers=2,heads=4,kv_heads=2")
    tr = Trainer(cfg, seed=7)
    np_params = {k: np.asarray(v) for k, v in tr.params.items()}
    got = params_from_jax(np_params, device="cpu")
    assert list(got) == list(np_params)
    model = transformer_lm_config(61, 32, 2, 4, kv_heads=2)
    assert sorted(got) == sorted(p.name for p in model.parameters)
    for name, arr in np_params.items():
        assert tuple(got[name].shape) == arr.shape
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), arr)
    np.savez(tmp_path / "model.npz", **np_params)
    with np.load(tmp_path / "model.npz") as z:
        again = params_from_jax(dict(z), device="cpu")
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_params_from_jax_dtypes():
    """bfloat16 arrays stay bfloat16; `dtype` casts floating arrays only."""
    src = {"w": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)),
           "ids": np.arange(4, dtype=np.int32)}
    got = params_from_jax(src, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].float().tolist() == [[0, 1, 2], [3, 4, 5]]
    cast = params_from_jax(src, device="cpu", dtype=torch.float32)
    assert cast["w"].dtype == torch.float32 and cast["ids"].dtype == \
        torch.int32


def test_init_params_rules():
    """normal(mean, std); smart std = 1/sqrt(fan_in); zero; uniform; the
    same seed gives the same draws, another seed others."""
    model = ModelConfig(parameters=[
        ParameterConfig(name="n", size=200 * 300, dims=[200, 300],
                        initial_mean=0.5, initial_std=0.02),
        ParameterConfig(name="smart", size=400 * 300, dims=[400, 300],
                        initial_smart=True),
        ParameterConfig(name="z", size=8, dims=[1, 8],
                        initial_strategy="zero"),
        ParameterConfig(name="one", size=8, dims=[1, 8], initial_mean=1.0,
                        initial_std=0.0),
        ParameterConfig(name="u", size=100000, dims=[100000],
                        initial_strategy="uniform", initial_std=0.1),
    ])
    p = init_params(model, seed=3, device="cpu")
    assert abs(float(p["n"].mean()) - 0.5) < 1e-3
    assert abs(float(p["n"].std()) - 0.02) < 1e-3
    assert abs(float(p["smart"].std()) - 1 / np.sqrt(400)) < 1e-3
    assert torch.equal(p["z"], torch.zeros(1, 8))
    assert torch.equal(p["one"], torch.ones(1, 8))
    assert float(p["u"].min()) >= -0.1 and float(p["u"].max()) <= 0.1
    assert abs(float(p["u"].std()) - 0.1 / np.sqrt(3)) < 1e-3
    q = init_params(model, seed=3, device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    assert not torch.equal(p["n"], init_params(model, seed=4,
                                               device="cpu")["n"])


def test_init_params_full_width_lm_shapes():
    model = transformer_lm_config(vocab=64, dim=32, layers=2, heads=4)
    p = init_params(model, seed=1, device="cpu")
    assert {k: list(v.shape) for k, v in p.items()} == \
        {pc.name: pc.dims for pc in model.parameters}
    with pytest.raises(ValueError, match="dtype"):
        init_params(ModelConfig(parameters=[ParameterConfig(
            name="x", size=2, dims=[2], dtype="int4")]), device="cpu")
