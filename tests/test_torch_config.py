"""PyTorch port: the config schema copy and the transformer LM builder
against the JAX package's DSL parse."""

import json

import pytest

from paddle_tpu.config.parser import parse_config
from paddle_tpu_torch.config.schema import ModelConfig, TrainerConfig
from paddle_tpu_torch.graph import GraphExecutor
from paddle_tpu_torch.models import transformer_lm_config

CASES = [
    ("vocab=61,dim=32,layers=2,heads=4",
     dict(vocab=61, dim=32, layers=2, heads=4)),
    ("vocab=97,dim=32,layers=2,heads=4,kv_heads=2,window=5",
     dict(vocab=97, dim=32, layers=2, heads=4, kv_heads=2, window=5)),
    ("vocab=61,dim=32,layers=1,heads=4,attn_impl=dense,ffn_mult=2,"
     "block_k_min=16",
     dict(vocab=61, dim=32, layers=1, heads=4, attn_impl="dense",
          ffn_mult=2, block_k_min=16)),
]


@pytest.mark.parametrize("args,kw", CASES, ids=["mha", "gqa_window",
                                                 "dense_impl"])
def test_builder_matches_parse_config(args, kw):
    """Layer names, types, attrs, parameter names, dims and init attrs —
    the whole to_dict() form — equal the DSL parse of the demo config."""
    want = parse_config("demo/model_zoo/transformer_lm.py",
                        args).model_config.to_dict()
    assert transformer_lm_config(**kw).to_dict() == want


def test_jax_dumped_config_loads_as_is():
    """A config dumped with the JAX schema's to_json() loads with the
    port's from_json() and dumps back to the same JSON."""
    cfg = parse_config("demo/model_zoo/transformer_lm.py",
                       "vocab=61,dim=32,layers=2,heads=4,kv_heads=2,"
                       "compute_dtype=bfloat16")
    model = ModelConfig.from_json(cfg.model_config.to_json())
    assert model.to_json() == cfg.model_config.to_json()
    tc = TrainerConfig.from_json(cfg.to_json())
    assert json.loads(tc.to_json()) == json.loads(cfg.to_json())
    assert tc.opt_config.compute_dtype == "bfloat16"
    GraphExecutor(tc.model_config, compute_dtype=tc.opt_config.compute_dtype)


def test_full_width_graph_census():
    """The serving configuration: 2 data, 1 mixed, 17 layer_norm, 17 fc,
    16 addto, 8 attention and 1 cost layer; 100 parameters, 57.97 M
    values."""
    m = transformer_lm_config(vocab=32000, dim=512, layers=8, heads=8)
    kinds = {}
    for l in m.layers:
        kinds[l.type] = kinds.get(l.type, 0) + 1
    assert kinds == {"data": 2, "mixed": 1, "layer_norm": 17, "fc": 17,
                     "addto": 16, "multi_head_attention": 8,
                     "multi-class-cross-entropy": 1}
    assert len(m.parameters) == 100
    assert sum(p.size for p in m.parameters) == 57_971_712
    assert m.parameter("_blk0_attn.w0").dims == [512, 512]
    assert m.parameter("_blk0_ln1.w0").dims == [1, 512]


def test_builder_rejects_bad_shapes():
    with pytest.raises(ValueError):
        transformer_lm_config(vocab=10, dim=30, layers=1, heads=4)
    with pytest.raises(ValueError):
        transformer_lm_config(vocab=10, dim=32, layers=1, heads=4,
                              kv_heads=3)
    with pytest.raises(TypeError):
        ModelConfig.from_json(TrainerConfig().to_json())
