"""The IMDB sentiment LSTM networks: the port's parse of
demo/sentiment/trainer_config.py and demo/sentiment/sentiment_net.py.

`stacked_lstm_net_config` and `bidirectional_lstm_net_config` are the
config with `net=stacked` (the default) and `net=bidi`: the demo's
`settings(...)` (Adam, learning rate 2e-3, L2 8e-4, elementwise gradient
clipping at 25) and its data source (demo/sentiment/sentiment_provider.py:
{"word": ids [B, T] + lengths, "label": ids [B]}).

Stacked net (Zhou et al. 2015, as the reference's stacked_lstm_net):
embedding 128 -> fc(hid_dim) + lstmemory(relu; hidden hid_dim / 4), then
`stacked_num - 1` more fc([fc, lstm]) + lstmemory pairs with alternating
direction, every lstmemory with peepholes and drop_rate 0.5; max over time
of the last fc and the last lstm -> fc(2, softmax).  Bidirectional net:
embedding 128 -> a forward and a reversed simple_lstm (full-matrix
projection + lstmemory, hidden 128), the forward one's last and the reversed
one's first step concatenated, dropout 0.5, fc(2, softmax).
"""

from __future__ import annotations

import runpy

from paddle_tpu_torch.config.parser import (bound_config_names,
                                            parse_config_callable)
from paddle_tpu_torch.config.schema import ModelConfig, TrainerConfig
from paddle_tpu_torch.models.demos import demo_path, parse_demo

CONFIG = "sentiment/trainer_config.py"
CLASS_DIM = 2


def stacked_lstm_net(dict_dim: int, hid_dim: int = 512, stacked_num: int = 3,
                     is_predict: bool = False) -> ModelConfig:
    """The stacked net's graph (sentiment_net.stacked_lstm_net); the lstm
    hidden size is hid_dim / 4."""
    if stacked_num % 2 != 1:
        raise ValueError(f"stacked_num must be odd, got {stacked_num}")
    if hid_dim % 4:
        raise ValueError(f"hid_dim {hid_dim} must be 4 x the lstm hidden "
                         f"size")
    with bound_config_names():
        net = runpy.run_path(demo_path("sentiment/sentiment_net.py"))
    return parse_config_callable(
        net["stacked_lstm_net"], dict_dim, class_dim=CLASS_DIM,
        hid_dim=hid_dim, stacked_num=stacked_num,
        is_predict=is_predict).model_config


def stacked_lstm_net_config(dict_dim: int, batch_size: int = 128,
                            hid_dim: int = 512, is_predict: bool = False,
                            compute_dtype: str = "") -> TrainerConfig:
    """demo/sentiment/trainer_config.py with net=stacked (three fc + lstm
    pairs)."""
    if hid_dim % 4:
        raise ValueError(f"hid_dim {hid_dim} must be 4 x the lstm hidden "
                         f"size")
    return parse_demo(CONFIG, dict_dim=dict_dim, batch_size=batch_size,
                      hid_dim=hid_dim, is_predict=is_predict,
                      compute_dtype=compute_dtype)


def bidirectional_lstm_net_config(dict_dim: int, batch_size: int = 128,
                                  is_predict: bool = False,
                                  compute_dtype: str = "") -> TrainerConfig:
    """demo/sentiment/trainer_config.py with net=bidi (the demo's `hid_dim`
    does not reach this net: its lstm hidden size is 128)."""
    return parse_demo(CONFIG, net="bidi", dict_dim=dict_dim,
                      batch_size=batch_size, is_predict=is_predict,
                      compute_dtype=compute_dtype)
