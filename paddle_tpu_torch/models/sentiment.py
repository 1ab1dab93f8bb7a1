"""The IMDB sentiment LSTM networks, built without the config DSL.

`stacked_lstm_net_config` and `bidirectional_lstm_net_config` build the
`TrainerConfig` that `parse_config("demo/sentiment/trainer_config.py", ...)`
produces on the JAX side for `net=stacked` (the default) and `net=bidi`:
the same layer names, types, attrs, parameter names, dims, init and update
attrs, in the same order, and the demo's `settings(...)` (Adam, learning
rate 2e-3, L2 8e-4, elementwise gradient clipping at 25).  The data provider
is not ported, so the configs name no data source: batches go to
`Trainer.train_one_pass(batches=...)` as {"word": ids [B, T] + lengths,
"label": ids [B]}.

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

from paddle_tpu_torch.config.schema import (
    LayerInput,
    ModelConfig,
    OptimizationConfig,
    ProjectionConfig,
    TrainerConfig,
)
from paddle_tpu_torch.models.net import Net

EMB_DIM = 128
CLASS_DIM = 2


def _finish(net: Net, output: str, is_predict: bool) -> ModelConfig:
    """The training head (label, classification cost and its error
    evaluator), or for prediction the probabilities as the output."""
    m = net.model
    if is_predict:
        m.input_layer_names = ["word"]
        m.output_layer_names = [output]
        return m
    label = net.layer("label", "data", CLASS_DIM, [])
    m.input_layer_names = ["word", label]
    m.output_layer_names = [net.classification_cost(output, label)]
    return m


def stacked_lstm_net(dict_dim: int, hid_dim: int = 512, stacked_num: int = 3,
                     is_predict: bool = False) -> ModelConfig:
    """The stacked net's graph; the lstm hidden size is hid_dim / 4."""
    if stacked_num % 2 != 1:
        raise ValueError(f"stacked_num must be odd, got {stacked_num}")
    if hid_dim % 4:
        raise ValueError(f"hid_dim {hid_dim} must be 4 x the lstm hidden "
                         f"size")
    net = Net()
    lstm_dim = hid_dim // 4
    zero_bias = dict(initial_std=0.0, initial_strategy="zero", decay_rate=0.0)

    def fc(inputs: list[str], size: int, act: str) -> str:
        """fc over [fc] or [fc, lstm]: beyond the first layer the fc edge
        learns at rate 1e-3 and the lstm edge starts at zero."""
        name = net.auto_name("fc_layer")
        edges = []
        for i, x in enumerate(inputs):
            if len(inputs) == 1:
                attrs = dict(initial_smart=True)
            elif i == 0:
                attrs = dict(learning_rate=1e-3, initial_smart=True)
            else:
                attrs = dict(initial_std=0.0)
            edges.append(LayerInput(x, net.param(
                f"_{name}.w{i}", [net.size(x), size], **attrs)))
        b = net.param(f"_{name}.wbias", [1, size], **zero_bias)
        return net.layer(name, "fc", size, edges, bias=b, act=act)

    def lstm(x: str, reverse: bool) -> str:
        name = net.auto_name("lstmemory")
        w = net.param(f"_{name}.w0", [lstm_dim, 4 * lstm_dim],
                      initial_smart=True)
        b = net.param(f"_{name}.wbias", [1, 7 * lstm_dim], **zero_bias)
        return net.layer(name, "lstmemory", lstm_dim, [LayerInput(x, w)],
                         bias=b, act="relu", drop_rate=0.5, reversed=reverse,
                         attrs={"active_gate_type": "sigmoid",
                                "active_state_type": "tanh"})

    data = net.layer("word", "data", dict_dim, [])
    emb = net.embedding(data, EMB_DIM)
    fc_i = fc([emb], hid_dim, "")
    lstm_i = lstm(fc_i, False)
    for i in range(2, stacked_num + 1):
        fc_i = fc([fc_i, lstm_i], hid_dim, "")
        lstm_i = lstm(fc_i, i % 2 == 0)
    pools = []
    for x in (fc_i, lstm_i):
        pools.append(net.layer(net.auto_name("pool"), "max", net.size(x),
                               [LayerInput(x)]))
    output = fc(pools, CLASS_DIM, "softmax")
    return _finish(net, output, is_predict)


def bidirectional_lstm_net(dict_dim: int, lstm_dim: int = 128,
                           is_predict: bool = False) -> ModelConfig:
    """The bidirectional net's graph."""
    net = Net()
    data = net.layer("word", "data", dict_dim, [])
    emb = net.embedding(data, EMB_DIM)
    group = net.auto_name("bidirectional_lstm")
    ends = []
    for tag, reverse in (("fwd", False), ("bwd", True)):
        name = f"{group}_{tag}"
        tw = net.param(f"_{name}_transform.w0", [EMB_DIM, 4 * lstm_dim],
                       initial_smart=True)
        x4 = net.layer(f"{name}_transform", "mixed", 4 * lstm_dim,
                       [LayerInput(emb, tw, ProjectionConfig(
                           input_size=EMB_DIM, output_size=4 * lstm_dim))])
        w = net.param(f"_{name}.w0", [lstm_dim, 4 * lstm_dim],
                      initial_smart=True)
        b = net.param(f"_{name}.wbias", [1, 7 * lstm_dim],
                      initial_strategy="zero")
        hs = net.layer(name, "lstmemory", lstm_dim, [LayerInput(x4, w)],
                       bias=b, act="tanh", reversed=reverse,
                       attrs={"active_gate_type": "sigmoid",
                              "active_state_type": "tanh"})
        ends.append((f"{name}_end", hs, reverse))
    for name, hs, reverse in ends:
        net.layer(name, "seqlastins", lstm_dim, [LayerInput(hs)],
                  select_first=reverse)
    both = net.layer(group, "concat", 2 * lstm_dim,
                     [LayerInput(name) for name, _, _ in ends])
    dropped = net.layer(net.auto_name("addto"), "addto", 2 * lstm_dim,
                        [LayerInput(both)], drop_rate=0.5)
    name = net.auto_name("fc_layer")
    w = net.param(f"_{name}.w0", [2 * lstm_dim, CLASS_DIM],
                  initial_smart=True)
    b = net.param(f"_{name}.wbias", [1, CLASS_DIM], initial_strategy="zero")
    output = net.layer(name, "fc", CLASS_DIM, [LayerInput(dropped, w)],
                       bias=b, act="softmax")
    return _finish(net, output, is_predict)


def _trainer_config(model: ModelConfig, batch_size: int,
                    compute_dtype: str) -> TrainerConfig:
    """The demo's settings(...): Adam, lr 2e-3, L2 8e-4, clipping at 25."""
    opt = OptimizationConfig(
        batch_size=batch_size, learning_method="adam", learning_rate=2e-3,
        learning_rate_schedule="poly", l2_weight=8e-4,
        gradient_clipping_threshold=25.0, compute_dtype=compute_dtype)
    return TrainerConfig(model_config=model, opt_config=opt)


def stacked_lstm_net_config(dict_dim: int, batch_size: int = 128,
                            hid_dim: int = 512, is_predict: bool = False,
                            compute_dtype: str = "") -> TrainerConfig:
    """demo/sentiment/trainer_config.py with net=stacked (three fc + lstm
    pairs)."""
    model = stacked_lstm_net(dict_dim, hid_dim, stacked_num=3,
                             is_predict=is_predict)
    return _trainer_config(model, batch_size, compute_dtype)


def bidirectional_lstm_net_config(dict_dim: int, batch_size: int = 128,
                                  is_predict: bool = False,
                                  compute_dtype: str = "") -> TrainerConfig:
    """demo/sentiment/trainer_config.py with net=bidi (the demo's `hid_dim`
    does not reach this net: its lstm hidden size is 128)."""
    return _trainer_config(bidirectional_lstm_net(dict_dim,
                                                  is_predict=is_predict),
                           batch_size, compute_dtype)
