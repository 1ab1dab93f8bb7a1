"""ForwardContext — per-forward state threaded through layer functions.

The port's counterpart of paddle_tpu/graph/context.py: the mode (TRAIN or
TEST), the parameter map, already-computed layer outputs, the
incoming/outgoing layer state (the serving engine's paged KV pools), and
the per-sample cost vectors the cost layers record by layer name.  The
per-layer random stream of the JAX side (dropout, sampling layers) is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from paddle_tpu_torch.config.schema import LayerConfig, ModelConfig
from paddle_tpu_torch.parameter.argument import Argument

TRAIN = "train"
TEST = "test"


@dataclass
class ForwardContext:
    model: ModelConfig
    params: dict[str, torch.Tensor]
    mode: str = TEST
    # layer name -> computed output
    outputs: dict[str, Argument] = field(default_factory=dict)
    # layer name -> incoming state, and the updated state layers emit
    state_in: dict[str, Any] = field(default_factory=dict)
    state_out: dict[str, Any] = field(default_factory=dict)
    # accumulated per-sample costs from cost layers: name -> [B]
    costs: dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def is_training(self) -> bool:
        return self.mode == TRAIN

    def get_input(self, cfg: LayerConfig, i: int) -> Argument:
        name = cfg.inputs[i].input_layer_name
        try:
            return self.outputs[name]
        except KeyError:
            raise KeyError(f"layer {cfg.name!r} input {name!r} not computed "
                           f"yet — config out of topological order?") from None

    def get_inputs(self, cfg: LayerConfig) -> list[Argument]:
        return [self.get_input(cfg, i) for i in range(len(cfg.inputs))]

    def param_of(self, cfg: LayerConfig, i: int) -> Optional[torch.Tensor]:
        pname = cfg.inputs[i].input_parameter_name
        return self.params[pname] if pname else None

    def bias_of(self, cfg: LayerConfig) -> Optional[torch.Tensor]:
        return (self.params[cfg.bias_parameter_name]
                if cfg.bias_parameter_name else None)
