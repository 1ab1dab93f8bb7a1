"""ForwardContext — per-forward state threaded through layer functions.

The port's counterpart of paddle_tpu/graph/context.py for inference
(TEST mode): the parameter map, already-computed layer outputs, and the
incoming/outgoing layer state (the serving engine's paged KV pools).
Training mode comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from paddle_tpu_torch.config.schema import LayerConfig, ModelConfig
from paddle_tpu_torch.parameter.argument import Argument

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
