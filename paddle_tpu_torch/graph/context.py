"""ForwardContext — per-forward state threaded through layer functions.

The port's counterpart of paddle_tpu/graph/context.py: the mode (TRAIN,
TEST, or GEN for the beam search's steps), the parameter map,
already-computed layer outputs, the incoming/outgoing layer state (the
serving engine's paged KV pools, the batch-norm moving statistics), the
per-sample cost vectors the cost layers record by layer name, and the
random stream of stochastic layers (training-time dropout): a
`torch.Generator` on the tensors' device that its owner (the Trainer) seeds.
Its draws are not those of `jax.random`, so `dropout_masks` lets a caller
supply a layer's keep-mask instead of drawing it (the tests feed the masks
JAX drew).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from paddle_tpu_torch.config.schema import LayerConfig, ModelConfig
from paddle_tpu_torch.parameter.argument import Argument, image_layout

TRAIN = "train"
TEST = "test"
GEN = "gen"


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
    # the random stream of stochastic layers, and keep-masks by layer name
    # that replace a draw from it
    rng: Optional[torch.Generator] = None
    dropout_masks: dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def is_training(self) -> bool:
        return self.mode == TRAIN

    def sub_context(self) -> "ForwardContext":
        """A fresh context for one step of a recurrent group (or its deferred
        suffix): the same model, parameters, mode, random stream and
        supplied masks, its own outputs; its costs and state stay its own."""
        return ForwardContext(model=self.model, params=self.params,
                              mode=self.mode, rng=self.rng,
                              dropout_masks=self.dropout_masks)

    def next_rng(self) -> torch.Generator:
        """The generator the next stochastic draw comes from (each draw
        advances it, as the JAX side folds a counter into its key)."""
        if self.rng is None:
            raise ValueError("forward() needs an rng for stochastic layers "
                             "(training-time dropout)")
        return self.rng

    def get_input(self, cfg: LayerConfig, i: int) -> Argument:
        """Input i in the reference's flat row layout (an image output is
        flattened here; image layers take get_image_input instead, so that
        images stay [B, C, H, W] between them)."""
        return self.get_raw_input(cfg, i).flatten_image()

    def get_raw_input(self, cfg: LayerConfig, i: int) -> Argument:
        """Input i as its producer left it (an image or rows)."""
        name = cfg.inputs[i].input_layer_name
        try:
            return self.outputs[name]
        except KeyError:
            raise KeyError(f"layer {cfg.name!r} input {name!r} not computed "
                           f"yet — config out of topological order?") from None

    def get_image_input(self, cfg: LayerConfig, i: int, channels: int,
                        height: int, width: int) -> Argument:
        """Input i as a [B, channels, height, width] image.  Flat rows are
        unpacked from the reference's C-major layout; an image of another
        geometry (the consumer's config splits the same element count into
        another C/H/W) goes through the flat rows, the common currency."""
        arg = self.get_raw_input(cfg, i)
        if arg.image:
            if tuple(arg.value.shape[1:]) == (channels, height, width):
                return arg
            arg = arg.flatten_image()
        v = arg.value.reshape(arg.value.shape[0], channels, height, width)
        return arg.replace(value=image_layout(v), image=True)

    def get_inputs(self, cfg: LayerConfig) -> list[Argument]:
        return [self.get_input(cfg, i) for i in range(len(cfg.inputs))]

    def param_of(self, cfg: LayerConfig, i: int) -> Optional[torch.Tensor]:
        pname = cfg.inputs[i].input_parameter_name
        return self.params[pname] if pname else None

    def bias_of(self, cfg: LayerConfig) -> Optional[torch.Tensor]:
        return (self.params[cfg.bias_parameter_name]
                if cfg.bias_parameter_name else None)
