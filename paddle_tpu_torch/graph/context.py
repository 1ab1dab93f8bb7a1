"""ForwardContext — per-forward state threaded through layer functions.

The port's counterpart of paddle_tpu/graph/context.py: the mode (TRAIN,
TEST, or GEN for the beam search's steps), the parameter map,
already-computed layer outputs, the incoming/outgoing layer state (the
serving engine's paged KV pools, the batch-norm moving statistics), the
per-sample cost vectors the cost layers record by layer name, and the
threefry key of stochastic layers (training-time dropout, sampling_id):
`next_rng` folds a per-context draw counter into it, as the JAX context
does, so a layer draws the same bits as its JAX counterpart
(utils/prng.py).  `dropout_masks` lets a caller supply a layer's keep-mask
instead of drawing it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from paddle_tpu_torch.config.schema import LayerConfig, ModelConfig
from paddle_tpu_torch.parameter.argument import Argument, image_layout
from paddle_tpu_torch.utils import prng

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
    # the threefry key [2] of stochastic layers (a host key folds on the
    # host, a device key on the device; draws run on their tensors'
    # device), and keep-masks by layer name that replace a draw from it
    rng: Optional[torch.Tensor] = None
    dropout_masks: dict[str, torch.Tensor] = field(default_factory=dict)
    _rng_counter: int = 0
    # a fold of `rng` not yet applied: made at the first draw, so a
    # recurrent step that draws nothing costs no hash
    _rng_fold: Optional[int] = None

    @property
    def is_training(self) -> bool:
        return self.mode == TRAIN

    def sub_context(self, fold: Optional[int] = None) -> "ForwardContext":
        """A fresh context for one step of a recurrent group (or its deferred
        suffix, or a beam-search step): the same model, parameters, mode and
        supplied masks, the key folded with `fold` (the same key without
        one, as the JAX generator's steps get it), its draws counted from
        0, its own outputs; its costs and state stay its own."""
        return ForwardContext(model=self.model, params=self.params,
                              mode=self.mode, rng=self._key(),
                              dropout_masks=self.dropout_masks,
                              _rng_fold=fold)

    def _key(self) -> Optional[torch.Tensor]:
        """`rng` with its pending fold applied."""
        if self._rng_fold is not None and self.rng is not None:
            self.rng = prng.fold_in(self.rng, self._rng_fold)
        self._rng_fold = None
        return self.rng

    def next_rng(self) -> torch.Tensor:
        """The key of the next stochastic draw: fold_in(rng, n) for the
        context's n-th draw, n from 1."""
        if self._key() is None:
            raise ValueError("forward() needs an rng for stochastic layers "
                             "(training-time dropout)")
        self._rng_counter += 1
        return prng.fold_in(self.rng, self._rng_counter)

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
