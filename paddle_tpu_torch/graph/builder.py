"""GraphExecutor — runs a ModelConfig's layer graph on tensors.

The port's counterpart of paddle_tpu/graph/builder.py (`__init__`,
`prepare`, `forward`, `loss`): layers run eagerly in config order (the
config lists them topologically), each a function of the context.  A TEST
forward runs under `torch.no_grad` (the serving engine builds no autograd
graph); a TRAIN forward records one, and autograd of `loss` replaces the
JAX side's `jax.value_and_grad`.  Models with recurrent sub-models raise;
their scan executor is queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

# importing the layer modules registers their layer types
from paddle_tpu_torch.graph import (layers_attn, layers_core,  # noqa: F401
                                    layers_cost, layers_misc, layers_seq)
from paddle_tpu_torch.config.schema import LayerConfig, ModelConfig
from paddle_tpu_torch.graph.context import TEST, TRAIN, ForwardContext
from paddle_tpu_torch.graph.registry import get_layer_fn
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.parameter.init import torch_dtype
from paddle_tpu_torch.utils.dtypes import promote_compute


class GraphExecutor:
    """Builds and runs the layer graph described by a ModelConfig.

    `compute_dtype` '' runs in the parameters' dtype; 'bfloat16' casts
    floating parameters and inputs to bfloat16 while softmax, layer-norm
    statistics and attention scores stay float32."""

    def __init__(self, model: ModelConfig, compute_dtype: str = ""):
        recurrent = [sm.name for sm in model.sub_models
                     if sm.is_recurrent_layer_group]
        if recurrent:
            raise NotImplementedError(
                f"recurrent sub-models {recurrent} need the scan executor, "
                f"not ported yet (ROADMAP.md: training path)")
        self.model = model
        self.compute_dtype = compute_dtype
        self.layer_map: dict[str, LayerConfig] = {l.name: l
                                                  for l in model.layers}
        self._plan = [l for l in model.layers if l.type != "data"]

    @property
    def static_param_names(self) -> set[str]:
        return {p.name for p in self.model.parameters if p.is_static}

    def prepare(self, params: dict[str, torch.Tensor],
                feed: dict[str, Argument]):
        """Static parameters detached (no gradient flows into them), then
        the mixed-precision cast of floating params and inputs (a no-op for
        tensors already in the compute dtype).  The cast is part of the
        differentiated forward, so float32 master parameters get float32
        gradients."""
        static = self.static_param_names
        if static:
            params = {k: (v.detach() if k in static else v)
                      for k, v in params.items()}
        if not self.compute_dtype:
            return params, feed
        dt = torch_dtype(self.compute_dtype)
        params = {k: (v.to(dt) if v.is_floating_point() else v)
                  for k, v in params.items()}
        feed = {name: (arg.replace(value=arg.value.to(dt))
                       if arg.value is not None
                       and arg.value.is_floating_point() else arg)
                for name, arg in feed.items()}
        return params, feed

    def forward(self, params: dict[str, torch.Tensor],
                feed: dict[str, Argument],
                state: Optional[dict[str, Any]] = None,
                mode: str = TEST, rng: Optional[torch.Generator] = None,
                dropout_masks: Optional[dict[str, torch.Tensor]] = None):
        """Run the graph.  Returns (layer outputs, per-sample costs by cost
        layer, new state).  Layers whose inputs were not fed (the training
        head, for a feed without labels) are skipped.  TEST runs without
        autograd; TRAIN records the graph for `loss(...).backward()`.  A
        TRAIN forward of a model with dropout draws its masks from `rng`,
        except for the layers whose keep-mask `dropout_masks` supplies."""
        if mode not in (TRAIN, TEST):
            raise ValueError(f"mode {mode!r}: expected {TRAIN!r} or {TEST!r}")
        with torch.set_grad_enabled(mode == TRAIN and
                                    torch.is_grad_enabled()):
            params, feed = self.prepare(params, feed)
            ctx = ForwardContext(model=self.model, params=params, mode=mode,
                                 state_in=state or {}, rng=rng,
                                 dropout_masks=dropout_masks or {})
            ctx.outputs.update(feed)
            for cfg in self._plan:
                if any(inp.input_layer_name not in ctx.outputs
                       for inp in cfg.inputs):
                    continue
                ctx.outputs[cfg.name] = get_layer_fn(cfg.type)(ctx, cfg)
        return ctx.outputs, ctx.costs, ctx.state_out

    def loss(self, params: dict[str, torch.Tensor],
             feed: dict[str, Argument],
             state: Optional[dict[str, Any]] = None, mode: str = TRAIN,
             rng: Optional[torch.Generator] = None,
             dropout_masks: Optional[dict[str, torch.Tensor]] = None):
        """The sum over cost layers of each cost's batch mean, in at least
        float32, and the forward's (outputs, costs, state)."""
        outputs, costs, new_state = self.forward(params, feed, state, mode,
                                                 rng, dropout_masks)
        if not costs:
            raise ValueError("model has no cost layers (or their inputs "
                             "were not fed)")
        total = None
        for c in costs.values():
            m = torch.mean(promote_compute(c))
            total = m if total is None else total + m
        return total, (outputs, costs, new_state)
