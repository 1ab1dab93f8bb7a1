"""GraphExecutor — runs a ModelConfig's layer graph on tensors.

The port's counterpart of paddle_tpu/graph/builder.py (`__init__`,
`prepare`, `forward`) for inference: layers run eagerly in config order
(the config lists them topologically), each a function of the context.
Models with recurrent sub-models raise; their scan executor is queued in
ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

# importing the layer modules registers their layer types
from paddle_tpu_torch.graph import layers_attn, layers_core, layers_misc  # noqa: F401
from paddle_tpu_torch.config.schema import LayerConfig, ModelConfig
from paddle_tpu_torch.graph.context import TEST, ForwardContext
from paddle_tpu_torch.graph.registry import get_layer_fn
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.parameter.init import torch_dtype


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

    def prepare(self, params: dict[str, torch.Tensor],
                feed: dict[str, Argument]):
        """The mixed-precision cast of floating params and inputs (a
        no-op for tensors already in the compute dtype)."""
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

    @torch.no_grad()
    def forward(self, params: dict[str, torch.Tensor],
                feed: dict[str, Argument],
                state: Optional[dict[str, Any]] = None,
                mode: str = TEST):
        """Run the graph.  Returns (layer outputs, per-sample costs, new
        state); costs stay empty in TEST mode.  Layers whose inputs were
        not fed (the training head, for a feed without labels) are
        skipped."""
        if mode != TEST:
            raise NotImplementedError(
                f"mode {mode!r}: the port runs inference only so far "
                f"(ROADMAP.md: training path)")
        params, feed = self.prepare(params, feed)
        ctx = ForwardContext(model=self.model, params=params, mode=mode,
                             state_in=state or {})
        ctx.outputs.update(feed)
        for cfg in self._plan:
            if any(inp.input_layer_name not in ctx.outputs
                   for inp in cfg.inputs):
                continue
            ctx.outputs[cfg.name] = get_layer_fn(cfg.type)(ctx, cfg)
        return ctx.outputs, {}, ctx.state_out
