"""GraphExecutor — runs a ModelConfig's layer graph on tensors.

The port's counterpart of paddle_tpu/graph/builder.py: layers run eagerly in
config order (the config lists them topologically), each a function of the
context.  A TEST forward runs under `torch.no_grad` (the serving engine
builds no autograd graph); a TRAIN forward records one, and autograd of
`loss` replaces the JAX side's `jax.value_and_grad`.  Layer state (the
batch-norm moving statistics) comes in as `state` and goes out as the
forward's new state, in TRAIN and TEST; its update is not differentiated.

A recurrent layer group (a SubModelConfig) runs as a Python loop over its
time steps where the JAX side runs a `lax.scan`: its in-links are sliced per
step and fed through their agent layers, its static links are fed whole,
its memories carry the linked layers' outputs from step to step (frozen
where t >= length), and its out-links are published as [B, T, .] sequences.
Layers outside the carry's closure (a decoder's vocabulary softmax) run
once over the stacked sequence after the loop (`_split_deferred`).

A group nested in a group (the reference's hierarchical RNN) is a ('scan',
child) item of its parent's plan and runs inside each of the parent's
steps.  A nested (SubsequenceInput) in-link, [B, S, T, ...] with
sub_lengths [B, S], makes its group loop over the sub-sequence axis: each
step feeds one whole [B, T, ...] sequence with that sub-sequence's
lengths, and an out-link whose step emitted sequences is published as
[B, S, T, ...] with the in-link's sub_lengths.  A sparse in-link (column
ids and their values) stays sparse rows through the slicing, so an fc in
the step gathers the rows it touches.  Loop bounds come from shapes, never
from the lengths' values, so a step loop records into a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

# importing the layer modules registers their layer types
from paddle_tpu_torch.graph import (layers_attn, layers_conv,  # noqa: F401
                                    layers_core, layers_cost, layers_misc,
                                    layers_seq)
from paddle_tpu_torch.config.schema import (LayerConfig, ModelConfig,
                                            SubModelConfig)
from paddle_tpu_torch.graph.context import TEST, TRAIN, ForwardContext
from paddle_tpu_torch.graph.registry import get_layer_fn, register_layer
from paddle_tpu_torch.ops.sequence import seq_reverse
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.parameter.init import torch_dtype
from paddle_tpu_torch.utils.dtypes import promote_compute


# Agent layers are placeholders the executor feeds (the in-links, static
# links and memories of a recurrent group).
@register_layer("agent", "sequence_agent", "scatter_agent",
                "sequence_scatter_agent", "gather_agent",
                "sequence_gather_agent")
def _agent_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    raise AssertionError(f"agent layer {cfg.name!r} must be fed by the "
                         f"executor")


@register_layer("get_output")
def _get_output_layer(ctx: ForwardContext, cfg: LayerConfig) -> Argument:
    """A group's out-link, published by the time the root walk reaches it."""
    return ctx.get_input(cfg, 0)


def _arg(x: torch.Tensor, lengths: Optional[torch.Tensor] = None
         ) -> Argument:
    """An Argument holding x as ids (integer x) or as values."""
    if x.is_floating_point():
        return Argument(value=x, lengths=lengths)
    return Argument(ids=x, lengths=lengths)


@dataclass
class _Link:
    """A group's in-link in loop order: `seq` [B, N, ...] (N the steps: T,
    or S for a nested link), the sparse rows' values and width for a
    sparse link, and the [B, S] sub_lengths of a nested one."""
    seq: torch.Tensor
    vals: Optional[torch.Tensor] = None
    dim: int = 0
    sub: Optional[torch.Tensor] = None

    def step(self, t: int) -> Argument:
        """Step t's slice: a [B, ...] row, or for a nested link the
        [B, T, ...] sequence of sub-sequence t with its lengths."""
        lengths = None if self.sub is None else self.sub[:, t]
        if self.dim:
            return Argument(ids=self.seq[:, t], sparse_vals=self.vals[:, t],
                            sparse_dim=self.dim, lengths=lengths)
        return _arg(self.seq[:, t], lengths)

    def whole(self, lengths: torch.Tensor) -> Argument:
        """The whole (flat) sequence, for the deferred suffix."""
        if self.dim:
            return Argument(ids=self.seq, sparse_vals=self.vals,
                            sparse_dim=self.dim, lengths=lengths)
        return _arg(self.seq, lengths)


class GraphExecutor:
    """Builds and runs the layer graph described by a ModelConfig.

    `compute_dtype` '' runs in the parameters' dtype; 'bfloat16' casts
    floating parameters and inputs to bfloat16 while softmax, layer-norm
    statistics and attention scores stay float32."""

    # projection types of a mixed layer that may run deferred
    _DEFER_PROJS = {"fc", "full_matrix", "trans_full_matrix", "table",
                    "identity", "dot_mul", "scaling"}

    def __init__(self, model: ModelConfig, compute_dtype: str = ""):
        self.model = model
        self.compute_dtype = compute_dtype
        self.layer_map: dict[str, LayerConfig] = {l.name: l
                                                  for l in model.layers}
        # the layers of a recurrent group run inside its step loop (a
        # group's layer_names hold only its own layers, not those of the
        # groups nested in it)
        self._sub_of: dict[str, SubModelConfig] = {}
        self._sub_by_name: dict[str, SubModelConfig] = {}
        for sm in model.sub_models:
            if sm.is_recurrent_layer_group:
                self._sub_by_name[sm.name] = sm
                for ln in sm.layer_names:
                    self._sub_of[ln] = sm
        self._sub_plan: dict[str, list[tuple[str, Any]]] = {}
        self._plan = self._build_plan()
        self._defer_cache: dict[str, Optional[dict]] = {}

    # -- planning ---------------------------------------------------------
    def _build_plan(self) -> list[tuple[str, Any]]:
        """('layer', cfg) and ('scan', sub_model) items in config order.
        The root plan holds the root groups, each at the first layer of it
        or of a group nested in it; each group's own plan
        (self._sub_plan) holds its layers and its child groups the same
        way."""
        plan: list[tuple[str, Any]] = []
        seen: set[str] = set()
        for l in self.model.layers:
            sm = self._sub_of.get(l.name)
            if sm is None:
                if l.type != "data":
                    plan.append(("layer", l))
                continue
            self._sub_plan.setdefault(sm.name, []).append(("layer", l))
            child = sm
            while child is not None and child.name not in seen:
                seen.add(child.name)
                if child.parent:
                    self._sub_plan.setdefault(child.parent, []).append(
                        ("scan", child))
                    child = self._sub_by_name[child.parent]
                else:
                    plan.append(("scan", child))
                    child = None
        return plan

    @property
    def static_param_names(self) -> set[str]:
        return {p.name for p in self.model.parameters if p.is_static}

    def prepare(self, params: dict[str, torch.Tensor],
                feed: dict[str, Argument]):
        """Static parameters detached (no gradient flows into them), then
        the mixed-precision cast of floating params, inputs and sparse-row
        values (a no-op for tensors already in the compute dtype).  The
        cast is part of the
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

        def cast(arg: Argument) -> Argument:
            if arg.value is not None and arg.value.is_floating_point():
                arg = arg.replace(value=arg.value.to(dt))
            if arg.sparse_vals is not None:
                arg = arg.replace(sparse_vals=arg.sparse_vals.to(dt))
            return arg
        feed = {name: cast(arg) for name, arg in feed.items()}
        return params, feed

    def run_layers(self, ctx: ForwardContext, skip_sub=None) -> None:
        """The root walk: every layer whose inputs are there, every group
        whose in-links and static links are (`skip_sub` and generation-only
        groups excepted; generate() runs those)."""
        for kind, item in self._plan:
            if kind == "layer":
                if all(inp.input_layer_name in ctx.outputs
                       for inp in item.inputs):
                    ctx.outputs[item.name] = get_layer_fn(item.type)(ctx,
                                                                     item)
            elif item is not skip_sub and item.in_links and all(
                    n in ctx.outputs
                    for n in item.in_links + item.static_links):
                self._run_scan(ctx, item)

    def forward(self, params: dict[str, torch.Tensor],
                feed: dict[str, Argument],
                state: Optional[dict[str, Any]] = None,
                mode: str = TEST, rng: Optional[torch.Generator] = None,
                dropout_masks: Optional[dict[str, torch.Tensor]] = None):
        """Run the graph.  Returns (layer outputs, per-sample costs by cost
        layer, new state).  Layers and groups whose inputs were not fed
        (the training head, for a feed without labels) are skipped.  TEST
        runs without autograd; TRAIN records the graph for
        `loss(...).backward()`.  A TRAIN forward of a model with dropout
        draws its masks from `rng`, except for the layers whose keep-mask
        `dropout_masks` supplies."""
        if mode not in (TRAIN, TEST):
            raise ValueError(f"mode {mode!r}: expected {TRAIN!r} or {TEST!r}"
                             f" (generation: graph/generator.py)")
        with torch.set_grad_enabled(mode == TRAIN and
                                    torch.is_grad_enabled()):
            params, feed = self.prepare(params, feed)
            ctx = ForwardContext(model=self.model, params=params, mode=mode,
                                 state_in=state or {}, rng=rng,
                                 dropout_masks=dropout_masks or {})
            ctx.outputs.update(feed)
            self.run_layers(ctx)
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

    # -- recurrent groups -------------------------------------------------
    def run_group_layers(self, sm: SubModelConfig, sub: ForwardContext,
                         skip: Optional[set] = None) -> None:
        """One step of a group's layers; the agent layers must already be
        fed into sub.outputs.  A nested group runs its whole loop at its
        place in the plan.  `skip` holds the layers deferred to after the
        loop."""
        for kind, item in self._sub_plan.get(sm.name, []):
            if kind == "scan":
                self._run_scan(sub, item)
            elif not (item.name in sub.outputs
                      or (skip and item.name in skip)):
                sub.outputs[item.name] = get_layer_fn(item.type)(sub, item)

    def _split_deferred(self, sm: SubModelConfig) -> Optional[dict]:
        """The group's layers outside the carry-dependency closure: they
        need not run inside the step loop and run once on the stacked
        [B, T, ...] sequence afterwards — one large product instead of T
        small ones (the classic case: a decoder's vocabulary softmax, which
        feeds only the cost).  Returns {deferred, cfgs, emit} or None.  Only
        last-dim layer types are eligible; a deferred layer may read values
        of the step (emitted per step) or in-link aliases (fed as whole
        sequences) but not static links.  A group holding a nested group
        defers nothing."""
        items = self._sub_plan.get(sm.name, [])
        if sm.generator is not None or any(k == "scan" for k, _ in items):
            return None
        plan = [cfg for _, cfg in items]
        layer_cfgs = {cfg.name: cfg for cfg in plan}
        alias = set(sm.in_link_layers)
        statics = set(sm.static_link_layers)
        agents = {m.layer_name for m in sm.memories}

        # carry closure: memory-linked layers and their transitive inputs
        needed: set = set()
        stack = [m.link_name for m in sm.memories]
        while stack:
            n = stack.pop()
            if n in needed or n not in layer_cfgs:
                continue
            needed.add(n)
            stack.extend(inp.input_layer_name
                         for inp in layer_cfgs[n].inputs)

        def safe(cfg: LayerConfig) -> bool:
            if any(i.input_layer_name in statics for i in cfg.inputs):
                return False
            if cfg.type in ("fc", "addto"):
                return True
            if cfg.type == "mixed":
                return (all(i.proj is None or i.proj.type in self._DEFER_PROJS
                            for i in cfg.inputs)
                        and all(op.type == "dot_mul" for op in cfg.operators))
            return False

        deferred = {cfg.name for cfg in plan
                    if cfg.name not in needed and cfg.name not in alias
                    and cfg.name not in agents and safe(cfg)}
        # fixpoint: a layer inside the loop that reads a deferred output
        # pulls its producer back inside
        changed = True
        while changed:
            changed = False
            for cfg in plan:
                if cfg.name in deferred:
                    continue
                for inp in cfg.inputs:
                    if inp.input_layer_name in deferred:
                        deferred.discard(inp.input_layer_name)
                        changed = True
        if not deferred:
            return None
        cfgs = [cfg for cfg in plan if cfg.name in deferred]
        emit = {inp.input_layer_name for cfg in cfgs for inp in cfg.inputs
                if inp.input_layer_name not in deferred
                and inp.input_layer_name not in alias
                and (inp.input_layer_name in layer_cfgs
                     or inp.input_layer_name in agents)}
        return {"deferred": deferred, "cfgs": cfgs, "emit": emit}

    def _in_links(self, ctx: ForwardContext, sm: SubModelConfig):
        """The group's in-links in loop order (each row's valid prefix
        reversed for a reversed group), their lengths (the longest over the
        links; for nested links the sub-sequence counts), the number of
        steps N and the nested links' sub_lengths (None for flat links)."""
        levels = {ctx.outputs[o].sub_lengths is not None
                  for o in sm.in_links}
        if len(levels) > 1:
            raise ValueError(
                f"recurrent group {sm.name!r} mixes nested (SubsequenceInput)"
                f" and flat sequence in-links; all in-links must share one "
                f"nesting level (their step counts differ)")
        links: dict[str, _Link] = {}
        lengths, N, sub_src = None, 0, None
        for outer in sm.in_links:
            arg = ctx.outputs[outer]
            if not arg.is_sequence:
                raise ValueError(f"recurrent group {sm.name!r}: in-link "
                                 f"{outer!r} is not a sequence")
            link = _Link(arg.data, arg.sparse_vals if arg.sparse_dim
                         else None, arg.sparse_dim, arg.sub_lengths)
            if link.sub is not None:
                if sm.reversed:
                    raise ValueError(
                        f"recurrent group {sm.name!r}: reverse=True on a "
                        f"nested recurrent group is not supported (nor in "
                        f"the JAX package)")
                sub_src = link.sub
            elif sm.reversed:
                link.seq = seq_reverse(link.seq, arg.lengths)
                if link.dim:
                    link.vals = seq_reverse(link.vals, arg.lengths)
            links[outer] = link
            lengths = (arg.lengths if lengths is None
                       else torch.maximum(lengths, arg.lengths))
            N = max(N, link.seq.shape[1])
        if lengths is None:
            raise ValueError(f"recurrent group {sm.name!r} has no in-links")
        return links, lengths, N, sub_src

    def _run_scan(self, ctx: ForwardContext, sm: SubModelConfig) -> None:
        """Run a recurrent group over its in-links' time axis, or over the
        sub-sequence axis of nested in-links (the JAX side's `lax.scan`;
        ref: RecurrentGradientMachine forward and its hierarchical form).
        The JAX side wraps the step in `jax.checkpoint` for training, to
        recompute its internals in the backward instead of storing them;
        that is a memory device of XLA's, and here autograd stores what the
        step's operations save."""
        in_link_alias = dict(zip(sm.in_links, sm.in_link_layers))
        static_alias = dict(zip(sm.static_links, sm.static_link_layers))
        links, lengths, N, sub_src = self._in_links(ctx, sm)
        B = lengths.shape[0]
        dev = lengths.device

        # memories: a boot layer's output, a constant id, or zeros
        carry: dict[str, torch.Tensor] = {}
        for mem in sm.memories:
            if mem.boot_layer_name:
                boot = ctx.outputs[mem.boot_layer_name].data
            elif mem.boot_with_const_id is not None:
                boot = torch.full((B,), mem.boot_with_const_id,
                                  dtype=torch.long, device=dev)
            else:
                boot = torch.zeros(B, mem.size, device=dev)
            carry[mem.link_name] = boot

        if sm.name not in self._defer_cache:
            self._defer_cache[sm.name] = self._split_deferred(sm)
        spec = self._defer_cache[sm.name] if sub_src is None else None
        deferred = spec["deferred"] if spec else set()
        emit_names = (sorted((set(sm.output_layer_names) - deferred)
                             | spec["emit"]) if spec
                      else list(sm.output_layer_names))

        stacked: dict[str, list] = {name: [] for name in emit_names}
        out_is_seq: dict[str, bool] = {}
        for t in range(N):
            sub = ctx.sub_context()
            for outer, inner in in_link_alias.items():
                sub.outputs[inner] = links[outer].step(t)
            for outer, inner in static_alias.items():
                sub.outputs[inner] = ctx.outputs[outer]
            for mem in sm.memories:
                sub.outputs[mem.layer_name] = _arg(carry[mem.link_name])
            self.run_group_layers(sm, sub, skip=deferred)
            valid = t < lengths
            for mem in sm.memories:
                prev = carry[mem.link_name]
                out = sub.outputs[mem.link_name].data
                v = valid.reshape((B,) + (1,) * (out.dim() - 1))
                # the carry keeps its dtype across steps
                carry[mem.link_name] = torch.where(v, out, prev).to(
                    prev.dtype)
            for name in emit_names:
                o = sub.outputs[name]
                out_is_seq[name] = o.lengths is not None
                stacked[name].append(o.data)

        def publish(name: str, seq: torch.Tensor) -> None:
            if sm.reversed:
                seq = seq_reverse(seq, lengths)
            nested = sub_src is not None and out_is_seq.get(name, False)
            ctx.outputs[name] = Argument(
                value=seq, lengths=lengths,
                sub_lengths=sub_src if nested else None)

        for name in sm.output_layer_names:
            if name not in deferred:
                publish(name, torch.stack(stacked[name], dim=1))
        if not spec:
            return
        # the deferred suffix, once over the stacked sequences (in loop
        # order, so that a reversed group publishes it like the others)
        dctx = ctx.sub_context()
        for outer, inner in in_link_alias.items():
            dctx.outputs[inner] = links[outer].whole(lengths)
        for name in spec["emit"]:
            dctx.outputs[name] = _arg(torch.stack(stacked[name], dim=1),
                                      lengths)
        for cfg in spec["cfgs"]:
            dctx.outputs[cfg.name] = get_layer_fn(cfg.type)(dctx, cfg)
        for name in sm.output_layer_names:
            if name in deferred:
                publish(name, dctx.outputs[name].data)
