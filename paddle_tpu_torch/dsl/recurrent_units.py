"""Pre-DSL recurrent building blocks — LSTM/GRU units and layer groups with
explicit parameter-name sharing (ref: python/paddle/trainer/
recurrent_units.py:32-354).

The reference's units are raw config_parser calls (Layer/Memory/Projection);
here they are thin compositions over the modern DSL with the same public
surface and the same parameter-naming contract: two units created with one
`para_prefix` share `<prefix>_input_recurrent.w/.b` (+ `<prefix>_check.b`
for LSTM peepholes / `<prefix>_gate_recurrent.w` for GRU), which is how the
reference expresses weight tying across recurrent unit instances.

The reference's *Naive variants build the identical math from explicit
per-gate expression layers (kept there for debugging its fused C++ step
layers); here both forms run the same fused recurrence, so the
Naive names alias the fused implementations.
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.dsl.activations import ACTIVATION_TYPES, LinearActivation
from paddle_tpu_torch.dsl.attrs import ExtraLayerAttribute, ParameterAttribute
from paddle_tpu_torch.dsl.base import current_context
from paddle_tpu_torch.dsl.layers import (LayerOutput, _Projection,
                                   full_matrix_projection, gru_step_layer,
                                   identity_projection, lstm_step_layer,
                                   memory, mixed_layer, recurrent_group)

__all__ = [
    "LstmRecurrentUnit", "LstmRecurrentUnitNaive", "LstmRecurrentLayerGroup",
    "GatedRecurrentUnit", "GatedRecurrentUnitNaive",
    "GatedRecurrentLayerGroup",
]


def _act(name):
    """Reference configs pass activation TYPE STRINGS here; the step layers
    accept the string directly.  Unknown names fail loudly instead of
    silently substituting a default."""
    if not isinstance(name, str):
        return name
    if not name:
        return "linear"
    if name not in ACTIVATION_TYPES:
        raise ValueError(f"unknown activation type {name!r}")
    return name


def _as_projection(p, width: int) -> _Projection:
    if isinstance(p, _Projection):
        return p
    assert isinstance(p, LayerOutput), f"bad unit input: {type(p)}"
    return full_matrix_projection(p, size=width)


def LstmRecurrentUnit(name: str, size: int, active_type: str = "tanh",
                      state_active_type: str = "tanh",
                      gate_active_type: str = "sigmoid",
                      inputs=(), para_prefix: Optional[str] = None,
                      error_clipping_threshold: float = 0,
                      out_memory: Optional[LayerOutput] = None) -> LayerOutput:
    """One LSTM unit inside a recurrent_group step (ref:
    recurrent_units.py:32-72): mixed(4*size) over `inputs` + the recurrent
    projection of the output memory, then a fused lstm_step."""
    para_prefix = para_prefix or name
    if out_memory is None:
        out_memory = memory(name=name, size=size)
    state_memory = memory(name=f"{name}_state", size=size)

    extra = (ExtraLayerAttribute(error_clipping_threshold=error_clipping_threshold)
             if error_clipping_threshold else None)
    with mixed_layer(
            name=f"{name}_input_recurrent", size=size * 4,
            act=LinearActivation(),
            bias_attr=ParameterAttribute(
                name=f"{para_prefix}_input_recurrent.b", initial_std=0),
            layer_attr=extra) as m:
        for p in inputs:
            m += _as_projection(p, size * 4)
        m += full_matrix_projection(
            out_memory, size=size * 4,
            param_attr=ParameterAttribute(
                name=f"{para_prefix}_input_recurrent.w"))
    return lstm_step_layer(
        input=m, state=state_memory, size=size, name=name,
        state_name=f"{name}_state",
        bias_attr=ParameterAttribute(name=f"{para_prefix}_check.b"),
        act=_act(active_type), gate_act=_act(gate_active_type),
        state_act=_act(state_active_type))


# identical math; the reference's Naive form exists to cross-check its fused
# C++ kernels — here both run the same fused recurrence
LstmRecurrentUnitNaive = LstmRecurrentUnit


def LstmRecurrentLayerGroup(name: str, size: int, active_type: str = "tanh",
                            state_active_type: str = "tanh",
                            gate_active_type: str = "sigmoid",
                            inputs=(), para_prefix: Optional[str] = None,
                            error_clipping_threshold: float = 0,
                            seq_reversed: bool = False) -> LayerOutput:
    """LSTM over a sequence built from the unit (ref:
    recurrent_units.py:156-191): the input projections apply OUTSIDE the
    group in one mixed(4*size); each step consumes its slice by identity."""
    with mixed_layer(name=f"{name}_transform_input", size=size * 4,
                     act=LinearActivation(), bias_attr=False) as transform:
        for p in inputs:
            transform += _as_projection(p, size * 4)

    def step(ipt):
        return LstmRecurrentUnit(
            name=name, size=size, active_type=active_type,
            state_active_type=state_active_type,
            gate_active_type=gate_active_type,
            inputs=[identity_projection(ipt)], para_prefix=para_prefix,
            error_clipping_threshold=error_clipping_threshold)

    return recurrent_group(step=step, input=transform, reverse=seq_reversed,
                           name=f"{name}_layer_group")


def GatedRecurrentUnit(name: str, size: int, active_type: str = "tanh",
                       gate_active_type: str = "sigmoid",
                       inputs=(), para_prefix: Optional[str] = None,
                       error_clipping_threshold: float = 0,
                       out_memory: Optional[LayerOutput] = None) -> LayerOutput:
    """One GRU unit inside a recurrent_group step (ref:
    recurrent_units.py:202-236)."""
    para_prefix = para_prefix or name
    if out_memory is None:
        out_memory = memory(name=name, size=size)

    extra = (ExtraLayerAttribute(error_clipping_threshold=error_clipping_threshold)
             if error_clipping_threshold else None)
    with mixed_layer(
            name=f"{name}_input_proj", size=size * 3,
            act=LinearActivation(),
            bias_attr=ParameterAttribute(
                name=f"{para_prefix}_input_proj.b", initial_std=0),
            layer_attr=extra) as m:
        for p in inputs:
            m += _as_projection(p, size * 3)
    return gru_step_layer(
        input=m, output_mem=out_memory, size=size, name=name,
        param_attr=ParameterAttribute(name=f"{para_prefix}_gate_recurrent.w"),
        bias_attr=ParameterAttribute(name=f"{para_prefix}_gate_recurrent.b"),
        act=_act(active_type), gate_act=_act(gate_active_type))


GatedRecurrentUnitNaive = GatedRecurrentUnit


def GatedRecurrentLayerGroup(name: str, size: int, active_type: str = "tanh",
                             gate_active_type: str = "sigmoid",
                             inputs=(), para_prefix: Optional[str] = None,
                             error_clipping_threshold: float = 0,
                             seq_reversed: bool = False) -> LayerOutput:
    """GRU over a sequence built from the unit (ref:
    recurrent_units.py:321-354)."""
    with mixed_layer(name=f"{name}_transform_input", size=size * 3,
                     act=LinearActivation(), bias_attr=False) as transform:
        for p in inputs:
            transform += _as_projection(p, size * 3)

    def step(ipt):
        return GatedRecurrentUnit(
            name=name, size=size, active_type=active_type,
            gate_active_type=gate_active_type,
            inputs=[identity_projection(ipt)], para_prefix=para_prefix,
            error_clipping_threshold=error_clipping_threshold)

    return recurrent_group(step=step, input=transform, reverse=seq_reversed,
                           name=f"{name}_layer_group")
