"""Recurrent cell scans — the counterpart of paddle_tpu/ops/rnn.py for the
LSTM (`lstm_scan`), the GRU (`gru_scan`) and the plain recurrent layer
(`simple_rnn_scan`).

Gate math (the reference's cell, hl_lstm_ops.cuh):
    a = act(xa + h.Wa)        i = gate(xi + h.Wi [+ c_prev*peep_i])
    f = gate(xf + h.Wf [+ c_prev*peep_f])
    c = a*i + f*c_prev        o = gate(xo + h.Wo [+ c*peep_o])
    h = o * state_act(c)
GRU (the reference's GatedRecurrentLayer):
    u = gate(xu + h.Wu)    r = gate(xr + h.Wr)
    c = act(xc + (r*h).Wc)    h = u*h + (1-u)*c
Variable lengths freeze the carried state once t >= length.

`lstm_scan` and `gru_scan` prepare what the JAX functions prepare (the bias
added, for the LSTM split into its gate part and the peepholes; zero
initial state) and hand the recurrence to `ops.lstm_fused` /
`ops.gru_fused`: the CUDA kernels for CUDA tensors, the plain per-step loop
for CPU tensors.  The JAX side's `lax.scan` route for hidden sizes its
kernel does not take is its plain version; here a CUDA call with a hidden
size or an activation the kernels do not take raises, and only an explicit
`impl="plain"` (the tests' comparison) runs the loop on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.ops import gru_fused
from paddle_tpu_torch.ops import lstm_fused as fused


def lstm_scan(
    x4: torch.Tensor,                    # [B, T, 4D] pre-projected (a,i,f,o)
    lengths: torch.Tensor,               # [B]
    w_rec: torch.Tensor,                 # [D, 4D] recurrent weights
    bias: Optional[torch.Tensor],        # [4D] or [7D] (peepholes i,f,o)
    h0: Optional[torch.Tensor] = None,   # [B, D] initial hidden
    c0: Optional[torch.Tensor] = None,   # [B, D] initial cell
    active_type: str = "tanh",
    gate_active_type: str = "sigmoid",
    state_active_type: str = "tanh",
    reverse: bool = False,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (hiddens [B, T, D], last_h [B, D], last_c [B, D]) in x4's
    dtype; the recurrence itself runs in float32.  `impl`: 'auto' (kernels
    on CUDA, the plain loop on the CPU) or 'plain'."""
    _check_impl("lstm_scan", impl)
    B, T, D4 = x4.shape
    D = D4 // 4
    peeps = None
    if bias is not None:
        bias = bias.reshape(-1)          # configs create [1, kD]
        if bias.shape[0] == 7 * D:
            x4 = x4 + bias[:4 * D]
            peeps = bias[4 * D:].reshape(3, D)
        elif bias.shape[0] == 4 * D:
            x4 = x4 + bias
        else:
            raise ValueError(f"lstm_scan: bias of {bias.shape[0]} values; "
                             f"expected 4D = {4 * D} or 7D = {7 * D}")
    if peeps is None:
        peeps = torch.zeros(3, D, dtype=x4.dtype, device=x4.device)
    if h0 is None:
        h0 = torch.zeros(B, D, dtype=x4.dtype, device=x4.device)
    if c0 is None:
        c0 = torch.zeros(B, D, dtype=x4.dtype, device=x4.device)
    run = fused.lstm_fused_plain if impl == "plain" else fused.lstm_fused
    hs, h_last, c_last = run(
        x4, lengths, w_rec, peeps, h0, c0, active_type=active_type,
        gate_active_type=gate_active_type,
        state_active_type=state_active_type, reverse=reverse)
    dt = x4.dtype
    return hs.to(dt), h_last.to(dt), c_last.to(dt)


def gru_scan(
    x3: torch.Tensor,                    # [B, T, 3D] pre-projected (u,r,c)
    lengths: torch.Tensor,               # [B]
    w_gate: torch.Tensor,                # [D, 2D] update/reset weights
    w_cand: torch.Tensor,                # [D, D] candidate weights
    bias: Optional[torch.Tensor],        # [3D] or None
    h0: Optional[torch.Tensor] = None,   # [B, D] initial hidden
    active_type: str = "tanh",
    gate_active_type: str = "sigmoid",
    reverse: bool = False,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (hiddens [B, T, D], last_h [B, D]) in x3's dtype; the
    recurrence itself runs in float32.  `impl`: 'auto' (kernels on CUDA,
    the plain loop on the CPU) or 'plain'."""
    _check_impl("gru_scan", impl)
    B, T, D3 = x3.shape
    if bias is not None:
        x3 = x3 + bias.reshape(-1)       # configs create [1, 3D]
    if h0 is None:
        h0 = torch.zeros(B, D3 // 3, dtype=x3.dtype, device=x3.device)
    run = (gru_fused.gru_fused_plain if impl == "plain"
           else gru_fused.gru_fused)
    hs, h_last = run(x3, lengths, w_gate, w_cand, h0,
                     active_type=active_type,
                     gate_active_type=gate_active_type, reverse=reverse)
    return hs.to(x3.dtype), h_last.to(x3.dtype)


def simple_rnn_scan(
    x: torch.Tensor,                     # [B, T, D] pre-projected input
    lengths: torch.Tensor,               # [B]
    w_rec: torch.Tensor,                 # [D, D]
    bias: Optional[torch.Tensor],        # [D] or None
    h0: Optional[torch.Tensor] = None,   # [B, D] initial hidden
    active_type: str = "tanh",
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The vanilla recurrent layer h_t = act(x_t + h_{t-1} W), the bias
    added to x, h frozen past each row's length; `reverse` walks the
    padded axis backwards.  A step loop of tensor ops, as the reference's
    lax.scan (the JAX package has no kernel for it).  Returns (hiddens
    [B, T, D], last_h [B, D])."""
    from paddle_tpu_torch.ops.activations import activation_registry
    B, T, D = x.shape
    act = activation_registry[active_type]
    if bias is not None:
        x = x + bias.reshape(-1)
    h = torch.zeros(B, D, dtype=x.dtype, device=x.device) if h0 is None \
        else h0
    lens = lengths.long()[:, None]
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h = torch.where(t < lens, act(x[:, t] + h @ w_rec), h)
        hs[t] = h
    return torch.stack(hs, dim=1), h


def _check_impl(what: str, impl: str) -> None:
    if impl not in ("auto", "plain"):
        raise ValueError(f"{what}: impl {impl!r}: expected 'auto' or "
                         f"'plain'")
