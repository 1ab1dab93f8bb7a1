"""Recurrent cell scans — the counterpart of paddle_tpu/ops/rnn.py for the
LSTM (`lstm_scan`); the GRU and the plain recurrent scan are queued in
ROADMAP.md.

Gate math (the reference's cell, hl_lstm_ops.cuh):
    a = act(xa + h.Wa)        i = gate(xi + h.Wi [+ c_prev*peep_i])
    f = gate(xf + h.Wf [+ c_prev*peep_f])
    c = a*i + f*c_prev        o = gate(xo + h.Wo [+ c*peep_o])
    h = o * state_act(c)
Variable lengths freeze the carried state once t >= length.

`lstm_scan` prepares what the JAX function prepares (the bias split into
its gate part and the peepholes, zero initial state) and hands the
recurrence to `ops.lstm_fused`: the CUDA kernels for CUDA tensors, the plain
per-step loop for CPU tensors.  The JAX side's `lax.scan` route for hidden
sizes its kernel does not take is its plain version; here a CUDA call with a
hidden size or an activation the kernels do not take raises, and only an
explicit `impl="plain"` (the tests' comparison) runs the loop on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

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
    if impl not in ("auto", "plain"):
        raise ValueError(f"lstm_scan: impl {impl!r}: expected 'auto' or "
                         f"'plain'")
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
