"""The 2-D multi-dimensional LSTM recurrence — the counterpart of
paddle_tpu/ops/mdlstm.py (ref: MDLstmLayer.cpp:180-486): each grid cell
(i, j) has an input node, an input gate, one forget gate per dimension and
an output gate; its cell state mixes its up and left predecessors' states
through the per-dimension forget gates, one shared recurrent weight
[D, 5D] projects the predecessors' summed h, and the peepholes sit at the
bias's tail.  The grid is static [H, W] (padded batches), walked row by
row and column by column; a reversed dimension is walked by flipping the
input and the output.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.ops.activations import activation_registry


def mdlstm_2d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              height: int, width: int,
              directions: tuple[bool, bool] = (True, True),
              active_type: str = "tanh", gate_active_type: str = "sigmoid",
              state_active_type: str = "tanh",
              lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, H*W, 5D] gate pre-activations [inode | igate | fgate_dim0 |
    fgate_dim1 | ogate], w [D, 5D], bias [9D] = local bias (5D) ++ peep_ig
    (D) ++ peep_fg (2D) ++ peep_og (D); directions[d] True walks dim d
    upward.  Cells at flat index >= lengths[b] are boundary: their h and c
    are zero.  Returns h [B, H*W, D]."""
    B = x.shape[0]
    D = w.shape[0]
    G = 5 * D
    if x.shape[1] != height * width or x.shape[2] != G or \
            bias.shape[-1] != 9 * D:
        raise ValueError(f"mdlstm_2d: x {tuple(x.shape)}, bias "
                         f"{tuple(bias.shape)} for a {height}x{width} grid "
                         f"of width {D}")
    act = activation_registry[active_type or "tanh"]
    gate = activation_registry[gate_active_type or "sigmoid"]
    state_act = activation_registry[state_active_type or "tanh"]
    bias = bias.reshape(-1)
    local_b = bias[:G]
    peep_ig = bias[G:G + D]
    peep_fg0 = bias[G + D:G + 2 * D]
    peep_fg1 = bias[G + 2 * D:G + 3 * D]
    peep_og = bias[G + 3 * D:]
    if lengths is not None:
        valid = (torch.arange(height * width, device=x.device)[None, :]
                 < lengths[:, None]).to(x.dtype)
    else:
        valid = torch.ones((B, height * width), dtype=x.dtype,
                           device=x.device)
    xg = (x + local_b).reshape(B, height, width, G)
    valid = valid.reshape(B, height, width, 1)
    flip = [d for d, up in ((1, directions[0]), (2, directions[1]))
            if not up]
    if flip:
        xg, valid = torch.flip(xg, flip), torch.flip(valid, flip)

    zeros = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    h_up = [zeros] * width
    c_up = [zeros] * width
    rows = []
    for i in range(height):
        h_left = c_left = zeros
        h_row, c_row = [], []
        for j in range(width):
            g = xg[:, i, j] + (h_up[j] + h_left) @ w
            a = act(g[:, :D])
            ig = gate(g[:, D:2 * D] + (c_up[j] + c_left) * peep_ig)
            f0 = gate(g[:, 2 * D:3 * D] + c_up[j] * peep_fg0)
            f1 = gate(g[:, 3 * D:4 * D] + c_left * peep_fg1)
            c = f0 * c_up[j] + f1 * c_left + a * ig
            o = gate(g[:, 4 * D:] + c * peep_og)
            v = valid[:, i, j]
            h_left, c_left = o * state_act(c) * v, c * v
            h_row.append(h_left)
            c_row.append(c_left)
        h_up, c_up = h_row, c_row
        rows.append(torch.stack(h_row, dim=1))
    h = torch.stack(rows, dim=1)                    # [B, H, W, D]
    if flip:
        h = torch.flip(h, flip)
    return h.reshape(B, height * width, D)
