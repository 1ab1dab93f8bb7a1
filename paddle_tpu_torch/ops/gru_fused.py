"""Fused GRU recurrence: the hand-written CUDA kernels' wrappers, their plain
PyTorch versions, the autograd function over them, and their call counts.

Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_rnn.py
(`_gru_fwd_kernel`, `_gru_bwd_kernel`, tied together by the
`jax.custom_vjp` of `_gru_fused_factory`).  `gru_fused` has the JAX
function's signature: x3 [B, T, 3D] pre-projected input (column order u, r,
c; bias already added), lengths [B], w_gate [D, 2D], w_cand [D, D], h0
[B, D]; it returns (hs [B, T, D], h_last) in float32, whatever the input's
dtype.  The state of a row freezes at every step t >= length; `reverse`
walks time backwards, the padded tail first.

For CUDA tensors the forward launches the forward kernel of csrc/gru.cu and
autograd's backward launches its backward kernel (or they raise); for CPU
tensors `gru_fused` is `gru_fused_plain`, the same arithmetic step by step
with autograd for its gradient.  There is no fallback from one to the
other.  The kernels index [B, T, .] tensors, walk time in either direction
themselves and read the two weights through their row strides, so the
column slices of one [D, 3D] layer parameter go in without a copy.
`gru_fused_bwd_plain` is the backward kernel's arithmetic transcribed to
PyTorch, so that it can be checked against autograd where there is no card.
Conventions (the build, the ctypes binding, the activation codes, the
hidden sizes the kernels take, the batch tile) are those of
ops/lstm_fused.py, whose helpers this module shares.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops.activations import (ACT_GRAD_FROM_OUTPUT,
                                              activation_registry)
from paddle_tpu_torch.ops.lstm_fused import (ACT_CODES, SM_COUNT, CallCounts,
                                             batch_tile, kernel_takes)

DW_TILE = (32, 32)                  # csrc/gru.cu DW_TK x DW_TJ

counts = CallCounts()


class _Kernel:
    """The built library and its C entry points, made on first launch."""

    def __init__(self):
        self.built: Optional[cuda_build.KernelLibrary] = None

    def library(self) -> cuda_build.KernelLibrary:
        if self.built is None:
            built = cuda_build.build("gru")
            lib = built.lib
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.gru_fwd_launch.argtypes = [p, p, i, p, i, p, p, p] \
                + [i] * 7 + [p]
            lib.gru_bwd_launch.argtypes = [p, p, i, p, i] + [p] * 11 \
                + [i] * 8 + [p]
            lib.gru_fwd_launch.restype = i
            lib.gru_bwd_launch.restype = i
            lib.gru_error_string.argtypes = [i]
            lib.gru_error_string.restype = ctypes.c_char_p
            self.built = built
        return self.built


kernel = _Kernel()


# -- the plain versions -------------------------------------------------------

def _act_names(active_type, gate_active_type):
    return active_type or "tanh", gate_active_type or "sigmoid"


def _check(x3, lengths, w_gate, w_cand, h0) -> tuple[int, int, int]:
    if x3.dim() != 3 or x3.shape[2] % 3:
        raise ValueError(f"gru_fused: x3 [B, T, 3D] expected, got "
                         f"{tuple(x3.shape)}")
    B, T, D3 = x3.shape
    D = D3 // 3
    if T < 1:
        raise ValueError("gru_fused: needs at least one timestep")
    want = {"lengths": (B,), "w_gate": (D, 2 * D), "w_cand": (D, D),
            "h0": (B, D)}
    got = {"lengths": lengths, "w_gate": w_gate, "w_cand": w_cand, "h0": h0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"gru_fused: {name} {shape} expected for x3 "
                             f"{tuple(x3.shape)}, got "
                             f"{tuple(got[name].shape)}")
    devs = {t.device for t in (x3, *got.values())}
    if len(devs) != 1:
        raise ValueError(f"gru_fused: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    return B, T, D


def _step(x_t, h, w_gate, w_cand, act, gate):
    """One GRU step: (h_new, u, r, c) before the freeze."""
    D = h.shape[1]
    zg = x_t[:, :2 * D] + h @ w_gate
    u = gate(zg[:, :D])
    r = gate(zg[:, D:])
    c = act(x_t[:, 2 * D:] + (r * h) @ w_cand)
    return u * h + (1.0 - u) * c, u, r, c


def _last(reverse: bool, T: int) -> int:
    """The time index of the last scan step."""
    return 0 if reverse else T - 1


def gru_fused_plain(x3: torch.Tensor, lengths: torch.Tensor,
                    w_gate: torch.Tensor, w_cand: torch.Tensor,
                    h0: torch.Tensor, *, active_type: str = "tanh",
                    gate_active_type: str = "sigmoid",
                    reverse: bool = False):
    """The kernels' function in plain PyTorch, float32, differentiable by
    autograd: (hs [B, T, D], h_last)."""
    counts.plain += 1
    B, T, D = _check(x3, lengths, w_gate, w_cand, h0)
    act, gate = (activation_registry[a]
                 for a in _act_names(active_type, gate_active_type))
    x3, wg, wc, h = x3.float(), w_gate.float(), w_cand.float(), h0.float()
    hs = [None] * T
    for s in range(T):
        t = T - 1 - s if reverse else s
        h_new = _step(x3[:, t], h, wg, wc, act, gate)[0]
        h = torch.where((lengths > t)[:, None], h_new, h)
        hs[t] = h
    hs = torch.stack(hs, dim=1)
    return hs, hs[:, _last(reverse, T)]


def gru_fused_bwd_plain(x3, lengths, w_gate, w_cand, h0, hs, g_hs, g_hl, *,
                        active_type="tanh", gate_active_type="sigmoid",
                        reverse=False):
    """The backward kernel's arithmetic in plain PyTorch (the walk of
    pallas_rnn._gru_bwd_kernel): from the stored hs [B, T, D] and the
    cotangents of (hs, h_last) to (dx3, dw_gate, dw_cand, dh0).  Gates are
    recomputed from the state before each step; a frozen step gives
    dx3 = 0 and passes dh_total on."""
    counts.plain += 1
    names = _act_names(active_type, gate_active_type)
    act, gate = (activation_registry[a] for a in names)
    act_d, gate_d = (ACT_GRAD_FROM_OUTPUT[a] for a in names)
    B, T, D3 = x3.shape
    D = D3 // 3
    dh = g_hl
    dx = torch.zeros_like(x3)
    dwg = torch.zeros_like(w_gate)
    dwc = torch.zeros_like(w_cand)
    for s in range(T - 1, -1, -1):
        t = T - 1 - s if reverse else s
        t_prev = t + 1 if reverse else t - 1
        h_prev = h0 if s == 0 else hs[:, t_prev]
        _, u, r, c = _step(x3[:, t], h_prev, w_gate, w_cand, act, gate)
        valid = (lengths > t)[:, None]
        dh_total = dh + g_hs[:, t]
        dzc = dh_total * (1.0 - u) * act_d(c) * valid
        dzu = dh_total * (h_prev - c) * gate_d(u) * valid
        drh = dzc @ w_cand.t()
        dzr = drh * h_prev * gate_d(r) * valid
        dzg = torch.cat([dzu, dzr], dim=1)
        dx[:, t] = torch.cat([dzg, dzc], dim=1)
        dh = torch.where(valid, dh_total * u + drh * r + dzg @ w_gate.t(),
                         dh_total)
        dwg = dwg + h_prev.t() @ dzg
        dwc = dwc + (r * h_prev).t() @ dzc
    return dx, dwg, dwc, dh


# -- the kernels --------------------------------------------------------------

def _check_cuda(what: str, acts, **tensors) -> None:
    """What the kernels take beyond _check: CUDA, float32, contiguous (the
    weights: unit column stride, rows 16-byte aligned), a hidden size and
    activations they were written for."""
    x3 = tensors["x3"]
    if x3.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x3.device}")
    refused = kernel_takes(x3.shape[2] // 3, *acts)
    if refused:
        raise ValueError(f"{what}: the CUDA kernels do not take {refused}")
    for name, t in tensors.items():
        want = torch.int32 if name == "lengths" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
        if name in ("w_gate", "w_cand"):
            if t.stride(1) != 1 or t.stride(0) % 4 or t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must have unit column "
                                 f"stride and 16-byte aligned rows")
        elif not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _raise_if_failed(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.gru_error_string(rc).decode()
        raise RuntimeError(f"fused GRU {what} kernel launch failed: CUDA "
                           f"error {rc} ({msg})")


def _stream(t: torch.Tensor) -> int:
    # read at every launch: autograd runs the backward on its own thread
    return torch.cuda.current_stream(t.device).cuda_stream


def dw_splits(B: int, T: int, D: int) -> int:
    """How many ranges of (b, t) rows the weight-gradient product is split
    into so that its grid fills the card (each split is summed in order
    afterwards)."""
    tiles = (D // DW_TILE[0]) * (3 * D // DW_TILE[1])
    return max(1, min(2 * SM_COUNT // tiles, -(-B * T // 256)))


def gru_fwd_kernel(x3, lengths, w_gate, w_cand, h0, acts, reverse):
    """One launch of the forward kernel on CUDA tensors (float32, lengths
    int32): hs [B, T, D]."""
    B, T, D = _check(x3, lengths, w_gate, w_cand, h0)
    _check_cuda("gru_fused", acts, x3=x3, lengths=lengths, w_gate=w_gate,
                w_cand=w_cand, h0=h0)
    hs = torch.empty(B, T, D, dtype=torch.float32, device=x3.device)
    lib = kernel.library().lib
    with torch.cuda.device(x3.device):
        rc = lib.gru_fwd_launch(
            x3.data_ptr(), w_gate.data_ptr(), w_gate.stride(0),
            w_cand.data_ptr(), w_cand.stride(0), lengths.data_ptr(),
            h0.data_ptr(), hs.data_ptr(), B, T, D, int(bool(reverse)),
            *(ACT_CODES[a] for a in acts), batch_tile(B, D), _stream(x3))
    _raise_if_failed(lib, rc, "forward")
    counts.fwd += 1
    return hs


def gru_bwd_kernel(x3, lengths, w_gate, w_cand, h0, hs, g_hs, g_hl, acts,
                   reverse):
    """One launch of the backward kernel (the reverse walk, then the
    weight-gradient product and the ordered sums) on CUDA tensors:
    (dx3, dw_gate, dw_cand, dh0)."""
    B, T, D = _check(x3, lengths, w_gate, w_cand, h0)
    _check_cuda("gru_fused backward", acts, x3=x3, lengths=lengths,
                w_gate=w_gate, w_cand=w_cand, h0=h0, hs=hs, g_hs=g_hs,
                g_hl=g_hl)
    for name, t, shape in (("hs", hs, (B, T, D)), ("g_hs", g_hs, (B, T, D)),
                           ("g_hl", g_hl, (B, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gru_fused backward: {name} {shape} expected, "
                             f"got {tuple(t.shape)}")
    dev = x3.device
    dx = torch.empty_like(x3)
    dh0 = torch.empty_like(h0)
    dwg = torch.empty(D, 2 * D, dtype=torch.float32, device=dev)
    dwc = torch.empty(D, D, dtype=torch.float32, device=dev)
    rh = torch.empty_like(hs)
    splits = dw_splits(B, T, D)
    dw_part = torch.empty(splits, D, 3 * D, dtype=torch.float32, device=dev)
    lib = kernel.library().lib
    with torch.cuda.device(dev):
        rc = lib.gru_bwd_launch(
            x3.data_ptr(), w_gate.data_ptr(), w_gate.stride(0),
            w_cand.data_ptr(), w_cand.stride(0), lengths.data_ptr(),
            h0.data_ptr(), hs.data_ptr(), g_hs.data_ptr(), g_hl.data_ptr(),
            dx.data_ptr(), dh0.data_ptr(), dwg.data_ptr(), dwc.data_ptr(),
            rh.data_ptr(), dw_part.data_ptr(), splits, B, T, D,
            int(bool(reverse)), *(ACT_CODES[a] for a in acts),
            batch_tile(B, D), _stream(x3))
    _raise_if_failed(lib, rc, "backward")
    counts.bwd += 1
    return dx, dwg, dwc, dh0


class _GruFused(torch.autograd.Function):
    """The `jax.custom_vjp` of `_gru_fused_factory`: forward stores hs; the
    backward takes the cotangents of (hs, h_last) and returns (dx3,
    dw_gate, dw_cand, None, dh0)."""

    @staticmethod
    def forward(ctx, x3, w_gate, w_cand, lengths, h0, acts, reverse):
        hs = gru_fwd_kernel(x3, lengths, w_gate, w_cand, h0, acts, reverse)
        ctx.save_for_backward(x3, w_gate, w_cand, lengths, h0, hs)
        ctx.args = (acts, reverse)
        return hs, hs[:, _last(reverse, x3.shape[1])].clone()

    @staticmethod
    def backward(ctx, g_hs, g_hl):
        x3, w_gate, w_cand, lengths, h0, hs = ctx.saved_tensors
        dx, dwg, dwc, dh0 = gru_bwd_kernel(
            x3, lengths, w_gate, w_cand, h0, hs, g_hs.contiguous(),
            g_hl.contiguous(), *ctx.args)
        return dx, dwg, dwc, None, dh0, None, None


def _rows(w: torch.Tensor) -> torch.Tensor:
    """w in float32 as the kernels read it: a view when its rows already
    are (unit column stride, 16-byte aligned rows), else a contiguous copy."""
    w = w.float()
    if w.stride(1) == 1 and w.stride(0) % 4 == 0 and w.data_ptr() % 16 == 0:
        return w
    return w.contiguous()


def gru_fused(x3: torch.Tensor, lengths: torch.Tensor, w_gate: torch.Tensor,
              w_cand: torch.Tensor, h0: torch.Tensor, *,
              active_type: str = "tanh", gate_active_type: str = "sigmoid",
              reverse: bool = False):
    """Fused GRU over [B, T, 3D] pre-projected input (pallas_rnn.gru_fused):
    (hs [B, T, D], h_last) in float32, differentiable in x3, w_gate, w_cand
    and h0.  CUDA tensors go through the kernels, CPU tensors through
    `gru_fused_plain`."""
    if x3.device.type == "cpu":
        return gru_fused_plain(x3, lengths, w_gate, w_cand, h0,
                               active_type=active_type,
                               gate_active_type=gate_active_type,
                               reverse=reverse)
    acts = _act_names(active_type, gate_active_type)
    return _GruFused.apply(x3.float().contiguous(), _rows(w_gate),
                           _rows(w_cand), lengths.to(torch.int32).contiguous(),
                           h0.float().contiguous(), acts, bool(reverse))
