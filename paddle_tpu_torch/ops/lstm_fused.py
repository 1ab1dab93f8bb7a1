"""Fused LSTM recurrence: the hand-written CUDA kernels' wrappers, their
plain PyTorch versions, the autograd function over them, and their call
counts.

Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_rnn.py
(`_lstm_fwd_kernel`, `_lstm_bwd_kernel`, tied together by the
`jax.custom_vjp` of `_lstm_fused_factory`).  `lstm_fused` has the JAX
function's signature: x4 [B, T, 4D] pre-projected input (gate order a, i, f,
o; bias already added), lengths [B], w [D, 4D], peeps [3, D] (i, f, o;
zeros for a layer without peepholes), h0/c0 [B, D]; it returns
(hs [B, T, D], h_last, c_last) in float32, whatever the input's dtype.  The
state of a row freezes at every step t >= length; `reverse` walks time
backwards, the padded tail first.

For CUDA tensors the forward launches the forward kernel of csrc/lstm.cu and
autograd's backward launches its backward kernel (or they raise); for CPU
tensors `lstm_fused` is `lstm_fused_plain`, the same arithmetic step by
step with autograd for its gradient.  There is no fallback from one to the
other.  Unlike the JAX wrapper nothing is transposed or flipped around the
kernels: they index [B, T, .] tensors and walk time in either direction
themselves.  `lstm_fused_bwd_plain` is the backward kernel's arithmetic
transcribed to PyTorch, so that it can be checked against autograd where
there is no card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops.activations import (ACT_GRAD_FROM_OUTPUT,
                                              activation_registry)

# activation name -> the kernels' code (csrc/lstm.cu act_fwd / act_grad)
ACT_CODES = {"sigmoid": 0, "tanh": 1, "relu": 2, "linear": 3, "": 3}
MIN_HIDDEN, MAX_HIDDEN, HIDDEN_STEP = 32, 512, 32
SM_COUNT = 132                      # H100: CTAs that run at once, one per SM
DW_TILE = (32, 64)                  # csrc/lstm.cu DW_TK x DW_TJ


class CallCounts:
    """How often each version ran: `fwd` and `bwd` count CUDA launches of
    the two kernels, `plain` counts calls of the plain PyTorch versions
    (forward or the transcribed backward)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.fwd = 0
        self.bwd = 0
        self.plain = 0


counts = CallCounts()


class _Kernel:
    """The built library and its C entry points, made on first launch."""

    def __init__(self):
        self.built: Optional[cuda_build.KernelLibrary] = None

    def library(self) -> cuda_build.KernelLibrary:
        if self.built is None:
            built = cuda_build.build("lstm")
            lib = built.lib
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.lstm_fwd_launch.argtypes = [p] * 8 + [i] * 8 + [p]
            lib.lstm_bwd_launch.argtypes = [p] * 18 + [i] * 9 + [p]
            lib.lstm_fwd_launch.restype = i
            lib.lstm_bwd_launch.restype = i
            lib.lstm_error_string.argtypes = [i]
            lib.lstm_error_string.restype = ctypes.c_char_p
            self.built = built
        return self.built


kernel = _Kernel()


def kernel_takes(D: int, *acts: str) -> Optional[str]:
    """None when the kernels take this hidden size and these activations,
    else what they refuse."""
    if D < MIN_HIDDEN or D > MAX_HIDDEN or D % HIDDEN_STEP:
        return (f"hidden size {D} (the kernels take multiples of "
                f"{HIDDEN_STEP} from {MIN_HIDDEN} to {MAX_HIDDEN})")
    bad = [a for a in acts if a not in ACT_CODES]
    if bad:
        return (f"activation(s) {bad} (the kernels take "
                f"{sorted(a for a in ACT_CODES if a)})")
    return None


# -- the plain versions -------------------------------------------------------

def _act_names(active_type, gate_active_type, state_active_type):
    return (active_type or "tanh", gate_active_type or "sigmoid",
            state_active_type or "tanh")


def _check(x4, lengths, w, peeps, h0, c0) -> tuple[int, int, int]:
    if x4.dim() != 3 or x4.shape[2] % 4:
        raise ValueError(f"lstm_fused: x4 [B, T, 4D] expected, got "
                         f"{tuple(x4.shape)}")
    B, T, D4 = x4.shape
    D = D4 // 4
    if T < 1:
        raise ValueError("lstm_fused: needs at least one timestep")
    want = {"lengths": (B,), "w": (D, D4), "peeps": (3, D), "h0": (B, D),
            "c0": (B, D)}
    got = {"lengths": lengths, "w": w, "peeps": peeps, "h0": h0, "c0": c0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"lstm_fused: {name} {shape} expected for x4 "
                             f"{tuple(x4.shape)}, got "
                             f"{tuple(got[name].shape)}")
    devs = {t.device for t in (x4, *got.values())}
    if len(devs) != 1:
        raise ValueError(f"lstm_fused: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    return B, T, D


def _plain_steps(x4, lengths, w, peeps, h0, c0, acts, reverse):
    """The recurrence step by step in float32: (hs, cs) [B, T, D], each step
    the state after it (frozen rows repeat theirs)."""
    B, T, D4 = x4.shape
    D = D4 // 4
    act, gate, state = (activation_registry[a] for a in acts)
    h, c = h0, c0
    hs, cs = [None] * T, [None] * T
    for s in range(T):
        t = T - 1 - s if reverse else s
        g = x4[:, t] + h @ w
        a = act(g[:, :D])
        ig = gate(g[:, D:2 * D] + c * peeps[0])
        fg = gate(g[:, 2 * D:3 * D] + c * peeps[1])
        c_new = a * ig + fg * c
        og = gate(g[:, 3 * D:] + c_new * peeps[2])
        h_new = og * state(c_new)
        valid = (lengths > t)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        hs[t], cs[t] = h, c
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def _last(reverse: bool, T: int) -> int:
    """The time index of the last scan step."""
    return 0 if reverse else T - 1


def lstm_fused_plain(x4: torch.Tensor, lengths: torch.Tensor,
                     w: torch.Tensor, peeps: torch.Tensor, h0: torch.Tensor,
                     c0: torch.Tensor, *, active_type: str = "tanh",
                     gate_active_type: str = "sigmoid",
                     state_active_type: str = "tanh", reverse: bool = False):
    """The kernels' function in plain PyTorch, float32, differentiable by
    autograd: (hs [B, T, D], h_last, c_last)."""
    counts.plain += 1
    _check(x4, lengths, w, peeps, h0, c0)
    acts = _act_names(active_type, gate_active_type, state_active_type)
    hs, cs = _plain_steps(x4.float(), lengths, w.float(), peeps.float(),
                          h0.float(), c0.float(), acts, reverse)
    tl = _last(reverse, x4.shape[1])
    return hs, hs[:, tl], cs[:, tl]


def lstm_fused_bwd_plain(x4, lengths, w, peeps, h0, c0, hs, cs, g_hs, g_hl,
                         g_cl, *, active_type="tanh",
                         gate_active_type="sigmoid",
                         state_active_type="tanh", reverse=False):
    """The backward kernel's arithmetic in plain PyTorch (the walk of
    pallas_rnn._lstm_bwd_kernel): from the stored hs, cs [B, T, D] and the
    cotangents of (hs, h_last, c_last) to (dx4, dw, dpeeps, dh0, dc0).
    Gates are recomputed from the state before each step; a frozen step
    gives dx4 = 0, passes dh_total on and keeps dc."""
    counts.plain += 1
    acts = _act_names(active_type, gate_active_type, state_active_type)
    act, gate, state = (activation_registry[a] for a in acts)
    act_d, gate_d, state_d = (ACT_GRAD_FROM_OUTPUT[a] for a in acts)
    B, T, D4 = x4.shape
    D = D4 // 4
    dh, dc = g_hl, g_cl
    dx = torch.zeros_like(x4)
    dw = torch.zeros_like(w)
    dpeeps = torch.zeros_like(peeps)
    for s in range(T - 1, -1, -1):
        t = T - 1 - s if reverse else s
        t_prev = t + 1 if reverse else t - 1
        h_prev = h0 if s == 0 else hs[:, t_prev]
        c_prev = c0 if s == 0 else cs[:, t_prev]
        c_new = cs[:, t]
        g = x4[:, t] + h_prev @ w
        a = act(g[:, :D])
        ig = gate(g[:, D:2 * D] + c_prev * peeps[0])
        fg = gate(g[:, 2 * D:3 * D] + c_prev * peeps[1])
        og = gate(g[:, 3 * D:] + c_new * peeps[2])
        sc = state(c_new)
        valid = (lengths > t)[:, None]
        dh_total = dh + g_hs[:, t]
        dzo = dh_total * sc * gate_d(og)
        dc_in = dh_total * og * state_d(sc) + dc + dzo * peeps[2]
        dza = dc_in * ig * act_d(a)
        dzi = dc_in * a * gate_d(ig)
        dzf = dc_in * c_prev * gate_d(fg)
        dc_prev = dc_in * fg + dzi * peeps[0] + dzf * peeps[1]
        dx4_t = torch.cat([dza, dzi, dzf, dzo], dim=1) * valid
        dx[:, t] = dx4_t
        dh = torch.where(valid, dx4_t @ w.t(), dh_total)
        dc = torch.where(valid, dc_prev, dc)
        dw = dw + h_prev.t() @ dx4_t
        dpeeps = dpeeps + torch.stack([
            (dx4_t[:, D:2 * D] * c_prev).sum(0),
            (dx4_t[:, 2 * D:3 * D] * c_prev).sum(0),
            (dx4_t[:, 3 * D:] * c_new).sum(0)])
    return dx, dw, dpeeps, dh, dc


# -- the kernels --------------------------------------------------------------

def _check_cuda(what: str, acts, **tensors) -> None:
    """What the kernels take beyond _check: CUDA, float32, contiguous, a
    hidden size and activations they were written for."""
    x4 = tensors["x4"]
    if x4.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x4.device}")
    refused = kernel_takes(x4.shape[2] // 4, *acts)
    if refused:
        raise ValueError(f"{what}: the CUDA kernels do not take {refused}")
    for name, t in tensors.items():
        want = torch.int32 if name == "lengths" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name in ("x4", "w"):                 # read with 16-byte loads
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _raise_if_failed(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lstm_error_string(rc).decode()
        raise RuntimeError(f"fused LSTM {what} kernel launch failed: CUDA "
                           f"error {rc} ({msg})")


def batch_tile(B: int, D: int) -> int:
    """Batch rows per CTA: the smallest of 1, 2, 4 whose grid runs in one
    wave (every CTA reads the whole recurrent weight each step, so fewer,
    taller CTAs only pay once the card is full).  Above D = 256 a 4-row
    tile's state no longer fits an SM's shared memory in the backward."""
    for bt in (1, 2):
        if -(-B // bt) <= SM_COUNT:
            return bt
    return 4 if D <= 256 else 2


def dw_splits(B: int, T: int, D: int) -> int:
    """How many ranges of (b, t) rows the weight-gradient product is split
    into so that its grid fills the card (each split is summed in order
    afterwards)."""
    tiles = (D // DW_TILE[0]) * (4 * D // DW_TILE[1])
    return max(1, min(2 * SM_COUNT // tiles, -(-B * T // 256)))


def _stream(t: torch.Tensor) -> int:
    # read at every launch: autograd runs the backward on its own thread
    return torch.cuda.current_stream(t.device).cuda_stream


def lstm_fwd_kernel(x4, lengths, w, peeps, h0, c0, acts, reverse):
    """One launch of the forward kernel on CUDA tensors (float32, lengths
    int32): (hs, cs) [B, T, D]."""
    B, T, D = _check(x4, lengths, w, peeps, h0, c0)
    _check_cuda("lstm_fused", acts, x4=x4, lengths=lengths, w=w,
                peeps=peeps, h0=h0, c0=c0)
    hs = torch.empty(B, T, D, dtype=torch.float32, device=x4.device)
    cs = torch.empty_like(hs)
    lib = kernel.library().lib
    with torch.cuda.device(x4.device):
        rc = lib.lstm_fwd_launch(
            x4.data_ptr(), w.data_ptr(), peeps.data_ptr(),
            lengths.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), B, T, D, int(bool(reverse)),
            *(ACT_CODES[a] for a in acts), batch_tile(B, D), _stream(x4))
    _raise_if_failed(lib, rc, "forward")
    counts.fwd += 1
    return hs, cs


def lstm_bwd_kernel(x4, lengths, w, peeps, h0, c0, hs, cs, g_hs, g_hl, g_cl,
                    acts, reverse):
    """One launch of the backward kernel (the reverse walk, then the
    weight-gradient product and the ordered sums) on CUDA tensors:
    (dx4, dw, dpeeps, dh0, dc0)."""
    B, T, D = _check(x4, lengths, w, peeps, h0, c0)
    _check_cuda("lstm_fused backward", acts, x4=x4, lengths=lengths, w=w,
                peeps=peeps, h0=h0, c0=c0, hs=hs, cs=cs, g_hs=g_hs,
                g_hl=g_hl, g_cl=g_cl)
    for name, t, like in (("g_hs", g_hs, hs), ("g_hl", g_hl, h0),
                          ("g_cl", g_cl, c0), ("cs", cs, hs)):
        if t.shape != like.shape:
            raise ValueError(f"lstm_fused backward: {name} "
                             f"{tuple(like.shape)} expected, got "
                             f"{tuple(t.shape)}")
    dev = x4.device
    dx = torch.empty_like(x4)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    dw, dpeeps = torch.empty_like(w), torch.empty_like(peeps)
    splits = dw_splits(B, T, D)
    dpeep_part = torch.empty(B, 3, D, dtype=torch.float32, device=dev)
    dw_part = torch.empty(splits, D, 4 * D, dtype=torch.float32, device=dev)
    lib = kernel.library().lib
    with torch.cuda.device(dev):
        rc = lib.lstm_bwd_launch(
            x4.data_ptr(), w.data_ptr(), peeps.data_ptr(),
            lengths.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), g_hs.data_ptr(), g_hl.data_ptr(),
            g_cl.data_ptr(), dx.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            dw.data_ptr(), dpeeps.data_ptr(), dpeep_part.data_ptr(),
            dw_part.data_ptr(), splits, B, T, D, int(bool(reverse)),
            *(ACT_CODES[a] for a in acts), batch_tile(B, D), _stream(x4))
    _raise_if_failed(lib, rc, "backward")
    counts.bwd += 1
    return dx, dw, dpeeps, dh0, dc0


class _LstmFused(torch.autograd.Function):
    """The `jax.custom_vjp` of `_lstm_fused_factory`: forward stores hs and
    cs; the backward takes the cotangents of (hs, h_last, c_last) and
    returns (dx4, dw, dpeeps, None, dh0, dc0)."""

    @staticmethod
    def forward(ctx, x4, w, peeps, lengths, h0, c0, acts, reverse):
        hs, cs = lstm_fwd_kernel(x4, lengths, w, peeps, h0, c0, acts,
                                 reverse)
        ctx.save_for_backward(x4, w, peeps, lengths, h0, c0, hs, cs)
        ctx.args = (acts, reverse)
        tl = _last(reverse, x4.shape[1])
        return hs, hs[:, tl].clone(), cs[:, tl].clone()

    @staticmethod
    def backward(ctx, g_hs, g_hl, g_cl):
        x4, w, peeps, lengths, h0, c0, hs, cs = ctx.saved_tensors
        dx, dw, dpeeps, dh0, dc0 = lstm_bwd_kernel(
            x4, lengths, w, peeps, h0, c0, hs, cs, g_hs.contiguous(),
            g_hl.contiguous(), g_cl.contiguous(), *ctx.args)
        return dx, dw, dpeeps, None, dh0, dc0, None, None


def lstm_fused(x4: torch.Tensor, lengths: torch.Tensor, w: torch.Tensor,
               peeps: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, *,
               active_type: str = "tanh", gate_active_type: str = "sigmoid",
               state_active_type: str = "tanh", reverse: bool = False):
    """Fused LSTM over [B, T, 4D] pre-projected input (pallas_rnn.lstm_fused):
    (hs [B, T, D], h_last, c_last) in float32, differentiable in x4, w,
    peeps, h0 and c0.  CUDA tensors go through the kernels, CPU tensors
    through `lstm_fused_plain`."""
    if x4.device.type == "cpu":
        return lstm_fused_plain(
            x4, lengths, w, peeps, h0, c0, active_type=active_type,
            gate_active_type=gate_active_type,
            state_active_type=state_active_type, reverse=reverse)
    acts = _act_names(active_type, gate_active_type, state_active_type)

    def f32(t):
        return t.float().contiguous()

    return _LstmFused.apply(f32(x4), f32(w), f32(peeps),
                            lengths.to(torch.int32).contiguous(), f32(h0),
                            f32(c0), acts, bool(reverse))
