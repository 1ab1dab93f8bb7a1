"""Fused GRU recurrence: the hand-written CUDA kernels' wrappers and launch
plan, their plain PyTorch versions, the autograd function over them, and
their call counts.

Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_rnn.py
(`_gru_fwd_kernel`, `_gru_bwd_kernel`, tied together by the
`jax.custom_vjp` of `_gru_fused_factory`).  `gru_fused` has the JAX
function's signature: x3 [B, T, 3D] pre-projected input (column order u, r,
c; bias already added), lengths [B], w_gate [D, 2D], w_cand [D, D], h0
[B, D]; it returns (hs [B, T, D], h_last) in float32, whatever the input's
dtype.  The state of a row freezes at every step t >= length; `reverse`
walks time backwards, the padded tail first.

For CUDA tensors the forward launches the forward kernel of csrc/gru.cu and
autograd's backward launches its backward (or they raise); for CPU tensors
`gru_fused` is `gru_fused_plain`, the same arithmetic step by step with
autograd for its gradient.  There is no fallback from one to the other.
The kernels index [B, T, .] tensors, walk time in either direction
themselves and read the two weights through their row strides, so the
column slices of one [D, 3D] layer parameter go in without a copy.

The kernels split the batch into groups and a group's hidden units over
CTAs that keep their weight columns resident and meet at a barrier twice a
step (csrc/gru.cu); `gru_plan` chooses the split of one launch.  A
group's rows must fit a CTA's shared memory beside its weights, so a large
batch (at D = 512 from 673 rows) fits no launch: `gru_launches` cuts the
batch into slices of rows walked one launch after another (rows never meet
in the recurrence), and the weight-gradient product runs once over the
whole batch.  When a gradient is wanted the forward also saves the gates
u, r, c, and the backward walks from them.  `gru_fwd_gates_plain` and
`gru_fused_bwd_plain` are that data flow transcribed to PyTorch (the
partial sums per column slice added in slice order), so that it can be
checked against autograd where there is no card.  The build, the ctypes binding, the activation codes and the hidden
sizes the kernels take are those of ops/lstm_fused.py, whose helpers this
module shares.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops.activations import (ACT_GRAD_FROM_OUTPUT,
                                              activation_registry)
from paddle_tpu_torch.ops.lstm_fused import (ACT_CODES, CallCounts,
                                             kernel_takes)

WALK_THREADS = 256                  # csrc/gru.cu THREADS
DW_TILE = (64, 64)                  # csrc/gru.cu DW_BM x DW_BN
FWD_STAMPS, BWD_STAMPS = 9, 8       # clock64() stamps per step (_phases)

counts = CallCounts()


class _Kernel:
    """The built library and its C entry points, made on first launch."""

    def __init__(self):
        self.built: Optional[cuda_build.KernelLibrary] = None
        self.limits: dict = {}

    def library(self) -> cuda_build.KernelLibrary:
        if self.built is None:
            built = cuda_build.build("gru")
            lib = built.lib
            p, i = ctypes.c_void_p, ctypes.c_int
            fwd = [p, p, i, p, i] + [p] * 6 + [i] * 11
            bwd = [p, i, p, i] + [p] * 12 + [i] * 11
            lib.gru_fwd_launch.argtypes = fwd + [p]
            lib.gru_fwd_phases_launch.argtypes = fwd + [p, p]
            lib.gru_bwd_launch.argtypes = bwd + [p]
            lib.gru_bwd_phases_launch.argtypes = bwd + [p, p]
            lib.gru_dw_launch.argtypes = [p] * 5 + [i] * 4 + [p]
            lib.gru_kernel_attributes.argtypes = [i] * 7 + [
                ctypes.POINTER(i)]
            lib.gru_device_limits.argtypes = [ctypes.POINTER(i)] * 2
            for fn in (lib.gru_fwd_launch, lib.gru_fwd_phases_launch,
                       lib.gru_bwd_launch, lib.gru_bwd_phases_launch,
                       lib.gru_dw_launch, lib.gru_kernel_attributes, lib.gru_device_limits):
                fn.restype = i
            lib.gru_error_string.argtypes = [i]
            lib.gru_error_string.restype = ctypes.c_char_p
            self.built = built
        return self.built

    def device_limits(self, device: torch.device) -> tuple[int, int]:
        """(SM count, shared memory a block may opt into) of the card, from
        the CUDA runtime."""
        idx = device.index if device.index is not None else \
            torch.cuda.current_device()
        if idx not in self.limits:
            lib = self.library().lib
            sms, smem = ctypes.c_int(), ctypes.c_int()
            with torch.cuda.device(idx):
                rc = lib.gru_device_limits(ctypes.byref(sms),
                                           ctypes.byref(smem))
            _raise_if_failed(lib, rc, "device query")
            self.limits[idx] = (sms.value, smem.value)
        return self.limits[idx]


kernel = _Kernel()


# -- the launch plan ----------------------------------------------------------

@dataclass(frozen=True)
class GruPlan:
    """How the walk kernels split the work: `groups` groups of `rows` batch
    rows (the last may hold fewer), each run by `ctas` CTAs that own
    `units` hidden units apiece; the forward stages `chunk` rows of a
    group's state at once.  Sizes in bytes."""
    groups: int
    ctas: int
    rows: int
    rows_pad: int                   # rows rounded up to the 8-row tiles
    units: int
    chunk: int
    smem_fwd: int
    smem_bwd: int
    exch_bytes: int                 # the forward's r h exchange
    scratch_bytes: int              # each of the backward's two partial sums

    @property
    def grid(self) -> int:
        return self.groups * self.ctas

    def args(self) -> tuple[int, ...]:
        return (self.groups, self.ctas, self.rows, self.units, self.chunk)


def fwd_smem_bytes(D: int, units: int, rows_pad: int, chunk: int) -> int:
    """csrc/gru.cu fwd_smem_bytes."""
    floats = (D * 3 * units + max(chunk * (D + 4), 16 * WALK_THREADS)
              + 8 * rows_pad * units)
    return 4 * floats + 4 * rows_pad


def bwd_smem_bytes(D: int, units: int, rows_pad: int) -> int:
    """csrc/gru.cu bwd_smem_bytes."""
    floats = 3 * units * D + 3 * units * rows_pad + 16 * rows_pad * units
    return 4 * floats + 4 * rows_pad


# Cycles of one training step (forward and walk) on one SM, to rank plans.
# Fitted to the split of one step at [64, 30, 512] on the (8 rows, 32 units)
# plan, timed by chip_smoke.py [seq2seq] on an H100 80GB HBM3 (PERF.md §6):
# the forward's products ran ~32 FMAs a cycle and the walk's ~61,
# the group's state came from L2 at ~11 bytes a cycle, a group barrier took
# ~2,200 cycles, a pass of the elementwise work ~5,500 (forward and walk)
# and each CTA's partials ~80 cycles a pass of the walk's ordered sums.
# With these the model ranks the four plans timed there as they ran.
_FWD_FMAS, _WALK_FMAS = 32, 61
_STAGE_BYTES = 11
_BARRIER_CYCLES = 2200
_ELEMENTWISE_CYCLES = 5500
_SUM_CYCLES = 80


def _step_cycles(D: int, ctas: int, units: int, rows_pad: int) -> float:
    fmas = rows_pad * 3 * units * D
    passes = -(-rows_pad * units // WALK_THREADS)
    cycles = fmas / _FWD_FMAS + fmas / _WALK_FMAS
    cycles += 2 * rows_pad * D * 4 / _STAGE_BYTES
    cycles += passes * _ELEMENTWISE_CYCLES
    if ctas > 1:
        cycles += 4 * _BARRIER_CYCLES + 2 * ctas * passes * _SUM_CYCLES
    return cycles


def _unit_choices(D: int) -> range:
    return range(4, D + 1, 4)


def _fit(B: int, D: int, u: int, sm_count: int, smem_limit: int,
         rows: Optional[int] = None) -> Optional[GruPlan]:
    """The one-launch plan of B rows at `u` units a CTA (`rows` a group if
    given, else as few as fill the SMs), or None if it does not fit."""
    if u % 4 or D % u:
        return None
    ctas = D // u
    max_groups = sm_count // ctas
    if max_groups < 1:
        return None
    r = rows if rows else -(-B // min(max_groups, B))
    groups = -(-B // r)
    if groups > max_groups:
        return None
    rows_pad = -(-r // 8) * 8
    if bwd_smem_bytes(D, u, rows_pad) > smem_limit:
        return None
    chunk = next((c for c in range(rows_pad, 0, -4)
                  if rows_pad % c == 0
                  and (c // 4) * (u // 2) <= WALK_THREADS
                  and fwd_smem_bytes(D, u, rows_pad, c) <= smem_limit), None)
    if chunk is None:
        return None
    return GruPlan(groups, ctas, r, rows_pad, u, chunk,
                   fwd_smem_bytes(D, u, rows_pad, chunk),
                   bwd_smem_bytes(D, u, rows_pad),
                   4 * groups * rows_pad * D, 4 * groups * ctas * rows_pad * D)


def _rank(p: GruPlan, D: int, launches: int = 1) -> tuple:
    # fastest by the model, then fewer launches, then fewer CTAs
    return (launches * _step_cycles(D, p.ctas, p.units, p.rows_pad),
            launches, p.grid)


@functools.lru_cache(maxsize=None)
def gru_plan(B: int, D: int, sm_count: int, smem_limit: int, *,
             rows: Optional[int] = None,
             units: Optional[int] = None) -> GruPlan:
    """The plan of one launch of the walk kernels over B rows at hidden size
    D on a card of `sm_count` SMs whose blocks may use `smem_limit` bytes of
    shared memory: of the splits with at most one CTA per SM whose kernels
    fit, the one `_step_cycles` ranks fastest.  `rows` and `units` pin a
    plan (to time it); ValueError if none fits."""
    fits = [p for u in ([units] if units else _unit_choices(D))
            if (p := _fit(B, D, u, sm_count, smem_limit, rows)) is not None]
    if not fits:
        raise ValueError(f"gru_plan: no split of B={B}, D={D} (rows={rows}, "
                         f"units={units}) fits {sm_count} SMs of "
                         f"{smem_limit} bytes")
    return min(fits, key=lambda p: _rank(p, D))


def _slices(B: int, D: int, plan: GruPlan, sm_count: int,
            smem_limit: int) -> tuple[tuple[int, int, GruPlan], ...]:
    """(first row, rows, plan) of each launch that walks B rows in slices
    of as many rows as `plan` takes, `plan` for each full slice and one of
    its units a CTA for a shorter last one."""
    size = plan.groups * plan.rows
    if size >= B:
        return ((0, B, plan),)
    return tuple((b0, min(size, B - b0),
                  plan if B - b0 >= size else
                  gru_plan(B - b0, D, sm_count, smem_limit, units=plan.units))
                 for b0 in range(0, B, size))


@functools.lru_cache(maxsize=None)
def gru_launches(B: int, D: int, sm_count: int,
                 smem_limit: int) -> tuple[tuple[int, int, GruPlan], ...]:
    """The walk kernels' launches over a batch of B rows, run one after
    another: (first row, rows, plan) of each.  One launch of gru_plan's pick
    where one takes the batch (at [1024, 30, 256] on the H100 its forward
    and backward together ran 4-5% faster than two slices).  Else the batch
    is cut into equal slices (the last may hold fewer rows) that each fit a
    launch: for each number of units a CTA the fewest slices, and of those
    choices the one `_step_cycles` times its launches ranks fastest."""
    try:
        return ((0, B, gru_plan(B, D, sm_count, smem_limit)),)
    except ValueError:
        pass
    best = None
    for u in _unit_choices(D):
        if _fit(1, D, u, sm_count, smem_limit) is None:
            continue
        lo, hi = 2, B          # the fewest slices that fit: fit is monotone
        while lo < hi:
            mid = (lo + hi) // 2
            if _fit(-(-B // mid), D, u, sm_count, smem_limit) is None:
                lo = mid + 1
            else:
                hi = mid
        p = _fit(-(-B // lo), D, u, sm_count, smem_limit)
        key = _rank(p, D, -(-B // (p.groups * p.rows)))
        if best is None or key < best[0]:
            best = (key, p)
    if best is None:
        raise ValueError(f"gru_launches: no split of D={D} fits "
                         f"{sm_count} SMs of {smem_limit} bytes")
    return _slices(B, D, best[1], sm_count, smem_limit)


def dw_splits(B: int, T: int, D: int, sm_count: int) -> int:
    """How many ranges of (b, t) rows the weight-gradient product is split
    into so that ~4 of its 64-thread CTAs run on each SM (each split is
    summed in order afterwards); no range is empty."""
    tiles = -(-D // DW_TILE[0]) * -(-3 * D // DW_TILE[1])
    want = -(-4 * sm_count // tiles)
    n = B * T
    splits = max(1, min(want, -(-n // 64)))
    # every range non-empty: ceil(n / splits) * (splits - 1) < n
    while splits > 1 and -(-n // splits) * (splits - 1) >= n:
        splits -= 1
    return splits


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


def _walk(x3, lengths, w_gate, w_cand, h0, act, gate, reverse):
    """The forward step by step: (hs, gates [B, T, 3D] = u, r, c of every
    step, computed from the state before it, frozen rows included)."""
    T = x3.shape[1]
    h = h0
    hs, gates = [None] * T, [None] * T
    for s in range(T):
        t = T - 1 - s if reverse else s
        h_new, u, r, c = _step(x3[:, t], h, w_gate, w_cand, act, gate)
        h = torch.where((lengths > t)[:, None], h_new, h)
        hs[t] = h
        gates[t] = torch.cat([u, r, c], dim=1)
    return torch.stack(hs, dim=1), torch.stack(gates, dim=1)


def gru_fused_plain(x3: torch.Tensor, lengths: torch.Tensor,
                    w_gate: torch.Tensor, w_cand: torch.Tensor,
                    h0: torch.Tensor, *, active_type: str = "tanh",
                    gate_active_type: str = "sigmoid",
                    reverse: bool = False):
    """The kernels' function in plain PyTorch, float32, differentiable by
    autograd: (hs [B, T, D], h_last)."""
    counts.plain += 1
    _, T, _ = _check(x3, lengths, w_gate, w_cand, h0)
    act, gate = (activation_registry[a]
                 for a in _act_names(active_type, gate_active_type))
    hs, _ = _walk(x3.float(), lengths, w_gate.float(), w_cand.float(),
                  h0.float(), act, gate, reverse)
    return hs, hs[:, _last(reverse, T)]


def gru_fwd_gates_plain(x3, lengths, w_gate, w_cand, h0, *,
                        active_type="tanh", gate_active_type="sigmoid",
                        reverse=False):
    """The forward kernel's outputs when a gradient is wanted, in plain
    PyTorch: (hs [B, T, D], gates [B, T, 3D] — u, r, c).  The kernel leaves
    the gates of frozen rows unset; the backward never reads them."""
    counts.plain += 1
    _check(x3, lengths, w_gate, w_cand, h0)
    act, gate = (activation_registry[a]
                 for a in _act_names(active_type, gate_active_type))
    return _walk(x3.float(), lengths, w_gate.float(), w_cand.float(),
                 h0.float(), act, gate, reverse)


def gru_fused_bwd_plain(x3, lengths, w_gate, w_cand, h0, hs, g_hs, g_hl, *,
                        gates=None, slices=1, active_type="tanh",
                        gate_active_type="sigmoid", reverse=False):
    """The backward kernels' data flow in plain PyTorch: from the stored hs
    [B, T, D], the forward's saved gates (recomputed from x3 when None) and
    the cotangents of (hs, h_last) to (dx3, dw_gate, dw_cand, dh0).  The
    hidden units are cut into `slices` column slices, as over a group's
    CTAs: each product with a transposed weight is the sum, in slice order,
    of the partial products over one slice's columns.  A frozen row gives
    dx3 = 0 and passes dh_total on (selected, never multiplied, so that
    unset gates cannot leak in); the weight gradients are one product over
    the operands [h_prev, r h_prev] of the valid steps."""
    counts.plain += 1
    names = _act_names(active_type, gate_active_type)
    act, gate = (activation_registry[a] for a in names)
    act_d, gate_d = (ACT_GRAD_FROM_OUTPUT[a] for a in names)
    B, T, D3 = x3.shape
    D = D3 // 3
    if D % slices:
        raise ValueError(f"gru_fused_bwd_plain: {slices} slices of {D}")
    if gates is None:
        gates = _walk(x3, lengths, w_gate, w_cand, h0, act, gate, reverse)[1]
    cuts = [slice(i * D // slices, (i + 1) * D // slices)
            for i in range(slices)]

    def by_slice(z, w):
        # z w^T as the sum over column slices of z[:, sl] w[:, sl]^T
        out = torch.zeros(z.shape[0], w.shape[0], dtype=z.dtype,
                          device=z.device)
        for sl in cuts:
            out = out + z[:, sl] @ w[:, sl].t()
        return out

    zero = torch.zeros((), dtype=x3.dtype, device=x3.device)
    dh = g_hl
    dx = torch.zeros_like(x3)
    aop = torch.zeros(B, T, 2 * D, dtype=x3.dtype, device=x3.device)
    for s in range(T - 1, -1, -1):
        t = T - 1 - s if reverse else s
        t_prev = t + 1 if reverse else t - 1
        h_prev = h0 if s == 0 else hs[:, t_prev]
        u, r, c = gates[:, t, :D], gates[:, t, D:2 * D], gates[:, t, 2 * D:]
        valid = (lengths > t)[:, None]
        dh_total = dh + g_hs[:, t]
        dzc = torch.where(valid, dh_total * (1.0 - u) * act_d(c), zero)
        dzu = torch.where(valid, dh_total * (h_prev - c) * gate_d(u), zero)
        drh = by_slice(dzc, w_cand)                         # phase A
        dzr = torch.where(valid, drh * h_prev * gate_d(r), zero)
        dzg = torch.cat([dzu, dzr], dim=1)
        # phase B: a slice's u and r columns together, as one CTA owns them
        dhg = torch.zeros_like(dh_total)
        for sl in cuts:
            zs = torch.cat([dzu[:, sl], dzr[:, sl]], dim=1)
            ws = torch.cat([w_gate[:, sl], w_gate[:, D:][:, sl]], dim=1)
            dhg = dhg + zs @ ws.t()
        dx[:, t] = torch.cat([dzg, dzc], dim=1)
        dh = torch.where(valid, dh_total * u + drh * r + dhg, dh_total)
        aop[:, t] = torch.where(valid, torch.cat([h_prev, r * h_prev], dim=1),
                                zero)
    a = aop.reshape(B * T, 2 * D)
    g = dx.reshape(B * T, D3)
    dwg = a[:, :D].t() @ g[:, :2 * D]
    dwc = a[:, D:].t() @ g[:, 2 * D:]
    return dx, dwg, dwc, dh


# -- the kernels --------------------------------------------------------------

def _check_cuda(what: str, acts, **tensors) -> None:
    """What the kernels take beyond _check: CUDA, float32, contiguous (the
    weights: unit column stride, rows 16-byte aligned), a hidden size and
    activations they were written for."""
    x3 = next(iter(tensors.values()))
    if x3.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x3.device}")
    refused = kernel_takes(tensors["w_cand"].shape[0], *acts)
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


def plan_for(B: int, D: int, device: torch.device) -> GruPlan:
    """The plan of one launch over B rows on this card."""
    return gru_plan(B, D, *kernel.device_limits(device))


def _launches(B: int, D: int, device: torch.device,
              plan: Optional[GruPlan]) -> tuple[tuple[int, int, GruPlan], ...]:
    """(first row, rows, plan) of each walk launch on this card:
    gru_launches', or slices of as many rows as a given `plan` takes."""
    limits = kernel.device_limits(device)
    if plan is not None:
        return _slices(B, D, plan, *limits)
    return gru_launches(B, D, *limits)


def _fwd(x3, lengths, w_gate, w_cand, h0, acts, reverse, save_gates, plan,
         stamps=None):
    B, T, D = _check(x3, lengths, w_gate, w_cand, h0)
    _check_cuda("gru_fused", acts, x3=x3, lengths=lengths, w_gate=w_gate,
                w_cand=w_cand, h0=h0)
    dev = x3.device
    launches = _launches(B, D, dev, plan)
    hs = torch.empty(B, T, D, dtype=torch.float32, device=dev)
    gates = torch.empty_like(x3) if save_gates else None
    exch = torch.empty(max(p.exch_bytes for *_, p in launches) // 4,
                       dtype=torch.float32, device=dev)
    counters = torch.zeros(sum(p.groups for *_, p in launches),
                           dtype=torch.int32, device=dev)
    lib = kernel.library().lib
    used = 0
    for b0, n, p in launches:
        rows = slice(b0, b0 + n)
        args = (x3[rows].data_ptr(), w_gate.data_ptr(), w_gate.stride(0),
                w_cand.data_ptr(), w_cand.stride(0), lengths[rows].data_ptr(),
                h0[rows].data_ptr(), hs[rows].data_ptr(),
                None if gates is None else gates[rows].data_ptr(),
                exch.data_ptr(), counters[used:].data_ptr(), n, T, D,
                int(bool(reverse)), *(ACT_CODES[a] for a in acts), *p.args())
        used += p.groups
        with torch.cuda.device(dev):
            if stamps is None:
                rc = lib.gru_fwd_launch(*args, _stream(x3))
            else:
                rc = lib.gru_fwd_phases_launch(*args, stamps.data_ptr(),
                                               _stream(x3))
        _raise_if_failed(lib, rc, "forward")
    return hs, gates


def gru_fwd_kernel(x3, lengths, w_gate, w_cand, h0, acts, reverse, *,
                   save_gates: bool = False, plan: Optional[GruPlan] = None):
    """The forward kernel on CUDA tensors (float32, lengths int32), one
    launch per slice of gru_launches: (hs [B, T, D], gates [B, T, 3D] — u,
    r, c — or None unless `save_gates`).  `plan` pins the plan of each
    launch, the batch walked in slices of as many rows as it takes."""
    out = _fwd(x3, lengths, w_gate, w_cand, h0, acts, reverse, save_gates,
               plan)
    counts.fwd += 1
    return out


def _bwd(lengths, w_gate, w_cand, h0, hs, gates, g_hs, g_hl, acts, reverse,
         plan, stamps=None):
    D = w_cand.shape[0]
    B, T = hs.shape[:2]
    _check_cuda("gru_fused backward", acts, hs=hs, lengths=lengths,
                w_gate=w_gate, w_cand=w_cand, h0=h0, gates=gates, g_hs=g_hs,
                g_hl=g_hl)
    for name, t, shape in (("hs", hs, (B, T, D)), ("gates", gates,
                                                   (B, T, 3 * D)),
                           ("g_hs", g_hs, (B, T, D)), ("g_hl", g_hl, (B, D)),
                           ("lengths", lengths, (B,)), ("h0", h0, (B, D)),
                           ("w_gate", w_gate, (D, 2 * D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gru_fused backward: {name} {shape} expected, "
                             f"got {tuple(t.shape)}")
    dev = hs.device
    launches = _launches(B, D, dev, plan)
    dx = torch.empty(B, T, 3 * D, dtype=torch.float32, device=dev)
    dh0 = torch.empty_like(h0)
    aop = torch.empty(B, T, 2 * D, dtype=torch.float32, device=dev)
    scr = torch.empty(2, max(p.scratch_bytes for *_, p in launches) // 4,
                      dtype=torch.float32, device=dev)
    counters = torch.zeros(sum(p.groups for *_, p in launches),
                           dtype=torch.int32, device=dev)
    lib = kernel.library().lib
    used = 0
    for b0, n, p in launches:
        rows = slice(b0, b0 + n)
        args = (w_gate.data_ptr(), w_gate.stride(0), w_cand.data_ptr(),
                w_cand.stride(0), lengths[rows].data_ptr(),
                h0[rows].data_ptr(), hs[rows].data_ptr(),
                gates[rows].data_ptr(), g_hs[rows].data_ptr(),
                g_hl[rows].data_ptr(), dx[rows].data_ptr(),
                dh0[rows].data_ptr(), aop[rows].data_ptr(),
                scr[0].data_ptr(), scr[1].data_ptr(),
                counters[used:].data_ptr(), n, T, D, int(bool(reverse)),
                *(ACT_CODES[a] for a in acts), *p.args())
        used += p.groups
        with torch.cuda.device(dev):
            if stamps is None:
                rc = lib.gru_bwd_launch(*args, _stream(hs))
            else:
                rc = lib.gru_bwd_phases_launch(*args, stamps.data_ptr(),
                                               _stream(hs))
        _raise_if_failed(lib, rc, "backward")
    if stamps is not None:
        return dx, None, None, dh0
    # the weight gradients once over the whole batch
    dwg = torch.empty(D, 2 * D, dtype=torch.float32, device=dev)
    dwc = torch.empty(D, D, dtype=torch.float32, device=dev)
    splits = dw_splits(B, T, D, kernel.device_limits(dev)[0])
    dw_part = torch.empty(splits if splits > 1 else 0, D, 3 * D,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gru_dw_launch(aop.data_ptr(), dx.data_ptr(), dwg.data_ptr(),
                               dwc.data_ptr(),
                               dw_part.data_ptr() if splits > 1 else None,
                               splits, B, T, D, _stream(hs))
    _raise_if_failed(lib, rc, "weight-gradient")
    return dx, dwg, dwc, dh0


def gru_bwd_kernel(lengths, w_gate, w_cand, h0, hs, gates, g_hs, g_hl, acts,
                   reverse, *, plan: Optional[GruPlan] = None):
    """The backward on CUDA tensors: the reverse walk from the forward's
    saved gates (one launch per slice of gru_launches, or of `plan`),
    then the weight-gradient product over the whole batch and, split, its
    ordered sum: (dx3, dw_gate, dw_cand, dh0)."""
    out = _bwd(lengths, w_gate, w_cand, h0, hs, gates, g_hs, g_hl, acts,
               reverse, plan)
    counts.bwd += 1
    return out


def gru_phase_stamps(x3, lengths, w_gate, w_cand, h0, g_hs, g_hl, acts,
                     reverse, plan: Optional[GruPlan] = None):
    """Measurement only, never on the op's path: one forward and one
    backward walk whose CTA 0 stamps clock64() around each part of every
    step; (forward stamps [T, 9], walk stamps [T, 8] in walk order) as int64
    on the host, rows of steps its group skipped all zero.  Counted in no
    launch count."""
    B, T, D = _check(x3, lengths, w_gate, w_cand, h0)
    st_f = torch.zeros(T, FWD_STAMPS, dtype=torch.int64, device=x3.device)
    st_b = torch.zeros(T, BWD_STAMPS, dtype=torch.int64, device=x3.device)
    plan = plan or plan_for(B, D, x3.device)
    hs, gates = _fwd(x3, lengths, w_gate, w_cand, h0, acts, reverse, True,
                     plan, st_f)
    _bwd(lengths, w_gate, w_cand, h0, hs, gates, g_hs, g_hl, acts, reverse,
         plan, st_b)
    return st_f.cpu(), st_b.cpu()


def kernel_attributes(D: int, plan: GruPlan) -> dict:
    """{kernel name: (registers, local memory bytes per thread, static
    shared memory bytes, dynamic shared memory bytes)} as the CUDA runtime
    reports them, the walk kernels' dynamic shared memory set for `plan`
    at hidden size D."""
    lib = kernel.library().lib
    out = {}
    for which, name in enumerate(("gru_fwd_kernel", "gru_bwd_kernel",
                                  "gru_dw_kernel", "gru_reduce_kernel")):
        vals = (ctypes.c_int * 4)()
        rc = lib.gru_kernel_attributes(which, D, *plan.args(), vals)
        _raise_if_failed(lib, rc, f"{name} attributes")
        out[name] = tuple(vals)
    return out


class _GruFused(torch.autograd.Function):
    """The `jax.custom_vjp` of `_gru_fused_factory`: the forward stores hs
    and, when a gradient is wanted (`save_gates`), the gates; the backward
    takes the cotangents of (hs, h_last) and returns (dx3, dw_gate,
    dw_cand, None, dh0)."""

    @staticmethod
    def forward(ctx, x3, w_gate, w_cand, lengths, h0, acts, reverse,
                save_gates):
        hs, gates = gru_fwd_kernel(x3, lengths, w_gate, w_cand, h0, acts,
                                   reverse, save_gates=save_gates)
        if save_gates:
            ctx.save_for_backward(w_gate, w_cand, lengths, h0, hs, gates)
        ctx.args = (acts, reverse)
        return hs, hs[:, _last(reverse, x3.shape[1])].clone()

    @staticmethod
    def backward(ctx, g_hs, g_hl):
        w_gate, w_cand, lengths, h0, hs, gates = ctx.saved_tensors
        dx, dwg, dwc, dh0 = gru_bwd_kernel(
            lengths, w_gate, w_cand, h0, hs, gates, g_hs.contiguous(),
            g_hl.contiguous(), *ctx.args)
        return dx, dwg, dwc, None, dh0, None, None, None


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
    save_gates = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x3, w_gate, w_cand, h0))
    return _GruFused.apply(x3.float().contiguous(), _rows(w_gate),
                           _rows(w_cand), lengths.to(torch.int32).contiguous(),
                           h0.float().contiguous(), acts, bool(reverse),
                           save_gates)
