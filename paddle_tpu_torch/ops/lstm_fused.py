"""Fused LSTM recurrence: the hand-written CUDA kernels' wrappers and launch
plan, their plain PyTorch versions, the autograd function over them, and
their call counts.

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
autograd's backward launches its backward (or they raise); for CPU tensors
`lstm_fused` is `lstm_fused_plain`, the same arithmetic step by step with
autograd for its gradient.  There is no fallback from one to the other.
Unlike the JAX wrapper nothing is transposed or flipped around the kernels:
they index [B, T, .] tensors and walk time in either direction themselves.

The kernels split the batch into groups of rows, each run by a
thread-block cluster whose CTAs own slices of the hidden units with their
four gate columns of W on chip (in registers where they fit) and send each
step's new h to one another through distributed shared memory, counted by
an mbarrier (csrc/lstm.cu); `lstm_plans` lists the splits, `ranked_plans`
ranks them for the card and `plan_for` takes the first.  When a gradient
is wanted the forward also saves the activated gates a, i, f, o, and the
backward walks from them.  `lstm_fwd_gates_plain` and
`lstm_fused_bwd_plain` are that data flow transcribed to PyTorch (the
backward's product summed per column slice in slice order), so that it
can be checked against autograd where there is no
card.
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
from paddle_tpu_torch.utils.dtypes import promote_compute

# activation name -> the kernels' code (csrc/lstm.cu act_fwd / act_grad)
ACT_CODES = {"sigmoid": 0, "tanh": 1, "relu": 2, "linear": 3, "": 3}
MIN_HIDDEN, MAX_HIDDEN, HIDDEN_STEP = 32, 512, 32
WALK_THREADS = 256                  # csrc/lstm.cu THREADS
ROW_TILE, COL_QUADS, MAX_KS = 4, 2, 16   # csrc/lstm.cu RT, CQ, MAX_KS
CLUSTER_SIZES = (1, 2, 4, 8, 16)    # CTAs a cluster (above 8: non-portable)
DW_TILE = (64, 64)                  # csrc/lstm.cu DW_BM x DW_BN
FWD_STAMPS, BWD_STAMPS = 6, 6       # clock64() stamps per step (_phases)


class CallCounts:
    """How often each version ran: `fwd` and `bwd` count calls of the two
    kernel wrappers (each launches its kernels once), `plain` counts calls
    of the plain PyTorch versions (forward or the transcribed backward)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.fwd = 0
        self.bwd = 0
        self.plain = 0


counts = CallCounts()


class _Kernel:
    """The built library and its C entry points, made on first launch; the
    card's limits and the occupancy of the plans asked for, cached."""

    def __init__(self):
        self.built: Optional[cuda_build.KernelLibrary] = None
        self.limits: dict = {}
        self.plans: dict = {}

    def library(self) -> cuda_build.KernelLibrary:
        if self.built is None:
            built = cuda_build.build("lstm")
            lib = built.lib
            p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
                ctypes.c_int)
            fwd = [p] * 9 + [i] * 13
            bwd = [p] * 14 + [i] * 13
            lib.lstm_fwd_launch.argtypes = fwd + [p]
            lib.lstm_fwd_phases_launch.argtypes = fwd + [p, p]
            lib.lstm_bwd_launch.argtypes = bwd + [p]
            lib.lstm_bwd_phases_launch.argtypes = bwd + [p, p]
            lib.lstm_dw_launch.argtypes = [p] * 8 + [i] * 5 + [p]
            lib.lstm_plan_occupancy.argtypes = [i] * 7 + [ip]
            lib.lstm_kernel_attributes.argtypes = [i] * 8 + [ip]
            lib.lstm_device_limits.argtypes = [ip, ip]
            for fn in (lib.lstm_fwd_launch, lib.lstm_fwd_phases_launch,
                       lib.lstm_bwd_launch, lib.lstm_bwd_phases_launch,
                       lib.lstm_dw_launch, lib.lstm_plan_occupancy,
                       lib.lstm_kernel_attributes, lib.lstm_device_limits):
                fn.restype = i
            lib.lstm_error_string.argtypes = [i]
            lib.lstm_error_string.restype = ctypes.c_char_p
            self.built = built
        return self.built

    @staticmethod
    def _index(device: torch.device) -> int:
        return device.index if device.index is not None else \
            torch.cuda.current_device()

    def device_limits(self, device: torch.device) -> tuple[int, int]:
        """(SM count, shared memory a block may opt into) of the card, from
        the CUDA runtime."""
        idx = self._index(device)
        if idx not in self.limits:
            lib = self.library().lib
            sms, smem = ctypes.c_int(), ctypes.c_int()
            with torch.cuda.device(idx):
                rc = lib.lstm_device_limits(ctypes.byref(sms),
                                            ctypes.byref(smem))
            _raise_if_failed(lib, rc, "device query")
            self.limits[idx] = (sms.value, smem.value)
        return self.limits[idx]

    def occupancy(self, D: int, plan: "LstmPlan",
                  device: torch.device) -> tuple[int, int]:
        """How many clusters of `plan` the card holds at once, for the
        forward and for the backward walk (0: none)."""
        lib = self.library().lib
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(self._index(device)):
            rc = lib.lstm_plan_occupancy(D, *plan.args(), out)
        _raise_if_failed(lib, rc, "occupancy query")
        return out[0], out[1]


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


# -- the launch plan ----------------------------------------------------------

@dataclass(frozen=True)
class LstmPlan:
    """How the walk kernels split the work: `clusters` groups of `rows`
    batch rows (the last may hold fewer), each run by a cluster of `ctas`
    CTAs that own `units` hidden units apiece; `res_fwd` of the D rows of a
    CTA's [D, 4U] W slice stay in shared memory in the forward, `res_bwd` of
    the 4U rows of its transpose in the backward (the rest is read from L2
    every step).  Sizes in bytes."""
    clusters: int
    ctas: int
    rows: int
    rows_pad: int                   # rows rounded up to the 4-row tiles
    units: int
    res_fwd: int
    res_bwd: int
    smem_fwd: int
    smem_bwd: int

    @property
    def grid(self) -> int:
        return self.clusters * self.ctas

    def args(self) -> tuple[int, ...]:
        return (self.clusters, self.ctas, self.rows, self.units,
                self.res_fwd, self.res_bwd)


def _k_splits(tiles: int) -> int:
    """csrc/lstm.cu k_splits: lanes a product tile, a power of two."""
    ks = 1
    while 2 * ks <= MAX_KS and tiles * 2 * ks <= WALK_THREADS:
        ks *= 2
    return ks


def _reg_quads(KQ: int, KS: int, tiles: int) -> int:
    """csrc/lstm.cu reg_quads: k-quads of W a lane keeps in registers (0:
    the slice stays in shared memory)."""
    nm = KQ // KS
    return nm if tiles <= WALK_THREADS and KQ % KS == 0 and nm in (2, 4) \
        else 0


def fwd_quads(D: int, units: int, rows_pad: int) -> int:
    """csrc/lstm.cu fwd_quads."""
    tiles = rows_pad // ROW_TILE * (units // COL_QUADS)
    return _reg_quads(D // 4, _k_splits(tiles), tiles)


def bwd_quads(D: int, units: int, rows_pad: int) -> int:
    """csrc/lstm.cu bwd_quads."""
    tiles = rows_pad // ROW_TILE * (D // (4 * COL_QUADS))
    return _reg_quads(units, _k_splits(tiles), tiles)


def fwd_smem_bytes(D: int, units: int, rows_pad: int, res: int) -> int:
    """csrc/lstm.cu fwd_smem_bytes."""
    w = 0 if fwd_quads(D, units, rows_pad) else res * (4 * units + 4)
    return 4 * (w + 2 * rows_pad * (D + 4)) + 4 * rows_pad


def bwd_smem_bytes(D: int, units: int, rows_pad: int, res: int) -> int:
    """csrc/lstm.cu bwd_smem_bytes."""
    w = 0 if bwd_quads(D, units, rows_pad) else res * (D + 4)
    return (4 * (w + 2 * rows_pad * D + rows_pad * (4 * units + 4))
            + 4 * rows_pad)


# Cycles of one training step (forward and backward walk) on one CTA, to
# rank plans; fitted to the per-step split (clock64() stamps) of the plans
# timed at [128, 100, 128] on an H100 (PERF.md section 6).  A lane's
# k-quad of a product tile (4 rows x 8 columns, 128 FMAs) took ~300 cycles
# with W in registers (~600 assumed with W in shared memory: three times
# the loads), the shuffles that sum a tile and the sends ~850 a product;
# the elementwise work ~850 cycles a walk; the exchange of a walk (the
# sends, the writes to device memory, the wait) ~850 plus ~60 for each CTA
# of the cluster.  Rows of W read from L2 at ~11 bytes a cycle (K1's
# staging rate).
_REG_QUAD_CYCLES = 300
_SMEM_QUAD_CYCLES = 600
_REDUCE_CYCLES = 850
_ELEMENTWISE_CYCLES = 850
_EXCHANGE_CYCLES, _PEER_CYCLES = 850, 60
_STREAM_BYTES = 11


def _step_cycles(D: int, p: LstmPlan) -> float:
    U, Rp = p.units, p.rows_pad
    cycles = 0.0
    for KQ, tiles, nm in ((D // 4, Rp // ROW_TILE * (U // COL_QUADS),
                           fwd_quads(D, U, Rp)),
                          (U, Rp // ROW_TILE * (D // (4 * COL_QUADS)),
                           bwd_quads(D, U, Rp))):
        ks = _k_splits(tiles)
        quads = -(-KQ // ks) * -(-tiles * ks // WALK_THREADS)
        cycles += _REDUCE_CYCLES + quads * (_REG_QUAD_CYCLES if nm
                                            else _SMEM_QUAD_CYCLES)
    cycles += ((D - p.res_fwd) * 4 * U + (4 * U - p.res_bwd) * D) * 4 \
        / _STREAM_BYTES
    cycles += 2 * (_ELEMENTWISE_CYCLES + _EXCHANGE_CYCLES
                   + p.ctas * _PEER_CYCLES)
    return cycles


def _waves(p: LstmPlan, sm_count: int) -> int:
    """Waves of clusters, at one CTA per SM."""
    return -(-p.clusters // max(1, sm_count // p.ctas))


def _fit(B: int, D: int, ctas: int, rows: int,
         smem_limit: int) -> Optional[LstmPlan]:
    """The plan of B rows in groups of at most `rows` (balanced) on clusters
    of `ctas`, with as much of each W slice resident as shared memory
    holds, or None if the rest does not fit."""
    if D % ctas or (D // ctas) % 4:
        return None
    U = D // ctas
    clusters = -(-B // rows)
    r = -(-B // clusters)
    rp = -(-r // ROW_TILE) * ROW_TILE
    if rp * U > WALK_THREADS:           # one (row, unit) item a thread
        return None
    room_f = smem_limit - fwd_smem_bytes(D, U, rp, 0)
    room_b = smem_limit - bwd_smem_bytes(D, U, rp, 0)
    if room_f < 0 or room_b < 0:
        return None
    # W in registers counts as resident
    res_f = D if fwd_quads(D, U, rp) else \
        min(D, room_f // (4 * (4 * U + 4)) // 4 * 4)
    res_b = 4 * U if bwd_quads(D, U, rp) else \
        min(4 * U, room_b // (4 * (D + 4)) // 4 * 4)
    return LstmPlan(clusters, ctas, r, rp, U, res_f, res_b,
                    fwd_smem_bytes(D, U, rp, res_f),
                    bwd_smem_bytes(D, U, rp, res_b))


def _row_choices(B: int) -> list[int]:
    return sorted({min(B, r) for r in (1, 2, 3, *range(4, 129, 4))})


@functools.lru_cache(maxsize=None)
def lstm_plans(B: int, D: int, sm_count: int,
               smem_limit: int) -> tuple[LstmPlan, ...]:
    """Every plan of one launch over B rows at hidden size D on a card of
    `sm_count` SMs whose blocks may use `smem_limit` bytes of shared
    memory, fastest first by `_step_cycles` times the waves of clusters
    (then fewer CTAs)."""
    plans = {p for c in CLUSTER_SIZES if c <= sm_count
             for r in _row_choices(B)
             if (p := _fit(B, D, c, r, smem_limit)) is not None}
    return tuple(sorted(plans, key=lambda p: (
        _waves(p, sm_count) * _step_cycles(D, p), p.grid, p.ctas)))


def lstm_plan(B: int, D: int, sm_count: int, smem_limit: int) -> LstmPlan:
    """The fastest plan of lstm_plans.  ValueError if none fits."""
    plans = lstm_plans(B, D, sm_count, smem_limit)
    if not plans:
        raise ValueError(f"lstm_plan: no split of B={B}, D={D} fits "
                         f"{sm_count} SMs of {smem_limit} bytes")
    return plans[0]


def dw_splits(B: int, T: int, D: int, sm_count: int) -> int:
    """How many ranges of (b, t) rows the weight-gradient product is split
    into so that ~4 of its 64-thread CTAs run on each SM (each split is
    summed in order afterwards); no range is empty."""
    tiles = -(-D // DW_TILE[0]) * (4 * D // DW_TILE[1])
    want = -(-4 * sm_count // tiles)
    n = B * T
    splits = max(1, min(want, -(-n // 64)))
    while splits > 1 and -(-n // splits) * (splits - 1) >= n:
        splits -= 1
    return splits


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


def _walk(x4, lengths, w, peeps, h0, c0, acts, reverse, keep_gates=False):
    """The recurrence step by step in float32: (hs, cs) [B, T, D], each step
    the state after it (frozen rows repeat theirs), and with `keep_gates`
    the activated gates [B, T, 4D] (a, i, f, o of every step from the state
    before it, frozen rows included), else None."""
    B, T, D4 = x4.shape
    D = D4 // 4
    act, gate, state = (activation_registry[a] for a in acts)
    h, c = h0, c0
    hs, cs, gates = [None] * T, [None] * T, [None] * T
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
        if keep_gates:
            gates[t] = torch.cat([a, ig, fg, og], dim=1)
    return (torch.stack(hs, dim=1), torch.stack(cs, dim=1),
            torch.stack(gates, dim=1) if keep_gates else None)


def _plain_steps(x4, lengths, w, peeps, h0, c0, acts, reverse):
    """(hs, cs) [B, T, D] of the recurrence, step by step in float32."""
    return _walk(x4, lengths, w, peeps, h0, c0, acts, reverse)[:2]


def _last(reverse: bool, T: int) -> int:
    """The time index of the last scan step."""
    return 0 if reverse else T - 1


def lstm_fused_plain(x4: torch.Tensor, lengths: torch.Tensor,
                     w: torch.Tensor, peeps: torch.Tensor, h0: torch.Tensor,
                     c0: torch.Tensor, *, active_type: str = "tanh",
                     gate_active_type: str = "sigmoid",
                     state_active_type: str = "tanh", reverse: bool = False):
    """The kernels' function in plain PyTorch, float32 (float64 inputs, the
    gradient check's float64 pass on the CPU, stay float64),
    differentiable by autograd: (hs [B, T, D], h_last, c_last)."""
    counts.plain += 1
    _check(x4, lengths, w, peeps, h0, c0)
    acts = _act_names(active_type, gate_active_type, state_active_type)
    hs, cs = _plain_steps(*map(promote_compute, (x4, lengths, w, peeps, h0,
                                                 c0)), acts, reverse)
    tl = _last(reverse, x4.shape[1])
    return hs, hs[:, tl], cs[:, tl]


def lstm_fwd_gates_plain(x4, lengths, w, peeps, h0, c0, *,
                         active_type="tanh", gate_active_type="sigmoid",
                         state_active_type="tanh", reverse=False):
    """The forward kernel's outputs when a gradient is wanted, in plain
    PyTorch: (hs, cs [B, T, D], gates [B, T, 4D] — a, i, f, o).  The kernel
    leaves the gates of frozen rows unset; the backward never reads them."""
    counts.plain += 1
    _check(x4, lengths, w, peeps, h0, c0)
    acts = _act_names(active_type, gate_active_type, state_active_type)
    return _walk(x4.float(), lengths, w.float(), peeps.float(), h0.float(),
                 c0.float(), acts, reverse, keep_gates=True)


def lstm_fused_bwd_plain(x4, lengths, w, peeps, h0, c0, hs, cs, g_hs, g_hl,
                         g_cl, *, gates=None, slices=1, active_type="tanh",
                         gate_active_type="sigmoid",
                         state_active_type="tanh", reverse=False):
    """The backward kernels' data flow in plain PyTorch (the walk of
    pallas_rnn._lstm_bwd_kernel): from the stored hs, cs [B, T, D], the
    forward's saved gates (recomputed from x4 when None) and the cotangents
    of (hs, h_last, c_last) to (dx4, dw, dpeeps, dh0, dc0).  The hidden
    units are cut into `slices` slices, as over a cluster's CTAs: dx4 W^T
    is the sum, in slice order, of the partial products over one slice's
    four gate columns.  A frozen step gives dx4 = 0, passes dh_total on and
    keeps dc (selected, never multiplied, so that unset gates cannot leak
    in); the peephole gradients are summed per row, then over the rows;
    dW is one product over the operands h_prev of every step."""
    counts.plain += 1
    acts = _act_names(active_type, gate_active_type, state_active_type)
    act_d, gate_d, state_d = (ACT_GRAD_FROM_OUTPUT[a] for a in acts)
    state = activation_registry[acts[2]]
    B, T, D4 = x4.shape
    D = D4 // 4
    if D % slices:
        raise ValueError(f"lstm_fused_bwd_plain: {slices} slices of {D}")
    if gates is None:
        gates = _walk(x4, lengths, w, peeps, h0, c0, acts, reverse,
                      keep_gates=True)[2]
    U = D // slices
    cols = [torch.cat([torch.arange(m * D + q * U, m * D + (q + 1) * U)
                       for m in range(4)]).to(x4.device)
            for q in range(slices)]
    zero = torch.zeros((), dtype=x4.dtype, device=x4.device)
    dh, dc = g_hl, g_cl
    dx = torch.zeros_like(x4)
    h_prev_all = torch.zeros(B, T, D, dtype=x4.dtype, device=x4.device)
    dp_rows = torch.zeros(B, 3, D, dtype=x4.dtype, device=x4.device)
    for s in range(T - 1, -1, -1):
        t = T - 1 - s if reverse else s
        t_prev = t + 1 if reverse else t - 1
        h_prev_all[:, t] = h0 if s == 0 else hs[:, t_prev]
        c_prev = c0 if s == 0 else cs[:, t_prev]
        c_new = cs[:, t]
        a, ig, fg, og = (gates[:, t, m * D:(m + 1) * D] for m in range(4))
        valid = (lengths > t)[:, None]
        sc = state(c_new)
        dh_total = dh + g_hs[:, t]
        dzo = dh_total * sc * gate_d(og)
        dc_in = dh_total * og * state_d(sc) + dc + dzo * peeps[2]
        dza = dc_in * ig * act_d(a)
        dzi = dc_in * a * gate_d(ig)
        dzf = dc_in * c_prev * gate_d(fg)
        dc_prev = dc_in * fg + dzi * peeps[0] + dzf * peeps[1]
        dx4_t = torch.where(valid, torch.cat([dza, dzi, dzf, dzo], dim=1),
                            zero)
        dx[:, t] = dx4_t
        prod = torch.zeros_like(dh_total)
        for c in cols:
            prod = prod + dx4_t[:, c] @ w[:, c].t()
        dh = torch.where(valid, prod, dh_total)
        dc = torch.where(valid, dc_prev, dc)
        dp_rows = dp_rows + torch.where(
            valid[:, None], torch.stack([dzi * c_prev, dzf * c_prev,
                                         dzo * c_new], dim=1), zero)
    dw = h_prev_all.reshape(B * T, D).t() @ dx.reshape(B * T, D4)
    return dx, dw, dp_rows.sum(0), dh, dc


# -- the kernels --------------------------------------------------------------

def _check_cuda(what: str, acts, D: int, **tensors) -> None:
    """What the kernels take beyond _check: CUDA, float32, contiguous and
    16-byte aligned (rows are copied with cp.async), a hidden size and
    activations they were written for."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {first.device}")
    refused = kernel_takes(D, *acts)
    if refused:
        raise ValueError(f"{what}: the CUDA kernels do not take {refused}")
    for name, t in tensors.items():
        want = torch.int32 if name == "lengths" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if name != "lengths" and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _raise_if_failed(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lstm_error_string(rc).decode()
        raise RuntimeError(f"fused LSTM {what} kernel launch failed: CUDA "
                           f"error {rc} ({msg})")


def _stream(t: torch.Tensor) -> int:
    # read at every launch: autograd runs the backward on its own thread
    return torch.cuda.current_stream(t.device).cuda_stream


def ranked_plans(B: int, D: int,
                 device: torch.device) -> tuple[LstmPlan, ...]:
    """lstm_plans ranked for this card: by `_step_cycles` times the waves of
    clusters as the card holds them (cudaOccupancyMaxActiveClusters of both
    walk kernels; plans of which it holds none are left out), cached."""
    key = (kernel._index(device), B, D)
    if key not in kernel.plans:
        limits = kernel.device_limits(device)
        ranked = []
        for p in lstm_plans(B, D, *limits):
            held = min(kernel.occupancy(D, p, device))
            if held >= 1:
                ranked.append(((-(-p.clusters // held) * _step_cycles(D, p),
                                p.grid), p))
        kernel.plans[key] = tuple(p for _, p in sorted(
            ranked, key=lambda x: x[0]))
    return kernel.plans[key]


def plan_for(B: int, D: int, device: torch.device) -> LstmPlan:
    """The plan of a launch over B rows on this card: the first of
    ranked_plans.  RuntimeError if the card holds none."""
    ranked = ranked_plans(B, D, device)
    if not ranked:
        raise RuntimeError(f"fused LSTM: the card holds no cluster of any "
                           f"plan of B={B}, D={D}")
    return ranked[0]


def _fwd(x4, lengths, w, peeps, h0, c0, acts, reverse, save_gates, plan,
         stamps=None):
    B, T, D = _check(x4, lengths, w, peeps, h0, c0)
    _check_cuda("lstm_fused", acts, D, x4=x4, lengths=lengths, w=w,
                peeps=peeps, h0=h0, c0=c0)
    dev = x4.device
    plan = plan or plan_for(B, D, dev)
    hs = torch.empty(B, T, D, dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(x4) if save_gates else None
    lib = kernel.library().lib
    args = (x4.data_ptr(), w.data_ptr(), peeps.data_ptr(),
            lengths.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), None if gates is None else gates.data_ptr(), B, T,
            D, int(bool(reverse)), *(ACT_CODES[a] for a in acts),
            *plan.args())
    with torch.cuda.device(dev):
        if stamps is None:
            rc = lib.lstm_fwd_launch(*args, _stream(x4))
        else:
            rc = lib.lstm_fwd_phases_launch(*args, stamps.data_ptr(),
                                            _stream(x4))
    _raise_if_failed(lib, rc, "forward")
    return hs, cs, gates


def lstm_fwd_kernel(x4, lengths, w, peeps, h0, c0, acts, reverse, *,
                    save_gates: bool = False,
                    plan: Optional[LstmPlan] = None):
    """One launch of the forward kernel on CUDA tensors (float32, lengths
    int32): (hs, cs [B, T, D], gates [B, T, 4D] — a, i, f, o — or None
    unless `save_gates`).  `plan` pins the launch plan."""
    out = _fwd(x4, lengths, w, peeps, h0, c0, acts, reverse, save_gates,
               plan)
    counts.fwd += 1
    return out


def _bwd(lengths, w, peeps, h0, c0, hs, cs, gates, g_hs, g_hl, g_cl, acts,
         reverse, plan, stamps=None):
    D = w.shape[0]
    B, T = hs.shape[:2]
    _check_cuda("lstm_fused backward", acts, D, hs=hs, lengths=lengths, w=w,
                peeps=peeps, h0=h0, c0=c0, cs=cs, gates=gates, g_hs=g_hs,
                g_hl=g_hl, g_cl=g_cl)
    for name, t, shape in (("hs", hs, (B, T, D)), ("cs", cs, (B, T, D)),
                           ("gates", gates, (B, T, 4 * D)),
                           ("g_hs", g_hs, (B, T, D)), ("g_hl", g_hl, (B, D)),
                           ("g_cl", g_cl, (B, D)), ("lengths", lengths, (B,)),
                           ("h0", h0, (B, D)), ("c0", c0, (B, D)),
                           ("w", w, (D, 4 * D)), ("peeps", peeps, (3, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"lstm_fused backward: {name} {shape} expected, "
                             f"got {tuple(t.shape)}")
    dev = hs.device
    plan = plan or plan_for(B, D, dev)
    # the slice's rows that stay in L2 are read from W^T
    wt = w.t().contiguous() if plan.res_bwd < 4 * plan.units else None
    dx = torch.empty(B, T, 4 * D, dtype=torch.float32, device=dev)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    dpeep_part = torch.empty(B, 3, D, dtype=torch.float32, device=dev)
    lib = kernel.library().lib
    args = (w.data_ptr(), None if wt is None else wt.data_ptr(),
            peeps.data_ptr(), lengths.data_ptr(), c0.data_ptr(),
            cs.data_ptr(), gates.data_ptr(), g_hs.data_ptr(),
            g_hl.data_ptr(), g_cl.data_ptr(), dx.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), dpeep_part.data_ptr(), B, T, D,
            int(bool(reverse)), *(ACT_CODES[a] for a in acts), *plan.args())
    with torch.cuda.device(dev):
        if stamps is None:
            rc = lib.lstm_bwd_launch(*args, _stream(hs))
        else:
            rc = lib.lstm_bwd_phases_launch(*args, stamps.data_ptr(),
                                            _stream(hs))
    _raise_if_failed(lib, rc, "backward")
    if stamps is not None:
        return dx, None, None, dh0, dc0
    dw, dpeeps = torch.empty_like(w), torch.empty_like(peeps)
    splits = dw_splits(B, T, D, kernel.device_limits(dev)[0])
    dw_part = torch.empty(splits if splits > 1 else 0, D, 4 * D,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.lstm_dw_launch(hs.data_ptr(), h0.data_ptr(), dx.data_ptr(),
                                lengths.data_ptr(), dpeep_part.data_ptr(),
                                dw.data_ptr(), dpeeps.data_ptr(),
                                dw_part.data_ptr() if splits > 1 else None,
                                splits, B, T, D, int(bool(reverse)),
                                _stream(hs))
    _raise_if_failed(lib, rc, "weight-gradient")
    return dx, dw, dpeeps, dh0, dc0


def lstm_bwd_kernel(lengths, w, peeps, h0, c0, hs, cs, gates, g_hs, g_hl,
                    g_cl, acts, reverse, *, plan: Optional[LstmPlan] = None):
    """The backward on CUDA tensors: the reverse walk from the forward's
    saved gates, then the weight-gradient product and the ordered sums:
    (dx4, dw, dpeeps, dh0, dc0)."""
    out = _bwd(lengths, w, peeps, h0, c0, hs, cs, gates, g_hs, g_hl, g_cl,
               acts, reverse, plan)
    counts.bwd += 1
    return out


def lstm_phase_stamps(x4, lengths, w, peeps, h0, c0, g_hs, g_hl, g_cl, acts,
                      reverse, plan: Optional[LstmPlan] = None):
    """Measurement only, never on the op's path: one forward and one
    backward walk whose CTA 0 stamps clock64() around each part of every
    step; (forward stamps [T, 6], walk stamps [T, 6] in walk order) as int64
    on the host, rows of steps its group skipped all zero.  Counted in no
    launch count."""
    B, T, D = _check(x4, lengths, w, peeps, h0, c0)
    st_f = torch.zeros(T, FWD_STAMPS, dtype=torch.int64, device=x4.device)
    st_b = torch.zeros(T, BWD_STAMPS, dtype=torch.int64, device=x4.device)
    plan = plan or plan_for(B, D, x4.device)
    hs, cs, gates = _fwd(x4, lengths, w, peeps, h0, c0, acts, reverse, True,
                         plan, st_f)
    _bwd(lengths, w, peeps, h0, c0, hs, cs, gates, g_hs, g_hl, g_cl, acts,
         reverse, plan, st_b)
    return st_f.cpu(), st_b.cpu()


def kernel_attributes(D: int, plan: LstmPlan) -> dict:
    """{kernel name: (registers, local memory bytes per thread, static
    shared memory bytes, dynamic shared memory bytes)} as the CUDA runtime
    reports them, the walk kernels' dynamic shared memory set for `plan`
    at hidden size D."""
    lib = kernel.library().lib
    out = {}
    for which, name in enumerate(("lstm_fwd_kernel", "lstm_bwd_kernel",
                                  "lstm_dw_kernel", "lstm_reduce_kernel")):
        vals = (ctypes.c_int * 4)()
        rc = lib.lstm_kernel_attributes(which, D, *plan.args(), vals)
        _raise_if_failed(lib, rc, f"{name} attributes")
        out[name] = tuple(vals)
    return out


class _LstmFused(torch.autograd.Function):
    """The `jax.custom_vjp` of `_lstm_fused_factory`: the forward stores hs,
    cs and, when a gradient is wanted (`save_gates`), the gates; the
    backward takes the cotangents of (hs, h_last, c_last) and returns (dx4,
    dw, dpeeps, None, dh0, dc0)."""

    @staticmethod
    def forward(ctx, x4, w, peeps, lengths, h0, c0, acts, reverse,
                save_gates):
        hs, cs, gates = lstm_fwd_kernel(x4, lengths, w, peeps, h0, c0, acts,
                                        reverse, save_gates=save_gates)
        if save_gates:
            ctx.save_for_backward(w, peeps, lengths, h0, c0, hs, cs, gates)
        ctx.args = (acts, reverse)
        tl = _last(reverse, x4.shape[1])
        return hs, hs[:, tl].clone(), cs[:, tl].clone()

    @staticmethod
    def backward(ctx, g_hs, g_hl, g_cl):
        w, peeps, lengths, h0, c0, hs, cs, gates = ctx.saved_tensors
        dx, dw, dpeeps, dh0, dc0 = lstm_bwd_kernel(
            lengths, w, peeps, h0, c0, hs, cs, gates, _f32(g_hs),
            _f32(g_hl), _f32(g_cl), *ctx.args)
        return dx, dw, dpeeps, None, dh0, dc0, None, None, None


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A cotangent as the kernels read it: float32, contiguous, 16-byte
    aligned (autograd may hand in a view)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    save_gates = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x4, w, peeps, h0, c0))

    def f32(t):
        return t.float().contiguous()

    return _LstmFused.apply(f32(x4), f32(w), f32(peeps),
                            lengths.to(torch.int32).contiguous(), f32(h0),
                            f32(c0), acts, bool(reverse), save_gates)
