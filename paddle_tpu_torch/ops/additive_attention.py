"""The Bahdanau additive-attention step: the hand-written CUDA kernel's
wrapper, its plain PyTorch version, the autograd function over them, and
their call counts.

Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas_additive.py
(`_kernel` via `_fwd_pallas`) and keeps that module's split: `_fused`
computes u = dec_state @ w in float32 outside the kernel (a `torch.matmul`,
true float32: the port leaves TF32 off) and hands u to the kernel, which
returns context = sum_t softmax_t(v . tanh(enc_proj[t] + u)) enc_seq[t]
over t < lengths, accumulated in float32 and written in enc_seq's dtype.
The backward (`_vjp_bwd`) recomputes through the dense formula
(ops/attention.py `additive_attention_step`) with autograd; there is no
backward kernel, as the JAX package has none.

The kernel spreads a batch row over a thread-block cluster of CTAs
(`additive_plan` picks their number from shapes): each CTA scores the keys
over its slice of D, the cluster sums the partial scores through
distributed shared memory once per tile of 32 keys, and each CTA writes the
context of its slice of Dv, so every byte of enc_proj and enc_seq is read
once and the decoder's 64 rows fill the card.  It moves those bytes, but
at the seq2seq shapes latency bounds it (the loads, the exchange and the
context tail; PERF.md).

The kernel is lengths-based: a row with no valid key gets a zero context,
where the dense formula returns the average over all keys; the backward is
the dense formula's gradient either way, as on the JAX side.

For CUDA tensors the forward launches the kernel of
csrc/additive_attention.cu (or raises); for CPU tensors it runs
`additive_attention_plain`, the kernel's arithmetic in plain PyTorch.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.ops import cuda_build
from paddle_tpu_torch.ops.attention import additive_attention_step

_NEG_INF = -1e30
MAX_D, MAX_DV = 4096, 2048          # csrc/additive_attention.cu limits
MAX_CTAS = 8                        # CTAs of a row's cluster
MAX_SLICE = 256                     # Dv columns one CTA owns at most
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class CallCounts:
    """How often each version ran: `kernel` counts CUDA launches, `plain`
    calls of the plain forward, `recompute` the backward's recomputes
    through the dense formula (the reference's design, not a plain
    stand-in for the kernel)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0
        self.recompute = 0


counts = CallCounts()


class _Kernel:
    """The built library and its C entry point, made on first launch."""

    def __init__(self):
        self.built: Optional[cuda_build.KernelLibrary] = None

    def library(self) -> cuda_build.KernelLibrary:
        if self.built is None:
            built = cuda_build.build("additive_attention")
            lib = built.lib
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.additive_attention_launch.argtypes = [p] * 6 + [i] * 6 + [p]
            lib.additive_attention_launch.restype = i
            lib.additive_attention_attributes.argtypes = [
                i, ctypes.POINTER(i)]
            lib.additive_attention_attributes.restype = i
            lib.additive_attention_error_string.argtypes = [i]
            lib.additive_attention_error_string.restype = ctypes.c_char_p
            self.built = built
        return self.built


kernel = _Kernel()
_SM_COUNT: dict = {}


def additive_plan(B: int, Dv: int, sm_count: int) -> int:
    """CTAs of a batch row's cluster: the fewest of 1, 2, 4, 8 whose Dv
    slices (ceil(Dv / ctas), which round up to 8 columns within it) stay
    within MAX_SLICE, doubled while the B clusters give fewer CTAs than the
    card has SMs.  Shapes alone decide."""
    ctas = 1
    while -(-Dv // ctas) > MAX_SLICE:
        ctas *= 2
    while ctas < MAX_CTAS and B * ctas < sm_count:
        ctas *= 2
    return ctas


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def kernel_attributes() -> dict:
    """The runtime's account of the float32 and bfloat16 kernels
    (cudaFuncGetAttributes): {dtype: (registers, local memory bytes per
    thread, static shared memory bytes, the most dynamic shared memory a
    launch asks)}."""
    lib = kernel.library().lib
    out = {}
    for code, name in ((0, "float32"), (1, "bfloat16")):
        buf = (ctypes.c_int * 4)()
        rc = lib.additive_attention_attributes(code, buf)
        if rc:
            raise RuntimeError(f"additive_attention_attributes({name}) "
                               f"failed: CUDA error {rc}")
        out[name] = tuple(buf)
    return out


def _check(u, v, enc_proj, enc_seq, lengths) -> tuple[int, int, int, int]:
    if enc_proj.dim() != 3 or enc_seq.dim() != 3:
        raise ValueError(f"additive attention: enc_proj [B, T, D] and "
                         f"enc_seq [B, T, Dv] expected, got "
                         f"{tuple(enc_proj.shape)}, {tuple(enc_seq.shape)}")
    B, T, D = enc_proj.shape
    Dv = enc_seq.shape[2]
    want = {"u": (B, D), "v": (D,), "enc_seq": (B, T, Dv), "lengths": (B,)}
    got = {"u": u, "v": v, "enc_seq": enc_seq, "lengths": lengths}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"additive attention: {name} {shape} expected "
                             f"for enc_proj {tuple(enc_proj.shape)}, got "
                             f"{tuple(got[name].shape)}")
    return B, T, D, Dv


def additive_attention_plain(u: torch.Tensor, v: torch.Tensor,
                             enc_proj: torch.Tensor, enc_seq: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: scores, softmax and context
    in float32 over the keys t < lengths (a row without one gets 0), the
    context in enc_seq's dtype."""
    counts.plain += 1
    B, T, D, Dv = _check(u, v, enc_proj, enc_seq, lengths)
    s = torch.einsum("btd,d->bt",
                     torch.tanh(enc_proj.float() + u.float()[:, None, :]),
                     v.float())
    valid = torch.arange(T, device=s.device)[None, :] < lengths[:, None]
    s = torch.where(valid, s, _NEG_INF)
    p = torch.softmax(s, dim=-1) * valid
    return torch.einsum("bt,btd->bd", p, enc_seq.float()).to(enc_seq.dtype)


def additive_attention_kernel(u: torch.Tensor, v: torch.Tensor,
                              enc_proj: torch.Tensor, enc_seq: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors: u [B, D] and v [D] float32,
    enc_proj and enc_seq float32 or bfloat16 (the same), lengths int32."""
    return _launch(u, v, enc_proj, enc_seq, lengths)


def _launch(u, v, enc_proj, enc_seq, lengths,
            ctas: Optional[int] = None) -> torch.Tensor:
    """The launch behind `additive_attention_kernel`.  `ctas` pins the CTAs
    of a row's cluster (the measurements and card tests call it so; the
    wrapper takes `additive_plan`'s)."""
    B, T, D, Dv = _check(u, v, enc_proj, enc_seq, lengths)
    if enc_proj.device.type != "cuda":
        raise ValueError(f"additive attention: no kernel for device "
                         f"{enc_proj.device}")
    if enc_seq.dtype not in _DTYPE_CODES or enc_proj.dtype != enc_seq.dtype:
        raise TypeError(f"additive attention: the kernel takes float32 or "
                        f"bfloat16 enc_proj and enc_seq of one dtype, got "
                        f"{enc_proj.dtype} and {enc_seq.dtype}")
    if D > MAX_D or Dv > MAX_DV:
        raise ValueError(f"additive attention: the kernel takes D <= {MAX_D} "
                         f"and Dv <= {MAX_DV}, got {D} and {Dv}")
    for name, t, want in (("u", u, torch.float32), ("v", v, torch.float32),
                          ("lengths", lengths, torch.int32)):
        if t.dtype != want:
            raise TypeError(f"additive attention: {name} must be {want}, got "
                            f"{t.dtype}")
    for name, t in (("u", u), ("v", v), ("enc_proj", enc_proj),
                    ("enc_seq", enc_seq), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"additive attention: {name} must be contiguous")
    if ctas is None:
        ctas = additive_plan(B, Dv, _sm_count(enc_seq.device))
    out = torch.empty(B, Dv, dtype=enc_seq.dtype, device=enc_seq.device)
    lib = kernel.library().lib
    with torch.cuda.device(enc_seq.device):
        rc = lib.additive_attention_launch(
            u.data_ptr(), v.data_ptr(), enc_proj.data_ptr(),
            enc_seq.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, T, D,
            Dv, _DTYPE_CODES[enc_seq.dtype], ctas,
            torch.cuda.current_stream(enc_seq.device).cuda_stream)
    if rc != 0:
        msg = lib.additive_attention_error_string(rc).decode()
        raise RuntimeError(f"additive attention kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    counts.kernel += 1
    return out


def _dense(dec_state, w, v, enc_proj, enc_seq, lengths):
    """The dense formula over the length-prefix mask (`_reference`)."""
    T = enc_proj.shape[1]
    mask = torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]
    return additive_attention_step(dec_state, w, v, enc_proj, enc_seq, mask)


class _AdditiveAttention(torch.autograd.Function):
    """The `jax.custom_vjp` `_fused`: the forward through the kernel (its
    plain version on the CPU), the backward through autograd of the dense
    formula (`_vjp_bwd`)."""

    @staticmethod
    def forward(ctx, dec_state, w, v, enc_proj, enc_seq, lengths):
        u = torch.matmul(dec_state.float(), w.float())
        if enc_seq.device.type == "cpu":
            out = additive_attention_plain(u, v, enc_proj, enc_seq, lengths)
        else:
            out = additive_attention_kernel(
                u, v.float().contiguous(), enc_proj.contiguous(),
                enc_seq.contiguous(), lengths.to(torch.int32).contiguous())
        ctx.save_for_backward(dec_state, w, v, enc_proj, enc_seq, lengths)
        return out

    @staticmethod
    def backward(ctx, g):
        counts.recompute += 1
        saved = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(True) for t in saved[:5]]
        with torch.enable_grad():
            out = _dense(*leaves, saved[5])
        grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None)


def additive_attention(dec_state: torch.Tensor, w: torch.Tensor,
                       v: torch.Tensor, enc_proj: torch.Tensor,
                       enc_seq: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """The additive-attention step through the kernel
    (pallas_additive.additive_attention_step with `lengths`): dec_state
    [B, Ds], w [Ds, D], v [D], enc_proj [B, T, D], enc_seq [B, T, Dv],
    lengths [B] -> context [B, Dv] in enc_seq's dtype, differentiable in
    the first five."""
    return _AdditiveAttention.apply(dec_state, w, v, enc_proj, enc_seq,
                                    lengths)
