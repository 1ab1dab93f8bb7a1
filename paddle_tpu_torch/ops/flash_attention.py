"""Flash attention: the hand-written CUDA kernels' wrappers, their plain
PyTorch versions, the autograd function over them, and their call counts.

Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_attention.py
(`_fwd_kernel`, `_bwd_dq_kernel`, `_bwd_dkv_kernel`, tied together by the
`jax.custom_vjp` `_flash`).  `flash_attention` has the JAX function's
signature and masking: q [B, Tq, H, D], k/v [B, Tk, H_kv, D] (grouped-query
heads resolved in the kernel, K/V never expanded), per-batch key validity,
causal and sliding-window masks on global positions `q_offset + i` /
`k_offset + j`; a fully masked row gives o = 0 and lse = -inf.  Query-row
validity is applied outside the kernels (o *= q_valid, lse = -inf there),
so the zeroed cotangent kills the invalid rows' gradients, as in JAX.

For CUDA tensors the forward and both backward passes launch a kernel (or
raise), chosen by dtype; both routes run on the tensor cores.  bfloat16
goes to the kernels of csrc/flash_attention_tc.cu (bf16 products with
float32 sums, as the TPU kernels at the MXU's default precision: dS and the
backward's p rounded to bf16 where they enter a product, the forward's p as
two bf16 terms), float32 to the kernels of csrc/flash_attention.cu (every
product three TF32 passes on a hi/lo split of each operand, ~22
significant bits with float32 sums: the card's counterpart of the TPU
kernels' Precision.HIGHEST for float32).  For CPU
tensors they run the plain versions `flash_attention_plain` /
`flash_attention_bwd_plain`, the same arithmetic in float32 on a dense
[B, H, Tq, Tk] score matrix.  There is no fallback from one to another.
The backward's `delta = rowsum(do * o) - dlse` (non-finite values set to
0) is computed here between the two launches, as JAX computes it in jnp
outside its kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from paddle_tpu_torch.ops import cuda_build

_NEG_INF = -1e30
MAX_HEAD_DIM = 128      # head dims the kernels take (instances for 64, 128)


class CallCounts:
    """How often each version ran: `fwd`, `bwd_dq` and `bwd_dkv` count CUDA
    launches of the float32 kernels, `fwd_tc`, `bwd_dq_tc` and
    `bwd_dkv_tc` those of the bfloat16 tensor-core kernels, `plain` counts
    calls of the plain PyTorch versions (forward or backward)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.fwd = self.bwd_dq = self.bwd_dkv = 0
        self.fwd_tc = self.bwd_dq_tc = self.bwd_dkv_tc = 0
        self.plain = 0

    def launched(self, kernel: "_Kernel", name: str) -> None:
        name += kernel.count_suffix
        setattr(self, name, getattr(self, name) + 1)


counts = CallCounts()


class _Kernel:
    """One kernel library (forward, dQ, dK/dV behind one C interface) and
    its C entry points, built on first launch."""

    def __init__(self, source: str, count_suffix: str):
        self.source = source              # csrc/<source>.cu
        self.count_suffix = count_suffix  # its launches' CallCounts names
        self.built: Optional[cuda_build.KernelLibrary] = None

    def library(self) -> cuda_build.KernelLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            lib = built.lib
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            shape = [i] * 6 + [f] + [i] * 4 + [p]   # B..D, scale, mask, stream
            lib.flash_fwd_launch.argtypes = [p] * 6 + shape
            lib.flash_bwd_dq_launch.argtypes = [p] * 8 + shape
            lib.flash_bwd_dkv_launch.argtypes = [p] * 9 + shape
            for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch,
                       lib.flash_bwd_dkv_launch):
                fn.restype = i
            lib.flash_error_string.argtypes = [i]
            lib.flash_error_string.restype = ctypes.c_char_p
            lib.flash_kernel_attributes.argtypes = [i, i,
                                                    ctypes.POINTER(i)]
            lib.flash_kernel_attributes.restype = i
            self.built = built
        return self.built

    def attributes(self) -> dict:
        """{(kernel, dm): (registers, local bytes per thread, dynamic shared
        bytes)} of the library's six instances, as the CUDA runtime reports
        them (also when the library was built by an earlier run)."""
        lib = self.library().lib
        out = {}
        for which, name in enumerate(("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")):
            for dm in (64, 128):
                vals = (ctypes.c_int * 3)()
                rc = lib.flash_kernel_attributes(which, dm, vals)
                if rc:
                    raise RuntimeError(f"cudaFuncGetAttributes({name}"
                                       f"{self.count_suffix}<{dm}>) failed: "
                                       f"CUDA error {rc}")
                out[(f"{name}{self.count_suffix}_kernel", dm)] = tuple(vals)
        return out


kernel = _Kernel("flash_attention", "")           # float32, 3xTF32
kernel_tc = _Kernel("flash_attention_tc", "_tc")  # bfloat16
_KERNELS = {torch.float32: kernel, torch.bfloat16: kernel_tc}


# -- the plain versions -------------------------------------------------------

def _score_mask(kv_mask, Tq: int, causal: bool, q_offset: int, k_offset: int,
                window: Optional[int]) -> torch.Tensor:
    """[B, 1, Tq, Tk] validity: key validity x causality x window, on global
    positions (pallas_attention._tile_mask)."""
    dev = kv_mask.device
    mask = kv_mask.bool()[:, None, None, :]
    if causal or window is not None:
        qpos = q_offset + torch.arange(Tq, device=dev)[:, None]
        kpos = k_offset + torch.arange(kv_mask.shape[1], device=dev)[None, :]
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & ((qpos - kpos).abs() < window)
    return mask


def _expand(x: torch.Tensor, H: int) -> torch.Tensor:
    """[B, Tk, H_kv, D] -> [B, H, Tk, D] float32, each kv head repeated over
    its query-head group."""
    x = x.float().permute(0, 2, 1, 3)
    rep = H // x.shape[1]
    return x.repeat_interleave(rep, dim=1) if rep > 1 else x


def _plain_probs(q, k, kv_mask, causal, scale, q_offset, k_offset, window,
                 lse=None):
    """Masked scores [B, H, Tq, Tk] in float32, the mask, and p: the softmax
    (forward) or exp(s - lse) recomputed from a given lse (backward)."""
    H = q.shape[2]
    qh = q.float().permute(0, 2, 1, 3)
    s = torch.matmul(qh, _expand(k, H).transpose(-1, -2)) * scale
    mask = _score_mask(kv_mask, q.shape[1], causal, q_offset, k_offset,
                       window)
    s = torch.where(mask, s, _NEG_INF)
    if lse is None:
        return s, mask, None
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=s.device))
    return s, mask, p


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_mask: torch.Tensor, causal: bool = False,
                          scale: Optional[float] = None, q_offset: int = 0,
                          k_offset: int = 0, window: Optional[int] = None):
    """The forward kernel's function in plain PyTorch: (o [B, Tq, H, D] in
    q's dtype, lse [B, H, Tq] float32), scores and softmax in float32; rows
    without a valid key give o = 0, lse = -inf."""
    counts.plain += 1
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s, mask, _ = _plain_probs(q, k, kv_mask, causal, scale, q_offset,
                              k_offset, window)
    live = mask.any(dim=-1)                                    # [B, H|1, Tq]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), torch.zeros((), device=s.device))
    l = e.sum(dim=-1)
    p = e / l.clamp_min(1e-30)[..., None]
    o = torch.matmul(p, _expand(v, q.shape[2]))                # [B, H, Tq, D]
    o = torch.where(live[..., None], o, torch.zeros((), device=o.device))
    lse = torch.where(live, m[..., 0] + torch.log(l.clamp_min(1e-30)),
                      float("-inf"))
    lse = lse.expand(q.shape[0], q.shape[2], q.shape[1])
    return o.permute(0, 2, 1, 3).to(q.dtype), lse.contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_mask: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor,
                              do: torch.Tensor,
                              dlse: Optional[torch.Tensor] = None,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              q_offset: int = 0, k_offset: int = 0,
                              window: Optional[int] = None):
    """The backward kernels' function in plain PyTorch (the arithmetic of
    pallas_attention._bwd_call): recompute p = exp(s - lse), fold the lse
    cotangent into delta, and return (dq, dk, dv) in the dtypes of q, k, v;
    dk/dv sum over each kv head's query-head group."""
    counts.plain += 1
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, Tq, H, D = q.shape
    h_kv = k.shape[2]
    delta = backward_delta(o, do, dlse)
    _, _, p = _plain_probs(q, k, kv_mask, causal, scale, q_offset, k_offset,
                           window, lse=lse)
    doh = do.float().permute(0, 2, 1, 3)                       # [B, H, Tq, D]
    dv = torch.matmul(p.transpose(-1, -2), doh)                # [B, H, Tk, D]
    dp = torch.matmul(doh, _expand(v, H).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds, _expand(k, H))
    dk = torch.matmul(ds.transpose(-1, -2), q.float().permute(0, 2, 1, 3))

    def to_kv(g, like):                        # sum the group, [B, Tk, Hkv, D]
        g = g.reshape(B, h_kv, H // h_kv, *g.shape[2:]).sum(dim=2)
        return g.permute(0, 2, 1, 3).to(like.dtype)

    return (dq.permute(0, 2, 1, 3).to(q.dtype), to_kv(dk, k), to_kv(dv, v))


def backward_delta(o, do, dlse) -> torch.Tensor:
    """delta = rowsum(do * o) - dlse as [B, H, Tq] float32, non-finite
    entries set to 0 (pallas_attention._bwd_call)."""
    delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)
    if dlse is not None:
        delta = delta - dlse.float()
    return torch.where(torch.isfinite(delta), delta,
                       torch.zeros((), device=delta.device)).contiguous()


# -- the kernels --------------------------------------------------------------

def _check(q, k, v, kv_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B,Tq,H,D] and k/v "
                         f"[B,Tk,H_kv,D] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention: batch / head dim / head groups "
                         f"of q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         f"disagree")
    if kv_mask.shape != (B, k.shape[1]):
        raise ValueError(f"flash_attention: key mask [B, Tk] = "
                         f"{(B, k.shape[1])} expected, got "
                         f"{tuple(kv_mask.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not q.is_floating_point():
        raise TypeError(f"flash_attention: q/k/v must share one floating "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    devs = {t.device for t in (q, k, v, kv_mask)}
    if len(devs) != 1:
        raise ValueError(f"flash_attention: tensors on several devices "
                         f"{sorted(map(str, devs))}")


def _check_cuda(name: str, **tensors) -> "_Kernel":
    """What the kernels take beyond _check: CUDA, float32 or bfloat16,
    D <= 128, contiguous
    tensors.  Returns the kernel library of q's dtype."""
    q = tensors["q"]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dtype not in _KERNELS:
        raise TypeError(f"{name}: the kernel takes float32/bfloat16, got "
                        f"{q.dtype}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head dims <= "
                         f"{MAX_HEAD_DIM}, got {q.shape[3]}")
    for tname, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    return _KERNELS[q.dtype]


def _raise_if_failed(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.flash_error_string(rc).decode()
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"CUDA error {rc} ({msg})")


def _mask_args(causal, window, q_offset, k_offset):
    return (int(bool(causal)), -1 if window is None else int(window),
            int(q_offset), int(k_offset))


def _stream(t: torch.Tensor) -> int:
    # read at every launch: autograd runs the backward on its own thread
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q, k, v, kv_mask, causal=False, scale=None,
                        q_offset=0, k_offset=0, window=None):
    """(o, lse) through the forward kernel for CUDA tensors, through
    `flash_attention_plain` for CPU tensors.  kv_mask [B, Tk] (bool or
    uint8)."""
    _check(q, k, v, kv_mask)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, causal, scale,
                                     q_offset, k_offset, window)
    kvm = kv_mask.to(torch.uint8)
    kern = _check_cuda("flash_attention", q=q, k=k, v=v, kv_mask=kvm)
    B, Tq, H, D = q.shape
    Tk, h_kv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    lib = kern.library().lib
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kvm.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, Tq, Tk, H, h_kv, D,
            float(scale), *_mask_args(causal, window, q_offset, k_offset),
            _stream(q))
    _raise_if_failed(lib, rc, "forward")
    counts.launched(kern, "fwd")
    return o, lse


def flash_attention_bwd(q, k, v, kv_mask, o, lse, do, dlse=None,
                        causal=False, scale=None, q_offset=0, k_offset=0,
                        window=None):
    """(dq, dk, dv) through the two backward kernels for CUDA tensors,
    through `flash_attention_bwd_plain` for CPU tensors."""
    _check(q, k, v, kv_mask)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: do must match q "
                         f"{tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, dlse,
                                         causal, scale, q_offset, k_offset,
                                         window)
    do = do.contiguous()
    kvm = kv_mask.to(torch.uint8)
    delta = backward_delta(o, do, dlse)
    args = (q, k, v, kvm, do, lse, delta, causal, scale, q_offset, k_offset,
            window)
    dq = bwd_dq_kernel(*args)
    dk, dv = bwd_dkv_kernel(*args)
    return dq, dk, dv


def _bwd_launch_args(q, k, v, kvm, do, lse, delta, causal, scale, q_offset,
                     k_offset, window):
    kern = _check_cuda("flash_attention backward", q=q, k=k, v=v,
                       kv_mask=kvm, do=do, lse=lse, delta=delta)
    B, Tq, H, D = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (B, H, Tq):
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"float32 [B, H, Tq] = {(B, H, Tq)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return (kern,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), kvm.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr()),
            (B, Tq, k.shape[1], H, k.shape[2], D, float(scale),
             *_mask_args(causal, window, q_offset, k_offset)))


def bwd_dq_kernel(q, k, v, kvm, do, lse, delta, causal, scale, q_offset,
                  k_offset, window) -> torch.Tensor:
    """One launch of the dQ kernel of q's dtype on CUDA tensors (kvm uint8,
    delta from `backward_delta`): returns dq."""
    kern, head, shape = _bwd_launch_args(q, k, v, kvm, do, lse, delta,
                                         causal, scale, q_offset, k_offset,
                                         window)
    dq = torch.empty_like(q)
    lib = kern.library().lib
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq_launch(*head, dq.data_ptr(), *shape,
                                     _stream(q))
    _raise_if_failed(lib, rc, "backward dq")
    counts.launched(kern, "bwd_dq")
    return dq


def bwd_dkv_kernel(q, k, v, kvm, do, lse, delta, causal, scale, q_offset,
                   k_offset, window):
    """One launch of the dK/dV kernel of q's dtype on CUDA tensors: returns
    (dk, dv)."""
    kern, head, shape = _bwd_launch_args(q, k, v, kvm, do, lse, delta,
                                         causal, scale, q_offset, k_offset,
                                         window)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = kern.library().lib
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv_launch(*head, dk.data_ptr(), dv.data_ptr(),
                                      *shape, _stream(q))
    _raise_if_failed(lib, rc, "backward dk/dv")
    counts.launched(kern, "bwd_dkv")
    return dk, dv


class _Flash(torch.autograd.Function):
    """The `jax.custom_vjp` `_flash`: forward saves (q, k, v, mask, o, lse);
    the backward takes the o and lse cotangents."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, q_offset, k_offset,
                window):
        o, lse = flash_attention_fwd(q, k, v, kv_mask, causal, scale,
                                     q_offset, k_offset, window)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.args = (causal, scale, q_offset, k_offset, window)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, o, lse, do, dlse,
                                         *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_valid: Optional[torch.Tensor] = None,
                    k_valid: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None,
                    q_offset: Union[int, torch.Tensor] = 0,
                    k_offset: Union[int, torch.Tensor] = 0,
                    return_lse: bool = False, window: Optional[int] = None):
    """Drop-in for `dot_product_attention` (pallas_attention.flash_attention):
    q [B,Tq,H,D], k/v [B,Tk,H_kv,D] -> o [B,Tq,H,D]; with `return_lse` also
    the per-row log-sum-exp [B, H, Tq] (float32, -inf for fully masked or
    invalid rows).  Differentiable in q, k, v."""
    B, Tq, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    kv_mask = (torch.ones(B, k.shape[1], dtype=torch.uint8, device=k.device)
               if k_valid is None else k_valid.to(torch.uint8))
    o, lse = _Flash.apply(q, k, v, kv_mask, bool(causal), float(scale),
                          int(q_offset), int(k_offset),
                          None if window is None else int(window))
    if q_valid is not None:
        o = o * q_valid[:, :, None, None].to(o.dtype)
    if not return_lse:
        return o
    if q_valid is not None:
        lse = torch.where(q_valid[:, None, :].bool(), lse, float("-inf"))
    return o, lse
