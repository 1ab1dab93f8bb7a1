"""Ragged paged attention: the hand-written CUDA kernel's wrapper, its
plain PyTorch version, and their call counts.

Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas_paged.py
(`_kernel`, launched by `paged_attention`).  Query row r attends the
pages `table[row_slot[r], p]` of its table row for token positions
t < lengths[r], with grouped-query heads resolved in the kernel (the pools
stay at H_kv heads) and pages past a row's length never read.  The serving
engine calls it once per attention layer on every decode and mixed step.

The kernel (csrc/paged_attention.cu) moves the bytes of the live pages,
but at the serving run's launches latency bounds it (dependent load
rounds, the cluster's wait for its slowest split, the merge; PERF.md).  It
splits each row's keys over a thread-block cluster of CTAs whose
partial softmax states merge on chip (`split_plan` picks the split count
from shapes alone, so the wrapper never reads row_slot or lengths on the
host; a row's result depends on that count, so the serving engine pins
one for all its launches), gives each CTA the query heads of one kv head
of one row, and
scores a block of staged keys with a lane per token, not a warp reduction
per token.

`paged_attention` launches the kernel for CUDA tensors and raises where it
cannot; for CPU tensors it runs `paged_attention_plain`, the same function
as a page-table gather plus a masked softmax.  There is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.ops import cuda_build

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128      # head dims the kernel takes
MAX_GROUP = 8           # query heads per kv head the kernel takes
MAX_SPLITS = 8          # CTAs of a cluster (the portable cluster size)
BLOCK_TOKENS = 32       # tokens the kernel stages at a time
SPLIT_TOKENS = 128      # the context positions a split aims to take at most


class CallCounts:
    """How often each version ran: `kernel` counts CUDA launches,
    `plain` counts calls of the plain PyTorch version."""

    def __init__(self):
        self.kernel = 0
        self.plain = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


counts = CallCounts()


class _Kernel:
    """The built library and its C entry points, made on first launch."""

    def __init__(self):
        self.built: Optional[cuda_build.KernelLibrary] = None

    def library(self) -> cuda_build.KernelLibrary:
        if self.built is None:
            built = cuda_build.build("paged_attention")
            fn = built.lib.paged_attention_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                           + [ctypes.c_int] * 6 + [ctypes.c_float]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            attrs = built.lib.paged_attention_attributes
            attrs.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            attrs.restype = ctypes.c_int
            built.lib.paged_attention_instances.restype = ctypes.c_int
            err = built.lib.paged_attention_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self.built = built
        return self.built


kernel = _Kernel()


def split_plan(rows: int, table_rows: int, maxp: int, page_size: int,
               splits: Optional[int] = None) -> tuple[int, int]:
    """(splits, tokens per split) of a launch of `rows` query rows over a
    page table of `table_rows` rows of `maxp` pages of `page_size` tokens.
    A decode launch (a row per table row at most) takes the fewest of 1, 2,
    4, 8 CTAs that give each at most SPLIT_TOKENS of the maxp * page_size
    positions; a launch with more rows (a mixed step, whose prompt chunk's
    rows already fill the grid of rows x kv heads x splits) divides that
    count by rows / table_rows, down to 1.  `splits` pins the count.
    A split's tokens round up to BLOCK_TOKENS.  Shapes alone decide, never
    a row's length."""
    ctx = maxp * page_size
    if splits is None:
        splits = 1
        while splits < MAX_SPLITS and splits * SPLIT_TOKENS < ctx:
            splits *= 2
        while splits > 1 and rows * splits > table_rows * MAX_SPLITS:
            splits //= 2
    if splits not in (1, 2, 4, 8):
        raise ValueError(f"paged_attention: splits must be 1, 2, 4 or 8, "
                         f"got {splits}")
    per = -(-ctx // splits)
    return splits, -(-per // BLOCK_TOKENS) * BLOCK_TOKENS


def kernel_attributes() -> list[dict]:
    """The runtime's account of every kernel instance (cudaFuncGetAttributes):
    registers, local memory bytes per thread, static and dynamic shared
    memory bytes, with the instance's query vectors (a kv head's query
    heads rounded up to a power of two), padded head dim and dtype."""
    lib = kernel.library().lib
    out = []
    for idx in range(lib.paged_attention_instances()):
        buf = (ctypes.c_int * 7)()
        rc = lib.paged_attention_attributes(idx, buf)
        if rc:
            raise RuntimeError(f"paged_attention_attributes({idx}) failed: "
                               f"CUDA error {rc}")
        out.append({"registers": buf[0], "local_bytes": buf[1],
                    "static_smem": buf[2], "dynamic_smem": buf[3],
                    "nq": buf[4], "head_dim_pad": buf[5],
                    "dtype": ("float32", "bfloat16")[buf[6]]})
    return out


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor,
                          scale: Optional[float] = None,
                          row_slot: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather each row's pages to a
    contiguous [R, maxp * page_size] view, mask t >= lengths[r], softmax
    and weighted sum in float32, result in q's dtype."""
    counts.plain += 1
    R, H, D = q.shape
    _, ps, h_kv, _ = k_pages.shape
    maxp = page_table.shape[1]
    if scale is None:
        scale = D ** -0.5
    if row_slot is None:
        row_slot = torch.arange(R, device=q.device)
    rows = page_table.long()[row_slot.long()]                    # [R, maxp]
    T_ctx = maxp * ps
    kc = k_pages[rows].reshape(R, T_ctx, h_kv, D).float()
    vc = v_pages[rows].reshape(R, T_ctx, h_kv, D).float()
    rep = H // h_kv
    if rep > 1:
        kc = kc.repeat_interleave(rep, dim=2)
        vc = vc.repeat_interleave(rep, dim=2)
    s = torch.einsum("rhd,rthd->rht", q.float(), kc) * scale
    valid = (torch.arange(T_ctx, device=q.device)[None, :]
             < lengths.long()[:, None])
    s = torch.where(valid[:, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("rht,rthd->rhd", p, vc).to(q.dtype)


def _check(q, k_pages, v_pages, page_table, lengths, row_slot) -> None:
    """Shapes, dtypes and devices; row_slot None means row r reads table
    row r."""
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: q [R,H,D] and pools "
                         f"[P,ps,H_kv,D] expected, got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    R, H, D = q.shape
    if k_pages.shape[3] != D or H % k_pages.shape[2]:
        raise ValueError(f"paged_attention: head dim / head groups of q "
                         f"{tuple(q.shape)} and pools "
                         f"{tuple(k_pages.shape)} disagree")
    index = {"page_table": page_table, "lengths": lengths}
    if row_slot is not None:
        index["row_slot"] = row_slot
    if page_table.dim() != 2 or lengths.shape != (R,) or \
            (row_slot is not None and row_slot.shape != (R,)):
        raise ValueError(f"paged_attention: table [S, maxp] and [R] "
                         f"lengths/row_slot expected, got "
                         f"{tuple(page_table.shape)}, {tuple(lengths.shape)},"
                         f" {None if row_slot is None else tuple(row_slot.shape)}")
    if row_slot is None and page_table.shape[0] < R:
        raise ValueError(f"paged_attention: {R} rows read their own table "
                         f"rows, but the table has {page_table.shape[0]}")
    for name, t in index.items():
        if t.dtype != torch.int32:
            raise TypeError(f"paged_attention: {name} must be int32, "
                            f"got {t.dtype}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"paged_attention: q {q.dtype} and pools "
                        f"{k_pages.dtype}/{v_pages.dtype} must share a dtype")
    devs = {t.device for t in (q, k_pages, v_pages, *index.values())}
    if len(devs) != 1:
        raise ValueError(f"paged_attention: tensors on several devices "
                         f"{sorted(map(str, devs))}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, scale: Optional[float] = None,
                    row_slot: Optional[torch.Tensor] = None,
                    splits: Optional[int] = None) -> torch.Tensor:
    """Ragged paged attention -> [R, H, D].

    q [R, H, D]; pools [P, page_size, H_kv, D] (float32 or bfloat16, the
    same dtype as q); page_table [S, max_pages] int32 (0 = unmapped, the
    trash page); lengths [R] int32 tokens row r attends (its own included);
    row_slot [R] int32 table row of each query row (None: row r reads
    table row r, one decode token per slot).  `splits` pins the kernel's
    split count (None: `split_plan`'s); a row's result depends on it, so
    the serving engine pins one count for all its launches (the plain
    version ignores it)."""
    if q.device.type == "cpu":
        _check(q, k_pages, v_pages, page_table, lengths, row_slot)
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     lengths, scale, row_slot)
    return _launch(q, k_pages, v_pages, page_table, lengths, scale, row_slot,
                   splits)


def _launch(q, k_pages, v_pages, page_table, lengths, scale=None,
            row_slot=None, splits: Optional[int] = None) -> torch.Tensor:
    """The kernel launch behind `paged_attention` on CUDA tensors, with
    `splits` as `paged_attention` takes it."""
    R, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    identity = row_slot is None
    _check(q, k_pages, v_pages, page_table, lengths, row_slot)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    P, ps, h_kv, _ = k_pages.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_attention: kernel takes float32/bfloat16, "
                        f"got {q.dtype}")
    if D > MAX_HEAD_DIM or H // h_kv > MAX_GROUP:
        raise ValueError(f"paged_attention: kernel takes head dim <= "
                         f"{MAX_HEAD_DIM} and <= {MAX_GROUP} query heads per "
                         f"kv head, got D={D}, H={H}, H_kv={h_kv}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths),
                    ("row_slot", row_slot)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    out = torch.empty_like(q)
    if R == 0:
        return out
    maxp = page_table.shape[1]
    n_split, spl = split_plan(R, page_table.shape[0], maxp, ps, splits)
    lib = kernel.library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            None if identity else row_slot.data_ptr(), out.data_ptr(), R, H,
            h_kv, D, ps, maxp,
            float(scale), n_split, spl, int(identity), stream)
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    counts.kernel += 1
    return out
