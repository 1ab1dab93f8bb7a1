"""DataFeeder — samples -> padded batches; the port's copy of
paddle_tpu/data/feeder.py.

Replaces the reference's C++ DataProvider machinery (ref:
paddle/gserver/dataproviders/DataProvider.h DataBatch/DoubleBuffer:260,
PyDataProvider2.cpp loadThread_ + memory pool :360-467): pools samples,
shuffles, buckets sequences by length (so the trainer sees few distinct
padded shapes: few captured step graphs), pads to dense numpy arrays on
the host, and prefetches batches on a background thread (the
DoubleBuffer analog).  The order comes from `random.Random(seed)` and the
provider's own draws, so the batches equal the JAX package's feeder's
exactly: ids, lengths, padding, bucket lengths and order.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Iterator, Optional

import numpy as np

from paddle_tpu_torch.data.provider import DataProviderWrapper, InputType, SeqType, SlotKind
from paddle_tpu_torch.parameter.argument import Argument


def _bucket_len(n: int, bucket_sizes=(8, 16, 32, 48, 64, 96, 128, 192, 256, 384, 512)) -> int:
    for b in bucket_sizes:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def _check_sparse_ids(ids: np.ndarray, dim: int, name: str) -> None:
    """Out-of-range feature ids must fail at batch assembly — on device the
    gather would silently clamp to dim-1 and train on the wrong row."""
    hi = int(ids.max()) if ids.size else 0
    lo = int(ids.min()) if ids.size else 0
    if hi >= dim or lo < 0:
        raise ValueError(
            f"sparse slot {name!r}: feature id {hi if hi >= dim else lo} "
            f"out of range for dim={dim}")


def _sparse_row(row, binary: bool):
    """One sparse row -> (ids, vals): a list of column ids for binary slots,
    a list of (id, value) pairs for value slots (ref: PyDataProvider2.py
    sparse_binary_vector vs sparse_vector)."""
    if binary:
        ids = np.asarray(row, np.int32)
        return ids, np.ones(len(row), np.float32)
    ids = np.asarray([p[0] for p in row], np.int32)
    vals = np.asarray([p[1] for p in row], np.float32)
    return ids, vals


def make_batch(samples: list, types: list[InputType], names: list[str],
               pad_len: Optional[int] = None) -> dict[str, Argument]:
    """Assemble one padded batch: sample tuples -> {layer_name: Argument}."""
    B = len(samples)
    out: dict[str, Argument] = {}
    for slot, (name, t) in enumerate(zip(names, types)):
        # samples are tuples aligned with input_types, or dicts keyed by
        # slot name (ref: PyDataProvider2.cpp also accepts dict yields)
        vals = [s[name] if isinstance(s, dict) else s[slot] for s in samples]
        if t.seq_type == SeqType.NO_SEQUENCE:
            if t.kind == SlotKind.DENSE:
                arr = np.asarray(vals, np.float32).reshape(B, t.dim)
                out[name] = Argument(value=arr)
            elif t.kind == SlotKind.INDEX:
                out[name] = Argument(ids=np.asarray(vals, np.int32).reshape(B))
            else:
                # sparse row representation: padded [B, K] nonzero ids +
                # values (1/0 validity for binary slots) — memory ∝ nnz,
                # never ∝ dim (ref: SparseRowMatrix.h; PyDataProvider2
                # sparse_binary_vector / sparse_vector)
                binary = t.kind == SlotKind.SPARSE_BINARY
                K = _bucket_len(max((len(v) for v in vals), default=1) or 1)
                ids = np.zeros((B, K), np.int32)
                w = np.zeros((B, K), np.float32)
                for i, row in enumerate(vals):
                    rid, rv = _sparse_row(row, binary)
                    ids[i, :len(rid)] = rid
                    w[i, :len(rid)] = rv
                _check_sparse_ids(ids, t.dim, name)
                out[name] = Argument(ids=ids, sparse_vals=w, sparse_dim=t.dim)
        elif t.seq_type == SeqType.SUB_SEQUENCE:
            # nested sequence: sample = list of subsequences.  Packed as
            # [B, S, T(, dim)] + lengths [B] (#subsequences) + sub_lengths
            # [B, S] (tokens per subsequence)
            n_sub = np.asarray([len(v) for v in vals], np.int32)
            # bucket the subsequence axis too — exact per-batch maxima would
            # give the trainer a new step signature for every document shape
            S = _bucket_len(max(int(n_sub.max()) if n_sub.size else 1, 1),
                            bucket_sizes=(2, 4, 8, 16, 32, 64, 128))
            sub_l = np.zeros((B, S), np.int32)
            for i, subs in enumerate(vals):
                for j, ss in enumerate(subs):
                    sub_l[i, j] = len(ss)
            T = pad_len or _bucket_len(max(int(sub_l.max()), 1))
            if t.kind == SlotKind.INDEX:
                arr = np.zeros((B, S, T), np.int32)
                for i, subs in enumerate(vals):
                    for j, ss in enumerate(subs):
                        arr[i, j, :len(ss)] = np.asarray(ss, np.int32)
                out[name] = Argument(ids=arr, lengths=n_sub, sub_lengths=sub_l)
            elif t.kind == SlotKind.DENSE:
                arr = np.zeros((B, S, T, t.dim), np.float32)
                for i, subs in enumerate(vals):
                    for j, ss in enumerate(subs):
                        arr[i, j, :len(ss)] = np.asarray(ss, np.float32)
                out[name] = Argument(value=arr, lengths=n_sub, sub_lengths=sub_l)
            else:
                # sparse rows per timestep of each subsequence: [B, S, T, K]
                # ids + values — the same nnz-proportional representation as
                # the flat-sequence sparse slots, one nesting level deeper
                # (ref: PyDataProvider2.py sparse_*_sub_sequence)
                binary = t.kind == SlotKind.SPARSE_BINARY
                K = _bucket_len(max((len(row) for subs in vals
                                     for ss in subs for row in ss),
                                    default=1) or 1)
                ids = np.zeros((B, S, T, K), np.int32)
                w = np.zeros((B, S, T, K), np.float32)
                for i, subs in enumerate(vals):
                    for j, ss in enumerate(subs):
                        for k, row in enumerate(ss):
                            rid, rv = _sparse_row(row, binary)
                            ids[i, j, k, :len(rid)] = rid
                            w[i, j, k, :len(rid)] = rv
                _check_sparse_ids(ids, t.dim, name)
                out[name] = Argument(ids=ids, sparse_vals=w, sparse_dim=t.dim,
                                     lengths=n_sub, sub_lengths=sub_l)
        else:
            lengths = np.asarray([len(v) for v in vals], np.int32)
            T = pad_len or _bucket_len(int(lengths.max()) if B else 1)
            if t.kind == SlotKind.INDEX:
                arr = np.zeros((B, T), np.int32)
                for i, seq in enumerate(vals):
                    arr[i, :len(seq)] = np.asarray(seq, np.int32)
                out[name] = Argument(ids=arr, lengths=lengths)
            elif t.kind == SlotKind.DENSE:
                arr = np.zeros((B, T, t.dim), np.float32)
                for i, seq in enumerate(vals):
                    arr[i, :len(seq)] = np.asarray(seq, np.float32)
                out[name] = Argument(value=arr, lengths=lengths)
            else:
                # per-timestep sparse rows: [B, T, K] ids + values — same
                # nnz-proportional representation as the non-sequence slots
                # (ref: PyDataProvider2.py sparse_binary_vector_sequence /
                # sparse_vector_sequence)
                binary = t.kind == SlotKind.SPARSE_BINARY
                K = _bucket_len(max((len(row) for seq in vals for row in seq),
                                    default=1) or 1)
                ids = np.zeros((B, T, K), np.int32)
                w = np.zeros((B, T, K), np.float32)
                for i, seq in enumerate(vals):
                    for j, row in enumerate(seq):
                        rid, rv = _sparse_row(row, binary)
                        ids[i, j, :len(rid)] = rid
                        w[i, j, :len(rid)] = rv
                _check_sparse_ids(ids, t.dim, name)
                out[name] = Argument(ids=ids, sparse_vals=w, sparse_dim=t.dim,
                                     lengths=lengths)
    return out


class DeviceDoubleBuffer:
    """Device-resident double buffering: a background thread runs
    `place_fn` on each item ONE AHEAD of the consumer, so the
    host-to-device staging of k-group i+1 overlaps the device computation
    of group i and the copies leave the dispatch's critical path (ref:
    gserver/dataproviders/DataProvider.h DoubleBuffer:260 — the reference
    overlapped batch ASSEMBLY; device staging is the analog one level
    further down).  The trainer's place_fn copies a group from pinned host
    memory on a side stream and records an event after the copies; the
    consumer makes its stream wait on that event before it reads them
    (trainer/trainer.py `_stage_group`).

    At most two staged items are alive ahead of the consumer: one in the
    queue, one being staged.  Exceptions from the producer or place_fn
    re-raise in the consumer.

    A consumer that stops iterating early (an exception mid-pass) must
    call `close()` — otherwise the producer thread would sit blocked on
    the bounded queue forever, pinning its staged device buffers; the
    trainer's fused loop closes in a finally block."""

    def __init__(self, items: Iterator, place_fn):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._end = object()
        self._stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up once close() was called; returns
            False when the buffer is shut down."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for item in items:
                    if self._stop.is_set():
                        return
                    if not put(place_fn(item)):
                        return
                put(self._end)
            except BaseException as e:   # propagate to the consumer
                put(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Release the producer thread and drop staged items (idempotent)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is self._end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.close()


class DataFeeder:
    """Batches a provider's samples for one or more passes."""

    def __init__(
        self,
        prov: DataProviderWrapper,
        file_list: list[str],
        input_names: list[str],
        batch_size: int,
        shuffle: Optional[bool] = None,
        seed: int = 1,
        drop_last: bool = True,
        bucket_by_length: bool = True,
        prefetch: int = 2,
        constant_slots: Optional[list] = None,
    ):
        self.prov = prov
        self.file_list = file_list
        names = prov.input_names
        self.names = names if names else input_names
        # constant slots fill the model input names AFTER the provider's
        # slots, each a [B, 1] fixed value (ref: DataProvider.cpp:177-195)
        self.constant_slots = list(constant_slots or [])
        if self.constant_slots:
            if names:          # dict-style provider: names are declared
                extra = [n for n in input_names if n not in names]
            else:              # list-style: provider fills the first slots
                extra = list(input_names[len(self.types):])
            assert len(extra) == len(self.constant_slots), (
                f"constant_slots has {len(self.constant_slots)} value(s) but "
                f"the model leaves {len(extra)} input(s) {extra} unfed by "
                f"the provider's {len(self.types)} slot(s)")
            self._const_names = extra
        else:
            self._const_names = []
        self.types = prov.input_types
        self.batch_size = batch_size
        self.shuffle = prov.settings.should_shuffle if shuffle is None else shuffle
        self.rng = random.Random(seed)
        self.drop_last = drop_last
        self.bucket_by_length = bucket_by_length and any(
            t.seq_type != SeqType.NO_SEQUENCE for t in self.types)
        self.prefetch = prefetch
        self._cache: Optional[list] = None
        self._use_cache = prov.settings.cache.name == "CACHE_PASS_IN_MEM"

    def _all_samples(self) -> list:
        if self._use_cache and self._cache is not None:
            return self._cache
        samples = list(self.prov.samples(self.file_list))
        if self._use_cache:
            self._cache = samples
        return samples

    def _sample_sort_key(self, s) -> int:
        for slot, t in enumerate(self.types):
            if t.seq_type != SeqType.NO_SEQUENCE:
                return len(s[self.names[slot]] if isinstance(s, dict)
                           else s[slot])
        return 0

    def batches(self) -> Iterator[dict[str, Argument]]:
        """One pass of padded batches (host numpy; the trainer moves them to
        the device)."""
        samples = self._all_samples()
        if self.shuffle:
            samples = list(samples)
            self.rng.shuffle(samples)
        if self.bucket_by_length:
            # length-sorted windows keep batches shape-homogeneous while
            # preserving shuffle at the window level (the reference sorts
            # by length inside SequenceToBatch; here it bounds padding waste)
            window = self.batch_size * 64
            chunks = [samples[i:i + window] for i in range(0, len(samples), window)]
            samples = []
            for ch in chunks:
                ch.sort(key=self._sample_sort_key)
                samples.extend(ch)
        bs = self.batch_size
        calc = self.prov.settings.calc_batch_size
        if calc is not None:
            # cost-weighted batching (ref: PyDataProvider2.py
            # calc_batch_size:265 — each sample contributes a custom batch
            # weight, e.g. its token count; a batch closes when the
            # accumulated weight reaches batch_size, and may exceed it
            # like the reference's can_over_batch_size mode)
            chunks, cur, acc = [], [], 0.0
            for s in samples:
                cur.append(s)
                acc += calc(s)     # raw weight — fractional costs accumulate
                if acc >= bs:
                    chunks.append(cur)
                    cur, acc = [], 0
            if cur and not self.drop_last:
                chunks.append(cur)
        else:
            chunks = [samples[i:i + bs] for i in range(0, len(samples), bs)]
            if chunks and len(chunks[-1]) < bs and self.drop_last:
                chunks.pop()
        if self.shuffle and self.bucket_by_length:
            self.rng.shuffle(chunks)
        for chunk in chunks:
            batch = make_batch(chunk, self.types, self.names)
            for name, val in zip(self._const_names, self.constant_slots):
                batch[name] = Argument(
                    value=np.full((len(chunk), 1), val, np.float32))
            yield batch

    def prefetched_batches(self) -> Iterator[dict[str, Argument]]:
        """Background-thread prefetch (ref: DataProvider.h DoubleBuffer)."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        END = object()

        def work():
            try:
                for b in self.batches():
                    q.put(b)
                q.put(END)
            except BaseException as e:  # propagate provider failures to consumer
                q.put(e)

        th = threading.Thread(target=work, daemon=True)
        th.start()
        while True:
            item = q.get()
            if item is END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
