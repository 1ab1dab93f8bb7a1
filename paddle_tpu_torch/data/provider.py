"""@provider decorator and input-type descriptors — the port's copy of
paddle_tpu/data/provider.py (a provider module written for the JAX
package imports these under its names: config/parser.py
bound_config_names).

Behavior-compatible analog of the reference's PyDataProvider2
(ref: python/paddle/trainer/PyDataProvider2.py: @provider:206, input types
:57-107 dense_vector/sparse_binary_vector/sparse_vector/integer_value ×
{scalar, sequence}; C++ host gserver/dataproviders/PyDataProvider2.cpp).

A provider is a generator function decorated with @provider(input_types=...);
it yields one sample per iteration, each sample a list/tuple aligned with
input_types.  The DataFeeder (feeder.py) pools samples, shuffles, buckets
sequences by length and emits padded batches — replacing the reference's
background loadThread + memory-pool machinery.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class SlotKind(enum.Enum):
    DENSE = 0
    SPARSE_BINARY = 1
    SPARSE_VALUE = 2
    INDEX = 3


class SeqType(enum.Enum):
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


@dataclass
class InputType:
    """(ref: PyDataProvider2.py InputType)."""

    dim: int
    kind: SlotKind
    seq_type: SeqType = SeqType.NO_SEQUENCE


def dense_vector(dim: int) -> InputType:
    return InputType(dim, SlotKind.DENSE)


def sparse_binary_vector(dim: int) -> InputType:
    return InputType(dim, SlotKind.SPARSE_BINARY)


def sparse_vector(dim: int) -> InputType:
    return InputType(dim, SlotKind.SPARSE_VALUE)


def integer_value(value_range: int) -> InputType:
    return InputType(value_range, SlotKind.INDEX)


def dense_vector_sequence(dim: int) -> InputType:
    return InputType(dim, SlotKind.DENSE, SeqType.SEQUENCE)


def sparse_binary_vector_sequence(dim: int) -> InputType:
    return InputType(dim, SlotKind.SPARSE_BINARY, SeqType.SEQUENCE)


def sparse_vector_sequence(dim: int) -> InputType:
    return InputType(dim, SlotKind.SPARSE_VALUE, SeqType.SEQUENCE)


def integer_value_sequence(value_range: int) -> InputType:
    return InputType(value_range, SlotKind.INDEX, SeqType.SEQUENCE)


def integer_value_sub_sequence(value_range: int) -> InputType:
    return InputType(value_range, SlotKind.INDEX, SeqType.SUB_SEQUENCE)


def dense_vector_sub_sequence(dim: int) -> InputType:
    return InputType(dim, SlotKind.DENSE, SeqType.SUB_SEQUENCE)


def sparse_binary_vector_sub_sequence(dim: int) -> InputType:
    return InputType(dim, SlotKind.SPARSE_BINARY, SeqType.SUB_SEQUENCE)


def sparse_vector_sub_sequence(dim: int) -> InputType:
    return InputType(dim, SlotKind.SPARSE_VALUE, SeqType.SUB_SEQUENCE)


class CacheType(enum.Enum):
    """(ref: PyDataProvider2.py CacheType)."""

    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


@dataclass
class ProviderSettings:
    """Passed as first argument to the wrapped generator
    (ref: PyDataProvider2 settings object)."""

    input_types: list[InputType] = field(default_factory=list)
    slots: Optional[dict[str, InputType]] = None   # name -> type when dict given
    should_shuffle: bool = True
    pool_size: int = -1
    cache: CacheType = CacheType.NO_CACHE
    calc_batch_size: Optional[Callable] = None
    args: Any = None
    # user extension point
    logger: Any = None


class DataProviderWrapper:
    """The object produced by @provider; callable like the original function
    but also carries the settings needed by DataFeeder."""

    def __init__(self, fn: Callable, settings: ProviderSettings, init_hook: Optional[Callable]):
        self.fn = fn
        self.settings = settings
        self.init_hook = init_hook
        self.__name__ = getattr(fn, "__name__", "provider")

    def initialize(self, file_list: list[str], **kwargs) -> None:
        if self.init_hook is not None:
            self.init_hook(self.settings, file_list=file_list, **kwargs)

    def samples(self, file_list: list[str]):
        """Iterate all samples of one pass."""
        for f in file_list:
            yield from self.fn(self.settings, f)

    @property
    def input_types(self) -> list[InputType]:
        st = self.settings
        if st.slots is not None:
            return list(st.slots.values())
        return list(st.input_types)

    @property
    def input_names(self) -> Optional[list[str]]:
        if self.settings.slots is not None:
            return list(self.settings.slots.keys())
        return None


class MultiProviderWrapper:
    """Mixes several sub-providers into one sample stream by data ratio
    (ref: gserver/dataproviders/MultiDataProvider.{h,cpp}: each batch draws
    size*ratio_i/total samples from sub-provider i; in test mode every
    sub-provider contributes all of its data).

    All sub-providers must declare the same slot schema.  Presents the
    DataProviderWrapper interface so DataFeeder needs no special casing.
    """

    def __init__(self, subs: list, sub_files: list[list[str]],
                 ratios: Optional[list[int]] = None, is_test: bool = False):
        assert subs, "MultiProviderWrapper needs at least one sub-provider"
        self.subs = subs
        self.sub_files = sub_files
        self.ratios = list(ratios) if ratios else [1] * len(subs)
        assert len(self.ratios) == len(subs)
        self.is_test = is_test
        self.settings = subs[0].settings
        t0 = [type(t).__name__ for t in subs[0].input_types]
        for s in subs[1:]:
            assert [type(t).__name__ for t in s.input_types] == t0, \
                "MultiDataProvider sub-providers must share one slot schema"

    def samples(self, file_list: list[str]):
        """Ratio-weighted round-robin over the sub-provider streams.  The
        TRAIN stream ends when the first sub-provider drains, so the pass's
        overall composition honors the ratios even after the feeder's
        global shuffle (the reference draws size*ratio_i/total per batch —
        same steady-state mixture).  Test mode ignores ratios and
        concatenates everything."""
        if self.is_test:
            for s, files in zip(self.subs, self.sub_files):
                yield from s.samples(files)
            return
        its = [iter(s.samples(files))
               for s, files in zip(self.subs, self.sub_files)]
        while True:
            for i, it in enumerate(its):
                for _ in range(self.ratios[i]):
                    try:
                        yield next(it)
                    except StopIteration:
                        return

    @property
    def input_types(self):
        return self.subs[0].input_types

    @property
    def input_names(self):
        return self.subs[0].input_names


def provider(input_types=None, should_shuffle: bool = True, pool_size: int = -1,
             cache: CacheType = CacheType.NO_CACHE, init_hook: Optional[Callable] = None,
             calc_batch_size: Optional[Callable] = None, **kwargs):
    """(ref: PyDataProvider2.py provider:206)."""

    def deco(fn):
        st = ProviderSettings(should_shuffle=should_shuffle, pool_size=pool_size,
                              cache=cache, calc_batch_size=calc_batch_size)
        if isinstance(input_types, dict):
            st.slots = dict(input_types)
        elif input_types is not None:
            st.input_types = list(input_types)
        return DataProviderWrapper(fn, st, init_hook)

    return deco
