"""Pooling descriptors (ref: trainer_config_helpers/poolings.py)."""

from __future__ import annotations

__all__ = ["BasePoolingType", "MaxPooling", "AvgPooling", "SumPooling",
           "SquareRootNPooling", "LastPooling", "FirstPooling",
           "MaxWithIdPooling", "CudnnMaxPooling", "CudnnAvgPooling"]


class BasePoolingType:
    name: str = ""


class MaxPooling(BasePoolingType):
    name = "max"


class MaxWithIdPooling(BasePoolingType):
    name = "max"


class AvgPooling(BasePoolingType):
    name = "average"
    strategy = "average"


class SumPooling(BasePoolingType):
    name = "average"
    strategy = "sum"


class SquareRootNPooling(BasePoolingType):
    name = "average"
    strategy = "squarerootn"


class LastPooling(BasePoolingType):
    name = "seqlastins"


class FirstPooling(BasePoolingType):
    name = "seqlastins"
    select_first = True


# cuDNN-dispatch aliases (ref: poolings.py CudnnMaxPooling/CudnnAvgPooling)
# — the CPU-vs-cuDNN dispatch distinction is not the config's to make; the
# math is identical, so these are pure aliases
CudnnMaxPooling = MaxPooling
CudnnAvgPooling = AvgPooling
