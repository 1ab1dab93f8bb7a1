"""Data source declaration (ref: trainer_config_helpers/data_sources.py
define_py_data_sources2:173)."""

from __future__ import annotations

from typing import Any, Optional

from paddle_tpu_torch.config.schema import DataConfig
from paddle_tpu_torch.dsl.base import current_context

__all__ = ["define_py_data_sources2", "define_multi_py_data_sources2",
           "define_ptsh_data_sources"]


def define_py_data_sources2(
    train_list: Optional[str],
    test_list: Optional[str],
    module: str,
    obj: str,
    args: Any = None,
    constant_slots: Optional[list] = None,
) -> None:
    """Declare train/test providers backed by @provider functions
    (ref: data_sources.py:173; PyDataProvider2).  `constant_slots` appends
    fixed-value [B, 1] slots after the provider's slots (ref:
    config_parser.py:888; DataProvider.cpp:177-195)."""
    ctx = current_context()
    import json
    args_str = json.dumps(args) if args is not None else ""
    const = [float(v) for v in (constant_slots or [])]
    if train_list is not None:
        ctx.data = DataConfig(type="py2", files=train_list, load_data_module=module,
                              load_data_object=obj, load_data_args=args_str,
                              constant_slots=const)
    if test_list is not None:
        ctx.test_data = DataConfig(type="py2", files=test_list, load_data_module=module,
                                   load_data_object=obj, load_data_args=args_str,
                                   constant_slots=const)


def define_multi_py_data_sources2(
    train_sources: Optional[list] = None,
    test_sources: Optional[list] = None,
    ratios: Optional[list] = None,
) -> None:
    """Declare a multi-source provider that mixes several @provider streams
    by data ratio into one training stream (ref:
    gserver/dataproviders/MultiDataProvider.{h,cpp}).

    Each source is a dict: {"files": ..., "module": ..., "obj": ...,
    "args": optional}; all sources must share one slot schema.  `ratios`
    weights how many samples each source contributes per mixing round
    (default: equal).  Test sources are concatenated, not mixed.
    """
    import json as _json

    ctx = current_context()

    def _sub(src) -> DataConfig:
        return DataConfig(
            type="py2", files=src["files"], load_data_module=src["module"],
            load_data_object=src["obj"],
            load_data_args=(_json.dumps(src["args"]) if src.get("args")
                            is not None else ""))

    if train_sources:
        ctx.data = DataConfig(type="multi",
                              sub_configs=[_sub(s) for s in train_sources],
                              data_ratios=list(ratios or []))
    if test_sources:
        ctx.test_data = DataConfig(type="multi",
                                   sub_configs=[_sub(s) for s in test_sources])


def define_ptsh_data_sources(
    train: Optional[str],
    test: Optional[str] = None,
    names: Optional[list] = None,
) -> None:
    """Declare train/test sources backed by PTSH binary shards read by the
    native C++ loader (the JAX package's paddle_tpu/io/; not ported yet:
    the port's Trainer refuses this source, ROADMAP.md).  `train`/`test` are a shard dir,
    glob, or file-list; `names` maps shard slots to data-layer names (defaults
    to the model's data layers in declaration order)."""
    ctx = current_context()
    import json
    args_str = json.dumps({"names": names}) if names else ""
    if train is not None:
        ctx.data = DataConfig(type="ptsh", files=train, load_data_args=args_str)
    if test is not None:
        ctx.test_data = DataConfig(type="ptsh", files=test, load_data_args=args_str)
