"""Default-filling decorators for user-defined DSL extensions (ref:
python/paddle/trainer_config_helpers/default_decorators.py:30-131).

User configs in the wild decorate their own composite-layer helpers with
these to inherit the framework's defaulting behavior: a missing/None
kwarg is filled from a factory before the call.  This rewrite keeps
the public API; name generation routes through the config context's
unique_name so decorator-produced names can never collide with layer
auto-names.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence


def wrap_param_default(param_names: Sequence[str],
                       default_factory: Callable,
                       not_set_callback=None):
    """Fill each named kwarg with default_factory(func) when unset/None."""
    assert param_names and all(isinstance(n, str) for n in param_names)
    if not_set_callback is None:
        def not_set_callback(kwargs, name):
            return name not in kwargs or kwargs[name] is None

    def deco(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            for name in param_names:
                if not_set_callback(kwargs, name):
                    kwargs[name] = default_factory(func)
            return func(*args, **kwargs)

        return wrapper

    return deco


def wrap_name_default(name_prefix: Optional[str] = None):
    """Fill `name=None` with a unique generated name (prefix defaults to
    the wrapped function's own name)."""
    def factory(func):
        from paddle_tpu_torch.dsl.base import current_context
        return current_context().unique_name(name_prefix or func.__name__)

    return wrap_param_default(["name"], factory)


def wrap_param_attr_default(param_names: Optional[Sequence[str]] = None,
                            default_factory: Optional[Callable] = None):
    from paddle_tpu_torch.dsl.attrs import ParameterAttribute
    factory = default_factory or (lambda func: ParameterAttribute())
    return wrap_param_default(list(param_names or ["param_attr"]), factory)


def wrap_bias_attr_default(param_names: Optional[Sequence[str]] = None,
                           default_factory: Optional[Callable] = None,
                           has_bias: bool = True):
    from paddle_tpu_torch.dsl.attrs import ParameterAttribute

    def factory(func):
        if default_factory is not None:
            return default_factory(func)
        return ParameterAttribute() if has_bias else False

    return wrap_param_default(list(param_names or ["bias_attr"]), factory)


def wrap_act_default(param_names: Optional[Sequence[str]] = None,
                     act=None):
    if act is None:
        from paddle_tpu_torch.dsl.activations import TanhActivation
        act = TanhActivation()
    return wrap_param_default(list(param_names or ["act"]), lambda f: act)
