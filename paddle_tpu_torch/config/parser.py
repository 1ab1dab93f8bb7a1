"""Config parser: run a user config file and return its TrainerConfig — the
port's copy of paddle_tpu/config/parser.py.

(ref: python/paddle/trainer/config_parser.py:3349 parse_config /
parse_config_and_serialize: executes the user config inside a managed
namespace and returns the assembled config.)

Config files, their data providers and their helper modules are written
for the JAX package: `from paddle_tpu.dsl import *`, `from
paddle_tpu.data.provider import provider`.  While the port runs one
(`parse_config`, and `trainer.load_provider` importing a provider),
`bound_config_names()` binds those names to the port's own modules, so
the port never imports the JAX package and what the config builds is the
port's.  Afterwards `sys.modules` is as it was.
"""

from __future__ import annotations

import contextlib
import os
import runpy
import site
import sys
import sysconfig
import types
from typing import Iterator

# the bound subpackages are imported here, before any binding snapshots
# `sys.modules`: imported within one, they would be dropped on its exit
# and a later import would make second copies of their classes
import paddle_tpu_torch.data  # noqa: F401
import paddle_tpu_torch.dsl  # noqa: F401
from paddle_tpu_torch.config.schema import TrainerConfig
from paddle_tpu_torch.dsl.base import config_context

# the JAX package's name, and its subpackages a config or a provider may
# import, each bound to the port's package of the same name
JAX_PACKAGE = "paddle_tpu"
BOUND_SUBPACKAGES = ("config", "data", "dsl")


def _is_jax_package(name: object) -> bool:
    return isinstance(name, str) and (
        name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + "."))


def _installed_dirs() -> tuple[str, ...]:
    """The interpreter's library directories, the standard library and
    the installed packages, as given and resolved (a module's `__file__`
    is compared as it stands: resolving it on every parse costs seconds
    on a slow file system)."""
    paths = sysconfig.get_paths()
    dirs = {paths[k] for k in ("stdlib", "platstdlib", "purelib", "platlib")
            if k in paths}
    dirs.update(site.getsitepackages())
    dirs.update([os.path.realpath(d) for d in dirs])
    return tuple(os.path.join(d, "") for d in dirs)


_INSTALLED = _installed_dirs()


def _holds_jax_package(mod: object) -> bool:
    """Whether a module's globals hold a module, class, function or object
    of the JAX package: a config helper or provider module imported while
    the JAX package's names were its own (a JAX parse earlier in the
    process), which a port parse must import afresh.  Installed libraries
    and the standard library are not looked at: they import neither
    package."""
    names = getattr(mod, "__dict__", None)
    path = getattr(mod, "__file__", None)
    if (not isinstance(names, dict) or not isinstance(path, str)
            or mod is sys.modules.get("__main__")
            or path.startswith(_INSTALLED)):
        return False
    for v in list(names.values()):
        if isinstance(v, types.ModuleType):
            owner = v.__name__
        elif isinstance(v, type) or isinstance(v, types.FunctionType):
            owner = v.__module__
        else:
            owner = type(v).__module__
        if _is_jax_package(owner):
            return True
    return False


def _port_bindings() -> dict[str, types.ModuleType]:
    """{JAX-package module name: the port's module} for the bound
    subpackages, and a stand-in for the package itself that holds only
    them (an empty `__path__`: any other `paddle_tpu.*` import fails
    instead of reaching the JAX package)."""
    top = types.ModuleType(JAX_PACKAGE, "The port's modules under the JAX "
                           "package's names, while a config runs.")
    top.__path__ = []
    out = {JAX_PACKAGE: top}
    for sub in BOUND_SUBPACKAGES:
        prefix = f"paddle_tpu_torch.{sub}"
        for name, mod in list(sys.modules.items()):
            if name == prefix or name.startswith(prefix + "."):
                out[JAX_PACKAGE + name[len("paddle_tpu_torch"):]] = mod
        setattr(top, sub, sys.modules[prefix])
    return out


@contextlib.contextmanager
def bound_config_names() -> Iterator[None]:
    """Within: `paddle_tpu`, `paddle_tpu.{config,data,dsl}[.*]` name the
    port's modules, and a module bound to the JAX package's (one whose
    globals hold its objects) is out of `sys.modules`, so a config or
    provider importing it gets it afresh, under the port's names.  On
    exit every entry of `sys.modules` and every package attribute an
    import set is restored: the modules imported within are dropped."""
    saved = dict(sys.modules)
    stale = [n for n, m in saved.items()
             if _is_jax_package(n) or _holds_jax_package(m)]
    for name in stale:
        del sys.modules[name]
    sys.modules.update(_port_bindings())
    try:
        yield
    finally:
        changed = {n: m for n, m in list(sys.modules.items())
                   if saved.get(n) is not m}
        for name in changed:
            del sys.modules[name]
        sys.modules.update({n: m for n, m in saved.items()
                            if n not in sys.modules})
        for name, mod in changed.items():
            parent, _, child = name.rpartition(".")
            holder = sys.modules.get(parent)
            if holder is None or getattr(holder, child, None) is not mod:
                continue
            if name in saved:
                setattr(holder, child, saved[name])
            else:
                delattr(holder, child)


def parse_config_args(config_args: str) -> dict[str, str]:
    """'a=1,b=2' -> {'a': '1', 'b': '2'} (ref: config_parser.py:3362-3366)."""
    out: dict[str, str] = {}
    if not config_args:
        return out
    for pair in config_args.split(","):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        out[k.strip()] = v.strip()
    return out


def parse_config(config_file: str, config_args: str = "") -> TrainerConfig:
    """Execute `config_file` and collect the model/optimization/data configs.

    The config reads `get_config_arg(name, type, default)` for --config_args
    passthrough, exactly like the reference.
    """
    args = parse_config_args(config_args)

    def get_config_arg(name: str, type_=str, default=None):
        if name in args:
            if type_ is bool:
                return args[name].lower() in ("1", "true", "yes")
            return type_(args[name])
        return default

    with bound_config_names(), config_context() as ctx:
        runpy.run_path(config_file,
                       init_globals={"get_config_arg": get_config_arg})
        return ctx.to_trainer_config()


def parse_config_and_serialize(config_file: str, config_args: str = "") -> str:
    """(ref: config_parser.py parse_config_and_serialize) — JSON instead of
    binary proto."""
    return parse_config(config_file, config_args).to_json()


def parse_config_callable(fn, *fn_args, **fn_kwargs) -> TrainerConfig:
    """Build a config by calling a Python function instead of a file."""
    with bound_config_names(), config_context() as ctx:
        fn(*fn_args, **fn_kwargs)
        return ctx.to_trainer_config()
