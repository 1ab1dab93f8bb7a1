"""The demo config files the model builders parse: demo/ beside the
package, run by the port's own parser (config/parser.py)."""

from __future__ import annotations

import os

from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.config.schema import TrainerConfig

DEMO_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "demo")


def demo_path(rel: str) -> str:
    """The path of a file under demo/."""
    return os.path.join(DEMO_DIR, rel)


def config_args(**args) -> str:
    """--config_args text of keyword values (booleans as 1 / 0)."""
    return ",".join(f"{k}={int(v) if isinstance(v, bool) else v}"
                    for k, v in args.items())


def parse_demo(rel: str, **args) -> TrainerConfig:
    """parse_config of demo/<rel> with these config args."""
    return parse_config(demo_path(rel), config_args(**args))
