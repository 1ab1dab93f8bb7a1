"""Logging facade (ref: paddle/utils/Logging.{h,cpp} — glog-or-builtin clone);
the port's copy of paddle_tpu/utils/logger.py.

One process-wide logger, `paddle_tpu_torch`, with a glog-style format.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(levelname).1s %(asctime)s.%(msecs)03d %(name)s] %(message)s"
_DATEFMT = "%m%d %H:%M:%S"

ROOT = "paddle_tpu_torch"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    root = logging.getLogger(ROOT)
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    root.propagate = False
    _configured = True


def get_logger(name: str = ROOT) -> logging.Logger:
    _configure()
    if name != ROOT and not name.startswith(ROOT + "."):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
