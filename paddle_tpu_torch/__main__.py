"""`python -m paddle_tpu_torch <command>` — the port's CLI entry point, the
counterpart of `python -m paddle_tpu` (paddle_tpu/__main__.py; ref:
paddle/scripts/submit_local.sh.in:109-134).

Ported: `train` (trainer_main.py), `dump_config` (tools/dump_config.py) and
`version`.  The JAX package's other commands (merge_model, make_diagram,
show_model, plotcurve, cluster_launch) exit 2 with a message naming
ROADMAP.md.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "train": ("paddle_tpu_torch.trainer_main",
              "train/test a config (paddle_trainer analog)"),
    "dump_config": ("paddle_tpu_torch.tools.dump_config",
                    "print a parsed config as JSON"),
}
# the JAX package's commands the port has not ported yet
NOT_PORTED = ("merge_model", "make_diagram", "show_model", "plotcurve",
              "cluster_launch")


def _version() -> str:
    """The port's version line: torch and CUDA, and the card's name."""
    import torch

    from paddle_tpu_torch import __version__
    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "no CUDA card")
    return (f"paddle_tpu_torch {__version__} on torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, {card}")


def usage() -> str:
    lines = ["usage: python -m paddle_tpu_torch <command> [args...]", "",
             "commands:"]
    for name, (_, desc) in COMMANDS.items():
        lines.append(f"  {name:<15} {desc}")
    lines += ["  version         print version", "  --help          this text"]
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("--help", "-h", "help"):
        print(usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        print(_version())
        return 0
    if cmd in NOT_PORTED:
        print(f"command {cmd!r} is not ported to paddle_tpu_torch yet "
              f"(ROADMAP.md)", file=sys.stderr)
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}\n\n{usage()}", file=sys.stderr)
        return 2
    mod = importlib.import_module(COMMANDS[cmd][0])
    return int(mod.main(rest) or 0)


if __name__ == "__main__":
    sys.exit(main())
