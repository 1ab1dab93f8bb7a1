"""Parse a config file and dump the built TrainerConfig — the port's copy of
paddle_tpu/tools/dump_config.py (ref: python/paddle/utils/dump_config.py;
the canonical serialization here is JSON, the same as the JAX package's).

CLI: python -m paddle_tpu_torch dump_config CONFIG [CONFIG_ARGS]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config")
    p.add_argument("config_args", nargs="?", default="")
    p.add_argument("--model_only", action="store_true",
                   help="dump only the ModelConfig section")
    args = p.parse_args(argv)

    from paddle_tpu_torch.config.parser import parse_config
    cfg = parse_config(args.config, args.config_args)
    if args.model_only:
        print(cfg.model_config.to_json(indent=2))
    else:
        print(cfg.to_json(indent=2))


if __name__ == "__main__":
    main()
