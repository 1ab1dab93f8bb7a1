"""The port's trainer CLI — `python -m paddle_tpu_torch train --config=...`;
the port's copy of paddle_tpu/trainer_main.py.

(ref: paddle/trainer/TrainerMain.cpp:36-110: flag parsing, config load, job
dispatch.)  Jobs `train` and `test` run on the CUDA card; `--use_gpu=false`
asks for the CPU, and with `--use_gpu=true` and no CUDA the run fails
instead of moving to the CPU.  Exit codes as in the JAX package's CLI: 2
for a config that fails to parse, for `--job=test` on a config without a
test source, and for a usage error.  What the port has not ported yet is
refused with exit 2 and a message naming ROADMAP.md: `--job=time` and
`--job=checkgrad`, and the flags of `utils.flags.NOT_PORTED` set away from
their defaults (meshes and the multi-host bootstrap, --detect_nan,
--profile_dir, ...).  Arguments the flags do not know are refused too.

Every flag is reset to its default before a run and put back after it, so
a caller may run `main` several times in one process.
"""

from __future__ import annotations

import sys

from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.trainer.trainer import Trainer
from paddle_tpu_torch.utils import FLAGS, get_logger, parse_flags
from paddle_tpu_torch.utils.flags import NOT_PORTED

log = get_logger("main")

USAGE = ("usage: python -m paddle_tpu_torch train --config=<config.py> "
         "[--job=train|test] [--num_passes=N] [--save_dir=DIR] "
         "[--config_args=k=v,...] [--init_model_path=DIR] "
         "[--steps_per_dispatch=K] [--compute_dtype=bfloat16] "
         "[--use_gpu=false] [--seed=N] [--log_period=N]")


def main(argv=None) -> int:
    saved = FLAGS.as_dict()
    FLAGS.restore(FLAGS.defaults())
    try:
        return _run(argv)
    finally:
        FLAGS.restore(saved)


def _run(argv) -> int:
    rest = parse_flags(argv)
    if not FLAGS.config:
        print(USAGE, file=sys.stderr)
        return 2
    if rest:
        log.error("unknown argument(s) %s\n%s", rest, USAGE)
        return 2
    defaults = FLAGS.defaults()
    refused = [n for n in NOT_PORTED if getattr(FLAGS, n) != defaults[n]]
    if refused:
        log.error("%s: not ported to paddle_tpu_torch yet (ROADMAP.md)",
                  ", ".join(f"--{n}" for n in refused))
        return 2
    job = FLAGS.job
    if job in ("time", "checkgrad"):
        log.error("--job=%s is not ported to paddle_tpu_torch yet "
                  "(ROADMAP.md)", job)
        return 2
    if job not in ("train", "test"):
        log.error("unknown --job=%s", job)
        return 2

    try:
        config = parse_config(FLAGS.config, FLAGS.config_args)
    except Exception as e:   # noqa: BLE001 — configs run arbitrary user code
        # ANY failure while running the config file is a usage error (exit
        # 2), not a job failure (exit 1), as in the JAX package's CLI
        log.error("failed to parse config %s: %s: %s", FLAGS.config,
                  type(e).__name__, e, exc_info=True)
        return 2
    log.info("parsed config %s: %d layers, %d parameters", FLAGS.config,
             len(config.model_config.layers),
             len(config.model_config.parameters))
    if job == "test" and config.test_data_config is None:
        log.error("--job=test: this config declares no test data source — "
                  "add define_py_data_sources2(test_list=...) (ref: "
                  "TrainerMain.cpp)")
        return 2

    trainer = Trainer(config, seed=FLAGS.seed,
                      device=None if FLAGS.use_gpu else "cpu",
                      compute_dtype=FLAGS.compute_dtype)
    trainer.nonfinite_check_period = FLAGS.nonfinite_check_period
    log.info("device %s", trainer.device)
    if FLAGS.init_model_path:
        trainer.load(FLAGS.init_model_path)
        log.info("loaded initial model from %s", FLAGS.init_model_path)

    if job == "train":
        trainer.train(num_passes=FLAGS.num_passes,
                      log_period=FLAGS.log_period,
                      save_dir=FLAGS.save_dir or None,
                      steps_per_dispatch=FLAGS.steps_per_dispatch)
    else:
        stats = trainer.test()
        log.info("test result: %s", stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
