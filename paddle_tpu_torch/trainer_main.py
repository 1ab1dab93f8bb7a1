"""The port's trainer CLI — `python -m paddle_tpu_torch train --config=...`;
the port's copy of paddle_tpu/trainer_main.py.

(ref: paddle/trainer/TrainerMain.cpp:36-110: flag parsing, config load, job
dispatch.)  The four jobs of the reference's `paddle_trainer` run on the
CUDA card: `train`, `test`, `checkgrad` (Trainer.check_gradient on the
first batch of the training source; exit 1 when a parameter's error
exceeds --checkgrad_bar) and `time` (Trainer.benchmark: samples/s).
`--use_gpu=false` asks for the CPU, and with `--use_gpu=true` and no CUDA
the run fails instead of moving to the CPU.  `--detect_nan` checks every
batch's loss and names the first non-finite layer (exit 1 on a non-finite
loss); `--profile_dir=DIR` runs the job under `torch.profiler` (the CPU
and, on the card, CUDA activities) and writes `DIR/trace.json`, a Chrome
trace, when the job ends, also when it fails; `--show_parameter_stats_period
=N` logs each parameter's mean and max |value| every N batches.  Exit
codes as in the JAX package's CLI: 2 for a config that fails to parse,
for `--job=test` on a config without a test source, for
`--job=checkgrad` on a source that gives no batch, and for a usage error.
The flags of `utils.flags.NOT_PORTED` (meshes and the multi-host
bootstrap, the sparse-distribution check) are refused with exit 2 and a
message naming ROADMAP.md when set away from their defaults.  Arguments
the flags do not know are refused too.

Every flag is reset to its default before a run and put back after it, so
a caller may run `main` several times in one process.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from paddle_tpu_torch.config.parser import parse_config
from paddle_tpu_torch.trainer.trainer import Trainer
from paddle_tpu_torch.utils import FLAGS, get_logger, parse_flags
from paddle_tpu_torch.utils.flags import NOT_PORTED

log = get_logger("main")

USAGE = ("usage: python -m paddle_tpu_torch train --config=<config.py> "
         "[--job=train|test|checkgrad|time] [--num_passes=N] "
         "[--save_dir=DIR] [--config_args=k=v,...] [--init_model_path=DIR] "
         "[--steps_per_dispatch=K] [--compute_dtype=bfloat16] "
         "[--use_gpu=false] [--seed=N] [--log_period=N] [--detect_nan] "
         "[--profile_dir=DIR] [--show_parameter_stats_period=N]")


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
    if job not in ("train", "test", "checkgrad", "time"):
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

    with _profiled(FLAGS.profile_dir, trainer.device):
        try:
            return _job(trainer, job)
        except FloatingPointError as e:
            log.error("%s", e)
            return 1


def _job(trainer: Trainer, job: str) -> int:
    if job == "train":
        trainer.train(num_passes=FLAGS.num_passes,
                      log_period=FLAGS.log_period,
                      save_dir=FLAGS.save_dir or None,
                      steps_per_dispatch=FLAGS.steps_per_dispatch)
    elif job == "test":
        stats = trainer.test()
        log.info("test result: %s", stats)
    elif job == "time":
        stats = trainer.benchmark(trainer.train_batches())
        log.info("benchmark: %.1f samples/sec (%d samples in %.2fs)",
                 stats["samples_per_sec"], stats["samples"],
                 stats["seconds"])
    else:
        batch = next(iter(trainer.train_batches()), None)
        if batch is None:
            log.error("checkgrad: data source produced no batches")
            return 2
        errors = trainer.check_gradient(
            batch, refine_threshold=FLAGS.checkgrad_bar)
        worst = max(errors.values(), default=0.0)
        log.info("checkgrad: %d parameters, worst max_rel_err=%.3e",
                 len(errors), worst)
        if worst > FLAGS.checkgrad_bar:
            log.error("gradient check FAILED")
            return 1
    return 0


@contextlib.contextmanager
def _profiled(profile_dir: str, device: torch.device):
    """`torch.profiler` around the job when `profile_dir` is set (CUDA
    activities on the card), its Chrome trace written to
    `profile_dir/trace.json` when the job ends, also when it fails."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)


if __name__ == "__main__":
    sys.exit(main())
