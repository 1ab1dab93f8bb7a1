"""Global flag system — the port's copy of paddle_tpu/utils/flags.py.

(ref: paddle/utils/Flags.{h,cpp}, CommandLineParser.{h,cpp}): a
process-global registry of typed flags with defaults, overridable from argv
or programmatically.  The flags are the JAX package's, by the same names and
defaults, except that `--use_gpu` (the reference paddle_trainer's name,
default true) takes the place of `--use_tpu`.  The port's CLI
(trainer_main.py) refuses the flags whose feature is not ported yet when
they are set (`NOT_PORTED`), and puts every flag back after a run
(`snapshot` / `restore`), so an in-process call leaves no state behind.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any


@dataclass
class _FlagSpec:
    name: str
    default: Any
    type: type
    help: str


class _Flags:
    """Attribute-style access to registered flags: ``FLAGS.use_gpu``."""

    def __init__(self) -> None:
        object.__setattr__(self, "_specs", {})
        object.__setattr__(self, "_values", {})

    def define(self, name: str, default: Any, help: str = "") -> None:
        specs = object.__getattribute__(self, "_specs")
        if name in specs:  # re-definition keeps first registration (idempotent imports)
            return
        specs[name] = _FlagSpec(name, default, type(default) if default is not None else str, help)
        object.__getattribute__(self, "_values")[name] = default

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(f"undefined flag: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        values = object.__getattribute__(self, "_values")
        if name not in values:
            raise AttributeError(f"undefined flag: {name}; use define_flag first")
        values[name] = value

    def as_dict(self) -> dict[str, Any]:
        return dict(object.__getattribute__(self, "_values"))

    def defaults(self) -> dict[str, Any]:
        return {n: s.default
                for n, s in object.__getattribute__(self, "_specs").items()}

    def restore(self, values: dict[str, Any]) -> None:
        """Set every flag to `values` (an `as_dict()` or `defaults()`)."""
        object.__getattribute__(self, "_values").update(values)

    def parse(self, argv: list[str] | None = None) -> list[str]:
        """Consume ``--name=value`` / ``--name value`` pairs; returns leftovers."""
        specs = object.__getattribute__(self, "_specs")
        values = object.__getattribute__(self, "_values")
        if argv is None:
            argv = sys.argv[1:]
        rest: list[str] = []
        i = 0
        while i < len(argv):
            arg = argv[i]
            if not arg.startswith("--"):
                rest.append(arg)
                i += 1
                continue
            body = arg[2:]
            if "=" in body:
                name, raw = body.split("=", 1)
            else:
                name = body
                nxt = argv[i + 1] if i + 1 < len(argv) else None
                # a bare flag never consumes a following flag token — values
                # that genuinely start with '--' need the --name=value form
                if nxt is not None and name in specs and \
                        not nxt.startswith("--"):
                    raw = nxt
                    i += 1
                else:
                    raw = "true"
            if name not in specs:
                rest.append(arg)
                i += 1
                continue
            spec = specs[name]
            if spec.type is bool:
                values[name] = raw.lower() in ("1", "true", "yes", "on")
            elif spec.default is None:
                values[name] = raw
            else:
                values[name] = spec.type(raw)
            i += 1
        return rest


FLAGS = _Flags()


def define_flag(name: str, default: Any, help: str = "") -> None:
    FLAGS.define(name, default, help)


def parse_flags(argv: list[str] | None = None) -> list[str]:
    return FLAGS.parse(argv)


# Core global flags (ref: paddle/utils/Flags.cpp:19-68 — use_gpu, trainer_count,
# log_period, saving_period, ...), as the JAX package defines them.
define_flag("use_gpu", True, "run on the CUDA card (false: the CPU); "
            "without CUDA, true fails instead of running on the CPU")
define_flag("seed", 1, "global RNG seed (0 = nondeterministic)")
define_flag("log_period", 100, "log training stats every N batches")
define_flag("dot_period", 1, "progress dot every N batches")
define_flag("saving_period", 1, "checkpoint every N passes")
define_flag("test_period", 0, "test every N batches (0 = every pass)")
define_flag("num_passes", 1, "number of training passes")
define_flag("start_pass", 0, "resume from pass N")
define_flag("save_dir", "./output", "checkpoint directory")
define_flag("init_model_path", "", "path to initial model checkpoint")
define_flag("config", "", "trainer config python file")
define_flag("config_args", "", "comma-separated key=value passed to the config")
define_flag("job", "train", "train | test | checkgrad | time")
define_flag("checkgrad_bar", 0.02, "max relative error --job=checkgrad "
            "accepts before failing (exit 1)")
define_flag("show_parameter_stats_period", 0, "dump parameter stats every N batches")
define_flag("beam_size", 1, "beam width for sequence generation")
define_flag("mesh_shape", "", "device mesh, e.g. 'data:8' or 'data:4,model:2'")
define_flag("profile_dir", "", "if set, write profiler traces here")
define_flag("compute_dtype", "", "override compute dtype ('bfloat16' = "
            "mixed precision: fp32 params, bf16 matmuls)")
define_flag("detect_nan", False, "trap FP anomalies and localise the "
            "first non-finite batch (ref: feenableexcept at "
            "TrainerMain.cpp:97)")
define_flag("nonfinite_check_period", 100, "without --detect_nan, losses "
            "buffer on device and are bulk-checked every N batches (keeps "
            "dispatch pipelined — no per-batch host sync)")
define_flag("steps_per_dispatch", 1, "fuse k consecutive same-shape train "
            "steps into ONE dispatch (on the card one replay of a CUDA "
            "graph of the k steps, the next group's host->device copies "
            "staged meanwhile); batches group by their padded-shape "
            "signature and a group flushes early when the shape changes, "
            "so the update order — and the training trajectory — is "
            "identical to k=1")
define_flag("prev_batch_state", False, "truncated-BPTT continuation: "
            "forward recurrent layers start from the previous batch's final "
            "hidden state instead of zeros (ref: RecurrentLayer.cpp "
            "prevOutput_; feed consecutive chunks of long streams in order)")
define_flag("check_sparse_distribution", False,
            "check vocab-sharded table ids for balanced per-shard traffic "
            "(ref: --check_sparse_distribution_in_pserver)")
define_flag("show_check_sparse_distribution_log", False,
            "log per-shard row-touch counts for every probed batch")
define_flag("check_sparse_distribution_batches", 100,
            "run the sparse distribution check for N batches, then stop")
define_flag("check_sparse_distribution_ratio", 0.6,
            "crash if more than this fraction of checked batches is unbalanced")
define_flag("check_sparse_distribution_unbalance_degree", 2.0,
            "max/mean row-touch ratio beyond which a batch counts unbalanced")
# multi-host bootstrap (ref: --trainer_id/--pservers of the pserver fleet)
define_flag("coordinator_address", "", "cluster coordinator host:port")
define_flag("num_processes", 0, "number of cluster processes")
define_flag("process_id", 0, "this process's id in the cluster")

# flags whose feature the port has not ported yet (ROADMAP.md): the CLI
# refuses a run that sets one away from its default
NOT_PORTED = ("mesh_shape", "coordinator_address", "num_processes",
              "process_id", "detect_nan", "profile_dir",
              "check_sparse_distribution", "show_parameter_stats_period")
