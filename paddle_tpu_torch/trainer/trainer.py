"""Trainer — the port's counterpart of paddle_tpu/trainer/trainer.py for the
per-batch training loop and its fused k-step dispatch.

One step (`_step`) is the JAX side's jitted train step, all on the device:
the TRAIN forward and `GraphExecutor.loss`, `torch.autograd.grad` for every
trainable parameter, `ParameterUpdater.apply` (in place, on device
counters) and the evaluators' partial sums.  `train_one_batch` runs it
eagerly; the host then advances its counters, adds the partials and keeps
the loss on the device: losses are checked for finiteness in bulk every
`nonfinite_check_period` batches (`_drain_losses`), so the host does not
wait for the device on every step.

`train_one_pass(steps_per_dispatch=k)` is the fused dispatch: consecutive
batches of one signature (`_batch_signature`) go in groups of at most k,
flushed early when the signature changes, so updates apply in arrival
order.  On the card a group of j steps is one replay of a CUDA graph of j
steps of that signature (`utils/cuda_graphs.py`; one memory pool for all of
a trainer's graphs, the dropout generator registered with each): the
group's batches are copied into the graph's input tensors and the graph
runs the j steps, as the reference runs a group in one k-step `lax.scan`.
So n same-signature batches take ceil(n/k) replays, and a signature has a
graph for each group size it meets (k, and the shorter groups a signature
change or the end of a pass leaves).  The first batch of a new signature
runs the step eagerly and is kept, as the k = 1 loop runs it (the
reference's settling dispatch; a warm-up before capture would apply extra
updates), and the rest of its group replays.  On the CPU the same step
runs uncaptured, batch by batch.  Losses, parameters, optimizer state,
evaluator sums, the dropout generator and the layer state end where k = 1
leaves them, bit for bit.

Layer state (`net_state`: the batch-norm moving mean, variance and count,
by layer name) is carried as the reference carries it through its scan:
the first step that grows a layer's state creates its tensors, every later
step writes the same tensors in place, so a captured step reads and writes
them where the eager one does (a signature's eager first step settles the
state's structure before its capture).  `test()` and an is_predict forward
read the moving statistics; `save`/`load` write and read them as the JAX
package's `net|<layer>|<statistic>` keys.  The steps and `test()` run
cuDNN's deterministic algorithms, never autotuned (`cudnn_deterministic`):
its fastest fp32 convolution backward algorithms add with atomics, and
the eager and the captured step would then differ in their last bits.

Updates write into the trainer's tensors in place (a graph replays into
the addresses it captured): `Trainer.params`, the optimizer slots and the
layer state are the same tensors for a trainer's life (until `load`), and
whoever keeps one sees it change.  Take a snapshot with `clone()` or
`.to(device, copy=True)`.

Without `batches`, a pass reads the config's data source: `load_provider`
imports the @provider module it names (under the port's binding of the
JAX package's names, config/parser.py) and `DataFeeder` (data/feeder.py)
batches its samples on the host, as the JAX package's trainer does, so
the batches are the same.  In the fused pass the groups are staged on a
thread one ahead of the dispatch (`DeviceDoubleBuffer`): on the card each
group's host-to-device copies run from pinned memory on a side stream,
and the dispatch's stream waits on the event recorded after them before
it copies the group into a captured graph's input tensors, so the copy
into those tensors is ordered after the replay that last read them.

Feeds of sparse rows (`Argument.sparse_vals`) move to the device with
their ids; the fc layer and full-matrix projections gather the rows they
touch.  Under model averaging (`average_window > 0`) every update also
moves the averages (`opt_state["average"]`, `["average_count"]`, written
in place like the slots), `test()` evaluates with them, and checkpoints
carry them as the JAX package's `opt|average|<name>` and
`opt|average_count`.  Host evaluators (`chunk`) read some layers'
outputs after each step: each step hands them on (a captured group's are
copied out of the graph's buffers after its replay, step by step), and
they are read in bulk with the losses.

`train()` runs passes, each followed by `test()` on the config's test
source when it has one and a checkpoint in `save_dir`; `test()` runs the
TEST forward; `save`/`load` write and read the JAX package's checkpoint
layout, so either side resumes the other's run.

Nested-sequence feeds (`Argument.sub_lengths`, values [B, S, T(, D)])
move to the device with their sub_lengths, which are part of a batch's
signature.  Under --prev_batch_state the recurrent layers' final states
(`<layer>:h`, `<layer>:c`) are layer state like batch norm's: each step
boots from the previous step's and writes its own in place, eager or
captured; `test()` reads them and leaves them as they are.  A batch of
another size ignores the carried state and leaves its own, of its size, so
the state's shapes change with the batch size: the fused dispatch runs a
group's first step eagerly whenever the state's layout differs from the
one the signature's steps leave (`_settled`), and captures only steps
that keep the layout.

Gradient accumulation and pruning hooks live in the updater
(optim/updater.py): an accumulated step is one captured step like any
other, its accumulate-or-apply branch decided on the device.  A
`gradient_printer` evaluator probes its layers (`GraphExecutor.forward`'s
`probes`): the zero tensors are made inside the step (in a captured step
the graph's own buffers), and their gradients reach the host evaluators
as `__grad__<layer>` outputs, queued like the others.

Under --detect_nan (`FLAGS.detect_nan`) each step's loss is read and
checked at once, a fused pass falls back to one step per dispatch, and a
non-finite loss raises FloatingPointError naming the first layer whose
output is not finite (`diagnose_nonfinite`: the forward re-run with the
post-update parameters, as the reference reports it).  The reference also
sets `jax_debug_nans`, which re-runs the failing primitive; the port has
no counterpart of that and does not imitate it with a global anomaly
mode: the per-batch check and the layer report are the whole of it.  The
bulk check of the default reports the layer of the last buffered batch.

`check_gradient` is `--job=checkgrad` (central differences against the
analytic gradient, the noise-aware relative error, a float64
re-adjudication with kink detection on the CPU only), `benchmark` is
`--job=time`, `param_stats` / `log_param_stats` serve
--show_parameter_stats_period.

Observability, as the reference's trainer: the compile watch records the
sites `trainer.train_step` (an eager step's first run per batch
signature), `trainer.fused_step` (each captured group; on the CPU each
group's first run per signature and size) and `trainer.eval_step`; the
tracer gets a `train_pass` span per pass and an `eval` span per `test()`;
the `BarrierTimer` (parallel/barrier_stat.py) times dispatches, loss
reads, staging and replays; `metrics` (a strict MetricsRegistry) holds the
progress gauges and counters and the collectors of the host phases
(`utils/stat.py global_stat`), the barrier windows, the tracer, the
compile watch and the device memory, and `append_metrics` writes its
snapshot with each pass's row of `metrics.jsonl`.

Not ported yet, and refused (ROADMAP.md): the binary-shard data source
(`ptsh`), meshes, pipeline stages and the parameter server.
"""

from __future__ import annotations

import contextlib
import datetime
import importlib
import itertools
import json
import os
import time
from typing import Any, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.config.parser import bound_config_names
from paddle_tpu_torch.config.schema import DataConfig, TrainerConfig
from paddle_tpu_torch.data.feeder import DataFeeder, DeviceDoubleBuffer
from paddle_tpu_torch.data.provider import MultiProviderWrapper
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.graph.builder import GraphExecutor
from paddle_tpu_torch.graph.context import TEST, TRAIN
from paddle_tpu_torch.obs import (MetricsRegistry, barrier_collector,
                                  compile_collector, get_compile_watch,
                                  get_tracer, hbm_collector, signature_of,
                                  statset_collector, tracer_collector)
from paddle_tpu_torch.optim.updater import ParameterUpdater
from paddle_tpu_torch.parallel.barrier_stat import BarrierTimer
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.parameter.init import init_params
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.evaluators import EvaluatorSet
from paddle_tpu_torch.utils.cuda_graphs import StepGraph, new_pool
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.logger import get_logger
from paddle_tpu_torch.utils.stat import global_stat

Batch = dict[str, Argument]
log = get_logger("trainer")


def load_provider(data_cfg: DataConfig):
    """Instantiate a @provider from a DataConfig
    (ref: gserver/dataproviders/PyDataProvider2.cpp createPyDataProvider).

    The module is imported under `bound_config_names()`: a provider written
    for the JAX package gets the port's `@provider` and slot types, and the
    module is imported afresh and dropped from `sys.modules` again.  So
    each call initializes a wrapper of its own, and sub-sources naming one
    @provider with different args never share its settings (the JAX
    package's loader clones them for that)."""
    with bound_config_names():
        mod = importlib.import_module(data_cfg.load_data_module)
    prov = getattr(mod, data_cfg.load_data_object)
    files: list[str] = []
    if data_cfg.files:
        if os.path.exists(data_cfg.files):
            with open(data_cfg.files) as f:
                files = [ln.strip() for ln in f if ln.strip()]
        else:
            files = [data_cfg.files]
    kwargs = json.loads(data_cfg.load_data_args) if data_cfg.load_data_args else {}
    if not isinstance(kwargs, dict):
        kwargs = {"args": kwargs}
    prov.initialize(files, **kwargs)
    return prov, files


def _as_tensor(x, device: torch.device,
               pinned: bool = False) -> Optional[torch.Tensor]:
    if x is None:
        return None
    if not (pinned and device.type == "cuda"):
        return torch.as_tensor(x, device=device)
    t = torch.as_tensor(x)
    if t.device.type == "cpu":
        # the caching host allocator keeps the pinned copy until the
        # device copy from it has run
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def make_feeder(config: TrainerConfig, data_cfg: DataConfig, train: bool,
                seed: int = 1) -> DataFeeder:
    """The feeder of one of a config's data sources, as the JAX package's
    trainer builds it (its `_feeder`): shuffled from `seed` and without the
    last short batch for training, in order and whole for testing."""
    if data_cfg.type == "ptsh":
        raise NotImplementedError(
            "the ptsh binary-shard data source (the native shard reader) "
            "is not ported yet (ROADMAP.md)")
    if data_cfg.type == "multi":
        # ratio-mixed sub-providers (ref: MultiDataProvider.{h,cpp})
        subs, sub_files = [], []
        for sub_cfg in data_cfg.sub_configs:
            p, f = load_provider(sub_cfg)
            subs.append(p)
            sub_files.append(f)
        prov = MultiProviderWrapper(subs, sub_files,
                                    ratios=data_cfg.data_ratios or None,
                                    is_test=not train)
        files: list[str] = []
    else:
        prov, files = load_provider(data_cfg)
    return DataFeeder(
        prov, files, input_names=config.model_config.input_layer_names,
        batch_size=config.opt_config.batch_size, seed=seed,
        drop_last=train, shuffle=None if train else False,
        constant_slots=data_cfg.constant_slots)


class Trainer:
    """Trains one TrainerConfig on one device (the CUDA card unless
    `device="cpu"`).  `params` takes starting parameters (for example
    `params_from_jax(...)` output); without it they come from
    `init_params(model, seed)`, and the trainer keeps copies of its own.

    `params` (name -> tensor) and the slots in `opt_state["slots"]` are
    updated in place by every step: the same tensors for the trainer's
    life, so a caller holding one (a `ServingEngine` built from them, a
    CPU trainer's tensor kept as a snapshot) sees it change.  Snapshot
    with `clone()` or `.to(device, copy=True)`."""

    # bulk finiteness check of buffered losses, as the JAX side's
    # --nonfinite_check_period default
    nonfinite_check_period = 100
    # cuDNN's deterministic algorithms for the steps and test(): some of
    # its fp32 convolution backward algorithms add with atomics, and two
    # runs of a step (eager and captured, or two eager ones) then differ
    # in their last bits; False only to measure what determinism costs
    cudnn_deterministic = True

    def __init__(self, config: TrainerConfig, seed: int = 1,
                 device: DeviceLike = None,
                 params: Optional[dict[str, torch.Tensor]] = None,
                 compute_dtype: str = ""):
        """`compute_dtype` overrides the config's (the CLI's
        --compute_dtype)."""
        if config.model_config is None or config.opt_config is None:
            raise ValueError("TrainerConfig needs model_config and opt_config")
        self.device = resolve_device(device)
        self.config = config
        self.model = config.model_config
        self.opt = config.opt_config
        self.seed = seed
        staged = [l.name for l in self.model.layers if l.device >= 0]
        if staged:
            raise NotImplementedError(
                f"layers {staged} carry pipeline-stage annotations; pipeline "
                f"training is not ported yet (ROADMAP.md)")
        self.executor = GraphExecutor(
            self.model, compute_dtype=compute_dtype or self.opt.compute_dtype)
        self.updater = ParameterUpdater(self.model, self.opt)
        self.evaluators = EvaluatorSet(self.model)
        self._probes = self._probe_names()
        if params is None:
            params = init_params(self.model, seed=seed, device=self.device)
        missing = sorted({p.name for p in self.model.parameters} - set(params))
        if missing:
            raise KeyError(f"params lack {missing}")
        # own copies: the updates write into them in place; pruning masks
        # bind to the starting values (ref: StaticPruningHook::init)
        self.params = self.updater.apply_init_hooks(
            {n: params[n].to(self.device, copy=True)
             for n in (p.name for p in self.model.parameters)})
        self.opt_state = self.updater.init_state(self.params)
        self.net_state: dict[str, Any] = {}
        # a JAX PRNG key carried through a loaded checkpoint, unused here:
        # the port's own random stream (training-time dropout) is this
        # generator, saved with a checkpoint and restored on the same kind
        # of device
        self.rng: Optional[np.ndarray] = None
        self.dropout_rng = torch.Generator(device=self.device)
        self.dropout_rng.manual_seed(int(seed))
        self.pass_id = 0
        self._static = self.executor.static_param_names
        self._data_layers = {l.name: l for l in self.model.layers
                             if l.type == "data"}
        self._acc: dict = {}
        self._host_acc: dict = self.evaluators.new_host_state()
        self._loss_buf: list[torch.Tensor] = []
        # each step's outputs the host evaluators read, queued until the
        # losses are drained
        self._host_buf: list[dict] = []
        self._drained_cost = 0.0
        # the last batch whose loss was buffered (the bulk check's report)
        self._last_batch: Optional[Batch] = None
        # the keys of the steps already run once (an eager step's batch
        # signature; on the CPU a fused group's signature and size): their
        # later runs are timed, their first is a compile event
        self._seen: set = set()
        # the fused dispatch: by signature, the layout of the layer state
        # its eager step left (a step starting from that layout keeps it),
        # and the captured steps by (signature, group size) (the card only)
        self._settled: dict = {}
        self._graphs: dict[tuple, _CapturedSteps] = {}
        self._pool = new_pool(self.device)
        self.n_fused_dispatches = 0     # groups dispatched
        self.n_settle_steps = 0         # eager first steps of a signature
        # the fused pass's staging: a side stream for the host-to-device
        # copies of the next group (the card only)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._tracer = get_tracer()
        self.barrier_stat = BarrierTimer(tracer=self._tracer)
        self.metrics = self._new_metrics()

    def _new_metrics(self) -> MetricsRegistry:
        """The registry of the reference's trainer: progress gauges and
        counters, and collectors over the host phases, the barrier
        windows, the tracer's ring, the compile watch and device memory."""
        m = MetricsRegistry(strict=True)
        self._m_pass = m.gauge("trainer_pass_id")
        self._m_cost = m.gauge("trainer_cost")
        self._m_sps = m.gauge("trainer_samples_per_sec")
        self._m_batches = m.counter("trainer_batches_total")
        self._m_samples = m.counter("trainer_samples_total")
        m.register_collector(statset_collector(
            global_stat, "trainer_host_phase_seconds",
            "trainer_host_phase_count", label="phase",
            total_metric="trainer_host_phase_seconds_total"))
        m.register_collector(barrier_collector(self.barrier_stat))
        m.register_collector(tracer_collector(self._tracer))
        m.register_collector(compile_collector())
        m.register_collector(hbm_collector(params_fn=lambda: self.params))
        return m

    def _probe_names(self) -> list[str]:
        """The layers whose output gradients a gradient_printer prints
        (ref: GradientPrinter reads getOutputGrad()).  Probes go on root
        layers only: a layer inside a recurrent group is refused, as a
        zero there would pass for a gradient."""
        ex = self.executor
        for n in self.evaluators.probe_layer_names:
            if n in ex._sub_of:
                raise NotImplementedError(
                    f"gradient_printer on {n!r}: the layer runs inside "
                    f"recurrent group {ex._sub_of[n].name!r}, where output-"
                    f"grad probes are not injected — probe a layer outside "
                    f"the group (e.g. the group's consumer)")
            if n not in ex.layer_map or ex.layer_map[n].type == "data":
                raise ValueError(
                    f"gradient_printer on {n!r}: not a computed layer")
        return self.evaluators.probe_layer_names

    # -- one step -------------------------------------------------------
    def prepare_batch(self, batch: Batch, pinned: bool = False) -> Batch:
        """Check the feed against the data layers (missing or unknown keys,
        ids out of range on host arrays: a sparse row's column ids against
        its width, other ids against the data layer's size; batch sizes)
        and move it to the device, ids as int64, with a nested feed's
        sub_lengths; `pinned` copies host arrays through pinned memory
        without waiting for the copy (the fused pass's staging, on its
        side stream).  Sparse-row values keep
        their dtype here; the executor casts them to the compute dtype."""
        missing = sorted(set(self._data_layers) - set(batch))
        if missing:
            raise KeyError(f"batch is missing feed(s) for data layer(s) "
                           f"{missing}; fed keys: {sorted(batch)}")
        unknown = sorted(set(batch) - set(self._data_layers))
        if unknown:
            raise KeyError(f"batch feeds unknown key(s) {unknown} — not data "
                           f"layers (expected: {sorted(self._data_layers)})")
        out, sizes = {}, set()
        for name, arg in batch.items():
            if arg.value is None and arg.ids is None:
                raise ValueError(f"feed {name!r} carries neither dense "
                                 f"values nor ids")
            if arg.sub_lengths is not None and arg.lengths is None:
                raise ValueError(f"feed {name!r}: sub_lengths without the "
                                 f"sub-sequence counts (lengths)")
            ids = arg.ids
            sparse = arg.sparse_vals is not None
            if sparse and not arg.sparse_dim:
                raise ValueError(f"feed {name!r}: sparse rows without their "
                                 f"width (sparse_dim)")
            size = arg.sparse_dim if sparse else self._data_layers[name].size
            host = isinstance(ids, np.ndarray) or (
                isinstance(ids, torch.Tensor) and ids.device.type == "cpu")
            if ids is not None and host and size > 0 and np.size(ids):
                hi, lo = int(ids.max()), int(ids.min())
                if hi >= size or lo < 0:
                    what = "sparse row width" if sparse else \
                        "data layer size"
                    raise ValueError(
                        f"feed {name!r}: id {hi if hi >= size else lo} out "
                        f"of range for {what} {size}")
            ids = _as_tensor(ids, self.device, pinned)
            arg = Argument(value=_as_tensor(arg.value, self.device, pinned),
                           ids=None if ids is None else ids.long(),
                           lengths=_as_tensor(arg.lengths, self.device,
                                              pinned),
                           sub_lengths=_as_tensor(arg.sub_lengths,
                                                  self.device, pinned),
                           sparse_vals=_as_tensor(arg.sparse_vals,
                                                  self.device, pinned),
                           sparse_dim=arg.sparse_dim if sparse else 0)
            sizes.add(arg.data.shape[0])
            out[name] = arg
        if len(sizes) > 1:
            raise ValueError(f"feeds disagree on batch size: {sorted(sizes)}")
        return out

    def compute_gradients(self, batch: Batch,
                          dropout_masks: Optional[dict] = None):
        """The TRAIN loss of a prepared batch and d loss / d param for every
        trainable parameter: (loss, grads, outputs).  Dropout masks come
        from the trainer's generator unless `dropout_masks` gives a layer's
        keep-mask."""
        leaves = {n: (p.detach() if n in self._static
                      else p.detach().requires_grad_(True))
                  for n, p in self.params.items()}
        probes = dict.fromkeys(self._probes) if self._probes else None
        loss, (outputs, _, new_net) = self.executor.loss(
            leaves, batch, self.net_state, TRAIN, self.dropout_rng,
            dropout_masks, probes)
        names = [n for n in leaves if n not in self._static]
        wrt = [leaves[n] for n in names]
        if probes:
            unrun = [n for n, t in probes.items() if t is None]
            if unrun:
                raise ValueError(f"gradient_printer on {unrun}: the "
                                 f"layers did not run in this step")
            wrt += list(probes.values())
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        if probes:
            outputs = dict(outputs)
            for n, g in zip(probes, grads[len(names):]):
                outputs["__grad__" + n] = Argument(
                    value=torch.zeros_like(probes[n]) if g is None else g)
        grads = {n: g for n, g in zip(names, grads) if g is not None}
        self._keep_net_state(new_net)
        return loss.detach(), grads, outputs

    def _keep_net_state(self, new: dict) -> None:
        """A forward's new layer state into `net_state`: a layer's first
        state (or one of another structure or shape) becomes the trainer's
        own copy, later states are written into those tensors in place.
        A captured step may only write in place."""
        for name, tree in new.items():
            mine = self.net_state.get(name)
            if mine is not None and _layout(mine) == _layout(tree):
                _copy_into(mine, tree)
                continue
            if (self.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    f"layer {name!r} grows its state inside a captured step;"
                    f" the signature's eager first step should have grown "
                    f"it")
            self.net_state[name] = _own_copy(tree)

    def _step(self, batch: Batch, dropout_masks: Optional[dict] = None):
        """The training step on a prepared batch, on the device and with no
        host read: forward, gradients, the in-place update (the updater's
        device counters advance, the averages follow), the evaluators'
        partials.  Returns (loss, partials, the outputs the host
        evaluators read).  `train_one_batch` runs it eagerly; the fused
        dispatch captures it."""
        with self._cudnn():
            loss, grads, outputs = self.compute_gradients(batch,
                                                          dropout_masks)
            self.updater.apply(self.params, grads, self.opt_state,
                               _batch_size(batch))
            with torch.no_grad():
                partials = self.evaluators.batch_partials(outputs, batch)
        return loss, partials, _detached(
            self.evaluators.host_outputs(outputs))

    @contextlib.contextmanager
    def _cudnn(self):
        """cuDNN as the trainer's steps use it: `cudnn_deterministic`
        algorithms, never autotuned (an autotuned choice could differ
        between the eager and the captured step); the process's settings
        are restored after."""
        cudnn = torch.backends.cudnn
        saved = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic = self.cudnn_deterministic
        cudnn.benchmark = False
        try:
            yield
        finally:
            cudnn.deterministic, cudnn.benchmark = saved

    def _commit(self, loss: torch.Tensor, partials: dict, host_out: dict,
                batch: Batch) -> None:
        """The host's part of a step: the counters, the evaluator sums (in
        arrival order), the loss into the bulk check, the host evaluators'
        inputs into their queue (read in bulk with the losses).  Under
        --detect_nan the loss is read and checked here, and the queue
        drained."""
        self.opt_state = self.updater.advance(self.opt_state,
                                              _batch_size(batch))
        self._acc = self.evaluators.accumulate(self._acc, partials)
        if host_out:
            self._host_buf.append(host_out)
        if FLAGS.detect_nan:
            loss_f = float(loss)
            if not np.isfinite(loss_f):
                raise FloatingPointError(
                    f"non-finite loss {loss_f}; "
                    f"{self.diagnose_nonfinite(batch)}")
            self._drained_cost += loss_f + self._drain_losses()
            return
        self._last_batch = batch
        self._loss_buf.append(loss)
        if len(self._loss_buf) >= max(int(self.nonfinite_check_period), 1):
            self._drained_cost += self._drain_losses()

    def _eager(self, batch: Batch, dropout_masks: Optional[dict] = None
               ) -> torch.Tensor:
        self.updater.load_counters(self.opt_state, self.device)
        loss, partials, host_out = self._step(batch, dropout_masks)
        self._commit(loss, partials, host_out, batch)
        return loss

    def _run_step(self, batch: Batch, dropout_masks: Optional[dict] = None
                  ) -> torch.Tensor:
        """One eager step, watched as `trainer.train_step` (a signature's
        first run is its compile event; the later ones are timed
        dispatches)."""
        sig = self._batch_signature(batch, dropout_masks)
        timer = (self.barrier_stat.time_dispatch() if sig in self._seen
                 else contextlib.nullcontext())
        self._seen.add(sig)
        with get_compile_watch().observe("trainer.train_step", sig), timer:
            return self._eager(batch, dropout_masks)

    def train_one_batch(self, batch: Batch,
                        dropout_masks: Optional[dict] = None
                        ) -> torch.Tensor:
        """One optimizer step on one batch.  Returns the loss as a device
        scalar (no host read); non-finite losses raise at the next bulk
        check."""
        return self._run_step(self.prepare_batch(batch), dropout_masks)

    def _drain_losses(self) -> float:
        """One host read for all buffered losses: bulk finiteness check and
        their sum; the queued batches' outputs go to the host evaluators,
        in arrival order."""
        for host_out in self._host_buf:
            self.evaluators.host_update(self._host_acc, host_out)
        self._host_buf.clear()
        if not self._loss_buf:
            return 0.0
        with self.barrier_stat.time_sync():
            losses = torch.stack(self._loss_buf).float().cpu().numpy()
        n = len(self._loss_buf)
        self._loss_buf.clear()
        if not np.isfinite(losses).all():
            bad = int(np.flatnonzero(~np.isfinite(losses))[0])
            diag = (self.diagnose_nonfinite(self._last_batch)
                    if self._last_batch is not None else "")
            raise FloatingPointError(
                f"non-finite loss {losses[bad]} ({n - bad - 1} batches "
                f"before the last dispatched; run with --detect_nan for "
                f"exact per-batch localisation); {diag}")
        return float(losses.sum())

    # -- data -----------------------------------------------------------
    def _feeder(self, data_cfg: DataConfig, train: bool) -> DataFeeder:
        return make_feeder(self.config, data_cfg, train, self.seed)

    def train_batches(self) -> Iterator[Batch]:
        """One pass of the config's training source, assembled on a host
        thread unless the source says async_load_data=False."""
        if self.config.data_config is None:
            raise ValueError("config has no data source")
        feeder = self._feeder(self.config.data_config, True)
        if not self.config.data_config.async_load_data:
            return feeder.batches()
        return feeder.prefetched_batches()

    # -- passes ---------------------------------------------------------
    def train_one_pass(self, batches: Optional[Iterable[Batch]] = None,
                       steps_per_dispatch: Optional[int] = None,
                       dropout_masks: Optional[Sequence[dict]] = None,
                       log_period: int = 0) -> dict[str, float]:
        """Train on every batch of `batches` (default: a pass of the
        config's data source, `train_batches()`); returns the pass
        statistics (cost = mean loss, the evaluators, batches, samples,
        seconds, samples_per_sec).  `steps_per_dispatch=k > 1` runs the
        fused dispatch (module docstring), with results identical to
        k = 1.  `dropout_masks` gives each batch's keep-masks by layer (one
        dict per batch) in place of draws from `dropout_rng`.  Every
        `log_period` batches the cost so far is logged."""
        k = 1 if steps_per_dispatch is None else int(steps_per_dispatch)
        if k < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
        if k > 1 and FLAGS.detect_nan:
            # a fused group would apply its other updates before the check
            log.warning("--detect_nan forces steps_per_dispatch=1 "
                        "(per-batch nonfinite localisation)")
            k = 1
        stats_period = int(FLAGS.show_parameter_stats_period)
        t0 = time.time()
        self._acc = {}
        self._host_acc = self.evaluators.new_host_state()
        self._loss_buf.clear()
        self._host_buf.clear()
        self._drained_cost = 0.0
        if batches is None:
            batches = self.train_batches()
        masks = iter(dropout_masks) if dropout_masks is not None else None
        n_batches = n_samples = 0
        if k == 1:
            for batch in batches:
                with global_stat.time("trainOneBatch"):
                    self.train_one_batch(batch, _next_masks(masks))
                n_batches += 1
                n_samples += _batch_size(batch)
                if log_period and n_batches % log_period == 0:
                    self._log_progress(n_batches)
                if stats_period and n_batches % stats_period == 0:
                    self.log_param_stats()
        else:
            staged = DeviceDoubleBuffer(self._host_groups(batches, masks, k),
                                        self._stage_group)
            try:
                for group, ready in staged:
                    with global_stat.time("trainKSteps"):
                        self._dispatch_fused(self._received(group, ready),
                                             group)
                    j = len(group)
                    n_batches += j
                    n_samples += sum(_batch_size(b) for b, _ in group)
                    if log_period and (n_batches // log_period
                                       != (n_batches - j) // log_period):
                        self._log_progress(n_batches)
                    if stats_period and (n_batches // stats_period
                                         != (n_batches - j) // stats_period):
                        self.log_param_stats()
            finally:
                staged.close()
        self._drained_cost += self._drain_losses()
        self.opt_state = self.updater.finish_pass(self.opt_state)
        stats = self.evaluators.finalize(self._acc)
        stats.update(self.evaluators.finalize_host(self._host_acc))
        dt = time.time() - t0
        stats.update(cost=self._drained_cost / max(n_batches, 1),
                     batches=n_batches, samples=n_samples, seconds=dt,
                     samples_per_sec=n_samples / dt if dt > 0 else 0.0)
        log.info("pass %d done: %s", self.pass_id, _fmt(stats))
        if self._tracer.enabled:
            self._tracer.add("train_pass", time.perf_counter() - dt, dt,
                             track="trainer",
                             attrs={"pass": self.pass_id,
                                    "batches": n_batches})
        self.pass_id += 1
        self._m_pass.set(self.pass_id)             # = passes completed
        self._m_cost.set(stats["cost"])
        self._m_sps.set(stats["samples_per_sec"])
        if n_batches:
            self._m_batches.inc(n_batches)
            self._m_samples.inc(n_samples)
        return stats

    def _log_progress(self, n_batches: int) -> None:
        self._drained_cost += self._drain_losses()
        stats = self.evaluators.finalize(self._acc)
        stats.update(self.evaluators.finalize_host(self._host_acc))
        log.info("pass %d batch %d: cost=%.5f %s", self.pass_id, n_batches,
                 self._drained_cost / n_batches, _fmt(stats))

    def train(self, num_passes: int = 1, log_period: int = 100,
              save_dir: Optional[str] = None, keep_last: int = 0,
              steps_per_dispatch: Optional[int] = None) -> list[dict]:
        """Full training job (ref: Trainer::train): `num_passes` passes of
        the config's data source, each followed by `test()` when the config
        has a test source (its statistics under "test") and, with
        `save_dir`, a checkpoint and a row of `metrics.jsonl` there."""
        history = []
        for _ in range(num_passes):
            stats = self.train_one_pass(steps_per_dispatch=steps_per_dispatch,
                                        log_period=log_period)
            if self.config.test_data_config is not None:
                test_stats = self.test()
                log.info("pass %d test: %s", self.pass_id - 1,
                         _fmt(test_stats))
                stats["test"] = test_stats
            if save_dir:
                self.save(save_dir, keep_last=keep_last)
                self.append_metrics(save_dir, extra=stats)
            history.append(stats)
        return history

    def append_metrics(self, save_dir: str,
                       extra: Optional[dict] = None) -> str:
        """Append one record to `<save_dir>/metrics.jsonl`: {ts, pass_id,
        the scalar pass statistics, metrics: the registry's snapshot}, as
        the JAX package's trainer writes it."""
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, "metrics.jsonl")
        rec = {"ts": datetime.datetime.now(datetime.timezone.utc)
               .isoformat(timespec="seconds"), "pass_id": self.pass_id}
        for k, v in (extra or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                rec[k] = v
        rec["metrics"] = self.metrics.snapshot()
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return path

    # -- fused k-step dispatch ------------------------------------------
    def _batch_signature(self, batch: Batch,
                         dropout_masks: Optional[dict] = None) -> tuple:
        """Shapes and dtypes of every feed of a batch and of its fed
        dropout masks: of a prepared batch, the key of a captured step.
        (The layer state's structure is not part of it: a signature's eager
        first step settles it, and a capture whose state tensors were
        replaced is retaken, `_CapturedSteps.holds`.)"""
        feeds = tuple(sorted((name, _spec(a.value), _spec(a.ids),
                              _spec(a.lengths), _spec(a.sub_lengths),
                              _spec(a.sparse_vals), a.sparse_dim)
                             for name, a in batch.items()))
        masks = tuple(sorted((name, _spec(m))
                             for name, m in (dropout_masks or {}).items()))
        return feeds, masks

    def _host_groups(self, batches: Iterable[Batch], masks, k: int):
        """[(batch, masks), ...] groups of at most k consecutive batches of
        one signature (of the feeds and masks as given, before they are
        moved to the device), in arrival order."""
        pending: list = []
        sig = None
        for batch in batches:
            m = _next_masks(masks)
            s = self._batch_signature(batch, m)
            if pending and (s != sig or len(pending) == k):
                yield pending
                pending = []
            sig = s
            pending.append((batch, m))
        if pending:
            yield pending

    def _stage_group(self, group: list):
        """The DeviceDoubleBuffer's place_fn, on its thread: a host group
        checked and moved to the device, ([(prepared batch, masks), ...],
        the event recorded after its copies on the side stream, or None
        off the card)."""
        def place(batch, m, pinned):
            return (self.prepare_batch(batch, pinned),
                    None if m is None else {
                        n: _as_tensor(v, self.device, pinned)
                        for n, v in m.items()})
        with self.barrier_stat.time_h2d():
            if self._copy_stream is None:
                return [place(b, m, False) for b, m in group], None
            with torch.cuda.stream(self._copy_stream):
                staged = [place(b, m, True) for b, m in group]
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        return staged, ready

    def _received(self, group: list, ready) -> tuple:
        """A staged group taken over by the dispatching stream: it waits on
        the staging event, and the staged tensors (allocated on the side
        stream) are marked as used on it, so that their memory is not
        reused before the dispatch has read them.  Returns the group's
        signature."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for batch, m in group:
                for t in _tensors(batch, m):
                    t.record_stream(stream)
        return self._batch_signature(*group[0])

    def _dispatch_fused(self, sig: tuple, group: list) -> torch.Tensor:
        """One group: on the CPU the step once per batch, uncaptured; on the
        card one replay of the graph of len(group) steps of the signature,
        after an eager first step when the signature was never seen or the
        layer state's layout is not the one its steps leave (the first
        step grows the state, or a batch of another size left state of its
        size).  Returns the group's losses (on the device)."""
        self.n_fused_dispatches += 1
        cw = get_compile_watch()
        if self.device.type != "cuda":
            key = (sig, len(group))
            timer = (self.barrier_stat.time_scan() if key in self._seen
                     else contextlib.nullcontext())
            self._seen.add(key)
            with cw.observe("trainer.fused_step", *key), timer:
                return torch.stack([self._eager(b, m) for b, m in group])
        settle = []
        if self._settled.get(sig) != _layout(self.net_state):
            settle = [self._run_step(*group[0])]
            self._settled[sig] = _layout(self.net_state)
            self.n_settle_steps += 1
            group = group[1:]
            if not group:
                return torch.stack(settle)
        self.updater.load_counters(self.opt_state, self.device)
        key = (sig, len(group))
        steps = self._graphs.get(key)
        if steps is None or not steps.holds(self):
            t0 = time.perf_counter()
            steps = self._graphs[key] = _CapturedSteps(self, group)
            cw.record("trainer.fused_step", signature_of(key, {}),
                      time.perf_counter() - t0, t0=t0)
        steps.load(group)
        with self.barrier_stat.time_scan():
            steps.graph.replay()
        # read before any other replay (the graphs share one memory pool)
        # or the next load (the feeds the host evaluators read): each
        # step's own outputs, copied on the device
        losses = steps.losses.clone()
        for i, (batch, _) in enumerate(group):
            host_out = {n: _cloned(a)
                        for n, a in steps.host_outs[i].items()}
            self._commit(losses[i], steps.partials[i], host_out, batch)
        return torch.cat([torch.stack(settle), losses]) if settle else losses

    @torch.no_grad()
    def test(self, batches: Optional[Iterable[Batch]] = None
             ) -> dict[str, float]:
        """The TEST-mode cost (sample-weighted mean of the batch losses) and
        the evaluators over `batches` (default: the config's test source,
        in order, the last short batch kept; ref: Tester::testOnePeriod),
        with the averaged parameters under model averaging (the training
        parameters stay as they are)."""
        if batches is None:
            if self.config.test_data_config is None:
                raise ValueError(
                    "test needs a test data source, but this config "
                    "declares none — add define_py_data_sources2("
                    "test_list=...) to the config, or pass batches= "
                    "explicitly (ref: --job=test requires a test source, "
                    "TrainerMain.cpp)")
            batches = self._feeder(self.config.test_data_config,
                                   False).batches()
        params = self.updater.averaged_params(self.params, self.opt_state)
        acc: dict = {}
        host_acc = self.evaluators.new_host_state()
        total, n = 0.0, 0
        cw = get_compile_watch()
        with self._tracer.span("eval", track="trainer"):
            for batch in batches:
                batch = self.prepare_batch(batch)
                with self._cudnn(), cw.observe("trainer.eval_step",
                                               self._batch_signature(batch)):
                    loss, (outputs, _, _) = self.executor.loss(
                        params, batch, self.net_state, TEST)
                bsz = _batch_size(batch)
                total += float(loss) * bsz
                n += bsz
                acc = self.evaluators.accumulate(
                    acc, self.evaluators.batch_partials(outputs, batch))
                self.evaluators.host_update(
                    host_acc, self.evaluators.host_outputs(outputs))
        stats = self.evaluators.finalize(acc)
        stats.update(self.evaluators.finalize_host(host_acc))
        stats["cost"] = total / max(n, 1)
        return stats

    # -- diagnostics ----------------------------------------------------
    def param_stats(self) -> dict[str, dict]:
        """Each parameter's shape, mean and max |value| (ref:
        TrainerInternal.cpp showParameterStats), from a host copy."""
        out = {}
        for name, v in self.params.items():
            a = np.abs(_host(v))
            out[name] = {"shape": tuple(v.shape), "mean_abs": float(a.mean()),
                         "max_abs": float(a.max())}
        return out

    def log_param_stats(self) -> None:
        for name, st in self.param_stats().items():
            log.info("param %s shape=%s mean_abs=%.3e max_abs=%.3e",
                     name, st["shape"], st["mean_abs"], st["max_abs"])

    @torch.no_grad()
    def diagnose_nonfinite(self, batch: Batch) -> str:
        """The first layer, in config order, whose output is not finite:
        the TRAIN forward re-run on `batch` with the post-update
        parameters (dropout from a generator of its own, the trainer's
        stream untouched), in the reference's words (its gLayerStackTrace
        analog)."""
        batch = self.prepare_batch(batch)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        with self._cudnn():
            outputs, costs, _ = self.executor.forward(
                self.params, batch, self.net_state, TRAIN, gen)
        for layer in self.model.layers:
            arg = outputs.get(layer.name)
            if arg is None or arg.value is None:
                continue
            a = arg.value
            if not bool(torch.isfinite(a).all()):
                return (f"first non-finite output at layer {layer.name!r} "
                        f"(type={layer.type}): "
                        f"nan={int(torch.isnan(a).sum())} "
                        f"inf={int(torch.isinf(a).sum())} of {a.numel()} "
                        f"(forward re-run with post-update parameters)")
        for cname, c in costs.items():
            if not bool(torch.isfinite(c).all()):
                return (f"non-finite cost {cname!r} with finite layer "
                        f"outputs (forward re-run with post-update "
                        f"parameters)")
        return ("forward with post-update parameters is finite — the "
                "non-finite value arose in the gradient/optimizer update of "
                "the failing step")

    def check_gradient(self, batch: Batch, epsilon: float = 1e-3,
                       max_entries: int = 4,
                       refine_threshold: float = 0.02) -> dict[str, float]:
        """`--job=checkgrad` (ref: Trainer::checkGradient): central
        differences of the TEST loss against its analytic gradient at
        `max_entries` sampled entries of every trainable parameter; returns
        each parameter's worst relative error.  Mixed precision is off
        for the check (a difference of 1e-3 is below bfloat16's
        resolution), so on the card the float32 kernels run.  On the CPU
        the parameters the float32 screen flags above `refine_threshold`
        are checked again in float64, with kink detection; on the card
        the float32 screen is the whole verdict (float64 would leave the
        kernels for their plain versions)."""
        batch = self.prepare_batch(batch)
        errors = self._checkgrad_pass(batch, epsilon, max_entries, f64=False)
        if self.device.type == "cpu":
            flagged = [n for n, e in errors.items() if e > refine_threshold]
            if flagged:
                log.info("checkgrad: re-adjudicating %d flagged parameters "
                         "in float64: %s", len(flagged), flagged)
                errors.update(self._checkgrad_pass(
                    batch, epsilon, max_entries, f64=True, names=flagged,
                    detect_kinks=True))
        return errors

    def _checkgrad_pass(self, batch: Batch, epsilon: float,
                        max_entries: int, f64: bool, names=None,
                        detect_kinks: bool = False) -> dict[str, float]:
        saved = self.executor.compute_dtype
        self.executor.compute_dtype = ""
        try:
            if f64:
                params = {k: _f64(v) for k, v in self.params.items()}
                batch = {n: a.replace(value=_f64(a.value),
                                      sparse_vals=_f64(a.sparse_vals))
                         for n, a in batch.items()}
                state = _map_tree(_f64, self.net_state)
            else:
                params, state = self.params, self.net_state

            def loss_fn(p):
                with self._cudnn():
                    return float(self.executor.loss(p, batch, state,
                                                    TEST)[0])

            leaves = {n: (p.detach() if n in self._static
                          else p.detach().requires_grad_(True))
                      for n, p in params.items()}
            trained = [n for n in leaves if n not in self._static]
            with self._cudnn():
                loss = self.executor.loss(leaves, batch, state, TEST,
                                          differentiable=True)[0]
            got = torch.autograd.grad(loss, [leaves[n] for n in trained],
                                      allow_unused=True)
            grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                     for n, g in zip(trained, got)}
            return self._check_gradient_inner(loss_fn, grads, epsilon,
                                              max_entries, params, names,
                                              detect_kinks)
        finally:
            self.executor.compute_dtype = saved

    def _check_gradient_inner(self, loss_fn, grads: dict, epsilon: float,
                              max_entries: int, params: dict, names=None,
                              detect_kinks: bool = False) -> dict[str, float]:
        """The reference's comparison: the same entries sampled (one numpy
        generator seeded 0, drawn for every parameter in order), the
        noise-aware denominator max(|numeric|, |analytic|, 100 x the loss's
        rounding noise / 2h, 1e-8), and under `detect_kinks` an entry whose
        one-sided differences disagree retried at h / 100, then skipped."""
        errors: dict[str, float] = {}
        nrng = np.random.default_rng(0)
        L0 = loss_fn(params) if detect_kinks else 0.0
        for name, w in params.items():
            if name in self._static:
                continue
            size = w.numel()
            if names is not None and name not in names:
                # the same draws whether or not the parameter is checked
                nrng.choice(max(size, 1), size=min(max_entries, size),
                            replace=False)
                continue
            flat = _host(w).reshape(-1)
            gflat = _host(grads[name]).reshape(-1)
            idxs = nrng.choice(flat.size, size=min(max_entries, flat.size),
                               replace=False)
            worst = 0.0
            n_validated = n_kink = 0
            for i in idxs:
                eps_i = epsilon

                def fd_sides(h):
                    out = []
                    for sign in (+1, -1):
                        pert = flat.copy()
                        pert[i] += sign * h
                        p2 = dict(params)
                        p2[name] = torch.from_numpy(
                            pert.reshape(tuple(w.shape))).to(
                            device=w.device, dtype=w.dtype)
                        out.append(loss_fn(p2))
                    return out

                def kinked(sd, h):
                    fwd, bwd = (sd[0] - L0) / h, (L0 - sd[1]) / h
                    return abs(fwd - bwd) > 0.1 * max(
                        abs(fwd), abs(bwd), 1e-12), fwd, bwd

                sides = fd_sides(eps_i)
                if detect_kinks:
                    bad, fwd, bwd = kinked(sides, eps_i)
                    if bad:
                        eps_i = epsilon / 100.0
                        sides = fd_sides(eps_i)
                        bad, fwd, bwd = kinked(sides, eps_i)
                    if bad:
                        n_kink += 1
                        log.info("checkgrad %s[%d]: straddles a non-smooth "
                                 "point even at h=%.1e (one-sided fwd %.3e "
                                 "vs bwd %.3e) — entry skipped", name, i,
                                 eps_i, fwd, bwd)
                        continue
                numeric = (sides[0] - sides[1]) / (2 * eps_i)
                n_validated += 1
                # below the loss's own rounding noise a central difference
                # carries no signal: the denominator is clamped there
                noise = (abs(sides[0]) + abs(sides[1])) * \
                    float(np.finfo(flat.dtype).eps) / (2 * eps_i)
                denom = max(abs(numeric), abs(gflat[i]), 100.0 * noise,
                            1e-8)
                worst = max(worst, abs(numeric - gflat[i]) / denom)
            if detect_kinks and n_validated == 0 and n_kink > 0:
                # nothing adjudicated: the screen's flagged error stands
                log.warning("checkgrad %s: 0 of %d sampled entries "
                            "validated (all straddle non-smooth points) — "
                            "inconclusive; the fp32 screen's flagged error "
                            "stands for this parameter", name, n_kink)
                continue
            errors[name] = worst
            log.info("checkgrad %s: max_rel_err=%.3e", name, worst)
        return errors

    def benchmark(self, batches: Iterable[Batch], warmup: int = 3,
                  iters: int = 30, scan: bool = False) -> dict:
        """`--job=time` (ref: TrainerBenchmark.cpp): `warmup` steps, then
        `iters` timed ones.  By default each timed batch is moved to the
        device and its step dispatched with no host wait, and the host
        waits once, on the losses, at the end.  `scan=True` stages the
        timed batches on the device first and runs them as one fused
        group (on the card one replay of a CUDA graph of the `iters`
        steps, captured by an untimed run of the same group), the
        production path of `train_one_pass(steps_per_dispatch=k)`.  Every
        timed loss is checked finite after the final wait."""
        batch_list = list(itertools.islice(iter(batches), warmup + iters))
        for b in batch_list[:warmup]:
            self._run_step(self.prepare_batch(b))
        timed = batch_list[warmup:]
        if not timed:
            raise ValueError("benchmark needs at least one timed batch")
        n_samples = sum(_batch_size(b) for b in timed)
        if scan:
            group = [(self.prepare_batch(b), None) for b in timed]
            sig = self._batch_signature(*group[0])
            if any(self._batch_signature(*g) != sig for g in group):
                raise ValueError("benchmark(scan=True) runs one group: its "
                                 "batches need one signature")
            if self._settled.get(sig) != _layout(self.net_state):
                self._run_step(*group[0])
                self._settled[sig] = _layout(self.net_state)
            self._dispatch_fused(sig, group)
            self._sync()
            t0 = time.time()
            losses = self._dispatch_fused(sig, group)
        else:
            self._sync()
            t0 = time.time()
            losses = torch.stack([self._run_step(self.prepare_batch(b))
                                  for b in timed])
        lo = losses.float().cpu().numpy()
        dt = time.time() - t0
        self._loss_buf.clear()
        self._host_buf.clear()
        if not np.isfinite(lo).all():
            raise FloatingPointError(
                f"non-finite loss at bench step "
                f"{int(np.flatnonzero(~np.isfinite(lo))[0])}")
        return {"seconds": dt, "samples": n_samples,
                "samples_per_sec": n_samples / dt if dt else 0.0,
                "batches": len(timed)}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- checkpoints ----------------------------------------------------
    def save(self, save_dir: str, keep_last: int = 0) -> str:
        """Write the pass directory of the last completed pass (pass-init
        before the first) in the JAX package's layout."""
        return ckpt.save_checkpoint(
            save_dir, self.pass_id - 1, self.params, self.opt_state,
            self.net_state, config_json=self.config.to_json(),
            keep_last=keep_last, rng=self.rng,
            dropout_rng=self.dropout_rng.get_state())

    def load(self, path: str) -> None:
        """Load parameters, optimizer state, layer state and pass numbering
        from a checkpoint either side wrote; optimizer leaves whose shape
        differs from this model's keep their initial value."""
        data = ckpt.load_checkpoint(path)
        loaded = data["params"]
        for name in self.params:
            if name not in loaded:
                raise KeyError(f"checkpoint missing parameter {name!r}")
            self.params[name] = torch.as_tensor(
                loaded[name], device=self.device).to(self.params[name].dtype)
        # the pruning masks again, from the loaded values (the reference
        # reloads its mask file with --init_model_path too)
        self.params = self.updater.apply_init_hooks(self.params)
        if data.get("opt"):
            self.opt_state = _merge_state(
                self.updater.init_state(self.params), data["opt"],
                self.device)
        if data.get("net"):
            self.net_state = _tensor_tree(data["net"], self.device)
        if data.get("rng") is not None:
            self.rng = data["rng"]
        state = data.get("dropout_rng")
        if state is not None and (
                state.size == self.dropout_rng.get_state().numel()):
            # a generator's state is its device kind's own: a checkpoint
            # from the other kind keeps this trainer's seeded stream
            self.dropout_rng.set_state(torch.from_numpy(state.copy()))
        if "pass_id" in data:
            self.pass_id = data["pass_id"] + 1


def _merge_state(template, loaded, device: torch.device):
    """The optimizer-state template with loaded leaves where the shapes
    match; host counters come back as Python ints."""
    if isinstance(template, dict):
        return {k: (_merge_state(v, loaded[k], device)
                    if isinstance(loaded, dict) and k in loaded else v)
                for k, v in template.items()}
    arr = np.asarray(loaded)
    if isinstance(template, int):
        return int(arr) if arr.shape == () else template
    if tuple(arr.shape) != tuple(template.shape):
        return template
    return torch.as_tensor(arr, device=device).to(template.dtype)


class _CapturedSteps:
    """A group's j training steps of one signature captured into one CUDA
    graph: each step's feed and mask tensors (a replay's batches are copied
    into them), the j losses, each step's evaluator partials and the
    outputs the host evaluators read."""

    def __init__(self, trainer: Trainer, group: list):
        def own(t):
            return None if t is None else t.clone()
        self.feeds = [{name: Argument(value=own(a.value), ids=own(a.ids),
                                      lengths=own(a.lengths),
                                      sub_lengths=own(a.sub_lengths),
                                      sparse_vals=own(a.sparse_vals),
                                      sparse_dim=a.sparse_dim)
                       for name, a in batch.items()} for batch, _ in group]
        self.masks = [None if m is None else {n: v.clone()
                                              for n, v in m.items()}
                      for _, m in group]
        self.graph = StepGraph(trainer._pool, [trainer.dropout_rng])
        # the trainer's tensors the graph reads and writes in place: kept
        # alive here (a graph writing a freed tensor corrupts whatever the
        # allocator puts there next), and a trainer that replaced one
        # (load(), a new parameter) gets a new capture
        self.state = _state_tensors(trainer)

        def steps():
            out = [trainer._step(f, m) for f, m in zip(self.feeds,
                                                      self.masks)]
            return (torch.stack([o[0] for o in out]), [o[1] for o in out],
                    [o[2] for o in out])

        self.losses, self.partials, self.host_outs = self.graph.capture(
            steps)

    def holds(self, trainer: Trainer) -> bool:
        """Whether the trainer still updates the tensors captured here."""
        now = _state_tensors(trainer)
        return len(now) == len(self.state) and all(
            a is b for a, b in zip(now, self.state))

    def load(self, group: list) -> None:
        for feed, step_masks, (batch, masks) in zip(self.feeds, self.masks,
                                                    group):
            for name, a in batch.items():
                mine = feed[name]
                for dst, src in ((mine.value, a.value), (mine.ids, a.ids),
                                 (mine.lengths, a.lengths),
                                 (mine.sub_lengths, a.sub_lengths),
                                 (mine.sparse_vals, a.sparse_vals)):
                    if dst is not None:
                        dst.copy_(src)
            for n, m in (masks or {}).items():
                step_masks[n].copy_(m)


def _detached(outputs: dict[str, Argument]) -> dict[str, Argument]:
    """Outputs without their autograd history (a queued one would keep its
    step's graph alive)."""
    def d(t):
        return None if t is None else t.detach()
    return {n: a.replace(value=d(a.value), ids=d(a.ids),
                         lengths=d(a.lengths), sub_lengths=d(a.sub_lengths))
            for n, a in outputs.items()}


def _cloned(arg: Argument) -> Argument:
    """An Argument's tensors copied (on their device)."""
    def c(t):
        return None if t is None else t.clone()
    return arg.replace(value=c(arg.value), ids=c(arg.ids),
                       lengths=c(arg.lengths),
                       sub_lengths=c(arg.sub_lengths))


def _next_masks(masks) -> Optional[dict]:
    """The next batch's dropout masks from train_one_pass's iterator over
    `dropout_masks` (None without one)."""
    if masks is None:
        return None
    m = next(masks, masks)
    if m is masks:
        raise ValueError("dropout_masks has fewer entries than batches")
    return m


def _state_tensors(trainer: Trainer) -> list:
    """The parameters, optimizer slots, updater counters, averages,
    accumulated gradients, pruning masks and layer state of a trainer, in a
    fixed order."""
    opt = trainer.opt_state
    slots = opt["slots"]
    return ([trainer.updater._counters] + list(trainer.params.values())
            + [v for n in slots for v in slots[n].values()]
            + _leaves(opt.get("average", {}))
            + ([opt["average_count"]] if "average_count" in opt else [])
            + _leaves(opt.get("grad_accum", {}))
            + _leaves(opt.get("masks", {}))
            + _leaves(trainer.net_state))


def _leaves(tree) -> list:
    """The tensors of a state tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    return [tree]


def _layout(tree):
    """A state tree's keys, shapes and dtypes, comparable with ==."""
    if isinstance(tree, dict):
        return tuple((k, _layout(tree[k])) for k in sorted(tree))
    return tuple(tree.shape), tree.dtype


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif dst is not src:
        dst.copy_(src)


def _own_copy(tree):
    if isinstance(tree, dict):
        return {k: _own_copy(v) for k, v in tree.items()}
    return tree.detach().clone()


def _tensor_tree(tree, device: torch.device):
    """A loaded state tree's arrays as tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host array (bfloat16 as float32)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _f64(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A floating tensor in float64 (others as they are)."""
    if t is None or not t.is_floating_point():
        return t
    return t.detach().double()


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _spec(t) -> Optional[tuple]:
    """Shape and dtype of a feed's array or tensor (None for none)."""
    return None if t is None else (tuple(t.shape), str(t.dtype))


def _tensors(batch: Batch, masks: Optional[dict]) -> list:
    """The tensors of a prepared batch and its masks."""
    out = [t for a in batch.values()
           for t in (a.value, a.ids, a.lengths, a.sub_lengths, a.sparse_vals)
           if t is not None]
    return out + list((masks or {}).values())


def _fmt(stats: dict) -> str:
    parts = []
    for k, v in stats.items():
        if isinstance(v, float):
            parts.append(f"{k}={v:.5g}")
        elif isinstance(v, (int, np.integer)):
            parts.append(f"{k}={v}")
    return " ".join(parts)


def _batch_size(batch: Batch) -> int:
    for arg in batch.values():
        return int(arg.data.shape[0])
    return 0
