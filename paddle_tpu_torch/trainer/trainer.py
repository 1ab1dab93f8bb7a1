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
evaluator sums and the dropout generator end where k = 1 leaves them, bit
for bit.

Updates write into the trainer's tensors in place (a graph replays into
the addresses it captured): `Trainer.params` and the optimizer slots are
the same tensors for a trainer's life, and whoever keeps one sees it
change.  Take a snapshot with `clone()` or `.to(device, copy=True)`.

`test()` runs the TEST forward; `save`/`load` write and read the JAX
package's checkpoint layout, so either side resumes the other's run.

Not ported yet, and refused (ROADMAP.md): the data provider and feeder
(pass `batches=`; with it the reference's staging of the next group on a
thread), meshes, pipeline stages, the parameter server, gradient probes and
the evaluators other than classification_error.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.config.schema import TrainerConfig
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.graph.builder import GraphExecutor
from paddle_tpu_torch.graph.context import TEST, TRAIN
from paddle_tpu_torch.optim.updater import ParameterUpdater
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.parameter.init import init_params
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.evaluators import EvaluatorSet
from paddle_tpu_torch.utils.cuda_graphs import StepGraph, new_pool

Batch = dict[str, Argument]


def _as_tensor(x, device: torch.device) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, device=device)


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

    def __init__(self, config: TrainerConfig, seed: int = 1,
                 device: DeviceLike = None,
                 params: Optional[dict[str, torch.Tensor]] = None):
        if config.model_config is None or config.opt_config is None:
            raise ValueError("TrainerConfig needs model_config and opt_config")
        self.device = resolve_device(device)
        self.config = config
        self.model = config.model_config
        self.opt = config.opt_config
        staged = [l.name for l in self.model.layers if l.device >= 0]
        if staged:
            raise NotImplementedError(
                f"layers {staged} carry pipeline-stage annotations; pipeline "
                f"training is not ported yet (ROADMAP.md)")
        self.executor = GraphExecutor(self.model,
                                      compute_dtype=self.opt.compute_dtype)
        self.updater = ParameterUpdater(self.model, self.opt)
        self.evaluators = EvaluatorSet(self.model)
        if params is None:
            params = init_params(self.model, seed=seed, device=self.device)
        missing = sorted({p.name for p in self.model.parameters} - set(params))
        if missing:
            raise KeyError(f"params lack {missing}")
        # own copies: the updates write into them in place
        self.params = {n: params[n].to(self.device, copy=True)
                       for n in (p.name for p in self.model.parameters)}
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
        self._loss_buf: list[torch.Tensor] = []
        self._drained_cost = 0.0
        # the fused dispatch: signatures whose first batch ran eagerly, and
        # the captured steps by (signature, group size) (the card only)
        self._settled: set = set()
        self._graphs: dict[tuple, _CapturedSteps] = {}
        self._pool = new_pool(self.device)
        self.n_fused_dispatches = 0     # groups dispatched
        self.n_settle_steps = 0         # eager first steps of a signature

    # -- one step -------------------------------------------------------
    def prepare_batch(self, batch: Batch) -> Batch:
        """Check the feed against the data layers (missing or unknown keys,
        ids out of range on host arrays, batch sizes) and move it to the
        device."""
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
            ids = arg.ids
            size = self._data_layers[name].size
            host = isinstance(ids, np.ndarray) or (
                isinstance(ids, torch.Tensor) and ids.device.type == "cpu")
            if ids is not None and host and size > 0 and len(ids):
                hi, lo = int(ids.max()), int(ids.min())
                if hi >= size or lo < 0:
                    raise ValueError(
                        f"feed {name!r}: id {hi if hi >= size else lo} out "
                        f"of range for data layer size {size}")
            ids = _as_tensor(ids, self.device)
            arg = Argument(value=_as_tensor(arg.value, self.device),
                           ids=None if ids is None else ids.long(),
                           lengths=_as_tensor(arg.lengths, self.device))
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
        loss, (outputs, _, new_net) = self.executor.loss(
            leaves, batch, self.net_state, TRAIN, self.dropout_rng,
            dropout_masks)
        names = [n for n in leaves if n not in self._static]
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        grads = {n: g for n, g in zip(names, grads) if g is not None}
        if new_net:
            self.net_state = new_net
        return loss.detach(), grads, outputs

    def _step(self, batch: Batch, dropout_masks: Optional[dict] = None):
        """The training step on a prepared batch, on the device and with no
        host read: forward, gradients, the in-place update (the updater's
        device counters advance), the evaluators' partials.  Returns (loss,
        partials).  `train_one_batch` runs it eagerly; the fused dispatch
        captures it."""
        loss, grads, outputs = self.compute_gradients(batch, dropout_masks)
        self.updater.apply(self.params, grads, self.opt_state["slots"],
                           _batch_size(batch))
        with torch.no_grad():
            partials = self.evaluators.batch_partials(outputs, batch)
        return loss, partials

    def _commit(self, loss: torch.Tensor, partials: dict,
                batch_size: int) -> None:
        """The host's part of a step: the counters, the evaluator sums (in
        arrival order), the loss into the bulk check."""
        self.opt_state = self.updater.advance(self.opt_state, batch_size)
        self._acc = self.evaluators.accumulate(self._acc, partials)
        self._loss_buf.append(loss)
        if len(self._loss_buf) >= max(int(self.nonfinite_check_period), 1):
            self._drained_cost += self._drain_losses()

    def _run_step(self, batch: Batch, dropout_masks: Optional[dict] = None
                  ) -> torch.Tensor:
        self.updater.load_counters(self.opt_state, self.device)
        loss, partials = self._step(batch, dropout_masks)
        self._commit(loss, partials, _batch_size(batch))
        return loss

    def train_one_batch(self, batch: Batch,
                        dropout_masks: Optional[dict] = None
                        ) -> torch.Tensor:
        """One optimizer step on one batch.  Returns the loss as a device
        scalar (no host read); non-finite losses raise at the next bulk
        check."""
        return self._run_step(self.prepare_batch(batch), dropout_masks)

    def _drain_losses(self) -> float:
        """One host read for all buffered losses: bulk finiteness check and
        their sum."""
        if not self._loss_buf:
            return 0.0
        losses = torch.stack(self._loss_buf).float().cpu().numpy()
        n = len(self._loss_buf)
        self._loss_buf.clear()
        if not np.isfinite(losses).all():
            bad = int(np.flatnonzero(~np.isfinite(losses))[0])
            raise FloatingPointError(
                f"non-finite loss {losses[bad]} ({n - bad - 1} batches "
                f"before the last dispatched)")
        return float(losses.sum())

    # -- passes ---------------------------------------------------------
    def train_one_pass(self, batches: Optional[Iterable[Batch]] = None,
                       steps_per_dispatch: Optional[int] = None,
                       dropout_masks: Optional[Sequence[dict]] = None
                       ) -> dict[str, float]:
        """Train on every batch of `batches`; returns the pass statistics
        (cost = mean loss, the evaluators, batches, samples, seconds,
        samples_per_sec).  `steps_per_dispatch=k > 1` runs the fused
        dispatch (module docstring), with results identical to k = 1.
        `dropout_masks` gives each batch's keep-masks by layer (one dict
        per batch) in place of draws from `dropout_rng`."""
        if batches is None:
            raise NotImplementedError(
                "the data provider / feeder is not ported yet (ROADMAP.md): "
                "pass batches=")
        k = 1 if steps_per_dispatch is None else int(steps_per_dispatch)
        if k < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
        t0 = time.time()
        self._acc = {}
        self._loss_buf.clear()
        self._drained_cost = 0.0
        masks = iter(dropout_masks) if dropout_masks is not None else None
        n_batches = n_samples = 0
        if k == 1:
            for batch in batches:
                self.train_one_batch(batch, _next_masks(masks))
                n_batches += 1
                n_samples += _batch_size(batch)
        else:
            for sig, group in self._host_groups(batches, masks, k):
                self._dispatch_fused(sig, group)
                n_batches += len(group)
                n_samples += sum(_batch_size(b) for b, _ in group)
        self._drained_cost += self._drain_losses()
        self.opt_state = self.updater.finish_pass(self.opt_state)
        stats = self.evaluators.finalize(self._acc)
        dt = time.time() - t0
        stats.update(cost=self._drained_cost / max(n_batches, 1),
                     batches=n_batches, samples=n_samples, seconds=dt,
                     samples_per_sec=n_samples / dt if dt > 0 else 0.0)
        self.pass_id += 1
        return stats

    # -- fused k-step dispatch ------------------------------------------
    def _batch_signature(self, batch: Batch,
                         dropout_masks: Optional[dict] = None) -> tuple:
        """Shapes and dtypes of every feed of a prepared batch and of its
        fed dropout masks, plus the net_state structure: the key of a
        captured step."""
        def spec(t):
            return None if t is None else (tuple(t.shape), str(t.dtype))
        feeds = tuple(sorted((name, spec(a.value), spec(a.ids),
                              spec(a.lengths)) for name, a in batch.items()))
        masks = tuple(sorted((name, spec(m))
                             for name, m in (dropout_masks or {}).items()))
        return feeds, masks, _structure(self.net_state)

    def _host_groups(self, batches: Iterable[Batch], masks, k: int):
        """(signature, [(prepared batch, masks), ...]) groups of at most k
        consecutive same-signature batches, in arrival order."""
        pending: list = []
        sig = None
        for batch in batches:
            m = _next_masks(masks)
            if m is not None:
                m = {n: torch.as_tensor(v, device=self.device)
                     for n, v in m.items()}
            batch = self.prepare_batch(batch)
            s = self._batch_signature(batch, m)
            if pending and (s != sig or len(pending) == k):
                yield sig, pending
                pending = []
            sig = s
            pending.append((batch, m))
        if pending:
            yield sig, pending

    def _dispatch_fused(self, sig: tuple, group: list) -> None:
        """One group: on the CPU the step once per batch, uncaptured; on the
        card one replay of the graph of len(group) steps of the signature,
        after the eager first step of a signature never seen."""
        self.n_fused_dispatches += 1
        if self.device.type != "cuda":
            for batch, masks in group:
                self._run_step(batch, masks)
            return
        if sig not in self._settled:
            self._run_step(*group[0])
            self._settled.add(sig)
            self.n_settle_steps += 1
            group = group[1:]
            if not group:
                return
        self.updater.load_counters(self.opt_state, self.device)
        key = (sig, len(group))
        steps = self._graphs.get(key)
        if steps is None or not steps.holds(self):
            steps = self._graphs[key] = _CapturedSteps(self, group)
        steps.load(group)
        steps.graph.replay()
        # read before any other replay: the graphs share one memory pool
        losses = steps.losses.clone()
        for i, (batch, _) in enumerate(group):
            self._commit(losses[i], steps.partials[i], _batch_size(batch))

    @torch.no_grad()
    def test(self, batches: Iterable[Batch]) -> dict[str, float]:
        """The TEST-mode cost (sample-weighted mean of the batch losses) and
        the evaluators over `batches`."""
        acc: dict = {}
        total, n = 0.0, 0
        for batch in batches:
            batch = self.prepare_batch(batch)
            loss, (outputs, _, _) = self.executor.loss(
                self.params, batch, self.net_state, TEST)
            bsz = _batch_size(batch)
            total += float(loss) * bsz
            n += bsz
            acc = self.evaluators.accumulate(
                acc, self.evaluators.batch_partials(outputs, batch))
        stats = self.evaluators.finalize(acc)
        stats["cost"] = total / max(n, 1)
        return stats

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
        """Load parameters, optimizer state and pass numbering from a
        checkpoint either side wrote; optimizer leaves whose shape differs
        from this model's keep their initial value."""
        data = ckpt.load_checkpoint(path)
        loaded = data["params"]
        for name in self.params:
            if name not in loaded:
                raise KeyError(f"checkpoint missing parameter {name!r}")
            self.params[name] = torch.as_tensor(
                loaded[name], device=self.device).to(self.params[name].dtype)
        if data.get("opt"):
            self.opt_state = _merge_state(
                self.updater.init_state(self.params), data["opt"],
                self.device)
        if data.get("net"):
            self.net_state = data["net"]
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
    into them), the j losses and each step's evaluator partials."""

    def __init__(self, trainer: Trainer, group: list):
        def own(t):
            return None if t is None else t.clone()
        self.feeds = [{name: Argument(value=own(a.value), ids=own(a.ids),
                                      lengths=own(a.lengths))
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
        net = trainer.net_state

        def steps():
            out = [trainer._step(f, m) for f, m in zip(self.feeds,
                                                      self.masks)]
            return torch.stack([loss for loss, _ in out]), [p for _, p in out]

        self.losses, self.partials = self.graph.capture(steps)
        if trainer.net_state is not net:
            raise NotImplementedError(
                "a step that changes the net state (stateful layers) cannot "
                "be captured yet")

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
                                 (mine.lengths, a.lengths)):
                    if dst is not None:
                        dst.copy_(src)
            for n, m in (masks or {}).items():
                step_masks[n].copy_(m)


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
    """The parameters, optimizer slots and updater counters of a trainer,
    in a fixed order."""
    slots = trainer.opt_state["slots"]
    return ([trainer.updater._counters] + list(trainer.params.values())
            + [v for n in slots for v in slots[n].values()])


def _structure(tree) -> str:
    """The nesting of a state tree (its dict keys), without its values."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{_structure(v)}"
                              for k, v in sorted(tree.items())) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ",".join(_structure(v) for v in tree) + "]"
    return "*"


def _batch_size(batch: Batch) -> int:
    for arg in batch.values():
        return int(arg.data.shape[0])
    return 0
