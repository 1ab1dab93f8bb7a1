"""Trainer — the port's counterpart of paddle_tpu/trainer/trainer.py for the
per-batch training loop.

One step (`train_one_batch`) is the JAX side's jitted train step done
eagerly: the TRAIN forward and `GraphExecutor.loss`, `torch.autograd.grad`
for every trainable parameter, `ParameterUpdater.step`, and the
evaluators' partial sums.  Losses stay on the device and are checked for
finiteness in bulk every `nonfinite_check_period` batches
(`_drain_losses`), so the host does not wait for the device on every step.
`test()` runs the TEST forward; `save`/`load` write and read the JAX
package's checkpoint layout, so either side resumes the other's run.

Not ported yet, and refused (ROADMAP.md): the data provider and feeder
(pass `batches=`), fused dispatch (`steps_per_dispatch > 1`), meshes,
pipeline stages, the parameter server, gradient probes and the evaluators
other than classification_error.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Optional

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

Batch = dict[str, Argument]


def _as_tensor(x, device: torch.device) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, device=device)


class Trainer:
    """Trains one TrainerConfig on one device (the CUDA card unless
    `device="cpu"`).  `params` takes starting parameters (for example
    `params_from_jax(...)` output); without it they come from
    `init_params(model, seed)`."""

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
        self.params = {n: params[n].to(self.device)
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

    def train_one_batch(self, batch: Batch,
                        dropout_masks: Optional[dict] = None
                        ) -> torch.Tensor:
        """One optimizer step on one batch.  Returns the loss as a device
        scalar (no host read); non-finite losses raise at the next bulk
        check."""
        batch = self.prepare_batch(batch)
        loss, grads, outputs = self.compute_gradients(batch, dropout_masks)
        self.params, self.opt_state = self.updater.step(
            self.params, grads, self.opt_state, _batch_size(batch))
        with torch.no_grad():
            self._acc = self.evaluators.accumulate(
                self._acc, self.evaluators.batch_partials(outputs, batch))
        self._loss_buf.append(loss)
        if len(self._loss_buf) >= max(int(self.nonfinite_check_period), 1):
            self._drained_cost += self._drain_losses()
        return loss

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
                       steps_per_dispatch: Optional[int] = None
                       ) -> dict[str, float]:
        """Train on every batch of `batches`; returns the pass statistics
        (cost = mean loss, the evaluators, batches, samples, seconds,
        samples_per_sec)."""
        if batches is None:
            raise NotImplementedError(
                "the data provider / feeder is not ported yet (ROADMAP.md): "
                "pass batches=")
        if steps_per_dispatch is not None and int(steps_per_dispatch) > 1:
            raise NotImplementedError("fused dispatch (steps_per_dispatch > "
                                      "1) is not ported yet (ROADMAP.md)")
        t0 = time.time()
        self._acc = {}
        self._loss_buf.clear()
        self._drained_cost = 0.0
        n_batches = n_samples = 0
        for batch in batches:
            self.train_one_batch(batch)
            n_batches += 1
            n_samples += _batch_size(batch)
        self._drained_cost += self._drain_losses()
        self.opt_state = self.updater.finish_pass(self.opt_state)
        stats = self.evaluators.finalize(self._acc)
        dt = time.time() - t0
        stats.update(cost=self._drained_cost / max(n_batches, 1),
                     batches=n_batches, samples=n_samples, seconds=dt,
                     samples_per_sec=n_samples / dt if dt > 0 else 0.0)
        self.pass_id += 1
        return stats

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


def _batch_size(batch: Batch) -> int:
    for arg in batch.values():
        return int(arg.data.shape[0])
    return 0
