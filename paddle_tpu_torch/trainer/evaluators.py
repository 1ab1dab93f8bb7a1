"""Evaluators — the counterpart of paddle_tpu/trainer/evaluators.py for the
training slice: `classification_error` (the evaluator `classification_cost`
attaches), its per-batch partial sums and their float64 accumulation.

The partials stay on the tensors' device and accumulate there in float64,
so a training step needs no host read for them; `finalize` reads them once.
The other evaluators of the JAX package are queued in ROADMAP.md, and a
model that configures one raises.
"""

from __future__ import annotations

from typing import Callable

import torch

from paddle_tpu_torch.config.schema import EvaluatorConfig, ModelConfig
from paddle_tpu_torch.parameter.argument import Argument

# type -> (batch_fn(cfg, outputs, feed) -> dict of partial sums,
#          finalize_fn(cfg, accumulated floats) -> dict of floats)
evaluator_registry: dict[str, tuple[Callable, Callable]] = {}


def _cls_err_batch(cfg: EvaluatorConfig, outputs: dict[str, Argument],
                   feed: dict[str, Argument]) -> dict[str, torch.Tensor]:
    out = outputs[cfg.input_layer_names[0]]
    lbl = outputs[cfg.input_layer_names[1]]
    pred = out.value
    if pred.shape[-1] == 1:
        err = ((pred[..., 0] > cfg.classification_threshold).float()
               != lbl.ids.float()).float()
    else:
        err = (torch.argmax(pred, dim=-1) != lbl.ids).float()
    if out.is_sequence:
        mask = out.mask(torch.float32)
        return {"err": torch.sum(err * mask), "n": torch.sum(mask)}
    return {"err": torch.sum(err),
            "n": torch.full((), float(err.numel()), device=err.device)}


def _cls_err_final(cfg: EvaluatorConfig, acc: dict) -> dict:
    return {"classification_error": acc["err"] / max(acc["n"], 1.0)}


evaluator_registry["classification_error"] = (_cls_err_batch, _cls_err_final)


class EvaluatorSet:
    """Accumulates the model's evaluators across batches."""

    def __init__(self, model: ModelConfig):
        unported = sorted({e.type for e in model.evaluators
                           if e.type not in evaluator_registry})
        if unported:
            raise NotImplementedError(
                f"evaluators {unported} are not ported yet (ROADMAP.md); "
                f"ported: {sorted(evaluator_registry)}")
        self.configs = list(model.evaluators)

    def batch_partials(self, outputs: dict[str, Argument],
                       feed: dict[str, Argument]) -> dict[str, dict]:
        res = {}
        for cfg in self.configs:
            missing = [n for n in cfg.input_layer_names if n not in outputs]
            if missing:
                raise KeyError(f"evaluator {cfg.name!r} ({cfg.type}) "
                               f"references layer(s) {missing} absent from "
                               f"the forward outputs")
            res[cfg.name] = evaluator_registry[cfg.type][0](cfg, outputs,
                                                            feed)
        return res

    def accumulate(self, acc: dict, partials: dict) -> dict:
        """Add one batch's partials in float64, on their device.  The sums
        never alias a partial: a captured training step writes its partials
        into the same output tensors on every replay."""
        for name, parts in partials.items():
            slot = acc.setdefault(name, {})
            for k, v in parts.items():
                v = v.detach().to(torch.float64, copy=True)
                slot[k] = v if k not in slot else slot[k] + v
        return acc

    def finalize(self, acc: dict) -> dict[str, float]:
        """One host read of the accumulated sums; keys are the result names,
        prefixed by the evaluator's name when there are several."""
        out: dict[str, float] = {}
        many = len(self.configs) > 1
        for cfg in self.configs:
            if cfg.name not in acc:
                continue
            host = {k: float(v) for k, v in acc[cfg.name].items()}
            for k, v in evaluator_registry[cfg.type][1](cfg, host).items():
                out[f"{cfg.name}.{k}" if many else k] = float(v)
        return out
