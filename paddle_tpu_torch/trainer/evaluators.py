"""Evaluators — the counterpart of paddle_tpu/trainer/evaluators.py.

Device evaluators give per-batch partial sums computed in the training
step: `classification_error` (the evaluator `classification_cost`
attaches), `sum` and `column_sum`.  The partials stay on the tensors'
device and accumulate there in float64, so a training step needs no host
read for them; `finalize` reads them once.

Host evaluators run a sequential algorithm on host copies of the layers
they read, once per batch: `chunk` (segment F1 over IOB, IOE, IOBES or
plain tags, with `excluded_chunk_types`).  The trainer hands them each
step's outputs of those layers (`host_layer_names`); `host_update` copies
them to the host.  The other evaluators of the JAX package (auc,
precision_recall, pnpair, rankauc, seq_classification_error, the CTC
edit distance and the printers) are queued in ROADMAP.md, and a model
that configures one raises.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
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


def _sum_batch(cfg: EvaluatorConfig, outputs: dict[str, Argument],
               feed: dict[str, Argument]) -> dict[str, torch.Tensor]:
    """The sum of the input's values (or ids) over the valid steps, and
    the number of rows."""
    out = outputs[cfg.input_layer_names[0]]
    v = out.data.float()
    if out.is_sequence:
        mask = out.mask(torch.float32)
        v = v * (mask[..., None] if v.dim() == 3 else mask)
    return {"sum": torch.sum(v),
            "n": torch.full((), float(v.shape[0]), device=v.device)}


def _sum_final(cfg: EvaluatorConfig, acc: dict) -> dict:
    return {"sum": acc["sum"], "mean": acc["sum"] / max(acc["n"], 1.0)}


evaluator_registry["sum"] = (_sum_batch, _sum_final)


def _colsum_batch(cfg: EvaluatorConfig, outputs: dict[str, Argument],
                  feed: dict[str, Argument]) -> dict[str, torch.Tensor]:
    """Each column's sum over the rows (and a sequence's valid steps)."""
    out = outputs[cfg.input_layer_names[0]]
    v = out.value
    if out.is_sequence:
        v = torch.sum(v * out.mask(torch.float32)[..., None], dim=1)
    return {"colsum": torch.sum(v, dim=0),
            "n": torch.full((), float(v.shape[0]), device=v.device)}


def _colsum_final(cfg: EvaluatorConfig, acc: dict) -> dict:
    return {"column_sum_mean": acc["colsum"] / max(acc["n"], 1.0)}


evaluator_registry["column_sum"] = (_colsum_batch, _colsum_final)


# -- host evaluators: type -> (new_state_fn() -> state,
#    batch_fn(cfg, args: list[Argument of numpy arrays], state) -> None,
#    finalize_fn(cfg, state) -> dict)
host_evaluator_registry: dict[str, tuple[Callable, Callable, Callable]] = {}


def _np_arg(arg: Argument) -> Argument:
    """A host (numpy) copy of an Argument's arrays."""
    def host(t):
        return None if t is None else t.detach().cpu().numpy()
    return Argument(value=host(arg.value), ids=host(arg.ids),
                    lengths=host(arg.lengths))


def _seq_rows(arg: Argument):
    """(row data, length) per row of a host Argument: a sequence's valid
    prefix, a row of a non-sequence, or one value as a length-1 row."""
    lengths = arg.lengths
    data = arg.value if arg.value is not None else arg.ids
    for b in range(data.shape[0]):
        if lengths is not None:
            L = int(lengths[b])
            yield data[b, :L], L
        elif data.ndim >= 2:
            yield data[b], data.shape[1]
        else:
            yield data[b:b + 1], 1


# scheme -> (tag kinds, begin, inside, end, single); -1 = the scheme has
# no such tag
_CHUNK_SCHEMES = {
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_segments(labels: np.ndarray, scheme: str,
                    num_chunk_types: int) -> list:
    """The (begin, end, type) chunks of one row of label ids: a label is
    type * kinds + tag, type num_chunk_types the outside ("O") label."""
    n_tag, t_begin, t_inside, t_end, t_single = _CHUNK_SCHEMES[scheme]
    other = num_chunk_types

    def is_end(ptag, ptyp, tag, typ):
        if ptyp == other:
            return False
        if typ == other or typ != ptyp:
            return True
        if ptag in (t_begin, t_inside):
            return tag in (t_begin, t_single)
        return ptag in (t_end, t_single)

    def is_begin(ptag, ptyp, tag, typ):
        if ptyp == other:
            return typ != other
        if typ == other:
            return False
        if typ != ptyp or tag in (t_begin, t_single):
            return True
        if tag in (t_inside, t_end):
            return ptag in (t_end, t_single)
        return False

    segments = []
    in_chunk, start = False, 0
    tag, typ = -1, other
    for i, lab in enumerate(labels):
        ptag, ptyp = tag, typ
        tag, typ = int(lab) % n_tag, int(lab) // n_tag
        if in_chunk and is_end(ptag, ptyp, tag, typ):
            segments.append((start, i - 1, ptyp))
            in_chunk = False
        if is_begin(ptag, ptyp, tag, typ):
            start, in_chunk = i, True
    if in_chunk:
        segments.append((start, len(labels) - 1, typ))
    return segments


def _chunk_state() -> dict:
    return {"label_segs": 0, "out_segs": 0, "correct": 0}


def _chunk_batch(cfg: EvaluatorConfig, args: list, state: dict) -> None:
    """Counts the chunks of the output rows, of the label rows, and the
    chunks both have."""
    out, lbl = args[0], args[1]
    excluded = set(cfg.excluded_chunk_types or [])
    for (o, _), (l, _) in zip(_seq_rows(out), _seq_rows(lbl)):
        segs_o = _chunk_segments(o.reshape(-1), cfg.chunk_scheme,
                                 cfg.num_chunk_types)
        segs_l = _chunk_segments(l.reshape(-1), cfg.chunk_scheme,
                                 cfg.num_chunk_types)
        if excluded:
            segs_o = [g for g in segs_o if g[2] not in excluded]
            segs_l = [g for g in segs_l if g[2] not in excluded]
        state["correct"] += len(set(segs_o) & set(segs_l))
        state["out_segs"] += len(segs_o)
        state["label_segs"] += len(segs_l)


def _chunk_final(cfg: EvaluatorConfig, state: dict) -> dict:
    prec = state["correct"] / max(state["out_segs"], 1)
    rec = state["correct"] / max(state["label_segs"], 1)
    f1 = 0.0 if not state["correct"] else 2 * prec * rec / (prec + rec)
    return {"chunk_f1": f1, "true_chunks": state["label_segs"],
            "result_chunks": state["out_segs"],
            "correct_chunks": state["correct"]}


host_evaluator_registry["chunk"] = (_chunk_state, _chunk_batch,
                                    _chunk_final)


class EvaluatorSet:
    """Accumulates the model's evaluators across batches: the device ones'
    partial sums, the host ones' states."""

    def __init__(self, model: ModelConfig):
        unported = sorted({e.type for e in model.evaluators
                           if e.type not in evaluator_registry
                           and e.type not in host_evaluator_registry})
        if unported:
            raise NotImplementedError(
                f"evaluators {unported} are not ported yet (ROADMAP.md); "
                f"ported: {sorted(evaluator_registry)} and, on the host, "
                f"{sorted(host_evaluator_registry)}")
        self.configs = [e for e in model.evaluators
                        if e.type in evaluator_registry]
        self.host_configs = [e for e in model.evaluators
                             if e.type in host_evaluator_registry]

    @property
    def host_layer_names(self) -> list[str]:
        """The layers whose outputs the host evaluators read each batch."""
        names: list[str] = []
        for cfg in self.host_configs:
            for n in cfg.input_layer_names:
                if n not in names:
                    names.append(n)
        return names

    def host_outputs(self, outputs: dict[str, Argument]
                     ) -> dict[str, Argument]:
        """The outputs the host evaluators read, as rows (still on the
        device)."""
        return {n: outputs[n].flatten_image() for n in self.host_layer_names
                if n in outputs}

    def new_host_state(self) -> dict:
        return {cfg.name: host_evaluator_registry[cfg.type][0]()
                for cfg in self.host_configs}

    def host_update(self, state: dict, outputs: dict[str, Argument]) -> None:
        """Feed one batch's outputs (host_outputs) to every host evaluator:
        one host copy of each layer read."""
        cache = {n: _np_arg(a) for n, a in outputs.items()}
        for cfg in self.host_configs:
            missing = [n for n in cfg.input_layer_names if n not in cache]
            if missing:
                raise KeyError(f"host evaluator {cfg.name!r} ({cfg.type}) "
                               f"references {missing} absent from the step "
                               f"outputs")
            host_evaluator_registry[cfg.type][1](
                cfg, [cache[n] for n in cfg.input_layer_names],
                state[cfg.name])

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

    @property
    def _many(self) -> bool:
        return len(self.configs) + len(self.host_configs) > 1

    def finalize(self, acc: dict) -> dict:
        """One host read of the accumulated sums; keys are the result names,
        prefixed by the evaluator's name when there are several.  A result
        of one value is a float, a column_sum result an array."""
        out: dict = {}
        for cfg in self.configs:
            if cfg.name not in acc:
                continue
            host = {k: v.cpu().numpy() for k, v in acc[cfg.name].items()}
            host = {k: float(v) if v.size == 1 else v
                    for k, v in host.items()}
            for k, v in evaluator_registry[cfg.type][1](cfg, host).items():
                v = np.asarray(v)
                out[f"{cfg.name}.{k}" if self._many else k] = \
                    float(v) if v.size == 1 else v
        return out

    def finalize_host(self, state: dict) -> dict[str, float]:
        out: dict[str, float] = {}
        for cfg in self.host_configs:
            for k, v in host_evaluator_registry[cfg.type][2](
                    cfg, state[cfg.name]).items():
                out[f"{cfg.name}.{k}" if self._many else k] = float(v)
        return out
