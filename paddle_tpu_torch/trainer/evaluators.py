"""Evaluators — the counterpart of paddle_tpu/trainer/evaluators.py.

Device evaluators give per-batch partial sums computed in the training
step: `classification_error` (the evaluator `classification_cost`
attaches), `sum`, `column_sum`, `auc` / `last-column-auc` (two 1024-bin
histograms of the last output column by label, with an optional weight
input) and `precision_recall` (per-class true and false positives and
false negatives).  The partials stay on the tensors' device and accumulate
there in float64, so a training step needs no host read for them;
`finalize` reads them once.

The AUC histograms add each row's weight into its bin through a compare
against every bin and a sum over the rows, in float64: float32 weights sum
exactly there (whatever the order, for weights within 2^29 of each other),
so the card's histograms repeat bit for bit and equal the CPU's.  A
scatter-add on CUDA adds with atomics in no fixed order, and with weights
the float32 sums would differ in their last bits from run to run.  The
reference's float32 scatter-add rounds each add, so with non-dyadic
weights its histograms may differ from these in their last float32 bits.

Host evaluators run a sequential algorithm on host copies of the layers
they read, once per batch: `chunk` (segment F1 over IOB, IOE, IOBES or
plain tags, with `excluded_chunk_types`), `seq_classification_error`,
`ctc_edit_distance` (best path against the label by edit distance),
`pnpair` (concordant pairs within each query), `rankauc`, and the printers
`value_printer`, `max_id_printer`, `seq_text_printer`,
`classification_error_printer`, `max_frame_printer` and
`gradient_printer`.  The trainer hands them each step's outputs of those
layers (`host_layer_names`; for `gradient_printer` the `__grad__<layer>`
output gradients the trainer's probes give); `host_update` copies them to
the host.  The validation layers (`auc-validation`, `pnpair-validation`)
each host a `last-column-auc` or `pnpair` evaluator over their inputs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from paddle_tpu_torch.config.schema import EvaluatorConfig, ModelConfig
from paddle_tpu_torch.parameter.argument import Argument
from paddle_tpu_torch.utils.logger import get_logger

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


_AUC_BINS = 1024
_AUC_ROWS = 1024            # rows compared against the bins at once


def _auc_batch(cfg: EvaluatorConfig, outputs: dict[str, Argument],
               feed: dict[str, Argument]) -> dict[str, torch.Tensor]:
    """The positive and negative histograms of the last output column's
    score (ref: Evaluator.cpp AucEvaluator, created with colIdx -1 for
    'last-column-auc'), weighted by the optional third input: bin
    (score * 1024) cast to int32, clipped, in the score's dtype."""
    out = outputs[cfg.input_layer_names[0]].flatten_image()
    lbl = outputs[cfg.input_layer_names[1]].flatten_image()
    pos_prob = out.value[..., -1]
    y = lbl.ids.to(torch.float64).reshape(pos_prob.shape)
    w = torch.ones_like(y)
    if len(cfg.input_layer_names) > 2:
        wt = outputs[cfg.input_layer_names[2]].flatten_image()
        w = wt.value.reshape(pos_prob.shape).float().to(torch.float64)
    idx = torch.clamp((pos_prob * _AUC_BINS).to(torch.int32), 0,
                      _AUC_BINS - 1).reshape(-1)
    pos, neg = (y * w).reshape(-1), ((1.0 - y) * w).reshape(-1)
    bins = torch.arange(_AUC_BINS, dtype=torch.int32, device=idx.device)
    hist = torch.zeros(2, _AUC_BINS, dtype=torch.float64, device=idx.device)
    for s in range(0, idx.numel(), _AUC_ROWS):
        hit = idx[s:s + _AUC_ROWS, None] == bins
        vals = torch.stack([pos[s:s + _AUC_ROWS], neg[s:s + _AUC_ROWS]])
        hist = hist + torch.where(hit, vals[:, :, None], 0.0).sum(1)
    return {"pos": hist[0], "neg": hist[1]}


def _auc_final(cfg: EvaluatorConfig, acc: dict) -> dict:
    pos, neg = np.asarray(acc["pos"]), np.asarray(acc["neg"])
    # integrate from the high-score end (ref: AucEvaluator::calcAuc)
    tp = np.cumsum(pos[::-1])
    fp = np.cumsum(neg[::-1])
    tot_pos, tot_neg = tp[-1], fp[-1]
    if tot_pos == 0 or tot_neg == 0:
        return {"auc": 0.0}
    tpr = np.concatenate([[0.0], tp / tot_pos])
    fpr = np.concatenate([[0.0], fp / tot_neg])
    return {"auc": float(np.trapezoid(tpr, fpr))}


# "auc" is the JAX package's alias of the reference's "last-column-auc"
evaluator_registry["auc"] = (_auc_batch, _auc_final)
evaluator_registry["last-column-auc"] = (_auc_batch, _auc_final)


def _pr_batch(cfg: EvaluatorConfig, outputs: dict[str, Argument],
              feed: dict[str, Argument]) -> dict[str, torch.Tensor]:
    """Per-class true positives, false positives and false negatives
    (ref: PrecisionRecallEvaluator): the arg max, or the threshold of a
    one-column output."""
    out = outputs[cfg.input_layer_names[0]].flatten_image()
    lbl = outputs[cfg.input_layer_names[1]].flatten_image()
    p = out.value
    C = p.shape[-1]
    pred = torch.argmax(p, dim=-1) if C > 1 else \
        (p[..., 0] > cfg.classification_threshold).long()
    y = lbl.ids.reshape(pred.shape).long()
    nC = max(C, 2)
    onehot_p = torch.nn.functional.one_hot(pred, nC).float()
    onehot_y = torch.nn.functional.one_hot(y, nC).float()
    dims = tuple(range(onehot_p.dim() - 1))
    return {"tp": torch.sum(onehot_p * onehot_y, dim=dims),
            "fp": torch.sum(onehot_p * (1 - onehot_y), dim=dims),
            "fn": torch.sum((1 - onehot_p) * onehot_y, dim=dims)}


def _pr_final(cfg: EvaluatorConfig, acc: dict) -> dict:
    tp, fp, fn = (np.asarray(acc[k]) for k in ("tp", "fp", "fn"))
    if cfg.positive_label >= 0:
        tp, fp, fn = (tp[cfg.positive_label], fp[cfg.positive_label],
                      fn[cfg.positive_label])
        prec = tp / max(tp + fp, 1.0)
        rec = tp / max(tp + fn, 1.0)
    else:
        prec = float(np.mean(tp / np.maximum(tp + fp, 1.0)))
        rec = float(np.mean(tp / np.maximum(tp + fn, 1.0)))
    f1 = 2 * prec * rec / max(prec + rec, 1e-8)
    return {"precision": float(prec), "recall": float(rec),
            "F1-score": float(f1)}


evaluator_registry["precision_recall"] = (_pr_batch, _pr_final)


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


def _seqcls_state() -> dict:
    return {"err": 0, "n": 0}


def _seqcls_batch(cfg: EvaluatorConfig, args: list, state: dict) -> None:
    """A sequence counts as one error if any of its frames is
    misclassified (ref: SequenceClassificationErrorEvaluator)."""
    out, lbl = args[0], args[1]
    pred = np.asarray(out.value)
    if pred.shape[-1] == 1:
        frame_pred = (pred[..., 0] > cfg.classification_threshold).astype(
            np.int64)
    else:
        frame_pred = np.argmax(pred, axis=-1)
    labels = np.asarray(lbl.ids).reshape(frame_pred.shape)
    lengths = out.lengths
    for b in range(frame_pred.shape[0]):
        L = int(lengths[b]) if lengths is not None else frame_pred.shape[1]
        state["err"] += int(np.any(frame_pred[b, :L] != labels[b, :L]))
        state["n"] += 1


def _seqcls_final(cfg: EvaluatorConfig, state: dict) -> dict:
    return {"seq_classification_error": state["err"] / max(state["n"], 1)}


host_evaluator_registry["seq_classification_error"] = (
    _seqcls_state, _seqcls_batch, _seqcls_final)


def _ctc_collapse(path, blank: int) -> list:
    """Repeats collapsed, then blanks dropped (ref: CTCErrorEvaluator::
    path2String)."""
    out, prev = [], -1
    for lab in path:
        lab = int(lab)
        if lab != blank and (not out or lab != out[-1] or prev == blank):
            out.append(lab)
        prev = lab
    return out


def _edit_distance(a: list, b: list) -> int:
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def _ctc_state() -> dict:
    return {"dist": 0.0, "len": 0, "seq_err": 0, "n": 0}


def _ctc_batch(cfg: EvaluatorConfig, args: list, state: dict) -> None:
    """The best path of each row's activations (blank = the last class),
    against its label by edit distance (ref: CTCErrorEvaluator)."""
    out, lbl = args[0], args[1]
    acts = np.asarray(out.value)
    blank = acts.shape[-1] - 1
    out_lens = out.lengths
    for b, (lab_row, _) in enumerate(_seq_rows(lbl)):
        T = int(out_lens[b]) if out_lens is not None else acts.shape[1]
        rec = _ctc_collapse(np.argmax(acts[b, :T], axis=-1), blank)
        gt = [int(x) for x in np.asarray(lab_row).reshape(-1)]
        d = _edit_distance(gt, rec)
        state["dist"] += d
        state["len"] += len(gt)
        state["seq_err"] += int(d != 0)
        state["n"] += 1


def _ctc_final(cfg: EvaluatorConfig, state: dict) -> dict:
    return {"ctc_edit_distance": state["dist"] / max(state["n"], 1),
            "character_error_rate": state["dist"] / max(state["len"], 1),
            "sequence_error_rate": state["seq_err"] / max(state["n"], 1)}


host_evaluator_registry["ctc_edit_distance"] = (_ctc_state, _ctc_batch,
                                                _ctc_final)


def _pnpair_state() -> dict:
    return {"records": []}


def _pnpair_batch(cfg: EvaluatorConfig, args: list, state: dict) -> None:
    """(score, label, query id, weight) records, the score the last
    output column (ref: PnpairEvaluator)."""
    out, lbl, info = args[0], args[1], args[2]
    weight = args[3] if len(args) > 3 else None
    scores = np.asarray(out.value).reshape(out.value.shape[0], -1)[:, -1]
    labels = np.asarray(lbl.ids).reshape(-1)
    infos = np.asarray(info.ids).reshape(-1)
    ws = (np.asarray(weight.data).reshape(-1) if weight is not None
          else np.ones_like(scores))
    state["records"].extend(zip(scores.tolist(), labels.tolist(),
                                infos.tolist(), ws.tolist()))


def _pnpair_final(cfg: EvaluatorConfig, state: dict) -> dict:
    """Concordant, discordant and tied pairs of different labels within
    each query, weighted by the pair's mean weight (ref:
    PnpairEvaluator::calc)."""
    recs = sorted(state["records"], key=lambda r: r[2])
    pos = neg = spe = 0.0
    i = 0
    while i < len(recs):
        j = i
        while j < len(recs) and recs[j][2] == recs[i][2]:
            j += 1
        group = recs[i:j]
        for a in range(len(group)):
            for b in range(a + 1, len(group)):
                sa, la, _, wa = group[a]
                sb, lb, _, wb = group[b]
                if la == lb:
                    continue
                w = (wa + wb) / 2.0
                if (sa > sb and la > lb) or (sa < sb and la < lb):
                    pos += w
                elif (sa > sb and la < lb) or (sa < sb and la > lb):
                    neg += w
                else:
                    spe += w
        i = j
    return {"pos_pairs": pos, "neg_pairs": neg, "special_pairs": spe,
            "pnpair": pos / max(neg, 1e-8)}


host_evaluator_registry["pnpair"] = (_pnpair_state, _pnpair_batch,
                                     _pnpair_final)


def _rankauc_state() -> dict:
    return {"auc_sum": 0.0, "n": 0}


def _rank_auc_one(scores, clicks, pvs) -> float:
    """(ref: RankAucEvaluator::calcRankAuc) the tie-aware trapezoid."""
    order = np.argsort(-scores, kind="stable")
    auc = click_sum = old_click_sum = 0.0
    no_click = no_click_sum = 0.0
    last = scores[order[0]] + 1.0
    for idx in order:
        if scores[idx] != last:
            auc += (click_sum + old_click_sum) * no_click / 2.0
            old_click_sum = click_sum
            no_click = 0.0
            last = scores[idx]
        no_click += pvs[idx] - clicks[idx]
        no_click_sum += no_click
        click_sum += clicks[idx]
    auc += (click_sum + old_click_sum) * no_click / 2.0
    denom = click_sum * no_click_sum
    return 0.0 if denom == 0.0 else auc / denom


def _rankauc_batch(cfg: EvaluatorConfig, args: list, state: dict) -> None:
    out, click = args[0], args[1]
    pv = args[2] if len(args) > 2 else None
    scores = np.asarray(out.value)
    clicks = np.asarray(click.data, np.float64).reshape(scores.shape[0], -1)
    pvs = (np.asarray(pv.data, np.float64).reshape(scores.shape[0], -1)
           if pv is not None else np.ones_like(clicks))
    lengths = out.lengths
    for b in range(scores.shape[0]):
        if lengths is not None:
            L = int(lengths[b])
        else:
            L = scores.shape[1] if scores.ndim > 2 else clicks.shape[1]
        state["auc_sum"] += _rank_auc_one(scores[b].reshape(-1)[:L],
                                          clicks[b].reshape(-1)[:L],
                                          pvs[b].reshape(-1)[:L])
        state["n"] += 1


def _rankauc_final(cfg: EvaluatorConfig, state: dict) -> dict:
    return {"rankauc": state["auc_sum"] / max(state["n"], 1)}


host_evaluator_registry["rankauc"] = (_rankauc_state, _rankauc_batch,
                                      _rankauc_final)


# -- printers: log a few batches' samples and return no result (ref:
#    Evaluator.cpp value_printer, max_id_printer, seq_text_printer,
#    classification_error_printer, max_frame_printer, gradient_printer)

_PRINTED = 5        # batches a printer logs


def _printer_state() -> dict:
    return {"printed": 0}


def _make_printer(fmt_fn):
    def batch(cfg, args, state):
        if state["printed"] >= _PRINTED:
            return
        get_logger("evaluator").info("[%s] %s", cfg.name, fmt_fn(cfg, args))
        state["printed"] += 1
    return (_printer_state, batch, lambda cfg, state: {})


def _values_print(cfg: EvaluatorConfig, args: list) -> str:
    return " ".join(np.array2string(np.asarray(a.data), threshold=20)
                    for a in args)


def _max_id_print(cfg: EvaluatorConfig, args: list) -> str:
    return np.array2string(np.argmax(np.asarray(args[0].value), axis=-1),
                           threshold=50)


def _cls_err_print(cfg: EvaluatorConfig, args: list) -> str:
    pred = np.argmax(np.asarray(args[0].value), axis=-1)
    labels = np.asarray(args[1].ids).reshape(pred.shape)
    return np.array2string((pred != labels).astype(np.int32), threshold=50)


def _max_frame_print(cfg: EvaluatorConfig, args: list) -> str:
    """Per sequence, the frame with the largest output value and its index
    (ref: MaxFramePrinter)."""
    a = args[0]
    if a.value is None:
        raise ValueError(
            f"max_frame_printer on {cfg.input_layer_names!r}: probed layer "
            f"has no dense value (ids-only output) — point it at a layer "
            f"that emits values")
    v = np.asarray(a.value)
    if v.ndim == 2:
        v = v[:, None, :]               # [B, 1, D]: non-sequence = 1 frame
    lengths = a.lengths
    lines = []
    for b in range(v.shape[0]):
        L = int(lengths[b]) if lengths is not None else v.shape[1]
        frames = v[b, :max(L, 1)]
        t = int(np.argmax(frames.max(axis=-1)))
        lines.append(f"seq {b}: frame {t} "
                     f"{np.array2string(frames[t], threshold=10)}")
    return "; ".join(lines[:8])


def _seqtext_state() -> dict:
    return {"printed": 0, "dict": None, "file_reset": False}


def _seqtext_batch(cfg: EvaluatorConfig, args: list, state: dict) -> None:
    """Id sequences as words of `dict_file` (or as ids), appended to
    `result_file` or logged (ref: SequenceTextPrinter)."""
    if state["dict"] is None and cfg.dict_file:
        with open(cfg.dict_file) as f:
            state["dict"] = [ln.rstrip("\n") for ln in f]
    vocab = state["dict"]
    sep = " " if cfg.delimited else ""
    rows = []
    for row, _ in _seq_rows(args[0]):
        toks = [int(x) for x in np.asarray(row).reshape(-1)]
        rows.append(sep.join(vocab[t] if vocab and 0 <= t < len(vocab)
                             else str(t) for t in toks))
    if cfg.result_file:
        mode = "a" if state["file_reset"] else "w"
        state["file_reset"] = True
        with open(cfg.result_file, mode) as f:
            f.write("\n".join(rows) + "\n")
    elif state["printed"] < _PRINTED:
        get_logger("evaluator").info("[%s] %s", cfg.name,
                                     " | ".join(rows[:8]))
        state["printed"] += 1


host_evaluator_registry["value_printer"] = _make_printer(_values_print)
host_evaluator_registry["max_id_printer"] = _make_printer(_max_id_print)
host_evaluator_registry["seq_text_printer"] = (
    _seqtext_state, _seqtext_batch, lambda cfg, state: {})
host_evaluator_registry["classification_error_printer"] = _make_printer(
    _cls_err_print)
host_evaluator_registry["max_frame_printer"] = _make_printer(
    _max_frame_print)
# the probed layers' output gradients, `__grad__<layer>` outputs the
# trainer's probes give (ref: GradientPrinter reads getOutputGrad())
host_evaluator_registry["gradient_printer"] = _make_printer(_values_print)


class EvaluatorSet:
    """Accumulates the model's evaluators across batches: the device ones'
    partial sums, the host ones' states."""

    # validation layer type -> the evaluator it hosts (ref:
    # ValidationLayer.cpp AucValidation 'last-column-auc', PnpairValidation
    # 'pnpair')
    _VALIDATION_LAYERS = {"auc-validation": "last-column-auc",
                          "pnpair-validation": "pnpair"}

    def __init__(self, model: ModelConfig):
        evals = list(model.evaluators)
        for layer in model.layers:
            ev_type = self._VALIDATION_LAYERS.get(layer.type)
            if ev_type is not None:
                evals.append(EvaluatorConfig(
                    name=layer.name, type=ev_type,
                    input_layer_names=[i.input_layer_name
                                       for i in layer.inputs]))
        unknown = sorted({e.type for e in evals
                          if e.type not in evaluator_registry
                          and e.type not in host_evaluator_registry})
        if unknown:
            raise ValueError(
                f"unknown evaluator types {unknown}; known: "
                f"{sorted(evaluator_registry)} and, on the host, "
                f"{sorted(host_evaluator_registry)}")
        self.configs = [e for e in evals if e.type in evaluator_registry]
        self.host_configs = [e for e in evals
                             if e.type in host_evaluator_registry]

    @staticmethod
    def _host_keys(cfg: EvaluatorConfig) -> list[str]:
        """The output keys one host evaluator reads: its layers, or for
        gradient_printer their `__grad__<layer>` output gradients."""
        if cfg.type == "gradient_printer":
            return ["__grad__" + n for n in cfg.input_layer_names]
        return list(cfg.input_layer_names)

    @property
    def host_layer_names(self) -> list[str]:
        """The output keys the host evaluators read each batch."""
        names: list[str] = []
        for cfg in self.host_configs:
            for n in self._host_keys(cfg):
                if n not in names:
                    names.append(n)
        return names

    @property
    def probe_layer_names(self) -> list[str]:
        """The layers whose output gradients a gradient_printer prints."""
        names: list[str] = []
        for cfg in self.host_configs:
            if cfg.type == "gradient_printer":
                names += [n for n in cfg.input_layer_names if n not in names]
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
            keys = self._host_keys(cfg)
            missing = [n for n in keys if n not in cache]
            if missing:
                raise KeyError(f"host evaluator {cfg.name!r} ({cfg.type}) "
                               f"references {missing} absent from the step "
                               f"outputs")
            host_evaluator_registry[cfg.type][1](
                cfg, [cache[n] for n in keys], state[cfg.name])

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
