"""Evaluator DSL (ref: trainer_config_helpers/evaluators.py)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.config.schema import EvaluatorConfig
from paddle_tpu_torch.dsl.base import LayerOutput, current_context

__all__ = [
    "classification_error_evaluator", "auc_evaluator", "sum_evaluator",
    "column_sum_evaluator", "precision_recall_evaluator", "pnpair_evaluator",
    "chunk_evaluator", "ctc_error_evaluator", "value_printer_evaluator",
    "rank_auc_evaluator", "seq_classification_error_evaluator",
    "maxid_printer_evaluator", "seqtext_printer_evaluator",
    "classification_error_printer_evaluator", "gradient_printer_evaluator",
    "maxframe_printer_evaluator", "evaluator_base",
]


def _add(type_: str, inputs: list[LayerOutput], name: Optional[str], **extra) -> EvaluatorConfig:
    ctx = current_context()
    cfg = EvaluatorConfig(
        name=name or ctx.unique_name(type_), type=type_,
        input_layer_names=[i.name for i in inputs])
    for k, v in extra.items():
        if v is not None:
            setattr(cfg, k, v)
    return ctx.add_evaluator(cfg)


def classification_error_evaluator(input: LayerOutput, label: LayerOutput,
                                   name=None, weight=None,
                                   threshold: Optional[float] = None) -> None:
    """(ref: Evaluator.cpp ClassificationErrorEvaluator)."""
    ins = [input, label] + ([weight] if weight else [])
    _add("classification_error", ins, name,
         classification_threshold=threshold)


def auc_evaluator(input: LayerOutput, label: LayerOutput, name=None,
                  weight=None) -> None:
    """(ref: Evaluator.cpp AucEvaluator)."""
    ins = [input, label] + ([weight] if weight else [])
    _add("auc", ins, name)


def sum_evaluator(input: LayerOutput, name=None, weight=None) -> None:
    ins = [input] + ([weight] if weight else [])
    _add("sum", ins, name)


def column_sum_evaluator(input: LayerOutput, name=None, weight=None) -> None:
    ins = [input] + ([weight] if weight else [])
    _add("column_sum", ins, name)


def precision_recall_evaluator(input: LayerOutput, label: LayerOutput, name=None,
                               positive_label: int = -1, weight=None) -> None:
    """(ref: PrecisionRecallEvaluator)."""
    ins = [input, label] + ([weight] if weight else [])
    _add("precision_recall", ins, name, positive_label=positive_label)


def pnpair_evaluator(input: LayerOutput, label: LayerOutput, info: LayerOutput,
                     name=None, weight=None) -> None:
    """(ref: PnpairEvaluator)."""
    ins = [input, label, info] + ([weight] if weight else [])
    _add("pnpair", ins, name)


def chunk_evaluator(input: LayerOutput, label: LayerOutput, chunk_scheme: str,
                    num_chunk_types: int, name=None,
                    excluded_chunk_types: Optional[list] = None) -> None:
    """NER-style chunk F1 (ref: ChunkEvaluator.cpp)."""
    _add("chunk", [input, label], name, chunk_scheme=chunk_scheme,
         num_chunk_types=num_chunk_types,
         excluded_chunk_types=excluded_chunk_types or [])


def ctc_error_evaluator(input: LayerOutput, label: LayerOutput, name=None) -> None:
    """Edit-distance over CTC decodes (ref: CTCErrorEvaluator.cpp)."""
    _add("ctc_edit_distance", [input, label], name)


def value_printer_evaluator(input: LayerOutput, name=None) -> None:
    _add("value_printer", [input], name)


def rank_auc_evaluator(input: LayerOutput, label: LayerOutput, name=None,
                       weight=None) -> None:
    """Per-query ranking AUC over sequences (ref: RankAucEvaluator)."""
    ins = [input, label] + ([weight] if weight else [])
    _add("rankauc", ins, name)


def seq_classification_error_evaluator(input: LayerOutput, label: LayerOutput,
                                       name=None,
                                       threshold: Optional[float] = None) -> None:
    """Sequence-level error: wrong if any frame is wrong
    (ref: SequenceClassificationErrorEvaluator)."""
    _add("seq_classification_error", [input, label], name,
         classification_threshold=threshold)


def maxid_printer_evaluator(input: LayerOutput, name=None) -> None:
    _add("max_id_printer", [input], name)


def seqtext_printer_evaluator(input: LayerOutput, name=None,
                              result_file: str = "", dict_file: str = "",
                              delimited: bool = True) -> None:
    """Print/write decoded id sequences (ref: SequenceTextPrinter —
    result_file/dict_file/delimited)."""
    _add("seq_text_printer", [input], name, result_file=result_file,
         dict_file=dict_file, delimited=delimited)


def classification_error_printer_evaluator(input: LayerOutput,
                                           label: LayerOutput,
                                           name=None) -> None:
    _add("classification_error_printer", [input, label], name)


def gradient_printer_evaluator(input: LayerOutput, name=None) -> None:
    """Print the layer's OUTPUT GRADIENT each batch (ref: Evaluator.cpp
    GradientPrinter).  The trainer recreates the grad buffer autodiff
    elides via an additive-zero probe at the layer."""
    _add("gradient_printer", [input], name)


def maxframe_printer_evaluator(input: LayerOutput, name=None) -> None:
    """Print each sequence's value-maximizing frame (ref: Evaluator.cpp
    MaxFramePrinter)."""
    _add("max_frame_printer", [input], name)


def evaluator_base(input, type: str, label: Optional[LayerOutput] = None,
                   weight: Optional[LayerOutput] = None,
                   name: Optional[str] = None, **extra) -> None:
    """Generic evaluator constructor (ref: evaluators.py evaluator_base:60)
    — the escape hatch for evaluator types without a dedicated helper:
    assembles [input, label, weight] in the reference's argument order and
    passes every remaining kwarg onto the EvaluatorConfig."""
    inputs = [input] if isinstance(input, LayerOutput) else list(input)
    if label is not None:
        inputs.append(label)
    if weight is not None:
        inputs.append(weight)
    _add(type, inputs, name, **extra)
