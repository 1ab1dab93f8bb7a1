"""A ModelConfig under construction, with the config DSL's auto-naming —
what the port's model builders (models/sentiment.py, models/seq2seq.py)
write their graphs with, in place of the DSL."""

from __future__ import annotations

from paddle_tpu_torch.config.schema import (
    EvaluatorConfig,
    LayerConfig,
    LayerInput,
    ModelConfig,
    ParameterConfig,
    ProjectionConfig,
)


class Net:
    """A ModelConfig under construction, with the DSL's auto-naming."""

    def __init__(self):
        self.model = ModelConfig()
        self._n: dict[str, int] = {}

    def auto_name(self, kind: str) -> str:
        i = self._n.get(kind, 0)
        self._n[kind] = i + 1
        return f"__{kind}_{i}__"

    def param(self, name: str, dims: list[int], **attrs) -> str:
        self.model.parameters.append(ParameterConfig(
            name=name, size=dims[0] * dims[1], dims=list(dims), **attrs))
        return name

    def layer(self, name: str, type_: str, size: int,
              inputs: list[LayerInput], bias: str = "", act: str = "",
              **fields) -> str:
        self.model.layers.append(LayerConfig(
            name=name, type=type_, size=size, active_type=act, inputs=inputs,
            bias_parameter_name=bias, **fields))
        return name

    def size(self, name: str) -> int:
        return self.model.layer(name).size

    def embedding(self, data: str, size: int) -> str:
        name = self.auto_name("mixed")
        vocab = self.size(data)
        w = self.param(f"_{name}.w0", [vocab, size], initial_smart=True)
        return self.layer(name, "mixed", size, [LayerInput(
            data, w, ProjectionConfig(type="table", input_size=vocab,
                                      output_size=size))])

    def classification_cost(self, output: str, label: str) -> str:
        """The DSL's classification_cost: a multi-class cross-entropy layer
        over (output, label) and its classification-error evaluator."""
        cost = self.layer(self.auto_name("classification_cost"),
                          "multi-class-cross-entropy", 1,
                          [LayerInput(output), LayerInput(label)])
        self.model.evaluators.append(EvaluatorConfig(
            name=f"{cost}.classification_error",
            input_layer_names=[output, label]))
        return cost
