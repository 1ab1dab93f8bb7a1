"""The layer types ported last (concat2, the combination zoo of
layers_misc, moe, mdlstmemory, sampling_id, eos_id, ctc, nce, hsigmoid)
held against the JAX layers on the CPU.

Each per-layer case (`zoo_cases`) runs one layer on the same inputs and
parameters in a JAX and a port ForwardContext: values and the gradient
of sum(output * R) (plus the recorded costs) with respect to every float
input and parameter within 1e-4 (absolute and relative), ids exactly.
Then chip_smoke.py's five zoo models (its `[zoo]` phase runs them at full
size on the card against the CPU), at their small sizes, through the
port's GraphExecutor.loss and its backward against the JAX executor's
jitted value and gradient: the loss, every layer's values, every cost
and every parameter's gradient within 1e-4, ids exactly.  The stochastic
layers (sampling_id, nce) draw from the same key on both sides.  The two
registries hold the same type names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.schema import LayerConfig as JLayer
from paddle_tpu.config.schema import LayerInput as JInput
from paddle_tpu.config.schema import ProjectionConfig as JProj
from paddle_tpu.config.schema import TrainerConfig as JTrainerConfig
from paddle_tpu.graph.builder import GraphExecutor as JExecutor
from paddle_tpu.graph.context import ForwardContext as JContext
from paddle_tpu.graph.registry import get_layer_fn as jget
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu_torch.parameter import init_params
from chip_smoke import ZOO_KEY, ZOO_SIZES, ZOO_TYPES, zoo_graph_run, \
    zoo_model

ZOO_B = 4


def _zoo_val(shape, seed: int, lo: float = -1.0, hi: float = 1.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


def _zoo_probs(shape, seed: int):
    z = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def zoo_cases() -> dict:
    """The 25 layer types ported last, a small case each: type -> (inputs
    {name: ("value" | "ids", array, lengths or None)}, parameters {name:
    array}, the layer's inputs [(layer, parameter, (projection type, in,
    out) or None)], LayerConfig fields, mode)."""
    B, v, pr = ZOO_B, _zoo_val, _zoo_probs
    lens = np.array([3, 1, 2, 3], np.int32)
    c = {}
    c["concat2"] = ({"x1": ("value", v((B, 4), 1), None),
                     "x2": ("value", v((B, 3), 2), None)},
                    {"w": v((4, 5), 3), "b": v((1, 8), 4)},
                    [("x1", "w", ("fc", 4, 5)), ("x2", "", None)],
                    dict(size=8, bias_parameter_name="b"), "test")
    c["scaling"] = ({"w": ("value", v((B, 1), 5), None),
                     "x": ("value", v((B, 5), 6), None)}, {},
                    [("w", "", None), ("x", "", None)], dict(size=5), "test")
    c["slope_intercept"] = (
        {"x": ("value", v((B, 5), 7), None)}, {}, [("x", "", None)],
        dict(size=5, attrs={"slope": 2.5, "intercept": -0.75}), "test")
    c["interpolation"] = (
        {"w": ("value", v((B, 1), 8, 0.0, 1.0), None),
         "a": ("value", v((B, 5), 9), None),
         "b": ("value", v((B, 5), 10), None)}, {},
        [("w", "", None), ("a", "", None), ("b", "", None)], dict(size=5),
        "test")
    c["power"] = ({"w": ("value", v((B, 1), 11, 0.5, 2.0), None),
                   "x": ("value", v((B, 5), 12, 0.2, 2.0), None)}, {},
                  [("w", "", None), ("x", "", None)], dict(size=5), "test")
    for t in ("convex_comb", "linear_comb"):
        c[t] = ({"w": ("value", v((B, 3), 13), None),
                 "x": ("value", v((B, 12), 14), None)}, {},
                [("w", "", None), ("x", "", None)], dict(size=4), "test")
    c["cos_vm"] = ({"v": ("value", v((B, 4), 15), None),
                    "m": ("value", v((B, 12), 16), None)}, {},
                   [("v", "", None), ("m", "", None)],
                   dict(size=3, attrs={"cos_scale": 2.0}), "test")
    c["out_prod"] = ({"a": ("value", v((B, 3), 17), None),
                      "b": ("value", v((B, 4), 18), None)}, {},
                     [("a", "", None), ("b", "", None)], dict(size=12),
                     "test")
    c["tensor"] = ({"a": ("value", v((B, 3), 19), None),
                    "b": ("value", v((B, 4), 20), None)},
                   {"w": v((3, 8), 21), "bias": v((1, 2), 22)},
                   [("a", "w", None), ("b", "", None)],
                   dict(size=2, bias_parameter_name="bias"), "test")
    c["multiplex"] = ({"sel": ("ids", np.array([1, 0, 2, 1], np.int32),
                               None),
                       "x0": ("value", v((B, 4), 23), None),
                       "x1": ("value", v((B, 4), 24), None),
                       "x2": ("value", v((B, 4), 25), None)}, {},
                      [(n, "", None) for n in ("sel", "x0", "x1", "x2")],
                      dict(size=4), "test")
    c["trans"] = ({"x": ("value", v((B, 4), 26), None)}, {},
                  [("x", "", None)], dict(size=B), "test")
    c["resize"] = ({"x": ("value", v((B, 6), 27), None)}, {},
                   [("x", "", None)], dict(size=3), "test")
    c["featmap_expand"] = ({"x": ("value", v((B, 4), 28), None)}, {},
                           [("x", "", None)], dict(size=12, num_filters=3),
                           "test")
    c["prelu"] = ({"x": ("value", v((B, 6), 29), None)}, {"w": v((3,), 30)},
                  [("x", "w", None)], dict(size=6), "test")
    c["conv_shift"] = ({"a": ("value", v((B, 6), 31), None),
                        "b": ("value", v((B, 3), 32), None)}, {},
                       [("a", "", None), ("b", "", None)], dict(size=6),
                       "test")
    c["print"] = ({"x": ("value", v((B, 4), 33), None)}, {},
                  [("x", "", None)], dict(size=4), "test")
    c["selective_fc"] = (
        {"x": ("value", v((B, 4), 34), None),
         "sel": ("value", (v((B, 5), 35, 0.0, 1.0) > 0.4).astype(
             np.float32), None)},
        {"w": v((4, 5), 36), "b": v((1, 5), 37)},
        [("x", "w", None), ("sel", "", None)],
        dict(size=5, bias_parameter_name="b", active_type="softmax",
             attrs={"has_selected_colums": True}), "test")
    c["moe"] = ({"x": ("value", v((B, 3, 4), 38), lens)},
                {"router": v((4, 3), 39), "w1": v((3, 4, 6), 40),
                 "b1": v((3, 6), 41), "w2": v((3, 6, 4), 42),
                 "b2": v((3, 4), 43)},
                [("x", n, None) for n in ("router", "w1", "b1", "w2", "b2")],
                dict(size=4, attrs={"top_k": 2, "capacity_factor": 1.5,
                                    "aux_weight": 0.1}), "train")
    c["mdlstmemory"] = (
        {"x": ("value", v((B, 6, 15), 44), np.array([6, 4, 1, 5],
                                                      np.int32))},
        {"w": v((3, 15), 45, -0.5, 0.5), "b": v((1, 27), 46)},
        [("x", "w", None)],
        dict(size=3, bias_parameter_name="b",
             attrs={"height": 2, "width": 3, "directions": [True, False]}),
        "test")
    c["sampling_id"] = ({"x": ("value", pr((B, 9), 47), None)}, {},
                        [("x", "", None)], dict(size=9), "train")
    c["eos_id"] = ({"x": ("ids", np.random.default_rng(48).integers(
        0, 4, size=(B, 3)).astype(np.int32), lens)}, {}, [("x", "", None)],
        dict(size=1, attrs={"eos_id": 2}), "test")
    c["ctc"] = ({"x": ("value", pr((B, 6, 5), 49),
                       np.array([6, 5, 4, 6], np.int32)),
                 "lbl": ("ids", np.array([[1, 2, 2], [3, 1, 0], [4, 0, 0],
                                          [2, 3, 1]], np.int32),
                         np.array([3, 2, 1, 3], np.int32))}, {},
                [("x", "", None), ("lbl", "", None)],
                dict(size=1, blank=0, norm_by_times=True, coeff=0.5), "test")
    c["nce"] = ({"x": ("value", v((B, 4), 50), None),
                 "lbl": ("ids", np.array([0, 3, 6, 2], np.int32), None)},
                {"w": v((7, 4), 51), "b": v((1, 7), 52)},
                [("x", "w", None), ("lbl", "", None)],
                dict(size=1, bias_parameter_name="b", num_classes=7,
                     num_neg_samples=3,
                     neg_sampling_dist=[0.1, 0.2, 0.05, 0.15, 0.2, 0.1,
                                        0.2]), "train")
    c["hsigmoid"] = ({"x": ("value", v((B, 4), 53), None),
                      "lbl": ("ids", np.array([0, 5, 3, 2], np.int32),
                              None)},
                     {"w": v((5, 4), 54), "b": v((1, 5), 55)},
                     [("x", "w", None), ("lbl", "", None)],
                     dict(size=1, bias_parameter_name="b", num_classes=6),
                     "test")
    return c


def zoo_run(type_: str, case: tuple, device: str, key: int = 17):
    """One zoo case through the port's layer on `device`: (output Argument,
    the costs it recorded, (d/d float inputs, d/d parameters) of
    sum(output * R) plus the other recorded costs, or None for an output
    without values)."""
    from paddle_tpu_torch.config.schema import (LayerConfig, LayerInput,
                                                ProjectionConfig)
    from paddle_tpu_torch.graph.context import ForwardContext
    from paddle_tpu_torch.graph.registry import get_layer_fn
    from paddle_tpu_torch.parameter import Argument
    from paddle_tpu_torch.utils import prng
    inputs, params, lins, fields, mode = case
    cfg = LayerConfig(name="L", type=type_, inputs=[
        LayerInput(n, p, None if proj is None else ProjectionConfig(
            type=proj[0], input_size=proj[1], output_size=proj[2]))
        for n, p, proj in lins], **fields)
    fvals = {n: torch.tensor(a, device=device, requires_grad=True)
             for n, (k, a, _) in inputs.items() if k == "value"}
    pvals = {n: torch.tensor(a, device=device, requires_grad=True)
             for n, a in params.items()}
    ctx = ForwardContext(model=None, params=pvals, mode=mode,
                         rng=prng.PRNGKey(key, device=device))
    for n, (kind, a, lens) in inputs.items():
        lengths = None if lens is None else torch.tensor(lens, device=device)
        ctx.outputs[n] = Argument(value=fvals[n], lengths=lengths) \
            if kind == "value" else Argument(
                ids=torch.tensor(a, device=device).long(), lengths=lengths)
    with torch.enable_grad():
        out = get_layer_fn(type_)(ctx, cfg)
        grads = None
        if out.value is not None:
            R = torch.tensor(_zoo_val(tuple(out.value.shape), 99),
                             device=device)
            total = torch.sum(out.value * R)
            for cname, cv in ctx.costs.items():
                if cname != "L":
                    total = total + torch.sum(cv)
            leaves = list(fvals.values()) + list(pvals.values())
            g = torch.autograd.grad(total, leaves, allow_unused=True)
            grads = ({n: g[i] for i, n in enumerate(fvals)},
                     {n: g[len(fvals) + i] for i, n in enumerate(pvals)})
    return out, ctx.costs, grads


TOL = dict(rtol=1e-4, atol=1e-4)
CASES = zoo_cases()


def _jax_run(type_, case, key):
    """The JAX layer on the case, jitted: (output, costs, gradients as
    zoo_run gives them)."""
    inputs, params, lins, fields, mode = case
    cfg = JLayer(name="L", type=type_, inputs=[
        JInput(n, p, None if proj is None else JProj(
            type=proj[0], input_size=proj[1], output_size=proj[2]))
        for n, p, proj in lins], **fields)
    fnames = [n for n, (k, _, _) in inputs.items() if k == "value"]

    def run(fvals, pvals):
        ctx = JContext(model=None, params=pvals, mode=mode,
                       rng=jax.random.PRNGKey(key))
        for n, (kind, a, lens) in inputs.items():
            lengths = None if lens is None else jnp.asarray(lens)
            ctx.outputs[n] = JArgument(value=fvals[n], lengths=lengths) \
                if kind == "value" else JArgument(ids=jnp.asarray(a),
                                                  lengths=lengths)
        out = jget(type_)(ctx, cfg)
        return out, ctx.costs

    fvals = {n: jnp.asarray(inputs[n][1]) for n in fnames}
    pvals = {n: jnp.asarray(v) for n, v in params.items()}
    out, costs = jax.jit(run)(fvals, pvals)
    grads = None
    if out.value is not None:
        R = jnp.asarray(_zoo_val(out.value.shape, 99))

        def loss(fv, pv):
            o, cs = run(fv, pv)
            total = jnp.sum(o.value * R)
            for cname, cv in cs.items():
                if cname != "L":
                    total = total + jnp.sum(cv)
            return total
        grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(fvals, pvals)
    return out, costs, grads


@pytest.mark.parametrize("type_", sorted(CASES))
def test_layer_matches_jax_forward_and_gradient(type_):
    jout, jcosts, jgrads = _jax_run(type_, CASES[type_], 17)
    out, costs, grads = zoo_run(type_, CASES[type_], "cpu", 17)
    if jout.ids is not None:
        assert out.ids is not None
        assert np.array_equal(out.ids.numpy(), np.asarray(jout.ids))
    if jout.value is None:
        assert out.value is None
    else:
        np.testing.assert_allclose(out.value.detach().numpy(),
                                   np.asarray(jout.value), **TOL)
    assert (jout.lengths is None) == (out.lengths is None)
    assert sorted(costs) == sorted(jcosts)
    for cname in jcosts:
        np.testing.assert_allclose(costs[cname].detach().numpy(),
                                   np.asarray(jcosts[cname]), **TOL)
    if jgrads is not None:
        for side in (0, 1):
            for n, jg in jgrads[side].items():
                g = grads[side][n]
                got = np.zeros(jg.shape, np.float32) if g is None \
                    else g.numpy()
                np.testing.assert_allclose(got, np.asarray(jg), **TOL,
                                           err_msg=f"d/d{n}")


def test_registries_hold_the_same_types():
    """Every layer type of the JAX registry is registered in the port under
    the same name, and the port registers no other."""
    import paddle_tpu.graph.builder  # noqa: F401  (registers every module)
    import paddle_tpu_torch.graph.builder  # noqa: F401
    from paddle_tpu.graph.registry import layer_registry as jreg
    from paddle_tpu_torch.graph.registry import layer_registry as treg
    assert sorted(treg) == sorted(jreg)
    assert len(CASES) == 25 and sorted(CASES) == sorted(ZOO_TYPES)


def _jax_graph_run(cfg, params: dict, feed: dict):
    """The JAX executor on the same model (its config read from the port's
    JSON), parameters and batch, jitted: (loss, outputs, costs,
    gradients)."""
    ex = JExecutor(JTrainerConfig.from_json(cfg.to_json()).model_config)
    jfeed = {}
    for n, (kind, a, lens) in feed.items():
        lengths = None if lens is None else jnp.asarray(lens)
        jfeed[n] = JArgument(value=jnp.asarray(a), lengths=lengths) \
            if kind == "value" else JArgument(ids=jnp.asarray(a),
                                              lengths=lengths)

    def loss(p):
        total, (outs, costs, _) = ex.loss(p, jfeed, None, "train",
                                          jax.random.PRNGKey(ZOO_KEY))
        return total, (outs, costs)

    (total, (outs, costs)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))({n: jnp.asarray(a) for n, a in params.items()})
    return total, outs, costs, grads


@pytest.mark.parametrize("name", sorted(ZOO_SIZES))
def test_zoo_models_match_jax_executor(name):
    cfg, feed = zoo_model(name, small=True)
    params = {n: v.numpy() for n, v in
              init_params(cfg.model_config, seed=1, device="cpu").items()}
    loss, outs, costs, grads, _ = zoo_graph_run(cfg.model_config, params,
                                                feed, "cpu")
    jloss, jouts, jcosts, jgrads = _jax_graph_run(cfg, params, feed)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert sorted(outs) == sorted(jouts) and sorted(costs) == sorted(jcosts)
    for n, w in jouts.items():
        assert (w.ids is None) == (outs[n].ids is None), n
        if w.ids is not None:
            assert np.array_equal(outs[n].ids.numpy(), np.asarray(w.ids)), n
        if w.value is not None:
            np.testing.assert_allclose(outs[n].value.detach().numpy(),
                                       np.asarray(w.value), **TOL,
                                       err_msg=n)
    for n, w in jcosts.items():
        np.testing.assert_allclose(costs[n].detach().numpy(),
                                   np.asarray(w), **TOL, err_msg=n)
    assert sorted(grads) == sorted(jgrads)
    for n, w in jgrads.items():
        # a parameter off the loss's path (sampling_id's fc) has no
        # gradient in torch, a zero one in JAX
        g = torch.zeros(w.shape) if grads[n] is None else grads[n]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d/d{n}")


def test_zoo_models_hold_every_new_type():
    """The five zoo models hold each of the 25 types at both sizes."""
    for small in (True, False):
        held = set()
        for name in ZOO_SIZES:
            held |= {lc.type for lc in
                     zoo_model(name, small)[0].model_config.layers}
        assert set(ZOO_TYPES) <= held
