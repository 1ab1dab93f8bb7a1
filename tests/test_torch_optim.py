"""PyTorch port: the update rules, learning-rate schedules and the
ParameterUpdater against the JAX package's, on the same numpy state in
float32 (tolerance 1e-6: elementwise float32 arithmetic, which may round
differently where the two frameworks order or fuse an expression
differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.schema import ModelConfig as JModel
from paddle_tpu.config.schema import OptimizationConfig as JOpt
from paddle_tpu.config.schema import ParameterConfig as JParam
from paddle_tpu.optim import optimizers as jopt
from paddle_tpu.optim import schedulers as jsched
from paddle_tpu.optim.updater import ParameterUpdater as JUpdater
from paddle_tpu_torch.config.schema import ModelConfig, OptimizationConfig
from paddle_tpu_torch.config.schema import ParameterConfig
from paddle_tpu_torch.optim import optimizers as topt
from paddle_tpu_torch.optim import schedulers as tsched
from paddle_tpu_torch.optim.updater import ParameterUpdater
from paddle_tpu_torch.parameter import opt_state_from_jax

TOL = dict(rtol=1e-6, atol=1e-6)
RULES = ["momentum", "adagrad", "decayed_adagrad", "adadelta", "rmsprop",
         "adam", "adamax"]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("rule", RULES)
def test_update_rule_matches_jax(rule):
    """Four updates from zero slots with fresh gradients each time; the
    parameter and every slot after each update."""
    rng = np.random.default_rng(RULES.index(rule))
    kw = dict(learning_method=rule, momentum=0.9, ada_rho=0.9,
              ada_epsilon=1e-6)
    jo, to = JOpt(**kw), OptimizationConfig(**kw)
    jinit, jupd = jopt.get_optimizer(rule)
    tinit, tupd = topt.get_optimizer(rule)
    p = rng.normal(size=(6, 5)).astype(np.float32)
    jp, tp = jnp.asarray(p), _t(p)
    js, ts = jinit(jp, jo), tinit(tp, to)
    assert set(js) == set(ts)
    for t in range(1, 5):
        g = rng.normal(size=p.shape).astype(np.float32)
        jp, js = jupd(jp, jnp.asarray(g), js, jnp.float32(0.05), jo,
                      jnp.int32(t))
        tp, ts = tupd(tp, _t(g), ts, 0.05, to, t)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       **TOL)


def test_momentum_override():
    rng = np.random.default_rng(0)
    p, g = rng.normal(size=(2, 8, 3)).astype(np.float32)
    jo, to = JOpt(momentum=0.9), OptimizationConfig(momentum=0.9)
    jp, _ = jopt._momentum_update(jnp.asarray(p), jnp.asarray(g),
                                  {"momentum": jnp.asarray(g)}, 0.1, jo, 1,
                                  mom_override=0.5)
    tp, _ = topt._momentum_update(_t(p), _t(g), {"momentum": _t(g)}, 0.1, to,
                                  1, mom_override=0.5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_unknown_rule_raises():
    with pytest.raises(ValueError, match="unknown learning_method"):
        topt.get_optimizer("lbfgs")


SCHEDULES = [("constant", 0.0, 0.0, ""), ("poly", 1e-3, 0.75, ""),
             ("caffe_poly", 3000.0, 2.0, ""), ("exp", 0.5, 400.0, ""),
             ("discexp", 0.5, 400.0, ""), ("linear", 2e-5, 1e-3, ""),
             ("manual", 0.0, 0.0, "100:1.0,500:0.5,1000:0.1"),
             ("pass_manual", 0.0, 0.0, "1:1.0,3:0.5,9:0.1")]


@pytest.mark.parametrize("sched,a,b,args", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(sched, a, b, args):
    kw = dict(learning_rate=0.1, learning_rate_decay_a=a,
              learning_rate_decay_b=b, learning_rate_schedule=sched,
              learning_rate_args=args)
    for x, pass_id in ((0, 0), (77, 1), (500, 2), (1000, 3), (4999, 10)):
        want = float(jsched.learning_rate_at(JOpt(**kw), x, pass_id))
        got = tsched.learning_rate_at(OptimizationConfig(**kw), x, pass_id)
        assert got == pytest.approx(want, rel=1e-6, abs=0), (x, pass_id)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown learning_rate_schedule"):
        tsched.learning_rate_at(
            OptimizationConfig(learning_rate_schedule="cosine"), 0)


def _models():
    """Parameters with a learning-rate multiplier, a per-parameter clip,
    L2 and L1 decay, a momentum override and a static one."""
    specs = [dict(name="w", size=12, dims=[3, 4], learning_rate=0.5),
             dict(name="b", size=4, dims=[1, 4],
                  gradient_clipping_threshold=0.05, decay_rate=0.01),
             dict(name="e", size=10, dims=[5, 2], decay_rate_l1=0.002,
                  momentum=0.5),
             dict(name="s", size=6, dims=[2, 3], is_static=True)]
    return (JModel(parameters=[JParam(**s) for s in specs]),
            ModelConfig(parameters=[ParameterConfig(**s) for s in specs]))


@pytest.mark.parametrize("rule", ["adam", "momentum"])
def test_parameter_updater_matches_jax(rule):
    """Three ParameterUpdater.step calls with global elementwise clipping
    at 0.3, L2 0.001, per-parameter multipliers/clips/decays, the momentum
    override and a static parameter, under the poly schedule; the state
    carried from the JAX side with opt_state_from_jax compares too."""
    jm, tm = _models()
    kw = dict(learning_method=rule, learning_rate=0.02, momentum=0.9,
              gradient_clipping_threshold=0.3, l2_weight=1e-3,
              learning_rate_schedule="poly", learning_rate_decay_a=0.01,
              learning_rate_decay_b=0.5)
    ju, tu = JUpdater(jm, JOpt(**kw)), ParameterUpdater(tm,
                                                        OptimizationConfig(**kw))
    rng = np.random.default_rng(1)
    params = {p.name: rng.normal(size=p.dims).astype(np.float32)
              for p in tm.parameters}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = ju.init_state(jp), tu.init_state(tp)
    assert "s" not in ts["slots"]
    for _ in range(3):
        grads = {k: (rng.normal(size=v.shape) * 0.5).astype(np.float32)
                 for k, v in params.items() if k != "s"}
        jp, js = ju.step(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                         js, 8)
        tp, ts = tu.step(tp, {k: _t(v) for k, v in grads.items()}, ts, 8)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **TOL, err_msg=k)
    assert torch.equal(tp["s"], _t(params["s"]))
    carried = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for k in ("num_samples", "num_updates", "pass_id"):
        assert ts[k] == carried[k]
    for name, slots in carried["slots"].items():
        for s, v in slots.items():
            np.testing.assert_allclose(ts["slots"][name][s].numpy(),
                                       v.numpy(), **TOL)
    assert tu.finish_pass(ts)["pass_id"] == 1


@pytest.mark.parametrize("options", ["accumulation", "pruning"])
def test_accumulation_and_pruning_updaters_match_jax(options, tmp_path):
    """Gradient accumulation (a window of 2, micro-batches of 8 and 4) and
    pruning hooks (by ratio and from a mask file) build and step like the
    JAX updater: four steps, each parameter within the Adam-step tolerance,
    the window's state and the masks carried by opt_state_from_jax."""
    jm, tm = _models()
    kw = dict(learning_method="adam", learning_rate=0.02,
              gradient_clipping_threshold=0.3)
    if options == "accumulation":
        kw["num_batches_per_send_parameter"] = 2
    else:
        mask = (np.arange(10) % 3 != 0).astype(np.float32).reshape(5, 2)
        np.save(tmp_path / "mask.npy", mask)
        for m in (jm, tm):
            m.parameters[0].update_hooks = [{"type": "pruning",
                                             "sparsity_ratio": 0.5}]
            m.parameters[2].update_hooks = [
                {"type": "pruning", "mask_filename": str(tmp_path /
                                                         "mask.npy")}]
    ju, tu = JUpdater(jm, JOpt(**kw)), ParameterUpdater(
        tm, OptimizationConfig(**kw))
    rng = np.random.default_rng(2)
    params = {p.name: rng.normal(size=p.dims).astype(np.float32)
              for p in tm.parameters}
    jp = ju.apply_init_hooks({k: jnp.asarray(v) for k, v in params.items()})
    tp = tu.apply_init_hooks({k: _t(v) for k, v in params.items()})
    js, ts = ju.init_state(jp), tu.init_state(tp)
    for step in range(4):
        bs = 8 if step % 2 == 0 else 4
        grads = {k: (rng.normal(size=v.shape) * 0.5).astype(np.float32)
                 for k, v in params.items() if k != "s"}
        jp, js = ju.step(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                         js, bs)
        tp, ts = tu.step(tp, {k: _t(v) for k, v in grads.items()}, ts, bs)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **TOL, err_msg=f"{k} step {step}")
    carried = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for k in ("num_samples", "num_updates", "grad_accum_count",
              "grad_accum_samples"):
        assert carried.get(k) == ts.get(k), k
    if options == "accumulation":
        assert ts["num_updates"] == 2 and ts["num_samples"] == 24
        assert set(carried["grad_accum"]) == set(ts["grad_accum"])
    else:
        for k, m in ts["masks"].items():
            assert torch.equal(m, carried["masks"][k]), k
            assert torch.equal(tp[k] * (1 - m), torch.zeros_like(tp[k])), k
