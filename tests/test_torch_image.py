"""PyTorch port: the image classification configs against the JAX package
on the CPU — demo/image_classification/vgg_16_cifar.py and
demo/mnist/vgg_16_mnist.py (small_vgg, batch 4) and demo/model_zoo/
resnet.py (ResNet-50) — through the JAX package's Trainer and executor and
the port's, from the same parameters (`params_from_jax`): one TRAIN step's
loss and every gradient, parameters and batch-norm state after two Trainer
steps (VGG's dropout masks drawn by JAX and fed to the port), the TEST
output on the moving statistics, checkpoints both ways; the fused
dispatch at k = 4 against k = 1, a bfloat16 step, and the CLI training
MNIST from its file.

The comparisons run in float64 on both sides (the JAX side under
enable_x64), ResNet-50 at 64 x 64, 10 classes, batch 4.  Its batch norms
over the last stages' small maps (2 x 2 here, 4 values a channel a
sample) amplify rounding differences a thousandfold per stage: the port
in float32 and the port in float64 already disagree by ~9% in some
gradients at this size (and entirely at 32 x 32 and batch 2, where the
last map is 1 x 1), so a float32 comparison of the two implementations
would measure that amplification, not the port.  In float32 the VGGs'
second step also meets ReLU kinks that rounding puts on either side (a
cotangent entry present on one side, absent on the other).  The float32
layers are held one by one in tests/test_torch_conv.py, bfloat16 below.

Limits (float64): losses within rtol 1e-7, each gradient within 1e-6 of
its max |value| (the bias of a layer feeding a batch norm has a zero
gradient in exact arithmetic: both sides' rounding noise within 1e-6 of
the largest gradient entry), each parameter's two-step update, the moving
statistics and the TEST probabilities within 1e-5 of their max |value|.
Checkpoints carry every array bit for bit."""

import os
import queue
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config.parser import parse_config as jax_parse_config
from paddle_tpu.parameter.argument import Argument as JArgument
from paddle_tpu.trainer.trainer import Trainer as JTrainer
from paddle_tpu.utils.jax_compat import enable_x64
from paddle_tpu_torch.graph import TEST
from paddle_tpu_torch.models import (resnet_config, vgg_16_cifar_config,
                                     vgg_16_mnist_config)
from paddle_tpu_torch.parameter import Argument, params_from_jax
from paddle_tpu_torch.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CIFAR = "demo/image_classification/vgg_16_cifar.py"
MNIST = "demo/mnist/vgg_16_mnist.py"
RESNET = "demo/model_zoo/resnet.py"
B = 4

# name -> (config file, --config_args, the port's builder, image slot,
#          row width)
CONFIGS = {
    "cifar": (CIFAR, f"batch_size={B}", lambda: vgg_16_cifar_config(B),
              "image", 3 * 32 * 32),
    "mnist": (MNIST, f"batch_size={B}", lambda: vgg_16_mnist_config(B),
              "pixel", 28 * 28),
    "resnet": (RESNET, f"image_size=64,num_classes=10,batch_size={B}",
               lambda: resnet_config(image_size=64, num_classes=10,
                                     batch_size=B),
               "image", 3 * 64 * 64),
}
LOSS_RTOL = 1e-7
GRAD_SHARE = 1e-6       # of each gradient's max |value|
SHARE = 1e-5            # updates, statistics, outputs


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Many small ops: two torch threads keep them from spinning against
    the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches(n, slot, dim, dt, seed):
    rng = np.random.default_rng(seed)
    return [(slot, rng.standard_normal((B, dim)).astype(dt),
             rng.integers(0, 10, B).astype(np.int32)) for _ in range(n)]


def _jbatch(b):
    slot, x, y = b
    return {slot: JArgument(value=jnp.asarray(x)),
            "label": JArgument(ids=jnp.asarray(y))}


def _tbatch(b):
    slot, x, y = b
    return {slot: Argument(value=x), "label": Argument(ids=y)}


def _jax_masks(model, key):
    """The keep-masks the JAX forward draws from `key` (one
    bernoulli(fold_in(key, k), 1 - p) per layer with dropout, k counting
    them in config order); small_vgg's two dropout layers are rows."""
    masks, k = {}, 0
    for layer in model.layers:
        if layer.drop_rate > 0:
            k += 1
            masks[layer.name] = torch.from_numpy(np.array(
                jax.random.bernoulli(jax.random.fold_in(key, k),
                                     1.0 - layer.drop_rate,
                                     (B, layer.size))))
    return masks


def _bn_width(layer) -> int:
    """A batch norm's statistics: per channel of an image, else per
    feature."""
    if layer.conv is not None and layer.conv.img_size > 0:
        return layer.conv.channels
    return layer.size


def _share(got, want, what=""):
    """max |got - want| as a share of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _np(tree):
    """A copy of a state tree as numpy arrays (the port's tensors are
    updated in place by later steps)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy() if torch.is_tensor(tree) \
        else np.array(tree)


def _run(name, tmp):
    """Everything the JAX package computes for one config, beside the
    port's results, in one pass (the JAX side compiles once)."""
    path, args, build, slot, dim = CONFIGS[name]
    out = {}
    jtr = JTrainer(jax_parse_config(path, args), seed=3)
    out["jax_init"] = _np(jtr.params)
    jtr.params = {k: jnp.asarray(np.asarray(v), jnp.float64)
                  for k, v in jtr.params.items()}
    jtr.opt_state = jax.tree.map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
        jtr.opt_state)
    ttr = Trainer(build(), device="cpu", params=params_from_jax(
        {k: np.asarray(v) for k, v in jtr.params.items()}, device="cpu"))
    b0, b1, b2, bt = _batches(4, slot, dim, np.float64, seed=len(name))

    # one TRAIN step's loss and gradients, from the fresh state
    key = jax.random.PRNGKey(5)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.executor.loss(p, b, {}, "train", key)[0]))
    jl, jg = vg(jtr.params, _jbatch(b0))
    loss, grads, _ = ttr.compute_gradients(
        ttr.prepare_batch(_tbatch(b0)),
        dropout_masks=_jax_masks(ttr.model, key))
    out["step"] = (float(jl), _np(jg), float(loss), _np(grads))
    ttr.net_state = {}

    # two Trainer steps, the masks of the key each JAX step uses; the JAX
    # trainer starts from the fresh state the port's first step creates
    # (mean 0, variance 1, count 0), so that its two steps share one
    # compiled signature
    jtr.net_state = {l.name: {"mean": jnp.zeros(_bn_width(l)),
                              "var": jnp.ones(_bn_width(l)),
                              "count": jnp.zeros(())}
                     for l in ttr.model.layers if l.type == "batch_norm"}
    out["init"] = _np(ttr.params)
    losses = []
    for b in (b1, b2):
        step_key = jax.random.split(jtr.rng)[1]
        losses.append((float(jtr.train_one_batch(_jbatch(b))), float(
            ttr.train_one_batch(_tbatch(b), dropout_masks=_jax_masks(
                ttr.model, step_key)))))
    out["losses"] = losses
    out["params"] = (_np(jtr.params), _np(ttr.params))
    out["net"] = (_np(jtr.net_state), _np(ttr.net_state))

    # the TEST output on the moving statistics
    oname = ttr.model.evaluators[0].input_layer_names[0]
    want = jax.jit(lambda p, n, b: jtr.executor.forward(
        p, b, n, "test")[0][oname].value)(jtr.params, jtr.net_state,
                                          _jbatch(bt))
    got, _, state = ttr.executor.forward(
        ttr.params, ttr.prepare_batch(_tbatch(bt)), ttr.net_state, TEST)
    out["test"] = (np.asarray(want), _np(got[oname].value),
                   state is not None and all(
                       state[n][k] is ttr.net_state[n][k]
                       for n in ttr.net_state for k in ttr.net_state[n]))
    out["test_cost"] = (float(np.mean(-np.log(np.maximum(
        np.asarray(want)[np.arange(B), bt[2]], 1e-10)))),
        ttr.test([_tbatch(bt)])["cost"])

    # checkpoints: the JAX save into another port Trainer, the port's save
    # into the JAX Trainer
    jdir = jtr.save(str(tmp / "jax"))
    port = Trainer(build(), device="cpu", params={
        n: v.clone() for n, v in ttr.params.items()})
    port.load(jdir)
    out["jax_to_port"] = (_np(jtr.params), _np(jtr.net_state),
                          _np(port.params), _np(port.net_state))
    ttr.train_one_batch(_tbatch(b0), dropout_masks=_jax_masks(
        ttr.model, key))
    tdir = ttr.save(str(tmp / "port"))
    jtr.load(tdir)          # its last use: the port's save replaces it all
    out["port_to_jax"] = (_np(ttr.params), _np(ttr.net_state),
                          _np(jtr.params), _np(jtr.net_state))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            with enable_x64():
                cache[name] = _run(name, tmp_path_factory.mktemp(name))
        return cache[name]
    return get


@pytest.mark.parametrize("path,args,build", [
    (CIFAR, "", lambda: vgg_16_cifar_config()),
    (CIFAR, "batch_size=4,compute_dtype=bfloat16",
     lambda: vgg_16_cifar_config(4, compute_dtype="bfloat16")),
    (CIFAR, "is_predict=1", lambda: vgg_16_cifar_config(is_predict=True)),
    (MNIST, "", lambda: vgg_16_mnist_config()),
    (RESNET, "", lambda: resnet_config()),
    (RESNET, "layer_num=101,image_size=64,num_classes=10",
     lambda: resnet_config(101, 64, 10)),
    (RESNET, "is_predict=1", lambda: resnet_config(is_predict=True)),
], ids=["cifar", "cifar-bf16", "cifar-predict", "mnist", "resnet50",
        "resnet101-small", "resnet-predict"])
def test_builders_equal_the_dsl_parse(path, args, build):
    """The model and optimization configs equal the JAX package's parse of
    the demo file."""
    want = jax_parse_config(path, args)
    got = build()
    assert got.model_config.to_dict() == want.model_config.to_dict()
    assert got.opt_config.to_dict() == want.opt_config.to_dict()


def test_full_width_graph_census():
    """ResNet-50 at its defaults: 53 convs, each followed by a batch norm,
    16 shortcut sums, 25,557,032 parameters (torchvision's resnet50 count); small_vgg: 11 batch norms (10 on
    images, one on the fc rows), 5 pools."""
    m = resnet_config().model_config
    types = [l.type for l in m.layers]
    assert (types.count("exconv"), types.count("batch_norm"),
            types.count("addto"), types.count("pool")) == (53, 53, 16, 2)
    assert sum(p.size for p in m.parameters) == 25_557_032
    m = vgg_16_cifar_config().model_config
    bns = [l for l in m.layers if l.type == "batch_norm"]
    assert len(bns) == 11 and sum(l.conv is None for l in bns) == 1
    assert [l.type for l in m.layers].count("pool") == 5


def _bn_fed_biases(name) -> set:
    """The biases of the layers that feed a batch norm: their gradient is
    zero in exact arithmetic (the norm takes out any per-channel constant),
    so both sides give rounding noise for it."""
    model = CONFIGS[name][2]().model_config
    by_name = {l.name: l for l in model.layers}
    return {by_name[l.inputs[0].input_layer_name].bias_parameter_name
            for l in model.layers if l.type == "batch_norm"} - {""}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_match_the_jax_initialization(runs, name):
    """init_params gives every parameter the JAX initializer's shape and
    dtype; the deterministic ones its values exactly (batch-norm scales
    1, biases 0), the random ones their spread (std within 10% where the
    tensor has 1000+ entries)."""
    from paddle_tpu_torch.parameter import init_params
    want = runs(name)["jax_init"]
    got = init_params(CONFIGS[name][2]().model_config, seed=3, device="cpu")
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, n
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=n)
        elif w.size >= 1000:
            assert abs(g.std() / w.std() - 1) < 0.1, n
    bn = [n for n in want if n.endswith(".w0") and "batch_norm" in n
          or n.endswith("_bn.w0")]
    assert bn and all((want[n] == 1).all() for n in bn)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_step_loss_and_gradients_match_jax(runs, name):
    jl, jg, tl, tg = runs(name)["step"]
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    assert set(tg) == set(jg)
    top = max(float(np.abs(v).max()) for v in jg.values())
    zero = _bn_fed_biases(name)
    for n, g in tg.items():
        if n in zero:
            assert max(np.abs(g).max(), np.abs(jg[n]).max()) \
                <= GRAD_SHARE * top
            continue
        assert np.abs(jg[n]).max() > 0, n
        assert _share(g, jg[n], n) <= GRAD_SHARE, n


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_steps_parameters_and_batch_norm_state_match_jax(runs, name):
    """Two Trainer steps (momentum 0.9, L2, the config's learning rate;
    VGG's dropout masks as JAX drew them): losses, every parameter's
    update (after - before; the biases feeding a batch norm move by
    rounding noise only, within 1e-6 of the largest update on both
    sides), every layer's moving mean and variance, and the counts (2)."""
    r = runs(name)
    for jl, tl in r["losses"]:
        assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    p0 = r["init"]
    jp, tp = r["params"]
    top = max(float(np.abs(jp[n] - p0[n]).max()) for n in jp)
    zero = _bn_fed_biases(name)
    for n in jp:
        ju, tu = jp[n] - p0[n], tp[n] - p0[n]
        if n in zero:
            assert max(np.abs(ju).max(), np.abs(tu).max()) <= 1e-6 * top, n
            continue
        assert _share(tu, ju, n) <= SHARE, n
    jn, tn = r["net"]
    assert set(tn) == set(jn) and len(tn) in (11, 53)
    for layer, st in jn.items():
        assert set(tn[layer]) == {"mean", "var", "count"}
        assert float(tn[layer]["count"]) == float(st["count"]) == 2.0
        for k in ("mean", "var"):
            assert _share(tn[layer][k], st[k], f"{layer}.{k}") <= SHARE


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_test_output_on_moving_statistics_matches_jax(runs, name):
    """The TEST forward after the two steps normalizes by the moving
    statistics: class probabilities equal the JAX side's, the state is
    handed on as the same tensors, and test()'s cost is the cross-entropy
    of the JAX side's probabilities."""
    r = runs(name)
    want, got, same_state = r["test"]
    assert _share(got, want) <= SHARE
    assert same_state
    want_cost, cost = r["test_cost"]
    assert cost == pytest.approx(want_cost, rel=LOSS_RTOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_carry_batch_norm_state_both_ways(runs, name,
                                                      direction):
    """A checkpoint either side saves loads on the other: parameters and
    the moving mean, variance and count (`net|<layer>|<stat>`), bit for
    bit."""
    sp, sn, dp, dn = runs(name)[direction]
    assert set(dp) == set(sp) and set(dn) == set(sn) and sn
    for n in sp:
        np.testing.assert_array_equal(dp[n], sp[n], err_msg=n)
    for layer in sn:
        for k in ("mean", "var", "count"):
            np.testing.assert_array_equal(dn[layer][k], sn[layer][k],
                                          err_msg=f"{layer}.{k}")


def _pass(tr, batches, k):
    stats = tr.train_one_pass([_tbatch(b) for b in batches],
                              steps_per_dispatch=k)
    return {n: v for n, v in stats.items()
            if n not in ("seconds", "samples_per_sec")}


@pytest.mark.parametrize("name,n", [("cifar", 6), ("resnet-32", 5)])
def test_fused_dispatch_equals_the_k1_loop(name, n):
    """train_one_pass(steps_per_dispatch=4) on a batch-norm model against
    the k = 1 loop from one seed, two passes of n batches (groups of 4 and
    the rest): pass statistics, parameters, momentum slots and every
    layer's moving statistics bit for bit; the eager step writes the
    state tensors it created in place."""
    if name == "cifar":
        build = CONFIGS["cifar"][2]
    else:
        def build():
            return resnet_config(image_size=32, num_classes=10, batch_size=B)
    batches = _batches(n, "image", 3 * 32 * 32, np.float32, seed=2)
    ref, tr = Trainer(build(), device="cpu"), Trainer(build(), device="cpu")
    for p in range(2):
        assert _pass(ref, batches, 1) == _pass(tr, batches, 4)
        if p == 0:
            first = {(layer, k): t for layer, st in tr.net_state.items()
                     for k, t in st.items()}
    for pname, v in ref.params.items():
        assert torch.equal(v, tr.params[pname]), pname
    for pname, sl in ref.opt_state["slots"].items():
        for k, v in sl.items():
            assert torch.equal(v, tr.opt_state["slots"][pname][k]), (pname, k)
    assert ref.net_state.keys() == tr.net_state.keys()
    for layer, st in ref.net_state.items():
        for k, v in st.items():
            assert torch.equal(v, tr.net_state[layer][k]), (layer, k)
            assert tr.net_state[layer][k] is first[(layer, k)]
        assert float(st["count"]) == 2 * n
    assert tr.n_fused_dispatches == 4


def test_bfloat16_step_keeps_statistics_in_float32():
    """compute_dtype=bfloat16 on the CIFAR VGG: images and convolutions in
    bfloat16, batch-norm statistics and the moving state in float32, the
    outputs back in bfloat16; TEST probabilities within 2e-2 of the JAX
    side's bfloat16 forward, and a TRAIN step gives finite float32 master
    gradients."""
    jtr = JTrainer(jax_parse_config(CIFAR, f"batch_size={B},"
                                    "compute_dtype=bfloat16"), seed=3)
    tr = Trainer(vgg_16_cifar_config(B, compute_dtype="bfloat16"),
                 device="cpu", params=params_from_jax(
                     {k: np.asarray(v) for k, v in jtr.params.items()},
                     device="cpu"))
    b = _batches(1, "image", 3072, np.float32, seed=4)[0]
    feed = tr.prepare_batch(_tbatch(b))
    loss, grads, out = tr.compute_gradients(feed)
    assert np.isfinite(float(loss))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values())
    bn = "__batch_norm_0__"
    assert out[bn].image and out[bn].value.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for st in tr.net_state.values()
               for t in st.values())
    name = tr.model.evaluators[0].input_layer_names[0]
    want = jax.jit(lambda p, b: jtr.executor.forward(
        p, b, None, "test")[0][name].value)(jtr.params, _jbatch(b))
    got, _, _ = tr.executor.forward(tr.params, feed)
    assert got[name].value.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got[name].value.float().numpy(),
        np.asarray(want.astype(jnp.float32)), atol=2e-2)


def test_cli_trains_mnist_from_its_file(tmp_path):
    """`python -m paddle_tpu_torch train --config=demo/mnist/
    vgg_16_mnist.py --use_gpu=false` in a subprocess, from the repo root,
    on the config's own provider (synthetic digits without the dataset):
    it logs three batches with finite, falling-or-not costs, then is
    stopped (a whole pass is 1024 batches of 8 on the CPU)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "train",
         f"--config={MNIST}", "--use_gpu=false", "--config_args=batch_size=8",
         "--log_period=1", f"--save_dir={tmp_path}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    costs, seen = [], []
    try:
        while len(costs) < 3:
            line = lines.get(timeout=240)
            seen.append(line)
            if " batch " in line and "cost=" in line:
                costs.append(float(line.split("cost=")[1].split()[0]))
    except queue.Empty:
        pytest.fail("the CLI logged no batch in time:\n" + "".join(seen))
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert any("device cpu" in ln for ln in seen)
    assert np.isfinite(costs).all() and costs[0] > 0
