"""PyTorch port: the config DSL and its parser against the JAX package's.

Every config file under demo/ that builds a model, and tests/configs/*.py,
parsed by both (a case per file and config-args set): the whole to_dict()
form of the TrainerConfig is equal, and a config the JAX parse rejects is
rejected by the port with the same exception type.  The frozen layer-type
and activation names equal the JAX registries' keys.  While a config runs,
the port binds the JAX package's names to its own modules and restores
`sys.modules` afterwards (the subprocess tests start from a clean
interpreter)."""

import os
import subprocess
import sys
import textwrap

import pytest

from paddle_tpu.config.parser import parse_config as jax_parse_config
from paddle_tpu_torch.config.parser import parse_config, parse_config_args
from paddle_tpu_torch.dsl.activations import ACTIVATION_TYPES
from paddle_tpu_torch.dsl.layers import LAYER_TYPES, LayerType
from paddle_tpu_torch.utils.geometry import conv_output_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (config file, config args): the 25 files and the args sets that change
# what they build
CONFIGS = [
    ("demo/distributed/mlp_dist.py", ""),
    ("demo/distributed/mlp_dist.py", "dim=16,hidden=24,classes=4,l2=0.01"),
    ("demo/image_classification/vgg_16_cifar.py", ""),
    ("demo/image_classification/vgg_16_cifar.py", "is_predict=1"),
    ("demo/introduction/trainer_config.py", ""),
    ("demo/mnist/mlp_mnist.py", ""),
    ("demo/mnist/mlp_mnist.py", "is_test=1"),
    ("demo/mnist/mlp_mnist_pp.py", "micro_batches=2"),
    ("demo/mnist/vgg_16_mnist.py", ""),
    ("demo/model_zoo/resnet.py", ""),
    ("demo/model_zoo/resnet.py", "layer_num=101,is_predict=1"),
    ("demo/model_zoo/transformer_lm.py", ""),
    ("demo/model_zoo/transformer_lm.py",
     "vocab=32000,dim=512,layers=8,heads=8,attn_impl=flash,"
     "compute_dtype=bfloat16"),
    ("demo/model_zoo/transformer_lm.py", "kv_heads=2,window=5,block_k_min=16"),
    ("demo/quick_start/trainer_config.bidi-lstm.py", ""),
    ("demo/quick_start/trainer_config.cnn.py", ""),
    ("demo/quick_start/trainer_config.db-lstm.py", ""),
    ("demo/quick_start/trainer_config.db-lstm.py", "depth=4,is_predict=1"),
    ("demo/quick_start/trainer_config.emb.py", ""),
    ("demo/quick_start/trainer_config.lr.py", ""),
    ("demo/quick_start/trainer_config.lstm.py", ""),
    ("demo/quick_start/trainer_config.resnet-lstm.py", ""),
    ("demo/recommendation/trainer_config.py", ""),
    ("demo/semantic_role_labeling/db_lstm.py", ""),
    ("demo/sentiment/trainer_config.py", ""),
    ("demo/sentiment/trainer_config.py", "net=bidi"),
    ("demo/sentiment/trainer_config.py", "net=stacked,is_predict=1"),
    ("demo/seqToseq/seqToseq_net.py", ""),
    ("demo/seqToseq/seqToseq_net.py", "is_generating=1"),
    ("demo/seqToseq/seqToseq_net.py",
     "dict_size=30000,hidden_dim=512,batch_size=64"),
    ("demo/sequence_tagging/linear_crf.py", ""),
    ("demo/sequence_tagging/rnn_crf.py", ""),
    ("tests/configs/sequence_nest_rnn.py", ""),
    ("tests/configs/sequence_nest_rnn_multi_input.py", ""),
    ("tests/configs/sequence_rnn.py", ""),
    ("tests/configs/sequence_rnn_multi_input.py", ""),
]


def test_every_model_config_file_is_a_case():
    """The cases cover every file that imports the DSL (sentiment_net.py is
    a helper the sentiment config imports) — 25 files."""
    files = set()
    for root in ("demo", "tests/configs"):
        for dirpath, _, names in os.walk(os.path.join(REPO, root)):
            for n in names:
                path = os.path.join(dirpath, n)
                if n.endswith(".py") and "import *" in open(path).read() \
                        and "paddle_tpu.dsl" in open(path).read():
                    files.add(os.path.relpath(path, REPO))
    files.discard("demo/sentiment/sentiment_net.py")
    assert files == {path for path, _ in CONFIGS}
    assert len(files) == 25


@pytest.mark.parametrize("case", CONFIGS,
                         ids=[f"{p}[{a}]" for p, a in CONFIGS])
def test_parse_equals_the_jax_parse(case):
    path, args = case
    want = jax_parse_config(path, args)
    got = parse_config(path, args)
    assert type(got).__module__ == "paddle_tpu_torch.config.schema"
    assert got.to_dict() == want.to_dict()


REJECTED = {
    "unknown_activation": """
        from paddle_tpu.dsl import *
        from paddle_tpu.dsl import recurrent_units
        x = data_layer(name="x", size=8)
        recurrent_units.LstmRecurrentUnit("u", 4, active_type="bogus")
        """,
    "duplicate_layer": """
        from paddle_tpu.dsl import *
        data_layer(name="x", size=8)
        data_layer(name="x", size=8)
        """,
    "bad_heads": """
        from paddle_tpu.dsl import *
        x = data_layer(name="x", size=30)
        multi_head_attention_layer(x, size=30, num_heads=4)
        """,
    "syntax": "settings(\n",
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_a_config_the_jax_parse_rejects_the_port_rejects(name, tmp_path):
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(REJECTED[name]))
    with pytest.raises(Exception) as jax_err:
        jax_parse_config(str(path))
    with pytest.raises(Exception) as port_err:
        parse_config(str(path))
    assert type(port_err.value) is type(jax_err.value)


def test_frozen_names_equal_the_jax_registries():
    import paddle_tpu.graph.builder  # noqa: F401 — fills the registry
    from paddle_tpu.dsl.layers import LayerType as JLayerType
    from paddle_tpu.graph.registry import layer_registry
    from paddle_tpu.ops.activations import activation_registry
    assert sorted(LAYER_TYPES) == sorted(layer_registry)
    assert len(set(LAYER_TYPES)) == len(LAYER_TYPES)
    assert sorted(ACTIVATION_TYPES) == sorted(activation_registry)
    for name in list(LAYER_TYPES) + ["bogus", "lstmemory_v9"]:
        assert LayerType.is_layer_type(name) == JLayerType.is_layer_type(name)


def test_conv_output_size_equals_the_jax_copy():
    from paddle_tpu.graph.layers_conv import conv_output_size as jax_cos
    for args in [(32, 3, 1, 1), (224, 7, 2, 3), (7, 3, 2, 0), (5, 5, 1, 0)]:
        for caffe in (True, False):
            assert conv_output_size(*args, caffe) == jax_cos(*args, caffe)


def test_config_args_text():
    assert parse_config_args("a=1, b = x,,c=") == {"a": "1", "b": "x",
                                                    "c": ""}


def _run(*parts: str) -> str:
    """Run the code of `parts` (each dedented) in a new interpreter from
    the repo root; its stdout."""
    env = dict(os.environ, PYTHONPATH=REPO)
    code = "".join(textwrap.dedent(p) for p in parts)
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_jax_parse_then_a_port_parse_restores_sys_modules():
    """The JAX parse first leaves sentiment_net (imported by the config)
    bound to the JAX DSL, and the JAX provider loader the sentiment
    provider module; the port's parse and provider loader import both
    afresh under the port's names and build the port's config and
    provider, and afterwards every entry of sys.modules, and the package
    attributes imports set, are as before."""
    out = _run("""
        import sys
        from paddle_tpu.config.parser import parse_config as jparse
        from paddle_tpu.trainer.trainer import load_provider as jload
        from paddle_tpu_torch.config.parser import parse_config
        from paddle_tpu_torch.trainer.trainer import load_provider
        cfg = "demo/sentiment/trainer_config.py"
        want = jparse(cfg, "net=bidi")
        jprov, _ = jload(want.data_config)
        import demo.sentiment
        before = dict(sys.modules)
        attrs = dict(vars(demo.sentiment))
        got = parse_config(cfg, "net=bidi")
        assert got.to_dict() == want.to_dict()
        assert type(got).__module__ == "paddle_tpu_torch.config.schema"
        prov, _ = load_provider(got.data_config)
        assert type(prov).__module__ == "paddle_tpu_torch.data.provider"
        assert type(jprov).__module__ == "paddle_tpu.data.provider"
        after = dict(sys.modules)
        assert after.keys() == before.keys(), after.keys() ^ before.keys()
        assert all(after[n] is before[n] for n in before)
        assert dict(vars(demo.sentiment)) == attrs
        assert sys.modules["sentiment_net"].data_layer.__module__ == \\
            "paddle_tpu.dsl.layers"
        assert sys.modules["paddle_tpu.dsl"].__file__.endswith(
            "paddle_tpu/dsl/__init__.py")
        # and the other way round: a second JAX parse still builds JAX's
        again = jparse(cfg, "net=bidi")
        assert type(again).__module__ == "paddle_tpu.config.schema"
        assert again.to_dict() == want.to_dict()
        print("ok")
        """)
    assert out.strip().endswith("ok")


def test_the_first_parse_keeps_the_bound_subpackages():
    """The first parse of a process, with only the parser imported: the
    port's data and DSL modules it binds stay imported afterwards, so the
    provider classes a config reaches under the JAX package's names are
    the ones a later import of the port gets (one SlotKind, one
    SeqType)."""
    out = _run("""
        import sys
        from paddle_tpu_torch.config.parser import (bound_config_names,
                                                    parse_config)
        with bound_config_names():
            from paddle_tpu.data.provider import SeqType as bound
        parse_config("demo/sentiment/trainer_config.py", "")
        from paddle_tpu_torch.data.provider import SeqType, SlotKind
        from paddle_tpu_torch.data import feeder
        assert bound is SeqType
        assert feeder.SeqType is SeqType and feeder.SlotKind is SlotKind
        print("ok")
        """)
    assert out.strip().endswith("ok")


IMPORT_GUARD = """
    import sys

    class NoJax:
        '''Refuses any import of jax or of the JAX package.'''
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "paddle_tpu"):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, NoJax())
"""


def test_the_port_path_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Under an import hook that refuses jax and the JAX package: the
    port's parse of the demo configs, a pass of batches from the
    sentiment provider's feeder, and a CLI training step."""
    out = _run(IMPORT_GUARD, f"""
        from paddle_tpu_torch.config.parser import parse_config
        from paddle_tpu_torch.trainer.trainer import make_feeder
        from paddle_tpu_torch.__main__ import main
        for cfg in ("demo/sentiment/trainer_config.py",
                    "demo/seqToseq/seqToseq_net.py",
                    "demo/model_zoo/transformer_lm.py",
                    "demo/quick_start/trainer_config.lr.py"):
            parse_config(cfg, "")
        c = parse_config("demo/sentiment/trainer_config.py", "")
        n = sum(1 for _ in make_feeder(c, c.data_config, True).batches())
        assert n == 16, n
        rc = main(["train", "--config=demo/model_zoo/transformer_lm.py",
                   "--config_args=vocab=64,dim=16,layers=1,heads=2",
                   "--use_gpu=false", "--save_dir={tmp_path}"])
        assert rc == 0
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
        print("ok")
        """)
    assert out.strip().endswith("ok")
