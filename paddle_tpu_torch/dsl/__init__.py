"""User-facing configuration DSL — the port's copy of paddle_tpu/dsl/.

The equivalent of the reference's
`trainer_config_helpers` package (ref: python/paddle/trainer_config_helpers/):
layer constructors that assemble a ModelConfig, optimizer `settings()`,
activation/pooling/attr descriptor classes, and composite networks.
Configs written for the JAX package (`from paddle_tpu.dsl import *`) run
against these modules through config/parser.py, which binds the
`paddle_tpu` names to them while a config runs.
"""

from paddle_tpu_torch.dsl.activations import *  # noqa: F401,F403
from paddle_tpu_torch.dsl.attrs import (  # noqa: F401
    ExtraAttr, ExtraLayerAttribute, ParamAttr, ParameterAttribute,
)
from paddle_tpu_torch.dsl.poolings import *  # noqa: F401,F403
from paddle_tpu_torch.dsl.layers import *  # noqa: F401,F403
from paddle_tpu_torch.dsl.optimizers import *  # noqa: F401,F403
from paddle_tpu_torch.dsl.networks import *  # noqa: F401,F403
from paddle_tpu_torch.dsl.evaluators import *  # noqa: F401,F403
from paddle_tpu_torch.dsl.default_decorators import (  # noqa: F401
    wrap_act_default, wrap_bias_attr_default, wrap_name_default,
    wrap_param_attr_default, wrap_param_default,
)
from paddle_tpu_torch.dsl.data_sources import (  # noqa: F401
    define_multi_py_data_sources2, define_ptsh_data_sources,
    define_py_data_sources2,
)
# legacy recurrent building blocks: use as
# `from paddle_tpu_torch.dsl import recurrent_units` (the reference's
# `import trainer.recurrent_units` form)
from paddle_tpu_torch.dsl import recurrent_units  # noqa: F401
