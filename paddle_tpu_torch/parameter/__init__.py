from paddle_tpu_torch.parameter.argument import Argument  # noqa: F401
from paddle_tpu_torch.parameter.init import (  # noqa: F401
    init_params,
    opt_state_from_jax,
    params_from_jax,
)
