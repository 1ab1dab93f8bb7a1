from paddle_tpu_torch.utils.flags import FLAGS, define_flag, parse_flags  # noqa: F401
from paddle_tpu_torch.utils.logger import get_logger  # noqa: F401
