"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

Module names mirror the JAX package (paddle_tpu/) so each port module's
counterpart is easy to find.  The port imports torch and never jax, nor
anything of paddle_tpu.  Its entry points run on the CUDA card unless the
caller passes device="cpu" (device.py).  Slice 1 serves the decoder-only
transformer LM through a continuous-batching engine with paged KV, reading
attention through a hand-written CUDA kernel (csrc/paged_attention.cu);
slice 2 trains it (trainer.Trainer, optim/), long-context attention going
through hand-written flash-attention kernels, forward and backward
(csrc/flash_attention.cu); slice 3 trains and runs the IMDB sentiment LSTM
nets (models/sentiment.py), the recurrence going through hand-written
fused-LSTM kernels, forward and backward (csrc/lstm.cu); later slices add
the seq2seq (GRU and additive-attention kernels), k steps per dispatch as
CUDA graphs, and (slice 11) the user's own surface: the config DSL
(dsl/), its parser (config/parser.py), the data provider and feeder
(data/) and the CLI, `python -m paddle_tpu_torch train --config=...`
(trainer_main.py); the model builders of models/ parse the demo configs.
"""

__version__ = "0.1.0"

from paddle_tpu_torch.device import resolve_device  # noqa: F401
