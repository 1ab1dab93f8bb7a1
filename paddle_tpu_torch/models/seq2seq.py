"""The attention seq2seq network: the port's parse of
demo/seqToseq/seqToseq_net.py (the reference's demo/seqToseq/seqToseq_net.py).

`seq2seq_trainer_config` is that config with these config args: the
demo's `settings(...)` (Adam, learning rate 5e-4, L2 3.2e-3, elementwise
gradient clipping at 25) and its data source (demo/seqToseq/seq_provider.py:
{"source_language_word", "target_language_word",
"target_language_next_word": ids [B, T] + lengths}); `generate` takes
{"source_language_word": ...}.

Encoder: a `hidden_dim` embedding of the source words, a forward and a
reversed `simple_gru` (a mixed full-matrix projection to 3 x hidden, then
`gated_recurrent`), their concat, its projection to hidden (encoded_proj),
and the decoder's boot state (tanh projection of the reversed GRU's first
step).  Decoder: the recurrent group "decoder_group" over the target
embedding with the encoder outputs as static links and the memory
"gru_decoder" — per step `additive_attention_step`, the mixed
decoder_inputs (context and word, each projected to 3 x hidden), `gru_step`
and the softmax over the vocabulary, decoder_prob.  Training ends in the
classification cost against the next words; generation replaces the target
embedding with the embedding of the previous generated word (the id memory
booted with BOS = 0) and beam-searches for EOS = 1.
"""

from __future__ import annotations

from paddle_tpu_torch.config.schema import TrainerConfig
from paddle_tpu_torch.models.demos import parse_demo

CONFIG = "seqToseq/seqToseq_net.py"


def seq2seq_trainer_config(dict_size: int, hidden_dim: int = 64,
                           batch_size: int = 0, is_generating: bool = False,
                           beam_size: int = 3, max_length: int = 12,
                           compute_dtype: str = "") -> TrainerConfig:
    """demo/seqToseq/seqToseq_net.py with these config args (batch_size 0:
    the demo's default, 32 for training and 8 for generation)."""
    return parse_demo(CONFIG, dict_size=dict_size, hidden_dim=hidden_dim,
                      batch_size=batch_size, is_generating=is_generating,
                      beam_size=beam_size, max_length=max_length,
                      compute_dtype=compute_dtype)
