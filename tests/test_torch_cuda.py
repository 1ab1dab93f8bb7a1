"""PyTorch port on the card: the CUDA paged-attention kernel against its
plain version, and the engine on CUDA against the engine on the CPU.

These need an NVIDIA GPU and nvcc, and import nothing of JAX, so they run
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card they skip."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.graph import GraphExecutor
from paddle_tpu_torch.models import transformer_lm_config
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.parameter import init_params
from paddle_tpu_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,h_kv,D,ps", [(8, 8, 64, 16), (8, 2, 64, 8),
                                         (6, 3, 40, 32), (4, 1, 128, 48)])
def test_kernel_matches_plain_version(cuda, dtype, atol, H, h_kv, D, ps):
    """Ragged rows (a chunk, decode rows, padding rows), GQA, head dims
    that are not a multiple of 32, pages longer than a warp."""
    g = torch.Generator(device=cuda).manual_seed(0)
    S, maxp = 5, 6
    P = 1 + S * maxp
    k = torch.randn(P, ps, h_kv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(P, ps, h_kv, D, generator=g, device=cuda).to(dtype)
    lens = [1, maxp * ps, 17, 2 * ps, ps + 1]
    table = torch.zeros(S + 1, maxp, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))
    for s, n in enumerate(lens):
        npg = -(-n // ps)
        table[s, :npg] = perm[s * maxp:s * maxp + npg] + 1
    row_slot = [1] * 9 + [0, 2, 3, 4, S, S]
    lengths = list(range(maxp * ps - 8, maxp * ps + 1)) + [1, 17, 2 * ps,
                                                           ps + 1, 1, 1]
    row_slot = torch.tensor(row_slot, dtype=torch.int32, device=cuda)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn(len(row_slot), H, D, generator=g, device=cuda).to(dtype)
    table = table.to(cuda)
    before = pa.counts.kernel
    got = pa.paged_attention(q, k, v, table, lengths, row_slot=row_slot)
    torch.cuda.synchronize()
    assert pa.counts.kernel == before + 1
    want = pa.paged_attention_plain(q.float(), k.float(), v.float(), table,
                                    lengths, row_slot=row_slot)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert float((got.float() - want).abs().max()) <= atol


def test_engine_on_cuda_matches_cpu(cuda):
    """Greedy float32 serving through the kernel on the card gives the
    CPU engine's (plain version's) tokens, and every step launched the
    kernel once per attention layer."""
    model = transformer_lm_config(vocab=97, dim=64, layers=2, heads=4,
                                  kv_heads=2)
    ex = GraphExecutor(model)
    params = init_params(model, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(2, 97, n), m) for i, (n, m) in
            enumerate(zip((5, 30, 12, 70, 3), (9, 4, 12, 6, 10)))]
    out = {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(ex, params, num_slots=3, page_size=8,
                            max_context=96, device=dev)
        pa.counts.reset()
        out[str(dev)] = eng.run([Request(i, p, max_new=m)
                                 for i, p, m in reqs])
        eng.kv.check()
    assert pa.counts.kernel == 2 * eng.n_decode_steps and \
        pa.counts.plain == 0
    for i, _, _ in reqs:
        np.testing.assert_array_equal(out["cuda"][i], out["cpu"][i])
