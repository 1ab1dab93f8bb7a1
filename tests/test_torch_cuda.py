"""PyTorch port on the card: the CUDA paged-attention, flash-attention,
fused-LSTM, fused-GRU and additive-attention kernels against their plain
versions, the engine on CUDA against the engine on the CPU, and training
steps and the beam search on CUDA against the same on the CPU.

These need an NVIDIA GPU and nvcc, and import nothing of JAX, so they run
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card they skip."""

import numpy as np
import pytest
import torch

from chip_smoke import (ADD_CASES, ADD_LIMIT_BF16, ADD_TOL_F32, GRAD_TOL,
                        GRU_TOL, K5_ATOL, K5_EDGE, LSTM_TOL, additive_error,
                        additive_inputs, check_launches, cli_pair,
                        cli_test_round_trip, flash_graph_replay,
                        flash_repeats, flash_route, graph_replays,
                        graph_replay_equal, gru_compare, gru_inputs,
                        gru_move_off_relu_kink, gru_repeat_and_graph,
                        image_batches, image_pair, k5_case, k5_error, k5_repeat_and_graph,
                        kstep_alternating, lm_batches, lstm_compare,
                        lstm_inputs, lstm_repeat_and_graph,
                        move_off_relu_kink, o_limit_share, pass_with_losses,
                        profiled, reset_counts, route_total,
                        sentiment_batches, seq2seq_batches, seq2seq_route,
                        serve_requests, training_state_differs)
from paddle_tpu_torch.graph import GraphExecutor
from paddle_tpu_torch.graph.generator import generate
from paddle_tpu_torch.models import (seq2seq_trainer_config,
                                     stacked_lstm_net_config,
                                     transformer_lm_config,
                                     transformer_lm_trainer_config,
                                     vgg_16_cifar_config)
from paddle_tpu_torch.ops import additive_attention as aa
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import gru_fused as gf
from paddle_tpu_torch.ops import lstm_fused as lf
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import rnn as rnnops
from paddle_tpu_torch.parameter import Argument, init_params
from paddle_tpu_torch.serving import Request, ServingEngine
from paddle_tpu_torch.trainer import Trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["decode", "edge"])
@pytest.mark.parametrize("case", K5_EDGE,
                         ids=[f"rep{H // k}-D{D}-ps{ps}-ctx{c}"
                              for H, k, D, ps, c in K5_EDGE])
def test_kernel_edge_cases_match_plain_version(cuda, dtype, layout, case):
    """chip_smoke's [kernel] edge grid: a prompt chunk beside another
    slot's chunk, padding rows on the all-zero table row, length-1 rows, a
    row longer than a split beside splits without a live token; rep 1-8,
    D 32-128 (33 and 40 padded), pages 2-48."""
    H, h_kv, D, ps, ctx = case
    g = torch.Generator(device=cuda).manual_seed(2)
    args = k5_case(g, H=H, h_kv=h_kv, D=D, ps=ps, dtype=dtype, layout=layout,
                   ctx=ctx)
    assert k5_error(args) <= K5_ATOL[dtype]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_kernel_pinned_splits_match_plain_version(cuda, splits):
    g = torch.Generator(device=cuda).manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        args = k5_case(g, H=8, h_kv=2, D=64, ps=16, dtype=dtype,
                       layout="edge")
        assert k5_error(args, splits=splits) <= K5_ATOL[dtype]


def test_kernel_repeats_bit_for_bit_and_replays_in_a_cuda_graph(cuda):
    k5_repeat_and_graph()


def test_paged_and_additive_kernels_have_no_local_memory(cuda):
    assert all(a["local_bytes"] == 0 for a in pa.kernel_attributes())
    assert all(a[1] == 0 for a in aa.kernel_attributes().values())


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


# (B, Tq, Tk, H, H_kv, D, causal, window, q_offset, k_offset, ragged keys)
FLASH_CASES = [(2, 300, 300, 8, 8, 64, True, None, 0, 0, False),
               (2, 200, 333, 8, 2, 64, False, None, 0, 0, True),
               (2, 130, 190, 6, 3, 40, True, 50, 60, 17, True),
               (1, 100, 120, 4, 1, 128, True, None, 0, 0, False)]
FLASH_IDS = ["causal", "gqa-ragged", "d40-window-offsets", "d128-mqa"]
# both dtypes' kernels besides: each mask kind of chip_smoke's [flash]
# phase, and causal with ragged keys (its first rows see no key), at D 64,
# 128 and 40 (bfloat16: no 16-byte rows, element-wise loads), Tq = 1000
# and Tk = 1100 (ragged tile edges).
# (name, H_kv, causal, window, q_offset, k_offset, ragged keys)
TC_MASKS = [("causal", 8, True, None, 0, 0, False),
            ("causal-gqa", 2, True, None, 0, 0, False),
            ("full", 8, False, None, 0, 0, False),
            ("full-gqa", 2, False, None, 0, 0, False),
            ("ragged", 2, False, None, 0, 0, True),
            ("window", 8, True, 256, 0, 0, False),
            ("offsets", 2, True, None, 1000, 300, True),
            ("causal-ragged", 4, True, None, 0, 0, True)]
TC_CASES = [(2, 1000, 1100, 8, h_kv, D, causal, window, qo, ko, ragged)
            for _, h_kv, causal, window, qo, ko, ragged in TC_MASKS
            for D in (64, 128, 40)]
TC_IDS = [f"tc-{name}-d{D}" for name, *_ in TC_MASKS for D in (64, 128, 40)]
FLASH_PARAMS = ([(dt, c) for dt in (torch.float32, torch.bfloat16)
                 for c in FLASH_CASES]
                + [(torch.bfloat16, c) for c in TC_CASES]
                + [(torch.float32, c) for c in TC_CASES]
                # float32 rows of 30 floats: element-wise loads
                + [(torch.float32,
                    (2, 300, 350, 4, 2, 30, True, None, 0, 0, True))])
FLASH_PARAM_IDS = ([f"{n}-{dt}" for dt in ("float32", "bfloat16")
                    for n in FLASH_IDS] + TC_IDS
                   + [f"fp32-{n[3:]}" for n in TC_IDS]
                   + ["fp32-d30-elementwise"])


@pytest.mark.parametrize("dtype,case", FLASH_PARAMS, ids=FLASH_PARAM_IDS)
def test_flash_kernels_match_plain_versions(cuda, dtype, case):
    """The forward (o, lse) and the two backward kernels (dq, dk, dv, with
    an lse cotangent) against the plain versions in float32 on the same
    inputs, at chip_smoke's limits: o per element within rtol * |ref| +
    atol (float32 2e-5 absolute; bfloat16 2^-7 |ref| + 1e-3, the kernels
    rounding p and o to bfloat16), lse within 2e-5 and -inf on exactly the
    rows without a key, gradients within GRAD_TOL (float32 2e-5, bfloat16
    1e-2) times their max.  bfloat16 runs flash_attention_tc.cu's kernels,
    float32 flash_attention.cu's (launch counts)."""
    B, Tq, Tk, H, h_kv, D, causal, window, q_off, k_off, ragged = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q, do = (torch.randn(B, Tq, H, D, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Tk, h_kv, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kvm = torch.ones(B, Tk, dtype=torch.bool, device=cuda)
    if ragged:
        kvm[0, :5] = False
        kvm[B - 1, Tk // 2:] = False
    dlse = 0.1 * torch.randn(B, H, Tq, generator=g, device=cuda)
    mask = dict(causal=causal, q_offset=q_off, k_offset=k_off,
                window=window)
    fa.counts.reset()
    o, lse = fa.flash_attention_fwd(q, k, v, kvm, **mask)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, kvm, o, lse, do, dlse,
                                        **mask)
    torch.cuda.synchronize()
    tc = (fa.counts.fwd_tc, fa.counts.bwd_dq_tc, fa.counts.bwd_dkv_tc)
    cc = (fa.counts.fwd, fa.counts.bwd_dq, fa.counts.bwd_dkv)
    if dtype == torch.bfloat16:
        assert (tc, cc) == ((1, 1, 1), (0, 0, 0))
    else:
        assert (tc, cc) == ((0, 0, 0), (1, 1, 1))
    assert fa.counts.plain == 0
    f = [x.float() for x in (q, k, v)]
    want_o, want_lse = fa.flash_attention_plain(*f, kvm, **mask)
    assert o.dtype == dtype
    assert o_limit_share(o, want_o, dtype) <= 1
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    assert float((lse[fin] - want_lse[fin]).abs().max()) <= 2e-5
    want = fa.flash_attention_bwd_plain(*f, kvm, o.float(), lse, do.float(),
                                        dlse, **mask)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and torch.isfinite(got).all()
        err = float((got.float() - ref).abs().max())
        assert err <= GRAD_TOL[dtype] * float(ref.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,h_kv,causal,window",
                         [(64, 2, True, None), (128, 1, False, 50),
                          (40, 4, True, None)],
                         ids=["d64-gqa-causal", "d128-mqa-window",
                              "d40-causal"])
def test_flash_kernels_repeat_bit_for_bit(cuda, dtype, D, h_kv, causal,
                                          window):
    """The forward, dQ and dK/dV kernels launched twice on the same inputs
    give the same bits: one owner per output tile, no atomics."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, do = (torch.randn(2, 700, 8, D, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 900, h_kv, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kvm = torch.ones(2, 900, dtype=torch.bool, device=cuda)
    kvm[1, 600:] = False
    assert flash_repeats(q, k, v, kvm, do, causal=causal, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_replay_from_a_cuda_graph(cuda, dtype, D):
    """The forward, dQ and dK/dV kernels captured in a CUDA graph and
    replayed give the eager bits (GQA, causal, a ragged key mask)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, do = (torch.randn(2, 700, 8, D, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 700, 2, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kvm = torch.ones(2, 700, dtype=torch.bool, device=cuda)
    kvm[1, 500:] = False
    assert flash_graph_replay(q, k, v, kvm, do, causal=True)


def test_flash_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 160, device=cuda)
    kvm = torch.ones(1, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_fwd(q, q, q, kvm)
    with pytest.raises(ValueError, match="head dims"):  # tensor-core route
        fa.flash_attention_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16(), kvm)
    b = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="share one floating dtype"):
        fa.flash_attention_fwd(b, b.float(), b, kvm)
    o, lse = fa.flash_attention_fwd(b, b, b, kvm)
    with pytest.raises(ValueError, match="do must match"):
        fa.flash_attention_bwd(b, b, b, kvm, o, lse, b.float())
    with pytest.raises(ValueError, match="lse must be float32"):
        fa.bwd_dq_kernel(b, b, b, kvm.to(torch.uint8), b, lse.bfloat16(),
                         lse, False, 0.25, 0, 0, None)
    h = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        fa.flash_attention_fwd(h, h, h, kvm)
    t = torch.zeros(1, 2, 8, 16, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(t, t, t, kvm)


def test_training_steps_on_cuda_match_cpu(cuda):
    """Two fp32 Adam steps of the Trainer on the card (flash kernels) give
    the CPU's (plain versions') losses within rtol 1e-5 and, after the
    first step, parameters within 2e-6 (Adam's first update is +-lr per
    entry, so only the sign of each gradient entry matters); every step
    launches each flash kernel once per layer and the plain versions
    never."""
    cfg = transformer_lm_trainer_config(97, 64, 2, 4, batch_size=3,
                                        kv_heads=2, block_k_min=16)
    params = init_params(cfg.model_config, seed=0, device="cpu")
    batches = lm_batches(2, 3, 40, 97, seed=0, motifs=6,
                         short_last=5)
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, device=dev, params=params)
        losses, after1 = [], None
        for b in batches:
            fa.counts.reset()
            losses.append(float(tr.train_one_batch(b)))
            if dev == "cuda":
                assert (fa.counts.fwd, fa.counts.bwd_dq, fa.counts.bwd_dkv,
                        fa.counts.plain) == (2, 2, 2, 0)
            if after1 is None:
                # copies: the updates write the parameters in place
                after1 = {n: p.to("cpu", copy=True)
                          for n, p in tr.params.items()}
        runs[dev] = losses, after1
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5)
    for n, p in runs["cpu"][1].items():
        assert float((runs["cuda"][1][n] - p).abs().max()) <= 2e-6, n


# (B, T, D, reverse, peepholes, ragged, cell activation)
LSTM_CASES = [(5, 7, 32, False, True, True, "tanh"),
              (133, 20, 64, True, True, True, "relu"),
              (300, 9, 512, False, False, True, "relu"),
              (3, 1, 96, True, True, False, "tanh"),
              (64, 50, 128, True, False, False, "linear"),
              (64, 20, 256, False, True, True, "relu"),
              (32, 12, 512, True, True, True, "tanh"),
              (1000, 12, 128, False, True, True, "relu"),
              (5, 30, 128, True, True, True, "tanh"),
              (150, 32, 32, False, True, True, "tanh"),
              (150, 32, 32, True, True, True, "relu")]


@pytest.mark.parametrize("case", LSTM_CASES,
                         ids=["odd", "two-row-tiles", "d512-four-row-tiles",
                              "one-step", "linear-cell", "d256",
                              "d512-beyond-a-cluster", "b1000-waves",
                              "b5-partly-filled-group", "srl-fwd-tanh",
                              "srl-rev-relu"])
def test_lstm_kernels_match_plain_version(cuda, case):
    """The forward kernel (hs, h_last, c_last) and the backward kernel
    (dx4, dW, dpeep, dh0, dc0) against autograd of the plain version, each
    within chip_smoke's LSTM_TOL of its max; one call of each wrapper.  The
    cases reach every kind of launch plan: W in registers or in shared
    memory and L2 (hidden 512), clusters in waves (1,000 rows), a group
    only partly filled (5 rows)."""
    B, T, D, reverse, peep, ragged, act = case
    g = torch.Generator(device=cuda).manual_seed(0)
    acts = dict(active_type=act, gate_active_type="sigmoid",
                state_active_type="tanh")
    inputs, cot = lstm_inputs(g, B, T, D, peep, ragged)
    if act == "relu":
        inputs = move_off_relu_kink(inputs, reverse, **acts)
    lf.counts.reset()
    errs = lstm_compare(inputs, cot, reverse, **acts)
    assert (lf.counts.fwd, lf.counts.bwd) == (1, 1)
    for name, (_, rel) in errs.items():
        assert rel <= LSTM_TOL, (name, rel)


def test_lstm_limit_rejects_a_dropped_freeze(cuda):
    """The kernels told that row 1 is full: hs and dx4 leave LSTM_TOL, as
    chip_smoke's faulty-result check needs."""
    g = torch.Generator(device=cuda).manual_seed(2)
    inputs, cot = lstm_inputs(g, 128, 100, 128, True, True)
    bad = inputs[1].clone()
    bad[1] = 100
    errs = lstm_compare(inputs, cot, False, kernel_lens=bad)
    assert errs["hs"][1] > LSTM_TOL and errs["dx4"][1] > LSTM_TOL


def test_lstm_backward_repeats_and_replays_in_a_cuda_graph(cuda):
    """Two backward calls bit-identical; a forward + backward captured in a
    CUDA graph and replayed equals eager bit for bit (chip_smoke's check)."""
    lstm_repeat_and_graph(torch.Generator(device=cuda).manual_seed(3))


def test_lstm_kernels_have_no_local_memory(cuda):
    """The runtime's account of K3's kernels for the plans the cases take:
    no local memory (spills), and the walk kernels' dynamic shared memory is
    what lstm_plan sized."""
    for B, D in ((128, 128), (5, 32), (64, 256), (32, 512), (1000, 128),
                 (1, 512), (3, 96)):
        plan = lf.plan_for(B, D, torch.device(cuda))
        attrs = lf.kernel_attributes(D, plan)
        assert all(a[1] == 0 for a in attrs.values()), attrs
        assert attrs["lstm_fwd_kernel"][3] == plan.smem_fwd
        assert attrs["lstm_bwd_kernel"][3] == plan.smem_bwd


def test_lstm_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    """On CUDA tensors a hidden size or an activation the kernels do not
    take raises (no silent plain version); impl='plain' asks for the plain
    version explicitly."""
    x4 = torch.randn(2, 3, 32, device=cuda)
    lens = torch.tensor([3, 2], device=cuda)
    w = torch.randn(8, 32, device=cuda)
    with pytest.raises(ValueError, match="hidden size 8"):
        rnnops.lstm_scan(x4, lens, w, None)
    lf.counts.reset()
    hs, _, _ = rnnops.lstm_scan(x4, lens, w, None, impl="plain")
    assert hs.shape == (2, 3, 8) and (lf.counts.plain, lf.counts.fwd) == (1, 0)
    x4 = torch.randn(2, 3, 128, device=cuda)
    w = torch.randn(32, 128, device=cuda)
    with pytest.raises(ValueError, match="softmax"):
        rnnops.lstm_scan(x4, lens, w, None, active_type="softmax")
    with pytest.raises(ValueError, match="16-byte"):
        lf.lstm_fused(x4, lens, torch.randn(32 * 128 + 1, device=cuda)[1:]
                      .view(32, 128), torch.zeros(3, 32, device=cuda),
                      torch.zeros(2, 32, device=cuda),
                      torch.zeros(2, 32, device=cuda))


def test_sentiment_step_on_cuda_matches_cpu(cuda):
    """One fp32 training step of the stacked sentiment net (hid_dim 128:
    lstm hidden 32) on the card launches each LSTM kernel once per
    lstmemory and the plain version never, and gives the CPU step's loss
    (rtol 1e-5) and gradients (1e-4 of their max) with the same dropout
    masks."""
    cfg = stacked_lstm_net_config(97, batch_size=6, hid_dim=128)
    params = init_params(cfg.model_config, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for n, p in params.items():                  # wake the zero lstm edges
        if not p.any():
            params[n] = 0.05 * torch.randn(p.shape, generator=gen)
    batch = sentiment_batches(1, 6, 11, 97, seed=0, ragged=True)[0]
    masks = {l.name: torch.rand(6, 11, l.size, generator=gen) < 0.5
             for l in cfg.model_config.layers if l.drop_rate > 0}
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, device=dev, params=params)
        lf.counts.reset()
        loss, grads, _ = tr.compute_gradients(tr.prepare_batch(batch),
                                              dropout_masks=masks)
        if dev == "cuda":
            assert (lf.counts.fwd, lf.counts.bwd, lf.counts.plain) == (3, 3,
                                                                       0)
        runs[dev] = float(loss), {n: g.cpu() for n, g in grads.items()}
    assert runs["cuda"][0] == pytest.approx(runs["cpu"][0], rel=1e-5)
    for n, ref in runs["cpu"][1].items():
        err = float((runs["cuda"][1][n] - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()) + 1e-9, n


# (B, T, D, reverse, ragged, candidate activation)
GRU_CASES = [(5, 7, 32, False, True, "tanh"),
             (133, 20, 64, True, True, "relu"),
             (64, 30, 512, True, True, "tanh"),
             (3, 1, 96, False, False, "linear"),
             (16, 12, 128, False, True, "sigmoid"),
             (256, 30, 512, False, True, "relu"),
             (64, 30, 96, True, True, "tanh"),
             (1, 30, 512, False, False, "tanh"),
             (1024, 30, 512, True, True, "tanh"),
             (1500, 12, 256, False, True, "relu")]


@pytest.mark.parametrize("case", GRU_CASES,
                         ids=["odd", "relu-many-rows", "d512-seq2seq",
                              "one-step", "sigmoid-candidate", "b256-d512",
                              "d96", "one-row", "b1024-d512-sliced",
                              "b1500-d256-sliced"])
def test_gru_kernels_match_plain_version(cuda, case):
    """The GRU forward kernel (hs, h_last) and backward kernel (dx3, dWg,
    dWc, dh0), fed the column slices of one [D, 3D] weight, against
    autograd of the plain version, each within chip_smoke's GRU_TOL of its
    max; one call of each wrapper (a batch no launch takes is walked in
    slices, the last two cases)."""
    B, T, D, reverse, ragged, act = case
    g = torch.Generator(device=cuda).manual_seed(0)
    acts = dict(active_type=act, gate_active_type="sigmoid")
    inputs, cot = gru_inputs(g, B, T, D, ragged)
    if act == "relu":
        inputs = gru_move_off_relu_kink(inputs, reverse, **acts)
    gf.counts.reset()
    errs = gru_compare(inputs, cot, reverse, **acts)
    assert (gf.counts.fwd, gf.counts.bwd) == (1, 1)
    for name, (_, rel) in errs.items():
        assert rel <= GRU_TOL, (name, rel)


def test_gru_limit_rejects_a_dropped_freeze(cuda):
    """The kernels told that row 0 (length 0) is full: hs and dx3 leave
    GRU_TOL, as chip_smoke's faulty-result check needs."""
    g = torch.Generator(device=cuda).manual_seed(2)
    inputs, cot = gru_inputs(g, 64, 30, 512, True)
    bad = inputs[1].clone()
    bad[0] = 30
    errs = gru_compare(inputs, cot, False, kernel_lens=bad)
    assert errs["hs"][1] > GRU_TOL and errs["dx3"][1] > GRU_TOL


def test_gru_backward_repeats_and_replays_in_a_cuda_graph(cuda):
    """Two backward calls bit-identical; a forward + backward captured in a
    CUDA graph and replayed equals eager bit for bit (chip_smoke's check)."""
    gru_repeat_and_graph(torch.Generator(device=cuda).manual_seed(3))


def test_gru_kernels_have_no_local_memory(cuda):
    """The runtime's account of K1's kernels: no local memory (spills), and
    the walk kernels' dynamic shared memory is what gru_plan sized."""
    limits = gf.kernel.device_limits(torch.device(cuda))
    for B, D in ((64, 512), (256, 512), (1, 512), (64, 96), (5, 32),
                 (1024, 512), (1500, 256)):
        for _, _, plan in gf.gru_launches(B, D, *limits):
            attrs = gf.kernel_attributes(D, plan)
            assert all(a[1] == 0 for a in attrs.values()), attrs
            assert attrs["gru_fwd_kernel"][3] == plan.smem_fwd
            assert attrs["gru_bwd_kernel"][3] == plan.smem_bwd


def test_gru_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    """On CUDA tensors a hidden size or an activation the kernels do not
    take raises (no silent plain version); impl='plain' asks for the plain
    version explicitly."""
    x3 = torch.randn(2, 3, 24, device=cuda)
    lens = torch.tensor([3, 2], device=cuda)
    w = torch.randn(8, 24, device=cuda)
    with pytest.raises(ValueError, match="hidden size 8"):
        rnnops.gru_scan(x3, lens, w[:, :16], w[:, 16:], None)
    gf.counts.reset()
    hs, _ = rnnops.gru_scan(x3, lens, w[:, :16], w[:, 16:], None,
                            impl="plain")
    assert hs.shape == (2, 3, 8) and (gf.counts.plain, gf.counts.fwd) == (1, 0)
    x3 = torch.randn(2, 3, 96, device=cuda)
    w = torch.randn(32, 96, device=cuda)
    with pytest.raises(ValueError, match="softmax"):
        rnnops.gru_scan(x3, lens, w[:, :64], w[:, 64:], None,
                        active_type="softmax")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,Dv,ragged", [
    (64, 30, 512, 1024, True), (192, 30, 512, 1024, False),
    (3, 1, 40, 24, False), (5, 300, 512, 1024, True), (7, 65, 33, 2048, True)],
    ids=["seq2seq-train", "seq2seq-beam", "one-key", "long", "odd-widths"])
def test_additive_kernel_matches_plain_version(cuda, dtype, B, T, D, Dv,
                                               ragged):
    """The additive-attention kernel against its plain version in float32
    on the same inputs (a length-0 row among the ragged ones): float32
    within ADD_TOL_F32, bfloat16 within 2^-7 |ref| + 1e-3 per element."""
    g = torch.Generator(device=cuda).manual_seed(1)
    args = additive_inputs(g, B, T, D, Dv, ragged, dtype)
    aa.counts.reset()
    err, share = additive_error(args)
    assert aa.counts.kernel == 1
    if dtype == torch.float32:
        assert err <= ADD_TOL_F32
    else:
        assert share <= 1, (err, ADD_LIMIT_BF16)
    if ragged:
        out = aa.additive_attention_kernel(*args)
        assert not bool(out[0].any())               # the length-0 row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ADD_CASES,
                         ids=[f"B{c[0]}-T{c[1]}-D{c[2]}-Dv{c[3]}"
                              + ("-ragged" if c[4] else "")
                              for c in ADD_CASES])
def test_additive_kernel_cluster_cases(cuda, dtype, case):
    """chip_smoke's [additive] cases (rows without a key, T past one key
    tile, widths the cluster's slices do not divide, the beam shape), each
    at every cluster size the wrapper takes, and a bit-identical repeat."""
    B, T, D, Dv, ragged = case
    g = torch.Generator(device=cuda).manual_seed(3)
    u, v, proj, seq, lens = additive_inputs(g, B, T, D, Dv, ragged, dtype)
    want = aa.additive_attention_plain(u, v, proj.float(), seq.float(), lens)
    for ctas in (1, 2, 4, 8):
        if -(-Dv // ctas) > aa.MAX_SLICE:
            continue
        got = aa._launch(u, v, proj, seq, lens, ctas=ctas)
        again = aa._launch(u, v, proj, seq, lens, ctas=ctas)
        assert torch.equal(got, again)
        diff = (got.float() - want).abs()
        if dtype == torch.float32:
            assert float(diff.max()) <= ADD_TOL_F32, ctas
        else:
            rtol, atol = ADD_LIMIT_BF16
            assert bool((diff <= rtol * want.abs() + atol).all()), ctas
        assert not bool(got[lens == 0].any())


def test_seq2seq_step_and_generate_on_cuda_match_cpu(cuda):
    """One fp32 training step of the seq2seq (hidden 64) on the card
    launches 2 + 2 GRU kernels and one additive kernel per decoder step and
    no plain version, and gives the CPU step's loss (rtol 1e-5) and
    gradients (1e-4 of their max); the beam search on the card gives the
    CPU's ids."""
    V, H, B, T = 1100, 64, 6, 14          # chip_smoke's words are 3..1002
    cfg = seq2seq_trainer_config(V, H, B)
    params = init_params(cfg.model_config, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for n, p in params.items():                  # wake the zero biases
        if not p.any():
            params[n] = 0.05 * torch.randn(p.shape, generator=gen)
    batch = seq2seq_batches(1, B, T, seed=0, ragged=True)[0]
    gcfg = seq2seq_trainer_config(V, H, is_generating=True, beam_size=3,
                                  max_length=8)
    feed = {"source_language_word": batch["source_language_word"]}
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, device=dev, params=params)
        gf.counts.reset()
        aa.counts.reset()
        loss, grads, _ = tr.compute_gradients(tr.prepare_batch(batch))
        if dev == "cuda":
            assert (gf.counts.fwd, gf.counts.bwd, gf.counts.plain,
                    aa.counts.kernel, aa.counts.plain) == (2, 2, 0, T + 1, 0)
        ids, _ = generate(GraphExecutor(gcfg.model_config), tr.params,
                          {n: Argument(ids=a.ids, lengths=a.lengths)
                           for n, a in feed.items()})
        runs[dev] = (float(loss), {n: g.cpu() for n, g in grads.items()},
                     ids.cpu())
    assert runs["cuda"][0] == pytest.approx(runs["cpu"][0], rel=1e-5)
    for n, ref in runs["cpu"][1].items():
        err = float((runs["cuda"][1][n] - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()) + 1e-9, n
    assert torch.equal(runs["cuda"][2], runs["cpu"][2])


def test_additive_kernel_replays_from_a_cuda_graph(cuda):
    """The additive-attention kernel at the seq2seq shape, ragged (a row
    without keys), captured in a CUDA graph and replayed: the eager bits."""
    g = torch.Generator(device=cuda).manual_seed(5)
    args = additive_inputs(g, 64, 30, 512, 1024, True)
    assert graph_replay_equal(lambda: (aa.additive_attention_kernel(*args),))


def _lm_cfg(dtype):
    return lambda: transformer_lm_trainer_config(
        97, 64, 2, 4, batch_size=3, block_k_min=16, compute_dtype=dtype)


def _lstm_route(batch):
    return {"lstm_fwd_kernel": 3, "lstm_bwd_kernel": 3}


# model -> (config builder, batches(n, T), (long T, short T),
#           route(batch): {kernel symbol: launches a step})
FUSED_MODELS = {
    "lm-bf16": (_lm_cfg("bfloat16"),
                lambda n, T: lm_batches(n, 3, T, 97, seed=T, motifs=6,
                                        short_last=5),
                (40, 24), flash_route(2, torch.bfloat16)),
    "lm-fp32": (_lm_cfg(""),
                lambda n, T: lm_batches(n, 3, T, 97, seed=T, motifs=6,
                                        short_last=5),
                (40, 24), flash_route(2, torch.float32)),
    "sentiment": (lambda: stacked_lstm_net_config(97, batch_size=6,
                                                  hid_dim=128),
                  lambda n, T: sentiment_batches(n, 6, T, 97, seed=T,
                                                 ragged=True),
                  (14, 11), _lstm_route),
    "seq2seq": (lambda: seq2seq_trainer_config(1100, 64, 6),
                lambda n, T: seq2seq_batches(n, 6, T, seed=T, ragged=True),
                (14, 11), seq2seq_route),
    # small_vgg's 11 batch norms: the moving statistics written in place
    # by the captured steps (no hand-written kernel on this path)
    "vgg": (lambda: vgg_16_cifar_config(16),
            lambda n, T: image_batches(n, 16, 3, 32, seed=T), (1, 2),
            lambda b: {}),
}


@pytest.mark.parametrize("model", sorted(FUSED_MODELS))
def test_fused_dispatch_graphs_equal_the_k1_loop(cuda, model):
    """Two passes of 7 batches with steps_per_dispatch=4 (the first step
    eager; pass 1 groups of 3 and 3 steps, pass 2 of 4 and 3, each group
    one replay of a graph of that many steps) against the k = 1 loop from
    the same seed: pass statistics, every loss, parameters, optimizer
    slots, counters, the dropout generator and the layer state (the VGG's
    moving statistics) bit for bit.  The counts set
    to 0 before each pass: the card launches each step's kernels as at
    k = 1 (the profiler's kernel events), the plain versions never, and
    the wrappers count the launches they make eagerly or into a capture
    (at k = 4 the eager step and 3 captured steps in pass 1, 4 captured in
    pass 2)."""
    build, make, (T, _), route = FUSED_MODELS[model]
    batches = make(7, T)
    want = route_total(route, batches)
    ref, tr = Trainer(build(), seed=1), Trainer(build(), seed=1)
    for p in range(2):
        runs = []
        for t, k in ((ref, 1), (tr, 4)):
            reset_counts()
            out, _, kernels, _ = profiled(
                lambda: pass_with_losses(t, batches, k))
            runs.append(out)
            check_launches(f"k={k}", kernels, want, k > 1,
                           route_total(route, batches[:4]))
        (sa, la), (sb, lb) = runs
        assert sa == sb
        assert torch.equal(la, lb)
        assert training_state_differs(ref, tr) == []
    assert tr.n_settle_steps == 1 and tr.n_fused_dispatches == 4
    assert graph_replays(tr) == {(0, 3): 3, (0, 4): 1}


# config -> (config file, --config_args at a small width, the kernels a
# training step launches, those a test batch launches)
CLI_CONFIGS = {
    "sentiment": ("demo/sentiment/trainer_config.py",
                  "hid_dim=128,batch_size=128",
                  lambda b: {"lstm_fwd_kernel": 3, "lstm_bwd_kernel": 3},
                  lambda b: {"lstm_fwd_kernel": 3}),
    "seq2seq": ("demo/seqToseq/seqToseq_net.py",
                "dict_size=1100,hidden_dim=64,batch_size=256",
                lambda b: {"gru_fwd_kernel": 2, "gru_bwd_kernel": 2,
                           "additive_attention_kernel":
                           b["target_language_word"].ids.shape[1]},
                lambda b: {"gru_fwd_kernel": 2, "additive_attention_kernel":
                           b["target_language_word"].ids.shape[1]}),
    "lm-bf16": ("demo/model_zoo/transformer_lm.py",
                "vocab=97,dim=64,layers=2,heads=4,attn_impl=flash,"
                "compute_dtype=bfloat16", flash_route(2, torch.bfloat16),
                None),
}


@pytest.mark.parametrize("name", sorted(CLI_CONFIGS))
def test_cli_trains_a_demo_config_on_the_card(cuda, name, tmp_path):
    """`python -m paddle_tpu_torch train` on the demo config and its own
    provider, one pass at --steps_per_dispatch=1 and at 4 (chip_smoke's
    cli_pair): exit 0, the card launching each batch's kernels and no
    plain version, the two runs' statistics and checkpoints bit-identical;
    for the sentiment config also --job=test --init_model_path of the saved
    checkpoint equal to an in-process load."""
    path, args, train_route, test_route = CLI_CONFIGS[name]
    res = cli_pair(name, path, args, train_route, test_route, str(tmp_path))
    assert res["runs"][1]["row"]["batches"] == 16
    if name == "sentiment":
        cli_test_round_trip(name, path, args, res["runs"][1]["save"],
                            res["cfg"])


@pytest.mark.parametrize("V,D,n", [(2, 5, 4800), (7, 256, 20000),
                                   (30000, 128, 20000)])
def test_table_lookup_backward_repeats_bit_for_bit(cuda, V, D, n):
    """ops/table.py lookup_rows: its gradient is the per-row sum of the
    output gradient (against F.embedding's within 1e-5 of its max), the
    same bits over ten calls, and the same replayed from a CUDA graph:
    small tables through the one-hot product (where F.embedding's own
    backward, past 3,072 ids into a table of a few rows, is not
    deterministic), a 30,000-row table through embedding_dense_backward."""
    from paddle_tpu_torch.ops.table import lookup_rows
    g = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(0, V, (n,), device=cuda, generator=g)
    grad = torch.randn(n, D, device=cuda, generator=g)
    w = torch.randn(V, D, device=cuda, generator=g).requires_grad_(True)

    def run():
        return torch.autograd.grad(lookup_rows(ids, w), w, grad)[0]
    first = run()
    want = torch.autograd.grad(torch.nn.functional.embedding(ids, w), w,
                               grad)[0]
    assert float((first - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert all(torch.equal(first, run()) for _ in range(10))
    assert graph_replay_equal(lambda: (run(),))


# the tagging configs at small sizes: (file, --config_args, kernels a
# training step launches, kernels a test batch launches)
TAGGING_CONFIGS = {
    "srl": ("demo/semantic_role_labeling/db_lstm.py",
            "depth=2,batch_size=32",
            lambda b: {"lstm_fwd_kernel": 2, "lstm_bwd_kernel": 2},
            lambda b: {"lstm_fwd_kernel": 2}),
    "rnn_crf": ("demo/sequence_tagging/rnn_crf.py", "batch_size=64",
                lambda b: {"lstm_fwd_kernel": 0}, lambda b: {}),
    "recommendation": ("demo/recommendation/trainer_config.py",
                       "batch_size=256,emb_size=32",
                       lambda b: {"lstm_fwd_kernel": 0}, lambda b: {}),
}


@pytest.mark.parametrize("name", sorted(TAGGING_CONFIGS))
def test_cli_trains_a_tagging_config_on_the_card(cuda, name, tmp_path):
    """`python -m paddle_tpu_torch train` on an SRL, sequence-tagging or
    recommendation config at a small size (chip_smoke's cli_pair): one
    pass at --steps_per_dispatch=1 and at 4, the card launching each
    batch's kernels (SRL: K3 per lstmemory; the others none), the two
    runs' statistics (chunk counts included) and checkpoints (averages
    included) bit-identical, then --job=test of the k = 1 checkpoint on
    the averaged parameters equal to an in-process load."""
    path, args, train_route, test_route = TAGGING_CONFIGS[name]
    res = cli_pair(name, path, args, train_route, test_route, str(tmp_path))
    assert res["runs"][1]["row"]["batches"] > 1
    cli_test_round_trip(name, path, args, res["runs"][1]["save"],
                        res["cfg"])


def test_cli_trains_the_mnist_vgg_on_the_card(cuda, tmp_path):
    """`python -m paddle_tpu_torch train` on demo/mnist/vgg_16_mnist.py at
    batch 256 (chip_smoke's image_pair): one pass at k = 1 and at 4, no
    hand-written kernel, statistics and checkpoints (batch norm's moving
    statistics included) bit-identical, --job=test of the checkpoint
    equal to an in-process load, the steady passes' graphs replayed."""
    res = image_pair("mnist", "demo/mnist/vgg_16_mnist.py",
                     "batch_size=256", str(tmp_path), "")
    assert res["runs"][1]["row"]["batches"] == 32


@pytest.mark.parametrize("model", ["lm-fp32", "sentiment", "seq2seq"])
def test_fused_dispatch_graphs_of_two_signatures(cuda, model):
    """Batches of two padded lengths in runs of 3, 2, 4 and 1, two passes:
    graphs of both signatures and of each group size met, in one memory
    pool, replayed out of their capture order, bit-identical to the k = 1
    loop after each pass, the card launching each batch's kernels and the
    plain versions never (chip_smoke.kstep_alternating)."""
    build, make, (long_t, short_t), route = FUSED_MODELS[model]
    graphs = kstep_alternating(f"[{model}]", lambda: Trainer(build(), seed=1),
                               make(10, long_t), make(10, short_t), route)
    # pass 1: settle + 2, settle + 1, 4, 1; pass 2: 3, 2, 4, 1
    assert graphs == {(0, 2): 1, (1, 1): 3, (0, 4): 2, (0, 3): 1,
                      (1, 2): 1}


def test_engine_windows_from_cuda_graphs_equal_k1(cuda):
    """Greedy and sampled requests, more than the slots, served twice by
    an engine with decode_steps=4 (windows captured per variant, then
    replayed) and by one at k = 1: the same tokens; the card (the
    profiler's kernel events) launches the paged-attention kernel once
    per layer per forward, window bodies included, and the plain version
    never runs."""
    ex = GraphExecutor(transformer_lm_config(97, 64, 2, 4),
                       compute_dtype="bfloat16")
    params = init_params(ex.model, seed=0)
    runs = {}
    for k in (1, 4):
        eng = ServingEngine(ex, params, num_slots=4, page_size=8,
                            max_context=64, decode_steps=k)
        runs[k] = []
        for _ in range(2):
            reset_counts()
            n0 = (eng.n_decode_steps, eng.n_scan_flushes, eng.n_scan_steps)
            res, _, kernels, _ = profiled(lambda: eng.run(serve_requests(
                10, 97, seed=2, lo=3, hi=30, max_new=12, sampled_every=3)))
            runs[k].append(res)
            steps, flushes, bodies = (x - y for x, y in zip(
                (eng.n_decode_steps, eng.n_scan_flushes, eng.n_scan_steps),
                n0))
            check_launches(f"decode_steps={k}", kernels,
                           {"paged_attention_kernel":
                            2 * (steps - flushes + bodies)}, k > 1)
        if k > 1:
            assert eng.n_scan_flushes > 0
            assert sum(g.replays for g in eng._windows[k].graphs.values()
                       if g is not None) > 0
    # another k, then back: each k keeps its own window tensors and graphs
    for k in (2, 4):
        eng.set_decode_steps(k)
        runs[4].append(eng.run(serve_requests(10, 97, seed=2, lo=3, hi=30,
                                              max_new=12, sampled_every=3)))
    for res in runs[1] + runs[4]:
        assert sorted(res) == sorted(runs[1][0])
        for i, toks in runs[1][0].items():
            np.testing.assert_array_equal(res[i], toks)


def test_fused_dispatch_recaptures_after_a_load(cuda, tmp_path):
    """A checkpoint loaded into a trainer whose step was captured replaces
    its parameters and slots: the next fused pass captures anew and stays
    bit-identical to the k = 1 loop doing the same."""
    build, make, (T, _), _ = FUSED_MODELS["lm-fp32"]
    batches = make(5, T)
    runs = []
    for k in (1, 4):
        tr = Trainer(build(), seed=1)
        pass_with_losses(tr, batches, k)
        d = tr.save(str(tmp_path / f"k{k}"))
        pass_with_losses(tr, batches, k)
        tr.load(d)
        runs.append((tr, pass_with_losses(tr, batches, k)))
    (ref, (sa, la)), (tr, (sb, lb)) = runs
    assert sa == sb and torch.equal(la, lb)
    assert training_state_differs(ref, tr) == []


def test_nested_chunk_oracle_through_k3_and_k1(cuda, tmp_path):
    """--prev_batch_state on the card (chip_smoke's chunk_oracle): two
    chunks of T/2 booted from the carried state end where one T-step
    forward ends, through K3 at [128, 100, 128] and K1 at [64, 30, 512],
    each booted call held against the plain version."""
    from chip_smoke import chunk_oracle
    chunk_oracle(str(tmp_path))


def test_carried_state_k4_equals_k1_across_a_batch_size_change(cuda):
    """The stacked sentiment net (hidden 32 a K3 layer) with
    --prev_batch_state, two passes of five batches of 16 rows and one of
    12: the fused dispatch at k = 4 (an eager first step wherever the
    carried state's shape changes) bit-identical to k = 1 after each
    pass, the forward LSTMs' carried state included."""
    from chip_smoke import carried_state
    full = sentiment_batches(10, 16, 20, 500, seed=1, ragged=True)
    small = {n: Argument(ids=a.ids[:12], lengths=None if a.lengths is None
                         else a.lengths[:12])
             for n, a in sentiment_batches(1, 16, 20, 500, seed=2)[0]
             .items()}
    with carried_state():
        t1, t4 = (Trainer(stacked_lstm_net_config(500, 16, 128), seed=1)
                  for _ in range(2))
        for p in range(2):
            batches = full[5 * p:5 * p + 5] + [small]
            out = [pass_with_losses(tr, batches, k)
                   for tr, k in ((t1, 1), (t4, 4))]
            assert out[0][0] == out[1][0]
            assert torch.equal(out[0][1], out[1][1])
            assert training_state_differs(t1, t4) == []
            assert {tuple(v.shape) for v in t4.net_state.values()} == \
                {(12, 32)}
    assert sum(graph_replays(t4).values()) > 0
