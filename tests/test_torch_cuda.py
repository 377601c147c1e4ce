"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and skips without one. The file
imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

f32 comparisons run with TF32 off. Tolerances: lora_matmul f32 1e-4 and
bf16 1e-1 (the kernel adds the adapter to its f32 accumulator before the
one cast, the plain version casts x·W first); flash attention f32 2e-5
and bf16 2e-2 (one bf16 rounding of outputs of magnitude < 4); wkv6
relative to max |ref| 1e-5 in f32 and 1e-2 in bf16 (the reference
suite's).
"""
import numpy as np
import pytest
import torch

from repro_torch.config import LoRAConfig, ServeSpec
from repro_torch.configs import qwen2_0_5b, rwkv6_7b, vit_base_paper
from repro_torch.core.lora import pad_adapter_tree, rank_arange_mask
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.lora_matmul import ops as lm_ops
from repro_torch.kernels.lora_matmul.ref import lora_matmul_ref
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.launch.adapter_cache import PagedAdapter
from repro_torch.launch.serve import ServeEngine, make_prefill_step
from repro_torch.federated.batched_client import (BatchedLocalTrainer,
                                                  draw_batches)
from repro_torch.federated.client import LocalTrainer
from repro_torch.models import transformer as T
from repro_torch.optim.adam import leaves
from repro_torch.sim.simulator import IoVSimulator, SimConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lm_operands(seed, L, M, K, N, r, dtype, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((L, M, K), generator=g) / K ** 0.25
    w = torch.randn((K, N), generator=g) / K ** 0.5
    a = torch.randn((L, K, r), generator=g) / K ** 0.5
    b = torch.randn((L, r, N), generator=g)
    scale = torch.linspace(0.5, 2.0, L)
    mask = rank_arange_mask(torch.arange(L) % r + 1, r)
    return (x.to(device, dtype), w.to(device, dtype), a.to(device),
            b.to(device), scale.to(device), mask.to(device))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-1)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 100, 70, 50, 8), (4, 1, 96, 200, 16),
                                   (1, 64, 128, 64, 64), (3, 2, 33, 17, 2)])
def test_lora_matmul_kernel_matches_plain(cuda_device, shape, dtype, tol):
    args = _lm_operands(11, *shape, dtype, cuda_device)
    before = lm_ops.launches
    got = lm_ops.lora_matmul(*args)
    torch.cuda.synchronize()
    assert lm_ops.launches == before + 1
    want = lora_matmul_ref(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) < tol


def test_lora_matmul_kernel_zero_b_is_the_base_product(cuda_device):
    x, w, a, b, scale, mask = _lm_operands(12, 2, 40, 64, 48, 8,
                                           torch.float32, cuda_device)
    got = lm_ops.lora_matmul(x, w, a, torch.zeros_like(b), scale, mask)
    # the kernel's own f32 accumulation order, against cuBLAS's
    assert float((got - x @ w).abs().max()) < 1e-4


# (variant, L, M, K, N, dtype): each kernel of lora_matmul.cu at the shapes
# that select it; "misaligned" views x one element past a 16-byte boundary
LM_VARIANT_CASES = [
    ("wgmma", 1, 64, 896, 896, torch.bfloat16),
    ("wgmma", 1, 100, 4864, 896, torch.bfloat16),
    ("wgmma", 1, 512, 896, 4864, torch.bfloat16),
    ("wgmma", 1, 512, 4864, 896, torch.bfloat16),
    ("wgmma", 2, 100, 896, 4864, torch.bfloat16),
    # zamba2-2.7b's in_proj, N 10448: 81 tiles of 128 and one of 80
    # columns (512 rows), or 163 of 64 and one of 16 (100 rows); its
    # out_proj 5120 -> 2560
    ("wgmma", 1, 512, 2560, 10448, torch.bfloat16),
    ("wgmma", 1, 100, 2560, 10448, torch.bfloat16),
    ("wgmma", 1, 512, 5120, 2560, torch.bfloat16),
    ("splitk", 4, 1, 2560, 10448, torch.bfloat16),
    ("splitk", 1, 1, 2560, 10448, torch.bfloat16),
    ("splitk", 1, 1, 14336, 4096, torch.bfloat16),
    ("splitk", 4, 1, 14336, 4096, torch.bfloat16),
    ("splitk", 1, 16, 14336, 896, torch.bfloat16),
    ("splitk", 4, 1, 14336, 4096, torch.float32),
    ("splitk", 2, 8, 4864, 896, torch.float32),
    ("simt", 1, 100, 70, 50, torch.bfloat16),
    ("simt", 3, 2, 33, 17, torch.float32),
    ("simt", 1, 512, 896, 896, torch.float32),
    ("misaligned", 1, 100, 896, 896, torch.bfloat16),
]
LM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-1}


def _case_id(case):
    kind, L, M, K, N, dtype = case
    return f"{kind}-{L}x{M}-{K}to{N}-{str(dtype)[6:]}"


def _lm_case_operands(seed, L, M, K, N, r, dtype, device, misaligned=False):
    args = _lm_operands(seed, L, M, K, N, r, dtype, device)
    if misaligned:
        buf = torch.empty(L * M * K + 1, dtype=dtype, device=device)
        x = buf[1:].view(L, M, K)
        x.copy_(args[0])
        args = (x,) + tuple(args[1:])
    return args


def _count_variant(kind, fn):
    before = dict(lm_ops.launches_by_variant)
    out = fn()
    torch.cuda.synchronize()
    grew = {k: lm_ops.launches_by_variant[k] - before[k] for k in before}
    assert grew == {k: int(k == kind) for k in before}, grew
    return out


@pytest.mark.parametrize("case", LM_VARIANT_CASES, ids=_case_id)
def test_lora_matmul_variant_matches_plain(cuda_device, case):
    kind, L, M, K, N, dtype = case
    args = _lm_case_operands(K + N + M, L, M, K, N, 64, dtype, cuda_device,
                             misaligned=kind == "misaligned")
    kind = "simt" if kind == "misaligned" else kind
    got = _count_variant(kind, lambda: lm_ops.lora_matmul(*args))
    want = lora_matmul_ref(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) < LM_TOL[dtype]


@pytest.mark.parametrize("case", LM_VARIANT_CASES[1::3], ids=_case_id)
def test_lora_matmul_zero_b_is_the_base_product_per_variant(cuda_device,
                                                            case):
    """B = 0: the kernel's output is x·W accumulated in f32 and cast once
    (against the f32 product: its f32 summation order, one rounding)."""
    kind, L, M, K, N, dtype = case
    x, w, a, b, scale, mask = _lm_case_operands(
        7, L, M, K, N, 16, dtype, cuda_device,
        misaligned=kind == "misaligned")
    kind = "simt" if kind == "misaligned" else kind
    got = _count_variant(kind, lambda: lm_ops.lora_matmul(
        x, w, a, torch.zeros_like(b), scale, mask))
    base = x.float() @ w.float()
    if dtype == torch.float32:
        assert float((got - base).abs().max()) < 1e-4
    else:
        torch.testing.assert_close(got.float(), base, rtol=2 ** -8,
                                   atol=1e-3)


@pytest.mark.parametrize("case", LM_VARIANT_CASES, ids=_case_id)
def test_lora_matmul_padded_rank_equals_truncated(cuda_device, case):
    """A rank-8 adapter zero-padded to 64 under the rank mask gives the same
    bits as the truncated rank-8 adapter (tests/test_kernels.py's pin).
    Both calls get the same t columns: cuBLAS's x·A may sum in another
    order at r 8 than at r 64, and this pins the kernel's epilogue."""
    kind, L, M, K, N, dtype = case
    x, w, a, b, scale, _ = _lm_case_operands(
        9, L, M, K, N, 8, dtype, cuda_device,
        misaligned=kind == "misaligned")
    kind = "simt" if kind == "misaligned" else kind
    pad = torch.zeros((L, K, 56), device=cuda_device)
    a64 = torch.cat([a, pad], -1)
    b64 = torch.cat([b, torch.zeros((L, 56, N), device=cuda_device)], 1)
    t64 = x.float() @ a64
    t8 = t64[..., :8].contiguous()
    mask64 = rank_arange_mask(torch.full((L,), 8), 64).to(cuda_device)
    y_pad = _count_variant(kind, lambda: lm_ops._launch(
        x, w, t64, b64, scale, mask64))
    y_trunc = _count_variant(kind, lambda: lm_ops._launch(
        x, w, t8, b, scale, torch.ones((L, 8), device=cuda_device)))
    assert torch.equal(y_pad, y_trunc)


@pytest.mark.parametrize("K,N", [(896, 896), (896, 4864), (4864, 896),
                                 (4096, 4096), (4096, 14336),
                                 (14336, 4096)])
def test_lora_matmul_decode_is_deterministic(cuda_device, K, N):
    """The served decode shape (4 lanes x 1 row): split-K sums its partials
    in a fixed order, so two calls give the same bits."""
    args = _lm_operands(K + N, 4, 1, K, N, 64, torch.bfloat16, cuda_device)
    y1 = _count_variant("splitk", lambda: lm_ops.lora_matmul(*args))
    y2 = _count_variant("splitk", lambda: lm_ops.lora_matmul(*args))
    assert torch.equal(y1, y2)


def _fa_operands(seed, B, S, H, Hkv, D, dtype, device):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, S, h, D), generator=g).to(device, dtype)
            for h in (H, Hkv, Hkv)]


def _count_flash(kind, fn):
    before = dict(fa_ops.launches_by_variant)
    n0 = fa_ops.launches
    out = fn()
    torch.cuda.synchronize()
    grew = {k: fa_ops.launches_by_variant[k] - before[k] for k in before}
    assert grew == {k: int(k == kind) for k in before}, grew
    assert fa_ops.launches == n0 + 1
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,D,window", [(24, 64, None), (100, 64, None),
                                        (100, 64, 16), (128, 64, None),
                                        (40, 32, None), (70, 128, 8)])
def test_flash_kernel_matches_plain(cuda_device, S, D, window, dtype, tol):
    """bf16 takes the tensor-core kernel, f32 the SIMT one."""
    q, k, v = _fa_operands(S + D, 2, S, 4, 2, D, dtype, cuda_device)
    kind = "mma" if dtype == torch.bfloat16 else "simt"
    got = _count_flash(kind, lambda: fa_ops.flash_attention(
        q, k, v, sliding_window=window))
    want = fa_ops._plain(q, k, v, True, window, D ** -0.5)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.parametrize("S,D,window", [(24, 32, None), (40, 32, 8),
                                        (70, 128, None), (100, 128, 16),
                                        (128, 32, 16), (24, 128, 8)])
def test_flash_mma_other_head_dims_and_windows(cuda_device, S, D, window):
    """The tensor-core kernel at every head dim it takes, with and without
    a window, against the plain version (bf16 tolerance)."""
    q, k, v = _fa_operands(S * 3 + D, 2, S, 4, 2, D, torch.bfloat16,
                           cuda_device)
    got = _count_flash("mma", lambda: fa_ops.flash_attention(
        q, k, v, sliding_window=window))
    want = fa_ops._plain(q, k, v, True, window, D ** -0.5)
    assert float((got.float() - want.float()).abs().max()) < 2e-2


def _sharded_sim(n, placement, capture=None):
    """FUSED_KW over n shards, all on the one card."""
    from repro_torch.config import ShardSpec
    from repro_torch.federated.fused_engine import FusedRoundEngine
    sim = IoVSimulator(SimConfig(**dict(FUSED_KW, engine="fused_sharded"),
                                 shard=ShardSpec(num_shards=n,
                                                 placement=placement)),
                       device="cuda", fleet_devices=["cuda:0"] * n)
    if capture is False:
        sim.fused = FusedRoundEngine(sim, capture=False,
                                     devices=sim.fleet_devices)
    return sim


@pytest.mark.parametrize("n,placement", [(2, "roundrobin"), (4, "block")],
                         ids=["2-roundrobin", "4-block"])
def test_sharded_round_captures_once_per_topology_and_replays_as_eager(
        cuda_device, n, placement):
    """Three sharded rounds of the reduced ViT with every shard on the
    one card: one capture (a lane graph per shard and the home device's
    two), and the replayed rounds equal to the same rounds run eagerly
    (records, merged deltas, UCB-DUAL states in vehicle order)."""
    graph, eager = _sharded_sim(n, placement), _sharded_sim(n, placement,
                                                            False)
    assert graph.fused.capture and not eager.fused.capture
    g_recs, g_merged = _fused_state(graph, 3)
    e_recs, e_merged = _fused_state(eager, 3)
    assert graph.fused.captures == 1 and graph.fused.segments == n + 2
    assert eager.fused.captures == 0
    assert g_recs == e_recs
    for gs, es in zip(g_merged, e_merged):
        for g, e in zip(gs, es):
            assert torch.equal(g, e)
    arms = len(graph.cfg.lora.candidate_ranks)
    for gu, eu in zip(graph.ucb_states, eager.ucb_states):
        assert gu.counts.shape == (6, arms)
        for g, e in zip(gu, eu):
            assert torch.equal(g, e)


def test_sharded_run_scanned_on_card_equals_run_round(cuda_device):
    """A sharded run_scanned on the card gives the per-round records."""
    a, b = _sharded_sim(2, "roundrobin"), _sharded_sim(2, "roundrobin")
    assert a.run(2) == b.run_scanned(2)
    assert b.fused.captures == 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,window", [
    (4, 128, 16, 16, None),     # gemma-7b's prefill
    (4, 384, 8, 1, None),       # paligemma-3b's: 256 prefix + 128 tokens
    (2, 100, 8, 1, 32),         # ragged, MQA, a window
    (1, 40, 4, 2, None)],       # a part tile, 3 q tiles
    ids=["gemma", "paligemma", "ragged-window", "short"])
def test_flash_head_dim_256_matches_plain(cuda_device, B, S, H, Hkv, window,
                                          dtype, tol):
    """Head dim 256 on the dtype's kernel (mma re-reads Q's fragments
    from shared memory at each k-step), against the plain version."""
    q, k, v = _fa_operands(S + H + 256, B, S, H, Hkv, 256, dtype,
                           cuda_device)
    kind = fa_ops.variant(dtype, 256)
    got = _count_flash(kind, lambda: fa_ops.flash_attention(
        q, k, v, sliding_window=window))
    want = fa_ops._plain(q, k, v, True, window, 256 ** -0.5)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (14, 2)],
                         ids=["group1", "group2", "group7"])
@pytest.mark.parametrize("B,S", [(2, 100), (4, 128), (1, 2048)])
def test_flash_mma_gqa_groups_and_long_prompt(cuda_device, H, Hkv, B, S):
    """GQA groups of 1, 2 and 7 query heads per kv head, at ragged,
    served and long-prompt lengths (S 2048 takes 64-row blocks)."""
    q, k, v = _fa_operands(H * S + Hkv, B, S, H, Hkv, 64, torch.bfloat16,
                           cuda_device)
    got = _count_flash("mma", lambda: fa_ops.flash_attention(q, k, v))
    want = fa_ops._plain(q, k, v, True, None, 64 ** -0.5)
    assert float((got.float() - want.float()).abs().max()) < 2e-2


@pytest.mark.parametrize("S,tiles", [(9, 1), (16, 1), (30, 2), (40, 3),
                                     (64, 4), (100, 4)])
@pytest.mark.parametrize("window", [None, 16])
def test_flash_mma_every_plan_block(cuda_device, S, tiles, window):
    """Each block the plan takes (1 to 4 q tiles of 16 rows, ragged or
    whole) gives the plain version's result (14/2 heads)."""
    assert fa_ops.plan(S) == tiles
    q, k, v = _fa_operands(77 + S, 2, S, 14, 2, 64, torch.bfloat16,
                           cuda_device)
    got = _count_flash("mma", lambda: fa_ops.flash_attention(
        q, k, v, sliding_window=window))
    want = fa_ops._plain(q, k, v, True, window, 0.125)
    assert float((got.float() - want.float()).abs().max()) < 2e-2


def test_flash_mma_fully_masked_rows_are_zero(cuda_device):
    """Sq > Sk leaves the first Sq - Sk rows with no visible key: the
    kernel gives exactly 0 there (p = 0, denominator max(l, 1e-30)), and
    the plain version's other rows elsewhere."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 40, 4, 64), generator=g).to(cuda_device,
                                                    torch.bfloat16)
    k, v = (torch.randn((1, 24, 2, 64), generator=g).to(
        cuda_device, torch.bfloat16) for _ in range(2))
    got = _count_flash("mma", lambda: fa_ops.flash_attention(q, k, v))
    assert torch.equal(got[:, :16], torch.zeros_like(got[:, :16]))
    want = fa_ops._plain(q, k, v, True, None, 0.125)
    assert float((got[:, 16:].float() - want[:, 16:].float()).abs().max()
                 ) < 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_misaligned_view_is_copied(cuda_device, dtype):
    """A view off a 16-byte boundary cannot feed the kernels' 16-byte
    loads: the wrapper copies it, and the dtype's own route gives the
    aligned call's bits."""
    q, k, v = _fa_operands(5, 1, 64, 4, 2, 64, dtype, cuda_device)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    qm = buf[1:].view(q.shape)
    qm.copy_(q)
    kind = fa_ops.variant(dtype, 64)
    got = _count_flash(kind, lambda: fa_ops.flash_attention(qm, k, v))
    assert torch.equal(got, fa_ops.flash_attention(q, k, v))


def _wkv_operands(seed, B, S, H, K, dtype, device, decay=None,
                  wdtype=None):
    """r, k, v in ``dtype``, logw in ``wdtype`` (default: ``dtype``)."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, K), generator=g) for _ in range(3))
    if decay is None:
        logw = -torch.exp(torch.randn((B, S, H, K), generator=g) * 0.5 - 1.0)
    else:
        logw = torch.full((B, S, H, K), float(decay))
    u = 0.3 * torch.randn((H, K), generator=g)
    return ([t.to(device, dtype) for t in (r, k, v)]
            + [logw.to(device, wdtype or dtype), u.to(device)])


# (r/k/v dtype, logw dtype, y tolerance): the model's own pair is bf16
# activations with f32 log-decays
WKV_DTYPES = [(torch.float32, torch.float32, 1e-5),
              (torch.bfloat16, torch.bfloat16, 1e-2),
              (torch.bfloat16, torch.float32, 1e-2)]


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / (want.float().abs().max() + 1e-6))


@pytest.mark.parametrize("dtype,wdtype,tol", WKV_DTYPES,
                         ids=["f32", "bf16", "bf16-f32logw"])
@pytest.mark.parametrize("B,S,H,K", [(4, 128, 64, 64), (2, 100, 4, 64),
                                     (1, 300, 2, 64), (2, 50, 2, 16),
                                     (1, 96, 4, 32), (3, 17, 2, 64)])
def test_wkv6_kernel_matches_plain(cuda_device, B, S, H, K, dtype, wdtype,
                                   tol):
    """Against the plain chunked version (chunk min(128, S), padded) and
    the per-step oracle, both on the kernel's (rounded) inputs; the state
    is f32 in every dtype pair."""
    args = _wkv_operands(B * S + K, B, S, H, K, dtype, cuda_device,
                         wdtype=wdtype)
    before = wkv_ops.launches
    y, s = wkv_ops.wkv6(*args)
    torch.cuda.synchronize()
    assert wkv_ops.launches == before + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    yp, sp = wkv_ops._plain(*args, wkv_ops.CHUNK)
    assert _rel(y, yp) < tol and _rel(s, sp) < 1e-5
    yr, sr = wkv6_ref(*args)
    assert _rel(y, yr) < tol and _rel(s, sr) < 1e-5


@pytest.mark.parametrize("dtype,wdtype,tol", WKV_DTYPES[::2],
                         ids=["f32", "bf16-f32logw"])
@pytest.mark.parametrize("decay", [-0.8, -2.0, -5.0, -20.0])
def test_wkv6_kernel_stays_finite_at_strong_decay(cuda_device, decay, dtype,
                                                  wdtype, tol):
    """Per-step log-decays where the chunk-128 form overflows: the
    kernel's 16-row chunks stay finite and match the per-step oracle."""
    args = _wkv_operands(5, 2, 128, 4, 64, dtype, cuda_device, decay=decay,
                         wdtype=wdtype)
    y, s = wkv_ops.wkv6(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr = wkv6_ref(*args)
    assert _rel(y, yr) < tol and _rel(s, sr) < 1e-5
    yp, _ = wkv_ops._plain(*args, wkv_ops.CHUNK)
    assert not torch.isfinite(yp).all()


@pytest.mark.parametrize("B,slice_", [(1, (32, 1)), (4, (64, 2))],
                         ids=["VS32xVT1", "VS64xVT2"])
@pytest.mark.parametrize("dtype,wdtype,tol", WKV_DTYPES,
                         ids=["f32", "bf16", "bf16-f32logw"])
def test_wkv6_every_value_slice(cuda_device, B, slice_, dtype, wdtype, tol):
    """Each (value slice, columns per thread) the kernel is built for at
    K 64, as the plan picks it for rwkv6-7b's 64 heads at B 1 and B 4,
    gives the plain version's result (ragged S 100)."""
    assert wkv_ops.plan(B, 64, 64, wkv_ops._sm_count(cuda_device))[:2] \
        == slice_
    args = _wkv_operands(31, B, 100, 64, 64, dtype, cuda_device,
                         wdtype=wdtype)
    y, s = wkv_ops.wkv6(*args)
    torch.cuda.synchronize()
    yp, sp = wkv_ops._plain(*args, wkv_ops.CHUNK)
    assert _rel(y, yp) < tol and _rel(s, sp) < 1e-5


def test_wkv6_bf16_inputs_give_the_f32_call_rounded_once(cuda_device):
    """The model's call (bf16 r, k, v; f32 logw) gives the f32 call's y,
    rounded to bf16 once, and the same state: the kernel widens exactly."""
    args = _wkv_operands(41, 2, 128, 4, 64, torch.bfloat16, cuda_device,
                         wdtype=torch.float32)
    y, s = wkv_ops.wkv6(*args)
    y32, s32 = wkv_ops.wkv6(*[t.float() for t in args])
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(s, s32)


def test_wrappers_refuse_noncontiguous_cuda_tensors(cuda_device):
    x, w, a, b, scale, mask = _lm_operands(13, 1, 8, 16, 8, 4,
                                           torch.float32, cuda_device)
    with pytest.raises(ValueError):
        lm_ops.lora_matmul(x, w.t().contiguous().t(), a, b, scale, mask)
    q = torch.zeros((1, 8, 4, 64), device=cuda_device)
    k = torch.zeros((1, 2, 8, 64), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k)
    r = torch.zeros((1, 4, 8, 64), device=cuda_device).transpose(1, 2)
    u = torch.zeros((4, 64), device=cuda_device)
    with pytest.raises(ValueError):
        wkv_ops.wkv6(r, r, r, r, u)


def test_reduced_model_on_card_matches_cpu(cuda_device):
    """qwen2-0.5b reduced, f32: prefill and three-lane decode through the
    kernels on the card == the plain versions on the CPU (1e-4), with 2
    flash launches per prefill and 8 lora_matmul launches per step."""
    cfg = qwen2_0_5b.reduced()
    lora = LoRAConfig(rank=4, max_rank=8)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    ads = _shifted(T.init_adapters(cfg, lora, seed=1, device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    want = make_prefill_step(cfg, lora, device="cpu")(params, ads,
                                                      {"tokens": tokens})
    lm0, fa0 = lm_ops.launches, fa_ops.launches
    got = make_prefill_step(cfg, lora, device=cuda_device)(
        _to(params, cuda_device), _to(ads, cuda_device), {"tokens": tokens})
    assert fa_ops.launches - fa0 == cfg.num_layers
    assert lm_ops.launches - lm0 == 4 * cfg.num_layers
    assert float((got.cpu() - want).abs().max()) <= 1e-4

    engines = {}
    for dev in ("cpu", cuda_device):
        eng = ServeEngine(_to(params, dev), cfg, lora,
                          ServeSpec(max_batch=3, cache_len=8, max_rank=8),
                          device=dev)
        for lane, rank in enumerate((2, 8)):
            sub = _shifted(T.init_adapters(cfg, lora, seed=10 + lane,
                                           rank=rank, device="cpu"))
            eng.assign(lane, PagedAdapter(0, -1, 0, rank, 8, 16.0 / rank,
                                          _to(pad_adapter_tree(sub, 8), dev)))
        engines[str(dev)] = eng
    toks = np.array([1, 2, 3])
    for step in range(10):
        lm0 = lm_ops.launches
        got = engines[str(cuda_device)].step(toks).cpu()
        assert lm_ops.launches - lm0 == 4 * cfg.num_layers
        want = engines["cpu"].step(toks)
        assert float((got - want).abs().max()) <= 1e-4, step
        toks = want.argmax(-1).numpy()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _shifted(ads):
    """Adapters with b shifted off its zero init, so they matter."""
    return {"segments": [{k: {n: {"a": v["a"], "b": v["b"] + 0.01}
                              for n, v in blk.items()}
                          for k, blk in seg.items()}
                         for seg in ads["segments"]]}


def test_reduced_rwkv6_on_card_matches_cpu(cuda_device):
    """rwkv6-7b reduced, f32: prefill (S = 100, ragged) and three-lane
    decode through the kernels on the card == the plain versions on the
    CPU (1e-4), with 2 wkv6 and 12 lora_matmul launches per prefill and
    12 lora_matmul (0 wkv6) per step."""
    cfg = rwkv6_7b.reduced()
    lora = LoRAConfig(rank=4, max_rank=8)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    ads = _shifted(T.init_adapters(cfg, lora, seed=1, device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 100),
                           generator=torch.Generator().manual_seed(0))
    want = make_prefill_step(cfg, lora, device="cpu")(params, ads,
                                                      {"tokens": tokens})
    lm0, wk0 = lm_ops.launches, wkv_ops.launches
    got = make_prefill_step(cfg, lora, device=cuda_device)(
        _to(params, cuda_device), _to(ads, cuda_device), {"tokens": tokens})
    assert wkv_ops.launches - wk0 == cfg.num_layers
    assert lm_ops.launches - lm0 == 6 * cfg.num_layers
    assert float((got.cpu() - want).abs().max()) <= 1e-4

    engines = {}
    for dev in ("cpu", cuda_device):
        eng = ServeEngine(_to(params, dev), cfg, lora,
                          ServeSpec(max_batch=3, cache_len=8, max_rank=8),
                          device=dev)
        for lane, rank in enumerate((2, 8)):
            sub = _shifted(T.init_adapters(cfg, lora, seed=10 + lane,
                                           rank=rank, device="cpu"))
            eng.assign(lane, PagedAdapter(0, -1, 0, rank, 8, 16.0 / rank,
                                          _to(pad_adapter_tree(sub, 8), dev)))
        engines[str(dev)] = eng
    toks = np.array([1, 2, 3])
    for step in range(10):
        lm0, wk0 = lm_ops.launches, wkv_ops.launches
        got = engines[str(cuda_device)].step(toks).cpu()
        assert lm_ops.launches - lm0 == 6 * cfg.num_layers
        assert wkv_ops.launches == wk0
        want = engines["cpu"].step(toks)
        assert float((got - want).abs().max()) <= 1e-4, step
        toks = want.argmax(-1).numpy()
        if step == 4:
            for eng in engines.values():
                eng.retire(1)


# ---------------------------------------------------------------------------
# The federated round's shapes and paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,window", [
    (10, 24, 4, 4, None),     # the reduced ViT's train step
    (32, 24, 4, 4, None),     # its local eval
    (2, 100, 4, 2, 16),       # ragged, GQA, a window
    (1, 9, 2, 2, None),       # one partial q tile
    (2, 130, 4, 4, None),     # three kv tiles of the mma kernel
])
def test_flash_head_dim_16(cuda_device, B, S, H, Hkv, window, dtype, tol):
    """Head dim 16 on both kernels: the mma kernel's single k-step and
    two n8 tiles with 48-byte rows, the SIMT kernel's half-warp columns."""
    q, k, v = _fa_operands(B * S + H, B, S, H, Hkv, 16, dtype, cuda_device)
    kind = "mma" if dtype == torch.bfloat16 else "simt"
    got = _count_flash(kind, lambda: fa_ops.flash_attention(
        q, k, v, sliding_window=window))
    want = fa_ops._plain(q, k, v, True, window, 16 ** -0.5)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.parametrize("shape", [(1, 240, 768, 768, 2),
                                   (1, 240, 768, 3072, 32),
                                   (1, 240, 3072, 768, 4),
                                   (2, 100, 70, 50, 8), (4, 1, 96, 200, 16),
                                   (10, 240, 3072, 768, 4),
                                   (10, 240, 768, 3072, 2)],
                         ids=["train_768", "train_up", "train_down",
                              "lanes_ragged", "decode_lanes",
                              "batched_train_down", "batched_train_up"])
def test_lora_matmul_closed_form_backward_on_card(cuda_device, shape):
    """The closed-form backward (every operand asks for a grad) against
    autograd of the plain version on the card, within 1e-4 of each
    gradient's largest entry (f32 summation order, TF32 off)."""
    L, M, K, N, r = shape
    args = _lm_operands(sum(shape), L, M, K, N, r, torch.float32,
                        cuda_device)
    g = torch.randn((L, M, N), generator=torch.Generator().manual_seed(1)
                    ).to(cuda_device)

    def grads(fn):
        ins = [t.detach().requires_grad_() for t in args]
        return torch.autograd.grad(fn(*ins), ins, g)
    lm0 = lm_ops.launches
    got = grads(lm_ops.lora_matmul)
    assert lm_ops.launches == lm0 + 1       # the backward launches nothing
    want = grads(lora_matmul_ref)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))


def _nontrivial(ads, seed):
    g = torch.Generator().manual_seed(seed)
    return {"segments": [{k: {n: {"a": v["a"], "b": 0.02 * torch.randn(
        v["b"].shape, generator=g)} for n, v in blk.items()}
        for k, blk in seg.items()} for seg in ads["segments"]]}


def test_train_step_on_card_matches_cpu(cuda_device):
    """One local train step of the reduced ViT (head dim 16): loss and
    updated adapters on the card == on the CPU (1e-4), with every
    targeted linear (6 per layer) and every attention on the kernels."""
    cfg = vit_base_paper.reduced()
    lora = LoRAConfig(rank=8, max_rank=32)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    ads = _nontrivial(T.init_adapters(cfg, lora, seed=1, device="cpu"), 2)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (10, 24)),
             "labels": rng.integers(0, 6, (10,))}
    out = {}
    for dev in ("cpu", cuda_device):
        tr = LocalTrainer(cfg, lora, lr=5e-3, device=dev)
        lm0, fa0 = lm_ops.launches, fa_ops.launches
        ad = _to(ads, dev)
        new, _, m = tr.train_step(_to(params, dev), ad, tr.opt.init(ad),
                                  tr._batch(batch),
                                  torch.ones(cfg.num_layers, device=dev))
        out[str(dev)] = (new, m, lm_ops.launches - lm0,
                         fa_ops.launches - fa0)
    new_g, m_g, lm_n, fa_n = out[str(cuda_device)]
    new_c, m_c, lm_c, fa_c = out["cpu"]
    assert (lm_c, fa_c) == (0, 0)
    assert lm_n == 6 * cfg.num_layers and fa_n == cfg.num_layers
    assert abs(float(m_g["loss"]) - float(m_c["loss"])) < 1e-4
    for seg_g, seg_c in zip(new_g["segments"], new_c["segments"]):
        for blk in seg_c:
            for n in seg_c[blk]:
                for f in ("a", "b"):
                    assert float((seg_g[blk][n][f].cpu()
                                  - seg_c[blk][n][f]).abs().max()) < 1e-4


def test_round_on_card_matches_cpu(cuda_device):
    """Two rounds of the port's simulator, 6 vehicles and 2 tasks, on the
    card and on the CPU from one seed: the same records (integers exactly;
    energy, latency and accuracy within 1e-4 relative)."""
    kw = dict(method="ours", engine="serial", num_vehicles=6, num_tasks=2,
              local_steps=2)
    hist = {dev: IoVSimulator(SimConfig(**kw), device=dev).run(2)
            for dev in ("cpu", "cuda")}
    for rc, rg in zip(hist["cpu"], hist["cuda"]):
        for tc, tg in zip(rc["tasks"], rg["tasks"]):
            for key in ("active", "departing", "fallbacks", "comm_params",
                        "mean_rank"):
                assert tg[key] == tc[key], key
            for key in ("energy", "latency", "accuracy"):
                assert abs(tg[key] - tc[key]) <= 1e-4 * max(1.0,
                                                            abs(tc[key]))


def test_batched_group_on_card_matches_cpu(cuda_device):
    """One batched group of the reduced ViT (3 lanes, step budgets 2, 1
    and 2, then the local eval) on the card and on the CPU: adapters and
    metrics within 1e-4, with one launch per linear and per attention per
    forward of the whole group (2 train forwards + 1 eval)."""
    from repro_torch.data import ClientDataset
    cfg = vit_base_paper.reduced()
    lora = LoRAConfig(rank=4, max_rank=32)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    ads = [_nontrivial(T.init_adapters(cfg, lora, seed=i, rank=4,
                                       device="cpu"), 10 + i)
           for i in range(3)]
    rng = np.random.default_rng(5)
    batches, counts = [], [2, 1, 2]
    for i, c in enumerate(counts):
        ds = ClientDataset(rng.integers(0, cfg.vocab_size, (40, 24)),
                           rng.integers(0, 6, (40,)), 10, seed=i)
        batches.append(draw_batches(ds, c, 2))
    evb = {"tokens": rng.integers(0, cfg.vocab_size, (32, 24)),
           "labels": rng.integers(0, 6, (32,))}
    out = {}
    for dev in ("cpu", cuda_device):
        tr = BatchedLocalTrainer(cfg, lora, lr=5e-3, max_steps=2, device=dev)
        lm0, fa0 = lm_ops.launches, fa_ops.launches
        stacked, m = tr.finetune_group_stacked(
            _to(params, dev), [_to(a, dev) for a in ads], batches, counts,
            eval_batch=evb)
        out[str(dev)] = (stacked, m, lm_ops.launches - lm0,
                         fa_ops.launches - fa0)
    st_g, m_g, lm_n, fa_n = out[str(cuda_device)]
    st_c, m_c, _, _ = out["cpu"]
    assert lm_n == 3 * 6 * cfg.num_layers and fa_n == 3 * cfg.num_layers
    for k in m_c:
        assert np.abs(m_g[k] - m_c[k]).max() < 1e-4, k
    for seg_g, seg_c in zip(st_g["segments"], st_c["segments"]):
        for blk in seg_c:
            for n in seg_c[blk]:
                for f in ("a", "b"):
                    assert float((seg_g[blk][n][f].cpu()
                                  - seg_c[blk][n][f]).abs().max()) < 1e-4


def test_batched_round_on_card_matches_cpu(cuda_device):
    """Two batched rounds, 6 vehicles and 2 tasks, on the card and on the
    CPU from one seed: the same records (integers exactly; energy and
    latency within 1e-4 relative)."""
    kw = dict(method="ours", engine="batched", num_vehicles=6, num_tasks=2,
              local_steps=2)
    hist = {dev: IoVSimulator(SimConfig(**kw), device=dev).run(2)
            for dev in ("cpu", "cuda")}
    for rc, rg in zip(hist["cpu"], hist["cuda"]):
        for tc, tg in zip(rc["tasks"], rg["tasks"]):
            for key in ("active", "departing", "fallbacks", "comm_params",
                        "mean_rank"):
                assert tg[key] == tc[key], key
            for key in ("energy", "latency"):
                assert abs(tg[key] - tc[key]) <= 1e-4 * max(1.0,
                                                            abs(tc[key]))


FUSED_KW = dict(method="ours", engine="fused", num_vehicles=6, num_tasks=2,
                local_steps=2)


def _fused_state(sim, rounds):
    recs = [sim.run_round() for _ in range(rounds)]
    return recs, [leaves(s.merged) for s in sim.servers]


def test_fused_round_captures_once_and_replays_as_eager(cuda_device):
    """Three fused rounds of the reduced ViT on the card: one capture of
    the round (two graphs), and the replayed rounds equal to the same
    rounds run eagerly on the card (records and merged deltas), the
    same kernels on the same inputs."""
    from repro_torch.federated.fused_engine import FusedRoundEngine
    graph = IoVSimulator(SimConfig(**FUSED_KW), device="cuda")
    eager = IoVSimulator(SimConfig(**FUSED_KW), device="cuda")
    eager.fused = FusedRoundEngine(eager, capture=False)
    assert graph.fused.capture and not eager.fused.capture
    g_recs, g_merged = _fused_state(graph, 3)
    e_recs, e_merged = _fused_state(eager, 3)
    assert graph.fused.captures == 1 and graph.fused.segments == 2
    assert eager.fused.captures == 0
    assert g_recs == e_recs
    for gs, es in zip(g_merged, e_merged):
        for g, e in zip(gs, es):
            assert torch.equal(g, e)


def test_fused_run_scanned_on_card_equals_run_round(cuda_device):
    """run_scanned on the card (one host copy of every round's inputs,
    device copies between replays) gives the per-round records."""
    a = IoVSimulator(SimConfig(**FUSED_KW), device="cuda")
    b = IoVSimulator(SimConfig(**FUSED_KW), device="cuda")
    assert a.run(2) == b.run_scanned(2)
    assert b.fused.captures == 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,window", [
    (4, 128, 32, 32, None),     # zamba2-2.7b's shared block at prefill
    (2, 100, 8, 2, None),       # ragged, GQA
    (1, 37, 4, 1, 8),           # ragged, MQA, a window
    (3, 16, 6, 3, None)],       # one q tile
    ids=["zamba2", "ragged-gqa", "ragged-window", "short"])
def test_flash_head_dim_80_matches_plain(cuda_device, B, S, H, Hkv, window,
                                         dtype, tol):
    """Head dim 80 on the dtype's kernel (mma: 10 row chunks, 5 k-steps,
    a 176-byte row stride; simt: a half-used last column group)."""
    q, k, v = _fa_operands(S + H + 80, B, S, H, Hkv, 80, dtype, cuda_device)
    kind = fa_ops.variant(dtype, 80)
    got = _count_flash(kind, lambda: fa_ops.flash_attention(
        q, k, v, sliding_window=window))
    want = fa_ops._plain(q, k, v, True, window, 80 ** -0.5)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.parametrize("B,S,H,K", [(10, 24, 4, 32), (10, 24, 64, 64)],
                         ids=["reduced-round", "rwkv6-7b-width"])
def test_wkv6_forward_and_backward_in_a_cuda_graph(cuda_device, B, S, H, K):
    """wkv6 on a training path as the fused round runs it: the forward
    (the kernel) and the backward (autograd of the plain version)
    captured in a CUDA graph on the current stream, replayed on new
    inputs, equal to the same calls run eagerly; and the kernel's
    forward within the f32 tolerance of the plain version's."""
    static = [t.requires_grad_() for t in _wkv_operands(
        7, B, S, H, K, torch.float32, cuda_device)]
    gy = torch.randn((B, S, H, K), generator=torch.Generator().manual_seed(
        8)).to(cuda_device)

    def step(ins):
        y, st = wkv_ops.wkv6(*ins)
        loss = (y * gy).sum() + st.square().sum()
        return (y, st) + torch.autograd.grad(loss, ins)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(static)                       # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = wkv_ops.launches
    with torch.cuda.graph(graph):
        out = step(static)
    assert wkv_ops.launches == n0 + 1      # one kernel launch, captured
    fresh = _wkv_operands(9, B, S, H, K, torch.float32, cuda_device)
    with torch.no_grad():
        for dst, src in zip(static, fresh):
            dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    eager = step([t.detach().clone().requires_grad_() for t in fresh])
    for got, want in zip(out, eager):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-6 * max(
            1.0, float(want.abs().max()))
    yp, sp = wkv_ops._plain(*[t.detach() for t in fresh], wkv_ops.CHUNK)
    assert _rel(out[0], yp) < 1e-5 and _rel(out[1], sp) < 1e-5


def test_rwkv6_round_engines_on_card_match_cpu(cuda_device):
    """rwkv6 as train_arch: one round under serial, batched and fused on
    the card against the CPU (counts exactly, energy and latency 1e-4);
    wkv6 launches once per forward, inside the fused capture too."""
    from repro_torch.configs import rwkv6_7b as r6
    kw = dict(method="ours", num_vehicles=6, num_tasks=2, local_steps=1,
              train_arch=r6.reduced())
    for engine in ("serial", "batched", "fused"):
        recs, launched = {}, {}
        for dev in ("cpu", "cuda"):
            n0 = wkv_ops.launches
            recs[dev] = IoVSimulator(SimConfig(engine=engine, **kw),
                                     device=dev).run(2)
            launched[dev] = wkv_ops.launches - n0
        assert launched["cpu"] == 0 and launched["cuda"] > 0, engine
        for rc, rg in zip(recs["cpu"], recs["cuda"]):
            for tc, tg in zip(rc["tasks"], rg["tasks"]):
                for key in ("active", "departing", "fallbacks",
                            "comm_params", "mean_rank"):
                    assert tg[key] == tc[key], (engine, key)
                for key in ("energy", "latency"):
                    assert abs(tg[key] - tc[key]) <= 1e-4 * max(
                        1.0, abs(tc[key])), (engine, key)


def test_zamba2_serving_on_card_matches_cpu(cuda_device):
    """The reduced zamba2 in f32: prefill logits and 6 decode steps of a
    two-lane engine (paged, blocks of 4) on the card == on the CPU
    (1e-4), and paged == dense on the card bit for bit."""
    from repro_torch.configs import zamba2_2_7b as z2
    cfg = z2.reduced()
    lora = LoRAConfig(rank=4, max_rank=8)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    ads = pad_adapter_tree(_nontrivial_tree(T.init_adapters(
        cfg, lora, seed=1, device="cpu"), 2), 8)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    out = {}
    for dev in ("cpu", "cuda"):
        p, a = _to(params, dev), _to(ads, dev)
        pre = make_prefill_step(cfg, lora, device=dev)(p, a,
                                                       {"tokens": toks})
        steps = {}
        for bs in (0, 4):
            eng = ServeEngine(p, cfg, lora, ServeSpec(
                max_batch=2, cache_len=8, block_size=bs), device=dev)
            for lane in range(2):
                eng.assign(lane, PagedAdapter(
                    task=0, rsu=-1, version=lane, rank=8, slot_rank=8,
                    scale=lora.scale, adapters=a))
            steps[bs] = torch.stack([eng.step(toks[:, t]).cpu()
                                     for t in range(6)])
        out[dev] = (pre.cpu(), steps)
    assert torch.equal(out["cuda"][1][0], out["cuda"][1][4])
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) < 1e-4
    assert float((out["cuda"][1][4] - out["cpu"][1][4]).abs().max()) < 1e-4


def _nontrivial_tree(ads, seed):
    """Every b leaf drawn (b is zero-init), segments and shared block."""
    g = torch.Generator().manual_seed(seed)

    def fill(node):
        if isinstance(node, dict) and "a" in node and "b" in node:
            return {"a": node["a"],
                    "b": 0.02 * torch.randn(node["b"].shape, generator=g)}
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return [fill(v) for v in node]
    return fill(ads)


def _train_batch(vocab, B, S, seed):
    """The training CLI's synthetic task: tok_{t+1} = (7·tok_t + 1) mod V."""
    rng = np.random.default_rng(seed)
    seq = [rng.integers(0, vocab, size=(B, 1))]
    for _ in range(S):
        seq.append((seq[-1] * 7 + 1) % vocab)
    toks = np.concatenate(seq, 1)
    return {"tokens": torch.as_tensor(toks[:, :-1]),
            "labels": torch.as_tensor(toks[:, 1:])}


def test_bf16_train_step_launches_by_variant(cuda_device):
    """make_train_step at qwen2-0.5b's width, 2 layers, bf16, seq 256:
    remat, 2 microbatches. Per forward 4 lora_matmul a layer (q/k/v are
    biased: plain route) on wgmma and one flash on mma; 2 microbatches,
    each forward run twice (remat's recompute). Three steps on one batch
    lower its loss."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adam import adam
    cfg = qwen2_0_5b.qwen2_0_5b().with_overrides(num_layers=2)
    lora = LoRAConfig(rank=8)
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    ads = _to(_nontrivial_tree(T.init_adapters(cfg, lora, seed=1, rank=8,
                                               device="cpu"), 3), "cuda")
    opt = adam(1e-3).init(ads)
    _, placed = train_mod.make_train_step(
        cfg, lora, make_mesh((1, 1), ("data", "model"), "cuda"), lr=1e-3,
        remat=True, ce_chunk=128, microbatch=2)
    losses = []
    batch = _to(_train_batch(cfg.vocab_size, 4, 256, 5), "cuda")
    for step in range(3):
        lm0, fa0 = dict(lm_ops.launches_by_variant), dict(
            fa_ops.launches_by_variant)
        ads, opt, m = placed(params, ads, opt, batch)
        losses.append(float(m["loss"]))
        lm = {k: v - lm0[k] for k, v in lm_ops.launches_by_variant.items()}
        fa = {k: v - fa0[k] for k, v in fa_ops.launches_by_variant.items()}
        assert lm == {"wgmma": 4 * 2 * 2 * 2, "splitk": 0, "simt": 0}
        assert fa == {"mma": 2 * 2 * 2, "simt": 0}
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_f32_train_step_card_matches_cpu(cuda_device):
    """The same step in f32 at qwen2-0.5b's width, 2 layers, seq 128: the
    loss to 1e-4 and the first step's mu to 1e-3 of each leaf's largest
    entry, card against CPU."""
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.adam import adam
    cfg = qwen2_0_5b.qwen2_0_5b().with_overrides(num_layers=2)
    lora = LoRAConfig(rank=8)
    params = T.init_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    ads = _nontrivial_tree(T.init_adapters(cfg, lora, seed=2, rank=8,
                                           device="cpu"), 2)
    batch = _train_batch(cfg.vocab_size, 2, 128, 7)
    out = {}
    for dev in ("cpu", "cuda"):
        step, _ = train_mod.make_train_step(cfg, lora, lr=1e-3, remat=True,
                                            ce_chunk=64, microbatch=2)
        a = _to(ads, dev)
        _, opt, m = step(_to(params, dev), a, adam(1e-3).init(a),
                         _to(batch, dev))
        out[dev] = (float(m["loss"]), _to(opt.mu, "cpu"))
    assert abs(out["cuda"][0] - out["cpu"][0]) < 1e-4
    for x, y in zip(leaves(out["cuda"][1]), leaves(out["cpu"][1])):
        assert float((x - y).abs().max()) < 1e-3 * float(y.abs().max())
