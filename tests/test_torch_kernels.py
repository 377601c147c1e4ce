"""The port's kernels against the reference's, on the CPU.

On the CPU each wrapper of ``repro_torch.kernels`` runs its kernel's plain
version; these tests hold that path (and the wrappers' checks, lane
axis and gradients) to the reference's Pallas kernels in interpret mode
and to their jnp oracles, on the same numpy inputs. Tolerances are the
reference suite's (tests/test_kernels.py): f32 max abs < 1e-4 for
lora_matmul and < 2e-5 for flash attention.

The CUDA kernels themselves are held to the plain versions on a card by
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.kernels.lora_matmul.ops import lora_matmul as jax_lora_matmul
from repro.kernels.lora_matmul.ref import lora_matmul_ref as jax_lora_ref
from repro_torch.core.lora import rank_arange_mask
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.lora_matmul import ops as lm_ops
from repro_torch.kernels.lora_matmul.ref import lora_matmul_ref

LM_TOL = 1e-4
FA_TOL = 2e-5


def _lm_operands(seed, L, M, K, N, r):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((L, M, K)) / K ** 0.25).astype(np.float32)
    w = (rng.standard_normal((K, N)) / K ** 0.5).astype(np.float32)
    a = (rng.standard_normal((L, K, r)) / K ** 0.5).astype(np.float32)
    b = rng.standard_normal((L, r, N)).astype(np.float32)
    return x, w, a, b


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _maxabs(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


# ---------------------------------------------------------------------------
# lora_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 8])
@pytest.mark.parametrize("mkn", [(37, 50, 70), (100, 70, 50)],
                         ids=["37x50x70", "100x70x50"])
def test_lora_matmul_plain_matches_reference(mkn, r):
    """Ragged M/N/K: the port's plain path == the Pallas kernel
    (interpret) and the jnp oracle, one lane, scale 2."""
    M, K, N = mkn
    x, w, a, b = _lm_operands(0, 1, M, K, N, r)
    before = lm_ops.launches
    got = lm_ops.lora_matmul(*_t(x, w, a, b), torch.tensor([2.0]),
                             torch.ones(1, r))[0].numpy()
    assert lm_ops.launches == before, "a CPU call must not count a launch"
    kern = jax_lora_matmul(x[0], w, a[0], b[0], scale=2.0, block_m=32,
                           block_n=32, block_k=64, interpret=True)
    oracle = jax_lora_ref(x[0], w, a[0], b[0], 2.0)
    assert got.shape == (M, N)
    assert _maxabs(got, kern) < LM_TOL
    assert _maxabs(got, oracle) < LM_TOL


def test_lora_matmul_lane_axis_matches_reference_per_lane():
    """Three lanes with their own adapter, scale and rank mask == the
    reference op applied lane by lane (its vmap'd serving path)."""
    L, M, K, N, r = 3, 5, 40, 24, 8
    x, w, a, b = _lm_operands(1, L, M, K, N, r)
    scales = np.array([0.5, 1.0, 2.0], np.float32)
    masks = np.asarray(rank_arange_mask(torch.tensor([2, 4, 8]), r))
    got = lm_ops.lora_matmul(*_t(x, w, a, b, scales, masks)).numpy()
    for l in range(L):
        want = jax_lora_matmul(x[l], w, a[l], b[l], scale=scales[l],
                               rank_mask=jnp.asarray(masks[l]), block_m=16,
                               block_n=16, block_k=16, interpret=True)
        assert _maxabs(got[l], want) < LM_TOL, l


def test_lora_matmul_zero_b_is_exactly_the_base_product():
    """b = 0 ⇒ exactly x·W (the LoRA init invariant)."""
    x, w, a, _ = _lm_operands(2, 2, 16, 32, 24, 8)
    b = np.zeros((2, 8, 24), np.float32)
    xt, wt, at, bt = _t(x, w, a, b)
    got = lm_ops.lora_matmul(xt, wt, at, bt, torch.tensor([5.0, 3.0]),
                             torch.ones(2, 8))
    assert torch.equal(got, xt @ wt)


@pytest.mark.parametrize("r", [2, 4, 8])
def test_lora_matmul_rank_mask_equals_truncated(r):
    """A rank-r adapter paged into an 8-wide slot and masked to rank r
    gives the truncated rank-r adapter's output bit for bit (the masked
    tail adds exact zeros)."""
    x, w, a, b = _lm_operands(3, 1, 32, 32, 16, 8)
    a, b = a * 0.1, b * 0.1
    mask = rank_arange_mask(torch.tensor([r]), 8)
    am = a * mask.numpy()[:, None, :]
    bm = b * mask.numpy()[:, :, None]
    xt, wt = _t(x, w)
    y_mask = lm_ops.lora_matmul(xt, wt, *_t(am, bm), torch.tensor([1.5]),
                                mask)
    y_trunc = lm_ops.lora_matmul(xt, wt, *_t(a[..., :r], b[:, :r]),
                                 torch.tensor([1.5]), torch.ones(1, r))
    assert torch.equal(y_mask, y_trunc)


def test_lora_matmul_grads_match_plain_autodiff():
    """The autograd.Function's closed-form backward == autodiff of the
    plain version, within 1e-6 (the closed form applies the scale at
    another point of the products), for every operand."""
    x, w, a, b = _lm_operands(4, 2, 6, 12, 10, 4)
    ins = [t.requires_grad_() for t in _t(x, w, a, b)]
    ins += [torch.tensor([1.0, 2.0]).requires_grad_(),
            rank_arange_mask(torch.tensor([4, 3]), 4).requires_grad_()]
    g_kernel = torch.autograd.grad(
        lm_ops.lora_matmul(*ins).square().sum(), ins)
    g_plain = torch.autograd.grad(
        lora_matmul_ref(*ins).square().sum(), ins)
    for got, want in zip(g_kernel, g_plain):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) < 1e-6 * max(
            1.0, float(want.abs().max()))


@pytest.mark.parametrize("bad", ["rank", "lanes", "dtype", "adapter_dtype",
                                 "scale_shape", "x_rank"])
def test_lora_matmul_wrapper_rejects_bad_operands(bad):
    x, w, a, b = _t(*_lm_operands(5, 2, 4, 8, 6, 4))
    scale, mask = torch.ones(2), torch.ones(2, 4)
    if bad == "rank":
        b = b[:, :3]
    elif bad == "lanes":
        a = a[:1]
    elif bad == "dtype":
        w = w.to(torch.bfloat16)
    elif bad == "adapter_dtype":
        a = a.double()
    elif bad == "scale_shape":
        scale = torch.ones(3)
    elif bad == "x_rank":
        x = x[0]
    with pytest.raises((ValueError, TypeError)):
        lm_ops.lora_matmul(x, w, a, b, scale, mask)


# (rows, K, N, dtype, aligned) -> kernel: every served shape of both models
# (qwen2-0.5b d 896, d_ff 4864; rwkv6-7b d 4096, d_ff 14336; prefill 512
# rows, decode 4 lanes x 1 row) and the edges of the rule
_BF16, _F32 = torch.bfloat16, torch.float32
LM_VARIANT_RULE = [
    *[(rows, K, N, _BF16, True, kind)
      for K, N in ((896, 896), (896, 4864), (4864, 896), (4096, 4096),
                   (4096, 14336), (14336, 4096))
      for rows, kind in ((512, "wgmma"), (4, "splitk"))],
    (200, 896, 896, _BF16, True, "wgmma"),       # 2 lanes x 100 rows
    (17, 4096, 4096, _BF16, True, "wgmma"),      # just past split-K
    (16, 14336, 896, _BF16, True, "splitk"),
    (1, 14336, 4096, _BF16, True, "splitk"),
    (4, 4096, 4096, _F32, True, "splitk"),       # f32 decode streams too
    (512, 70, 896, _BF16, True, "simt"),         # K % 8 != 0: no TMA
    (512, 896, 50, _BF16, True, "simt"),         # N % 8 != 0
    (512, 896, 896, _F32, True, "simt"),         # f32 prefill
    (512, 896, 896, _BF16, False, "simt"),       # misaligned view
    (4, 896, 896, _BF16, False, "simt"),
    (4, 896, 17, _BF16, True, "simt"),           # N not whole vectors
    (4, 896, 898, _F32, True, "simt"),
    (512, 0, 896, _BF16, True, "simt"),          # K = 0
]


@pytest.mark.parametrize("rows,K,N,dtype,aligned,kind", LM_VARIANT_RULE)
def test_lora_matmul_variant_rule(rows, K, N, dtype, aligned, kind):
    """The pure-Python rule that picks the CUDA kernel (no card needed)."""
    assert lm_ops.variant(rows, K, N, dtype, aligned) == kind


@pytest.mark.parametrize("K,N", [(896, 896), (896, 4864), (4864, 896),
                                 (4096, 4096), (4096, 14336),
                                 (14336, 4096)])
@pytest.mark.parametrize("rows,itemsize", [(4, 2), (1, 2), (4, 4), (16, 2)])
def test_lora_matmul_splitk_plan_covers_k_in_one_wave(K, N, rows, itemsize):
    """Split-K's chunks cover K exactly, are whole 32-row steps, keep x's
    chunk within 48 KB, and make at most one wave of blocks (two per SM up
    to 4 rows) unless K is too long for the x chunk to allow it."""
    sms = 132
    strips, chunk, splits = lm_ops.splitk_plan(rows, K, N, itemsize, sms)
    assert strips == -(-N // (32 * 16 // itemsize))
    assert chunk % 32 == 0 and rows * chunk * 4 <= 48 * 1024
    assert (splits - 1) * chunk < K <= splits * chunk
    per_sm = 2 if rows <= 4 else 1
    assert strips * splits <= sms * per_sm or chunk * rows * 4 > 47 * 1024


def test_lora_matmul_wgmma_tile_by_shape():
    """128 x 128 tiles where their waves keep 3/4 of the SMs busy, else
    64 x 64 (block counts of the 128 x 128 tile in the comments)."""
    assert lm_ops.wgmma_tile(512, 4096, 132) == (128, 128)     # 128: 1 wave
    assert lm_ops.wgmma_tile(512, 14336, 132) == (128, 128)    # 448: 4, 85%
    assert lm_ops.wgmma_tile(512, 4864, 132) == (64, 64)       # 152: 2, 58%
    assert lm_ops.wgmma_tile(512, 896, 132) == (64, 64)        # 28
    assert lm_ops.wgmma_tile(200, 896, 132) == (64, 64)


def test_lora_matmul_counts_nothing_on_the_cpu():
    """The plain path launches nothing, so neither count moves."""
    x, w, a, b = _t(*_lm_operands(8, 1, 8, 16, 8, 4))
    before = (lm_ops.launches, dict(lm_ops.launches_by_variant))
    lm_ops.lora_matmul(x, w, a, b, torch.ones(1), torch.ones(1, 4))
    assert (lm_ops.launches, lm_ops.launches_by_variant) == before


def test_lora_matmul_bf16_plain_matches_reference():
    """bf16 activations and weights, f32 adapters (the served dtypes):
    within the reference suite's bf16 tolerance of 1e-1."""
    x, w, a, b = _lm_operands(6, 1, 32, 64, 48, 4)
    xb = jnp.asarray(x[0], jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    want = jax_lora_matmul(xb, wb, jnp.asarray(a[0]), jnp.asarray(b[0]),
                           scale=2.0, block_m=32, block_n=16, block_k=32,
                           interpret=True)
    xt, wt = (torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
              for v in (xb, wb))
    got = lm_ops.lora_matmul(xt[None], wt, *_t(a, b), torch.tensor([2.0]),
                             torch.ones(1, 4))
    assert got.dtype == torch.bfloat16
    assert _maxabs(got[0].float().numpy(), np.asarray(want, np.float32)) < 1e-1


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _fa_operands(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _jax_bshd_ref(q, k, v, window):
    return jax_attn_ref(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                        v.transpose(0, 2, 1, 3), causal=True,
                        sliding_window=window).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("window", [None, 16], ids=["full", "win16"])
@pytest.mark.parametrize("hkv", [1, 2])
@pytest.mark.parametrize("S", [24, 100])
def test_flash_plain_matches_reference(S, hkv, window):
    """The port's flash path on the CPU == the jnp oracle and the Pallas
    kernel (interpret, equal blocks) at H=4, D=32."""
    q, k, v = _fa_operands(S + hkv, 1, S, 4, hkv, 32)
    before = fa_ops.launches
    got = fa_ops.flash_attention(*_t(q, k, v), sliding_window=window).numpy()
    assert fa_ops.launches == before, "a CPU call must not count a launch"
    assert got.shape == q.shape
    assert _maxabs(got, _jax_bshd_ref(q, k, v, window)) < FA_TOL
    kern = jax_flash(q, k, v, sliding_window=window, block_q=32, block_k=32,
                     interpret=True)
    assert _maxabs(got, kern) < FA_TOL


def test_flash_plain_is_op_for_op_the_reference_oracle():
    """attention_ref in (B, H, S, D) == the jnp attention_ref, including
    Sq < Sk (q rows aligned to the end of the kv axis)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 4, 10, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 24, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 24, 16)).astype(np.float32)
    for window in (None, 5):
        got = attention_ref(*_t(q, k, v), sliding_window=window).numpy()
        want = jax_attn_ref(q, k, v, causal=True, sliding_window=window)
        assert _maxabs(got, want) < FA_TOL


def test_flash_grads_match_plain_autodiff():
    q, k, v = _fa_operands(8, 1, 12, 4, 2, 32)
    ins = [t.requires_grad_() for t in _t(q, k, v)]
    g = torch.autograd.grad(
        fa_ops.flash_attention(*ins).square().sum(), ins)
    want = torch.autograd.grad(
        attention_ref(*(t.transpose(1, 2) for t in ins)).transpose(1, 2)
        .square().sum(), ins)
    for got, ref in zip(g, want):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("bad", ["kv_heads", "head_dim", "dtype", "window"])
def test_flash_wrapper_rejects_bad_operands(bad):
    q, k, v = _t(*_fa_operands(9, 1, 8, 4, 2, 32))
    kw = {}
    if bad == "kv_heads":
        k = v = torch.zeros(1, 8, 3, 32)
    elif bad == "head_dim":
        k = v = torch.zeros(1, 8, 2, 16)
    elif bad == "dtype":
        q = q.to(torch.bfloat16)
    elif bad == "window":
        kw = {"sliding_window": 0}
    with pytest.raises((ValueError, TypeError)):
        fa_ops.flash_attention(q, k, v, **kw)


def test_flash_bf16_plain_matches_reference():
    q, k, v = _fa_operands(10, 1, 40, 4, 2, 32)
    qb, kb, vb = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    want = _jax_bshd_ref(qb, kb, vb, None)
    got = fa_ops.flash_attention(*(torch.from_numpy(np.asarray(t, np.float32))
                                   .to(torch.bfloat16) for t in (qb, kb, vb)))
    assert got.dtype == torch.bfloat16
    assert _maxabs(got.float().numpy(), np.asarray(want, np.float32)) < 2e-2


# (dtype, head dim) -> kernel: bf16 on the tensor cores at every head dim
# the kernels take, f32 on the SIMT kernel (TF32 would break its
# tolerance)
FA_VARIANT_RULE = [
    *[(_BF16, d, "mma") for d in fa_ops.HEAD_DIMS],
    *[(_F32, d, "simt") for d in fa_ops.HEAD_DIMS],
]


@pytest.mark.parametrize("dtype,D,kind", FA_VARIANT_RULE)
def test_flash_variant_rule(dtype, D, kind):
    """The pure-Python route of flash_attention (no card needed)."""
    assert fa_ops.variant(dtype, D) == kind


@pytest.mark.parametrize("dtype", [_BF16, _F32])
@pytest.mark.parametrize("D", [8, 512])
def test_flash_variant_refuses_other_head_dims(dtype, D):
    """Neither kernel is built for a head dim outside HEAD_DIMS (16, the
    reduced ViT's, and 256, gemma's, are among them): the route raises,
    on the card, before any launch."""
    with pytest.raises(ValueError):
        fa_ops.variant(dtype, D)


@pytest.mark.parametrize("S,tiles", [
    (128, 4),       # qwen2-0.5b's served prefill
    (100, 4),       # ragged
    (2048, 4),      # a long prompt
    (24, 2),        # fewer rows than a 64-row block
    (8, 1),
])
def test_flash_plan_by_shape(S, tiles):
    """The mma kernel's block: one head, 64-row q tiles, fewer where the
    prompt is shorter; within the kernel's 4 warps (its launch bounds)."""
    assert fa_ops.plan(S) == tiles
    assert 1 <= fa_ops.plan(S) <= 4


def test_flash_counts_nothing_on_the_cpu():
    """The plain path launches nothing, so neither count moves."""
    q, k, v = _t(*_fa_operands(11, 1, 16, 4, 2, 32))
    before = (fa_ops.launches, dict(fa_ops.launches_by_variant))
    fa_ops.flash_attention(q.to(torch.bfloat16), k.to(torch.bfloat16),
                           v.to(torch.bfloat16))
    assert (fa_ops.launches, fa_ops.launches_by_variant) == before
