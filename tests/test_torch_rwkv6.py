"""The port's rwkv6 serving path against the reference, on the CPU.

Weights and adapters come from the reference's seeded init and are
carried across with ``repro_torch.interop``; inputs are numpy arrays from
a seed. The config is ``rwkv6_7b.reduced()`` (2 layers, d 128, 4 wkv
heads of 32, vocab 512) in f32. On the CPU the port's kernel routes take
their plain versions. Tolerances: WKV relative to max |ref| 1e-5 in f32
and 1e-2 in bf16 (the reference suite's), modules 1e-5, logits of the
model ≤ 1e-4 (f32 summation order through two blocks and the head), and
decode against forward 2e-3 on softmax probabilities (the reference's
test_decode_consistency.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.config import ServeSpec as JServeSpec
from repro.configs import rwkv6_7b as jrwkv
from repro.core import lora as jlora
from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.launch.adapter_cache import PagedAdapter as JPagedAdapter
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import rwkv6 as jr6
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.config import LoRAConfig, ServeSpec, get_arch
from repro_torch.configs import rwkv6_7b
from repro_torch.kernels.lora_matmul import ops as lm_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_chunked, wkv6_ref
from repro_torch.launch.adapter_cache import PagedAdapter
from repro_torch.launch.serve import (ServeEngine, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import rwkv6 as r6
from repro_torch.models import transformer as T

TOL = 1e-4
SLOT = 8

JCFG = jrwkv.reduced()
CFG = rwkv6_7b.reduced()
JLORA = JLoRAConfig(rank=4, max_rank=SLOT, candidate_ranks=(2, 4, 8))
LORA = LoRAConfig(rank=4, max_rank=SLOT)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return _maxabs(got, want) / (float(np.max(np.abs(want))) + 1e-6)


def _jax_adapters(rank, seed):
    return _j_adapters(jax.random.PRNGKey(seed), rank)


@functools.partial(jax.jit, static_argnums=1)
def _j_adapters(key, rank):
    ads = JT.init_adapters(key, JCFG, JLORA, rank=rank)
    # b is zero-init; shift both factors so the adapter actually matters
    return jax.tree_util.tree_map(lambda x: x + 0.01 * jnp.ones_like(x), ads)


def _pair_adapters(rank, seed):
    jads = _jax_adapters(rank, seed)
    return jads, interop.adapters_from_jax(_np(jads), "cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are tiny; with the suite's parallel workers each
    running a full intra-op thread pool, the 300-step decode loop spends
    its time waiting on oversubscribed threads. One thread per worker,
    restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    jparams = jax.jit(JT.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), JCFG, jnp.float32)
    params = interop.params_from_jax(_np(jparams), device="cpu",
                                     dtype=torch.float32)
    return jparams, params


def _wkv_inputs(seed, B, S, H, K, decay=None):
    """r, k, v, logw (B,S,H,K) and u (H,K) as numpy f32. logw is drawn
    as test_kernels.py draws it, or set to ``decay`` everywhere."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32)
               for _ in range(3))
    if decay is None:
        logw = -np.exp(rng.standard_normal((B, S, H, K)) * 0.5 - 1.0)
    else:
        logw = np.full((B, S, H, K), decay)
    u = 0.3 * rng.standard_normal((H, K))
    return r, k, v, logw.astype(np.float32), u.astype(np.float32)


# the reference's forward, compiled once per shape (eager dispatch of its
# many small ops costs more here than one compile)
_j_forward = jax.jit(JT.forward, static_argnums=(2, 3))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# Config, init and interop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_copy_matches_reference(which):
    jc = jrwkv.rwkv6_7b() if which == "full" else jrwkv.reduced()
    pc = rwkv6_7b.rwkv6_7b() if which == "full" else rwkv6_7b.reduced()
    for f in dataclasses.fields(pc):
        if f.name == "rwkv":
            assert (dataclasses.asdict(pc.rwkv)
                    == dataclasses.asdict(jc.rwkv))
        else:
            assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    assert pc.blocks() == jc.blocks()
    if which == "full":
        assert get_arch("rwkv6-7b") == pc
        assert (pc.num_layers, pc.d_model, pc.d_ff, pc.vocab_size) == \
            (32, 4096, 14336, 65536)
        assert pc.d_model // pc.rwkv.head_dim == 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_init_trees_have_the_reference_layout(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    key = jax.random.PRNGKey(1)
    jp = jax.eval_shape(lambda: JT.init_params(key, JCFG, jdt))
    pp = T.init_params(CFG, seed=1, dtype=dtype, device="cpu")
    spec = lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
    assert interop.tree_map(spec, pp) == jax.tree_util.tree_map(spec, jp)
    ja = jax.eval_shape(lambda: JT.init_adapters(key, JCFG, JLORA))
    pa = T.init_adapters(CFG, LORA, seed=1, device="cpu")
    assert interop.tree_map(spec, pa) == jax.tree_util.tree_map(spec, ja)
    assert set(pa["segments"][0]["rwkv"]) == {"w_r", "w_k", "w_v", "w_o",
                                              "ck", "cv"}


def test_init_keeps_the_reference_deterministic_parts(weights):
    """w0 is the reference's linspace, decay_b zeros, ln_x ones/zeros and
    every mu 0.5 + 0.1·N."""
    jseg = _np(weights[0]["segments"][0]["rwkv"])
    seg = T.init_params(CFG, seed=1, dtype=torch.float32,
                        device="cpu")["segments"][0]["rwkv"]
    np.testing.assert_allclose(seg["w0"].numpy(), jseg["w0"], rtol=0,
                               atol=1e-6)
    assert not seg["decay_b"].any()
    np.testing.assert_array_equal(seg["ln_x"]["scale"].numpy(), 1)
    np.testing.assert_array_equal(seg["ln_x"]["bias"].numpy(), 0)
    mus = torch.cat([seg[m].reshape(-1) for m in
                     ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck",
                      "mu_cr")])
    assert abs(float(mus.mean()) - 0.5) < 0.02
    assert 0.08 < float(mus.std()) < 0.12


def test_interop_carries_rwkv_trees_exactly(weights):
    """w0, u_bonus, ln_x and the mu vectors (and every other leaf) cross
    exactly, bf16 through f32; adapters in f32."""
    jp = jax.tree_util.tree_map(lambda x: np.asarray(x).astype(jnp.bfloat16),
                                weights[0])
    pp = interop.params_from_jax(jp, "cpu", torch.bfloat16)
    assert pp["segments"][0]["rwkv"]["w0"].dtype == torch.bfloat16
    back = interop.to_numpy(pp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    jads = _np(_jax_adapters(4, 3))
    back = interop.to_numpy(interop.adapters_from_jax(jads, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(jads),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# WKV6: the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_last", [False, True])
def test_token_shift_matches_reference(with_last):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mu = rng.standard_normal(16).astype(np.float32)
    last = rng.standard_normal((2, 16)).astype(np.float32) if with_last \
        else None
    got = r6._token_shift(*_t(x, mu), None if last is None
                          else torch.from_numpy(last))
    want = jr6._token_shift(x, mu, last)
    assert _maxabs(got, want) < 1e-6


@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32), (24, 24)])
def test_wkv6_chunked_matches_reference_chunked(S, chunk):
    args = _wkv_inputs(S, 2, S, 2, 16)
    y, s = wkv6_chunked(*_t(*args), chunk)
    yj, sj = jax.jit(jr6._wkv_chunked, static_argnums=5)(*args, chunk)
    assert _rel(y, yj) < 1e-5 and _rel(s, sj) < 1e-5


# the reference suite's cases (tests/test_kernels.py::WKV_CASES)
WKV_CASES = [
    (2, 64, 2, 16, 16, torch.float32),
    (1, 96, 4, 32, 32, torch.float32),
    (2, 50, 2, 16, 16, torch.float32),    # ragged length
    (1, 64, 2, 16, 64, torch.float32),    # single chunk
    (1, 64, 2, 16, 16, torch.bfloat16),
]


@pytest.mark.parametrize("case", WKV_CASES,
                         ids=lambda c: "x".join(map(str, c[:5]))
                         + ("_bf16" if c[5] == torch.bfloat16 else ""))
def test_wkv6_plain_matches_both_oracles(case):
    """The port's wrapper on the CPU (padded, chunked plain version at
    its chunk and at the case's) == the reference's per-step oracle and
    the port's own, on the same (bf16-rounded where bf16) inputs."""
    B, S, H, K, chunk, dtype = case
    r, k, v, logw, u = _t(*_wkv_inputs(S + K, B, S, H, K))
    r, k, v, logw = (t.to(dtype) for t in (r, k, v, logw))
    before = wkv_ops.launches
    y, s = wkv_ops.wkv6(r, k, v, logw, u)
    assert wkv_ops.launches == before
    assert y.dtype == dtype and s.dtype == torch.float32
    yc, sc = wkv_ops._plain(r, k, v, logw, u, chunk)
    as_np = [t.float().numpy() for t in (r, k, v, logw)]
    yj, sj = jax_wkv6_ref(*as_np, u.numpy())
    yp, sp = wkv6_ref(r, k, v, logw, u)
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert _rel(y.float(), yj) < rtol and _rel(s, sj) < rtol
    assert _rel(yc.float(), yj) < rtol and _rel(sc, sj) < rtol
    assert _rel(yp, yj) < 1e-5 and _rel(sp, sj) < 1e-5


def test_wkv6_plain_matches_pallas_kernel_interpret():
    """The wrapper's padding against the reference's Pallas wrapper in
    interpret mode, ragged S = 50 at chunk 16."""
    args = _wkv_inputs(7, 1, 50, 2, 16)
    y, s = wkv_ops._plain(*_t(*args), 16)
    yj, sj = jax_wkv6(*args, chunk=16, interpret=True)
    assert _rel(y, yj) < 1e-5 and _rel(s, sj) < 1e-5


def test_wkv6_strong_decay_oracle_and_chunk_overflow():
    """At logw = -2 per step the chunk-128 form divides by e^{256}: the
    plain chunked version overflows (as the reference's does), the
    per-step oracle does not; at chunk 16 the chunked form is finite and
    right again."""
    args = _wkv_inputs(8, 1, 128, 2, 16, decay=-2.0)
    yj, sj = jax_wkv6_ref(*args)
    y, s = wkv6_ref(*_t(*args))
    assert _rel(y, yj) < 1e-5 and _rel(s, sj) < 1e-5
    y128, _ = wkv_ops.wkv6(*_t(*args))
    assert not torch.isfinite(y128).all()
    y16, s16 = wkv_ops._plain(*_t(*args), 16)
    assert _rel(y16, yj) < 1e-5 and _rel(s16, sj) < 1e-5


def test_wkv6_wrapper_checks_and_gradients():
    r, k, v, logw, u = _t(*_wkv_inputs(9, 1, 20, 2, 16))
    with pytest.raises(ValueError):
        wkv_ops.wkv6(r, k[:, :10], v, logw, u)
    with pytest.raises(ValueError):
        wkv_ops.wkv6(r, k, v, logw, u[:1])
    with pytest.raises(TypeError):
        wkv_ops.wkv6(r, k.double(), v, logw, u)
    # backward differentiates the plain version
    leaves = [t.clone().requires_grad_() for t in (r, k, v)]
    y, s = wkv_ops.wkv6(*leaves, logw, u)
    (y.sum() + s.sum()).backward()
    leaves2 = [t.clone().requires_grad_() for t in (r, k, v)]
    y2, s2 = wkv6_ref(*leaves2, logw, u)
    (y2.sum() + s2.sum()).backward()
    for a, b in zip(leaves, leaves2):
        assert _rel(a.grad, b.grad.numpy()) < 1e-4


@pytest.mark.parametrize("B,H,K,want", [
    (4, 64, 64, (64, 2)),     # rwkv6-7b's served prefill: 256 whole heads
    (2, 64, 64, (64, 2)),
    (1, 64, 64, (32, 1)),     # 64 heads, under half of 132 SMs: split
    (1, 66, 64, (32, 1)),
    (1, 67, 64, (64, 2)),
    (2, 4, 64, (32, 1)),      # the reduced configs' heads
    (2, 2, 16, (16, 1)),
    (1, 4, 32, (32, 1))])
def test_wkv6_plan_covers_every_value_column(B, H, K, want):
    """The kernel's plan (pure Python, 132 SMs): a built (VS, VT) case for
    the head dim, VS value columns per block with VS | K, and a grid of
    H·K/VS x B blocks, so each (b, h, value column) has one block; whole
    heads once they cover more than half of the SMs, half heads below.
    The plan does not depend on S, so the ragged lengths take it too."""
    vs, vt, grid = wkv_ops.plan(B, H, K, 132)
    assert (vs, vt) == want and (vs, vt) in wkv_ops.SLICES[K]
    assert K % vs == 0 and grid == (H * (K // vs), B)


def test_wkv6_wrapper_dtype_rules():
    """r, k, v share one dtype; logw is f32 or that dtype. bf16 r, k, v
    with f32 logw (the model's call) is taken, computed in f32 on the
    CPU and rounded once: the all-f32 call's y in bf16, its state
    exactly. Mixed r/k/v, and bf16 logw under f32 r, are refused."""
    r, k, v, logw, u = _t(*_wkv_inputs(21, 2, 40, 2, 16))
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    y, s = wkv_ops.wkv6(rb, kb, vb, logw, u)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y32, s32 = wkv_ops.wkv6(rb.float(), kb.float(), vb.float(), logw, u)
    assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(s, s32)
    y2, _ = wkv_ops.wkv6(rb, kb, vb, logw.to(torch.bfloat16), u)
    assert y2.dtype == torch.bfloat16
    for bad in ((rb, k, v, logw), (r, kb, v, logw), (r, k, vb, logw),
                (r, k, v, logw.to(torch.bfloat16)),
                (rb, kb, vb, logw.double())):
        with pytest.raises(TypeError):
            wkv_ops.wkv6(*bad, u)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def test_wkv_step_matches_reference():
    r, k, v, logw, u = _wkv_inputs(10, 3, 1, 2, 16)
    state = np.random.default_rng(11).standard_normal(
        (3, 2, 16, 16)).astype(np.float32)
    y, ns = r6._wkv_step(*_t(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u,
                             state))
    yj, nsj = jr6._wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, state)
    assert _maxabs(y, yj) < 1e-5 and _maxabs(ns, nsj) < 1e-5


def _layer0(jparams, params, jads, ads):
    jp = jax.tree_util.tree_map(lambda t: t[0], jparams["segments"][0])
    jad = jax.tree_util.tree_map(lambda t: t[0], jads["segments"][0])
    p = T._layer(params["segments"][0], 0)
    ad = T._layer(ads["segments"][0], 0)
    return jp, p, jad, ad


def _state_pair(seed):
    rng = np.random.default_rng(seed)
    H, K, d = 4, 32, CFG.d_model
    st = {"wkv": rng.standard_normal((2, H, K, K)).astype(np.float32),
          "last": rng.standard_normal((2, d)).astype(np.float32),
          "last_cm": rng.standard_normal((2, d)).astype(np.float32)}
    return st, {k: torch.from_numpy(v) for k, v in st.items()}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_timemix_and_channelmix_match_reference(weights, mode):
    jparams, params = weights
    jads, ads = _pair_adapters(4, 12)
    jp, p, jad, ad = _layer0(jparams, params, jads, ads)
    S = 24 if mode == "prefill" else 1
    x = np.random.default_rng(13).standard_normal(
        (2, S, CFG.d_model)).astype(np.float32)
    jst, st = _state_pair(14) if mode == "decode" else (None, None)
    o, ns = r6.apply_rwkv6_timemix(p["rwkv"], ad["rwkv"], torch.from_numpy(x),
                                   CFG, LORA.scale, state=st)
    oj, nsj = jax.jit(jr6.apply_rwkv6_timemix, static_argnums=(3, 4))(
        jp["rwkv"], jad["rwkv"], x, JCFG, JLORA.scale, state=jst)
    assert _maxabs(o, oj) < 1e-5
    if mode == "decode":
        assert _maxabs(ns["wkv"], nsj["wkv"]) < 1e-5
        assert _maxabs(ns["last"], nsj["last"]) == 0
    else:
        assert ns is None and nsj is None
    o, last = r6.apply_rwkv6_channelmix(p["rwkv"], ad["rwkv"],
                                        torch.from_numpy(x), CFG, LORA.scale,
                                        state=st)
    oj, lastj = jax.jit(jr6.apply_rwkv6_channelmix, static_argnums=(3, 4))(
        jp["rwkv"], jad["rwkv"], x, JCFG, JLORA.scale, state=jst)
    assert _maxabs(o, oj) < 1e-5
    assert (last is None) == (lastj is None)


def test_timemix_hands_wkv6_the_model_dtypes(weights, monkeypatch):
    """bf16 weights: the time-mix hands wkv6 its bf16 r, k, v and f32
    logw as they are. Its output is bit for bit the old call's, which
    widened r, k and v to f32 first (y is the same f32 sum, rounded to
    bf16 once), and it matches the reference's bf16 time-mix to two bf16
    ulps at the output's scale (the two frameworks round bf16
    activations at different points; one ulp is 7.8e-3 here)."""
    jparams, params = weights
    jads, ads = _pair_adapters(4, 15)
    jp, p, jad, ad = _layer0(jparams, params, jads, ads)
    pb = interop.tree_map(lambda t: t.to(torch.bfloat16), p["rwkv"])
    jpb = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16),
                                 jp["rwkv"])
    x = np.random.default_rng(16).standard_normal(
        (2, 24, CFG.d_model)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    seen = []
    real = r6.wkv6

    def spy(r, k, v, logw, u):
        seen.append((r.dtype, k.dtype, v.dtype, logw.dtype))
        return real(r, k, v, logw, u)
    monkeypatch.setattr(r6, "wkv6", spy)
    out, _ = r6.apply_rwkv6_timemix(pb, ad["rwkv"], xb, CFG, LORA.scale)
    assert seen == [(torch.bfloat16,) * 3 + (torch.float32,)]
    monkeypatch.setattr(r6, "wkv6", lambda r, k, v, logw, u: real(
        r.float(), k.float(), v.float(), logw, u))
    old, _ = r6.apply_rwkv6_timemix(pb, ad["rwkv"], xb, CFG, LORA.scale)
    assert out.dtype == torch.bfloat16 and torch.equal(out, old)
    want, _ = jax.jit(jr6.apply_rwkv6_timemix, static_argnums=(3, 4))(
        jpb, jad["rwkv"], jnp.asarray(x, jnp.bfloat16), JCFG, JLORA.scale)
    want = np.asarray(want, np.float32)
    assert _maxabs(out.float(), want) < 2 ** -6 * float(np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# The slice: prefill, decode, the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [24, 128])
def test_prefill_matches_reference_forward(weights, S):
    jparams, params = weights
    jads, ads = _pair_adapters(4, 15)
    tokens = np.random.default_rng(S).integers(0, JCFG.vocab_size, (2, S))
    want, _ = _j_forward(jparams, jads, JCFG, JLORA, {"tokens": tokens})
    before = (lm_ops.launches, wkv_ops.launches)
    got = make_prefill_step(CFG, LORA, device="cpu")(params, ads,
                                                     {"tokens": tokens})
    assert (lm_ops.launches, wkv_ops.launches) == before
    assert got.shape == want.shape
    assert _maxabs(got, want) <= TOL


def test_teacher_forced_decode_matches_reference(weights):
    jparams, params = weights
    jads, ads = _pair_adapters(4, 16)
    tokens = np.random.default_rng(17).integers(0, JCFG.vocab_size, (2, 10))
    jstep = jax.jit(lambda tok, c, t: JT.decode_step(
        jparams, jads, JCFG, JLORA, tok, c, t))
    jcaches = JT.init_caches(JCFG, 2, 4, dtype=jnp.float32)
    decode = make_decode_step(CFG, LORA, device="cpu")
    caches = T.init_caches(CFG, 2, 4, dtype=torch.float32, device="cpu")
    for t in range(tokens.shape[1]):
        want, jcaches = jstep(tokens[:, t:t + 1], jcaches,
                              jnp.asarray(t, jnp.int32))
        got, caches = decode(params, ads, tokens[:, t:t + 1], caches, t)
        assert _maxabs(got, want) <= TOL, f"step {t}"
    for name in ("wkv", "last", "last_cm"):     # |wkv| reaches ~5
        assert _rel(caches["segments"][0][name],
                    jcaches["segments"][0][name]) < 1e-5, name


def _decode_all(params, ads, tokens):
    decode = make_decode_step(CFG, LORA, device="cpu")
    B, S = tokens.shape
    caches = T.init_caches(CFG, B, S, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        logits, caches = decode(params, ads, tokens[:, t:t + 1], caches, t)
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1)


def test_decode_matches_forward(weights):
    _, params = weights
    _, ads = _pair_adapters(4, 18)
    tokens = np.random.default_rng(19).integers(0, CFG.vocab_size, (2, 12))
    full = make_prefill_step(CFG, LORA, device="cpu")(params, ads,
                                                      {"tokens": tokens})
    dec = _decode_all(params, ads, tokens)
    err = float((torch.softmax(full, -1) - torch.softmax(dec, -1)).abs().max())
    assert err < 2e-3


def test_reference_single_chunk_nan_is_not_copied(weights):
    """S = 300 is no multiple of 128, so the reference runs one chunk of
    300 and k·e^{−cum} overflows: its logits are NaN. The port chunks by
    128 (padded to 384): finite, and equal to its own teacher-forced
    decode."""
    jparams, params = weights
    tokens = np.random.default_rng(20).integers(0, CFG.vocab_size, (1, 300))
    want, _ = _j_forward(jparams, None, JCFG, JLORA, {"tokens": tokens})
    assert np.isnan(np.asarray(want)).any()
    got = make_prefill_step(CFG, LORA, device="cpu")(params, None,
                                                     {"tokens": tokens})
    assert torch.isfinite(got).all()
    dec = _decode_all(params, None, tokens)
    err = float((torch.softmax(got, -1) - torch.softmax(dec, -1)).abs().max())
    assert err < 2e-3


def _paged_pair(rank, seed):
    jads = jlora.pad_adapter_tree(_jax_adapters(rank, seed), SLOT)
    scale = JLORA.alpha / rank
    jp = JPagedAdapter(task=0, rsu=-1, version=0, rank=rank, slot_rank=SLOT,
                       scale=scale, adapters=jads)
    pp = PagedAdapter(task=0, rsu=-1, version=0, rank=rank, slot_rank=SLOT,
                      scale=scale,
                      adapters=interop.adapters_from_jax(_np(jads), "cpu"))
    return jp, pp


def test_serve_engine_matches_reference_through_retire_admit(weights):
    """Three lanes at ranks 2/4/8 in slot 8, greedy on their own streams;
    lane 1 retires at step 3 (its recurrent state reset) and a rank-8
    tenant is admitted there at step 5. Per-step logits match the
    reference engine and the greedy streams are equal."""
    jparams, params = weights
    spec = dict(max_batch=3, cache_len=8, max_rank=SLOT)
    jeng = JServeEngine(jparams, JCFG, JLORA, JServeSpec(**spec))
    # the reference's step mutates _positions in place right after an
    # asynchronous dispatch (ROADMAP Queue 3): wait for each decode
    decode = jeng._decode
    jeng._decode = lambda *args: jax.block_until_ready(decode(*args))
    eng = ServeEngine(params, CFG, LORA, ServeSpec(**spec), device="cpu")
    for lane, (rank, seed) in enumerate([(2, 21), (4, 22), (8, 23)]):
        jp, pp = _paged_pair(rank, seed)
        jeng.assign(lane, jp)
        eng.assign(lane, pp)
    jtok = ptok = np.array([1, 2, 3])
    streams_j, streams_p = [], []
    for step in range(10):
        if step == 3:
            jeng.retire(1)
            eng.retire(1)
            assert not eng._caches["segments"][0]["wkv"][:, 1].any()
        if step == 5:
            jp, pp = _paged_pair(8, 24)
            assert jeng.admit(jp) == 1 and eng.admit(pp) == 1
        want = np.asarray(jeng.step(jtok))
        got = eng.step(ptok).numpy()
        assert _maxabs(got, want) <= TOL, f"step {step}"
        jtok, ptok = want.argmax(-1), got.argmax(-1)
        streams_j.append(jtok)
        streams_p.append(ptok)
    np.testing.assert_array_equal(np.stack(streams_p), np.stack(streams_j))
    np.testing.assert_array_equal(eng._positions, jeng._positions)
