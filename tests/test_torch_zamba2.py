"""zamba2-2.7b (a Mamba2 stack with one shared attention block applied
after every ``shared_attn_every`` mamba layers) against the reference, on
the CPU.

Configs: ``zamba2_2_7b.reduced()`` (2 layers, d 128, SSM heads of 32,
state 16, the shared block after layer 2) and a 5-layer variant with
``shared_attn_every`` 2 (two groups and one remainder layer, which no
shared block follows), f32, weights and adapters from the reference's
seeded init carried across with ``repro_torch.interop``; inputs are numpy
arrays from a seed. On the CPU the port's ``lora_matmul`` and
``flash_attention`` (head dim 32 here, 80 at full width) take their plain
versions.

Tolerances: modules 1e-5 (f32, the SSD's einsums in another order);
logits 1e-4 of their largest entry; the loss 1e-5 and the adapter
gradients 1e-5 of the largest gradient entry (relative); teacher-forced
decode against the reference's decode_step 1e-4; decode against forward
2e-3 on softmax probabilities (``tests/test_decode_consistency.py:47``).
Serving is held to the port's own dense engine bit for bit, and to the
reference's decode_step lane by lane (the reference's zamba2 serving
tests are not an oracle here: ROADMAP lists them as failing or flaky on
this container).

Also pinned: reference fault 7 (``param_counts`` leaves the shared block
out) and fault 8 (the serial and batched trainers multiply the FedRA
layer mask into the shared block's unstacked adapters: the reference
fails, the port refuses; the fused round refuses zamba2, item 11).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.configs import zamba2_2_7b as jzamba
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.models import mamba2 as jm2
from repro.models import transformer as JT
from repro.sim.simulator import IoVSimulator as JSimulator
from repro.sim.simulator import SimConfig as JSimConfig
from repro_torch import interop
from repro_torch.config import BLOCK_MAMBA2, LoRAConfig, ServeSpec, get_arch
from repro_torch.configs import zamba2_2_7b
from repro_torch.core import kv_blocks as kvb
from repro_torch.core import lora as lora_lib
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.adapter_cache import PagedAdapter
from repro_torch.launch.serve import ServeEngine, make_prefill_step
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as T
from repro_torch.sim.simulator import IoVSimulator, SimConfig

torch.set_num_threads(1)

JLORA = JLoRAConfig(rank=4)
LORA = LoRAConfig(rank=4)
TOL = 1e-4
MOD_TOL = 1e-5
B, S = 2, 12
FAULT7_TOTAL = 2_315_960_320        # param_counts()["total"], both packages
FAULT7_TREE = 2_422_393_760         # what init_params builds
FAULT7_SHARED = 104_862_720         # of which params["shared_attn"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _variant(mod, layers, every):
    return mod.reduced().with_overrides(
        num_layers=layers, block_pattern=(BLOCK_MAMBA2,) * layers,
        shared_attn_every=every)


VARIANTS = {"reduced": (2, 2), "5-layers-every-2": (5, 2)}


@functools.lru_cache(maxsize=None)
def _load(name):
    """(name, reference cfg, port cfg, reference params, port params,
    reference adapters, port adapters, tokens), built once per variant
    (the reference's init and every reference call below run under jit:
    its eager dispatch costs several times the time)."""
    jcfg, cfg = (_variant(m, *VARIANTS[name]) for m in (jzamba, zamba2_2_7b))
    jp, ja = jax.jit(lambda k0, k7: (
        JT.init_params(k0, jcfg, jnp.float32),
        jax.tree_util.tree_map(lambda x: x + 0.01,
                               JT.init_adapters(k7, jcfg, JLORA, rank=4))))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(7))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    return (name, jcfg, cfg, jp,
            interop.params_from_jax(_np(jp), device="cpu",
                                    dtype=torch.float32),
            ja, interop.adapters_from_jax(_np(ja), "cpu"), toks)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    return _load(request.param)


# ---------------------------------------------------------------------------
# Config and structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_copy_matches_reference(which):
    jc = jzamba.zamba2_2_7b() if which == "full" else jzamba.reduced()
    pc = zamba2_2_7b.zamba2_2_7b() if which == "full" else \
        zamba2_2_7b.reduced()
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.blocks() == jc.blocks()
    assert pc.resolved_head_dim == jc.resolved_head_dim
    assert pc.param_counts() == jc.param_counts()
    if which == "full":
        assert get_arch("zamba2-2.7b") == pc


def test_fault_7_param_counts_leave_out_the_shared_block():
    """Reference fault 7 (ROADMAP Queue 3), copied and pinned: the count
    covers the mamba blocks and the embeddings, not the shared block, so
    it is 106,433,440 short of the tree (the shared block's 104,862,720
    plus the norms, convs and per-head leaves it does not count)."""
    jc, pc = jzamba.zamba2_2_7b(), zamba2_2_7b.zamba2_2_7b()
    assert pc.param_counts()["total"] == jc.param_counts()["total"] \
        == FAULT7_TOTAL
    shapes = jax.eval_shape(lambda k: JT.init_params(k, jc, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    count = lambda t: sum(int(np.prod(x.shape))
                          for x in jax.tree_util.tree_leaves(t))
    assert count(shapes) == FAULT7_TREE
    assert count(shapes["shared_attn"]) == FAULT7_SHARED


def test_init_trees_have_the_reference_layout(model):
    _, jcfg, cfg, jp, pp, ja, pa, _ = model
    shapes = lambda t: interop.tree_map(lambda x: tuple(x.shape), t)
    jshapes = lambda t: jax.tree_util.tree_map(lambda x: tuple(x.shape), t)
    assert shapes(pp) == jshapes(jp)
    assert shapes(pa) == jshapes(ja)
    mine = T.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    assert shapes(mine) == jshapes(jp)
    assert sorted(mine["shared_attn"]) == ["attn", "mlp", "norm1", "norm2"]
    assert shapes(T.init_adapters(cfg, LORA, seed=1, device="cpu")) == \
        jshapes(ja)
    assert sum(x.numel() for x in _leaves(mine)) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))


def _leaves(tree):
    out = []
    interop.tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_interop_carries_the_mamba_and_shared_trees_both_ways(dtype):
    """The reference's params (the mamba segment and the shared block)
    and adapters go to the port and back bit for bit; bf16 through
    f32, which holds every bf16 value."""
    jcfg = jzamba.reduced()
    jp = jax.jit(lambda k: JT.init_params(k, jcfg, dtype))(
        jax.random.PRNGKey(2))
    pp = interop.params_from_jax(_np(jp), device="cpu",
                                 dtype=torch.bfloat16 if dtype ==
                                 jnp.bfloat16 else torch.float32)
    assert pp["shared_attn"]["attn"]["q"]["w"].dtype == (
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    back = interop.to_numpy(pp)
    want = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    _, _, _, _, _, ja, pa, _ = _load("reduced")
    for a, b in zip(jax.tree_util.tree_leaves(interop.to_numpy(pa)),
                    jax.tree_util.tree_leaves(_np(ja))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("leaf", ["a_log", "d_skip", "dt_bias"])
def test_deterministic_mamba_leaves_match_reference(model, leaf):
    """The port computes them in float64 and rounds once; XLA's f32
    linspace / log / expm1 may land one ulp away."""
    _, _, cfg, jp, _, _, _, _ = model
    mine = T.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    got = mine["segments"][0]["mamba"][leaf].numpy()
    want = np.asarray(jp["segments"][0]["mamba"][leaf])
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 8), (1, 4, 2, 16), (5,)])
def test_segsum_matches_reference(shape):
    a = -np.abs(np.random.default_rng(len(shape)).standard_normal(shape)
                ).astype(np.float32)
    got = m2._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(jm2._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert _maxabs(got[fin], want[fin]) <= MOD_TOL


def _ssd_operands(S_, seed=0, b=2, H=3, P=4, N=5):
    rng = np.random.default_rng(seed + S_)
    x = rng.standard_normal((b, S_, H, P)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((b, S_, H))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, S_, N)).astype(np.float32)
              for _ in range(2))
    return x, dt, a_log, Bm, Cm


@pytest.mark.parametrize("S_,chunk", [(24, 8), (32, 8), (20, 20)],
                         ids=["3-chunks", "4-chunks", "one-ragged-chunk"])
def test_ssd_chunked_matches_reference(S_, chunk):
    args = _ssd_operands(S_)
    y, st = m2._ssd_chunked(*(torch.from_numpy(t) for t in args), chunk)
    jy, jst = jax.jit(lambda *a: jm2._ssd_chunked(*a, chunk))(*args)
    assert y.shape == jy.shape and st.shape == jst.shape
    assert _maxabs(y, jy) <= MOD_TOL and _maxabs(st, jst) <= MOD_TOL


def test_ssd_chunking_does_not_change_the_result():
    """Several chunks and one chunk of S compute the same SSD."""
    args = [torch.from_numpy(t) for t in _ssd_operands(24, seed=5)]
    y8, s8 = m2._ssd_chunked(*args, 8)
    y24, s24 = m2._ssd_chunked(*args, 24)
    assert float((y8 - y24).abs().max()) <= MOD_TOL
    assert float((s8 - s24).abs().max()) <= MOD_TOL


@pytest.mark.parametrize("tail", [False, True], ids=["no-tail", "tail"])
def test_causal_conv_matches_reference(tail):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    bias = rng.standard_normal((6,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if tail else None
    got, gst = m2._causal_conv(*(None if t is None else torch.from_numpy(t)
                                 for t in (x, w, bias, st)))
    want, wst = jm2._causal_conv(*(None if t is None else jnp.asarray(t)
                                   for t in (x, w, bias, st)))
    assert _maxabs(got, want) <= MOD_TOL
    assert np.array_equal(gst.numpy(), np.asarray(wst))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_mamba2_matches_reference(model, mode):
    """One mamba block with its adapters: a prefill of S 12 (one ragged
    chunk) and a decode step from a nonzero state."""
    _, jcfg, cfg, jp, pp, ja, pa, _ = model
    jblk = jax.tree_util.tree_map(lambda t: t[0], jp["segments"][0]["mamba"])
    jad = jax.tree_util.tree_map(lambda t: t[0], ja["segments"][0]["mamba"])
    blk = T._layer(pp["segments"][0]["mamba"], 0)
    ad = T._layer(pa["segments"][0]["mamba"], 0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 1 if mode == "decode" else S,
                             cfg.d_model)).astype(np.float32)
    jstate = state = None
    if mode == "decode":
        s0 = jm2.init_mamba2_state(jcfg, B)
        jstate = jax.tree_util.tree_map(
            lambda t: jnp.asarray(rng.standard_normal(t.shape), t.dtype), s0)
        state = interop.tree_map(lambda t: torch.from_numpy(np.array(t)),
                                 _np(jstate))
    want, wst = jax.jit(lambda xx, st: jm2.apply_mamba2(
        jblk, jad, xx, jcfg, 0.5, state=st))(x, jstate)
    got, gst = m2.apply_mamba2(blk, ad, torch.from_numpy(x), cfg, 0.5,
                               state=state)
    assert _maxabs(got, want) <= MOD_TOL
    if mode == "decode":
        for k in ("ssm", "conv"):
            assert _maxabs(gst[k], wst[k]) <= MOD_TOL
    else:
        assert gst is None and wst is None


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_forward_matches_reference(model):
    _, jcfg, cfg, jp, pp, ja, pa, toks = model
    want, _ = jax.jit(lambda b: JT.forward(jp, ja, jcfg, JLORA, b))(
        {"tokens": toks})
    got = make_prefill_step(cfg, LORA, device="cpu")(pp, pa, {"tokens": toks})
    assert tuple(got.shape) == (B, S, cfg.vocab_size) == want.shape
    assert _maxabs(got, want) <= TOL * float(np.max(np.abs(want)))


def test_loss_and_adapter_grads_match_reference(model):
    _, jcfg, cfg, jp, pp, ja, pa, toks = model
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    batch = {"tokens": toks, "labels": labels}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda a: JT.loss_fn(jp, a, jcfg, JLORA, batch), has_aux=True))(ja)
    ads = interop.tree_map(lambda x: x.clone().requires_grad_(True), pa)
    loss, _ = T.loss_fn(pp, ads, cfg, LORA,
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    leaves, refs = [], []
    interop.tree_map(lambda x, g: (leaves.append(x), refs.append(g)), ads,
                     _np(jgrads))
    grads = torch.autograd.grad(loss, leaves)
    # mamba in/out_proj per segment, the shared block's 7 linears
    assert len(grads) == 2 * (2 + 7)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    scale = max(float(np.max(np.abs(r))) for r in refs)
    err = max(_maxabs(g, r) for g, r in zip(grads, refs))
    assert err <= 1e-5 * scale, f"adapter grads {err} of {scale}"
    # the shared block's adapters get a gradient (every application's)
    down_b = ads["shared_attn"]["mlp"]["down"]["b"]
    assert float(next(g for x, g in zip(leaves, grads) if x is down_b)
                 .abs().max()) > 0


def test_decode_matches_forward(model):
    """Teacher-forced decode reproduces the forward (SSM state and the
    shared block's rings end to end), the remainder layer included."""
    _, _, cfg, _, pp, _, pa, toks = model
    full, _ = T.forward(pp, pa, cfg, LORA, {"tokens": torch.from_numpy(toks)})
    caches = T.init_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    assert caches["shared_attn"]["k"].shape[0] == \
        cfg.num_layers // cfg.shared_attn_every
    outs = []
    for t in range(S):
        got, caches = T.decode_step(pp, pa, cfg, LORA,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    caches, t)
        outs.append(got[:, 0])
    dec = torch.stack(outs, dim=1)
    err = float((torch.softmax(full, -1) - torch.softmax(dec, -1))
                .abs().max())
    assert err < 2e-3, f"decode diverges from forward (max {err})"


def test_teacher_forced_decode_matches_reference():
    """The port's decode steps against the reference's decode_step (the
    reduced config: the reference's decode regroups the layers by
    shared_attn_every and takes no remainder)."""
    _, jcfg, cfg, jp, pp, ja, pa, toks = _load("reduced")
    caches = T.init_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    jcaches = JT.init_caches(jcfg, B, S, dtype=jnp.float32)
    jstep = jax.jit(lambda tok, c, t: JT.decode_step(jp, ja, jcfg, JLORA,
                                                     tok, c, t))
    for t in range(S):
        got, caches = T.decode_step(pp, pa, cfg, LORA,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    caches, t)
        want, jcaches = jstep(toks[:, t:t + 1], jcaches,
                              jnp.asarray(t, jnp.int32))
        assert _maxabs(got, want) <= TOL, f"step {t}"
    for k in ("ssm", "conv"):
        assert _maxabs(caches["segments"][0][k],
                       jcaches["segments"][0][k]) <= TOL
    assert np.array_equal(caches["shared_attn"]["pos"].numpy(),
                          np.asarray(jcaches["shared_attn"]["pos"]))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

SLOT = 8


def _tenant(pa, lora, seed):
    ads = interop.tree_map(lambda x: x + 0.01 * seed * torch.ones_like(x),
                           pa)
    return PagedAdapter(task=0, rsu=-1, version=seed, rank=4,
                        slot_rank=SLOT, scale=lora.scale,
                        adapters=lora_lib.pad_adapter_tree(ads, SLOT))


def _churn(eng, tenants, prompts, steps=20, churn=True):
    """Greedy-decode 3 lanes for ``steps``; with ``churn`` lane 1 retires
    at step 5, is re-admitted with another tenant at 8 (its blocks
    recycled) and lane 2 is reset at 13. Returns every step's logits."""
    for lane in range(3):
        eng.assign(lane, tenants[lane])
    tok = prompts[:, 0].copy()
    out = []
    for t in range(steps):
        if churn and t == 5:
            eng.retire(1)
        if churn and t == 8:
            assert eng.admit(tenants[3]) == 1
            tok[1] = prompts[1, 0]
        if churn and t == 13:
            eng.reset_lane(2)
            tok[2] = prompts[2, 0]
        logits = eng.step(tok)
        out.append(logits.clone())
        tok = torch.argmax(logits, -1).numpy()
    return torch.stack(out)


def test_paged_engine_equals_dense_through_churn(model):
    """Paged (blocks of 4, an 8-slot ring that wraps) == dense, every
    step's logits bit for bit, through retire, re-admit and reset; the
    pools hold only the shared block's rings."""
    _, _, cfg, _, pp, _, pa, _ = model
    lora = dataclasses.replace(LORA, max_rank=SLOT)
    tenants = [_tenant(pa, lora, s) for s in (1, 2, 3, 4)]
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 1))
    logits = {}
    for bs in (0, 4):
        eng = ServeEngine(pp, cfg, lora,
                          ServeSpec(max_batch=3, cache_len=8, block_size=bs),
                          device="cpu")
        logits[bs] = _churn(eng, tenants, prompts)
        if bs:
            assert kvb.paged_slots(cfg) == [("shared_attn",)]
            assert len(eng._pools) == 1
            assert eng.allocator.recycles > 0
            eng.allocator.check()
    assert torch.equal(logits[0], logits[4])


def test_churn_leaves_sibling_lanes_bit_identical(model):
    """Lane 0 decodes the same bits whether or not lanes 1 and 2 churn
    (the SSM and conv state of a retired or reset lane go back to zero
    and no other lane's moves)."""
    _, _, cfg, _, pp, _, pa, _ = model
    lora = dataclasses.replace(LORA, max_rank=SLOT)
    tenants = [_tenant(pa, lora, s) for s in (1, 2, 3, 4)]
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 1))
    runs = []
    for churn in (False, True):
        eng = ServeEngine(pp, cfg, lora,
                          ServeSpec(max_batch=3, cache_len=8, block_size=4),
                          device="cpu")
        runs.append(_churn(eng, tenants, prompts, churn=churn))
        if churn:
            eng.retire(2)
            state = eng.lane_cache(2)
            assert float(state["segments"][0]["ssm"].abs().max()) == 0
            assert float(state["segments"][0]["conv"].abs().max()) == 0
            assert int(state["shared_attn"]["pos"].max()) == -1
    assert torch.equal(runs[0][:, 0], runs[1][:, 0])


def test_engine_lanes_equal_reference_decode_steps():
    """Each lane of a two-lane engine (its own adapters in an 8-wide
    slot, its own scale) decodes what the reference's decode_step gives
    for that lane alone, step by step."""
    _, jcfg, cfg, jp, pp, _, pa, _ = _load("reduced")
    lora = dataclasses.replace(LORA, max_rank=SLOT)
    eng = ServeEngine(pp, cfg, lora, ServeSpec(max_batch=2, cache_len=S),
                      device="cpu")
    jads = []
    for lane in range(2):
        tenant = _tenant(pa, lora, lane + 1)
        eng.assign(lane, tenant)
        jads.append(interop.to_numpy(tenant.adapters))
    jstep = jax.jit(lambda ad, tok, c, t: JT.decode_step(
        jp, ad, jcfg, JLORA, tok, c, t, scale=lora.scale))
    jcaches = [JT.init_caches(jcfg, 1, S, dtype=jnp.float32)
               for _ in range(2)]
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 6))
    for t in range(6):
        got = eng.step(toks[:, t])
        for lane in range(2):
            want, jcaches[lane] = jstep(jads[lane],
                                        toks[lane:lane + 1, t:t + 1],
                                        jcaches[lane],
                                        jnp.asarray(t, jnp.int32))
            assert _maxabs(got[lane], want[0, 0]) <= TOL, (t, lane)


# ---------------------------------------------------------------------------
# Flash attention at head dim 80 (the shared block's at full width)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,kind", [(torch.bfloat16, "mma"),
                                        (torch.float32, "simt")])
def test_flash_takes_head_dim_80(dtype, kind):
    assert 80 in fa_ops.HEAD_DIMS
    assert fa_ops.variant(dtype, 80) == kind


@pytest.mark.parametrize("S_,H,Hkv,window", [(128, 8, 8, None),
                                             (100, 8, 2, None),
                                             (37, 4, 1, 8)])
def test_attend_at_head_dim_80_matches_reference(S_, H, Hkv, window):
    """The flash route at head dim 80: the port's attend (on the CPU, the
    kernel's plain version) against the reference's attention_ref, MHA
    as zamba2's and GQA, ragged lengths, with and without a window."""
    D = 80
    rng = np.random.default_rng(S_ + H)
    q, k, v = (rng.standard_normal((2, S_, h, D)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    assert attn_lib.attention_path(causal=True, Sq=S_, Sk=S_, hd_k=D,
                                   hd_v=D) == "flash"
    pos = torch.arange(S_)[None].expand(2, S_)
    got = attn_lib.attend(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, q_positions=pos,
                          sliding_window=window)
    want = jattention_ref(*(jnp.swapaxes(jnp.asarray(t), 1, 2)
                            for t in (q, k, v)), causal=True,
                          sliding_window=window)
    assert _maxabs(got.numpy(), np.swapaxes(np.asarray(want), 1, 2)) <= 2e-5


# ---------------------------------------------------------------------------
# zamba2 in the federated round: fault 8 and the fused engine
# ---------------------------------------------------------------------------

ROUND_KW = dict(num_vehicles=6, num_tasks=2, local_steps=1)


@pytest.mark.parametrize("engine", ["serial", "batched"])
def test_fault_8_reference_fails_and_the_port_refuses(engine):
    """The reference's trainers multiply the (L,) FedRA mask, reshaped
    (L, 1, ...), into the shared block's (d, r) adapter gradients and
    fail at the round's first train step; the port's trainers refuse
    there with a message that names the fault."""
    jsim = JSimulator(JSimConfig(train_arch=jzamba.reduced(), engine=engine,
                                 **ROUND_KW))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jsim.run_round()
    sim = IoVSimulator(SimConfig(train_arch=zamba2_2_7b.reduced(),
                                 engine=engine, **ROUND_KW), device="cpu")
    with pytest.raises(ValueError, match="fault 8"):
        sim.run_round()


@pytest.mark.parametrize("trainer", ["serial", "batched"])
def test_fault_8_trainers_refuse_unstacked_adapters(trainer):
    from repro_torch.federated.batched_client import BatchedLocalTrainer
    from repro_torch.federated.client import LocalTrainer
    cfg = zamba2_2_7b.reduced()
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    ads = T.init_adapters(cfg, LORA, seed=0, device="cpu")
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.long),
             "labels": torch.zeros((2,), dtype=torch.long)}
    with pytest.raises(ValueError, match="fault 8"):
        if trainer == "serial":
            tr = LocalTrainer(cfg, LORA, device="cpu")
            tr.train_step(params, ads, tr.opt.init(ads), batch,
                          torch.ones(cfg.num_layers))
        else:
            tr = BatchedLocalTrainer(cfg, LORA, max_steps=1, device="cpu")
            tr.train_step(params, ads, tr.opt.init(ads), batch, None, 1)


@pytest.mark.parametrize("engine", ["fused", "fused_check"])
def test_fused_round_refuses_zamba2(engine):
    with pytest.raises(NotImplementedError, match="item 11"):
        IoVSimulator(SimConfig(train_arch=zamba2_2_7b.reduced(),
                               engine=engine, **ROUND_KW), device="cpu")
