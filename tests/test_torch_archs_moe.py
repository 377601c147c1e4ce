"""The MoE archs, grok-1-314b (attn + routed experts with per-expert
adapters, a logits softcap of 30) and deepseek-v2-236b (MLA + MoE with a
shared expert), against the reference, on the CPU.

Per arch: the config copies equal the reference's field by field (full
and reduced, the nested MoEConfig / MLAConfig included), and so do the
param counts (grok-1-314b's 213 B pins ROADMAP Queue 3, fault 5); at the
reduced size (2 layers, f32, weights and adapters from the reference's
seeded init) the init trees have the reference's keys and shapes, the
prefill logits match ``T.forward`` to 1e-4 and the MoE aux to 1e-6,
``loss_fn`` and the adapters' gradients match ``jax.value_and_grad`` of
the reference's to 1e-4, teacher-forced decode matches the port's own
forward (softmax within 2e-3, the reference's
``tests/test_decode_consistency.py``) and the reference's decode logits
to 1e-4, and a paged engine decodes the dense engine's bits. A deepseek
variant with ``q_lora_rank`` 32 (set in both packages) holds the full
config's ``q_down`` / ``q_up`` path. The MoE's dispatch equals the
reference's, an overflowing case included; lane-batched adapters route
each lane against its own capacity, as the reference's vmapped lanes do;
a two-lane engine's decode equals two one-lane reference decodes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.configs import deepseek_v2_236b as jdeep
from repro.configs import grok1_314b as jgrok
from repro.core import lora as jlora
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.config import LoRAConfig, ServeSpec, get_arch
from repro_torch.configs import deepseek_v2_236b, grok1_314b
from repro_torch.core import lora as lora_lib
from repro_torch.launch.adapter_cache import PagedAdapter
from repro_torch.launch.serve import ServeEngine, make_prefill_step
from repro_torch.models import moe
from repro_torch.models import transformer as T

torch.set_num_threads(1)

ARCHS = {"grok-1-314b": (jgrok, grok1_314b, "grok1_314b"),
         "deepseek-v2-236b": (jdeep, deepseek_v2_236b, "deepseek_v2_236b")}
# the reduced deepseek has q_lora_rank 0; this variant holds q_down/q_up
VARIANTS = ["grok-1-314b", "deepseek-v2-236b", "deepseek-v2-236b-q32"]
JLORA = JLoRAConfig(rank=4)
LORA = LoRAConfig(rank=4)
TOL = 1e-4
B, S = 2, 12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reduced(variant):
    jmod, pmod, _ = ARCHS[variant.replace("-q32", "")]
    jcfg, cfg = jmod.reduced(), pmod.reduced()
    if variant.endswith("-q32"):
        jcfg = jcfg.with_overrides(
            mla=dataclasses.replace(jcfg.mla, q_lora_rank=32))
        cfg = cfg.with_overrides(
            mla=dataclasses.replace(cfg.mla, q_lora_rank=32))
    return jcfg, cfg


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.fixture(scope="module", params=VARIANTS)
def model(request):
    """(variant, reference cfg, port cfg, reference params, port params,
    reference adapters, port adapters, tokens) at the reduced size."""
    jcfg, cfg = _reduced(request.param)
    # the reference's functions run under jit here (eager dispatch of
    # their every op costs 3-4x the time)
    jp, ja = jax.jit(lambda k0, k7: (
        JT.init_params(k0, jcfg, jnp.float32),
        jax.tree_util.tree_map(lambda x: x + 0.01,
                               JT.init_adapters(k7, jcfg, JLORA, rank=4))))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(7))
    # the reference's own decode test draws its tokens so; the forward's
    # capacity drops tokens that decode (2 tokens a step) keeps, which
    # moves grok's softmax by up to 2.5e-3 at other tokens, in both
    # packages alike (the port's forward and decode each hold the
    # reference's to 1e-4 whatever the tokens)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(0), (B, S), 0,
                                         cfg.vocab_size))
    return (request.param, jcfg, cfg, jp,
            interop.params_from_jax(_np(jp), device="cpu",
                                    dtype=torch.float32),
            ja, interop.adapters_from_jax(_np(ja), "cpu"), toks)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_copy_matches_reference(arch, which):
    jmod, pmod, fn = ARCHS[arch]
    jc = getattr(jmod, fn)() if which == "full" else jmod.reduced()
    pc = getattr(pmod, fn)() if which == "full" else pmod.reduced()
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    for sub in ("moe", "mla"):
        if getattr(jc, sub) is None:
            assert getattr(pc, sub) is None
        else:
            assert dataclasses.asdict(getattr(pc, sub)) == \
                dataclasses.asdict(getattr(jc, sub))
    assert pc.blocks() == jc.blocks()
    assert pc.resolved_head_dim == jc.resolved_head_dim
    assert pc.param_counts() == jc.param_counts()
    if which == "full":
        assert get_arch(arch) == pc


def test_grok_param_count_keeps_the_reference_fault():
    """ROADMAP Queue 3, fault 5: the reference counts grok-1-314b's
    non-gated gelu experts at two matrices each (8 x 6144 x 32768 x 2 a
    layer), so its total is 213.4 B, not the 314 B of its name. The port
    copies the count, fault and all."""
    c = grok1_314b.grok1_314b()
    d, f, E, L = 6144, 32768, 8, 64
    attn = d * 128 * (48 + 2 * 8) + 48 * 128 * d
    blocks = L * (attn + E * d * f * 2 + d * E)
    embed = 2 * 131072 * d
    counts = c.param_counts()
    assert counts["blocks_total"] == blocks
    assert counts["total"] == blocks + embed
    assert 213.4e9 < counts["total"] < 213.5e9
    assert counts == jgrok.grok1_314b().param_counts()


def test_init_trees_have_the_reference_layout(model):
    _, jcfg, cfg, jp, pp, ja, pa, _ = model
    shapes = lambda t: interop.tree_map(lambda x: tuple(x.shape), t)
    jshapes = lambda t: jax.tree_util.tree_map(lambda x: tuple(x.shape), t)
    assert shapes(pp) == jshapes(jp)
    assert shapes(pa) == jshapes(ja)
    mine = T.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    assert shapes(mine) == jshapes(jp)
    mine_ad = T.init_adapters(cfg, LORA, seed=1, device="cpu")
    assert shapes(mine_ad) == jshapes(ja)
    moe_ad = mine_ad["segments"][0]["moe"]
    if cfg.moe.num_shared_experts:      # deepseek: the shared expert only
        assert set(moe_ad) == {"shared"}
    else:                               # grok: per-expert (L, E, d, r)
        E, d = cfg.moe.num_experts, cfg.d_model
        assert tuple(moe_ad["w_up"]["a"].shape) == (2, E, d, 4)
        assert torch.count_nonzero(moe_ad["w_down"]["b"]) == 0


@pytest.mark.parametrize("case", ["seeded", "overflow"])
def test_dispatch_indices_match_reference(case):
    """Token, expert, slot, keep and order equal the reference's; in the
    overflow case every token picks expert 0 first, so assignments past
    the capacity are dropped."""
    T_, k, E = 24, 2, 4
    rng = np.random.default_rng(3)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(T_)])
    if case == "overflow":
        ids[:, 0] = 0
        ids[:, 1] = rng.integers(1, E, T_)
    cap = max(int(np.ceil(T_ * k / E * 1.25)), 8)
    want = jmoe._dispatch_indices(jnp.asarray(ids), E, cap, k)
    got = moe._dispatch_indices(torch.from_numpy(ids), E, cap, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "overflow":
        assert int((~got[3]).sum()) == T_ - cap


def test_prefill_matches_reference_forward(model):
    _, jcfg, cfg, jp, pp, ja, pa, toks = model
    want, jaux = jax.jit(lambda t: JT.forward(jp, ja, jcfg, JLORA,
                                              {"tokens": t}))(toks)
    got = make_prefill_step(cfg, LORA, device="cpu")(pp, pa,
                                                     {"tokens": toks})
    assert got.shape == want.shape
    assert _maxabs(got, want) <= TOL
    _, aux = T.forward(pp, pa, cfg, LORA, {"tokens": torch.from_numpy(toks)})
    assert float(jaux) > 0.0
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_loss_and_adapter_grads_match_reference(model):
    _, jcfg, cfg, jp, pp, ja, pa, toks = model
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    batch = {"tokens": toks, "labels": labels}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda a: JT.loss_fn(jp, a, jcfg, JLORA, batch), has_aux=True))(ja)
    ads = interop.tree_map(lambda x: x.clone().requires_grad_(True), pa)
    loss, m = T.loss_fn(pp, ads, cfg, LORA,
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    leaves, refs = [], []
    interop.tree_map(lambda x, g: (leaves.append(x), refs.append(g)), ads,
                     _np(jgrads))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert abs(float(m["aux"].detach()) - float(jm["aux"])) <= 1e-6
    err = max(_maxabs(g, r) for g, r in zip(grads, refs))
    assert err <= TOL, f"adapter grads max abs {err}"
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_teacher_forced_decode_matches_forward_and_reference(model):
    """Incremental decode over the same tokens reproduces the full
    forward (latent / KV caches end to end) and the reference's decode
    steps."""
    _, jcfg, cfg, jp, pp, ja, pa, toks = model
    full, _ = T.forward(pp, pa, cfg, LORA, {"tokens": torch.from_numpy(toks)})
    caches = T.init_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    jcaches = JT.init_caches(jcfg, B, S, dtype=jnp.float32)
    jstep = jax.jit(lambda tok, c, t: JT.decode_step(jp, ja, jcfg, JLORA,
                                                     tok, c, t))
    outs = []
    for t in range(S):
        got, caches = T.decode_step(pp, pa, cfg, LORA,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    caches, t)
        want, jcaches = jstep(toks[:, t:t + 1], jcaches,
                              jnp.asarray(t, jnp.int32))
        assert _maxabs(got, want) <= TOL, f"step {t}"
        outs.append(got[:, 0])
    dec = torch.stack(outs, dim=1)
    err = float((torch.softmax(full, -1) - torch.softmax(dec, -1))
                .abs().max())
    assert err < 2e-3, f"decode diverges from forward (max {err})"


def _tenant(pa, slot, lora, seed):
    ads = interop.tree_map(
        lambda x: x + 0.01 * seed * torch.ones_like(x), pa)
    return PagedAdapter(task=0, rsu=-1, version=seed, rank=4,
                        slot_rank=slot, scale=lora.scale,
                        adapters=lora_lib.pad_adapter_tree(ads, slot))


def test_paged_engine_equals_dense(model):
    _, _, cfg, _, pp, _, pa, _ = model
    slot = 8
    lora = dataclasses.replace(LORA, max_rank=slot)
    tenant = _tenant(pa, slot, lora, 1)
    outs = []
    for bs in (0, 4):
        eng = ServeEngine(pp, cfg, lora,
                          ServeSpec(max_batch=2, cache_len=8, block_size=bs),
                          device="cpu")
        eng.assign(0, tenant)
        prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                    (2, 3))
        gen = eng.generate(prompts, 4)
        eng.retire(0)
        eng.admit(tenant)
        outs.append((gen, eng.generate(prompts, 8)))   # the ring wraps
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_two_lane_engine_equals_one_lane_reference_decodes(model):
    """Each lane of a two-lane engine (its own adapters, padded into an
    8-wide slot) decodes what the reference's decode_step gives for that
    lane alone (B 1, its own capacity of 8), step by step: the lanes'
    tokens never share an expert buffer and their adapters never mix."""
    _, jcfg, cfg, jp, pp, ja, pa, toks = model
    slot = 8
    lora = dataclasses.replace(LORA, max_rank=slot)
    eng = ServeEngine(pp, cfg, lora, ServeSpec(max_batch=2, cache_len=S),
                      device="cpu")
    jads = []
    for lane in range(2):
        tenant = _tenant(pa, slot, lora, lane + 1)
        eng.assign(lane, tenant)
        jads.append(interop.to_numpy(tenant.adapters))
    jstep = jax.jit(lambda ad, tok, c, t: JT.decode_step(
        jp, ad, jcfg, JLORA, tok, c, t, scale=lora.scale))
    jcaches = [JT.init_caches(jcfg, 1, S, dtype=jnp.float32)
               for _ in range(2)]
    for t in range(6):
        got = eng.step(toks[:, t])
        for lane in range(2):
            want, jcaches[lane] = jstep(jads[lane],
                                        toks[lane:lane + 1, t:t + 1],
                                        jcaches[lane],
                                        jnp.asarray(t, jnp.int32))
            assert _maxabs(got[lane], want[0, 0]) <= TOL, (t, lane)


def test_lane_batched_moe_routes_each_lane_against_its_own_capacity(model):
    """apply_moe with lane-batched adapters equals the reference's
    apply_moe run lane by lane (as its vmapped lanes run it), at a size
    where one lane's 12 tokens overflow the capacity of 8 that pooling the
    two lanes (24 tokens, capacity 15) would not."""
    _, jcfg, cfg, jp, pp, ja, pa, _ = model
    p = jax.tree_util.tree_map(lambda t: t[0], jp["segments"][0]["moe"])
    tp = T._layer(pp["segments"][0]["moe"], 0)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    lane_ads = []
    for lane in range(2):
        ad = jax.tree_util.tree_map(
            lambda t: t[0] * (1.0 + lane), ja["segments"][0]["moe"])
        lane_ads.append(ad)
    stacked = jax.tree_util.tree_map(lambda *t: np.stack(t), *lane_ads)
    scales = torch.tensor([0.5, 2.0])
    got, aux = moe.apply_moe(tp, interop.adapters_from_jax(stacked, "cpu"),
                             torch.from_numpy(x), cfg, scales)
    assert tuple(aux.shape) == (2,)
    dropped = 0
    jmoe_apply = jax.jit(lambda ad, xv, sc: jmoe.apply_moe(p, ad, xv, jcfg,
                                                          sc))
    for lane in range(2):
        want, jaux = jmoe_apply(lane_ads[lane], x[lane:lane + 1],
                                float(scales[lane]))
        assert _maxabs(got[lane:lane + 1].numpy(), want) <= TOL
        assert abs(float(aux[lane]) - float(jaux)) <= 1e-6
        logits = x[lane] @ np.asarray(p["router"]["w"])
        top = np.argsort(-logits, axis=-1)[:, :cfg.moe.top_k]
        dropped += int(np.maximum(np.bincount(top.ravel(),
                                              minlength=4) - 8, 0).sum())
    assert dropped > 0


def test_per_expert_adapters_pad_and_truncate_on_the_rank_axis(model):
    """A tenant's (L, E, d, r) leaves page into the slot as the
    reference's do (a's last axis, b's axis -2) and truncate back."""
    _, _, _, _, _, ja, pa, _ = model
    padded = lora_lib.pad_adapter_tree(pa, 8)
    want = _np(jlora.pad_adapter_tree(ja, 8))
    interop.tree_map(lambda g, w: np.testing.assert_array_equal(
        g.numpy(), w), padded, want)
    back = lora_lib.truncate_adapter_tree(padded, 4)
    interop.tree_map(lambda g, w: np.testing.assert_array_equal(
        g.numpy(), w.numpy()), back, pa)
    assert lora_lib.tree_rank(padded) == 8


def test_lanes_and_ce_chunk_keep_their_meaning(model):
    """loss_fn's lanes: two lanes of lane-batched adapters (leaves
    (L, 2, ...)) give each lane the loss, aux and gradient it has alone
    (the MoE routes each lane's rows against its own capacity); ce_chunk
    changes nothing but the peak logits and the CE's summation order."""
    _, _, cfg, _, pp, _, pa, toks = model
    labels = torch.from_numpy(np.roll(toks, -1, axis=1))
    tok = torch.from_numpy(toks)
    trees = [interop.tree_map(lambda x: x * s, pa) for s in (1.0, 1.5)]
    alone = [T.loss_fn(pp, ad, cfg, LORA, {"tokens": tok[v:v + 1],
                                           "labels": labels[v:v + 1]})
             for v, ad in enumerate(trees)]
    lanes = interop.tree_map(lambda a, b: torch.stack([a, b], 1)
                             .requires_grad_(True), *trees)
    loss, m = T.loss_fn(pp, lanes, cfg, LORA,
                        {"tokens": tok, "labels": labels}, lanes=2)
    for v, (lv, mv) in enumerate(alone):
        assert abs(float(m["loss"][v]) - float(mv["loss"])) <= 1e-5
        assert abs(float(m["aux"][v]) - float(mv["aux"])) <= 1e-6
    assert abs(float(loss.detach()) - sum(float(lv) for lv, _ in alone)) \
        <= 1e-5
    chunked, _ = T.loss_fn(pp, pa, cfg, LORA,
                           {"tokens": tok, "labels": labels}, ce_chunk=4)
    whole, _ = T.loss_fn(pp, pa, cfg, LORA,
                         {"tokens": tok, "labels": labels})
    # the chunks' CE sums add in another order (f32, losses ~6)
    assert abs(float(chunked) - float(whole)) <= 1e-5
