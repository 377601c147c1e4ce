"""The port's serving slice against the reference, on the CPU.

Weights and adapters come from the reference's seeded init and are
carried across with ``repro_torch.interop``; inputs are numpy arrays from
a seed. The config is ``qwen2_0_5b.reduced()`` (2 layers, d 128, vocab
512) in f32. On the CPU the port's kernel routes take their plain
versions. Tolerance: max abs logits difference ≤ 1e-4.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.config import ServeSpec as JServeSpec
from repro.configs import qwen2_0_5b as jqwen
from repro.core import lora as jlora
from repro.launch.adapter_cache import PagedAdapter as JPagedAdapter
from repro.launch.serve import ServeEngine as JServeEngine
from repro.launch.serve import make_decode_step as j_make_decode_step
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import runmode as jrunmode
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.config import LoRAConfig, ServeSpec, get_arch, list_archs
from repro_torch.configs import qwen2_0_5b
from repro_torch.core import lora
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.lora_matmul import ops as lm_ops
from repro_torch.launch.adapter_cache import PagedAdapter
from repro_torch.launch.serve import (ServeEngine, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import attention, common
from repro_torch.models import transformer as T

TOL = 1e-4
SLOT = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JCFG = jqwen.reduced()
CFG = qwen2_0_5b.reduced()
JLORA = JLoRAConfig(rank=4, max_rank=SLOT, candidate_ranks=(2, 4, 8))
LORA = LoRAConfig(rank=4, max_rank=SLOT)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _jax_adapters(rank, seed):
    ads = JT.init_adapters(jax.random.PRNGKey(seed), JCFG, JLORA, rank=rank)
    # b is zero-init; shift both factors so the adapter actually matters
    return jax.tree_util.tree_map(lambda x: x + 0.01 * jnp.ones_like(x), ads)


@pytest.fixture(scope="module")
def weights():
    jparams = JT.init_params(jax.random.PRNGKey(0), JCFG, jnp.float32)
    params = interop.params_from_jax(_np(jparams), device="cpu",
                                     dtype=torch.float32)
    return jparams, params


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, JCFG.vocab_size, (2, 12))


# ---------------------------------------------------------------------------
# Config and interop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_copy_matches_reference(which):
    jc = jqwen.qwen2_0_5b() if which == "full" else jqwen.reduced()
    pc = qwen2_0_5b.qwen2_0_5b() if which == "full" else qwen2_0_5b.reduced()
    for f in dataclasses.fields(pc):
        assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    assert pc.blocks() == jc.blocks()
    assert pc.resolved_head_dim == jc.resolved_head_dim


def test_lora_and_serve_spec_copies_match_reference():
    """Every field the two ServeSpecs share has the reference's default;
    the one the port leaves out is ``donate`` (JAX buffer donation)."""
    assert LORA.scale == JLORA.scale
    ours = {f.name for f in dataclasses.fields(ServeSpec)}
    theirs = {f.name for f in dataclasses.fields(JServeSpec)}
    assert theirs - ours == {"donate"} and ours <= theirs
    for name in ours:
        assert getattr(ServeSpec(), name) == getattr(JServeSpec(), name)
    assert ServeSpec(max_rank=0).resolve_max_rank(LORA) == SLOT
    with pytest.raises(ValueError):
        ServeSpec(admission="lifo")
    assert get_arch("qwen2-0.5b") == qwen2_0_5b.qwen2_0_5b()
    from repro.config import list_archs as j_list_archs
    assert list_archs() == j_list_archs() == [
        "deepseek-v2-236b", "gemma-7b", "grok-1-314b", "musicgen-medium",
        "paligemma-3b", "qwen2-0.5b", "rwkv6-7b", "smollm-135m",
        "starcoder2-15b", "vit-base-paper", "zamba2-2.7b"]


def test_interop_round_trip_is_exact(weights):
    jparams, params = weights
    back = interop.to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(_np(jparams)),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    jads = _np(_jax_adapters(4, 3))
    back = interop.to_numpy(interop.adapters_from_jax(jads, "cpu"))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jads)
    for a, b in zip(jax.tree_util.tree_leaves(jads),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_interop_bf16_goes_through_f32_exactly():
    x = jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16)
    t = interop.params_from_jax({"w": np.asarray(x)}, "cpu",
                                torch.bfloat16)["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))


def test_init_trees_have_the_reference_layout():
    jp = JT.init_params(jax.random.PRNGKey(1), JCFG, jnp.float32)
    pp = T.init_params(CFG, seed=1, dtype=torch.float32, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    pshapes = interop.tree_map(lambda x: tuple(x.shape), pp)
    assert pshapes == jshapes
    ja = JT.init_adapters(jax.random.PRNGKey(1), JCFG, JLORA)
    pa = T.init_adapters(CFG, LORA, seed=1, device="cpu")
    assert interop.tree_map(lambda x: tuple(x.shape), pa) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), ja)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_reference(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    got = common.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind)
    want = jcommon.apply_norm(p, x, kind)
    assert _maxabs(got, want) < 1e-6


def test_apply_rope_matches_reference_with_per_lane_positions():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    pos = np.array([[0], [7], [1000]])
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = jcommon.apply_rope(x, jnp.asarray(pos), 1e6)
    assert _maxabs(got, want) < 1e-5


@pytest.mark.parametrize("biased", [False, True])
def test_apply_lora_linear_matches_reference(biased):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    base = {"w": rng.standard_normal((24, 16)).astype(np.float32)}
    if biased:
        base["b"] = rng.standard_normal(16).astype(np.float32)
    ad = {"a": rng.standard_normal((24, 4)).astype(np.float32),
          "b": rng.standard_normal((4, 16)).astype(np.float32)}
    mask = np.array([1, 1, 0, 0], np.float32)
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
    got = lora.apply_lora_linear(t(base), t(ad), torch.from_numpy(x),
                                 (0.5, torch.from_numpy(mask)))
    want = jlora.apply_lora_linear(base, ad, x, (0.5, jnp.asarray(mask)))
    assert _maxabs(got, want) < 1e-5


@pytest.mark.parametrize("biased", [False, True])
def test_lane_batched_lora_linear_matches_reference_vmap(biased):
    """The written-out lane axis == the reference's vmap over lanes, each
    lane with its own adapter and scale."""
    rng = np.random.default_rng(4)
    B = 3
    x = rng.standard_normal((B, 1, 24)).astype(np.float32)
    base = {"w": rng.standard_normal((24, 16)).astype(np.float32)}
    if biased:
        base["b"] = rng.standard_normal(16).astype(np.float32)
    ad = {"a": rng.standard_normal((B, 24, 8)).astype(np.float32),
          "b": rng.standard_normal((B, 8, 16)).astype(np.float32)}
    scales = np.array([0.0, 1.0, 4.0], np.float32)
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
    got = lora.apply_lora_linear(t(base), t(ad), torch.from_numpy(x),
                                 (torch.from_numpy(scales), torch.ones(B, 8)))
    want = jax.vmap(lambda a_, x_, s_: jlora.apply_lora_linear(
        base, a_, x_, s_), in_axes=(0, 0, 0))(ad, x, scales)
    assert _maxabs(got, want) < TOL   # |y| reaches ~60 here


def test_rank_tree_helpers_match_reference():
    jads = _jax_adapters(4, 5)
    ads = interop.adapters_from_jax(_np(jads), "cpu")
    assert lora.tree_rank(ads) == jlora.tree_rank(jads) == 4
    padded = lora.pad_adapter_tree(ads, SLOT)
    jpadded = jlora.pad_adapter_tree(jads, SLOT)
    for a, b in zip(jax.tree_util.tree_leaves(_np(jpadded)),
                    jax.tree_util.tree_leaves(interop.to_numpy(padded))):
        np.testing.assert_array_equal(a, b)
    back = lora.truncate_adapter_tree(padded, 4)
    for a, b in zip(jax.tree_util.tree_leaves(_np(jads)),
                    jax.tree_util.tree_leaves(interop.to_numpy(back))):
        np.testing.assert_array_equal(a, b)
    mask = lora.rank_arange_mask(torch.tensor(2), SLOT)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jlora.rank_arange_mask(jnp.int32(2), SLOT)))
    got = interop.to_numpy(lora.mask_adapter_tree(padded, mask))
    want = _np(jlora.mask_adapter_tree(jpadded, jnp.asarray(mask.numpy())))
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        lora.pad_adapter_tree(padded, 4)


@pytest.mark.parametrize("route", ["decode", "direct"])
def test_attend_routes_match_reference(route):
    """Ring-buffer cache attention with per-lane positions and empty
    (-1) slots, and the short full-sequence direct route."""
    rng = np.random.default_rng(5)
    B, H, Hkv, D, Sk = 3, 4, 2, 32, 10
    Sq = 1 if route == "decode" else 6
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    kvp = np.tile(np.arange(Sk), (B, 1))
    kvp[1, 6:] = -1                       # a lane with empty ring slots
    qp = np.array([[9], [5], [3]]) if Sq == 1 else np.tile(
        np.arange(4, 10), (B, 1))
    assert attention.attention_path(causal=True, Sq=Sq, Sk=Sk) == route
    got = attention.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=True, q_positions=torch.from_numpy(qp),
                           kv_positions=torch.from_numpy(kvp),
                           sliding_window=4)
    want = jattn.attend(q, k, v, causal=True, q_positions=jnp.asarray(qp),
                        kv_positions=jnp.asarray(kvp), sliding_window=4)
    assert _maxabs(got, want) < 1e-5


# (case, Sq, Sk, hd_k, hd_v, window, cap): the blocked route's triggers
# (Sq != Sk past DIRECT_ATTN_MAX_SEQ, a softcap, hd_k != hd_v, decode
# with FAST_DECODE off) and its edges (padding to whole KV_BLOCKs, three
# blocks, a window, empty ring slots, a row with every key masked)
BLOCKED = {
    "Sk 100, padded": (80, 100, 32, 32, None, 0.0),
    "Sk 1100, three blocks": (80, 1100, 32, 32, None, 0.0),
    "window": (80, 1100, 32, 32, 16, 0.0),
    "softcap 30": (100, 100, 32, 32, None, 30.0),
    "hd_k 192, hd_v 128": (80, 80, 192, 128, None, 0.0),
    "empty ring slots": (80, 600, 32, 32, 64, 0.0),
    "a fully masked row": (80, 100, 32, 32, None, 0.0),
    "decode, FAST_DECODE off": (1, 700, 32, 32, None, 0.0),
}


@pytest.mark.parametrize("case", list(BLOCKED))
def test_attend_blocked_route_matches_reference(case, monkeypatch):
    """The blocked online-softmax route (plain tensor code on every
    device) against the reference's jnp route, GQA (4 query heads on 2),
    f32, to 1e-5. A row with every key masked averages its values over
    the padded block, as the reference's finite NEG_INF makes it."""
    Sq, Sk, hd_k, hd_v, window, cap = BLOCKED[case]
    rng = np.random.default_rng(len(case))
    B, H, Hkv = 2, 4, 2
    q = rng.standard_normal((B, Sq, H, hd_k)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd_k)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd_v)).astype(np.float32)
    kvp = np.tile(np.arange(Sk), (B, 1))
    qp = np.tile(np.arange(Sk - Sq, Sk), (B, 1))
    if case == "empty ring slots":
        kvp[1, 400:] = -1
        kvp[0, ::7] = -1
    if case == "a fully masked row":
        kvp[0] += 30                     # keys start past query 0's position
        qp[0, 0] = 10
    fast = case != "decode, FAST_DECODE off"
    monkeypatch.setattr(attention.runmode, "FAST_DECODE", fast)
    assert attention.attention_path(causal=True, Sq=Sq, Sk=Sk, cap=cap,
                                    hd_k=hd_k, hd_v=hd_v) == "blocked"
    got = attention.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=True, q_positions=torch.from_numpy(qp),
                           kv_positions=torch.from_numpy(kvp),
                           sliding_window=window, cap=cap)
    with jrunmode.overrides(FAST_DECODE=fast):
        assert jattn.attention_path(causal=True, Sq=Sq, Sk=Sk, cap=cap,
                                    hd_k=hd_k, hd_v=hd_v) == "jnp_flash"
        want = jattn.attend(q, k, v, causal=True,
                            q_positions=jnp.asarray(qp),
                            kv_positions=jnp.asarray(kvp),
                            sliding_window=window, cap=cap)
    assert got.shape == (B, Sq, H, hd_v)
    assert _maxabs(got, want) <= 1e-5
    if case == "a fully masked row":
        padded = -(-Sk // attention.KV_BLOCK) * attention.KV_BLOCK
        mean = v[0].repeat(2, axis=1).sum(0) / padded     # (H, hd_v)
        assert _maxabs(got[0, 0], mean) <= 1e-6


# ---------------------------------------------------------------------------
# The slice: prefill and decode
# ---------------------------------------------------------------------------

def test_prefill_matches_reference_forward(weights, tokens):
    jparams, params = weights
    jads = _jax_adapters(4, 7)
    ads = interop.adapters_from_jax(_np(jads), "cpu")
    want, _ = JT.forward(jparams, jads, JCFG, JLORA, {"tokens": tokens})
    before = (lm_ops.launches, fa_ops.launches)
    got = make_prefill_step(CFG, LORA, device="cpu")(params, ads,
                                                     {"tokens": tokens})
    assert (lm_ops.launches, fa_ops.launches) == before
    assert got.shape == want.shape
    assert _maxabs(got, want) <= TOL


def test_prefill_matches_reference_flash_kernel_route(weights, tokens):
    """The reference on its Pallas flash route (interpret mode) against
    the port's flash route."""
    jparams, params = weights
    jads = _jax_adapters(2, 8)
    ads = interop.adapters_from_jax(_np(jads), "cpu")
    with jrunmode.overrides(USE_PALLAS_ATTN=True, PALLAS_INTERPRET=True):
        assert jattn.attention_path(causal=True, Sq=12, Sk=12) == \
            "pallas_flash"
        want, _ = JT.forward(jparams, jads, JCFG, JLORA, {"tokens": tokens})
    assert attention.attention_path(causal=True, Sq=12, Sk=12) == "flash"
    got = make_prefill_step(CFG, LORA, device="cpu")(params, ads,
                                                     {"tokens": tokens})
    assert _maxabs(got, want) <= TOL


def test_teacher_forced_decode_matches_reference(weights, tokens):
    jparams, params = weights
    jads = _jax_adapters(4, 9)
    ads = interop.adapters_from_jax(_np(jads), "cpu")
    B, S = tokens.shape
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jdecode = jax.jit(j_make_decode_step(JCFG, JLORA, mesh)[0])
    jcaches = JT.init_caches(JCFG, B, 8, dtype=jnp.float32)   # ring wraps
    decode = make_decode_step(CFG, LORA, device="cpu")
    caches = T.init_caches(CFG, B, 8, dtype=torch.float32, device="cpu")
    for t in range(S):
        want, jcaches = jdecode(jparams, jads, tokens[:, t:t + 1], jcaches,
                                jnp.asarray(t, jnp.int32))
        got, caches = decode(params, ads, tokens[:, t:t + 1], caches, t)
        assert _maxabs(got, want) <= TOL, f"step {t}"
    np.testing.assert_array_equal(
        caches["segments"][0]["pos"].numpy(),
        np.asarray(jcaches["segments"][0]["pos"]))


def _paged_pair(rank, seed):
    jads = jlora.pad_adapter_tree(_jax_adapters(rank, seed), SLOT)
    scale = JLORA.alpha / rank
    jp = JPagedAdapter(task=0, rsu=-1, version=0, rank=rank, slot_rank=SLOT,
                       scale=scale, adapters=jads)
    pp = PagedAdapter(task=0, rsu=-1, version=0, rank=rank, slot_rank=SLOT,
                      scale=scale,
                      adapters=interop.adapters_from_jax(_np(jads), "cpu"))
    return jp, pp


def _engines(weights, cache_len=8):
    jparams, params = weights
    jeng = JServeEngine(jparams, JCFG, JLORA,
                        JServeSpec(max_batch=3, cache_len=cache_len,
                                   max_rank=SLOT))
    # The reference's step hands jnp.asarray(self._positions) to an
    # asynchronous decode and then does self._positions += 1 in place; on
    # the CPU backend that array can be a zero-copy view, so the decode
    # sometimes reads the incremented positions (about 1 run in 4 here).
    # Waiting for each decode to finish keeps the reference deterministic.
    decode = jeng._decode
    jeng._decode = lambda *args: jax.block_until_ready(decode(*args))
    eng = ServeEngine(params, CFG, LORA,
                      ServeSpec(max_batch=3, cache_len=cache_len,
                                max_rank=SLOT), device="cpu")
    return jeng, eng


def test_serve_engine_matches_reference_through_retire_admit(weights):
    """Three lanes at ranks 2/4/8 paged into slot 8, each greedy on its
    own stream; lane 1 retires at step 4 and a rank-8 tenant is admitted
    there at step 6; the 8-slot ring wraps. Per-step logits on every lane
    match the reference engine and the greedy streams are equal."""
    jeng, eng = _engines(weights)
    for lane, (rank, seed) in enumerate([(2, 11), (4, 12), (8, 13)]):
        jp, pp = _paged_pair(rank, seed)
        jeng.assign(lane, jp)
        eng.assign(lane, pp)
    jtok = ptok = np.array([1, 2, 3])
    streams_j, streams_p = [], []
    for step in range(14):
        if step == 4:
            jeng.retire(1)
            eng.retire(1)
        if step == 6:
            jp, pp = _paged_pair(8, 14)
            assert jeng.admit(jp) == 1 and eng.admit(pp) == 1
        want = np.asarray(jeng.step(jtok))
        got = eng.step(ptok).numpy()
        assert _maxabs(got, want) <= TOL, f"step {step}"
        jtok, ptok = want.argmax(-1), got.argmax(-1)
        streams_j.append(jtok)
        streams_p.append(ptok)
    np.testing.assert_array_equal(np.stack(streams_p), np.stack(streams_j))
    np.testing.assert_array_equal(eng._positions, jeng._positions)
    assert (eng.admits, eng.retires, eng.swaps) == \
        (jeng.admits, jeng.retires, jeng.swaps)


def test_serve_engine_generate_matches_reference(weights):
    jeng, eng = _engines(weights, cache_len=16)
    for lane, (rank, seed) in enumerate([(8, 21), (2, 22)]):
        jp, pp = _paged_pair(rank, seed)
        jeng.assign(lane, jp)
        eng.assign(lane, pp)
    prompts = np.random.default_rng(3).integers(0, JCFG.vocab_size, (3, 4))
    np.testing.assert_array_equal(eng.generate(prompts, 6),
                                  jeng.generate(prompts, 6))


def test_unassigned_lane_is_the_base_model(weights, tokens):
    """A lane with no tenant (zero adapter, zero scale) decodes exactly
    what the base model decodes for its stream."""
    _, params = weights
    _, eng = _engines(weights, cache_len=16)
    jp, pp = _paged_pair(4, 31)
    eng.assign(0, pp)
    decode = make_decode_step(CFG, LORA, device="cpu")
    caches = T.init_caches(CFG, 1, 16, dtype=torch.float32, device="cpu")
    for t in range(6):
        lanes = eng.step(np.array([tokens[0, t], tokens[0, t],
                                   tokens[1, t]]))
        base, caches = decode(params, None, tokens[1:2, t:t + 1], caches, t)
        assert _maxabs(lanes[2], base[0, 0]) <= 1e-5, t


def test_assign_checks_slot_width_and_admission(weights):
    _, eng = _engines(weights)
    _, pp = _paged_pair(4, 41)
    with pytest.raises(ValueError):
        eng.assign(0, dataclasses.replace(pp, slot_rank=4))
    for lane in range(3):
        eng.admit(pp)
    with pytest.raises(RuntimeError):
        eng.admit(pp)


# ---------------------------------------------------------------------------
# Boundaries of the slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["shared_attn", "conv"])
def test_transformer_refuses_unknown_block_kinds(kind):
    """A block kind the model has no block for is refused, as the
    reference refuses it (zamba2's shared block is no segment kind:
    it comes from ``shared_attn_every``)."""
    cfg = CFG.with_overrides(block_pattern=(kind, "attn"))
    with pytest.raises(ValueError, match=kind):
        T.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match=kind):
        JT.init_params(jax.random.PRNGKey(0), cfg_to_reference(cfg))


def cfg_to_reference(cfg):
    from repro.config import ModelConfig as JModelConfig
    return JModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("pattern", [("mamba2", "attn"), ("attn", "mamba2")],
                         ids=["mamba2-attn", "attn-mamba2"])
def test_transformer_runs_mamba2_segments_beside_attn(pattern):
    """mamba2 blocks (with an SSM config) form their own segment beside
    attn ones, in the reference's layout, and decode reproduces the
    forward."""
    from repro.config import SSMConfig as JSSMConfig
    from repro_torch.config import SSMConfig
    kw = dict(state_dim=8, head_dim=16)
    cfg = CFG.with_overrides(block_pattern=pattern, ssm=SSMConfig(**kw))
    jcfg = cfg_to_reference(cfg.with_overrides(ssm=None)).with_overrides(
        ssm=JSSMConfig(**kw))
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    jshapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg, jnp.float32),
                             jax.random.PRNGKey(0))
    assert interop.tree_map(lambda x: tuple(x.shape), params) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), jshapes)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 6)))
    full, _ = T.forward(params, None, cfg, LORA, {"tokens": toks})
    caches = T.init_caches(cfg, 2, 6, dtype=torch.float32, device="cpu")
    for t in range(6):
        got, caches = T.decode_step(params, None, cfg, LORA,
                                    toks[:, t:t + 1], caches, t)
        assert float((torch.softmax(got[:, 0], -1)
                      - torch.softmax(full[:, t], -1)).abs().max()) < 2e-3


@pytest.mark.parametrize("entry", ["init_params", "init_adapters",
                                   "init_caches", "make_prefill_step",
                                   "make_decode_step", "ServeEngine",
                                   "params_from_jax"])
def test_entry_points_refuse_to_run_without_a_card(entry):
    """The default device is cuda; without a card every entry point
    raises instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    calls = {
        "init_params": lambda: T.init_params(CFG),
        "init_adapters": lambda: T.init_adapters(CFG, LORA),
        "init_caches": lambda: T.init_caches(CFG, 1, 8),
        "make_prefill_step": lambda: make_prefill_step(CFG, LORA),
        "make_decode_step": lambda: make_decode_step(CFG, LORA),
        "ServeEngine": lambda: ServeEngine({}, CFG, LORA),
        "params_from_jax": lambda: interop.params_from_jax({}),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of repro_torch, and chip_smoke.py, imports with jax
    and repro blocked."""
    code = textwrap.dedent("""
        import pkgutil, sys, importlib
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        sys.path.insert(0, sys.argv[1])
        import chip_smoke
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
               and sys.modules[m] is not None]
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code, REPO], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
