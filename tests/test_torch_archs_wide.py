"""The head-dim-256 and frontend archs, gemma-7b, paligemma-3b (256 prefix
embeddings from a stubbed SigLIP frontend, MQA 8 on 1) and
musicgen-medium (LayerNorm, GELU, untied), against the reference, on the
CPU.

Per arch: the config copies equal the reference's field by field (full
and reduced) and so do the param counts; at the reduced size (2 layers,
f32, weights and adapters from the reference's seeded init) the init
trees have the reference's keys and shapes, the prefill logits match
``T.forward`` to 1e-4 (paligemma-3b with ``prefix_embeds (B, P, d)``:
logits (B, P + S, V)), ``loss_fn`` (paligemma-3b with the prefix, whose
rows the CE drops) and the adapters' gradients match
``jax.value_and_grad`` of the reference's to 1e-4, teacher-forced decode
(tokens only, as the reference's) matches the port's own forward
(softmax within 2e-3) and the reference's decode logits to 1e-4, and a
paged engine decodes the dense engine's bits. Flash attention at head
dim 256: both kernels take it, and on the CPU the port's ``attend``
(the flash route's plain version) matches the reference's
``attention_ref`` to 2e-5 (f32, ragged S, GQA 8 on 1, a window).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.configs import gemma_7b as jgemma
from repro.configs import musicgen_medium as jmusicgen
from repro.configs import paligemma_3b as jpali
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.config import LoRAConfig, ServeSpec, get_arch
from repro_torch.configs import gemma_7b, musicgen_medium, paligemma_3b
from repro_torch.core import lora as lora_lib
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.adapter_cache import PagedAdapter
from repro_torch.launch.serve import ServeEngine, make_prefill_step
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as T

torch.set_num_threads(1)

ARCHS = {"gemma-7b": (jgemma, gemma_7b, "gemma_7b"),
         "paligemma-3b": (jpali, paligemma_3b, "paligemma_3b"),
         "musicgen-medium": (jmusicgen, musicgen_medium, "musicgen_medium")}
JLORA = JLoRAConfig(rank=4)
LORA = LoRAConfig(rank=4)
TOL = 1e-4
B, S = 2, 12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    """(arch, reference cfg, port cfg, reference params, port params,
    reference adapters, port adapters, tokens, prefix or None) at the
    reduced size."""
    jmod, pmod, _ = ARCHS[request.param]
    jcfg, cfg = jmod.reduced(), pmod.reduced()
    # the reference's functions run under jit here (eager dispatch of
    # their every op costs 3-4x the time)
    jp, ja = jax.jit(lambda k0, k7: (
        JT.init_params(k0, jcfg, jnp.float32),
        jax.tree_util.tree_map(lambda x: x + 0.01,
                               JT.init_adapters(k7, jcfg, JLORA, rank=4))))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(7))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    prefix = None
    if cfg.num_prefix_embeds:
        prefix = (0.5 * rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model))).astype(np.float32)
    return (request.param, jcfg, cfg, jp,
            interop.params_from_jax(_np(jp), device="cpu",
                                    dtype=torch.float32),
            ja, interop.adapters_from_jax(_np(ja), "cpu"), toks, prefix)


def _batch(toks, prefix, torch_side=False):
    batch = {"tokens": toks}
    if prefix is not None:
        batch["prefix_embeds"] = prefix
    if torch_side:
        batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return batch


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_copy_matches_reference(arch, which):
    jmod, pmod, fn = ARCHS[arch]
    jc = getattr(jmod, fn)() if which == "full" else jmod.reduced()
    pc = getattr(pmod, fn)() if which == "full" else pmod.reduced()
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.blocks() == jc.blocks()
    assert pc.resolved_head_dim == jc.resolved_head_dim
    assert pc.param_counts() == jc.param_counts()
    if which == "full":
        assert get_arch(arch) == pc


def test_init_trees_have_the_reference_layout(model):
    _, jcfg, cfg, jp, pp, ja, pa, _, _ = model
    shapes = lambda t: interop.tree_map(lambda x: tuple(x.shape), t)
    jshapes = lambda t: jax.tree_util.tree_map(lambda x: tuple(x.shape), t)
    assert shapes(pp) == jshapes(jp)
    assert shapes(pa) == jshapes(ja)
    mine = T.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    assert shapes(mine) == jshapes(jp)
    assert shapes(T.init_adapters(cfg, LORA, seed=1, device="cpu")) == \
        jshapes(ja)


def test_prefill_matches_reference_forward(model):
    _, jcfg, cfg, jp, pp, ja, pa, toks, prefix = model
    want, _ = jax.jit(lambda b: JT.forward(jp, ja, jcfg, JLORA, b))(
        _batch(toks, prefix))
    got = make_prefill_step(cfg, LORA, device="cpu")(pp, pa,
                                                     _batch(toks, prefix))
    P = 0 if prefix is None else prefix.shape[1]
    assert tuple(got.shape) == (B, P + S, cfg.vocab_size) == want.shape
    assert _maxabs(got, want) <= TOL


def test_loss_and_adapter_grads_match_reference(model):
    _, jcfg, cfg, jp, pp, ja, pa, toks, prefix = model
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    batch = dict(_batch(toks, prefix), labels=labels)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda a: JT.loss_fn(jp, a, jcfg, JLORA, batch), has_aux=True))(ja)
    ads = interop.tree_map(lambda x: x.clone().requires_grad_(True), pa)
    loss, _ = T.loss_fn(pp, ads, cfg, LORA,
                        dict(_batch(toks, prefix, True),
                             labels=torch.from_numpy(labels)))
    leaves, refs = [], []
    interop.tree_map(lambda x, g: (leaves.append(x), refs.append(g)), ads,
                     _np(jgrads))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    err = max(_maxabs(g, r) for g, r in zip(grads, refs))
    assert err <= TOL, f"adapter grads max abs {err}"
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_teacher_forced_decode_matches_forward_and_reference(model):
    """Incremental decode over the same tokens reproduces the full
    forward (KV caches end to end) and the reference's decode steps;
    decode takes tokens only, as the reference's does."""
    _, jcfg, cfg, jp, pp, ja, pa, toks, _ = model
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


def test_paged_engine_equals_dense(model):
    _, _, cfg, _, pp, _, pa, _, _ = model
    slot = 8
    lora = dataclasses.replace(LORA, max_rank=slot)
    tenant = PagedAdapter(task=0, rsu=-1, version=0, rank=4, slot_rank=slot,
                          scale=lora.scale,
                          adapters=lora_lib.pad_adapter_tree(pa, slot))
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


@pytest.mark.parametrize("dtype,kind", [(torch.bfloat16, "mma"),
                                        (torch.float32, "simt")])
def test_flash_takes_head_dim_256(dtype, kind):
    assert 256 in fa_ops.HEAD_DIMS
    assert fa_ops.variant(dtype, 256) == kind


@pytest.mark.parametrize("S_,window", [(100, None), (100, 32), (37, 8)])
def test_attend_at_head_dim_256_matches_reference(S_, window):
    """The flash route at gemma's and paligemma's head dim, 8 query heads
    on one kv head (paligemma's MQA), ragged lengths, with and without a
    sliding window: the port's attend (on the CPU, the kernel's plain
    version) against the reference's attention_ref."""
    H, Hkv, D = 8, 1, 256
    rng = np.random.default_rng(S_ + (window or 0))
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
