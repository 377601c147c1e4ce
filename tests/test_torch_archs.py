"""The two attention-only archs the port adds, smollm-135m and
starcoder2-15b, against the reference, on the CPU.

They need no block kind the port lacks (GQA, SwiGLU or GELU, RMSNorm or
LayerNorm, biased q/k/v, tied embeddings). Per arch: the config copies
equal the reference's field by field (full and reduced); at the reduced
size (2 layers, f32, weights and adapters from the reference's seeded
init) the port's prefill logits match the reference's ``T.forward`` to
1e-4; teacher-forced decode reproduces the port's own forward (softmax
within 2e-3, the reference's ``tests/test_decode_consistency.py``) and
the reference's decode logits to 1e-4; a paged engine decodes the dense
engine's bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.configs import smollm_135m as jsmollm
from repro.configs import starcoder2_15b as jstarcoder
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.config import LoRAConfig, ServeSpec, get_arch
from repro_torch.configs import smollm_135m, starcoder2_15b
from repro_torch.core import lora as lora_lib
from repro_torch.launch.adapter_cache import PagedAdapter
from repro_torch.launch.serve import ServeEngine, make_prefill_step
from repro_torch.models import transformer as T

torch.set_num_threads(1)

ARCHS = {"smollm-135m": (jsmollm, smollm_135m, "smollm_135m"),
         "starcoder2-15b": (jstarcoder, starcoder2_15b, "starcoder2_15b")}
JLORA = JLoRAConfig(rank=4)
LORA = LoRAConfig(rank=4)
TOL = 1e-4
B, S = 2, 12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    """(arch, port cfg, reference params, port params, reference
    adapters, port adapters, tokens) at the reduced size."""
    jmod, pmod, _ = ARCHS[request.param]
    jcfg, cfg = jmod.reduced(), pmod.reduced()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    ja = JT.init_adapters(jax.random.PRNGKey(7), jcfg, JLORA, rank=4)
    ja = jax.tree_util.tree_map(lambda x: x + 0.01 * jnp.ones_like(x), ja)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
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
    for f in dataclasses.fields(pc):
        assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    assert pc.blocks() == jc.blocks()
    assert pc.resolved_head_dim == jc.resolved_head_dim
    assert pc.param_counts() == jc.param_counts()
    if which == "full":
        assert get_arch(arch) == pc


def test_init_trees_have_the_reference_layout(model):
    _, jcfg, cfg, jp, pp, ja, pa, _ = model
    assert interop.tree_map(lambda x: tuple(x.shape), pp) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    assert interop.tree_map(lambda x: tuple(x.shape), pa) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), ja)
    mine = T.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    assert interop.tree_map(lambda x: tuple(x.shape), mine) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)


def test_prefill_matches_reference_forward(model):
    _, jcfg, cfg, jp, pp, ja, pa, toks = model
    want, _ = JT.forward(jp, ja, jcfg, JLORA, {"tokens": toks})
    got = make_prefill_step(cfg, LORA, device="cpu")(pp, pa,
                                                     {"tokens": toks})
    assert got.shape == want.shape
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= TOL


def test_teacher_forced_decode_matches_forward_and_reference(model):
    """Incremental decode over the same tokens reproduces the full
    forward (KV caches end to end) and the reference's decode steps."""
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
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) \
            <= TOL, f"step {t}"
        outs.append(got[:, 0])
    dec = torch.stack(outs, dim=1)
    err = float((torch.softmax(full, -1) - torch.softmax(dec, -1))
                .abs().max())
    assert err < 2e-3, f"decode diverges from forward (max {err})"


def test_paged_engine_equals_dense(model):
    _, _, cfg, _, pp, _, pa, _ = model
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
