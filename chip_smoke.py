#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving paths on one card, through the entry points
a user calls, with seeded random weights: multi-tenant LoRA serving of
qwen2-0.5b, smollm-135m, starcoder2-15b, gemma-7b, paligemma-3b and
musicgen-medium (attn blocks: ``lora_matmul`` and ``flash_attention``,
head dims 64 to 256; dense and block-paged KV), grok-1-314b (attn + MoE)
and deepseek-v2-236b (MLA + MoE: ``lora_matmul``; its attention is off
the flash route, as in the reference) and of rwkv6-7b (rwkv6 blocks:
``lora_matmul`` and ``wkv6``), all at their published widths, and
adapters served from a trained checkpoint.
Phases (any failure raises; nothing is caught):

1. Print the card's name and power limit; build the CUDA kernels from the
   sources in this checkout (one nvcc per source, all at once) and print
   ptxas's registers and spills per kernel, and the dynamic shared
   memory of each block the main paths launch.
2. Hold each kernel to its plain PyTorch version at the main paths'
   shapes, in bf16 and in f32 (TF32 off), and time kernel, plain version
   and a library call on the same inputs (wkv6 has no library call; at
   per-step log-decays of -2 and -20, where the plain chunked version
   overflows, it is held to the per-step oracle). ``lora_matmul`` records
   the kernel each case took (wgmma, splitk or simt), its time alone (t =
   x·A given), and adds a 2-lane x 100-row case per model; every decode
   case runs twice and must give the same bits; at the square shapes in
   bf16 a rank-8 adapter zero-padded to the 64 slot must give the bits of
   the truncated one. ``flash_attention`` records its route (mma for
   bf16, simt for f32) and adds a long prompt (B 4, S 2048) with its
   TFLOP/s and its ratio to SDPA, recorded without a gate. ``wkv6`` runs
   in the model's own dtypes (bf16 r, k, v; f32 logw) at the served,
   ragged and 19-chunk lengths, with bf16 logw, in f32 (served and 19
   chunks), and at the strong decays; then its time per chunk step at B
   1 and B 4 tells latency from throughput.
3. Parity at full width and reduced depth (2 layers, f32), per model:
   the same weights on the card (kernels) and on the CPU (plain
   versions), prefill logits and 8 multi-tenant decode steps (rwkv6-7b:
   with a retire/admit after step 4).
4. The served run per model at full depth and width in bf16: a 4 x 128
   prefill through ``make_prefill_step``, then ``ServeEngine(max_batch=4)``
   with lanes at ranks 8/16/32/64 in a 64-wide slot, ``generate`` with
   one retire/admit mid-stream. Launch counts are reset just before and
   read just after each of the two, and must match the model's layer
   count; every ``lora_matmul`` launch of the prefill must be a wgmma one
   and every one of the decode a split-K one; every flash launch of the
   qwen2-0.5b prefill must take the tensor-core route. Then a
   torch.profiler window over a prefill and 4 steps.
5. The federated round, through ``IoVSimulator``, of the paper's method
   under the three engines that the port runs (and, in (d), of every
   other method): ``serial`` (one vehicle
   at a time), ``batched`` (each (task, rank) group of vehicles one stack
   of lanes) and ``fused`` (below, (c)). (a) At the reduced ViT (head dim 16) with the default
   ``SimConfig`` (24 vehicles, 3 tasks, 3 local steps), per engine one
   round from one seed on the card and on the CPU, held together (ranks,
   active and departing counts, fallbacks and comm_params exactly;
   merged deltas, energy and latency within 1e-4; under ``serial`` also
   one train step's loss and adapter grads), then one ``batched_check``
   round on the card, whose ``engine_check_dev`` (the serial trainer
   replayed on the same batches) is printed and must be below 1e-4. (b) At the full width of
   vit-base-paper (12 layers, d 768): one serial round (unprofiled: a
   window over its ~50,000 kernels took 87 s) and one batched round
   under a torch.profiler window (wall and device ms, busy share, peak
   memory, launches split into train steps and evaluations and by
   shape), then one more batched round without it. Every batched round's
   launches must equal what its groups predict (one forward per group
   step, one local eval per group, one global eval per task with a
   global model that kept or released an upload); the batched rounds are held to the serial ones (ranks and
   active sets exactly, energy and latency within 1e-5, merged deltas
   after round 0 within the update limit below, as a Frobenius spread);
   every loss, energy and accuracy must be finite and every launch
   ``simt``. Then task 0's first rank group of round 0, through the
   batched trainer and vehicle by vehicle through the serial one: one
   step's gradients within 1e-4, and after the step budgets each lane's
   update within twice the serial trainer's own card-vs-CPU spread on
   the same lanes (Adam's sign-like first update lets single entries
   part by 2·lr, so the largest entry difference is recorded, not
   held); two planted faults must break these gates. (c) The fused
   engine (the round as one program over the rank-padded fleet, run
   eagerly on its first round and then captured as two CUDA graphs
   around the two eager SVDs, replayed every round after): at the
   reduced ViT one round card against CPU as in (a), and one
   ``fused_check`` round on the card (``engine_check_dev`` < 1e-4); at
   full width three rounds: the first without the profiler, timing its
   eager run and its capture apart, then one profiled and one without:
   one capture over all rounds, the launches counted at
   capture and the profiler's kernel records of the profiled replayed
   round equal to 15 forwards' (1,080 ``lora_matmul``, 180 flash, all
   ``simt``); ranks and
   active sets equal to the batched rounds', energy and latency within
   1e-5; round-0 merged deltas within the serial spread limit of (b);
   two rounds (the second a replay) equal to the same rounds run
   eagerly on the card (``capture=False``) within 1e-6 of each leaf's
   largest entry, at full
   width and at the reduced ViT, where a planted fault (an input buffer
   left as the first round staged it) must break that gate. Then phase
   2's rows at the batched round's lane shapes, V from its largest group
   per rank: f32 ``lora_matmul`` at V x 240 rows (with the closed-form
   backward) and V x 768, flash at B = V·10 and V·32; and at the fused
   round's: 24 lanes rank-padded to 32 with mixed lane ranks, 24 x 240
   (with the backward) and 24 x 768 rows, flash at B 240 and 768.
   (d) The paper's baselines (HomoLoRA, HetLoRA, FedRA), ablations
   (``ours_no_energy``, ``ours_no_mobility``) and ``ours_residual``. At
   the reduced ViT with the default SimConfig, each method under
   ``serial`` and ``batched`` (the ablations also ``fused``) two rounds
   from one seed on the card and on the CPU, the second round on the
   card started from the CPU's state: ranks, active and departing
   counts, fallbacks and comm_params exactly; energy, latency and the
   servers' states (merged deltas, or the baselines' global adapters)
   within 1e-4. Then one ``batched_check`` round per method and one
   ``fused_check`` round per ablation on the card: ``engine_check_dev``
   recorded, each lane's update spread against the serial replay held
   within 2x the serial trainer's card-vs-CPU spread (a replay one step
   short must fail). At full width (2 of vit-base-paper's 12 layers,
   to keep the run inside its time limit), each
   method's batched rounds (the first profiled, but for HetLoRA and
   the three that train ours' groups, whose one round
   runs unprofiled; launches held to the
   groups' prediction in both; every launch ``simt``, every loss,
   energy and accuracy finite); FedRA's left-out layers bit-identical
   after local training, which a planted fault (the mask applied after
   the optimizer step) must break; and each ablation's fused rounds (a
   capture, then a replayed round with 360 / 60 kernel records) held
   to its batched rounds (ranks and active sets exactly, energy and
   latency within 1e-5). Then phase 2's rows at HetLoRA's largest lane
   group per rank.
   (e) The round's modes: a multi-RSU tier (the reference's dense-rsu
   tier: 3 RSUs per task, a staleness-discounted sync every 2 rounds, a
   handoff charged 6 J and 0.4 s) and semi-synchronous participation
   (the default spec with two RSU outage windows, so that uploads defer
   and come back), alone and together. At the reduced ViT (seed 2,
   three local steps), four rounds card against CPU, each round on the
   card from the CPU's state: the tier under serial, batched and fused
   (and HetLoRA's under serial and batched), semi_sync under serial,
   batched and fused, both under fused; counts, deferred and released
   uploads, which partials are live, their ages and the buffer's
   vehicles, ages and destinations exactly; energy, latency, release
   weights and the partials' and buffered uploads' weights within 1e-4;
   the global states, partials and buffered deltas as a Frobenius spread
   within 5e-4 (their largest entry difference recorded); the runs must
   merge two or more live partials in a sync, charge a handoff, defer an
   upload and release one. Three planted faults on the card's side must
   break these gates: staleness discounts one round too old, a
   release landing at the RSU its vehicle trained under, a sync gate
   frozen at capture. At full width (2 of vit-base-paper's 12 layers,
   ``DEPTH_5E``, to keep the script inside its time limit), four rounds
   of each configuration
   under batched (HetLoRA's tier too, unprofiled: a window over its 15
   groups costs ~50 s) and fused, one profiled (for the fused engine a
   replay): wall and device ms, busy share, peak memory,
   launches (batched: the groups' prediction, with no global eval
   before a task's first sync; fused: one capture, 1,080 / 180 kernel
   records per replay); the fused rounds 0-1 equal to an eager run
   within 1e-6 (partials and buffer too) and to the batched rounds
   (counts exactly, energy and latency within 1e-5, each task's merged
   delta at its first merge within 5b's spread limit); the tier's four
   rounds again through ``run_scanned`` (records equal to the rounds run
   one by one, its peak memory recorded).
   (f) Resumable runs and the scenario presets, through
   ``scenarios.build_sim`` and ``restore_checkpoint``. At the reduced
   ViT: rsu-outage under semi_sync (batched ``run``, fused chunked
   ``run_scanned``, 4 rounds, a checkpoint every 2) and dense-rsu (6
   rounds, every 3: its boundary holds live partials), each run
   uninterrupted and stopped at its first boundary, restored into a
   fresh simulator (one fused case into the live one, whose captured
   graphs must replay the restored state) and finished: the histories'
   JSON and every leaf of the final checkpoints equal; a boundary must
   hold a buffered upload and one two live partials; two planted faults
   (a restore that skips the channel's stream, buffered uploads one
   lane off) must break the comparison, and a preset of another seed
   must refuse the file before any state changes. A checkpoint written
   on the card restored on the CPU and one written on the CPU restored
   on the card, one round on each device from it, and rush-hour's round
   0, held with (e)'s gates; no absent vehicle trains. At full width:
   rsu-outage under semi_sync, fused ``run_scanned(6)`` in chunks of 2
   (``keep_last=1``), uninterrupted against stopped at round 2, freed,
   restored into a fresh simulator and finished: histories and final
   checkpoints equal to the bit; each save's and the restore's ms,
   bytes, host and device peaks; the profiler's records of the first
   replay after the restore (144 / 24: 3 of the 12 layers, ``DEPTH_5F``).
   Then each of the seven presets
   at full width (``DEPTH_5F`` layers since PR 24), batched, until a round trains, on one set of base
   weights: launches equal to the groups' prediction, energy, latency
   and accuracy finite, absent vehicles (rush-hour, sparse-rural)
   training no lane. The checkpoints go to a temporary directory in the
   checkout, removed at the end.
6. Serving, the rest. (a) qwen2-0.5b at full width in bf16 (6 of its
   24 layers since PR 24, 12 in PR 23, ``DEPTH_6A``),
   4 lanes at ranks 8/16/32/64 in the 64 slot: a block-paged engine
   (blocks of 16, a 128-slot ring) and a dense one driven in lockstep
   through admit, retire, re-admit into a recycled lane, evict_oldest
   and a ring wrap (140 steps): every step's logits and greedy tokens
   bit-equal, the allocator's invariants after every mutation, blocks
   recycled, each lane's gathered cache equal to the dense one wherever
   pos >= 0, the pools and tables never moved, 96 split-K launches a
   step in both; decode ms/step and lane-tok/s paged against dense, in
   turns; a pool one block short must raise BlockPoolExhausted at the
   step its last lane outgrows it. (b) Train -> checkpoint -> serve at
   the full width of vit-base-paper (6 of its 12 layers since PR 23,
   ``DEPTH_6B``): the dense-rsu preset, batched,
   three rounds (merged deltas and live partials), checkpointed;
   ``AdapterStore.from_checkpoint`` against ``from_sim`` of the live
   simulator, bit-equal for every task, RSU and rank, one SVD (cache
   miss) per key; a foreign config refused; the time of one max-rank
   redistribute and of a get that hits; trained tenants admitted by the
   store into a paged and a dense engine through retire, re-admit and
   evict_oldest, bit-equal. (c) starcoder2-15b (40 layers, d 6144, 48
   heads of 128 on 4) and smollm-135m at full depth and width in bf16:
   the weights' init and peak memory, a 4 x 128 prefill (every
   ``lora_matmul`` launch on an unbiased linear ``wgmma``, every flash
   launch ``mma``), a paged and a dense engine in lockstep with a
   retire/admit (bit-equal), and the paged engine's ``generate`` with
   one retire/admit (every launch split-K). Phase 2 adds both archs'
   bf16 rows (``lora_matmul`` prefill and decode, flash at S 128), and
   phase 3 their 2-layer card-vs-CPU parity (starcoder2-15b with a
   32-token prompt). (d) The same run for gemma-7b (28 layers, head dim
   256), paligemma-3b (18 layers, 8 heads of 256 on 1, its prefill after
   256 prefix embeddings from the stubbed frontend), musicgen-medium (48
   layers), grok-1-314b (4 of its 64 layers: 8 experts of 32768, top-2,
   per-expert adapters, logits softcap 30) and deepseek-v2-236b (3 of its
   60 layers: MLA, 160 routed + 2 shared experts, top-6), one model at a
   time, each freed before the next: every flash launch of a prefill
   ``mma`` (28, 18, 48, 4 and 0), paged == dense through a retire/admit.
   Phase 2 adds flash at head dim 256 in bf16 and f32 at gemma-7b's and
   paligemma-3b's prefills (and bf16 at musicgen-medium's and grok-1's),
   and ``lora_matmul`` bf16 at every distinct shape of the five archs'
   prefills and decode steps; phase 3 their card-vs-CPU parity, drawn on
   the card: 2 layers of the dense three (paligemma-3b with a prefix),
   one of grok-1 and deepseek-v2 (1 decode step: the CPU runs every
   expert over its capacity).
7. zamba2-2.7b served at full depth (7a) and rwkv6 trained in the round
   (7b).
8. The training entry point (``launch/train.py``). (a) The CLI as a user
   runs it, ``python -m repro_torch.launch.train --arch smollm-135m
   --full`` (f32: ``lora_matmul`` and flash on ``simt``, batch 8 x seq
   64), in subprocesses: 20 uninterrupted steps with a checkpoint every
   10, and 10 steps resumed to 20 with ``--resume`` in this process (its
   launches counted): every leaf of both checkpoints (adapters, mu, nu,
   step, meta with the RNG state) bit-equal to the uninterrupted run's,
   the printed losses equal, the last below the first; a resume with the
   RNG state not restored must differ, and one under another ``--lr``
   must be refused. (b) The README's two ``--simulate`` lines with their
   horizons cut (rsu-outage semi-sync fused, 4 rounds; sparse-rural
   sync, 2), in subprocesses: each printed round line equal to
   ``scenarios.build_sim`` run here with the same arguments. (c)
   ``make_train_step`` at qwen2-0.5b's full width in bf16 at train_4k's
   sequence length 4096 (global batch 4 for its 256), remat, ce_chunk
   512, two microbatches, rank 8, through ``placed_step`` on a
   one-device mesh, 6 steps (the last profiled): per step 384
   ``lora_matmul`` launches, all ``wgmma``, and 96 flash, all ``mma``
   (remat's recompute doubles both); ms/step, tokens/s, losses, peak
   memory. (d) The same step card vs CPU in f32 at 2 of the 24 layers,
   seq 256: the loss to 1e-4 and the first step's mu to 1e-3 of each
   leaf's largest entry. (e) ``lora_matmul`` bf16 at 8192 rows (896 ->
   896 / 4864, 4864 -> 896, rank 8) and flash bf16 at B 2, S 4096, 14
   heads on 2, held to their plain versions and timed against the
   library call and the bound. Every bf16 flash row, here and in phase
   2, is also held per query row against the plain version in f32
   (FLASH_ROW_TOL), and must catch a planted lost tile of 64 keys.
9. The device-sharded fleet (``engine="fused_sharded"``), two or four
   shards on the one card (``fleet_devices=["cuda:0"] * N``: both shards
   share it, so no speed-up is claimed). (a) The reduced ViT at the
   reference test's shape (6 vehicles, 2 tasks, 1 local step, 2 rounds)
   at N 2 and 4, round-robin and block: the card's sharded run against
   the CPU's sharded run and against the card's unsharded fused run
   (active sets, ranks, departures, fallbacks, comm_params and UCB-DUAL
   counts exact; energy, latency, merged deltas and UCB sums 1e-4); the
   dense-rsu tier and rsu-outage under semi_sync at N 2 against their
   unsharded fused runs (partials' and buffers' weights too, ages and
   destinations exact); a sharded replay against the same rounds run
   eagerly (1e-6); one capture per topology (N + 2 graphs a round); two
   planted faults (a shard's partial merged delta dropped from the home
   sum; the host mirror left in slot order) must fail their gates. (b)
   vit-base-paper at full width and depth, the default SimConfig, over 2
   shards for 2 rounds against phase 5c's fused rounds of the same seed
   (ranks, active sets, departures, fallbacks and comm_params exact;
   energy and latency 1e-5; round-0 merged deltas within 5b's
   serial-spread limit); each shard's ``lora_matmul`` launches at
   capture equal to its lanes' forwards, all ``simt``; the round's wall
   time (the eager round and the capture, then a profiled replay),
   device time, busy share and each shard's peak memory.
10. Print the ``kernels`` JSON line, then the final ``{"ok": true,
   ...}``.

Phase 2 also holds the kernels at the round's shapes: f32
``lora_matmul`` (simt) for 768->768, 768->3072 and 3072->768 at a train
step's 240 rows (B 10 x S 24; ranks 2, 4, 8, 16 and 32, with the
closed-form backward against autograd of the plain version), a local
eval's 768 (ranks 2 and 4) and the largest global eval's 8064 (ranks 8
and 32); flash
attention at S 24 in f32 and bf16 at a train step's B 10 with head dim
16 (4 heads) and 64 (12 heads), and in f32 at the evals' B 32 and 336.

Exits non-zero without a CUDA device or outside a checkout of the repo.
Details go to chiprun_out/chip_smoke.json.
"""
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.checkpoint.carry as carry_mod  # noqa: E402
from repro_torch.checkpoint import (latest_checkpoint,  # noqa: E402
                                    load_pytree, restore_checkpoint,
                                    save_checkpoint, save_pytree)
from repro_torch.config import (CheckpointSpec, LoRAConfig,  # noqa: E402
                                OutageSpec, ParticipationSpec, RSUTierSpec,
                                ServeSpec, ShardSpec)
from repro_torch.config import BLOCK_ATTN, get_input_shape  # noqa: E402
from repro_torch.configs import (deepseek_v2_236b, gemma_7b,  # noqa: E402
                                 grok1_314b, musicgen_medium, paligemma_3b,
                                 qwen2_0_5b, rwkv6_7b, smollm_135m,
                                 starcoder2_15b, vit_base_paper,
                                 zamba2_2_7b)
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core import energy_alloc, ucb_dual  # noqa: E402
from repro_torch.core import kv_blocks as kvb  # noqa: E402
from repro_torch.core.aggregation import (  # noqa: E402
    tree_get, tree_paths, tree_paths_delta)
from repro_torch.core.lora import (  # noqa: E402
    pad_adapter_tree, rank_arange_mask, truncate_adapter_tree)
from repro_torch.federated.client import LocalTrainer  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.lora_matmul import ops as lm_ops  # noqa: E402
from repro_torch.kernels.lora_matmul.ref import lora_matmul_ref  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: E402
from repro_torch.launch.adapter_cache import (  # noqa: E402
    GLOBAL_RSU, AdapterStore, PagedAdapter)
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.serve import (ServeEngine, make_prefill_step,  # noqa: E402
                                      make_decode_step)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import is_glu  # noqa: E402
from repro_torch.interop import tree_map  # noqa: E402
from repro_torch.federated.fused_engine import (  # noqa: E402
    FusedRoundEngine, _copy_tree)
from repro_torch.optim.adam import adam, leaves  # noqa: E402
from repro_torch.sim import scenarios  # noqa: E402
from repro_torch.sim.mobility_model import MobilitySimConfig  # noqa: E402
from repro_torch.sim.simulator import IoVSimulator, SimConfig  # noqa: E402

OUT_DIR = os.path.join(HERE, "chiprun_out")
# H100 SXM data sheet, dense: HBM rate, bf16 tensor-core peak, f32 peak
# outside the tensor cores (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version on the same inputs; see each kernel's notes
TOL = {("lora_matmul", torch.bfloat16): 1e-1,   # one vs two bf16 roundings
       ("lora_matmul", torch.float32): 1e-4,    # f32 summation order only
       ("flash_attention", torch.bfloat16): 2e-2,   # one bf16 rounding, |o|<4
       ("flash_attention", torch.float32): 2e-5,    # f32 summation order
       # wkv6: RELATIVE to max |reference| (the reference suite's), the
       # kernel's 16-row chunks against the plain version's 128
       ("wkv6", torch.bfloat16): 1e-2,   # one bf16 rounding of y
       ("wkv6", torch.float32): 1e-5}
# flash bf16 against the plain version in f32, per query row: the row's
# largest |error| over its D outputs / its largest |output|. At long S a
# row's output is a mean over thousands of keys (|o| ~ 0.03 at S 4096),
# where TOL's absolute 2e-2 would pass a lost key tile; one bf16 rounding
# of o and of the probabilities is ~2^-8 of the row
FLASH_ROW_TOL = 1e-2
# the planted fault each bf16 row must catch: the values of one late
# 64-key tile lost (zeroed), from this fraction of S on
PLANT_AT = 0.75
# full width, 2 layers, f32, card vs CPU: summation order through the
# stack and the 151936-wide tied head, with TF32 off
E2E_TOL = 1e-3
SLOT = 64
RANKS = (8, 16, 32, 64)
# > the 50 MB L2, so each timed call starts cold; and ~0.3 ms of device
# work, during which the host enqueues the timed call, so the events
# bracket device time rather than the host's dispatch of several launches
FLUSH_BYTES = 1 << 30


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# the kernels of lora_matmul.cu and flash_attention.cu by the variant
# name their ops.variant gives them
VARIANT_OF = {"wgmma_kernel": "wgmma", "splitk_kernel": "splitk",
              "lora_mm_kernel": "simt", "fa_mma_kernel": "mma",
              "fa_kernel": "simt"}


def kernel_name(mangled: str) -> str:
    """The *_kernel name inside a mangled template name: the one
    length-prefixed name that ends in "kernel" and opens a template."""
    for i in range(1, len(mangled)):
        for k in (1, 2):
            digits = mangled[max(0, i - k):i]
            if not digits.isdigit():
                continue
            name = mangled[i:i + int(digits)]
            if name.endswith("kernel") and mangled[i + len(name):][:1] == "I":
                return name
    return mangled


# one template argument in a mangled name: bf16, f32, a substitution of
# an earlier type (S<n>_), or an integer (Li<n>E)
_TARG = re.compile(r"13__nv_bfloat16|f|S\d*_|Li(\d+)E")


def template_args(mangled: str, name: str):
    """The template arguments after ``name`` in a mangled name: bf16, f32
    and integers (an S<n>_ substitution is read as the type before it)."""
    i = mangled.find(name + "I")
    rest = mangled[i + len(name) + 1:] if i >= 0 else ""
    out, last = [], "?"
    while rest and rest[0] != "E" and (m := _TARG.match(rest)):
        tok = m.group(0)
        if m.group(1):
            out.append(m.group(1))
        elif tok.startswith("S"):
            out.append(last)
        else:
            last = "f32" if tok == "f" else "bf16"
            out.append(last)
        rest = rest[m.end():]
    return out


def ptxas_summary(log: str):
    """(kernel, "registers, spills, static shared memory") per entry
    function in nvcc's -Xptxas -v output (ptxas does not see dynamic
    shared memory, which the flash and wkv6 kernels use); a kernel is
    named by its template, e.g. wgmma_kernel<128,128> or
    wkv6_kernel<bf16,f32,64,64,2>."""
    kernel, info = None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            if kernel:
                yield kernel, "; ".join(info)
            mangled = m.group(1)
            name = kernel_name(mangled)
            targs = template_args(mangled, name)
            kernel = name + (f"<{','.join(targs)}>" if targs else "")
            info = []
        elif kernel and ("registers" in line or "spill" in line):
            info.append(line.split(":", 1)[-1].strip())
    if kernel:
        yield kernel, "; ".join(info)


def sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def timed_ms(fn, reps=25, warmup=3) -> float:
    """Median device time of one call, with L2 flushed before each."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops_by_dtype: dict):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[dt] for dt, n in ops_by_dtype.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def maxabs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel(got, want) -> float:
    """Over the query rows of (..., D) outputs: the largest of each
    row's max |got - want| / max |want|."""
    w = want.float()
    return float(((got.float() - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp_min(1e-30)).max())


def to(tree, dev):
    if isinstance(tree, dict):
        return {k: to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to(v, dev) for v in tree]
    return tree.to(dev)


def nontrivial(ads, seed):
    """Adapters with b drawn off its zero init, so they change outputs."""
    g = torch.Generator().manual_seed(seed)

    def fix(node):
        if "a" in node and "b" in node:
            b = 0.02 * torch.randn(node["b"].shape, generator=g)
            return {"a": node["a"], "b": b.to(node["b"].device)}
        return {k: fix(v) for k, v in node.items()}
    out = {"segments": [fix(s) for s in ads["segments"]]}
    if "shared_attn" in ads:      # zamba2's shared block
        out["shared_attn"] = fix(ads["shared_attn"])
    return out


KERNELS = {"lora_matmul": lm_ops, "flash_attention": fa_ops,
           "wkv6": wkv_ops}
REPLACES = {"lora_matmul": "src/repro/kernels/lora_matmul/kernel.py:79",
            "flash_attention":
            "src/repro/kernels/flash_attention/kernel.py:102",
            "wkv6": "src/repro/kernels/wkv6/kernel.py:87"}


def reset_counts():
    for mod in KERNELS.values():
        mod.launches = 0
    for by in (lm_ops.launches_by_variant, fa_ops.launches_by_variant):
        for k in by:
            by[k] = 0


def variant_counts():
    return dict(lm_ops.launches_by_variant)


def flash_variant_counts():
    return dict(fa_ops.launches_by_variant)


def counts():
    return {name: mod.launches for name, mod in KERNELS.items()}


def shared_memory(qwen, rwkv):
    """Dynamic shared memory of one block of each kernel at the served
    shapes (bytes), as the kernels' own sources size it."""
    D = qwen.resolved_head_dim
    tiles = fa_ops.plan(128)
    fa = fa_ops._kernel_lib().flash_attention_smem_bytes
    H, K = rwkv.d_model // rwkv.rwkv.head_dim, rwkv.rwkv.head_dim
    vs, vt, _ = wkv_ops.plan(4, H, K, sms())
    wk = wkv_ops._kernel_lib().wkv6_smem_bytes
    train_tiles = fa_ops.plan(TRAIN_S)
    return {f"fa_mma_kernel<{D}> {tiles} warps": fa(1, D, tiles),
            f"fa_kernel<f32,{D}>": fa(0, D, 0),
            # gemma-7b's and paligemma-3b's head dim
            f"fa_mma_kernel<256> {tiles} warps": fa(1, 256, tiles),
            "fa_kernel<f32,256>": fa(0, 256, 0),
            # the reduced ViT's head dim at the round's S 24
            f"fa_mma_kernel<16> {train_tiles} warps": fa(1, 16, train_tiles),
            "fa_kernel<f32,16>": fa(0, 16, 0),
            f"wkv6_kernel<bf16,f32,{K},{vs},{vt}>": wk(1, 0, K, vs),
            f"wkv6_kernel<f32,f32,{K},{vs},{vt}>": wk(0, 0, K, vs)}


def kernel_linears(cfg):
    """(path, K, N) of a layer's linears on the lora_matmul kernel: every
    LoRA-targeted, unbiased 2-D one (biased q/k/v take the plain
    expression; routed experts and MLA's kv_up, which has no adapter, are
    plain products, as in the reference)."""
    return [(path, din, dout) for path, din, dout in
            T._lora_targets(cfg.blocks()[0], cfg, LoRAConfig())
            if not isinstance(din, tuple)
            and not (cfg.qkv_bias and path[0] == "attn"
                     and path[1] in ("q", "k", "v"))]


def per_layer(cfg):
    """Kernel launches per layer of one prefill and of one decode step."""
    if cfg.rwkv is not None:   # w_r/w_k/w_v/w_o/ck/cv, and the wkv
        return ({"lora_matmul": 6, "flash_attention": 0, "wkv6": 1},
                {"lora_matmul": 6, "flash_attention": 0, "wkv6": 0})
    # the kernel's linears, and attention on the flash route (attn blocks;
    # MLA's q/k head dim differs from its v head dim)
    n = len(kernel_linears(cfg))
    fa = int(cfg.blocks()[0] == BLOCK_ATTN)
    return ({"lora_matmul": n, "flash_attention": fa, "wkv6": 0},
            {"lora_matmul": n, "flash_attention": 0, "wkv6": 0})


def shared_linears(cfg):
    """(path, K, N) of zamba2's shared block's linears (q/k/v unbiased:
    all seven on the kernel); none without a shared block."""
    if not cfg.shared_attn_every:
        return []
    return [(("shared_attn",) + path, din, dout)
            for path, din, dout in T._shared_targets(cfg)]


def per_model(cfg):
    """Kernel launches of one prefill and of one decode step of the whole
    model: per layer times the layers, and for zamba2 the shared block's
    linears and flash (prefill) at each of its applications."""
    in_prefill, in_step = per_layer(cfg)
    apps = (cfg.num_layers // cfg.shared_attn_every
            if cfg.shared_attn_every else 0)
    shared = len(shared_linears(cfg))
    prefill = {k: n * cfg.num_layers for k, n in in_prefill.items()}
    step = {k: n * cfg.num_layers for k, n in in_step.items()}
    prefill["lora_matmul"] += shared * apps
    prefill["flash_attention"] += apps
    step["lora_matmul"] += shared * apps
    return prefill, step


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def lora_cases(cfg):
    """Every served (linear, mode) shape, and a row tile that straddles
    two lanes with a ragged edge (2 lanes x 100 rows)."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.rwkv is not None:
        linears = (("w_r/w_k/w_v/w_o", d, d), ("ck", d, f), ("cv", f, d))
    else:
        up = "up/gate" if is_glu(cfg.activation) else "up"
        linears = (("o", d, d), (up, d, f), ("down", f, d))
    for linear, K, N in linears:
        for mode, L, M in (("prefill", 1, 512), ("decode", len(RANKS), 1)):
            yield linear, mode, L, M, K, N
    yield linears[0][0], "2 lanes x 100", 2, 100, d, d


def arch_lora_cases(cfg, prefill_rows=512):
    """The new archs' served shapes: each distinct (K, N) of the kernel's
    linears (``kernel_linears``), in prefill (one lane, 4 x 128 rows, or
    4 x (256 + 128) with paligemma-3b's prefix) and in decode (4 lanes x
    1 row)."""
    seen = {}
    for path, K, N in kernel_linears(cfg) + shared_linears(cfg):
        seen.setdefault((K, N), []).append("/".join(path[1:]))
    for (K, N), names in seen.items():
        for mode, L, M in (("prefill", 1, prefill_rows),
                           ("decode", len(RANKS), 1)):
            yield "+".join(names), mode, L, M, K, N


def launched_variant(fn):
    """fn() once; the lora_matmul kernel variant it launched."""
    before = variant_counts()
    out = fn()
    torch.cuda.synchronize()
    grew = [k for k, n in variant_counts().items() if n != before[k]]
    if len(grew) != 1 or lm_ops.launches_by_variant[grew[0]] != \
            before[grew[0]] + 1:
        fail(f"lora_matmul call launched {grew}, want one kernel")
    return out, grew[0]


def rank_pin(x, w, scale, dtype):
    """The reference's pin (tests/test_kernels.py:145-162) on the card: a
    rank-8 adapter zero-padded to the 64 slot under the rank mask gives
    the same bits as the truncated rank-8 adapter. Both launches get the
    same t columns (cuBLAS's x·A may sum in another order at r 8)."""
    L, _, K = x.shape
    N = w.shape[1]
    g = torch.Generator(device="cuda").manual_seed(K + N + 8)
    a8 = torch.randn((L, K, 8), generator=g, device="cuda") / K ** 0.5
    b8 = 0.1 * torch.randn((L, 8, N), generator=g, device="cuda")
    a64 = torch.cat([a8, torch.zeros((L, K, SLOT - 8), device="cuda")], -1)
    b64 = torch.cat([b8, torch.zeros((L, SLOT - 8, N), device="cuda")], 1)
    t64 = x.float() @ a64
    mask64 = rank_arange_mask(torch.full((L,), 8, device="cuda"), SLOT)
    y_pad, kind = launched_variant(
        lambda: lm_ops._launch(x, w, t64, b64, scale, mask64))
    y_trunc, _ = launched_variant(lambda: lm_ops._launch(
        x, w, t64[..., :8].contiguous(), b8, scale,
        torch.ones((L, 8), device="cuda")))
    if not torch.equal(y_pad, y_trunc):
        fail(f"lora_matmul {kind} {dtype}: padded rank-8 adapter differs "
             f"from the truncated one")
    return kind


def check_lora(cfg, dtype, cases=None, slot=SLOT):
    """Each case's kernel against its plain version and timed; adapters
    ``slot`` wide (a lane's rank mask below it in decode cases)."""
    rows = []
    for linear, mode, L, M, K, N in (cases or lora_cases(cfg)):
        g = torch.Generator(device="cuda").manual_seed(K * 7 + N + L)
        x = torch.randn((L, M, K), generator=g, device="cuda").to(dtype)
        w = (torch.randn((K, N), generator=g, device="cuda")
             / K ** 0.5).to(dtype)
        a = torch.randn((L, K, slot), generator=g, device="cuda") / K ** 0.5
        b = 0.1 * torch.randn((L, slot, N), generator=g, device="cuda")
        if L > 1:      # one tenant per lane, mixed ranks
            ranks = torch.tensor(RANKS[:L], device="cuda")
        else:
            ranks = torch.tensor([slot], device="cuda")
        scale = (16.0 / ranks).float()
        mask = rank_arange_mask(ranks, slot)
        args = (x, w, a, b, scale, mask)
        got, kind = launched_variant(lambda: lm_ops.lora_matmul(*args))
        want = lora_matmul_ref(*args)
        err = maxabs(got, want)
        tol = TOL[("lora_matmul", dtype)]
        if not (err < tol and torch.isfinite(got).all()):
            fail(f"lora_matmul {linear}/{mode}/{dtype}: max abs {err} "
                 f">= {tol}")
        if mode == "decode":     # split-K's fixed summation order
            again, _ = launched_variant(lambda: lm_ops.lora_matmul(*args))
            if not torch.equal(got, again):
                fail(f"lora_matmul {linear}/{mode}/{dtype}: two calls "
                     f"differ")
        pinned = (rank_pin(x, w, scale, dtype)
                  if dtype == torch.bfloat16 and K == N else None)
        es = x.element_size()
        nbytes = (es * (L * M * K + K * N + L * M * N)
                  + 4 * (L * K * slot + L * slot * N + L + L * slot))
        # x·W in the model dtype; t = x·A and (t⊙m)·B in f32
        ops = {torch.float32: 2.0 * L * M * slot * (K + N)}
        ops[dtype] = ops.get(dtype, 0.0) + 2.0 * L * M * K * N
        b_ms, b_by = bound(nbytes, ops)
        t = x.float() @ a      # the kernel alone, on the wrapper's t

        def library():
            t = (x.float() @ a) * mask[:, None, :]
            return x @ w + (scale[:, None, None] * (t @ b)).to(dtype)
        kernel_ms = timed_ms(lambda: lm_ops._launch(x, w, t, b, scale, mask))
        rows.append({
            "name": "lora_matmul", "model": cfg.name, "linear": linear,
            "mode": mode, "variant": kind,
            "dtype": str(dtype).replace("torch.", ""),
            "shape": f"L={L} M={M} K={K} N={N} r={slot}",
            "max_abs_err": err, "tol": tol,
            "deterministic": True if mode == "decode" else None,
            "rank_pin": pinned,
            "ms": timed_ms(lambda: lm_ops.lora_matmul(*args)),
            "kernel_ms": kernel_ms,
            # the kernel's x·W rate and its bytes' rate (W, x, y, t, B)
            "kernel_tflops": 2.0 * L * M * K * N / kernel_ms / 1e9,
            "kernel_gbs": (nbytes - 4 * L * K * slot + 4 * L * M * slot)
            / kernel_ms / 1e6,
            "plain_ms": timed_ms(lambda: lora_matmul_ref(*args)),
            "library_ms": timed_ms(library),
            "bound_ms": b_ms, "bound_by": b_by})
    return rows


def check_flash(cfg, dtype, lengths=None, B=4):
    rows = []
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kind = fa_ops.variant(dtype, D)
    # the served prefill (S 128), a ragged one, and a long qwen2 prompt
    if lengths is None:
        lengths = (128, 100, 2048) if dtype == torch.bfloat16 else (128, 100)
    for S in lengths:
        g = torch.Generator(device="cuda").manual_seed(S)
        q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(dtype)
        before = flash_variant_counts()
        got = fa_ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        took = [n for n, c in flash_variant_counts().items()
                if c != before[n]]
        if took != [kind]:
            fail(f"flash_attention S={S}/{dtype} launched {took}, want "
                 f"{kind}")
        want = fa_ops._plain(q, k, v, True, None, D ** -0.5)
        err = maxabs(got, want)
        tol = TOL[("flash_attention", dtype)]
        if not (err < tol and torch.isfinite(got).all()):
            fail(f"flash_attention S={S}/{dtype}: max abs {err} >= {tol}")
        rel = {}
        if dtype == torch.bfloat16:
            qf, kf, vf = q.float(), k.float(), v.float()
            want32 = fa_ops._plain(qf, kf, vf, True, None, D ** -0.5)
            j = int(S * PLANT_AT) // 64 * 64
            vf[:, j:j + 64] = 0
            lost = fa_ops._plain(qf, kf, vf, True, None, D ** -0.5)
            rel = {"row_rel_err": row_rel(got, want32),
                   "row_tol": FLASH_ROW_TOL,
                   "planted_row_rel_err": row_rel(lost, want32),
                   "planted_abs_err": maxabs(lost, want32),
                   "planted_keys": [j, min(j + 64, S)]}
            del qf, kf, vf, want32, lost
            if not (rel["row_rel_err"] < FLASH_ROW_TOL
                    < rel["planted_row_rel_err"]):
                fail(f"flash_attention S={S}/{dtype} per row vs f32: "
                     f"{rel['row_rel_err']} (tol {FLASH_ROW_TOL}); keys "
                     f"{rel['planted_keys']} lost: "
                     f"{rel['planted_row_rel_err']} must exceed it")
        es = q.element_size()
        nbytes = es * (2 * B * S * H * D + 2 * B * S * Hkv * D)
        pairs = S * (S + 1) / 2                  # causal: visible (q, k)
        flops = 4.0 * B * H * D * pairs
        b_ms, b_by = bound(nbytes, {dtype: flops})
        # the library yardstick: SDPA in its own (B, H, S, D) layout
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        ms = timed_ms(lambda: fa_ops.flash_attention(q, k, v))
        lib_ms = timed_ms(library)
        rows.append({
            "name": "flash_attention", "model": cfg.name,
            "dtype": str(dtype).replace("torch.", ""), "variant": kind,
            "block": f"{16 * fa_ops.plan(S)} rows" if kind == "mma"
            else "32 rows",
            "shape": f"B={B} S={S} H={H} Hkv={Hkv} D={D}",
            "max_abs_err": err, "tol": tol, **rel, "ms": ms,
            "tflops": flops / ms / 1e9, "vs_library": ms / lib_ms,
            "plain_ms": timed_ms(
                lambda: fa_ops._plain(q, k, v, True, None, D ** -0.5)),
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
    return rows


def wkv_cases():
    """(label, B, S, dtype of r/k/v, dtype of logw, decay): the served
    prefill in the model's own dtypes, ragged lengths, all-bf16 and
    all-f32 inputs (the ragged tail held at f32's tolerance too), strong
    decay."""
    bf16, f32 = torch.bfloat16, torch.float32
    yield "model shape", 4, 128, bf16, f32, None
    yield "ragged", 4, 100, bf16, f32, None
    yield "ragged, 19 chunks", 4, 300, bf16, f32, None
    yield "bf16 inputs", 4, 128, bf16, bf16, None
    yield "f32", 4, 128, f32, f32, None
    yield "f32, ragged, 19 chunks", 4, 300, f32, f32, None
    yield "logw = -2", 4, 128, f32, f32, -2.0
    yield "logw = -20", 4, 128, f32, f32, -20.0


def wkv_bytes(B, S, H, K, es, es_w):
    """r/k/v read and y written once in their dtype (es bytes), logw read
    once in its own (es_w), u read and the state written once in f32."""
    n = B * S * H * K
    return es * 4 * n + es_w * n + 4 * (H * K + B * H * K * K)


def wkv_bound(B, S, H, K, es, es_w):
    """Bound of the work the function needs: per step and head about
    5·K² f32 flops (k·vᵀ, r·S and the decayed state update; the kernel's
    chunked form at its 16 rows does 4·Q²·K + 4·Q·K² per chunk, the
    same count at K = 64)."""
    return bound(wkv_bytes(B, S, H, K, es, es_w),
                 {torch.float32: 5.0 * B * H * S * K * K})


def wkv_tpu_work_ms(B, S, H, K, es, es_w):
    """A yardstick, not the bound: the TPU kernel's own work at its chunk
    of c = min(128, S), 4·c²·K + 4·c·K² flops per chunk and head, against
    the same bytes (ms)."""
    c = min(wkv_ops.CHUNK, S)
    flops = B * H * -(-S // c) * (4.0 * c * c * K + 4.0 * c * K * K)
    return bound(wkv_bytes(B, S, H, K, es, es_w),
                 {torch.float32: flops})[0]


def rel_err(got, want) -> float:
    return maxabs(got, want) / (float(want.float().abs().max()) + 1e-6)


def wkv_operands(B, S, H, K, dtype, wdtype, decay, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, K), generator=g, device="cuda"
                           ).to(dtype) for _ in range(3))
    if decay is None:     # the init decays' range, -e^(-6) .. -e^(-1)
        logw = -torch.exp(torch.rand((B, S, H, K), generator=g,
                                     device="cuda") * 5.0 - 6.0)
    else:
        logw = torch.full((B, S, H, K), decay, device="cuda")
    u = 0.1 * torch.randn((H, K), generator=g, device="cuda")
    return r, k, v, logw.to(wdtype), u


def check_wkv(cfg):
    rows = []
    H, K = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    for label, B, S, dtype, wdtype, decay in wkv_cases():
        args = wkv_operands(B, S, H, K, dtype, wdtype, decay, S + int(K))
        y, s = wkv_ops.wkv6(*args)
        torch.cuda.synchronize()

        def plain():
            return wkv_ops._plain(*args, wkv_ops.CHUNK)
        if decay is None:
            yw, sw = plain()
            yardstick = "wkv6_chunked"
        else:   # the chunked form overflows here; the per-step oracle
            yw, sw = wkv6_ref(*args)
            yardstick = "wkv6_ref"
        err, rel = maxabs(y, yw), rel_err(y, yw)
        s_rel = rel_err(s, sw)
        tol = TOL[("wkv6", dtype)]
        if not (rel < tol and s_rel < TOL[("wkv6", torch.float32)]
                and torch.isfinite(y).all() and torch.isfinite(s).all()):
            fail(f"wkv6 {label}: y rel {rel}, state rel {s_rel} (tol {tol})")
        es, es_w = args[0].element_size(), args[3].element_size()
        b_ms, b_by = wkv_bound(B, S, H, K, es, es_w)
        vs, vt, grid = wkv_ops.plan(B, H, K, sms())
        rows.append({
            "name": "wkv6", "model": cfg.name, "case": label,
            "dtype": str(dtype).replace("torch.", ""),
            "logw_dtype": str(wdtype).replace("torch.", ""),
            "shape": f"B={B} S={S} H={H} K={K}", "yardstick": yardstick,
            "plan": f"VS={vs} VT={vt} grid {grid}",
            "max_abs_err": err, "rel_err": rel, "state_rel_err": s_rel,
            "tol": tol, "ms": timed_ms(lambda: wkv_ops.wkv6(*args)),
            "plain_ms": timed_ms(plain), "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
            "tpu_chunk128_work_ms": wkv_tpu_work_ms(B, S, H, K, es, es_w)})
    return rows


def wkv_chunk_steps(cfg):
    """Time per 16-row chunk step, the slope from S 64 to S 1024, at B 1
    (an SM holds at most one block: close to the latency of one step) and
    at the served B 4 (what the SMs get through). Equal slopes would say
    latency; a B 4 slope that grows with the blocks per SM says issue
    and shared-memory throughput."""
    H, K = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    out = {}
    for B in (1, 4):
        ms = []
        for S in (64, 1024):
            args = wkv_operands(B, S, H, K, torch.bfloat16, torch.float32,
                                None, S)
            ms.append(timed_ms(lambda: wkv_ops.wkv6(*args)))
        vs, vt, grid = wkv_ops.plan(B, H, K, sms())
        out[f"B={B}"] = {"grid": list(grid), "ms_S64": ms[0],
                         "ms_S1024": ms[1],
                         "us_per_chunk_step": (ms[1] - ms[0]) / 60 * 1e3}
    return out


# ---------------------------------------------------------------------------
# Phase 2, continued: the round's training shapes
# ---------------------------------------------------------------------------

# a local train step: B 10 samples of S 24 tokens (SimConfig's batch and
# the synthetic tasks' length)
TRAIN_B, TRAIN_S = 10, 24
# the closed-form LoRA backward on the card against autograd of the plain
# version: 1e-4 of each gradient's largest entry (at least 1e-4), f32
# summation order with TF32 off
BWD_TOL = 1e-4


def grad_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), worst over the list."""
    return max(maxabs(g, w) / max(1.0, float(w.float().abs().max()))
               for g, w in zip(got, want))


# the rows each kind of lora_matmul call of a vit-base-paper round takes,
# and the ranks it runs there: a train step's batch (ours: rank 2 in
# round 0, 4 in round 1; HomoLoRA and FedRA 8; HetLoRA 2-32; 32 is the
# slot), a vehicle's local eval (32 samples) and the server's global
# eval (the largest task's eval split, 336 samples) at max_rank, or at 8
# for HomoLoRA's and FedRA's global adapters
LORA_TRAIN_CASES = (("train", TRAIN_B * TRAIN_S, (2, 4, 8, 16, 32)),
                    ("local eval", 32 * TRAIN_S, (2, 4)),
                    ("global eval", 336 * TRAIN_S, (8, 32)))


VIT_LINEARS = (("q/k/v/o", 768, 768), ("up", 768, 3072),
               ("down", 3072, 768))


def check_lora_train():
    """f32 lora_matmul at the serial round's shapes of vit-base-paper,
    with the closed-form backward at the train step's."""
    rows = []
    for mode, M, ranks in LORA_TRAIN_CASES:
        for linear, K, N in VIT_LINEARS:
            for r in ranks:
                rows.append(lora_train_row(mode, M, linear, K, N, r))
    return rows


def lora_train_row(mode, M, linear, K, N, r, L=1, lane_ranks=None,
                   model="vit-base-paper"):
    """One f32 lora_matmul row: L lanes of M rows against one W; with
    ``lane_ranks`` the lanes are rank-padded to r, each masked at its own
    rank with scale 16 / rank (the fused engine's fleet)."""
    g = torch.Generator(device="cuda").manual_seed(L * M + K + N + r)
    x = torch.randn((L, M, K), generator=g, device="cuda")
    w = torch.randn((K, N), generator=g, device="cuda") / K ** 0.5
    a = torch.randn((L, K, r), generator=g, device="cuda") / K ** 0.5
    b = 0.1 * torch.randn((L, r, N), generator=g, device="cuda")
    scale = torch.full((L,), 16.0 / r, device="cuda")
    mask = torch.ones((L, r), device="cuda")
    if lane_ranks is not None:
        ranks = torch.as_tensor(lane_ranks, device="cuda")
        mask = rank_arange_mask(ranks, r)
        scale = 16.0 / ranks.float()
    args = (x, w, a, b, scale, mask)
    got, kind = launched_variant(lambda: lm_ops.lora_matmul(*args))
    err = maxabs(got, lora_matmul_ref(*args))
    tol = TOL[("lora_matmul", torch.float32)]
    if not (kind == "simt" and err < tol and torch.isfinite(got).all()):
        fail(f"lora_matmul {mode} {linear} L={L} M={M} r={r}: {kind}, max "
             f"abs {err} >= {tol}")
    t_ = x @ a
    LM = L * M
    nbytes = 4 * (LM * K + K * N + LM * N + L * (K * r + r * N + 1 + r))
    b_ms, b_by = bound(nbytes, {torch.float32: 2.0 * LM * K * N
                                + 2.0 * LM * r * (K + N)})

    def library():
        return x @ w + scale[:, None, None] * (
            ((x @ a) * mask[:, None, :]) @ b)
    kernel_ms = timed_ms(lambda: lm_ops._launch(x, w, t_, b, scale, mask))
    row = {"name": "lora_matmul", "model": model,
           "linear": linear, "mode": mode, "variant": kind,
           "dtype": "float32", "rank": r,
           "shape": f"L={L} M={M} K={K} N={N} r={r}" + (
               "" if lane_ranks is None else " (lane ranks "
               f"{sorted(set(lane_ranks))})"),
           "key": [L, M, K, N, r],
           "max_abs_err": err, "tol": tol, "rank_pin": None,
           "deterministic": None,
           "ms": timed_ms(lambda: lm_ops.lora_matmul(*args)),
           "kernel_ms": kernel_ms,
           "kernel_tflops": 2.0 * LM * K * N / kernel_ms / 1e9,
           "kernel_gbs": nbytes / kernel_ms / 1e6,
           "plain_ms": timed_ms(lambda: lora_matmul_ref(*args)),
           "library_ms": timed_ms(library),
           "bound_ms": b_ms, "bound_by": b_by}
    if "eval" in mode:
        return row
    gy = torch.randn((L, M, N), generator=g, device="cuda")
    # the frozen base: x, a and b ask for grads, W does not
    need = (True, False, True, True, False, False)

    def grads(fn):
        ins = [t.detach().requires_grad_(n) for t, n in zip(args, need)]
        return torch.autograd.grad(
            fn(*ins), [t for t in ins if t.requires_grad], gy)
    bwd = grad_err(grads(lm_ops.lora_matmul), grads(lora_matmul_ref))
    if not bwd < BWD_TOL:
        fail(f"lora_matmul train {linear} r={r}: backward err {bwd} >= "
             f"{BWD_TOL}")
    # the backward's own work: dx (g·Wᵀ and u·Aᵀ), dA, dB and u
    bwd_ops = {torch.float32: 2.0 * LM * N * K + 2.0 * LM * r
               * (2 * N + 2 * K)}
    bwd_bytes = 4 * (2 * LM * N + 2 * LM * K + K * N
                     + 2 * L * r * (K + N) + LM * r)
    row.update({
        "bwd_err": bwd, "bwd_tol": BWD_TOL,
        "bwd_ms": timed_ms(lambda: lm_ops.lora_matmul_backward(
            gy, x, w, a, b, scale, mask, t_, need)),
        "autograd_plain_bwd_ms": timed_ms(lambda: grads(lora_matmul_ref)),
        "bwd_bound_ms": bound(bwd_bytes, bwd_ops)[0]})
    return row


def check_flash_train():
    """Flash attention at the round's attention shapes (S 24): a train
    step's batch (B 10) at head dim 16 with 4 heads (reduced ViT) and 64
    with 12 (vit-base-paper), f32 (the round's dtype, simt) and bf16
    (mma); and vit-base-paper's local and global evals (B 32 and 336) in
    f32. The backward is the plain version's autograd (no kernel), so it
    is not held here."""
    rows = []
    for mode, B, H, D, model, dtypes in (
            ("train", TRAIN_B, 4, 16, "vit-tiny-paper",
             (torch.float32, torch.bfloat16)),
            ("train", TRAIN_B, 12, 64, "vit-base-paper",
             (torch.float32, torch.bfloat16)),
            ("local eval", 32, 12, 64, "vit-base-paper", (torch.float32,)),
            ("global eval", 336, 12, 64, "vit-base-paper",
             (torch.float32,))):
        for dtype in dtypes:
            rows.append(flash_train_row(mode, B, H, D, model, dtype))
    return rows


def flash_train_row(mode, B, H, D, model, dtype, S=TRAIN_S):
    kind = fa_ops.variant(dtype, D)
    g = torch.Generator(device="cuda").manual_seed(B * H * D + S)
    q, k, v = (torch.randn((B, S, H, D), generator=g,
                           device="cuda").to(dtype) for _ in range(3))
    before = flash_variant_counts()
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    took = [n for n, c in flash_variant_counts().items() if c != before[n]]
    if took != [kind]:
        fail(f"flash {mode} B={B} D={D}/{dtype} launched {took}, want "
             f"{kind}")
    err = maxabs(got, fa_ops._plain(q, k, v, True, None, D ** -0.5))
    tol = TOL[("flash_attention", dtype)]
    if not (err < tol and torch.isfinite(got).all()):
        fail(f"flash {mode} B={B} D={D}/{dtype}: max abs {err} >= {tol}")
    es = q.element_size()
    nbytes = es * 4 * B * S * H * D
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    b_ms, b_by = bound(nbytes, {dtype: flops})
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return {
        "name": "flash_attention", "model": model, "mode": mode,
        "dtype": str(dtype).replace("torch.", ""), "variant": kind,
        "block": f"{16 * fa_ops.plan(S)} rows" if kind == "mma"
        else "32 rows",
        "shape": f"B={B} S={S} H={H} Hkv={H} D={D}",
        "key": [B, S, H, D], "max_abs_err": err, "tol": tol,
        "ms": timed_ms(lambda: fa_ops.flash_attention(q, k, v)),
        "plain_ms": timed_ms(
            lambda: fa_ops._plain(q, k, v, True, None, D ** -0.5)),
        "library_ms": timed_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
        "bound_ms": b_ms, "bound_by": b_by}


def check_lane_shapes(lanes_by_rank, label=""):
    """Phase 2 at the batched round's lane shapes, V from its largest
    group per rank: f32 lora_matmul at V x 240 rows (train, forward and
    closed-form backward) and V x 768 (local eval), flash at B = V·10
    and V·32. ``label`` prefixes the rows' mode (the method)."""
    rows = []
    for r, V in sorted(lanes_by_rank.items()):
        for mode, M in ((f"{label}train lanes", TRAIN_B * TRAIN_S),
                        (f"{label}local eval lanes", 32 * TRAIN_S)):
            for linear, K, N in VIT_LINEARS:
                rows.append(lora_train_row(mode, M, linear, K, N, r, L=V))
    for V in sorted(set(lanes_by_rank.values())):
        for mode, B in ((f"{label}train lanes", V * TRAIN_B),
                        (f"{label}local eval lanes", V * 32)):
            rows.append(flash_train_row(mode, B, 12, 64, "vit-base-paper",
                                        torch.float32))
    return rows


def check_fused_shapes(V, candidates):
    """Phase 2 at the fused round's shapes: the whole fleet of V lanes,
    rank-padded to the slot (the largest candidate) with lane ranks
    cycling over the candidates: f32 lora_matmul at V x 240 rows (train,
    forward and closed-form backward) and V x 768 (local eval), flash at
    B = V·10 and V·32."""
    r = max(candidates)
    ranks = [candidates[v % len(candidates)] for v in range(V)]
    rows = []
    for mode, M in (("fused train lanes", TRAIN_B * TRAIN_S),
                    ("fused local eval lanes", 32 * TRAIN_S)):
        for linear, K, N in VIT_LINEARS:
            rows.append(lora_train_row(mode, M, linear, K, N, r, L=V,
                                       lane_ranks=ranks))
    for mode, B in (("fused train lanes", V * TRAIN_B),
                    ("fused local eval lanes", V * 32)):
        rows.append(flash_train_row(mode, B, 12, 64, "vit-base-paper",
                                    torch.float32))
    return rows


# ---------------------------------------------------------------------------
# Phase 3: full width, reduced depth, card vs CPU
# ---------------------------------------------------------------------------

def engine_with_tenants(params, cfg, lora, dtype, device, seed0):
    eng = ServeEngine(params, cfg, lora,
                      ServeSpec(max_batch=len(RANKS), cache_len=128,
                                max_rank=SLOT), dtype=dtype, device=device)
    for lane, rank in enumerate(RANKS):
        eng.assign(lane, paged(cfg, lora, rank, seed0 + lane, device))
    return eng


def paged(cfg, lora, rank, seed, device):
    # drawn on the CPU (CPU and CUDA generators give different streams),
    # so the card and CPU engines of phase 3 serve the same tenants
    ads = nontrivial(T.init_adapters(cfg, lora, seed=seed, rank=rank,
                                     device="cpu"), seed)
    return PagedAdapter(task=0, rsu=-1, version=0, rank=rank, slot_rank=SLOT,
                        scale=lora.alpha / rank,
                        adapters=to(pad_adapter_tree(ads, SLOT), device))


def parity(cfg_full, lora, seq, layers=2, steps=8):
    """Full width at ``layers`` layers, f32, the same weights on the card
    and on the CPU: prefill logits (with ``prefix_embeds`` where the
    config takes them) and ``steps`` multi-tenant decode steps. The
    weights are drawn on the card and copied to the host (a 20 GB MoE
    layer draws in a second there, in minutes on the host)."""
    cfg = cfg_full.with_overrides(num_layers=layers,
                                  block_pattern=cfg_full.blocks()[:layers]
                                  if cfg_full.block_pattern else None)
    params_gpu = T.init_params(cfg, seed=1, dtype=torch.float32,
                               device="cuda")
    params_cpu = to(params_gpu, "cpu")
    ads_cpu = nontrivial(T.init_adapters(cfg, lora, seed=2, rank=SLOT,
                                         device="cpu"), 2)
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, seq),
                                     generator=g)}
    tokens = batch["tokens"]
    if cfg.num_prefix_embeds:
        batch["prefix_embeds"] = 0.5 * torch.randn(
            (2, cfg.num_prefix_embeds, cfg.d_model), generator=g)
    want = make_prefill_step(cfg, lora, device="cpu")(params_cpu, ads_cpu,
                                                      batch)
    got = make_prefill_step(cfg, lora, device="cuda")(
        params_gpu, to(ads_cpu, "cuda"), batch)
    prefill_err = maxabs(got.cpu(), want)
    if not prefill_err <= E2E_TOL:
        fail(f"{cfg.name} prefill card vs CPU: max abs {prefill_err} > "
             f"{E2E_TOL}")

    eng_cpu = engine_with_tenants(params_cpu, cfg, lora, torch.float32,
                                  "cpu", seed0=10)
    eng_gpu = engine_with_tenants(params_gpu, cfg, lora, torch.float32,
                                  "cuda", seed0=10)
    toks = np.array([1, 2, 3, 4])
    decode_err = 0.0
    for step in range(steps):
        got = eng_gpu.step(toks).cpu()
        want = eng_cpu.step(toks)
        err = maxabs(got, want)
        decode_err = max(decode_err, err)
        if not err <= E2E_TOL:
            fail(f"{cfg.name} decode step {step} card vs CPU: max abs {err}")
        toks = want.argmax(-1).numpy()
        if step == 3 and (cfg.rwkv is not None or cfg.ssm is not None):
            # a fresh recurrent state
            for eng, dev in ((eng_cpu, "cpu"), (eng_gpu, "cuda")):
                eng.retire(3)
                eng.admit(paged(cfg, lora, 32, 40, dev), lane=3)
    # the single-sequence decode factory on the card, same weights
    decode = make_decode_step(cfg, lora, device="cuda")
    caches = T.init_caches(cfg, 2, 8, dtype=torch.float32, device="cuda")
    logits, _ = decode(params_gpu, None, tokens[:, :1], caches, 0)
    if not torch.isfinite(logits).all():
        fail("decode factory logits not finite")
    pre = (f" after a {cfg.num_prefix_embeds}-row prefix"
           if cfg.num_prefix_embeds else "")
    out = {"config": f"{cfg.name}, {cfg.num_layers} layers, full width, "
           f"f32, prefill 2x{seq}{pre}", "tol": E2E_TOL,
           "prefill_max_abs_err": prefill_err,
           "decode_max_abs_err": decode_err, "decode_steps": steps}
    del params_cpu, params_gpu, eng_cpu, eng_gpu, caches
    release()
    return out


# ---------------------------------------------------------------------------
# Phase 4: the served run at full depth
# ---------------------------------------------------------------------------

def served(cfg, lora):
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    prefill = make_prefill_step(cfg, lora, device="cuda")
    ads = nontrivial(T.init_adapters(cfg, lora, seed=5, rank=SLOT,
                                     device="cuda"), 5)
    tokens = torch.randint(0, cfg.vocab_size, (4, 128),
                           generator=torch.Generator().manual_seed(6))
    prefill(params, ads, {"tokens": tokens})         # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = prefill(params, ads, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_counts = counts()
    prefill_variants = variant_counts()
    prefill_flash = flash_variant_counts()
    if not torch.isfinite(logits).all():
        fail(f"{cfg.name} prefill logits not finite")
    in_prefill, in_step = per_model(cfg)
    want = dict(in_prefill)
    if prefill_counts != want:
        fail(f"{cfg.name} prefill launches {prefill_counts}, want {want}")
    # every bf16 lora_matmul and flash launch of the served prefill on
    # the tensor cores
    want_fa = {"mma": want["flash_attention"], "simt": 0}
    want = {"wgmma": want["lora_matmul"], "splitk": 0, "simt": 0}
    if prefill_variants != want:
        fail(f"{cfg.name} prefill lora_matmul variants {prefill_variants}, "
             f"want {want}")
    if prefill_flash != want_fa:
        fail(f"{cfg.name} prefill flash_attention variants {prefill_flash}, "
             f"want {want_fa}")

    eng = engine_with_tenants(params, cfg, lora, torch.bfloat16, "cuda",
                              seed0=20)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                (len(RANKS), 16))
    eng.step(prompts[:, 0])                           # warm-up
    for lane in range(eng.max_batch):
        eng.reset_lane(lane)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    gen1 = eng.generate(prompts, 32)
    eng.retire(3)
    eng.admit(paged(cfg, lora, 32, 30, "cuda"), lane=3)
    gen2 = eng.generate(prompts, 32)
    last = eng.step(gen2[:, -1])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    steps = 2 * (16 + 32 - 1) + 1
    decode_counts = counts()
    decode_variants = variant_counts()
    decode_flash = flash_variant_counts()
    if not torch.isfinite(last).all():
        fail(f"{cfg.name} decode logits not finite")
    want = {k: n * steps for k, n in in_step.items()}
    if decode_counts != want:
        fail(f"{cfg.name} decode launches {decode_counts}, want {want}")
    # and every one of the served decode on the weight-streaming kernel
    want = {"wgmma": 0, "splitk": want["lora_matmul"], "simt": 0}
    if decode_variants != want:
        fail(f"{cfg.name} decode lora_matmul variants {decode_variants}, "
             f"want {want}")
    if gen1.shape != (4, 32) or gen2.shape != (4, 32):
        fail("generate returned the wrong shape")
    # after the counted runs: where the device time goes
    traces = {
        "prefill": device_profile(
            lambda: prefill(params, ads, {"tokens": tokens})),
        "decode_4_steps": device_profile(
            lambda: [eng.step(gen2[:, -1]) for _ in range(4)])}
    return {
        "model": cfg.name,
        "config": f"{cfg.name}, {cfg.num_layers} layers, full width, bf16",
        "prefill": {"batch": 4, "seq": 128, "ms": prefill_ms,
                    "launches": prefill_counts,
                    "lora_matmul_variants": prefill_variants,
                    "flash_attention_variants": prefill_flash},
        "decode": {"lanes": len(RANKS), "ranks": list(RANKS), "slot": SLOT,
                   "steps": steps, "seconds": decode_s,
                   "lane_tokens_per_s": len(RANKS) * steps / decode_s,
                   "ms_per_step": decode_s / steps * 1e3,
                   "launches": decode_counts,
                   "lora_matmul_variants": decode_variants,
                   "launches_per_step": {
                       k: v / steps for k, v in decode_counts.items()}},
        "launches": {k: prefill_counts[k] + decode_counts[k]
                     for k in prefill_counts},
        "lora_matmul_variants": {k: prefill_variants[k] + decode_variants[k]
                                 for k in prefill_variants},
        "flash_attention_variants": {k: prefill_flash[k] + decode_flash[k]
                                     for k in prefill_flash},
        "profile": traces,
    }


# seconds the profiler's window waits before and after the profiled call
SETTLE_S = 0.5


def device_profile(fn, top=8):
    """Device time by kernel over one fn() (torch.profiler, CUDA activity
    only), and the share of the wall time the device was busy. The
    profiler's own overhead lengthens the wall time a little. The window
    pauses SETTLE_S before and after fn() (outside the timed wall): the
    activity records of CUDA-graph kernels arrive late, and without the
    pauses a replayed round's profile lost up to 53% of its kernel
    records (PERF.md, Findings)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_in = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(SETTLE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(SETTLE_S)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    ours = {}   # the port's kernels, by name, wherever they rank
    for k, ms, n in rows:
        name = next((n_ for n_ in (*VARIANT_OF, "wkv6_kernel")
                     if f"::{n_}<" in k), None)
        if name:
            t = ours.setdefault(name, {"ms": 0.0, "count": 0})
            t["ms"] += ms
            t["count"] += n
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "window_s": time.perf_counter() - t_in,
            "kernels": len(rows), "port_kernels": ours,
            "top": [{"kernel": k[:100], "ms": ms, "count": n}
                    for k, ms, n in rows[:top]]}


# ---------------------------------------------------------------------------
# Phase 5: the federated round (serial engine)
# ---------------------------------------------------------------------------

# card vs CPU, reduced ViT, one round: f32 summation order through a
# 2-layer model and 3 Adam steps per vehicle (relative to the largest
# entry of each merged delta; energy and latency relative)
ROUND_TOL = 1e-4
# full width, batched vs serial on the card: each lane's update within
# SPREAD_FACTOR times the serial trainer's own card-vs-CPU spread on the
# first CPU_LANES lanes of the same group (see group_budgets_agree)
SPREAD_FACTOR = 2.0
CPU_LANES = 3


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


class ShapeCounter:
    """Counts the kernels' launches by shape and dtype while installed, by
    wrapping the wrappers' ``_launch`` (whose own counts stay as they
    are). lora_matmul keys on (lanes, rows, K, N, r, dtype)."""

    def __init__(self):
        self.lora, self.flash = {}, {}
        self._orig = (lm_ops._launch, fa_ops._launch)

    def __enter__(self):
        lora_launch, flash_launch = self._orig

        def lora(x, w, t, b, scale, mask):
            key = tuple(x.shape) + (w.shape[1], t.shape[-1],
                                    dtype_name(x.dtype))
            self.lora[key] = self.lora.get(key, 0) + 1
            return lora_launch(x, w, t, b, scale, mask)

        def flash(q, k, v, *rest):
            key = tuple(q.shape) + (dtype_name(q.dtype),)
            self.flash[key] = self.flash.get(key, 0) + 1
            return flash_launch(q, k, v, *rest)
        lm_ops._launch, fa_ops._launch = lora, flash
        return self

    def __exit__(self, *exc):
        lm_ops._launch, fa_ops._launch = self._orig

    @staticmethod
    def by_shape(table):
        return {"x".join(map(str, k)): v for k, v in sorted(table.items())}


def recording(sim, plans):
    """Wrap the simulator's planner to keep each task's active set, ranks
    and departures. The fused engine plans in its round program: its
    active sets and departures come from the staged inputs, its ranks
    from the arm each vehicle's UCB-DUAL count moved on."""
    if sim.fused is not None:
        eng, staged = sim.fused, []
        stage, run_round = eng._stage_round, sim.run_round

        def stage_spy(*a, **kw):
            out = stage(*a, **kw)
            staged.append(out[0])
            return out

        def rr():
            before = [st.counts.clone() for st in sim.ucb_states]
            rec = run_round()
            x, cand = staged[-1], sim.cfg.lora.candidate_ranks
            for ti in range(sim.cfg.num_tasks):
                ids = np.where(x["active"][ti])[0]
                arms = torch.argmax(sim.ucb_states[ti].counts - before[ti],
                                    -1)
                plans.append((ti, ids.tolist(),
                              [int(cand[int(arms[v])]) for v in ids],
                              x["departing"][ti].astype(bool).tolist()))
            return rec
        eng._stage_round, sim.run_round = stage_spy, rr
        return
    plan_task = sim._plan_task

    def plan(ti):
        p = plan_task(ti)
        plans.append((int(ti), p["active_ids"].tolist(),
                      [int(p["ranks"][v]) for v in p["active_ids"]],
                      np.asarray(p["departing"]).tolist()))
        return p
    sim._plan_task = plan


def split_counts(sim):
    """Accumulate both kernels' launches by variant under train steps
    (the serial trainer's per vehicle, the batched trainer's per group)
    and evaluations (local and global); keep every step's loss."""
    split = {"train": {}, "eval": {}, "losses": [], "steps": 0, "evals": 0}

    def snap():
        return {**{f"lora_matmul.{k}": v
                   for k, v in lm_ops.launches_by_variant.items()},
                **{f"flash_attention.{k}": v
                   for k, v in fa_ops.launches_by_variant.items()}}

    def add(kind, before):
        for k, v in snap().items():
            split[kind][k] = split[kind].get(k, 0) + v - before[k]

    def wrap(obj, name, kind):
        fn = getattr(obj, name)

        def counted(*a, **kw):
            before = snap()
            out = fn(*a, **kw)
            add(kind, before)
            if kind == "train":
                split["steps"] += 1
                split["losses"].append(out[2]["loss"].reshape(-1))
            else:
                split["evals"] += 1
            return out
        setattr(obj, name, counted)
    wrap(sim.trainer, "train_step", "train")
    wrap(sim.trainer, "evaluate", "eval")
    wrap(sim.batched_trainer, "train_step", "train")
    wrap(sim.batched_trainer, "evaluate_lanes", "eval")
    return split


def step_grads(sim, ads, batch, rank):
    """Loss and adapter grads of one local train step's loss on sim's
    device (the trainer's loss, differentiated by the adapters only)."""
    import dataclasses
    ad = tree_map(lambda t: t.to(sim.device).requires_grad_(), ads)
    lora_r = dataclasses.replace(sim.cfg.lora, rank=rank)
    b = sim.trainer._batch(batch)
    loss, _ = T.loss_fn(sim.params, ad, sim.model_cfg, lora_r, b)
    grads = torch.autograd.grad(loss, leaves(ad))
    return loss.detach().cpu(), [g.cpu() for g in grads]


def merged_rel_err(want_servers, got_merged, by_leaf=None):
    """Largest |got - want| over the merged deltas of every task, relative
    to each task's largest entry; per leaf into ``by_leaf``."""
    worst = 0.0
    for ti, (want, got) in enumerate(zip(want_servers, got_merged)):
        err = top = 0.0
        for path in tree_paths_delta(want):
            w = tree_get(want, path)["delta"].cpu()
            g = tree_get(got, path)["delta"].cpu()
            e, m = maxabs(g, w), float(w.abs().max())
            if by_leaf is not None:
                by_leaf[f"{ti}/{'/'.join(map(str, path[2:]))}"] = (
                    e / max(m, 1e-30))
            err, top = max(err, e), max(top, m)
        worst = max(worst, err / max(top, 1e-30))
    return worst


def heads_of(cfg):
    """A config's heads, for its printed line."""
    if cfg.rwkv is not None:
        return (f"{cfg.d_model // cfg.rwkv.head_dim} wkv heads of "
                f"{cfg.rwkv.head_dim}")
    return f"{cfg.num_heads} heads of {cfg.resolved_head_dim}"


def round_per_fwd(cfg, lora):
    """Launches of each kernel per forward of the round's model: one
    lora_matmul per LoRA linear, one flash per attention layer, one wkv6
    per rwkv6 layer."""
    rwkv = cfg.rwkv is not None
    return {"lora_matmul": cfg.num_layers * len(tree_paths(
        T.init_adapters(cfg, lora, rank=2, device="cpu"))),
        "flash_attention": 0 if rwkv else cfg.num_layers,
        "wkv6": cfg.num_layers if rwkv else 0}


def round_parity(engine, arch=None, **kw):
    """Phase 5a (and 7b with ``arch``): the reduced ViT (head dim 16) with
    the default SimConfig (or ``arch`` with ``kw``'s SimConfig fields)
    under ``engine``, one seed, on the card and on the CPU."""
    sims, plans, recs = {}, {}, {}
    if arch is not None:
        kw["train_arch"] = arch
    for dev in ("cuda", "cpu"):
        sims[dev] = IoVSimulator(SimConfig(engine=engine, **kw), device=dev)
        plans[dev] = []
        recording(sims[dev], plans[dev])
    cfg, lora = sims["cpu"].model_cfg, sims["cpu"].cfg.lora
    out = {"engine": engine}
    if engine == "serial":
        # one local train step's loss and grads: fresh adapters with b off
        # zero (with b = 0 every grad of a is exactly 0), a batch of task 0
        ads = nontrivial(T.init_adapters(cfg, lora, seed=11, rank=8,
                                         device="cpu"), 11)
        d = sims["cpu"].task_data[0]
        batch = {"tokens": d["tokens"][:TRAIN_B],
                 "labels": d["labels"][:TRAIN_B]}
        (l_gpu, g_gpu), (l_cpu, g_cpu) = (step_grads(sims[dev], ads, batch,
                                                     8)
                                          for dev in ("cuda", "cpu"))
        loss_err = abs(float(l_gpu) - float(l_cpu))
        grad_abs = max(maxabs(a, b) for a, b in zip(g_gpu, g_cpu))
        if not (loss_err < ROUND_TOL and grad_abs < ROUND_TOL):
            fail(f"train step card vs CPU: loss {loss_err}, grads "
                 f"{grad_abs}")
        out.update(step_loss_err=loss_err, step_grad_max_abs_err=grad_abs)
    # one round
    reset_counts()
    with ShapeCounter() as shapes:
        t0 = time.perf_counter()
        recs["cuda"] = sims["cuda"].run_round()
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        launched = counts()
        lora_v, flash_v = variant_counts(), flash_variant_counts()
    t0 = time.perf_counter()
    recs["cpu"] = sims["cpu"].run_round()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    per_fwd = round_per_fwd(cfg, lora)
    if any(launched[k] == 0 for k, n in per_fwd.items() if n) or any(
            launched[k] for k, n in per_fwd.items() if not n):
        fail(f"reduced {cfg.name} {engine} round launched {launched}")
    if plans["cuda"] != plans["cpu"]:
        fail(f"{engine} round card vs CPU: active sets, ranks or "
             f"departures differ")
    rel = {}
    for gt, ct in zip(recs["cuda"]["tasks"], recs["cpu"]["tasks"]):
        for key in ("active", "departing", "fallbacks", "comm_params",
                    "mean_rank"):
            if gt[key] != ct[key]:
                fail(f"{engine} round card vs CPU: task {gt['task']} {key}"
                     f" {gt[key]} vs {ct[key]}")
        for key in ("energy", "latency"):
            e = abs(gt[key] - ct[key]) / max(abs(ct[key]), 1e-12)
            rel[key] = max(rel.get(key, 0.0), e)
    # per task: max abs difference over its merged deltas, relative to
    # their largest entry. Adam's first step is close to lr·sign(g), so an
    # entry of b whose gradient is near 0 moves by up to 2·lr apart on
    # the two devices; the leaf-by-leaf ratios are kept for the record
    by_leaf = {}
    delta = merged_rel_err([s.merged for s in sims["cpu"].servers],
                           [s.merged for s in sims["cuda"].servers], by_leaf)
    if not (delta < ROUND_TOL and max(rel.values()) < ROUND_TOL):
        fail(f"{engine} round card vs CPU: merged deltas {delta}, {rel}")
    out.update({
        "config": f"SimConfig(engine={engine!r}"
        + "".join(f", {k}={v}" for k, v in kw.items() if k != "train_arch")
        + f") otherwise default, train arch {cfg.name} ({cfg.num_layers} "
        f"layers, d {cfg.d_model}, head dim "
        f"{(cfg.rwkv.head_dim if cfg.rwkv else cfg.resolved_head_dim)}), "
        "f32", "tol": ROUND_TOL,
        "merged_delta_rel_err": delta,
        "merged_delta_rel_err_by_leaf": by_leaf,
        "energy_rel_err": rel["energy"], "latency_rel_err": rel["latency"],
        "ranks": sorted({r for _, _, rs, _ in plans["cpu"] for r in rs}),
        "active": [t["active"] for t in recs["cpu"]["tasks"]],
        "accuracy_card": recs["cuda"]["accuracy"],
        "accuracy_cpu": recs["cpu"]["accuracy"],
        "card_round_ms": card_ms, "cpu_round_ms": cpu_ms,
        "captures": (sims["cuda"].fused.captures
                     if sims["cuda"].fused is not None else None),
        "launches": launched, "lora_matmul_variants": lora_v,
        "flash_attention_variants": flash_v,
        "lora_matmul_by_shape": shapes.by_shape(shapes.lora),
        "flash_attention_by_shape": shapes.by_shape(shapes.flash)})
    return out


def check_dev_on_card(engine):
    """Phases 5a and 5c: one ``batched_check`` or ``fused_check`` round of
    the reduced ViT on the card: the serial trainer replayed on the
    engine's batches (and, fused, its distributed lanes)."""
    sim = IoVSimulator(SimConfig(engine=engine), device="cuda")
    sim.run_round()
    if not sim.engine_check_dev < ROUND_TOL:
        fail(f"{engine} on the card: engine_check_dev "
             f"{sim.engine_check_dev} >= {ROUND_TOL}")
    return sim.engine_check_dev


def round_groups(sim, round_plans):
    """The batched engine's groups of one round, from its plans:
    [(task, rank, lanes, train forwards)], the forwards being the
    group's largest step budget (§IV-E: departing vehicles train
    max(1, round(local_steps · departure_fraction)) steps)."""
    cfg = sim.cfg
    dep = max(1, int(round(cfg.local_steps * cfg.departure_fraction)))
    groups = []
    for ti, active, ranks, departing in round_plans:
        by_rank = {}
        for v, r in zip(active, ranks):
            by_rank.setdefault(r, []).append(
                dep if departing[v] else cfg.local_steps)
        groups += [(sim.tasks[ti].name, r, len(st), max(st))
                   for r, st in sorted(by_rank.items())]
    return groups


def full_rounds(engine, n_profiled, method="ours", hook=None, modes=None,
                plain=1, arch=None, params=None):
    """Phases 5b, 5d and 5e: rounds of ``method`` at the full width of
    vit-base-paper on the card under ``engine`` (with ``modes``, a tier
    or semi_sync's SimConfig fields), ``n_profiled`` each under a
    profiler window, then ``plain`` more without it; every batched
    round's launches held to its groups' prediction. ``hook(sim)`` runs
    before the first round. ``arch`` cuts the depth (default: all 12
    layers). Keeps each round's plans, records and the servers' states
    (merged deltas, or the baselines' global adapters; under "_state",
    for :func:`engines_agree`)."""
    t_start = time.perf_counter()
    sim = IoVSimulator(SimConfig(
        method=method, engine=engine,
        train_arch=arch or vit_base_paper.vit_base_paper(), **(modes or {})),
        device="cuda", params=params)
    if hook is not None:
        hook(sim)
    cfg = sim.model_cfg
    nt = sim.cfg.num_tasks
    per_fwd = round_per_fwd(cfg, sim.cfg.lora)
    plans = []
    recording(sim, plans)
    split = split_counts(sim)
    state = {"plans": [], "recs": [], "merged": []}
    out = []
    reset_counts()
    for rnd in range(n_profiled):
        before = {"train": dict(split["train"]),
                  "eval": dict(split["eval"]),
                  "steps": split["steps"], "evals": split["evals"],
                  "counts": counts()}
        recs = []
        torch.cuda.reset_peak_memory_stats()
        with ShapeCounter() as shapes:
            prof = device_profile(lambda: recs.append(sim.run_round()),
                                  top=6)
        peak = torch.cuda.max_memory_allocated()
        rec = recs[0]
        losses = torch.cat(split["losses"]).cpu()
        split["losses"] = []
        finite = (bool(torch.isfinite(losses).all())
                  and np.isfinite(rec["energy"])
                  and np.isfinite(rec["accuracy"])
                  and all(np.isfinite(t["energy"]) and
                          np.isfinite(t["accuracy"])
                          for t in rec["tasks"]))
        if not finite:
            fail(f"full-width {engine} round {rnd}: a loss, energy or "
                 f"accuracy is not finite")
        launched = {k: v - before["counts"][k] for k, v in counts().items()}
        row = {
            "round": rnd, "wall_ms": prof["wall_ms"],
            "device_ms": prof["device_ms"],
            "busy_share": prof["busy_share"],
            "peak_memory_bytes": peak,
            "kernels_in_trace": prof["kernels"],
            "port_kernels": prof["port_kernels"], "top": prof["top"],
            "profiler_window_s": prof["window_s"],
            "train_steps": split["steps"] - before["steps"],
            "evals": split["evals"] - before["evals"],
            "launches": {kind: {k: v - before[kind].get(k, 0)
                                for k, v in split[kind].items()}
                         for kind in ("train", "eval")},
            "launches_total": launched,
            "lora_matmul_by_shape": shapes.by_shape(shapes.lora),
            "flash_attention_by_shape": shapes.by_shape(shapes.flash),
            "ranks": {t["task"]: t["mean_rank"] for t in rec["tasks"]},
            "active": {t["task"]: t["active"] for t in rec["tasks"]},
            "energy": rec["energy"], "latency": rec["latency"],
            "accuracy": rec["accuracy"],
            "loss_first_last": [float(losses[0]), float(losses[-1])]}
        if engine != "serial":
            groups, want = predicted_launches(sim, plans[-nt:], rec,
                                              launched, per_fwd)
            row.update(groups=[list(g) for g in groups],
                       predicted_launches=want)
        out.append(row)
        state["plans"].append(plans[-nt:])
        state["recs"].append(rec)
        state["merged"].append(server_states(sim))
    launched = counts()
    lora_v, flash_v = variant_counts(), flash_variant_counts()
    # ``plain`` more rounds, no profiler: the plain wall time
    plain_ms, plain_groups = [], []
    for _ in range(plain):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        t0 = time.perf_counter()
        rec = sim.run_round()
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        if engine != "serial":
            groups, _ = predicted_launches(sim, plans[-nt:], rec, {
                k: v - before[k] for k, v in counts().items()}, per_fwd)
            plain_groups.append([list(g) for g in groups])
        if not (np.isfinite(rec["energy"])
                and np.isfinite(rec["accuracy"])):
            fail(f"full-width {method} {engine} unprofiled round: energy "
                 f"or accuracy not finite")
        state["plans"].append(plans[-nt:])
        state["recs"].append(rec)
        state["merged"].append(server_states(sim))
    total = counts()
    if not n_profiled:   # the run's launches are its unprofiled rounds'
        launched = total
        lora_v, flash_v = variant_counts(), flash_variant_counts()
    for name, n in per_fwd.items():
        if (total[name] == 0) != (n == 0):
            fail(f"full-width {cfg.name} {method} {engine} rounds launched "
                 f"{total[name]} {name}, {n} per forward")
    if variant_counts()["simt"] != total["lora_matmul"] or \
            flash_variant_counts()["simt"] != total["flash_attention"]:
        fail(f"full-width {method} {engine} rounds: f32 launches off the "
             f"simt kernels {variant_counts()} {flash_variant_counts()}")
    return {"engine": engine, "method": method,
            "config": f"{cfg.name}, {cfg.num_layers} layers, d "
            f"{cfg.d_model}, {heads_of(cfg)}, f32; SimConfig(method="
            f"{method!r}, engine={engine!r}"
            + "".join(f", {k}={v}" for k, v in (modes or {}).items())
            + ") otherwise default",
            "rounds": out, "launches": launched,
            "lora_matmul_variants": lora_v,
            "flash_attention_variants": flash_v,
            "seconds": time.perf_counter() - t_start,
            "unprofiled_round": {
                "round": n_profiled,
                "wall_ms": plain_ms[0] if plain_ms else None,
                "wall_ms_each": plain_ms, "groups_each": plain_groups,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "energy": rec["energy"], "accuracy": rec["accuracy"]},
            "_state": state}


def global_evals(sim, rec):
    """Tasks that evaluate their global model at the end of a round: it
    exists (under a tier, from the first sync on) and the round kept an
    upload or released one. The kept ones are the contributors (a
    departure loses its upload without §IV-E, an abandoning vehicle with
    it) less the deferred."""
    n = 0
    for srv, t in zip(sim.servers, rec["tasks"]):
        lost = (t["fallbacks"][2] if sim.spec.mobility_aware
                else t["departing"])
        kept = t["active"] - lost - t.get("deferred", 0)
        glob = srv.merged if srv.method == "ours" else srv.global_adapters
        n += glob is not None and (kept > 0 or t.get("released", 0) > 0)
    return n


def predicted_launches(sim, round_plans, rec, launched, per_fwd):
    """A batched round's launches against its groups' prediction: one
    forward per group step, one local eval per group, one global eval
    per task that evaluates (:func:`global_evals`; any loop over
    vehicles would launch more). Returns (groups, predicted
    launches)."""
    groups = round_groups(sim, round_plans)
    fwd = sum(steps + 1 for *_, steps in groups) + global_evals(sim, rec)
    want = {k: n * fwd for k, n in per_fwd.items()}
    if {k: launched[k] for k in want} != want:
        fail(f"full-width {sim.cfg.method} {sim.engine} round "
             f"{len(sim.history) - 1}: launches {launched}, the groups "
             f"{groups} predict {want}")
    return groups, want


def server_states(sim):
    """Each task's server state: the merged deltas of the ``ours``
    family, the global adapters of the baselines."""
    return [srv.merged if srv.method == "ours" else srv.global_adapters
            for srv in sim.servers]


def update_spread(got, want, base, scale):
    """Largest, over the LoRA targets, ||P_got - P_want||_F /
    ||P_want - P_base||_F with P = scale·A·B per layer: the difference of
    two trainings of one lane, over the update the second made. One
    entry whose update took the other sign moves it little; a lane
    trained on other gradients, or for other steps, moves it a lot."""
    worst = 0.0
    for path in tree_paths(want):
        def prod(t):
            ad = tree_get(t, path)
            return scale * torch.einsum("lir,lro->lio", ad["a"].cuda(),
                                        ad["b"].cuda())
        pw = prod(want)
        worst = max(worst, float((prod(got) - pw).norm()
                                 / (pw - prod(base)).norm().clamp_min(
                                     1e-30)))
    return worst


def merged_spread(want_servers, got_merged):
    """Largest, over tasks and merged-delta leaves,
    ||got - want||_F / ||want||_F."""
    worst = 0.0
    for want, got in zip(want_servers, got_merged):
        for path in tree_paths_delta(want):
            w = tree_get(want, path)["delta"]
            g = tree_get(got, path)["delta"]
            worst = max(worst, float((g - w).norm()
                                     / w.norm().clamp_min(1e-30)))
    return worst


def group_budgets_agree():
    """Phase 5b: task 0's first rank group of round 0 at full width, on
    one round's pre-drawn batches and one shared adapter tree, through
    the batched trainer (as the simulator calls it) and, vehicle by
    vehicle, the serial trainer on the card; the serial trainer also on
    the CPU for its first CPU_LANES vehicles.

    Held:
    - one local step's adapter gradients (b drawn off zero, so a's
      gradients are not 0), batched against serial, within ROUND_TOL of
      each leaf's largest entry: the two differ only in summation order;
    - after the full step budgets, every lane's update (see
      :func:`update_spread`), batched against serial on the card, within
      SPREAD_FACTOR times the largest spread of the serial trainer
      between the card and the CPU on the same lanes, read in this call;
      the lanes' last live losses within ROUND_TOL relative;
    - two planted faults of the batched trainer must break the
      gradient or the update gate: the loss as a mean over all V·B rows
      (each lane's gradient scaled by 1/V, so 1 - 1/V off) and a lane
      past its budget left live.

    Adam's first update is close to lr·sign(g), so an entry whose
    gradient is within summation noise of 0 moves by up to 2·lr apart
    on another summation order; the largest entry difference of a merged
    delta is one such entry, the Frobenius spread is not
    (``tools/batched_spread_probe.py`` counts them)."""
    import dataclasses
    from repro_torch.federated import batched_client as bc
    from repro_torch.federated.client import LocalTrainer
    sim = IoVSimulator(SimConfig(method="ours", engine="batched",
                                 train_arch=vit_base_paper.vit_base_paper()),
                       device="cuda")
    sim.mobility.step()
    plan = sim._plan_task(0)
    ids = plan["active_ids"]
    rank = min(int(plan["ranks"][v]) for v in ids)
    idxs = [i for i, v in enumerate(ids) if int(plan["ranks"][v]) == rank]
    steps = [plan["steps_list"][i] for i in idxs]
    # one tree shared by every lane, as every round after the first
    # distributes it (the trainer materialises it per lane)
    ads = [plan["adapters_list"][idxs[0]]] * len(idxs)
    batches = [bc.draw_batches(sim.client_data[0][ids[i]],
                               plan["steps_list"][i], sim.cfg.local_steps)
               for i in idxs]
    evb = sim.local_eval[0]
    V, scale = len(idxs), sim.cfg.lora.scale
    lora_r = dataclasses.replace(sim.cfg.lora, rank=rank)
    if not min(steps) < max(steps):
        fail(f"full width: task 0's rank-{rank} group (budgets {steps}) "
             f"has no departing lane")

    # one step's gradients
    def grads(ad, tok, lab, lanes=None):
        adg = tree_map(lambda t: t.detach().requires_grad_(True), ad)
        loss, _ = T.loss_fn(sim.params, adg, sim.model_cfg, lora_r,
                            {"tokens": tok, "labels": lab}, lanes=lanes)
        return torch.autograd.grad(loss, leaves(adg))
    moved = [nontrivial(ad, 30 + j) for j, ad in enumerate(ads)]
    tok = torch.as_tensor(np.stack([b["tokens"][0] for b in batches]),
                          dtype=torch.int64, device=sim.device)
    lab = torch.as_tensor(np.stack([b["labels"][0] for b in batches]),
                          dtype=torch.int64, device=sim.device)
    g_s = [grads(moved[j], tok[j], lab[j]) for j in range(V)]

    def grad_err():
        g_b = grads(bc.stack_trees(moved), tok.reshape(-1, tok.shape[-1]),
                    lab.reshape(-1), lanes=V)
        return max(maxabs(gb.select(-3, j), gs) / max(float(gs.abs().max()),
                                                      1e-30)
                   for j in range(V) for gb, gs in zip(g_b, g_s[j]))

    def batched():
        stacked, m = sim.batched_trainer.run_jobs(sim.params, [{
            "adapters_list": ads, "batches_list": batches,
            "step_counts": steps, "eval_batch": evb}])[0]
        return bc.unstack_tree(stacked, V), m

    def serial(trainer, params, n_lanes, dev):
        return [trainer.finetune(
            params, to(ad, dev), None, n, eval_batch=evb,
            batches=[{k: a[si] for k, a in b.items()} for si in range(n)])
            for ad, b, n in zip(ads[:n_lanes], batches, steps)]

    def spreads(got, want):
        return [update_spread(g, w, ad, scale)
                for g, w, ad in zip(got, want, ads)]

    def loss_errs(got, want):
        return [abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want)]
    ser = serial(sim.trainer, sim.params, V, "cuda")
    cpu = serial(LocalTrainer(sim.model_cfg, sim.cfg.lora, lr=sim.cfg.lr,
                              device="cpu"), to(sim.params, "cpu"),
                 CPU_LANES, "cpu")
    ser_ads, ser_loss = [a for a, _ in ser], [m["loss"] for _, m in ser]
    card_cpu = spreads(ser_ads[:CPU_LANES], [a for a, _ in cpu])
    card_cpu_loss = loss_errs(ser_loss, [m["loss"] for _, m in cpu])
    limit = SPREAD_FACTOR * max(card_cpu)
    lanes, m = batched()
    out = {"task": sim.tasks[0].name, "rank": rank, "lanes": V,
           "steps": steps, "one_step_grad_rel_err": grad_err(),
           "cpu_lanes": CPU_LANES, "spread_factor": SPREAD_FACTOR,
           "serial_card_vs_cpu_update_spread": card_cpu,
           "serial_card_vs_cpu_loss_rel": card_cpu_loss,
           "update_limit": limit,
           "batched_vs_serial_update_spread": spreads(lanes, ser_ads),
           "batched_vs_serial_loss_rel": loss_errs(
               [float(x) for x in m["loss"]], ser_loss),
           "eval_accuracy_batched": [float(x) for x in m["eval_accuracy"]],
           "eval_accuracy_serial": [s["eval_accuracy"] for _, s in ser]}
    if not out["one_step_grad_rel_err"] < ROUND_TOL:
        fail(f"full width, one local step of {V} lanes: batched vs serial "
             f"gradients {out['one_step_grad_rel_err']} >= {ROUND_TOL}")
    if not (max(out["batched_vs_serial_update_spread"]) <= limit
            and max(out["batched_vs_serial_loss_rel"]) < ROUND_TOL):
        fail(f"full width, {V} lanes at budgets {steps}: batched vs serial "
             f"updates {out['batched_vs_serial_update_spread']} (limit "
             f"{limit}), losses {out['batched_vs_serial_loss_rel']} "
             f"(tol {ROUND_TOL})")

    # planted faults: each must break the gradient or the update gate
    loss_fn, keep = T.loss_fn, bc._keep_frozen

    def mean_over_rows(*a, lanes=None, **kw):
        loss, mt = loss_fn(*a, lanes=lanes, **kw)
        return (loss / lanes if lanes else loss), mt
    planted = {}
    for label, name, fake in (
            ("mean over all V·B rows", "loss_fn", mean_over_rows),
            ("lane past its budget left live", "_keep_frozen",
             lambda live, new, old: new)):
        owner = T if name == "loss_fn" else bc
        setattr(owner, name, fake)
        try:
            got, _ = batched()
            row = {"one_step_grad_rel_err": grad_err(),
                   "update_spread": max(spreads(got, ser_ads))}
        finally:
            T.loss_fn, bc._keep_frozen = loss_fn, keep
        if not (row["one_step_grad_rel_err"] >= ROUND_TOL
                or row["update_spread"] > limit):
            fail(f"full width: planted fault '{label}' passes the gates "
                 f"{row}")
        planted[label] = row
    out["planted_faults"] = planted
    return out, limit


def engines_agree(serial, batched, limit):
    """Phase 5b: the batched rounds against the serial rounds of the same
    seed: active sets and ranks exact in every round both ran, energy and
    latency within 1e-5 relative, and the merged deltas after round 0
    (see :func:`merged_spread`) within ``limit``, the update limit that
    :func:`group_budgets_agree` reads from the serial trainer's
    card-vs-CPU spread. The largest entry difference is recorded."""
    s, b = serial["_state"], batched["_state"]
    n = min(len(s["recs"]), len(b["recs"]))
    rel = {}
    for rnd in range(n):
        if s["plans"][rnd] != b["plans"][rnd]:
            fail(f"full width round {rnd}: batched and serial differ in "
                 f"active sets, ranks or departures")
        for st, bt in zip(s["recs"][rnd]["tasks"], b["recs"][rnd]["tasks"]):
            for key in ("energy", "latency"):
                e = abs(bt[key] - st[key]) / max(abs(st[key]), 1e-12)
                rel[key] = max(rel.get(key, 0.0), e)
    spread = merged_spread(s["merged"][0], b["merged"][0])
    if not max(rel.values()) < 1e-5:
        fail(f"full width batched vs serial: energy/latency {rel}")
    if not spread <= limit:
        fail(f"full width batched vs serial: merged deltas after round 0 "
             f"{spread} > {limit}")
    return {"rounds": n, "energy_rel_err": rel["energy"],
            "latency_rel_err": rel["latency"],
            "merged_delta_spread_round0": spread, "limit": limit,
            "merged_delta_rel_err_round0": merged_rel_err(s["merged"][0],
                                                          b["merged"][0])}


# ---------------------------------------------------------------------------
# Phase 5c: the fused round (CUDA graphs)
# ---------------------------------------------------------------------------

# a replayed fused round against the same round run eagerly on the card:
# the same kernels on the same inputs, so the bits agree; the limit is of
# each merged-delta leaf's largest entry and each record value
REPLAY_TOL = 1e-6


def fused_rounds(n_profiled, method="ours", plain=1, modes=None, arch=None):
    """Phases 5c, 5d and 5e: fused rounds of ``method`` (with ``modes``,
    a tier or semi_sync's SimConfig fields) at the full width of
    vit-base-paper on the card: the first round, which runs the program
    eagerly and then captures it (both timed apart), without the
    profiler (a window over it took 74-79 s of the profiler's own
    processing on an H100 80GB HBM3); then ``n_profiled`` replayed
    rounds, each under a profiler window; then ``plain`` more without
    it. Holds one capture over all rounds and, per profiled round, the
    profiler's kernel records against the launches counted at capture
    (one per LoRA linear and per attention of 15 forwards). Keeps the
    first replay's (round 1's) partials and buffers for
    :func:`replay_gates`. ``arch`` cuts the depth (default: all 12
    layers)."""
    t_start = time.perf_counter()
    sim = IoVSimulator(SimConfig(
        method=method, engine="fused",
        train_arch=arch or vit_base_paper.vit_base_paper(), **(modes or {})),
        device="cuda")
    eng, cfg, nt = sim.fused, sim.model_cfg, sim.cfg.num_tasks
    per_fwd = {k: n for k, n in round_per_fwd(cfg, sim.cfg.lora).items()
               if k != "wkv6"}
    forwards = nt * (sim.cfg.local_steps + 2)
    want = {k: n * forwards for k, n in per_fwd.items()}
    plans = []
    recording(sim, plans)
    first = {}

    def timed(name, fn):
        def run():
            torch.cuda.synchronize()
            before = counts()
            t0 = time.perf_counter()
            if name == "capture":
                with ShapeCounter() as shapes:
                    fn()
                first["lora_matmul_by_shape"] = shapes.by_shape(shapes.lora)
                first["flash_attention_by_shape"] = shapes.by_shape(
                    shapes.flash)
            else:
                fn()
            torch.cuda.synchronize()
            first[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
            first[f"{name}_launches"] = {k: v - before[k]
                                         for k, v in counts().items()}
        return run
    eng._warm_up = timed("warm_up", eng._warm_up)
    eng._capture = timed("capture", eng._capture)
    state = {"plans": [], "recs": [], "merged": [], "ucb": [], "modes": []}
    out = []
    reset_counts()

    def keep(rec):
        state["plans"].append(plans[-nt:])
        state["recs"].append(rec)
        state["merged"].append(server_states(sim))
        state["ucb"].append([tuple(x.clone() for x in st)
                             for st in sim.ucb_states])
        # round 1 is the first replay: its partials and buffer go to the
        # replay gate (round 0 runs eagerly in both runs)
        state["modes"].append(mode_states(sim) if len(state["recs"]) == 2
                              else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = sim.run_round()
    torch.cuda.synchronize()
    first["round_wall_ms"] = (time.perf_counter() - t0) * 1e3
    first["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if not (np.isfinite(rec["energy"]) and np.isfinite(rec["accuracy"])):
        fail(f"full-width {method} fused round 0: energy or accuracy not "
             f"finite")
    keep(rec)
    for rnd in range(1, n_profiled + 1):
        recs = []
        torch.cuda.reset_peak_memory_stats()
        prof = device_profile(lambda: recs.append(sim.run_round()), top=6)
        rec = recs[0]
        if not (np.isfinite(rec["energy"]) and np.isfinite(rec["accuracy"])
                and all(np.isfinite(t["energy"]) and
                        np.isfinite(t["accuracy"]) for t in rec["tasks"])):
            fail(f"full-width {method} fused round {rnd}: an energy or "
                 f"accuracy is not finite")
        ours = prof["port_kernels"]
        replayed = {"lora_matmul": ours.get("lora_mm_kernel", {}).get(
            "count", 0), "flash_attention": ours.get("fa_kernel", {}).get(
            "count", 0)}
        if (replayed != want
                or set(ours) != {"lora_mm_kernel", "fa_kernel"}):
            fail(f"full-width {method} fused round {rnd}: the profiler saw "
                 f"{ours}, {want} predicted, all simt")
        out.append({
            "round": len(state["recs"]), "wall_ms": prof["wall_ms"],
            "device_ms": prof["device_ms"], "busy_share": prof["busy_share"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "kernels_in_trace": prof["kernels"], "port_kernels": ours,
            "top": prof["top"], "profiler_window_s": prof["window_s"],
            "launches_per_run_by_profiler": replayed,
            "ranks": {t["task"]: t["mean_rank"] for t in rec["tasks"]},
            "active": {t["task"]: t["active"] for t in rec["tasks"]},
            "energy": rec["energy"], "latency": rec["latency"],
            "accuracy": rec["accuracy"], "captures": eng.captures})
        keep(rec)
    plain_ms = []
    for _ in range(plain):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = sim.run_round()
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        if not (np.isfinite(rec["energy"])
                and np.isfinite(rec["accuracy"])):
            fail(f"full-width {method} fused round {len(state['recs'])}: "
                 f"energy or accuracy not finite")
        keep(rec)
    launched = counts()
    lora_v, flash_v = variant_counts(), flash_variant_counts()
    if eng.captures != 1:
        fail(f"full-width {method} fused: {eng.captures} captures over "
             f"{len(state['recs'])} rounds")
    caught = {k: first["capture_launches"][k] for k in want}
    if caught != want:
        fail(f"full-width {method} fused: {caught} launches at capture, "
             f"{want} predicted")
    if lora_v["simt"] != launched["lora_matmul"] or \
            flash_v["simt"] != launched["flash_attention"]:
        fail(f"full-width {method} fused rounds: f32 launches off the simt "
             f"kernels {lora_v} {flash_v}")
    return {"engine": "fused", "method": method,
            "config": f"{cfg.name}, {cfg.num_layers} layers, d "
            f"{cfg.d_model}, {cfg.num_heads} heads of "
            f"{cfg.resolved_head_dim}, f32; SimConfig(method={method!r}, "
            f"engine='fused'"
            + "".join(f", {k}={v}" for k, v in (modes or {}).items())
            + ") otherwise default",
            "rounds": out, "launches": launched,
            "lora_matmul_variants": lora_v,
            "flash_attention_variants": flash_v,
            "predicted_launches_per_round": want,
            "captures": eng.captures, "segments": eng.segments,
            "seconds": time.perf_counter() - t_start,
            "first_round": first,
            "unprofiled_round": {
                "round": len(state["recs"]) - 1,
                "wall_ms": plain_ms[-1] if plain_ms else None,
                "wall_ms_each": plain_ms,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "energy": rec["energy"], "accuracy": rec["accuracy"]},
            "_state": state}


def fused_state_diff(got, want, rounds):
    """Largest difference of two fused runs over their first ``rounds``
    rounds: each task's record values relative to their size, each
    merged-delta leaf relative to its largest entry, the UCB-DUAL state
    relative to each leaf's largest entry."""
    worst = 0.0
    for rnd in range(rounds):
        for gt, wt in zip(got["recs"][rnd]["tasks"],
                          want["recs"][rnd]["tasks"]):
            for key in ("accuracy", "energy", "latency", "lambda",
                        "mean_rank", "comm_params", "budget"):
                worst = max(worst, abs(gt[key] - wt[key])
                            / max(abs(wt[key]), 1e-30))
        for g, w in zip(got["merged"][rnd], want["merged"][rnd]):
            for path in tree_paths_delta(w):
                a = tree_get(g, path)["delta"]
                b = tree_get(w, path)["delta"]
                worst = max(worst, maxabs(a, b)
                            / max(float(b.abs().max()), 1e-30))
        for g, w in zip(got["ucb"][rnd], want["ucb"][rnd]):
            for a, b in zip(g, w):
                worst = max(worst, maxabs(a, b)
                            / max(float(b.abs().max()), 1e-30))
        if rnd < len(want["modes"]) and want["modes"][rnd] is not None:
            worst = max(worst, max(mode_state_diff(
                got["modes"][rnd], want["modes"][rnd]).values(),
                default=0.0))
    return worst


def fused_run(arch, rounds, capture=True, fault=False, modes=None,
              params=None):
    """``rounds`` fused rounds from one seed on the card (with ``modes``,
    a tier or semi_sync's SimConfig fields): captured and replayed, or
    (``capture=False``) the same functions run eagerly. ``fault`` plants
    a static input left un-refreshed: after the first round the integer
    inputs (coverage, budgets, batches) stay as they were staged for it.
    Returns the records, merged deltas and UCB-DUAL states of every
    round, and round 1's partials and buffers."""
    kw = {} if arch is None else {"train_arch": arch}
    sim = IoVSimulator(SimConfig(method="ours", engine="fused", **kw,
                                 **(modes or {})),
                       device="cuda", params=params)
    if not capture:
        sim.fused = FusedRoundEngine(sim, capture=False)
    if fault:
        eng, upload, calls = sim.fused, sim.fused._upload, []

        def stale(ints, f32s, fresh):
            if calls:
                ints = eng.int_in.cpu().numpy()
            calls.append(1)
            upload(ints, f32s, fresh)
        eng._upload = stale
    state = {"recs": [], "merged": [], "ucb": [], "modes": []}
    for rnd in range(rounds):
        state["recs"].append(sim.run_round())
        state["merged"].append([srv.merged for srv in sim.servers])
        state["ucb"].append([tuple(x.clone() for x in st)
                             for st in sim.ucb_states])
        state["modes"].append(mode_states(sim) if rnd == 1 else None)
    return state


def replay_gates(full_state, rounds):
    """Phase 5c: a replayed round against the same round run eagerly on
    the card, at full width (the rounds of :func:`fused_rounds`) and at
    the reduced ViT, where a planted fault (an input buffer left as the
    first round staged it) must break the same gate."""
    eager = fused_run(vit_base_paper.vit_base_paper(), rounds,
                      capture=False)
    full = fused_state_diff(full_state, eager, rounds)
    del eager
    small_eager = fused_run(None, rounds, capture=False)
    small = fused_state_diff(fused_run(None, rounds), small_eager, rounds)
    planted = fused_state_diff(fused_run(None, rounds, fault=True),
                               small_eager, rounds)
    if not (full <= REPLAY_TOL and small <= REPLAY_TOL):
        fail(f"fused replay vs eager: full width {full}, reduced {small} "
             f"> {REPLAY_TOL}")
    if not planted > REPLAY_TOL:
        fail(f"planted fault (un-refreshed input) passes the replay gate: "
             f"{planted}")
    return {"rounds": rounds, "tol": REPLAY_TOL, "full_width": full,
            "reduced": small, "planted_unrefreshed_input": planted}


def fused_agrees(fused, batched, serial, limit):
    """Phase 5c: the fused rounds against the batched rounds of the same
    seed (active sets and ranks exact, energy and latency within 1e-5
    relative) and its round-0 merged deltas against the serial engine's,
    as a Frobenius spread within ``limit`` (:func:`group_budgets_agree`);
    the largest entry difference is recorded."""
    f, b, s = fused["_state"], batched["_state"], serial["_state"]
    n = min(len(f["recs"]), len(b["recs"]))
    rel = {}
    for rnd in range(n):
        if f["plans"][rnd] != b["plans"][rnd]:
            fail(f"full width round {rnd}: fused and batched differ in "
                 f"active sets, ranks or departures")
        for ft, bt in zip(f["recs"][rnd]["tasks"], b["recs"][rnd]["tasks"]):
            for key in ("energy", "latency"):
                e = abs(ft[key] - bt[key]) / max(abs(bt[key]), 1e-12)
                rel[key] = max(rel.get(key, 0.0), e)
    spread = merged_spread(s["merged"][0], f["merged"][0])
    if not max(rel.values()) < 1e-5:
        fail(f"full width fused vs batched: energy/latency {rel}")
    if not spread <= limit:
        fail(f"full width fused vs serial: merged deltas after round 0 "
             f"{spread} > {limit}")
    return {"rounds": n, "energy_rel_err": rel["energy"],
            "latency_rel_err": rel["latency"],
            "merged_delta_spread_round0_vs_serial": spread, "limit": limit,
            "merged_delta_rel_err_round0_vs_serial": merged_rel_err(
                s["merged"][0], f["merged"][0])}


# ---------------------------------------------------------------------------
# Phase 5d: the paper's baselines and ablations
# ---------------------------------------------------------------------------

# the methods of this phase (``ours`` runs in 5a-5c) and the ablations,
# which also run under the fused engine
METHODS_5D = ("homolora", "hetlora", "fedra", "ours_no_energy",
              "ours_no_mobility", "ours_residual")
ABLATIONS = ("ours_no_energy", "ours_no_mobility")
# methods whose full-width batched round runs once, unprofiled, launches
# held to its groups: the ours family trains ours' groups (5b profiles
# those), HetLoRA its capability groups (5e profiles them under a tier)
# 5d's and 5e's full-width rounds run at a sixth of vit-base-paper's
# depth (full width, 2 of its 12 layers) and 5f's full-width resume at a
# quarter (DEPTH_5F), to keep the script within 900 s of its 1,200 s
# limit on a slow host, and since PR 24 5f's presets at that quarter
# too (the script took 1,068 s on a slow host with them at 12); 5b and
# 5c run all 12 (at 6, 5b's merged-delta spread limit, twice the
# serial trainer's own card-vs-CPU spread, came out below the spread it
# holds, 0.0014 > 0.0009); 5e (a), the reduced ViT card against the
# CPU, is unchanged
DEPTH_5D = 2
DEPTH_5E = 2
UNPROFILED_5D = ("hetlora", "ours_no_energy", "ours_no_mobility",
                 "ours_residual")
PARITY_ROUNDS = 2
# fused vs batched rounds at full width, energy and latency (relative)
ENGINE_TOL = 1e-5


def state_rel_err(want_states, got_states):
    """Largest |got - want| over each task's server state (merged deltas
    or adapters), relative to that task's largest entry."""
    worst = 0.0
    for want, got in zip(want_states, got_states):
        if (want is None) != (got is None):
            fail("a server state is set on one device only")
        if want is None:
            continue
        err = top = 0.0
        for path in tree_paths_delta(want) or tree_paths(want):
            for k, w in tree_get(want, path).items():
                w = w.cpu()
                err = max(err, maxabs(tree_get(got, path)[k].cpu(), w))
                top = max(top, float(w.abs().max()))
        worst = max(worst, err / max(top, 1e-30))
    return worst


def adopt_state(dst, src):
    """Give the card's simulator ``dst`` what the CPU's ``src`` learned
    in its last round: each server's merged deltas or global adapters,
    the UCB-DUAL states and the allocator (the host streams, mobility,
    channel and data, are equal already), so that the next round starts
    from one state on both devices."""
    for d, s_ in zip(dst.servers, src.servers):
        d.merged, d.global_adapters = (
            None if t is None else to(t, dst.device)
            for t in (s_.merged, s_.global_adapters))
    dst.ucb_states = [ucb_dual.UCBDualState(*(t.clone() for t in st))
                      for st in src.ucb_states]
    dst.alloc = energy_alloc.AllocState(
        budgets=src.alloc.budgets.clone(),
        difficulty=src.alloc.difficulty.clone(), round=src.alloc.round)
    if dst.fused is not None:
        dst.fused.reset_carry()


def product_rel_err(want, got):
    """Largest |A·B| difference over two adapter trees, relative to the
    largest entry of want's A·B."""
    err = top = 0.0
    for path in tree_paths(want):
        w, g = tree_get(want, path), tree_get(got, path)
        pw = w["a"].float().cuda() @ w["b"].float().cuda()
        err = max(err, maxabs(g["a"].float().cuda() @ g["b"].float().cuda(),
                              pw))
        top = max(top, float(pw.abs().max()))
    return err / max(top, 1e-30)


def share_distribution(card, cpu):
    """For the next round of the ``ours`` family: hand the card's servers
    (serial, batched) or fused engine the SVD redistribution the CPU
    computes from the same merged deltas, so that the round trains from
    one set of adapters on both devices. The two devices' SVDs differ in
    summation order, and a round of Adam from their factors parts the
    merged deltas by 1.1e-4 to 5.4e-4 of their largest entry (H100 80GB
    HBM3 against the CPU). Returns a list that receives the largest product
    difference of the card's own distribution against the CPU's."""
    errs = []
    if cpu.fused is not None:
        c_svd = cpu.fused.dist_svd
        dist_svd = card.fused._dist_svd

        def from_cpu():
            dist_svd()
            with torch.no_grad():
                for mine, theirs in zip(card.fused.dist_svd, c_svd):
                    _copy_tree(mine, theirs)
        card.fused._dist_svd = from_cpu
        return errs
    for c_srv, srv in zip(cpu.servers, card.servers):
        if srv.method != "ours":
            continue
        c_dist, dist = c_srv.distribute, srv.distribute

        def cpu_side(ranks, c_dist=c_dist, srv=srv):
            out = c_dist(ranks)
            moved = {}
            srv.shared = [moved.setdefault(id(t), to(t, "cuda"))
                          for t in out]
            return out

        def card_side(ranks, dist=dist, srv=srv):
            own = dist(ranks)
            errs.extend(product_rel_err(w, g)
                        for w, g in zip(srv.shared, own))
            srv._distributed = srv.shared
            return srv.shared
        c_srv.distribute, srv.distribute = cpu_side, card_side
    return errs


def method_parity(method, engine):
    """Phase 5d (a): PARITY_ROUNDS rounds of ``method`` under ``engine``
    at the reduced ViT with the default SimConfig, from one seed, on the
    CPU and on the card. Every round after the first starts on the card
    from the CPU's state (:func:`adopt_state`) and, for the ``ours``
    family, trains from the CPU's SVD redistribution of it
    (:func:`share_distribution`): two runs 1e-5 apart after a round part
    by 1e-4 to 1e-2 after the next (ROADMAP, "What one round can be held
    to"), so every round is held from one state. Held: active sets,
    ranks and departures, and per round and task the active and
    departing counts, fallbacks, comm_params and mean rank exactly;
    energy, latency and the servers' states (merged deltas or global
    adapters, after every round) within ROUND_TOL. The card's own
    redistribution against the CPU's is recorded."""
    sims, plans, recs, states = {}, {}, {}, {}
    ms = {"cuda": 0.0, "cpu": 0.0}
    for dev in ("cuda", "cpu"):
        sims[dev] = IoVSimulator(SimConfig(method=method, engine=engine),
                                 device=dev)
        plans[dev], recs[dev], states[dev] = [], [], []
        recording(sims[dev], plans[dev])
    reset_counts()
    dist_errs = []
    for rnd in range(PARITY_ROUNDS):
        if rnd:
            adopt_state(sims["cuda"], sims["cpu"])
            dist_errs = share_distribution(sims["cuda"], sims["cpu"])
        for dev in ("cpu", "cuda"):
            t0 = time.perf_counter()
            recs[dev].append(sims[dev].run_round())
            states[dev].append(server_states(sims[dev]))
            if dev == "cuda":
                torch.cuda.synchronize()
            ms[dev] += (time.perf_counter() - t0) * 1e3
    launched = counts()
    what = f"5d {method} {engine}"
    if launched["lora_matmul"] == 0 or launched["flash_attention"] == 0:
        fail(f"{what}: the card's rounds launched {launched}")
    if plans["cuda"] != plans["cpu"]:
        fail(f"{what} card vs CPU: active sets, ranks or departures differ")
    rel = {"energy": 0.0, "latency": 0.0}
    for gr, cr in zip(recs["cuda"], recs["cpu"]):
        for gt, ct in zip(gr["tasks"], cr["tasks"]):
            for key in ("active", "departing", "fallbacks", "comm_params",
                        "mean_rank"):
                if gt[key] != ct[key]:
                    fail(f"{what} card vs CPU: round {gr['round']} task "
                         f"{gt['task']} {key} {gt[key]} vs {ct[key]}")
            for key in rel:
                rel[key] = max(rel[key], abs(gt[key] - ct[key])
                               / max(abs(ct[key]), 1e-12))
    state = [state_rel_err(c, g) for c, g in zip(states["cpu"],
                                                 states["cuda"])]
    if not (max(state) < ROUND_TOL and max(rel.values()) < ROUND_TOL):
        fail(f"{what} card vs CPU: server states {state}, {rel}")
    cpu_recs = recs["cpu"]
    return {
        "method": method, "engine": engine, "rounds": PARITY_ROUNDS,
        "tol": ROUND_TOL, "state_rel_err_by_round": state,
        "energy_rel_err": rel["energy"], "latency_rel_err": rel["latency"],
        "card_own_distribution_rel_err": max(dist_errs, default=None),
        "ranks": sorted({r for _, _, rs, _ in plans["cpu"] for r in rs}),
        "fallbacks": [[t["fallbacks"] for t in r["tasks"]]
                      for r in cpu_recs],
        "comm_params": [[t["comm_params"] for t in r["tasks"]]
                        for r in cpu_recs],
        "accuracy_card": [r["accuracy"] for r in recs["cuda"]],
        "accuracy_cpu": [r["accuracy"] for r in cpu_recs],
        "card_ms": ms["cuda"], "cpu_ms": ms["cpu"], "launches": launched,
        "captures": (sims["cuda"].fused.captures
                     if sims["cuda"].fused is not None else None)}


def check_round(method, engine):
    """Phase 5d: one ``batched_check`` or ``fused_check`` round of
    ``method`` at the reduced ViT on the card, the serial trainer
    replayed on the engine's batches from each lane's given adapters.
    ``engine_check_dev``, the largest entry of any lane's difference, is
    recorded: Adam's first update lr·g/(|g| + 1e-8) turns a gradient
    within summation noise of 1e-8 into a difference of a good part of
    lr, whichever engine is right (``tools/
    batched_spread_probe.py``). Held instead, as in 5b: every lane's
    update spread (:func:`update_spread`) between the engine and the
    serial replay on the card within SPREAD_FACTOR times the largest
    spread of the serial trainer between the card and the CPU on the
    same lanes, read in this call; a planted fault (one lane's replay
    one step short) must break it."""
    sim = IoVSimulator(SimConfig(method=method, engine=engine),
                       device="cuda")
    calls, got = [], []
    finetune = sim.trainer.finetune

    def replay(params, adapters, dataset, steps, **kw):
        out = finetune(params, adapters, dataset, steps, **kw)
        calls.append((adapters, steps, kw, out[0]))
        return out
    sim.trainer.finetune = replay
    if sim.fused is not None:
        run_check = sim.fused._run_check

        def lanes_of(x, mid):
            for t in range(sim.cfg.num_tasks):
                ranks = mid["ranks"][t].cpu().numpy()
                for v in np.where(x["active"][t])[0]:
                    got.append(truncate_adapter_tree(tree_map(
                        lambda a: a.select(-3, int(v)), mid["new"][t]),
                        int(ranks[v])))
            return run_check(x, mid)
        sim.fused._run_check = lanes_of
    else:
        check = sim._check_against_serial

        def lanes_of(plans, results):
            for plan, res in zip(plans, results):
                lanes = {i: (st, j) for st, idxs in res["groups"].values()
                         for j, i in enumerate(idxs)}
                for i in range(len(plan["active_ids"])):
                    st, j = lanes[i]
                    got.append(tree_map(lambda a: a.select(-3, j), st))
            return check(plans, results)
        sim._check_against_serial = lanes_of
    sim.run_round()
    if len(got) != len(calls) or not calls:
        fail(f"{method} {engine}: {len(got)} lanes, {len(calls)} replays")
    cpu = LocalTrainer(sim.model_cfg, sim.cfg.lora, lr=sim.cfg.lr,
                       device="cpu")
    params_cpu = tree_map(lambda t: t.cpu(), sim.params)
    engine_spread, card_cpu = [], []
    for (given, steps, kw, serial), lane in zip(calls, got):
        engine_spread.append(update_spread(lane, serial, given, 1.0))
        ref, _ = cpu.finetune(params_cpu, tree_map(lambda t: t.cpu(), given),
                              None, steps, batches=kw["batches"],
                              layer_mask=kw.get("layer_mask"))
        card_cpu.append(update_spread(serial, ref, given, 1.0))
    limit = SPREAD_FACTOR * max(card_cpu)
    given, steps, kw, serial = next(c for c in calls if c[1] > 1)
    short, _ = finetune(sim.params, given, None, steps - 1,
                        batches=kw["batches"][:steps - 1],
                        layer_mask=kw.get("layer_mask"))
    planted = update_spread(short, serial, given, 1.0)
    if not max(engine_spread) <= limit:
        fail(f"{method} {engine} on the card: update spread "
             f"{max(engine_spread)} > {limit}")
    if not planted > limit:
        fail(f"{method} {engine}: a replay one step short passes the "
             f"update-spread gate ({planted} <= {limit})")
    return {"engine_check_dev": sim.engine_check_dev, "lanes": len(calls),
            "update_spread": max(engine_spread),
            "serial_card_vs_cpu_spread": max(card_cpu), "limit": limit,
            "planted_one_step_short": planted}


def fedra_spy(box):
    """A full_rounds hook: keep the inputs and the trained lanes of the
    first group the batched trainer runs (FedRA: one rank-8 group per
    task, every lane given the same tree and its own layer mask)."""
    def hook(sim):
        trainer = sim.batched_trainer
        run_group = trainer._run_group

        def spy(params, adapters_list, batches_list, step_counts,
                eval_batch=None, layer_masks=None):
            out = run_group(params, adapters_list, batches_list,
                            step_counts, eval_batch=eval_batch,
                            layer_masks=layer_masks)
            if not box:
                box.update(trainer=trainer, run_group=run_group,
                           params=params, given=list(adapters_list),
                           batches=batches_list, steps=list(step_counts),
                           masks=[np.asarray(m, np.float32)
                                  for m in layer_masks], trained=out[0])
            return out
        trainer._run_group = spy
    return hook


def masked_layers_kept(given, stacked, masks):
    """Per lane: whether every leaf of the lane equals, bit for bit, the
    tree the lane was given on the layers its mask leaves out."""
    kept = []
    for v, (tree, m) in enumerate(zip(given, masks)):
        off = torch.as_tensor(np.asarray(m) == 0)
        same = True
        for path in tree_paths(tree):
            for k in ("a", "b"):
                g = tree_get(tree, path)[k]
                t = tree_get(stacked, path)[k].select(-3, v)
                same = same and torch.equal(t[off.to(t.device)],
                                            g[off.to(g.device)])
        kept.append(bool(same))
    return kept


def fedra_gate(box):
    """Phase 5d (b), FedRA at full width on the card: after local
    training every lane's adapter on the layers its mask leaves out is
    bit-identical to the adapter it was given (masked gradients are
    exactly 0, so Adam's update is exactly 0), and on every trained
    layer it moved. A planted fault must break the gate: a copy of the
    lanes trained without the mask on the gradients, the mask applied
    to the adapters after the optimizer's steps instead."""
    given, masks = box["given"], box["masks"]
    kept = masked_layers_kept(given, box["trained"], masks)
    moved = [not k for k in masked_layers_kept(
        given, box["trained"], [1.0 - m for m in masks])]
    if not (all(kept) and all(moved)):
        fail(f"FedRA masked layers at full width: kept {kept}, trained "
             f"layers moved {moved}")
    fault, _ = box["run_group"](box["params"], given, box["batches"],
                                box["steps"], layer_masks=None)
    m = torch.as_tensor(np.stack(masks))          # (V, L)
    fault = tree_map(lambda x: x * m.t().to(x.device).reshape(
        m.shape[1], m.shape[0], 1, 1), fault)
    planted = masked_layers_kept(given, fault, masks)
    if any(planted):
        fail(f"planted fault (mask after the optimizer step) passes the "
             f"FedRA gate: {planted}")
    return {"lanes": len(given), "layers": int(masks[0].shape[0]),
            "trained_layers_per_lane": [int(x.sum()) for x in masks],
            "steps": box["steps"], "left_out_layers_exact": kept,
            "trained_layers_moved": moved,
            "planted_mask_after_step_exact": planted}


def fused_vs_batched(fused, batched):
    """Phase 5d (b): an ablation's fused rounds against its batched
    rounds of the same seed: active sets, ranks and departures exactly,
    energy and latency within ENGINE_TOL relative."""
    f, b = fused["_state"], batched["_state"]
    n = min(len(f["recs"]), len(b["recs"]))
    rel = {"energy": 0.0, "latency": 0.0}
    for rnd in range(n):
        if f["plans"][rnd] != b["plans"][rnd]:
            fail(f"5d {fused['method']} round {rnd}: fused and batched "
                 f"differ in active sets, ranks or departures")
        for ft, bt in zip(f["recs"][rnd]["tasks"], b["recs"][rnd]["tasks"]):
            for key in rel:
                rel[key] = max(rel[key], abs(ft[key] - bt[key])
                               / max(abs(bt[key]), 1e-12))
    if not max(rel.values()) < ENGINE_TOL:
        fail(f"5d {fused['method']} fused vs batched: {rel}")
    return {"rounds": n, "energy_rel_err": rel["energy"],
            "latency_rel_err": rel["latency"], "tol": ENGINE_TOL}


def phase_5d():
    """Phase 5d: (a) card vs CPU at the reduced ViT, every method of
    METHODS_5D under serial and batched (with batched_check on the
    card), the ablations also under fused (fused_check on the card);
    (b) full width at DEPTH_5D layers: each method's batched rounds (the
    first profiled, but for UNPROFILED_5D's one unprofiled round),
    FedRA's masked-layer gate, the ablations' fused rounds (a capture,
    then a replayed round) against their batched rounds. Each path is
    driven with the counts set to 0 just before it and read just after
    (inside method_parity, full_rounds and fused_rounds)."""
    t0 = time.perf_counter()
    parity, check = {}, {}
    for m in METHODS_5D:
        for engine in ("serial", "batched") + (
                ("fused",) if m in ABLATIONS else ()):
            parity[f"{m} {engine}"] = method_parity(m, engine)
        for engine in ("batched_check",) + (
                ("fused_check",) if m in ABLATIONS else ()):
            check[f"{m} {engine}"] = check_round(m, engine)
    parity_s = time.perf_counter() - t0
    box = {}
    arch = vit_base_paper.vit_base_paper().with_overrides(
        num_layers=DEPTH_5D)
    batched = {m: full_rounds("batched", 0 if m in UNPROFILED_5D else 1,
                              method=m, arch=arch,
                              hook=fedra_spy(box) if m == "fedra" else None)
               for m in METHODS_5D}
    fedra = fedra_gate(box)
    box.clear()
    for run in batched.values():
        run["_state"].pop("merged")
    torch.cuda.empty_cache()
    fused = {m: fused_rounds(1, method=m, plain=0, arch=arch)
             for m in ABLATIONS}
    agree = {m: fused_vs_batched(fused[m], batched[m]) for m in ABLATIONS}
    for run in list(batched.values()) + list(fused.values()):
        run.pop("_state")
    torch.cuda.empty_cache()
    return {"parity": parity, "engine_check_dev": check,
            "parity_s": parity_s, "batched": batched,
            "fedra_gate": fedra, "fused": fused, "fused_vs_batched": agree,
            "seconds": time.perf_counter() - t0}


def print_5d(p5d):
    """Phase 5d's lines."""
    for name, p in p5d["parity"].items():
        print(f"[5d] {name}, reduced ViT, default SimConfig, card vs CPU "
              f"over {p['rounds']} rounds (round 1 from the CPU's state): "
              f"ranks {p['ranks']}, active sets, fallbacks "
              f"{p['fallbacks']} and comm_params equal; server state rel "
              f"{', '.join(f'{x:.3g}' for x in p['state_rel_err_by_round'])}"
              f", energy rel {p['energy_rel_err']:.3g}, latency rel "
              f"{p['latency_rel_err']:.3g} (tol {p['tol']})"
              + ("" if p["card_own_distribution_rel_err"] is None else
                 f"; the card's own round-1 SVD redistribution vs the CPU's"
                 f" {p['card_own_distribution_rel_err']:.3g} (recorded)")
              + "; accuracy "
              f"card {p['accuracy_card'][-1]:.4f}, CPU "
              f"{p['accuracy_cpu'][-1]:.4f}; {p['card_ms']:.0f} ms on the "
              f"card, {p['cpu_ms']:.0f} ms on the CPU; launches "
              f"{p['launches']}", flush=True)
    for name, c_ in p5d["engine_check_dev"].items():
        print(f"[5d] {name}, one round on the card: engine_check_dev "
              f"{c_['engine_check_dev']:.3g} (largest entry, recorded); "
              f"update spread vs the serial replay over {c_['lanes']} lanes "
              f"{c_['update_spread']:.3g}, limit {c_['limit']:.3g} "
              f"({SPREAD_FACTOR}x the serial trainer's card-vs-CPU spread "
              f"{c_['serial_card_vs_cpu_spread']:.3g}); planted fault (a "
              f"replay one step short) {c_['planted_one_step_short']:.3g}, "
              f"fails the gate", flush=True)
    print(f"[5d] card vs CPU and the check rounds took "
          f"{p5d['parity_s']:.1f} s", flush=True)
    for m, run in p5d["batched"].items():
        for rd in run["rounds"]:
            print(f"[5d] {m} batched at full width, round {rd['round']}: "
                  f"wall {rd['wall_ms']:.1f} ms (profiled), device "
                  f"{rd['device_ms']:.1f} ms, busy {rd['busy_share']:.3f}, "
                  f"peak memory {rd['peak_memory_bytes'] / 2**30:.2f} GiB; "
                  f"{rd['train_steps']} group steps, {rd['evals']} evals, "
                  f"launches {rd['launches_total']} = predicted "
                  f"{rd['predicted_launches']}; {len(rd['groups'])} groups "
                  f"(task, rank, lanes, steps) {rd['groups']}; mean ranks "
                  f"{rd['ranks']}; energy {rd['energy']:.2f} J, accuracy "
                  f"{rd['accuracy']:.4f}; port kernels: "
                  + "; ".join(f"{k} {t['ms']:.2f} ms x{t['count']}"
                              for k, t in rd["port_kernels"].items())
                  + "; top: " + "; ".join(
                      f"{t['kernel'][:40]} {t['ms']:.2f} ms x{t['count']}"
                      for t in rd["top"][:4]), flush=True)
        up = run["unprofiled_round"]
        window = (f" (profiler window "
                  f"{run['rounds'][0]['profiler_window_s']:.1f} s)"
                  if run["rounds"] else " (not profiled: 5b profiles ours' "
                  "groups; a window over HetLoRA's small groups costs ~50 s)")
        print(f"[5d] {m} batched round {up['round']} without the profiler: "
              f"wall {up['wall_ms']:.1f} ms, peak memory "
              f"{up['peak_memory_bytes'] / 2**30:.2f} GiB, launches "
              f"{run['launches']} equal to its groups' "
              f"prediction; {run['seconds']:.1f} s in all{window}",
              flush=True)
    g = p5d["fedra_gate"]
    print(f"[5d] FedRA at full width, task 0's group of round 0 ({g['lanes']}"
          f" lanes, {g['layers']} layers, trained layers per lane "
          f"{g['trained_layers_per_lane']}): left-out layers bit-identical "
          f"to the given adapter in every lane, trained layers moved; "
          f"planted fault (mask applied after the optimizer step): exact "
          f"in {sum(g['planted_mask_after_step_exact'])} of {g['lanes']} "
          f"lanes, fails the gate", flush=True)
    for m, run in p5d["fused"].items():
        fr = run["first_round"]
        print(f"[5d] {m} fused at full width: round 0 (unprofiled) wall "
              f"{fr['round_wall_ms']:.1f} ms: the round run eagerly "
              f"{fr['warm_up_ms']:.1f} ms, then the capture "
              f"{fr['capture_ms']:.1f} ms; peak memory "
              f"{fr['peak_memory_bytes'] / 2**30:.2f} GiB; captures "
              f"{run['captures']}; {run['seconds']:.1f} s in all", flush=True)
        for rd in run["rounds"]:
            print(f"[5d] {m} fused round {rd['round']} wall "
                  f"{rd['wall_ms']:.1f} ms (profiled, a replay), device "
                  f"{rd['device_ms']:.1f} ms,"
                  f" busy {rd['busy_share']:.3f}, peak memory "
                  f"{rd['peak_memory_bytes'] / 2**30:.2f} GiB; records per "
                  f"run {rd['launches_per_run_by_profiler']}, all simt; "
                  f"energy {rd['energy']:.2f} J, accuracy "
                  f"{rd['accuracy']:.4f}", flush=True)
        a = p5d["fused_vs_batched"][m]
        print(f"[5d] {m} fused vs batched at full width over {a['rounds']} "
              f"rounds: ranks and active sets equal, energy rel "
              f"{a['energy_rel_err']:.3g}, latency rel "
              f"{a['latency_rel_err']:.3g} (tol {a['tol']})", flush=True)
    print(f"[5d] phase 5d took {p5d['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 5e: the round's modes (multi-RSU tiers, semi-sync participation)
# ---------------------------------------------------------------------------

# the reference's dense-rsu tier on the default synthetic map; semi_sync
# with its defaults and the shape of the reference's rsu-outage preset
# (task 0's RSU dark in round 1, task 1's in round 2), so that uploads
# defer and come back
MODES_5E = {
    "tier": {"rsu_tier": RSUTierSpec(
        num_rsus_per_task=3, sync_period=2, staleness_decay=0.7,
        handoff_energy=6.0, handoff_latency=0.4)},
    "semi": {"participation": ParticipationSpec(mode="semi_sync"),
             "mobility_sim": MobilitySimConfig(outages=(
                 OutageSpec(rsu_id=0, start=1, end=2),
                 OutageSpec(rsu_id=1, start=2, end=3)))}}
MODES_5E["tier+semi"] = {**MODES_5E["tier"], **MODES_5E["semi"]}
MODE_ROUNDS = 4
# the reduced ViT's runs (the default SimConfig's three local steps): at
# this seed a sync merges two or more live partials of a task, handoffs
# are charged, uploads defer and come back, and under tier+semi one comes
# back under another RSU of its task in round 1 (the destination fault
# below moves it)
MODE_SEED, MODE_STEPS = 2, 3
# 5e (a)'s limit on the trained state's card-vs-CPU Frobenius spread:
# sound runs at three local steps read up to 1.2e-04 (partials of one to
# three uploads), the planted faults 0.14 (discount) and 1.5 (release
# destination) on an H100 80GB HBM3 at 700 W (PERF.md, Findings)
MODE_FRO_LIMIT = 5e-4
PARITY_5E = (("tier", "ours", "serial"), ("tier", "ours", "batched"),
             ("tier", "ours", "fused"), ("tier", "hetlora", "serial"),
             ("tier", "hetlora", "batched"), ("semi", "ours", "serial"),
             ("semi", "ours", "batched"), ("semi", "ours", "fused"),
             ("tier+semi", "ours", "fused"))
COUNT_KEYS_5E = ("active", "departing", "handoffs", "fallbacks",
                 "comm_params", "mean_rank", "deferred", "released")


def mode_states(sim):
    """Each task's tier and buffer state: the partials (trees, or None
    for a segment that never had an upload) with their weights and ages,
    the in-flight buffer (vehicle → delta, weight, age, destination)."""
    return [{"partials": (None if srv.partials is None
                          else list(srv.partials)),
             "partial_w": np.asarray(srv.partial_w, np.float64).copy(),
             "partial_age": np.asarray(srv.partial_age).copy(),
             "buffer": {v: dict(e) for v, e in srv.buffer.items()}}
            for srv in sim.servers]


def _tree_rel(got, want):
    """Two trees against each other: the largest |got - want| relative to
    want's largest entry, and ||got - want||_F / ||want||_F over all
    leaves. None against a zero tree (a segment the host never
    refreshed, the fused carry's zeros) counts as equal."""
    if got is None and want is None:
        return 0.0, 0.0
    if got is None or want is None:
        t = got if want is None else want
        zero = all(float(x.abs().max()) == 0.0 for x in leaves(t))
        return (0.0, 0.0) if zero else (float("inf"), float("inf"))
    err = top = d2 = w2 = 0.0
    for g, w in zip(leaves(got), leaves(want)):
        g, w = g.cpu().double(), w.cpu().double()
        err = max(err, float((g - w).abs().max()))
        top = max(top, float(w.abs().max()))
        d2 += float(((g - w) ** 2).sum())
        w2 += float((w ** 2).sum())
    return err / max(top, 1e-30), (d2 / max(w2, 1e-60)) ** 0.5


def mode_state_diff(got, want):
    """One simulator's tier and buffer state against another's, per part:
    relative errors, and inf where an exact part (ages, which partials
    are live, the buffer's vehicles, ages and destinations) differs."""
    out = {"partials": 0.0, "partials_fro": 0.0, "partial_w": 0.0,
           "buffer": 0.0, "buffer_fro": 0.0, "buffer_w": 0.0, "exact": 0.0}
    for g, w in zip(got, want):
        if (g["partials"] is None) != (w["partials"] is None):
            out["exact"] = float("inf")
            continue
        for gp, wp in zip(g["partials"] or [], w["partials"] or []):
            e, f = _tree_rel(gp, wp)
            out["partials"] = max(out["partials"], e)
            out["partials_fro"] = max(out["partials_fro"], f)
        out["partial_w"] = max(out["partial_w"], float(np.max(
            np.abs(g["partial_w"] - w["partial_w"])
            / np.maximum(np.abs(w["partial_w"]), 1e-12), initial=0.0)))
        same = (np.array_equal(np.asarray(g["partial_age"], np.int64),
                               np.asarray(w["partial_age"], np.int64))
                and np.array_equal(g["partial_w"] > 0, w["partial_w"] > 0)
                and sorted(g["buffer"]) == sorted(w["buffer"])
                and all((g["buffer"][v]["age"], g["buffer"][v]["dest"])
                        == (e["age"], e["dest"])
                        for v, e in w["buffer"].items()))
        if not same:
            out["exact"] = float("inf")
            continue
        for v, e in w["buffer"].items():
            err, fro = _tree_rel(g["buffer"][v]["delta"], e["delta"])
            out["buffer"] = max(out["buffer"], err)
            out["buffer_fro"] = max(out["buffer_fro"], fro)
            out["buffer_w"] = max(out["buffer_w"], abs(
                g["buffer"][v]["w"] - e["w"]) / e["w"])
    return out


def adopt_mode_state(dst, src):
    """:func:`adopt_state`, the tier's partials and semi_sync's buffer
    too: the card's round starts from the CPU's state."""
    for d, s_ in zip(dst.servers, src.servers):
        d.partials = (None if s_.partials is None else
                      [None if p is None else to(p, dst.device)
                       for p in s_.partials])
        d.partial_w = s_.partial_w.copy()
        d.partial_age = s_.partial_age.copy()
        d.buffer = {v: dict(e, delta=to(e["delta"], dst.device))
                    for v, e in s_.buffer.items()}
    adopt_state(dst, src)


def mode_parity(mode, method, engine, limit, rounds=MODE_ROUNDS,
                fault=None):
    """Phase 5e (a): ``rounds`` rounds of ``method`` under ``engine`` with
    ``mode``'s tier or participation at the reduced ViT with the default
    SimConfig (seed MODE_SEED, MODE_STEPS local steps), on the CPU and
    on the card; every round
    after the first starts on the card from the CPU's state
    (:func:`adopt_mode_state`) and, for ``ours``, trains from the CPU's
    SVD redistribution of it (:func:`share_distribution`). ``fault(sim)``
    plants a fault on the card's side. Returns the gates' readings, per
    round, and the violations: active sets, ranks and departures, and
    per round and task the active, departing, handoff, deferred and
    released counts, fallbacks, comm_params and mean rank exactly,
    whether a task has a global model, which partials are live, their
    ages, the buffer's vehicles, ages and destinations exactly; energy,
    latency, release weights and the partials' and buffered uploads'
    weights within ROUND_TOL; the trained state (the global states, the
    partials, the buffered deltas) as a Frobenius spread ||card -
    CPU||_F / ||CPU||_F within ``limit`` (MODE_FRO_LIMIT), with the
    largest entry difference recorded: a partial or a buffered delta
    holds one to three vehicles' updates, whose entries on near-zero
    gradients Adam's first step moves by up to 2·lr apart on the two
    devices (5b), so the largest entry parts by up to ~2e-3 where a
    many-vehicle merge parts by ~5e-5 (PERF.md, Findings). Also counts what
    the run exercised: syncs that merge two or more live partials,
    handoffs, deferred and released uploads."""
    sims, plans, recs = {}, {}, {}
    ms = {"cuda": 0.0, "cpu": 0.0}
    for dev in ("cuda", "cpu"):
        sims[dev] = IoVSimulator(SimConfig(method=method, engine=engine,
                                           seed=MODE_SEED,
                                           local_steps=MODE_STEPS,
                                           **MODES_5E[mode]), device=dev)
        plans[dev], recs[dev] = [], []
        recording(sims[dev], plans[dev])
    if fault is not None:
        fault(sims["cuda"])
    reset_counts()
    what = f"5e {mode} {method} {engine}" + (" (planted)" if fault else "")
    bad, worst, by_round = [], {}, []
    events = {"syncs_of_2_or_more": 0, "handoffs": 0, "deferred": 0,
              "released": 0}
    tier = sims["cpu"].cfg.rsu_tier
    before = mode_states(sims["cpu"])
    for rnd in range(rounds):
        if rnd:
            adopt_mode_state(sims["cuda"], sims["cpu"])
            if rnd == 1:
                share_distribution(sims["cuda"], sims["cpu"])
        for dev in ("cpu", "cuda"):
            t0 = time.perf_counter()
            recs[dev].append(sims[dev].run_round())
            if dev == "cuda":
                torch.cuda.synchronize()
            ms[dev] += (time.perf_counter() - t0) * 1e3
        gr, cr = recs["cuda"][-1], recs["cpu"][-1]
        row = {"energy": 0.0, "latency": 0.0, "rel_weight": 0.0,
               "state": 0.0, "state_fro": 0.0}
        for gt, ct in zip(gr["tasks"], cr["tasks"]):
            for key in COUNT_KEYS_5E:
                if gt.get(key) != ct.get(key):
                    bad.append(f"round {rnd} task {gt['task']} {key} "
                               f"{gt.get(key)} vs {ct.get(key)}")
            for key in ("energy", "latency", "rel_weight"):
                if key in ct:
                    row[key] = max(row[key], abs(gt[key] - ct[key])
                                   / max(abs(ct[key]), 1e-12))
            events["handoffs"] += ct["handoffs"] if not tier.trivial else 0
            events["deferred"] += ct.get("deferred", 0)
            events["released"] += ct.get("released", 0)
        g_states, c_states = server_states(sims["cuda"]), server_states(
            sims["cpu"])
        if [s is None for s in g_states] != [s is None for s in c_states]:
            bad.append(f"round {rnd}: has a global model "
                       f"{[s is not None for s in g_states]} vs "
                       f"{[s is not None for s in c_states]}")
        else:
            for g, c_ in zip(g_states, c_states):
                e, f = _tree_rel(g, c_)
                row["state"] = max(row["state"], e)
                row["state_fro"] = max(row["state_fro"], f)
        after = mode_states(sims["cpu"])
        diff = mode_state_diff(mode_states(sims["cuda"]), after)
        if diff.pop("exact"):
            bad.append(f"round {rnd}: live partials, ages or the buffer's "
                       f"vehicles, ages or destinations differ")
        row.update(diff)
        by_round.append(row)
        for k, v in row.items():
            worst[k] = max(worst.get(k, 0.0), v)
        if not tier.trivial and (rnd + 1) % tier.sync_period == 0:
            live = max(int(np.sum(b["partial_w"] > 0)) for b in before)
            events["syncs_of_2_or_more"] += live >= 2
        before = after
    if plans["cuda"] != plans["cpu"]:
        bad.append("active sets, ranks or departures differ")
    held = {**{k: ROUND_TOL for k in ("energy", "latency", "rel_weight",
                                      "partial_w", "buffer_w")},
            **{k: limit for k in ("state_fro", "partials_fro",
                                  "buffer_fro")}}
    over = {k: worst.get(k, 0.0) for k, tol in held.items()
            if not worst.get(k, 0.0) <= tol}
    if over:
        bad.append(f"over their limits {held}: {over}")
    launched = counts()
    if not fault and (launched["lora_matmul"] == 0
                      or launched["flash_attention"] == 0):
        fail(f"{what}: the card's rounds launched {launched}")
    return {"mode": mode, "method": method, "engine": engine,
            "rounds": rounds, "tol": ROUND_TOL, "limit": limit,
            "worst": worst,
            "by_round": by_round, "violations": bad, "events": events,
            "ranks": sorted({r for _, _, rs, _ in plans["cpu"] for r in rs}),
            "deferred": [[t.get("deferred", 0) for t in r["tasks"]]
                         for r in recs["cpu"]],
            "released": [[t.get("released", 0) for t in r["tasks"]]
                         for r in recs["cpu"]],
            "handoffs": [[t["handoffs"] for t in r["tasks"]]
                         for r in recs["cpu"]],
            "accuracy_card": [r["accuracy"] for r in recs["cuda"]],
            "accuracy_cpu": [r["accuracy"] for r in recs["cpu"]],
            "card_ms": ms["cuda"], "cpu_ms": ms["cpu"], "launches": launched,
            "captures": (sims["cuda"].fused.captures
                         if sims["cuda"].fused is not None else None)}


def stale_discount(sim):
    """Planted fault: the card's staleness discounts one round too old
    (decay**(age + 1)), in every round the card runs."""
    real, run_round = agg.staleness_weights, sim.run_round

    def older(ages, decay):
        return real(torch.as_tensor(ages, dtype=torch.float32) + 1.0, decay)

    def rr():
        agg.staleness_weights = older
        try:
            return run_round()
        finally:
            agg.staleness_weights = real
    sim.run_round = rr


def trained_rsu(sim):
    """Planted fault: on the card a released upload lands at the RSU its
    vehicle trained under, not at the one it is in now."""
    import dataclasses
    sim.fused.part = dataclasses.replace(sim.fused.part,
                                         buffer_handoffs=False)


def frozen_sync(sim):
    """Planted fault: the card's sync gate is read on the host when the
    round is captured and kept as a constant in the graph."""
    eng = sim.fused

    def gate(t):
        return torch.full((), (eng._round + 1) % eng.tier.sync_period == 0,
                          dtype=torch.bool, device=eng.device)
    eng._sync_gate = gate


def first_merges(run):
    """Each task's first round with a global model, and that model."""
    out = {}
    for rnd, states in enumerate(run["_state"]["merged"]):
        for t, st in enumerate(states):
            if st is not None and t not in out:
                out[t] = (rnd, st)
    return out


def modes_agree(fused, batched, limit):
    """Phase 5e (b): a configuration's fused rounds against its batched
    rounds of the same seed at full width: active sets, ranks and
    departures, the per-task counts, deferred and released uploads
    exactly; energy and latency within ENGINE_TOL relative; each task's
    merged delta at its first merge (under a tier, the first sync) within
    ``limit`` as a Frobenius spread, the update limit of 5b."""
    f, b = fused["_state"], batched["_state"]
    n = min(len(f["recs"]), len(b["recs"]))
    rel = {"energy": 0.0, "latency": 0.0}
    for rnd in range(n):
        if f["plans"][rnd] != b["plans"][rnd]:
            fail(f"5e {fused['config']}: round {rnd} fused and batched "
                 f"differ in active sets, ranks or departures")
        for ft, bt in zip(f["recs"][rnd]["tasks"], b["recs"][rnd]["tasks"]):
            for key in COUNT_KEYS_5E:
                if ft.get(key) != bt.get(key):
                    fail(f"5e fused vs batched: round {rnd} task "
                         f"{ft['task']} {key} {ft.get(key)} vs "
                         f"{bt.get(key)}")
            for key in rel:
                rel[key] = max(rel[key], abs(ft[key] - bt[key])
                               / max(abs(bt[key]), 1e-12))
    fm, bm = first_merges(fused), first_merges(batched)
    if {t: r for t, (r, _) in fm.items()} != {t: r for t, (r, _)
                                              in bm.items()}:
        fail(f"5e fused vs batched: first merges {fm.keys()} {bm.keys()}")
    spread = max(merged_spread([bm[t][1]], [fm[t][1]]) for t in bm)
    if not (max(rel.values()) < ENGINE_TOL and spread <= limit):
        fail(f"5e fused vs batched: {rel} (tol {ENGINE_TOL}), merged "
             f"delta spread at the first merge {spread} (limit {limit})")
    return {"rounds": n, "energy_rel_err": rel["energy"],
            "latency_rel_err": rel["latency"], "tol": ENGINE_TOL,
            "first_merge_round": {t: r for t, (r, _) in fm.items()},
            "first_merge_spread": spread, "limit": limit}


def scanned_rounds(want, modes, arch):
    """Phase 5e (b): the tier's rounds of :func:`fused_rounds` (their
    records ``want``) again, from the same seed, through ``run_scanned``:
    every round staged first, each task's fresh adapters drawn for every
    round before its first sync, just before the round runs. Holds the
    records to the rounds run one by one (counts exactly, energy and
    latency within ENGINE_TOL) and records the wall time and the peak
    memory, with what the card held before the run."""
    release()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = IoVSimulator(SimConfig(method="ours", engine="fused",
                                 train_arch=arch, **modes), device="cuda")
    recs = sim.run_scanned(len(want))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    rel = {"energy": 0.0, "latency": 0.0}
    for rnd, (got, rec) in enumerate(zip(recs, want)):
        for gt, wt in zip(got["tasks"], rec["tasks"]):
            for key in COUNT_KEYS_5E:
                if gt.get(key) != wt.get(key):
                    fail(f"5e tier run_scanned vs run_round: round {rnd} "
                         f"task {gt['task']} {key} {gt.get(key)} vs "
                         f"{wt.get(key)}")
            for key in rel:
                rel[key] = max(rel[key], abs(gt[key] - wt[key])
                               / max(abs(wt[key]), 1e-12))
    if not max(rel.values()) < ENGINE_TOL:
        fail(f"5e tier run_scanned vs run_round: {rel} (tol {ENGINE_TOL})")
    captures = sim.fused.captures
    del sim
    release()
    return {"rounds": len(recs), "wall_ms": wall, "peak_memory_bytes": peak,
            "held_before_bytes": base,
            "energy_rel_err": rel["energy"],
            "latency_rel_err": rel["latency"], "tol": ENGINE_TOL,
            "captures": captures}


def release():
    """Free what earlier runs left: a simulator and its fused engine hold
    each other, so only the cycle collector frees a finished run's carry
    and graphs (semi_sync's buffer alone is 22.8 GiB at full width)."""
    gc.collect()
    torch.cuda.empty_cache()


def only_first_merges(run):
    """Keep, of a full-width run's per-round server states, each task's
    first global model (what :func:`modes_agree` holds), and drop the
    rest."""
    first = {t: r for t, (r, _) in first_merges(run).items()}
    run["_state"]["merged"] = [
        [st if first.get(t) == rnd else None for t, st in enumerate(sts)]
        for rnd, sts in enumerate(run["_state"]["merged"])]


def phase_5e(limit):
    """Phase 5e: (a) card vs CPU at the reduced ViT, each case of
    PARITY_5E over MODE_ROUNDS rounds from one state per round, and what
    the runs exercised; (c) three planted faults on the card's side,
    each of which must break (a)'s gates; (b) full width: each
    configuration's batched and fused rounds (one profiled round each),
    the fused ones held to an eager run and to the batched ones (within
    ``limit``, 5b's update limit), and the tier's rounds again through
    ``run_scanned``."""
    t0 = time.perf_counter()
    parity, events = {}, {}
    for mode, method, engine in PARITY_5E:
        p = mode_parity(mode, method, engine, MODE_FRO_LIMIT)
        if p["violations"]:
            fail(f"5e {mode} {method} {engine} card vs CPU: "
                 f"{p['violations']}")
        parity[f"{mode} {method} {engine}"] = p
        for k, v in p["events"].items():
            events[k] = events.get(k, 0) + v
    if not all(events.values()):
        fail(f"5e: the reduced runs exercised {events}; each must occur")
    planted = {}
    for label, (mode, engine, rounds, fault) in {
            "staleness discount one round too old": (
                "semi", "batched", 3, stale_discount),
            "release at the RSU it trained under": (
                "tier+semi", "fused", 2, trained_rsu),
            "sync gate frozen at capture": (
                "tier", "fused", 2, frozen_sync)}.items():
        p = mode_parity(mode, "ours", engine, MODE_FRO_LIMIT, rounds,
                        fault=fault)
        if not p["violations"]:
            fail(f"5e planted fault '{label}' passes the gates")
        planted[label] = p
    parity_s = time.perf_counter() - t0
    release()
    modes = MODES_5E
    arch = vit_base_paper.vit_base_paper().with_overrides(
        num_layers=DEPTH_5E)
    batched = {}
    for name, method, mode in (("tier", "ours", "tier"),
                               ("tier hetlora", "hetlora", "tier"),
                               ("semi", "ours", "semi")):
        # HetLoRA's 15 small groups cost a 49 s profiler window on an
        # H100 80GB HBM3 at 700 W: its four rounds run unprofiled, their
        # launches still held to the groups' prediction
        het = method == "hetlora"
        batched[name] = full_rounds("batched", 0 if het else 1,
                                    method=method, modes=modes[mode],
                                    plain=4 if het else 3, arch=arch)
        only_first_merges(batched[name])
        release()
    fused, replay = {}, {}
    for name in ("tier", "semi", "tier+semi"):
        fused[name] = fused_rounds(1, plain=2, modes=modes[name],
                                   arch=arch)
        release()
        eager = fused_run(arch, 2, capture=False, modes=modes[name])
        replay[name] = fused_state_diff(fused[name]["_state"], eager, 2)
        del eager
        if not replay[name] <= REPLAY_TOL:
            fail(f"5e {name} fused replay vs eager at full width: "
                 f"{replay[name]} > {REPLAY_TOL}")
        fused[name]["_state"].pop("modes")
        only_first_merges(fused[name])
        release()
    agree = {name: modes_agree(fused[name], batched[name], limit)
             for name in ("tier", "semi")}
    tier_recs = fused["tier"]["_state"]["recs"]
    for run in list(batched.values()) + list(fused.values()):
        run.pop("_state")
    scanned = scanned_rounds(tier_recs, modes["tier"], arch)
    torch.cuda.empty_cache()
    return {"parity": parity, "events": events, "planted": planted,
            "parity_s": parity_s, "batched": batched, "fused": fused,
            "replay_vs_eager": replay, "replay_tol": REPLAY_TOL,
            "fused_vs_batched": agree, "scanned": scanned,
            "seconds": time.perf_counter() - t0}


def print_5e(p5e):
    """Phase 5e's lines."""
    for name, p in p5e["parity"].items():
        w = p["worst"]
        print(f"[5e] {name}, reduced ViT, seed {MODE_SEED}, card vs CPU "
              f"over {p['rounds']} rounds (each from the CPU's state): ranks "
              f"{p['ranks']}, counts equal (handoffs {p['handoffs']}, "
              f"deferred {p['deferred']}, released {p['released']}); rel "
              f"energy {w['energy']:.3g}, latency {w['latency']:.3g}, "
              f"release weight {w['rel_weight']:.3g}, partial weights "
              f"{w['partial_w']:.3g}, buffered weights {w['buffer_w']:.3g} "
              f"(tol {p['tol']}); Frobenius spread of the global states "
              f"{w['state_fro']:.3g}, partials {w['partials_fro']:.3g}, "
              f"buffered deltas {w['buffer_fro']:.3g} (limit "
              f"{p['limit']:.3g}); largest entry (recorded) "
              f"{w['state']:.3g}, {w['partials']:.3g}, {w['buffer']:.3g} "
              f"(by round: "
              + ", ".join(f"{r['state']:.2g}/{r['partials']:.2g}/"
                          f"{r['buffer']:.2g}" for r in p["by_round"])
              + f"); {p['card_ms']:.0f} "
              f"ms on the card, {p['cpu_ms']:.0f} ms on the CPU; launches "
              f"{p['launches']}"
              + (f"; captures {p['captures']}" if p["captures"] else ""),
              flush=True)
    print(f"[5e] the reduced runs exercised {p5e['events']}", flush=True)
    for label, p in p5e["planted"].items():
        print(f"[5e] planted fault '{label}' ({p['mode']} {p['engine']}, "
              f"{p['rounds']} rounds): fails the gates: "
              f"{'; '.join(p['violations'])[:300]}", flush=True)
    print(f"[5e] card vs CPU and the planted faults took "
          f"{p5e['parity_s']:.1f} s", flush=True)
    for name, run in list(p5e["batched"].items()) + list(
            p5e["fused"].items()):
        up = run["unprofiled_round"]
        if not run["rounds"]:
            print(f"[5e] {name} {run['engine']} ({run['method']}) at full "
                  f"width ({DEPTH_5E} layers), unprofiled: rounds wall "
                  f"{', '.join(f'{x:.1f}' for x in up['wall_ms_each'])} ms, "
                  f"peak memory {up['peak_memory_bytes'] / 2**30:.2f} GiB; "
                  f"launches {run['launches']} (each round's = its groups' "
                  f"prediction), all simt; {run['seconds']:.1f} s in all",
                  flush=True)
            continue
        rd = run["rounds"][0]
        fr = run.get("first_round")
        first = ("" if fr is None else
                 f"round 0 (eager, then the capture) wall "
                 f"{fr['round_wall_ms']:.1f} ms (capture "
                 f"{fr['capture_ms']:.1f} ms), peak memory "
                 f"{fr['peak_memory_bytes'] / 2**30:.2f} GiB; ")
        launches = (f"kernel records per replayed round "
                    f"{rd['launches_per_run_by_profiler']}, all simt, "
                    f"captures {run['captures']}"
                    if fr is not None else
                    f"launches {rd['launches_total']} = predicted "
                    f"{rd['predicted_launches']}; groups {rd['groups']}")
        print(f"[5e] {name} {run['engine']} ({run['method']}) at full "
              f"width ({DEPTH_5E} layers): {first}round {rd['round']} wall "
              f"{rd['wall_ms']:.1f} ms (profiled), device "
              f"{rd['device_ms']:.1f} ms, busy {rd['busy_share']:.3f}, peak "
              f"memory {rd['peak_memory_bytes'] / 2**30:.2f} GiB; "
              f"{launches}; unprofiled rounds wall "
              f"{', '.join(f'{x:.1f}' for x in up['wall_ms_each'])} ms, "
              f"peak memory {up['peak_memory_bytes'] / 2**30:.2f} GiB; "
              f"{run['seconds']:.1f} s in all; top: "
              + "; ".join(f"{t['kernel'][:40]} {t['ms']:.2f} ms "
                          f"x{t['count']}" for t in rd["top"][:4]),
              flush=True)
    for name, d in p5e["replay_vs_eager"].items():
        print(f"[5e] {name} fused at full width ({DEPTH_5E} layers), "
              f"rounds 0-1 (round 1 a replay) vs eager: {d:.3g} (tol "
              f"{p5e['replay_tol']})", flush=True)
    for name, a in p5e["fused_vs_batched"].items():
        print(f"[5e] {name} fused vs batched at full width ({DEPTH_5E} "
              f"layers) over "
              f"{a['rounds']} rounds: ranks, counts, deferred and released "
              f"equal, energy rel {a['energy_rel_err']:.3g}, latency rel "
              f"{a['latency_rel_err']:.3g} (tol {a['tol']}); merged deltas "
              f"at each task's first merge (rounds "
              f"{a['first_merge_round']}) spread "
              f"{a['first_merge_spread']:.3g} (limit {a['limit']:.3g})",
              flush=True)
    sc = p5e["scanned"]
    print(f"[5e] tier fused at full width ({DEPTH_5E} layers) through "
          f"run_scanned("
          f"{sc['rounds']}) (fresh adapters drawn per round until the first "
          f"sync): counts equal to run_round's, energy rel "
          f"{sc['energy_rel_err']:.3g}, latency rel "
          f"{sc['latency_rel_err']:.3g} (tol {sc['tol']}); wall "
          f"{sc['wall_ms']:.1f} ms with the simulator's construction, peak "
          f"memory {sc['peak_memory_bytes'] / 2**30:.2f} GiB (held before "
          f"the run {sc['held_before_bytes'] / 2**30:.2f} GiB), captures "
          f"{sc['captures']}", flush=True)
    print(f"[5e] phase 5e took {p5e['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 5f: resumable runs and the scenario presets
# ---------------------------------------------------------------------------

# (a), (b): the reduced ViT; each case (preset, participation, engine,
# checkpoint interval, rounds) runs its rounds with a checkpoint every
# interval, against a run stopped at the first boundary and resumed.
# rsu-outage under semi_sync holds deferred uploads at the round-2
# boundary; dense-rsu syncs its partials every 2 rounds (rounds 1, 3,
# 5), so its round-3 boundary holds the live partials of round 2 and the
# resumed run's first round merges them.
RESUME_ROUNDS, RESUME_EVERY = 4, 2
RESUME_5F = (("rsu-outage", "semi_sync", "batched", 2, 4),
             ("rsu-outage", "semi_sync", "fused", 2, 4),
             ("dense-rsu", "sync", "batched", 3, 6),
             ("dense-rsu", "sync", "fused", 3, 6))
# (c): full width, rsu-outage under semi_sync, fused run_scanned in
# chunks of RESUME_EVERY over FULL_HORIZON rounds (the preset built for
# that horizon: its trace and outage windows)
FULL_HORIZON = 6


def preset_sim(name, part, engine, rounds, ckpt=None, keep_last=0,
               device="cuda", arch=None, every=RESUME_EVERY, **kw):
    """A scenario preset's simulator for ``rounds`` rounds, checkpointing
    every ``every`` rounds into ``ckpt`` when given."""
    over = dict(kw)
    if ckpt is not None:
        over["checkpoint"] = CheckpointSpec(interval=every, dir=ckpt,
                                            keep_last=keep_last)
    if arch is not None:
        over["train_arch"] = arch
    return scenarios.build_sim(name, rounds=rounds, engine=engine,
                               participation=part, device=device, **over)


def drive(sim, n):
    """``n`` rounds as a user resumes them: ``run_scanned`` in chunks under
    a fused engine, ``run`` otherwise."""
    return (sim.run_scanned if sim.fused is not None else sim.run)(n)


def history_json(sim):
    return json.dumps(sim.history, sort_keys=True)


def checkpoint_diff(a, b):
    """Leaves of two checkpoint files that differ (by flat key; dtypes,
    shapes and bits), read one entry at a time."""
    with np.load(a) as za, np.load(b) as zb:
        if sorted(za.files) != sorted(zb.files):
            return [f"keys {sorted(set(za.files) ^ set(zb.files))}"]
        out = []
        for k in za.files:
            x, y = za[k], zb[k]
            if x.dtype != y.dtype or not np.array_equal(x, y):
                out.append(k)
        return out


def boundary_state(path):
    """What a checkpoint carries: buffered uploads and, per task, live
    partials (the largest count over tasks)."""
    st = load_pytree(path, numpy=True)
    return {"buffered": int(sum(len(s["buffer"]["lanes"])
                                for s in st["servers"])),
            "live_partials": int(max(int((s["partial_w"] > 0).sum())
                                     for s in st["servers"]))}


def restore_skipping_channel(sim, ckpt_dir):
    """Planted fault: a restore that leaves the channel's fading stream
    where the fresh simulator had it."""
    state = sim.channel._rng.bit_generator.state
    done = restore_checkpoint(sim, ckpt_dir)
    sim.channel._rng.bit_generator.state = state
    return done


def restore_buffer_one_lane_off(sim, ckpt_dir):
    """Planted fault: a restore whose buffered uploads land one vehicle
    lane over."""
    done = restore_checkpoint(sim, ckpt_dir)
    V = sim.cfg.num_vehicles
    for srv in sim.servers:
        srv.buffer = {(v + 1) % V: e for v, e in srv.buffer.items()}
    if sim.fused is not None:
        sim.fused.reset_carry()
    return done


def resume_case(root, name, part, engine, every, rounds, live=False):
    """Phase 5f (a), one case: an uninterrupted run of ``rounds`` rounds
    with a checkpoint every ``every`` against one stopped at the first
    boundary and restored (into a fresh simulator, or with ``live`` into
    the same one after it ran on), then finished. Returns the readings;
    the histories (JSON) and every leaf of the final checkpoints must be
    equal."""
    label = f"{name} {part} {engine}" + (" live" if live else "")
    d_ref, d_vic = (os.path.join(root, label.replace(" ", "_") + s)
                    for s in ("_ref", "_vic"))
    kw = dict(every=every)
    reset_counts()
    t0 = time.perf_counter()
    ref = preset_sim(name, part, engine, rounds, d_ref, **kw)
    drive(ref, rounds)
    want = history_json(ref)
    del ref
    release()
    vic = preset_sim(name, part, engine, rounds, d_vic, **kw)
    drive(vic, rounds if live else every)
    if live:
        res = vic
        captures = res.fused.captures
        ptrs = {k: v.data_ptr() for k, v in res.fused.carry.items()
                if isinstance(v, torch.Tensor)}
        done = restore_checkpoint(res, round_idx=every)
    else:
        del vic
        release()
        res = preset_sim(name, part, engine, rounds, d_vic, **kw)
        done = restore_checkpoint(res)
    if done != every or len(res.history) != every:
        fail(f"5f {label}: restored round {done}, history "
             f"{len(res.history)}")
    drive(res, rounds - every)
    launched = counts()
    if launched["lora_matmul"] == 0 or launched["flash_attention"] == 0:
        fail(f"5f {label}: the rounds launched {launched}")
    if live and (res.fused.captures != captures or ptrs != {
            k: v.data_ptr() for k, v in res.fused.carry.items()
            if isinstance(v, torch.Tensor)}):
        fail(f"5f {label}: the live restore recaptured or rebound the "
             f"carry")
    final = f"round_{rounds:06d}.npz"
    diff = checkpoint_diff(os.path.join(d_ref, final),
                           os.path.join(d_vic, final))
    out = {"case": label, "every": every, "rounds": rounds,
           "history_equal": history_json(res) == want,
           "checkpoint_leaves_differing": diff,
           "boundary": boundary_state(os.path.join(
               d_vic, f"round_{every:06d}.npz")),
           "launches": launched, "seconds": time.perf_counter() - t0,
           "_want": want, "_dirs": (d_ref, d_vic)}
    del res
    release()
    return out


def faulted_resume(root, case, restore):
    """Phase 5f (a), a planted fault: ``case``'s stopped run restored
    through ``restore`` into a fresh simulator and finished; the
    comparison with the uninterrupted run must fail."""
    name, part, engine = case["case"].split()[:3]
    every, rounds = case["every"], case["rounds"]
    d_ref, d_vic = case["_dirs"]
    d = os.path.join(root, f"fault_{restore.__name__}")
    os.makedirs(d)
    first = f"round_{every:06d}.npz"
    shutil.copy(os.path.join(d_vic, first), os.path.join(d, first))
    sim = preset_sim(name, part, engine, rounds, d, every=every)
    restore(sim, d)
    drive(sim, rounds - every)
    final = f"round_{rounds:06d}.npz"
    out = {"history_equal": history_json(sim) == case["_want"],
           "checkpoint_leaves_differing": len(checkpoint_diff(
               os.path.join(d_ref, final), os.path.join(d, final)))}
    del sim
    release()
    return out


def wrong_seed_raises(root, case):
    """Phase 5f (a): a preset built with another seed refuses the
    checkpoint before any state changes."""
    name, part, engine = case["case"].split()[:3]
    sim = preset_sim(name, part, engine, case["rounds"], seed=1)
    try:
        restore_checkpoint(sim, case["_dirs"][1])
    except ValueError as e:
        msg = str(e)
    else:
        fail("5f: a checkpoint restored into a preset of another seed")
    untouched = (sim.history == [] and sim.mobility.tick == 0
                 and all(s.merged is None and not s.buffer
                         for s in sim.servers))
    if not untouched:
        fail("5f: a refused restore changed the simulator's state")
    return msg


def round_gates(card, cpu):
    """One round on each device from one state, held with 5e's gates:
    the counts exactly, energy, latency and weights within ROUND_TOL,
    the trained state (global states, partials, buffered deltas) as a
    Frobenius spread within MODE_FRO_LIMIT. Returns (readings,
    violations)."""
    bad = []
    gr, cr = card.history[-1], cpu.history[-1]
    row = {"energy": 0.0, "latency": 0.0, "rel_weight": 0.0,
           "state": 0.0, "state_fro": 0.0}
    for gt, ct in zip(gr["tasks"], cr["tasks"]):
        for key in COUNT_KEYS_5E:
            if gt.get(key) != ct.get(key):
                bad.append(f"task {gt['task']} {key} {gt.get(key)} vs "
                           f"{ct.get(key)}")
        for key in ("energy", "latency", "rel_weight"):
            if key in ct:
                row[key] = max(row[key], abs(gt[key] - ct[key])
                               / max(abs(ct[key]), 1e-12))
    gs, cs = server_states(card), server_states(cpu)
    if [s is None for s in gs] != [s is None for s in cs]:
        bad.append("a global model on one device only")
    else:
        for g, c_ in zip(gs, cs):
            e, f = _tree_rel(g, c_)
            row["state"] = max(row["state"], e)
            row["state_fro"] = max(row["state_fro"], f)
    diff = mode_state_diff(mode_states(card), mode_states(cpu))
    if diff.pop("exact"):
        bad.append("live partials, ages or the buffer differ")
    row.update(diff)
    held = {**{k: ROUND_TOL for k in ("energy", "latency", "rel_weight",
                                      "partial_w", "buffer_w")},
            **{k: MODE_FRO_LIMIT for k in ("state_fro", "partials_fro",
                                           "buffer_fro")}}
    over = {k: row.get(k, 0.0) for k, tol in held.items()
            if not row.get(k, 0.0) <= tol}
    if over:
        bad.append(f"over their limits: {over}")
    return row, bad


def present_spy(sim):
    """Keep the fleet's presence after each mobility step."""
    seen, step = [], sim.mobility.step

    def spy():
        step()
        seen.append(sim.mobility.present.copy())
    sim.mobility.step = spy
    return seen


def absent_trained(plans, present, nt):
    """Vehicles that trained a lane while absent, per round."""
    return [sorted(set(ids) - set(np.flatnonzero(present[i // nt])))
            for i, (_, ids, _, _) in enumerate(plans)]


def cross_device(root):
    """Phase 5f (b): a checkpoint the card wrote restored on the CPU, and
    one the CPU wrote restored on the card; each time one round on each
    device from that state (the card training from the CPU's SVD
    redistribution, :func:`share_distribution`), held with 5e's gates.
    Then round 0 of rush-hour (a dynamic fleet) on both devices."""
    name, part = "rsu-outage", "semi_sync"
    rows, bad = {}, []
    reset_counts()
    card = preset_sim(name, part, "batched", RESUME_ROUNDS)
    card.run(RESUME_EVERY)
    d_card = os.path.join(root, "card_written")
    save_checkpoint(card, d_card)
    cpu = preset_sim(name, part, "batched", RESUME_ROUNDS, device="cpu")
    restore_checkpoint(cpu, d_card)
    share_distribution(card, cpu)
    cpu.run_round()
    card.run_round()
    rows["card-written, restored on the CPU"], b = round_gates(card, cpu)
    bad += [f"card-written: {x}" for x in b]
    del card
    release()
    d_cpu = os.path.join(root, "cpu_written")
    save_checkpoint(cpu, d_cpu)
    card = preset_sim(name, part, "batched", RESUME_ROUNDS)
    restore_checkpoint(card, d_cpu)
    share_distribution(card, cpu)
    cpu.run_round()
    card.run_round()
    rows["CPU-written, restored on the card"], b = round_gates(card, cpu)
    bad += [f"CPU-written: {x}" for x in b]
    buffered = [len(s.buffer) for s in cpu.servers]
    del card, cpu
    release()
    sims, plans, present = {}, {}, {}
    for dev in ("cpu", "cuda"):
        sims[dev] = preset_sim("rush-hour", "sync", "batched", 24,
                               device=dev)
        plans[dev] = []
        recording(sims[dev], plans[dev])
        present[dev] = present_spy(sims[dev])
        sims[dev].run_round()
    rows["rush-hour round 0"], b = round_gates(sims["cuda"], sims["cpu"])
    bad += [f"rush-hour: {x}" for x in b]
    if plans["cuda"] != plans["cpu"]:
        bad.append("rush-hour: active sets, ranks or departures differ")
    nt = sims["cuda"].cfg.num_tasks
    trained_absent = absent_trained(plans["cuda"], present["cuda"], nt)
    absent = int((~present["cuda"][0]).sum())
    if any(trained_absent) or absent == 0:
        bad.append(f"rush-hour: {absent} absent, of them trained "
                   f"{trained_absent}")
    launched = counts()
    del sims
    release()
    if bad:
        fail(f"5f (b) card vs CPU: {bad}")
    return {"rounds": rows, "buffered_after": buffered,
            "rush_hour_absent": absent, "launches": launched}


class HostPeak:
    """The process's resident memory, sampled every 5 ms while inside:
    ``peak`` is the most it rose above what it held on entry (bytes)."""

    def __init__(self):
        self.peak = 0

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def __enter__(self):
        import threading
        self._base, self._stop = self._rss(), threading.Event()

        def watch():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, self._rss() - self._base)
        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss() - self._base)


def timed_saves(log):
    """Time every checkpoint the simulators write (wall ms with the
    device-to-host copies, file bytes, host and device peaks), by
    wrapping ``save_checkpoint`` where ``run``/``run_scanned`` call it."""
    real = carry_mod.save_checkpoint

    def save(sim, *a, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with HostPeak() as host:
            path = real(sim, *a, **kw)
        log.append({"round": len(sim.history),
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "bytes": os.path.getsize(path),
                    "host_peak_bytes": host.peak,
                    "device_peak_bytes":
                        torch.cuda.max_memory_allocated() - base,
                    "run_peak_before_bytes": before})
        return path
    carry_mod.save_checkpoint = save
    return real


DEPTH_5F = 3


def full_width_resume(root):
    """Phase 5f (c): rsu-outage under semi_sync at the full width of
    vit-base-paper (DEPTH_5F of its 12 layers), fused ``run_scanned``
    over FULL_HORIZON rounds with a
    checkpoint every RESUME_EVERY (keep_last 1): an uninterrupted run
    against one stopped at the first boundary, freed, restored into a
    fresh simulator and finished; no two simulators on the card at
    once. Histories bit-equal, the final checkpoints' leaves equal;
    save and restore times, bytes and peaks; the profiler's kernel
    records of one replayed round after the restore."""
    arch = vit_base_paper.vit_base_paper().with_overrides(
        num_layers=DEPTH_5F)
    name, part = "rsu-outage", "semi_sync"
    d_ref, d_vic = (os.path.join(root, s) for s in ("full_ref", "full_vic"))
    saves = []
    real = timed_saves(saves)
    reset_counts()
    t0 = time.perf_counter()
    ref = preset_sim(name, part, "fused", FULL_HORIZON, d_ref, keep_last=1,
                     arch=arch)
    forwards = ref.cfg.num_tasks * (ref.cfg.local_steps + 2)
    # six LoRA linears (q/k/v/o/up/down) and one attention a layer
    want_records = {"lora_matmul": 6 * arch.num_layers * forwards,
                    "flash_attention": arch.num_layers * forwards}
    ref.run_scanned(FULL_HORIZON)
    want = history_json(ref)
    ref_s = time.perf_counter() - t0
    del ref
    release()
    vic = preset_sim(name, part, "fused", FULL_HORIZON, d_vic, keep_last=1,
                     arch=arch)
    vic.run_scanned(RESUME_EVERY)
    del vic
    release()
    boundary = boundary_state(latest_checkpoint(d_vic))
    if boundary["buffered"] == 0:
        fail(f"5f (c): the round-{RESUME_EVERY} checkpoint holds no "
             f"buffered upload")
    res = preset_sim(name, part, "fused", FULL_HORIZON, d_vic, keep_last=1,
                     arch=arch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with HostPeak() as host:
        done = restore_checkpoint(res)
        torch.cuda.synchronize()
    restore = {"ms": (time.perf_counter() - t1) * 1e3,
               "host_peak_bytes": host.peak,
               "device_peak_bytes": torch.cuda.max_memory_allocated() - base,
               "round": done}
    # the profiler's records of the first replay after the restore (the
    # resumed run's second round: its first runs eagerly, then captures)
    eng, profiled, calls = res.fused, [], []
    execute = eng._execute

    def watched():
        calls.append(1)
        if len(calls) == 2:
            profiled.append(device_profile(execute, top=6))
        else:
            execute()
    eng._execute = watched
    torch.cuda.reset_peak_memory_stats()
    n_saves = len(saves)
    res.run_scanned(FULL_HORIZON - done)
    # the resumed run's peak, across the resets each save makes
    peak = max([s["run_peak_before_bytes"] for s in saves[n_saves:]]
               + [torch.cuda.max_memory_allocated()])
    carry_mod.save_checkpoint = real
    got = history_json(res)
    captures = eng.captures
    launched = counts()
    del res, eng, execute, watched
    release()
    prof = profiled[0]
    ours = prof["port_kernels"]
    records = {"lora_matmul": ours.get("lora_mm_kernel", {}).get("count", 0),
               "flash_attention": ours.get("fa_kernel", {}).get("count", 0)}
    final = f"round_{FULL_HORIZON:06d}.npz"
    diff = checkpoint_diff(os.path.join(d_ref, final),
                           os.path.join(d_vic, final))
    if got != want or diff:
        fail(f"5f (c) full width: the resumed run differs from the "
             f"uninterrupted one (history equal {got == want}, leaves "
             f"{diff[:5]})")
    if records != want_records or captures != 1:
        fail(f"5f (c): a replayed round's records {records}, predicted "
             f"{want_records}; captures {captures}")
    if sorted(os.listdir(d_vic)) != [final]:
        fail(f"5f (c): keep_last=1 left {sorted(os.listdir(d_vic))}")
    return {"config": f"{name}, participation={part}, {arch.name} at full "
            f"width ({arch.num_layers} layers, d {arch.d_model}), fused "
            f"run_scanned({FULL_HORIZON}) in chunks of {RESUME_EVERY}",
            "boundary": boundary, "saves": saves, "restore": restore,
            "uninterrupted_s": ref_s, "resumed_peak_memory_bytes": peak,
            "replayed_round": {k: prof[k] for k in (
                "wall_ms", "device_ms", "busy_share", "window_s")},
            "records_per_replayed_round": records,
            "predicted_records": want_records, "captures": captures,
            "launches": launched, "history_equal": True,
            "checkpoint_leaves_equal": True,
            "seconds": time.perf_counter() - t0}


def every_preset():
    """Phase 5f (d): each preset at the full width of vit-base-paper
    (DEPTH_5F of its 12 layers) under the batched engine, every simulator on one set of base weights, round
    by round until a round trains (sparse-rural's first two have no
    vehicle in coverage): launches equal to the groups' prediction,
    energy, latency and accuracy finite, no absent vehicle training a
    lane (rush-hour's and sparse-rural's rounds must have absent
    vehicles); the wall time of each round, unprofiled."""
    release()
    arch = vit_base_paper.vit_base_paper().with_overrides(
        num_layers=DEPTH_5F)
    params = tree_map(lambda t: t.cuda(), T.init_params(
        arch, seed=0, dtype=torch.float32, device="cpu"))
    per_fwd = {"lora_matmul": arch.num_layers * len(tree_paths(
        T.init_adapters(arch, LoRAConfig(), rank=2, device="cpu"))),
        "flash_attention": arch.num_layers}
    out = {}
    for name in scenarios.list_scenarios():
        sim = scenarios.build_sim(name, engine="batched", train_arch=arch,
                                  params=params)
        plans = []
        recording(sim, plans)
        present = present_spy(sim)
        nt = sim.cfg.num_tasks
        reset_counts()
        walls, groups = [], []
        while not groups and len(walls) < 3:
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = sim.run_round()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            groups, _ = predicted_launches(sim, plans[-nt:], rec, {
                k: v - before[k] for k, v in counts().items()}, per_fwd)
            finite = all(np.isfinite(t[k]) for t in rec["tasks"] + [rec]
                         for k in ("energy", "latency", "accuracy"))
            if not finite:
                fail(f"5f (d) {name} round {len(walls) - 1}: an energy, "
                     f"latency or accuracy is not finite")
        launched = counts()
        trained_absent = absent_trained(plans, present, nt)
        absent = [int((~p).sum()) for p in present]
        if not groups or launched["lora_matmul"] == 0 or any(trained_absent):
            fail(f"5f (d) {name}: groups {groups}, launches {launched}, "
                 f"absent vehicles that trained {trained_absent}")
        if name in ("rush-hour", "sparse-rural") and not all(absent):
            fail(f"5f (d) {name}: rounds without an absent vehicle "
                 f"({absent})")
        out[name] = {"wall_ms": walls[-1], "wall_ms_each": walls,
                     "rounds": len(walls), "launches": launched,
                     "groups": [list(g) for g in groups],
                     "vehicles": sim.cfg.num_vehicles, "tasks": nt,
                     "absent": absent,
                     "active": [t["active"] for t in rec["tasks"]],
                     "energy": rec["energy"], "latency": rec["latency"],
                     "accuracy": rec["accuracy"]}
        del sim
        release()
    return out


def phase_5f():
    """Phase 5f: (a) resume on the card at the reduced ViT, with two
    planted faults and a refused config; (b) checkpoints across the card
    and the CPU; (c) a full-width resume; (d) every preset at full width.
    The checkpoints go to a temporary directory in the checkout, removed
    at the end."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_ckpt_") as root:
        cases = [resume_case(root, *c) for c in RESUME_5F]
        cases.append(resume_case(root, *RESUME_5F[1], live=True))
        for c in cases:
            if not c["history_equal"] or c["checkpoint_leaves_differing"]:
                fail(f"5f (a) {c['case']}: the resumed run differs "
                     f"(history equal {c['history_equal']}, leaves "
                     f"{c['checkpoint_leaves_differing'][:5]})")
        if not (any(c["boundary"]["buffered"] for c in cases)
                and any(c["boundary"]["live_partials"] >= 2 for c in cases)):
            fail(f"5f (a): the boundaries held "
                 f"{[c['boundary'] for c in cases]}; a buffered upload and "
                 f"two live partials must occur")
        planted = {}
        for label, restore in (
                ("a restore that skips the channel's stream",
                 restore_skipping_channel),
                ("buffered uploads one lane off",
                 restore_buffer_one_lane_off)):
            p = faulted_resume(root, cases[0], restore)
            if p["history_equal"] and not p["checkpoint_leaves_differing"]:
                fail(f"5f planted fault '{label}' passes the comparison")
            planted[label] = p
        refused = wrong_seed_raises(root, cases[0])
        a_s = time.perf_counter() - t0
        cross = cross_device(root)
        b_s = time.perf_counter() - t0 - a_s
        full = full_width_resume(root)
    presets = every_preset()
    for c in cases:
        del c["_want"], c["_dirs"]
    return {"cases": cases, "planted": planted, "refused": refused,
            "a_s": a_s, "cross_device": cross, "b_s": b_s, "full": full,
            "presets": presets, "seconds": time.perf_counter() - t0}


def print_5f(p5f):
    """Phase 5f's lines."""
    for c in p5f["cases"]:
        print(f"[5f] {c['case']}, reduced ViT, {c['rounds']} rounds, "
              f"stopped at {c['every']} and resumed: history equal "
              f"{c['history_equal']}, final checkpoints' leaves equal "
              f"{not c['checkpoint_leaves_differing']}; the boundary held "
              f"{c['boundary']}; launches {c['launches']}; "
              f"{c['seconds']:.1f} s", flush=True)
    for label, p in p5f["planted"].items():
        print(f"[5f] planted fault '{label}': history equal "
              f"{p['history_equal']}, {p['checkpoint_leaves_differing']} "
              f"leaves differ: fails the comparison", flush=True)
    print(f"[5f] a preset of another seed refuses the checkpoint before "
          f"any state changes: {p5f['refused'][:90]}; (a) took "
          f"{p5f['a_s']:.1f} s", flush=True)
    x = p5f["cross_device"]
    for label, r in x["rounds"].items():
        print(f"[5f] {label}: one round on each device, counts equal; rel "
              f"energy {r['energy']:.3g}, latency {r['latency']:.3g}, "
              f"release weight {r['rel_weight']:.3g} (tol {ROUND_TOL}); "
              f"Frobenius spread of the global states "
              f"{r['state_fro']:.3g}, partials {r['partials_fro']:.3g}, "
              f"buffered deltas {r['buffer_fro']:.3g} (limit "
              f"{MODE_FRO_LIMIT}); largest entry (recorded) "
              f"{r['state']:.3g}", flush=True)
    print(f"[5f] rush-hour round 0: {x['rush_hour_absent']} vehicles "
          f"absent, none trained; buffered uploads after the CPU-written "
          f"restore {x['buffered_after']}; launches {x['launches']}; (b) "
          f"took {p5f['b_s']:.1f} s", flush=True)
    f = p5f["full"]
    for s in f["saves"]:
        print(f"[5f] full width save at round {s['round']}: "
              f"{s['ms']:.1f} ms, {s['bytes'] / 2**30:.3f} GiB, host peak "
              f"{s['host_peak_bytes'] / 2**30:.3f} GiB, device peak "
              f"{s['device_peak_bytes'] / 2**30:.3f} GiB", flush=True)
    r = f["restore"]
    rr = f["replayed_round"]
    print(f"[5f] {f['config']}: the boundary held {f['boundary']}; restore "
          f"{r['ms']:.1f} ms, host peak {r['host_peak_bytes'] / 2**30:.3f} "
          f"GiB, device peak {r['device_peak_bytes'] / 2**30:.3f} GiB; "
          f"history and final checkpoint equal to the uninterrupted run's "
          f"({f['uninterrupted_s']:.1f} s); the first replay after the "
          f"restore: records {f['records_per_replayed_round']} (predicted "
          f"{f['predicted_records']}), wall {rr['wall_ms']:.1f} ms, device "
          f"{rr['device_ms']:.1f} ms, busy {rr['busy_share']:.3f}; "
          f"captures {f['captures']}; resumed run's peak memory "
          f"{f['resumed_peak_memory_bytes'] / 2**30:.2f} GiB; "
          f"{f['seconds']:.1f} s", flush=True)
    for name, p in p5f["presets"].items():
        print(f"[5f] {name} at full width, batched round {p['rounds'] - 1} "
              f"(the first that trains; unprofiled): wall "
              f"{p['wall_ms']:.1f} ms, {p['vehicles']} vehicles, "
              f"{p['tasks']} tasks, {p['absent']} absent, active "
              f"{p['active']}, launches {p['launches']} = the groups' "
              f"prediction ({len(p['groups'])} groups); energy "
              f"{p['energy']:.2f} J, latency {p['latency']:.2f} s, accuracy "
              f"{p['accuracy']:.4f}", flush=True)
    print(f"[5f] phase 5f took {p5f['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 6: serving, the rest (paged KV, the adapter store, two more archs)
# ---------------------------------------------------------------------------

BLOCK_6 = 16          # paged KV block size (tokens)
CACHE_6 = 128         # a lane's ring (tokens)
STEPS_6A = 140        # lanes 2 and 3 run on past the 128-slot ring
GEN_6A = 24           # tokens per timed generate, after a 16-token prompt


def tenant(cfg, lora, rank, seed, device="cuda", task=0, slot=SLOT):
    """A rank-``rank`` tenant padded into the slot, drawn on ``device``
    (b off its zero init, so it changes outputs)."""
    g = torch.Generator(device=device).manual_seed(seed)
    ads = T.init_adapters(cfg, lora, rank=rank, generator=g)

    def fix(node):
        if "a" in node and "b" in node:
            return {"a": node["a"], "b": 0.02 * torch.randn(
                node["b"].shape, generator=g, device=device)}
        return {k: fix(v) for k, v in node.items()}
    ads = {k: ([fix(sg) for sg in v] if k == "segments" else fix(v))
           for k, v in ads.items()}
    return PagedAdapter(task=task, rsu=-1, version=0, rank=rank,
                        slot_rank=slot, scale=lora.alpha / rank,
                        adapters=pad_adapter_tree(ads, slot))


def pool_ptrs(eng):
    return ([leaf.data_ptr() for pool in eng._pools
             for leaf in pool.values()], eng._tables.data_ptr())


def lockstep(paged, dense, schedule, steps):
    """Drive a paged and a dense engine through one schedule (step ->
    [("admit", PagedAdapter) | ("retire", lane)], applied before that
    step), each lane greedy on its own stream, a churned lane's stream
    restarting at token 1. Every step's logits and tokens must be
    bit-equal, the allocator's invariants must hold after every mutation,
    and the pools and tables must not move. Returns the engines' lane
    choices per event and the recycled-block count."""
    ptrs = pool_ptrs(paged)
    B = paged.max_batch
    toks = [np.ones(B, np.int64), np.ones(B, np.int64)]
    lanes = []
    for t in range(steps):
        for action, arg in schedule.get(t, ()):
            got = []
            for eng, tk in zip((paged, dense), toks):
                lane = (eng.admit(arg) if action == "admit"
                        else eng.retire(arg))
                tk[lane] = 1
                got.append(lane)
            paged.allocator.check()
            if got[0] != got[1]:
                fail(f"6: paged and dense engines chose lanes {got}")
            lanes.append((t, action, got[0]))
        out = [eng.step(tk) for eng, tk in zip((paged, dense), toks)]
        paged.allocator.check()
        if not torch.equal(out[0], out[1]):
            fail(f"6: paged != dense at step {t}: max abs "
                 f"{maxabs(out[0], out[1]):.3g}")
        toks = [o.argmax(-1).cpu().numpy() for o in out]
        if not np.array_equal(toks[0], toks[1]):
            fail(f"6: paged and dense greedy tokens differ at step {t}")
    if pool_ptrs(paged) != ptrs:
        fail("6: the paged engine's pools or tables moved")
    return lanes


def lane_caches_agree(paged, dense):
    """Each lane's gathered cache equals the dense one: positions at
    every slot, K and V wherever pos >= 0. Returns the live slots."""
    live_slots = 0
    for lane in range(paged.max_batch):
        _, rp = kvb.split_cache_tree(paged.cfg, paged.lane_cache(lane))
        _, rd = kvb.split_cache_tree(dense.cfg, dense.lane_cache(lane))
        for a, b in zip(rp, rd):
            if not torch.equal(a["pos"], b["pos"]):
                fail(f"6: lane {lane}'s positions differ, paged vs dense")
            live = (a["pos"] >= 0)[..., None, None]
            for name in ("k", "v"):
                if not torch.equal(torch.where(live, a[name], 0),
                                   torch.where(live, b[name], 0)):
                    fail(f"6: lane {lane}'s live {name} differs")
            live_slots += int((a["pos"][0] >= 0).sum())
    return live_slots


def decode_launch_gate(label, launched, variants, want):
    """Every lora_matmul launch of a decode run is split-K, want of
    them; no flash or wkv6 launch."""
    if launched != {"lora_matmul": want, "flash_attention": 0, "wkv6": 0} \
            or variants != {"wgmma": 0, "splitk": want, "simt": 0}:
        fail(f"6 {label}: launches {launched}, by variant {variants}; "
             f"want {want} split-K")


def timed_generate(eng, prompts, n, label, per_step):
    """One counted, timed ``generate`` of ``n`` tokens after the prompts
    (counts reset just before, read just after)."""
    for lane in range(eng.max_batch):
        eng.reset_lane(lane)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng.generate(prompts, n)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    steps = prompts.shape[1] + n - 1
    launched, variants = counts(), variant_counts()
    decode_launch_gate(label, launched, variants, per_step * steps)
    return {"steps": steps, "ms_per_step": sec / steps * 1e3,
            "lane_tokens_per_s": eng.max_batch * steps / sec,
            "launches": launched, "lora_matmul_variants": variants,
            "flash_attention_variants": flash_variant_counts()}


def exhaustion_planted(params, cfg, lora, dtype):
    """A pool one block short of full occupancy must raise mid-step, at
    the step where the last lane's next block is due, and leave the
    allocator whole."""
    spec = ServeSpec(max_batch=len(RANKS), cache_len=2 * BLOCK_6,
                     max_rank=SLOT, block_size=BLOCK_6)
    spec = dataclasses.replace(spec,
                               max_blocks=spec.resolve_max_blocks() - 1)
    eng = ServeEngine(params, cfg, lora, spec, dtype=dtype)
    toks = np.ones(len(RANKS), np.int64)
    raised = None
    for t in range(2 * BLOCK_6):
        try:
            eng.step(toks)
        except kvb.BlockPoolExhausted as e:
            raised = (t, str(e))
            break
    if raised is None or raised[0] != BLOCK_6:
        fail(f"6a planted fault: a pool one block short raised {raised}, "
             f"want BlockPoolExhausted at step {BLOCK_6}")
    eng.allocator.check()
    if eng.allocator_stats()["oom_events"] != 1:
        fail(f"6a planted fault: stats {eng.allocator_stats()}")
    return {"max_blocks": spec.max_blocks, "raised_at_step": raised[0],
            "message": raised[1][:80]}


# 6a and 6b run qwen2-0.5b and vit-base-paper at full width: 6b at half
# depth since PR 23, 6a at a quarter since PR 24 (half in PR 23), to
# keep the script within 1,000 s on a slow host
DEPTH_6A = 6
DEPTH_6B = 6


def phase_6a():
    """Paged vs dense at qwen2-0.5b's full width (DEPTH_6A of its 24
    layers) in bf16: a
    churn schedule (admit, retire, re-admit into a recycled lane,
    evict_oldest, a ring wrap) in lockstep, bit-equal; live cache slots
    equal; launches per step; decode time paged against dense; a planted
    exhausted pool."""
    t0 = time.perf_counter()
    cfg = qwen2_0_5b.qwen2_0_5b().with_overrides(num_layers=DEPTH_6A)
    lora = LoRAConfig(rank=SLOT, max_rank=SLOT)
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    tenants = [tenant(cfg, lora, r, 60 + i) for i, r in
               enumerate(RANKS + (32, 16))]

    def engine(block_size):
        return ServeEngine(params, cfg, lora, ServeSpec(
            max_batch=len(RANKS), cache_len=CACHE_6, max_rank=SLOT,
            block_size=block_size, admission="evict_oldest"),
            dtype=torch.bfloat16)
    paged, dense = engine(BLOCK_6), engine(0)
    schedule = {0: [("admit", x) for x in tenants[:4]],
                40: [("retire", 1)],
                60: [("admit", tenants[4])],     # lane 1: recycled blocks
                80: [("admit", tenants[5])]}     # full: evicts lane 0
    per_step = per_model(cfg)[1]["lora_matmul"]
    reset_counts()
    lanes = lockstep(paged, dense, schedule, STEPS_6A)
    launched, variants = counts(), variant_counts()
    decode_launch_gate("a lockstep", launched, variants,
                       2 * per_step * STEPS_6A)
    stats = paged.allocator_stats()
    if stats["recycles"] == 0 or stats["oom_events"]:
        fail(f"6a: allocator stats {stats}: no block recycled")
    if max(paged._positions) <= CACHE_6:
        fail("6a: the ring never wrapped")
    live = lane_caches_agree(paged, dense)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                                (len(RANKS), 16))
    runs = {}
    for label, eng in (("dense", dense), ("paged", paged), ("paged", paged),
                       ("dense", dense)):   # in turns
        runs.setdefault(label, []).append(
            timed_generate(eng, prompts, GEN_6A, f"a {label}", per_step))
    planted = exhaustion_planted(params, cfg, lora, torch.bfloat16)
    del paged, dense, params, tenants
    release()
    return {"config": f"{cfg.name}, {cfg.num_layers} layers, full width, "
            f"bf16, {len(RANKS)} lanes at ranks {list(RANKS)} in the "
            f"{SLOT} slot, block {BLOCK_6}, ring {CACHE_6}",
            "lockstep_steps": STEPS_6A, "events": lanes,
            "allocator": stats, "live_slots_equal": live,
            "lockstep_launches": launched,
            "lockstep_lora_matmul_variants": variants,
            "timed": runs, "planted_exhaustion": planted,
            "seconds": time.perf_counter() - t0}


def phase_6b(root):
    """Train -> checkpoint -> serve at the full width of vit-base-paper:
    the dense-rsu preset, batched, three rounds (a sync after round 1, so
    the servers hold merged deltas and live partials), checkpointed; the
    store from the checkpoint against the store from the live simulator
    (bits per task, RSU and rank; one SVD per key); trained tenants
    admitted by the store into a paged and a dense engine through
    retire, re-admit and evict_oldest, bit-equal; a foreign config
    refused; the time of the store's one SVD and of a get that hits."""
    t0 = time.perf_counter()
    arch = vit_base_paper.vit_base_paper().with_overrides(
        num_layers=DEPTH_6B)
    sim = preset_sim("dense-rsu", "sync", "batched", 3, arch=arch)
    drive(sim, 3)
    train_s = time.perf_counter() - t0
    d = os.path.join(root, "store")
    save_checkpoint(sim, ckpt_dir=d)
    lora = sim.cfg.lora
    live = AdapterStore.from_sim(sim)
    t1 = time.perf_counter()
    restored = AdapterStore.from_checkpoint(sim.cfg, d)
    load_ms = (time.perf_counter() - t1) * 1e3
    keys = 0
    served = {}
    for t in range(live.num_tasks):
        rsus = live.rsus(t)
        if rsus != restored.rsus(t):
            fail(f"6b: task {t} RSUs {rsus} live, {restored.rsus(t)} "
                 f"from the checkpoint")
        for rsu in rsus:
            if rsu == GLOBAL_RSU and live.servers[t]["merged"] is None:
                continue
            keys += 1
            for rank in lora.candidate_ranks:
                a, b = (st.get(t, rsu=rsu, rank=rank)
                        for st in (live, restored))
                # matched by key: a file stores its keys sorted
                if not all(leaves(tree_map(torch.equal, a.adapters,
                                           b.adapters))):
                    fail(f"6b: task {t} rsu {rsu} rank {rank}: the "
                         f"checkpoint serves other bits than the live "
                         f"simulator")
        served[t] = rsus
    if not any(len(r) > 1 for r in served.values()):
        fail(f"6b: no live partial to serve ({served})")
    for st in (live, restored):
        if st.cache.misses != keys or \
                st.cache.hits != keys * (len(lora.candidate_ranks) - 1):
            fail(f"6b: {st.cache.misses} misses, {st.cache.hits} hits for "
                 f"{keys} keys: want one SVD per key")
    misses, hits = live.cache.misses, live.cache.hits
    other = dataclasses.replace(sim.cfg, seed=sim.cfg.seed + 1)
    try:
        AdapterStore.from_checkpoint(other, d)
        fail("6b: a checkpoint of another config was served")
    except ValueError as e:
        if "DIFFERENT SimConfig" not in str(e):
            raise
        refused = str(e)[:70]
    # the store's one SVD at full width, and a get that hits
    merged, version = live.servers[0]["merged"], live.version(0)
    svd_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        agg.redistribute(merged, rank=lora.max_rank, scale=lora.scale,
                         max_rank=lora.max_rank, seed=version)
        torch.cuda.synchronize()
        svd_ms.append((time.perf_counter() - t1) * 1e3)
    hit_ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        live.get(0, rank=8)
        torch.cuda.synchronize()
        hit_ms.append((time.perf_counter() - t1) * 1e3)

    def engine(block_size):
        return ServeEngine(sim.params, sim.model_cfg, lora, ServeSpec(
            max_batch=4, cache_len=64, block_size=BLOCK_6,
            admission="evict_oldest") if block_size else ServeSpec(
            max_batch=4, cache_len=64, admission="evict_oldest"))
    paged, dense = engine(BLOCK_6), engine(0)
    # trained tenants: each servable (task, rsu) key in turn, the RSU
    # partials first, at ranks across the candidate set
    pairs = sorted(((t, r) for t, rs in enumerate(served.values())
                    for r in rs if r != GLOBAL_RSU
                    or live.servers[t]["merged"] is not None),
                   key=lambda tr: tr[1] == GLOBAL_RSU)
    ranks = (8, 32, 4, 16, 2, 32)
    tenants = [live.get(*pairs[i % len(pairs)], rank=r)
               for i, r in enumerate(ranks)]
    schedule = {0: [("admit", x) for x in tenants[:4]],
                20: [("retire", 2)],
                30: [("admit", tenants[4])],
                40: [("admit", tenants[5])]}
    per_step = per_model(arch)[1]["lora_matmul"]
    reset_counts()
    steps = 80                                   # the 64-slot ring wraps
    lanes = lockstep(paged, dense, schedule, steps)
    launched, variants = counts(), variant_counts()
    decode_launch_gate("b lockstep", launched, variants,
                       2 * per_step * steps)
    stats = paged.allocator_stats()
    if stats["recycles"] == 0:
        fail(f"6b: allocator stats {stats}: no block recycled")
    live_slots = lane_caches_agree(paged, dense)
    out = {"config": f"dense-rsu, {arch.name} at full width "
           f"({arch.num_layers} layers, d {arch.d_model}), batched, 3 "
           f"rounds; serving slot {lora.max_rank}, ranks "
           f"{list(lora.candidate_ranks)}",
           "train_s": train_s, "checkpoint_load_ms": load_ms,
           "servable": served, "keys": keys,
           "misses": misses, "hits": hits,
           "refused": refused, "redistribute_ms": svd_ms,
           "get_hit_ms": statistics.median(hit_ms),
           "events": lanes, "lockstep_steps": steps, "allocator": stats,
           "live_slots_equal": live_slots, "launches": launched,
           "lora_matmul_variants": variants,
           "flash_attention_variants": flash_variant_counts(),
           "seconds": time.perf_counter() - t0}
    del sim, live, restored, paged, dense, tenants, merged
    release()
    return out


def served_paged(cfg, lock_steps, prompt_len, gen_tokens, label="6c"):
    """Phases 6c and 6d: ``cfg`` at full width in bf16 (full depth, or
    the depth ``cfg`` is cut to): its weights' init and peak memory; a
    4 x 128 prefill, after the config's prefix embeddings where it takes
    them (every lora_matmul launch on an unbiased linear wgmma, every
    flash launch mma); then a paged and a dense ServeEngine(max_batch=4),
    lanes at ranks 8/16/32/64, in lockstep with a retire/admit
    (bit-equal), and the paged engine's counted ``generate`` with one
    retire/admit (tokens only, as the engine takes)."""
    t0 = time.perf_counter()
    lora = LoRAConfig(rank=SLOT, max_rank=SLOT)
    release()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init = {"s": time.perf_counter() - t0,
            "weights_bytes": sum(x.numel() * x.element_size()
                                 for x in leaves(params)),
            "peak_bytes": torch.cuda.max_memory_allocated() - base}
    init["params"] = sum(x.numel() for x in leaves(params))
    in_prefill, in_step = per_model(cfg)
    prefill = make_prefill_step(cfg, lora, device="cuda")
    ads = tenant(cfg, lora, SLOT, 5).adapters
    g = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 128),
                                     generator=g)}
    if cfg.num_prefix_embeds:     # a VLM's stubbed frontend
        batch["prefix_embeds"] = (0.5 * torch.randn(
            (4, cfg.num_prefix_embeds, cfg.d_model), generator=g)).to(
            "cuda", torch.bfloat16)
    prefill(params, ads, batch)                      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    logits = prefill(params, ads, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    p_counts, p_var, p_fa = counts(), variant_counts(), flash_variant_counts()
    want = dict(in_prefill)
    if p_counts != want or p_var != {"wgmma": want["lora_matmul"],
                                     "splitk": 0, "simt": 0} \
            or p_fa != {"mma": want["flash_attention"], "simt": 0}:
        fail(f"{label} {cfg.name} prefill: launches {p_counts}, lora_matmul "
             f"{p_var}, flash {p_fa}; want {want}, all wgmma and mma")
    seq = cfg.num_prefix_embeds + 128
    if tuple(logits.shape) != (4, seq, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        fail(f"{label} {cfg.name} prefill logits {tuple(logits.shape)} not "
             f"finite or not (4, {seq}, V)")
    del logits, ads, batch
    tenants = [tenant(cfg, lora, r, 20 + i) for i, r in
               enumerate(RANKS + (32,))]

    def engine(block_size):
        return ServeEngine(params, cfg, lora, ServeSpec(
            max_batch=len(RANKS), cache_len=CACHE_6, max_rank=SLOT,
            block_size=block_size), dtype=torch.bfloat16)
    paged, dense = engine(BLOCK_6), engine(0)
    for eng in (paged, dense):
        for lane, x in enumerate(tenants[:4]):
            eng.assign(lane, x)
    per_step = in_step["lora_matmul"]
    reset_counts()
    lanes = lockstep(paged, dense, {lock_steps // 2: [
        ("retire", 3), ("admit", tenants[4])]}, lock_steps)
    l_counts, l_var = counts(), variant_counts()
    decode_launch_gate(f"{label[1:]} {cfg.name} lockstep", l_counts, l_var,
                       2 * per_step * lock_steps)
    del dense
    release()
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                (len(RANKS), prompt_len))
    for lane in range(paged.max_batch):
        paged.reset_lane(lane)
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    gen1 = paged.generate(prompts, gen_tokens)
    paged.retire(3)
    paged.admit(tenants[3], lane=3)
    gen2 = paged.generate(prompts, gen_tokens)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t1
    steps = 2 * (prompt_len + gen_tokens - 1)
    d_counts, d_var = counts(), variant_counts()
    decode_launch_gate(f"{label[1:]} {cfg.name} generate", d_counts, d_var,
                       per_step * steps)
    if not gen1.shape == gen2.shape == (len(RANKS), gen_tokens):
        fail(f"{label} generate returned the wrong shape")
    out = {"model": cfg.name,
           "config": f"{cfg.name}, {cfg.num_layers} layers, full width "
           f"(d {cfg.d_model}, {cfg.num_heads} heads of "
           f"{cfg.resolved_head_dim}, {cfg.num_kv_heads} kv{shape_note(cfg)})"
           f", bf16",
           "init": init, "peak_bytes":
           torch.cuda.max_memory_allocated() - base,
           "prefill": {"batch": 4, "seq": seq, "ms": prefill_ms,
                       "launches": p_counts, "lora_matmul_variants": p_var,
                       "flash_attention_variants": p_fa},
           "lockstep_steps": lock_steps, "events": lanes,
           "lockstep_launches": l_counts,
           "lockstep_lora_matmul_variants": l_var,
           "allocator": paged.allocator_stats(),
           "decode": {"steps": steps, "ms_per_step": sec / steps * 1e3,
                      "lane_tokens_per_s": len(RANKS) * steps / sec,
                      "launches": d_counts, "lora_matmul_variants": d_var,
                      "launches_per_step": {k: v / steps for k, v in
                                            d_counts.items()}},
           "launches": {k: p_counts[k] + d_counts[k] for k in p_counts},
           "lora_matmul_variants": {k: p_var[k] + d_var[k] for k in p_var},
           "flash_attention_variants": p_fa,
           "seconds": time.perf_counter() - t0}
    del params, paged, tenants
    release()
    return out


def shape_note(cfg):
    """The MoE / MLA / SSM widths of a config, for its printed line."""
    note = ""
    if cfg.ssm is not None:
        s = cfg.ssm
        note += (f", Mamba2 SSD {s.expand * cfg.d_model // s.head_dim} "
                 f"heads of {s.head_dim}, state {s.state_dim}, conv "
                 f"{s.conv_width}, chunk {s.chunk}; the shared block after "
                 f"every {cfg.shared_attn_every} layers "
                 f"({cfg.num_layers // cfg.shared_attn_every} applications)")
    if cfg.mla is not None:
        note += (f", MLA latent {cfg.mla.kv_lora_rank} + rope "
                 f"{cfg.mla.qk_rope_head_dim}, q rank {cfg.mla.q_lora_rank}")
    if cfg.moe is not None:
        note += (f", {cfg.moe.num_experts} experts of "
                 f"{cfg.moe.expert_d_ff or cfg.d_ff} top-{cfg.moe.top_k}")
        if cfg.moe.num_shared_experts:
            note += f" + {cfg.moe.num_shared_experts} shared"
    return note


# phase 6d: one layer of grok-1 (3.2 G params of experts) or deepseek-v2
# (2.4 G) does not fit twice on the card, and no config shrinks its
# experts, so those two run at a cut depth; the rest at full depth
DEPTH_6D = {"grok-1-314b": 4, "deepseek-v2-236b": 3}
ARCHS_6D = (gemma_7b.gemma_7b, paligemma_3b.paligemma_3b,
            musicgen_medium.musicgen_medium, grok1_314b.grok1_314b,
            deepseek_v2_236b.deepseek_v2_236b)


def phase_6d():
    """The MoE, MLA and head-dim-256 archs served at full width in bf16,
    one model at a time, each freed before the next (``served_paged``):
    init and peak memory, a 4 x 128 prefill (paligemma-3b after its 256
    prefix rows), paged and dense engines in lockstep through a
    retire/admit, bit-equal, and decode ms/step."""
    t0 = time.perf_counter()
    runs = []
    for make in ARCHS_6D:
        cfg = make()
        depth = DEPTH_6D.get(cfg.name)
        if depth:
            cfg = cfg.with_overrides(
                num_layers=depth, block_pattern=cfg.blocks()[:depth]
                if cfg.block_pattern else None)
        runs.append(served_paged(cfg, 6, 4, 8, label="6d"))
    return {"runs": runs, "seconds": time.perf_counter() - t0}


def phase_6():
    """Phase 6, serving, the rest: (a) paged vs dense, qwen2-0.5b; (b)
    train -> checkpoint -> serve, vit-base-paper; (c) starcoder2-15b and
    smollm-135m served paged at full depth and width."""
    t0 = time.perf_counter()
    a = phase_6a()
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_ckpt_") as root:
        b = phase_6b(root)
    c = [served_paged(starcoder2_15b.starcoder2_15b(), 10, 8, 16),
         served_paged(smollm_135m.smollm_135m(), 16, 16, 32)]
    return {"a": a, "b": b, "c": c, "seconds": time.perf_counter() - t0}


def print_6(p6):
    a, b = p6["a"], p6["b"]
    print(f"[6a] {a['config']}: {a['lockstep_steps']} steps in lockstep, "
          f"paged == dense bit for bit (logits and greedy tokens) through "
          f"{a['events'][4:]} (step, event, lane) and a ring wrap; "
          f"allocator {a['allocator']}, its invariants after every "
          f"mutation; {a['live_slots_equal']} live slots equal; pools and "
          f"tables fixed; launches {a['lockstep_launches']['lora_matmul']} "
          f"(split-K) for both engines", flush=True)
    for label, rs in a["timed"].items():
        print(f"[6a] {label} decode, generate 16 + {GEN_6A}: " + "; ".join(
            f"{r['ms_per_step']:.2f} ms/step, {r['lane_tokens_per_s']:.1f} "
            f"lane-tok/s" for r in rs) + f"; launches per step "
            f"{rs[0]['launches']['lora_matmul'] / rs[0]['steps']:.0f} "
            f"split-K", flush=True)
    pl = a["planted_exhaustion"]
    print(f"[6a] planted fault: a pool of {pl['max_blocks']} blocks (one "
          f"short) raised BlockPoolExhausted at step "
          f"{pl['raised_at_step']} ({pl['message']}...); {a['seconds']:.1f} s",
          flush=True)
    print(f"[6b] {b['config']}: trained in {b['train_s']:.1f} s; store from "
          f"the checkpoint ({b['checkpoint_load_ms']:.1f} ms) == store from "
          f"the live simulator, bit for bit, for {b['keys']} (task, rsu) "
          f"keys x every rank (servable {b['servable']}); misses "
          f"{b['misses']}, hits {b['hits']}; one max-rank redistribute "
          f"{', '.join(f'{x:.1f}' for x in b['redistribute_ms'])} ms, a get "
          f"that hits {b['get_hit_ms']:.3f} ms; a foreign config refused "
          f"({b['refused']}...)", flush=True)
    print(f"[6b] store.admit of trained tenants, paged vs dense, "
          f"{b['lockstep_steps']} steps in lockstep through {b['events'][4:]}"
          f": bit-equal; allocator {b['allocator']}; {b['live_slots_equal']}"
          f" live slots equal; launches {b['launches']['lora_matmul']} "
          f"(split-K); {b['seconds']:.1f} s", flush=True)
    for c in p6["c"]:
        p, d = c["prefill"], c["decode"]
        print(f"[6c] {c['config']}: init {c['init']['s']:.1f} s, weights "
              f"{c['init']['weights_bytes'] / 2**30:.2f} GiB, init peak "
              f"{c['init']['peak_bytes'] / 2**30:.2f} GiB, run peak "
              f"{c['peak_bytes'] / 2**30:.2f} GiB; prefill 4x128 "
              f"{p['ms']:.2f} ms, launches {p['launches']} (lora_matmul "
              f"{p['lora_matmul_variants']}, flash "
              f"{p['flash_attention_variants']}); paged == dense over "
              f"{c['lockstep_steps']} steps with a retire/admit; paged "
              f"decode {d['steps']} steps x 4 lanes {d['ms_per_step']:.2f} "
              f"ms/step, {d['lane_tokens_per_s']:.1f} lane-tok/s, launches "
              f"per step {d['launches_per_step']} (split-K); allocator "
              f"{c['allocator']}; {c['seconds']:.1f} s", flush=True)
    print(f"[6] phase 6 took {p6['seconds']:.1f} s", flush=True)


def print_6d(p6d):
    for c in p6d["runs"]:
        p, d = c["prefill"], c["decode"]
        print(f"[6d] {c['config']}: init {c['init']['s']:.1f} s, weights "
              f"{c['init']['weights_bytes'] / 2**30:.2f} GiB, init peak "
              f"{c['init']['peak_bytes'] / 2**30:.2f} GiB, run peak "
              f"{c['peak_bytes'] / 2**30:.2f} GiB; prefill 4x{p['seq']} "
              f"{p['ms']:.2f} ms, launches {p['launches']} (lora_matmul "
              f"{p['lora_matmul_variants']}, flash "
              f"{p['flash_attention_variants']}); paged == dense over "
              f"{c['lockstep_steps']} steps with a retire/admit; paged "
              f"decode {d['steps']} steps x 4 lanes {d['ms_per_step']:.2f} "
              f"ms/step, {d['lane_tokens_per_s']:.1f} lane-tok/s, launches "
              f"per step {d['launches_per_step']} (split-K); allocator "
              f"{c['allocator']}; {c['seconds']:.1f} s", flush=True)
    print(f"[6d] phase 6d took {p6d['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 7: zamba2-2.7b served, rwkv6 in the round
# ---------------------------------------------------------------------------

ZAMBA2_PARAMS = 2_422_393_760     # the tree init_params builds at full size
# phase 3: one shared application (after layer 6) and one remainder layer
DEPTH_3_ZAMBA2 = 7
# 7b: the reduced rwkv6 round card vs CPU (seed 1 at 8 vehicles trains
# two rank groups by its second round), and rwkv6-7b's width at 2 of its
# 32 layers in the default SimConfig
RWKV_ROUND_KW = dict(num_vehicles=8, num_tasks=2, local_steps=2, seed=1)
DEPTH_7B = 2
# the round's rwkv6 linears at d 4096: the time-mix's four, the
# channel-mix's up (ck) and down (cv)
RWKV_LINEARS = (("w_r/w_k/w_v/w_o", 4096, 4096), ("ck", 4096, 14336),
                ("cv", 14336, 4096))


def check_lora_rwkv_round():
    """f32 lora_matmul at the rwkv6 round's shapes at rwkv6-7b's width: a
    train step's 240 rows (rank 2, UCB-DUAL's first arm, with the
    closed-form backward) and a local eval's 768."""
    rows = []
    for mode, M, r in (("train", TRAIN_B * TRAIN_S, 2),
                       ("local eval", 32 * TRAIN_S, 2)):
        for linear, K, N in RWKV_LINEARS:
            rows.append(lora_train_row(mode, M, linear, K, N, r,
                                       model="rwkv6-7b"))
    return rows


def check_wkv_train(cfg):
    """wkv6 at the round's train step at rwkv6-7b's width (B 10, S 24,
    64 heads of 64, f32): the kernel's forward against the plain version
    (y and state relative 1e-5), and one training call, the forward and
    the backward (autograd of the plain version, as ``_WKV6.backward``
    runs it), timed beside the plain version's."""
    f32 = torch.float32
    B, S = TRAIN_B, TRAIN_S
    H, K = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    args = wkv_operands(B, S, H, K, f32, f32, None, 77)
    y, st = wkv_ops.wkv6(*args)
    yp, sp = wkv_ops._plain(*args, wkv_ops.CHUNK)
    rel, s_rel = rel_err(y, yp), rel_err(st, sp)
    tol = TOL[("wkv6", f32)]
    if not (rel < tol and s_rel < tol and torch.isfinite(y).all()):
        fail(f"wkv6 round train: y rel {rel}, state rel {s_rel}")
    g = torch.Generator(device="cuda").manual_seed(78)
    gy = torch.randn(y.shape, generator=g, device="cuda")
    gs = torch.randn(st.shape, generator=g, device="cuda")

    def train(fn):
        ins = [t.detach().requires_grad_() for t in args]
        out = fn(*ins)
        return torch.autograd.grad(out, ins, (gy, gs))
    got = train(wkv_ops.wkv6)
    want = train(lambda *a: wkv_ops._plain(*a, wkv_ops.CHUNK))
    bwd = max(rel_err(a, b) for a, b in zip(got, want))
    if not bwd < tol:
        fail(f"wkv6 round train: backward rel {bwd} >= {tol}")
    n = B * S * H * K
    b_ms, b_by = wkv_bound(B, S, H, K, 4, 4)
    # the backward's own work: twice the forward's flops; gy and the
    # state's gradient read, r, k, v, logw, u read again and their
    # gradients written
    bwd_bound = bound(4 * (n + B * H * K * K + 2 * (4 * n + H * K)),
                      {f32: 10.0 * B * H * S * K * K})[0]
    vs, vt, grid = wkv_ops.plan(B, H, K, sms())
    return [{"name": "wkv6", "model": cfg.name, "case": "round train",
             "mode": "train", "dtype": "float32", "logw_dtype": "float32",
             "shape": f"B={B} S={S} H={H} K={K}", "yardstick": "wkv6_chunked",
             "plan": f"VS={vs} VT={vt} grid {grid}",
             "max_abs_err": maxabs(y, yp), "rel_err": rel,
             "state_rel_err": s_rel, "bwd_rel_err": bwd, "tol": tol,
             "ms": timed_ms(lambda: wkv_ops.wkv6(*args)),
             "plain_ms": timed_ms(
                 lambda: wkv_ops._plain(*args, wkv_ops.CHUNK)),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
             "train_ms": timed_ms(lambda: train(wkv_ops.wkv6)),
             "plain_train_ms": timed_ms(lambda: train(
                 lambda *a: wkv_ops._plain(*a, wkv_ops.CHUNK))),
             "bwd_bound_ms": bwd_bound}]


def phase_7a():
    """zamba2-2.7b served at full depth and width in bf16
    (``served_paged``): 54 Mamba2 layers and 9 applications of the shared
    block, weights 2,422,393,760 parameters; a 4 x 128 prefill (171
    lora_matmul launches, all wgmma; 9 flash, all mma, head dim 80);
    paged == dense through a retire/admit; decode ms/step (171 split-K
    launches a step)."""
    run = served_paged(zamba2_2_7b.zamba2_2_7b(), 6, 4, 8, label="7a")
    if run["init"]["params"] != ZAMBA2_PARAMS:
        fail(f"7a zamba2-2.7b holds {run['init']['params']} parameters, "
             f"want {ZAMBA2_PARAMS}")
    return run


def phase_7b():
    """rwkv6 as the round's train_arch. (1) The reduced rwkv6 round card
    against CPU under serial, batched and fused (5a's gates: plans and
    counts exact; energy, latency and merged deltas within 1e-4; wkv6
    launched, flash not). (2) rwkv6-7b's width at 2 of its 32 layers in
    the default SimConfig: one batched round (launches equal to its
    groups' prediction, wkv6 once per layer and forward) and two fused
    rounds (the first run eagerly and captured, the second a replay;
    launches at the eager run and the capture as predicted), equal to
    the same two rounds run eagerly within 1e-6."""
    t0 = time.perf_counter()
    par = {e: round_parity(e, rwkv6_7b.reduced(), **RWKV_ROUND_KW)
           for e in ("serial", "batched", "fused")}
    full = rwkv6_7b.rwkv6_7b()
    arch = full.with_overrides(num_layers=DEPTH_7B,
                               block_pattern=full.blocks()[:DEPTH_7B])
    params = T.init_params(arch, seed=0, dtype=torch.float32, device="cuda")
    batched = full_rounds("batched", 0, plain=1, arch=arch, params=params)
    batched.pop("_state")
    release()
    per_fwd = round_per_fwd(arch, SimConfig().lora)
    forwards = SimConfig().num_tasks * (SimConfig().local_steps + 2)
    want = {k: 2 * n * forwards for k, n in per_fwd.items()}
    runs, launched = {}, {}
    for name, capture in (("captured", True), ("eager", False)):
        release()
        reset_counts()
        t1 = time.perf_counter()
        runs[name] = fused_run(arch, 2, capture=capture, params=params)
        torch.cuda.synchronize()
        launched[name] = dict(counts(), seconds=time.perf_counter() - t1,
                              lora_matmul_variants=variant_counts(),
                              flash_attention_variants=flash_variant_counts())
        if {k: launched[name][k] for k in want} != want:
            fail(f"7b {arch.name} fused {name}: launches {launched[name]}, "
                 f"{want} predicted (two runs of {forwards} forwards)")
        for rec in runs[name]["recs"]:
            if not (np.isfinite(rec["energy"])
                    and np.isfinite(rec["accuracy"])):
                fail(f"7b {arch.name} fused {name}: not finite")
    diff = fused_state_diff(runs["captured"], runs["eager"], 2)
    if not diff <= REPLAY_TOL:
        fail(f"7b {arch.name} fused replay vs eager: {diff} > {REPLAY_TOL}")
    del runs, params
    release()
    return {"parity": par, "batched": batched, "fused_launches": launched,
            "fused_predicted": want, "replay_vs_eager": diff,
            "config": f"{arch.name}, {DEPTH_7B} of {full.num_layers} layers,"
            f" d {arch.d_model}, {arch.d_model // arch.rwkv.head_dim} wkv "
            f"heads of {arch.rwkv.head_dim}, f32; SimConfig() otherwise "
            "default", "seconds": time.perf_counter() - t0}


def print_7(p7a, p7b):
    c = p7a
    p, d = c["prefill"], c["decode"]
    print(f"[7a] {c['config']}: {c['init']['params']:,} parameters, init "
          f"{c['init']['s']:.1f} s, weights "
          f"{c['init']['weights_bytes'] / 2**30:.2f} GiB, init peak "
          f"{c['init']['peak_bytes'] / 2**30:.2f} GiB, run peak "
          f"{c['peak_bytes'] / 2**30:.2f} GiB; prefill 4x{p['seq']} "
          f"{p['ms']:.2f} ms, launches {p['launches']} (lora_matmul "
          f"{p['lora_matmul_variants']}, flash "
          f"{p['flash_attention_variants']}); paged == dense over "
          f"{c['lockstep_steps']} steps with a retire/admit; paged decode "
          f"{d['steps']} steps x 4 lanes {d['ms_per_step']:.2f} ms/step, "
          f"{d['lane_tokens_per_s']:.1f} lane-tok/s, launches per step "
          f"{d['launches_per_step']} (split-K); allocator "
          f"{c['allocator']}; {c['seconds']:.1f} s", flush=True)
    for engine, p5 in p7b["parity"].items():
        print(f"[7b] {p5['config']}, card vs CPU: one round: ranks "
              f"{p5['ranks']}, active {p5['active']} equal, merged deltas "
              f"rel {p5['merged_delta_rel_err']:.3g}, energy rel "
              f"{p5['energy_rel_err']:.3g}, latency rel "
              f"{p5['latency_rel_err']:.3g} (tol {ROUND_TOL}); round "
              f"{p5['card_round_ms']:.0f} ms on the card, "
              f"{p5['cpu_round_ms']:.0f} ms on the CPU; launches "
              f"{p5['launches']}"
              + (f"; captures {p5['captures']}" if p5["captures"] else ""),
              flush=True)
    b = p7b["batched"]
    up = b["unprofiled_round"]
    print(f"[7b] {b['config']}: one batched round (unprofiled) wall "
          f"{up['wall_ms']:.1f} ms, peak memory "
          f"{up['peak_memory_bytes'] / 2**30:.2f} GiB, groups (task, rank, "
          f"lanes, steps) {up['groups_each'][0]}, launches "
          f"{b['launches']} = the groups' prediction; energy "
          f"{up['energy']:.2f} J, accuracy {up['accuracy']:.4f}",
          flush=True)
    for name, n in p7b["fused_launches"].items():
        print(f"[7b] {p7b['config']}: fused, two rounds {name} in "
              f"{n['seconds']:.1f} s, launches "
              f"{ {k: n[k] for k in p7b['fused_predicted']} } (predicted "
              f"{p7b['fused_predicted']}: the first round's eager run and "
              f"{'the capture' if name == 'captured' else 'the second'})",
              flush=True)
    print(f"[7b] fused replay vs eager over 2 rounds: "
          f"{p7b['replay_vs_eager']:.3g} (tol {REPLAY_TOL}); phase 7b took "
          f"{p7b['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 8: the training entry point
# ---------------------------------------------------------------------------

# (a) the CLI at smollm-135m's full width in f32, as it builds it
CLI_8A = ["--arch", "smollm-135m", "--full"]
STEPS_8A = 20
EVERY_8A = 10
# (b) the README's two --simulate lines, their horizons cut to 4 and 2
SIM_8B = ({"simulate": "rsu-outage", "participation": "semi-sync",
           "engine": "fused", "rounds": 4},
          {"simulate": "sparse-rural", "participation": "sync",
           "rounds": 2})
# (c) qwen2-0.5b at full width in bf16 at train_4k's sequence length;
# global batch 4 for train_4k's 256
SHAPE_8C = "train_4k"
BATCH_8C = 4
STEPS_8C = 6
RANK_8C = 8
LR_8C = 1e-3
STEP_KW_8C = dict(remat=True, ce_chunk=512, microbatch=2)
# (d) the same step card vs CPU in f32 at 2 of the 24 layers
DEPTH_8D = 2
SEQ_8D = 256
STEP_KW_8D = dict(remat=True, ce_chunk=128, microbatch=2)
LOSS_TOL_8D = 1e-4
MU_TOL_8D = 1e-3        # of each leaf's largest entry


def sim_args(run):
    out = []
    for k, v in run.items():
        out += [f"--{k}", str(v)]
    return out


def start_cli(args, device="cuda"):
    """The training CLI in a subprocess, started as a user starts it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            device] + list(args)
    return subprocess.Popen(argv, cwd=HERE, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_cli(proc, what, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        fail(f"8 {what}: exit {proc.returncode}: {err[-3000:]}")
    return out


def cli_in_process(args, device="cuda"):
    """The CLI's ``main`` in this process (its launches are counted
    here); its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_mod.main(["--device", device] + list(args))
    return out.getvalue()


def loss_lines(text):
    return [(int(i), float(x)) for i, x in
            re.findall(r"step\s+(\d+) loss=([0-9.]+)", text)]


def round_lines(text):
    return [line for line in text.splitlines() if line.startswith("round ")]


def sim_in_process(run, device="cuda"):
    """``scenarios.build_sim`` with the CLI's arguments, run as the CLI
    runs it; its round lines and launches."""
    kw = {"participation": run["participation"]}
    if run.get("engine"):
        kw["engine"] = run["engine"]
    reset_counts()
    sim = scenarios.build_sim(run["simulate"], rounds=run["rounds"], seed=0,
                              device=device, **kw)
    hist = (sim.run_scanned(run["rounds"]) if sim.fused is not None
            else sim.run())
    if device == "cuda":
        torch.cuda.synchronize()
    launched = {"launches": counts(),
                "lora_matmul_variants": variant_counts(),
                "flash_attention_variants": flash_variant_counts()}
    lines = [f"round {rec['round']:3d} acc={rec['accuracy']:.4f} "
             f"energy={rec['energy']:.1f} reward={rec['reward']:.3f}"
             for rec in hist]
    del sim
    release()
    return lines, launched


def planted_rng_resume(src, dst, args, device="cuda"):
    """Planted fault: a resume whose RNG state is not restored, i.e.
    the checkpoint's data cursor put back at the stream's start. Returns
    the directory its run wrote."""
    os.makedirs(dst)
    name = os.path.basename(src)
    state = load_pytree(src, numpy=True)
    meta = json.loads(bytes(state["meta"]).decode())
    meta["rng"] = np.random.default_rng(0).bit_generator.state
    state["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    save_pytree(os.path.join(dst, name), state)
    cli_in_process(args + ["--resume", "--checkpoint-dir", dst], device)
    return dst


def phase_8a(root, device="cuda", args=CLI_8A, sims=SIM_8B):
    """(a) and (b): the CLI in subprocesses, each started as a user
    starts it. 20 uninterrupted steps with a checkpoint every 10, and 10
    steps whose run ends there, resumed in this process to 20 (its
    launches counted): every leaf of the last checkpoints (adapters, mu,
    nu, step, meta with the RNG state) bit-equal, the first ones too;
    two planted faults (a resume with the RNG state not restored, a
    resume under another --lr) must fail. Meanwhile the two --simulate
    runs, whose round lines must equal ``scenarios.build_sim``'s run in
    this process."""
    whole, cut = os.path.join(root, "whole"), os.path.join(root, "cut")
    every = ["--checkpoint-every", str(EVERY_8A)]
    procs = {}
    try:
        t0 = time.perf_counter()
        procs["whole"] = start_cli(args + every + [
            "--steps", str(STEPS_8A), "--checkpoint-dir", whole], device)
        procs["cut"] = start_cli(args + every + [
            "--steps", str(EVERY_8A), "--checkpoint-dir", cut], device)
        for i, run in enumerate(sims):
            procs[f"sim{i}"] = start_cli(sim_args(run), device)
        # the --simulate runs again, here, while the subprocesses run
        local = [sim_in_process(run, device) for run in sims]
        cut_out = finish_cli(procs["cut"], "the 10-step CLI run")
        reset_counts()
        t1 = time.perf_counter()
        resumed = cli_in_process(args + every + [
            "--steps", str(STEPS_8A), "--resume", "--checkpoint-dir", cut],
            device)
        if device == "cuda":
            torch.cuda.synchronize()
        resume_s = time.perf_counter() - t1
        resume_launch = {"launches": counts(),
                         "lora_matmul_variants": variant_counts(),
                         "flash_attention_variants": flash_variant_counts()}
        whole_out = finish_cli(procs["whole"], "the uninterrupted CLI run")
        sim_out = [finish_cli(procs[f"sim{i}"], f"--simulate {run}")
                   for i, run in enumerate(sims)]
        subprocess_s = time.perf_counter() - t0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if f"resumed from step {EVERY_8A}" not in resumed:
        fail(f"8a the resumed run did not resume: {resumed[-500:]}")
    last = f"round_{STEPS_8A:06d}.npz"
    first = f"round_{EVERY_8A:06d}.npz"
    diff = (checkpoint_diff(os.path.join(whole, last), os.path.join(cut, last))
            + checkpoint_diff(os.path.join(whole, first),
                              os.path.join(cut, first)))
    if diff:
        fail(f"8a resumed checkpoints differ from the uninterrupted run's: "
             f"{diff[:8]}")
    ckpt = load_pytree(os.path.join(cut, last), numpy=True)
    leaves_n = len(np.load(os.path.join(cut, last)).files) - 1
    meta = json.loads(bytes(ckpt["meta"]).decode())
    losses = loss_lines(whole_out)
    if not (losses and losses[-1][1] < losses[0][1]):
        fail(f"8a the last printed loss is not below the first: {losses}")
    # the printed losses of the cut and resumed runs at the steps the
    # uninterrupted run printed (every 10th and the last)
    want, seen = dict(losses), set()
    for i, x in loss_lines(cut_out + resumed):
        if i in want:
            seen.add(i)
            if x != want[i]:
                fail(f"8a step {i}: the cut or resumed run printed loss {x}"
                     f", the uninterrupted run {want[i]}")
    if seen != set(want):
        fail(f"8a the cut and resumed runs printed steps {sorted(seen)}, "
             f"want {sorted(want)}")
    # planted faults
    fault_dir = planted_rng_resume(os.path.join(cut, first),
                                   os.path.join(root, "fault"), args + every
                                   + ["--steps", str(STEPS_8A)], device)
    rng_diff = checkpoint_diff(os.path.join(whole, last),
                               os.path.join(fault_dir, last))
    if not any(k.startswith("adapters") for k in rng_diff):
        fail("8a planted fault (resume without the RNG state) was not "
             "caught")
    try:
        cli_in_process(args + every + ["--steps", str(STEPS_8A), "--resume",
                                       "--lr", "2e-3", "--checkpoint-dir",
                                       cut], device)
        refused = None
    except SystemExit as e:
        refused = str(e)
    if not refused or "different run config" not in refused:
        fail(f"8a a resume under another --lr was not refused ({refused})")
    # (b) the --simulate lines against the in-process runs
    sims_out = []
    for run, text, (lines, launched) in zip(sims, sim_out, local):
        got = round_lines(text)
        if got != lines or len(got) != run["rounds"]:
            fail(f"8b --simulate {run}: the CLI printed {got}, build_sim "
                 f"gives {lines}")
        sims_out.append({"run": run, "lines": got, "launched": launched,
                         "done": text.strip().splitlines()[-1]})
    return {"cli": " ".join(args), "steps": STEPS_8A, "every": EVERY_8A,
            "losses": losses, "leaves_compared": leaves_n,
            "meta_step": meta["step"], "fingerprint": meta["fingerprint"],
            "resume_s": resume_s, "subprocess_wall_s": subprocess_s,
            "resume_launch": resume_launch,
            "planted_rng_leaves_differing": len(rng_diff),
            "planted_lr_refused": refused, "sims": sims_out}


def synthetic_batch(rng, V, B, S, device):
    """The CLI's synthetic task: tok_{t+1} = (7·tok_t + 1) mod V."""
    seq = [rng.integers(0, V, size=(B, 1))]
    for _ in range(S):
        seq.append((seq[-1] * 7 + 1) % V)
    toks = np.concatenate(seq, 1)
    return {"tokens": torch.as_tensor(toks[:, :-1], device=device),
            "labels": torch.as_tensor(toks[:, 1:], device=device)}


def step_prediction(cfg, microbatch, remat):
    """Launches of one train step: per forward, one lora_matmul per
    kernel linear of each layer and one flash per attention layer;
    ``microbatch`` forwards, each run twice under remat (the backward's
    recompute). The backward passes are plain PyTorch."""
    per_fwd, _ = per_model(cfg)
    n = microbatch * (2 if remat else 1)
    return {"lora_matmul": per_fwd["lora_matmul"] * n,
            "flash_attention": per_fwd["flash_attention"] * n,
            "wkv6": per_fwd["wkv6"] * n}


def phase_8c(cfg=None, device="cuda", batch=BATCH_8C, steps=STEPS_8C):
    """(c) ``make_train_step`` at qwen2-0.5b's full width in bf16 at
    train_4k's sequence length, through ``placed_step`` on a one-device
    mesh: remat, ce_chunk 512, two microbatches, rank 8. Every step's
    launches must equal the prediction, every lora_matmul on wgmma and
    every flash on mma; ms/step, tokens/s, the losses and the peak of
    ``max_memory_allocated``."""
    cfg = cfg or qwen2_0_5b.qwen2_0_5b()
    S = get_input_shape(SHAPE_8C).seq_len if device == "cuda" else 64
    lora = LoRAConfig(rank=RANK_8C)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    adapters = to(nontrivial(T.init_adapters(cfg, lora, seed=1, rank=RANK_8C,
                                             device="cpu"), 8), device)
    opt_state = adam(LR_8C).init(adapters)
    mesh = make_mesh((1, 1), ("data", "model"), device)
    _, placed = train_mod.make_train_step(cfg, lora, mesh, lr=LR_8C,
                                          **STEP_KW_8C)
    init_s = time.perf_counter() - t0
    want = step_prediction(cfg, STEP_KW_8C["microbatch"],
                           STEP_KW_8C["remat"])
    rng = np.random.default_rng(0)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, ms, total = [], [], {k: 0 for k in want}
    lm_var = {k: 0 for k in lm_ops.launches_by_variant}
    fa_var = {k: 0 for k in fa_ops.launches_by_variant}
    # the last step on the card runs under the profiler (below)
    for i in range(steps - 1 if device == "cuda" else steps):
        b = synthetic_batch(rng, cfg.vocab_size, batch, S, device)
        reset_counts()
        t1 = time.perf_counter()
        adapters, opt_state, m = placed(params, adapters, opt_state, b)
        loss = float(m["loss"])          # waits for the step
        ms.append((time.perf_counter() - t1) * 1e3)
        got, lv, fv = counts(), variant_counts(), flash_variant_counts()
        if got != want or lv["wgmma"] != want["lora_matmul"] or \
                fv["mma"] != want["flash_attention"]:
            fail(f"8c step {i}: launches {got} ({lv}, {fv}), want {want} "
                 f"(all wgmma / mma)")
        if not np.isfinite(loss):
            fail(f"8c step {i}: loss {loss}")
        losses.append(loss)
        for k in total:
            total[k] += got[k]
        for k in lm_var:
            lm_var[k] += lv[k]
        for k in fa_var:
            fa_var[k] += fv[k]
    step_ms = statistics.median(ms[1:])
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    # the last step under the profiler: where a step's device time goes
    prof = None
    if device == "cuda":
        b = synthetic_batch(rng, cfg.vocab_size, batch, S, device)
        box = {}

        def one():
            box["out"] = placed(params, adapters, opt_state, b)
        reset_counts()
        prof = device_profile(one, top=8)
        if counts() != want:
            fail(f"8c profiled step: launches {counts()}, want {want}")
        adapters, opt_state, _ = box["out"]
        for k in total:
            total[k] += want[k]
        lm_var["wgmma"] += want["lora_matmul"]
        fa_var["mma"] += want["flash_attention"]
    out = {"config": f"{cfg.name}, {cfg.num_layers} layers, d "
           f"{cfg.d_model}, bf16, global batch {batch} x seq {S} "
           f"({SHAPE_8C}'s seq; its batch {get_input_shape(SHAPE_8C).global_batch} "
           f"cut to {batch}), rank {RANK_8C}, {STEP_KW_8C}",
           "init_s": init_s, "ms_per_step": ms, "median_ms": step_ms,
           "tokens_per_s": batch * S / step_ms * 1e3, "losses": losses,
           "peak_memory_bytes": peak, "predicted_per_step": want,
           "profile": prof,
           "launches": total, "lora_matmul_variants": lm_var,
           "flash_attention_variants": fa_var}
    del params, adapters, opt_state
    release()
    return out


def phase_8d(cfg_full=None, seq=SEQ_8D, device="cuda"):
    """(d) the same step card vs CPU in f32 at full width with 2 of the
    24 layers: the loss to 1e-4 and Adam's mu after one step (the first
    step's adapter gradients, times 1 - b1) to 1e-3 of each leaf's
    largest entry. Weights drawn on the card and copied to the host."""
    cfg_full = cfg_full or qwen2_0_5b.qwen2_0_5b()
    cfg = cfg_full.with_overrides(num_layers=DEPTH_8D)
    lora = LoRAConfig(rank=RANK_8C)
    params = {device: T.init_params(cfg, seed=1, dtype=torch.float32,
                                    device=device)}
    params["cpu"] = to(params[device], "cpu")
    ads = nontrivial(T.init_adapters(cfg, lora, seed=2, rank=RANK_8C,
                                     device="cpu"), 2)
    batch = synthetic_batch(np.random.default_rng(1), cfg.vocab_size, 2,
                            seq, "cpu")
    got = {}
    for dev in ("cpu", device):
        step, _ = train_mod.make_train_step(cfg, lora, lr=LR_8C,
                                            **STEP_KW_8D)
        a = to(ads, dev)
        reset_counts()
        t0 = time.perf_counter()
        _, opt, m = step(params[dev], a, adam(LR_8C).init(a),
                         to(batch, dev))
        loss = float(m["loss"])
        got[dev] = {"loss": loss, "mu": to(opt.mu, "cpu"),
                    "s": time.perf_counter() - t0,
                    "launches": counts(),
                    "lora_matmul_variants": variant_counts(),
                    "flash_attention_variants": flash_variant_counts()}
    loss_err = abs(got[device]["loss"] - got["cpu"]["loss"])
    mu_err = max(maxabs(x, y) / max(float(y.abs().max()), 1e-30)
                 for x, y in zip(leaves(got[device]["mu"]),
                                 leaves(got["cpu"]["mu"])))
    if not (loss_err < LOSS_TOL_8D and mu_err < MU_TOL_8D):
        fail(f"8d card vs CPU: loss {loss_err} (tol {LOSS_TOL_8D}), mu "
             f"{mu_err} of the largest entry (tol {MU_TOL_8D})")
    want = step_prediction(cfg, STEP_KW_8D["microbatch"],
                           STEP_KW_8D["remat"])
    if device == "cuda" and got[device]["launches"] != want:
        fail(f"8d launches {got[device]['launches']}, want {want}")
    out = {"config": f"{cfg.name}, {DEPTH_8D} of {cfg_full.num_layers} "
           f"layers, full width, f32, batch 2 x seq {seq}, {STEP_KW_8D}",
           "loss_card": got[device]["loss"], "loss_cpu": got["cpu"]["loss"],
           "loss_err": loss_err, "mu_rel_err": mu_err,
           "card_s": got[device]["s"], "cpu_s": got["cpu"]["s"],
           **{k: got[device][k] for k in ("launches", "lora_matmul_variants",
                                          "flash_attention_variants")}}
    del params, got
    release()
    return out


def check_train_4k(cfg):
    """(e) the step's new kernel shapes: lora_matmul bf16 at 2 x 4096
    rows (one microbatch) for o (896 -> 896), up/gate (896 -> 4864) and
    down (4864 -> 896) at rank 8; flash bf16 at B 2, S 4096, 14 heads on
    2, head dim 64, causal."""
    rows_ = 2 * get_input_shape(SHAPE_8C).seq_len
    d, f = cfg.d_model, cfg.d_ff
    cases = [("o", "train_4k", 1, rows_, d, d),
             ("up/gate", "train_4k", 1, rows_, d, f),
             ("down", "train_4k", 1, rows_, f, d)]
    out = check_lora(cfg, torch.bfloat16, cases, slot=RANK_8C)
    out += check_flash(cfg, torch.bfloat16, (get_input_shape(
        SHAPE_8C).seq_len,), B=2)
    for r in out:
        r["mode"] = "train_4k"
    return out


def phase_8(device="cuda"):
    """Phase 8: (a)+(b) the CLI, (c) the train_4k step, (d) card vs CPU,
    (e) the new kernel shapes; each path driven with the counts set to
    0 just before it and read just after. Checkpoints go to a temporary
    directory in the checkout, removed at the end."""
    root = tempfile.mkdtemp(prefix=".chip_ckpt_8_", dir=HERE)
    try:
        a = phase_8a(root, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    c = phase_8c(device=device)
    d = phase_8d(device=device)
    e = check_train_4k(qwen2_0_5b.qwen2_0_5b())
    paths = {f"smollm-135m train CLI --full, steps {EVERY_8A}-"
             f"{STEPS_8A - 1} resumed in-process (8a)": a["resume_launch"]}
    for s in a["sims"]:
        r = s["run"]
        paths[f"--simulate {r['simulate']} {r['participation']} "
              f"{r.get('engine', 'batched')} {r['rounds']} rounds, "
              f"build_sim in-process (8b)"] = s["launched"]
    paths[f"qwen2-0.5b train_4k step x {STEPS_8C}, the last profiled "
          f"(8c)"] = c
    paths[f"qwen2-0.5b {DEPTH_8D} layers f32 card step (8d)"] = d
    return {"a": a, "c": c, "d": d, "rows": e,
            "paths": {p: r["launches"] for p, r in paths.items()},
            "runs": list(paths.values())}


def print_8(p8):
    a, c, d = p8["a"], p8["c"], p8["d"]
    print(f"[8a] {a['cli']}: {a['steps']} steps, a checkpoint every "
          f"{a['every']}: loss {a['losses'][0][1]:.4f} -> "
          f"{a['losses'][-1][1]:.4f} (printed at steps "
          f"{[i for i, _ in a['losses']]}); 10 steps in a subprocess, then "
          f"--resume in this process ({a['resume_s']:.1f} s, launches "
          f"{a['resume_launch']['launches']}): both checkpoints' "
          f"{a['leaves_compared']} leaves bit-equal to the uninterrupted "
          f"run's (meta step {a['meta_step']}); planted faults: resume "
          f"without the RNG state ({a['planted_rng_leaves_differing']} "
          f"leaves differ, caught), another --lr refused "
          f"({a['planted_lr_refused']!r}); subprocesses "
          f"{a['subprocess_wall_s']:.1f} s wall", flush=True)
    for s in a["sims"]:
        print(f"[8b] --simulate {s['run']}: {len(s['lines'])} round lines "
              f"equal to build_sim's in-process run ({s['lines'][-1]}; "
              f"{s['done']}); launches in-process "
              f"{s['launched']['launches']}", flush=True)
    print(f"[8c] {c['config']}: init {c['init_s']:.1f} s; "
          f"{c['median_ms']:.1f} ms/step (median of steps 1-"
          f"{len(c['ms_per_step']) - 1}; each {[round(x, 1) for x in c['ms_per_step']]}), "
          f"{c['tokens_per_s']:.0f} tokens/s; losses "
          f"{[round(x, 4) for x in c['losses']]}; peak memory "
          f"{c['peak_memory_bytes'] / 2**30:.2f} GiB; launches per step "
          f"{c['predicted_per_step']} as predicted, lora_matmul "
          f"{c['lora_matmul_variants']}, flash {c['flash_attention_variants']}"
          f" over {STEPS_8C} steps (the last profiled)", flush=True)
    pr = c["profile"]
    print(f"[8c] a profiled step: wall {pr['wall_ms']:.1f} ms, device "
          f"{pr['device_ms']:.1f} ms (busy {pr['busy_share']:.3f}); port "
          f"kernels: " + "; ".join(f"{k} {t['ms']:.2f} ms x{t['count']}"
                                   for k, t in pr["port_kernels"].items())
          + "; top: " + "; ".join(f"{t['kernel'][:60]} {t['ms']:.2f} ms "
                                  f"x{t['count']}" for t in pr["top"]),
          flush=True)
    print(f"[8d] {d['config']}: loss card {d['loss_card']:.6f}, CPU "
          f"{d['loss_cpu']:.6f} (|diff| {d['loss_err']:.3g}, tol "
          f"{LOSS_TOL_8D}); first step's mu max rel {d['mu_rel_err']:.3g} "
          f"(tol {MU_TOL_8D}); card {d['card_s']:.1f} s, CPU "
          f"{d['cpu_s']:.1f} s; launches {d['launches']}", flush=True)
    for r in p8["rows"]:
        extra = (f", kernel alone {r['kernel_ms']:.4f} ms "
                 f"({r['kernel_tflops']:.1f} TFLOP/s)"
                 if r["name"] == "lora_matmul" else
                 f", per row vs f32 {r['row_rel_err']:.3g} (tol "
                 f"{r['row_tol']}; keys {r['planted_keys']} lost: "
                 f"{r['planted_row_rel_err']:.3g}, max abs "
                 f"{r['planted_abs_err']:.3g}), {r['tflops']:.1f} TFLOP/s, "
                 f"{r['vs_library']:.2f}x SDPA")
        print(f"[8e] {r['name']} {r.get('linear', '')} {r['variant']} "
              f"{r['dtype']} {r['shape']}: err {r['max_abs_err']:.3g} (tol "
              f"{r['tol']}), ms {r['ms']:.4f}, plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}){extra}", flush=True)


# ---------------------------------------------------------------------------
# Phase 9: the device-sharded fleet
# ---------------------------------------------------------------------------

# the reference test's _sim: 6 vehicles, 2 tasks, 1 local step, 2 rounds
SHARD_KW_9A = dict(num_vehicles=6, num_tasks=2, local_steps=1, seed=3)
ROUNDS_9 = 2
TOPOLOGIES_9A = ((2, "roundrobin"), (2, "block"), (4, "roundrobin"),
                 (4, "block"))
# the presets at N 2 (seed 1, their own fleets; rsu-outage's max_delay 3)
PRESETS_9A = (("dense-rsu", {}, ROUNDS_9),
              ("rsu-outage", {"participation": ParticipationSpec(
                  mode="semi_sync", max_delay=3)}, 6))
SHARDS_9B = 2
# 9b against 5c's fused rounds: the reduced-ViT tolerance of 5a is 1e-4
# (card vs CPU); one card and one seed at full width, 1e-5 as 5c holds
# fused to batched
SHARD_TOL_9B = 1e-5


def card_shards(n):
    """n shards, all on the one card."""
    return ["cuda:0"] * n


def shard_sim(device, n=None, placement="roundrobin", preset=None,
              capture=None, fault=None, arch=None, **modes):
    """SHARD_KW_9A's SimConfig (or ``preset``, a (name, SimConfig fields,
    rounds) of PRESETS_9A) on ``device``: unsharded fused without ``n``,
    else over n shards on ``device`` repeated. ``capture=False`` runs the
    program eagerly; ``fault(engine)`` plants a fault."""
    kw = {}
    if n is not None:
        devs = ["cpu"] * n if device == "cpu" else card_shards(n)
        kw = {"engine": "fused_sharded", "fleet_devices": devs,
              "shard": ShardSpec(num_shards=n, placement=placement)}
    if preset is not None:
        name, fields, rounds = preset
        sim = scenarios.build_sim(name, rounds=rounds, seed=1,
                                  device=device,
                                  **{"engine": "fused", **fields, **kw})
    else:
        sim_kw = {"fleet_devices": kw.pop("fleet_devices")} if kw else {}
        if arch is not None:
            modes["train_arch"] = arch
        sim = IoVSimulator(SimConfig(**{"engine": "fused", **SHARD_KW_9A,
                                        **modes, **kw}),
                           device=device, **sim_kw)
    if capture is False:
        sim.fused = FusedRoundEngine(sim, capture=False,
                                     devices=sim.fleet_devices)
    if fault is not None:
        fault(sim.fused)
    sim.plans_9 = []
    recording(sim, sim.plans_9)
    sim.state_9 = {"recs": [], "plans": [], "merged": [], "ucb": [],
                   "modes": []}
    return sim


def shard_round(sim):
    """One round of a phase-9 simulator and its readings: the record, the
    plans, the merged deltas and UCB-DUAL states (on the CPU), the
    tier's partials and semi_sync's buffer."""
    st, nt = sim.state_9, sim.cfg.num_tasks
    st["recs"].append(sim.run_round())
    st["plans"].append(sim.plans_9[-nt:])
    st["merged"].append([None if s.merged is None else
                         tree_map(lambda t: t.cpu(), s.merged)
                         for s in sim.servers])
    st["ucb"].append([tuple(x.cpu().clone() for x in u)
                      for u in sim.ucb_states])
    st["modes"].append(None if (sim.cfg.rsu_tier.trivial
                                and sim.cfg.participation.trivial)
                       else mode_states(sim))
    return st


def shard_alone(sim, rounds=ROUNDS_9):
    for _ in range(rounds):
        shard_round(sim)
    return sim.state_9


def shard_lockstep(base, others, rounds=ROUNDS_9):
    """``base`` and each of ``others`` round by round; each other's round
    r >= 1 starts from base's state after round r - 1
    (:func:`adopt_mode_state`) and trains from base's SVD redistribution
    (:func:`share_distribution`), so that each round is compared from one
    state (5e's method). Returns base's readings."""
    for rnd in range(rounds):
        if rnd:
            for o in others:
                adopt_mode_state(o, base)
                if rnd == 1:
                    share_distribution(o, base)
        shard_round(base)
        for o in others:
            shard_round(o)
    return base.state_9


def shard_gates(got, want, tol, label, fro=None, check=True):
    """``got`` (a sharded run's readings) against ``want``'s, round by
    round: plans (active sets, ranks, departures), active, departing,
    handoffs, fallbacks, comm_params, mean_rank, deferred, released,
    which tasks have merged deltas, and UCB-DUAL counts exact; energy and
    latency relative, UCB-DUAL sums and the merged deltas relative to
    each leaf's largest entry, each within ``tol``; from round 1 on, with
    ``fro``, the merged deltas as a Frobenius spread within ``fro``
    instead (the largest entry recorded); a tier's partials and
    semi_sync's buffer: weights within ``tol``, ages, destinations and
    vehicles exact, deltas as a spread within ``fro`` (else ``tol``).
    Fails (when ``check``) on any gate; returns the largest
    differences."""
    err = {"energy": 0.0, "latency": 0.0, "merged_round0": 0.0,
           "merged": 0.0, "merged_fro": 0.0, "ucb_sums": 0.0,
           "weights": 0.0, "modes_fro": 0.0}
    exact = []
    for rnd, (g, w) in enumerate(zip(got["recs"], want["recs"])):
        if got["plans"][rnd] != want["plans"][rnd]:
            exact.append(f"round {rnd} plans")
        for gt, wt in zip(g["tasks"], w["tasks"]):
            for key in ("active", "departing", "handoffs", "fallbacks",
                        "comm_params", "mean_rank", "deferred",
                        "released"):
                if gt.get(key) != wt.get(key):
                    exact.append(f"round {rnd} {gt['task']} {key} "
                                 f"{gt.get(key)} vs {wt.get(key)}")
            for key in ("energy", "latency"):
                err[key] = max(err[key], abs(gt[key] - wt[key])
                               / max(abs(wt[key]), 1e-12))
        pairs = list(zip(got["merged"][rnd], want["merged"][rnd]))
        if any((a is None) != (b is None) for a, b in pairs):
            exact.append(f"round {rnd} which tasks have merged deltas")
        key = "merged" if rnd else "merged_round0"
        for a, b in pairs:
            if a is not None and b is not None:
                e, f = _tree_rel(a, b)
                err[key] = max(err[key], e)
                if rnd:
                    err["merged_fro"] = max(err["merged_fro"], f)
        for gs, ws in zip(got["ucb"][rnd], want["ucb"][rnd]):
            if not torch.equal(gs[0], ws[0]):
                exact.append(f"round {rnd} UCB-DUAL counts")
            for a, b in zip(gs[1:3], ws[1:3]):
                err["ucb_sums"] = max(err["ucb_sums"], maxabs(a, b) / max(
                    float(b.abs().max()), 1e-30))
        if want["modes"][rnd] is not None:
            d = mode_state_diff(got["modes"][rnd], want["modes"][rnd])
            if d.pop("exact"):
                exact.append(f"round {rnd} live partials, ages or the "
                             f"buffer's vehicles")
            err["weights"] = max(err["weights"], d["partial_w"],
                                 d["buffer_w"])
            err["modes_fro"] = max(err["modes_fro"], d["partials_fro"],
                                   d["buffer_fro"])
    held = {"energy": tol, "latency": tol, "merged_round0": tol,
            "ucb_sums": tol, "weights": tol, "modes_fro": fro or tol}
    held["merged_fro" if fro else "merged"] = fro or tol
    bad = exact + [f"{k} {err[k]:.3g} > {v}" for k, v in held.items()
                   if not err[k] <= v]
    if check and bad:
        fail(f"{label}: {bad[:6]}")
    return {**err, "held": held, "failed": bad}


def phase_9a():
    """Phase 9a: the reduced ViT sharded on the card, per topology,
    against the CPU's sharded run and the card's unsharded fused run, the
    three from the CPU's state each round; the presets against the
    card's fused runs; a replay against eager; two planted faults."""
    t0 = time.perf_counter()
    out = {"topologies": [], "presets": {}}
    reset_counts()
    for n, placement in TOPOLOGIES_9A:
        cpu = shard_sim("cpu", n, placement)
        card = shard_sim("cuda", n, placement)
        fused = shard_sim("cuda")
        shard_lockstep(cpu, [card, fused])
        eng = card.fused
        # round 0 from one seed; round 1 from the CPU's state and SVD,
        # its merged deltas held as a Frobenius spread with the largest
        # entry recorded: Adam's first step moves an entry of a near-zero
        # gradient by up to 2·lr whichever way the rounding falls, so the
        # card parts them from the CPU's by 1.1e-4 to 5.4e-4 of their
        # largest entry (share_distribution; within 5e's MODE_FRO_LIMIT
        # as a spread), and on the card 2-lane shards part them from the
        # 6-lane fleet by 1.6e-4 (H100 80GB HBM3, 700.00 W: round 0
        # 1.0e-6 apart, the lane count moves the rounding), 1.1e-5 as a
        # spread, held within ROUND_TOL
        vs_cpu = shard_gates(card.state_9, cpu.state_9, ROUND_TOL,
                             f"sharded {n} {placement} card vs CPU",
                             fro=MODE_FRO_LIMIT)
        vs_fused = shard_gates(card.state_9, fused.state_9, ROUND_TOL,
                               f"sharded {n} {placement} vs fused",
                               fro=ROUND_TOL)
        if not (eng.captures == 1 and eng.segments == n + 2):
            fail(f"sharded {n} {placement}: {eng.captures} captures, "
                 f"{eng.segments} graphs a round")
        out["topologies"].append({
            "shards": n, "placement": placement, "Vp": eng.Vp,
            "slot": eng.slot.tolist(), "captures": eng.captures,
            "segments": eng.segments,
            "devices": [str(d) for d in eng.mesh.devices],
            "vs_cpu": vs_cpu, "vs_fused": vs_fused})
        del cpu, card, fused, eng
        release()
    for preset in PRESETS_9A:
        name = preset[0]
        want = shard_sim("cuda", preset=preset)
        got = shard_sim("cuda", 2, preset=preset)
        shard_lockstep(want, [got], preset[2])
        recs = got.state_9["recs"]
        out["presets"][name] = {
            "rounds": preset[2], "vehicles": got.cfg.num_vehicles,
            "deferred": sum(t.get("deferred", 0) for r in recs
                            for t in r["tasks"]),
            "released": sum(t.get("released", 0) for r in recs
                            for t in r["tasks"]),
            "handoffs": sum(t["handoffs"] for r in recs
                            for t in r["tasks"]),
            "captures": got.fused.captures,
            **shard_gates(got.state_9, want.state_9, ROUND_TOL,
                          f"sharded 2 {name} vs fused")}
        del want, got
        release()
    # a replay against the same rounds run eagerly, one seed
    replay = shard_alone(shard_sim("cuda", 2))
    eager = shard_alone(shard_sim("cuda", 2, capture=False))
    out["replay_vs_eager"] = fused_state_diff(replay, eager, ROUNDS_9)
    if not out["replay_vs_eager"] <= REPLAY_TOL:
        fail(f"sharded replay vs eager: {out['replay_vs_eager']} > "
             f"{REPLAY_TOL}")
    out["launches"] = counts()
    out["lora_matmul_variants"] = variant_counts()
    out["flash_attention_variants"] = flash_variant_counts()
    # planted faults: each must fail its gate
    planted = {}

    def drop_shard(eng):
        gather = eng._gather

        def dropped():
            gather()
            for d in leaves(eng.stage[-1]["raw"]):
                d.zero_()
        eng._gather = dropped

    def slot_order(eng):
        eng._vehicle_order = lambda a, axis: a.narrow(axis, 0, eng.V)
    for name, n, fault in (("dropped_shard_partial", 2, drop_shard),
                           ("mirror_in_slot_order", 4, slot_order)):
        want = shard_sim("cuda")
        got = shard_sim("cuda", n, fault=fault)
        shard_lockstep(want, [got])
        gates = shard_gates(got.state_9, want.state_9, ROUND_TOL, name,
                            check=False)
        if not gates["failed"]:
            fail(f"planted fault {name} passes the sharded gates")
        planted[name] = gates
        del want, got
    out["planted"] = planted
    out["seconds"] = time.perf_counter() - t0
    return out


def shard_capture_spy(eng):
    """During the capture: each shard's ``lora_matmul`` / flash launches
    and the home segments'; during the eager first round: each shard's
    peak memory above what its lane segment found allocated."""
    spy = {"capturing": False, "shard_launches": [], "shard_peak_bytes":
           [], "peak_bytes": 0}
    lane, capture = eng._shard_main, eng._capture

    def shard_main(sh):
        before = counts()
        if not spy["capturing"]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out = lane(sh)
        if spy["capturing"]:
            spy["shard_launches"].append({k: v - before[k]
                                          for k, v in counts().items()})
        else:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            spy["shard_peak_bytes"].append(peak - base)
            spy["peak_bytes"] = max(spy["peak_bytes"], peak)
        return out

    def captured():
        spy["capturing"] = True
        before = counts()
        capture()
        spy["capturing"] = False
        spy["capture_launches"] = {k: v - before[k]
                                   for k, v in counts().items()}
    eng._shard_main, eng._capture = shard_main, captured
    return spy


def phase_9b(base=None, limit=None):
    """Phase 9b: vit-base-paper at full width and depth, the default
    SimConfig, over SHARDS_9B shards on the card for ROUNDS_9 rounds,
    against ``base``: phase 5c's fused rounds of the same seed (its
    plans, records and round-0 merged deltas), else those rounds run
    here (and counted in this phase's time). ``limit``: 5b's
    serial-spread limit for the round-0 merged deltas."""
    t0 = time.perf_counter()
    cfg = vit_base_paper.vit_base_paper()
    if base is None:
        st = shard_alone(shard_sim("cuda", arch=cfg, **{
            k: getattr(SimConfig(), k) for k in SHARD_KW_9A}))
        base = {"plans": st["plans"], "recs": st["recs"],
                "merged0": st["merged"][0]}
        release()
    sim = IoVSimulator(SimConfig(engine="fused_sharded", train_arch=cfg),
                       device="cuda", fleet_devices=card_shards(SHARDS_9B))
    eng, nt = sim.fused, sim.cfg.num_tasks
    per_fwd = {k: n for k, n in round_per_fwd(cfg, sim.cfg.lora).items()
               if k != "wkv6"}
    steps = sim.cfg.local_steps
    # a shard's lane segment: each task's training steps and local eval
    # over its lanes; the home segment: each task's global eval
    want_shard = {k: n * nt * (steps + 1) for k, n in per_fwd.items()}
    want_home = {k: n * nt for k, n in per_fwd.items()}
    want_round = {k: want_shard[k] * SHARDS_9B + want_home[k]
                  for k in per_fwd}
    plans = []
    recording(sim, plans)
    spy = shard_capture_spy(eng)
    reset_counts()
    state = {"plans": [], "recs": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    state["recs"].append(sim.run_round())
    torch.cuda.synchronize()
    round0_ms = (time.perf_counter() - t1) * 1e3
    state["plans"].append(plans[-nt:])
    merged0 = [s.merged for s in sim.servers]
    # the lane segments reset the peak: the round's is the larger
    peak0 = max(spy["peak_bytes"], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    recs = []
    prof = device_profile(lambda: recs.append(sim.run_round()), top=6)
    state["recs"].append(recs[0])
    state["plans"].append(plans[-nt:])
    launched = counts()
    lora_v, flash_v = variant_counts(), flash_variant_counts()
    for rec in state["recs"]:
        if not (np.isfinite(rec["energy"]) and np.isfinite(rec["accuracy"])):
            fail("full-width sharded round: energy or accuracy not finite")
    if eng.captures != 1:
        fail(f"full-width sharded: {eng.captures} captures")
    for i, got in enumerate(spy["shard_launches"]):
        if {k: got[k] for k in want_shard} != want_shard:
            fail(f"full-width sharded: shard {i} launched {got} at capture,"
                 f" {want_shard} predicted")
    caught = {k: spy.get("capture_launches", {}).get(k, 0)
              for k in want_round}
    if caught != want_round:
        fail(f"full-width sharded: {caught} launches at capture, "
             f"{want_round} predicted")
    ours = prof["port_kernels"]
    replayed = {"lora_matmul": ours.get("lora_mm_kernel", {}).get("count",
                                                                  0),
                "flash_attention": ours.get("fa_kernel", {}).get("count", 0)}
    if replayed != want_round or set(ours) != {"lora_mm_kernel",
                                               "fa_kernel"}:
        fail(f"full-width sharded replay: the profiler saw {ours}, "
             f"{want_round} predicted, all simt")
    if lora_v["simt"] != launched["lora_matmul"] or \
            flash_v["simt"] != launched["flash_attention"]:
        fail(f"full-width sharded: launches off the simt kernels {lora_v} "
             f"{flash_v}")
    # against 5c's fused rounds of the same seed
    rel = {"energy": 0.0, "latency": 0.0}
    for rnd, (g, w) in enumerate(zip(state["recs"], base["recs"])):
        if state["plans"][rnd] != base["plans"][rnd]:
            fail(f"full-width sharded round {rnd}: active sets, ranks or "
                 f"departures differ from the fused run's")
        for gt, wt in zip(g["tasks"], w["tasks"]):
            for key in ("active", "departing", "fallbacks", "comm_params",
                        "mean_rank"):
                if gt[key] != wt[key]:
                    fail(f"full-width sharded round {rnd} {gt['task']}: "
                         f"{key} {gt[key]} vs {wt[key]}")
            for key in rel:
                rel[key] = max(rel[key], abs(gt[key] - wt[key])
                               / max(abs(wt[key]), 1e-12))
    merged0 = [tree_map(lambda t: t.cpu(), m) for m in merged0]
    spread = merged_spread(base["merged0"], merged0)
    largest = merged_rel_err(base["merged0"], merged0)
    if not max(rel.values()) <= SHARD_TOL_9B:
        fail(f"full-width sharded vs fused: energy/latency {rel}")
    if limit is not None and not spread <= limit:
        fail(f"full-width sharded vs fused: round-0 merged deltas spread "
             f"{spread} > {limit}")
    return {"config": f"{cfg.name}, {cfg.num_layers} layers, d "
            f"{cfg.d_model}, f32; SimConfig(engine='fused_sharded') "
            f"otherwise default, fleet_devices {card_shards(SHARDS_9B)}",
            "shards": SHARDS_9B, "Vp": eng.Vp, "slot": eng.slot.tolist(),
            "round0_wall_ms": round0_ms,
            "warm_up_and_capture": "round 0 runs eagerly, then captures",
            "round0_peak_memory_bytes": peak0,
            "replay_wall_ms": prof["wall_ms"],
            "replay_device_ms": prof["device_ms"],
            "replay_busy_share": prof["busy_share"],
            "replay_peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "shard_peak_bytes": spy["shard_peak_bytes"],
            "port_kernels": ours, "top": prof["top"],
            "shard_launches_at_capture": spy["shard_launches"],
            "launches_at_capture": caught, "predicted_per_shard": want_shard,
            "predicted_per_round": want_round, "launches": launched,
            "lora_matmul_variants": lora_v,
            "flash_attention_variants": flash_v,
            "energy_rel_err": rel["energy"],
            "latency_rel_err": rel["latency"],
            "merged_delta_spread_round0": spread, "limit": limit,
            "merged_delta_rel_err_round0": largest,
            "captures": eng.captures, "segments": eng.segments,
            "seconds": time.perf_counter() - t0}


def phase_9(base=None, limit=None):
    out = {"a": phase_9a()}
    release()
    out["b"] = phase_9b(base, limit)
    release()
    return out


def print_9(p9):
    a, b = p9["a"], p9["b"]

    def gates(g):
        return ", ".join(f"{k} {g[k]:.3g}" for k in (
            "energy", "latency", "merged_round0", "merged", "merged_fro",
            "ucb_sums", "weights", "modes_fro") if k in g) + (
            f" (held {g['held']}; counts exact)")
    print(f"[9a] every shard on the one card ({card_shards(2)} / "
          f"{card_shards(4)}): the shards share it; no speed-up is "
          f"claimed", flush=True)
    for t in a["topologies"]:
        print(f"[9a] reduced ViT {SHARD_KW_9A}, {ROUNDS_9} rounds, "
              f"{t['shards']} shards {t['placement']} (Vp {t['Vp']}, slots "
              f"{t['slot']}): card vs CPU {gates(t['vs_cpu'])}; card vs "
              f"unsharded fused {gates(t['vs_fused'])}; captures "
              f"{t['captures']}, {t['segments']} graphs a round",
              flush=True)
    for name, p in a["presets"].items():
        print(f"[9a] {name} ({p['vehicles']} vehicles, {p['rounds']} "
              f"rounds, {p['deferred']} deferred, {p['released']} "
              f"released, {p['handoffs']} handoffs) over 2 shards vs "
              f"fused: {gates(p)}; captures {p['captures']}", flush=True)
    print(f"[9a] sharded replay vs eager over {ROUNDS_9} rounds: "
          f"{a['replay_vs_eager']:.3g} (tol {REPLAY_TOL}); planted faults: "
          + "; ".join(f"{k} fails {v['failed'][:2]}"
                      for k, v in a["planted"].items())
          + f"; launches {a['launches']} (lora_matmul "
          f"{a['lora_matmul_variants']}); {a['seconds']:.1f} s",
          flush=True)
    gib = 2 ** 30
    print(f"[9b] {b['config']}: round 0 (eager, then the capture of "
          f"{b['segments']} graphs) {b['round0_wall_ms']:.1f} ms, peak "
          f"{b['round0_peak_memory_bytes'] / gib:.2f} GiB, each shard's "
          f"lane segment peak "
          + ", ".join(f"{x / gib:.2f}" for x in b["shard_peak_bytes"])
          + f" GiB above its start; round 1 (a replay, profiled) wall "
          f"{b['replay_wall_ms']:.1f} ms, device {b['replay_device_ms']:.1f}"
          f" ms, busy {b['replay_busy_share']:.3f}, peak "
          f"{b['replay_peak_memory_bytes'] / gib:.2f} GiB; launches at "
          f"capture per shard {b['shard_launches_at_capture']} (predicted "
          f"{b['predicted_per_shard']}), per round "
          f"{b['launches_at_capture']}, all simt; captures "
          f"{b['captures']}; port kernels: "
          + "; ".join(f"{k} {t['ms']:.2f} ms x{t['count']}"
                      for k, t in b["port_kernels"].items())
          + "; top: " + "; ".join(f"{t['kernel'][:40]} {t['ms']:.2f} ms "
                                  f"x{t['count']}" for t in b["top"][:4]),
          flush=True)
    print(f"[9b] sharded vs 5c's fused rounds: ranks, active sets, "
          f"departures, fallbacks, comm_params equal; energy rel "
          f"{b['energy_rel_err']:.3g}, latency rel "
          f"{b['latency_rel_err']:.3g} (tol {SHARD_TOL_9B}); round-0 "
          f"merged deltas spread {b['merged_delta_spread_round0']:.3g} "
          f"(limit {b['limit']}), largest entry rel "
          f"{b['merged_delta_rel_err_round0']:.3g} (recorded); "
          f"{b['seconds']:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"[1] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    seconds = {}
    lap = [time.perf_counter()]

    def took(phase):
        """Print and keep the seconds since the last phase ended."""
        now = time.perf_counter()
        seconds[phase] = now - lap[0]
        lap[0] = now
        print(f"[t] phase {phase} took {seconds[phase]:.1f} s", flush=True)
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"[1] built {sorted(secs)} in {time.perf_counter() - t0:.2f}s "
          f"wall ({', '.join(f'{k} {v:.2f}s' for k, v in secs.items())})")
    for name, log in _build.build_logs.items():
        for kernel, info in ptxas_summary(log):
            kind = VARIANT_OF.get(kernel.split("<")[0])
            print(f"[1] ptxas {name} {kernel}"
                  f"{f' ({kind} variant)' if kind else ''}: {info}")

    qwen, rwkv = qwen2_0_5b.qwen2_0_5b(), rwkv6_7b.rwkv6_7b()
    smem = shared_memory(qwen, rwkv)
    print("[1] dynamic shared memory per block: " + "; ".join(
        f"{k} {v} B" for k, v in smem.items()), flush=True)
    lora = LoRAConfig(rank=SLOT, max_rank=SLOT)
    took("1")
    rows = []
    for cfg in (qwen, rwkv):
        for dtype in (torch.bfloat16, torch.float32):
            rows += check_lora(cfg, dtype)
            if cfg.rwkv is None:
                rows += check_flash(cfg, dtype)
    # the two archs phase 6 serves: starcoder2-15b's 6144 / 24576 widths
    # (wgmma prefill, split-K decode at K 24576) and head dim 128 with a
    # GQA repeat of 12, smollm-135m's 576 / 1536 and 9 heads on 3
    starcoder, smollm = (starcoder2_15b.starcoder2_15b(),
                         smollm_135m.smollm_135m())
    for cfg in (starcoder, smollm):
        rows += check_lora(cfg, torch.bfloat16)
        rows += check_flash(cfg, torch.bfloat16, (128,))
    # the archs phase 6d serves: flash at head dim 256 in both dtypes at
    # gemma-7b's prefill (16 heads on 16, S 128) and paligemma-3b's (8 on
    # 1, 256 prefix rows + 128), bf16 at musicgen-medium's (24 of 64) and
    # grok-1's (48 of 128 on 8); every lora_matmul shape of their
    # prefills and decode steps (deepseek-v2's MLA never reaches flash)
    gemma, pali, musicgen, grok, deepseek = (make() for make in ARCHS_6D)
    for dtype in (torch.bfloat16, torch.float32):
        rows += check_flash(gemma, dtype, (128,))
        rows += check_flash(pali, dtype, (pali.num_prefix_embeds + 128,))
    for cfg in (musicgen, grok):
        rows += check_flash(cfg, torch.bfloat16, (128,))
    for cfg in (gemma, pali, musicgen, grok, deepseek):
        rows += check_lora(cfg, torch.bfloat16, list(arch_lora_cases(
            cfg, 4 * (cfg.num_prefix_embeds + 128))))
    # phase 7a's zamba2-2.7b: flash at head dim 80 in both dtypes at its
    # prefill (32 heads on 32), and every distinct lora_matmul shape of
    # its prefill and decode (mamba in_proj 2560 -> 10448 and out_proj;
    # the shared block's q/k/v/o, up/gate and down)
    zamba = zamba2_2_7b.zamba2_2_7b()
    for dtype in (torch.bfloat16, torch.float32):
        rows += check_flash(zamba, dtype, (128,))
    rows += check_lora(zamba, torch.bfloat16, list(arch_lora_cases(zamba)))
    rows += check_wkv(rwkv)
    # phase 7b's rwkv6 round: wkv6 forward and backward at a train step
    rows += check_wkv_train(rwkv)
    steps = wkv_chunk_steps(rwkv)
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        rel = f", rel {r['rel_err']:.3g}" if "rel_err" in r else ""
        if "tpu_chunk128_work_ms" in r:
            rel += (f", TPU chunk-128 work "
                    f"{r['tpu_chunk128_work_ms']:.4f} ms")
        if r["name"] == "flash_attention":
            rel += (f", {r['variant']} block {r['block']}: "
                    f"{r['tflops']:.1f} TFLOP/s, {r['vs_library']:.2f}x SDPA")
            if "row_rel_err" in r:
                rel += (f", per row vs f32 {r['row_rel_err']:.3g} (keys "
                        f"{r['planted_keys']} lost: "
                        f"{r['planted_row_rel_err']:.3g})")
        if r["name"] == "wkv6":
            rel += f", logw {r['logw_dtype']}, {r['plan']}"
        if "train_ms" in r:
            rel += (f"; forward + backward (autograd of the plain version) "
                    f"{r['train_ms']:.4f} ms, all plain "
                    f"{r['plain_train_ms']:.4f} ms, backward bound "
                    f"{r['bwd_bound_ms']:.4f} ms, backward rel "
                    f"{r['bwd_rel_err']:.3g}")
        if r["name"] == "lora_matmul":
            rel += (f", {r['variant']}: kernel alone {r['kernel_ms']:.4f} ms"
                    f" ({r['kernel_tflops']:.1f} TFLOP/s, "
                    f"{r['kernel_gbs']:.0f} GB/s)")
            if r["rank_pin"]:
                rel += ", rank pin equal"
            if r["deterministic"]:
                rel += ", two calls equal"
        print(f"[2] {r['name']} {r['model']} {r.get('linear', '')} "
              f"{r.get('mode', r.get('case', ''))} {r['dtype']} {r['shape']}"
              f": err {r['max_abs_err']:.3g}{rel} (tol {r['tol']}), ms "
              f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library {lib}, "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)

    for b, st in steps.items():
        print(f"[2] wkv6 chunk step at {b} (grid {st['grid']}): "
              f"{st['us_per_chunk_step']:.3f} us (S 64 {st['ms_S64']:.4f} "
              f"ms, S 1024 {st['ms_S1024']:.4f} ms)", flush=True)

    # the rwkv6 round's f32 lora_matmul shapes at rwkv6-7b's width (7b)
    train_rows = (check_lora_train() + check_flash_train()
                  + check_lora_rwkv_round())
    for r in train_rows:
        extra = (f", kernel alone {r['kernel_ms']:.4f} ms"
                 if r["name"] == "lora_matmul" else f", {r['block']}")
        if "bwd_err" in r:
            extra += (f", backward err {r['bwd_err']:.3g} (tol "
                      f"{r['bwd_tol']}), backward {r['bwd_ms']:.4f} ms "
                      f"(autograd of the plain version "
                      f"{r['autograd_plain_bwd_ms']:.4f}, bound "
                      f"{r['bwd_bound_ms']:.4f})")
        print(f"[2] {r['mode']} {r['name']} {r['model']} "
              f"{r.get('linear', '')} {r['variant']} {r['dtype']} "
              f"{r['shape']}: err {r['max_abs_err']:.3g} (tol {r['tol']}), "
              f"ms {r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}){extra}", flush=True)
    took("2")

    pars = [parity(qwen, lora, 64), parity(rwkv, lora, 100),
            parity(smollm, lora, 64), parity(starcoder, lora, 32)]
    # phase 6d's archs: 2 layers of the dense ones
    # (paligemma-3b after its 256 prefix rows), one of grok-1 and
    # deepseek-v2 (~20 GB of f32 each; the CPU's decode runs every expert
    # over its capacity of 8 per lane, ~2 s a step there, so 1 step)
    pars += [parity(gemma, lora, 64), parity(pali, lora, 16),
             parity(musicgen, lora, 64),
             parity(grok, lora, 16, layers=1, steps=1),
             parity(deepseek, lora, 16, layers=1, steps=1)]
    # zamba2-2.7b at 7 layers: one shared application and one remainder
    # layer; a retire/admit after step 3 (a fresh SSM and conv state)
    pars.append(parity(zamba, lora, 64, layers=DEPTH_3_ZAMBA2, steps=6))
    for par in pars:
        print(f"[3] {par['config']}: prefill max abs "
              f"{par['prefill_max_abs_err']:.3g}, decode max abs "
              f"{par['decode_max_abs_err']:.3g} over {par['decode_steps']} "
              f"steps (tol {E2E_TOL})", flush=True)
    took("3")

    # each path is driven with the counts set to 0 just before it and
    # read just after (inside served)
    runs = [served(qwen, lora), served(rwkv, lora)]
    for run in runs:
        p, d = run["prefill"], run["decode"]
        print(f"[4] {run['config']}: prefill 4x128 {p['ms']:.2f} ms, "
              f"launches {p['launches']}, lora_matmul by variant "
              f"{p['lora_matmul_variants']}; decode {d['steps']} steps x "
              f"{d['lanes']} lanes {d['lane_tokens_per_s']:.1f} tok/s "
              f"({d['ms_per_step']:.2f} ms/step), launches per step "
              f"{d['launches_per_step']}, lora_matmul by variant "
              f"{d['lora_matmul_variants']}; flash by variant in the "
              f"prefill {p['flash_attention_variants']}", flush=True)
        for name, tr in run["profile"].items():
            print(f"[4] {run['model']} profile {name}: wall "
                  f"{tr['wall_ms']:.2f} ms, device {tr['device_ms']:.2f} ms "
                  f"(busy {tr['busy_share']:.3f}), port kernels: "
                  + "; ".join(f"{k} {t['ms']:.3f} ms x{t['count']}"
                              for k, t in tr["port_kernels"].items())
                  + "; top: "
                  + "; ".join(f"{t['kernel'][:40]} {t['ms']:.3f} ms "
                              f"x{t['count']}" for t in tr["top"][:4]),
                  flush=True)
    took("4")

    # the round: each path driven with the counts set to 0 just before
    # it and read just after (inside round_parity and full_rounds)
    par5 = {e: round_parity(e) for e in ("serial", "batched", "fused")}
    for engine, p5 in par5.items():
        step = (f"train step loss err {p5['step_loss_err']:.3g}, grads max "
                f"abs {p5['step_grad_max_abs_err']:.3g}; "
                if "step_loss_err" in p5 else "")
        print(f"[5a] {p5['config']}, card vs CPU: {step}one round: ranks "
              f"{p5['ranks']}, active {p5['active']} equal, merged deltas "
              f"rel {p5['merged_delta_rel_err']:.3g}, energy rel "
              f"{p5['energy_rel_err']:.3g}, latency rel "
              f"{p5['latency_rel_err']:.3g} (tol {ROUND_TOL}); accuracy "
              f"card {p5['accuracy_card']:.4f}, CPU "
              f"{p5['accuracy_cpu']:.4f}; round {p5['card_round_ms']:.0f} "
              f"ms on the card, {p5['cpu_round_ms']:.0f} ms on the CPU; "
              f"launches {p5['launches']}"
              + (f"; captures {p5['captures']}" if p5["captures"] else ""),
              flush=True)
    check_dev = check_dev_on_card("batched_check")
    print(f"[5a] batched_check on the card: engine_check_dev "
          f"{check_dev:.3g} (largest |batched - serial| adapter entry)",
          flush=True)
    fused_check_dev = check_dev_on_card("fused_check")
    print(f"[5c] fused_check on the card: engine_check_dev "
          f"{fused_check_dev:.3g} (largest |fused - serial| adapter entry; "
          f"tol {ROUND_TOL})", flush=True)
    fulls = {"serial": full_rounds("serial", 0),
             "batched": full_rounds("batched", 1)}
    fused = fused_rounds(1)
    g, limit = group_budgets_agree()
    agree = engines_agree(fulls["serial"], fulls["batched"], limit)
    fagree = fused_agrees(fused, fulls["batched"], fulls["serial"], limit)
    for run in fulls.values():
        run.pop("_state")
    torch.cuda.empty_cache()
    # phase 9b's baseline: 5c's first two rounds (their plans, records
    # and round-0 merged deltas, on the host)
    f5c = fused["_state"]
    base9 = {"plans": f5c["plans"][:ROUNDS_9],
             "recs": f5c["recs"][:ROUNDS_9],
             "merged0": [tree_map(lambda t: t.cpu(), m)
                         for m in f5c["merged"][0]]}
    del f5c
    replay = replay_gates(fused.pop("_state"), 2)
    for full in fulls.values():
        for rd in full["rounds"]:
            groups = (f"; groups (task, rank, lanes, steps) {rd['groups']}"
                      if "groups" in rd else "")
            print(f"[5b] {full['config']}: round {rd['round']} wall "
                  f"{rd['wall_ms']:.1f} ms (profiled), device "
                  f"{rd['device_ms']:.1f} ms, busy {rd['busy_share']:.3f}, "
                  f"peak memory {rd['peak_memory_bytes'] / 2**30:.2f} GiB; "
                  f"{rd['train_steps']} train steps, {rd['evals']} evals; "
                  f"launches in train steps {rd['launches']['train']}, in "
                  f"evals {rd['launches']['eval']}{groups}; ranks "
                  f"{rd['ranks']}, active {rd['active']}; energy "
                  f"{rd['energy']:.2f} J, accuracy {rd['accuracy']:.4f}, "
                  f"loss {rd['loss_first_last'][0]:.4f} -> "
                  f"{rd['loss_first_last'][1]:.4f}; port kernels: "
                  + "; ".join(f"{k} {t['ms']:.2f} ms x{t['count']}"
                              for k, t in rd["port_kernels"].items())
                  + "; top: " + "; ".join(
                      f"{t['kernel'][:40]} {t['ms']:.2f} ms x{t['count']}"
                      for t in rd["top"][:4]), flush=True)
        up = full["unprofiled_round"]
        if up["wall_ms"] is not None:
            print(f"[5b] {full['engine']} round {up['round']} without the "
                  f"profiler: wall {up['wall_ms']:.1f} ms, peak memory "
                  f"{up['peak_memory_bytes'] / 2**30:.2f} GiB", flush=True)
        print(f"[5b] {full['engine']}: launches over the profiled rounds "
              f"{full['launches']}", flush=True)
        for rd in full["rounds"]:
            print(f"[5b] {full['engine']} round {rd['round']} by shape: "
                  f"lora_matmul (L x M x K x N x r x dtype) "
                  f"{rd['lora_matmul_by_shape']}; flash (B x S x H x D x "
                  f"dtype) {rd['flash_attention_by_shape']}", flush=True)
    print(f"[5b] task {g['task']}'s rank-{g['rank']} group of round 0 at "
          f"full width ({g['lanes']} lanes, step budgets {g['steps']}): one "
          f"step's adapter gradients batched vs serial on the card rel "
          f"{g['one_step_grad_rel_err']:.3g} (tol {ROUND_TOL}); after the "
          f"budgets, each lane's update spread batched vs serial on the "
          f"card max {max(g['batched_vs_serial_update_spread']):.3g}, "
          f"serial card vs CPU ({g['cpu_lanes']} lanes) max "
          f"{max(g['serial_card_vs_cpu_update_spread']):.3g}, limit "
          f"{g['update_limit']:.3g} ({g['spread_factor']}x); last live "
          f"losses rel max {max(g['batched_vs_serial_loss_rel']):.3g} "
          f"(tol {ROUND_TOL}); planted faults: "
          + "; ".join(f"{k}: gradients {v['one_step_grad_rel_err']:.3g}, "
                      f"update spread {v['update_spread']:.3g}"
                      for k, v in g["planted_faults"].items()), flush=True)
    print(f"[5b] batched vs serial at full width over {agree['rounds']} "
          f"rounds: ranks and active sets equal, energy rel "
          f"{agree['energy_rel_err']:.3g}, latency rel "
          f"{agree['latency_rel_err']:.3g} (tol 1e-5), merged deltas after "
          f"round 0: spread {agree['merged_delta_spread_round0']:.3g} "
          f"(limit {agree['limit']:.3g}), largest entry rel "
          f"{agree['merged_delta_rel_err_round0']:.3g} (recorded); launches "
          f"equal the groups' prediction in every batched round",
          flush=True)

    fr = fused["first_round"]
    print(f"[5c] {fused['config']}: round 0 (unprofiled) wall "
          f"{fr['round_wall_ms']:.1f} ms: the round run eagerly "
          f"{fr['warm_up_ms']:.1f} ms, then the capture "
          f"{fr['capture_ms']:.1f} ms "
          f"({fused['segments']} graphs; launches counted at capture "
          f"{fr['capture_launches']}, predicted "
          f"{fused['predicted_launches_per_round']}); "
          f"captures after {fused['unprofiled_round']['round'] + 1} "
          f"rounds: {fused['captures']}", flush=True)
    for rd in fused["rounds"]:
        print(f"[5c] fused round {rd['round']} wall {rd['wall_ms']:.1f} ms "
              f"(profiled, a replay), "
              f"device {rd['device_ms']:.1f} ms, busy "
              f"{rd['busy_share']:.3f}, peak memory "
              f"{rd['peak_memory_bytes'] / 2**30:.2f} GiB; launches per "
              f"run by the profiler {rd['launches_per_run_by_profiler']}, "
              f"all simt; ranks {rd['ranks']}, active {rd['active']}; "
              f"energy {rd['energy']:.2f} J, accuracy "
              f"{rd['accuracy']:.4f}; port kernels: "
              + "; ".join(f"{k} {t['ms']:.2f} ms x{t['count']}"
                          for k, t in rd["port_kernels"].items())
              + "; top: " + "; ".join(
                  f"{t['kernel'][:40]} {t['ms']:.2f} ms x{t['count']}"
                  for t in rd["top"][:4]), flush=True)
    up = fused["unprofiled_round"]
    print(f"[5c] fused round {up['round']} without the profiler: wall "
          f"{up['wall_ms']:.1f} ms, peak memory "
          f"{up['peak_memory_bytes'] / 2**30:.2f} GiB; by shape at capture:"
          f" lora_matmul {fr['lora_matmul_by_shape']}; flash "
          f"{fr['flash_attention_by_shape']}", flush=True)
    print(f"[5c] fused vs batched at full width over {fagree['rounds']} "
          f"rounds: ranks and active sets equal, energy rel "
          f"{fagree['energy_rel_err']:.3g}, latency rel "
          f"{fagree['latency_rel_err']:.3g} (tol 1e-5); merged deltas after "
          f"round 0 vs serial: spread "
          f"{fagree['merged_delta_spread_round0_vs_serial']:.3g} (limit "
          f"{fagree['limit']:.3g}), largest entry rel "
          f"{fagree['merged_delta_rel_err_round0_vs_serial']:.3g} "
          f"(recorded)", flush=True)
    print(f"[5c] replay vs eager on the card over {replay['rounds']} "
          f"rounds: full width {replay['full_width']:.3g}, reduced ViT "
          f"{replay['reduced']:.3g} (tol {replay['tol']}); planted fault "
          f"(an input buffer left as round 0 staged it): "
          f"{replay['planted_unrefreshed_input']:.3g}, fails the gate",
          flush=True)

    took("5a-5c")
    p5d = phase_5d()
    print_5d(p5d)
    took("5d")
    p5e = phase_5e(limit)
    print_5e(p5e)
    took("5e")
    p5f = phase_5f()
    print_5f(p5f)
    took("5f")
    # serving, the rest: each path driven with the counts set to 0 just
    # before it and read just after (lockstep, timed_generate,
    # served_paged)
    p6 = phase_6()
    print_6(p6)
    p6d = phase_6d()
    print_6d(p6d)
    took("6")
    # zamba2-2.7b served and rwkv6 in the round: each path driven with
    # the counts set to 0 just before it and read just after (inside
    # served_paged, round_parity, full_rounds and phase_7b)
    p7a = phase_7a()
    p7b = phase_7b()
    print_7(p7a, p7b)
    took("7")
    # the training entry point: each path driven with the counts set to
    # 0 just before it and read just after (inside phase_8a, sim_in_process,
    # phase_8c and phase_8d)
    p8 = phase_8()
    print_8(p8)
    rows += p8["rows"]
    took("8")
    # the device-sharded fleet: each path driven with the counts set to 0
    # just before it and read just after (inside phase_9a, phase_9b)
    p9 = phase_9(base9, limit)
    del base9
    print_9(p9)
    took("9")
    serve6 = [("qwen2-0.5b paged and dense engines in lockstep, churn "
               "(6a)", {"launches": p6["a"]["lockstep_launches"],
                        "lora_matmul_variants":
                        p6["a"]["lockstep_lora_matmul_variants"],
                        "flash_attention_variants": {"mma": 0, "simt": 0}})]
    for label, rs in p6["a"]["timed"].items():
        serve6 += [(f"qwen2-0.5b {label} generate {i} (6a)", r)
                   for i, r in enumerate(rs)]
    serve6.append(("vit-base-paper store-served paged and dense engines "
                   "in lockstep (6b)", p6["b"]))
    for c, label in ([(c, "6c") for c in p6["c"]]
                     + [(c, "6d") for c in p6d["runs"]] + [(p7a, "7a")]):
        serve6.append((f"{c['model']} prefill and paged generate ({label})",
                       c))
        serve6.append((f"{c['model']} paged and dense engines in lockstep "
                       f"({label})", {"launches": c["lockstep_launches"],
                                      "lora_matmul_variants":
                                      c["lockstep_lora_matmul_variants"],
                                      "flash_attention_variants":
                                      {"mma": 0, "simt": 0}}))

    # phase 2 at the batched round's lane shapes: V from its largest
    # group per rank, for ours and for HetLoRA (the most rank groups)
    lane_rows = []
    for run, label in ((fulls["batched"], ""),
                       (p5e["batched"]["tier hetlora"], "hetlora ")):
        lanes_by_rank = {}
        for groups in ([rd["groups"] for rd in run["rounds"]]
                       + run["unprofiled_round"]["groups_each"]):
            for _, r, lanes, _ in groups:
                lanes_by_rank[r] = max(lanes_by_rank.get(r, 0), lanes)
        lane_rows += check_lane_shapes(lanes_by_rank, label)
    # and at the fused round's: the whole fleet, rank-padded
    lane_rows += check_fused_shapes(SimConfig().num_vehicles, list(
        SimConfig().lora.candidate_ranks))
    for r in lane_rows:
        extra = (f", kernel alone {r['kernel_ms']:.4f} ms"
                 if r["name"] == "lora_matmul" else f", {r['block']}")
        if "bwd_err" in r:
            extra += (f", backward err {r['bwd_err']:.3g} (tol "
                      f"{r['bwd_tol']}), backward {r['bwd_ms']:.4f} ms "
                      f"(autograd of the plain version "
                      f"{r['autograd_plain_bwd_ms']:.4f}, bound "
                      f"{r['bwd_bound_ms']:.4f})")
        print(f"[2] {r['mode']} {r['name']} {r['model']} "
              f"{r.get('linear', '')} {r['variant']} {r['dtype']} "
              f"{r['shape']}: err {r['max_abs_err']:.3g} (tol {r['tol']}), "
              f"ms {r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}){extra}", flush=True)
    train_rows += lane_rows

    round_paths = {
        "vit-tiny-paper serial round (5a)": par5["serial"]["launches"],
        "vit-tiny-paper batched round (5a)": par5["batched"]["launches"],
        "vit-base-paper serial round (5b)": fulls["serial"]["launches"],
        "vit-base-paper profiled batched round (5b)":
            fulls["batched"]["launches"],
        "vit-tiny-paper fused round (5c)": par5["fused"]["launches"],
        "vit-base-paper 3 fused rounds, warm-up and capture (5c)":
            fused["launches"]}
    for name, p in p5d["parity"].items():
        round_paths[f"vit-tiny-paper {name} 2 rounds (5d)"] = p["launches"]
    half = f"vit-base-paper ({DEPTH_5D} layers)"
    for m, run in p5d["batched"].items():
        kind = "profiled" if run["rounds"] else "unprofiled"
        round_paths[f"{half} {m} {kind} batched round (5d)"] = \
            run["launches"]
    for m, run in p5d["fused"].items():
        round_paths[f"{half} {m} 2 fused rounds, warm-up and "
                    f"capture (5d)"] = run["launches"]
    for name, p in list(p5e["parity"].items()) + [
            (f"{k} (planted)", p) for k, p in p5e["planted"].items()]:
        round_paths[f"vit-tiny-paper {name} {p['rounds']} rounds (5e)"] = \
            p["launches"]
    half5e = f"vit-base-paper ({DEPTH_5E} layers)"
    for name, run in p5e["batched"].items():
        kind = ("profiled batched round" if run["rounds"] else
                f"{len(run['unprofiled_round']['wall_ms_each'])} "
                f"unprofiled batched rounds")
        round_paths[f"{half5e} {name} {kind} (5e)"] = run["launches"]
    for name, run in p5e["fused"].items():
        round_paths[f"{half5e} {name} 4 fused rounds, first eager and "
                    f"the capture (5e)"] = run["launches"]
    for c in p5f["cases"]:
        round_paths[f"vit-tiny-paper {c['case']} {c['rounds']} rounds and "
                    f"the resumed {c['rounds'] - c['every']} (5f)"] = \
            c["launches"]
    round_paths["vit-tiny-paper rsu-outage rounds after card/CPU restores, "
                "rush-hour round 0, both devices (5f)"] = \
        p5f["cross_device"]["launches"]
    round_paths[f"vit-base-paper rsu-outage semi_sync fused "
                f"run_scanned({FULL_HORIZON}), stopped at {RESUME_EVERY} "
                f"and resumed (5f)"] = p5f["full"]["launches"]
    for name, p in p5f["presets"].items():
        round_paths[f"vit-base-paper {name} batched rounds 0-"
                    f"{p['rounds'] - 1} (5f)"] = p["launches"]
    round_paths["vit-tiny-paper sharded fleet rounds, 2 and 4 shards "
                "on the card, presets, replay and planted faults (9a)"] = \
        p9["a"]["launches"]
    round_paths[f"vit-base-paper {SHARDS_9B} shards on the card, "
                f"{ROUNDS_9} fused_sharded rounds (9b)"] = \
        p9["b"]["launches"]
    # each phase-2 row's launches in each round: vit-base-paper's in the
    # profiled rounds of 5b, vit-tiny-paper's in 5a's one round (its
    # round 0), by engine
    per_round = {}
    for model, engine, rounds in (
            ("vit-base-paper", "serial", fulls["serial"]["rounds"]),
            ("vit-base-paper", "batched", fulls["batched"]["rounds"]),
            ("vit-tiny-paper", "serial", [dict(par5["serial"], round=0)]),
            ("vit-tiny-paper", "batched",
             [dict(par5["batched"], round=0)]),
            ("vit-base-paper", "fused",
             [dict(fr, round="each")])) + tuple(
            ("vit-base-paper", f"{m} batched", run["rounds"])
            for m, run in p5d["batched"].items()):
        for rd in rounds:
            for name in ("lora_matmul", "flash_attention"):
                for k, v in rd[f"{name}_by_shape"].items():
                    *dims, dt = k.split("x")
                    key = (model, name, dt) + tuple(int(x) for x in dims)
                    per_round.setdefault(key, {})[
                        f"{engine} round {rd['round']}"] = v
    for r in train_rows:
        r["launches_by_round"] = per_round.get(
            (r["model"], r["name"], r["dtype"]) + tuple(r["key"]), {})
    print("[5] launches in each round at the shapes of phase 2's training "
          "rows: " + "; ".join(
              f"{r['name']} {r['model']} {r['mode']} {r['dtype']} "
              f"{r['shape']} " + (", ".join(
                  f"{k} {v}" for k, v in r["launches_by_round"].items())
                  or "none") for r in train_rows), flush=True)
    rows += train_rows
    round_runs = (list(par5.values()) + list(fulls.values()) + [fused]
                  + list(p5d["batched"].values())
                  + list(p5d["fused"].values())
                  + list(p5e["batched"].values())
                  + list(p5e["fused"].values())
                  + list(p7b["parity"].values()) + [p7b["batched"]]
                  + list(p7b["fused_launches"].values())
                  + [p9["a"], p9["b"]])
    # phase 7b's round paths, the only ones with wkv6 in them
    rwkv_paths = {f"rwkv6-7b-reduced {e} round (7b)": p["launches"]
                  for e, p in p7b["parity"].items()}
    rwkv_paths[f"rwkv6-7b ({DEPTH_7B} layers) batched round (7b)"] = \
        p7b["batched"]["launches"]
    for name, n in p7b["fused_launches"].items():
        rwkv_paths[f"rwkv6-7b ({DEPTH_7B} layers) 2 fused rounds, {name} "
                   f"(7b)"] = n

    # the kernels line: one entry per kernel at a main-path shape
    # (lora_matmul: qwen2-0.5b's up/gate prefill in bf16; flash: S = 128
    # in bf16; wkv6: rwkv6-7b's prefill shape in the model's own dtypes),
    # with every shape measured under "cases"
    entries = []
    for name, pick in (("lora_matmul", lambda r: r["dtype"] == "bfloat16"
                        and r.get("linear") == "up/gate"
                        and r["mode"] == "prefill"),
                       ("flash_attention", lambda r: r["dtype"] == "bfloat16"
                        and "S=128" in r["shape"]),
                       ("wkv6", lambda r: r["case"] == "model shape")):
        mine = [r for r in rows if r["name"] == name]
        head = next(r for r in mine if pick(r))
        by_path = {run["model"]: run["launches"][name] for run in runs}
        if name != "wkv6":
            by_path.update({p: c[name] for p, c in round_paths.items()})
            by_path.update({p: r["launches"][name] for p, r in serve6})
            by_path.update({p: c[name] for p, c in p8["paths"].items()})
        by_path.update({p: c[name] for p, c in rwkv_paths.items()})
        extra = {}
        if name == "lora_matmul":
            extra["launches_by_variant"] = {
                k: sum(run["lora_matmul_variants"][k]
                       for run in runs + round_runs + [r for _, r in serve6]
                       + p8["runs"])
                for k in lm_ops.launches_by_variant}
            extra["kernel_ms"] = head["kernel_ms"]   # t = x·A given
        if name != "wkv6":
            # the fused rounds replay what one capture launched: the
            # profiler's kernel records per replayed round
            extra["launches_per_fused_round_by_profiler"] = \
                fused["rounds"][-1]["launches_per_run_by_profiler"][name]
        if name == "flash_attention":
            extra["launches_by_variant"] = {
                k: sum(run["flash_attention_variants"][k]
                       for run in runs + round_runs + [r for _, r in serve6]
                       + p8["runs"])
                for k in fa_ops.launches_by_variant}
            extra["block"] = head["block"]
        if name == "wkv6":
            extra["plan"] = head["plan"]
        entries.append({
            "name": name, "route": "cuda",
            "source": str(_build.source_of(name).relative_to(HERE)),
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": (head["max_abs_err"] if name == "wkv6" else
                            max(r["max_abs_err"] for r in mine
                                if r["dtype"] == "bfloat16")),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            **extra, "cases": mine})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "torch": torch.__version__,
                   "build_seconds": secs, "shared_memory_bytes": smem,
                   "wkv6_chunk_steps": steps, "kernels": entries,
                   "parity": pars, "served": runs, "round_parity": par5,
                   "engine_check_dev": check_dev,
                   "fused_check_dev": fused_check_dev,
                   "full_rounds": fulls, "fused_rounds": fused,
                   "fused_agreement": fagree, "fused_replay": replay,
                   "full_batched_vs_serial": agree,
                   "full_group_budgets": g, "methods": p5d,
                   "modes": p5e, "resume_and_presets": p5f,
                   "serving_rest": p6, "serving_archs": p6d,
                   "zamba2_served": p7a, "rwkv6_round": p7b,
                   "training_entry_point": {k: v for k, v in p8.items()
                                            if k != "runs"},
                   "sharded_fleet": p9,
                   "phase_seconds": seconds}, fh, indent=1)
    print(smi())
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k != "cases"} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
