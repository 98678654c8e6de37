#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives the
port's paths on the card through the entry points a user calls:

  1. the card: name and power limit (``nvidia-smi``);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the phases below and at larger or edge-case shapes
     (``rolling_sum`` also from row 0 on every row, and at an N that is not
     a multiple of its tile; ``online_lookup`` on queries -1, -2, INT64_MIN
     and INT64_MAX against keys holding each many times, and
     ``online_lookup`` and ``merge_scan`` at P = 65,536 partitions); then
     ``error_checks``: a bad segment bound, a bad window start and a bad or
     duplicate winner key raise the CPU path's ``ValueError`` at
     ``check_error`` after a synchronization, or at the next call, a refused
     merge leaves the table byte-identical, and the next good call
     succeeds.  On the main path's inputs each of the four feature-store
     wrappers runs once under ``torch.cuda.set_sync_debug_mode("error")``
     (``sync_free``).  AdamW's fused update and sum of squares
     (``kernels/adamw``) against the optimizer's leaf path, three steps
     each, bit for bit, and ``torch.sum`` within 1e-6: at deepseek-v2-lite's
     embedding (the train cell's largest leaf), pixtral's (the largest leaf
     of a train row), deepseek's float32 router and an odd bf16 size with a
     float32 gradient; then a strided and a float16 card leaf raise in the
     optimizer, untouched (``adamw_odd_leaves``);
  3. ``profile``: 2**23 entities x 32 float32 features written through
     ``FeatureStore.write_batch`` into a kernel-engine store on the card
     (online only, with a TTL, 256 partitions: ~2.5 GB of device tensors)
     and a vector-engine twin on the host; state, merge tallies and 64
     served batches of 4,096 ids must be byte-identical.  Its first update
     frame also goes, reduced to per-id winners, through the index-free
     scan merge (``scan_merge``) into a clone of the device state, which
     must equal the store's own state after ``write_batch``;
  4. the main path, ``txn_rolling``: 24 hourly scheduled materialization
     jobs over 1M entities and 200k events an hour, a 10-feature rolling
     DSL (sum/mean of two columns over 1 h and 6 h, counts), merged into the
     offline and the online store and read back through the serving front;
  5. ``offline_retrieval``: a 2**20-row spine joined point-in-time onto the
     ``txn_rolling`` offline history through
     ``FeatureStore.get_offline_features``, held against the plain search
     on the card, the same call on the CPU and an independent numpy search;
  6. ``geo``: both store planes replicated across westus2, eastus and
     westeurope (one-way links of 32, 70 and 40 ms, 1 Gbps).  The main
     path's feature set homed in westus2 with replicas in the other two
     (``GeoFeatureStore``, kernel engine): 12 hourly jobs, each drained;
     replicas byte-identical to the home; 16 GETs from westeurope served by
     its replica (one lookup launch each) and equal to the home's.  A
     replica daemon child on the card takes the state over a socket and its
     rebuild must equal the in-process replica; the home is lost, eastus is
     promoted with the un-acked suffix replayed, and a 2**16-row training
     join on the promoted offline plane equals the one before the failure;
     the ex-home rejoins.  6 jobs over a seeded faulty channel converge
     byte-identical to the fault-free run.  A ``MultiHomeGeoStore`` (16
     shards, ``profile``'s 32 features at 2**21 entities, 3 frames of 2**20
     rows, one entering at each region) converges, fails westeurope's ranges
     over, converges again and answers GETs alike from every region;
  7. ``examples``: the port's five examples and its transport smoke
     (``examples/*_torch.py``, ``scripts/transport_smoke_torch.py``), each
     file run as ``__main__`` in an interpreter of its own on the card at
     its default sizes, the way a user starts it, then that process's launch
     counts and peak memory printed: quickstart, serving_front,
     geo_failover (its replica daemon a grandchild on the card),
     online_serving and the transport smoke side by side, then
     ``train_lm_torch.py`` alone at the configuration its docstring names
     for one card (gemma3-1b, ``--full --batch 8 --seq 512``, 50 steps):
     each exits 0 (its own assertions, train_lm's that the loss falls),
     prints the lines that say its drill held, and launches the kernels of
     its path; train_lm's step seconds, tokens/s, MFU and peak GB;
  8. ``flash_attn`` against its plain version at phi3-medium-14b's prefill
     shape (B=4, S=2,048, H=40, KV=10, D=128, bf16), a ragged float32 GQA
     shape, an MQA D=256 shape, a ragged bf16 D=128 shape, and zamba2's
     shared-block shape (B=4, S=2,048, H=KV=32, D=112, bf16) and a ragged
     one (S=T=1,000), and pixtral's prefill shape (B=4, S=T=3,072 of 1,024
     patches and 2,048 tokens, H=32, KV=8, D=128, bf16), and qwen1.5-4b's
     (B=4, S=2,048, H=KV=20, D=128, bf16: MHA), beside
     ``scaled_dot_product_attention``; each check
     asserts its route (bf16 at D 64/112/128/256 on the tensor cores,
     ``wgmma``; float32 on the CUDA cores).  Then ``flash_backward``: the
     backward kernel of each route at phi3's and zamba2's prefill shapes, a
     ragged bf16 shape and a float32 one (gemma-2b's in ``lm_train``,
     pixtral's in ``lm_vlm_train``), its dq, dk, dv within FLASH_TOL of autograd through the plain forward,
     two calls bit-equal, beside the plain backward and
     ``scaled_dot_product_attention``'s backward;
  9. ``lm_serve``: the ported LM request path (``launch/serve.py``) at
     phi3-medium-14b's full width (40 layers, d_model 5,120, random bf16
     weights from a seed, 29.3 GB): 8 sessions' contexts fetched through the
     online store (the lookup kernel), a stepped prefill of the 32-token
     contexts, 16 greedy tokens; contexts equal to the offline latest,
     prompts equal to a CPU run of the serving plane;
  10. ``lm_prefill``: ``make_prefill_step`` with ``attn_impl="pallas_flash"``
     on the same model, on the served prompts (against the stepped prefill's
     logits) and on a 4 x 2,048 batch from a ``FeatureStoreLoader`` over the
     serving plane (against ``attn_impl="xla"``), 40 flash launches per
     forward, all on the tensor-core route;
  11. ``lm_gemma3_serve``, ``lm_gemma3_prefill`` and ``window_decode``:
     ``lm_serve``'s and ``lm_prefill``'s paths and checks at gemma3-1b's
     full width (26 layers, d_model 1,152, MQA 4/1, D 256, vocab 262,144,
     tied; a 512-token window on 5 of every 6 layers), no flash launch
     (the flash gate sends a windowed config down the einsum path); then
     a stepped prompt of 504 loader tokens and 16 greedy steps across the
     window, each step's logits against the last row of a full forward
     over the same tokens, and that forward equal to an all-global one
     before position 512 and different after.  ``lm_qwen_serve`` and
     ``lm_qwen_prefill``: the same at qwen1.5-4b's (40 layers, d_model
     2,560, MHA 20/20 with QKV bias, D 128, vocab 151,936), 40 flash
     launches a forward on the tensor cores;
  12. ``lm_ssm_serve`` and ``lm_ssm_prefill``: ``lm_serve``'s request path
     and checks at mamba2-2.7b's full width (64 Mamba2 layers, d_model
     2,560, 80 heads of 64, state 128; random bf16 weights from a seed,
     5.7 GB), decode bounded by the weights and one read and one write of
     every layer's SSM state; then ``make_prefill_step`` at 4 x 2,048 (8
     SSD chunks of 256) against the same forward at chunk 128, no flash
     launch.  The bf16 forward on the served prompts, the bf16 stepped
     prefill and the 4 x 2,048 forward's first 512 logits of row 0 are each
     held against the float32 stepped prefill of a float32 twin of the
     weights, and the weights rounded one mantissa bit coarser must fall
     outside that bound;
  13. ``lm_hybrid_serve`` and ``lm_hybrid_prefill``: the same at zamba2-7b's
     full width (81 Mamba2 layers as 13 groups of 6 and a tail of 3, one
     shared attention block of 32 heads of 112 after each group; 13.4 GB),
     the prefill with ``attn_impl="pallas_flash"`` against ``"xla"``, 13
     flash launches a forward on the tensor-core route, and the same float32
     twin reference and control;
  14. ``lm_audio_serve`` and ``lm_audio_prefill``: ``lm_serve``'s request
     path at whisper-tiny's full width and depth (4 + 4 layers, d_model
     384, 6 heads of 64, 1,500 frames, vocab 51,865; 73.2 MB of bf16
     weights, decoder positions sized to the published 448-token context):
     zero frames through the encoder, the cross K/V attached to the cache,
     then the stepped prefill and decode, a step's bound one read of the
     weights and of the cross and self K/V; then ``make_prefill_step`` on
     the served prompts over the same frames against the stepped logits,
     and at 4 x 448 loader tokens over 1,500 seeded frames each, timed;
     no kernel but the GET's (the JAX package's whisper attention is its
     einsum path everywhere);
  15. ``lm_vlm_serve`` and ``lm_vlm_prefill``: the same at pixtral-12b's
     full width (40 layers, d_model 5,120, GQA 32/8, D 128, vocab 131,072;
     24.5 GB), served text-only as the JAX driver does; the prefill on
     4 x (1,024 seeded patch embeddings + 2,048 loader tokens), S=3,072,
     ``pallas_flash`` against ``xla``, 40 flash launches a forward on the
     tensor cores;
  16. ``moe_dispatch``: one MoE layer at deepseek-v2-lite-16b's widths (D
     2,048, 64 experts top-6, F 1,408, two shared experts; seeded bf16
     weights) on 4 x 2,048 tokens in groups of 2,048 at capacity factor
     1.25 (capacity 240): ``moe_apply`` against its GShard einsum oracle,
     the share of assignments dropped (above 0), ``_dispatch_indices`` on
     the card byte-identical to the CPU, and ``moe_apply`` sync-free;
  17. ``lm_moe_serve``: ``lm_serve``'s request path and checks at
     deepseek-v2-lite-16b's full width (27 layers, MLA, 64 experts; random
     bf16 weights from a seed, 31.4 GB) on a serving plane of its own:
     absorbed-MLA decode and no-drop MoE, no flash launch;
  18. ``lm_moe_prefill``: ``make_prefill_step`` on that model, no-drop on
     the served prompts against the stepped prefill's logits, then at
     capacity factor 1.25 on a 4 x 2,048 loader batch with each MoE layer's
     dropped share;
  19. ``lm_train``: the ported train path (``launch/train.py``'s data plane
     and optimizer, ``make_train_step``) at gemma-2b's full width (18
     layers, d_model 2,048, MQA 8/1, head_dim 256, vocab 256,000; 2.51 B
     random bf16 weights from a seed), ``attn_impl="pallas_flash"``: 8 AdamW
     steps (float32 moments) on 4 x 2,048 loader batches from the feature
     store on the card, advanced until no row is left-padded; finite losses,
     no token after the loader clock, 36 tensor-core flash launches a step
     (18 forward, 18 recomputed in the backward) and 18 tensor-core backward
     launches, one AdamW update launch a leaf a step and one sum of squares
     a step, peak memory under the card's.  Then, from the same state and
     batch, the loss and every gradient leaf against ``attn_impl="xla"``; the
     flash backward kernel alone at the training shape against autograd
     through the plain forward, beside ``scaled_dot_product_attention``'s
     backward; and the
     driver's kill at step 9 and resume (``train.main``, reduced gemma-2b, the
     JAX driver test's arguments), bit-identical to an uninterrupted run;
  20. ``lm_ssm_train`` and ``lm_hybrid_train``: the same train path at
     mamba2-2.7b's full width and depth (64 layers, 2.83 B parameters) and
     at zamba2-7b's full width cut to 48 of its 81 layers (8 groups of 6
     and the shared block: 4.13 B parameters; all 81 need 80.4 GB of
     weights, gradients and moments), 8 steps each: finite losses, peak
     memory under the card's, zamba2's shared block launching the D=112
     flash forward and backward kernels once a group a step on the tensor
     cores (8 each).  mamba2: ``_ssd_chunked`` at one layer's full shape in
     float32, its output and the gradients of x, dt, B and C against the
     recurrence at dt from softplus(N(-2, 1)) and at dt·|A| = 0.5, where
     the JAX package's decay expression gives a NaN gradient; the bf16
     gradient at the trained state's first 8 layers against a float32 twin,
     with weights one mantissa bit coarser at least doubling the median
     leaf's error.
     zamba2: the flash/xla gradient check at the trained state's first two
     groups (12 layers).  Each: the driver's kill and resume on the reduced
     config, bit-identical;
  21. ``lm_vlm_train``: pixtral-12b at full width cut to 10 of its 40
     layers (4.07 B parameters; all 40 need 147 GB at 12 B a parameter),
     ``pallas_flash``, 8 steps at 4 x (1,024 patches + 2,048 tokens): 20
     flash forward launches a step (forward and recompute) and 10 backward
     ones, all on the tensor cores at S=T=3,072; the flash/xla gradient
     check at the trained state's first 2 layers; the flash backward alone
     at this shape against autograd through the plain forward;
  22. ``lm_audio_train``: whisper-tiny at full size, 8 steps at 8 x 448
     tokens over 1,500 frames, no kernel launched but AdamW's; the driver's kill and
     resume on reduced whisper, bit-identical;
  23. ``moe_backward``: ``moe_dispatch``'s layer and tokens (gemma-2b freed
     first), forward + backward: every gradient leaf of the sort dispatch
     (x, the float32 router, the expert stacks, the shared experts) within
     2^-5 of the largest entry of the einsum oracle's, the routing of the
     two identical, no host sync, the time beside three times the forward's
     bound;
  24. ``lm_moe_train``: the train path at deepseek-v2-lite-16b's published
     width (d_model 2,048, MLA R 512, 64 experts top-6 + 2 shared, F 1,408,
     vocab 102,400) cut to ``MOE_TRAIN_LAYERS`` layers (1 dense + 5 MoE:
     all 27 need 188 GB of weights, gradients and moments), seeded random bf16
     weights (float32 routers), float32 AdamW moments, 8 steps on 4 x 2,048
     loader batches at the config's capacity factor: finite losses and aux
     losses, each MoE layer's dropped share at the first and the last step,
     every recompute routing as its forward, no kernel launch but AdamW's, peak memory
     under the card's; then ``train.main``'s kill at step 9 and resume on
     reduced deepseek-v3 (MLA with query LoRA, MoE, MTP), bit-identical;
  25. ``moe_train_parity``: reduced deepseek-v2-lite and reduced
     deepseek-v3 in float32 (TF32 off), 4 train steps on the card against
     the same 4 on the CPU from the same weights: routing identical at
     every step, losses, parameters and moments within the CPU tests'
     bounds; ``ssm_train_parity``: the same for reduced mamba2 and zamba2,
     ``encdec_vlm_train_parity`` for reduced whisper and pixtral (with
     seeded frames or patch embeddings);
  26. ``dryrun``: ``launch/dryrun.py``'s cells of ``lm_moe_train``
     (deepseek-v2-lite at 6 layers), ``lm_ssm_train`` (mamba2-2.7b at 64
     layers), ``lm_train`` (gemma-2b, ``pallas_flash``) and
     ``lm_hybrid_train`` (zamba2-7b at 48 layers, ``pallas_flash``: the
     flash forward and backward on meta tensors through their fake
     implementations), 4 x 2,048, the driver's float32 moments, one
     microbatch, on a 1x1 mesh of the ``fake`` backend (the mesh path on
     one card), over meta tensors, all at once, each in a child process on
     the host after the timed phases: the dry-run's FLOPs equal the
     ``FlopCounterMode`` count of a step of the row's state (one forward
     and backward after its measured steps; flash counted at SDPA's
     formulas) exactly, its
     predicted peak is within 25% of the row's measured ``peak_gb``, and
     its roofline seconds print beside the row's ``step_s``.  The four
     cells then go through the dry-run report
     (``scripts/render_experiments_torch.py`` ``dryrun_tables``), whose
     roofline rows print on lines of their own: one row a cell, its
     "fits H100" column agreeing with the row's measured peak, and the
     report's H100 capacity (``H100_HBM``) within ``H100_HBM_MARGIN`` of
     the card's total memory;
  27. ``mesh``: the mesh path on the card (``launch/mesh.py``,
     ``models/sharding.py``, ``models/pspec.py``): NCCL at world size 1, a
     1x1 (data, model) mesh.  gemma-2b at full width, ``pallas_flash``,
     3 steps at 4 x 2,048 with the weights placed as DTensors, the batch
     ``Shard(0)`` and the step under ``activation_mesh``, against the same
     3 steps unsharded from the same weights and seeded batches: losses
     within 1e-6 (bit-equality of the losses and every weight recorded:
     the unsharded steps' AdamW is the fused kernel, the mesh's DTensors
     the leaf path, whose clip norms are summed in another order),
     36 flash forward and 18 backward launches a step through
     ``pspec.local_call``, all on the tensor cores, no AdamW kernel; then ``_moe_ep`` at
     ``moe_dispatch``'s layer and tokens against ``moe_apply`` on the
     routed experts: routing identical, output, aux and gradients bit-equal,
     both times;
  28. ``mesh_decode``, in the same 1x1 NCCL world: gemma-2b (a
     sequence-parallel MQA cache on a wider mesh) and mamba2-2.7b (the SSM
     state on its heads, the conv ring on its channels) at full width,
     seeded bf16 weights, 8 requests: a stepped prompt of 32 tokens, then
     16 greedy steps, every step through ``serve_step``, once unsharded and
     once with the weights placed as DTensors and the cache by
     ``sharding.cache_specs``: tokens equal, every step's logits and every
     cache leaf (gathered whole) bit-equal; ms a step on the mesh against
     unsharded (DTensor's dispatch on a host-bound path);
  29. the ``kernels`` line: launches, errors, times and bounds per kernel.

Each path (``scan_merge``, the main path, ``offline_retrieval``, ``geo``,
each example, ``lm_serve``, ``lm_prefill``, ``lm_gemma3_serve``,
``lm_gemma3_prefill``, ``window_decode``, ``lm_qwen_serve``,
``lm_qwen_prefill``, ``lm_ssm_serve``, ``lm_ssm_prefill``,
``lm_hybrid_serve``, ``lm_hybrid_prefill``, ``lm_audio_serve``,
``lm_audio_prefill``, ``lm_vlm_serve``, ``lm_vlm_prefill``, ``lm_moe_serve``,
``lm_moe_prefill``, ``lm_train``, ``lm_ssm_train``, ``lm_hybrid_train``,
``lm_vlm_train``, ``lm_audio_train``, ``lm_moe_train``, ``mesh``,
``mesh_decode``) runs
with the launch counts zeroed just before it and read just after, and must
have launched each kernel of its own path (an example's in its own
process; ``lm_moe_train``'s, ``lm_ssm_train``'s and ``lm_audio_train``'s
paths launch none of them but AdamW's: MLA, the MoE dispatch, the SSD and
whisper's attention are plain PyTorch, as they are XLA ops in the JAX
package; nor does the transport smoke, which replicates on the host, and
train_lm, on gemma3-1b, whose window sends attention down the einsum path,
launches AdamW's alone).  Every train row launches AdamW's update once a
leaf a step and its sum of squares once a step.

Each phase prints one JSON line; any failed check raises, so the run exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.assets import (  # noqa: E402
    Entity,
    Feature,
    FeatureSetSpec,
    MaterializationSettings,
)
from repro_torch.core.dsl import DslTransform, RollingAgg, UDFTransform  # noqa: E402
from repro_torch.core.featurestore import FeatureStore  # noqa: E402
from repro_torch.core import wire as geo_wire  # noqa: E402
from repro_torch.core.channel import FaultPlan, FaultyChannel  # noqa: E402
from repro_torch.core.daemon import SocketChannel, spawn_replica_daemon  # noqa: E402
from repro_torch.core.keys import encode_keys  # noqa: E402
from repro_torch.core.merge_engine import plan_online_batch  # noqa: E402
from repro_torch.core.multihome import MultiHomeGeoStore  # noqa: E402
from repro_torch.core.pit import (  # noqa: E402
    _prepare_history,
    get_offline_features,
    pit_join_feature_set,
    search_inputs,
)
from repro_torch.core.regions import GeoTopology, Region  # noqa: E402
from repro_torch.core.replication import DeliveryPolicy, GeoFeatureStore  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.data.sources import SyntheticEventSource  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.adamw import ops as adamw_ops  # noqa: E402
from repro_torch.kernels.online_lookup import ops as lookup_ops  # noqa: E402
from repro_torch.kernels.online_lookup.ref import lookup_ref  # noqa: E402
from repro_torch.kernels.online_merge import ops as merge_ops  # noqa: E402
from repro_torch.kernels.online_merge.ref import match_winners, merge_scan_ref  # noqa: E402
from repro_torch.kernels.pit_join import ops as pit_ops  # noqa: E402
from repro_torch.kernels.pit_join.ref import pit_search_ref  # noqa: E402
from repro_torch.kernels.rolling_agg import ops as rolling_ops  # noqa: E402
from repro_torch.kernels.rolling_agg.ref import rolling_sum_ref  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import attention_ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.offline_store import CREATION_TS  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _port_named,
    lm_params_from_numpy,
    lm_params_to_numpy,
    train_state_to_numpy,
)
from repro_torch.data.loader import FeatureStoreLoader  # noqa: E402
from repro_torch.launch.serve import build_serving_plane, serve  # noqa: E402
from repro_torch.kernels.flash_attn.ref import attention_bwd_ref  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.launch.mesh import make_mesh, process_group  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    TrainState,
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models import api  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.layers import torch_dtype  # noqa: E402
from repro_torch.models.pspec import activation_mesh  # noqa: E402
from repro_torch.optim import adamw as adamw_mod  # noqa: E402
from repro_torch.optim.schedules import warmup_cosine  # noqa: E402

HOUR = 3_600_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bfloat16 tensor-core rate
# rolling_sum: kernel and plain both sum in float64 and round once to float32,
# so they differ by at most about one float32 ulp of the result
ROLL_RTOL, ROLL_ATOL = 1e-6, 1e-5

PROFILE_ENTITIES = 1 << 23
PROFILE_FEATURES = 32
PROFILE_PARTITIONS = 256
PROFILE_TTL = 15_000
TXN_ENTITIES = 1_000_000
TXN_EVENTS_PER_HOUR = 200_000
TXN_HOURS = 24
GET_BATCH = 4096
SPINE_ROWS = 1 << 20
LM_ARCH = "phi3-medium-14b"  # full width: 40 layers, d_model 5120, GQA 40/10, vocab 100,352
SSM_ARCH = "mamba2-2.7b"  # full width: 64 layers, d_model 2,560, 80 heads of 64, state 128
HYBRID_ARCH = "zamba2-7b"  # full width: 81 Mamba layers (13 groups of 6 + 3), shared attn D 112
# the two configs of the JAX package no earlier phase runs on the card
WINDOW_ARCH = "gemma3-1b"  # 26 layers, d_model 1,152, MQA 4/1, D 256, 5:1 local:global, window 512
MHA_ARCH = "qwen1.5-4b"  # 40 layers, d_model 2,560, MHA 20/20, D 128, QKV bias, vocab 151,936
LM_REQUESTS, LM_NEW_TOKENS = 8, 16
PREFILL_BATCH, PREFILL_SEQ = 4, 2048
# window_decode: a stepped prompt of WINDOW_PROMPT tokens, then LM_NEW_TOKENS
# greedy steps, so the positions cross gemma3-1b's 512-token window
WINDOW_PROMPT = 504
# examples: each example and the transport smoke as a user runs it, in an
# interpreter of its own on the card at its default sizes; train_lm at the
# configuration its docstring names for one card, its steps cut to 50.  The
# store and serving examples run side by side, then train_lm alone: per
# example, the kernels of its path that must launch and lines of its own
# output that must appear
EXAMPLE_TIMEOUT = 900
EXAMPLE_RUNS = (
    ("examples/quickstart_torch.py", [], ("online_lookup", "rolling_sum", "pit_search"),
     ("online lookup: found=[True, True, True, True, True, True, True, True]",
      "consistency: online==max(event_ts,creation_ts) per id: True", "quickstart complete.")),
    ("examples/serving_front_torch.py", [], ("online_lookup", "rolling_sum"),
     ("degraded=True", "status=shed (bound enforced)")),
    ("examples/geo_failover_torch.py", [], ("online_lookup", "rolling_sum"),
     ("offline/online consistency after fail-over: True", "(identical=True)",
      "converged byte-identical through the lossy WAN: True",
      "adopted daemon state byte-identical=True", "daemon torn down cleanly: exit=0",
      "all 3 cells byte-identical after the full drill: True")),
    ("examples/online_serving_torch.py", [], ("online_lookup",),
     ("generated shape (8, 16)",)),
    ("scripts/transport_smoke_torch.py", [], (), ("transport smoke: PASS",)),
)
TRAIN_EXAMPLE = ("examples/train_lm_torch.py",
                 ["--arch", WINDOW_ARCH, "--full", "--batch", "8", "--seq", "512",
                  "--steps", "50", "--log-every", "1"], ("adamw_update", "adamw_sqnorm"),
                 ("example complete: 50 steps",))
# the child's wrapper: the example's file run as __main__, then the launch
# counts of its own process and its peak device memory on one line
EXAMPLE_RUNNER = r"""
import json, runpy, sys
import torch
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.online_lookup import ops as lookup_ops
from repro_torch.kernels.online_merge import ops as merge_ops
from repro_torch.kernels.pit_join import ops as pit_ops
from repro_torch.kernels.rolling_agg import ops as rolling_ops
sys.argv = sys.argv[1:]
code = 0
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    code = e.code if isinstance(e.code, int) else int(e.code is not None)
counters = (lookup_ops.counter, rolling_ops.counter, pit_ops.counter, merge_ops.counter,
            flash_ops.counter, adamw_ops.counter, adamw_ops.sqnorm_counter)
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
print("example readings: " + json.dumps({"launches": {c.name: c.launches for c in counters},
                                         "peak_gb": peak / 1e9}), flush=True)
sys.exit(code)
"""
TRAIN_LOG = re.compile(r"\[train\] step +(\d+) loss ([\d.]+) \(([\d.]+)s\)")
EPOCH_MS = 1_700_000_000_000
I64_MIN = -(2**63)
# lm_prefill, the flash forward's logits against the stepped prefill and the
# xla path: both compute attention in float32 from bfloat16 q, k, v and
# differ in summation order and in one bfloat16 rounding of each attention
# output (the stepped prefill also in its matmuls' shapes), amplified over 40
# random-weight layers; compared relative to the logits' scale
LOGITS_REL_RMS, LOGITS_TOP1 = 0.1, 0.8
# lm_ssm_prefill and lm_hybrid_prefill, each bfloat16 path of the served model
# (the full-sequence forward: chunked SSD, the conv as products summed in
# bfloat16; the stepped prefill: one recurrent step a token, the conv summed
# in float32; both as the JAX package formulates them) against the stepped
# prefill of a float32 twin of the same weights with TF32 off.  Their
# roundings compound over the depth: at mamba2's 64 layers the bfloat16
# paths land about 0.12 from float32, as the JAX package's own do
# (tests/test_torch_lm.py::test_ssm_bf16_paths_part_as_jax_at_depth), so
# the pure SSM family has its own bound; zamba2's 81 Mamba layers, with the
# shared block after each group, stay within the LOGITS bound.  The bounds
# sit above the H100 readings, and the served weights rounded to
# SSM_CONTROL_BITS explicit mantissa bits (bfloat16 keeps 7) must fall
# outside them: they pass no model one bit coarser
SERVED_BOUNDS = {"ssm": (0.15, 0.7)}
SSM_CONTROL_BITS = 6
# the row-0 prefix of the 4 x 2,048 forward held against the float32 stepped
# prefill: two SSD chunks, so the inter-chunk scan is in it
SSM_PREFIX = 512
# flash_attn, kernel vs plain: the plain version keeps float32 throughout.  The
# float32 route (CUDA cores) differs from it in summation order only: 1e-5.
# The bfloat16 route (tensor cores) also rounds P to bfloat16 before P.V, as
# the TPU kernel's DEFAULT-precision dot does on its own chip and as
# scaled_dot_product_attention does, and rounds the output once to bfloat16:
# 2e-2, the JAX package's own bfloat16 flash tolerance
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TRAIN_ARCH = "gemma-2b"  # full width: 18 layers, d_model 2,048, MQA 8/1, D 256, vocab 256,000
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 2048, 8, 3e-3
# the JAX driver test's arguments (tests/integration/test_train_driver.py)
TRAIN_KILL_ARGS = ["--arch", "gemma-2b", "--steps", "12", "--batch", "2", "--seq", "32",
                   "--ckpt-every", "4", "--log-every", "100"]
# lm_train, the flash step against the xla step from one state and batch:
# the forwards differ in one bfloat16 rounding of P before P.V (the kernel's,
# as the TPU kernel's DEFAULT-precision dot) and in summation order, over 18
# layers; the backward is the same float32 code.  The first full-width run
# (H100, after 8 steps) measured a loss 4.9e-6 apart (relative) and gradient
# leaves at most 0.0225 apart in relative RMS (a query projection, tail.10's
# wq; median 5.4e-4): bounds of about 200x and 2x those
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_RMS = 1e-3, 0.05
MOE_ARCH = "deepseek-v2-lite-16b"  # full width: 27 layers, d_model 2,048, MLA R 512, 64 experts
MOE_CF = 1.25  # the config's train-time capacity factor: 4 groups of 2,048 tokens, capacity 240
# moe_dispatch, moe_apply against its einsum oracle in bfloat16: both run the
# same routing and the same expert products; they differ in the combine.
# moe_apply adds the k weighted terms one at a time in bfloat16 (a rounding
# per product and per sum), the oracle rounds each gate to bfloat16 and sums
# in one product accumulated in float32, then both add the shared experts
# (one more rounding).  About 2k + 2 roundings of at most half a bfloat16
# step (2**-9 relative) each: 2**-5 of the output's largest magnitude
MOE_TOL = 2**-5
# lm_moe_train: deepseek-v2-lite's depth cut from 27 layers to 1 dense + 5 MoE.
# Its 15.7 B parameters need 188 GB of weights, gradients and float32 moments
# at 12 bytes a parameter (AdamW updates in place); 6 layers hold 3.42 B.
# (Before the in-place update, 22 bytes a parameter, 6 layers peaked at
# 78.97 GB and the cut was 4.)
MOE_TRAIN_LAYERS = 6
MOE_KILL_ARGS = ["--arch", "deepseek-v3-671b", *TRAIN_KILL_ARGS[2:]]
# moe_train_parity: the CPU tests' bounds (tests/test_torch_train.py): in
# float32 the card and the CPU differ in summation order only
TRAJ_TOL, PARAM_REL_RMS = 1e-4, 1e-3
PARITY_ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
PARITY_STEPS, PARITY_BATCH, PARITY_SEQ = 4, 4, 64
# lm_ssm_train and lm_hybrid_train: mamba2-2.7b at its full depth (64 layers,
# 2.83 B parameters, 34.0 GB at 12 B a parameter), zamba2-7b cut from 81
# layers to 8 groups of 6 and no tail (4.13 B parameters; all 81 hold 6.70 B,
# 80.4 GB at 12 B a parameter before any activation)
HYBRID_TRAIN_LAYERS = 48
# zamba2's flash/xla gradient check runs the trained state's first two
# groups and its shared block: the xla path keeps float32 S x S scores of 32
# heads (2.1 GB a group at 4 x 2,048), which 48 layers cannot hold
HYBRID_CHECK_LAYERS = 12
# mamba2's bf16 gradient against a float32 twin of the same weights (TF32
# off) at the trained state's first SSM_TWIN_LAYERS layers, each leaf in
# relative RMS.  The first full-width run (H100, the state after 9 updates)
# measured a worst leaf of 0.0872 (tail.0's d_skip, a float32 weight whose
# gradient sums over every token; median 0.0044) and 0.1767 with the weights
# rounded to SSM_CONTROL_BITS mantissa bits; the next (after 8 updates, as
# now) 0.0324 and 0.2397.  The bound sits between the readings and the
# controls.  The worst leaf is whichever gradient nearly cancels at the
# state reached (d_skip above), so it swings with the trajectory: from a
# state whose clip norms differ in their float32 last bits (AdamW's fused
# norm), 0.0077 and 0.0410, w_in the worst.  The median leaf does not: bf16
# 0.0021 and 0.0022 at the two states, the control 0.0078 and 0.0111.  So
# the control's test is on the median: one mantissa bit coarser must at
# least SSM_CONTROL_RATIO-fold it (3.7 and 5.0 there)
SSM_TWIN_LAYERS = 8
SSM_GRAD_REL_RMS = 0.12
SSM_CONTROL_RATIO = 2.0
SSM_KILL_ARGS = ["--arch", SSM_ARCH, *TRAIN_KILL_ARGS[2:]]
HYBRID_KILL_ARGS = ["--arch", HYBRID_ARCH, *TRAIN_KILL_ARGS[2:]]
SSM_PARITY_ARCHS = (SSM_ARCH, HYBRID_ARCH)
# ssd_gradient: the chunked SSD against the recurrence (ssd_reference) at one
# mamba2 layer's shape in float32 (TF32 off): the output and the gradients of
# x, dt, B and C within SSD_GRAD_TOL of each one's largest entry, the CPU
# tests' bound (tests/test_torch_ssm.py)
SSD_GRAD_TOL = 1e-4
# the last two families.  whisper-tiny at full width and depth (4 + 4 layers,
# d_model 384, 6 heads of 64, 1,500 frames, vocab 51,865): its learned
# decoder positions sized to the published decoder context, 448 tokens,
# which lm_audio_prefill runs 4 of over 1,500 frames and lm_audio_train 8
AUDIO_ARCH = "whisper-tiny"
AUDIO_CONTEXT = 448
AUDIO_PREFILL_BATCH, AUDIO_TRAIN_BATCH = 4, 8
AUDIO_KILL_ARGS = ["--arch", AUDIO_ARCH, *TRAIN_KILL_ARGS[2:]]
# pixtral-12b at full width (40 layers, d_model 5,120, GQA 32/8, D 128, vocab
# 131,072; 1,024 patches of 1,024): prefill and train at 4 x (1,024 patches
# + 2,048 tokens), S = T = 3,072.  Training cuts the depth to
# VLM_TRAIN_LAYERS: 4.07 B parameters, 48.9 GB at 12 B a parameter (all 40
# layers need 147 GB); the flash/xla gradient check runs the trained
# state's first VLM_CHECK_LAYERS layers (xla keeps 4.8 GB of float32
# scores a layer at this shape)
VLM_ARCH = "pixtral-12b"
VLM_TRAIN_LAYERS = 10
VLM_CHECK_LAYERS = 2
LAST_PARITY_ARCHS = (AUDIO_ARCH, VLM_ARCH)
L2_FLUSH_BYTES = 128 << 20  # written before a launch to empty the 50 MB L2
# mesh: gemma-2b's train steps through the mesh path on a 1x1 mesh (NCCL at
# world size 1) against the same steps unsharded, from the same weights and
# batches.  The losses must agree within MESH_LOSS_RTOL (bit-equality, and
# that of every weight, is recorded: it is what the port expects)
MESH_STEPS = 3
MESH_LOSS_RTOL = 1e-6
# dryrun: the dry-run of four train rows (their arch, depth and attention
# path, 4 x 2,048, the driver's float32 moments, one microbatch) on a 1x1
# mesh of the fake backend (DRYRUN_MESH: the step as the mesh path runs it on
# one card), over meta tensors, in child processes on the host after the
# timed phases; its peak within DRYRUN_PEAK_TOL of the row's measured one,
# its FLOPs the row's step's, exactly
DRYRUN_CELLS = {"lm_moe_train": (MOE_ARCH, MOE_TRAIN_LAYERS, None),
                "lm_ssm_train": (SSM_ARCH, None, None),
                "lm_train": (TRAIN_ARCH, None, "pallas_flash"),
                "lm_hybrid_train": (HYBRID_ARCH, HYBRID_TRAIN_LAYERS, "pallas_flash")}
DRYRUN_MESH = "1x1"
DRYRUN_PEAK_TOL = 0.25
# mesh_decode: serve_step on the 1x1 mesh against unsharded, bit for bit:
# gemma-2b and mamba2-2.7b at full width, 8 requests, a prompt of 32 tokens
# stepped, then 16 greedy steps
MESH_DECODE_ARCHS = (TRAIN_ARCH, SSM_ARCH)
MESH_DECODE_BATCH, MESH_DECODE_PROMPT, MESH_DECODE_STEPS = 8, 32, 16
SLEEP_CYCLES = 50_000_000  # a sleep kernel of about 25 ms on an H100
COUNTERS = (lookup_ops.counter, rolling_ops.counter, pit_ops.counter, merge_ops.counter,
            flash_ops.counter, flash_ops.tc_counter, flash_ops.bwd_counter,
            flash_ops.bwd_tc_counter, adamw_ops.counter, adamw_ops.sqnorm_counter)
# adamw_update: AdamW's fused update, on a bf16 leaf of the train cell's
# largest shape (deepseek-v2-lite's embedding, 102,400 x 2,048), the largest
# leaf of any train row here (pixtral's embedding, 131,072 x 5,120) and a
# float32 router (deepseek's, 64 x 2,048), three steps each against the
# optimizer's leaf path bit for bit; the norm's sum of squares within
# ADAMW_NORM_RTOL of torch.sum's float64 sum of the float32 squares.
# ADAMW_OPS: float32 operations an element (the clip's scale 1, m 3, v 4,
# the ratio 5, the decay 2, the step 2)
ADAMW_NORM_RTOL = 1e-6
ADAMW_OPS = 17
ADAMW_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
# the tensor-core flash kernels the build must hold: the forward at each of
# its head dims, the backward's delta pass and fused dK/dV/dQ pass at each
TC_KERNELS = sorted(f"{k}<{d}>" for d in flash_ops.TC_HEAD_DIMS
                    for k in ("flash_fwd_tc", "flash_bwd_delta", "flash_bwd_fused"))
# products of 2·D operations per visible (query head, key) pair that each
# backward route's schedule does: tensor cores, the delta pass's QKᵀ and
# dO·Vᵀ, then each of the five once; CUDA cores, QKᵀ and dO·Vᵀ in each of its
# three passes, dV and dK, dQ.  A flash backward's least is five
BWD_PRODUCTS = {"wgmma": 7, "cuda_cores": 9}
BWD_BOUND_PRODUCTS = 5


def reset_counts() -> None:
    for c in COUNTERS:
        c.reset()


def read_counts() -> dict:
    return {c.name: c.launches for c in COUNTERS}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def tc_sass(so: Path) -> dict:
    """Per tensor-core flash kernel in the built library (the forward
    ``flash_fwd_tc<D>``, the backward's ``flash_bwd_delta<D>`` and
    ``flash_bwd_fused<D>``), from
    ``cuobjdump``: its HGMMA (wgmma) instructions, and the registers a thread
    starts with (before ``setmaxnreg``) and its stack bytes (spills) from the
    resource usage table."""
    tool = str(Path(native.nvcc()).with_name("cuobjdump"))
    run = lambda *a: subprocess.run([tool, *a, str(so)], capture_output=True, text=True,
                                    check=True, timeout=300).stdout

    def name(mangled: str) -> str | None:
        m = re.search(r"(flash_fwd_tc|flash_bwd_delta|flash_bwd_fused)ILi(\d+)E", mangled)
        return None if m is None else f"{m.group(1)}<{m.group(2)}>"

    out, fn = {}, None
    for line in run("-sass").splitlines():
        if (m := re.search(r"Function : (\S+)", line)):
            fn = name(m.group(1))
            if fn:
                out[fn] = {"hgmma": 0}
        elif fn and "HGMMA" in line:
            out[fn]["hgmma"] += 1
    fn = None
    for line in run("-res-usage").splitlines():
        if (m := re.search(r"Function (\S+):", line)):
            fn = name(m.group(1))
        elif fn and (m := re.search(r"REG:(\d+) STACK:(\d+)", line)):
            out[fn].update(registers=int(m.group(1)), stack_bytes=int(m.group(2)))
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_restored(fn, restore, reps: int) -> float:
    """Mean device time of ``fn()`` alone, each call on state ``restore()``
    put back first (outside the timed span), after a warm-up."""
    restore()
    fn()
    total = 0.0
    for _ in range(reps):
        restore()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` with the host out of the way: the calls
    are queued behind a sleep kernel that keeps the card busy while the host
    issues them, so they run back to back.  Fails if queueing them took the
    host longer than the sleep lasted (the time would then include host
    gaps)."""
    fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    slept.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    check(queued_ms < slept.elapsed_time(start), "the calls were queued before the sleep ended")
    return start.elapsed_time(end) / reps


def device_ms_restored(fn, restore, reps: int) -> float:
    """Mean device time of ``fn()`` alone, each call on state ``restore()``
    put back first, with the host out of the way: each call is queued behind
    its restore and a sleep kernel and timed between two events.  Fails if
    queueing a call took the host longer than the sleep lasted."""
    restore()
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        restore()
        slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        fn()
        end.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        check(queued_ms < slept.elapsed_time(start), "the call was queued before the sleep ended")
        total += start.elapsed_time(end)
    return total / reps


def bound(nbytes: int, ops: int, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate vs operations over
    the rate of their type (float32 unless given), in ms, and which of the
    two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- kernel against plain ------------------------------------------------------
def check_lookup(keys: torch.Tensor, queries: torch.Tensor, label: str) -> dict:
    """Kernel vs plain on the card: slots must be equal, and the kernel must
    launch once.  Bytes: keys and queries read once, slots written once;
    operations: one int64 compare per key and per query (the least any GET
    does on these inputs).  ``launch_only_ms``: the kernel's launch alone,
    into an output allocated beforehand; ``device_ms``: the same with the
    host out of the way."""
    before = lookup_ops.counter.launches
    got = lookup_ops.lookup(keys, queries)
    want = lookup_ref(keys, queries)
    torch.cuda.synchronize()
    check(lookup_ops.counter.launches == before + 1, f"lookup kernel launched once ({label})")
    check(torch.equal(got, want), f"lookup kernel == plain ({label})")
    p, c = keys.shape
    q = queries.shape[1]
    b_ms, b_by = bound(8 * p * c + 12 * p * q, 2 * (p * c + p * q))
    out = torch.empty_like(got)
    launch = lambda: lookup_ops._launch(keys, queries, out)
    row = {
        "phase": "kernel_check", "kernel": "online_lookup", "shape": label,
        "P": p, "C": c, "Q": q, "hits": int((got >= 0).sum()),
        "max_abs_err": float((got.long() - want.long()).abs().max()),
        "ms": cuda_ms(lambda: lookup_ops.lookup(keys, queries), 20),
        "launch_only_ms": cuda_ms(launch, 20), "device_ms": device_ms(launch, 20),
        "plain_ms": cuda_ms(lambda: lookup_ref(keys, queries), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    emit(row)
    return row


def check_rolling(values: torch.Tensor, starts: torch.Tensor, label: str) -> dict:
    """Kernel vs plain on the card within ROLL_RTOL/ROLL_ATOL, and the same
    bits from a second call.  Bytes: values and starts read once, sums
    written once; operations: a prefix and a difference, two float32 adds
    per element.  ``launch_only_ms``: the kernel's launches alone, into an
    output and a scratch allocated beforehand; ``device_ms``: the same with
    the host out of the way."""
    got = rolling_ops.rolling_sum(values, starts)
    again = rolling_ops.rolling_sum(values, starts)
    want = rolling_sum_ref(values, starts)
    torch.cuda.synchronize()
    rolling_ops.check_error()
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
          f"rolling_sum gives the same bits from two calls ({label})")
    check(
        torch.allclose(got, want, rtol=ROLL_RTOL, atol=ROLL_ATOL),
        f"rolling_sum kernel within rtol {ROLL_RTOL}, atol {ROLL_ATOL} of plain ({label})",
    )
    n, f = values.shape
    rows = torch.arange(n, device=starts.device)
    spans = rows + 1 - starts.long()
    tile_start = rows // rolling_ops.TILE_ROWS * rolling_ops.TILE_ROWS
    b_ms, b_by = bound(8 * n * f + 4 * n, 2 * n * f)
    out = torch.empty_like(got)
    scratch = torch.empty(rolling_ops.scratch_len(n, f), dtype=torch.float64, device=values.device)
    launch = lambda: rolling_ops._launch(values, starts, out, scratch)
    row = {
        "phase": "kernel_check", "kernel": "rolling_sum", "shape": label,
        "N": n, "F": f, "max_span": int(spans.max()), "mean_span": float(spans.double().mean()),
        "cross_tile_rows": int((starts.long() < tile_start).sum()),
        "max_abs_err": float((got - want).abs().max()),
        "ms": cuda_ms(lambda: rolling_ops.rolling_sum(values, starts), 20),
        "launch_only_ms": cuda_ms(launch, 20), "device_ms": device_ms(launch, 20),
        "plain_ms": cuda_ms(lambda: rolling_sum_ref(values, starts), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    emit(row)
    return row


def check_pit(table_ts, q_ts, q_lo, q_hi, row_seg, q_seg, label: str) -> dict:
    """Kernel vs plain on the card: idx and valid must be equal, and the
    kernel must launch at this shape.  Bytes: each query's (q_ts, lo, hi)
    read once and (idx, valid) written once, plus each distinct 32-byte
    sector of the table that the bisection reads (the plain search records
    every row it probes; a fresh allocation starts on a sector, so row r
    lies in sector r // 4); operations: one int64 compare per probe.  The
    second bytes bound, ``query_bytes_bound_ms``, counts the query bytes
    alone: the least time if every table sector came from L2.
    Library: one ``torch.searchsorted`` over the composite key
    segment * span + ts, where that key fits in int64 (building it is not
    timed).  The kernel alone is timed with L2 warm (repeated launches) and
    with L2 flushed before each launch."""
    before = pit_ops.counter.launches
    got = pit_ops.pit_search(table_ts, q_ts, q_lo, q_hi)
    probes = []
    want = pit_search_ref(table_ts, q_ts, q_lo, q_hi, probes)
    torch.cuda.synchronize()
    pit_ops.check_error()
    check(pit_ops.counter.launches == before + 1, f"pit_search kernel launched ({label})")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"pit_search kernel == plain ({label})")
    m, b = table_ts.shape[0], q_ts.shape[0]
    seg_len = (q_hi.long() - q_lo.long()).double()
    probed = torch.cat(probes)
    steps, sectors = probed.numel(), torch.unique(probed // 4).numel()
    per_query = 8 + q_lo.element_size() + q_hi.element_size() + 4 + 1
    b_ms, b_by = bound(per_query * b + 32 * sectors, steps)
    tmin, tmax = int(table_ts.min()), int(table_ts.max())
    span = tmax - tmin + 2
    n_seg = int(row_seg.max()) + 1
    library_ms = None
    if n_seg * span < 2**63:
        comp_t = row_seg * span + (table_ts - tmin)
        comp_q = q_seg * span + (q_ts - tmin).clamp(-1, span - 1)
        ub = torch.searchsorted(comp_t, comp_q, right=True)
        real = q_lo < q_hi
        check(torch.equal((ub - 1)[real].int(), got[0][real])
              and torch.equal((ub > q_lo)[real], got[1][real]),
              f"torch.searchsorted on the composite key agrees ({label})")
        library_ms = cuda_ms(lambda: torch.searchsorted(comp_t, comp_q, right=True), 20)
    # the kernel alone, without the wrapper's argument checks and allocations
    idx, valid = torch.empty_like(got[0]), torch.empty_like(got[1])
    lo32, hi32 = q_lo.int(), q_hi.int()
    launch_only = lambda: pit_ops._launch(table_ts, q_ts, lo32, hi32, idx, valid)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=table_ts.device)
    row = {
        "phase": "kernel_check", "kernel": "pit_search", "shape": label,
        "M": m, "B": b, "segments": n_seg, "mean_query_segment": float(seg_len.mean()),
        "span_ms": tmax - tmin, "wide_span": tmax - tmin >= 2**31,
        "found_frac": float(got[1].float().mean()), "bisection_steps": steps,
        "table_sectors_read": sectors,
        "max_abs_err": float(max((got[0].long() - want[0].long()).abs().max(),
                                 (got[1] != want[1]).sum())),
        "ms": cuda_ms(lambda: pit_ops.pit_search(table_ts, q_ts, q_lo, q_hi), 20),
        "launch_only_ms": cuda_ms(launch_only, 20), "device_ms": device_ms(launch_only, 20),
        "launch_only_cold_l2_ms": cuda_ms_restored(launch_only, flush.zero_, 10),
        "plain_ms": cuda_ms(lambda: pit_search_ref(table_ts, q_ts, q_lo, q_hi), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "query_bytes_bound_ms": per_query * b / HBM_BYTES_PER_S * 1e3, "library_ms": library_ms,
    }
    emit(row)
    return row


def check_sync_free(name: str, call, label: str) -> dict:
    """``call()``, a wrapper on inputs already on the card, run once more
    under ``torch.cuda.set_sync_debug_mode("error")`` after a warm call (the
    first call builds the kernels and allocates the error word): any
    synchronizing torch op in the wrapper raises.  The mode is restored."""
    call()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    row = {"phase": "sync_free", "kernel": name, "shape": label, "sync_free": True}
    emit(row)
    return row


def raises_value_error(fn, message: str) -> bool:
    """Whether ``fn()`` raises ``ValueError(message)``."""
    try:
        fn()
    except ValueError as e:
        return str(e) == message
    return False


def check_bad_inputs(device) -> dict:
    """Per kernel, a bad input on the card (a segment bound past the table,
    a window start past its row): the wrapper returns without raising, the
    bad query or row alone is marked (valid False, NaN), and the CPU path's
    ValueError surfaces at ``check_error`` after a synchronization; a report
    nobody read raises at the next call instead; the next good call then
    succeeds and equals the plain version."""
    out = {"phase": "error_checks"}
    i64 = lambda *v: torch.tensor(v, dtype=torch.int64, device=device)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=device)
    table, q, lo = torch.arange(10, dtype=torch.int64, device=device), i64(5, 5, 5), i32(0, 0, 2)
    good_hi, bad_hi = i32(10, 10, 10), i32(10, 11, 10)
    msg = pit_ops.BOUNDS_MESSAGE
    idx, valid = pit_ops.pit_search(table, q, lo, bad_hi)
    torch.cuda.synchronize()
    check(valid.tolist() == [True, False, True] and idx.tolist() == [5, -1, 5],
          "pit_search marks only the query with bad bounds")
    check(raises_value_error(pit_ops.check_error, msg),
          "pit_search's bad bounds raise at check_error after a synchronization")
    pit_ops.pit_search(table, q, lo, bad_hi)
    torch.cuda.synchronize()
    check(raises_value_error(lambda: pit_ops.pit_search(table, q, lo, good_hi), msg),
          "pit_search's unread report raises at the next call")
    got, want = pit_ops.pit_search(table, q, lo, good_hi), pit_search_ref(table, q, lo, good_hi)
    torch.cuda.synchronize()
    pit_ops.check_error()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "pit_search's next good call succeeds")
    out["pit_search"] = {"message": msg, "raised_at_check_error": True,
                         "raised_at_next_call": True, "next_good_call_ok": True}

    n = rolling_ops.TILE_ROWS + 100
    vals = torch.ones(n, 2, device=device)
    good = torch.zeros(n, dtype=torch.int32, device=device)
    msg = rolling_ops.STARTS_MESSAGE
    for row, start in ((7, 8), (n - 1, -1)):
        bad = good.clone()
        bad[row] = start
        sums = rolling_ops.rolling_sum(vals, bad)
        torch.cuda.synchronize()
        nan_rows = sums.isnan().any(dim=1)
        check(bool(nan_rows[row]) and int(nan_rows.sum()) == 1,
              f"rolling_sum marks only the row with start {start} (row {row}) NaN")
        check(raises_value_error(rolling_ops.check_error, msg),
              "rolling_sum's bad start raises at check_error after a synchronization")
        rolling_ops.rolling_sum(vals, bad)
        torch.cuda.synchronize()
        check(raises_value_error(lambda: rolling_ops.rolling_sum(vals, good), msg),
              "rolling_sum's unread report raises at the next call")
        sums = rolling_ops.rolling_sum(vals, good)
        torch.cuda.synchronize()
        rolling_ops.check_error()
        check(torch.equal(sums, rolling_sum_ref(vals, good)),
              "rolling_sum's next good call succeeds")
    out["rolling_sum"] = {"message": msg, "raised_at_check_error": True,
                          "raised_at_next_call": True, "next_good_call_ok": True}

    state, (q_keys, q_ev, q_vals) = scan_case(np.random.default_rng(5), device, 3, 400, 4, 600)
    keys, table = state[0], [t.clone() for t in state[1:]]
    live = torch.nonzero(q_keys[0] >= 0)[0].item()
    for bad, msg in (("duplicate", merge_ops.DUPLICATE_MESSAGE),
                     ("negative", merge_ops.BAD_KEY_MESSAGE)):
        wrong = q_keys.clone()
        if bad == "duplicate":
            wrong[2, -1] = wrong[2, 0] = 7  # key 7 twice in the last partition
        else:
            wrong[0, live] = -5
        merge_ops.merge(keys, *table, wrong, q_ev, q_vals, 99)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(table, state[1:])),
              f"merge_scan's refused batch ({bad} key) leaves the table byte-identical")
        check(raises_value_error(merge_ops.check_error, msg),
              f"merge_scan's {bad} key raises at check_error after a synchronization")
        merge_ops.merge(keys, *table, wrong, q_ev, q_vals, 99)
        torch.cuda.synchronize()
        check(raises_value_error(
            lambda: merge_ops.merge(keys, *table, q_keys, q_ev, q_vals, 99), msg),
            f"merge_scan's unread report ({bad} key) raises at the next call")
        check(all(torch.equal(a, b) for a, b in zip(table, state[1:])),
              "a merge that raised at its call changed nothing")
    plain = [t.clone() for t in table]
    merge_ops.merge(keys, *table, q_keys, q_ev, q_vals, 99)
    merge_scan_ref(keys, *plain, q_keys, q_ev, q_vals, 99)
    torch.cuda.synchronize()
    merge_ops.check_error()
    check(all(torch.equal(a, b) for a, b in zip(table, plain))
          and not torch.equal(table[0], state[1]), "merge_scan's next good call succeeds")
    out["merge_scan"] = {"messages": list(merge_ops.errors.messages),
                         "raised_at_check_error": True, "raised_at_next_call": True,
                         "refused_batch_left_table_identical": True,
                         "next_good_call_ok": True}
    emit(out)
    return out


def check_merge(state, routed, creation: int, label: str) -> dict:
    """Kernel vs plain on the card, each on its own copy of ``state`` (keys,
    event_ts, creation_ts, values): the three updated tensors must be equal
    byte for byte, and the kernel must launch at this shape.  Bytes: every
    key read once (there is no index), the winners' keys read once, the old
    ev and the winner's ev read at each matched slot, the old cr where the
    two ev tie, and the winner's row read and (ev, cr, values) written at
    each slot it wins; operations: one int64 compare per slot.  Times: each
    call on the state put back; ``launch_only_ms`` the C entry alone, into a
    scratch allocated beforehand; ``device_ms`` the same with the host out
    of the way."""
    keys, ev0, cr0, v0 = state
    q_keys, q_ev, q_vals = routed
    mine = [t.clone() for t in (ev0, cr0, v0)]
    plain = [t.clone() for t in (ev0, cr0, v0)]
    before = merge_ops.counter.launches
    merge_ops.merge(keys, *mine, q_keys, q_ev, q_vals, creation)
    merge_scan_ref(keys, *plain, q_keys, q_ev, q_vals, creation)
    torch.cuda.synchronize()
    merge_ops.check_error()
    check(merge_ops.counter.launches == before + 1, f"merge_scan kernel launched ({label})")
    check(all(torch.equal(a, b) for a, b in zip(mine, plain)),
          f"merge_scan kernel == plain ({label})")
    live = q_keys[q_keys >= 0]
    hit, _, new_ev = match_winners(keys, q_keys, q_ev)
    matched, ties = int(hit.sum()), int((hit & (new_ev == ev0)).sum())
    won = int(((mine[0] != ev0) | (mine[1] != cr0)).sum())
    p, c = keys.shape
    q, d = q_keys.shape[1], v0.shape[2]
    b_ms, b_by = bound(8 * p * c + 8 * live.numel() + 16 * matched + 8 * ties
                       + won * (16 + 8 * d), p * c)

    def restore(copy):
        return lambda: [a.copy_(b) for a, b in zip(copy, (ev0, cr0, v0))]

    # the kernel alone, without the wrapper's argument checks and allocation
    scratch = torch.empty(merge_ops.scratch_len(p, q), dtype=torch.int64, device=keys.device)
    launch_only = lambda: merge_ops._launch(keys, *mine, q_keys, q_ev, q_vals, scratch,
                                            creation)

    row = {
        "phase": "kernel_check", "kernel": "merge_scan", "shape": label,
        "P": p, "C": c, "Q": q, "D": d, "winners": live.numel(), "matched_slots": matched,
        "tied_slots": ties, "written_slots": won,
        "winner_keys_in": "shared" if merge_ops.hash_in_shared(q) else "global",
        "max_abs_err": float((mine[2] - plain[2]).abs().max()) if v0.numel() else 0.0,
        "ms": cuda_ms_restored(
            lambda: merge_ops.merge(keys, *mine, q_keys, q_ev, q_vals, creation),
            restore(mine), 10),
        "launch_only_ms": cuda_ms_restored(launch_only, restore(mine), 10),
        "device_ms": device_ms_restored(launch_only, restore(mine), 10),
        "plain_ms": cuda_ms_restored(
            lambda: merge_scan_ref(keys, *plain, q_keys, q_ev, q_vals, creation),
            restore(plain), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    merge_ops.check_error()
    emit(row)
    return row


def check_adamw(shape: tuple, dtypes: tuple, label: str) -> dict:
    """AdamW's kernels against the optimizer's leaf path on the card, on one
    leaf of ``shape``, weight and gradient of ``dtypes``, float32 moments
    carried in: ``ops.update`` and ``_update_leaf`` from the same state with
    the same clip scale, decay and scheduled step (the driver's, past its
    warm-up), three steps, the same bits in p, m and v after each; each
    step's ``ops.sqnorm`` within ADAMW_NORM_RTOL of ``torch.sum``'s float64
    sum of the float32 squares, the same bits from two calls.  Bytes: p, g,
    m and v read, p, m and v written (22 a bf16 parameter); operations:
    ADAMW_OPS an element; the norm reads g once."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(5)
    p_dtype, g_dtype = dtypes
    p = torch.randn(shape, generator=gen, device=dev).to(p_dtype)
    m = torch.randn(shape, generator=gen, device=dev).mul_(1e-3)
    v = torch.randn(shape, generator=gen, device=dev).square_().mul_(1e-6)
    fused = [p.clone(), m.clone(), v.clone()]
    sched = warmup_cosine(TRAIN_LR, 20, 100)
    b1, b2 = ADAMW_HYPER["b1"], ADAMW_HYPER["b2"]
    before = (adamw_ops.counter.launches, adamw_ops.sqnorm_counter.launches)
    norm_err, g = 0.0, None
    for k in range(21, 24):
        del g
        g = torch.randn(shape, generator=gen, device=dev).mul_(0.01).to(g_dtype)
        got, again = adamw_ops.sqnorm([g]), adamw_ops.sqnorm([g])
        want = torch.sum(torch.square(g.float()), dtype=torch.float64)
        err = abs(float(got) - float(want)) / float(want)
        check(err <= ADAMW_NORM_RTOL, f"sqnorm within {ADAMW_NORM_RTOL} of torch.sum ({label})")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"sqnorm gives the same bits from two calls ({label})")
        norm_err = max(norm_err, err)
        count = torch.tensor(k, dtype=torch.int32, device=dev)
        scalars = dict(scale=torch.clamp(1.0 / torch.clamp(torch.sqrt(got), min=1e-9), max=1.0),
                       bc1=1.0 - b1 ** count.float(), bc2=1.0 - b2 ** count.float(),
                       step=sched(count))
        adamw_ops.update([(fused[0], g, fused[1], fused[2])], **scalars, **ADAMW_HYPER)
        adamw_mod._update_leaf(p, g, m, v, **scalars, **ADAMW_HYPER)
        for name, a, b in zip("pmv", fused, (p, m, v)):
            bits = torch.int16 if a.element_size() == 2 else torch.int32
            check(torch.equal(a.view(bits), b.view(bits)),
                  f"adamw update {name} == the leaf path's bit for bit, step {k} ({label})")
    torch.cuda.synchronize()
    check((adamw_ops.counter.launches - before[0], adamw_ops.sqnorm_counter.launches - before[1])
          == (3, 6), f"one update launch a step, one sqnorm launch a call ({label})")
    n = p.numel()
    nbytes = n * (2 * p.element_size() + g.element_size() + 16)
    b_ms, b_by = bound(nbytes, ADAMW_OPS * n)
    row = {
        "phase": "kernel_check", "kernel": "adamw_update", "shape": label,
        "numel": n, "dtypes": [str(p_dtype), str(g_dtype)], "bytes_per_param": nbytes / n,
        "max_abs_err": max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(fused, (p, m, v))),
    }
    upd = lambda: adamw_ops.update([(fused[0], g, fused[1], fused[2])], **scalars,
                                   **ADAMW_HYPER)
    row.update({
        "ms": cuda_ms(upd, 20), "device_ms": device_ms(upd, 20),
        "plain_ms": cuda_ms(lambda: adamw_mod._update_leaf(p, g, m, v, **scalars,
                                                           **ADAMW_HYPER), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "sqnorm_ms": cuda_ms(lambda: adamw_ops.sqnorm([g]), 20),
        "sqnorm_bound_ms": n * g.element_size() / HBM_BYTES_PER_S * 1e3,
        "sqnorm_max_rel_err": norm_err,
    })
    emit(row)
    return row


def check_adamw_odd_leaves(device) -> dict:
    """The driver's optimizer on a strided and on a float16 leaf on the
    card: each raises (the kernel takes neither, and a card leaf never
    falls back to the plain passes), the weight and the step count
    untouched."""
    opt = lm_train.train_optimizer(TRAIN_LR, TRAIN_STEPS)
    raised = {}
    for kind, w in (("strided", torch.ones(64, 48, dtype=torch.bfloat16, device=device).t()),
                    ("float16", torch.ones(64, dtype=torch.float16, device=device))):
        params = {"w": w}
        state = opt.init(params)
        try:
            opt.update({"w": torch.ones_like(w)}, state, params)
        except (TypeError, ValueError) as e:
            raised[kind] = f"{type(e).__name__}: {e}"
        torch.cuda.synchronize()
        check(kind in raised and bool((w == 1).all()) and int(state["count"]) == 0,
              f"a {kind} card leaf raises in AdamW's update, its weight untouched")
    emit({"phase": "adamw_odd_leaves", "raised": raised})
    return raised


def check_adamw_launches(launches: dict, params, label: str, steps: int = TRAIN_STEPS) -> int:
    """AdamW's kernels in a train row's launches, counted from zero over
    ``steps`` steps of ``params`` (plain card tensors, the driver's float32
    moments and clip): one update launch a non-empty leaf a step, one sum of
    squares a step.  Returns their sum, for the row's count of the rest."""
    leaves = sum(1 for p in params.parameters() if p.numel())
    check(launches["adamw_update"] == steps * leaves,
          f"one AdamW update launch a leaf a step ({leaves} leaves, {steps} steps): {label}")
    check(launches["adamw_sqnorm"] == steps, f"one AdamW sum of squares a step: {label}")
    return steps * (leaves + 1)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The library yardstick for flash_attn: one PyTorch call on the same
    (B, S, H, D) inputs, viewed as (B, H, S, D).  Timed here, used nowhere
    in the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
        enable_gqa=True).transpose(1, 2)


def check_flash(b: int, s: int, h: int, kv: int, d: int, dtype, route: str, label: str, rng,
                reps: int = 10) -> dict:
    """Kernel vs plain on the card within FLASH_TOL, on seeded normal q, k,
    v (the library call's distance to plain is reported), launched on
    ``route``.  Operations: 4·D per (query head, visible key) pair -- two for
    q.k, two for p.v -- over the rate of the input type (bfloat16 tensor
    cores, or float32); bytes: q, k, v read once and O written once."""
    up = lambda shape: torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        "cuda").to(dtype)
    q, k, v = up((b, s, h, d)), up((b, s, kv, d)), up((b, s, kv, d))
    before = flash_ops.counter.launches, flash_ops.tc_counter.launches
    got = flash_ops.flash_attention(q, k, v)
    want = attention_ref(q, k, v).to(dtype)
    lib = sdpa(q, k, v)
    torch.cuda.synchronize()
    check(flash_ops.route(dtype, d) == route, f"flash_attn takes the {route} route ({label})")
    check(flash_ops.counter.launches == before[0] + 1
          and flash_ops.tc_counter.launches == before[1] + (route == "wgmma"),
          f"flash_attn kernel launched on the {route} route ({label})")
    tol = FLASH_TOL[dtype]
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"flash_attn kernel within {tol} of plain ({label})")
    pairs = sum(min(i + 1, s) for i in range(s))
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    b_ms, b_by = bound(q.element_size() * (2 * q.numel() + 2 * k.numel()),
                       4 * b * h * d * pairs, rate)
    row = {
        "phase": "kernel_check", "kernel": "flash_attn", "shape": label, "route": route,
        "B": b, "S": s, "H": h, "KV": kv, "D": d, "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "library_max_abs_err": float((lib.float() - want.float()).abs().max()),
        "ms": cuda_ms(lambda: flash_ops.flash_attention(q, k, v), reps),
        "plain_ms": cuda_ms(lambda: attention_ref(q, k, v), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: sdpa(q, k, v), reps),
    }
    emit(row)
    return row


def wide_span_case(rng, device, n_ent: int = 4096, rows: int = 2048, n_q: int = 1 << 20):
    """``n_ent`` entities x ``rows`` epoch-ms rows each, gaps up to 2**22 ms
    (zero gaps tie), so each entity spans about 2**32 ms; ``n_q`` queries
    over 1.1 x the entities: before the first row, exact hits, after the last
    row and in between, and missing entities (lo == hi)."""
    ts = EPOCH_MS + np.cumsum(rng.integers(0, 1 << 22, (n_ent, rows)), axis=1)
    ent = rng.integers(0, n_ent * 11 // 10, n_q)
    e = np.minimum(ent, n_ent - 1)
    lo = e * rows
    hi = np.where(ent < n_ent, lo + rows, lo)
    first, last = ts[e, 0], ts[e, -1]
    kind = rng.integers(0, 4, n_q)
    q = np.select(
        [kind == 0, kind == 1, kind == 2],
        [first - rng.integers(1, 1 << 30, n_q), ts[e, rng.integers(0, rows, n_q)],
         last + rng.integers(0, 1 << 30, n_q)],
        default=first + rng.integers(0, last - first + 1),
    )
    up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
    return (up(ts.ravel(), np.int64), up(q, np.int64), up(lo, np.int32), up(hi, np.int32),
            up(np.repeat(np.arange(n_ent), rows), np.int64), up(e, np.int64))


def scan_case(rng, device, p: int, c: int, d: int, n_winners: int):
    """A table whose keys sit in their hash partitions (3/4 of the slots),
    event and creation timestamps drawn from int32/int64 boundary values
    (INT64_MIN: pre-stamped fresh inserts), and ``n_winners`` unique
    winners, 3/4 of them held keys, routed with pads."""
    cand = rng.integers(0, 2**40, p * c)
    home = lookup_ops.partition_of(cand, p)
    keys = np.full((p, c), -1, np.int64)
    for part in range(p):
        mine = cand[home == part][: c * 3 // 4]
        keys[part, rng.choice(c, len(mine), replace=False)] = mine
    edge = np.array([2**31 - 1, 2**31, 2**32, -1, 0, I64_MIN, 2**31 + 1], np.int64)
    live = keys[keys >= 0]
    n_hit = min(n_winners * 3 // 4, len(live))
    ids = np.concatenate([rng.choice(live, n_hit, replace=False),
                          2**41 + rng.permutation(4 * n_winners)[: n_winners - n_hit]])
    routed = merge_ops.route_winners(p, ids, rng.choice(edge, n_winners),
                                     rng.standard_normal((n_winners, d)).astype(np.float32))
    up = lambda a: torch.from_numpy(a).to(device)
    state = (keys, rng.choice(edge, (p, c)), rng.choice(edge, (p, c)),
             rng.standard_normal((p, c, d)).astype(np.float32))
    return tuple(map(up, state)), tuple(map(up, routed))


def many_partitions_case(rng, device, p: int, c: int, d: int, n_winners: int):
    """``scan_case`` for P in the tens of thousands, built without a loop
    over partitions: 2 * P * c / 3 random ids, each in the first free slot
    of its hash partition (up to 3/4 of the slots), edge timestamps, and
    ``n_winners`` unique winners, 3/4 of them held keys."""
    ids = np.unique(rng.integers(0, 2**40, 2 * p * c // 3))
    home = lookup_ops.partition_of(ids, p)
    order = np.argsort(home, kind="stable")
    ids, home = ids[order], home[order]
    slot = np.arange(len(ids)) - np.searchsorted(home, home)
    keep = slot < c * 3 // 4
    keys = np.full((p, c), -1, np.int64)
    keys[home[keep], slot[keep]] = ids[keep]
    edge = np.array([2**31 - 1, 2**31, 2**32, -1, 0, I64_MIN, 2**31 + 1], np.int64)
    live = ids[keep]
    n_hit = min(n_winners * 3 // 4, len(live))
    win = np.concatenate([rng.choice(live, n_hit, replace=False),
                          2**41 + rng.permutation(4 * n_winners)[: n_winners - n_hit]])
    routed = merge_ops.route_winners(p, win, rng.choice(edge, n_winners),
                                     rng.standard_normal((n_winners, d)).astype(np.float32))
    up = lambda a: torch.from_numpy(a).to(device)
    state = (keys, rng.choice(edge, (p, c)), rng.choice(edge, (p, c)),
             rng.standard_normal((p, c, d)).astype(np.float32))
    return tuple(map(up, state)), tuple(map(up, routed))


def adversarial_lookup_case(rng, device, p: int, c: int, q: int):
    """Keys drawn half from -1 (empty), -2 (pad), INT64_MIN, INT64_MAX and a
    few other values, half at random; queries 70% from the same values (so
    each partition holds each in many slots and asks for each in many
    columns), the rest held keys, and every 16th column a miss."""
    pool = np.array([-1, -2, I64_MIN, 2**63 - 1, 0, 1, 2**32, -(2**31)], np.int64)
    keys = np.where(rng.random((p, c)) < 0.5, rng.choice(pool, (p, c)),
                    rng.integers(I64_MIN, 2**63 - 1, (p, c), dtype=np.int64))
    queries = np.where(rng.random((p, q)) < 0.7, rng.choice(pool, (p, q)),
                       keys[np.arange(p)[:, None], rng.integers(0, c, (p, q))])
    queries[:, ::16] = rng.integers(2**40, 2**41, (p, len(range(0, q, 16))))  # misses
    return torch.from_numpy(keys).to(device), torch.from_numpy(queries).to(device)


def routed_queries(store, ids: np.ndarray) -> torch.Tensor:
    routed = lookup_ops.route_queries_i64(store.num_partitions, ids)[0]
    return torch.from_numpy(routed).to(store.device)


# -- phase 3: the profile table -------------------------------------------------
def profile_spec() -> FeatureSetSpec:
    return FeatureSetSpec(
        name="profile", version=1, entity=Entity("user", ("entity_id",)),
        features=tuple(Feature(f"f{i}") for i in range(PROFILE_FEATURES)),
        source_name="profile_src",
        transform=UDFTransform(lambda df, ctx: df, name="identity"),
        materialization=MaterializationSettings(
            offline_enabled=False, online_enabled=True, online_ttl=PROFILE_TTL
        ),
    )


def profile_store(device: str, engine: str, partitions: int) -> FeatureStore:
    fs = FeatureStore("profile-" + engine, device=device, merge_engine=engine,
                      online_partitions=partitions)
    fs.register_source(SyntheticEventSource("profile_src"))
    fs.create_feature_set(profile_spec())
    return fs


def profile_frames(n_entities: int, frame_rows: int, seed: int):
    """8 frames of inserts (every id once, in random order), then 4 frames
    of random ids: event_ts below, above or equal to the inserted one
    (no-ops, overrides, creation_ts tie-breaks), duplicates inside a frame,
    and two frames that share a creation_ts."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_entities).astype(np.int64)
    ev0 = rng.integers(1_000_000, 2_000_000, n_entities).astype(np.int64)
    cols = lambda ids, ev: {
        "entity_id": ids, "ts": ev,
        **{f"f{i}": rng.standard_normal(len(ids)).astype(np.float32)
           for i in range(PROFILE_FEATURES)},
    }
    for k in range(0, n_entities, frame_rows):
        ids = perm[k:k + frame_rows]
        yield Table(cols(ids, ev0[ids])), 10_000 + k // frame_rows
    for cr in (20_000, 20_001, 20_002, 20_002):
        ids = rng.integers(0, n_entities, frame_rows).astype(np.int64)
        mode = rng.integers(0, 3, frame_rows)
        ev = ev0[ids] + np.where(mode == 0, -rng.integers(1, 50, frame_rows),
                                 np.where(mode == 1, rng.integers(1, 50, frame_rows), 0))
        yield Table(cols(ids, ev)), cr


def scan_merge(fs: FeatureStore, frame: Table, creation: int) -> dict:
    """The frame reduced to per-id winners by the merge plan (as the
    materialization bench's scan-merge engine does), then applied by the
    index-free scan merge to a clone of the store's device state, with the
    launch counts zeroed just before the merge and read just after."""
    online = fs.online
    state = online.device_state("profile", 1)
    start = tuple(t.clone() for t in state.planes())
    table = online._tables[("profile", 1)]
    dev = state.keys.device

    def resolve(uids: np.ndarray):
        part, slot, found = online._index_find(table, uids)
        ev, cr = merge_ops.gather_slot_ts(start[1], start[2], torch.from_numpy(part).to(dev),
                                          torch.from_numpy(slot).to(dev))
        return ev.cpu().numpy(), cr.cpu().numpy(), found

    t0 = time.perf_counter()
    plan = plan_online_batch(encode_keys([frame["entity_id"]]), frame["ts"].astype(np.int64),
                             creation, resolve)
    check(not plan.is_new.any(), "the update frame holds only stored ids")
    feats = frame.column_stack([f"f{i}" for i in range(PROFILE_FEATURES)])[plan.winner_row]
    routed = tuple(torch.from_numpy(a).to(dev) for a in merge_ops.route_winners(
        online.num_partitions, plan.uids, plan.winner_ev, feats))
    work = tuple(t.clone() for t in start[1:])
    plan_s = time.perf_counter() - t0
    reset_counts()
    t1 = time.perf_counter()
    merge_ops.merge(start[0], *work, *routed, creation)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        merge_ops.check_error(dev)
    merge_s = time.perf_counter() - t1
    launches = read_counts()
    check(launches["merge_scan"] == (dev.type == "cuda")
          and sum(launches.values()) == launches["merge_scan"],
          "the scan path launched merge_scan once and nothing else")
    return {"start": start, "work": work, "routed": routed, "plan": plan,
            "row": {"winners": len(plan.uids), "Q": routed[0].shape[1], "plan_s": plan_s,
                    "merge_s": merge_s, "launches": launches}}


def phase_profile(device: str, n_entities: int, frame_rows: int,
                  partitions: int, n_batches: int, seed: int = 0) -> dict:
    reset_counts()
    t0 = time.perf_counter()
    dev = profile_store(device, "kernel", partitions)
    host = profile_store("cpu", "vector", partitions)
    tallies = np.zeros(3, np.int64)
    merge_s = 0.0
    scan = None
    for frame, cr in profile_frames(n_entities, frame_rows, seed):
        if cr == 20_000:  # the first update frame also takes the scan path
            scan = scan_merge(dev, frame, cr)
        t1 = time.perf_counter()
        a = dev.write_batch("profile", 1, frame, creation_ts=cr)["online"]
        merge_s += time.perf_counter() - t1
        b = host.write_batch("profile", 1, frame, creation_ts=cr)["online"]
        for k in ("inserts", "overrides", "noops", "creation_ts"):
            check(a[k] == b[k], f"profile MergeStats {k} equal")
        for k in ("touched_parts", "touched_slots", "touched_keys",
                  "touched_event_ts", "touched_values"):
            check(np.array_equal(a[k], b[k]), f"profile MergeStats {k} equal")
        tallies += (a["inserts"], a["overrides"], a["noops"])
        if cr == 20_000:
            state = dev.online.device_state("profile", 1)
            check(torch.equal(state.keys, scan["start"][0]), "the update frame inserted nothing")
            for name, mine, theirs in zip(("event_ts", "creation_ts", "values"),
                                          scan.pop("work"), state.planes()[1:]):
                check(torch.equal(mine, theirs), f"scan merge == write_batch on {name}")
            plan = scan.pop("plan")
            check((plan.inserts, plan.overrides, plan.noops)
                  == (a["inserts"], a["overrides"], a["noops"]),
                  "scan merge plan tallies == write_batch MergeStats")
    check(tallies[1] > 0 and tallies[2] > 0, "updates hold overrides and no-ops")
    state = dev.online.device_state("profile", 1)
    device_gb = state.nbytes() / 1e9
    da, db = dev.online.dump_all("profile", 1), host.online.dump_all("profile", 1)
    check(len(da) == n_entities and sorted(da.columns) == sorted(db.columns),
          "profile dump holds every entity")
    for c in da.columns:
        check(np.array_equal(da[c], db[c]), f"profile dump_all column {c} byte-identical")
    del da, db

    rng = np.random.default_rng(seed + 1)
    get_ms, found_frac = [], []
    for now in [20_100] * n_batches + [10_004 + PROFILE_TTL]:
        dev.advance_clock(now)
        host.advance_clock(now)
        ids = rng.integers(0, int(1.1 * n_entities), GET_BATCH).astype(np.int64)
        t1 = time.perf_counter()
        va, fa = dev.get_online_features("profile", 1, [ids])
        get_ms.append((time.perf_counter() - t1) * 1e3)
        vb, fb = host.get_online_features("profile", 1, [ids], use_kernel=False)
        check(np.array_equal(fa, fb) and np.array_equal(va, vb),
              "profile GET byte-identical to the host twin")
        found_frac.append(float(fa.mean()))
    check(found_frac[-1] < min(found_frac[:-1]), "TTL expires rows past the TTL")
    row = {
        "phase": "profile", "device": str(dev.device), "entities": n_entities,
        "features": PROFILE_FEATURES, "partitions": partitions,
        "capacity": int(state.keys.shape[1]), "device_table_gb": device_gb,
        "inserts": int(tallies[0]), "overrides": int(tallies[1]), "noops": int(tallies[2]),
        "kernel_store_merge_s": merge_s, "get_batches": n_batches + 1,
        "found_frac": found_frac[0], "found_frac_past_ttl": found_frac[-1],
        "get_p50_ms": float(np.percentile(get_ms[:-1], 50)),
        "get_p99_ms": float(np.percentile(get_ms[:-1], 99)),
        "scan_merge": {**scan["row"], "equal_to_write_batch": True},
        "launches": read_counts(),
        "seconds": time.perf_counter() - t0,
    }
    emit(row)
    return {"row": row, "store": dev, "scan": scan}


# -- phase 4: the main path -----------------------------------------------------
def txn_aggs() -> list[RollingAgg]:
    aggs = []
    for w, tag in ((HOUR, "1h"), (6 * HOUR, "6h")):
        for col in ("amount", "quantity"):
            for agg in ("sum", "mean"):
                aggs.append(RollingAgg(f"{col}_{agg}_{tag}", col, w, agg))
        aggs.append(RollingAgg(f"count_{tag}", "amount", w, "count"))
    return aggs


def txn_parts(device: str, n_entities: int, events_per_hour: int):
    """The main path's source, DSL transform and feature set."""
    source = SyntheticEventSource("events", seed=0, num_entities=n_entities,
                                  events_per_bucket=events_per_hour, bucket_ms=HOUR)
    transform = DslTransform("entity_id", "ts", txn_aggs(), device=device)
    spec = FeatureSetSpec(
        name="txn_rolling", version=1, entity=Entity("customer", ("entity_id",)),
        features=tuple(Feature(a.output) for a in txn_aggs()), source_name="events",
        transform=transform, timestamp_col="ts", source_lookback=6 * HOUR,
        materialization=MaterializationSettings(
            offline_enabled=True, online_enabled=True, schedule_interval=HOUR),
    )
    return source, transform, spec


def txn_store(device: str, n_entities: int, events_per_hour: int):
    source, transform, spec = txn_parts(device, n_entities, events_per_hour)
    fs = FeatureStore("txn", device=device, merge_engine="kernel")
    fs.register_source(source)
    fs.create_feature_set(spec)
    return fs, source, transform


def phase_txn(device: str, n_entities: int, events_per_hour: int, hours: int,
              n_batches: int, seed: int = 0) -> dict:
    fs, source, transform = txn_store(device, n_entities, events_per_hour)
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, int(1.1 * n_entities), GET_BATCH).astype(np.int64)
               for _ in range(n_batches)]
    reset_counts()
    t0 = time.perf_counter()
    jobs = {"succeeded": 0, "retried": 0, "failed": 0}
    for h in range(1, hours + 1):
        for k, v in fs.tick(now=h * HOUR).items():
            jobs[k] += v
    tick_s = time.perf_counter() - t0
    served = [fs.get_online_features("txn_rolling", 1, [ids]) for ids in batches]
    launches = read_counts()
    path_s = time.perf_counter() - t0

    check(jobs["succeeded"] == hours and jobs["failed"] == 0, f"{hours} jobs succeeded")
    for ids, (v, f) in zip(batches, served):
        hv, hf = fs.get_online_features("txn_rolling", 1, [ids], use_kernel=False)
        check(np.array_equal(f, hf) and np.array_equal(v, hv),
              "kernel GET byte-identical to host GET")
    report = fs.check_consistency("txn_rolling", 1)
    check(report.consistent, f"txn_rolling consistent: {report.summary()}")

    # one job's DSL output on the card against the same transform on the CPU
    mid = hours // 2 * HOUR
    df = source.read(mid - 6 * HOUR, mid + HOUR)
    on_card = transform(df, {})
    on_cpu = DslTransform("entity_id", "ts", txn_aggs(), device="cpu")(df, {})
    dsl_err = 0.0
    for c in on_cpu.columns:
        a, b = on_card[c], on_cpu[c]
        if a.dtype.kind == "f":
            check(np.allclose(a, b, rtol=ROLL_RTOL, atol=ROLL_ATOL), f"DSL column {c} card vs cpu")
            dsl_err = max(dsl_err, float(np.abs(a - b).max()) if len(a) else 0.0)
        else:
            check(np.array_equal(a, b), f"DSL column {c} card vs cpu")
    row = {
        "phase": "txn_rolling", "device": str(fs.device), "entities": n_entities,
        "events_per_hour": events_per_hour, "jobs": jobs,
        "online_records": fs.online.num_records("txn_rolling", 1),
        "offline_rows": fs.offline.num_rows("txn_rolling", 1),
        "consistency": report.summary(), "dsl_rows_checked": len(df),
        "dsl_max_abs_err_card_vs_cpu": dsl_err, "launches": launches,
        "tick_s": tick_s, "path_s": path_s,
        "found_frac": float(np.mean([f.mean() for _, f in served])),
    }
    emit(row)
    return {"row": row, "store": fs, "source": source, "batch": batches[0], "mid": mid}


def dsl_inputs(source, mid: int, window: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (values, starts) one job's DSL hands the rolling sum for
    ``window``: rows of [mid - 6 h, mid + 1 h) sorted by (entity, ts)."""
    df = source.read(mid - 6 * HOUR, mid + HOUR)
    order = np.lexsort((df["ts"], df["entity_id"]))
    ent, ts = df["entity_id"][order], df["ts"][order].astype(np.int64)
    seg = np.concatenate([[0], np.cumsum(ent[1:] != ent[:-1])]).astype(np.int64)
    starts = rolling_ops.window_starts(seg, ts, window)
    vals = np.stack([df["amount"][order], df["quantity"][order]], axis=1).astype(np.float32)
    return torch.from_numpy(vals).to(device), torch.from_numpy(starts).to(device)


# -- phase 5: offline retrieval ------------------------------------------------
def check_nearest_past(history: Table, ids, q_ts, res, features, rng, n: int) -> int:
    """An independent numpy search on ``n`` sampled spine rows: the found
    row is the one of greatest (event_ts, creation_ts) among the entity's
    rows at or before ``q_ts``, and not found means there is none."""
    sample = rng.choice(len(ids), n, replace=False)
    key, ev, cr = history["__key__"], history["event_ts"], history["creation_ts"]
    sub = np.flatnonzero(np.isin(key, ids[sample]))
    for i in sample:
        rows = sub[(key[sub] == ids[i]) & (ev[sub] <= q_ts[i])]
        if len(rows) == 0:
            check(not res.found[i], "a row with no past record is not found")
            continue
        best = rows[np.lexsort((cr[rows], ev[rows]))[-1]]
        check(bool(res.found[i]) and res.event_ts[i] == ev[best]
              and all(res.values[f][i] == history[f][best] for f in features),
              "the found row is the nearest past")
    return n


def phase_offline(fs: FeatureStore, n_entities: int, spine_rows: int, seed: int = 0) -> dict:
    """The training-data path: a seeded spine of ``spine_rows`` (entity_id,
    ts) rows, ts uniform over [0 h, 25 h], ids over 1.1 x the entities,
    joined point-in-time onto the ``txn_rolling`` offline history."""
    spec = fs.registry.get_feature_set("txn_rolling", 1)
    features = [f.name for f in spec.features]
    sets = [("txn_rolling", 1)]
    rng = np.random.default_rng(seed)
    spine = Table({"entity_id": rng.integers(0, int(1.1 * n_entities), spine_rows),
                   "ts": rng.integers(0, 25 * HOUR + 1, spine_rows)})
    ids, ts = spine["entity_id"], spine["ts"]
    per_call = int(fs.device.type == "cuda")  # a CPU store runs the plain search
    reset_counts()
    t0 = time.perf_counter()
    out = fs.get_offline_features(spine, sets)
    facade_s = time.perf_counter() - t0
    check(read_counts()["pit_search"] == per_call, "one pit_search launch per feature set")
    plain = fs.get_offline_features(spine, sets, use_kernel=False)
    on_cpu = get_offline_features(fs.offline, spine, [spec], device="cpu")
    for c in out.columns:
        check(np.array_equal(out[c], plain[c]), f"offline column {c}: kernel == plain")
        check(np.array_equal(out[c], on_cpu[c]), f"offline column {c}: card == cpu")
    t1 = time.perf_counter()
    history = fs.offline.read("txn_rolling", 1)
    read_s = time.perf_counter() - t1
    results, checked = {}, 0
    for s in (spec, dataclasses.replace(spec, expected_delay=15 * 60_000)):
        before = read_counts()["pit_search"]
        res = pit_join_feature_set([ids], ts, s, history, device=fs.device)
        check(read_counts()["pit_search"] == before + per_call, "one pit_search launch per call")
        host = pit_join_feature_set([ids], ts, s, history, device="cpu")
        check(np.array_equal(res.found, host.found) and np.array_equal(res.event_ts, host.event_ts)
              and all(np.array_equal(res.values[f], host.values[f]) for f in features),
              f"delay {s.expected_delay}: card == cpu")
        check(bool((res.event_ts <= ts - s.expected_delay)[res.found].all()),
              f"delay {s.expected_delay}: no found row after ts - expected_delay")
        checked += check_nearest_past(history, ids, ts - s.expected_delay, res, features,
                                      rng, 2000)
        results[s.expected_delay] = res
    launches = read_counts()
    first, delayed = results[0], results[15 * 60_000]
    check(np.array_equal(out["txn_rolling:v1:__found__"], first.found)
          and all(np.array_equal(out[f"txn_rolling:v1:{f}"], first.values[f]) for f in features),
          "FeatureStore.get_offline_features == pit_join_feature_set")
    check(delayed.found.sum() <= first.found.sum(), "the delay hides records, never adds any")
    row = {
        "phase": "offline_retrieval", "device": str(fs.device), "spine_rows": spine_rows,
        "history_rows": len(history), "found_frac": float(first.found.mean()),
        "found_frac_delay_15min": float(delayed.found.mean()),
        "facade_s": facade_s, "spine_rows_per_s": spine_rows / facade_s, "read_s": read_s,
        **{f"{k}_s": v for k, v in first.seconds.items()},
        "nearest_past_checked": checked, "launches": launches,
    }
    emit(row)
    return {"row": row, "history": history, "spine": spine, "spec": spec}


def pit_main_inputs(history: Table, spine: Table, delay: int, device):
    """The (table_ts, q_ts, q_lo, q_hi) the offline path hands the search,
    plus each row's and each query's segment (for the library yardstick)."""
    h, uniq, offsets = _prepare_history(history)
    ids = encode_keys([spine["entity_id"]])
    q_ts, q_lo, q_hi, _ = search_inputs(ids, spine["ts"], delay, uniq, offsets)
    row_seg = np.repeat(np.arange(len(uniq)), np.diff(offsets))
    q_seg = np.clip(np.searchsorted(uniq, ids), 0, len(uniq) - 1)
    up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
    return (up(h["event_ts"], np.int64), up(q_ts, np.int64), up(q_lo, np.int32),
            up(q_hi, np.int32), up(row_seg, np.int64), up(q_seg, np.int64))


# -- the geo phase: both store planes replicated across three regions -----------
GEO_REGIONS = ("westus2", "eastus", "westeurope")
GEO_JOBS, GEO_CHAOS_JOBS = 12, 6
GEO_SPINE_ROWS = 1 << 16
GEO_DAEMON = "eastus-daemon"  # the out-of-process replica's name in the replica set
# multi-home at 2**21 entities in 3 frames (two of inserts, one of updates,
# one entering at each region): cut from 2**22 and 6 for the run's time
MH_ENTITIES, MH_FRAME_ROWS, MH_FRAMES, MH_SHARDS = 1 << 21, 1 << 20, 3, 16
# benchmarks/bench_geo_replication.py: CHAOS_RATES and its chaos delivery policy
GEO_CHAOS_RATES = dict(drop_rate=0.10, dup_rate=0.05, reorder_rate=0.05, corrupt_rate=0.05,
                       ack_loss_rate=0.03, spike_rate=0.02)
GEO_CHAOS_POLICY = dict(suspect_after=2, dead_after=5, backoff_base=1, backoff_cap=4,
                        probe_interval=2)


def geo_topology() -> GeoTopology:
    """The geo benchmark's three regions: one-way links of 32, 70 and 40 ms,
    1 Gbps between regions."""
    return GeoTopology(
        regions={r: Region(r) for r in GEO_REGIONS}, local_latency_ms=1.0,
        cross_region_latency_ms=60.0, cross_region_gbps=1.0,
        link_latency_ms={("westus2", "eastus"): 32.0, ("westus2", "westeurope"): 70.0,
                         ("eastus", "westeurope"): 40.0},
    )


def geo_txn_store(device: str, n_entities: int, events_per_hour: int,
                  topology: GeoTopology | None = None, **kw) -> GeoFeatureStore:
    """The main path's feature set, homed in westus2 and replicated, both
    planes, to eastus and westeurope."""
    source, _, spec = txn_parts(device, n_entities, events_per_hour)
    g = GeoFeatureStore("geo", topology=topology or geo_topology(), home_region="westus2",
                        replica_regions=GEO_REGIONS[1:], device=device,
                        merge_engine="kernel", **kw)
    g.register_source(source)
    g.create_feature_set(spec)
    return g


class Spans:
    """Host seconds and calls of named callables, each wrapped in place for
    the ``with`` block and put back after it: the geo phase's time by layer."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = collections.defaultdict(float)
        self.calls: collections.Counter = collections.Counter()
        self._undo: list[tuple] = []

    def wrap(self, name: str, owner, attr: str) -> None:
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, time.perf_counter() - t0)

        self._undo.append((owner, attr, vars(owner).get(attr), attr in vars(owner)))
        setattr(owner, attr, timed)

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] += seconds
        self.calls[name] += 1

    def __enter__(self) -> "Spans":
        return self

    def __exit__(self, *exc) -> None:
        for owner, attr, old, had in reversed(self._undo):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._undo.clear()

    def row(self) -> dict:
        return {k: {"s": v, "calls": self.calls[k]} for k, v in sorted(self.seconds.items())}


def plane_state(online, offline, name: str) -> tuple[Table, Table]:
    """One region's two planes: the online dump (sorted key index) and the
    canonical offline history (sorted by the full record key)."""
    return online.dump_all(name, 1), offline.canonical_history(name, 1)


def check_same_state(want: tuple, got: tuple, what: str) -> None:
    """Both planes byte-identical: every column of the online dump and of
    the canonical offline history, dtype and bytes."""
    for plane, a, b in zip(("online", "offline"), want, got):
        check(sorted(a.names) == sorted(b.names) and len(a) == len(b),
              f"{what}: {plane} columns and rows")
        for c in a.names:
            check(a[c].dtype == b[c].dtype and np.array_equal(a[c], b[c]),
                  f"{what}: {plane} column {c} byte-identical")


def converge(g: GeoFeatureStore, rounds: int) -> int:
    """Drain until every replica's cursor is at the head and nothing is
    evicted; the drains it took."""
    rep = g.replicator
    for n in range(1, rounds + 1):
        g.drain()
        if all(rep.log.pending_count(r) == 0 for r in rep.replica_regions()) and not g.evicted:
            return n
    raise RuntimeError(f"check failed: replicas converged within {rounds} drains")


def geo_single_home(device: str, n_entities: int, events_per_hour: int, jobs: int,
                    n_batches: int, snapshot_at: int, seed: int = 0) -> dict:
    """Hourly jobs at the home, each followed by a drain to both replicas;
    then geo-routed GETs from westeurope."""
    g = geo_txn_store(device, n_entities, events_per_hour)
    rep = g.replicator
    replicas = GEO_REGIONS[1:]
    applied = dict.fromkeys(replicas, 0)
    snapshot = None
    with Spans() as spans:
        for r in replicas:
            spans.wrap("replica_apply_online", rep.stores[r], "merge_reduced")
            spans.wrap("replica_apply_offline", rep.offline_stores[r], "apply_chunks")
        spans.wrap("log_append", rep, "_publish")
        spans.wrap("wire_encode", geo_wire, "encode_run")
        spans.wrap("wire_decode", geo_wire, "decode_frame")
        for h in range(1, jobs + 1):
            t0 = time.perf_counter()
            ran = g.tick(now=h * HOUR)
            t1 = time.perf_counter()
            drained = g.drain()
            spans.add("job", t1 - t0)
            spans.add("drain", time.perf_counter() - t1)
            check(ran["succeeded"] == 1 and ran["failed"] == 0, f"geo job {h} succeeded")
            for r in replicas:
                applied[r] += drained[r]["applied_rows"]
            if h == snapshot_at:
                snapshot = plane_state(g.fs.online, g.fs.offline, "txn_rolling")
    if g.fs.device.type == "cuda":
        torch.cuda.synchronize()
    home = plane_state(g.fs.online, g.fs.offline, "txn_rolling")
    for r in replicas:
        check(g.lag(r).batches == 0, f"{r} drained")
        check_same_state(home, plane_state(rep.stores[r], rep.offline_stores[r], "txn_rolling"),
                         f"replica {r} == home")

    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, int(1.1 * n_entities), GET_BATCH).astype(np.int64)
               for _ in range(n_batches)]
    before = read_counts()
    get_ms, served = [], []
    for ids in batches:
        t0 = time.perf_counter()
        served.append(g.get_online_features("txn_rolling", 1, [ids], consumer_region="westeurope"))
        get_ms.append((time.perf_counter() - t0) * 1e3)
    get_launches = {k: v - before[k] for k, v in read_counts().items()}
    on_card = int(g.fs.device.type == "cuda")
    check(get_launches["online_lookup"] == on_card * n_batches
          and sum(get_launches.values()) == get_launches["online_lookup"],
          "one lookup launch per replica GET, and nothing else")
    for ids, (v, f, route) in zip(batches, served):
        check(route == {"region": "westeurope", "modeled_ms": 1.0},
              "the GET was served by the westeurope replica")
        hv, hf, hroute = g.get_online_features("txn_rolling", 1, [ids], consumer_region="westus2")
        check(hroute["region"] == "westus2" and np.array_equal(f, hf) and np.array_equal(v, hv),
              "replica GET byte-identical to the home's")
    # the replica's keys and one GET's routed queries, for the kernel check
    replica = rep.stores["westeurope"]
    lookup_inputs = (replica.device_state("txn_rolling", 1).keys.clone(),
                     routed_queries(replica, batches[0]))
    ship = {r: dataclasses.asdict(rep.shipped[r]) for r in replicas}
    sp = spans.row()
    apply_s = sum(sp[k]["s"] for k in ("replica_apply_online", "replica_apply_offline"))
    row = {
        "jobs": jobs, "entities": n_entities, "events_per_hour": events_per_hour,
        "job_s": sp["job"]["s"], "drain_s": sp["drain"]["s"], "split": sp,
        "shipped": ship, "wire_frames": sum(s["frames"] for s in ship.values()),
        "modeled_wan_ms": {r: s["ms"] for r, s in ship.items()},
        "replica_apply_rows": applied, "replica_apply_rows_per_s": sum(applied.values()) / apply_s,
        "replica_get_p50_ms": float(np.percentile(get_ms, 50)),
        "replica_get_p99_ms": float(np.percentile(get_ms, 99)),
        "get_batches": n_batches, "get_launches": get_launches,
        "found_frac": float(np.mean([f.mean() for _, f, _ in served])),
        "replicas_equal_home": True,
    }
    return {"row": row, "store": g, "snapshot": snapshot, "lookup_inputs": lookup_inputs}


def geo_daemon(g: GeoFeatureStore, hour: int) -> dict:
    """One replica out of process: a daemon child on the store's device with
    the kernel engine, attached with ``add_remote_replica``; the jobs so far
    stream to it as delta-bootstrap chunks over the socket, one more job's
    log batches are drained to it with the in-process replicas, and
    ``_adopt_remote`` rebuilds its state in-process from its dump stream,
    which must equal the in-process eastus replica."""
    rep, home = g.replicator, g.fs.online
    spec = g.registry.get_feature_set("txn_rolling", 1)
    device = g.fs.device
    t0 = time.perf_counter()
    with spawn_replica_daemon(region="eastus", merge_engine="kernel", device=device,
                              num_partitions=home.num_partitions,
                              initial_capacity=home.initial_capacity,
                              idle_timeout=600.0, startup_timeout=300.0) as handle:
        spawn_s = time.perf_counter() - t0
        hello = handle.control({"cmd": "hello"}, timeout=60.0)
        check(hello is not None and hello["device"].startswith(device.type)
              and hello["engine"] == "kernel", f"the daemon child runs on {device.type}")
        ch = SocketChannel(handle.connect(timeout=60.0), src="westus2", dst="eastus",
                           topology=g.topology)
        rep.add_remote_replica(GEO_DAEMON, ch, offline=True)
        t1 = time.perf_counter()
        boot = rep.bootstrap_delta(GEO_DAEMON, spec)
        boot_s = time.perf_counter() - t1
        ran = g.tick(now=hour * HOUR)
        t2 = time.perf_counter()
        drained = g.drain()
        drain_s = time.perf_counter() - t2
        check(ran["succeeded"] == 1 and rep.lag_batches(GEO_DAEMON) == 0
              and drained[GEO_DAEMON]["applied_batches"] > 0,
              "the job's log batches drained to the daemon")
        ledger = ch.ledger()
        t3 = time.perf_counter()
        rep._adopt_remote(GEO_DAEMON)
        adopt_s = time.perf_counter() - t3
        check_same_state(plane_state(rep.stores["eastus"], rep.offline_stores["eastus"],
                                     "txn_rolling"),
                         plane_state(rep.stores[GEO_DAEMON], rep.offline_stores[GEO_DAEMON],
                                     "txn_rolling"),
                         "the daemon's state == the in-process eastus replica")
        ch.close()
        pid = handle.proc.pid
    check(handle.proc.poll() is not None, "the daemon child exited")
    try:
        os.kill(pid, 0)
        left = True
    except ProcessLookupError:
        left = False
    check(not left, "no daemon child is left")
    return {"device": hello["device"], "spawn_s": spawn_s, "bootstrap_s": boot_s,
            "bootstrap": boot, "drain_s": drain_s, "adopt_s": adopt_s,
            "ledger": ledger, "shipped": dataclasses.asdict(rep.shipped[GEO_DAEMON]),
            "daemon_equal_in_process": True, "child_left": left}


def geo_failover(g: GeoFeatureStore, hour: int, n_entities: int, spine_rows: int,
                 seed: int = 0) -> dict:
    """One more job the replicas have not seen, then the home is lost: the
    nearest in-sync replica is promoted with the un-acked suffix replayed,
    a training read joins on the promoted offline plane, and the ex-home
    rejoins through the delta bootstrap."""
    spec_name = "txn_rolling"
    ran = g.tick(now=hour * HOUR)
    check(ran["succeeded"] == 1 and g.lag("eastus").batches > 0, "an un-drained suffix")
    before = plane_state(g.fs.online, g.fs.offline, spec_name)
    rng = np.random.default_rng(seed)
    spine = Table({"entity_id": rng.integers(0, int(1.1 * n_entities), spine_rows),
                   "ts": rng.integers(0, (hour + 1) * HOUR + 1, spine_rows)})
    join_before = g.get_offline_features(spine, [(spec_name, 1)])
    g.mark_down("westus2")
    t0 = time.perf_counter()
    info = g.failover()
    replay_s = time.perf_counter() - t0
    check(info is not None and info["promoted"] == "eastus" and info["replayed_batches"] > 0,
          "eastus promoted with the suffix replayed")
    check(g.fs.online is g.replicator.stores["eastus"], "writes re-pointed at eastus")
    check_same_state(before, plane_state(g.fs.online, g.fs.offline, spec_name),
                     "the promoted stores == the lost home")
    per_call = int(g.fs.device.type == "cuda")
    pit0 = pit_ops.counter.launches
    t1 = time.perf_counter()
    join_after = g.get_offline_features(spine, [(spec_name, 1)])
    join_s = time.perf_counter() - t1
    check(pit_ops.counter.launches == pit0 + per_call, "the promoted plane's join ran pit_search")
    for c in join_before.columns:
        check(np.array_equal(join_before[c], join_after[c]),
              f"offline join column {c}: promoted == before the failure")
    g.mark_up("westus2")
    t2 = time.perf_counter()
    back = g.rejoin("westus2")
    rejoin_s = time.perf_counter() - t2
    rounds = converge(g, 8)
    home = plane_state(g.fs.online, g.fs.offline, spec_name)
    for r in g.replicator.replica_regions():
        check_same_state(home, plane_state(g.replicator.stores[r],
                                           g.replicator.offline_stores[r], spec_name),
                         f"after rejoin: {r} == the new home")
    return {"promoted": info["promoted"], "replayed_batches": info["replayed_batches"],
            "replayed_rows": info["replayed_rows"], "replay_ms": replay_s * 1e3,
            "replay_rows_per_s": info["replayed_rows"] / replay_s,
            "spine_rows": spine_rows, "join_s": join_s,
            "found_frac": float(join_after[f"{spec_name}:v1:__found__"].mean()),
            "rejoin_s": rejoin_s, "bootstrap_chunks": back["chunks"],
            "bootstrap_rows": {"online": back["online_rows"], "offline": back["offline_rows"]},
            "converge_drains": rounds, "promoted_equal_lost_home": True,
            "join_equal_before": True}


def geo_chaos(device: str, n_entities: int, events_per_hour: int, jobs: int,
              reference: tuple, seed: int = 8) -> dict:
    """The same jobs over a seeded faulty channel: drops, duplicates,
    reorders, corruption, lost acks and latency spikes at the geo
    benchmark's rates; the replicas converge byte-identical to a fault-free
    run of the same jobs."""
    topo = geo_topology()
    channel = FaultyChannel(FaultPlan(seed=seed, **GEO_CHAOS_RATES), topo)
    g = geo_txn_store(device, n_entities, events_per_hour, topology=topo, channel=channel,
                      delivery_policy=DeliveryPolicy(**GEO_CHAOS_POLICY))
    for h in range(1, jobs + 1):
        ran = g.tick(now=h * HOUR)
        check(ran["succeeded"] == 1, f"chaos job {h} succeeded")
        g.drain()
    rounds = converge(g, 300)
    check_same_state(reference, plane_state(g.fs.online, g.fs.offline, "txn_rolling"),
                     "chaos home == the fault-free run's home")
    for r in GEO_REGIONS[1:]:
        check_same_state(reference, plane_state(g.replicator.stores[r],
                                                g.replicator.offline_stores[r], "txn_rolling"),
                         f"chaos replica {r} == the fault-free run")
    states = g.replicator.delivery
    totals = {k: sum(getattr(st, k) for st in states.values())
              for k in ("retries", "timeouts", "corrupt_frames", "redelivered_batches")}
    check(sum(v for k, v in channel.counts.items() if k != "transmits") > 0,
          "the schedule injected faults")
    return {"seed": seed, "rates": GEO_CHAOS_RATES, "jobs": jobs,
            "drain_rounds": jobs + rounds, "converge_drains": rounds, **totals,
            "channel_counts": dict(channel.counts),
            "transitions": {r: [list(t) for t in st.transitions] for r, st in states.items()},
            "equal_fault_free": True}


def mh_spec() -> FeatureSetSpec:
    """``profile``'s schema (32 float32 features) with both planes on."""
    return FeatureSetSpec(
        name="profile", version=1, entity=Entity("user", ("entity_id",)),
        features=tuple(Feature(f"f{i}") for i in range(PROFILE_FEATURES)),
        source_name="profile_src",
        transform=UDFTransform(lambda df, ctx: df, name="identity"),
        materialization=MaterializationSettings(offline_enabled=True, online_enabled=True),
    )


def mh_frames(n_entities: int, frame_rows: int, n_frames: int, seed: int):
    """Frames of inserts (every id once, in random order) until each id is
    written, then frames of random ids with event_ts below, above or equal
    to the inserted one; frame k enters at region k mod 3."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_entities).astype(np.int64)
    ev0 = rng.integers(1_000_000, 2_000_000, n_entities).astype(np.int64)
    for k in range(n_frames):
        if (k + 1) * frame_rows <= n_entities:
            ids = perm[k * frame_rows:(k + 1) * frame_rows]
            ev = ev0[ids]
        else:
            ids = rng.integers(0, n_entities, frame_rows).astype(np.int64)
            ev = ev0[ids] + rng.integers(-50, 50, frame_rows)
        cols = {"entity_id": ids, "ts": ev}
        for i in range(PROFILE_FEATURES):
            cols[f"f{i}"] = rng.standard_normal(frame_rows).astype(np.float32)
        # creation_ts past every event_ts, as the offline plane requires
        yield Table(cols), 3_000_000 + k, GEO_REGIONS[k % len(GEO_REGIONS)]


def check_mesh(mh: MultiHomeGeoStore, what: str) -> None:
    regions = mh.regions()
    first = plane_state(mh.online[regions[0]], mh.offline[regions[0]], "profile")
    for r in regions[1:]:
        check_same_state(first, plane_state(mh.online[r], mh.offline[r], "profile"),
                         f"{what}: {r} == {regions[0]}")


def geo_multihome(device: str, n_entities: int, frame_rows: int, n_frames: int,
                  n_shards: int, n_batches: int, seed: int = 0) -> dict:
    """An active-active mesh over the three regions: writes enter anywhere
    and split by owning shard; the mesh converges, loses westeurope's
    ranges to failover, converges again, and answers GETs from every
    region alike."""
    mh = MultiHomeGeoStore("mh", topology=geo_topology(), regions=list(GEO_REGIONS),
                           num_shards=n_shards, device=device, merge_engine="kernel",
                           online_partitions=PROFILE_PARTITIONS)
    mh.create_feature_set(mh_spec())
    owners = np.asarray(mh.shard_map.owners)
    forwarded = 0
    with Spans() as spans:
        for r in GEO_REGIONS:
            spans.wrap("home_merge_online", mh.online[r], "merge")
            spans.wrap("home_merge_offline", mh.offline[r], "merge_with_stats")
            spans.wrap("replica_apply_online", mh.online[r], "merge_reduced")
            spans.wrap("replica_apply_offline", mh.offline[r], "apply_chunks")
            spans.wrap("log_append", mh.replicators[r], "_publish")
        spans.wrap("wire_encode", geo_wire, "encode_run")
        spans.wrap("wire_decode", geo_wire, "decode_frame")
        t0 = time.perf_counter()
        for frame, cr, region in mh_frames(n_entities, frame_rows, n_frames, seed):
            keys = encode_keys([frame["entity_id"]])
            foreign = int((owners[mh.shard_map.shard_of(keys)] != region).sum())
            info = mh.write_batch("profile", 1, frame, region=region, creation_ts=cr)
            check(info["forwarded_rows"] == foreign
                  and sum(info["slices"].values()) == len(frame),
                  "each write splits by the shard map")
            forwarded += foreign
        write_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        rounds = mh.converge()
        converge_s = time.perf_counter() - t1
    check(mh.pending_batches() == 0, "the mesh converged")
    check_mesh(mh, "converged mesh")
    wl = dict(mh.write_log)
    check(wl["rows"] == n_frames * frame_rows and wl["forwarded_rows"] == forwarded
          and wl["local_rows"] == wl["rows"] - forwarded,
          "the write log's forwarded rows match the shard map")
    lost = mh.shard_map.owned_shards("westeurope")
    mh.mark_down("westeurope")
    t2 = time.perf_counter()
    info = mh.failover()
    failover_s = time.perf_counter() - t2
    check(info is not None and info["shards"] == lost, "westeurope's ranges failed over")
    rounds_after = mh.converge()
    check_mesh(mh, "after failover")
    rng = np.random.default_rng(seed + 1)
    on_card = int(mh.online[mh.regions()[0]].device.type == "cuda")
    get_ms, legs = [], set()
    for _ in range(n_batches):
        ids = rng.integers(0, n_entities, GET_BATCH).astype(np.int64)
        answers = []
        for consumer in GEO_REGIONS:
            before = lookup_ops.counter.launches
            t3 = time.perf_counter()
            v, f, route = mh.get_online_features("profile", 1, [ids], consumer_region=consumer)
            get_ms.append((time.perf_counter() - t3) * 1e3)
            n_legs = len(route["per_range"])
            legs.add(n_legs)
            check(lookup_ops.counter.launches - before == on_card * n_legs,
                  "one lookup launch per key range the GET reads")
            answers.append((v, f))
        check(answers[0][1].all(), "every id is found")
        for v, f in answers[1:]:
            check(np.array_equal(v, answers[0][0]) and np.array_equal(f, answers[0][1]),
                  "multi-home GETs equal from every region")
    return {"entities": n_entities, "features": PROFILE_FEATURES, "shards": n_shards,
            "frames": n_frames, "frame_rows": frame_rows, "write_s": write_s,
            "converge_s": converge_s, "converge_drains": rounds, "split": spans.row(),
            "shipped": {h: {r: dataclasses.asdict(led) for r, led in rep.shipped.items()}
                        for h, rep in mh.replicators.items()},
            "write_log": wl,
            "forwarded_frac": forwarded / wl["rows"], "failover_shards": lost,
            "failover_promoted": info["promoted"], "failover_s": failover_s,
            "converge_drains_after_failover": rounds_after,
            "get_p50_ms": float(np.percentile(get_ms, 50)),
            "get_p99_ms": float(np.percentile(get_ms, 99)),
            "gets": len(get_ms), "lookup_launches_per_get": sorted(legs),
            "regions_equal": True}


def phase_geo(device: str, n_entities: int, events_per_hour: int, jobs: int, chaos_jobs: int,
              n_batches: int, spine_rows: int, mh_entities: int, mh_frame_rows: int,
              mh_frames_n: int, mh_shards: int) -> dict:
    """Geo-replication of both planes on the port: single home with two
    replicas, a daemon replica, failover and rejoin, chaos, multi-home.
    Each step prints its own line as it ends; the phase's line sums up."""
    t0 = time.perf_counter()
    reset_counts()
    seconds = {}

    def step(name: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        emit({"phase": f"geo.{name}", **(out["row"] if "row" in out else out),
              "seconds": seconds[name]})
        return out

    single = step("single_home", geo_single_home, device, n_entities, events_per_hour, jobs,
                  n_batches, chaos_jobs)
    g = single.pop("store")
    step("daemon", geo_daemon, g, jobs + 1)
    step("failover", geo_failover, g, jobs + 2, n_entities, spine_rows)
    del g
    step("chaos", geo_chaos, device, n_entities, events_per_hour, chaos_jobs,
         single.pop("snapshot"))
    step("multihome", geo_multihome, device, mh_entities, mh_frame_rows, mh_frames_n,
         mh_shards, n_batches)
    launches = read_counts()
    row = {"phase": "geo", "device": device, "regions": list(GEO_REGIONS),
           "step_seconds": seconds, "launches": launches,
           "seconds": time.perf_counter() - t0}
    emit(row)
    return {"row": row, "lookup_inputs": single["lookup_inputs"]}


# -- phases 6-7: the LM serving path ------------------------------------------------
def run_examples(runs, timeout: float) -> dict:
    """Each (script, args, ...) of ``runs`` started at once, in an
    interpreter of its own (``EXAMPLE_RUNNER``, a session of its own) on the
    card, from the root of the checkout; waits for all.  Per script: exit
    code, seconds, its output's lines and its readings.  Past ``timeout``
    every session still running is killed and the phase fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT / "src"), env.get("PYTHONPATH"))
                                        if p)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as d:
        procs = {}
        for i, (script, args, *_) in enumerate(runs):
            logs = Path(d) / f"{i}.out", Path(d) / f"{i}.err"
            with open(logs[0], "w") as o, open(logs[1], "w") as e:
                procs[script] = (subprocess.Popen(
                    [sys.executable, "-c", EXAMPLE_RUNNER, script, *args], cwd=ROOT, env=env,
                    stdout=o, stderr=e, start_new_session=True), time.perf_counter(), logs)
        deadline = time.perf_counter() + timeout
        ended = {}
        try:
            while len(ended) < len(procs) and time.perf_counter() < deadline:
                for script, (proc, t0, _) in procs.items():
                    if script not in ended and proc.poll() is not None:
                        ended[script] = time.perf_counter() - t0
                time.sleep(0.1)
        finally:
            # every session ends with the phase: one still running, and any
            # replica daemon a failed example left behind
            for proc, _, _ in procs.values():
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:  # the session had ended whole
                    pass
                proc.wait()
        for script, (proc, _, logs) in procs.items():
            lines = logs[0].read_text().splitlines()
            readings = [json.loads(ln.removeprefix("example readings: ")) for ln in lines
                        if ln.startswith("example readings: ")]
            out[script] = {"rc": proc.returncode, "seconds": ended.get(script),
                           "lines": lines, "readings": readings[-1] if readings else None,
                           "stderr_tail": logs[1].read_text().splitlines()[-8:]}
    check(len(ended) == len(procs), f"every example ended within {timeout} s")
    return out


def check_example(script: str, args: list, kernels: tuple, expect: tuple, res: dict) -> dict:
    """An example's exit code 0 (its own assertions held), each line of
    ``expect`` in its output, each kernel of ``kernels`` launched in its
    process; its row."""
    check(res["rc"] == 0 and res["readings"] is not None,
          f"{script} exits 0 (rc {res['rc']}): {' | '.join(res['stderr_tail'])}")
    text = "\n".join(res["lines"])
    for line in expect:
        check(line in text, f"{script} prints {line!r}")
    launches = res["readings"]["launches"]
    for k in kernels:
        check(launches[k] > 0, f"{script} launched {k}")
    return {"example": script, "args": args, "seconds": res["seconds"], "launches": launches,
            "peak_gb": res["readings"]["peak_gb"], "last_line": res["lines"][-2]}


def phase_examples() -> dict:
    """The examples and the transport smoke on the card (``EXAMPLE_RUNS`` side
    by side, then ``TRAIN_EXAMPLE`` alone); train_lm's readings from its
    driver's log: step seconds (its last 49 steps), tokens/s, MFU
    (6·N·tokens / step / 989e12, N from ``param_counts``), peak GB, and its
    losses, which the example asserts fall."""
    t0 = time.perf_counter()
    done = run_examples(EXAMPLE_RUNS, EXAMPLE_TIMEOUT)
    side_by_side_s = time.perf_counter() - t0
    rows = [check_example(*run, done[run[0]]) for run in EXAMPLE_RUNS]
    script, args = TRAIN_EXAMPLE[:2]
    trained = run_examples([TRAIN_EXAMPLE], EXAMPLE_TIMEOUT)[script]
    rows.append(check_example(*TRAIN_EXAMPLE, trained))
    log = [TRAIN_LOG.fullmatch(ln) for ln in trained["lines"]]
    log = [(int(m[1]), float(m[2]), float(m[3])) for m in log if m]
    steps = int(args[args.index("--steps") + 1])
    check([s for s, _, _ in log] == list(range(steps)), "train_lm logged every step")
    cfg = get_config(args[args.index("--arch") + 1])
    step_s = (log[-1][2] - log[0][2]) / (steps - 1)
    tokens = int(args[args.index("--batch") + 1]) * int(args[args.index("--seq") + 1])
    n_params = cfg.param_counts()["total"]
    peak = trained["readings"]["peak_gb"]
    check(peak * 1e9 < torch.cuda.get_device_properties(0).total_memory,
          "train_lm's peak memory under the card's")
    rows[-1].update(
        arch=cfg.name, params=n_params, embedding_params=cfg.vocab_size * cfg.d_model,
        first_step_s=log[0][2], step_s=step_s, train_tokens_per_s=tokens / step_s,
        mfu=6 * n_params * tokens / step_s / BF16_OPS_PER_S,
        first_loss=log[0][1], last_loss=log[-1][1], min_loss=min(lo for _, lo, _ in log),
        loss_fell=log[-1][1] < log[0][1])
    row = {"phase": "examples", "side_by_side_s": side_by_side_s,
           "seconds": time.perf_counter() - t0, "rows": rows}
    emit(row)
    return row


def latest_chunks(fs: FeatureStore, spec, ids: np.ndarray) -> np.ndarray:
    """The offline store's latest record (greatest (event_ts, creation_ts))
    of each id, as the feature row the online store must serve."""
    hist = fs.offline.read(spec.name, spec.version)
    cols = [f.name for f in spec.features]
    rows = []
    for i in ids:
        mine = np.flatnonzero(hist["doc_id"] == i)
        rows.append(mine[np.lexsort((hist[CREATION_TS][mine], hist["event_ts"][mine]))[-1]])
    return np.stack([hist[c][rows] for c in cols], axis=1).astype(np.float32)


def logits_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Distance of bfloat16 logits ``got`` from ``want``: max abs, relative
    RMS (||got - want|| / ||want||), and the share of positions whose top-1
    token agrees."""
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
          "logits are finite")
    g, w = got.float(), want.float()
    return {"max_abs_err": float((g - w).abs().max()), "max_abs": float(w.abs().max()),
            "rel_rms_err": float((g - w).norm() / w.norm()),
            "top1_agree": float((g.argmax(-1) == w.argmax(-1)).float().mean())}


def recurrent_state_bytes(cfg, batch: int) -> int:
    """The bytes of every Mamba layer's decode state (the float32 SSM state
    and the conv ring) for ``batch`` requests; 0 without SSM layers."""
    if not cfg.ssm:
        return 0
    cache = lm_mod.init_cache(cfg, batch, 1, device=torch.device("meta"))
    layers = [*cache.get("prefix", []), *(lc for g in cache.get("groups", []) for lc in g),
              *cache.get("tail", [])]
    return sum(t.numel() * t.element_size() for lc in layers for k, t in lc.items()
               if k in ("conv", "ssm"))


def encdec_cache_bytes(cfg, batch: int, max_len: int) -> int:
    """The bytes of an encoder/decoder's decode cache for ``batch``
    requests: every layer's cross K/V over the encoder's frames and its self
    K/V of ``max_len`` positions; 0 for a decoder-only config."""
    if not cfg.encoder_decoder:
        return 0
    cache = encdec_mod.init_cache(cfg, batch, max_len, device=torch.device("meta"))
    return sum(t.numel() * t.element_size() for k, t in cache.items() if k != "t")


def phase_lm_serve(cfg, device: str, phase: str = "lm_serve") -> dict:
    """The ported request path at full width: the context GET through the
    online store, stepped prefill of the 32-token contexts, greedy decode;
    an encoder/decoder encodes zero frames and attaches the cross K/V
    first (its learned positions sized to AUDIO_CONTEXT, so the same model
    runs ``lm_audio_prefill``).  A decode step's bound is one read of every
    weight (the MoE decode reads every expert's, as the JAX formulation
    does), plus, for the SSM and hybrid families, one read and one write of
    every Mamba layer's state, and for the encoder/decoder one read of its
    cross and self K/V."""
    t0 = time.perf_counter()
    plane = build_serving_plane(cfg, seed=0, device=device)
    plane_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, max_decode_len=AUDIO_CONTEXT, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    state_gb = recurrent_state_bytes(cfg, LM_REQUESTS) / 1e9
    kv_gb = encdec_cache_bytes(cfg, LM_REQUESTS, plane[2].chunk_len + LM_NEW_TOKENS) / 1e9
    reset_counts()
    out = serve(cfg, requests=LM_REQUESTS, new_tokens=LM_NEW_TOKENS, seed=0, device=device,
                params=params, plane=plane, keep_logits=True)
    launches = read_counts()
    check(launches["online_lookup"] == 1, "the context GET launched online_lookup once")
    check(launches["flash_attn"] == 0, "decode takes the einsum path, not the flash kernel")
    fs, spec, src = plane
    hit = out["found"]
    check(hit.sum() > 0, "the GET found warm sessions")
    check(np.array_equal(out["contexts"][hit], latest_chunks(fs, spec, out["doc_ids"][hit])),
          "every served context is the offline store's latest chunk for its id")
    cfs, cspec, _ = build_serving_plane(cfg, seed=0, device="cpu")
    ctx, found = cfs.get_online_features(cspec.name, cspec.version, [out["doc_ids"]])
    prompts = np.where(found[:, None], np.clip(ctx.astype(np.int64), 0, cfg.vocab_size - 1), 1)
    check(np.array_equal(found, hit) and np.array_equal(prompts, out["prompts"]),
          "the prompts are byte-identical to a CPU run of the serving plane")
    gen = out["generated"]
    check(gen.shape == (LM_REQUESTS, LM_NEW_TOKENS) and (gen >= 0).all()
          and (gen < cfg.vocab_size).all(), "generated tokens of the expected shape and range")
    check(bool(torch.isfinite(out["prompt_logits"]).all()), "prefill logits are finite")
    decode_ms = out["decode_ms_total"] - out["prefill_ms"]
    row = {
        "phase": phase, "arch": cfg.name, "device": str(params.device),
        "layers": cfg.num_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads, "vocab": cfg.vocab_size, "weight_gb": weight_gb,
        "init_s": init_s, "plane_s": plane_s, "requests": LM_REQUESTS,
        "prompt_len": int(out["prompts"].shape[1]), "context_hits": out["context_hits"],
        "new_tokens": LM_NEW_TOKENS, "online_lookup_ms": out["online_lookup_ms"],
        "stepped_prefill_ms": out["prefill_ms"],
        "decode_ms_per_step": decode_ms / LM_NEW_TOKENS, "state_gb": state_gb,
        "decode_bound_ms": (weight_gb + 2 * state_gb + kv_gb) * 1e9 / HBM_BYTES_PER_S * 1e3,
        "decode_tokens_per_s": LM_REQUESTS * LM_NEW_TOKENS / decode_ms * 1e3,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    }
    if cfg.encoder_decoder:
        row.update(encoder_layers=cfg.encoder_layers, frames=cfg.encoder_seq,
                   encode_ms=out["encode_ms"], kv_gb=kv_gb)
    emit(row)
    return {"row": row, "params": params, "plane": plane, "out": out}


def prefill_batch(plane, seq: int, batch: int) -> tuple[dict, FeatureStoreLoader]:
    """A (batch, seq) token batch from a loader over the serving plane,
    advanced hour by hour until every document holds ``seq`` tokens of
    history, so no sampled row is left-padded."""
    fs, spec, src = plane
    loader = FeatureStoreLoader(store=fs, spec=spec, seq_len=seq, batch_size=batch,
                                chunk_len=src.chunk_len, seed=0)
    need = -(-seq // src.chunk_len)
    hours = 3
    while True:
        loader.advance(hours * HOUR)
        counts = np.bincount(fs.offline.read(spec.name, spec.version)["doc_id"],
                             minlength=src.num_docs)
        if counts.min() >= need:
            break
        hours += 4
    return loader.sample_batch(0), loader


def float32_twin(params, cfg):
    """A float32 copy of ``params`` (the same weights, each cast) and its
    float32 config."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    twin = lm_mod.LM(cfg32, None, device=params.device)
    with torch.no_grad():
        for (name, p32), (same, p) in zip(twin.named_parameters(), params.named_parameters(),
                                          strict=True):
            check(name == same, "the float32 twin holds the served model's parameters")
            p32.copy_(p)
    return twin, cfg32


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Float32 ``x`` rounded to ``bits`` explicit mantissa bits, half away
    from zero, on its bit pattern."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


def float32_references(params, cfg, token_sets: list, control) -> dict:
    """The reference of a config with SSM layers: the stepped prefill
    (``lm.prefill``) of each of ``token_sets`` on a float32 twin of the
    served weights.  Then the control: ``control(params)`` (a forward on the
    served model) with every weight rounded to ``SSM_CONTROL_BITS``
    explicit mantissa bits, after which the served weights are put back
    from the twin, bit for bit."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    twin, cfg32 = float32_twin(params, cfg)
    t0 = time.perf_counter()
    refs = [lm_mod.prefill(twin, torch.as_tensor(t, device=params.device), cfg32,
                           max_len=t.shape[1])[0] for t in token_sets]
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    with torch.no_grad():
        for p in params.parameters():
            p.copy_(round_mantissa(p.float(), SSM_CONTROL_BITS))
        control_logits = control(params)
        for p, p32 in zip(params.parameters(), twin.parameters(), strict=True):
            p.copy_(p32)
    del twin
    torch.cuda.empty_cache()
    return {"logits": refs, "control": control_logits, "seconds": ref_s}


def attention_calls(cfg) -> int:
    """Flash calls a full-sequence forward makes: one a layer, or for a
    hybrid config one a group (the shared block); none for pure SSM, nor
    with a sliding window (the flash gate sends a windowed config, its
    global layers too, down the einsum path, as the JAX package does)."""
    if cfg.sliding_window:
        return 0
    if cfg.ssm:
        return lm_mod._layer_plan(cfg)["groups"]
    return cfg.num_layers


def phase_lm_prefill(cfg, served: dict, kernel_ms: float, phase: str = "lm_prefill") -> dict:
    """``make_prefill_step`` with ``attn_impl="pallas_flash"`` on the served
    model.  (i) On the served prompts, against a reference: for attention
    only, the stepped prefill's logits; with SSM layers, the float32 stepped
    prefill of a float32 twin (``float32_references``), against which the
    served stepped prefill and the first ``SSM_PREFIX`` logits of (ii)'s row
    0 are held too, and a lower-precision control must fall outside the
    bounds.  (ii) On a 4 x 2,048 loader batch against ``attn_impl="xla"``,
    or, with no attention in the model (mamba2), against the same forward
    at half the SSD chunk (twice the chunks through the inter-chunk scan).
    A vision-prefix config's (ii) puts ``num_patches`` seeded patch
    embeddings before the 2,048 tokens, and its tokens/s counts every
    position.  Each attention call launches flash on the route
    ``flash_ops.route`` names (``kernel_ms`` is that kernel's time at this
    shape); a windowed config launches none, and its reference is the same
    einsum path.  Returns the row and the 4 x 2,048 tokens."""
    params, out = served["params"], served["out"]
    flash = make_prefill_step(dataclasses.replace(cfg, attn_impl="pallas_flash"))
    calls = attention_calls(cfg)
    if calls or not cfg.ssm:
        ref_label = "xla"
        xla = make_prefill_step(dataclasses.replace(cfg, attn_impl="xla"))
    else:
        ref_label = f"ssm_chunk {cfg.ssm_chunk // 2}"
        xla = make_prefill_step(dataclasses.replace(cfg, ssm_chunk=cfg.ssm_chunk // 2))
    t0 = time.perf_counter()
    batch, loader = prefill_batch(served["plane"], PREFILL_SEQ, PREFILL_BATCH)
    batch_s = time.perf_counter() - t0
    tokens = torch.as_tensor(batch["tokens"], device=params.device)
    check(tokens.shape == (PREFILL_BATCH, PREFILL_SEQ), "the loader batch is 4 x 2,048")
    check(bool((batch["__max_event_ts__"] <= batch["__observation_ts__"]).all()),
          "no token from after the loader's clock")
    long_batch, n_prefix = {"tokens": tokens}, 0
    if cfg.vision_prefix:
        long_batch["patch_embeds"] = api.make_dummy_batch(
            cfg, PREFILL_BATCH, 1, seed=0, device=params.device)["patch_embeds"]
        n_prefix = cfg.num_patches
    seq = PREFILL_SEQ + n_prefix

    if cfg.ssm:
        refs = float32_references(params, cfg, [out["prompts"], tokens[:1, :SSM_PREFIX]],
                                  lambda model: flash(model, {"tokens": out["prompts"]}))
        served_ref, prefix_ref = refs["logits"]
        reference = "float32 stepped prefill"
    else:
        refs, served_ref, reference = None, out["prompt_logits"], "stepped prefill"
    bounds = SERVED_BOUNDS.get(cfg.family, (LOGITS_REL_RMS, LOGITS_TOP1))
    reset_counts()
    short = flash(params, {"tokens": out["prompts"]})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    long = flash(params, long_batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reps, t0 = 2, time.perf_counter()
    for _ in range(reps):
        flash(params, long_batch)
    torch.cuda.synchronize()
    forward_s = (time.perf_counter() - t0) / reps
    launches = read_counts()
    forwards = 2 + reps
    route = flash_ops.route(torch_dtype(cfg.compute_dtype), cfg.head_dim)
    check(launches["flash_attn"] == calls * forwards
          and launches["flash_attn_wgmma"] == (calls * forwards if route == "wgmma" else 0),
          f"{calls} flash launches per forward, all on the {route} route ({forwards} forwards)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = xla(params, long_batch)
    torch.cuda.synchronize()
    xla_s = time.perf_counter() - t0
    check(read_counts()["flash_attn"] == launches["flash_attn"],
          f"the {ref_label} path launches no flash")
    check(short.shape == out["prompt_logits"].shape and long.shape == ref.shape
          == (PREFILL_BATCH, seq, cfg.vocab_size), "logits of the expected shapes")
    vs_reference = {"forward": logits_agreement(short, served_ref)}
    if refs:
        vs_reference["stepped_prefill"] = logits_agreement(out["prompt_logits"], served_ref)
        vs_reference[f"forward_4x{PREFILL_SEQ}_row0_prefix"] = logits_agreement(
            long[:1, :SSM_PREFIX], prefix_ref)
        control = logits_agreement(refs["control"], served_ref)
    vs_xla = logits_agreement(long, ref)

    def within(a: dict, rel_rms: float, top1: float) -> bool:
        return a["rel_rms_err"] <= rel_rms and a["top1_agree"] >= top1

    for what, agreement in vs_reference.items():
        check(within(agreement, *bounds), f"{what} within {bounds[0]} relative RMS and "
              f"{bounds[1]} top-1 agreement of the {reference}")
    if refs:
        check(not within(control, *bounds), f"the control ({SSM_CONTROL_BITS} mantissa bits) "
              f"falls outside {bounds[0]} relative RMS or {bounds[1]} top-1 agreement")
    check(within(vs_xla, LOGITS_REL_RMS, LOGITS_TOP1), f"flash prefill within "
          f"{LOGITS_REL_RMS} relative RMS and {LOGITS_TOP1} top-1 agreement of the {ref_label} path")
    n_tok = PREFILL_BATCH * seq
    row = {
        "phase": phase, "arch": cfg.name, "batch": PREFILL_BATCH, "seq": seq,
        "patches": n_prefix, "text_tokens": PREFILL_SEQ,
        "loader_clock_h": loader.clock / HOUR, "batch_s": batch_s,
        "reference": reference, "bounds": bounds, "vs_reference": vs_reference,
        "vs_xla_reference": ref_label, "vs_xla": vs_xla,
        "first_forward_s": first_s, "forward_s": forward_s, "xla_forward_s": xla_s,
        "prefill_tokens_per_s": n_tok / forward_s,
        "xla_prefill_tokens_per_s": n_tok / xla_s,
        "flash_calls_per_forward": calls, "flash_route": route if calls else None,
        "flash_share_of_forward": calls * kernel_ms / (forward_s * 1e3),
        "xla_peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    }
    if refs:
        row.update(ssd_chunks=PREFILL_SEQ // cfg.ssm_chunk, reference_s=refs["seconds"],
                   control_mantissa_bits=SSM_CONTROL_BITS, control=control,
                   forward_vs_stepped_prefill_bf16=logits_agreement(short, out["prompt_logits"]))
    emit(row)
    return {"row": row, "tokens": tokens}


def phase_window_decode(cfg, served: dict, tokens: torch.Tensor) -> dict:
    """A sliding window on the card: each row of ``tokens``' first
    WINDOW_PROMPT tokens stepped through ``decode_step`` (``lm.prefill``),
    then LM_NEW_TOKENS greedy steps, whose positions cross the window (from
    position ``sliding_window`` on, the local layers' mask drops the oldest
    keys of their full-length caches).  Each step's logits are held against
    the last row of a full-sequence forward over the same tokens, within
    ``lm_prefill``'s bounds.  The window's teeth: over the final tokens the
    forward with the window equals one with every layer global, bit for
    bit, at the positions before ``sliding_window`` and differs after."""
    params = served["params"]
    window = cfg.sliding_window
    n = WINDOW_PROMPT + LM_NEW_TOKENS
    check(WINDOW_PROMPT < window < n, f"the decode crosses the {window}-token window")
    forward = make_prefill_step(cfg)
    all_global = make_prefill_step(dataclasses.replace(cfg, sliding_window=0,
                                                       local_global_period=0))
    seq = tokens[:, :WINDOW_PROMPT]
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = lm_mod.prefill(params, seq, cfg, max_len=n)
        torch.cuda.synchronize()
        prompt_s = time.perf_counter() - t0
        cur = logits[:, -1].argmax(-1, keepdim=True).to(seq.dtype)
        del logits
        stepped, full, decode_s = [], [], 0.0
        for _ in range(LM_NEW_TOKENS):
            seq = torch.cat([seq, cur], dim=1)
            t0 = time.perf_counter()
            logits, cache = lm_mod.decode_step(params, cache, cur, cfg)
            torch.cuda.synchronize()
            decode_s += time.perf_counter() - t0
            stepped.append(logits[:, 0])
            full.append(forward(params, {"tokens": seq})[:, -1])
            cur = logits[:, -1].argmax(-1, keepdim=True).to(seq.dtype)
        check(cache["t"] == n and seq.shape[1] == n, f"{n} positions decoded")
        windowed, unwindowed = (f(params, {"tokens": seq}) for f in (forward, all_global))
    launches = read_counts()
    check(launches["flash_attn"] == 0, "the windowed config takes the einsum path, not flash")
    agreement = logits_agreement(torch.stack(stepped, 1), torch.stack(full, 1))
    check(agreement["rel_rms_err"] <= LOGITS_REL_RMS and agreement["top1_agree"] >= LOGITS_TOP1,
          f"the decode across the window within {LOGITS_REL_RMS} relative RMS and "
          f"{LOGITS_TOP1} top-1 agreement of the full forward")
    same_before = bool(torch.equal(windowed[:, :window], unwindowed[:, :window]))
    diff_after = float((windowed[:, window:].float() - unwindowed[:, window:].float()).abs().max())
    check(same_before and diff_after > 0, "the window masks exactly the positions past it: "
          "equal to all-global attention before, different after")
    past = [i for i in range(LM_NEW_TOKENS) if WINDOW_PROMPT + i >= window]
    row = {
        "phase": "window_decode", "arch": cfg.name, "window": window,
        "local_global_period": cfg.local_global_period, "batch": seq.shape[0],
        "prompt": WINDOW_PROMPT, "new_tokens": LM_NEW_TOKENS,
        "steps_past_window": len(past), "stepped_prompt_s": prompt_s,
        "decode_ms_per_step": decode_s / LM_NEW_TOKENS * 1e3,
        "vs_full_forward": agreement,
        "past_window_vs_full_forward": logits_agreement(
            torch.stack([stepped[i] for i in past], 1), torch.stack([full[i] for i in past], 1)),
        "past_window_vs_all_global": logits_agreement(
            torch.stack([stepped[i] for i in past], 1),
            unwindowed[:, [WINDOW_PROMPT + i for i in past]]),
        "all_global_max_abs_diff_past_window": diff_after, "launches": launches,
    }
    emit(row)
    return row


def phase_lm_audio_prefill(cfg, served: dict) -> dict:
    """``make_prefill_step`` on the served encoder/decoder: (i) the served
    prompts over the same zero frames, against the stepped prefill's logits
    at every prompt position, within the LOGITS bounds; (ii) the published
    decoder context, AUDIO_PREFILL_BATCH x AUDIO_CONTEXT loader tokens, over
    as many seeded frame sequences of ``cfg.encoder_seq`` frames, timed:
    finite logits of the expected shape, no kernel launched (whisper's
    attention is the einsum path, as in the JAX package)."""
    params, out = served["params"], served["out"]
    step = make_prefill_step(cfg)
    t0 = time.perf_counter()
    batch, loader = prefill_batch(served["plane"], AUDIO_CONTEXT, AUDIO_PREFILL_BATCH)
    batch_s = time.perf_counter() - t0
    tokens = torch.as_tensor(batch["tokens"], device=params.device)
    check(tokens.shape == (AUDIO_PREFILL_BATCH, AUDIO_CONTEXT), "the loader batch is 4 x 448")
    frames = api.make_dummy_batch(cfg, AUDIO_PREFILL_BATCH, 1, seed=0,
                                  device=params.device)["frames"]
    zeros = torch.zeros((LM_REQUESTS, cfg.encoder_seq, cfg.d_model), device=params.device)
    reset_counts()
    short = step(params, {"tokens": out["prompts"], "frames": zeros})
    vs_stepped = logits_agreement(short, out["prompt_logits"])
    check(short.shape == out["prompt_logits"].shape, "logits of the stepped prefill's shape")
    check(vs_stepped["rel_rms_err"] <= LOGITS_REL_RMS and vs_stepped["top1_agree"] >= LOGITS_TOP1,
          f"the forward within {LOGITS_REL_RMS} relative RMS and {LOGITS_TOP1} top-1 "
          "agreement of the stepped prefill")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    long = step(params, {"tokens": tokens, "frames": frames})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(long.shape == (AUDIO_PREFILL_BATCH, AUDIO_CONTEXT, cfg.vocab_size)
          and bool(torch.isfinite(long).all()), "finite logits of the expected shape")
    reps, t0 = 3, time.perf_counter()
    for _ in range(reps):
        step(params, {"tokens": tokens, "frames": frames})
    torch.cuda.synchronize()
    forward_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        api.encode_memory(params, frames, cfg)
    torch.cuda.synchronize()
    encode_s = (time.perf_counter() - t0) / reps
    launches = read_counts()
    check(not any(launches.values()), "the encoder/decoder launches none of the kernels")
    n_tok = AUDIO_PREFILL_BATCH * AUDIO_CONTEXT
    row = {
        "phase": "lm_audio_prefill", "arch": cfg.name, "batch": AUDIO_PREFILL_BATCH,
        "seq": AUDIO_CONTEXT, "frames": cfg.encoder_seq, "loader_clock_h": loader.clock / HOUR,
        "batch_s": batch_s, "vs_stepped_prefill": vs_stepped,
        "bounds": (LOGITS_REL_RMS, LOGITS_TOP1), "first_forward_s": first_s,
        "forward_s": forward_s, "encoder_s": encode_s,
        "prefill_tokens_per_s": n_tok / forward_s,
        "frames_per_s": AUDIO_PREFILL_BATCH * cfg.encoder_seq / encode_s,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
    }
    emit(row)
    return {"row": row}


# -- the MLA + MoE family ------------------------------------------------------------
def observe(name: str, fn) -> tuple:
    """``fn()``'s result and each call it made to ``moe.<name>``, as
    (arguments, result) in call order; the function is put back after."""
    real, calls = getattr(moe_mod, name), []

    def observed(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    setattr(moe_mod, name, observed)
    try:
        return fn(), calls
    finally:
        setattr(moe_mod, name, real)


def drop_shares(dispatches: list) -> list:
    """The share of assignments each observed ``_dispatch_indices`` call
    dropped."""
    return [1.0 - float(keep.float().mean()) for _, (_, keep) in dispatches]


def moe_layer_and_tokens(cfg, device: str):
    """``moe_dispatch``'s MoE layer (seeded bf16 weights, float32 router) and
    its PREFILL_BATCH x PREFILL_SEQ tokens: normal draws plus one normal
    offset shared by all of them, which skews the router's load."""
    gen = torch.Generator(device=device).manual_seed(0)
    params = moe_mod.MoE(gen, cfg, dtype=torch.bfloat16)
    b, s, d = PREFILL_BATCH, PREFILL_SEQ, cfg.d_model
    x = torch.randn((b, s, d), generator=gen, device=device)
    return params, (x + torch.randn((d,), generator=gen, device=device)).bfloat16()


def phase_moe_dispatch(cfg, device: str) -> dict:
    """One MoE layer at the config's widths with seeded bf16 weights, on
    PREFILL_BATCH x PREFILL_SEQ tokens in groups of 2,048 at ``MOE_CF``:
    ``moe_apply`` against ``moe_apply_einsum`` (within ``MOE_TOL`` of the
    output's scale); the share of assignments dropped, which must be above 0
    (the capacity binds); ``_dispatch_indices`` on the card's ``idx_k``
    byte-identical to the same call on the CPU; ``moe_apply`` once with
    synchronizing ops made errors; the times of both.  The tokens share a
    mean direction, as hidden states do (``moe_layer_and_tokens``).  The
    bound counts
    the products the kept assignments and the shared experts need on the
    bf16 tensor cores, and one read of the weights and the tokens and one
    write of the output."""
    params, x = moe_layer_and_tokens(cfg, device)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    group = 2048
    apply = lambda: moe_mod.moe_apply(params, x, cfg, group_size=group,  # noqa: E731
                                      capacity_factor=MOE_CF)
    y, aux = apply()
    y_ref, aux_ref = moe_mod.moe_apply_einsum(params, x, cfg, group_size=group,
                                              capacity_factor=MOE_CF)
    err = float((y.float() - y_ref.float()).abs().max())
    scale = float(y_ref.float().abs().max())
    check(y.shape == x.shape and bool(torch.isfinite(y).all()), "moe_apply's output is finite")
    check(err <= MOE_TOL * scale, f"moe_apply within {MOE_TOL} of the oracle's scale")
    check(abs(float(aux) - float(aux_ref)) <= 1e-6 * abs(float(aux_ref)), "the aux losses agree")

    xg = moe_mod._group(x, group)
    cap = moe_mod._capacity(cfg, xg.shape[1], MOE_CF)
    _, idx_k, _ = moe_mod._route(params, xg, cfg)
    dst, keep = moe_mod._dispatch_indices(idx_k, e, cap)
    cdst, ckeep = moe_mod._dispatch_indices(idx_k.cpu(), e, cap)
    identical = (dst.cpu().numpy().tobytes() == cdst.numpy().tobytes()
                 and keep.cpu().numpy().tobytes() == ckeep.numpy().tobytes())
    check(identical, "the card's dispatch is byte-identical to the CPU's")
    kept = int(ckeep.sum())
    dropped = 1.0 - kept / ckeep.numel()
    check(cap == 240 and dropped > 0, "the capacity (240) binds: some assignments drop")
    check_sync_free("moe_apply", apply, f"{MOE_ARCH} MoE layer, {b} x {s} tokens, cf {MOE_CF}")

    f, fs = cfg.moe_d_ff, cfg.moe_d_ff * cfg.num_shared_experts
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    b_ms, b_by = bound(weight_bytes + 2 * x.numel() * x.element_size(),
                       6 * d * (f * kept + fs * b * s), BF16_OPS_PER_S)
    row = {
        "phase": "moe_dispatch", "arch": cfg.name, "d_model": d, "experts": e, "top_k": k,
        "moe_d_ff": f, "shared_experts": cfg.num_shared_experts, "tokens": b * s,
        "groups": xg.shape[0], "group_size": xg.shape[1], "capacity_factor": MOE_CF,
        "capacity": cap, "dropped_share": dropped, "max_abs_err": err, "max_abs": scale,
        "tol": MOE_TOL * scale, "aux": float(aux), "dispatch_identical_to_cpu": identical,
        "sync_free": True,
        "ms": cuda_ms(apply, 10), "bound_ms": b_ms, "bound_by": b_by,
        "oracle_ms": cuda_ms(lambda: moe_mod.moe_apply_einsum(
            params, x, cfg, group_size=group, capacity_factor=MOE_CF), 3),
    }
    emit(row)
    return row


def phase_lm_moe_prefill(cfg, served: dict) -> dict:
    """``make_prefill_step`` on the served MLA + MoE model: (i) no-drop
    (capacity factor E/k) on the served prompts against the stepped
    prefill's logits (expanded MLA against absorbed, no-drop dispatch
    against no-drop); (ii) at the config's capacity factor on a 4 x 2,048
    loader batch, timed, with the share of assignments each MoE layer drops
    (from one more forward)."""
    params, out = served["params"], served["out"]
    no_drop = make_prefill_step(dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.top_k))
    step = make_prefill_step(cfg)
    t0 = time.perf_counter()
    batch, loader = prefill_batch(served["plane"], PREFILL_SEQ, PREFILL_BATCH)
    batch_s = time.perf_counter() - t0
    tokens = torch.as_tensor(batch["tokens"], device=params.device)
    check(tokens.shape == (PREFILL_BATCH, PREFILL_SEQ), "the loader batch is 4 x 2,048")
    check(bool((batch["__max_event_ts__"] <= batch["__observation_ts__"]).all()),
          "no token from after the loader's clock")

    reset_counts()
    short = no_drop(params, {"tokens": out["prompts"]})
    vs_stepped = logits_agreement(short, out["prompt_logits"])
    check(short.shape == out["prompt_logits"].shape, "logits of the stepped prefill's shape")
    check(vs_stepped["rel_rms_err"] <= LOGITS_REL_RMS and vs_stepped["top1_agree"] >= LOGITS_TOP1,
          f"no-drop prefill within {LOGITS_REL_RMS} relative RMS and {LOGITS_TOP1} top-1 "
          "agreement of the stepped prefill")
    del short
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    long = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(long.shape == (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab_size)
          and bool(torch.isfinite(long).all()), "finite logits of the expected shape")
    del long
    reps, t0 = 2, time.perf_counter()
    for _ in range(reps):
        step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    forward_s = (time.perf_counter() - t0) / reps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = read_counts()
    check(launches["flash_attn"] == 0, "MLA takes the einsum path, not the flash kernel")
    drops = drop_shares(observe("_dispatch_indices", lambda: step(params, {"tokens": tokens}))[1])
    check(len(drops) == cfg.num_layers - cfg.first_dense_layers, "one dispatch per MoE layer")
    n_tok = PREFILL_BATCH * PREFILL_SEQ
    row = {
        "phase": "lm_moe_prefill", "arch": cfg.name, "batch": PREFILL_BATCH,
        "seq": PREFILL_SEQ, "capacity_factor": cfg.capacity_factor,
        "loader_clock_h": loader.clock / HOUR, "batch_s": batch_s,
        "no_drop_vs_stepped_prefill": vs_stepped, "first_forward_s": first_s,
        "forward_s": forward_s, "prefill_tokens_per_s": n_tok / forward_s,
        "peak_gb": peak_gb, "dropped_share_per_moe_layer": drops,
        "dropped_share_mean": float(np.mean(drops)), "launches": launches,
    }
    emit(row)
    return {"row": row}


# -- phase 8: the LM train path -------------------------------------------------------
def fill_history(loader: FeatureStoreLoader, hours: int) -> None:
    """Advance ``loader`` hour by hour from ``hours`` until every document in
    the offline history holds ``seq_len`` tokens, so no sampled row is
    left-padded."""
    need = -(-loader.seq_len // loader.chunk_len)
    while True:
        loader.advance(hours * HOUR)
        docs = loader.store.offline.read(loader.spec.name, loader.spec.version)["doc_id"]
        if np.unique(docs, return_counts=True)[1].min() >= need:
            return
        hours += 1


def check_flash_backward(b: int, s: int, h: int, kv: int, d: int, rng, label: str,
                         dtype=torch.bfloat16, device: str = "cuda", reps: int = 10) -> dict:
    """The flash backward kernel at one causal shape on the card, on the
    kernel forward's log-sum-exp: launched twice on the route
    ``flash_ops.route`` names, the two calls' dq, dk, dv bit-equal, and each
    within FLASH_TOL of its largest entry of autograd through the plain
    forward.  Its time beside the plain backward's (``attention_bwd_ref``,
    the whole S x T square in float32), ``scaled_dot_product_attention``'s
    backward alone (the library call) and forward + backward.  The bound is
    a flash backward's least work: five products (QKᵀ again, dV, dP, dQ, dK)
    of 2·D operations per (query head, visible key) pair at the rate of the
    input type; bytes: q, k, v, dO and the log-sum-exp read and dq, dk, dv
    written once.  The row names the products the route's schedule does
    (``BWD_PRODUCTS``) beside the bound's."""
    up = lambda shape: torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device).to(dtype)
    q, k, v, do = up((b, s, h, d)), up((b, s, kv, d)), up((b, s, kv, d)), up((b, s, h, d))
    route = flash_ops.route(dtype, d)
    before = flash_ops.bwd_counter.launches, flash_ops.bwd_tc_counter.launches
    _, lse = flash_ops._forward(q, k, v, True, True)
    got = flash_ops._backward(q, k, v, lse, do, True)
    again = flash_ops._backward(q, k, v, lse, do, True)
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref_leaves), ref_leaves, do.float())
    torch.cuda.synchronize()
    check(flash_ops.bwd_counter.launches == before[0] + 2
          and flash_ops.bwd_tc_counter.launches == before[1] + 2 * (route == "wgmma"),
          f"the flash backward kernel launched on the {route} route ({label})")
    check(all(torch.equal(g, g2) for g, g2 in zip(got, again)),
          f"two flash backward calls give the same bits ({label})")
    errs, tol = {}, FLASH_TOL[dtype]
    for name, g, w in zip("qkv", got, want):
        errs[f"d{name}_max_abs_err"] = float((g.float() - w.float()).abs().max())
        errs[f"d{name}_max_abs"] = float(w.float().abs().max())
        check(errs[f"d{name}_max_abs_err"] <= tol * errs[f"d{name}_max_abs"],
              f"flash backward d{name} within {tol} of plain ({label})")
    del got, again, want, ref_leaves
    sdpa_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    sdpa_out = sdpa(*sdpa_leaves)
    pairs = s * (s + 1) // 2
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    b_ms, b_by = bound(q.element_size() * (3 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
                       BWD_BOUND_PRODUCTS * 2 * d * b * h * pairs, rate)
    row = {
        "phase": "flash_backward", "shape": label, "route": route, "B": b, "S": s, "H": h,
        "KV": kv, "D": d, "dtype": str(dtype).removeprefix("torch."), **errs,
        "products": BWD_PRODUCTS[route], "bound_products": BWD_BOUND_PRODUCTS,
        "max_abs_err": max(errs[f"d{n}_max_abs_err"] for n in "qkv"),
        "ms": cuda_ms(lambda: flash_ops._backward(q, k, v, lse, do, True), reps),
        "plain_ms": cuda_ms(lambda: attention_bwd_ref(q, k, v, do), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "forward_ms": cuda_ms(lambda: flash_ops._forward(q, k, v, True, True), reps),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(sdpa_out, sdpa_leaves, do,
                                                          retain_graph=True), reps),
        "library_fwd_bwd_ms": cuda_ms(
            lambda: torch.autograd.grad(sdpa(*sdpa_leaves), sdpa_leaves, do), reps),
    }
    emit(row)
    return row


def leaf_agreement(got: dict, want: dict) -> dict:
    """Per gradient leaf, ||got - want|| / ||want||: the largest, and its leaf."""
    rel = {n: float((got[n].float() - want[n].float()).norm() / want[n].float().norm())
           for n in want}
    worst = max(rel, key=rel.get)
    return {"max_rel_rms": rel[worst], "worst_leaf": worst,
            "median_rel_rms": float(np.median(list(rel.values())))}


def kill_and_resume(root: Path, device: str = "cuda", args=TRAIN_KILL_ARGS) -> dict:
    """``train.main`` on the card with ``args`` (by default the JAX driver
    test's): an uninterrupted run, a run killed at step 9 (exit 17) and its
    resume from step 8's checkpoint, whose losses must equal the
    uninterrupted ones bit for bit."""
    if root.exists():
        shutil.rmtree(root)
    try:
        ref = lm_train.main(args + ["--ckpt-dir", str(root / "uninterrupted")], device=device)
        code = None
        try:
            lm_train.main(args + ["--ckpt-dir", str(root / "killed"), "--kill-at", "9"],
                          device=device)
        except SystemExit as e:
            code = e.code
        check(code == 17, "the killed run exits 17 at step 9")
        resumed = lm_train.main(args + ["--ckpt-dir", str(root / "killed")], device=device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(resumed["start_step"] == 9 and ref["steps_run"] == 12, "the resume starts at step 9")
    check(resumed["losses"] == ref["losses"][9:],
          "losses 9-11 of the resumed run are bit-identical to the uninterrupted run's")
    return {"losses": ref["losses"], "resumed_losses": resumed["losses"]}


def phase_lm_train(cfg, rng, device: str = "cuda") -> dict:
    """The train path at full width on the card with the flash kernel, then
    the flash/xla gradient check, the flash backward alone, and the
    driver's kill and resume."""
    cfg = dataclasses.replace(cfg, attn_impl="pallas_flash")
    run = train_steps(cfg, device)
    state, batch, launches = run.pop("state"), run.pop("batch"), run["launches"]
    n_params = sum(p.numel() for p in state.params.parameters())
    want = 2 * cfg.num_layers * TRAIN_STEPS
    check(launches["flash_attn"] == launches["flash_attn_wgmma"] == want,
          f"{2 * cfg.num_layers} flash launches a step (forward and recompute), all on the "
          f"tensor cores ({TRAIN_STEPS} steps)")
    check(launches["flash_attn_bwd"] == launches["flash_attn_bwd_wgmma"] == want // 2,
          f"{cfg.num_layers} flash backward launches a step, all on the tensor cores "
          f"({TRAIN_STEPS} steps)")
    adamw_n = check_adamw_launches(launches, state.params, cfg.name)
    check(sum(launches.values()) == 3 * want + adamw_n, "no other kernel of the port launched")

    # one state and batch: flash against xla, then the optimizer alone (it
    # updates the state in place, so it goes last).  The cache is emptied
    # first: the loop leaves its blocks cut to its own sizes, and the 7.8 GiB
    # float32 logits need a fresh one
    torch.cuda.empty_cache()
    flash_m, flash_g = loss_and_grads(state.params, batch, cfg)
    torch.cuda.empty_cache()
    before = read_counts()["flash_attn"]
    xla_m, xla_g = loss_and_grads(state.params, batch, dataclasses.replace(cfg, attn_impl="xla"))
    torch.cuda.synchronize()
    check(read_counts()["flash_attn"] == before, "the xla step launches no flash")
    opt_s = optimizer_seconds(state, run["optimizer"], flash_g)
    lf, lx = float(flash_m["lm_loss"]), float(xla_m["lm_loss"])
    grads = leaf_agreement(flash_g, xla_g)
    check(np.isfinite(lf) and abs(lf - lx) <= TRAIN_LOSS_RTOL * abs(lx),
          f"flash loss within {TRAIN_LOSS_RTOL} of the xla loss")
    check(grads["max_rel_rms"] <= TRAIN_GRAD_REL_RMS,
          f"every flash gradient leaf within {TRAIN_GRAD_REL_RMS} relative RMS of xla's")
    del flash_g, xla_g
    torch.cuda.empty_cache()
    flops = step_flops(state, batch, cfg)
    del state, batch
    torch.cuda.empty_cache()

    bwd = check_flash_backward(TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads,
                               cfg.head_dim, rng, f"lm_train: B={TRAIN_BATCH} S=T={TRAIN_SEQ} "
                               f"H={cfg.num_heads} KV={cfg.num_kv_heads} D={cfg.head_dim} bf16 "
                               f"({cfg.name})", device=device)
    t0 = time.perf_counter()
    resume = kill_and_resume(ROOT / "build" / "lm_train_ckpt", device)
    resume_s = time.perf_counter() - t0

    row = {
        "phase": "lm_train", "arch": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "vocab": cfg.vocab_size, "params": n_params,
        **train_readings(run, n_params, opt_s), "mfu_formula": "6 * params * tokens / step_s / 989e12",
        "step_flops": flops,
        "bound_s": 8 * n_params * TRAIN_BATCH * TRAIN_SEQ / BF16_OPS_PER_S,
        "vs_xla": {"loss": lf, "xla_loss": lx, **grads},
        "flash_backward_ms": bwd["ms"], "flash_backward_plain_ms": bwd["plain_ms"],
        "sdpa_bwd_ms": bwd["library_ms"], "sdpa_fwd_bwd_ms": bwd["library_fwd_bwd_ms"],
        "kill_resume": {**resume, "seconds": resume_s},
    }
    emit(row)
    return {"row": row, "backward": bwd}


# -- the SSM and hybrid train path -------------------------------------------------
def jax_decay(cum: torch.Tensor) -> torch.Tensor:
    """The JAX package's intra-chunk decay, ``where(tri, exp(diff), 0)``:
    ``exp`` before the mask, so its gradient is 0 x inf = NaN where diff
    overflows."""
    q = cum.shape[2]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=cum.device))
    return torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)


def check_ssd_gradient(cfg, rng, device: str = "cuda") -> dict:
    """``_ssd_chunked`` at one layer's shape of ``cfg`` (mamba2-2.7b: B=1,
    L=TRAIN_SEQ, 80 heads of 64, state 128, chunk 256) in float32 against the
    recurrence ``ssd_reference``: y and the gradients of x, dt, B and C of
    sum(y·gy) + sum(s·gs) (seeded cotangents) within SSD_GRAD_TOL of each
    one's largest entry.  Two cases, A = -1: dt = softplus(N(-2, 1)), and
    dt = 0.5, where Σ dt·|A| over a chunk reaches 127.5 and the JAX
    package's decay expression (``jax_decay``, swapped in) gives a NaN
    gradient, which is checked too."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    b, l, h, p, g, n = 1, TRAIN_SEQ, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    up = lambda *shape: torch.from_numpy(rng.standard_normal(shape, np.float32)).to(device)  # noqa: E731
    xs, bs, cs, gy, gs = up(b, l, h, p), up(b, l, g, n), up(b, l, g, n), up(b, l, h, p), up(b, h, p, n)
    a = -torch.ones(h, device=device)
    cases = {"dt=softplus(N(-2,1)), A=-1": torch.nn.functional.softplus(up(b, l, h) - 2.0),
             "dt=0.5, A=-1": torch.full((b, l, h), 0.5, device=device)}

    def run(fn, dt):
        leaves = [t.clone().requires_grad_(True) for t in (xs, dt, bs, cs)]
        y, st = fn(leaves[0], leaves[1], a, leaves[2], leaves[3])
        grads = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), leaves)
        return y.detach(), grads

    chunked = lambda *t: ssm_mod._ssd_chunked(*t, cfg)  # noqa: E731
    out = {}
    for label, dt in cases.items():
        t0 = time.perf_counter()
        y, grads = run(chunked, dt)
        y_ref, ref = run(ssm_mod.ssd_reference, dt)
        real = ssm_mod._intra_decay
        ssm_mod._intra_decay = jax_decay
        try:
            _, jax_grads = run(chunked, dt)
        finally:
            ssm_mod._intra_decay = real
        torch.cuda.synchronize()
        row = {"max_cum_diff": float((dt * -a).reshape(b, -1, cfg.ssm_chunk, h)[:, :, 1:]
                                     .sum(2).max()),
               "seconds": time.perf_counter() - t0}
        for name, got, want in (("y", y, y_ref), *zip(("dx", "ddt", "dB", "dC"), grads, ref)):
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            row[name] = {"max_abs_err": err, "max_abs": scale, "rel": err / scale}
            check(bool(torch.isfinite(got).all()), f"SSD {name} finite ({label})")
            check(err <= SSD_GRAD_TOL * scale,
                  f"SSD {name} within {SSD_GRAD_TOL} of the recurrence's ({label})")
        row["jax_expression_grad_finite"] = all(bool(torch.isfinite(t).all()) for t in jax_grads)
        out[label] = row
        del y, grads, y_ref, ref, jax_grads
    check(not out["dt=0.5, A=-1"]["jax_expression_grad_finite"],
          "the JAX package's decay expression gives a NaN gradient at dt*|A| = 0.5")
    torch.cuda.empty_cache()
    return {"shape": f"B={b} L={l} H={h} P={p} G={g} N={n} chunk={cfg.ssm_chunk} float32",
            "tol": SSD_GRAD_TOL, "cases": out}


def sub_model(state: TrainState, cfg):
    """An ``LM`` of ``cfg`` (a cut depth) holding the trained weights of the
    same names: the first layers (or groups and the shared block), the
    embedding, the final norm and the head."""
    model = lm_mod.LM(cfg, None, device=state.params.device)
    full = dict(state.params.named_parameters())
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(full[name])
    return model.requires_grad_(True)


def train_steps(cfg, device: str, batch_size: int | None = None, seq: int | None = None) -> dict:
    """``TRAIN_STEPS`` AdamW steps of ``cfg`` at ``batch_size`` x ``seq``
    tokens (by default TRAIN_BATCH x TRAIN_SEQ) on the driver's data plane and optimizer (``launch/train.py``),
    seeded bf16 weights and float32 moments, with the launch counts zeroed
    just before and read just after: the state, the first batch, the
    optimizer and the readings.  An encoder/decoder's ``frames`` and a
    vision prefix's ``patch_embeds`` come from ``make_dummy_batch(seed=step)``,
    as in the driver."""
    batch_size, seq = batch_size or TRAIN_BATCH, seq or TRAIN_SEQ
    t0 = time.perf_counter()
    fs, loader = lm_train.build_data_plane(cfg, seq_len=seq, batch=batch_size, seed=0,
                                           device=device)
    fill_history(loader, 6)
    batches = []
    for step in range(TRAIN_STEPS):
        b = loader.sample_batch(step)
        check(b["tokens"].shape == (batch_size, seq),
              f"the loader batch is {batch_size} x {seq:,}")
        check(bool((b["__max_event_ts__"] <= b["__observation_ts__"]).all()),
              "no token from after the loader's clock")
        model_batch = {"tokens": torch.as_tensor(b["tokens"], device=device)}
        if cfg.encoder_decoder or cfg.vision_prefix:
            dummy = api.make_dummy_batch(cfg, batch_size, seq, seed=step, device=device)
            model_batch.update((k, dummy[k]) for k in ("frames", "patch_embeds") if k in dummy)
        batches.append(model_batch)
    plane_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, device=device)
    optimizer = lm_train.train_optimizer(TRAIN_LR, TRAIN_STEPS)
    state = TrainState.create(params, optimizer)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    train_step = make_train_step(cfg, optimizer)
    reset_counts()
    losses, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        losses.append(float(metrics["lm_loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    check(all(np.isfinite(losses)), "the training losses are finite")
    check(peak_gb < card_gb, "peak memory under the card's")
    return {"state": state, "batch": batches[0], "optimizer": optimizer, "losses": losses,
            "step_s": step_s, "launches": launches, "peak_gb": peak_gb, "card_gb": card_gb,
            "plane_s": plane_s, "init_s": init_s, "loader_clock_h": loader.clock / HOUR,
            "batch_size": batch_size, "seq": seq}


def step_flops(state: TrainState, batch: dict, cfg) -> int:
    """``FlopCounterMode``'s count of a train step, for the rows the dry-run
    is held to (``DRYRUN_CELLS``): one forward and backward of ``batch``
    (AdamW's update has no op the counter counts), outside the measured
    steps: under the counter's dispatch mode the backward's bits differ (a
    CUDA run's trajectory moved with the counter on its first step), so it
    never wraps a step whose state goes on."""
    with FlopCounterMode(display=False) as counter:
        loss_and_grads(state.params, batch, cfg)
    return counter.get_total_flops()


def train_readings(run: dict, n_params: int, opt_s: float, flops: float | None = None) -> dict:
    """A train row's readings from ``train_steps``' ``run``: the step's
    median over steps 1-7 (the first compiles and warms the allocator),
    tokens/s, the MFU of ``flops`` a step (by default 6·N·tokens), the
    optimizer's seconds and share, the peak memory and the launches."""
    tokens = run["batch_size"] * run["seq"]
    flops = 6 * n_params * tokens if flops is None else flops
    steady = float(np.median(run["step_s"][1:]))
    return {"batch": run["batch_size"], "seq": run["seq"], "steps": TRAIN_STEPS,
            "loader_clock_h": run["loader_clock_h"], "plane_s": run["plane_s"],
            "init_s": run["init_s"], "losses": run["losses"], "first_step_s": run["step_s"][0],
            "step_s": steady, "step_s_all": run["step_s"], "train_tokens_per_s": tokens / steady,
            "mfu": flops / steady / BF16_OPS_PER_S,
            "optimizer_s": opt_s, "optimizer_share": opt_s / steady,
            "peak_gb": run["peak_gb"], "card_gb": run["card_gb"], "launches": run["launches"]}


def optimizer_seconds(state: TrainState, optimizer, grads: dict) -> float:
    """Seconds of one AdamW update of ``state`` with ``grads``, alone (it
    updates the state in place)."""
    named = dict(state.params.named_parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    optimizer.update(grads, state.opt, named)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def twin_gradient_check(state: TrainState, cfg, batch: dict) -> dict:
    """mamba2's bf16 gradient at the trained state's first SSM_TWIN_LAYERS
    layers against a float32 twin of the same weights (TF32 off): every
    leaf within SSM_GRAD_REL_RMS relative RMS.  The control: the same bf16
    gradient with the weights rounded to SSM_CONTROL_BITS explicit mantissa
    bits must put its median leaf at least SSM_CONTROL_RATIO times as far
    from the twin's as the bf16 gradient's median leaf (whether its worst
    leaf falls outside the bound is recorded)."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    cut = dataclasses.replace(cfg, num_layers=SSM_TWIN_LAYERS)
    model = sub_model(state, cut)
    twin, cut32 = float32_twin(model, cut)
    _, got = loss_and_grads(model, batch, cut)
    _, want = loss_and_grads(twin.requires_grad_(True), batch, cut32)
    agreement = leaf_agreement(got, want)
    del got
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(round_mantissa(p.float(), SSM_CONTROL_BITS))
    _, coarse = loss_and_grads(model, batch, cut)
    control = leaf_agreement(coarse, want)
    del model, twin, want, coarse
    torch.cuda.empty_cache()
    check(agreement["max_rel_rms"] <= SSM_GRAD_REL_RMS,
          f"every bf16 gradient leaf within {SSM_GRAD_REL_RMS} relative RMS of the float32 "
          f"twin's ({SSM_TWIN_LAYERS} layers)")
    ratio = control["median_rel_rms"] / agreement["median_rel_rms"]
    check(ratio >= SSM_CONTROL_RATIO,
          f"the control ({SSM_CONTROL_BITS} mantissa bits) puts the median leaf at least "
          f"{SSM_CONTROL_RATIO}x as far from the float32 twin's")
    return {"layers": SSM_TWIN_LAYERS, "bound": SSM_GRAD_REL_RMS, **agreement,
            "control_mantissa_bits": SSM_CONTROL_BITS, "control": control,
            "control_median_ratio": ratio,
            "control_outside_bound": control["max_rel_rms"] > SSM_GRAD_REL_RMS}


def flash_xla_gradient_check(state: TrainState, cfg, batch: dict,
                             layers: int = HYBRID_CHECK_LAYERS) -> dict:
    """The flash step against the xla step at the trained state's first
    ``layers`` layers (zamba2: their groups and the shared block; and the
    embedding, the final norm, the head, pixtral's ``vision_proj``) on one
    batch: the loss within TRAIN_LOSS_RTOL and every gradient leaf within
    TRAIN_GRAD_REL_RMS relative RMS, ``lm_train``'s bounds."""
    cut = dataclasses.replace(cfg, num_layers=layers)
    model = sub_model(state, cut)
    flash_m, flash_g = loss_and_grads(model, batch, cut)
    torch.cuda.empty_cache()
    before = read_counts()["flash_attn"]
    xla_m, xla_g = loss_and_grads(model, batch, dataclasses.replace(cut, attn_impl="xla"))
    torch.cuda.synchronize()
    check(read_counts()["flash_attn"] == before, "the xla step launches no flash")
    lf, lx = float(flash_m["lm_loss"]), float(xla_m["lm_loss"])
    grads = leaf_agreement(flash_g, xla_g)
    del model, flash_g, xla_g
    torch.cuda.empty_cache()
    check(np.isfinite(lf) and abs(lf - lx) <= TRAIN_LOSS_RTOL * abs(lx),
          f"flash loss within {TRAIN_LOSS_RTOL} of the xla loss")
    check(grads["max_rel_rms"] <= TRAIN_GRAD_REL_RMS,
          f"every flash gradient leaf within {TRAIN_GRAD_REL_RMS} relative RMS of xla's")
    return {"layers": layers, "loss": lf, "xla_loss": lx, **grads}


def phase_lm_ssm_train(cfg, rng, device: str = "cuda", layers: int | None = None) -> dict:
    """The train path of an SSM (mamba2) or hybrid (zamba2) config at its
    published width, cut to ``layers`` layers if given (whole groups), on the
    card: ``train_steps``, then the family's gradient check (mamba2: the
    full-shape SSD gradient and the bf16/float32-twin check with its
    control; zamba2, with ``attn_impl="pallas_flash"``: one flash forward
    and one flash backward launch a group a step, all on the tensor cores,
    and the flash/xla check) and the driver's kill and resume on the
    reduced config.  The MFU's 6·N·tokens leaves out the SSD's
    chunk-quadratic work (and zamba2's attention scores)."""
    t_phase = time.perf_counter()
    published = cfg.num_layers
    hybrid = bool(cfg.hybrid_attn_period)
    cfg = dataclasses.replace(cfg, num_layers=layers or published,
                              attn_impl="pallas_flash" if hybrid else cfg.attn_impl)
    plan = lm_mod._layer_plan(cfg)
    check(plan["tail"] == 0 or not hybrid, "the cut keeps whole groups")
    counts = cfg.param_counts()
    run = train_steps(cfg, device)
    state, batch, launches = run.pop("state"), run.pop("batch"), run["launches"]
    n_params = sum(p.numel() for p in state.params.parameters())
    family = "lm_hybrid_train" if hybrid else "lm_ssm_train"
    adamw_n = check_adamw_launches(launches, state.params, cfg.name)
    if hybrid:
        want = plan["groups"] * TRAIN_STEPS
        check(launches["flash_attn"] == launches["flash_attn_wgmma"] == want,
              f"{plan['groups']} flash launches a step (the shared block once a group, not "
              f"recomputed), all on the tensor cores ({TRAIN_STEPS} steps)")
        check(launches["flash_attn_bwd"] == launches["flash_attn_bwd_wgmma"] == want,
              f"{plan['groups']} flash backward launches a step, all on the tensor cores "
              f"({TRAIN_STEPS} steps)")
        check(sum(launches.values()) == 4 * want + adamw_n,
              "no other kernel of the port launched")
        t0 = time.perf_counter()
        grad_check = {"flash_vs_xla": flash_xla_gradient_check(state, cfg, batch)}
    else:
        check(sum(launches.values()) == adamw_n,
              "the SSM train path launches none of the other kernels")
        t0 = time.perf_counter()
        grad_check = {"bf16_vs_float32_twin": twin_gradient_check(state, cfg, batch)}
    grad_check["seconds"] = time.perf_counter() - t0
    opt_s = optimizer_seconds(state, run["optimizer"], loss_and_grads(state.params, batch, cfg)[1])
    flops = {"step_flops": step_flops(state, batch, cfg)} if family in DRYRUN_CELLS else {}
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not hybrid:
        grad_check["ssd_gradient"] = check_ssd_gradient(cfg, rng, device)
    t0 = time.perf_counter()
    resume = kill_and_resume(ROOT / "build" / f"{family}_ckpt", device,
                             HYBRID_KILL_ARGS if hybrid else SSM_KILL_ARGS)
    resume_s = time.perf_counter() - t0

    full = get_config(cfg.name).param_counts()["total"]
    row = {
        "phase": family, "arch": cfg.name, "layers": cfg.num_layers,
        "published_layers": published,
        "depth_cut": None if cfg.num_layers == published else (
            f"{cfg.num_layers} of {published} layers ({plan['groups']} groups of "
            f"{plan['group_len']}, no tail): {int(full):,} parameters at full depth need "
            f"{12 * full / 1e9:.1f} GB at 12 B a parameter"),
        "d_model": cfg.d_model, "ssm_heads": cfg.ssm_heads, "ssm_head_dim": cfg.ssm_head_dim,
        "ssm_state": cfg.ssm_state, "ssm_chunk": cfg.ssm_chunk, "vocab": cfg.vocab_size,
        "params": n_params, "params_formula": counts["total"],
        **train_readings(run, n_params, opt_s),
        "mfu_formula": "6 * params * tokens / step_s / 989e12 (leaves out the SSD's "
                       "chunk-quadratic work" + ("; counts the shared block's weights once, "
                                                 "though each group applies them, and leaves "
                                                 "out its attention scores)" if hybrid else ")"),
        **flops, **grad_check, "kill_resume": {**resume, "arch": cfg.name, "seconds": resume_s},
        "seconds": time.perf_counter() - t_phase,
    }
    if hybrid:
        row.update(groups=plan["groups"], group_len=plan["group_len"], heads=cfg.num_heads,
                   head_dim=cfg.head_dim, d_ff=cfg.d_ff)
    emit(row)
    return {"row": row}


def phase_lm_vlm_train(cfg, rng, device: str = "cuda") -> dict:
    """pixtral's train path at its published width cut to VLM_TRAIN_LAYERS,
    ``attn_impl="pallas_flash"``, 8 steps at TRAIN_BATCH x (``num_patches``
    patches + TRAIN_SEQ tokens): each layer's flash forward twice a step
    (the forward and the recompute of the checkpointed layer) and its
    backward once, all on the tensor cores at S = T = 3,072; then the
    flash/xla gradient check at VLM_CHECK_LAYERS layers and the flash
    backward alone at this shape against autograd through the plain
    forward.  The MFU counts 6·N per position through the backbone,
    patches and tokens alike."""
    t_phase = time.perf_counter()
    published = cfg.num_layers
    cfg = dataclasses.replace(cfg, num_layers=VLM_TRAIN_LAYERS, attn_impl="pallas_flash")
    run = train_steps(cfg, device)
    state, batch, launches = run.pop("state"), run.pop("batch"), run["launches"]
    n_params = sum(p.numel() for p in state.params.parameters())
    want = cfg.num_layers * TRAIN_STEPS
    check(launches["flash_attn"] == launches["flash_attn_wgmma"] == 2 * want,
          f"{2 * cfg.num_layers} flash launches a step (forward and recompute), all on the "
          f"tensor cores ({TRAIN_STEPS} steps)")
    check(launches["flash_attn_bwd"] == launches["flash_attn_bwd_wgmma"] == want,
          f"{cfg.num_layers} flash backward launches a step, all on the tensor cores "
          f"({TRAIN_STEPS} steps)")
    adamw_n = check_adamw_launches(launches, state.params, cfg.name)
    check(sum(launches.values()) == 6 * want + adamw_n, "no other kernel of the port launched")
    t0 = time.perf_counter()
    grad_check = flash_xla_gradient_check(state, cfg, batch, VLM_CHECK_LAYERS)
    grad_check["seconds"] = time.perf_counter() - t0
    opt_s = optimizer_seconds(state, run["optimizer"], loss_and_grads(state.params, batch, cfg)[1])
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    seq = cfg.num_patches + TRAIN_SEQ
    bwd = check_flash_backward(TRAIN_BATCH, seq, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                               rng, f"lm_vlm_train: B={TRAIN_BATCH} S=T={seq:,} "
                               f"H={cfg.num_heads} KV={cfg.num_kv_heads} D={cfg.head_dim} bf16 "
                               f"({cfg.name}, {cfg.num_patches:,} patches + {TRAIN_SEQ:,} "
                               "tokens)", device=device)
    positions = TRAIN_BATCH * seq
    readings = train_readings(run, n_params, opt_s, 6 * n_params * positions)
    full = get_config(cfg.name).param_counts()["total"]
    row = {
        "phase": "lm_vlm_train", "arch": cfg.name, "layers": cfg.num_layers,
        "published_layers": published,
        "depth_cut": f"{cfg.num_layers} of {published} layers: {int(full):,} parameters at "
                     f"full depth need {12 * full / 1e9:.1f} GB at 12 B a parameter",
        "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "vocab": cfg.vocab_size, "patches": cfg.num_patches,
        "vision_dim": cfg.vision_dim, "params": n_params, **readings,
        "positions_per_s": positions / readings["step_s"],
        "mfu_formula": "6 * params * (patches + tokens) / step_s / 989e12",
        "free_gb": run["card_gb"] - run["peak_gb"], "flash_vs_xla": grad_check,
        "flash_backward_ms": bwd["ms"], "flash_backward_plain_ms": bwd["plain_ms"],
        "sdpa_bwd_ms": bwd["library_ms"], "seconds": time.perf_counter() - t_phase,
    }
    emit(row)
    return {"row": row, "backward": bwd}


def phase_lm_audio_train(cfg, device: str = "cuda") -> dict:
    """whisper's train path at full width and depth, 8 steps at
    AUDIO_TRAIN_BATCH x AUDIO_CONTEXT tokens over as many sequences of
    ``cfg.encoder_seq`` frames: finite losses, no kernel launched; then the
    driver's kill and resume on the reduced config.  The MFU counts 6·N per
    position: the encoder's parameters over the frames, the rest (decoder
    and tied embedding) over the tokens."""
    t_phase = time.perf_counter()
    run = train_steps(cfg, device, AUDIO_TRAIN_BATCH, AUDIO_CONTEXT)
    state, batch, launches = run.pop("state"), run.pop("batch"), run["launches"]
    adamw_n = check_adamw_launches(launches, state.params, cfg.name)
    check(sum(launches.values()) == adamw_n, "the encoder/decoder train path launches none of "
          "the other kernels")
    named = dict(state.params.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    n_enc = sum(p.numel() for n, p in named.items() if n.startswith(("enc.", "enc_ln.")))
    frames = AUDIO_TRAIN_BATCH * cfg.encoder_seq
    tokens = AUDIO_TRAIN_BATCH * AUDIO_CONTEXT
    flops = 6 * (n_enc * frames + (n_params - n_enc) * tokens)
    opt_s = optimizer_seconds(state, run["optimizer"], loss_and_grads(state.params, batch, cfg)[1])
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resume = kill_and_resume(ROOT / "build" / "lm_audio_train_ckpt", device, AUDIO_KILL_ARGS)
    resume_s = time.perf_counter() - t0
    row = {
        "phase": "lm_audio_train", "arch": cfg.name, "encoder_layers": cfg.encoder_layers,
        "layers": cfg.num_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
        "head_dim": cfg.head_dim, "vocab": cfg.vocab_size, "frames": cfg.encoder_seq,
        "params": n_params, "encoder_params": n_enc,
        **train_readings(run, n_params, opt_s, flops),
        "mfu_formula": "6 * (encoder params * frames + other params * tokens) / step_s / "
                       "989e12 (leaves out the attention scores)",
        "kill_resume": {**resume, "arch": cfg.name, "seconds": resume_s},
        "seconds": time.perf_counter() - t_phase,
    }
    emit(row)
    return {"row": row}


def phase_moe_backward(cfg, device: str, forward: dict) -> dict:
    """``moe_dispatch``'s layer and tokens, forward + backward of
    sum(y · ct) + aux under a seeded bf16 cotangent ``ct``: each gradient
    leaf of the sort dispatch within ``MOE_TOL`` of the largest entry of
    the einsum oracle's (the forward's bound: the backward's roundings are
    those of the forward's products, transposed); both routed alike (each
    ``_route`` call's ``idx_k``); the sort path's forward + backward with
    synchronizing ops made errors; its time beside three times the
    forward's bound (a backward does twice a forward's products).
    ``forward`` is ``moe_dispatch``'s row."""
    params, x = moe_layer_and_tokens(cfg, device)
    gen = torch.Generator(device=device).manual_seed(1)
    ct = torch.randn(x.shape, generator=gen, device=device).bfloat16()
    params.requires_grad_(True)
    leaves = dict(params.named_parameters())
    xl = x.clone().requires_grad_(True)
    names, wrt = ["x", *leaves], [xl, *leaves.values()]

    def grads(apply):
        y, aux = apply(params, xl, cfg, group_size=2048, capacity_factor=MOE_CF)
        return torch.autograd.grad((y.float() * ct.float()).sum() + aux, wrt)

    sort = lambda: grads(moe_mod.moe_apply)  # noqa: E731
    got, sort_routes = observe("_route", sort)
    want, oracle_routes = observe("_route", lambda: grads(moe_mod.moe_apply_einsum))
    check(len(sort_routes) == len(oracle_routes) == 1, "one routing a call")
    flipped = int((sort_routes[0][1][1] != oracle_routes[0][1][1]).sum())
    check(flipped == 0, "the sort dispatch and the oracle route alike")
    errs = {}
    for name, g, w in zip(names, got, want):
        err, scale = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
        check(g.dtype == w.dtype == leaves.get(name, xl).dtype and bool(torch.isfinite(g).all())
              and scale > 0, f"the {name} gradient is finite, nonzero, of its leaf's dtype")
        check(err <= MOE_TOL * scale, f"the {name} gradient within {MOE_TOL} of the oracle's scale")
        errs[name] = {"max_abs_err": err, "max_abs": scale}
    del got, want
    check_sync_free("moe_backward", sort,
                    f"{cfg.name} MoE layer, {x.shape[0]} x {x.shape[1]} tokens, cf {MOE_CF}, "
                    "forward + backward")
    row = {
        "phase": "moe_backward", "arch": cfg.name, "tokens": x.shape[0] * x.shape[1],
        "capacity_factor": MOE_CF, "capacity": forward["capacity"],
        "dropped_share": forward["dropped_share"], "flipped_assignments": flipped,
        "tol": MOE_TOL, "grads": errs, "sync_free": True,
        "ms": cuda_ms(sort, 5), "forward_ms": forward["ms"],
        "bound_ms": 3 * forward["bound_ms"], "bound_by": forward["bound_by"],
        "bound": "3 x moe_dispatch's bound",
        "oracle_ms": cuda_ms(lambda: grads(moe_mod.moe_apply_einsum), 3),
    }
    emit(row)
    return row


def routes_of(dispatches: list) -> list:
    """(idx_k, keep) of each observed ``_dispatch_indices`` call, on the CPU."""
    return [(args[0].cpu(), out[1].cpu()) for args, out in dispatches]


def phase_lm_moe_train(cfg, layers: int, device: str = "cuda") -> dict:
    """The train path at the config's width cut to ``layers`` layers, then
    the driver's kill and resume on reduced deepseek-v3.  The first and the
    last step run with the dispatches observed: each MoE layer dispatches
    twice a step (forward, then the checkpointed recompute in the
    backward), the recompute exactly as the forward, and the forward's
    dropped shares are reported."""
    cfg = dataclasses.replace(cfg, num_layers=layers)
    n_moe = layers - cfg.first_dense_layers
    t0 = time.perf_counter()
    fs, loader = lm_train.build_data_plane(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0,
                                           device=device)
    fill_history(loader, 6)
    batches = [loader.sample_batch(step) for step in range(TRAIN_STEPS)]
    plane_s = time.perf_counter() - t0
    for b in batches:
        check(b["tokens"].shape == (TRAIN_BATCH, TRAIN_SEQ), "the loader batch is 4 x 2,048")
        check(bool((b["__max_event_ts__"] <= b["__observation_ts__"]).all()),
              "no token from after the loader's clock")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, device=device)
    optimizer = lm_train.train_optimizer(TRAIN_LR, TRAIN_STEPS)
    state = TrainState.create(params, optimizer)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    counts = cfg.param_counts()
    counts_full = int(get_config(cfg.name).param_counts()["total"])
    n_params = sum(p.numel() for p in params.parameters())
    # the config's count leaves out the final and the latent norms' weights
    uncounted = sum(p.numel() for n, p in params.named_parameters()
                    if n.endswith(("final_norm", "kv_norm", "q_norm")))
    check(n_params - uncounted == counts["total"], "the model holds the config's parameters")
    routers = [p for n, p in params.named_parameters() if n.endswith("ffn.router")]
    check(len(routers) == n_moe and all(p.dtype == torch.float32 for p in routers),
          "one float32 router a MoE layer")
    train_step = make_train_step(cfg, optimizer)

    reset_counts()
    losses, aux, step_s, drops = [], [], [], {}
    for i, b in enumerate(batches):
        tokens = torch.as_tensor(b["tokens"], device=device)
        t0 = time.perf_counter()
        if i in (0, TRAIN_STEPS - 1):
            (state, metrics), seen = observe("_dispatch_indices",
                                             lambda: train_step(state, {"tokens": tokens}))
        else:
            state, metrics = train_step(state, {"tokens": tokens})
        losses.append(float(metrics["lm_loss"]))
        aux.append(float(metrics["aux_loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i in (0, TRAIN_STEPS - 1):
            check(len(seen) == 2 * n_moe, "each MoE layer dispatches twice a step")
            fwd, rec = routes_of(seen[:n_moe]), routes_of(seen[n_moe:][::-1])
            check(all(torch.equal(fi, ri) and torch.equal(fk, rk)
                      for (fi, fk), (ri, rk) in zip(fwd, rec)),
                  "each recompute routes exactly as its forward")
            drops["first" if i == 0 else "last"] = drop_shares(seen[:n_moe])
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    check(all(np.isfinite(losses)) and all(np.isfinite(aux)), "losses and aux losses are finite")
    adamw_n = check_adamw_launches(launches, state.params, cfg.name)
    check(sum(launches.values()) == adamw_n,
          "the MLA + MoE train path launches none of the other kernels")
    check(peak_gb < card_gb, "peak memory under the card's")
    check(all(0 <= d < 1 for d in drops["first"] + drops["last"]), "dropped shares in [0, 1)")

    # the optimizer alone, on one state and batch
    torch.cuda.empty_cache()
    _, grads = loss_and_grads(state.params, {"tokens": tokens}, cfg)
    named = dict(state.params.named_parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    update = optimizer.update(grads, state.opt, named)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    check(update[0]["tail.0.ffn.router"].dtype == update[1]["m"]["tail.0.ffn.router"].dtype
          == torch.float32, "the router stays float32 through AdamW")
    del update, grads, named
    torch.cuda.empty_cache()
    flops = step_flops(state, {"tokens": tokens}, cfg)
    del state, params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    resume = kill_and_resume(ROOT / "build" / "lm_moe_train_ckpt", device, MOE_KILL_ARGS)
    resume_s = time.perf_counter() - t0

    tokens_n = TRAIN_BATCH * TRAIN_SEQ
    steady = float(np.median(step_s[1:]))
    row = {
        "phase": "lm_moe_train", "arch": cfg.name, "layers": layers,
        "published_layers": get_config(cfg.name).num_layers,
        "depth_cut": (f"{counts_full:,} parameters at all {get_config(cfg.name).num_layers} "
                      f"layers need {12 * counts_full / 1e9:.0f} GB at 12 B a parameter"),
        "dense_layers": cfg.first_dense_layers, "moe_layers": n_moe, "d_model": cfg.d_model,
        "experts": cfg.num_experts, "top_k": cfg.top_k, "moe_d_ff": cfg.moe_d_ff,
        "shared_experts": cfg.num_shared_experts, "kv_lora_rank": cfg.kv_lora_rank,
        "vocab": cfg.vocab_size, "params": n_params, "params_formula": counts["total"],
        "active_params": counts["active"],
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "capacity_factor": cfg.capacity_factor, "loader_clock_h": loader.clock / HOUR,
        "plane_s": plane_s, "init_s": init_s, "losses": losses, "aux_losses": aux,
        "first_step_s": step_s[0], "step_s": steady, "step_s_all": step_s,
        "train_tokens_per_s": tokens_n / steady,
        "mfu": 6 * counts["active"] * tokens_n / steady / BF16_OPS_PER_S,
        "mfu_formula": "6 * active params * tokens / step_s / 989e12",
        "mfu_total_params": 6 * n_params * tokens_n / steady / BF16_OPS_PER_S,
        "optimizer_s": opt_s, "optimizer_share": opt_s / steady,
        "peak_gb": peak_gb, "card_gb": card_gb, "launches": launches,
        "step_flops": flops,
        "dropped_share_per_moe_layer": drops, "recompute_routes_as_forward": True,
        "kill_resume": {**resume, "arch": MOE_KILL_ARGS[1], "seconds": resume_s},
    }
    emit(row)
    return {"row": row}


def phase_train_parity(device: str = "cuda", archs=PARITY_ARCHS,
                       phase: str = "moe_train_parity") -> dict:
    """``PARITY_STEPS`` train steps of each of ``archs``, reduced and in
    float32, on the card (TF32 off) and on the CPU from the same weights
    (the card's seeded draw carried over with ``lm_params_from_numpy``) and
    the same seeded batches (with frames or patch embeddings where the
    family takes them): for MoE configs every dispatch of every step
    routed alike (``idx_k`` and ``keep``); every metric within TRAJ_TOL
    (relative), each parameter and moment leaf within PARAM_REL_RMS
    relative RMS."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    rows = {}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch, reduced=True), param_dtype="float32",
                                  compute_dtype="float32")
        tree = lm_params_to_numpy(api.init_params(0, cfg, device=device))
        rng = np.random.default_rng(7)
        batches = []
        for _ in range(PARITY_STEPS):
            b = {"tokens": rng.integers(0, cfg.vocab_size, (PARITY_BATCH, PARITY_SEQ),
                                        dtype=np.int32)}
            if cfg.encoder_decoder:
                b["frames"] = rng.standard_normal(
                    (PARITY_BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
            if cfg.vision_prefix:
                b["patch_embeds"] = rng.standard_normal(
                    (PARITY_BATCH, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
            batches.append(b)
        optimizer = lm_train.train_optimizer(TRAIN_LR, PARITY_STEPS)
        runs = []
        for dev in (device, "cpu"):
            state = TrainState.create(lm_params_from_numpy(cfg, tree, device=dev), optimizer)
            step, metrics, routes = make_train_step(cfg, optimizer), [], []
            for b in batches:
                tb = {k: torch.from_numpy(x).to(dev) for k, x in b.items()}
                if cfg.moe:
                    (state, m), seen = observe("_dispatch_indices", lambda: step(state, tb))
                    routes.append(routes_of(seen))
                else:
                    state, m = step(state, tb)
                metrics.append({k: float(v) for k, v in m.items()})
            runs.append((metrics, routes, train_state_to_numpy(state)))
        (card_m, card_r, card_s), (cpu_m, cpu_r, cpu_s) = runs
        if cfg.moe:
            check(all(len(a) == len(b) > 0 for a, b in zip(card_r, cpu_r)),
                  "the same dispatches each step")
            flipped = [sum(int((ci != hi).sum()) for (ci, _), (hi, _) in zip(a, b))
                       for a, b in zip(card_r, cpu_r)]
            keep_diff = [sum(int((ck != hk).sum()) for (_, ck), (_, hk) in zip(a, b))
                         for a, b in zip(card_r, cpu_r)]
            check(not any(flipped) and not any(keep_diff), "routing identical at every step")
        loss_rel = max(abs(c[k] - h[k]) / abs(h[k]) for c, h in zip(card_m, cpu_m)
                       for k in h if k != "aux_loss")
        aux_abs = max(abs(c.get("aux_loss", 0.0) - h.get("aux_loss", 0.0))
                      for c, h in zip(card_m, cpu_m))
        check(loss_rel <= TRAJ_TOL, f"losses within {TRAJ_TOL} of the CPU's")
        rel = {}
        for part in ("params", "m", "v"):
            got = _port_named(card_s[part] if part == "params" else card_s["opt"][part])
            want = _port_named(cpu_s[part] if part == "params" else cpu_s["opt"][part])
            for n in want:
                rel[f"{part} {n}"] = float(np.linalg.norm(got[n] - want[n])
                                           / max(np.linalg.norm(want[n]), 1e-30))
        worst = max(rel, key=rel.get)
        check(rel[worst] <= PARAM_REL_RMS,
              f"parameters and moments within {PARAM_REL_RMS} relative RMS of the CPU's")
        rows[arch] = {"metrics_card": card_m, "max_loss_rel_err": loss_rel,
                      "max_aux_abs_err": aux_abs, "max_leaf_rel_rms": rel[worst],
                      "worst_leaf": worst}
        if cfg.moe:
            rows[arch].update(flipped_assignments_per_step=flipped,
                              dispatches_per_step=len(card_r[0]))
    row = {"phase": phase, "steps": PARITY_STEPS, "batch": PARITY_BATCH,
           "seq": PARITY_SEQ, "dtype": "float32", "tf32": False, "traj_tol": TRAJ_TOL,
           "param_rel_rms_tol": PARAM_REL_RMS, "archs": rows}
    emit(row)
    return row


# -- training on a mesh ------------------------------------------------------------
def mesh_steps(cfg, batches: list, device: str, mesh=None) -> dict:
    """``MESH_STEPS`` steps of the driver's optimizer from ``init_params(0)``:
    plain tensors, or on ``mesh`` as ``launch/train.py --mesh`` runs them
    (weights placed by ``sharding.param_specs`` before the moments exist,
    each batch ``Shard(0)`` over the batch axes, the step under
    ``activation_mesh``).  The state, the losses and each step's seconds."""
    params = api.init_params(0, cfg, device=device)
    if mesh is not None:
        sharding.distribute_model(params, cfg, mesh)
    optimizer = lm_train.train_optimizer(TRAIN_LR, MESH_STEPS)
    state = TrainState.create(params, optimizer)
    step = make_train_step(cfg, optimizer)
    losses, step_s = [], []
    with activation_mesh(mesh):
        for b in batches:
            if mesh is not None:
                specs = sharding.batch_specs(b, mesh)
                b = {k: sharding.distribute_tensor(x, specs[k], mesh) for k, x in b.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            loss = metrics["lm_loss"]
            losses.append(float(loss.full_tensor() if mesh is not None else loss))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    return {"state": state, "losses": losses, "step_s": step_s}


def weight_checksum(named: dict) -> float:
    """The float64 sum of every weight: equal for two bit-equal models."""
    return float(sum(float(p.double().sum()) for p in named.values()))


def mesh_moe_ep(cfg, mesh, device: str) -> dict:
    """``_moe_ep`` at one deepseek-v2-lite layer's shape (``moe_dispatch``'s
    layer and tokens: 64 routed experts, top-6, D 2,048, 4 x 2,048 tokens,
    bf16, groups of 2,048, ``MOE_CF``) on the 1x1 mesh against ``moe_apply``
    on the routed experts: routing identical (each ``_dispatch_indices``
    call's ``idx_k`` and its result), output, aux and the gradient of
    sum(y · ct) + aux in x and every weight bit-equal; both times."""
    layer, x = moe_layer_and_tokens(cfg, device)
    gen = torch.Generator(device=device).manual_seed(1)
    ct = torch.randn(x.shape, generator=gen, device=device).bfloat16()
    routed = {k: getattr(layer, k).detach() for k in ("router", "w_gate", "w_up", "w_down")}
    plain = {k: v.clone().requires_grad_(True) for k, v in routed.items()}
    xl = x.clone().requires_grad_(True)
    specs = sharding.param_specs({f"ffn.{k}": v for k, v in routed.items()}, cfg, mesh)
    dp = {k: sharding.distribute_tensor(v, specs[f"ffn.{k}"], mesh).requires_grad_(True)
          for k, v in routed.items()}
    row_spec = ("data", None, None)
    xd = sharding.distribute_tensor(x, row_spec, mesh).requires_grad_(True)
    ctd = sharding.distribute_tensor(ct, row_spec, mesh)

    def plain_fwd():
        return moe_mod.moe_apply(plain, xl, cfg, group_size=2048, capacity_factor=MOE_CF)

    def ep_fwd():
        with activation_mesh(mesh):
            return moe_mod._moe_ep(dp, xd, cfg, mesh, 2048, MOE_CF)

    def plain_grads():
        y, aux = plain_fwd()
        return y, aux, torch.autograd.grad((y.float() * ct.float()).sum() + aux,
                                           [xl, *plain.values()])

    def ep_grads():
        with activation_mesh(mesh):
            y, aux = ep_fwd()
            return y, aux, torch.autograd.grad((y.float() * ctd.float()).sum() + aux,
                                               [xd, *dp.values()])

    (y0, a0, g0), routes0 = observe("_dispatch_indices", plain_grads)
    (y1, a1, g1), routes1 = observe("_dispatch_indices", ep_grads)
    check(len(routes0) == len(routes1) == 1, "one dispatch a call")
    (args0, out0), (args1, out1) = routes0[0], routes1[0]
    same_routes = (torch.equal(args0[0], args1[0])
                   and all(torch.equal(a, b) for a, b in zip(out0, out1)))
    check(same_routes, "_moe_ep routes and dispatches as moe_apply")
    y1, a1 = y1.full_tensor(), a1.full_tensor()
    g1 = [g.full_tensor() for g in g1]
    names = ["x", *routed]
    unequal = [n for n, a, b in zip(names, g0, g1) if not torch.equal(a, b)]
    check(torch.equal(y0, y1) and torch.equal(a0, a1), "_moe_ep's output and aux are "
          "moe_apply's, bit for bit")
    check(not unequal, f"_moe_ep's gradients are moe_apply's, bit for bit (unequal: {unequal})")
    check(bool(torch.isfinite(y1).all()), "the EP output is finite")
    b, s, d = x.shape
    return {"shape": f"{b} x {s} tokens, D {d}, {cfg.num_experts} experts top-{cfg.top_k}, "
                     f"groups of 2,048, cf {MOE_CF}, bf16",
            "routing_identical": same_routes, "output_bit_equal": True,
            "grads_bit_equal": names, "ep_ms": cuda_ms(ep_fwd, 5),
            "moe_apply_ms": cuda_ms(plain_fwd, 5), "ep_fwd_bwd_ms": cuda_ms(ep_grads, 3),
            "moe_apply_fwd_bwd_ms": cuda_ms(plain_grads, 3)}


def decode_through_serve_step(model, cfg, prompt: torch.Tensor, device: str,
                              mesh=None) -> dict:
    """``MESH_DECODE_PROMPT`` prompt tokens and then ``MESH_DECODE_STEPS``
    greedy tokens of ``prompt``'s requests, every step one ``serve_step``
    (a prompt step's token is dropped, the prompt's next one fed): unsharded,
    or on ``mesh`` with ``model`` placed by ``param_specs`` and the cache by
    ``cache_specs``.  Each step's logits (whole), the greedy tokens, the
    final cache's leaves (whole) and each step's seconds."""
    from repro_torch.convert import whole_tensor

    b = prompt.shape[0]
    cache = api.init_cache(cfg, b, MESH_DECODE_PROMPT + MESH_DECODE_STEPS, device=device)
    if mesh is not None:
        cache = sharding.distribute_cache(cache, cfg, mesh)
    serve_step = make_serve_step(cfg)
    logits, tokens, step_s = [], [], []
    decode = api.decode_step

    def recorded(*a):
        out, c = decode(*a)
        logits.append(whole_tensor(out))
        return out, c

    api.decode_step = recorded
    try:
        with torch.no_grad(), activation_mesh(mesh):
            tok = prompt[:, :1]
            for i in range(MESH_DECODE_PROMPT + MESH_DECODE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nxt, cache = serve_step(model, cache, tok)
                nxt = whole_tensor(nxt)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                if i + 1 < MESH_DECODE_PROMPT:
                    tok = prompt[:, i + 1:i + 2]
                else:
                    tokens.append(nxt)
                    tok = nxt[:, None]
    finally:
        api.decode_step = decode
    leaves = {}

    def walk(x, name):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{name}.{k}" if name else k)
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{name}.{i}")
        elif isinstance(x, torch.Tensor):
            leaves[name] = whole_tensor(x)

    walk(cache, "")
    return {"logits": logits, "tokens": torch.stack(tokens, dim=1), "cache": leaves,
            "step_s": step_s}


def mesh_decode(cfg, mesh, device: str) -> dict:
    """``cfg`` (gemma-2b or mamba2-2.7b at full width, seeded bf16
    weights) decoded by ``decode_through_serve_step`` unsharded and then on
    the 1x1 ``mesh`` from the same weights and prompt: tokens equal, every
    step's logits and every cache leaf bit-equal; the median seconds a
    step of each (the first step of each run left out)."""
    model = api.init_params(0, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(13)
    prompt = torch.randint(0, cfg.vocab_size, (MESH_DECODE_BATCH, MESH_DECODE_PROMPT),
                           generator=gen, device=device, dtype=torch.int32)
    plain = decode_through_serve_step(model, cfg, prompt, device)
    sharding.distribute_model(model, cfg, mesh)
    check(all(type(p).__name__ == "DTensor" for p in model.parameters()),
          "every weight of the mesh run is a DTensor")
    meshed = decode_through_serve_step(model, cfg, prompt, device, mesh)
    check(torch.equal(meshed["tokens"], plain["tokens"]),
          f"{cfg.name}: the mesh run's greedy tokens are the unsharded run's")
    unequal_logits = [i for i, (a, b) in enumerate(zip(meshed["logits"], plain["logits"]))
                      if not torch.equal(a, b)]
    unequal_cache = [n for n in plain["cache"] if not torch.equal(meshed["cache"][n],
                                                                  plain["cache"][n])]
    check(len(meshed["logits"]) == len(plain["logits"]) and not unequal_logits,
          f"{cfg.name}: every step's logits bit-equal (unequal at steps {unequal_logits[:8]})")
    check(set(meshed["cache"]) == set(plain["cache"]) and not unequal_cache,
          f"{cfg.name}: every cache leaf bit-equal (unequal: {unequal_cache[:8]})")
    check(all(bool(torch.isfinite(x).all()) for x in plain["logits"]),
          f"{cfg.name}: the logits are finite")
    mesh_ms = float(np.median(meshed["step_s"][1:])) * 1e3
    plain_ms = float(np.median(plain["step_s"][1:])) * 1e3
    row = {"phase": "mesh_decode", "mesh": "1x1 (data, model), world size 1", "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model, "batch": MESH_DECODE_BATCH,
           "prompt": MESH_DECODE_PROMPT, "greedy_steps": MESH_DECODE_STEPS,
           "steps_through_serve_step": len(plain["step_s"]),
           "tokens_equal": True, "logits_bit_equal": True,
           "cache_leaves_bit_equal": len(plain["cache"]),
           "ms_per_step": mesh_ms, "unsharded_ms_per_step": plain_ms,
           "mesh_over_unsharded": mesh_ms / plain_ms,
           "first_step_ms": meshed["step_s"][0] * 1e3,
           "unsharded_first_step_ms": plain["step_s"][0] * 1e3}
    emit(row)
    return row


def phase_mesh(cfg, moe_cfg, device: str = "cuda") -> dict:
    """The mesh path on one card: NCCL at world size 1, a 1x1 (data, model)
    mesh.  ``cfg`` (gemma-2b at full width, ``pallas_flash``) takes
    ``MESH_STEPS`` steps at TRAIN_BATCH x TRAIN_SEQ unsharded and then on
    the mesh from the same weights and seeded batches (``mesh_steps``): the
    losses within ``MESH_LOSS_RTOL`` and, recorded, bit-equal, with every
    weight after the last step; the flash launches of the mesh run, on its
    local shards through ``pspec.local_call``, counted from zero.  Then
    ``mesh_moe_ep`` on ``moe_cfg``'s layer, and ``mesh_decode`` (a row of
    its own) for each of ``MESH_DECODE_ARCHS``, under ``row["decode"]``."""
    cfg = dataclasses.replace(cfg, attn_impl="pallas_flash")
    gen = torch.Generator(device=device).manual_seed(7)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                                        generator=gen, device=device, dtype=torch.int32)}
               for _ in range(MESH_STEPS)]
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as store, \
            process_group(backend, 0, 1, store):
        mesh = make_mesh((1, 1), ("data", "model"), device=device)
        plain = mesh_steps(cfg, batches, device)
        plain_w = {n: p.detach() for n, p in plain.pop("state").params.named_parameters()}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        run = mesh_steps(cfg, batches, device, mesh)
        launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        named = {n: p for n, p in run.pop("state").params.named_parameters()}
        check(all(type(p).__name__ == "DTensor" for p in named.values()),
              "every weight of the mesh run is a DTensor")
        whole = {n: p.full_tensor().detach() for n, p in named.items()}
        unequal = [n for n in plain_w if not torch.equal(whole[n], plain_w[n])]
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], plain["losses"]))
        check(all(np.isfinite(run["losses"])), "the mesh run's losses are finite")
        check(rel <= MESH_LOSS_RTOL, f"the mesh run's losses within {MESH_LOSS_RTOL} of the "
              "unsharded run's")
        want = 2 * cfg.num_layers * MESH_STEPS
        check(launches["flash_attn"] == launches["flash_attn_wgmma"] == want,
              f"{2 * cfg.num_layers} flash launches a step on local shards, all on the "
              "tensor cores")
        check(launches["flash_attn_bwd"] == launches["flash_attn_bwd_wgmma"] == want // 2,
              f"{cfg.num_layers} flash backward launches a step on local shards")
        check(launches["adamw_update"] == launches["adamw_sqnorm"] == 0,
              "the mesh run's DTensor leaves take AdamW's leaf path, not the kernels")
        row = {
            "phase": "mesh", "mesh": f"1x1 (data, model), {backend}, world size 1",
            "arch": cfg.name, "layers": cfg.num_layers, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": MESH_STEPS, "losses": run["losses"],
            "unsharded_losses": plain["losses"], "loss_max_rel_diff": rel,
            "losses_bit_equal": run["losses"] == plain["losses"],
            "weights_bit_equal": not unequal, "unequal_weights": unequal[:8],
            "n_unequal_weights": len(unequal),
            "weight_checksum": weight_checksum(whole),
            "unsharded_weight_checksum": weight_checksum(plain_w),
            "step_s": run["step_s"], "unsharded_step_s": plain["step_s"],
            "peak_gb": peak_gb, "launches": launches,
        }
        del named, whole, plain_w, run, plain
        gc.collect()
        torch.cuda.empty_cache()
        row["moe_ep"] = mesh_moe_ep(moe_cfg, mesh, device)
        gc.collect()
        torch.cuda.empty_cache()
        emit(row)
        row["decode"] = {}
        for arch in MESH_DECODE_ARCHS:
            row["decode"][arch] = mesh_decode(get_config(arch), mesh, device)
            gc.collect()
            torch.cuda.empty_cache()
    return row


# -- the dry-run against measured train rows ----------------------------------------
def phase_dryrun(rows: dict, reduced: bool = False) -> dict:
    """``launch/dryrun.py``'s cells of ``DRYRUN_CELLS`` (``reduced`` for a
    CPU rehearsal), each in a child process on the host, both at once,
    after every timed phase but the mesh's, so they contend with no timed
    host path; each against its measured train row (``rows``): the
    dry-run's FLOPs (the recorder's: on a 1x1 mesh the step's) equal the
    row's ``FlopCounterMode`` count of a step (``step_flops``); the predicted peak
    within ``DRYRUN_PEAK_TOL`` of the measured ``peak_gb``; the roofline's
    compute and memory seconds beside ``step_s``."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.dryrun import run_cell_process

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(DRYRUN_CELLS)) as pool:
        futures = {name: pool.submit(run_cell_process, arch, "train_4k", DRYRUN_MESH,
                                     layers=layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                     optimizer="float32", microbatches=1, reduced=reduced,
                                     attn_impl=attn_impl, timeout=600)
                   for name, (arch, layers, attn_impl) in DRYRUN_CELLS.items()}
        cells = {name: fut.result() for name, fut in futures.items()}
    out = {"phase": "dryrun", "mesh": f"{DRYRUN_MESH} (data, model), fake backend, meta tensors",
           "seconds": time.perf_counter() - t0, "cells": {}}
    for name, cell in cells.items():
        row = rows[name]
        check("error" not in cell, f"the dry-run of {name} ran: {cell.get('error')}")
        flops = cell["roofline"]["flops_per_dev"]
        peak_gb = cell["memory"]["peak_bytes_per_dev"] / 1e9
        check(flops == row["step_flops"] > 0, f"the dry-run's FLOPs of {name} are its step's "
              f"({flops} against {row['step_flops']})")
        check(abs(peak_gb - row["peak_gb"]) <= DRYRUN_PEAK_TOL * row["peak_gb"],
              f"the dry-run's peak of {name} within {DRYRUN_PEAK_TOL:.0%} of the measured one "
              f"({peak_gb:.2f} against {row['peak_gb']:.2f} GB)")
        r = cell["roofline"]
        out["cells"][name] = {
            "arch": cell["arch"], "layers": cell["layers"], "batch": cell["batch"],
            "seq": cell["seq"], "attn_impl": cell["attn_impl"], "flops": flops,
            "measured_step_flops": row["step_flops"],
            "predicted_peak_gb": peak_gb, "measured_peak_gb": row["peak_gb"],
            "compute_s": r["compute_s"], "memory_s": r["memory_s"], "dominant": r["dominant"],
            "measured_step_s": row["step_s"], "dryrun_s": cell["compile_s"],
            "microbatches": cell["microbatches"]}
    out["report"] = check_report(cells, rows)
    emit(out)
    return out


def check_report(cells: dict, rows: dict) -> dict:
    """The dry-run cells (``phase_dryrun``) through the port's report,
    ``scripts/render_experiments_torch.py``: its roofline table holds one
    row a cell, printed here line by line; each row's "fits H100" column
    agrees with the peak measured on this card against the report's
    capacity, and that capacity (``H100_HBM``, the data sheet's) is within
    ``H100_HBM_MARGIN`` of the card's total memory."""
    path = ROOT / "scripts" / "render_experiments_torch.py"
    spec = importlib.util.spec_from_file_location("render_experiments_torch", path)
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    card = torch.cuda.get_device_properties(0).total_memory
    check(abs(card - report.H100_HBM) <= report.H100_HBM_MARGIN * report.H100_HBM,
          f"the report's H100 capacity ({report.H100_HBM} bytes) is within "
          f"{report.H100_HBM_MARGIN:.0%} of the card's total memory ({card} bytes)")
    by_arch = {cell["arch"]: name for name, cell in cells.items()}
    tables = report.dryrun_tables({f"{c['arch']}|train_4k|{DRYRUN_MESH}": c
                                   for c in cells.values()})
    lines = tables["ROOFLINE_SINGLE"].splitlines()
    print("\n".join(lines), flush=True)
    header = [c.strip("| ") for c in lines[0].split(" | ")]
    fits = header.index("fits H100")
    check(len(lines) == 2 + len(cells), f"the report renders one row a dry-run cell "
          f"({len(lines) - 2} rows for {len(cells)} cells)")
    for line in lines[2:]:
        cols = [c.strip("| ") for c in line.split(" | ")]
        name = by_arch[cols[0]]
        measured_fits = rows[name]["peak_gb"] * 1e9 <= report.H100_HBM
        check((cols[fits] == "y") == measured_fits,
              f"the report's fits-H100 column of {name} ({cols[fits]}) agrees with the "
              f"peak measured on the card ({rows[name]['peak_gb']:.2f} GB)")
    return {"rows": lines[2:], "h100_hbm_bytes": report.H100_HBM,
            "card_total_memory": card, "counts": tables["COUNTS"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs one GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    sass = tc_sass(Path(native.build_log["path"]))
    check(sorted(sass) == TC_KERNELS and all(k["hgmma"] > 0 for k in sass.values()),
          "each tensor-core flash kernel, forward and backward, is built with HGMMA "
          "instructions")
    emit({"phase": "build", "seconds": build_s, "cached": native.build_log.get("cached"),
          "library": Path(native.build_log["path"]).name, "tensor_core_sass": sass})
    cuda = torch.device("cuda", torch.cuda.current_device())
    # float32 products in full float32 (the plain versions' reference numerics)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # quick kernel checks first, so a broken kernel stops the run early
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(0, 2**62, (16, 1 << 18), dtype=np.int64)).to(cuda)
    q = np.full((16, 512), -2, np.int64)  # routed: 256 hits, 128 misses, pads
    q[:, :256] = keys[:, ::1024].cpu().numpy()
    q[:, 256:384] = rng.integers(0, 2**62, (16, 128))
    checks = {"online_lookup": [
        check_lookup(keys, torch.from_numpy(q).to(cuda), "P=16 C=2^18 Q=512 synthetic"),
        check_lookup(*adversarial_lookup_case(rng, cuda, 16, 1 << 16, 512),
                     "adversarial: queries -1, -2, INT64_MIN/MAX, duplicates; P=16 C=2^16 "
                     "Q=512 (a cluster a partition)"),
        check_lookup(*adversarial_lookup_case(rng, cuda, 300, 2000, 3000),
                     "adversarial: P=300 C=2,000 Q=3,000 (a block a partition, two "
                     "query chunks)"),
        check_lookup(*adversarial_lookup_case(rng, cuda, 65_536, 64, 128),
                     "adversarial: P=65,536 C=64 Q=128 (grid x past 65,535)"),
    ]}
    n = 1 << 20
    vals = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32) * 100).to(cuda)
    starts = torch.from_numpy(
        np.maximum(np.arange(n) - rng.integers(0, 8192, n), 0).astype(np.int32)).to(cuda)
    checks["rolling_sum"] = [
        check_rolling(vals, starts, "N=2^20 F=4 spans<=8192 synthetic"),
        check_rolling(vals, torch.zeros_like(starts), "N=2^20 F=4 start=0 on every row"),
    ]
    n = 1_000_003  # not a multiple of the tile; F=5 takes two feature chunks
    vals = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32) * 100).to(cuda)
    starts = torch.from_numpy(
        np.maximum(np.arange(n) - rng.integers(0, 3000, n), 0).astype(np.int32)).to(cuda)
    checks["rolling_sum"].append(check_rolling(
        vals, starts, "N=1,000,003 (not a multiple of the tile) F=5 spans<=3000 synthetic"))
    del keys, vals, starts
    check_bad_inputs(cuda)
    checks["pit_search"] = [check_pit(*wide_span_case(rng, cuda),
                                      "wide span: 4,096 x 2,048 epoch-ms rows, 2^20 queries")]
    check(checks["pit_search"][0]["wide_span"], "the wide-span shape spans over 2^31 ms")
    checks["merge_scan"] = [
        check_merge(*scan_case(rng, cuda, 5, 1001, 3, 2000), 2**31,
                    "synthetic P=5 C=1001 D=3, edge timestamps, winner keys in shared memory"),
        check_merge(*scan_case(rng, cuda, 2, 3001, 5, 20_000), -1,
                    "synthetic P=2 C=3001 D=5, edge timestamps, winner keys in global memory"),
    ]
    check(checks["merge_scan"][1]["winner_keys_in"] == "global", "the global-memory path ran")
    checks["merge_scan"].append(check_merge(
        *many_partitions_case(rng, cuda, 65_536, 32, 4, 400_000), 2**31,
        "synthetic P=65,536 C=32 D=4, edge timestamps (grid x past 65,535)"))
    bf16, f32 = torch.bfloat16, torch.float32
    moe_w, vlm_w = get_config(MOE_ARCH), get_config(VLM_ARCH)
    checks["adamw_update"] = [
        check_adamw((moe_w.vocab_size, moe_w.d_model), (bf16, bf16),
                    f"main path: {MOE_ARCH}'s embedding, {moe_w.vocab_size:,} x "
                    f"{moe_w.d_model:,} bf16 (the train cell's largest leaf)"),
        check_adamw((vlm_w.vocab_size, vlm_w.d_model), (bf16, bf16),
                    f"{VLM_ARCH}'s embedding, {vlm_w.vocab_size:,} x {vlm_w.d_model:,} bf16 "
                    "(the largest leaf of a train row)"),
        check_adamw((moe_w.d_model, moe_w.num_experts), (f32, f32),
                    f"{MOE_ARCH}'s router, {moe_w.d_model:,} x {moe_w.num_experts} float32"),
        check_adamw((1_000_003,), (bf16, f32),
                    "N=1,000,003 (not a multiple of the vector) bf16 weight, float32 gradient "
                    "(a microbatched step's)"),
    ]
    main_adamw = checks["adamw_update"][0]
    check_adamw_odd_leaves(cuda)
    gc.collect()
    torch.cuda.empty_cache()

    prof = phase_profile("cuda", PROFILE_ENTITIES, 1 << 20, PROFILE_PARTITIONS, 64)
    prof_row, pstore, scan = prof["row"], prof["store"].online, prof["scan"]
    check(prof_row["launches"]["online_lookup"] == prof_row["get_batches"],
          "one lookup launch per profile GET batch")
    checks["online_lookup"].append(check_lookup(
        pstore.device_state("profile", 1).keys,
        routed_queries(pstore, rng.integers(0, PROFILE_ENTITIES, GET_BATCH)),
        "profile table P=256, one 4,096-id GET"))
    main_merge = check_merge(scan["start"], scan["routed"], 20_000,
                             "profile table P=256 C=65,536 D=32, one 2^20-row frame's winners")
    checks["merge_scan"].append(main_merge)
    work = [t.clone() for t in scan["start"][1:]]
    check_sync_free("merge_scan",
                    lambda: merge_ops.merge(scan["start"][0], *work, *scan["routed"], 20_000),
                    "profile table P=256 C=65,536 D=32, one 2^20-row frame's winners")
    merge_ops.check_error()
    del work
    del prof, pstore, scan
    torch.cuda.empty_cache()

    txn = phase_txn("cuda", TXN_ENTITIES, TXN_EVENTS_PER_HOUR, TXN_HOURS, 16)
    ostore = txn["store"].online
    main_keys = ostore.device_state("txn_rolling", 1).keys
    main_queries = routed_queries(ostore, txn["batch"])
    main_lookup = check_lookup(main_keys, main_queries,
                               "main path: txn_rolling table, one 4,096-id GET")
    checks["online_lookup"].append(main_lookup)
    check_sync_free("online_lookup", lambda: lookup_ops.lookup(main_keys, main_queries),
                    "main path: txn_rolling table, one 4,096-id GET")
    del main_keys, main_queries
    for window, tag in ((HOUR, "1h"), (6 * HOUR, "6h")):
        v, s = dsl_inputs(txn["source"], txn["mid"], window, cuda)
        checks["rolling_sum"].append(check_rolling(v, s, f"main path: one job's {tag} window"))
    main_roll = checks["rolling_sum"][-1]  # the 6 h window: the longer spans
    check_sync_free("rolling_sum", lambda: rolling_ops.rolling_sum(v, s),
                    "main path: one job's 6h window")
    del v, s

    launches = {k: txn["row"]["launches"][k] for k in ("online_lookup", "rolling_sum")}
    check(all(v > 0 for v in launches.values()), "each kernel of the main path launched")
    check(launches["rolling_sum"] == 2 * txn["row"]["jobs"]["succeeded"],
          "two rolling_sum launches per job (one per window)")
    check(launches["online_lookup"] == 16, "one lookup launch per GET batch")
    launches["merge_scan"] = prof_row["scan_merge"]["launches"]["merge_scan"]
    check(launches["merge_scan"] > 0, "merge_scan launched on the scan path")

    off = phase_offline(txn["store"], TXN_ENTITIES, SPINE_ROWS)
    launches["pit_search"] = off["row"]["launches"]["pit_search"]
    check(launches["pit_search"] == 3, "pit_search launched once per offline call")
    pit_inputs = pit_main_inputs(off["history"], off["spine"], 0, cuda)
    main_pit = check_pit(*pit_inputs, "main path: txn_rolling history, 2^20-row spine")
    checks["pit_search"].append(main_pit)
    check_sync_free("pit_search", lambda: pit_ops.pit_search(*pit_inputs[:4]),
                    "main path: txn_rolling history, 2^20-row spine")
    del pit_inputs
    del txn, ostore, off
    torch.cuda.empty_cache()

    geo = phase_geo("cuda", TXN_ENTITIES, TXN_EVENTS_PER_HOUR, GEO_JOBS, GEO_CHAOS_JOBS, 16,
                    GEO_SPINE_ROWS, MH_ENTITIES, MH_FRAME_ROWS, MH_FRAMES, MH_SHARDS)
    geo_launches = geo["row"]["launches"]
    check(all(geo_launches[k] > 0 for k in ("online_lookup", "rolling_sum", "pit_search")),
          "the geo path launched the GET, the DSL and the as-of search kernels")
    checks["online_lookup"].append(check_lookup(
        *geo["lookup_inputs"], "geo: westeurope replica table, one 4,096-id GET"))
    geo_s = geo["row"]["seconds"]
    del geo
    gc.collect()  # the geo stores hold their replicators in reference cycles
    torch.cuda.empty_cache()

    examples = phase_examples()
    for row in examples["rows"]:
        for k in ("online_lookup", "rolling_sum", "pit_search"):
            launches[k] += row["launches"][k]

    checks["flash_attn"] = [
        check_flash(PREFILL_BATCH, PREFILL_SEQ, 40, 10, 128, torch.bfloat16, "wgmma",
                    "main path: B=4 S=T=2,048 H=40 KV=10 D=128 bf16 (phi3-medium-14b)", rng),
        check_flash(2, 100, 8, 2, 64, torch.float32, "cuda_cores",
                    "f32 GQA B=2 S=T=100 (ragged) H=8 KV=2 D=64", rng),
        check_flash(2, 1024, 8, 1, 256, torch.bfloat16, "wgmma",
                    "MQA B=2 S=T=1,024 H=8 KV=1 D=256 bf16 (gemma-2b heads)", rng),
        check_flash(2, 1000, 40, 10, 128, torch.bfloat16, "wgmma",
                    "ragged bf16 B=2 S=T=1,000 H=40 KV=10 D=128", rng),
        check_flash(PREFILL_BATCH, PREFILL_SEQ, 32, 32, 112, torch.bfloat16, "wgmma",
                    "zamba2 prefill: B=4 S=T=2,048 H=KV=32 D=112 bf16 (shared block)", rng),
        check_flash(2, 1000, 32, 32, 112, torch.bfloat16, "wgmma",
                    "ragged bf16 B=2 S=T=1,000 H=KV=32 D=112", rng),
        check_flash(PREFILL_BATCH, 1024 + PREFILL_SEQ, 32, 8, 128, torch.bfloat16, "wgmma",
                    "pixtral prefill: B=4 S=T=3,072 (1,024 patches + 2,048 tokens) H=32 KV=8 "
                    "D=128 bf16", rng),
        check_flash(PREFILL_BATCH, PREFILL_SEQ, 20, 20, 128, torch.bfloat16, "wgmma",
                    "qwen1.5-4b prefill: B=4 S=T=2,048 H=KV=20 D=128 bf16 (MHA)", rng),
    ]
    main_flash, flash_112 = checks["flash_attn"][0], checks["flash_attn"][4]
    flash_vlm, flash_mha = checks["flash_attn"][6], checks["flash_attn"][7]
    checks["flash_attn_bwd"] = [
        check_flash_backward(PREFILL_BATCH, PREFILL_SEQ, 40, 10, 128, rng,
                             "B=4 S=T=2,048 H=40 KV=10 D=128 bf16 (phi3-medium-14b)"),
        check_flash_backward(PREFILL_BATCH, PREFILL_SEQ, 32, 32, 112, rng,
                             "B=4 S=T=2,048 H=KV=32 D=112 bf16 (zamba2-7b's shared block)"),
        check_flash_backward(2, 1000, 8, 2, 64, rng, "ragged bf16 B=2 S=T=1,000 H=8 KV=2 D=64"),
        check_flash_backward(2, 300, 8, 2, 64, rng, "f32 GQA B=2 S=T=300 (ragged) H=8 KV=2 D=64",
                             dtype=torch.float32),
    ]
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    served = phase_lm_serve(cfg, "cuda")
    prefill = phase_lm_prefill(cfg, served, main_flash["ms"])
    launches["flash_attn"] = prefill["row"]["launches"]["flash_attn"]
    check(launches["flash_attn"] > 0, "flash_attn launched on the prefill path")
    lm_row = {k: served["row"][k] for k in ("weight_gb", "online_lookup_ms", "decode_ms_per_step")}
    lm_row["prefill_tokens_per_s"] = prefill["row"]["prefill_tokens_per_s"]
    del served, prefill
    gc.collect()
    torch.cuda.empty_cache()

    # the two configs no phase above runs: gemma3-1b (a 512-token window on 5
    # of every 6 layers: the einsum path, and a decode across the window) and
    # qwen1.5-4b (MHA with QKV bias: flash at H=KV=20)
    for arch, family, kernel_ms in ((WINDOW_ARCH, "gemma3", 0.0), (MHA_ARCH, "qwen",
                                                                    flash_mha["ms"])):
        d_cfg = get_config(arch)
        d_served = phase_lm_serve(d_cfg, "cuda", phase=f"lm_{family}_serve")
        launches["online_lookup"] += d_served["row"]["launches"]["online_lookup"]
        d_prefill = phase_lm_prefill(d_cfg, d_served, kernel_ms, phase=f"lm_{family}_prefill")
        launches["flash_attn"] += d_prefill["row"]["launches"]["flash_attn"]
        lm_row[family] = {k: d_served["row"][k] for k in (
            "weight_gb", "decode_ms_per_step", "decode_bound_ms")}
        lm_row[family]["prefill_tokens_per_s"] = d_prefill["row"]["prefill_tokens_per_s"]
        if family == "qwen":
            flash_mha["launches"] = d_prefill["row"]["launches"]["flash_attn"]
        if d_cfg.sliding_window:
            window = phase_window_decode(d_cfg, d_served, d_prefill["tokens"])
            lm_row[family]["window_decode"] = {k: window[k] for k in (
                "steps_past_window", "decode_ms_per_step", "vs_full_forward")}
        del d_served, d_prefill
        gc.collect()
        torch.cuda.empty_cache()

    # the SSM and hybrid families: serving, then the full-sequence prefill
    for arch, family, kernel_ms in ((SSM_ARCH, "ssm", 0.0), (HYBRID_ARCH, "hybrid",
                                                               flash_112["ms"])):
        fam_cfg = get_config(arch)
        fam_served = phase_lm_serve(fam_cfg, "cuda", phase=f"lm_{family}_serve")
        launches["online_lookup"] += fam_served["row"]["launches"]["online_lookup"]
        fam_prefill = phase_lm_prefill(fam_cfg, fam_served, kernel_ms,
                                       phase=f"lm_{family}_prefill")["row"]
        launches["flash_attn"] += fam_prefill["launches"]["flash_attn"]
        lm_row[family] = {k: fam_served["row"][k] for k in (
            "weight_gb", "state_gb", "decode_ms_per_step", "decode_bound_ms")}
        lm_row[family]["prefill_tokens_per_s"] = fam_prefill["prefill_tokens_per_s"]
        del fam_served, fam_prefill
        gc.collect()
        torch.cuda.empty_cache()

    # the last two families: whisper's encoder/decoder, pixtral's vision prefix
    audio_cfg = get_config(AUDIO_ARCH)
    audio_served = phase_lm_serve(audio_cfg, "cuda", phase="lm_audio_serve")
    launches["online_lookup"] += audio_served["row"]["launches"]["online_lookup"]
    audio_prefill = phase_lm_audio_prefill(audio_cfg, audio_served)["row"]
    lm_row["audio"] = {k: audio_served["row"][k] for k in (
        "weight_gb", "kv_gb", "encode_ms", "decode_ms_per_step", "decode_bound_ms")}
    lm_row["audio"]["prefill_tokens_per_s"] = audio_prefill["prefill_tokens_per_s"]
    del audio_served, audio_prefill
    gc.collect()
    torch.cuda.empty_cache()
    vlm_cfg = get_config(VLM_ARCH)
    vlm_served = phase_lm_serve(vlm_cfg, "cuda", phase="lm_vlm_serve")
    launches["online_lookup"] += vlm_served["row"]["launches"]["online_lookup"]
    vlm_prefill = phase_lm_prefill(vlm_cfg, vlm_served, flash_vlm["ms"],
                                   phase="lm_vlm_prefill")["row"]
    launches["flash_attn"] += vlm_prefill["launches"]["flash_attn"]
    lm_row["vlm"] = {k: vlm_served["row"][k] for k in (
        "weight_gb", "decode_ms_per_step", "decode_bound_ms")}
    lm_row["vlm"]["prefill_tokens_per_s"] = vlm_prefill["prefill_tokens_per_s"]
    del vlm_served, vlm_prefill
    gc.collect()
    torch.cuda.empty_cache()

    moe_cfg = get_config(MOE_ARCH)
    moe_row = phase_moe_dispatch(moe_cfg, "cuda")
    torch.cuda.empty_cache()
    moe_served = phase_lm_serve(moe_cfg, "cuda", phase="lm_moe_serve")
    launches["online_lookup"] += moe_served["row"]["launches"]["online_lookup"]
    moe_prefill = phase_lm_moe_prefill(moe_cfg, moe_served)
    lm_row["moe"] = {"weight_gb": moe_served["row"]["weight_gb"],
                     "decode_ms_per_step": moe_served["row"]["decode_ms_per_step"],
                     "decode_bound_ms": moe_served["row"]["decode_bound_ms"],
                     "prefill_tokens_per_s": moe_prefill["row"]["prefill_tokens_per_s"],
                     "dispatch_dropped_share": moe_row["dropped_share"],
                     "moe_apply_ms": moe_row["ms"]}
    del moe_served, moe_prefill
    gc.collect()
    torch.cuda.empty_cache()

    trained = phase_lm_train(get_config(TRAIN_ARCH), rng)
    launches["flash_attn"] += trained["row"]["launches"]["flash_attn"]
    launches["flash_attn_bwd"] = trained["row"]["launches"]["flash_attn_bwd"]
    main_bwd = trained["backward"]
    checks["flash_attn_bwd"].append(main_bwd)
    lm_row.update({k: trained["row"][k] for k in ("train_tokens_per_s", "mfu")})
    train_row = trained["row"]
    del trained
    torch.cuda.empty_cache()

    # the SSM and hybrid families: training at full width
    ssm_trained = phase_lm_ssm_train(get_config(SSM_ARCH), rng)["row"]
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_trained = phase_lm_ssm_train(get_config(HYBRID_ARCH), rng,
                                        layers=HYBRID_TRAIN_LAYERS)["row"]
    gc.collect()
    torch.cuda.empty_cache()
    vlm_trained = phase_lm_vlm_train(vlm_cfg, rng)
    checks["flash_attn_bwd"].append(vlm_trained["backward"])
    vlm_trained = vlm_trained["row"]
    gc.collect()
    torch.cuda.empty_cache()
    audio_trained = phase_lm_audio_train(audio_cfg)["row"]
    gc.collect()
    torch.cuda.empty_cache()
    bwd_by_phase = {"lm_train (D=256)": launches["flash_attn_bwd"],
                    "lm_hybrid_train (D=112)": hybrid_trained["launches"]["flash_attn_bwd"],
                    "lm_vlm_train (D=128)": vlm_trained["launches"]["flash_attn_bwd"]}
    for row in (hybrid_trained, vlm_trained):
        launches["flash_attn"] += row["launches"]["flash_attn"]
        launches["flash_attn_bwd"] += row["launches"]["flash_attn_bwd"]
    adamw_by_phase = {row["phase"]: row["launches"]["adamw_update"] for row in (
        train_row, ssm_trained, hybrid_trained, vlm_trained, audio_trained)}
    for family, row in (("ssm", ssm_trained), ("hybrid", hybrid_trained),
                        ("vlm", vlm_trained), ("audio", audio_trained)):
        lm_row[family].update({"train_" + k: row[k] for k in (
            "layers", "step_s", "train_tokens_per_s", "mfu", "peak_gb")})

    moe_bwd = phase_moe_backward(moe_cfg, "cuda", moe_row)
    torch.cuda.empty_cache()
    moe_trained = phase_lm_moe_train(moe_cfg, MOE_TRAIN_LAYERS)["row"]
    torch.cuda.empty_cache()
    phase_train_parity("cuda")
    phase_train_parity("cuda", SSM_PARITY_ARCHS, "ssm_train_parity")
    phase_train_parity("cuda", LAST_PARITY_ARCHS, "encdec_vlm_train_parity")
    lm_row["moe"].update({"train_" + k: moe_trained[k] for k in (
        "layers", "step_s", "train_tokens_per_s", "mfu", "peak_gb")})
    lm_row["moe"]["backward_ms"] = moe_bwd["ms"]
    adamw_by_phase["lm_moe_train"] = moe_trained["launches"]["adamw_update"]
    adamw_by_phase["examples (train_lm)"] = examples["rows"][-1]["launches"]["adamw_update"]
    launches["adamw_update"] = sum(adamw_by_phase.values())

    dry = phase_dryrun({"lm_moe_train": moe_trained, "lm_ssm_train": ssm_trained,
                        "lm_train": train_row, "lm_hybrid_train": hybrid_trained})
    lm_row["dryrun"] = {k: {f: v[f] for f in ("predicted_peak_gb", "measured_peak_gb")}
                        for k, v in dry["cells"].items()}
    meshed = phase_mesh(get_config(TRAIN_ARCH), moe_cfg)
    launches["flash_attn"] += meshed["launches"]["flash_attn"]
    launches["flash_attn_bwd"] += meshed["launches"]["flash_attn_bwd"]
    bwd_by_phase["mesh (D=256)"] = meshed["launches"]["flash_attn_bwd"]
    lm_row["mesh"] = {k: meshed[k] for k in ("losses_bit_equal", "weights_bit_equal",
                                             "loss_max_rel_diff", "step_s")}
    lm_row["mesh"]["moe_ep"] = {k: meshed["moe_ep"][k] for k in ("ep_ms", "moe_apply_ms")}
    lm_row["mesh"]["decode"] = {arch: {k: r[k] for k in ("ms_per_step", "unsharded_ms_per_step")}
                                for arch, r in meshed["decode"].items()}
    torch.cuda.empty_cache()

    sources = {"online_lookup": ("src/repro_torch/csrc/online_lookup.cu",
                                 "src/repro/kernels/online_lookup/kernel.py:38"),
               "rolling_sum": ("src/repro_torch/csrc/rolling_sum.cu",
                               "src/repro/kernels/rolling_agg/kernel.py:39"),
               "pit_search": ("src/repro_torch/csrc/pit_search.cu",
                              "src/repro/kernels/pit_join/kernel.py:34"),
               "merge_scan": ("src/repro_torch/csrc/merge_scan.cu",
                              "src/repro/kernels/online_merge/kernel.py:60"),
               "flash_attn": ("src/repro_torch/csrc/flash_attn_tc.cu",
                              "src/repro/kernels/flash_attn/kernel.py:41"),
               # no TPU kernel: XLA differentiates the einsum path of attention_ref
               "flash_attn_bwd": ("src/repro_torch/csrc/flash_attn_bwd_tc.cu",
                                  "none (XLA's gradient of "
                                  "src/repro/kernels/flash_attn/ref.py:11)"),
               # no TPU kernel: XLA fuses the per-leaf update
               "adamw_update": ("src/repro_torch/csrc/adamw.cu",
                                "none (XLA's fusion of src/repro/optim/adamw.py:117)")}
    kernels = []
    for name, main_row in (("online_lookup", main_lookup), ("rolling_sum", main_roll),
                           ("pit_search", main_pit), ("merge_scan", main_merge),
                           ("flash_attn", main_flash), ("flash_attn_bwd", main_bwd),
                           ("adamw_update", main_adamw)):
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checks[name]),
            "ms": main_row["ms"], "device_ms": main_row.get("device_ms"),
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "shape": main_row["shape"],
        })
    kernels[-1]["launches_by_phase"] = adamw_by_phase
    kernels[-1].update({k: main_adamw[k] for k in (
        "bytes_per_param", "sqnorm_ms", "sqnorm_bound_ms", "sqnorm_max_rel_err")})
    kernels[-1]["other_shapes"] = [{k: r[k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "sqnorm_ms",
        "sqnorm_max_rel_err")} for r in checks["adamw_update"] if r is not main_adamw]
    kernels[-3]["head_dim_112"] = {k: flash_112[k] for k in (
        "shape", "route", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    kernels[-3]["pixtral_shape"] = {k: flash_vlm[k] for k in (
        "shape", "route", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    kernels[-3]["qwen_shape"] = {k: flash_mha[k] for k in (
        "shape", "route", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "launches")}
    kernels[-2]["launches_by_phase"] = bwd_by_phase
    kernels[-2]["library_fwd_bwd_ms"] = main_bwd["library_fwd_bwd_ms"]
    kernels[-2]["other_shapes"] = [{k: r[k] for k in (
        "shape", "route", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "library_fwd_bwd_ms")} for r in checks["flash_attn_bwd"] if r is not main_bwd]
    print(json.dumps({"kernels": kernels}), flush=True)
    emit({"card": card, "get_batch": GET_BATCH, "get_p50_ms": prof_row["get_p50_ms"],
          "get_p99_ms": prof_row["get_p99_ms"], "lm": lm_row, "geo_s": geo_s,
          "examples_s": examples["seconds"],
          "train_lm": {k: examples["rows"][-1][k] for k in (
              "arch", "step_s", "train_tokens_per_s", "mfu", "peak_gb", "first_loss",
              "last_loss")},
          "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
