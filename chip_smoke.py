"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, times each at the shapes of the paths
that run it, and drives every ported path at full size:

* the paper's 3000-TAO mixed-mode DAG on ``ThreadedRuntime`` under the
  policies ``homogeneous`` and ``molding:weight`` (slice 1);
* ``python -m repro_torch.launch.serve --arch llama3.2-1b --orchestrate``:
  the llama3.2-1b decoder at its published widths and depth, random weights
  from a seed, with a teacher-forcing check at full depth and a check of
  the card against the CPU at full width and 2 layers (slice 3);
* serving through the tenant zoo's JAX pairing, a llama3.2-1b transformer
  tenant and a kernel tenant at llama3.2-1b widths (slices 2 and 3): the
  trace, gate and controller of ``python -m repro_torch.launch.serve
  --zoo``, then a full backlog (the default ``bursty_serving_trace``, 100
  requests) with no gate and no controller;
* ``run_arch`` with ``--orchestrate`` on the MoE and sliding-window
  decoders and the patch frontend (slice 8, the ``moe`` phase):
  mixtral-8x22b at its published widths cut to 2 of 56 layers (a 4352-token
  prompt through the rolling window cache), moonshot-v1-16b-a3b at its
  widths cut to 4 of 48 layers, and internvl2-2b whole; teacher forcing on
  the card (past mixtral's window through its shifted and ring caches) and
  ``moe_ffn`` on the card against the CPU at both published widths;
* the state-space, hybrid and encoder families (slice 9, the ``families``
  phase): ``run_arch`` with ``--orchestrate`` on mamba2-780m and
  hymba-1.5b whole (a 1000-token prompt across mamba2's chunk edges into
  a padded chunk; a 1100-token prompt past hymba's 1024-token window, so
  its windowed layers roll and its global ones stay positional), with
  teacher forcing on the card; hubert-xlarge whole through
  ``make_encode_step`` (4 clips of 500 frames, the flash kernel at head
  dim 80, not causal) and 3 train steps on that batch; the zoo's ``ssm``
  and ``hybrid`` tenants at their full models, checked and then serving a
  trace together; and each family at full width and 2 layers on the card
  against the CPU, forward and loss grads;
* ``python -m repro_torch.launch.train --arch llama3.2-1b`` (slice 7): the
  launcher's default run (20 steps of batch 4 x seq 128 from
  ``SyntheticLM(seed=0)``, AdamW under the cosine schedule, clipping) at
  the full published size (``phase_train``), then ``--orchestrate
  --microbatches 2`` for 4 steps, against a sequential run of the same
  grads and updates (``phase_train_orchestrated``);
* slice 10: the zoo's kernel tenants with both implementations bound as
  TAO variants, "ref" (the plain versions) and "cuda", serving the
  100-request backlog (``phase_multi_impl``); the paper's mixed-mode DAG
  under a chaos plan that degrades one worker and kills another, with PTT
  straggler detection, an elastic fleet's heartbeats and re-mesh, and a
  second DAG on the re-meshed fleet (``phase_fleet``); one loss-and-grads of the full
  llama3.2-1b and three rounds of int8 gradient sync with error feedback
  over a one-rank NCCL mesh, held against the CPU (``phase_grad_sync``);
  the ``serve_lm`` and ``train_lm`` example twins at their defaults
  (``phase_examples``);
* slice 11: ``python -m repro_torch.launch.dryrun`` in subprocesses on
  llama3.2-1b's cells of the 16x16 and 2x16x16 meshes, all on the meta
  device of a fake world, never touching CUDA (``phase_dryrun``); and in
  ``phase_train`` the parameters and AdamW state the card allocates for
  llama3.2-1b against the dry run's bytes of them;
* slice 12: llama3.2-1b at full size on a one-rank NCCL mesh
  (``make_debug_mesh``), a prefill of 4 x 64, 32 decode steps into the
  placed cache and one ``make_train_step`` of 4 x 128, with the kernels
  on the local shards, against the same steps without a mesh
  (``phase_sharded``);
* slice 13: remat.  Every training path recomputes each layer in its
  backward, the config's default (``remat=True``, ``"nothing"``), so its
  backward launches the layers' norms and attentions again; and
  ``models.loss_and_grads`` of the full llama3.2-1b at train_4k's
  sequence, 2 x 4096 tokens, under remat off, ``"nothing"``, ``"dots"``
  and ``"nothing"`` with the loss in 8 chunks (and chunked without remat),
  with each one's peak memory, seconds, launches and loss, its loss and
  grads against its twin's without remat and the dry run's temp bytes of
  the same call; the peaks again at 16 x 512 tokens, where the loss sets
  them; and the default, cut to 2 layers, against the plain versions of
  the norm and attention (``phase_remat``);
* slice 14: the sharded program's loss and norms.  The dry run adds
  llama3.2-1b's 16x16 ``train_4k`` with ``--set ce_onehot=True`` (the
  vocab-parallel cross-entropy: a device's temp and all-gather bytes both
  under the default cell's, which gathers the fp32 logits as the
  reference's default does); and the rmsnorm kernel's two entry points for
  a row split across ranks, ``rmsnorm_sumsq`` and ``rmsnorm_scale``, are
  held against their plain versions at mamba2-780m's gated norm in 2 and
  16 column pieces, recombined against the whole-row kernel, and timed
  (``check_split_norm``).  No card path splits a row (one card shards
  nothing), so they launch in those checks alone;
* slice 15: the reference's long-sequence attention.  Above
  ``dense_attn_max_seq`` the flash Function's backward runs in q chunks of
  ``attn_chunk`` (over each chunk's causal and window slice of the keys
  under ``swa_block_skip``), held against the dense backward at the remat
  phase's attention (``check_chunked_backward``); the remat phase's peaks
  at 2 x 4096 tokens now fall strictly from the unchunked to the chunked
  loss, and a variant adds block skipping; the dry run adds
  ``prefill_32k`` under ``--set swa_block_skip=True``, whose FLOPs are the
  closed form over the chunks' key slices;
* slice 16: fault E.  The flash Function's dense backward, like the plain
  attention on and off a mesh, sums dk and dv over the GQA group and the
  q chunks in fp32 and rounds them to bf16 once, as the reference does,
  so ``check_chunked_backward`` holds the chunk-wise backward to the dense
  one at 2e-4 relative Frobenius, where it took 2^-8 before;
* slice 18: fault G.  The dry run adds mamba2-780m's and hymba-1.5b's
  16x16 ``train_4k`` and ``prefill_32k``, whose SSD scan runs on each
  rank's local shards and whose hymba prefill writes its K and V caches
  in place, so that the host's torch runs them; a line a cell gives a
  device's collective bytes, the world's and a device's FLOPs and the
  temp bytes, and the phase prints its seconds;
* slice 19: fault H.  A collective's result lives on behind funcol's
  autograd wrapper, which the dry run counted at 0 bytes while letting the
  result's storage go: a sharded layer whose output leaves an all-reduce
  was not counted.  The dry run's storages at the peak of llama3.2-1b's
  16x16 ``train_4k``, charged to their ops
  (``tools/collective_sites.py``), hold each layer's residual once
  (``phase_dryrun``); on the one-rank NCCL mesh the card's bytes of such
  a result against the dry run's count of the same ops, and the bytes
  the sharded train forward keeps for its backward and its train step's
  peak above its start against the unsharded step's (``phase_sharded``);
  and the train phase prints what was allocated at its start beside its
  peak;
* slice 20: fault I.  A sharded train step handed back its parameters and
  moments in other placements than it took, so that a second step on
  them raised; each grad now takes its parameter's placements once, in
  ``models.loss_and_grads``.  On the one-rank NCCL mesh the train step is
  taken twice, the second on the first's outputs, each against the
  unsharded run's and each handing back the placements it took
  (``phase_sharded``); the dry run's collectives of llama3.2-1b's 16x16
  ``train_4k`` are held by kind (``phase_dryrun``);
* slice 21: fault J.  Under a mesh the MoE's expert down-projection and
  its combine run on each rank's local shards and each token's output is
  reduced once, where DTensor's release chose the product's placement
  before; the dry run adds mixtral-8x22b's 16x16 ``train_4k``, its
  collective bytes of each kind and its temp held within 0.1% of this
  host's count and its FLOPs exactly (``phase_dryrun``);
* slice 22: fault K.  Under a mesh the MoE's dispatch and its expert
  up-projections run on each rank's local shards too, and each token's
  grad is reduced once, where DTensor's backward all-reduced the gathered
  tokens' cotangent and zeroed the whole batch's tokens on each device; a
  decode step's up-projections take a closed form.  The dry run holds
  mixtral-8x22b's 16x16 ``train_4k`` at the new counts and adds its
  ``decode_32k``, its FLOPs exactly and the bytes its up-projections issue
  within 0.1% of this host's (``phase_dryrun``).

Besides, it holds the RMSNorm kernel against its plain version at every
edge of its geometry (``check_rmsnorm_edges``), and the decoder's loss
gradients on the card, through the kernels' autograd Functions, against the
CPU's at full width and 2 layers, and moonshot-v1-16b-a3b's at full width
and 1 layer (``phase_grads``); two train steps there
on the card against the CPU (``phase_train_vs_cpu``); and checkpointing on
the card: a resumed run against a straight one, and a checkpoint written
from the card restored on the CPU (``phase_checkpoint``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Kernel times are CUDA events around each call, median of 30; a bytes-bound
call whose operands fit in L2 is timed with L2 flushed before each call (the
GEMV also warm, as the decode burst calls it), and a time under 0.95 of its
bound raises.  Every phase prints one JSON line.  Any failed check raises,
and the script exits with a code other than 0; it does the same without a
CUDA device.  The line before the last lists every kernel with its launches
in each path's run (``launches`` is the smallest over the paths that run
it), its error and its times at each path's shapes; the line before it
gives the script's wall time; the last line names the card.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

# the port from this checkout; in a directory without it the import fails
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch import kernels, mixed_mode  # noqa: E402
from repro_torch.core import (LITTLE, ChaosPlan,  # noqa: E402
                              ThreadedRuntime, Workload, hikey960,
                              make_policy, random_dag)
from repro_torch.core.serve_orchestrator import DECODE_UNIT  # noqa: E402
from repro_torch.checkpointing import (CheckpointManager,  # noqa: E402
                                      Template)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernel_bench import (FAMILY_NORMS,  # noqa: E402
                                      HUBERT_ATTENTION, L2_BYTES, NORM_ROWS,
                                      TRAIN_ATTENTION, attention_pairs,
                                      bound, device_ms, sdpa, sort_ops)
from repro_torch.kernels import (_build, copy_stream,  # noqa: E402
                                 flash_attention, ops, ref, rmsnorm)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, serve, train, zoo  # noqa: E402
from repro_torch.models import (get_model, hybrid,  # noqa: E402
                                loss_and_grads, make_decode_step,
                                make_prefill_step, make_train_step, mamba2,
                                transformer)
from repro_torch.models.layers import moe_ffn  # noqa: E402
from repro_torch.models.losses import lm_cross_entropy  # noqa: E402
from repro_torch.models.convert import (numpy_params,  # noqa: E402
                                        params_from_numpy)
from repro_torch.optimizer import (adamw_init, adamw_update,  # noqa: E402
                                   cosine_schedule)
from repro_torch.workers import ChunkLog  # noqa: E402
from repro_torch.examples import serve_lm, train_lm  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.parallel import use_sharding  # noqa: E402
from repro_torch.parallel.sharding import place  # noqa: E402
from repro_torch.parallel.collectives import (grad_sync_tree,  # noqa: E402
                                              quantize_int8)
from repro_torch.runtime_ft import (ElasticFleet,  # noqa: E402
                                    StragglerDetector)

N_TASKS, DEGREE, SEED = 3000, 3.03, 1
ARCH = "llama3.2-1b"  # the model of serve:model and of the zoo's transformer
PTT_FLOOR = 0.8  # a PTT time must cover this share of its kernel's time

# kernel -> (source, the Pallas kernel it replaces, the DAG class it serves
# on the mixed-mode path, or None)
KERNELS = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:63", "matmul"),
    "copy": ("src/repro_torch/kernels/csrc/copy_stream.cu",
             "src/repro/kernels/copy_stream.py:37", "copy"),
    "triad": ("src/repro_torch/kernels/csrc/copy_stream.cu",
              "src/repro/kernels/copy_stream.py:69", None),
    "sort_rows": ("src/repro_torch/kernels/csrc/sort_bitonic.cu",
                  "src/repro/kernels/sort_bitonic.py:62", "sort"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:35", None),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:124", None),
}
MIXED_PATHS = tuple(f"mixed_mode:{p}" for p in mixed_mode.POLICIES)
MODEL_PATH = "serve:model"
SERVE_PATHS = tuple(serve.PATHS)
TRAIN_PATH, ORCH_TRAIN_PATH = "train", "train_orchestrated"
TRAIN_PATHS = (TRAIN_PATH, ORCH_TRAIN_PATH)
# the moe phase's serving runs (serve.ARCH_RUNS): mixtral-8x22b cut to 2
# layers, a 4352-token prompt through its rolling window cache (4352 % 4096
# = 256 for the ring's shift), moonshot cut to 4, internvl2 whole
MOE_RUNS = {p: serve.ARCH_RUNS[p] for p in ("serve:mixtral", "serve:moonshot",
                                            "serve:internvl2")}
MOE_PATHS = tuple(MOE_RUNS)
# the families phase (slice 9): mamba2-780m and hymba-1.5b whole through
# run_arch (serve.ARCH_RUNS), hubert-xlarge whole through its encode step
# (serve.ENCODE_RUNS), and the zoo's ssm and hybrid tenants at SERVE_SHAPES
FAMILY_RUNS = {p: serve.ARCH_RUNS[p] for p in ("serve:mamba2",
                                               "serve:hymba")}
ENCODE_PATH = "encode:hubert"
FAMILY_ZOO_PATH = "serve:ssm_hybrid"
FAMILY_PATHS = tuple(FAMILY_RUNS) + (ENCODE_PATH, FAMILY_ZOO_PATH)
# teacher forcing of the families' runs: decode steps after the prompt
# (mamba2's cross the forward's chunk edge at 1024)
TF_FAMILY = {"serve:mamba2": 32, "serve:hymba": 8}
# the families at full width and 2 layers, card against CPU: (batch, length)
# of the fp32 forward (mamba2's crosses a chunk edge into a padded chunk,
# hymba's passes its window, hubert's is the encode's clip); the bf16
# forward and the loss grads take (2, 64), as phase_grads does
PARITY_TOKENS = {"mamba2-780m": (1, 300), "hymba-1.5b": (1, 1100),
                 "hubert-xlarge": (1, 500)}
ENCODE_TRAIN_STEPS = 3
# the ssm and hybrid tenants' trace: 12 requests of 512-2048 prompt tokens
FAMILY_TRACE = dict(n_steady=6, n_burst=6, burst_at=0.2,
                    steady_prompts=(512, 1024), steady_gens=(64,),
                    burst_prompts=(1024, 2048), burst_gens=(64,), seed=3)
# teacher forcing of the MoE runs: decode steps after the prompt
TF_DECODE = {"serve:mixtral": 8, "serve:moonshot": 4}
# the share of moonshot's 128 tokens that the grads phase may leave out of
# its bf16 loss for routing otherwise on the card and on the CPU: at most 4
# of the 128 (an H100 leaves 1 out, at a near-tie of its router)
MOVED_SHARE = 4 / 128
# internvl2's loss with patch_embeds: 2 rows of its 256 patches and 64 tokens
PATCH_BATCH, PATCH_SEQ = 2, 320
# slice 10's paths: the zoo's kernel tenants with both impls bound
# (multi_impl), the mixed-mode DAG under chaos with straggler detection and
# an elastic re-mesh (fleet), the grad sync of the full llama3.2-1b
# (grad_sync), and the serve_lm and train_lm twins at their defaults
MULTI_IMPL_PATH, FLEET_PATH = "multi_impl", "fleet"
# the policies explore an untried (leader, width) cell's variants in
# declared order, "ref" first: over serve:entry's 24 requests most cells
# are visited once, and "cuda" ran as few as 5 of 48 prefill chunks on an
# NVIDIA H100 80GB HBM3 (1 of 48 in runs on the CPU), so a kernel could go
# unlaunched; the backlog's 100 requests revisit the cells
MULTI_IMPL_TRACE = "serve:backlog"
GRAD_SYNC_PATH, EXAMPLES_PATH = "grad_sync", "examples"
# slice 11: python -m repro_torch.launch.dryrun on llama3.2-1b's four cells
# of the 16x16 mesh and its decode on the 2x16x16 one, each status the
# reference's (cell_skip_reason); launches no kernel.  A cell is (arch,
# mesh, shape, --set overrides)
DRYRUN_PATH = "dryrun"
DRYRUN_CELLS = {(ARCH, "single_pod", "train_4k"): "ok",
                (ARCH, "single_pod", "prefill_32k"): "ok",
                (ARCH, "single_pod", "decode_32k"): "ok",
                (ARCH, "single_pod", "long_500k"): "skip",
                (ARCH, "multi_pod", "decode_32k"): "ok",
                # slice 14: the vocab-parallel loss (--set ce_onehot=True)
                (ARCH, "single_pod", "train_4k", "ce_onehot=True"): "ok",
                # slice 15: block-skipping attention in q chunks of 1024
                (ARCH, "single_pod", "prefill_32k", "swa_block_skip=True"):
                "ok",
                # slice 18: the SSM families' train and prefill steps, the
                # SSD scan on each rank's local shards (fault G)
                **{(arch, "single_pod", shape): "ok"
                   for arch in ("mamba2-780m", "hymba-1.5b")
                   for shape in ("train_4k", "prefill_32k")},
                # slice 21: the MoE's expert down-projection and combine on
                # each rank's local shards (fault J)
                ("mixtral-8x22b", "single_pod", "train_4k"): "ok",
                # slice 22: the MoE's dispatch and up-projections on each
                # rank's local shards, a decode step's in a closed form
                # (fault K)
                ("mixtral-8x22b", "single_pod", "decode_32k"): "ok",
                # slice 23: a batch of one's decode, its SSD states made and
                # stacked in the cache's layout (fault L)
                ("mamba2-780m", "single_pod", "long_500k"): "ok"}
DRYRUN_TIMEOUT_S = 600
# slice 20: fault I.  A device's collective bytes by kind in ARCH's 16x16
# train_4k once each grad takes its parameter's placements in
# models.loss_and_grads, and (slice 23, fault L) the lookup gathers the
# table over data and its grad is reduced once (python -m
# repro_torch.launch.dryrun under torch 2.13.0+cpu).  The card host's release must give the same bytes, but for
# the clip's all-reduces of a grad's fp32 sum of squares, which a release
# may issue once or for each parameter and mesh dim (4 B each)
DRYRUN_TRAIN_COLLECTIVES = {"all-gather": 38379192320,
                            "all-reduce": 26306945044,
                            "reduce-scatter": 31277056,
                            "all-to-all": 0,
                            "collective-permute": 0}
# slice 21: fault J.  mixtral-8x22b's 16x16 train_4k once the expert
# down-projection and the combine run on each rank's local shards and each
# token's output is reduced once; slice 22: fault K, once the dispatch and
# the up-projections do too and each token's grad is reduced once; slice
# 23: fault L, the lookup on local shards (python
# -m repro_torch.launch.dryrun under torch 2.13.0+cpu): a device's
# collective bytes of each kind and its temp, each held within
# DRYRUN_MOE_REL on the card's host, whose release placed the product
# otherwise before; the FLOPs exactly
DRYRUN_MOE, DRYRUN_MOE_REL = "mixtral-8x22b", 1e-3
DRYRUN_MOE_TRAIN = {"collectives": {"all-gather": 74460954624,
                                    "all-reduce": 257193304084,
                                    "reduce-scatter": 1306165248,
                                    "all-to-all": 0,
                                    "collective-permute": 0},
                    "temp_size_bytes": 67916546048,
                    "matmul_flops": 420968917414969344,
                    "matmul_flops_per_device": 1732349289037824}
# slice 22: fault K.  Its 16x16 decode_32k: the FLOPs exactly, and the
# bytes that the dispatch and the up-projections issue
# (models.layers._local_dispatch_and_up, tools/collective_sites.py) held
# within DRYRUN_MOE_REL of this host's: a closed form, where the two
# releases' programs differed before (2.13 reduce-scattered the partial
# products, 2.11 all-reduced them)
DRYRUN_MOE_DECODE = {"matmul_flops": 279113449340928,
                     "matmul_flops_per_device": 1090328199168,
                     "up_projection_bytes": 126615552}
DRYRUN_MOE_UP_SITE = "(_local_dispatch_and_up)"
# slice 23: fault L.  Two serving cells whose programs the port's code
# now fixes (the lookup, a decode step's projections and SwiGLU, the SSM
# states in one closed form each), where each release filled the
# placements its own way before: a device's collective bytes of each kind
# and its temp (python -m repro_torch.launch.dryrun under torch
# 2.13.0+cpu), each held within DRYRUN_MOE_REL on the card's host; and
# (slice 24, fault M) a train cell of the SSM branch, the same way
DRYRUN_RELEASE = {
    ("mixtral-8x22b", "decode_32k"): {
        "collectives": {"all-gather": 994761216, "all-reduce": 22290432,
                        "reduce-scatter": 119619584, "all-to-all": 35061760,
                        "collective-permute": 0},
        "temp_size_bytes": 529916116},
    ("mamba2-780m", "long_500k"): {
        "collectives": {"all-gather": 61496832, "all-reduce": 48288,
                        "reduce-scatter": 0, "all-to-all": 119808,
                        "collective-permute": 0},
        "temp_size_bytes": 151127584},
    # slice 24: fault M.  A train cell of the SSM branch, whose backward
    # reduces B's, C's, in_proj's and the conv's grads in one closed form
    # each (sharding.whole_over, weight_blocks), where each release planned
    # its own redistributions before (the all-to-all 52248576 B on 2.13,
    # 1916928 B on 2.11); the all-reduces within the clip's scalars
    ("mamba2-780m", "train_4k"): {
        "collectives": {"all-gather": 16837372928,
                        "all-reduce": 19768220176,
                        "reduce-scatter": 110337024, "all-to-all": 5730816,
                        "collective-permute": 0},
        "temp_size_bytes": 38553336832}}
# slice 19: fault H.  At the peak of llama3.2-1b's 16x16 train_4k the
# storages of the residual's local size ((B / data) x S x d_model, bf16):
# each layer's input, which remat keeps, the last layer's output (the final
# norm's input) and the final norm's output (the head product's input),
# n_layers + DRYRUN_RESIDUALS_EXTRA, charged to their ops by
# tools/collective_sites.py
DRYRUN_PEAK_SHAPE, DRYRUN_DATA, DRYRUN_RESIDUALS_EXTRA = "train_4k", 16, 2
# slice 12: serve:model's prefill and decode steps and train steps of the
# train path, with and without a one-rank NCCL mesh (the sharded program);
# slice 20: two train steps, the second on the first's outputs (fault I)
SHARDED_PATH, SHARDED_DECODE, SHARDED_TRAIN_STEPS = "sharded", 32, 2
# slice 19: the rows of the all-reduced partial sum whose card bytes are
# held against the dry run's count (wrapped_result_bytes): 16 MiB in bf16
WRAPPED_ROWS = 4096
# slice 13: one loss_and_grads of the full llama3.2-1b at train_4k's
# sequence under each variant (config changes), each remat variant held
# against its twin without remat (REMAT_TWIN): the chunked loss sums its
# chunks' bf16 head grads in another order, so it has a twin of its own
# (off_chunk8).  At 2 x 4096 tokens the attention backward runs in q
# chunks of 1024 (slice 15: the reference's attn_chunk above
# dense_attn_max_seq), so its largest transient is a (2, 32, 1024, 4096)
# fp32 chunk and no longer the (2, 32, 4096, 4096) scores that made the
# two "nothing" variants' peaks equal: the peaks fall as REMAT_ORDER says
# ((a, b, strictly)), strictly from the unchunked to the chunked loss.
# The strict order of all four is held again at REMAT_LOSS_TOKENS, the
# same 8192 tokens as 16 rows of 512, where attention is dense
# (REMAT_LOSS_ORDER).  nothing_chunk8_skip adds block skipping
# (swa_block_skip): each chunk's backward reads the keys up to its last
# row, which rounds dq's bf16 rows otherwise (check_chunked_backward) and
# so moves every grad by bf16 noise (2.55e-3 against off_chunk8 on an
# NVIDIA H100 80GB HBM3), so it has a twin of its own (off_chunk8_skip).
# One variant, the default, is held against the plain versions of the
# norm and attention (REMAT_PLAIN_LAYERS deep, at the grads phase's
# 3e-2).
REMAT_PATH, REMAT_BATCH, REMAT_SEQ = "remat", 2, 4096
REMAT_LOSS_TOKENS = (16, 512)
REMAT_VARIANTS = {"off": {"remat": False},
                  "off_chunk8": {"remat": False, "logits_chunk": 8},
                  "nothing": {}, "dots": {"remat_policy": "dots"},
                  "nothing_chunk8": {"logits_chunk": 8},
                  "off_chunk8_skip": {"remat": False, "logits_chunk": 8,
                                      "swa_block_skip": True},
                  "nothing_chunk8_skip": {"logits_chunk": 8,
                                          "swa_block_skip": True}}
REMAT_TWIN = {"nothing": "off", "dots": "off",
              "nothing_chunk8": "off_chunk8", "off_chunk8": "off",
              "off_chunk8_skip": "off_chunk8",
              "nothing_chunk8_skip": "off_chunk8_skip"}
REMAT_ORDER = (("off", "dots", True), ("dots", "nothing", False),
               ("nothing", "nothing_chunk8", True))
REMAT_LOSS_ORDER = (("off", "dots", True), ("dots", "nothing", False),
                    ("nothing", "nothing_chunk8", True))
REMAT_GRAD_TOL = 1e-3   # relative Frobenius, each parameter against twin's
REMAT_PLAIN_LAYERS, REMAT_PLAIN_TOL = 2, 3e-2
# slice 14: the norm of a row split across ranks at mamba2-780m's gated norm
# (4000 rows of d_inner 3072: serve:mamba2's prefill), in column pieces as
# 2 and 16 model ranks hold them, each timed
SPLIT_NORM_ARCH, SPLIT_NORM_ROWS, SPLIT_PIECES = "mamba2-780m", 4000, (2, 16)
SPLIT_SUMSQ_RTOL = 1e-5   # fp32 sums of squares in another order
# fleet: worker 5 (BIG) runs at 0.3 of its speed from the start, worker 2
# (LITTLE) is killed 1 s in; the second DAG runs on the re-meshed fleet
FLEET_SLOW, FLEET_SPEED, FLEET_KILLED, FLEET_KILL_AT = 5, 0.3, 2, 1.0
FLEET_SECOND = 300
GRAD_SYNC_ROUNDS = 3
# kernel -> the paths whose main run must launch it.  triad has no caller
# in either package: it is checked and timed, and no path runs it.
KERNEL_PATHS = {"matmul": MIXED_PATHS + SERVE_PATHS
                + (MULTI_IMPL_PATH, FLEET_PATH),
                "copy": MIXED_PATHS + SERVE_PATHS
                + (MULTI_IMPL_PATH, FLEET_PATH),
                "triad": (),
                "sort_rows": MIXED_PATHS + (FLEET_PATH,),
                "rmsnorm": (MODEL_PATH,) + SERVE_PATHS + TRAIN_PATHS
                + MOE_PATHS + FAMILY_PATHS + (GRAD_SYNC_PATH, EXAMPLES_PATH,
                                              SHARDED_PATH, REMAT_PATH),
                "flash_attention": (MODEL_PATH,) + SERVE_PATHS + TRAIN_PATHS
                + MOE_PATHS + ("serve:hymba", ENCODE_PATH, FAMILY_ZOO_PATH,
                               MULTI_IMPL_PATH, GRAD_SYNC_PATH,
                               EXAMPLES_PATH, SHARDED_PATH, REMAT_PATH)}
# kernel -> the shape (a key of phase_times's result) its top-level numbers
# in the kernels line are taken at: the path that brought it into the port
MAIN_SHAPE = {"matmul": "mixed_mode", "copy": "mixed_mode",
              "triad": "stream", "sort_rows": "mixed_mode",
              "rmsnorm": "serve:model", "flash_attention": "serve"}
D_MODEL = 2048        # ARCH's width (configs/llama3_2_1b.py)
MODEL_BATCH, MODEL_PROMPT = 4, 64  # serve --arch's defaults (serve:model)
# launch.train's defaults (train), and the orchestrated run's cut (4 steps
# of 2 microbatches, train_orchestrated)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 4, 128, 3e-4
ORCH_STEPS, MICROBATCHES = 4, 2


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def tensor(shape, dtype, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        a = rng.integers(-1000, 1000, shape, dtype=np.int32)
    else:
        a = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(a).to(device="cuda", dtype=dtype)


def phase_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "load_s": time.perf_counter() - t0, "build_s": _build.build_seconds,
          "ptxas": [ln.strip() for ln in _build.build_log.splitlines()
                    if "registers" in ln or "spill" in ln]})


def phase_kernels() -> dict:
    """Each kernel against its plain version on the card, at the shapes of
    tests/test_kernels.py and of the main paths.  matmul and rmsnorm within
    that file's tolerances (matmul rtol=tol, atol=10*tol; rmsnorm
    rtol=atol=2e-5 fp32, 2e-2 bf16); copy, sort and triad bit-exact (the
    triad rounds the product and the sum one at a time, as PyTorch does);
    flash attention as ``check_flash`` says.  Sort and copy also at their
    edges (``check_sort_edges``, ``check_copy_edges``)."""
    before = kernels.launch_counts()
    err = {name: 0.0 for name in KERNELS}
    main_err = {}
    cases = 0
    for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 2e-2)):
        for m, k, n, bm, bn, bk in ((128, 128, 128, 128, 128, 128),
                                    (256, 384, 256, 128, 128, 128),
                                    (256, 256, 512, 128, 256, 64),
                                    (512, 128, 128, 256, 128, 128),
                                    (2048, 2048, 2048, 128, 128, 128)):
            x, y = tensor((m, k), dtype, 1), tensor((k, n), dtype, 2)
            got = ops.matmul(x, y, bm=bm, bn=bn, bk=bk).float()
            want = ref.matmul(x, y).float()
            diff = (got - want).abs()
            if not bool((diff <= 10 * tol + tol * want.abs()).all()):
                raise AssertionError(f"matmul {dtype} ({m},{k},{n}): max abs "
                                     f"err {diff.max().item()}")
            err["matmul"] = max(err["matmul"], diff.max().item())
            if dtype == torch.bfloat16 and m == 2048:
                main_err["matmul"] = diff.max().item()
            cases += 1
    # the zoo's decode GEMV: one row through the kernel at bm=1
    for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 2e-2)):
        x, w = tensor((1, 2048), dtype, 10), tensor((2048, 2048), dtype, 11)
        got = ops.matmul(x, w, bm=1).float()
        want = ref.matmul(x, w).float()
        diff = (got - want).abs()
        if not bool((diff <= 10 * tol + tol * want.abs()).all()):
            raise AssertionError(f"matmul GEMV {dtype}: max abs err "
                                 f"{diff.max().item()}")
        err["matmul"] = max(err["matmul"], diff.max().item())
        cases += 1
    # bf16 on both sides of m = 16 (the streaming kernel at and below it,
    # wgmma above) at the zoo's width, up to its projection; the GEMV gives
    # the same bits on every call
    w = tensor((2048, 2048), torch.bfloat16, 13)
    for m in (1, 4, 16, 17, 1024):
        x = tensor((m, 2048), torch.bfloat16, 12)
        got = ops.matmul(x, w, bm=min(m, 128)).float()
        want = ref.matmul(x, w).float()
        diff = (got - want).abs()
        if not bool((diff <= 0.2 + 2e-2 * want.abs()).all()):
            raise AssertionError(f"matmul bf16 m={m}: max abs err "
                                 f"{diff.max().item()}")
        if m == 1 and not torch.equal(ops.matmul(x, w, bm=1).float(), got):
            raise AssertionError("matmul GEMV differs between two calls")
        err["matmul"] = max(err["matmul"], diff.max().item())
        cases += 1
    flash_cases, main_err["flash_attention"], err["flash_attention"] = \
        check_flash()
    cases += flash_cases
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for shape, block in (((256, 128), 256), ((512, 64), 128),
                             ((1024, 256), 256), ((16384, 1024), 256)):
            x = tensor(shape, dtype, 3)
            got = ops.copy(x, block_rows=block)
            if not torch.equal(got, x) or got.data_ptr() == x.data_ptr():
                raise AssertionError(f"copy {dtype} {shape} not a bit-exact "
                                     f"new buffer")
            cases += 1
    # the byte path: an unaligned start, and a tail past the last 16 bytes
    flat = tensor((1, 4099), torch.int32, 4).view(-1)
    for x in (flat[1:].view(1, 4098), tensor((1, 1001), torch.bfloat16, 5)):
        if not torch.equal(copy_stream.copy(x), x):
            raise AssertionError(f"copy byte path {x.dtype} {tuple(x.shape)}")
        cases += 1
    main_err["copy"] = 0.0
    for dtype, shape, block in ((torch.float32, (8, 64), 8),
                                (torch.float32, (16, 256), 8),
                                (torch.float32, (32, 1024), 4),
                                (torch.float32, (8, 128), 2),
                                (torch.float32, (1024, 4096), 8),
                                (torch.float32, (8, 32768), 8),
                                (torch.int32, (16, 1024), 8)):
        x = tensor(shape, dtype, 6)
        got = ops.sort_rows(x, block_rows=block)
        if not torch.equal(got, ref.sort_rows(x)):
            raise AssertionError(f"sort {dtype} {shape} differs from "
                                 f"torch.sort")
        cases += 1
    cases += check_sort_edges() + check_copy_edges() + check_rmsnorm_edges()
    split_cases, split_err = check_split_norm()
    cases += split_cases
    main_err.update(split_err)
    main_err["sort_rows"] = 0.0
    # rmsnorm at test_kernels.py's sweep (w in x's dtype, eps 1e-6), then at
    # the model's shapes: bf16 x, fp32 w, eps 1e-5, all rows in one block
    norm_cases = [(rows, d, block, dtype, dtype, 1e-6, tol)
                  for rows, d, block in ((256, 128, 256), (512, 512, 128),
                                         (256, 64, 64))
                  for dtype, tol in ((torch.float32, 2e-5),
                                     (torch.bfloat16, 2e-2))]
    norm_cases += [(rows, D_MODEL, rows, torch.bfloat16, torch.float32, 1e-5,
                    2e-2) for rows in (256, 1024, 4, 1, 512)]
    # the moe phase's decoders at their widths: each run's prefill and
    # decode step, its teacher forcing's forward (for the MoE decoders also
    # in fp32 activations, at fp32's tolerance) and internvl2's prefill over
    # all but the last token and its loss over 256 patches and 64 tokens
    for path, (arch, _, b, prompt, _) in MOE_RUNS.items():
        cfg = get_config(arch)
        tf = TF_DECODE.get(path, 0)
        rows = {b * prompt, b, b * (prompt + tf), b * (prompt - (tf == 0))}
        if path == "serve:internvl2":
            rows.add(PATCH_BATCH * PATCH_SEQ)
        acts = ((torch.bfloat16, 2e-2),) + (
            ((torch.float32, 2e-5),) if cfg.is_moe else ())
        norm_cases += [(r, cfg.d_model, r, xd, torch.float32, cfg.norm_eps,
                        tol) for r in sorted(rows) for xd, tol in acts]
    norm_cases += family_norm_cases() + example_norm_cases()
    for i, (rows, d, block, xd, wd, eps, tol) in enumerate(norm_cases):
        x, w = tensor((rows, d), xd, 70 + i), tensor((d,), wd, 90 + i)
        got = ops.rmsnorm(x, w, eps=eps, block_rows=block).float()
        want = ref.rmsnorm(x, w, eps).float()
        diff = (got - want).abs()
        if got.shape != want.shape or \
                not bool((diff <= tol + tol * want.abs()).all()):
            raise AssertionError(f"rmsnorm ({rows},{d}) {xd} w {wd}: max abs "
                                 f"err {diff.max().item()}")
        err["rmsnorm"] = max(err["rmsnorm"], diff.max().item())
        if (rows, d, wd) == (NORM_ROWS["serve:model"], D_MODEL,
                             torch.float32):
            main_err["rmsnorm"] = diff.max().item()
        cases += 1
    # triad at test_kernels.py's cases and at the streaming shape
    for shape, block in (((256, 128), 128), ((16384, 1024), 256)):
        x, y = tensor(shape, torch.float32, 110), \
            tensor(shape, torch.float32, 111)
        for a in (0.0, 1.0, -2.5):
            got = ops.triad(a, x, y, block_rows=block)
            if not torch.equal(got, ref.triad(a, x, y)):
                raise AssertionError(f"triad a={a} {shape} differs from "
                                     f"a * x + y")
            cases += 1
    main_err["triad"] = 0.0
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in KERNELS:
        if after[name] <= before[name]:
            raise AssertionError(f"{name}'s launch counter did not move")
    emit({"phase": "kernels", "checked": list(KERNELS), "cases": cases,
          "max_abs_err": err, "max_abs_err_main_shape": main_err})
    return main_err


def norm_widths(cfg) -> tuple:
    """The widths ``cfg``'s model norms: d_model, and mamba2's gated norm
    at d_inner (hymba's fused norms are at d_inner_hybrid = n_heads * hd,
    which is its d_model)."""
    extra = {"ssm": cfg.d_inner, "hybrid": cfg.d_inner_hybrid}.get(
        cfg.family, cfg.d_model)
    return tuple(sorted({cfg.d_model, extra}))


def family_norm_cases() -> list:
    """rmsnorm cases (rows, d, block, x dtype, w dtype, eps, tol) at the
    families phase's shapes: each run's prefill, decode step and teacher
    forcing's forward in bf16 and fp32 activations, the tenants' 1024-token
    chunk and one-token step, the 2-layer parity's fp32 forward and the
    (2, 64) bf16 forward and grads; hubert's encode and train steps."""
    out = []
    for path, (arch, _, b, prompt, _) in FAMILY_RUNS.items():
        cfg = get_config(arch)
        p_b, p_s = PARITY_TOKENS[arch]
        rows = {torch.bfloat16: {b * prompt, b, b * (prompt + TF_FAMILY[path]),
                                 1024, 1, 2 * MODEL_PROMPT},
                torch.float32: {b * prompt, b, b * (prompt + TF_FAMILY[path]),
                                p_b * p_s}}
        for d in norm_widths(cfg):
            out += [(r, d, r, xd, torch.float32, cfg.norm_eps,
                     2e-2 if xd == torch.bfloat16 else 2e-5)
                    for xd, rs in rows.items() for r in sorted(rs)]
    cfg = get_config("hubert-xlarge")
    _, eb, es = serve.ENCODE_RUNS[ENCODE_PATH]
    p_b, p_s = PARITY_TOKENS["hubert-xlarge"]
    out += [(r, cfg.d_model, r, torch.bfloat16, torch.float32, cfg.norm_eps,
             2e-2) for r in (eb * es, 2 * MODEL_PROMPT)]
    out.append((p_b * p_s, cfg.d_model, p_b * p_s, torch.float32,
                torch.float32, cfg.norm_eps, 2e-5))
    return out


def example_norm_cases() -> list:
    """rmsnorm cases (rows, d, block, x dtype, w dtype, eps, tol) at the
    examples phase's shapes: serve_lm's prefill over its prompt and its
    decode step at ``demo_config()``'s width, and a train_lm step's forward
    over its batch at ``config_100m()``'s; bf16 x, fp32 w, all rows in one
    block as ``layers.rmsnorm`` launches them."""
    s_cfg, t_cfg = serve_lm.demo_config(), train_lm.config_100m()
    return [(r, cfg.d_model, r, torch.bfloat16, torch.float32, cfg.norm_eps,
             2e-2) for cfg, rows in ((s_cfg, (serve_lm.PROMPT_LEN, 1)),
                                     (t_cfg, (train_lm.BATCH * train_lm.SEQ,)))
            for r in rows]


def check_sort_edges() -> int:
    """sort_rows against torch.sort at every row length it takes (1 ..
    32768), fp32 and int32: random rows (3 and 129, not a multiple of the
    rows a block sorts), random 0-1 rows, reversed rows and the type's
    extremes (+-inf and +-3.4e38; INT_MIN and INT_MAX).  Returns the number
    of cases."""
    cases = 0
    for log2n in range(16):
        n = 1 << log2n
        rng = np.random.default_rng(200 + log2n)
        for dtype in (torch.float32, torch.int32):
            if dtype == torch.int32:
                info = torch.iinfo(torch.int32)
                pool = [info.min, info.max, 0, -1, 1]
                rand = rng.integers(info.min, info.max, (129, n),
                                    dtype=np.int64, endpoint=True)
            else:
                pool = [float("-inf"), float("inf"), -3.4e38, 3.4e38, 0.5]
                rand = rng.standard_normal((129, n))
            inputs = {"random": rand, "random x3": rand[:3],
                      "0-1": rng.integers(0, 2, (129, n)),
                      "reversed": np.arange(n)[::-1].reshape(1, n).copy(),
                      "extremes": np.asarray(pool)[
                          rng.integers(0, len(pool), (3, n))]}
            for name, a in inputs.items():
                x = torch.from_numpy(np.ascontiguousarray(a)).to(
                    device="cuda", dtype=dtype)
                if not torch.equal(ops.sort_rows(x, block_rows=1),
                                   ref.sort_rows(x)):
                    raise AssertionError(f"sort {dtype} n={n} {name} differs "
                                         f"from torch.sort")
                cases += 1
    return cases


def check_copy_edges() -> int:
    """copy at byte counts around its edges (one vector; one batch, 32 KB a
    block, +-16 bytes; every block's span at 1, 8 and 24 units of 256
    vectors, +-1 vector), aligned and 3 bytes off, and one copy of 2^31 + 48
    bytes: each a bit-exact new buffer.  Returns the number of cases."""
    unit = torch.cuda.get_device_properties(0).multi_processor_count \
        * 4 * 256 * 16  # one unit of 256 vectors on each block of the grid
    sizes = [16, 32752, 32768, 32784, 32791] + [
        a * unit + b for a in (1, 8, 24) for b in (-16, 0, 16, 5)]
    cases = 0
    g = torch.Generator(device="cuda").manual_seed(3)
    for nbytes in sizes:
        for offset in (0, 3):
            base = torch.randint(0, 256, (nbytes + offset,), device="cuda",
                                 dtype=torch.uint8, generator=g)
            x = base[offset:]
            got = copy_stream.copy(x)
            if got.data_ptr() == x.data_ptr() or not torch.equal(got, x):
                raise AssertionError(f"copy of {nbytes} bytes at offset "
                                     f"{offset} not a bit-exact new buffer")
            cases += 1
    x = torch.randint(0, 256, (2 ** 31 + 48,), device="cuda",
                      dtype=torch.uint8, generator=g)
    if not torch.equal(copy_stream.copy(x), x):
        raise AssertionError("copy of 2^31 + 48 bytes differs")
    del x
    torch.cuda.empty_cache()
    return cases + 1


def check_rmsnorm_edges() -> int:
    """rmsnorm against its plain version at every d around a step of its
    warps a row (``rmsnorm.geometry_edges``, up to the widest), each at
    every row count around a step of its launch (``rmsnorm.EDGE_ROWS``), in
    the three (x, w) dtype pairs it takes, at test_kernels.py's tolerances
    (rtol = atol = 2e-5 fp32, 2e-2 bf16).  Emits one line; returns the
    number of cases."""
    cases, worst = 0, {}
    for xd, wd, tol in ((torch.float32, torch.float32, 2e-5),
                        (torch.bfloat16, torch.bfloat16, 2e-2),
                        (torch.bfloat16, torch.float32, 2e-2)):
        for d in rmsnorm.geometry_edges(xd):
            w = tensor((d,), wd, d)
            for rows in rmsnorm.EDGE_ROWS:
                x = tensor((rows, d), xd, rows)
                got = rmsnorm.rmsnorm(x, w, eps=1e-5).float()
                want = rmsnorm.plain(x, w, eps=1e-5).float()
                diff = (got - want).abs()
                if not bool((diff <= tol + tol * want.abs()).all()):
                    raise AssertionError(
                        f"rmsnorm ({rows},{d}) {xd} w {wd}: max abs err "
                        f"{diff.max().item()}")
                key = f"{xd} w {wd}".replace("torch.", "")
                worst[key] = max(worst.get(key, 0.0), diff.max().item())
                cases += 1
    emit({"phase": "rmsnorm_edges", "cases": cases,
          "widths": {str(dt).replace("torch.", ""): rmsnorm.geometry_edges(dt)
                     for dt in (torch.float32, torch.bfloat16)},
          "rows": rmsnorm.EDGE_ROWS, "max_abs_err": worst})
    return cases


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference of bf16 ``got`` and ``want`` in bf16 steps
    of the larger magnitude (2^-7 of its power of two)."""
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(torch.maximum(g.abs(), w.abs()))[1] - 8)
    return ((g - w).abs() / ulp).max().item()


def split_norm_pieces(pieces: int, seed: int = 120) -> tuple:
    """mamba2-780m's gated norm operands (bf16 x of SPLIT_NORM_ROWS rows of
    d_inner, fp32 w, the config's eps) and their ``pieces`` column pieces,
    each contiguous as a rank's local shard: (x, w, eps, x pieces, w
    pieces)."""
    cfg = get_config(SPLIT_NORM_ARCH)
    x = tensor((SPLIT_NORM_ROWS, cfg.d_inner), torch.bfloat16, seed)
    w = tensor((cfg.d_inner,), torch.float32, seed + 1)
    return (x, w, cfg.norm_eps, [p.contiguous() for p in x.chunk(pieces, -1)],
            [p.contiguous() for p in w.chunk(pieces)])


def check_split_norm() -> tuple[int, dict]:
    """The rmsnorm kernel's entry points for a row split across ranks at
    mamba2-780m's gated norm, in each of SPLIT_PIECES column pieces: each
    piece's ``rmsnorm_sumsq`` against ``plain_sumsq`` at fp32 rtol
    SPLIT_SUMSQ_RTOL; the pieces' sums added in piece order, as an
    all-reduce would; each piece's ``rmsnorm_scale`` on those totals
    against ``plain_scale`` within one bf16 ulp; the pieces side by side
    against the whole-row kernel within one bf16 ulp.  Each entry point
    launches once a piece.  Emits one line; returns the cases and each
    entry point's largest error."""
    before = kernels.entry_launch_counts()
    err = {name: 0.0 for name in kernels.ENTRY_POINTS}
    ulps, cases = {}, 0
    for pieces in SPLIT_PIECES:
        x, w, eps, xs, ws = split_norm_pieces(pieces)
        whole = rmsnorm.rmsnorm(x, w, eps=eps)
        sums = [rmsnorm.sumsq(p) for p in xs]
        for p, got in zip(xs, sums):
            want = rmsnorm.plain_sumsq(p)
            if not torch.allclose(got, want, rtol=SPLIT_SUMSQ_RTOL, atol=0):
                rel = ((got - want) / want).abs().max().item()
                raise AssertionError(f"rmsnorm_sumsq ({tuple(p.shape)}): max "
                                     f"rel err {rel}")
            err["rmsnorm_sumsq"] = max(err["rmsnorm_sumsq"],
                                       (got - want).abs().max().item())
            cases += 1
        total = torch.stack(sums).sum(dim=0)
        outs = [rmsnorm.scale(p, wp, total, x.shape[1], eps=eps)
                for p, wp in zip(xs, ws)]
        for p, wp, got in zip(xs, ws, outs):
            want = rmsnorm.plain_scale(p, wp, total, x.shape[1], eps=eps)
            if bf16_ulps(got, want) > 1:
                raise AssertionError(f"rmsnorm_scale ({tuple(p.shape)}): "
                                     f"{bf16_ulps(got, want)} bf16 ulps")
            err["rmsnorm_scale"] = max(err["rmsnorm_scale"], (
                got.float() - want.float()).abs().max().item())
            cases += 1
        ulps[pieces] = bf16_ulps(torch.cat(outs, dim=-1), whole)
        if ulps[pieces] > 1:
            raise AssertionError(f"split norm in {pieces} pieces: "
                                 f"{ulps[pieces]} bf16 ulps from the whole "
                                 f"row's kernel")
        cases += 1
    torch.cuda.synchronize()
    launched = {k: n - before[k]
                for k, n in kernels.entry_launch_counts().items()}
    if launched != {k: sum(SPLIT_PIECES) for k in kernels.ENTRY_POINTS}:
        raise AssertionError(f"split norm: launches {launched}")
    emit({"phase": "split_norm", "arch": SPLIT_NORM_ARCH,
          "shape": [SPLIT_NORM_ROWS, get_config(SPLIT_NORM_ARCH).d_inner],
          "pieces": list(SPLIT_PIECES), "cases": cases, "launches": launched,
          "max_abs_err": err, "sumsq_rtol": SPLIT_SUMSQ_RTOL,
          "recombined_bf16_ulps_vs_whole_row": ulps})
    return cases, err


# dtype -> (rtol, atol) of flash_attention against its plain version.  fp32:
# summation order.  bf16: both sides compute in fp32 (the kernel carries P
# as a bf16 high and low part, to 2^-17) and round the output to bf16 once,
# so they differ by at most one bf16 ulp (2^-7 of the value): rtol 1e-2
# holds that, and atol 2e-3 is under a tenth of a typical output at the
# serving shape (|out| ~ 0.05 where a row averages ~500 keys).
FLASH_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 2e-3)}


def check_flash() -> tuple[int, float, float]:
    """flash_attention against its plain version, in the working dtype, at
    ``FLASH_TOL``, through ``ops.flash_attention`` with the tiles each caller
    passes (64 unless a case says).  Returns the number of cases, the error
    at the kernel tenant's serving shape and the largest."""
    cases = []  # (B, Hq, Hkv, S, Sk, D), dtype, causal, window, tile
    # test_kernels.py's modes, GQA ratios and bf16 case
    for causal, window in ((True, None), (False, None), (True, 100),
                           (True, 256)):
        cases.append(((2, 4, 2, 256, 256, 64), torch.float32, causal, window,
                      64))
    for hkv in (8, 4, 1):
        cases.append(((1, 8, hkv, 256, 256, 32), torch.float32, True, None,
                      64))
    cases.append(((1, 2, 1, 256, 256, 64), torch.bfloat16, True, None, 64))
    # every head size the kernel takes, 80 (hubert's) among them: causal,
    # over GQA heads
    for d in flash_attention.HEAD_DIMS:
        for dtype in FLASH_TOL:
            cases.append(((1, 4, 2, 320, 320, d), dtype, True, None, 64))
    # S != Sk, with rows (319 on) that see no key: the reference's fault 2
    for causal in (True, False):
        for dtype in FLASH_TOL:
            cases.append(((1, 2, 1, 512, 256, 64), dtype, causal, 64, 64))
    s = zoo.SERVE_SHAPES
    serving = ((s.batch, s.q_heads, s.kv_heads, s.seq, s.seq, s.head_dim),
               s.dtype, True, None, 64)
    cases.append(serving)
    # the decoder's prefill attention (layers.attention: bq = bk = S) at
    # llama3.2-1b's heads, at each batch and length the model's calls give
    # it: serve:model's prefill and forward (batch 4) and the 2-layer parity
    # check's forward (batch 2) over the prompt, their teacher-forcing
    # prefills over all but its last token, and the zoo transformer's chunk
    hq, hkv, d = s.q_heads, s.kv_heads, s.head_dim
    # and a training step's forward (batch 4) and an orchestrated
    # microbatch's (batch 2) over launch.train's 128 tokens
    for b, sq in ((MODEL_BATCH, MODEL_PROMPT), (MODEL_BATCH, MODEL_PROMPT - 1),
                  (2, MODEL_PROMPT), (2, MODEL_PROMPT - 1),
                  (1, s.model_prompt), (TRAIN_BATCH, TRAIN_SEQ),
                  (TRAIN_BATCH // MICROBATCHES, TRAIN_SEQ)):
        cases.append(((b, hq, hkv, sq, sq, d), s.dtype, True, None, sq))
    # the moe phase's decoders at head dim 128 (mixtral within its 4096-key
    # window): each run's prefill, its teacher forcing's forward over the
    # prompt and the decoded tokens (internvl2's prefill over all but the
    # last), and internvl2's loss over 256 patches and 64 tokens
    for path, (arch, _, b, prompt, _) in MOE_RUNS.items():
        cfg = get_config(arch)
        tf = TF_DECODE.get(path, 0)
        for sq in sorted({prompt, prompt + tf, prompt - (tf == 0)}):
            cases.append(((b, cfg.n_heads, cfg.n_kv_heads, sq, sq, cfg.hd),
                          torch.bfloat16, True, cfg.window, sq))
    cfg = get_config("internvl2-2b")
    cases.append(((PATCH_BATCH, cfg.n_heads, cfg.n_kv_heads, PATCH_SEQ,
                   PATCH_SEQ, cfg.hd), torch.bfloat16, True, None, PATCH_SEQ))
    # the remat phase's training forwards at llama3.2-1b's heads: 2 x 4096
    # tokens (its variants and the check against the plain versions) and
    # 16 x 512 (its peaks where the loss sets them)
    for b, sq in ((REMAT_BATCH, REMAT_SEQ), REMAT_LOSS_TOKENS):
        cases.append(((b, hq, hkv, sq, sq, d), s.dtype, True, None, sq))
    cases += family_flash_cases() + example_flash_cases()
    check_chunked_backward()
    worst = main = 0.0
    for i, case in enumerate(cases):
        (b, hq, hkv, sq, sk, d), dtype, causal, window, tile = case
        q = tensor((b, hq, sq, d), dtype, 20 + 3 * i)
        k = tensor((b, hkv, sk, d), dtype, 21 + 3 * i)
        v = tensor((b, hkv, sk, d), dtype, 22 + 3 * i)
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention(q, k, v, bq=tile, bk=tile, **kw).float()
        want = ref.attention(q, k, v, **kw).float()
        rtol, atol = FLASH_TOL[dtype]
        diff = (got - want).abs()
        if got.shape != want.shape or \
                not bool((diff <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"flash_attention {case}: max abs err "
                                 f"{diff.max().item()}")
        if sk < sq and window is not None and bool(got[:, :, 319:].any()):
            raise AssertionError(f"flash_attention {case}: a row that sees "
                                 f"no key is not 0")
        worst = max(worst, diff.max().item())
        if case == serving:
            main = diff.max().item()
    return len(cases), main, worst


# slice 15: the flash Function's chunk-wise backward against its dense one
# on the same bf16 q, k, v and g, at the remat phase's attention (2 x 4096
# tokens, llama3.2-1b's heads), in chunks of the reference's attn_chunk:
# (causal, window, block_skip) cases, each grad within FLASH_BWD_TOL
# relative Frobenius.  Both backwards sum dk and dv over the GQA group and
# the chunks in fp32 and round them to bf16 once (slice 16, fault E: the
# dense one had summed a group's bf16 grads, 2.7e-3 away), so they differ
# only where their fp32 sums, taken in another order, round a value to
# either side of a bf16 tie
FLASH_BWD_CASES = ((True, None, False), (True, None, True),
                   (True, 1024, False), (True, 1024, True))
FLASH_BWD_CHUNK, FLASH_BWD_TOL = 1024, 2e-4


def check_chunked_backward() -> dict:
    """``FlashAttentionFunction`` with ``chunk=FLASH_BWD_CHUNK`` (the
    kernel's forward, ``plain_backward``) against the same Function without
    a chunk (the kernel's forward, the dense backward) on one bf16 draw of
    q, k, v and g of the remat phase's attention, each case of
    FLASH_BWD_CASES: dq, dk and dv within FLASH_BWD_TOL relative Frobenius,
    each error printed.  Returns case -> grad -> error."""
    cfg = get_config(ARCH)
    q = tensor((REMAT_BATCH, cfg.n_heads, REMAT_SEQ, cfg.hd), torch.bfloat16,
               140)
    k, v = (tensor((REMAT_BATCH, cfg.n_kv_heads, REMAT_SEQ, cfg.hd),
                   torch.bfloat16, seed) for seed in (141, 142))
    g = tensor(tuple(q.shape), torch.bfloat16, 143)
    errs = {}
    for causal, window, skip in FLASH_BWD_CASES:
        grads = {}
        for chunk in (None, FLASH_BWD_CHUNK):
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            out = flash_attention.FlashAttentionFunction.apply(
                *qkv, causal, window, None, chunk, skip)
            grads[chunk] = torch.autograd.grad(out, qkv, g)
        label = (f"causal={causal} window={window} chunk={FLASH_BWD_CHUNK}"
                 f" block_skip={skip}")
        errs[label] = {name: ((a.float() - b.float()).norm()
                              / b.float().norm()).item()
                       for name, a, b in zip(("dq", "dk", "dv"),
                                             grads[FLASH_BWD_CHUNK],
                                             grads[None])}
        del grads
        if max(errs[label].values()) > FLASH_BWD_TOL:
            raise AssertionError(f"flash chunk-wise backward {label}: "
                                 f"relative Frobenius {errs[label]} > "
                                 f"{FLASH_BWD_TOL}")
    torch.cuda.empty_cache()
    print(f"flash chunk-wise backward vs dense at {tuple(q.shape)} over "
          f"{cfg.n_kv_heads} kv heads, bf16, relative Frobenius (bound "
          f"{FLASH_BWD_TOL}): {json.dumps(errs)}", flush=True)
    return errs


def family_flash_cases() -> list:
    """flash cases at the families phase's shapes.  hubert-xlarge at head
    dim 80, not causal: its encode's 4 clips of 500 frames (500 is not a
    multiple of the 64-row tile), the 2-layer parity's clip (fp32 too) and
    the grads' (2, 64); and a GQA case (16 q over 4 kv heads).  hymba-1.5b's
    25 q over 5 kv heads of 64, in its windowed (1024) and global layers:
    the run's prefill, the teacher forcing's forward (bf16 and fp32), the
    tenant's 1024-token chunk, the parity's fp32 forward and the grads'."""
    out = []
    hb = get_config("hubert-xlarge")
    _, eb, es = serve.ENCODE_RUNS[ENCODE_PATH]
    p_b, p_s = PARITY_TOKENS["hubert-xlarge"]
    for b, sq, dtypes in ((eb, es, (torch.bfloat16, torch.float32)),
                          (p_b, p_s, (torch.float32,)),
                          (2, MODEL_PROMPT, (torch.bfloat16,))):
        out += [((b, hb.n_heads, hb.n_kv_heads, sq, sq, hb.hd), dt, False,
                 None, sq) for dt in dtypes]
    out += [((2, 16, 4, 500, 500, 80), dt, causal, None, 500)
            for dt in FLASH_TOL for causal in (False, True)]
    hy = get_config("hymba-1.5b")
    b, prompt = FAMILY_RUNS["serve:hymba"][2:4]
    tf = prompt + TF_FAMILY["serve:hymba"]
    p_b, p_s = PARITY_TOKENS["hymba-1.5b"]
    for bb, sq, dtypes in ((b, prompt, (torch.bfloat16,)),
                           (b, tf, (torch.bfloat16, torch.float32)),
                           (1, zoo.SERVE_SHAPES.model_prompt,
                            (torch.bfloat16,)),
                           (p_b, p_s, (torch.float32,)),
                           (2, MODEL_PROMPT, (torch.bfloat16,))):
        out += [((bb, hy.n_heads, hy.n_kv_heads, sq, sq, hy.hd), dt, True,
                 win, sq) for dt in dtypes for win in (hy.window, None)]
    return out


def example_flash_cases() -> list:
    """flash cases at the examples phase's shapes, with the tiles
    ``layers.attention`` passes (bq = bk = S): serve_lm's prefill over its
    prompt (batch 1) and a train_lm step's forward over its batch, causal
    in bf16."""
    out = []
    for cfg, b, sq in ((serve_lm.demo_config(), 1, serve_lm.PROMPT_LEN),
                       (train_lm.config_100m(), train_lm.BATCH,
                        train_lm.SEQ)):
        out.append(((b, cfg.n_heads, cfg.n_kv_heads, sq, sq, cfg.hd),
                    torch.bfloat16, True, cfg.window, sq))
    return out


def phase_times() -> dict:
    """kernel, plain and library times at the shapes of each path that runs
    the kernel, and the bound each kernel is held to there.  Returns
    kernel -> shape key -> times."""
    shapes, dtypes = mixed_mode.PAPER_SHAPES, mixed_mode.DTYPES
    xm = tensor(shapes["matmul"], dtypes["matmul"], 7)
    xc = tensor(shapes["copy"], dtypes["copy"], 8)
    xs = tensor(shapes["sort"], dtypes["sort"], 9)
    # the serving chunk's operands (zoo.SERVE_SHAPES)
    sv = zoo.SERVE_SHAPES
    q = tensor((sv.batch, sv.q_heads, sv.seq, sv.head_dim), sv.dtype, 10)
    kv = tensor((sv.batch, sv.kv_heads, sv.seq, sv.head_dim), sv.dtype, 11)
    w = tensor((sv.width, sv.width), sv.dtype, 12)
    xp = tensor((sv.seq, sv.width), sv.dtype, 13)
    x1 = tensor((1, sv.width), sv.dtype, 14)
    slab = tensor((sv.cache_rows, sv.cache_cols), sv.dtype, 15)
    flash_ops = (4 * sv.head_dim * sv.batch * sv.q_heads
                 * attention_pairs(sv.seq, sv.seq, True, None))
    flash_library = sdpa(q, kv, kv)
    tb, thq, thkv, ts, td = TRAIN_ATTENTION
    qt = tensor((tb, thq, ts, td), sv.dtype, 20)
    kvt = tensor((tb, thkv, ts, td), sv.dtype, 21)
    # mixtral's prefill (serve:mixtral): q (1, 48, 4352, 128) over kv (1, 8,
    # 4352, 128) within its 4096-key window
    mx = get_config("mixtral-8x22b")
    mb, mseq = MOE_RUNS["serve:mixtral"][2:4]
    qm = tensor((mb, mx.n_heads, mseq, mx.hd), torch.bfloat16, 22)
    kvm = tensor((mb, mx.n_kv_heads, mseq, mx.hd), torch.bfloat16, 23)
    # hubert's encode (encode:hubert): q = k = v (4, 16, 500, 80), not
    # causal; hymba's prefill (serve:hymba) in its 29 windowed layers: q
    # (4, 25, 1100, 64) over kv (4, 5, 1100, 64) within 1024 keys
    eb, ehq, _, es, ed = HUBERT_ATTENTION
    qh = tensor((eb, ehq, es, ed), torch.bfloat16, 24)
    hy = get_config("hymba-1.5b")
    yb, yseq = FAMILY_RUNS["serve:hymba"][2:4]
    qy = tensor((yb, hy.n_heads, yseq, hy.hd), torch.bfloat16, 25)
    kvy = tensor((yb, hy.n_kv_heads, yseq, hy.hd), torch.bfloat16, 26)
    lib_err = {key: (sdpa(a, b, b, w, causal)().float() - ref.attention(
        a, b, b, causal=causal, window=w).float()).abs().max().item()
        for key, (a, b, w, causal) in (
            ("serve", (q, kv, None, True)), ("train", (qt, kvt, None, True)),
            ("serve:mixtral", (qm, kvm, mx.window, True)),
            (ENCODE_PATH, (qh, qh, None, False)),
            ("serve:hymba", (qy, kvy, hy.window, True)))}

    def mm(x, y):
        return (lambda: ops.matmul(x, y, bm=min(128, x.shape[0])),
                lambda: ref.matmul(x, y), lambda: torch.matmul(x, y),
                (x.numel() + y.numel() + x.shape[0] * y.shape[1])
                * x.element_size(), 2 * x.shape[0] * y.shape[1] * x.shape[1],
                x.dtype, [list(x.shape), list(y.shape)])

    def cp(x):
        return (lambda: ops.copy(x), lambda: ref.copy(x),
                lambda: torch.empty_like(x).copy_(x),
                2 * x.numel() * x.element_size(), 0, x.dtype, list(x.shape))

    def norm(rows, width=D_MODEL):
        # the model's operands: bf16 activations, fp32 weight, eps 1e-5; four
        # fp32 operations an element (square, sum, scale, weight)
        x = tensor((rows, width), torch.bfloat16, 16)
        w = tensor((width,), torch.float32, 17)
        f = torch.nn.functional.rms_norm
        return (lambda: ops.rmsnorm(x, w, eps=1e-5, block_rows=rows),
                lambda: ref.rmsnorm(x, w, 1e-5),
                lambda: f(x, (width,), w, 1e-5),
                2 * x.numel() * x.element_size() + w.numel() * w.element_size(),
                4 * x.numel(), torch.float32, [list(x.shape), list(w.shape)])

    xt, yt = (tensor((16384, 1024), torch.float32, seed) for seed in (18, 19))

    work = {  # (name, shape key) -> (kernel, plain, library, bytes,
        #                             operations, op dtype, shape)
        ("matmul", "mixed_mode"): mm(xm, xm),
        ("copy", "mixed_mode"): cp(xc),
        ("sort_rows", "mixed_mode"): (
            lambda: ops.sort_rows(xs), lambda: ref.sort_rows(xs),
            lambda: torch.sort(xs, dim=-1),
            2 * xs.numel() * xs.element_size(), sort_ops(*xs.shape),
            xs.dtype, list(xs.shape)),
        ("flash_attention", "serve"): (
            lambda: ops.flash_attention(q, kv, kv),
            lambda: ref.attention(q, kv, kv), flash_library,
            2 * (q.numel() + kv.numel()) * q.element_size(), flash_ops,
            q.dtype, [list(q.shape), list(kv.shape)]),
        ("flash_attention", "train"): (
            lambda: ops.flash_attention(qt, kvt, kvt, bq=ts, bk=ts),
            lambda: ref.attention(qt, kvt, kvt), sdpa(qt, kvt, kvt),
            2 * (qt.numel() + kvt.numel()) * qt.element_size(),
            4 * td * tb * thq * attention_pairs(ts, ts, True, None),
            qt.dtype, [list(qt.shape), list(kvt.shape)]),
        ("matmul", "serve:projection"): mm(xp, w),
        ("matmul", "serve:gemv"): mm(x1, w),
        ("copy", "serve:slab"): cp(slab),
        ("triad", "stream"): (
            lambda: ops.triad(-2.5, xt, yt), lambda: ref.triad(-2.5, xt, yt),
            lambda: torch.add(yt, xt, alpha=-2.5),
            3 * xt.numel() * xt.element_size(), 2 * xt.numel(), xt.dtype,
            [list(xt.shape), list(yt.shape)]),
        **{("rmsnorm", key): norm(rows) for key, rows in NORM_ROWS.items()},
        ("flash_attention", "serve:mixtral"): (
            lambda: ops.flash_attention(qm, kvm, kvm, window=mx.window,
                                        bq=mseq, bk=mseq),
            lambda: ref.attention(qm, kvm, kvm, window=mx.window),
            sdpa(qm, kvm, kvm, mx.window),
            2 * (qm.numel() + kvm.numel()) * qm.element_size(),
            4 * mx.hd * mb * mx.n_heads * attention_pairs(
                mseq, mseq, True, mx.window),
            qm.dtype, [list(qm.shape), list(kvm.shape)]),
        ("rmsnorm", "serve:mixtral"): norm(mb * mseq, mx.d_model),
        ("flash_attention", ENCODE_PATH): (
            lambda: ops.flash_attention(qh, qh, qh, causal=False, bq=es,
                                        bk=es),
            lambda: ref.attention(qh, qh, qh, causal=False),
            sdpa(qh, qh, qh, causal=False),
            4 * qh.numel() * qh.element_size(),
            4 * ed * eb * ehq * attention_pairs(es, es, False, None),
            qh.dtype, [list(qh.shape)] * 3),
        ("flash_attention", "serve:hymba"): (
            lambda: ops.flash_attention(qy, kvy, kvy, window=hy.window,
                                        bq=yseq, bk=yseq),
            lambda: ref.attention(qy, kvy, kvy, window=hy.window),
            sdpa(qy, kvy, kvy, hy.window),
            2 * (qy.numel() + kvy.numel()) * qy.element_size(),
            4 * hy.hd * yb * hy.n_heads * attention_pairs(
                yseq, yseq, True, hy.window),
            qy.dtype, [list(qy.shape), list(kvy.shape)]),
        **{("rmsnorm", key): norm(rows, width) for key, (rows, width) in
           FAMILY_NORMS.items()},
        **{(name, f"gated_norm/{pieces}"): split_norm_work(name, pieces)
           for name in kernels.ENTRY_POINTS for pieces in SPLIT_PIECES},
    }
    times: dict = {}
    for (name, key), (kern, plain, lib, nbytes, nops, dtype, shape) in \
            work.items():
        bound_ms, bound_by = bound(nbytes, nops, dtype)
        # a bytes-bound call whose operands fit in L2 would re-read them
        # from there: flush L2 before each call, so it reads HBM
        cold = bound_by == "bytes" and nbytes <= L2_BYTES
        t = {"kernel_ms": device_ms(kern, cold),
             "plain_ms": device_ms(plain, cold),
             "library_ms": None if lib is None else device_ms(lib, cold),
             "l2": "flushed" if cold
             else "warm", "bound_ms": bound_ms, "bound_by": bound_by}
        if (name, key) == ("matmul", "serve:gemv"):
            # the decode burst re-reads its weight at every step: warm
            t["warm_kernel_ms"] = device_ms(kern)
        t["share_of_bound"] = t["bound_ms"] / t["kernel_ms"]
        if t["share_of_bound"] > 1.05:
            raise AssertionError(f"{name} at {key}: {t['kernel_ms']} ms, "
                                 f"under its bound {t['bound_ms']} ms")
        times.setdefault(name, {})[key] = t
        extra = {"rmsnorm": {"library": "rms_norm (fp32 weight)"},
                 "triad": {"library": "add(y, x, alpha=a)"},
                 "rmsnorm_sumsq": {"library": "x.float().square().sum(-1)"},
                 "rmsnorm_scale": {"library": None}}.get(name, {})
        if name == "flash_attention":
            extra = {"library": "scaled_dot_product_attention" + (
                " (window as a boolean mask)" if key in ("serve:mixtral",
                                                         "serve:hymba")
                else ""), "library_max_abs_err": lib_err[key]}
        emit({"phase": "time", "kernel": name, "at": key, "shape": shape,
              **t, **extra})
    return times


def split_norm_work(name: str, pieces: int) -> tuple:
    """phase_times's entry for the split norm's entry point ``name`` on one
    rank's piece of mamba2-780m's gated norm in ``pieces`` column pieces:
    (kernel, plain, library or None, bytes, operations, op dtype, shape).
    rmsnorm_sumsq reads the piece and writes a float a row, two fp32
    operations an element (square, add); rmsnorm_scale reads the piece, its
    w and the rows' totals and writes the piece, two an element (x r, w).
    No one PyTorch call scales by given totals: no library time."""
    x, w, eps, xs, ws = split_norm_pieces(pieces, seed=130)
    p, wp = xs[0], ws[0]
    rows, d = p.shape
    if name == "rmsnorm_sumsq":
        return (lambda: rmsnorm.sumsq(p), lambda: rmsnorm.plain_sumsq(p),
                lambda: p.float().square().sum(-1),
                p.numel() * p.element_size() + 4 * rows, 2 * p.numel(),
                torch.float32, [list(p.shape)])
    total, d_full = rmsnorm.plain_sumsq(x), x.shape[1]
    return (lambda: rmsnorm.scale(p, wp, total, d_full, eps=eps),
            lambda: rmsnorm.plain_scale(p, wp, total, d_full, eps=eps), None,
            2 * p.numel() * p.element_size() + 4 * (wp.numel() + rows),
            2 * p.numel(), torch.float32, [list(p.shape), list(wp.shape),
                                           [rows]])


def check_ptt(label: str, records, cells, floor) -> tuple[list, list]:
    """A PTT time is a leader's wall time.  A leader that ran a chunk waited
    for the card, so its time covers its kernels': ``floor(cls, dag_id)``
    s for a chunk of class ``cls`` in DAG ``dag_id``.  A leader whose
    place-mates claimed every chunk first records only its idle claim; a
    PTT cell ``(cls, leader, width, t)``, shared by every DAG, under
    ``floor(cls, None)`` must be one such a record touched.  Returns the
    idle records and those cells."""
    short = [r for r in records
             if r.leader_chunks > 0 and r.elapsed_s < floor(r.cls, r.dag_id)]
    if short:
        raise AssertionError(f"{label}: {len(short)} PTT records under the "
                             f"kernels' time, e.g. {short[0]}")
    idle = [r for r in records if r.leader_chunks == 0]
    idle_cells = {(r.cls, r.leader, r.width) for r in idle}
    below = []
    for cls, leader, width, t in cells:
        if t >= floor(cls, None):
            continue
        if (cls, leader, width) not in idle_cells:
            raise AssertionError(f"{label}: PTT[{cls}][{leader}, w{width}] "
                                 f"= {t} s under the kernels' time")
        below.append(f"{cls}[{leader},w{width}]")
    return idle, below


def check_slice_outputs() -> None:
    """One chunk of each class, at the main path's shapes, against the plain
    version of its op on the same operands."""
    operands = mixed_mode.operands_from_numpy(mixed_mode.make_arrays(), "cuda")
    torch.cuda.synchronize()
    dag = random_dag(n_tasks=3, target_degree=1.0, seed=0)
    mixed_mode.bind_real_work(dag, operands, device="cuda")
    plain = {"matmul": lambda x: ref.matmul(x, x), "sort": ref.sort_rows,
             "copy": ref.copy}
    for node in dag.nodes:
        got = node.work.chunk_fn(0)
        want = plain[node.type](operands[node.type])
        if got.shape != want.shape or \
                not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{node.type} chunk: bad shape or values")
        if node.type == "matmul":
            diff = (got.float() - want.float()).abs()
            ok = bool((diff <= 0.2 + 2e-2 * want.float().abs()).all())
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(f"{node.type} chunk differs from plain")


def phase_slice(times) -> dict:
    """The main path: both policies at full size.  Every counter is reset
    just before each policy's run and read just after it.  Returns path ->
    kernel -> launches."""
    floor_s = {KERNELS[name][2]: PTT_FLOOR * t["mixed_mode"]["kernel_ms"]
               / 1e3 for name, t in times.items()
               if name in KERNELS and KERNELS[name][2]}
    launches = {}
    for policy in mixed_mode.POLICIES:
        log = mixed_mode.ChunkLog()
        kernels.reset_launch_counts()
        out = mixed_mode.run(policy, N_TASKS, DEGREE, SEED, "cuda",
                             timeout_s=300.0, log=log)
        per_run = launches[f"mixed_mode:{policy}"] = kernels.launch_counts()
        if out["completed"] != N_TASKS:
            raise AssertionError(f"{policy}: {out['completed']} of {N_TASKS}")
        runs = log.runs
        if len(runs) != N_TASKS * mixed_mode.N_CHUNKS or \
                set(runs.values()) != {1}:
            raise AssertionError(f"{policy}: chunks not each run once")
        want = {name: N_TASKS // 3 * mixed_mode.N_CHUNKS if cls else 0
                for name, (_, _, cls) in KERNELS.items()}
        if per_run != want:
            raise AssertionError(f"{policy}: launches {per_run}, want {want}")
        records, widths = log.records, out["widths"]
        idle, below = check_ptt(policy, records, (
            (cls, leader, widths[wi], t)
            for cls, table in out["ptt"].items()
            for leader, row in enumerate(table)
            for wi, t in enumerate(row) if t > 0),
            lambda cls, dag_id: floor_s[cls])
        emit({"phase": "slice", "policy": policy,
              "completed": out["completed"], "elapsed_s": out["elapsed_s"],
              "taos_per_s": out["throughput_taos_per_s"],
              "launches": per_run, "ptt_records": len(records),
              "idle_leader_records": {
                  f"w{w}": sum(r.width == w for r in idle) for w in widths},
              "ptt_cells_below_floor_from_idle_leaders": below,
              "ptt_ms": {cls: (table * 1e3).tolist()
                         for cls, table in out["ptt"].items()}})
    return launches


def chunk_launches(tenant) -> dict:
    """TAO type -> kernel -> launches of one chunk of ``tenant``'s (one
    decode step of a burst)."""
    if tenant.flavor == "kernel":
        return {"prefill": {"flash_attention": 1, "matmul": 1},
                "decode": {"copy": 1, "matmul": 1}}
    norms, flash = call_launches(tenant.config)
    return {"prefill": {"rmsnorm": norms, "flash_attention": flash},
            "decode": {"rmsnorm": norms}}


def serve_floors(times, tenants) -> dict:
    """flavor -> TAO type -> the least wall time of one chunk: the event
    times of the port's kernels that the chunk launches, at the serving
    shapes, times PTT_FLOOR.  The kernel flavor's prefill chunk is one flash
    attention and one projection; the transformer's is 2L + 1 norms of the
    1024-token chunk and L flash attentions (its projections are plain
    torch.matmul, which the floor leaves out)."""
    def ms(name, key):
        return times[name][key]["kernel_ms"]
    keys = {"flash_attention": "serve", "rmsnorm": "serve:zoo_prefill"}
    floors = {}
    for tenant in tenants.values():
        n = chunk_launches(tenant)
        pre = sum(k * ms(name, keys.get(name, "serve:projection"))
                  for name, k in n["prefill"].items())
        # the burst's GEMV re-reads its weight from L2: its warm time
        dec = sum(k * (times["matmul"]["serve:gemv"]["warm_kernel_ms"]
                       if name == "matmul" else
                       ms(name, {"copy": "serve:slab",
                                 "rmsnorm": "serve:decode"}[name]))
                  for name, k in n["decode"].items())
        floors[tenant.flavor] = {
            "prefill": PTT_FLOOR * pre / 1e3,
            "decode": PTT_FLOOR * tenant.decode_steps * dec / 1e3}
    return floors


def close(what: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
          atol: float) -> float:
    """Raise unless ``got`` is finite and within rtol/atol of ``want``;
    returns the largest error."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, want "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or \
            not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what}: max abs err {diff.max().item()} "
                             f"(rtol {rtol}, atol {atol})")
    return diff.max().item()


def check_serving_outputs() -> None:
    """One prefill slab and one decode burst of a kernel tenant at the
    serving shapes against the plain versions composed the same way.  The
    projection sums 2048 products: test_kernels.py's bf16 matmul tolerance
    (rtol=2e-2, atol=0.2) holds it."""
    arrays = zoo.kernel_arrays(zoo.SERVE_SHAPES, seed=5)
    operands = zoo.kernel_operands_from_numpy(arrays, "cuda")
    tenant = zoo.ZooTenant("check", operands=operands)
    q, kv, w, x1 = (operands[n] for n in ("q", "kv", "w", "x1"))
    attn = ref.attention(q, kv, kv)
    got = tenant.prefill_slab()
    want = ref.matmul(attn.reshape(attn.shape[2], -1), w)
    moved, y = tenant.decode_burst()
    torch.cuda.synchronize()
    if not torch.equal(moved, operands["cache_slab"]):
        raise AssertionError("decode burst: the slab copy differs")
    close("prefill slab", got, want, 2e-2, 0.2)
    close("decode GEMV", y, ref.matmul(x1, w), 2e-2, 0.2)


def check_transformer_tenant(tenant) -> dict:
    """The transformer tenant's payloads by teacher forcing: the burst
    decodes the chunk's last token once more at position 1024, so forward
    over the chunk and that token gives the prefill slab's logits at its
    second-last position and the burst's at its last; all finite, at rtol
    3e-2 and ``bf16_atol`` of the model's depth, as ``phase_model``."""
    model, weights, toks = tenant.model, tenant.weights, tenant.tokens
    atol = bf16_atol(model.cfg.n_layers)
    with torch.inference_mode():
        full = model.forward(weights, {"tokens": torch.cat(
            [toks, toks[:, -1:]], dim=1)})
    return {"atol": atol, "prefill_max_abs_err": close(
                "transformer prefill slab", tenant.prefill_slab()[:, 0],
                full[:, -2], 3e-2, atol),
            "decode_max_abs_err": close(
                "transformer decode burst", tenant.decode_burst()[:, 0],
                full[:, -1], 3e-2, atol)}


def serve_run(path: str, tenants: dict, requests: list, floors: dict,
              **controls) -> dict:
    """One serving run through ``serve.run_zoo``, with every counter reset
    just before it and read just after.  Checks that every admitted request
    completes, every chunk runs once, each kernel launches exactly as often
    as the admitted requests' chunks call it, and every PTT update whose
    leader ran a chunk covers the chunk's kernel time (its tenant's floor).
    Returns kernel -> launches."""
    log = ChunkLog()
    kernels.reset_launch_counts()
    stats = serve.run_zoo(requests, tenants, log=log, timeout_s=300.0,
                          **controls)
    launched = kernels.launch_counts()
    res = stats.result
    by_name = {f"req{r.id}": r for r in requests}
    admitted = [by_name[st.name] for st in res.admitted_dags()]
    undone = [st.name for st in res.admitted_dags() if not st.done]
    if not admitted or undone:
        raise AssertionError(f"{path}: {len(admitted)} admitted, not done: "
                             f"{undone}")
    want = collections.Counter({name: 0 for name in KERNELS})
    prefill = decode_taos = 0
    for r in admitted:
        tenant = tenants[r.tenant]
        n_pre = tenant.prefill_chunks(r)
        n_dec = math.ceil(r.gen_len / DECODE_UNIT)
        prefill += n_pre
        decode_taos += n_dec
        per = chunk_launches(tenant)
        for name, k in per["prefill"].items():
            want[name] += n_pre * k
        for name, k in per["decode"].items():
            want[name] += n_dec * tenant.decode_steps * k
    if launched != dict(want):
        raise AssertionError(f"{path}: launches {launched}, want "
                             f"{dict(want)}")
    if len(log.runs) != prefill + decode_taos or \
            set(log.runs.values()) != {1}:
        raise AssertionError(f"{path}: chunks not each run once")
    flavor_of = {dag_id: tenants[by_name[st.name].tenant].flavor
                 for dag_id, st in res.per_dag.items()}
    records = log.records

    def floor(typ, dag_id):
        # a record is its tenant's chunk; a PTT cell is per type, shared by
        # the tenants, so its floor is the least of theirs
        if dag_id is None:
            return min(f[typ] for f in floors.values())
        return floors[flavor_of[dag_id]][typ]

    idle, below = check_ptt(
        path, records,
        ((typ, leader, width, t) for typ, cells in stats.ptt_profiles.items()
         for (leader, width, *_), t in cells.items()), floor)
    emit({"phase": "serve", "path": path, "requests": len(requests),
          "tenants": {n: t.flavor for n, t in tenants.items()},
          "admitted": len(admitted), "rejected": res.n_rejected,
          "prefill_chunks": prefill, "decode_taos": decode_taos,
          "completed_taos": res.completed, "makespan_s": stats.makespan,
          "tokens_per_s": stats.tokens_per_s,
          "tokens_per_s_by_tenant": stats.tokens_per_s_by_tenant,
          "p99_sojourn_s_by_tenant": stats.p99_by_tenant(),
          "preemptions": res.n_preemptions, "launches": launched,
          "ptt_records": len(records),
          "idle_leader_records": {f"{typ}:w{w}": n for (typ, w), n in sorted(
              collections.Counter((r.cls, r.width) for r in idle).items())},
          "ptt_cells_below_floor_from_idle_leaders": below,
          "ptt_floor_ms": {fl: {t: v * 1e3 for t, v in f.items()}
                           for fl, f in floors.items()},
          "ptt_ms": {typ: {f"{k[0]},w{k[1]}": t * 1e3
                           for k, t in sorted(cells.items())}
                     for typ, cells in stats.ptt_profiles.items()}})
    return launched


def phase_serve(times) -> dict:
    """The serving path through the zoo's JAX pairing at full size: the
    entry point's trace, gate and controller, then a full backlog with
    neither.  Returns path -> kernel -> launches."""
    check_serving_outputs()
    tenants = zoo.default_zoo()
    zoo.warm_zoo(tenants)
    checked = check_transformer_tenant(tenants["steady"])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    floors = serve_floors(times, tenants)
    emit({"phase": "serve_tenants", "tenants": {
        n: t.flavor for n, t in tenants.items()},
        "transformer": tenants["steady"].config.name, **checked})
    return {path: serve_run(path, tenants, trace(), floors, **controls())
            for path, (trace, controls) in serve.PATHS.items()}


def bf16_atol(layers: int) -> float:
    """test_models.py:114-125's bound for bf16 logits after ``layers``
    layers: 4 * 2^-8 * sqrt(4 L + 2), the error of bf16 sums taken in
    another order growing with the number of reductions."""
    return 4 * 2.0 ** -8 * math.sqrt(4 * layers + 2)


def call_launches(cfg) -> tuple[int, int]:
    """(norms, flash attentions) of one forward or prefill of ``cfg``'s
    model; a decode step launches the norms alone.  Two norms a layer and
    the final one (the decoder, the encoder, mamba2's norm and gated norm);
    four a layer for the hybrid (its input, both fused branches and the
    MLP's).  One flash attention a layer, none for the ssm family."""
    L = cfg.n_layers
    norms = (4 if cfg.family == "hybrid" else 2) * L + 1
    return norms, 0 if cfg.family == "ssm" else L


def recompute_launches(cfg) -> tuple[int, int]:
    """(norms, flash attentions) that the backward of one training forward
    of ``cfg``'s model launches: under ``cfg.remat`` each layer runs again
    (``models.layers.remat``), with every norm but the final one, which
    is outside the layers, and every attention; none without."""
    if not cfg.remat:
        return 0, 0
    norms, flash = call_launches(cfg)
    return norms - 1, flash


def step_launches(cfg) -> tuple[int, int]:
    """(norms, flash attentions) of one forward and backward of ``cfg``'s
    loss: the forward's ``call_launches`` and the backward's
    ``recompute_launches``."""
    return tuple(a + b for a, b in zip(call_launches(cfg),
                                       recompute_launches(cfg)))


@contextlib.contextmanager
def act_dtype(dtype):
    """While open, the models compute in ``dtype`` activations (each model
    module's ``ACT_DTYPE``; mamba2's also sets the hybrid's conv cache)."""
    mods = (transformer, mamba2, hybrid)
    before = [m.ACT_DTYPE for m in mods]
    for m in mods:
        m.ACT_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, before):
            m.ACT_DTYPE = d


def teacher_forcing(model, weights, toks, atol: float, steps=None,
                    label: str = MODEL_PATH) -> dict:
    """Prefill of all but the last token, then a decode step of it, against
    forward over all: test_models.py:86-106's check, at rtol 3e-2 and
    ``atol``.  With ``steps`` each call's launches are checked: 2L + 1
    norms each, L flash attentions in forward and prefill."""
    norms, layers = call_launches(model.cfg)

    def run(name, fn, flash):
        before = kernels.launch_counts()
        with torch.inference_mode():
            result = fn()
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if steps is not None:
            if got != {**{k: 0 for k in KERNELS}, "rmsnorm": norms,
                       "flash_attention": flash}:
                raise AssertionError(f"{label} {name}: launches {got}")
            steps[name] = got
        return result

    full = run("forward", lambda: model.forward(weights, {"tokens": toks}),
               layers)
    pre, cache = run("prefill", lambda: make_prefill_step(model)(
        weights, {"tokens": toks[:, :-1]}), layers)
    dec, _ = run("decode_step", lambda: make_decode_step(model)(
        weights, toks[:, -1:], cache), 0)
    return {"atol": atol,
            "prefill_max_abs_err": close("teacher forcing, prefill",
                                         pre[:, 0], full[:, -2], 3e-2, atol),
            "decode_max_abs_err": close("teacher forcing, decode", dec[:, 0],
                                        full[:, -1], 3e-2, atol)}


def check_full_width_on_two_layers() -> dict:
    """llama3.2-1b at its published widths cut to 2 layers, built from one
    set of numpy weights on the card (kernels) and on the CPU (plain
    versions): the logits of a (2, 64) forward at every position, at
    test_models.py:122-125's bf16 formula, rtol 3e-2 and atol
    4 * 2^-8 * sqrt(4 L + 2).  On the card also teacher forcing at the
    flat rtol = atol = 3e-2 that test_models.py:89-97 sets for its 2-layer
    smoke models."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    model = get_model(cfg)
    arrays = numpy_params(model, seed=7)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, MODEL_PROMPT)))
    logits = {}
    for dev in ("cuda", "cpu"):
        weights = model.bf16_copy(params_from_numpy(arrays, dev))
        with torch.inference_mode():
            logits[dev] = model.forward(weights, {"tokens": toks.to(dev)})
        if dev == "cuda":
            tf = teacher_forcing(model, weights, toks.to(dev), 3e-2)
        del weights
    atol = bf16_atol(cfg.n_layers)
    return {"layers": cfg.n_layers, "tokens": list(toks.shape),
            "atol": atol, "max_abs_err": close(
                "2-layer full width, card against CPU", logits["cuda"],
                logits["cpu"], 3e-2, atol), "teacher_forcing": tf,
            "max_row_rms": float(row_rms(logits["cpu"]).max())}


def row_rms(logits: torch.Tensor) -> torch.Tensor:
    """The root mean square of each row of logits (..., V), in fp32."""
    return logits.float().pow(2).mean(-1).sqrt()


def grads_on_both(cfg, seed: int, label: str, routing: bool = False
                  ) -> dict:
    """``cfg``'s loss gradients from one set of fp32 weights
    (``numpy_params(seed)``) and one (2, 64) batch, on the card, where the
    norms and attentions launch the kernels through their autograd
    Functions, and on the CPU (plain versions).  The card's forward must
    launch ``call_launches(cfg)``, its backward ``recompute_launches(cfg)``
    (each layer again under remat), and every parameter
    must get a finite non-zero grad there, but for an encoder on frames the
    token embedding, which its loss does not read: no grad on either
    device.  A frames encoder's batch is (2, 64, d_model) unit normal
    frames in bf16 and targets.  Returns each device's loss and grads and
    the card's launches.

    With ``routing`` (an MoE decoder) a forward on each device first logs
    each layer's router logits (``routing_alike``), and the loss is the
    mean cross-entropy of the tokens that route alike on both: a token that
    the two send to other experts, or whose kept assignments differ, adds
    nothing to either loss."""
    model = get_model(cfg)
    arrays = numpy_params(model, seed=seed)
    rng = np.random.default_rng(9)
    toks, tgts = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, MODEL_PROMPT))) for _ in "tt")
    inputs = {"tokens": toks}
    if cfg.frontend == "frames":
        inputs = {"frames": torch.from_numpy(rng.standard_normal(
            (2, MODEL_PROMPT, cfg.d_model), dtype=np.float32)).bfloat16()}
    out = {"grads": {}, "loss": {}}
    mask = None
    if routing:
        routers = {}
        for dev in ("cuda", "cpu"):
            params = params_from_numpy(arrays, dev)
            with routing_log() as rl, torch.inference_mode():
                model.forward(params, {"tokens": toks.to(dev)})
            routers[dev] = [(c[0].cpu(), c[1], c[2]) for c in rl]
            del params
        mask, out["routing"] = routing_alike(routers["cuda"], routers["cpu"],
                                             label)
    for dev in ("cuda", "cpu"):
        params = {k: v.requires_grad_() for k, v in
                  params_from_numpy(arrays, dev).items()}
        batch = {**{k: v.to(dev) for k, v in inputs.items()},
                 "targets": tgts.to(dev)}
        kernels.reset_launch_counts()
        if mask is None:
            loss, _ = model.loss(params, batch)
        else:
            loss = lm_cross_entropy(model.forward(params, batch),
                                    batch["targets"], onehot=cfg.ce_onehot,
                                    mask=mask.to(dev))
        torch.cuda.synchronize()
        forward = kernels.launch_counts()
        loss.backward()
        torch.cuda.synchronize()
        if dev == "cuda":
            launched = {"forward": forward, "backward": {
                k: n - forward[k] for k, n in kernels.launch_counts().items()}}
            want = {name: 0 for name in KERNELS}
            want["rmsnorm"], want["flash_attention"] = call_launches(cfg)
            back = {name: 0 for name in KERNELS}
            back["rmsnorm"], back["flash_attention"] = \
                recompute_launches(cfg)
            if launched != {"forward": want, "backward": back}:
                raise AssertionError(f"{label}: launches {launched}")
            out["launches"] = launched
        out["loss"][dev] = loss.item()
        out["grads"][dev] = {k: p.grad.float().cpu()
                             for k, p in params.items() if p.grad is not None}
        del params, loss
    torch.cuda.empty_cache()
    unread = {"embed.w"} if cfg.frontend == "frames" else set()
    for dev, grads in out["grads"].items():
        if set(arrays) - set(grads) != unread:
            raise AssertionError(f"{label}: no grad on {dev} for "
                                 f"{sorted(set(arrays) - set(grads))}")
    for name, got in out["grads"]["cuda"].items():
        if not bool(torch.isfinite(got).all()) or not bool(got.abs().max() > 0):
            raise AssertionError(f"{label}: {name} is zero or not finite on "
                                 f"the card")
    return out


def routing_alike(card, cpu, label: str) -> tuple[torch.Tensor, dict]:
    """Two devices' logged ``moe_ffn`` calls (router logits, top_k,
    capacity) of one forward: a (B, S) float mask of the tokens that get
    the same top-k and the same kept assignments in every layer, and what
    it leaves out.  A token whose top-k differs must show a near-tie (its
    boundary gap within twice the largest change of its logits); one whose
    kept assignments alone differ was pushed past the capacity by such a
    token earlier in its row."""
    alike = None
    flipped = 0
    for (got, k, cap), (want, _, _) in zip(card, cpu):
        top = (chosen(got, k) == chosen(want, k)).all(-1)
        near = boundary_gap(want, k) <= 2 * (got - want).abs().amax(-1)
        if bool((~top & ~near).any()):
            raise AssertionError(f"{label}: a token changed its experts "
                                 f"without a near-tie")
        same = top & (kept(got, k, cap) == kept(want, k, cap)).all(-1)
        flipped += int((~top).sum())
        alike = same if alike is None else alike & same
    return alike.float(), {
        "tokens": alike.numel(), "alike": int(alike.sum()),
        "changed_top_k": flipped,
        "router_logits_max_abs_diff": max(
            float((a[0] - b[0]).abs().max()) for a, b in zip(card, cpu))}


def rel_frobenius_vs(grads: dict, want: dict) -> dict:
    """Each parameter's grad against ``want``'s: relative Frobenius."""
    return {k: float((g - want[k]).norm() / want[k].norm())
            for k, g in grads.items()}


def rel_frobenius(grads: dict) -> dict:
    """Each parameter's card grad against the CPU's."""
    return rel_frobenius_vs(grads["cuda"], grads["cpu"])


def phase_grads() -> None:
    """The decoder's loss gradients on the card against the CPU's
    (``grads_on_both``), within a relative Frobenius error of 3e-2 a
    parameter (bf16 activations summed in another order): llama3.2-1b at
    its published widths cut to 2 layers; then moonshot-v1-16b-a3b at its
    widths cut to 1 layer (1.24 B parameters), whose router sends each
    token to 6 of 64 experts.

    moonshot twice, each held at 3e-2.  In its own bf16 activations the
    router logits of the card and the CPU differ by bf16 roundings, which
    sends a token whose 6th and 7th logits lie closer than that to other
    experts on either side; there the two are other functions, so the loss
    leaves such tokens out on both devices (``routing_alike``), and at most
    ``MOVED_SHARE`` of the tokens may go.  With fp32 activations
    (``transformer.ACT_DTYPE``, as the CPU tests run the decoder in fp32)
    the logits agree to fp32 roundings, and every token must route
    alike."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    out = grads_on_both(cfg, 7, "grads")
    rel = rel_frobenius(out["grads"])
    for name, r in rel.items():
        if r > 3e-2:
            raise AssertionError(f"grads: {name} differs from the CPU's by "
                                 f"{r} (relative Frobenius)")
    emit({"phase": "grads", "arch": cfg.name, "layers": cfg.n_layers,
          "tokens": [2, MODEL_PROMPT], "loss": out["loss"],
          "launches": out["launches"], "rel_frobenius_err": rel})
    del out
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=1)
    for act in (torch.bfloat16, torch.float32):
        transformer.ACT_DTYPE = act
        label = f"grads {cfg.name} {act}"
        try:
            out = grads_on_both(cfg, 7, label, routing=True)
        finally:
            transformer.ACT_DTYPE = torch.bfloat16
        routed = out["routing"]
        left_out = 1 - routed["alike"] / routed["tokens"]
        if left_out > MOVED_SHARE or (act == torch.float32 and left_out):
            raise AssertionError(f"{label}: {routed} route alike")
        rel = rel_frobenius(out["grads"])
        for name, r in rel.items():
            if r > 3e-2:
                raise AssertionError(f"{label}: {name} differs from the "
                                     f"CPU's by {r} (relative Frobenius)")
        emit({"phase": "grads", "arch": cfg.name, "layers": cfg.n_layers,
              "params": get_model(cfg).param_count(),
              "activations": str(act).replace("torch.", ""),
              "tokens": [2, MODEL_PROMPT], "loss": out["loss"],
              "routing": routed, "routing_match_share": 1 - left_out,
              "launches": out["launches"], "rel_frobenius_err": rel})
        del out


def train_launches(forwards: int) -> dict:
    """Launches of ``forwards`` forwards and their backwards of the full
    llama3.2-1b through the kernels' Functions (``step_launches``): 2L + 1
    norms and L attentions a forward, and each backward's recompute of
    every layer (remat, the config's default), 2L norms and L attentions;
    none in an update."""
    norms, flash = step_launches(get_config(ARCH))
    want = {name: 0 for name in KERNELS}
    want.update(rmsnorm=forwards * norms, flash_attention=forwards * flash)
    return want


def phase_train() -> dict:
    """train: ``python -m repro_torch.launch.train --arch llama3.2-1b`` at
    full size, every counter reset just before and read just after.  Every
    loss and grad norm finite, the mean loss of the last 3 steps under the
    first's, every parameter moved and every moment non-zero, and exactly
    65 norms and 32 attentions a step (``train_launches``: 33 and 16 in the
    forward, 32 and 16 in the backward's recompute).  Returns kernel ->
    launches."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    out = train.run(ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, lr=TRAIN_LR, device="cuda")
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, gnorms, lrs = out["losses"], out["grad_norms"], out["lrs"]
    step_s = out["step_s"]
    if launched != train_launches(TRAIN_STEPS):
        raise AssertionError(f"{TRAIN_PATH}: launches {launched}, want "
                             f"{train_launches(TRAIN_STEPS)}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses + gnorms).all():
        raise AssertionError(f"{TRAIN_PATH}: losses {losses}, grad norms "
                             f"{gnorms}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"{TRAIN_PATH}: loss did not fall: {losses}")
    opt, params, model = out["opt"], out["params"], out["model"]
    if int(opt.step) != TRAIN_STEPS:
        raise AssertionError(f"{TRAIN_PATH}: AdamW step {int(opt.step)}")
    still = [k for k in params if not (bool(opt.mu[k].any())
                                       and bool(opt.nu[k].any()))]
    if still:
        raise AssertionError(f"{TRAIN_PATH}: zero moments {still}")
    del out, opt
    torch.cuda.empty_cache()
    init = model.init(torch.Generator("cuda").manual_seed(0))
    moved = {k: (params[k] != init[k]).float().mean().item() for k in params}
    if min(moved.values()) == 0.0:
        raise AssertionError(f"{TRAIN_PATH}: a parameter did not move: "
                             f"{moved}")
    del params, init
    torch.cuda.empty_cache()
    state = check_state_bytes(model)
    warm_s = sum(step_s[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"{TRAIN_PATH}: allocated at the start {start / 2 ** 30} GiB, peak "
          f"{peak / 2 ** 30} GiB, {(peak - start) / 2 ** 30} GiB above the "
          f"start", flush=True)
    emit({"phase": "train", "path": TRAIN_PATH, "arch": ARCH,
          "params": model.param_count(), "steps": TRAIN_STEPS,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
          "grad_norms": gnorms, "lrs": lrs, "step_s": step_s,
          "first_step_s": step_s[0],
          "steps_per_s": (TRAIN_STEPS - 1) / warm_s,
          "tokens_per_s": tokens * (TRAIN_STEPS - 1) / warm_s,
          "tokens_per_s_with_first_step": tokens * TRAIN_STEPS / sum(step_s),
          "share_of_elements_moved_least": min(moved.values()),
          "launches": launched, "peak_memory_gib": peak / 2 ** 30,
          "start_allocated_gib": start / 2 ** 30,
          "peak_above_start_gib": (peak - start) / 2 ** 30,
          "state_bytes": state})
    return launched


def check_state_bytes(model) -> dict:
    """The bytes that the card allocates for ``model``'s parameters and
    AdamW state (``init`` and ``adamw_init``, the delta of
    ``memory_allocated``) against the dry run's count of them on one device
    (``dryrun.state_bytes`` at no mesh), within 1% for the allocator's
    rounding of each block."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    del params, opt
    torch.cuda.empty_cache()
    counted = dryrun.state_bytes(model.cfg)
    want = counted["params"] + counted["opt_state"]
    if abs(allocated - want) > 0.01 * want:
        raise AssertionError(f"{TRAIN_PATH}: the card allocates {allocated} "
                             f"bytes of parameters and AdamW state, the dry "
                             f"run counts {counted}")
    return {"allocated": allocated, "dry_run": counted,
            "rel_err": (allocated - want) / want}


def phase_train_vs_cpu() -> None:
    """Two train steps of llama3.2-1b at its published widths cut to 2
    layers, on one set of fp32 weights (``numpy_params``) and the launcher's
    first two batches at phase_grads' size (2 x 64), on the card (the
    kernels through their Functions) and on the CPU (plain versions): loss
    and grad norm of each step within 3e-2 relative (bf16 activations
    summed in another order, phase_grads' bound), the lr equal."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    model = get_model(cfg)
    arrays = numpy_params(model, seed=7)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=MODEL_PROMPT,
                       global_batch=2)
    steps = 2
    sched = cosine_schedule(TRAIN_LR, warmup_steps=max(steps // 20, 2),
                            total_steps=steps)
    runs = {}
    for dev in ("cuda", "cpu"):
        step = make_train_step(model, lr_schedule=sched)
        params = params_from_numpy(arrays, dev)
        opt = adamw_init(params)
        kernels.reset_launch_counts()
        metrics = []
        for s in range(steps):
            params, opt, m = step(params, opt, data.batch(s, device=dev))
            metrics.append({k: m[k].item() for k in ("loss", "grad_norm",
                                                     "lr")})
        if dev == "cuda":
            torch.cuda.synchronize()
            want = {name: 0 for name in KERNELS}
            norms, flash = step_launches(cfg)
            want.update(rmsnorm=steps * norms, flash_attention=steps * flash)
            if kernels.launch_counts() != want:
                raise AssertionError(f"train_vs_cpu: launches "
                                     f"{kernels.launch_counts()}")
        runs[dev] = {"metrics": metrics,
                     "params": {k: v.cpu() for k, v in params.items()}}
        del params, opt
    torch.cuda.empty_cache()
    rel = {"loss": [], "grad_norm": []}
    for got, want in zip(runs["cuda"]["metrics"], runs["cpu"]["metrics"]):
        for k in rel:
            rel[k].append(abs(got[k] - want[k]) / abs(want[k]))
        if not (max(rel["loss"][-1], rel["grad_norm"][-1]) <= 3e-2
                and math.isfinite(got["loss"])) or \
                abs(got["lr"] - want["lr"]) > 1e-6 * want["lr"]:
            raise AssertionError(f"train_vs_cpu: card {got}, CPU {want}")
    params_rel = max(float((runs["cuda"]["params"][k] - p).norm() / p.norm())
                     for k, p in runs["cpu"]["params"].items())
    emit({"phase": "train_vs_cpu", "arch": cfg.name, "layers": cfg.n_layers,
          "tokens": [2, MODEL_PROMPT], "steps": steps,
          "card": runs["cuda"]["metrics"], "cpu": runs["cpu"]["metrics"],
          "rel_err": rel, "params_max_rel_frobenius_err": params_rel})


def phase_train_orchestrated() -> dict:
    """train_orchestrated: ``launch.train --orchestrate --microbatches 2``
    at full size for 4 steps, every counter reset just before and read just
    after: 4 x (2 + 2) TAOs, finite losses, exactly 8 forwards' launches;
    the final params within 1e-5 relative Frobenius of a sequential run of
    the same grads and updates (with 2 microbatches the sums are the same
    in either order, so a larger gap means a stream read before its work
    was done).  Returns kernel -> launches."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.run(ARCH, steps=ORCH_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    lr=TRAIN_LR, orchestrate=True, microbatches=MICROBATCHES,
                    device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = out["stats"]
    if launched != train_launches(ORCH_STEPS * MICROBATCHES):
        raise AssertionError(f"{ORCH_TRAIN_PATH}: launches {launched}")
    if stats["completed"] != ORCH_STEPS * (MICROBATCHES + 2):
        raise AssertionError(f"{ORCH_TRAIN_PATH}: {stats['completed']} TAOs")
    losses = stats["losses"]
    if len(losses) != ORCH_STEPS * MICROBATCHES or \
            not np.isfinite(losses).all():
        raise AssertionError(f"{ORCH_TRAIN_PATH}: losses {losses}")
    got = {k: v.cpu() for k, v in out["params"].items()}
    model = out["model"]
    del out
    torch.cuda.empty_cache()
    # the sequential run: the same batches, grads summed in microbatch
    # order and averaged, AdamW at the constant lr without clipping
    params = model.init(torch.Generator("cuda").manual_seed(0))
    opt = adamw_init(params)
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH)
    for mbs in train.microbatch_batches(data, 0, ORCH_STEPS, MICROBATCHES,
                                        "cuda"):
        grads = None
        for mb in mbs:
            g, _ = loss_and_grads(model, params, mb)
            grads = g if grads is None else {k: grads[k] + g[k] for k in g}
            del g
        grads = {k: g / len(mbs) for k, g in grads.items()}
        params, opt = adamw_update(params, grads, opt, lr=TRAIN_LR)
        del grads
    rel = {k: float((got[k] - p.cpu()).norm() / p.cpu().norm())
           for k, p in params.items()}
    del params, opt
    torch.cuda.empty_cache()
    if max(rel.values()) > 1e-5:
        raise AssertionError(f"{ORCH_TRAIN_PATH}: params differ from the "
                             f"sequential run's: {rel}")
    widths = stats["widths"]
    emit({"phase": "train_orchestrated", "path": ORCH_TRAIN_PATH,
          "arch": ARCH, "steps": ORCH_STEPS, "microbatches": MICROBATCHES,
          "completed_taos": stats["completed"],
          "elapsed_s": stats["elapsed_s"], "wall_s": wall, "losses": losses,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * ORCH_STEPS
          / stats["elapsed_s"],
          "params_rel_frobenius_err_vs_sequential": rel,
          "ptt_fwdbwd_ms": {f"{leader},w{widths[wi]}": t * 1e3
                            for leader, row in enumerate(
                                stats["ptt"]["fwdbwd"])
                            for wi, t in enumerate(row) if t > 0},
          "launches": launched, "peak_memory_gib": peak / 2 ** 30})
    return launched


def phase_checkpoint() -> None:
    """Checkpointing on the card, the smoke llama3.2-1b at head_dim 64 (a
    size the flash kernel takes; the layout does not depend on width), into
    a temporary directory that is deleted after: 4 straight steps against 2
    steps, a save, a restore and 2 more, within 1e-6; then an async save
    from the card, with a bf16 copy of the weights beside the fp32 state,
    restored on the CPU to byte-equal leaves."""
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(ARCH), head_dim=64)
    model = get_model(cfg)
    step = make_train_step(model, lr_schedule=1e-3)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=2).batch(0, device="cuda")
    p0 = model.init(torch.Generator("cuda").manual_seed(0))
    o0 = adamw_init(p0)
    ps, os_ = p0, o0
    for _ in range(4):
        ps, os_, _ = step(ps, os_, batch)
    with tempfile.TemporaryDirectory() as tmp:
        pa, oa = p0, o0
        for _ in range(2):
            pa, oa, _ = step(pa, oa, batch)
        mgr = CheckpointManager(tmp)
        mgr.save(2, {"params": pa, "opt": oa})
        _, restored = mgr.restore({"params": p0, "opt": o0})
        pb, ob = restored["params"], restored["opt"]
        for _ in range(2):
            pb, ob, _ = step(pb, ob, batch)
        resume_err = max((pb[k] - ps[k]).abs().max().item() for k in ps)
        if resume_err > 1e-6 or int(ob.step) != 4:
            raise AssertionError(f"checkpoint: the resumed run differs by "
                                 f"{resume_err}")
        tree = {"params": pb, "opt": ob, "weights": model.bf16_copy(pb)}
        mgr.async_save(4, tree)
        mgr.wait()

        def template(x):
            if isinstance(x, dict):
                return {k: template(v) for k, v in x.items()}
            if dataclasses.is_dataclass(x):
                return type(x)(**{f.name: template(getattr(x, f.name))
                                  for f in dataclasses.fields(x)})
            return Template(tuple(x.shape), x.dtype, "cpu")

        step_no, on_cpu = mgr.restore(template(tree))
        pairs = [(on_cpu[g][k], tree[g][k]) for g in ("params", "weights")
                 for k in tree[g]]
        pairs += [(on_cpu["opt"].step, ob.step)] + [
            (getattr(on_cpu["opt"], f)[k], getattr(ob, f)[k])
            for f in ("mu", "nu") for k in ob.mu]
        for got, want in pairs:
            if got.device.type != "cpu" or got.dtype != want.dtype or \
                    not torch.equal(got, want.cpu()):
                raise AssertionError("checkpoint: a leaf restored on the CPU "
                                     "differs from the card's")
        leaves = len(json.loads((Path(tmp) / "step_00000004" /
                                 "MANIFEST.json").read_text())["leaves"])
        kept = mgr.steps()
    emit({"phase": "checkpoint", "arch": cfg.name, "head_dim": cfg.hd,
          "resume_max_abs_err": resume_err, "restored_step": step_no,
          "leaves_card_to_cpu": leaves, "byte_equal_pairs": len(pairs),
          "kept_steps": kept})


def check_arch_run(path: str, out: dict, launched: dict) -> None:
    """``run_arch``'s run with ``orchestrate``: every TAO of the 4 x batch
    requests completed, and each kernel launched exactly as often as its
    calls: 2L + 1 norms in each prefill and decode step, L flash attentions
    in each prefill (the batch's, then one a request), none in a decode
    step (``call_launches``: 4L + 1 norms for the hybrid, and no flash
    attention for the ssm family); the prefill's logits finite."""
    cfg, stats = out["model"].cfg, out["stats"]
    batch, gen = out["out_tokens"].shape
    n_prefill = batch * 4                        # the orchestrated requests
    n_decode = stats.result.completed - n_prefill
    if stats.result.completed != n_prefill * (1 + math.ceil(
            gen / DECODE_UNIT)):
        raise AssertionError(f"{path}: {stats.result.completed} TAOs")
    norms, layers = call_launches(cfg)
    want = {name: 0 for name in KERNELS}
    want["rmsnorm"] = norms * (1 + gen + n_prefill + n_decode)
    want["flash_attention"] = layers * (1 + n_prefill)
    if launched != want:
        raise AssertionError(f"{path}: launches {launched}, want {want}")
    if not bool(torch.isfinite(out["logits"].float()).all()):
        raise AssertionError(f"{path}: logits not finite")


def phase_model() -> dict:
    """serve:model: ``python -m repro_torch.launch.serve --arch llama3.2-1b
    --orchestrate`` at full size, every counter reset just before and read
    just after; then teacher forcing on the card at full depth, and the
    card against the CPU at full width and 2 layers.  Returns kernel ->
    launches of the run, and the largest row RMS of the 2-layer logits
    that ``bf16_atol(2)`` held (``moe_teacher_forcing`` scales from it)."""
    kernels.reset_launch_counts()
    out = serve.run_arch(ARCH, orchestrate=True, device="cuda")
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    check_arch_run(MODEL_PATH, out, launched)
    model, weights, toks = out["model"], out["weights"], out["tokens"]
    cfg, stats = model.cfg, out["stats"]
    batch, prompt = toks.shape
    gen = out["out_tokens"].shape[1]
    # teacher forcing at full depth, each call's launches counted on its
    # own.  The flat 3e-2 of test_models.py:89-97 is set for 2 layers; at 16
    # the decode path's error on an H100 reached 0.0791, so the check takes
    # the same file's bound for depth L (:114-125)
    steps = {}
    tf = teacher_forcing(model, weights, toks, bf16_atol(cfg.n_layers),
                         steps)
    params = model.param_count()
    times = {"prefill_s": out["prefill_s"], "decode_s": out["decode_s"]}
    del out, weights
    torch.cuda.empty_cache()
    parity = check_full_width_on_two_layers()
    emit({"phase": "model", "path": MODEL_PATH, "arch": cfg.name,
          "params": params, "layers": cfg.n_layers, "batch": batch,
          "prompt": prompt, "gen": gen,
          **times,
          "orchestrated_taos": stats.result.completed,
          "orchestrated_tokens_per_s": stats.tokens_per_s,
          "orchestrated_p99_sojourn_s": stats.p99_latency,
          "launches": launched, "launches_per_call": steps,
          "teacher_forcing": tf, "two_layer_card_vs_cpu": parity,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launched, parity["max_row_rms"]


# ------------------------------------------------------------- the moe phase
@contextlib.contextmanager
def routing_log():
    """While open, each call of the decoder's ``moe_ffn`` (one a layer, in
    order) is noted as (its router logits (B, S, E) fp32, top_k,
    capacity), computed as ``moe_ffn`` computes them, on the same inputs.
    Instrumentation of the checks: the main runs go without it."""
    calls, inner = [], transformer.moe_ffn

    def logged(x, router_w, *weights, n_experts, top_k, capacity, **kw):
        calls.append((torch.einsum("bsm,me->bse", x.float(),
                                   router_w.float()), top_k, capacity))
        return inner(x, router_w, *weights, n_experts=n_experts,
                     top_k=top_k, capacity=capacity, **kw)

    transformer.moe_ffn = logged
    try:
        yield calls
    finally:
        transformer.moe_ffn = inner


def chosen(logits: torch.Tensor, k: int) -> torch.Tensor:
    """(B, S, E) bool: the k experts of each token's top-k."""
    sel = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    return sel.scatter_(-1, logits.topk(k, dim=-1).indices, True)


def kept(logits: torch.Tensor, k: int, capacity: int) -> torch.Tensor:
    """(B, S, E) bool: the assignments that the capacity keeps.  Another
    form of moe_ffn's rule: a token's assignment to expert e is kept when
    fewer than ``capacity`` tokens before it in its row chose e."""
    sel = chosen(logits, k)
    return sel & (sel.long().cumsum(dim=1) <= capacity)


def boundary_gap(logits: torch.Tensor, k: int) -> torch.Tensor:
    """(B, S): the k-th largest logit less the (k+1)-th."""
    top = logits.topk(k + 1, dim=-1).values
    return top[..., k - 1] - top[..., k]


def drop_share(calls) -> dict:
    """The share of the logged calls' assignments that the capacity drops,
    over all layers and by layer."""
    by_layer = []
    dropped = total = 0
    for logits, k, cap in calls:
        n_sel = logits.shape[0] * logits.shape[1] * k
        n_drop = n_sel - int(kept(logits, k, cap).sum())
        by_layer.append(n_drop / n_sel)
        dropped, total = dropped + n_drop, total + n_sel
    return {"share": dropped / total, "by_layer": by_layer,
            "capacity": calls[0][2]}


def moe_teacher_forcing(model, weights, toks, prompt: int,
                        ref_rms: float) -> dict:
    """Teacher forcing of an MoE decoder on the card: forward over ``toks``
    (B, T) against prefill of the first ``prompt`` tokens (its last logits)
    and a decode step of each token after (each step's logits); for a
    sliding-window model, once through the shifted cache and once through
    the ring buffer.  ``model`` routes at capacity_factor = E / k, so that
    nothing drops: forward over T tokens routes at moe_capacity(T) and
    prefill at moe_capacity(prompt), and where assignments drop those are
    other functions, in the reference as much as in the port.

    Twice, elementwise.  In fp32 activations (``transformer.ACT_DTYPE``)
    at rtol = atol = 1e-3.  Then in the model's bf16 at rtol 3e-2 and an
    atol measured on the same rows: the median over the compared positions
    of the row's largest |bf16 forward - fp32 forward|, the error that bf16
    itself gives this forward.  The cached paths are another bf16
    evaluation of the same function, and may differ from the forward by no
    more than that.  For the record it also counts the elements over
    test_models.py:114-125's bf16_atol(L) scaled by the row's logit RMS
    over ``ref_rms`` (the largest row RMS of llama3.2-1b's logits at full
    width and 2 layers, where that bound holds on the card): the formula
    counts 4 bf16 reductions a dense layer, and mixtral's MoE layers at
    d_model 6144 and d_ff 16384 round more than that.

    A token is compared where both calls give it the same top-k in every
    layer.  bf16 sums taken in another order move the router logits by a
    little, which sends a token whose k-th and (k+1)-th logits lie closer
    than that to another expert: such a token must show that near-tie (its
    boundary gap within twice the largest change of its logits), and as in
    ``check_moe_ffn`` at most 0.5% of the tokens may move (in fp32 none)."""
    out, fp32_full = {}, None
    for act in (torch.float32, torch.bfloat16):
        transformer.ACT_DTYPE = act
        try:
            out[str(act).replace("torch.", "")], full = _moe_teacher_forcing(
                model, weights, toks, prompt, act, ref_rms, fp32_full)
        finally:
            transformer.ACT_DTYPE = torch.bfloat16
        fp32_full = full.float()
    return out


def _moe_teacher_forcing(model, weights, toks, prompt: int, act,
                         ref_rms: float, fp32_full) -> tuple[dict, torch.Tensor]:
    cfg = model.cfg
    k = cfg.experts_per_token
    formula = bf16_atol(cfg.n_layers)
    with routing_log() as calls, torch.inference_mode():
        full = model.forward(weights, {"tokens": toks})
    f_logits = [c[0] for c in calls]
    if act == torch.float32:
        atol = 1e-3
    else:
        noise = (full[:, prompt - 1:].float() - fp32_full[:, prompt - 1:])
        atol = float(noise.abs().amax(-1).median())
    rows = []  # (variant, position, logits (B, V), router logits a layer)
    variants = {"positional" if cfg.window is None else "shifted": model}
    if cfg.window is not None:
        variants["ring"] = get_model(dataclasses.replace(
            cfg, swa_ring_buffer=True))
    for name, m in variants.items():
        with routing_log() as calls:
            pre, cache = make_prefill_step(m)(
                weights, {"tokens": toks[:, :prompt]})
        rows.append((name, prompt - 1, pre[:, 0],
                     [c[0][:, -1] for c in calls]))
        for i in range(prompt, toks.shape[1]):
            with routing_log() as calls:
                dec, cache = make_decode_step(m)(weights, toks[:, i:i + 1],
                                                 cache)
            rows.append((name, i, dec[:, 0], [c[0][:, 0] for c in calls]))
        if cfg.window is not None and cache["k"].shape[3] != cfg.window:
            raise AssertionError(f"{name}: the cache did not roll")
    worst, compared, moved, over = 0.0, 0, [], 0
    for name, i, logits, routers in rows:
        same = torch.ones(toks.shape[0], dtype=torch.bool, device=toks.device)
        for got, want in zip(routers, (f[:, i] for f in f_logits)):
            alike = (chosen(got, k) == chosen(want, k)).all(-1)
            same &= alike
            near = boundary_gap(want, k) <= 2 * (got - want).abs().amax(-1)
            if bool((~alike & ~near).any()):
                raise AssertionError(f"{name} at {i}: a token changed its "
                                     f"experts without a near-tie")
        for b in range(toks.shape[0]):
            if not bool(same[b]):
                moved.append(f"{name}:{b}@{i}")
                continue
            got, want = logits[b].float().cpu(), full[b, i].float().cpu()
            rtol = 1e-3 if act == torch.float32 else 3e-2
            worst = max(worst, close(f"teacher forcing {act}, {name}, row "
                                     f"{b} at {i}", got, want, rtol, atol))
            scaled = formula * max(1.0, float(row_rms(want)) / ref_rms)
            over += int(((got - want).abs()
                         > scaled + 3e-2 * want.abs()).sum())
            compared += 1
    share = len(moved) / (compared + len(moved))
    if share > 5e-3 or (act == torch.float32 and moved):
        raise AssertionError(f"teacher forcing {act}: {len(moved)} tokens "
                             f"changed experts, {compared} compared")
    return {"variants": list(variants), "capacity_factor":
            cfg.capacity_factor, "compared": compared,
            "routing_match_share": 1 - share, "changed_experts": moved,
            "max_abs_err": worst, "atol": atol, "rtol": rtol,
            "elements_over_rms_scaled_bf16_atol": over,
            "bf16_atol": formula, "ref_rms": ref_rms}, full


def patch_loss(model, weights) -> float:
    """internvl2's loss over PATCH_BATCH rows of its n_patches patch
    embeddings and 64 tokens: finite and positive, its patch positions
    masked out."""
    cfg = model.cfg
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PATCH_BATCH, PATCH_SEQ))).cuda()
    pe = torch.from_numpy(rng.standard_normal(
        (PATCH_BATCH, cfg.n_patches, cfg.d_model), dtype=np.float32))
    with torch.inference_mode():
        loss, _ = model.loss(weights, {"tokens": toks, "targets": toks,
                                       "patch_embeds": pe.cuda()})
    loss = loss.item()
    if not (math.isfinite(loss) and loss > 0):
        raise AssertionError(f"internvl2 loss with patch_embeds: {loss}")
    return loss


def serve_arch_path(path: str, ref_rms: float) -> dict:
    """One moe-phase run: ``run_arch`` with ``orchestrate`` on MOE_RUNS'
    config, every counter reset just before and read just after, held by
    ``check_arch_run``; then on its weights the checks of its kind: an MoE
    decoder's prefill drop share and teacher forcing without drops (past
    the window for mixtral; ``ref_rms`` as ``moe_teacher_forcing`` takes
    it), internvl2's teacher forcing at full depth with
    each call's launches and its loss with patch_embeds.  Returns kernel ->
    launches of the run."""
    run = serve.arch_run(path)
    cfg, batch, prompt, gen = (run[k] for k in ("config", "batch",
                                                "prompt_len", "gen"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = serve.run_arch(**run, device="cuda")
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_arch_run(path, out, launched)
    model, weights, toks, stats = (out[k] for k in ("model", "weights",
                                                    "tokens", "stats"))
    line = {"phase": "moe", "path": path, "arch": cfg.name,
            "params": model.param_count(),
            "active_params": model.active_param_count(),
            "layers": cfg.n_layers, "published_layers":
            get_config(run["arch"]).n_layers, "batch": batch,
            "prompt": prompt,
            "gen": gen, "prefill_s": out["prefill_s"],
            "decode_s": out["decode_s"],
            "decode_tokens_per_s": batch * gen / out["decode_s"],
            "cache_slots": out["cache"]["k"].shape[3],
            "orchestrated_taos": stats.result.completed,
            "orchestrated_tokens_per_s": stats.tokens_per_s,
            "orchestrated_p99_sojourn_s": stats.p99_latency,
            "launches": launched, "peak_memory_gib": peak / 2 ** 30}
    del out
    if cfg.is_moe:
        with routing_log() as calls:
            make_prefill_step(model)(weights, {"tokens": toks})
        line["prefill_drops"] = drop_share(calls)
        del calls
        free = get_model(dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token))
        more = torch.from_numpy(np.random.default_rng(14).integers(
            0, cfg.vocab_size, (batch, TF_DECODE[path]))).cuda()
        line["teacher_forcing"] = moe_teacher_forcing(
            free, weights, torch.cat([toks, more], dim=1), prompt, ref_rms)
    else:
        steps = {}
        line["teacher_forcing"] = teacher_forcing(
            model, weights, toks, bf16_atol(cfg.n_layers), steps, label=path)
        line["launches_per_call"] = steps
        line["patch_loss"] = patch_loss(model, weights)
    del weights
    torch.cuda.empty_cache()
    emit(line)
    return launched


def check_moe_ffn() -> None:
    """``moe_ffn`` on the card against the CPU at both published widths,
    one layer's weights (fp32, ``numpy_params``) and bf16 inputs (unit
    normal draws, as a norm gives them) identical on both: mixtral's at 256
    tokens (its CPU products are slow, its fp32 experts ~10 GB of host
    memory), moonshot's at 512, each at its config's capacity.  Two card
    runs give the same bits.  The share of tokens whose top-k set differs
    (near-ties of the router, whose fp32 sums run in another order) must
    stay under 0.5%; a token whose kept assignments agree (kept: the
    capacity rule in another form) is compared at rtol 3e-2 and atol 1e-2
    of the largest output, bf16's tolerance."""
    for arch, tokens in (("mixtral-8x22b", 256),
                         ("moonshot-v1-16b-a3b", 512)):
        cfg = dataclasses.replace(get_config(arch), n_layers=1)
        defs = {n: d for n, d in get_model(cfg).param_defs().items()
                if n.startswith("layers.moe.")}
        arrays = numpy_params(SimpleNamespace(param_defs=lambda: defs), 11)
        x = torch.from_numpy(np.random.default_rng(12).standard_normal(
            (1, tokens, cfg.d_model), dtype=np.float32)).bfloat16()
        kw = dict(n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
                  capacity=cfg.moe_capacity(tokens))
        names = ("router", "experts.w1", "experts.w3", "experts.w2")
        out, logits, seconds = {}, {}, {}
        for dev in ("cuda", "cpu"):
            ws = [torch.from_numpy(arrays[f"layers.moe.{n}"][0]).to(dev)
                  for n in names]
            xd = x.to(dev)
            t0 = time.perf_counter()
            out[dev] = moe_ffn(xd, *ws, **kw)
            if dev == "cuda":
                torch.cuda.synchronize()
                if not torch.equal(moe_ffn(xd, *ws, **kw), out[dev]):
                    raise AssertionError(f"{arch} moe_ffn: two card runs "
                                         f"differ")
            seconds[dev] = time.perf_counter() - t0
            logits[dev] = torch.einsum("bsm,me->bse", xd.float(),
                                       ws[0].float()).cpu()
            out[dev] = out[dev].float().cpu()
            del ws, xd
        del arrays
        torch.cuda.empty_cache()
        k = cfg.experts_per_token
        flipped = ~(chosen(logits["cuda"], k) == chosen(logits["cpu"], k)
                    ).all(-1)
        same = (kept(logits["cuda"], k, kw["capacity"])
                == kept(logits["cpu"], k, kw["capacity"])).all(-1)
        share = float(flipped.float().mean())
        if share > 5e-3:
            raise AssertionError(f"{arch} moe_ffn: {share} of tokens change "
                                 f"experts between the card and the CPU")
        atol = 1e-2 * float(out["cpu"].abs().max())
        err = close(f"{arch} moe_ffn, card against CPU", out["cuda"][same],
                    out["cpu"][same], 3e-2, atol)
        emit({"phase": "moe_ffn", "arch": arch, "tokens": tokens,
              "capacity": kw["capacity"], "experts": cfg.n_experts,
              "top_k": k, "changed_top_k_share": share,
              "tokens_compared": int(same.sum()),
              "drop_share_cpu": 1 - float(
                  kept(logits["cpu"], k, kw["capacity"]).sum())
              / (tokens * k),
              "max_abs_err": err, "atol": atol, "bit_equal_card_runs": True,
              "card_s_first_call": seconds["cuda"],
              "cpu_s": seconds["cpu"]})


def phase_moe(ref_rms: float) -> dict:
    """The moe phase: each of MOE_RUNS (``serve_arch_path``; ``ref_rms``
    for its teacher forcing), then ``check_moe_ffn``.  Returns path ->
    kernel -> launches."""
    launches = {path: serve_arch_path(path, ref_rms) for path in MOE_RUNS}
    check_moe_ffn()
    return launches


# -------------------------------------------------------- the families phase
def family_teacher_forcing(model, weights, toks, prompt: int) -> dict:
    """Teacher forcing of mamba2 or hymba on the card: forward over ``toks``
    (B, T) against prefill of the first ``prompt`` tokens (its last logits)
    and a decode step of each token after (each step's logits).  mamba2's
    prompt ends in a padded chunk and its steps cross the forward's chunk
    edge at 1024; hymba's prompt passes its window, so its windowed layers
    decode through the rolling cache and its global ones through the
    positional one.

    Twice, elementwise.  In fp32 activations the cached paths against the
    forward at rtol = atol = 1e-3.  In the model's bf16 the cached paths
    against the fp32 forward at rtol 3e-2 and, as atol, the largest
    |bf16 forward - fp32 forward| over the same rows: the cached paths are
    another bf16 evaluation of the same function, and may stray from the
    fp32 result no further than the bf16 forward does.  For the record it
    also gives ``moe_teacher_forcing``'s form (bf16 cached paths against
    the bf16 forward, atol the median over the rows of each row's largest
    such error): both sides of that err, so it can read up to twice the
    bf16 error, and mamba2's 48 layers erred 0.197 there against 0.173 on
    an H100."""
    cfg = model.cfg
    out, fp32_full = {}, None
    for act in (torch.float32, torch.bfloat16):
        with act_dtype(act):
            with torch.inference_mode():
                full = model.forward(weights, {"tokens": toks})
            pre, cache = make_prefill_step(model)(
                weights, {"tokens": toks[:, :prompt]})
            if cfg.family == "hybrid":
                slots = [k.shape[2] for k in cache["k"]]
                want = [prompt + 64 if model.window(i) is None else
                        cfg.window for i in range(cfg.n_layers)]
                if slots != want:
                    raise AssertionError(f"{cfg.name}: cache slots {slots}")
            rows = [(prompt - 1, pre[:, 0])]
            for i in range(prompt, toks.shape[1]):
                dec, cache = make_decode_step(model)(
                    weights, toks[:, i:i + 1], cache)
                rows.append((i, dec[:, 0]))
        name = str(act).replace("torch.", "")
        if act == torch.float32:
            fp32_full = full.float()
            out[name] = {"rtol": 1e-3, "atol": 1e-3, "max_abs_err": max(
                close(f"{cfg.name} teacher forcing fp32 at {i}", logits,
                      full[:, i], 1e-3, 1e-3) for i, logits in rows)}
        else:
            noise = (full[:, prompt - 1:].float()
                     - fp32_full[:, prompt - 1:]).abs().amax(-1)
            atol = float(noise.max())
            err = max(close(f"{cfg.name} teacher forcing bf16 at {i}",
                            logits, fp32_full[:, i], 3e-2, atol)
                      for i, logits in rows)
            against_bf16 = max(float((logits.float() - full[:, i].float())
                                     .abs().max()) for i, logits in rows)
            out[name] = {"rtol": 3e-2, "atol": atol,
                         "max_abs_err_vs_fp32_forward": err,
                         "max_abs_err_vs_bf16_forward": against_bf16,
                         "bf16_forward_err_median_row_max":
                         float(noise.median())}
        out[name]["decode_steps"] = len(rows) - 1
        del full, rows, cache
    return out


def serve_family_path(path: str) -> dict:
    """One families-phase run: ``run_arch`` with ``orchestrate`` on
    FAMILY_RUNS' config (mamba2-780m or hymba-1.5b whole), every counter
    reset just before and read just after, held by ``check_arch_run``;
    then teacher forcing on its weights.  Returns kernel -> launches of the
    run."""
    run = serve.arch_run(path)
    cfg, batch, prompt, gen = (run[k] for k in ("config", "batch",
                                                "prompt_len", "gen"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = serve.run_arch(**run, device="cuda")
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_arch_run(path, out, launched)
    model, weights, toks, stats = (out[k] for k in ("model", "weights",
                                                    "tokens", "stats"))
    line = {"phase": "families", "path": path, "arch": cfg.name,
            "params": model.param_count(), "layers": cfg.n_layers,
            "batch": batch, "prompt": prompt, "gen": gen,
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "decode_tokens_per_s": batch * gen / out["decode_s"],
            "orchestrated_taos": stats.result.completed,
            "orchestrated_tokens_per_s": stats.tokens_per_s,
            "orchestrated_p99_sojourn_s": stats.p99_latency,
            "launches": launched, "peak_memory_gib": peak / 2 ** 30}
    del out, stats
    more = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (batch, TF_FAMILY[path]))).cuda()
    line["teacher_forcing"] = family_teacher_forcing(
        model, weights, torch.cat([toks, more], dim=1), prompt)
    del weights
    torch.cuda.empty_cache()
    emit(line)
    return launched


def encode_path() -> dict:
    """encode:hubert: ``serve.run_encode`` on hubert-xlarge whole (4 clips
    of 500 frames of ``SyntheticFrames(seed=0)``), every counter reset just
    before and read just after: 2L + 1 norms and L flash attentions, the
    logits (4, 500, 504) finite.  Then ENCODE_TRAIN_STEPS steps of
    ``make_train_step`` on that batch at full size from fp32 masters
    (seed 0): each step's forward launches the same and its backward's
    recompute 2L norms and L attentions more (``step_launches``), losses
    finite, every parameter moved.  Returns kernel -> launches of the
    encode."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = serve.run_encode(ENCODE_PATH, device="cuda")
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    model, batch, logits = out["model"], out["batch"], out["logits"]
    cfg = model.cfg
    want = {name: 0 for name in KERNELS}
    want["rmsnorm"], want["flash_attention"] = call_launches(cfg)
    if launched != want:
        raise AssertionError(f"{ENCODE_PATH}: launches {launched}, want "
                             f"{want}")
    shape = (*batch["frames"].shape[:2], cfg.padded_vocab)
    if tuple(logits.shape) != shape or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{ENCODE_PATH}: logits {tuple(logits.shape)} "
                             f"not finite or not {shape}")
    line = {"phase": "families", "path": ENCODE_PATH, "arch": cfg.name,
            "params": model.param_count(), "layers": cfg.n_layers,
            "frames": list(batch["frames"].shape), "encode_s":
            out["encode_s"][-1], "frames_per_s": shape[0] * shape[1]
            / out["encode_s"][-1], "launches": launched,
            "encode_peak_memory_gib": torch.cuda.max_memory_allocated()
            / 2 ** 30}
    del out, logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    start = {k: v.clone() for k, v in params.items()}
    opt = adamw_init(params)
    step = make_train_step(model, lr_schedule=TRAIN_LR)
    want_step = {name: 0 for name in KERNELS}
    want_step["rmsnorm"], want_step["flash_attention"] = step_launches(cfg)
    losses, step_s, per_step = [], [], []
    for _ in range(ENCODE_TRAIN_STEPS):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(metrics["loss"].item())
        step_s.append(time.perf_counter() - t0)
        per_step.append(kernels.launch_counts())
    if any(n != want_step for n in per_step) or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{ENCODE_PATH} train: launches {per_step}, "
                             f"losses {losses}")
    still = [k for k, v in params.items() if torch.equal(v, start[k])]
    if still:
        raise AssertionError(f"{ENCODE_PATH} train: {still} did not move")
    line.update(train_steps=ENCODE_TRAIN_STEPS, train_losses=losses,
                train_step_s=step_s, train_launches_per_step=per_step[0],
                train_peak_memory_gib=torch.cuda.max_memory_allocated()
                / 2 ** 30)
    del params, start, opt
    torch.cuda.empty_cache()
    emit(line)
    return launched


def family_card_vs_cpu(arch: str) -> dict:
    """``arch`` at its published widths cut to 2 layers (hymba: layer 0
    global, layer 1 windowed), one set of numpy weights (``numpy_params``)
    on the card (kernels) and on the CPU (plain versions).  The fp32
    forward over PARITY_TOKENS[arch] elementwise at rtol = atol = 1e-3;
    the card's bf16 forward over (2, 64) against the CPU's fp32 forward at
    rtol 3e-2 and, as atol, the CPU's own largest |bf16 - fp32| over the
    rows (the card's bf16 may stray from the fp32 result no further than
    the CPU's bf16 does; against the CPU's bf16, both sides err, and
    hymba's card and CPU differed by 0.047 where the CPU's median row
    error was 0.037 on an H100); the loss grads over (2, 64)
    (``grads_on_both``) within 3e-2 relative Frobenius a parameter."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    model = get_model(cfg)
    arrays = numpy_params(model, seed=7)
    rng = np.random.default_rng(8)

    def inputs(b, s):
        if cfg.frontend == "frames":
            return {"frames": torch.from_numpy(rng.standard_normal(
                (b, s, cfg.d_model), dtype=np.float32)).bfloat16()}
        return {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, s)))}

    batches = {torch.float32: inputs(*PARITY_TOKENS[arch]),
               torch.bfloat16: inputs(2, MODEL_PROMPT)}
    logits = {}
    for dev in ("cuda", "cpu"):
        weights = model.bf16_copy(params_from_numpy(arrays, dev))
        for act, batch in batches.items():
            acts = (act,) if act == torch.float32 or dev == "cuda" else \
                (torch.bfloat16, torch.float32)
            for a in acts:
                with act_dtype(a), torch.inference_mode():
                    logits[dev, a, act] = model.forward(weights, {
                        k: v.to(dev) for k, v in batch.items()}).float().cpu()
        del weights
    torch.cuda.empty_cache()
    fp32 = close(f"{cfg.name} 2-layer fp32 forward, card against CPU",
                 logits["cuda", torch.float32, torch.float32],
                 logits["cpu", torch.float32, torch.float32], 1e-3, 1e-3)
    want = logits["cpu", torch.float32, torch.bfloat16]
    atol = float((logits["cpu", torch.bfloat16, torch.bfloat16]
                  - want).abs().max())
    card = logits["cuda", torch.bfloat16, torch.bfloat16]
    bf16 = close(f"{cfg.name} 2-layer bf16 forward on the card against "
                 f"the CPU's fp32", card, want, 3e-2, atol)
    bf16_vs_bf16 = float((card - logits["cpu", torch.bfloat16,
                                        torch.bfloat16]).abs().max())
    grads = grads_on_both(cfg, 7, f"grads {cfg.name}")
    rel = rel_frobenius(grads["grads"])
    for name, r in rel.items():
        if r > 3e-2:
            raise AssertionError(f"grads {cfg.name}: {name} differs from "
                                 f"the CPU's by {r} (relative Frobenius)")
    return {"layers": cfg.n_layers, "fp32_tokens": list(
        PARITY_TOKENS[arch]), "fp32_max_abs_err": fp32,
        "bf16_tokens": [2, MODEL_PROMPT], "bf16_atol": atol,
        "bf16_max_abs_err_vs_cpu_fp32": bf16,
        "bf16_max_abs_err_vs_cpu_bf16": bf16_vs_bf16, "loss": grads["loss"],
        "grad_launches": grads["launches"], "rel_frobenius_err": rel}


def family_tenants() -> dict:
    """The zoo's ssm and hybrid tenants at SERVE_SHAPES (mamba2-780m and
    hymba-1.5b whole over a 1024-token chunk), warmed: one prefill slab and
    one decode burst of each, every counter reset around each, launch
    ``chunk_launches`` exactly and equal the model's own prefill and decode
    step on the tenant's weights, tokens and cache (the same calls: rtol =
    atol = 1e-2).  Then FAMILY_TRACE served through the two as one zoo
    (``serve_run``: every chunk once, exact launches, PTT floors at
    PTT_FLOOR of each chunk's device time alone).  Returns kernel ->
    launches of the run."""
    tenants = zoo.default_zoo({"steady": "ssm", "burst": "hybrid"})
    zoo.warm_zoo(tenants)
    floors, checked = {}, {}
    for tenant in tenants.values():
        model, weights, toks = tenant.model, tenant.weights, tenant.tokens
        per = chunk_launches(tenant)
        got = {}
        for typ, fn in (("prefill", tenant.prefill_slab),
                        ("decode", tenant.decode_burst)):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            got[typ] = fn()
            torch.cuda.synchronize()
            n = kernels.launch_counts()
            want = {name: per[typ].get(name, 0) for name in KERNELS}
            if n != want:
                raise AssertionError(f"{tenant.flavor} tenant {typ}: "
                                     f"launches {n}, want {want}")
        pre, cache = make_prefill_step(model)(weights, {"tokens": toks})
        dec, _ = make_decode_step(model)(weights, toks[:, -1:], cache)
        checked[tenant.flavor] = {
            "model": model.cfg.name, "prefill_max_abs_err": close(
                f"{tenant.flavor} tenant prefill", got["prefill"], pre,
                1e-2, 1e-2),
            "decode_max_abs_err": close(
                f"{tenant.flavor} tenant decode", got["decode"], dec, 1e-2,
                1e-2)}
        floors[tenant.flavor] = {
            "prefill": PTT_FLOOR * device_ms(tenant.prefill_slab) / 1e3,
            "decode": PTT_FLOOR * device_ms(tenant.decode_burst) / 1e3}
        del pre, cache, dec, got
    torch.cuda.synchronize()
    emit({"phase": "family_tenants", **checked})
    trace = serve.bursty_serving_trace(**FAMILY_TRACE)
    return serve_run(FAMILY_ZOO_PATH, tenants, trace, floors)


def phase_families() -> dict:
    """The families phase: mamba2-780m and hymba-1.5b served whole
    (``serve_family_path``), hubert-xlarge's encode and train steps
    (``encode_path``), the ssm and hybrid tenants (``family_tenants``),
    then each family at full width and 2 layers on the card against the
    CPU (``family_card_vs_cpu``).  Returns path -> kernel -> launches."""
    launches = {path: serve_family_path(path) for path in FAMILY_RUNS}
    launches[ENCODE_PATH] = encode_path()
    launches[FAMILY_ZOO_PATH] = family_tenants()
    for arch in PARITY_TOKENS:
        emit({"phase": "family_card_vs_cpu", "arch": arch,
              **family_card_vs_cpu(arch)})
    return launches


# ------------------------------------------------------ slice 10's phases
def phase_multi_impl() -> dict:
    """multi_impl: two kernel tenants at SERVE_SHAPES, each binding the
    plain versions ("ref") and the kernels ("cuda") as TAO variants, serve
    MULTI_IMPL_TRACE under molding:weight.
    Every admitted request completes and each chunk runs once; a TAO's
    chunks all run one impl (a continuation keeps its TAO's); the kernels
    launch exactly as the "cuda" chunks call them (a prefill chunk one
    flash attention and one projection, a decode step one copy and one
    GEMV) and the "ref" chunks launch none.  Reports chunks per impl and
    the PTT's fastest time per (class, impl, width); whether the scheduler
    learns to avoid "ref" is reported, not held.  Returns kernel ->
    launches."""
    tenants = zoo.default_zoo({"steady": "kernel", "burst": "kernel"},
                              multi_impl=True)
    for name, t in tenants.items():
        if tuple(t._impl_payloads) != ("ref", "cuda"):
            raise AssertionError(f"multi_impl: {name} binds "
                                 f"{tuple(t._impl_payloads)}")
    zoo.warm_zoo(tenants)
    trace, controls = serve.PATHS[MULTI_IMPL_TRACE]
    requests = trace()
    log = ChunkLog()
    kernels.reset_launch_counts()
    stats = serve.run_zoo(requests, tenants, log=log, timeout_s=300.0,
                          **controls())
    launched = kernels.launch_counts()
    res = stats.result
    by_name = {f"req{r.id}": r for r in requests}
    admitted = [by_name[st.name] for st in res.admitted_dags()]
    undone = [st.name for st in res.admitted_dags() if not st.done]
    if not admitted or undone:
        raise AssertionError(f"multi_impl: {len(admitted)} admitted, not "
                             f"done: {undone}")
    n_chunks = sum(tenants[r.tenant].prefill_chunks(r)
                   + math.ceil(r.gen_len / DECODE_UNIT) for r in admitted)
    if len(log.runs) != n_chunks or set(log.runs.values()) != {1}:
        raise AssertionError("multi_impl: chunks not each run once")
    impls, types = collections.defaultdict(set), {}
    for rec in res.trace:
        impls[rec.dag_id, rec.tao_id].add(rec.impl)
        types[rec.dag_id, rec.tao_id] = rec.type
    mixed = {k: v for k, v in impls.items() if len(v) != 1}
    if mixed:
        raise AssertionError(f"multi_impl: TAOs ran several impls: {mixed}")
    chunks = collections.Counter()
    for dag_id, tao_id, _ in log.runs:
        (impl,) = impls[dag_id, tao_id]
        chunks[impl, types[dag_id, tao_id]] += 1
    steps = {t.decode_steps for t in tenants.values()}.pop()
    pre, dec = chunks["cuda", "prefill"], chunks["cuda", "decode"] * steps
    want = {name: 0 for name in KERNELS}
    want.update(flash_attention=pre, matmul=pre + dec, copy=dec)
    if launched != want:
        raise AssertionError(f"multi_impl: launches {launched}, want {want} "
                             f"from chunks {dict(chunks)}")
    fastest = {}
    for typ, cells in stats.ptt_profiles.items():
        for (leader, width, *impl), t in cells.items():
            key = f"{typ},{impl[0] if impl else 'default'},w{width}"
            fastest[key] = min(t * 1e3, fastest.get(key, math.inf))
    # the share of TAOs that ran "ref", in the first and the second half of
    # the run by start time
    recs = sorted((r for r in res.trace if not r.preempted),
                  key=lambda r: r.start)
    half = len(recs) // 2
    ref_share = [sum(r.impl == "ref" for r in part) / max(len(part), 1)
                 for part in (recs[:half], recs[half:])]
    emit({"phase": "multi_impl", "path": MULTI_IMPL_PATH,
          "trace": MULTI_IMPL_TRACE, "requests": len(requests),
          "admitted": len(admitted),
          "completed_taos": res.completed, "makespan_s": stats.makespan,
          "tokens_per_s": stats.tokens_per_s,
          "chunks_by_impl": {f"{i}:{t}": n for (i, t), n in
                             sorted(chunks.items())},
          "ref_taos_share_first_half": ref_share[0],
          "ref_taos_share_second_half": ref_share[1],
          "ptt_fastest_ms": dict(sorted(fastest.items())),
          "preemptions": res.n_preemptions, "launches": launched})
    return launched


def phase_fleet() -> dict:
    """fleet: the paper's mixed-mode DAG on ThreadedRuntime under
    ``homogeneous`` (every TAO at width 1) with a ChaosPlan that degrades
    worker FLEET_SLOW to FLEET_SPEED from the start and kills worker
    FLEET_KILLED at FLEET_KILL_AT s.  Every chunk runs once and every TAO
    commits, each kernel launched once a chunk; ``StragglerDetector`` on
    the run's PTT flags the degraded worker on most classes and no other
    worker on most; an ``ElasticFleet`` fed each worker's trace records as
    heartbeats marks the killed worker DEAD at the run's end and no other,
    and demotes the straggler to LITTLE; a second DAG of FLEET_SECOND TAOs
    completes on ``fleet.cluster_spec()``.  The vote over classes relaxes
    "flags the degraded worker and no other": the detector's raw reports on
    healthy workers are emitted as ``false_positives``, and ``StallLog``
    splits each PTT update of the run to show what lifted their cells.
    Returns kernel -> launches of the first DAG."""
    operands = mixed_mode.operands_from_numpy(mixed_mode.make_arrays(),
                                              "cuda")
    torch.cuda.synchronize()
    spec = hikey960()
    plan = (ChaosPlan.builder().degrade(0.0, [FLEET_SLOW], FLEET_SPEED)
            .kill(FLEET_KILL_AT, [FLEET_KILLED]).build())

    def run(dag, spec, policy, chaos=None):
        log = StallLog()
        mixed_mode.bind_real_work(dag, operands, device="cuda", log=log)
        rt = ThreadedRuntime(spec, make_policy(policy), seed=0)
        log.watch(rt.core)
        with log.gc_pauses():
            res = rt.run_workload(Workload.from_trace([(0.0, dag, "fleet")]),
                                  timeout_s=300.0, chaos=chaos)
        if res.completed != len(dag) or \
                len(log.runs) != len(dag) * mixed_mode.N_CHUNKS or \
                set(log.runs.values()) != {1}:
            raise AssertionError(f"fleet: {res.completed} of {len(dag)} "
                                 f"TAOs, chunks not each run once")
        return rt, res, log

    kernels.reset_launch_counts()
    rt, res, log = run(random_dag(n_tasks=N_TASKS, target_degree=DEGREE,
                                  seed=SEED), spec, "homogeneous", plan)
    launched = kernels.launch_counts()
    want = {name: N_TASKS // 3 * mixed_mode.N_CHUNKS if cls else 0
            for name, (_, _, cls) in KERNELS.items()}
    if launched != want:
        raise AssertionError(f"fleet: launches {launched}, want {want}")
    if {r.width for r in res.trace} != {1}:
        raise AssertionError("fleet: homogeneous ran a TAO wider than 1")
    det = StragglerDetector(rt.core.ptt, ratio_threshold=2.0)
    reports = det.scan(width=1)
    classes = rt.core.ptt.types()
    by_class = {typ: sorted({r.worker for r in reports if r.tao_type == typ})
                for typ in classes}
    # a straggler is flagged on most classes: the degraded worker sleeps on
    # every chunk, where a healthy worker's cell can be lifted on one class
    # by one late update caught in a stall of several threads inside their
    # CUDA calls (``StallLog``); the raw reports on healthy workers are
    # emitted as false positives
    votes = collections.Counter(w for ws in by_class.values() for w in ws)
    flagged = sorted(w for w, n in votes.items() if 2 * n > len(classes))
    ptt_ms = {typ: (rt.core.ptt.table(typ).snapshot()[:, 0] * 1e3).tolist()
              for typ in classes}
    if flagged != [FLEET_SLOW]:
        raise AssertionError(f"fleet: flagged {flagged} ({by_class}), want "
                             f"[{FLEET_SLOW}]; PTT ms at width 1 {ptt_ms}")
    beats = collections.defaultdict(list)
    for rec in res.trace:
        for w in rec.participants:
            beats[w].append(rec.end)
    last_killed = max(beats[FLEET_KILLED], default=0.0)
    # DEAD after half the time the run went on past the kill's last beat
    grace = (res.makespan - last_killed) / 2
    fleet = ElasticFleet(n_groups=spec.n_workers, model_parallel=1,
                         grace=grace)
    for w in range(spec.n_workers):
        fleet.observe(w, 0.0)
    for t, w in sorted((t, w) for w, ts in beats.items() for t in ts):
        fleet.observe(w, t)
    dead = fleet.tick(res.makespan)
    if dead != [FLEET_KILLED]:
        raise AssertionError(f"fleet: DEAD {dead}, want [{FLEET_KILLED}] "
                             f"(grace {grace} s, last beats "
                             f"{ {w: max(ts) for w, ts in beats.items()} })")
    for w in flagged:
        fleet.demote(w)
    alive = fleet.alive_groups()
    spec2 = fleet.cluster_spec(base_classes=spec.classes)
    if spec2.classes[alive.index(FLEET_SLOW)] != LITTLE or \
            spec2.n_workers != spec.n_workers - 1:
        raise AssertionError(f"fleet: cluster spec {spec2.classes}")
    _, res2, _ = run(random_dag(n_tasks=FLEET_SECOND, target_degree=DEGREE,
                             seed=SEED + 1), spec2, "molding:weight")
    emit({"phase": "fleet", "path": FLEET_PATH, "tasks": N_TASKS,
          "policy": "homogeneous", "degraded": [FLEET_SLOW, FLEET_SPEED],
          "killed": [FLEET_KILLED, FLEET_KILL_AT],
          "makespan_s": res.makespan, "taos_per_s": res.throughput,
          "requeued_on_kill": sum(st.requeued_by_failure
                                  for st in res.per_dag.values()),
          "flagged_by_class": by_class, "stragglers": flagged,
          "reports": [vars(r) for r in reports],
          "false_positives": [vars(r) for r in reports
                              if r.worker != FLEET_SLOW],
          "stalls": log.stalls(FLEET_SLOW, sorted(
              {(r.worker, r.tao_type) for r in reports})),
          "ptt_ms_w1": ptt_ms,
          "dead": dead, "grace_s": grace,
          "cluster_spec": list(spec2.classes),
          "second_dag": {"tasks": FLEET_SECOND, "policy": "molding:weight",
                         "makespan_s": res2.makespan,
                         "completed": res2.completed},
          "launches": launched})
    return launched


class StallLog(ChunkLog):
    """A ``ChunkLog`` that also splits every PTT update of a width-1 run:
    its ``elapsed``, the wall its leader's thread spent inside the chunk
    calls (launch, kernel, stream synchronise) since its last update, and
    the update's time on ``time.perf_counter``; and the run's garbage
    collector pauses (``gc_pauses``)."""

    def __init__(self) -> None:
        super().__init__()
        self.updates: list[tuple] = []  # (cls, leader, elapsed, inside, end)
        self.pauses: list[tuple] = []   # (start, end, generation)
        self._inside = threading.local()

    def wrap(self, chunk_fn, tao):
        logged = super().wrap(chunk_fn, tao)

        def timed(i):
            t = time.perf_counter()
            try:
                return logged(i)
            finally:
                self._inside.s = getattr(self._inside, "s", 0.0) \
                    + time.perf_counter() - t
        return timed

    def watch(self, core) -> None:
        super().watch(core)
        record_time = core.record_time

        def record(tao, leader, width, elapsed):
            inside, self._inside.s = getattr(self._inside, "s", 0.0), 0.0
            self.updates.append((tao.type, leader, elapsed, inside,
                                 time.perf_counter()))
            return record_time(tao, leader, width, elapsed)
        core.record_time = record

    @contextlib.contextmanager
    def gc_pauses(self):
        started = {}

        def note(phase, info):
            if phase == "start":
                started["t"] = time.perf_counter()
            elif "t" in started:
                self.pauses.append((started.pop("t"), time.perf_counter(),
                                    info["generation"]))
        gc.callbacks.append(note)
        try:
            yield
        finally:
            gc.callbacks.remove(note)

    def stalls(self, slow: int, cells=(), factor: float = 5.0,
               shown: int = 40) -> dict:
        """The healthy workers' PTT updates over ``factor`` x their class's
        median: how many, the first ``shown`` with the part of their
        elapsed spent inside the chunk calls (the rest is claims and waits
        between chunks), how many overlap a garbage collector pause and how
        many overlap another worker's such update; and the last 8 updates
        (ms, ms inside chunk calls) of each (worker, class) in ``cells``,
        which set its EWMA cell."""
        med = {c: float(np.median([e for cls, w, e, _, _ in self.updates
                                   if cls == c and w != slow]))
               for c in {u[0] for u in self.updates}}
        out = [u for u in self.updates
               if u[1] != slow and u[2] > factor * med[u[0]]]

        def overlaps(a0, a1, b0, b1):
            return a0 < b1 and b0 < a1
        return {
            "median_ms": {c: m * 1e3 for c, m in med.items()},
            "updates": len(self.updates), "factor": factor,
            "n_outliers": len(out),
            "outliers": [{"cls": c, "worker": w, "ms": e * 1e3,
                          "inside_chunks_ms": i * 1e3,
                          "at_s": t - self.updates[0][4]}
                         for c, w, e, i, t in out[:shown]],
            "outliers_in_gc_pause": sum(
                any(overlaps(t - e, t, p0, p1) for p0, p1, _ in self.pauses)
                for _, _, e, _, t in out),
            "outliers_overlapping_another_worker": sum(
                any(w2 != w and overlaps(t - e, t, t2 - e2, t2)
                    for _, w2, e2, _, t2 in out)
                for _, w, e, _, t in out),
            "gc_pauses": len(self.pauses),
            "gc_pause_ms_max": max((b - a for a, b, _ in self.pauses),
                                   default=0.0) * 1e3,
            "last_updates": {f"{w}:{c}": [
                (e * 1e3, i * 1e3) for cls, ww, e, i, _ in self.updates
                if (ww, cls) == (w, c)][-8:] for w, c in cells}}


def phase_grad_sync() -> dict:
    """grad_sync: one ``loss_and_grads`` of llama3.2-1b at full size on the
    train path's batch (4 x 128), then GRAD_SYNC_ROUNDS rounds of
    ``grad_sync_tree`` over a world-size-1 NCCL mesh from
    ``make_debug_mesh``, carrying the error feedback.  Each round each
    leaf's residual is within half a quantization step plus one bf16
    rounding of the transmitted value; after the rounds
    sum(reduced) + error == sum(grads) within fp32 rounding; the first
    round equals, bit for bit, the same functions on the CPU over a gloo
    group; ``compress=False`` returns the grads unchanged.  At world size 1
    NCCL's all_reduce only copies: the card shows the quantize and
    error-feedback arithmetic at full width and the NCCL binding, and the
    CPU tests hold the reduction across ranks.  Returns kernel ->
    launches of the loss and the rounds."""
    cfg = get_config(ARCH)
    model = get_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH).batch(0, device="cuda")
    kernels.reset_launch_counts()
    grads, metrics = loss_and_grads(model, params, batch)
    del params
    torch.cuda.empty_cache()
    mesh = make_debug_mesh()
    try:
        cpu_group = dist.new_group(backend="gloo")
        with use_sharding(mesh):
            out = sync_rounds(grads, cpu_group)
            torch.cuda.synchronize()
            launched = kernels.launch_counts()
            if launched != train_launches(1):
                raise AssertionError(f"grad_sync: launches {launched}, "
                                     f"want {train_launches(1)}")
            plain, zero = grad_sync_tree(grads, "data", compress=False)
        if not all(torch.equal(plain[k], grads[k]) and not zero[k].any()
                   for k in grads):
            raise AssertionError("grad_sync: compress=False changed grads")
        del plain, zero
    finally:
        dist.destroy_process_group()
    numel = sum(g.numel() for g in grads.values())
    emit({"phase": "grad_sync", "path": GRAD_SYNC_PATH, "arch": ARCH,
          "params": numel, "loss": metrics["loss"].item(),
          "rounds": GRAD_SYNC_ROUNDS, "world_size": 1,
          "backend": "nccl", "ms_per_sync": out["ms"],
          "wire_bytes_bf16": 2 * numel, "all_reduce_bytes_fp32": 4 * numel,
          "max_residual_over_half_step": out["residual"],
          "max_feedback_invariant_err_over_bound": out["invariant"],
          "cpu_bit_equal_first_round": True, "launches": launched})
    del grads, out
    torch.cuda.empty_cache()
    return launched


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` (fp32) hold the same bits, -0.0 and NaNs included."""
    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def sync_rounds(grads: dict, cpu_group) -> dict:
    """GRAD_SYNC_ROUNDS rounds of ``grad_sync_tree(grads, "data", error)``
    under the current mesh, each checked leaf by leaf: the new residual
    ``x - wire`` (x = grads + the previous error) within half the round's
    step (``quantize_int8``'s scale of x) plus one bf16 rounding of the
    wire (2^-8 of it) and fp32's of x and of the grid; after the rounds
    sum(reduced) + error == rounds x grads within 8 fp32 roundings of the
    summed magnitudes.  The
    first round equals, bit for bit, ``grad_sync_tree`` of the grads on
    the CPU over ``cpu_group``.  Returns each round's ms and the largest
    residual and invariant error over their bounds."""
    eps = 2.0 ** -24
    errors, total, mags = None, {}, {}
    ms, residual = [], 0.0
    for r in range(GRAD_SYNC_ROUNDS):
        prev = errors
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        red, errors = grad_sync_tree(grads, "data", prev)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if r == 0:
            cpu_red, cpu_err = grad_sync_tree(
                {k: g.cpu() for k, g in grads.items()}, cpu_group)
            differ = [k for k in grads
                      if not (bits_equal(red[k], cpu_red[k])
                              and bits_equal(errors[k], cpu_err[k]))]
            del cpu_red, cpu_err
            if differ:
                raise AssertionError(f"grad_sync: card and CPU differ on "
                                     f"{differ}")
        for k, g in grads.items():
            xk = g if prev is None else g + prev[k]
            step = quantize_int8(xk)[1]
            bound = step * (0.5 + 4 * eps) \
                + 2.0 ** -8 * (1 + 2.0 ** -7) * red[k].abs() \
                + 2 * eps * (xk.abs() + red[k].abs())
            residual = max(residual, (errors[k].abs() / bound).max().item())
            total[k] = red[k] if r == 0 else total[k] + red[k]
            mags[k] = red[k].abs() if r == 0 else mags[k] + red[k].abs()
        del prev, red, xk
    if residual > 1.0:
        raise AssertionError(f"grad_sync: a residual is {residual} of its "
                             f"bound")
    invariant = 0.0
    n = GRAD_SYNC_ROUNDS
    for k, g in grads.items():
        bound = 8 * eps * (mags[k] + errors[k].abs() + n * g.abs()) + 1e-30
        err = (total[k] + errors[k] - n * g).abs()
        invariant = max(invariant, (err / bound).max().item())
    if invariant > 1.0:
        raise AssertionError(f"grad_sync: sum(reduced) + error misses "
                             f"sum(grads) by {invariant} of the bound")
    return {"ms": ms, "residual": residual, "invariant": invariant}


# ------------------------------------------------------ slice 12's phase
def card_and_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]


@contextlib.contextmanager
def plain_calls():
    """While open, each plain version of the norm and the attention counts
    its calls into the yielded dict (kernel -> calls); a chunked plain
    attention (``plain_chunked``) counts as one call."""
    calls = {"rmsnorm": 0, "flash_attention": 0}
    saved = [(rmsnorm, "plain"), (flash_attention, "plain"),
             (flash_attention, "plain_chunked")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in saved]

    def counting(name, fn):
        def plain(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return plain

    for mod, attr, fn in saved:
        setattr(mod, attr, counting(mod.__name__.rsplit(".", 1)[1], fn))
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def forward_holds(model, params, batch) -> int:
    """The bytes the card holds after ``model.loss`` on ``batch`` with
    autograd recording, above what it held before: what the train forward
    keeps for its backward (under remat each layer's input) and the loss.
    Its launches are no path's: the counters are reset before each call."""
    with torch.enable_grad():
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss, _ = model.loss(leaves, batch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
    del loss
    return held


def wrapped_result_bytes(mesh) -> dict:
    """Fault H's op on the card: a (WRAPPED_ROWS, d_model) bf16 tensor
    all-reduced over ``mesh``'s ``data`` group by funcol (its autograd
    wrapper over the result; DTensor issues no collective over a dim of
    one rank) and the result doubled.  The bytes allocated above the start
    while both live, on the card and as ``dryrun.StepCounter`` counts the
    same two ops on meta, are both two results' bytes (a count that let
    the wrapped result go reads one)."""
    import torch.distributed._functional_collectives as funcol

    shape = (WRAPPED_ROWS, get_config(ARCH).d_model)
    group = mesh.get_group("data")
    x = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = funcol.all_reduce(x, "sum", group)
    z = y * 2
    torch.cuda.synchronize()
    card = torch.cuda.memory_allocated() - before
    del x, y, z
    meta = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    counter = dryrun.StepCounter((meta,))
    with counter:
        y = funcol.all_reduce(meta, "sum", group)
        z = y * 2
    del y, z
    result = math.prod(shape) * 2
    got = {"result_bytes": result, "card_bytes": card,
           "dry_run_bytes": counter.peak_bytes}
    if not card == counter.peak_bytes == 2 * result:
        raise AssertionError(f"{SHARDED_PATH}: an all-reduce's result and "
                             f"its double: {got}, want {2 * result} each")
    return got


def collect_garbage() -> dict:
    """Collects what only reference cycles keep, and says what it was: the
    card's bytes that freed, the CUDA tensors among it, and the functions
    whose frames it held (file:function, the most frequent first), each
    frame keeping its locals."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
    finally:
        gc.set_debug(0)
    found = list(gc.garbage)
    gc.garbage.clear()
    cuda = sum(isinstance(o, torch.Tensor) and o.is_cuda for o in found)
    frames = collections.Counter(
        f"{Path(o.f_code.co_filename).name}:{o.f_code.co_name}"
        for o in found if type(o).__name__ == "frame")
    del found
    gc.collect()
    torch.cuda.synchronize()
    return {"bytes": before - torch.cuda.memory_allocated(),
            "cuda_tensors": cuda, "frames": dict(frames.most_common(8))}


def sharded_steps(model, params, prompt, steps, batch, mesh) -> dict:
    """The prefill of ``prompt``, a decode step of each column of ``steps``
    and SHARDED_TRAIN_STEPS ``make_train_step``s on ``batch``, each on the
    last one's params and AdamW state, under ``use_sharding(mesh)`` (None:
    no mesh; the parameters, tokens and batch then placed by their logical
    names).  Under the mesh each train step hands back every parameter and
    moment in the placements it took (fault I: ``make_train_step`` raises
    ``AssertionError`` on one that moved).  Each call's launches and plain
    calls are counted on their own and checked: 2L + 1 norms and L
    attentions in the prefill, the norms alone in a decode step, and each
    train step's forward's and its backward's recompute
    (``step_launches``); no plain version in a serve step, the unsharded
    step's count in the train step (flash's backward is plain PyTorch).
    Returns the logits of every step and the last cache, and each train
    step's loss and params, on the CPU, with the launches, plain calls and
    seconds."""
    norms, layers = call_launches(model.cfg)
    out = {"logits": [], "launches": {name: 0 for name in KERNELS},
           "plain": {}, "seconds": {}}

    def run(name, fn, want):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with plain_calls() as calls:
            result = fn()
            torch.cuda.synchronize()
        out["seconds"][name] = out["seconds"].get(name, 0.0) + \
            time.perf_counter() - t0
        got = kernels.launch_counts()
        if got != {**{k: 0 for k in KERNELS}, **want}:
            raise AssertionError(f"{SHARDED_PATH} {name}: launches {got}, "
                                 f"want {want}")
        for k, n in got.items():
            out["launches"][k] += n
        for k, n in calls.items():
            out["plain"][f"{name}:{k}"] = out["plain"].get(f"{name}:{k}",
                                                           0) + n
        return result

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    with use_sharding(mesh):
        if mesh is not None:
            params = model.place(params)
            prompt, steps = (place(t, ("batch", "seq"))
                             for t in (prompt, steps))
            batch = {k: place(v, ("batch", "seq")) for k, v in batch.items()}
        weights = model.bf16_copy(params)
        logits, cache = run("prefill", lambda: make_prefill_step(model)(
            weights, {"tokens": prompt}), {"rmsnorm": norms,
                                          "flash_attention": layers})
        out["logits"].append(full(logits).cpu())
        for i in range(steps.shape[1]):
            logits, cache = run("decode", lambda: make_decode_step(model)(
                weights, steps[:, i:i + 1], cache), {"rmsnorm": norms})
            out["logits"].append(full(logits).cpu())
        out["cache"] = {k: full(cache[k]).cpu() for k in ("k", "v")}
        out["cache_local"] = {k: list((cache[k].to_local() if mesh is not
                                       None else cache[k]).shape)
                              for k in ("k", "v")}
        del weights, cache
        # garbage that earlier phases left in reference cycles, collected
        # first: a collection inside the measured forward would free it
        # there and take its bytes off the count
        out["garbage"] = [collect_garbage()]
        out["forward_held"] = forward_holds(model, params, batch)
        t_norms, t_flash = step_launches(model.cfg)
        train_step = make_train_step(model)
        new, opt = params, None
        out["loss"], out["params"] = [], []
        for i in range(SHARDED_TRAIN_STEPS):
            out["garbage"].append(collect_garbage())  # as before the forward
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state = new, opt
            # the first step's AdamW state is made inside the measured call
            new, opt, metrics = run("train", lambda: train_step(
                state[0], state[1] or adamw_init(params), batch),
                {"rmsnorm": t_norms, "flash_attention": t_flash})
            if i == 0:
                out["train_peak_above_start"] = \
                    torch.cuda.max_memory_allocated() - start
            out["loss"].append(full(metrics["loss"]).item())
            out["params"].append({k: full(v).cpu() for k, v in new.items()})
        del state, new, opt
    return out


def phase_sharded() -> dict:
    """sharded: llama3.2-1b at its published widths and depth (random
    weights from seed 0) on a one-rank NCCL mesh (``make_debug_mesh``)
    against the same steps with no mesh on the card: a prefill of batch 4
    x prompt 64, 32 decode steps into the placed cache and two
    ``make_train_step``s of 4 x 128, the second on the first's params and
    AdamW state, each handing them back in the placements it took
    (``sharded_steps``).  Under the mesh the norms and the attention run
    the kernels on each rank's local shards
    (``parallel.sharding.on_local_shards``), the cache is a DTensor placed
    by its logical names and written in place.  The logits of every step
    and the cache are held at serve:model's bf16 bound (rtol 3e-2, atol
    ``bf16_atol(L)``), each train step's loss at 3e-2 and each parameter
    after its AdamW at 3e-2 relative Frobenius (phase_train_vs_cpu's);
    whether each is bit for bit the unsharded run's is reported.  The
    bytes the train forward keeps for its backward (``forward_holds``)
    differ from the unsharded run's, and the first train step's peak
    above its start exceeds it, by under
    half a residual a layer, and an all-reduced result is held on the card
    as the dry run counts it (``wrapped_result_bytes``).  Every counter is
    reset just before each call and read just after; returns kernel ->
    launches of the sharded run."""
    cfg = get_config(ARCH)
    model = get_model(cfg)
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MODEL_BATCH, MODEL_PROMPT + SHARDED_DECODE)
    )).cuda()
    prompt, steps = toks[:, :MODEL_PROMPT], toks[:, MODEL_PROMPT:]
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH).batch(0, device="cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    runs = {"plain": sharded_steps(model, params, prompt, steps, batch,
                                   None)}
    torch.cuda.empty_cache()
    mesh = make_debug_mesh()
    try:
        runs["mesh"] = sharded_steps(model, params, prompt, steps, batch,
                                     mesh)
        wrapped = wrapped_result_bytes(mesh)
    finally:
        dist.destroy_process_group()
    del params
    got, want = runs["mesh"], runs["plain"]
    served = [k for k in got["plain"] if not k.startswith("train:")]
    if any(got["plain"][k] for k in served) or \
            got["plain"] != want["plain"]:
        raise AssertionError(f"{SHARDED_PATH}: plain calls {got['plain']}, "
                             f"unsharded {want['plain']}")
    atol = bf16_atol(cfg.n_layers)
    errs = {"logits": max(close(f"{SHARDED_PATH} logits {i}", g, w, 3e-2,
                                atol) for i, (g, w) in enumerate(zip(
                                    got["logits"], want["logits"])))}
    for k in ("k", "v"):
        errs[f"cache_{k}"] = close(f"{SHARDED_PATH} cache {k}",
                                   got["cache"][k], want["cache"][k], 3e-2,
                                   atol)
    # each train step, the second on the first's outputs
    errs["loss_rel"] = [abs(g - w) / abs(w)
                        for g, w in zip(got["loss"], want["loss"])]
    errs["params_max_rel_frobenius"] = [max(
        float((g[k] - p).norm() / p.norm()) for k, p in w.items())
        for g, w in zip(got["params"], want["params"])]
    if not (max(errs["loss_rel"]) <= 3e-2 and
            max(errs["params_max_rel_frobenius"]) <= 3e-2):
        raise AssertionError(f"{SHARDED_PATH}: {errs}")
    bit_equal = {
        "logits": all(torch.equal(g, w) for g, w in zip(got["logits"],
                                                        want["logits"])),
        "cache": all(torch.equal(got["cache"][k], want["cache"][k])
                     for k in ("k", "v")),
        "loss": [g == w for g, w in zip(got["loss"], want["loss"])],
        "params": [all(torch.equal(g[k], p) for k, p in w.items())
                   for g, w in zip(got["params"], want["params"])]}
    # fault H: a copy of each layer's residual more (or less) under the
    # mesh would move the bytes the forward keeps by n_layers residuals
    residual = TRAIN_BATCH * TRAIN_SEQ * cfg.d_model * 2
    memory = {k: {"mesh": got[k], "unsharded": want[k],
                  "residuals_more": (got[k] - want[k]) / residual}
              for k in ("forward_held", "train_peak_above_start")}
    memory["residual_bytes"] = residual
    # before the forward and each train step: what the collector freed
    memory["garbage"] = {"mesh": got["garbage"],
                         "unsharded": want["garbage"]}
    memory["wrapped_all_reduce"] = wrapped
    print(f"{SHARDED_PATH} memory: {json.dumps(memory)}", flush=True)
    if not (abs(got["forward_held"] - want["forward_held"]) <
            cfg.n_layers * residual / 2 and
            got["train_peak_above_start"] - want["train_peak_above_start"]
            < cfg.n_layers * residual / 2):
        raise AssertionError(f"{SHARDED_PATH}: memory {memory}")
    del runs, got["params"], want["params"]
    torch.cuda.empty_cache()
    emit({"phase": "sharded", "path": SHARDED_PATH, "arch": ARCH,
          "card": card_and_limit(), "mesh": {"data": 1, "model": 1},
          "backend": "nccl", "layers": cfg.n_layers, "batch": MODEL_BATCH,
          "prompt": MODEL_PROMPT, "decode_steps": SHARDED_DECODE,
          "train_tokens": [TRAIN_BATCH, TRAIN_SEQ],
          "train_steps": SHARDED_TRAIN_STEPS,
          "cache_local_shape": got["cache_local"],
          "max_abs_err": errs, "atol": atol, "bit_equal": bit_equal,
          "plain_calls": got["plain"], "seconds": got["seconds"],
          "seconds_unsharded": want["seconds"], "memory": memory,
          "launches": got["launches"]})
    return got["launches"]


def peak_call(fn, *args) -> tuple:
    """``fn(*args)`` on the card: (its result, the peak bytes allocated
    above what was allocated before it, its seconds, kernel -> launches),
    every counter reset just before and read just after."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (out, torch.cuda.max_memory_allocated() - before, seconds,
            kernels.launch_counts())


@contextlib.contextmanager
def plain_versions():
    """While open, the models' norms and attentions take their plain
    versions on the card (``force="ref"``) and launch no kernel."""
    norm, attend = ops.rmsnorm, ops.flash_attention
    ops.rmsnorm = lambda *a, **kw: norm(*a, **kw, force="ref")
    ops.flash_attention = lambda *a, **kw: attend(*a, **kw, force="ref")
    try:
        yield
    finally:
        ops.rmsnorm, ops.flash_attention = norm, attend


def remat_call(model, params, batch, warm: bool = True) -> tuple:
    """``models.loss_and_grads`` of ``model`` on the card, after a warm
    call where ``warm``, through ``peak_call``: (grads, loss, peak bytes,
    seconds, kernel -> launches), the launches exactly ``step_launches``
    of its config and the loss finite."""
    if warm:
        loss_and_grads(model, params, batch)
    (grads, metrics), peak, seconds, launched = peak_call(
        loss_and_grads, model, params, batch)
    want = {k: 0 for k in KERNELS}
    want["rmsnorm"], want["flash_attention"] = step_launches(model.cfg)
    label = (f"{REMAT_PATH} {model.cfg.n_layers} layers, tokens "
             f"{tuple(batch['tokens'].shape)}")
    if launched != want:
        raise AssertionError(f"{label}: launches {launched}, want {want}")
    loss = metrics["loss"]
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"{label}: loss {loss}")
    return grads, loss, peak, seconds, launched


def phase_remat() -> dict:
    """remat: ``models.loss_and_grads`` of llama3.2-1b at its published
    size (random weights, seed 0) on one ``SyntheticLM`` batch of
    REMAT_BATCH x REMAT_SEQ tokens, under each of REMAT_VARIANTS, one warm
    call and one timed (``remat_call``).  Each: exactly ``step_launches``
    of its config; with remat, the loss bit for bit its twin's without
    (REMAT_TWIN) and each parameter's grad within REMAT_GRAD_TOL relative
    Frobenius of the twin's (bit equality reported); the peak bytes above
    what was allocated before the call falling as REMAT_ORDER says; beside
    each peak the dry run's temp bytes of the same call on meta
    (``dryrun.temp_bytes``) and their ratio, reported.  Then the same
    variants but off_chunk8 on REMAT_LOSS_TOKENS, whose peaks fall as
    REMAT_LOSS_ORDER says, strictly from the unchunked to the chunked loss.
    Last, the default variant cut to REMAT_PLAIN_LAYERS layers at
    REMAT_BATCH x REMAT_SEQ against the same call on the plain versions
    (``plain_versions``, which launch nothing): the loss and each grad
    within REMAT_PLAIN_TOL relative.  Returns kernel -> launches of the
    timed full-depth calls."""
    cfg = get_config(ARCH)
    params = get_model(cfg).init(torch.Generator("cuda").manual_seed(0))

    def batch_of(b, s):
        return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=s,
                           global_batch=b).batch(0, device="cuda")

    batch = batch_of(REMAT_BATCH, REMAT_SEQ)
    meta_batch = {k: torch.empty_like(v, device="meta")
                  for k, v in batch.items()}
    total = {name: 0 for name in KERNELS}
    rows, losses, twins = {}, {}, {}
    for name, changes in REMAT_VARIANTS.items():
        model = get_model(dataclasses.replace(cfg, **changes))
        grads, losses[name], peak, seconds, launched = remat_call(
            model, params, batch)
        for k, n in launched.items():
            total[k] += n
        row, twin = {}, REMAT_TWIN.get(name)
        if twin is not None:
            rel = rel_frobenius_vs(grads, twins[twin])
            row = {"twin": twin, "grads_bit_equal_to_twin": all(
                torch.equal(g, twins[twin][k]) for k, g in grads.items()),
                "grads_max_rel_frobenius_vs_twin": max(rel.values()),
                "loss_bit_equal_to_twin": bits_equal(losses[name],
                                                     losses[twin])}
            if model.cfg.remat and (max(rel.values()) > REMAT_GRAD_TOL or
                                    not row["loss_bit_equal_to_twin"]):
                raise AssertionError(f"{REMAT_PATH} {name}: loss "
                                     f"{losses[name].item()} against "
                                     f"{losses[twin].item()}, grads {rel}")
        if not model.cfg.remat:
            twins[name] = grads
        del grads
        temp = dryrun.temp_bytes(loss_and_grads, model,
                                 model.abstract_params(), meta_batch)
        rows[name] = {"peak_bytes": peak, "peak_gib": peak / 2 ** 30,
                      "seconds": seconds, "launches": {
                          k: launched[k] for k in ("rmsnorm",
                                                   "flash_attention")},
                      "loss": losses[name].item(), **row,
                      "dry_run_temp_bytes": temp,
                      "peak_over_dry_run_temp": peak / temp}
    del twins
    wide = batch_of(*REMAT_LOSS_TOKENS)
    loss_rows = {}
    for name in dict.fromkeys(n for a, b, _ in REMAT_LOSS_ORDER
                              for n in (a, b)):
        model = get_model(dataclasses.replace(cfg, **REMAT_VARIANTS[name]))
        _, loss, peak, seconds, launched = remat_call(model, params, wide)
        for k, n in launched.items():
            total[k] += n
        loss_rows[name] = {"peak_bytes": peak, "peak_gib": peak / 2 ** 30,
                           "seconds": seconds, "loss": loss.item()}
    torch.cuda.empty_cache()
    for order, got, tokens in ((REMAT_ORDER, rows, (REMAT_BATCH, REMAT_SEQ)),
                               (REMAT_LOSS_ORDER, loss_rows,
                                REMAT_LOSS_TOKENS)):
        for a, b, strict in order:
            pa, pb = got[a]["peak_bytes"], got[b]["peak_bytes"]
            if not (pa > pb if strict else pa >= pb):
                raise AssertionError(f"{REMAT_PATH} {tokens}: peak {a} {pa} "
                                     f"not {'>' if strict else '>='} {b} "
                                     f"{pb}")
    shallow = get_model(dataclasses.replace(cfg,
                                            n_layers=REMAT_PLAIN_LAYERS))
    shallow_params = {k: v[:REMAT_PLAIN_LAYERS] if k.startswith("layers.")
                      else v for k, v in params.items()}
    grads, loss, *_ = remat_call(shallow, shallow_params, batch, warm=False)
    kernels.reset_launch_counts()
    with plain_versions():
        want, metrics = loss_and_grads(shallow, shallow_params, batch)
    torch.cuda.synchronize()
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"{REMAT_PATH} plain: launches "
                             f"{kernels.launch_counts()}")
    rel = rel_frobenius_vs(grads, want)
    loss_rel = float(abs(loss - metrics["loss"]) / abs(metrics["loss"]))
    if max(loss_rel, *rel.values()) > REMAT_PLAIN_TOL:
        raise AssertionError(f"{REMAT_PATH} against the plain versions: "
                             f"loss {loss_rel}, grads {rel}")
    del grads, want, params, shallow_params
    torch.cuda.empty_cache()
    emit({"phase": "remat", "path": REMAT_PATH, "arch": ARCH,
          "card": card_and_limit(), "tokens": [REMAT_BATCH, REMAT_SEQ],
          "variants": {name: dict(changes) or {"remat_policy": "nothing"}
                       for name, changes in REMAT_VARIANTS.items()},
          "runs": rows, "loss_tokens": list(REMAT_LOSS_TOKENS),
          "loss_runs": loss_rows,
          "against_plain": {"layers": REMAT_PLAIN_LAYERS,
                            "loss_rel_err": loss_rel,
                            "grads_max_rel_frobenius": max(rel.values()),
                            "tol": REMAT_PLAIN_TOL},
          "launches": total})
    return total


def skip_pairs(seq: int, chunk: int) -> int:
    """(row, key) pairs a (batch, head) of causal block-skipping attention
    reads over ``seq`` rows in q chunks of ``chunk``: each chunk the keys up
    to its last row (528 * 1024^2 at 32768 rows in chunks of 1024, against
    1024 * 1024^2 dense)."""
    return sum(chunk * min(a + chunk, seq) for a in range(0, seq, chunk))


def prefill_matmul_flops(cfg, batch: int, seq: int,
                         pairs: int | None = None) -> int:
    """World matmul FLOPs of a dense decoder's prefill from its config: the
    layer weights on every token, attention over every key (4 B H S^2 hd a
    layer; ``pairs`` in place of S^2 under block skipping), and the LM head
    on the last token."""
    L, M, H, KV, hd, F = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.hd, cfg.d_ff)
    layer_weights = L * (2 * M * H * hd + 2 * M * KV * hd + 3 * M * F)
    pairs = seq * seq if pairs is None else pairs
    return (2 * layer_weights * batch * seq + 4 * batch * H * pairs * hd
            * L + 2 * batch * M * cfg.padded_vocab)


def phase_dryrun() -> dict:
    """dryrun: ``python -m repro_torch.launch.dryrun`` on DRYRUN_CELLS, one
    subprocess a cell, all at once, into a temporary ``--out``: a fake
    world of 256 or 512 ranks cannot share this process with grad_sync's
    NCCL group.  Every cell's status is the reference's, llama3.2-1b's
    prefill's world matmul FLOPs equal the closed form of its config, and
    no subprocess initialised CUDA.  A line a cell: a device's collective
    bytes, the world's and a device's matmul FLOPs and temp bytes, and the
    phase's seconds.  With the cells, ``tools/collective_sites.py``
    charges the storages at the peak of ``ARCH``'s DRYRUN_PEAK_SHAPE to
    their ops (``peak_residuals``) and DRYRUN_MOE's decode_32k collectives
    to their sites; ``ARCH``'s 16x16 train_4k moves
    DRYRUN_TRAIN_COLLECTIVES (``train_collectives``), DRYRUN_MOE's holds
    DRYRUN_MOE_TRAIN (``moe_train_held``), its decode_32k
    DRYRUN_MOE_DECODE (``moe_decode_held``), and DRYRUN_RELEASE's cells
    their bytes and temp (``release_held``).  Launches no kernel in this
    process.
    Returns kernel -> launches."""
    from repro_torch.configs import SHAPES

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(
        Path(__file__).resolve().parent / "src")}
    with tempfile.TemporaryDirectory() as out:
        # a cell with --set writes under a directory of its own: its JSON
        # has the default cell's name
        dirs = {cell: Path(out) / "_".join(cell) for cell in DRYRUN_CELLS}
        runs = {cell: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             cell[0], "--shape", cell[2], "--" + cell[1].replace("_", "-"),
             "--out", str(dirs[cell]),
             *(a for kv in cell[3:] for a in ("--set", kv))], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for cell in DRYRUN_CELLS}
        tool = str(Path(__file__).resolve().parent / "tools" /
                   "collective_sites.py")
        peak_json = Path(out) / "peak.json"
        up_json = Path(out) / "moe_decode.json"
        tools = {json_: subprocess.Popen(
            [sys.executable, tool, "--arch", arch, "--shape", shape,
             "--top", "0", "--json", str(json_)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for json_, arch, shape in (
                (peak_json, ARCH, DRYRUN_PEAK_SHAPE),
                (up_json, DRYRUN_MOE, "decode_32k"))}
        cells = {}
        try:
            for cell, run in runs.items():
                arch, mesh, shape = cell[:3]
                stdout, stderr = run.communicate(timeout=DRYRUN_TIMEOUT_S)
                if run.returncode != 0 or \
                        "cuda_initialized=False" not in stdout:
                    raise AssertionError(
                        f"dryrun: {cell} exited {run.returncode}: "
                        f"{stdout[-2000:]} {stderr[-2000:]}")
                res = json.loads((dirs[cell] / mesh / f"{arch}__{shape}.json"
                                  ).read_text())
                if res["status"] != DRYRUN_CELLS[cell]:
                    raise AssertionError(f"dryrun: {cell}: {res}")
                cells[":".join(cell)] = res
            for json_, run in tools.items():
                stdout, stderr = run.communicate(timeout=DRYRUN_TIMEOUT_S)
                if run.returncode != 0:
                    raise AssertionError(
                        f"dryrun: collective_sites {json_.name} exited "
                        f"{run.returncode}: {stdout[-2000:]} "
                        f"{stderr[-2000:]}")
            peak = json.loads(peak_json.read_text())
            up = json.loads(up_json.read_text())
        finally:
            for run in (*runs.values(), *tools.values()):
                if run.poll() is None:
                    run.kill()
                    run.communicate()
    seconds = time.perf_counter() - t0
    launched = kernels.launch_counts()
    for name, r in cells.items():
        if r["status"] == "ok":
            coll = sum(v for k, v in r["collectives"].items()
                       if k != "count")
            print(f"dryrun {name}: collectives {coll} B a device, matmul "
                  f"FLOPs {r['matmul_flops']} world, "
                  f"{r['matmul_flops_per_device']} a device, temp "
                  f"{r['memory']['temp_size_bytes']} B", flush=True)
    llama = f"{ARCH}:single_pod"
    prefill = SHAPES["prefill_32k"]
    want = prefill_matmul_flops(get_config(ARCH), prefill.global_batch,
                                prefill.seq_len)
    got = cells[f"{llama}:prefill_32k"]["matmul_flops"]
    if got != want:
        raise AssertionError(f"dryrun: prefill_32k matmul FLOPs {got}, the "
                             f"closed form {want}")
    # block skipping: the FLOPs of the chunks' key slices, as the
    # reference counts them
    cfg = get_config(ARCH)
    skip_cell = cells[f"{llama}:prefill_32k:swa_block_skip=True"]
    want_skip = prefill_matmul_flops(cfg, prefill.global_batch,
                                     prefill.seq_len, skip_pairs(
                                         prefill.seq_len, cfg.attn_chunk))
    if skip_cell["matmul_flops"] != want_skip:
        raise AssertionError(f"dryrun: prefill_32k under swa_block_skip "
                             f"matmul FLOPs {skip_cell['matmul_flops']}, "
                             f"the closed form {want_skip}")
    prefill_temp = {k: cells[k]["memory"]["temp_size_bytes"] for k in (
        f"{llama}:prefill_32k", f"{llama}:prefill_32k:swa_block_skip=True")}
    print(f"dryrun prefill_32k a device: temp {json.dumps(prefill_temp)} B",
          flush=True)
    # the vocab-parallel loss against the reference's default gather: a
    # device's temp and all-gather bytes both lower
    loss = {flag: {"temp_size_bytes": r["memory"]["temp_size_bytes"],
                   "all_gather_bytes": r["collectives"]["all-gather"],
                   "all_reduce_bytes": r["collectives"]["all-reduce"]}
            for flag, r in (("ce_onehot=False",
                             cells[f"{llama}:train_4k"]),
                            ("ce_onehot=True",
                             cells[f"{llama}:train_4k:ce_onehot=True"]))}
    off, on = loss["ce_onehot=False"], loss["ce_onehot=True"]
    if not (on["temp_size_bytes"] < off["temp_size_bytes"] and
            on["all_gather_bytes"] < off["all_gather_bytes"]):
        raise AssertionError(f"dryrun: train_4k under ce_onehot {loss}")
    print(f"dryrun train_4k a device: temp {off['temp_size_bytes']} B, "
          f"all-gather {off['all_gather_bytes']} B (ce_onehot=False); temp "
          f"{on['temp_size_bytes']} B, all-gather {on['all_gather_bytes']} B "
          f"(ce_onehot=True)", flush=True)
    train_coll = train_collectives(cells[f"{llama}:train_4k"])
    moe_train = moe_train_held(cells[f"{DRYRUN_MOE}:single_pod:train_4k"])
    moe_decode = moe_decode_held(
        cells[f"{DRYRUN_MOE}:single_pod:decode_32k"], up)
    residuals = peak_residuals(peak, cells[f"{llama}:{DRYRUN_PEAK_SHAPE}"])
    release = release_held(cells)
    print(f"dryrun: {len(cells)} cells in {seconds:.3f} s", flush=True)
    emit({"phase": "dryrun", "path": DRYRUN_PATH, "arch": ARCH,
          "residuals_at_peak": residuals,
          "prefill_closed_form_flops": want,
          "prefill_skip_closed_form_flops": want_skip,
          "cuda_initialized": False, "seconds": seconds,
          "train_4k_loss": loss, "train_4k_collectives": train_coll,
          "moe_train_4k": moe_train, "moe_decode_32k": moe_decode,
          "release_held": release,
          "cells": {k: {f: r.get(f) for f in (
              "status", "reason", "chips", "matmul_flops",
              "matmul_flops_per_device", "collectives", "trace_s",
              "decode_pos")} | {k: r.get("memory", {}).get(k) for k in (
                  "argument_size_bytes", "temp_size_bytes")}
              for k, r in cells.items()},
          "launches": launched})
    return launched


def train_collectives(cell: dict) -> dict:
    """Fault I on the card's host: ``ARCH``'s 16x16 train_4k ``cell``
    moves DRYRUN_TRAIN_COLLECTIVES' bytes of each kind, the all-reduces up
    to one fp32 scalar a parameter and mesh dim more.  Prints and returns
    each kind's bytes beside its want."""
    got = cell["collectives"]
    scalars = 4 * 2 * len(get_model(get_config(ARCH)).abstract_params())
    out = {k: {"bytes": got[k], "want": want}
           for k, want in DRYRUN_TRAIN_COLLECTIVES.items()}
    out["all-reduce"]["scalar_slack"] = scalars
    print(f"dryrun {ARCH} train_4k collectives a device: {json.dumps(out)}",
          flush=True)
    extra = {k: got[k] - want for k, want in DRYRUN_TRAIN_COLLECTIVES.items()}
    if any(n for k, n in extra.items() if k != "all-reduce") or \
            not 0 <= extra["all-reduce"] <= scalars:
        raise AssertionError(f"dryrun: {ARCH} train_4k collectives {out}")
    return out


def moe_train_held(cell: dict) -> dict:
    """Fault J on the card's host: ``DRYRUN_MOE``'s 16x16 train_4k
    ``cell`` moves each kind of collective's bytes and holds the temp of
    DRYRUN_MOE_TRAIN within DRYRUN_MOE_REL, and counts its FLOPs exactly.
    Prints and returns each figure beside its want."""
    want = DRYRUN_MOE_TRAIN
    got = {"collectives": {k: cell["collectives"][k]
                           for k in want["collectives"]},
           "temp_size_bytes": cell["memory"]["temp_size_bytes"],
           **{k: cell[k] for k in ("matmul_flops",
                                   "matmul_flops_per_device")}}
    out = {"got": got, "want": want, "rel": DRYRUN_MOE_REL}
    print(f"dryrun {DRYRUN_MOE} train_4k a device: {json.dumps(out)}",
          flush=True)
    pairs = [(got["collectives"][k], n)
             for k, n in want["collectives"].items()]
    pairs.append((got["temp_size_bytes"], want["temp_size_bytes"]))
    if any(abs(g - n) > DRYRUN_MOE_REL * n for g, n in pairs) or any(
            got[k] != want[k] for k in ("matmul_flops",
                                        "matmul_flops_per_device")):
        raise AssertionError(f"dryrun: {DRYRUN_MOE} train_4k {out}")
    return out


def moe_decode_held(cell: dict, sites: dict) -> dict:
    """Fault K on the card's host: ``DRYRUN_MOE``'s 16x16 decode_32k
    ``cell`` counts DRYRUN_MOE_DECODE's FLOPs exactly, and the bytes that
    ``collective_sites.py`` (its JSON, ``sites``) charges to the dispatch
    and the up-projections are held within DRYRUN_MOE_REL.  Prints and
    returns each figure beside its want."""
    want = DRYRUN_MOE_DECODE
    got = {k: cell[k] for k in ("matmul_flops", "matmul_flops_per_device")}
    got["up_projection_bytes"] = sum(
        v["bytes"] for k, v in sites["sites"].items()
        if k.endswith(DRYRUN_MOE_UP_SITE))
    out = {"got": got, "want": want, "rel": DRYRUN_MOE_REL,
           "collectives": cell["collectives"],
           "temp_size_bytes": cell["memory"]["temp_size_bytes"]}
    print(f"dryrun {DRYRUN_MOE} decode_32k a device: {json.dumps(out)}",
          flush=True)
    n = want["up_projection_bytes"]
    if abs(got["up_projection_bytes"] - n) > DRYRUN_MOE_REL * n or any(
            got[k] != want[k] for k in ("matmul_flops",
                                        "matmul_flops_per_device")):
        raise AssertionError(f"dryrun: {DRYRUN_MOE} decode_32k {out}")
    return out


def release_held(cells: dict) -> dict:
    """Faults L and M on the card's host: each cell of DRYRUN_RELEASE
    (16x16) moves each kind of collective's bytes and holds the temp of
    this host's figures within DRYRUN_MOE_REL.  Prints and returns each
    figure beside its want."""
    out = {}
    for (arch, shape), want in DRYRUN_RELEASE.items():
        cell = cells[f"{arch}:single_pod:{shape}"]
        got = {"collectives": {k: cell["collectives"][k]
                               for k in want["collectives"]},
               "temp_size_bytes": cell["memory"]["temp_size_bytes"]}
        held = {"got": got, "want": want, "rel": DRYRUN_MOE_REL}
        print(f"dryrun {arch} {shape} a device: {json.dumps(held)}",
              flush=True)
        pairs = [(got["collectives"][k], n)
                 for k, n in want["collectives"].items()]
        pairs.append((got["temp_size_bytes"], want["temp_size_bytes"]))
        if any(abs(g - n) > DRYRUN_MOE_REL * n for g, n in pairs):
            raise AssertionError(f"dryrun: {arch} {shape} {held}")
        out[f"{arch}:{shape}"] = held
    return out


def peak_residuals(peak: dict, cell: dict) -> dict:
    """Fault H on the card's host: the storages at the peak of ``ARCH``'s
    16x16 ``DRYRUN_PEAK_SHAPE`` (``collective_sites.py``'s JSON,
    ``peak``) of the residual's local size are n_layers +
    DRYRUN_RESIDUALS_EXTRA, and the tool's temp is the dry run's own
    (``cell``).  Prints them by the op and model line that made them;
    returns the count, the bytes each and those sites."""
    from repro_torch.configs import SHAPES

    cfg, shape = get_config(ARCH), SHAPES[DRYRUN_PEAK_SHAPE]
    each = shape.global_batch // DRYRUN_DATA * shape.seq_len * \
        cfg.d_model * 2
    sites = collections.Counter()
    for p in peak["at_peak"]:
        if p["bytes_each"] == each:
            sites[f"{p['op']} {p['model']}"] += p["storages"]
    held, want = sum(sites.values()), cfg.n_layers + DRYRUN_RESIDUALS_EXTRA
    temp = cell["memory"]["temp_size_bytes"]
    print(f"dryrun {ARCH} {DRYRUN_PEAK_SHAPE} peak: {held} storages of the "
          f"residual's {each} B (want {want}), temp "
          f"{peak['temp_size_bytes']} B: {json.dumps(sites)}", flush=True)
    if held != want or peak["temp_size_bytes"] != temp:
        raise AssertionError(
            f"dryrun: {held} residual-sized storages at the peak of "
            f"{ARCH} {DRYRUN_PEAK_SHAPE}, want {want}; temp "
            f"{peak['temp_size_bytes']} against the cell's {temp}: {sites}")
    return {"storages": held, "bytes_each": each, "sites": dict(sites)}


def phase_examples() -> dict:
    """examples: ``python -m repro_torch.examples.serve_lm`` and
    ``train_lm`` at their defaults on the card, every counter reset just
    before and read just after both.  serve_lm: every TAO of its 8
    requests completes; train_lm (200 steps of 8 x 256, checkpoints to a
    temporary ``--ckpt``): every loss finite, the mean of the last 10
    under the first, and the final checkpoint restores bit for bit.  The
    kernels launch as their calls: 2L + 1 norms a prefill, decode step or
    train step's forward, L flash attentions a prefill or forward, and a
    train step's backward recomputes each layer's (``step_launches``).
    Returns kernel -> launches."""
    kernels.reset_launch_counts()
    served = serve_lm.main(["--device", "cuda"])["served"]
    with tempfile.TemporaryDirectory() as ckpt:
        trained = train_lm.main(["--ckpt", ckpt])
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        step, restored = trained["mgr"].restore(
            {"params": trained["params"], "opt": trained["opt"]})
        same = step == len(trained["losses"]) and all(
            torch.equal(restored["params"][k], v)
            for k, v in trained["params"].items()) and all(
            torch.equal(getattr(restored["opt"], f)[k], v)
            for f in ("mu", "nu") for k, v in
            getattr(trained["opt"], f).items())
    if not same:
        raise AssertionError("examples: train_lm's final checkpoint does not "
                             "restore")
    n_req = 8
    types = collections.Counter(r.type for r in served.result.trace)
    if served.result.completed != types["prefill"] + types["decode"] or \
            types["prefill"] != n_req:
        raise AssertionError(f"examples: serve_lm ran {dict(types)}")
    losses = trained["losses"]
    if not np.isfinite(losses).all() or not np.mean(losses[-10:]) < losses[0]:
        raise AssertionError(f"examples: train_lm losses {losses}")
    s_norms, s_flash = call_launches(serve_lm.demo_config())
    t_norms, t_flash = step_launches(train_lm.config_100m())
    calls = 1 + types["prefill"], 1 + types["decode"]  # and one warm each
    want = {name: 0 for name in KERNELS}
    want.update(rmsnorm=s_norms * sum(calls) + t_norms * len(losses),
                flash_attention=s_flash * calls[0] + t_flash * len(losses))
    if launched != want:
        raise AssertionError(f"examples: launches {launched}, want {want}")
    emit({"phase": "examples", "path": EXAMPLES_PATH,
          "serve_lm": {"taos": served.result.completed,
                       "makespan_s": served.makespan,
                       "tokens_per_s": served.tokens_per_s},
          "train_lm": {"params": trained["model"].param_count(),
                       "steps": len(losses), "first_loss": losses[0],
                       "last_loss": losses[-1], "seconds":
                       trained["seconds"], "checkpoint_step": step},
          "launches": launched})
    return launched


def entry_totals() -> dict:
    """entry point -> its launches since the script started (the phases
    reset the counts, not the totals)."""
    return {name: counter.total
            for name, (_, counter) in kernels.ENTRY_POINTS.items()}


def entry_points(kernel: str, checked: dict, main_err: dict,
                 times: dict) -> list:
    """The kernels line's entries of ``kernel``'s entry points: launches
    on the paths (those after the checks and times, ``checked`` their
    totals), their error and times at the split norm's shapes (the
    2-piece numbers on top)."""
    out, totals = [], entry_totals()
    for name, (owner, _) in kernels.ENTRY_POINTS.items():
        if owner != kernel:
            continue
        main_t = times[name][f"gated_norm/{SPLIT_PIECES[0]}"]
        out.append({
            "name": name, "route": "cuda", "source": KERNELS[kernel][0],
            "replaces": KERNELS[kernel][1],
            "launches": totals[name] - checked[name],
            "caller": "models.layers.rmsnorm on a row split across ranks "
                      "(no card path: one card splits no row)",
            "launches_checked_and_timed": checked[name],
            "max_abs_err": main_err[name],
            "ms": main_t["kernel_ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"],
            "times_by_shape": {key: {k: t[k] for k in (
                "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "l2")} for key, t in times[name].items()}})
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 = "highest"
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    main_err = phase_kernels()
    times = phase_times()
    checked = entry_totals()
    check_slice_outputs()
    launches = phase_slice(times)
    launches[MODEL_PATH], ref_rms = phase_model()
    launches.update(phase_moe(ref_rms))
    phase_grads()
    launches.update(phase_families())
    launches.update(phase_serve(times))
    launches[TRAIN_PATH] = phase_train()
    phase_train_vs_cpu()
    launches[ORCH_TRAIN_PATH] = phase_train_orchestrated()
    phase_checkpoint()
    for path, phase in ((MULTI_IMPL_PATH, phase_multi_impl),
                        (FLEET_PATH, phase_fleet),
                        (GRAD_SYNC_PATH, phase_grad_sync),
                        (EXAMPLES_PATH, phase_examples),
                        (DRYRUN_PATH, phase_dryrun),
                        (SHARDED_PATH, phase_sharded),
                        (REMAT_PATH, phase_remat)):
        t_phase = time.perf_counter()
        launches[path] = phase()
        emit({"phase": "seconds", "path": path,
              "seconds": time.perf_counter() - t_phase})
    entries = []
    for name, (src, replaces, _) in KERNELS.items():
        on_path = {p: launches[p][name] for p in KERNEL_PATHS[name]}
        if on_path and min(on_path.values()) == 0:
            raise AssertionError(f"{name} was not launched on {on_path}")
        main_t = times[name][MAIN_SHAPE[name]]
        # a kernel no path runs (triad: no caller in either package) shows
        # 0 launches and says so
        caller = {} if on_path else {"caller": None}
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": min(on_path.values(), default=0),
            **caller,
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": main_err[name],
            "ms": main_t["kernel_ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"],
            "times_by_shape": {key: {k: t[k] for k in (
                "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "l2")} for key, t in times[name].items()},
            "entry_points": entry_points(name, checked, main_err,
                                         times)})
    emit({"phase": "wall", "seconds": time.perf_counter() - t0})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
