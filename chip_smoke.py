#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one H100; exits non-zero on any failure

Phases, each fatal on failure:

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, in parallel) and print the seconds; print the
   card's name and power limit as nvidia-smi reports them; print how many
   HGMMA (wgmma) and HMMA instructions each kernel function of the
   flash-attention, matmul, ssd, ring and MLA-decode libraries holds
   (``cuobjdump -sass``), and fail unless each tensor-core attention
   kernel, the absorbed decode's tensor-core kernel
   (``mla::decode_wgmma``), the wgmma
   matmul (``wg::mm`` and its gated form ``wg::mm_gated``), the
   tensor-core scan (``tc::ssd``) and the tensor-core ring kernels (the
   AG-matmul, matmul-RS and contracted AG-matmul,
   ``ringtc::ag_wgmma<false>``, ``ringtc::rs_wgmma``,
   ``ringtc::contract_wgmma<false>``; their int8 wire's forms,
   ``ringtc::ag_wgmma<true>``, ``ringtc::rs_int8_wgmma``,
   ``ringtc::contract_wgmma<true>``) hold HGMMA;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it (qwen3-0.6b at full
   width), in fp32 and bf16, with the tolerance and its reason; time the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (a yardstick only: the port never calls it), beside
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the peak); where the attention forward or backward takes the
   tensor cores (bf16), the SIMT path is held and timed on the same inputs
   too, the two timed in turns, and each ``case`` line names its path;
   likewise a bf16 matmul, gated matmul or tile matmul on the wgmma path
   is held and timed on the wmma path too, and a bf16 decode matmul or
   gate on the gemv path against the skinny path, in turns; each gated
   case also times ``torch.matmul(x, [w1 | w1b])``, the two products
   alone (``products_only_ms``: a yardstick of the products, not of the
   gate);
3. check that one prompt's prefill logits through the kernels match the
   plain-op forward;
4. check the loss and every parameter's gradient of one training
   microbatch through the kernels against the plain-op path's autograd:
   bf16 at full depth, fp32 at two layers;
5. train full-width qwen3-0.6b (bf16 compute, fp32 masters) through the
   training launcher's code path, then measure peak memory and step time
   under each remat policy;
6. serve full-width qwen3-0.6b in bf16 through the serving entry point;
7. the SSM slice (mamba2-130m at full width): hold the SSD scan kernel
   against its plain version at the prefill shapes (bf16 and fp32, zero
   and random initial states, plus 17 chunks, a chunk short of its tile,
   groups at batch 2, S = 2, and a small grouped SIMT case); a bf16 case
   on the tensor-core route (``tc::ssd``) is held and timed on the SIMT
   route too, the two in turns, and must repeat bit for bit; check a
   300-token prefill and 8 decode steps through the kernels against the
   plain path (bf16 at 24 layers, fp32 at 2), and serve it in bf16
   through the serving entry point;
   random weights from a seed, made on the card, in 5 to 7.  The kernels'
   launch counts are zeroed just before the training run and each serving
   run and read just after each, and every kernel of each path must show
   launches; the attention wrapper's per-path counts must show every
   training forward and backward on the tensor cores, and every served
   prefill of 256 or 512 tokens; the matmul wrapper's must show every
   training tile matmul and gate, and every served matmul and gate with
   M > 16 (a prefill), on wgmma, and every served bf16 matmul and gate
   with M <= 16 (decode) on gemv; the scan's per-route counts
   (``ssm_ssd_paths``) every SSM prefill scan on wgmma;
8a. ``ring_loopback``: every ring kernel and int8 variant over a loopback
   ring (``kernels/ring_loopback.py``: all n ranks of one ring in this
   process, each on its own stream over its own buffer, every grid capped
   at its share of the card so that the n grids are resident together),
   n = 2 at the RING_CASES and n = 4 at the MEG_RING_CASES, bf16 and fp32:
   every rank's output against the ring's global result computed in fp32
   (on the int8 wire its emulated semantics), over three calls (one from
   hop 0, two carrying the hops on), at ``_ring_case``'s bounds; each
   case timed by CUDA-graph replays of one call (n streams forked from
   one and joined to it) beside one batched ``torch.matmul`` of the n
   ranks' products and n x a rank's bound; a bf16 case of any ring kernel
   on the wgmma route, on either wire, is held and timed on the wmma
   route too, in turns (``case`` lines with ``"loopback": true`` and
   ``"route"``).  These are
   the ring kernels' own times, and the main rows of the kernels line;
8. ``ring_kernels``: two rank processes on the card, one ring of n = 2
   through the symmetric buffers: a ping-pong probe of the cross-process
   flags (200 round trips in one launch each way, under a watchdog;
   rounds/s), then each ring kernel (AG-matmul, matmul-RS over columns
   and the gated pair over tokens, the contracted AG-matmul) held against
   its plain version at the grid step's five full-width bf16 blocks, the
   two further blocks its backward passes (matmul-RS over tokens of the
   K/V and FFN-down input gradients) and ragged shapes (one off 8
   elements), in bf16 and fp32, timed beside its bound and the
   compute-only ``torch.matmul`` on the gathered operand; then four rank
   processes, one ``model`` ring of n = 4 (megatron's axis of the 1x2x2
   ranks): matmul-RS over tokens at the megatron step's two full-width
   exit blocks, the AG-matmul of their backward, and the replicated
   layout's matmul-RS over columns with its backward's contracted
   AG-matmul, on both wires, against their plain versions (``case`` lines
   with ``"n": 4``; the time-sliced processes time the scheduler, so
   none of these is a main row);
9. ``grid_train``: the hecaton grid training step of full-width
   qwen3-0.6b at 2 of its 28 layers (GRID_LAYERS) on a 1x2x2 grid of four
   rank processes sharing the card
   (``overlap="fused"``, bf16 over fp32 masters, batch 8 x 512, 2
   microbatches, remat fusion, 3 steps) through the training launcher's
   grid entry: its route table, every rank's launches (each of the three
   ring kernels must launch on every rank, every one on the wgmma route,
   ``grid_train_ring_paths``; likewise in ``grid_pipeline_hecaton``,
   ``grid_pod_data`` and ``grid_serve``'s prefill, and in
   ``grid_megatron``, which must launch its AG-matmul and matmul-RS and
   launches no contracted ring), every step's loss and grad
   norm against the same grid trained through the plain versions from
   the same parameters (1e-3 and 1e-2 relative), the first step's loss
   against the single-device port on the same parameters and batch
   (1e-3), how far each leaf's final value lies from the plain run's
   (over the plain run's update; reported), and step ms, which four
   time-sliced ranks on one card make no grid speed;
10. ``grid_train_int8``: the same grid step on the int8 wire
   (``--comm-dtype int8``, 2 steps, full width, 2 layers): every rank
   launches each of the three int8 ring-kernel variants, every one on the
   wgmma route (``grid_train_int8_ring_paths``), every step's
   loss and grad norm within 1e-3 and 1e-2 of the plain int8 grid, the
   first loss within 5e-2 of the bf16 wire's (JAX's QUANT_RTOL); the
   ``ring_kernels`` phase also holds the int8 variants against their
   plain versions at the same blocks, in fp32 tightly enough (1e-5 on
   all but 0.1% of the elements, one int8 level there) that the bf16
   wire's kernel fails the same check, which it prints;
11. ``grid_bidir``: ``--overlap bidir --comm-dtype int8`` at 2 layers for
   one step (the -1 hops through the symmetric buffers; no kernel of its
   own), against the plain grid; its ``grid_bidir_ring_paths`` line must
   show no int8 AG-matmul or contracted AG-matmul launch at all, since the
   two-way rings fuse no ring kernel;
11b. ``grid_megatron``: the paper's baseline, ``--strategy megatron`` on
   the same four ranks (one ``model`` ring of four, the seq residual,
   ``overlap="fused"``), full width at 2 layers, bf16, batch 8 x 512, 2
   microbatches, 2 steps, through the launcher's grid entry: every step's
   loss and grad norm against the plain megatron grid (1e-3, 1e-2), the
   first loss against the single-device port (1e-3), every rank launching
   the matmul-RS and AG-matmul ring kernels (and the training kernels);
   its routes, launches and step ms, and each rank's NoP bytes per step
   (the logged forward collectives, recompute included:
   ``overlap.route_bytes``) beside the ``grid_train`` hecaton run's, in
   ``grid_nop_bytes``;
12. ``ckpt``: checkpoints of the training cell on one card through the
   launcher's ``--ckpt-*`` flags, in a temporary directory, at 8 of the
   28 layers (CKPT_LAYERS; cut further only if two checkpoints do not fit
   on its disk): two uninterrupted
   6-step references (bit-equal, or their spread sets the gate), a run
   saving async every 2 steps (keep 2, 2 writers) to step 4, a fresh run
   that must restore step 4 and meet the gate on steps 4 and 5; one
   blocking save and one restore timed (the restore bit-equal), and the
   staging arena's snapshot (a slot's first use and its reuse) beside a
   pageable copy; the
   line gives checkpoint bytes, each async save's stall, each background
   write's seconds and GB/s, and the median step with and without a write
   in flight;
13. ``grid_ckpt``: the 1x2x2 grid (fused, bf16 wire, 2 layers at full
   width) saving after each step; a fresh grid restores step 1 and runs
   step 2 against the uninterrupted run's (1e-3 relative), and one card
   restores the grid's checkpoint and runs step 2 against the grid's
   (1e-3); stalls, writes and restore times as above;
14. ``runtime``: the training runtime (``runtime/``) on the training cell
   (bf16 over fp32 masters, batch 8 x 512, 2 microbatches, remat fusion,
   the kernels on): ``guard_skip`` (2 layers) runs 5 guarded steps with
   batch 2's ``loss_mask`` all NaN: ``update_skipped`` only at step 2,
   every parameter and moment ``torch.equal`` across it, the other
   losses against two runs over the stream without batch 2 (the ``ckpt``
   gate); ``rollback`` (2 layers) runs ``run_supervised`` over an
   ``AsyncCheckpointManager`` (2 writers, every 2 steps) with NaN at data
   3 and 4 and ``skip_cap`` 2: the ``DivergenceError`` names step 3 and
   data (3, 4), the save of step 4 (published before the rollback) is
   retired, ``blocklist.json`` holds [3, 4], and after a later step held
   by a host sleep past
   ``hang_timeout`` (``HangError``) the restart resumes from the last
   published step; each incarnation's losses and the final state against
   two clean runs over the filtered stream (the ``ckpt`` gate);
   ``ckpt_procs`` runs the ``ckpt`` phase's saving run again through
   the launcher with ``--ckpt-procs`` (2 writer processes), reported
   beside the ``ckpt`` phase's run with writer threads (median step with
   a write in flight and with none, boundary stall, write s and GB/s,
   the fleet's pack s, spawn-to-first-heartbeat s, the handover: shm or
   spill), resumes from the fleet's step 4 against the ``ckpt`` phase's
   references, and at 2 layers saves once with
   writer 1 SIGKILLed in its torn window: published with
   ``reassigned["1"]``, restored bit-equal, the thread writers' files
   apart from that record;
15. ``grid_runtime``: the 1x2x2 grid at 2 layers through the launcher
   with ``--guard --ckpt-procs`` and a ``blocklist.json`` in its
   directory: the four ranks' loss histories identical, the first data
   index ``data_index(0, blocklist)``, the writers children of rank 0, and
   one card restoring the fleet-written step within 1e-3 of the grid;
16. ``grid_pipeline``: the inter-pod 1F1B pipeline through the launcher's
   ``--pods 2 --pod-role pipeline``: full-width paper-tinyllama-1.1b (d
   2048, 32/4 heads of dh 64, d_ff 5632, vocab 32,000, untied head) at 4
   of its 22 layers (PIPE_LAYERS, 2 a stage) on two one-rank stages sharing the card, bf16
   over fp32 masters, batch 8 x 512 in 4 microbatches, remat fusion, 2
   steps, beside the plain pipeline from the same parameters: every
   step's loss and grad norm against it (1e-3, 1e-2), the first loss
   against the single-device port (1e-3), each stage's executed order
   against ``stage_order`` and its stash peak against min(p - s, m), the
   tile matmul, the gate, the SwiGLU backward and attention forward and
   backward launched on every rank, no rank launching the forward-only
   product (the F ticks run the recompute's differentiable ops), every
   attention launch on the tensor cores and every product and gate on
   wgmma; the boundary bytes each
   rank receives per step, and step ms (time-sliced: not a pipeline
   speed); the kernels held at this model's shapes first (``case`` lines
   off the ``kernels`` line's sums); then ``grid_pipeline_hecaton``, the
   same pipeline over 1x1x2 hecaton stages (four ranks, ``overlap=
   "fused"``, 2 layers, 1 step), each of the three ring kernels launched
   on every rank, against its plain pipeline;
17. ``grid_pod_data``: the pod axis as data parallelism through the
   training launcher's ``--pods 2 --pod-role data`` over a 1x1x2 grid a
   pod (four rank processes; the batch, the gradient sum and the ZeRO-1
   moments over ``("pod", "data")``), the training cell's settings at
   full width and 2 layers, ``overlap="fused"``, 2 steps: the
   ``grid_train`` gates against the plain pod-data grid, every rank
   launching the three ring kernels;
18. ``serve_dense``: full-width qwen3-0.6b in fp32, each prompt of 64,
   256, 512 and 512 tokens prefilled into its own dense KV cache
   (``serve/step.build_prefill``) and decoded GEN tokens greedily; every
   sequence's tokens must equal the paged engine's on the same prompts;
19. ``serve_quant_kv``: the ``serve`` trace through ``--quant-kv`` (the
   int8 paged arena): every request finishes; one int8 block is (128 +
   4) / 256 of the bf16 pool's exactly; every K/V row the bf16 arena
   holds, written on the card through ``quant_paged_write``, reads back
   through ``quant_paged_gather`` within scale / 2, each scale max |row|
   / 127 of its row; the first decode
   tick's logits, teacher-forced on the same tokens, within a bound of
   the bf16 arena's; decode tok/s beside the ``serve`` line's (both
   host-bound);
20. ``grid_serve``: full-width qwen3-0.6b served on the 1x2x2 grid of
   four rank processes (hecaton, fused, bf16) through the serving
   launcher's grid entry: a prefill of 4 x 512 into sharded dense caches
   (the ring kernels) and 16 decode ticks (the 1D layout) teacher-forced
   on the one-card dense path's greedy tokens; every step's logits on
   every rank within a bound of that path's;
21. ``mla_kernels``: multi-head latent attention (minicpm3-4b at full
   width: 40 heads, latent 256, rope 32, dn = dv = 64): the absorbed
   decode kernel (``csrc/mla_decode.cu``) against its plain version at
   the serving tick (4 slots over the pool's 544-row page view, one slot
   idle; the kernels line's row) and off it (B 1 to 3, T 64, off the
   key tiles, an empty row), bf16 and fp32, fp32 out held to 2e-4; every
   bf16 case on the tensor cores (``mla::decode_wgmma``), the SIMT route
   held and timed in turns beside it, fp32 on SIMT; the
   attention forward (the three prefills, the training microbatch) and
   backward at dk 96 / dv 64, natively on the tensor cores in bf16 (the
   route that padded v to 96 and all three to 128 held and timed in
   turns beside it, SDPA's yardstick the faster of its call on v at 64
   and at 96), off the kernels line's sums;
22. ``mla_model_check``: a 300-token prefill and 8 decode steps through
   the kernels against the plain path, bf16 at 62 layers, fp32 at 2 (the
   ``ssm_model_check`` gates); the absorbed decode launched once a layer
   and step (bf16 on wgmma, fp32 on SIMT), every bf16 prefill's
   attention on the tensor cores at (96, 64), natively;
23. ``serve_mla``: full-width minicpm3-4b served in bf16 through the
   serving entry point (the serve phase's trace, prompts 64/256/512):
   the serve gates, every decode tick (the warm-up's too) launching the
   absorbed decode kernel 62 times, every launch on the tensor cores
   (``mla::decode_wgmma``), every prefill's attention on wgmma at (96,
   64), natively;
24. ``serve_mla_quant_kv``: the same trace through ``--quant-kv`` (the
   ``serve_quant_kv`` gates; one int8 latent block exactly (256 + 4 + 32
   + 4) / 576 of bf16's; every prefill's attention native at (96, 64);
   every absorbed decode launch on the tensor cores);
25. ``train_mla``: full-width minicpm3-4b at 8 of its 62 layers through
   the training launcher (bf16 over fp32 masters, batch 8 x 512, 2
   microbatches, remat fusion, 4 steps): every training kernel, every
   attention launch on wgmma at (96, 64), natively, step ms and peak
   memory; then the loss and
   every gradient of one microbatch against the plain path
   (``mla_grad_check``, the ``grad_check`` gates at 8 and 2 layers);
26. ``moe_kernels``: the MoE's expert kernels (``csrc/moe.cu``) against
   their plain versions: the grouped gated product and the grouped
   down-projection at granite-moe-3b-a800m's widths (E 40, H 1536, F 512,
   swiglu) at C = 1, 16, 37, 64 and 128 rows an expert (the first five
   experts' slots empty, the next five half empty), bf16 (C 1 and 16 on
   the gemv route, the rest on wgmma) and fp32 at C 1 and 37 (simt); one
   layer of grok-1-314b's experts (E 8, H 6144, F 32768, geglu) at C 1 and
   160 in bf16; the combine at T 4 and 512 tokens, k 8, over a real
   dispatch's slots (dropped assignments included), bf16 and fp32, which
   must equal its plain version bit for bit; each case with its bound and
   a library yardstick (one ``torch.bmm`` for the down-projection, two for
   the gated product's products only; one ``F.embedding_bag`` for the
   combine);
27. ``moe_model_check``: granite-moe-3b-a800m at full width, a 300-token
   prefill and 8 decode steps through the kernels against the plain
   path, every path on the kernel path's routing (each layer's top-k
   choices replayed: a near-tie flips between two paths and the flipped
   tokens' rows spread): bf16 at 8 layers within 5e-2 of the plain bf16
   path and as close to the plain fp32 forward as the plain bf16 path
   (25% margin), where controls (the gated product's products rounded to
   bf16 as JAX rounds them; the expert weights rounded to fp8 e4m3 and
   e5m2) are held to the same gates and the fp8 ones must fail them;
   bf16 at all 32 layers, the fp32-distance gate; fp32 at 32 layers
   within 1e-4; every grouped launch on the route its C calls for (the
   prefill's C 75 on wgmma, decode's C 1 on gemv; fp32 on simt), each
   MoE kernel once a layer and step; reported beside them the two bf16
   paths' gap at 32 layers and, per layer, the top-k choices they differ
   on, each routing freely;
28. ``serve_moe``: full-width granite-moe-3b-a800m served in bf16 through
   the serving entry point (the serve phase's trace, prompts 64/256/512):
   the serve gates, each MoE kernel launched once a layer in every
   prefill and tick (the warm-up's too), decode and the 64-token prefills
   (C <= 16) on gemv, the other prefills on wgmma, none on simt
   (``serve_moe_paths``);
29. print every phase's seconds (``phase_s``), then one JSON line of
   per-kernel numbers, then the result line.

``--profile`` also traces decode ticks of both serving runs and one
training step with torch.profiler and prints the device's busy share and
its time per kernel, also summed by kernel family (``profile_kernels``
and ``profile_train_kernels``: wg::mm, wg::mm_gated, gv::gemv, the old
paths, the attention kernels), and one 512-token prefill of the SSM
model: its device time and the scan's share (``profile_prefill``).
"""

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint import manager as ckpt_manager  # noqa: E402
from repro_torch.config import GuardConfig, ParallelConfig, RunConfig, get_config  # noqa: E402
from repro_torch.data.synthetic import Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import ring_matmul as krm  # noqa: E402
from repro_torch.kernels import ring_loopback as LB  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import matmul as kmm  # noqa: E402
from repro_torch.kernels import moe as kmoe  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.kernels import swiglu as ksw  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import Grid  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mlp as MLP  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel.context import PCtx  # noqa: E402
from repro_torch.runtime import fault as rt_fault  # noqa: E402
from repro_torch.runtime import guard as rt_guard  # noqa: E402
from repro_torch.serve.cache import CachePool, PoolConfig, dense_cache_bytes  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,             # dense bf16 tensor cores
            torch.float32: 67e12}               # fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
# keyed on the OUTPUT's dtype: an fp32 output of bf16 inputs (the tied
# head's logits, the gated kernel's kept products) is exact products summed
# in fp32 in another order, so it is held to the fp32 bound, and a kernel
# that rounded it to bf16 on the way out would fail
TOL = {torch.float32: (2e-4, "fp32 sums in another order; the repo's fp32 bound"),
       torch.bfloat16: (2e-2, "one bf16 rounding of the output (2^-8 relative); "
                              "the repo's bf16 bound")}
ARCH = "qwen3-0.6b"
SLOTS, BLOCK, REQUESTS, GEN = 4, 16, 8, 32
PROMPT_LENS = (64, 256, 512)
SEED = 0
DEV = "cuda"
# training: --batch 8 --seq 512 --microbatches 2, so a microbatch is 4 x 512
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 512, 2, 7     # 1 warm-up + 6
TRAIN_M = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ                    # tokens per microbatch
KERNELS = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:90"),
    "gated_matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                     "src/repro/kernels/matmul.py:132"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:84"),
    "tile_matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                    "src/repro/kernels/ring_matmul.py:225"),
    # no Pallas backward exists: these are the derivatives of the kernels above
    "swiglu_bwd": ("src/repro_torch/kernels/csrc/swiglu_bwd.cu",
                   "src/repro/kernels/matmul.py:132"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:84"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:88"),
    "ag_matmul": ("src/repro_torch/kernels/csrc/ring_matmul.cu",
                  "src/repro/kernels/ring_matmul.py:896"),
    "matmul_rs": ("src/repro_torch/kernels/csrc/ring_matmul.cu",
                  "src/repro/kernels/ring_matmul.py:1118"),
    "ag_matmul_contract": ("src/repro_torch/kernels/csrc/ring_matmul.cu",
                           "src/repro/kernels/ring_matmul.py:1290"),
    # the int8 wire: the same pallas_call sites with quant set
    "ag_matmul_int8": ("src/repro_torch/kernels/csrc/ring_matmul.cu",
                       "src/repro/kernels/ring_matmul.py:896"),
    "matmul_rs_int8": ("src/repro_torch/kernels/csrc/ring_matmul.cu",
                       "src/repro/kernels/ring_matmul.py:1118"),
    "ag_matmul_contract_int8": ("src/repro_torch/kernels/csrc/ring_matmul.cu",
                                "src/repro/kernels/ring_matmul.py:1290"),
    # MLA's absorbed decode has no pallas_call: it replaces the decode
    # form's einsums of apply_mla
    "mla_decode": ("src/repro_torch/kernels/csrc/mla_decode.cu",
                   "src/repro/models/attention.py:511"),
    # the MoE's experts have no pallas_call: these replace _moe_local's
    # einsums (the gated up-projection, the down-projection) and its
    # scatter-add
    "moe_grouped_gated": ("src/repro_torch/kernels/csrc/moe.cu", "src/repro/models/mlp.py:115"),
    "moe_grouped_mm": ("src/repro_torch/kernels/csrc/moe.cu", "src/repro/models/mlp.py:126"),
    "moe_combine": ("src/repro_torch/kernels/csrc/moe.cu", "src/repro/models/mlp.py:130"),
}
RING_KERNELS = ("ag_matmul", "matmul_rs", "ag_matmul_contract")
INT8_KERNELS = tuple(k + "_int8" for k in RING_KERNELS)
# the grid step's per-rank blocks at full width (qwen3-0.6b, 1x2x2, a
# microbatch of 4 x 512): the five forward blocks and the two that only the
# backward passes (its other blocks repeat these shapes), then ragged
# extents (off the 64 x 64 tiles, and off 8 elements) as the backward
# passes them without a gate: (kernel, label, x, w, scatter_dim, main)
RING_CASES = (
    ("ag_matmul", "K/V in-projection", (4, 256, 512), (512, 512), None, True),
    ("ag_matmul", "FFN down-projection", (4, 256, 1536), (1536, 512), None, True),
    ("matmul_rs", "Q in-projection, columns", (4, 512, 512), (512, 1024), 2, True),
    ("matmul_rs", "gated up pair, tokens", (4, 512, 512), (512, 1536), 1, True),
    ("ag_matmul_contract", "attention O-projection", (4, 512, 512), (1024, 512), None, True),
    ("matmul_rs", "K/V input gradient, tokens", (4, 512, 512), (512, 512), 1, True),
    ("matmul_rs", "FFN-down input gradient, tokens", (4, 512, 512), (512, 1536), 1, True),
    ("ag_matmul", "ragged", (2, 100, 200), (200, 264), None, False),
    ("ag_matmul", "ragged off 8", (3, 50, 45), (45, 27), None, False),
    ("matmul_rs", "ragged off 8 tokens", (3, 52, 45), (45, 27), 1, False),
    ("matmul_rs", "ragged columns", (2, 100, 200), (200, 264), 2, False),
    ("matmul_rs", "ragged tokens", (2, 100, 200), (200, 264), 1, False),
    ("ag_matmul_contract", "ragged", (2, 100, 200), (400, 264), None, False),
)
# megatron's ring of four (the model axis of GRID's ranks) at the blocks
# its full-width step passes the ring kernels: the seq layout's exit
# matmul-RS over tokens and its backward's AG-matmul (the FFN down's
# contracted dim, 768, is off the 512-deep tile, so JAX's gate sends it to
# the ring; timed here all the same), the replicated layout's matmul-RS
# over columns and its backward's contracted AG-matmul; off the kernels
# line's sums (main False)
MEG_RING_CASES = (
    ("matmul_rs", "megatron O-projection, tokens", (4, 512, 512), (512, 1024), 1, False),
    ("matmul_rs", "megatron FFN down, tokens", (4, 512, 768), (768, 1024), 1, False),
    ("ag_matmul", "megatron O-projection input gradient", (4, 128, 1024), (1024, 512), None,
     False),
    ("ag_matmul", "megatron FFN-down input gradient", (4, 128, 1024), (1024, 768), None, False),
    ("matmul_rs", "megatron replicated O-projection, columns", (4, 512, 512), (512, 1024), 2,
     False),
    ("ag_matmul_contract", "megatron replicated O-projection input gradient", (4, 512, 256),
     (1024, 512), None, False),
)
PROBE_ROUNDS = 200
GRID = (1, 2, 2)
GRID_STEPS = 3
# the depth of grid_train, grid_train_int8 and grid_megatron (cut from 28
# to 8, then to 2, to keep the script's time; every layer runs the same
# kernels, and the three share one depth, as their loss and NoP-byte
# comparisons need)
GRID_LAYERS = 2
GRID_TIMEOUT_S = 900
# the kernels' grid against the plain versions' grid (and the first loss
# against the single-device port): bf16 sums in other orders
GRID_LOSS_TOL, GRID_GNORM_TOL = 1e-3, 1e-2
RING_TIMEOUT_S = 300
GRID_LABEL = "4 ranks time-sliced on one card; not a grid speed"
# the int8 wire: 2 full-width steps; the first loss against the bf16
# wire's (JAX's QUANT_RTOL, tests/_mp/check_overlap.py)
INT8_STEPS, QUANT_RTOL = 2, 0.05
# bidir: a short run at cut depth (it runs no kernel of its own); the
# depth of the other short grid runs too (cut from 4 to 2)
BIDIR_LAYERS, BIDIR_STEPS = 2, 1
# megatron (the paper's baseline) on GRID's ranks: GRID_LAYERS, 2 steps; every
# rank must launch these kernels
MEG_STEPS = 2
MEG_KERNELS = ("matmul_rs", "ag_matmul", "tile_matmul", "gated_matmul", "flash_attention",
               "flash_attention_bwd", "swiglu_bwd")
# the int8 ring cases in fp32: the kernel and its plain version quantize
# the same values up to fp32 sums in another order, so all but a share of
# INT8_SHARE elements agree to INT8_TOL; those may sit one int8 level of
# the output apart (a value on a rounding boundary); the bf16 wire's kernel
# on the same inputs must fail this check
INT8_TOL, INT8_SHARE = 1e-5, 1e-3
SERVE_KERNELS = ("matmul", "gated_matmul", "flash_attention")
# the SSM slice: mamba2-130m served with prompts at their exact lengths
SSM_ARCH = "mamba2-130m"
SSM_PROMPT_LENS = (64, 200, 512)
SSM_CHECK_PROMPT, SSM_CHECK_DECODE = 300, 8
SSM_SERVE_KERNELS = ("matmul", "ssd")
TRAIN_KERNELS = ("tile_matmul", "gated_matmul", "flash_attention", "swiglu_bwd",
                 "flash_attention_bwd")
# prefill lengths that must take the tensor-core attention path when served
TC_PREFILLS = (256, 512)
# the tensor-core attention kernels tc::fwd, tc::bwd_dq, tc::bwd_dkdv, as the
# prefixes of their mangled names in the library's SASS
TC_FUNCTIONS = ("_ZN2tc3fwd", "_ZN2tc6bwd_dq", "_ZN2tc8bwd_dkdv")
# the wgmma matmul wg::mm and its gated form wg::mm_gated, likewise in the
# matmul library's SASS
WG_FUNCTIONS = ("_ZN2wg2mm", "_ZN2wg8mm_gated")
# the tensor-core SSD scan tc::ssd, likewise in the ssd library's SASS
SSD_TC_FUNCTIONS = ("_ZN2tc3ssd",)
# the tensor-core ring kernels ringtc::ag_wgmma<false>, ringtc::rs_wgmma and
# ringtc::contract_wgmma<false> (rows 5, 6 and 7 on wgmma), ringtc::ag_wgmma<true>,
# ringtc::rs_int8_wgmma and ringtc::contract_wgmma<true> (rows 5i, 6i and 7i), likewise
# in the ring library's SASS
RING_TC_FUNCTIONS = ("_ZN6ringtc8ag_wgmmaILb0E", "_ZN6ringtc8rs_wgmma",
                     "_ZN6ringtc14contract_wgmmaILb0E", "_ZN6ringtc8ag_wgmmaILb1E",
                     "_ZN6ringtc13rs_int8_wgmma", "_ZN6ringtc14contract_wgmmaILb1E")
# the absorbed MLA decode's tensor-core kernel mla::decode_wgmma, likewise in the
# mla_decode library's SASS
MLA_TC_FUNCTIONS = ("_ZN3mla12decode_wgmma",)
# the MoE's grouped wgmma products moe::grouped_wgmma<false> and <true> (the
# gated form), likewise in the moe library's SASS
MOE_TC_FUNCTIONS = ("_ZN3moe13grouped_wgmmaILb0E", "_ZN3moe13grouped_wgmmaILb1E")
# the ring kernels that take a route (ring_matmul.ring_impl): every bf16 launch
# of these at the grid phases' full-width blocks must be on wgmma, on the bf16
# wire and on the int8 wire
ROUTED_RING = ("ag_matmul", "matmul_rs", "ag_matmul_contract")
ROUTED_INT8 = ("ag_matmul_int8", "matmul_rs_int8", "ag_matmul_contract_int8")
# the loopback ring (kernels/ring_loopback.py): all n ranks of one ring in this
# process, on n streams: (n, the axis whose buffer layout it takes, the cases)
LOOPBACK_RINGS = ((2, "my", RING_CASES), (4, "model", MEG_RING_CASES))
LOOPBACK_TIMING = ("CUDA-graph replays of one call (n streams forked from and joined to one "
                   "stream, the flags zeroed first), warm L2; the n grids resident at once")
# kernel families of the device time (--profile): name fragments
PROFILE_FAMILIES = ("wg::mm<", "wg::mm_gated", "wg::sum_splits", "gv::gemv", "mm_skinny",
                    "mm_splitk_epilogue", "mm_tc_bf16", "tc::fwd", "tc::bwd_dq",
                    "tc::bwd_dkdv", "flash_", "swiglu")
# each bf16 matmul path timed, in turns, against the one it replaced
OLD_PATH = {"wgmma": "wmma", "gemv": "skinny"}
# checkpoints on one card: the reference runs CKPT_RESUME_AT + 2 steps; the
# run that saves stops at CKPT_RESUME_AT, saving async every CKPT_EVERY
# steps (keep CKPT_KEEP, CKPT_WRITERS writers); the resume runs the last two
CKPT_RESUME_AT, CKPT_EVERY, CKPT_KEEP, CKPT_WRITERS = 4, 2, 2, 2
# the depth of the ckpt phase's runs and of runtime's ckpt_procs, which
# repeats them (cut from 28 to keep the script's time; cut further only if
# two checkpoints do not fit on the disk)
CKPT_LAYERS = 8
# on the grid: full width at BIDIR_LAYERS layers, saving after every step
GRID_CKPT_STEPS = 2
NO_SAVE = "1000000"                       # --ckpt-every of a run that only restores
# the runtime phase (RUNTIME_LAYERS layers but ckpt_procs, which repeats the
# ckpt phase's run; guard_skip cut from 28 to keep the script's time):
# guard_skip poisons batch GUARD_NAN_AT of GUARD_STEPS;
# rollback poisons data RB_POISON of RB_STEPS,
# saving every RB_EVERY steps with skip_cap RB_SKIP_CAP, and after the
# rollback holds loop step HANG_STEP past HANG_TIMEOUT_S by a host sleep
GUARD_STEPS, GUARD_NAN_AT = 5, 2
RUNTIME_LAYERS = BIDIR_LAYERS
RB_STEPS, RB_POISON, RB_EVERY, RB_SKIP_CAP = 8, (3, 4), 2, 2
HANG_STEP, HANG_TIMEOUT_S, HANG_SLEEP_S = 5, 3.0, 4.0
# grid_runtime: the blocklist in the grid's checkpoint directory
GRID_BLOCKLIST, GRID_RUNTIME_STEPS = (0, 2), 2
# the 1F1B pipeline (--pods 2 --pod-role pipeline): full-width
# paper-tinyllama-1.1b (untied head) at PIPE_LAYERS of its 22 layers (cut
# to keep the script's time; PIPE_LAYERS / 2 a stage) on two one-rank
# stages, batch 8 x 512 in 4 microbatches; then the composed run, hecaton
# stages of 1x1x2 (four ranks) under the fused overlap at PIPE_HEC_LAYERS
# layers (cut from 4).  Every stage rank must launch PIPE_KERNELS (the
# composed run's every rank the ring kernels); PIPE_MICRO_BATCH x TRAIN_SEQ
# is a microbatch, the shape the kernel cases hold
PIPE_ARCH, PIPE_PODS, PIPE_MICRO, PIPE_STEPS = "paper-tinyllama-1.1b", 2, 4, 2
PIPE_LAYERS = 4
PIPE_MICRO_BATCH = TRAIN_BATCH // PIPE_MICRO
PIPE_HEC_GRID, PIPE_HEC_LAYERS, PIPE_HEC_STEPS = (1, 1, 2), 2, 1
PIPE_KERNELS = ("tile_matmul", "gated_matmul", "swiglu_bwd", "flash_attention",
                "flash_attention_bwd")
PIPE_LABEL = "stage processes time-sliced on one card; not a pipeline speed"
# the pod axis as data parallelism: --pods 2 --pod-role data over a 1x1x2
# grid a pod (four ranks), the training cell's settings, 2 steps at
# POD_DATA_LAYERS layers (the batch, gradient sum and moments over the
# pods do not depend on depth)
POD_DATA_PODS, POD_DATA_GRID, POD_DATA_STEPS = 2, (1, 1, 2), 2
POD_DATA_LAYERS = BIDIR_LAYERS
# the dense KV cache: full-width qwen3-0.6b in fp32, each prompt prefilled
# into its own dense cache and decoded GEN tokens greedily, against the
# one-card paged engine on the same prompts
DENSE_PROMPT_LENS = (64, 256, 512, 512)
# the int8 paged arena: the serve phase's trace through --quant-kv; one
# int8 block against the bf16 arena's ((dh + 4) / (2 dh) at dh 128); the
# first decode tick's logits, teacher-forced on the same tokens, against
# the bf16 arena's: max |int8 - bf16| over max |bf16|
QUANT_KV_RATIO = (128 + 4) / 256
# the roundtrip's bound in scales: 1/2 (round to nearest) plus the fp32
# roundings of x / scale and q * scale (|x| / scale <= 127, 2^-23 each);
# each scale must be max |row| / 127 (in fp64) within one fp32 rounding
QUANT_ROUND_SLACK = 127 * 2.0 ** -22
QUANT_SCALE_RTOL = 2.0 ** -23
QUANT_KV_LOGIT_TOL = 0.06                 # 0.0270 measured on an H100 80GB HBM3, 700 W
HOST_BOUND = "host-bound: the host's per-op launch cost, not the card, sets decode tok/s"
# serving on the rank grid: 1x2x2 (four ranks), hecaton, fused, bf16; one
# prefill of GRID_SERVE_BATCH prompts of GRID_SERVE_PROMPT tokens, then
# GRID_SERVE_TICKS decode ticks teacher-forced on the one-card dense path's
# greedy tokens; each step's logits against that path's: max |grid - one
# card| over max |one card|
GRID_SERVE, GRID_SERVE_BATCH, GRID_SERVE_PROMPT, GRID_SERVE_TICKS = (1, 2, 2), 4, 512, 16
GRID_SERVE_TOL = 0.05                     # 0.0248 measured on an H100 80GB HBM3, 700 W
# multi-head latent attention: minicpm3-4b at full width (62 layers, d 2560,
# 40 heads, latent 256, rope 32, dn = dv = 64, vocab 73,472 padded, untied)
# served in bf16 on the paged pool (SLOTS, BLOCK, REQUESTS, GEN) with prompts
# of MLA_PROMPT_LENS, then through --quant-kv; its model check runs a
# MLA_CHECK_PROMPT-token prefill and MLA_CHECK_DECODE decode steps; it trains
# at MLA_TRAIN_LAYERS of its 62 layers (the fp32 state of 62 does not fit
# the card), MLA_TRAIN_STEPS steps (1 warm-up) of the training cell's shape
MLA_ARCH = "minicpm3-4b"
MLA_PROMPT_LENS = (64, 256, 512)
MLA_CHECK_PROMPT, MLA_CHECK_DECODE = 300, 8
MLA_TRAIN_LAYERS, MLA_TRAIN_STEPS = 8, 4
MLA_SERVE_KERNELS = ("matmul", "gated_matmul", "flash_attention", "mla_decode")
# one int8 latent block against bf16's: (256 + 4 + 32 + 4) / (2 (256 + 32))
MLA_QUANT_RATIO = (256 + 4 + 32 + 4) / 576
MLA_QUANT_LOGIT_TOL = 0.06               # 0.0349 measured on an H100 80GB HBM3, 700 W
# the MoE slice: granite-moe-3b-a800m at full width (32 layers, d 1536, 40
# experts top-8 of d_ff 512, cf 1.25).  Its grouped products at each C a
# serving step gives them (C = int(8 T 1.25 / 40): a 4-slot decode tick
# 1, prefills of 64 / 256 / 512 tokens 16 / 64 / 128; the kernels line's
# rows) and 37 (ragged), some experts' slots empty; one layer of grok-1-314b's
# experts (E 8, H 6144, F 32768, geglu) at C 1 and 160 (a 512-token prefill);
# the combine at T 4 and 512 tokens, k 8
MOE_ARCH, GROK_ARCH = "granite-moe-3b-a800m", "grok-1-314b"
MOE_PROMPT_LENS = (64, 256, 512)
MOE_CS, MOE_MAIN_CS, GROK_CS, COMBINE_TS = (1, 16, 37, 64, 128), (1, 16, 64, 128), (1, 160), \
    (4, 512)
MOE_CHECK_PROMPT, MOE_CHECK_DECODE = 300, 8
# moe_model_check: the depth of the bf16 5e-2 gate (at 32 layers the plain bf16
# path alone stands ~0.11 from fp32), its controls, and those that must fail it
MOE_GATE_LAYERS = 8
MOE_CONTROLS, MOE_CONTROLS_FAIL = ("h_bf16", "w_e4m3", "w_e5m2"), ("w_e4m3", "w_e5m2")
MOE_KERNELS = ("moe_grouped_gated", "moe_grouped_mm", "moe_combine")
MOE_SERVE_KERNELS = ("matmul", "flash_attention") + MOE_KERNELS


def log(*a):
    print(*a, flush=True)


def bench_ms(calls, reps=10):
    """Device ms per call over a cycle of ``calls`` (each on its own inputs,
    so that together they exceed the L2 cache).  The cycle is captured in a
    CUDA graph and replayed between CUDA events, so the host's launch cost
    (larger than a small kernel's run time on this machine) is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up, as graph capture needs
        for c in calls[:3]:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def event_ms(fn, reps=5, windows=7):
    """Device ms per call of ``fn``: the median over ``windows`` windows of
    ``reps`` calls, each between CUDA events, after one warm-up call.  For
    calls of a millisecond or more (attention backward), whose host launch
    cost is small beside their device time, and which run autograd, which
    a graph capture does not take; the median drops the windows that a
    host stall (autograd, the allocator) stretched."""
    fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def n_copies(nbytes):
    return int(min(32, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))))


def bound(nbytes, nops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)


def record(results, kernel, case, dtype, main, out, want, kern_calls, plain_calls,
           lib_calls, nbytes, nops, timer=bench_ms, kernel_ms=None, path=None, extra=None,
           library_ms=None):
    """``out``/``want`` may be tuples (a backward's gradients, the gated
    kernel's kept products): each pair is held to the tolerance of its
    output's dtype and the worst error is reported.  ``dtype`` is the
    inputs' dtype, which sets the peak rate of the bound.  ``kernel_ms``,
    when given, was timed by the caller (two paths in turns); ``path``
    names the kernel's path in the case line; ``extra`` adds fields;
    ``library_ms``, when given, was timed by the caller (no
    ``lib_calls``)."""
    outs, wants = (out, want) if isinstance(out, tuple) else ((out,), (want,))
    errs, ok, tols = [], True, {}
    for o, w in zip(outs, wants):
        tol, why = TOL[o.dtype]
        tols[str(o.dtype).replace("torch.", "")] = (tol, why)
        errs.append((o.float() - w.float()).abs().max().item())
        ok &= bool(torch.allclose(o.float(), w.float(), atol=tol, rtol=tol)) and \
            bool(torch.isfinite(o.float()).all())
        ok &= o.dtype == w.dtype and o.shape == w.shape
    b_ms, b_by = bound(nbytes, nops, dtype)
    r = dict(kernel=kernel, case=case, dtype=str(dtype).replace("torch.", ""),
             main=main, max_err=max(errs), errs=errs,
             tol={k: t for k, (t, _) in tols.items()},
             reason={k: why for k, (_, why) in tols.items()}, ok=ok,
             kernel_ms=timer(kern_calls) if kernel_ms is None else kernel_ms,
             plain_ms=timer(plain_calls),
             library_ms=timer(lib_calls) if lib_calls else library_ms,
             bound_ms=b_ms, bound_by=b_by)
    if path is not None:
        r["path"] = path
    r.update(extra or {})
    results.append(r)
    log("case " + json.dumps(r))
    return ok


def check_matmul(results, gen, M, K, N, dtype, *, gated=False, act="none",
                 bias=False, main=True, keep_ab=False):
    """``keep_ab`` (gated, the training path): the kernel also writes the
    fp32 products a = x w1 and b = x w1b, and all three outputs are held
    against ``ref.gated_products_plain``."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nw = 2 if gated else 1
    nbytes = (M * K + nw * K * N + M * N + (N if bias else 0)) * elt + \
        (2 * M * N * 4 if keep_ab else 0)
    sets = []
    for _ in range(n_copies(nbytes)):
        x = randn(gen, (M, K), dtype)
        ws = [randn(gen, (K, N), dtype, K ** -0.5) for _ in range(nw)]
        b = randn(gen, (N,), dtype) if bias else None
        sets.append((x, ws, b))
    extra = None
    if gated:
        kern = lambda s, p=None: kmm.gated_matmul(s[0], *s[1], act=act, keep_ab=keep_ab, impl=p)
        plain = lambda s: (ref.gated_products_plain if keep_ab else ref.gated_matmul_plain)(
            s[0], *s[1], act=act)
        lib = None
        # the two products alone, [w1 | w1b] built outside the timed calls: a
        # yardstick of the products, not of the gate, so not a library time
        cats = [(s[0], torch.cat(s[1], dim=1)) for s in sets]
        extra = dict(products_only_ms=bench_ms([lambda c=c: torch.matmul(*c) for c in cats]),
                     products_only="torch.matmul(x, [w1 | w1b]): the two products, not the gate")
        del cats
    else:
        kern = lambda s, p=None: kmm.matmul(s[0], s[1][0], s[2], act=act, impl=p)
        plain = lambda s: ref.matmul_plain(s[0], s[1][0], s[2], act=act)
        lib = (lambda s: torch.matmul(s[0], s[1][0])) if (act == "none" and not bias) \
            else None
    name = "gated_matmul" if gated else "matmul"
    case = f"M={M} K={K} N={N} act={act}" + (" bias" if bias else "") + \
        (" keep_ab" if keep_ab else "")
    impl = (kmm.gated_impl if gated else kmm.mm_impl)(dtype, M, N, K)
    return _record_paths(results, name, case, dtype, main, impl, kern, plain, lib, sets,
                         nbytes, nw * 2 * M * K * N, both=True, extra=extra)


def _record_paths(results, name, case, dtype, main, impl, kern, plain, lib, sets, nbytes, nops,
                  both, extra=None):
    """One case of a matmul kernel on its chosen path ``impl``; when that
    is wgmma or gemv (and ``both``), the path it replaced (OLD_PATH: wmma,
    skinny) is held and timed on the same inputs too, the two timed in
    turns, and only the chosen path's row is a main one."""
    plains = [lambda s=s: plain(s) for s in sets]
    libs = [lambda s=s: lib(s) for s in sets] if lib else None
    if not (both and impl in OLD_PATH):
        return record(results, name, case, dtype, main, kern(sets[0]), plain(sets[0]),
                      [lambda s=s: kern(s) for s in sets], plains, libs, nbytes, nops,
                      path=impl, extra=extra)
    calls = {p: [lambda s=s, p=p: kern(s, p) for s in sets] for p in (impl, OLD_PATH[impl])}
    times = paired_ms(bench_ms, calls)
    ok, want = True, plain(sets[0])
    for p in times:                     # the chosen path first: its row is the main one
        got = kern(sets[0], p)
        ok &= record(results, name, case, dtype, main and p == impl, got, want, calls[p],
                     plains, libs, nbytes, nops, kernel_ms=times[p], path=p, extra=extra)
        if p == impl:                   # deterministic: two calls agree bit for bit
            again = kern(sets[0], p)
            ok &= all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, tuple) else (got,),
                again if isinstance(again, tuple) else (again,)))
    return ok


def sdpa_mask(B, Sq, Sk, q_off, kv_len, device):
    kpos = torch.arange(Sk, device=device)
    qpos = q_off[:, None] + torch.arange(Sq, device=device)[None, :]
    m = (kpos[None, None, :] <= qpos[:, :, None]) & \
        (kpos[None, None, :] < kv_len[:, None, None])
    return m[:, None]                                   # [B,1,Sq,Sk]


def _sdpa_fastest(lib_calls):
    """SDPA's yardstick over its forms (v at its own dv, v padded to dk):
    each form's ms per call (None where PyTorch refuses the form) and the
    fastest, ``library_ms``."""
    got = {}
    for form, calls in lib_calls.items():
        try:
            got[form] = bench_ms(calls)
        except RuntimeError as e:                 # a form no SDPA backend takes
            log(f"sdpa {form} refused: {str(e)[:200]}")
            got[form] = None
    taken = [t for t in got.values() if t is not None]
    return got, (min(taken) if taken else None)


def pad_heads(t, d):
    """A [B, heads, S, d'] view of [B, S, heads, d'] memory zero-padded to
    d in the same layout, as a model pads v to dk for kernels of one head
    dim."""
    return F.pad(t.transpose(1, 2), (0, d - t.shape[-1])).transpose(1, 2)


def profiled_ms(fn, reps=5):
    """Device ms per call of ``fn`` from torch.profiler: its kernels' own
    time (``device_ms``), without the host's time between launches, and
    each kernel's share of it by name."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    per = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = _short(e.key)
            per[name] = per.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return device_ms(events) / reps, per


def route_dims(path, dk, dv):
    """The kernels' "dkxdv" that a path of the attention checks runs:
    "wgmma_padded" is the tensor cores on v padded to dk first."""
    if path == "wgmma_padded":
        path, dv = "wgmma", dk
    return "x".join(map(str, kfa.kernel_dims(dk, dv, path)))


def check_attention(results, gen, B, nh, nkv, dh, Sq, Sk, q_off, kv_len, dtype, *,
                    main=True, label="", dv=None):
    """The forward at q, k of dh and v of ``dv`` (default dh) against
    ``ref.attention_plain``.  On the tensor cores (bf16) the SIMT path is
    held and timed on the same inputs, in turns; at dv < dh (MLA's 96 / 64)
    so is the route that pads v to dh first ("wgmma_padded": the wrapper
    then pads all three to 128, as the model and wrapper did before the
    native (96, 64) kernels), and SDPA's yardstick is the faster of its
    call on v at dv and on v padded to dh."""
    dv = dv or dh
    elt = torch.tensor([], dtype=dtype).element_size()
    qo = torch.tensor(q_off, dtype=torch.int32, device=DEV)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=DEV)
    # data-dependent work: visible (query, key) pairs and the K/V rows read
    pairs = sum(min(kv_len[b], q_off[b] + i + 1) for b in range(B) for i in range(Sq))
    kv_rows = sum(min(kv_len[b], q_off[b] + Sq) for b in range(B))
    # read q (dh), write o (dv); read k (dh) and v (dv) of the visible rows
    nbytes = (B * Sq * nh + kv_rows * nkv) * (dh + dv) * elt
    nops = 2 * pairs * nh * (dh + dv)
    sets = []
    for _ in range(n_copies(B * Sk * nkv * (dh + dv) * elt)):
        # the model's layout: [B, S, heads, d], handed over as transposed views
        q = randn(gen, (B, Sq, nh, dh), dtype).transpose(1, 2)
        k = randn(gen, (B, Sk, nkv, dh), dtype).transpose(1, 2)
        v = randn(gen, (B, Sk, nkv, dv), dtype).transpose(1, 2)
        sets.append((q, k, v) + ((pad_heads(v, dh),) if dv != dh else ()))
    mask = sdpa_mask(B, Sq, Sk, qo, kl, DEV)
    kw = dict(causal=True, q_offset=qo, kv_len=kl)
    kern = lambda s, p: (  # noqa: E731
        kfa.flash_attention(*s[:2], s[3], impl="wgmma", **kw)[..., :dv] if p == "wgmma_padded"
        else kfa.flash_attention(*s[:3], impl=p, **kw))
    plain = lambda s: ref.attention_plain(*s[:3], **kw)  # noqa: E731
    sdpa = lambda s, vv: F.scaled_dot_product_attention(  # noqa: E731
        *s[:2], vv, attn_mask=mask, enable_gqa=True)
    lib_forms = {f"v{dv}": [lambda s=s: sdpa(s, s[2]) for s in sets]}
    if dv != dh:
        lib_forms[f"v{dv}_padded_to_{dh}"] = [lambda s=s: sdpa(s, s[3]) for s in sets]
    sdpa_ms, lib_ms = _sdpa_fastest(lib_forms)
    case = f"{label} B={B} nh={nh} nkv={nkv} dh={dh}" + (f" dv={dv}" if dv != dh else "") + \
        f" Sq={Sq} Sk={Sk}"
    impl = kfa.forward_impl(dtype, B, nh, nkv, Sq, Sk, dh, dv)
    paths = kfa.IMPLS + (("wgmma_padded",) if dv != dh and impl == "wgmma" else ())
    calls = {p: [lambda s=s, p=p: kern(s, p) for s in sets] for p in paths}
    times = paired_ms(bench_ms, calls) if impl == "wgmma" else {impl: None}
    ok = True
    for p in times:                     # the chosen path first: its row is the main one
        extra = dict(kernel_dims=route_dims(p, dh, dv), sdpa_ms=sdpa_ms) if dv != dh else None
        ok &= record(results, "flash_attention", case, dtype, main and p == impl,
                     kern(sets[0], p), plain(sets[0]), calls[p],
                     [lambda s=s: plain(s) for s in sets], None, nbytes, nops,
                     kernel_ms=times[p], path=p, library_ms=lib_ms, extra=extra)
    return ok


def paired_ms(timer, calls):
    """Each path's ms per call for the paths of ``calls``, the first key's
    (the chosen path) first: they are timed in turns (the others, chosen,
    chosen, the others in reverse: for two paths other, chosen, chosen,
    other) and each path's two readings averaged, so a drift of the
    card's clock over the case falls on all alike."""
    first, *others = calls
    got = {p: [] for p in calls}
    for p in others[::-1] + [first, first] + others:
        got[p].append(timer(calls[p]))
    return {p: sum(got[p]) / len(got[p]) for p in calls}


def kernel_phase(cfg):
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    nh, nkv, F_ = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    # (K, N) of every projection on the path; head N is the padded vocab
    proj = [(d, nh * dh), (d, nkv * dh), (nh * dh, d), (F_, d), (d, cfg.padded_vocab)]
    max_seq = max(PROMPT_LENS) + GEN
    Sk = -(-max_seq // BLOCK) * BLOCK                 # gathered page view
    results, ok = [], True
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16                # the serving dtype
        for M in (SLOTS, max(PROMPT_LENS)):           # decode tick, longest prefill
            for K, N in proj:
                ok &= check_matmul(results, gen, M, K, N, dtype, main=main)
            ok &= check_matmul(results, gen, M, d, F_, dtype, gated=True, act="silu",
                               main=main)
        lens = [63, 300, 511, 0]                      # per-slot lengths, one idle
        ok &= check_attention(results, gen, SLOTS, nh, nkv, dh, 1, Sk, lens,
                              [n + 1 for n in lens], dtype, main=main, label="decode")
        for P in PROMPT_LENS:
            ok &= check_attention(results, gen, 1, nh, nkv, dh, P, Sk, [0], [P], dtype,
                                  main=main, label="prefill")
    # off-path coverage: ragged M, the other epilogues, a continued prefill, dh=64
    ok &= check_matmul(results, gen, 100, d, 2 * d, torch.bfloat16, main=False)
    for act in ("gelu", "relu2", "silu"):
        ok &= check_matmul(results, gen, 256, d, d, torch.bfloat16, act=act, bias=True,
                           main=False)
        ok &= check_matmul(results, gen, SLOTS, d, d, torch.float32, act=act, bias=True,
                           main=False)
    ok &= check_matmul(results, gen, 77, d, F_, torch.bfloat16, gated=True, act="gelu",
                       main=False)
    # decode off the main path: 16 slots through the gate, 7 through a projection
    ok &= check_matmul(results, gen, 16, d, F_, torch.bfloat16, gated=True, act="silu",
                       main=False)
    ok &= check_matmul(results, gen, 7, d, nh * dh, torch.bfloat16, main=False)
    ok &= check_attention(results, gen, 1, nh, nkv, dh, 64, Sk, [100], [164],
                          torch.bfloat16, main=False, label="continued-prefill")
    ok &= check_attention(results, gen, 2, 8, 2, 64, 128, 128, [0, 0], [128, 97],
                          torch.float32, main=False, label="dh64")
    # a slot at kv_len 0: its rows see no key and average all of v, as _sdpa
    ok &= check_attention(results, gen, SLOTS, nh, nkv, dh, 1, Sk, [63, 300, 511, 0],
                          [64, 301, 512, 0], torch.bfloat16, main=False, label="empty-row")
    # the tensor-core path off the main path: 3 q-heads a kv-head (a row tile
    # ends inside a query's group), dh 64, ragged lengths, a prefill with an
    # empty row
    ok &= check_attention(results, gen, 2, 6, 2, 64, 80, 80, [0, 0], [80, 33],
                          torch.bfloat16, main=False, label="ragged-g3")
    ok &= check_attention(results, gen, 3, 6, 2, dh, 40, 130, [0, 50, 7], [40, 90, 0],
                          torch.bfloat16, main=False, label="prefill-empty-row")
    return results, ok


def _short(demangled):
    """``void tc::fwd<(int)128>(CUtensorMap_st, ...)`` -> ``tc::fwd<128>``:
    the name up to its parameter list, which opens at the first "(" outside
    the template arguments."""
    depth = 0
    for i, c in enumerate(demangled):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            demangled = demangled[:i]
            break
    return demangled.replace("void ", "").replace("(int)", "")


def _sass(libname):
    """{function: {"HGMMA": n, "HMMA": n}} of one library, by mangled name,
    and the same keyed by short demangled names."""
    lib = build.library(libname)._name
    bindir = os.path.dirname(build.nvcc_path())
    sass = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    # a function's text runs from its "Function :" line to the next; an
    # instruction line holds one opcode
    parts = re.split(r"^[ \t]*Function :(.*)$", sass, flags=re.M)
    counts = {name.strip(): {"HGMMA": body.count(" HGMMA."), "HMMA": body.count(" HMMA.")}
              for name, body in zip(parts[1::2], parts[2::2])}
    names = list(counts)
    filt = os.path.join(bindir, "cu++filt")
    if os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(names):
            names = [_short(n) for n in out]
    return os.path.basename(lib), counts, dict(zip(names, counts.values()))


def sass_counts():
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in each kernel function
    of the flash-attention, matmul, ssd, ring, MLA-decode and MoE libraries,
    from ``cuobjdump -sass``; ok when every tensor-core attention kernel
    (TC_FUNCTIONS), the wgmma matmul (WG_FUNCTIONS), the tensor-core scan
    (SSD_TC_FUNCTIONS), the tensor-core ring kernels (RING_TC_FUNCTIONS),
    the absorbed decode's (MLA_TC_FUNCTIONS) and the MoE's grouped products
    (MOE_TC_FUNCTIONS) hold HGMMA."""
    shown, ok = {}, True
    libs = (("flash_attention", TC_FUNCTIONS), ("matmul", WG_FUNCTIONS),
            ("ssd", SSD_TC_FUNCTIONS), ("ring_matmul", RING_TC_FUNCTIONS),
            ("mla_decode", MLA_TC_FUNCTIONS), ("moe", MOE_TC_FUNCTIONS))
    for name, _ in libs:                       # loaded here, dumped in parallel below
        build.library(name)
    with ThreadPoolExecutor(len(libs)) as pool:
        dumps = list(pool.map(_sass, [name for name, _ in libs]))
    for (_, prefixes), (lib, counts, short) in zip(libs, dumps):
        shown[lib] = short
        ok &= all(any(m.startswith(pre) and c["HGMMA"] > 0 for m, c in counts.items())
                  for pre in prefixes)
    log("sass " + json.dumps(dict(libraries=shown, ok=ok)))
    return ok


def _stored(t, transposed):
    """t [rows, cols] as a row-major tensor or as the transposed view of
    one (the layout the training path hands the tile kernel)."""
    return t.t().contiguous().t() if transposed else t


def check_tile(results, gen, layout, M, K, N, dtype, out_dtype=None, *, main=True):
    """x @ w through the tile kernel; NT reads w transposed (dx = g w^T, the
    tied head), TN reads x transposed (dw = x^T g)."""
    out_dtype = out_dtype or dtype
    elt = torch.tensor([], dtype=dtype).element_size()
    oelt = torch.tensor([], dtype=out_dtype).element_size()
    nbytes = (M * K + K * N) * elt + M * N * oelt
    sets = [(_stored(randn(gen, (M, K), dtype), layout == "TN"),
             _stored(randn(gen, (K, N), dtype, K ** -0.5), layout == "NT"))
            for _ in range(n_copies(nbytes))]
    kern = lambda s, p=None: kmm.tile_matmul(*s, out_dtype=out_dtype, impl=p)
    plain = lambda s: ref.tile_matmul_plain(*s, out_dtype=out_dtype)
    lib = ((lambda s: torch.matmul(*s)) if out_dtype == dtype
           else (lambda s: torch.mm(*s, out_dtype=out_dtype)))
    case = f"{layout} M={M} K={K} N={N} out={str(out_dtype).replace('torch.', '')}"
    x, w = sets[0]
    ta, lda = kmm.layout(x)
    tb, ldb = kmm.layout(w)
    impl = kmm.mm_impl(dtype, M, N, K, ta, tb, lda, ldb, kmm.shared_align(x, w), tile=True)
    return _record_paths(results, "tile_matmul", case, dtype, main, impl, kern, plain, lib,
                         sets, nbytes, 2 * M * K * N, both=True)


def check_swiglu_bwd(results, gen, M, F_, dtype, *, main=True):
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = M * F_ * (3 * elt + 8)               # g, dA, dB; a, b in fp32
    sets = [(randn(gen, (M, F_), dtype), randn(gen, (M, F_), torch.float32, 3.0),
             randn(gen, (M, F_), torch.float32)) for _ in range(n_copies(nbytes))]
    kern = lambda s: ksw.swiglu_bwd(*s, act="silu")
    plain = lambda s: ref.swiglu_bwd_plain(*s, act="silu")
    return record(results, "swiglu_bwd", f"M={M} F={F_}", dtype, main, kern(sets[0]),
                  plain(sets[0]), [lambda s=s: kern(s) for s in sets],
                  [lambda s=s: plain(s) for s in sets], None, nbytes, 20 * M * F_)


def check_attention_bwd(results, gen, B, nh, nkv, dh, S, dtype, *, causal=True, main=True,
                        dv=None):
    """dq, dk, dv under the training mask against the plain version's
    autograd; [B,S,heads,d] tensors go in as transposed views, q and k at
    dh, v, o and dO at ``dv`` (default dh).  The yardstick is the backward
    of F.scaled_dot_product_attention (at dv < dh the faster of its forms
    on v at dv and on v and dO padded to dh); at dv < dh the route that
    pads v, o and dO to dh first ("wgmma_padded", then 128 in the wrapper)
    is held and timed in turns with the native one, and each path's and
    SDPA form's device time alone is read from torch.profiler."""
    dv = dv or dh
    elt = torch.tensor([], dtype=dtype).element_size()
    q = randn(gen, (B, S, nh, dh), dtype).transpose(1, 2)
    k = randn(gen, (B, S, nkv, dh), dtype).transpose(1, 2)
    v = randn(gen, (B, S, nkv, dv), dtype).transpose(1, 2)
    do = randn(gen, (B, S, nh, dv), dtype).transpose(1, 2)
    o, lse = kfa.flash_attention(q, k, v, causal=causal, return_lse=True)
    o_p, lse_p = ref.attention_plain(q, k, v, causal=causal, return_lse=True)
    pairs = B * (S * (S + 1) // 2 if causal else S * S)
    # read q, k, v, o, dO and the fp32 LSE; write dq, dk, dv: each at its width
    nbytes = 2 * B * S * (nh + nkv) * (dh + dv) * elt + 4 * B * nh * S
    # S = Q K^T, dQ, dK over dh; dP = dO V^T, dV over dv
    nops = pairs * nh * (6 * dh + 4 * dv)
    padded = {}
    if dv != dh:
        padded = dict(v=pad_heads(v, dh), do=pad_heads(do, dh))
        padded["o"], padded["lse"] = kfa.flash_attention(q, k, padded["v"], causal=causal,
                                                         return_lse=True)

    def kern(p):
        if p == "wgmma_padded":
            got = kfa.flash_attention_bwd(q, k, padded["v"], padded["o"], padded["lse"],
                                          padded["do"], causal=causal, impl="wgmma")
            return got[0], got[1], got[2][..., :dv]
        return kfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, impl=p)

    plain = lambda: ref.attention_bwd_plain(q, k, v, do, causal=causal)  # noqa: E731
    lib_forms = {}
    for form, vv, dd in ((f"v{dv}", v, do),) + (
            ((f"v{dv}_padded_to_{dh}", padded["v"], padded["do"]),) if padded else ()):
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, vv))
        try:
            o_l = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
        except RuntimeError as e:                 # a form no SDPA backend takes
            log(f"sdpa {form} refused: {str(e)[:200]}")
            continue
        lib_forms[form] = lambda o_l=o_l, ql=ql, kl=kl, vl=vl, dd=dd: torch.autograd.grad(
            o_l, (ql, kl, vl), dd, retain_graph=True)
    sdpa_ms = {form: event_ms(fn) for form, fn in lib_forms.items()}
    lib_ms = min(sdpa_ms.values()) if sdpa_ms else None
    ok_fwd = bool(torch.allclose(o.float(), o_p.float(), atol=TOL[o.dtype][0],
                                 rtol=TOL[o.dtype][0])) and \
        bool(torch.allclose(lse, lse_p, atol=2e-4, rtol=2e-4))
    case = f"{'causal' if causal else 'full'} B={B} nh={nh} nkv={nkv} dh={dh}" + \
        (f" dv={dv}" if dv != dh else "") + f" S={S}"
    impl = kfa.backward_impl(dtype, B, nh, nkv, S, S, dh, dv)
    timer = lambda c: event_ms(c[0])  # noqa: E731
    paths = kfa.IMPLS + (("wgmma_padded",) if padded and impl == "wgmma" else ())
    calls = {p: [lambda p=p: kern(p)] for p in paths}
    times = paired_ms(timer, calls) if impl == "wgmma" else {impl: None}
    ok = ok_fwd
    if dv != dh:      # device time alone: the event times above include the host's gaps
        prof = {p: profiled_ms(calls[p][0]) for p in times}
        prof.update({f"sdpa_{form}": profiled_ms(fn) for form, fn in lib_forms.items()})
        dev_ms = {p: ms for p, (ms, _) in prof.items()}
    for p in times:
        extra = dict(kernel_dims=route_dims(p, dh, dv), sdpa_ms=sdpa_ms, device_ms=dev_ms,
                     device_ms_by_kernel=prof[p][1]) if dv != dh else None
        got = kern(p)
        ok &= record(results, "flash_attention_bwd", case, dtype, main and p == impl, got,
                     plain(), calls[p], [plain], None, nbytes, nops, timer=timer,
                     kernel_ms=times[p], path=p, library_ms=lib_ms, extra=extra)
        ok &= all(torch.equal(a, b) for a, b in zip(got, kern(p)))     # deterministic
    return ok


def train_kernel_phase(cfg):
    """The training path's kernels at its shapes: one microbatch of
    TRAIN_M tokens through every projection, forward (NN) and backward (dx
    NT, dw TN), the tied head (NT, fp32 logits) and its backward."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    nh, nkv, F_, V = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.padded_vocab
    M, bf = TRAIN_M, torch.bfloat16
    results, ok = [], True
    for K, N in ((d, nh * dh), (d, nkv * dh), (nh * dh, d), (F_, d)):
        ok &= check_tile(results, gen, "NN", M, K, N, bf)           # forward
        ok &= check_tile(results, gen, "NT", M, N, K, bf)           # dx = g w^T
        ok &= check_tile(results, gen, "TN", K, M, N, bf)           # dw = x^T g
    # the FFN's gated up-projection, keeping a and b for the SwiGLU backward
    ok &= check_matmul(results, gen, M, d, F_, bf, gated=True, act="silu", keep_ab=True)
    ok &= check_matmul(results, gen, M, d, F_, torch.float32, gated=True, act="silu",
                       keep_ab=True, main=False)
    ok &= check_tile(results, gen, "NT", M, F_, d, bf)              # gated dx (twice)
    ok &= check_tile(results, gen, "TN", d, M, F_, bf)              # gated dw (twice)
    ok &= check_tile(results, gen, "NT", M, d, V, bf, torch.float32)   # tied head
    ok &= check_tile(results, gen, "NN", M, V, d, bf)               # head dx = g table
    ok &= check_tile(results, gen, "TN", d, M, V, bf)               # head dw = x^T g
    for layout in ("NN", "NT", "TN"):                               # fp32, off the path
        ok &= check_tile(results, gen, layout, M, d, d, torch.float32, main=False)
    ok &= check_tile(results, gen, "NN", M, d, nh * dh, bf, torch.float32, main=False)
    ok &= check_tile(results, gen, "TN", d, M, d, bf, torch.float32, main=False)
    # ragged: M, N and K each off the tiles where the layout allows
    ok &= check_tile(results, gen, "NN", 100, d, 2 * d, bf, main=False)
    ok &= check_tile(results, gen, "NT", 200, d, 1000, bf, main=False)
    ok &= check_tile(results, gen, "TN", d, 1000, 200, bf, main=False)
    # stored rows off 8 elements (the ring backward's ragged dw products)
    ok &= check_tile(results, gen, "NN", 100, 45, 27, bf, main=False)
    ok &= check_tile(results, gen, "TN", 45, 1000, 27, bf, main=False)
    ok &= check_swiglu_bwd(results, gen, M, F_, bf)
    ok &= check_swiglu_bwd(results, gen, M, F_, torch.float32, main=False)
    B = TRAIN_BATCH // TRAIN_MICRO
    ok &= check_attention(results, gen, B, nh, nkv, dh, TRAIN_SEQ, TRAIN_SEQ, [0] * B,
                          [TRAIN_SEQ] * B, bf, label="train")
    ok &= check_attention_bwd(results, gen, B, nh, nkv, dh, TRAIN_SEQ, bf)
    ok &= check_attention_bwd(results, gen, B, nh, nkv, dh, TRAIN_SEQ, torch.float32,
                              main=False)
    ok &= check_attention_bwd(results, gen, 2, 8, 2, 64, 256, bf, main=False)
    ok &= check_attention_bwd(results, gen, 2, 8, 2, 64, 256, bf, causal=False, main=False)
    return results, ok


def pipe_kernel_phase(cfg):
    """The pipeline's kernels at the shapes full-width paper-tinyllama-1.1b
    gives them (a microbatch of PIPE_MICRO_BATCH x TRAIN_SEQ tokens, 32/4
    heads of dh 64, d_ff 5632, the untied head over vocab 32,000), off the
    kernels line's sums (main False), so that its sums stay those of the
    earlier shapes."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    nh, nkv, F_, V = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.padded_vocab
    M, bf, B = PIPE_MICRO_BATCH * TRAIN_SEQ, torch.bfloat16, PIPE_MICRO_BATCH
    results, ok = [], True
    for K, N in ((d, nh * dh), (d, nkv * dh), (F_, d)):
        ok &= check_tile(results, gen, "NN", M, K, N, bf, main=False)
    ok &= check_tile(results, gen, "NT", M, F_, d, bf, main=False)      # FFN-down dx
    ok &= check_tile(results, gen, "TN", F_, M, d, bf, main=False)      # FFN-down dw
    ok &= check_tile(results, gen, "NN", M, d, V, bf, torch.float32, main=False)   # head
    ok &= check_tile(results, gen, "NT", M, V, d, bf, main=False)       # head dx
    ok &= check_tile(results, gen, "TN", d, M, V, bf, main=False)       # head dw
    ok &= check_matmul(results, gen, M, d, F_, bf, gated=True, act="silu", keep_ab=True,
                       main=False)
    ok &= check_swiglu_bwd(results, gen, M, F_, bf, main=False)
    ok &= check_attention(results, gen, B, nh, nkv, dh, TRAIN_SEQ, TRAIN_SEQ, [0] * B,
                          [TRAIN_SEQ] * B, bf, main=False, label="pipeline")
    ok &= check_attention_bwd(results, gen, B, nh, nkv, dh, TRAIN_SEQ, bf, main=False)
    return results, ok


def check_ssd(results, gen, b, S, nh, dh, g, ds, dtype, *, init, main=True, chunk=None):
    """The SSD scan (y and the fp32 final state) against ``ref.ssd_plain``.
    x, B and C are slices of one conv output, as the model hands them over;
    A = -(1..nh) and dt near 0.1 are mamba2-130m's, so cum falls to about
    -300 in a chunk of 128 (an exp(-cum) would overflow fp32).  The
    operations counted are the ones these inputs need: per (batch, head)
    and chunk of q real positions, the lower triangles of C B^T (ds) and of
    the scores times x (dh), C h^T and the state update (2 q dh ds each).
    A case the tensor-core route takes is held and timed on the SIMT route
    too, the two timed in turns (only the wgmma row is a main one), and the
    wgmma route must give the same bits on a second call."""
    elt = torch.tensor([], dtype=dtype).element_size()
    chunk, di, gs = chunk or min(128, S), nh * dh, g * ds
    nbytes = (2 * b * S * di + 2 * b * S * gs) * elt + 4 * (b * S * nh + nh + 2 * b * nh * dh * ds)
    nops = 0
    for t0 in range(0, S, chunk):
        q = min(chunk, S - t0)
        tri = q * (q + 1) // 2
        nops += 2 * (tri * ds + tri * dh + 2 * q * dh * ds)
    nops *= b * nh
    sets = []
    for _ in range(n_copies(nbytes)):
        conv = randn(gen, (b, S, di + 2 * gs), dtype)
        x = conv[..., :di].reshape(b, S, nh, dh)
        B = conv[..., di:di + gs].reshape(b, S, g, ds)
        C = conv[..., di + gs:].reshape(b, S, g, ds)
        dt = F.softplus(randn(gen, (b, S, nh), torch.float32) - 2.5)
        A = -torch.arange(1, nh + 1, dtype=torch.float32, device=DEV)
        h0 = (randn(gen, (b, nh, dh, ds), torch.float32) if init == "random"
              else torch.zeros((b, nh, dh, ds), device=DEV))
        sets.append((x, dt, A, B, C, h0))
    kern = lambda s, p=None: kssd.ssd(*s[:5], chunk=chunk, init_state=s[5], impl=p)
    plain = lambda s: ref.ssd_plain(*s[:5], chunk=chunk, init_state=s[5])
    plains = [lambda s=s: plain(s) for s in sets]
    case = f"{init}-state b={b} S={S} nh={nh} dh={dh} g={g} ds={ds} chunk={chunk}"
    # blocks of each route: one a chunk (clusters of up to 8 chunks, in rounds past that),
    # or one a 16-row slice of each head's state
    blocks = {"wgmma": b * nh * min(-(-S // chunk), kssd.TC_CLUSTER),
              "simt": b * nh * dh // kssd.SLICE}
    impl = kssd.ssd_impl(dtype, dh, ds, chunk)
    if impl != "wgmma":
        return record(results, "ssd", case, dtype, main, kern(sets[0]), plain(sets[0]),
                      [lambda s=s: kern(s) for s in sets], plains, None, nbytes, nops,
                      path=impl, extra=dict(blocks=blocks[impl]))
    calls = {p: [lambda s=s, p=p: kern(s, p) for s in sets] for p in ("wgmma", "simt")}
    times = paired_ms(bench_ms, calls)
    ok, want = True, plain(sets[0])
    for p in times:                     # the chosen route first: its row is the main one
        got = kern(sets[0], p)
        extra = dict(blocks=blocks[p])
        if p == "wgmma":                # deterministic: two calls agree bit for bit
            again = kern(sets[0], p)
            extra["deterministic"] = all(torch.equal(u, v) for u, v in zip(got, again))
            ok &= extra["deterministic"]
        ok &= record(results, "ssd", case, dtype, main and p == "wgmma", got, want, calls[p],
                     plains, None, nbytes, nops, kernel_ms=times[p], path=p, extra=extra)
    return ok


def ssd_kernel_phase(cfg):
    """The SSD scan at mamba2-130m's prefill shapes (batch 1, one
    exact-length prompt per launch); the path's cases are bf16 from the
    zero state a prefill starts from, on the wgmma route."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    s, nh = cfg.ssm, SSM.n_heads(cfg)
    results, ok = [], True
    for dtype in (torch.bfloat16, torch.float32):
        for init in ("zero", "random"):
            for S in SSM_PROMPT_LENS:
                ok &= check_ssd(results, gen, 1, S, nh, s.head_dim, s.n_groups, s.state_dim,
                                dtype, init=init,
                                main=dtype == torch.bfloat16 and init == "zero")
    # off the path, on the wgmma route: 17 chunks (rounds over a cluster of 8), a chunk
    # that does not fill its tile (rows of the next chunk in it), groups shared by two
    # heads at batch 2, the shortest prefill
    bf = torch.bfloat16
    ok &= check_ssd(results, gen, 1, 2100, nh, 64, 1, 128, bf, init="random", main=False)
    ok &= check_ssd(results, gen, 1, 300, nh, 64, 1, 128, bf, init="random", main=False,
                    chunk=100)
    ok &= check_ssd(results, gen, 2, 200, 4, 64, 2, 128, bf, init="random", main=False)
    ok &= check_ssd(results, gen, 1, 2, nh, 64, 1, 128, bf, init="random", main=False)
    # off the path, on the SIMT route: groups shared by two heads each, dh 32, batch 2, ragged
    ok &= check_ssd(results, gen, 2, 200, 8, 32, 2, 64, bf, init="random", main=False)
    return results, ok


def _ssm_logits(cfg, params, toks, plen, dtype, plain):
    """Logits of a ``plen``-token prefill from the pool's zero state rows,
    then one decode step per remaining token of ``toks`` (fed, not
    sampled, so that both paths see the same inputs): [len(toks), V]."""
    pool = CachePool(cfg, PoolConfig(1, BLOCK, -(-len(toks) // BLOCK) + 1, len(toks)),
                     device=DEV, dtype=dtype)
    slot = pool.admit(plen)
    pctx, t = PCtx(plain=plain), torch.from_numpy(toks).to(DEV)[None]
    with torch.inference_mode():
        out = lm.forward(pctx, cfg, params, {"tokens": t[:, :plen], "_dtype": dtype},
                         caches=pool.prefill_tree(slot))
        pool.absorb_prefill(slot, out.caches)
        logits = [out.logits[0]]
        for i in range(plen, t.shape[1]):
            step = lm.forward(pctx, cfg, params, {"tokens": t[:, i:i + 1], "_dtype": dtype},
                              caches=pool.decode_tree())
            logits.append(step.logits[0])
    return torch.cat(logits).float()


def ssm_model_check(cfg):
    """mamba2-130m at full width: a 300-token prompt's prefill and 8 decode
    steps through the kernels against the plain-op path, bf16 at 24 layers
    (and both against the plain fp32 forward), fp32 at 2 layers.  bf16
    is held as the dense model check holds it (5e-2 relative, and the
    kernel path as close to fp32 as the plain bf16 path, 25% margin);
    fp32 differs by sums in another order only, 1e-4 relative."""
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=SSM_CHECK_PROMPT + SSM_CHECK_DECODE)
    ok, report = True, {}
    for dtype, layers in ((torch.bfloat16, cfg.num_layers), (torch.float32, 2)):
        c = cfg.scaled(num_layers=layers)
        paths = [("kernel", dtype, False), ("plain", dtype, True)]
        if dtype == torch.bfloat16:
            paths.append(("plain_fp32", torch.float32, True))
        logits = {}
        for name, dt_, plain in paths:
            params = lm.init_params(c, seed=SEED, device=DEV, dtype=dt_)
            logits[name] = _ssm_logits(c, params, toks, SSM_CHECK_PROMPT, dt_, plain)
            del params
            torch.cuda.empty_cache()
        rel = lambda a, b: ((logits[a] - logits[b]).norm() / logits[b].norm()).item()
        entry = dict(layers=layers, prompt=SSM_CHECK_PROMPT, decode_steps=SSM_CHECK_DECODE,
                     max_abs_err=(logits["kernel"] - logits["plain"]).abs().max().item(),
                     rel_kernel_vs_plain=rel("kernel", "plain"))
        good = bool(torch.isfinite(logits["kernel"]).all())
        if dtype == torch.bfloat16:
            entry.update(rel_kernel_vs_fp32=rel("kernel", "plain_fp32"),
                         rel_plain_vs_fp32=rel("plain", "plain_fp32"), tol_rel=5e-2)
            good &= entry["rel_kernel_vs_plain"] <= 5e-2 and \
                entry["rel_kernel_vs_fp32"] <= 1.25 * entry["rel_plain_vs_fp32"] + 1e-3
        else:
            entry["tol_rel"] = 1e-4
            good &= entry["rel_kernel_vs_plain"] <= 1e-4
        entry["ok"] = good
        ok &= good
        report[str(dtype).replace("torch.", "")] = entry
    log("ssm_model_check " + json.dumps(report))
    return ok


def model_check(cfg):
    """One prompt's prefill logits: the kernel forward against the plain-op
    forward in bf16, and both against the plain fp32 forward."""
    plen = PROMPT_LENS[1]
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(1, plen))).to(DEV)
    logits = {}
    for name, dtype, plain in (("kernel", torch.bfloat16, False),
                               ("plain", torch.bfloat16, True),
                               ("plain_fp32", torch.float32, True)):
        # same seed: the bf16 weights are the fp32 ones rounded
        params = lm.init_params(cfg, seed=SEED, device=DEV, dtype=dtype)
        pool = CachePool(cfg, PoolConfig(1, BLOCK, plen // BLOCK + 1, plen), device=DEV,
                         dtype=dtype)
        slot = pool.admit(plen)
        with torch.inference_mode():
            out = lm.forward(PCtx(plain=plain), cfg, params,
                             {"tokens": toks, "_dtype": dtype},
                             caches=pool.prefill_tree(slot))
        logits[name] = out.logits.float()
        del params, pool, out
        torch.cuda.empty_cache()
    rel = lambda a, b: ((logits[a] - logits[b]).norm() / logits[b].norm()).item()
    err = (logits["kernel"] - logits["plain"]).abs().max().item()
    r_kp, r_k32, r_p32 = rel("kernel", "plain"), rel("kernel", "plain_fp32"), \
        rel("plain", "plain_fp32")
    # bf16 activations are rounded after every op, and the two bf16 paths
    # round differently where their fp32 sums (in another order) straddle a
    # rounding boundary; over 28 layers of ~10 roundings each that random
    # walk reaches about 2^-9 * sqrt(280) = 3.3e-2 relative, so the bf16
    # paths are held to 5e-2 of each other, and the kernel path must be as
    # close to the fp32 forward as the plain bf16 path is (25% margin)
    ok = (bool(torch.isfinite(logits["kernel"]).all()) and r_kp <= 5e-2
          and r_k32 <= 1.25 * r_p32 + 1e-3)
    log("model_check " + json.dumps(dict(
        prompt=plen, max_abs_err=err, rel_kernel_vs_plain=r_kp,
        rel_kernel_vs_fp32=r_k32, rel_plain_vs_fp32=r_p32, tol_rel=5e-2, ok=ok)))
    return ok


# bf16 kernel path vs bf16 plain path: their forward logits differ by 1.7e-2
# (relative, model_check above, over 28 layers) because each path rounds
# its activations to bf16 in other places; the backward walks the same
# chain again, so gradients differ by about twice that.  Held to 1e-1 per
# leaf (relative L2), and the kernel path's gradients must be as close to
# the fp32 plain path's as the bf16 plain path's are (50% margin).  fp32:
# sums in another order only, 1e-4 per leaf.
GRAD_TOL = {torch.bfloat16: 1e-1, torch.float32: 1e-4}


def _grads(cfg, params, batch, plain, dtype):
    pctx = PCtx(plain=plain, mode="train", pcfg=ParallelConfig())
    leaves = [t for _, t in lm.flatten(params)]
    loss, _ = lm.train_loss(pctx, cfg, params, dict(batch, _dtype=dtype), remat="fusion")
    grads = torch.autograd.grad(loss, leaves)           # every leaf, or it raises
    return float(loss.detach()), [g.float() for g in grads]


def _rel(a, b):
    return [((x - y).norm() / y.norm().clamp_min(1e-30)).item() for x, y in zip(a, b)]


def grad_check(cfg, name="grad_check"):
    """Loss and every leaf's gradient of one microbatch through the kernels
    against the plain-op path: bf16 at ``cfg``'s depth, fp32 at two
    layers; logged as ``name``."""
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH // TRAIN_MICRO, seed=SEED)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in data.batch_at(0).items()}
    ok, report = True, {}
    for dtype, layers in ((torch.bfloat16, cfg.num_layers), (torch.float32, 2)):
        c = cfg.scaled(num_layers=layers)
        params = lm.init_master_params(c, seed=SEED, device=DEV)
        for _, t in lm.flatten(params):
            t.requires_grad_(True)
        paths = [("kernel", False, dtype), ("plain", True, dtype)]
        if dtype == torch.bfloat16:
            paths.append(("plain_fp32", True, torch.float32))
        res = {name: _grads(c, params, batch, plain, dt) for name, plain, dt in paths}
        names = [".".join(p) for p, _ in lm.flatten(params)]
        r_kp = _rel(res["kernel"][1], res["plain"][1])
        worst = max(range(len(names)), key=lambda i: r_kp[i])
        finite = all(bool(torch.isfinite(g).all()) for g in res["kernel"][1])
        tol = GRAD_TOL[dtype]
        good = finite and r_kp[worst] <= tol and \
            abs(res["kernel"][0] - res["plain"][0]) <= tol * abs(res["plain"][0])
        entry = dict(layers=layers, loss_kernel=res["kernel"][0], loss_plain=res["plain"][0],
                     worst_leaf=names[worst], worst_rel=r_kp[worst], tol_rel=tol,
                     leaves=len(names))
        if "plain_fp32" in res:
            r_k32 = max(_rel(res["kernel"][1], res["plain_fp32"][1]))
            r_p32 = max(_rel(res["plain"][1], res["plain_fp32"][1]))
            entry.update(loss_plain_fp32=res["plain_fp32"][0], worst_rel_kernel_vs_fp32=r_k32,
                         worst_rel_plain_vs_fp32=r_p32)
            good &= r_k32 <= 1.5 * r_p32 + 1e-3
        entry["ok"] = good
        ok &= good
        report[str(dtype).replace("torch.", "")] = entry
        del params, res
        torch.cuda.empty_cache()
    log(f"{name} " + json.dumps(report))
    return ok


def model_flops(cfg, tokens, seq):
    """6 N tokens over the matmul weights (the tied head counted once) plus
    the causal attention products, forward and backward (3 x 4 per pair)."""
    d, dh, L = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    per_layer = d * nh * dh * 2 + 2 * d * nkv * dh + 3 * d * cfg.d_ff
    n = L * per_layer + d * cfg.padded_vocab
    pairs = tokens // seq * seq * (seq + 1) // 2
    return 6 * n * tokens + 12 * pairs * nh * dh * L


def train_phase(profile):
    """Train full-width qwen3-0.6b through the launcher's code path, then
    one step under each remat policy for its peak memory."""
    args = launch_train.parser().parse_args([
        "--arch", ARCH, "--dtype", "bfloat16", "--device", DEV, "--batch", str(TRAIN_BATCH),
        "--seq", str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICRO),
        "--steps", str(TRAIN_STEPS)])
    ops.reset_launches()
    r = launch_train.run(args, log_fn=log)            # the main path
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    paths = {k: dict(v) for k, v in kfa.IMPL_LAUNCHES.items()}
    mm_paths = dict(kmm.IMPL_LAUNCHES["tile_matmul"])
    gate_paths = dict(kmm.IMPL_LAUNCHES["gated_matmul"])
    cfg, losses = r["cfg"], [loss for _, loss in r["history"]]
    timed = r["step_s"][1:]                           # after the warm-up step
    step_ms = 1e3 * float(np.median(timed))
    tokens = r["tokens_per_step"]
    flops = model_flops(cfg, tokens, TRAIN_SEQ)
    state = r["state"]
    params, opt = state["params"], state["opt_state"]
    rc = RunConfig("custom", "train", TRAIN_SEQ, TRAIN_BATCH)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in data.batch_at(TRAIN_STEPS).items()}
    peak = {}
    for remat in ("none", "fusion", "full"):
        step = train_step.build_train_step(
            cfg, ParallelConfig(microbatches=TRAIN_MICRO, remat=remat), rc,
            compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2):                            # the second step is timed
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            times.append(1e3 * (time.perf_counter() - t0))
        peak[remat] = dict(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                           step_ms=times[-1], loss=losses[-1])
    line = dict(arch=ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=TRAIN_MICRO,
                remat="fusion", dtype="bfloat16", steps_timed=len(timed),
                step_ms_median=step_ms, step_ms=[1e3 * t for t in timed],
                warmup_step_ms=1e3 * r["step_s"][0], tokens_per_s=tokens / (step_ms / 1e3),
                model_tflop_per_step=flops / 1e12,
                model_tflop_s=flops / (step_ms / 1e3) / 1e12,
                losses=[loss for _, loss in r["history"]], remat_one_step=peak,
                setup_s=r["setup_s"])
    # every bf16 forward (each fills a row tile) and backward of the run went
    # through the tensor cores
    ok_paths = all(paths[k]["simt"] == 0 and paths[k]["wgmma"] == launches[k]
                   for k in ("flash_attention", "flash_attention_bwd"))
    # every (bf16) tile matmul and gate of the run went through wgmma
    ok_mm = all(counts["wgmma"] == launches[k] > 0 and counts["wgmma"] == sum(counts.values())
                for k, counts in (("tile_matmul", mm_paths), ("gated_matmul", gate_paths)))
    ok = all(math.isfinite(x) for x in losses) and \
        all(launches[k] > 0 for k in TRAIN_KERNELS) and ok_paths and ok_mm
    log("train " + json.dumps(line))
    log("train_kernels " + json.dumps(launches))
    log("train_paths " + json.dumps(dict(paths, ok=ok_paths)))
    log("train_mm_paths " + json.dumps(dict(tile_matmul=mm_paths, gated_matmul=gate_paths,
                                            ok=ok_mm)))
    if profile:
        profile_train(cfg, params, opt, rc, batch)
    del state, params, opt, r
    torch.cuda.empty_cache()
    return ok, launches


def profile_train(cfg, params, opt, rc, batch):
    """Device time per kernel, and the device's busy share, over one
    training step (remat fusion)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    step = train_step.build_train_step(
        cfg, ParallelConfig(microbatches=TRAIN_MICRO, remat="fusion"), rc,
        compute_dtype=torch.bfloat16)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = device_ms(events)
    log("profile_train " + json.dumps(dict(wall_ms=1e3 * wall, device_ms=dev,
                                           device_busy_share=dev / 1e3 / wall)))
    log("profile_train_kernels " + json.dumps(family_ms(events)))
    log(events.table(sort_by="self_device_time_total", row_limit=40))


SERVE_TOK_S = {}                          # decode tok/s of each arch's serve run
SERVE_TICKS = {}                          # decode ticks of each arch's serve run
SERVE_PREFILLS = {}                       # prefills of each arch's serve run (warm-up's too)


def serve_phase(profile, arch=ARCH, prompt_lens=PROMPT_LENS, kernels=SERVE_KERNELS,
                suffix=""):
    """Serve ``arch`` in bf16 through the serving entry point: 8 requests,
    4 slots, greedy; every kernel in ``kernels`` must launch."""
    args = launch_serve.parser().parse_args([
        "--arch", arch, "--dtype", "bfloat16", "--device", DEV,
        "--slots", str(SLOTS), "--block", str(BLOCK), "--requests", str(REQUESTS),
        "--prompt-lens", ",".join(map(str, prompt_lens)), "--gen", str(GEN),
        "--seed", str(SEED)])
    ops.reset_launches()
    r = launch_serve.run(args)                    # the main path
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    by_sq = dict(kfa.SQ_LAUNCHES)
    mm_paths = dict(kmm.IMPL_LAUNCHES["matmul"])
    gate_paths = dict(kmm.IMPL_LAUNCHES["gated_matmul"])
    ssd_paths = dict(kssd.IMPL_LAUNCHES)
    fin = r["finished"]
    vocab = get_config(arch).padded_vocab
    ok = (len(fin) == REQUESTS
          and all(len(f.tokens) == GEN and all(0 <= t < vocab for t in f.tokens)
                  for f in fin.values())
          and all(launches[k] > 0 for k in kernels))
    keys = ("sequences", "ticks", "preemptions", "prefill_ms_mean", "prefill_ms_max",
            "decode_tokens", "decode_s", "decode_tok_s", "peak_blocks",
            "dense_equiv_blocks", "paged_peak_bytes", "dense_cache_bytes", "warmup_s")
    log(f"serve{suffix} " + json.dumps(dict({k: r[k] for k in keys}, arch=arch)))
    SERVE_TOK_S[arch] = r["decode_tok_s"]
    SERVE_TICKS[arch] = r["ticks"]
    SERVE_PREFILLS[arch] = len(set(prompt_lens)) + len(r["engine"].stats["prefill_s"])
    log(f"kernels{suffix} " + json.dumps(launches))
    # every served (bf16) matmul and gate with M > 16 (a prefill) went
    # through wgmma, every one with M <= 16 (decode) through gemv: none on
    # the old paths (wmma, skinny) or fp32's
    ok_mm = mm_paths["wgmma"] > 0 and mm_paths["gemv"] > 0 and all(
        counts["wgmma"] + counts["gemv"] == launches[k]
        and counts["wmma"] == counts["skinny"] == counts["simt"] == 0
        for k, counts in (("matmul", mm_paths), ("gated_matmul", gate_paths)))
    if "gated_matmul" in kernels:
        ok_mm &= gate_paths["wgmma"] > 0 and gate_paths["gemv"] > 0
    ok &= ok_mm
    log(f"serve_mm_paths{suffix} " + json.dumps(dict(matmul=mm_paths, gated_matmul=gate_paths,
                                                     ok=ok_mm)))
    if "ssd" in kernels:
        # every served scan (a bf16 prefill of mamba2) on the tensor cores, none on SIMT
        ok_ssd = ssd_paths["wgmma"] == launches["ssd"] > 0 and ssd_paths["simt"] == 0
        ok &= ok_ssd
        log("ssm_ssd_paths " + json.dumps(dict(ssd_paths, ok=ok_ssd)))
    if "flash_attention" in kernels:
        ok_paths = all(by_sq.get(("simt", n), 0) == 0 and by_sq.get(("wgmma", n), 0) > 0
                       for n in TC_PREFILLS)
        ok &= ok_paths
        log(f"serve_paths{suffix} " + json.dumps(dict(
            {f"{p} Sq={n}": c for (p, n), c in sorted(by_sq.items())}, ok=ok_paths)))
    if profile:
        profile_decode(r["engine"])
        if "ssd" in kernels:
            profile_prefill(r["engine"], max(prompt_lens))
    return ok, launches


def device_ms(events):
    """Device time of a profile: the kernel events' own time.  Operator
    records also carry the time of kernels they launched (the custom ops'
    ctypes launches among them), so summing every row counts kernels
    twice; this is the sum torch's table prints as its device total."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3


def family_ms(events):
    """Device ms and calls of each kernel family (PROFILE_FAMILIES: name
    fragments), over the kernel events only, as ``device_ms`` sums them."""
    from torch.autograd import DeviceType
    out = {}
    for fam in PROFILE_FAMILIES:
        rows = [e for e in events if e.device_type == DeviceType.CUDA and fam in e.key]
        out[fam] = dict(ms=sum(e.self_device_time_total for e in rows) / 1e3,
                        calls=sum(e.count for e in rows))
    return out


def profile_decode(eng):
    """Device time per kernel, and the device's busy share, over decode
    ticks of a fresh 4-request trace."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    reqs = launch_serve.build_trace(np.random.default_rng(1), SLOTS,
                                    eng.cfg.vocab_size, [PROMPT_LENS[0]], 16, SLOTS)
    for q in reqs:
        eng.submit(q)
    eng.step()                                    # admissions + first tick
    ticks = 8
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = device_ms(events)
    summary = dict(ticks=ticks, wall_ms_per_tick=1e3 * wall / ticks,
                   device_ms_per_tick=dev / ticks, device_busy_share=dev / 1e3 / wall)
    log("profile " + json.dumps(summary))
    log("profile_kernels " + json.dumps(family_ms(events)))
    log(events.table(sort_by="self_device_time_total", row_limit=25))
    while eng.queue or eng.running:
        eng.step()


def profile_prefill(eng, plen):
    """Device time of one ``plen``-token prefill of the served SSM model
    through the kernels (a fresh pool's zero state rows, as a served
    prompt starts from), and the scan's share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    cfg = eng.cfg
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, plen))).to(DEV)

    def prefill():
        pool = CachePool(cfg, PoolConfig(1, BLOCK, -(-plen // BLOCK) + 1, plen), device=DEV,
                         dtype=torch.bfloat16)
        tree = pool.prefill_tree(pool.admit(plen))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            lm.forward(PCtx(), cfg, eng.params, {"tokens": toks, "_dtype": torch.bfloat16},
                       caches=tree)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prefill()                                     # warm-up
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = prefill()
    events = prof.key_averages()
    dev = device_ms(events)
    scan = [e for e in events if e.device_type == DeviceType.CUDA and "ssd" in e.key]
    scan_ms = sum(e.self_device_time_total for e in scan) / 1e3
    log("profile_prefill " + json.dumps(dict(
        prompt=plen, wall_ms=1e3 * wall, device_ms=dev, scan_ms=scan_ms,
        scan_calls=sum(e.count for e in scan), scan_share=scan_ms / dev if dev else None,
        scan_kernels=sorted({e.key for e in scan}))))


def _int8_check(out, want, tol):
    """The int8 cases' check: every element within ``tol`` (absolute and
    relative) but a share of at most INT8_SHARE, which may lie one int8
    level (max |want| / 127) further.  Returns (ok, max error, share off)."""
    o, w = out.float(), want.float()
    err = (o - w).abs()
    off = err > tol * (1 + w.abs())
    level = float(w.abs().max()) / 127
    share = float(off.float().mean())
    ok = (o.shape == w.shape and bool(torch.isfinite(o).all()) and share <= INT8_SHARE
          and float(err.max()) <= tol * (1 + float(w.abs().max())) + level)
    return ok, float(err.max()), share


def _ring_work(kernel, xs, ws, sd, n, elt, int8, pair):
    """(bytes, operations) of one rank's part of a ring kernel's call: x and
    w read, the output written, and the n - 1 arriving hops (the operand's
    own width, or the int8 payload and its fp32 scales a row)."""
    b, t, h = xs
    o = ws[1]
    hop = (lambda rows, cols, nseg=1: (n - 1) * (rows * cols + 4 * rows * nseg)) if int8 \
        else (lambda rows, cols, nseg=1: (n - 1) * rows * cols * elt)
    if kernel == "ag_matmul":
        return (b * t * h + h * o + b * n * t * o) * elt + hop(b * t, h), 2 * b * n * t * h * o
    if kernel == "ag_matmul_contract":
        return (b * t * h + n * h * o + b * t * o) * elt + hop(b * t, h), 2 * b * t * n * h * o
    ncols = o * (2 if pair else 1)
    out_elts = b * t * ncols // n
    out_cols = ncols if sd == 1 else ncols // n
    return ((b * t * h + h * ncols + out_elts) * elt
            + hop(out_elts // out_cols, out_cols, 2 if pair else 1)), 2 * b * t * h * ncols


def _ring_errs(kernel, outs, wants, dtype, n, int8, mags):
    """(ok, max error, fields) of ring outputs against what they should be:
    the int8 wire by ``_int8_check`` (1e-5 in fp32, the bf16 bound in
    bf16), bf16 matmul-RS over n > 2 at (n + 1) 2^-8 of the partials'
    magnitudes ``mags``, everything else at its output dtype's TOL."""
    ok = all(a.shape == c.shape and a.dtype == c.dtype and bool(torch.isfinite(a.float()).all())
             for a, c in zip(outs, wants))
    err = max(float((a.float() - c.float()).abs().max()) for a, c in zip(outs, wants))
    if int8:
        tol = INT8_TOL if dtype == torch.float32 else TOL[torch.bfloat16][0]
        checks = [_int8_check(a, c, tol) for a, c in zip(outs, wants)]
        return (ok and all(c[0] for c in checks), err,
                dict(tol=tol, share_off=max(c[2] for c in checks), share_allowed=INT8_SHARE))
    if kernel == "matmul_rs" and dtype == torch.bfloat16 and n > 2:
        # each contribution is stored in bf16 and the accumulator crosses
        # each hop in bf16, as the TPU kernel's does: n roundings of
        # contributions and n - 1 of partial sums (the plain version rounds
        # once), each at most 2^-8 (bf16's unit roundoff) of the value
        # rounded, so within (n + 1) 2^-8 of the sum of the ranks' partials'
        # magnitudes
        tol = (n + 1) * 2.0 ** -8
        ok &= all(bool(((a.float() - c.float()).abs() <= tol * m + 1e-6).all())
                  for a, c, m in zip(outs, wants, mags))
        return ok, err, dict(
            tol=tol, tol_of="the sum of the ranks' partials' magnitudes",
            err_over_partials=max(float(((a.float() - c.float()).abs() / (m + 1e-6)).max())
                                  for a, c, m in zip(outs, wants, mags)))
    tol = TOL[outs[0].dtype][0]
    ok &= all(bool(torch.allclose(a.float(), c.float(), atol=tol, rtol=tol))
              for a, c in zip(outs, wants))
    return ok, err, dict(tol=tol)


def _ring_case(idx, kernel, label, xs, ws, sd, main, dtype, rank, wire="bf16", n=2, ax="my",
               timer=event_ms):
    """One ring kernel (on the bf16 or the int8 wire) against its plain
    version on this rank's inputs, each timed by ``timer``."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1000 * idx + rank)
    x = randn(gen, xs, dtype)
    o = ws[1]
    pair = kernel == "matmul_rs" and sd == 1 and label.startswith("gated")
    w = randn(gen, ws, dtype, ws[0] ** -0.5)
    w1b = randn(gen, ws, dtype, ws[0] ** -0.5) if pair else None
    int8 = wire == "int8"
    nbytes, nops = _ring_work(kernel, xs, ws, sd, n, x.element_size(), int8, pair)
    if kernel == "ag_matmul":
        kern = lambda cd=wire: krm.ag_fwd(x, w, ax, 1, n, cd)
        plain = lambda: (ref.ag_matmul_int8_plain if int8 else ref.ag_matmul_plain)(
            x, w, ax, dim=1)
        xg = ref.gather_over_int8(x, ax, 1) if int8 else comm.raw_all_gather(x, ax, 1)
        lib = lambda: torch.matmul(xg, w)
    elif kernel == "ag_matmul_contract":
        kern = lambda cd=wire: krm.contract_fwd(x, w, ax, n, comm_dtype=cd)
        plain = lambda: (ref.ag_matmul_contract_int8_plain if int8
                         else ref.ag_matmul_contract_plain)(x, w, ax)
        xg = ref.gather_over_int8(x, ax, 2) if int8 else comm.raw_all_gather(x, ax, 2)
        lib = lambda: torch.matmul(xg, w)
    else:
        if pair:
            kern = lambda cd=wire: krm.pair_fwd(x, w, w1b, ax, sd, n, cd)
            plain = lambda: (ref.matmul_rs_pair_int8_plain if int8 else
                             ref.matmul_rs_pair_plain)(x, w, w1b, ax, scatter_dim=sd)
            wc = torch.cat([w, w1b], dim=1)
            lib = lambda: torch.matmul(x, wc)
        else:
            kern = lambda cd=wire: krm.rs_fwd(x, w, ax, sd, n, cd)
            plain = lambda: (ref.matmul_rs_int8_plain if int8 else ref.matmul_rs_plain)(
                x, w, ax, scatter_dim=sd)
            lib = lambda: torch.matmul(x, w)
    out, want = kern(), plain()
    outs, wants = (out, want) if isinstance(out, tuple) else ((out,), (want,))
    r = dict(kernel=kernel + ("_int8" if int8 else ""),
             case=f"{label} x={list(xs)} w={list(ws)}" + (f" scatter_dim={sd}" if sd else "")
             + (" pair" if pair else ""), wire=wire,
             dtype=str(dtype).replace("torch.", ""),
             # the kernels line takes the loopback ring's times: a time-sliced
             # process ring times the scheduler
             main=False, main_block=main and dtype == torch.bfloat16,
             rank=rank, n=n, axis=ax, process_ring=True)
    mags = None
    if kernel == "matmul_rs" and dtype == torch.bfloat16 and n > 2 and not int8:
        wc = torch.cat([w, w1b], dim=1) if pair else w
        absum = comm.raw_psum_scatter((x.float() @ wc.float()).abs(), ax, sd)
        mags = absum.split(o, dim=-1) if pair else (absum,)
    ok, err, fields = _ring_errs(kernel, outs, wants, dtype, n, int8, mags)
    r.update(fields)
    if int8 and dtype == torch.float32:
        # the same case through the bf16 wire's kernel must fail the check
        full = kern("bf16")
        fulls = full if isinstance(full, tuple) else (full,)
        fchecks = [_int8_check(a, c, fields["tol"]) for a, c in zip(fulls, wants)]
        r.update(bf16_wire_err=max(c[1] for c in fchecks),
                 bf16_wire_share_off=max(c[2] for c in fchecks),
                 bf16_wire_fails=not all(c[0] for c in fchecks))
        ok &= r["bf16_wire_fails"]
    b_ms, b_by = bound(nbytes, nops, dtype)
    r.update(max_err=err, ok=ok, kernel_ms=timer(kern), plain_ms=timer(plain),
             library_ms=timer(lib), bound_ms=b_ms, bound_by=b_by)
    return r


def ring_kernel_rank(rank, init_file):
    """One of the two ranks of the ring_kernels phase: the probe's seconds
    and this rank's cases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    comm.init_world(Grid(1, 1, 2, rank), device=DEV, init_file=init_file)
    try:
        secs = krm.pingpong("my", PROBE_ROUNDS)
        results = [_ring_case(idx, *case, dtype, rank, wire)
                   for wire in ("bf16", "int8")
                   for dtype in (torch.bfloat16, torch.float32)
                   for idx, case in enumerate(RING_CASES)]
        torch.cuda.synchronize()
        comm.barrier()
    finally:
        comm.shutdown()
    return dict(probe_s=secs, cases=results)


def ring4_kernel_rank(rank, init_file):
    """One of the four ranks of the ring_kernels phase's ``model`` ring:
    this rank's megatron cases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    comm.init_world(Grid(*GRID, rank), device=DEV, init_file=init_file)
    try:
        ops.reset_launches()
        # fewer timed calls than the ring of two: four time-sliced ranks
        # make every call several slices long
        results = [_ring_case(100 + idx, *case, dtype, rank, wire, n=4, ax="model",
                              timer=lambda f: event_ms(f, reps=2, windows=3))
                   for wire in ("bf16", "int8")
                   for dtype in (torch.bfloat16, torch.float32)
                   for idx, case in enumerate(MEG_RING_CASES)]
        torch.cuda.synchronize()
        comm.barrier()
    finally:
        comm.shutdown()
    return dict(cases=results, launches={k: ops.LAUNCHES[k] for k in RING_KERNELS + INT8_KERNELS})


def ring_kernels_phase():
    """The three ring kernels and their int8 variants on a ring of two rank
    processes sharing the card, after the flag ping-pong probe; then on
    the ``model`` ring of four processes at megatron's blocks."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        res = comm.run_ranks(ring_kernel_rank, 2, (comm.temp_init_file(),), RING_TIMEOUT_S)
    except Exception as e:                      # the phase fails; the script goes on
        log(f"ring_kernels FAILED: {e}")
        return [], False
    probe = {r: PROBE_ROUNDS / res[r]["probe_s"] for r in res}
    log("ring_probe " + json.dumps(dict(rounds=PROBE_ROUNDS, rounds_per_s=probe,
                                         device_s={r: res[r]["probe_s"] for r in res},
                                         phase_s=time.perf_counter() - t0)))
    results, ok = [], True
    for r in sorted(res):
        for c in res[r]["cases"]:
            ok &= c["ok"]
            if r == 0:
                results.append(c)
                log("case " + json.dumps(c))
    t1 = time.perf_counter()
    try:
        res4 = comm.run_ranks(ring4_kernel_rank, 4, (comm.temp_init_file(),), RING_TIMEOUT_S)
    except Exception as e:
        log(f"ring_kernels (ring of four) FAILED: {e}")
        return results, False
    for r in sorted(res4):
        for c in res4[r]["cases"]:
            ok &= c["ok"]
            if r == 0:
                results.append(c)
                log("case " + json.dumps(c))
    log("ring4 " + json.dumps(dict(cases=len(res4[0]["cases"]), ranks=len(res4),
                                   ok=all(c["ok"] for r in res4 for c in res4[r]["cases"]),
                                   launches={r: res4[r]["launches"] for r in sorted(res4)},
                                   phase_s=time.perf_counter() - t1)))
    return results, ok


def _loopback_case(lb, idx, kernel, label, xs, ws, sd, main, dtype, wire):
    """One ring kernel over the loopback ring ``lb`` (its n ranks on n
    streams of this process): every rank's output against the ring's global
    result in fp32 (``ring_loopback.reference``), after one call from hop 0
    and two more that carry the hops on (the credit protocol across calls);
    timed by CUDA-graph replays beside one batched ``torch.matmul`` of all
    n ranks' products and n x a rank's bound.  A bf16 case on the wgmma
    route (every ring kernel, on either wire) is held and timed on the wmma
    route too, the two in turns.  An int8 AG-matmul or contracted AG-matmul
    must also have hopped ``quant_int8``'s pair bit for bit, on every route
    (``quant_pair`` quantizes the shard in a launch of its own
    before the ring kernel).  Returns the case rows (the chosen route's
    first)."""
    n = lb.n
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7000 + 100 * n + idx)
    int8 = wire == "int8"
    pair = kernel == "matmul_rs" and sd == 1 and label.startswith("gated")
    xl = [randn(gen, xs, dtype) for _ in range(n)]
    wl = [randn(gen, ws, dtype, ws[0] ** -0.5) for _ in range(n)]
    if pair:                                   # one kernel over [w1 | w1b]
        wl = [torch.cat([w, randn(gen, ws, dtype, ws[0] ** -0.5)], dim=1) for w in wl]
    split = ws[1] if pair and int8 else 0
    h = xs[2]
    if kernel == "ag_matmul":
        run = lambda p=None, reset=False: LB.ag_matmul(lb, xl, wl, int8=int8, impl=p,
                                                       reset=reset)
        want_fn = lambda: LB.reference(kernel, xl, wl, int8=int8)
        lib_a, lib_b = torch.cat(xl, dim=1).reshape(-1, h), torch.cat(wl, dim=1)
    elif kernel == "ag_matmul_contract":
        run = lambda p=None, reset=False: LB.ag_matmul_contract(lb, xl, wl, int8=int8, impl=p,
                                                                reset=reset)
        want_fn = lambda: LB.reference(kernel, xl, wl, int8=int8)
        lib_a, lib_b = torch.cat(xl, dim=2).reshape(-1, n * h), torch.cat(wl, dim=1)
    else:
        run = lambda p=None, reset=False: LB.matmul_rs(lb, xl, wl, sd, int8=int8, split=split,
                                                       impl=p, reset=reset)
        want_fn = lambda: LB.reference(kernel, xl, wl, sd, int8=int8, split=split)
        lib_a, lib_b = torch.stack([x.reshape(-1, h) for x in xl]), torch.stack(wl)
    nbytes, nops = _ring_work(kernel, xs, ws, sd, n, xl[0].element_size(), int8, pair)
    b_ms, b_by = bound(n * nbytes, n * nops, dtype)
    want = want_fn()
    mags = LB.partial_magnitudes(xl, wl, sd) if kernel == "matmul_rs" else None
    name = kernel + ("_int8" if int8 else "")
    routed = name in (ROUTED_INT8 if int8 else ROUTED_RING)
    routes = [None]
    if routed:
        chosen = krm.ring_impl(dtype, (xs, tuple(wl[0].shape)),
                               (xl[0].stride(), wl[0].stride()), n,
                               sd if kernel == "matmul_rs" else None, int8=int8,
                               contract=kernel == "ag_matmul_contract", split=split)
        routes = [chosen] + (["wmma"] if chosen == "wgmma" else [])
    checks = {}
    for p in routes:                            # held first, then timed
        ok, err = True, 0.0
        for reset in (True, False, False):
            ok_c, err_c, fields = _ring_errs(kernel, run(p, reset), want, dtype, n, int8, mags)
            ok, err = ok and ok_c, max(err, err_c)
        if int8 and kernel != "matmul_rs":
            # the pair that crossed the last hop, bit for bit quant_int8's
            run(p, True)
            torch.cuda.synchronize()
            fields = dict(fields, pair_exact=all(torch.equal(a, b)
                                                 for a, b in LB.hopped_pairs(lb, xl)))
            ok &= fields["pair_exact"]
        checks[p] = ok, err, fields
    calls = {p: [lambda p=p: run(p, True)] for p in routes}
    times = paired_ms(bench_ms, calls) if len(routes) > 1 else \
        {routes[0]: bench_ms(calls[routes[0]])}
    lib_ms, plain_ms = bench_ms([lambda: torch.matmul(lib_a, lib_b)]), bench_ms([want_fn])
    rows = []
    for p in routes:
        route = p or ("simt" if dtype == torch.float32 else "wmma")
        ok, err, fields = checks[p]
        rows.append(dict(
            kernel=name, case=f"{label} x={list(xs)} w={list(ws)}"
            + (f" scatter_dim={sd}" if sd else "") + (" pair" if pair else ""),
            loopback=True, route=route,
            wire=wire, dtype=str(dtype).replace("torch.", ""), n=n, ranks=n,
            main=main and dtype == torch.bfloat16 and n == 2 and p == routes[0],
            max_err=err, ok=ok, **fields, kernel_ms=times[p], plain_ms=plain_ms,
            plain="the global result in fp32 (ring_loopback.reference)", library_ms=lib_ms,
            library="one batched torch.matmul of all n ranks' products",
            bound_ms=b_ms, bound_by=b_by, bound_of="n ranks' bytes and operations",
            blocks=lb.cap(name, dtype, route if routed else None,
                          dtype if kernel == "ag_matmul_contract" else None),
            timing=LOOPBACK_TIMING))
    return rows


def ring_loopback_phase():
    """Every ring kernel and int8 variant over a loopback ring of n = 2 (the
    RING_CASES) and of n = 4 (the MEG_RING_CASES), in bf16 and fp32, all n
    ranks in this process on n streams (``kernels/ring_loopback.py``): the
    first times of the ring kernels' own, against the fp32 global result."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results, ok, routes, harness = [], True, {}, {}
    try:
        for n, ax, cases in LOOPBACK_RINGS:
            lb = LB.LoopbackRing(n, ax, DEV)
            ops.reset_launches()
            for wire in ("bf16", "int8"):
                for dtype in (torch.bfloat16, torch.float32):
                    for idx, case in enumerate(cases):
                        for r in _loopback_case(lb, idx, *case, dtype, wire):
                            ok &= r["ok"]
                            results.append(r)
                            log("case " + json.dumps(r))
            # a call without the ring kernel (the flags reset, each rank's
            # counters zeroed on its stream, the fork and the join): the
            # fixed cost inside every case's kernel_ms (the median of 3)
            harness[n] = float(np.median([bench_ms([lambda: lb.run(
                lambda r, ring_of, cnt: cnt.zero_(), True)]) for _ in range(3)]))
            torch.cuda.synchronize()
            routes[n] = {k: dict(v) for k, v in krm.IMPL_LAUNCHES.items()}
            del lb
    except Exception as e:                      # the phase fails; the script goes on
        log(f"ring_loopback FAILED: {type(e).__name__}: {e}")
        return results, False
    log("ring_loopback " + json.dumps(dict(
        rings=[dict(n=n, axis=ax, cases=len(c)) for n, ax, c in LOOPBACK_RINGS],
        rows=len(results), route_launches=routes, harness_ms=harness,
        harness="a call's flags reset, counter zeroing, fork and join, without the kernel",
        ok=ok, phase_s=time.perf_counter() - t0)))
    return results, ok


def ring_route_check(name, paths, launches, kernels=ROUTED_RING, need=None, fused=True):
    """Each rank's launches of the routed ring ``kernels`` by route
    (``paths``: {rank: ring_matmul.IMPL_LAUNCHES}), printed; ok when every
    launch took wgmma (the grid phases run bf16 at the full-width blocks,
    which the tensor cores take) and every rank launched each kernel of
    ``need`` (those of ``kernels`` that the phase's own kernel list names;
    default all of them).  Not ``fused`` (the two-way rings, which fuse no
    ring kernel): ok only when no rank launched any of them."""
    need = kernels if need is None else need
    if fused:
        ok = all(paths[rk][k]["wgmma"] == launches[rk][k] and (launches[rk][k] > 0 or k not in need)
                 for rk in paths for k in kernels)
    else:
        ok = all(launches[rk][k] == 0 for rk in paths for k in kernels)
    log(f"{name}_ring_paths " + json.dumps(dict(paths, ok=ok, checked=list(kernels),
                                                needed=list(need))))
    return ok

def grid_train_phase(name="grid_train", overlap="fused", wire="bf16", steps=GRID_STEPS,
                     layers=GRID_LAYERS, kernels=RING_KERNELS, bf16_step0=None,
                     strategy="hecaton", grid=GRID, pods=1):
    """Train qwen3-0.6b (full width; ``layers`` cuts the depth) on a grid of
    rank processes (``grid`` per pod; ``pods`` > 1 makes the pods more
    data parallelism, ``--pod-role data``) through the training
    launcher's grid entry under ``strategy`` and ``overlap`` on the
    ``wire``, beside the plain grid from the same parameters.  Every rank
    must launch each of ``kernels``; every rank's AG-matmul and matmul-RS
    launches (on the int8 wire its int8 AG-matmul and contracted AG-matmul
    launches) must all be on wgmma (printed by route), or under
    ``overlap="bidir"``, which fuses no ring kernel, must be none.  On the bf16 wire
    the first loss is held against the single-device port's (1e-3); on the
    int8 wire against it and
    ``bf16_step0`` (the bf16 wire's first loss) to QUANT_RTOL.
    Returns (ok, launches summed over the ranks, the first loss, each
    rank's NoP bytes per step by route)."""
    torch.cuda.empty_cache()
    d, mx, my = grid
    args = launch_train.parser().parse_args([
        "--arch", ARCH, "--dtype", "bfloat16", "--device", DEV, "--batch", str(TRAIN_BATCH),
        "--seq", str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICRO), "--layers", str(layers),
        "--steps", str(steps), "--strategy", strategy, "--data", str(d), "--mx", str(mx),
        "--my", str(my), "--overlap", overlap, "--comm-dtype", wire, "--pods", str(pods),
        "--pod-role", "data", "--timeout", str(GRID_TIMEOUT_S)])
    try:
        r = launch_train.run_grid(args, log_fn=log, check_plain=True)   # the main path
    except Exception as e:
        log(f"{name} FAILED: {e}")
        return False, {}, None, {}
    losses = [loss for _, loss in r["history"]]
    gnorms = r["grad_norms"]
    checks = r["checks"]
    rel = lambda a, b: abs(a - b) / abs(b)
    loss_rel = [rel(k, p) for k, p in zip(losses, checks["plain_losses"])]
    gnorm_rel = [rel(k, p) for k, p in zip(gnorms, checks["plain_grad_norms"])]
    single_rel = rel(losses[0], checks["single_step0_loss"])
    single_tol = GRID_LOSS_TOL if wire == "bf16" else QUANT_RTOL
    wire_rel = None if bf16_step0 is None else rel(losses[0], bf16_step0)
    worst_leaf = max(checks["param_rel"], key=checks["param_rel"].get)
    launches = r["launches"]
    routed = ROUTED_RING if wire == "bf16" else ROUTED_INT8
    ok_routes = ring_route_check(
        name, {rk: p["ring"] for rk, p in r["pipeline"]["paths"].items()}, launches, routed,
        need=tuple(k for k in routed if k in kernels), fused=overlap != "bidir")
    ok = (all(math.isfinite(x) for x in losses + gnorms) and len(loss_rel) == steps
          and max(loss_rel) <= GRID_LOSS_TOL and single_rel <= single_tol
          and len(gnorm_rel) == steps and max(gnorm_rel) <= GRID_GNORM_TOL
          and (wire_rel is None or wire_rel <= QUANT_RTOL)
          and all(launches[k][n] > 0 for k in launches for n in kernels) and ok_routes)
    nop = {rank: {k: v / steps for k, v in b.items()} for rank, b in r["nop_bytes"].items()}
    log(f"{name}_routes " + json.dumps(r["routes"]))
    log(f"{name}_kernels " + json.dumps(launches))
    log(f"{name} " + json.dumps(dict(
        arch=ARCH, layers=r["cfg"].num_layers,
        grid=(f"{pods}x" if pods > 1 else "") + "x".join(map(str, grid)),
        strategy=strategy, overlap=overlap, comm_dtype=wire, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        microbatches=TRAIN_MICRO,
        remat="fusion", dtype="bfloat16",
        losses=losses, plain_losses=checks["plain_losses"], loss_rel=loss_rel,
        grad_norms=gnorms, plain_grad_norms=checks["plain_grad_norms"], gnorm_rel=gnorm_rel,
        single_step0_loss=checks["single_step0_loss"], single_step0_rel=single_rel,
        tol_single_rel=single_tol, bf16_wire_step0_loss=bf16_step0, bf16_wire_step0_rel=wire_rel,
        tol_loss_rel=GRID_LOSS_TOL, tol_gnorm_rel=GRID_GNORM_TOL, tol_wire_rel=QUANT_RTOL,
        param_rel_worst=dict(leaf=worst_leaf, rel=checks["param_rel"][worst_leaf]),
        param_rel_median=sorted(checks["param_rel"].values())[len(checks["param_rel"]) // 2],
        step_ms=[1e3 * x for x in r["step_s"]], step_ms_note=GRID_LABEL,
        nop_bytes_per_step=nop, setup_s=r["setup_s"], wall_s=r["wall_s"], ok=ok)))
    totals = {n: sum(launches[k][n] for k in launches) for n in launches[0]}
    return ok, totals, losses[0], nop


def grid_pipeline_phase(name="grid_pipeline", grid=(1, 1, 1), layers=0, steps=PIPE_STEPS,
                        overlap="none", kernels=PIPE_KERNELS, wgmma=True):
    """Train paper-tinyllama-1.1b (full width; ``layers`` cuts the depth)
    as a 1F1B pipeline of PIPE_PODS stages on ``grid``-shaped pods through
    the launcher's entry (``--pods --pod-role pipeline``), beside the plain
    pipeline from the same parameters.  Gates: every step's loss and grad
    norm against the plain run's, the first loss against the single-device
    port's, each stage's executed order against ``stage_order`` and its
    stash peak against ``min(p - s, m)``, each of ``kernels`` launched on
    every rank, no rank launching the forward-only product and, with
    ``wgmma``, every attention launch on the tensor cores and every product
    and gate on wgmma; under the fused overlap, every rank's AG-matmul and
    matmul-RS launches on wgmma."""
    from repro_torch.parallel import pipeline as PP
    torch.cuda.empty_cache()
    d, mx, my = grid
    args = launch_train.parser().parse_args([
        "--arch", PIPE_ARCH, "--dtype", "bfloat16", "--device", DEV,
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatches", str(PIPE_MICRO),
        "--layers", str(layers), "--steps", str(steps), "--pods", str(PIPE_PODS),
        "--pod-role", "pipeline", "--data", str(d), "--mx", str(mx), "--my", str(my),
        "--overlap", overlap, "--timeout", str(GRID_TIMEOUT_S)])
    try:
        r = launch_train.run_grid(args, log_fn=log, check_plain=True)   # the main path
    except Exception as e:
        log(f"{name} FAILED: {e}")
        return False, {}
    losses = [loss for _, loss in r["history"]]
    gnorms, checks, pipe = r["grad_norms"], r["checks"], r["pipeline"]
    rel = lambda a, b: abs(a - b) / abs(b)
    loss_rel = [rel(k, p) for k, p in zip(losses, checks["plain_losses"])]
    gnorm_rel = [rel(k, p) for k, p in zip(gnorms, checks["plain_grad_norms"])]
    single_rel = rel(losses[0], checks["single_step0_loss"])
    launches = r["launches"]
    order_ok = {rk: [tuple(t) for t in pipe["executed"][rk]] ==
                [(t.kind, t.mb) for t in PP.stage_order(s, PIPE_PODS, PIPE_MICRO)]
                for rk, s in pipe["stage"].items()}
    stash_ok = {rk: pipe["max_stash"][rk] <= min(PIPE_PODS - s, PIPE_MICRO)
                for rk, s in pipe["stage"].items()}
    # the F ticks run the recompute's differentiable ops: no rank launches
    # the forward-only product (row 1), which pipe_kernel_phase does not hold
    fwd_only_ok = all(launches[k]["matmul"] == 0 for k in launches)
    paths_ok = True
    if wgmma:
        for rk, pth in pipe["paths"].items():
            for k in ("flash_attention", "flash_attention_bwd"):
                c = pth["attention"][k]
                paths_ok &= c["simt"] == 0 and c["wgmma"] == launches[rk][k] > 0
            for k in ("matmul", "tile_matmul", "gated_matmul"):
                c = pth["matmul"][k]
                paths_ok &= c["wgmma"] == sum(c.values()) == launches[rk][k]
    if overlap == "fused":
        paths_ok &= ring_route_check(name, {rk: p["ring"] for rk, p in pipe["paths"].items()},
                                     launches)
    ok = (all(math.isfinite(x) for x in losses + gnorms) and len(loss_rel) == steps
          and max(loss_rel) <= GRID_LOSS_TOL and single_rel <= GRID_LOSS_TOL
          and len(gnorm_rel) == steps and max(gnorm_rel) <= GRID_GNORM_TOL
          and all(order_ok.values()) and all(stash_ok.values()) and paths_ok and fwd_only_ok
          and all(launches[k][n] > 0 for k in launches for n in kernels))
    worst_leaf = max(checks["param_rel"], key=checks["param_rel"].get)
    log(f"{name}_kernels " + json.dumps(launches))
    log(f"{name}_paths " + json.dumps(dict(pipe["paths"], ok=paths_ok)))
    log(f"{name} " + json.dumps(dict(
        arch=PIPE_ARCH, layers=r["cfg"].num_layers, pods=PIPE_PODS,
        stage_grid="x".join(map(str, grid)), ranks=r["world"], overlap=overlap,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=PIPE_MICRO, remat="fusion",
        dtype="bfloat16", losses=losses, plain_losses=checks["plain_losses"],
        loss_rel=loss_rel, grad_norms=gnorms, plain_grad_norms=checks["plain_grad_norms"],
        gnorm_rel=gnorm_rel, single_step0_loss=checks["single_step0_loss"],
        single_step0_rel=single_rel, tol_loss_rel=GRID_LOSS_TOL,
        tol_gnorm_rel=GRID_GNORM_TOL,
        param_rel_worst=dict(leaf=worst_leaf, rel=checks["param_rel"][worst_leaf]),
        stage=pipe["stage"], executed=pipe["executed"], executed_ok=order_ok,
        max_stash=pipe["max_stash"], stash_ok=stash_ok, launches=launches,
        fwd_only_ok=fwd_only_ok,
        boundary_bytes_per_step=pipe["boundary_bytes"],
        step_ms=[1e3 * x for x in r["step_s"]], step_ms_note=PIPE_LABEL,
        setup_s=r["setup_s"], wall_s=r["wall_s"], ok=ok)))
    return ok, launches


def _leaf_bytes(state):
    return sum(t.numel() * t.element_size() for t in ckpt_manager._leaf_paths(state).values())


def _overlaps(r, writes):
    """Per timed step of a run: did a background write overlap it?"""
    out = []
    for t0, dt in zip(r["ckpt"]["step_t0"], r["step_s"]):
        out.append(any(w["start"] < t0 + dt and w["end"] > t0 for w in writes))
    return out


def _median_ms(xs):
    return 1e3 * float(np.median(xs)) if xs else None


def _write_rows(writes):
    return [dict(step=w["step"], bytes=w["bytes"], write_s=w["end"] - w["start"],
                 gb_per_s=w["bytes"] / 1e9 / (w["end"] - w["start"])) for w in writes]


def _saving_row(kind, r, no_write_steps):
    """What a saving run through the launcher cost its steps: ``kind``
    names the writers (threads or processes); the steps with no write in
    flight are the references' (``no_write_steps``, seconds)."""
    c = r["ckpt"]
    busy = _overlaps(r, c["writes"])
    return dict(writers=kind, losses=[x for _, x in r["history"]],
                step_ms=[1e3 * x for x in r["step_s"]], write_in_flight=busy,
                median_step_ms_write_in_flight=_median_ms(
                    [x for x, b in zip(r["step_s"][1:], busy[1:]) if b]),
                median_step_ms_no_write=_median_ms(no_write_steps),
                boundary_stall_ms=[1e3 * x for _, x in c["save_s"]],
                writes=_write_rows(c["writes"]),
                spawn_to_first_heartbeat_s=[x for _, x in c["spawn_s"]], handover=c["handover"],
                fleet_saves=c["fleet_saves"], fleet_events=c["fleet_events"])


def _gate(got, a, b):
    """The ``ckpt`` phase's resume gate: ``got`` bit-equal to reference
    ``a`` when the two references ``a`` and ``b`` are bit-equal, else each
    value within their spread of both."""
    if a == b:
        return got == a
    spread = max(abs(x - y) for x, y in zip(a, b))
    return len(got) == len(a) and all(min(x, y) - spread <= v <= max(x, y) + spread
                                      for v, x, y in zip(got, a, b))


def _state_gate(got, a, b):
    """The same gate over flattened states (lists of tensors): bit-equal
    to ``a`` when ``a`` and ``b`` are, else each leaf within their spread."""
    if all(torch.equal(x, y) for x, y in zip(a, b)):
        return all(torch.equal(v, x) for v, x in zip(got, a))
    return all(float((v.float() - x.float()).abs().max())
               <= float((x.float() - y.float()).abs().max()) for v, x, y in zip(got, a, b))


def ckpt_phase():
    """Checkpoints of full-width qwen3-0.6b training on one card through
    the launcher (bf16 over fp32 masters, batch 8 x 512, 2 microbatches):
    two uninterrupted references from one seed (their agreement sets the
    resume's gate: bit-equality if they are bit-equal, else their spread),
    a run that saves async every CKPT_EVERY steps and stops at
    CKPT_RESUME_AT, and a fresh run on its directory that must restore that
    step and meet the gate on the last two steps.  Then, on the resumed
    state: one blocking save and one restore, timed (the restore bit-equal
    to the state), and the async path's snapshot into a staging-arena slot
    on its first use and reused, beside a pageable ``.cpu()`` copy of the
    same leaves.  Returns (ok, for the runtime phase: the references'
    losses and steps, the depth, the saving run's row)."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        cfg = get_config(ARCH)
        steps = CKPT_RESUME_AT + 2

        def run(n, layers, *extra):
            lines = []
            args = launch_train.parser().parse_args([
                "--arch", ARCH, "--dtype", "bfloat16", "--device", DEV,
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--microbatches", str(TRAIN_MICRO), "--layers", str(layers),
                "--steps", str(n), *extra])
            r = launch_train.run(args, log_fn=lines.append)
            torch.cuda.synchronize()
            r["log"] = lines
            return r

        # the state's bytes at CKPT_LAYERS decide whether two checkpoints fit
        cfg = cfg.scaled(num_layers=CKPT_LAYERS)
        params, opt = train_step.init_train_state(cfg, device=DEV)
        nbytes = _leaf_bytes({"params": params, "opt_state": opt})
        del params, opt
        torch.cuda.empty_cache()
        free = shutil.disk_usage(root).free
        layers, cut = CKPT_LAYERS, None
        if free < 2.2 * nbytes:
            layers = max(2, int(CKPT_LAYERS * free / (2.2 * nbytes)))
            cut = f"{free / 1e9:.1f} GB free for two {nbytes / 1e9:.2f} GB checkpoints: " \
                  f"{layers} layers"
        refs = []
        for _ in range(2):
            r = run(steps, layers)
            refs.append(([loss for _, loss in r["history"]], r["step_s"][1:]))
            del r
            torch.cuda.empty_cache()
        (la, sa), (lb, sb) = refs
        bit_equal = la == lb
        spread = max(abs(a - b) for a, b in zip(la, lb))
        d = os.path.join(root, "run")
        saver = run(CKPT_RESUME_AT, layers, "--ckpt-dir", d, "--ckpt-every", str(CKPT_EVERY),
                    "--ckpt-keep", str(CKPT_KEEP), "--ckpt-writers", str(CKPT_WRITERS))
        del saver["state"]
        torch.cuda.empty_cache()
        writes = saver["ckpt"]["writes"]
        busy = _overlaps(saver, writes)
        resume = run(steps, layers, "--ckpt-dir", d, "--ckpt-every", NO_SAVE)
        resumed = [loss for _, loss in resume["history"]]
        want = la[CKPT_RESUME_AT:]
        ok_resume = _gate(resumed, want, lb[CKPT_RESUME_AT:])
        restored_line = f"restored checkpoint at step {CKPT_RESUME_AT}"
        shutil.rmtree(d)

        state = resume.pop("state")
        state = {"params": state["params"], "opt_state": state["opt_state"]}
        sbytes = _leaf_bytes(state)
        d2 = os.path.join(root, "sync")
        mgr = ckpt_manager.CheckpointManager(d2, writers=CKPT_WRITERS)
        t0 = time.perf_counter()
        mgr.save(steps, state)
        sync_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = mgr.restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ok_back = all(torch.equal(a, b.detach()) for a, b in
                      zip(ckpt_manager._leaf_paths(back).values(),
                          ckpt_manager._leaf_paths(state).values()))
        del back
        shutil.rmtree(d2)
        torch.cuda.empty_cache()
        # the async path's snapshot into an arena slot: first use, then reuse
        slot, snap_s = {}, []
        for _ in range(2):
            t0 = time.perf_counter()
            mgr._snapshot_host(state, slot)
            snap_s.append(time.perf_counter() - t0)
        del slot
        t0 = time.perf_counter()
        mgr._snapshot_host(state)                 # pageable: a .cpu() of each leaf
        pageable_s = time.perf_counter() - t0
        ok = (ok_resume and ok_back and restored_line in resume["log"]
              and len(writes) == CKPT_RESUME_AT // CKPT_EVERY
              and all(math.isfinite(x) for x in la + lb + resumed))
        line = dict(
            arch=ARCH, layers=layers or cfg.num_layers, cut=cut, batch=TRAIN_BATCH,
            seq=TRAIN_SEQ, microbatches=TRAIN_MICRO, dtype="bfloat16",
            checkpoint_bytes=writes[-1]["bytes"] if writes else None, state_bytes=sbytes,
            writers=CKPT_WRITERS, keep=CKPT_KEEP,
            gate="bit-equal" if bit_equal else f"spread {spread}",
            ref_losses=[la, lb], resumed_losses=resumed, want_losses=want,
            restored=resume["ckpt"]["start"], restored_line=restored_line in resume["log"],
            async_stall_ms=[1e3 * x for _, x in saver["ckpt"]["save_s"]],
            writes=_write_rows(writes),
            step_ms_saving_run=[1e3 * x for x in saver["step_s"]], write_in_flight=busy,
            median_step_ms_write_in_flight=_median_ms(
                [x for x, b in zip(saver["step_s"][1:], busy[1:]) if b]),
            median_step_ms_no_write=_median_ms(sa + sb),
            launcher_restore_s=resume["ckpt"]["restore_s"],
            sync_save_s=sync_s, sync_gb_per_s=sbytes / 1e9 / sync_s, restore_s=restore_s,
            restore_bit_equal=ok_back, arena_snapshot_ms=dict(first=1e3 * snap_s[0],
                                                              reused=1e3 * snap_s[1]),
            pageable_copy_ms=1e3 * pageable_s, ok=ok)
        log("ckpt " + json.dumps(line))
        return ok, dict(refs=(la, lb), layers=layers, no_write_steps=sa + sb,
                        threads=_saving_row("threads", saver, sa + sb))
    except Exception as e:                        # the phase fails; the script goes on
        log(f"ckpt FAILED: {type(e).__name__}: {e}")
        return False, None
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def grid_ckpt_phase():
    """Checkpoints of the 1x2x2 grid (qwen3-0.6b at full width, BIDIR_LAYERS
    layers, ``overlap="fused"``, the bf16 wire): an uninterrupted run saving
    after every step (rank 0 writes global leaves); its steps after the
    first retired (the run as if stopped after step 1's save); a fresh grid
    that restores step 1 and runs step 2, held against the uninterrupted
    run's step 2; then one card restoring the grid's checkpoint and running
    step 2, held against the grid's (GRID_LOSS_TOL relative, as
    ``grid_train`` holds the single-device loss)."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_grid_ckpt_")
    try:
        torch.cuda.empty_cache()
        d, mx, my = GRID
        base = ["--arch", ARCH, "--dtype", "bfloat16", "--device", DEV,
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--microbatches", str(TRAIN_MICRO), "--layers", str(BIDIR_LAYERS),
                "--steps", str(GRID_CKPT_STEPS), "--ckpt-dir", root]
        grid = ["--strategy", "hecaton", "--data", str(d), "--mx", str(mx), "--my", str(my),
                "--overlap", "fused", "--comm-dtype", "bf16", "--timeout", str(GRID_TIMEOUT_S)]
        parse = launch_train.parser().parse_args
        whole = launch_train.run_grid(parse(base + grid + ["--ckpt-every", "1"]), log_fn=log)
        retired = ckpt_manager.CheckpointManager(root).retire_steps_after(1)
        lines = []
        fresh = launch_train.run_grid(parse(base + grid + ["--ckpt-every", NO_SAVE]),
                                      log_fn=lines.append)
        one_lines = []
        one = launch_train.run(parse(base + ["--ckpt-every", NO_SAVE]), log_fn=one_lines.append)
        del one["state"]
        torch.cuda.empty_cache()
        rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
        want = whole["history"][1][1]
        grid_rel = rel(fresh["history"][0][1], want)
        one_rel = rel(one["history"][0][1], fresh["history"][0][1])
        restored = "restored checkpoint at step 1"
        writes = whole["ckpt"]["writes"]
        busy = _overlaps(whole, writes)
        ok = (retired == [GRID_CKPT_STEPS] and fresh["ckpt"]["start"] == 1
              and one["ckpt"]["start"] == 1 and restored in lines and restored in one_lines
              and [s for s, _ in fresh["history"]] == [1] and grid_rel <= GRID_LOSS_TOL
              and one_rel <= GRID_LOSS_TOL and len(writes) == GRID_CKPT_STEPS)
        log("grid_ckpt " + json.dumps(dict(
            arch=ARCH, layers=BIDIR_LAYERS, grid="x".join(map(str, GRID)), overlap="fused",
            comm_dtype="bf16", batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=TRAIN_MICRO,
            dtype="bfloat16", checkpoint_bytes=writes[-1]["bytes"] if writes else None,
            uninterrupted_losses=[x for _, x in whole["history"]],
            resumed_grid_loss=fresh["history"][0][1], resumed_grid_rel=grid_rel,
            one_card_loss=one["history"][0][1], one_card_rel=one_rel, tol_rel=GRID_LOSS_TOL,
            save_stall_ms=[1e3 * x for _, x in whole["ckpt"]["save_s"]],
            writes=_write_rows(writes), step_ms=[1e3 * x for x in whole["step_s"]],
            write_in_flight=busy, grid_restore_s=fresh["ckpt"]["restore_s"],
            one_card_restore_s=one["ckpt"]["restore_s"], step_ms_note=GRID_LABEL, ok=ok)))
        return ok
    except Exception as e:                        # the phase fails; the script goes on
        log(f"grid_ckpt FAILED: {type(e).__name__}: {e}")
        return False
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _flat_state(params, opt):
    return [t.detach().clone() for t in ckpt_manager._leaf_paths(
        {"params": params, "opt_state": opt}).values()]


def _runtime_batch(data, i, nan):
    b = data.batch_at(i)
    b["loss_mask"] = np.full((TRAIN_BATCH, TRAIN_SEQ), np.nan if nan else 1.0, np.float32)
    return b


def _guarded_run(cfg, step, gc, data, indices, nan_at=None, on_step=None):
    """Train a fresh seeded state over ``batch_at(i) for i in indices``
    through the loop with a TrainingGuard of ``gc`` (the loss mask NaN at
    loop step ``nan_at``); ``on_step(when, i, params, opt, metrics)`` sees
    each step before and after it.  Returns (losses, update_skipped per
    step, the final state flattened)."""
    params, opt = train_step.init_train_state(cfg, seed=SEED, device=DEV)
    skipped, n = [], [0]

    def wrapped(p, o, b):
        if on_step is not None:
            on_step("before", n[0], p, o, None)
        p, o, m = step(p, o, b)
        skipped.append(float(m["update_skipped"]))
        if on_step is not None:
            on_step("after", n[0], p, o, m)
        n[0] += 1
        return p, o, m

    it = Prefetcher((_runtime_batch(data, i, k == nan_at) for k, i in enumerate(indices)),
                    device=DEV)
    try:
        state = train_loop.train(wrapped, {"params": params, "opt_state": opt}, it,
                                 num_steps=len(indices),
                                 guard=rt_guard.TrainingGuard(gc),
                                 log_every=1000, log_fn=lambda *a: None)
    finally:
        it.close()
    final = _flat_state(state["params"], state["opt_state"])
    losses = [loss for _, loss in state["history"]]
    del state, params, opt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return losses, skipped, final


def _guarded_step(cfg, gc):
    rc = RunConfig("custom", "train", TRAIN_SEQ, TRAIN_BATCH)
    return train_step.build_train_step(cfg, ParallelConfig(microbatches=TRAIN_MICRO), rc,
                                       compute_dtype=torch.bfloat16, guard=gc)


def guard_skip_part(cfg):
    """Five guarded steps at full width with batch GUARD_NAN_AT's loss mask
    NaN: the skip, the state across it, the other losses against two runs
    over the stream without that batch."""
    gc = GuardConfig(grad_spike_factor=1e9)
    step = _guarded_step(cfg, gc)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    held = {}

    def watch(when, i, p, o, m):
        if i != GUARD_NAN_AT:
            return
        if when == "before":
            held["before"] = _flat_state(p, o)
        else:
            held["unchanged"] = all(torch.equal(a, b) for a, b in
                                    zip(_flat_state(p, o), held.pop("before")))

    losses, skipped, _ = _guarded_run(cfg, step, gc, data, range(GUARD_STEPS), GUARD_NAN_AT,
                                      watch)
    keep = [i for i in range(GUARD_STEPS) if i != GUARD_NAN_AT]
    refs = [_guarded_run(cfg, step, gc, data, keep)[0] for _ in range(2)]
    got = [losses[i] for i in keep]
    ok = (skipped == [float(i == GUARD_NAN_AT) for i in range(GUARD_STEPS)]
          and held.get("unchanged") is True and _gate(got, *refs)
          and all(math.isfinite(x) for x in got + refs[0] + refs[1]))
    return ok, dict(layers=cfg.num_layers, update_skipped=skipped, losses=losses,
                    state_unchanged_across_skip=held.get("unchanged"),
                    ref_losses=refs, gate="bit-equal" if refs[0] == refs[1] else "spread",
                    ok=ok)


def rollback_part(cfg, root):
    """run_supervised over an async 2-writer manager: a skip-cap rollback
    at data RB_POISON, then a hang, each restart against two clean runs
    over the filtered stream.  Returns (ok, line)."""
    gc = GuardConfig(grad_spike_factor=1e9, skip_cap=RB_SKIP_CAP, patience=99)
    step = _guarded_step(cfg, gc)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    bl = list(RB_POISON)
    filtered = [rt_guard.data_index(s, bl) for s in range(RB_STEPS)]
    refs = [_guarded_run(cfg, step, gc, data, filtered) for _ in range(2)]
    d = os.path.join(root, "rollback")
    mgr = ckpt_manager.AsyncCheckpointManager(d, keep=RB_STEPS, writers=2)
    retire, retired = mgr.retire_steps_after, []
    mgr.retire_steps_after = lambda s: retired.append((s, retire(s)))
    wd = rt_guard.Watchdog(HANG_TIMEOUT_S)
    incs, errors, hang = [], [], {"armed": False}

    def make_state(resume_step):
        params, opt = train_step.init_train_state(cfg, seed=SEED, device=DEV)
        state, start = {"params": params, "opt_state": opt}, 0
        incs.append(dict(resume=resume_step, published=mgr.all_steps()))
        if resume_step is not None:
            t0 = time.perf_counter()
            state, start = mgr.restore(state, step=resume_step)
            for _, t in lm.flatten(state["params"]):
                t.requires_grad_(True)
            incs[-1]["restore_s"] = time.perf_counter() - t0
        hang["armed"] = len(incs) == 2            # the incarnation after the rollback
        return state, start

    def run_steps(state, start, inc):
        blist = rt_guard.load_blocklist(d)
        n = [start]

        def held(p, o, b):
            p, o, m = step(p, o, b)
            if hang["armed"] and n[0] == HANG_STEP:
                hang["armed"] = False
                float(m["loss"])
                time.sleep(HANG_SLEEP_S)          # the host holds the step
            n[0] += 1
            return p, o, m

        it = Prefetcher(rt_guard.blocklisted_stream(
            lambda i: _runtime_batch(data, i, i in RB_POISON), start, blist), device=DEV)
        try:
            return train_loop.train(
                held, state, it, start_step=start, num_steps=RB_STEPS, ckpt=mgr,
                ckpt_every=RB_EVERY, log_every=1000, guard=rt_guard.TrainingGuard(gc),
                watchdog=wd, data_index_fn=lambda s: rt_guard.data_index(s, blist),
                log_fn=lambda *a: None)
        except Exception as e:
            if isinstance(e, rt_guard.DivergenceError):
                # let the poisoned boundary's save publish, so the rollback
                # has a published step to retire (else the abort drops it)
                mgr.wait_until_finished()
            errors.append(dict(type=type(e).__name__,
                               **{k: getattr(e, k) for k in ("kind", "first_step",
                                                             "data_indices", "step", "elapsed")
                                  if hasattr(e, k)}))
            incs[-1]["history"] = list(state.get("history", []))
            raise
        finally:
            it.close()

    try:
        state, n_inc = rt_fault.run_supervised(make_state, run_steps, ckpt=mgr,
                                               sleep_fn=lambda _: None)
    finally:
        wd.close()
        mgr.close()
    incs[-1]["history"] = list(state["history"])
    final = _flat_state(state["params"], state["opt_state"])
    (la, _, fa), (lb, _, fb) = refs
    # every incarnation's losses against the clean runs, the first one's
    # before its poisoned steps
    clean = [[(s, x) for s, x in inc.get("history", []) if k or s < RB_POISON[0]]
             for k, inc in enumerate(incs)]
    ok_hist = all(_gate([x for _, x in h], [la[s] for s, _ in h], [lb[s] for s, _ in h])
                  for h in clean)
    first = errors[0] if errors else {}
    ok = (n_inc == 3 and len(errors) == 2 and first.get("type") == "DivergenceError"
          and first.get("kind") == "skip_cap" and first.get("first_step") == RB_POISON[0]
          and tuple(first.get("data_indices", ())) == RB_POISON
          and retired == [(RB_POISON[0], [RB_POISON[0] + 1])]
          and incs[1]["resume"] is not None and incs[1]["resume"] <= RB_POISON[0]
          and all(s <= RB_POISON[0] for s in incs[1]["published"])
          and rt_guard.load_blocklist(d) == bl
          and errors[1].get("type") == "HangError" and errors[1].get("step") == HANG_STEP
          and incs[2]["resume"] == (max(incs[2]["published"]) if incs[2]["published"]
                                    else None)
          and ok_hist and _state_gate(final, fa, fb)
          and [s for s, _ in incs[2]["history"]] == list(range(incs[2]["resume"] or 0,
                                                               RB_STEPS)))
    line = dict(layers=cfg.num_layers, poison=RB_POISON, skip_cap=RB_SKIP_CAP, errors=errors,
                retired=retired, blocklist=rt_guard.load_blocklist(d),
                incarnations=[dict(resume=i["resume"], published=i["published"],
                                   restore_s=i.get("restore_s"),
                                   losses=[x for _, x in i.get("history", [])]) for i in incs],
                ref_losses=[la, lb], gate="bit-equal" if la == lb else "spread",
                hang_timeout_s=HANG_TIMEOUT_S, hang_sleep_s=HANG_SLEEP_S, ok=ok)
    del refs, fa, fb, state, final
    torch.cuda.empty_cache()
    return ok, line


def _files(d):
    out = {}
    for r, _, names in os.walk(d):
        for n in names:
            with open(os.path.join(r, n), "rb") as f:
                out[os.path.relpath(os.path.join(r, n), d)] = f.read()
    return out


def kill9_part(cfg, root):
    """One save of a RUNTIME_LAYERS-layer state with writer process 1
    SIGKILLed in its torn window: published with reassigned["1"],
    restored bit-equal, and the thread writers' files apart from that
    record."""
    params, opt = train_step.init_train_state(cfg, seed=SEED, device=DEV)
    state = {"params": params, "opt_state": opt}
    inj = rt_fault.FailureInjector(proc_fail_at={1: (1, "kill9")})
    d = os.path.join(root, "kill9")
    mgr = ckpt_manager.CheckpointManager(d, writers=2, writer_procs=True,
                                         proc_fault=inj.proc_fault)
    t0 = time.perf_counter()
    mgr.save(1, state)
    save_s = time.perf_counter() - t0
    back, _ = mgr.restore(state)
    ok_back = all(torch.equal(a, b.detach()) for a, b in
                  zip(ckpt_manager._leaf_paths(back).values(),
                      ckpt_manager._leaf_paths(state).values()))
    events, kind = list(mgr.fleet().events), mgr.fleet().arena_kind
    mgr.close()
    del back
    t = os.path.join(root, "kill9_threads")
    ckpt_manager.CheckpointManager(t, writers=2).save(1, state)
    fleet_files = _files(os.path.join(d, "step_00000001"))
    thread_files = _files(os.path.join(t, "step_00000001"))
    meta = json.loads(fleet_files[ckpt_manager.MANIFEST])
    why = meta.pop("reassigned", {})
    same = (sorted(fleet_files) == sorted(thread_files)
            and all(fleet_files[f] == thread_files[f] for f in thread_files
                    if f != ckpt_manager.MANIFEST)
            and meta == json.loads(thread_files[ckpt_manager.MANIFEST]))
    nbytes = sum(len(v) for v in fleet_files.values())
    del fleet_files, thread_files, state, params, opt
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(t, ignore_errors=True)
    torch.cuda.empty_cache()
    ok = (ok_back and same and list(why) == ["1"] and "exited (-9)" in why["1"]
          and inj.log == ["step 1: injected proc fault kill9 into writer 1"])
    return ok, dict(layers=cfg.num_layers, checkpoint_bytes=nbytes, reassigned=why,
                    restore_bit_equal=ok_back, thread_files_equal_apart_from_record=same,
                    handover=kind, fleet_events=events, save_s=save_s, ok=ok)


def procs_part(refs, root):
    """The ckpt phase's saving run through the launcher again, with
    ``--ckpt-procs`` (its turn after the ckpt phase's writer threads);
    then a resume from the fleet's step CKPT_RESUME_AT against the ckpt
    phase's references."""
    la, lb = refs["refs"]
    layers = refs["layers"]
    d = os.path.join(root, "procs")
    base = ["--arch", ARCH, "--dtype", "bfloat16", "--device", DEV, "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICRO), "--layers", str(layers),
            "--ckpt-dir", d]
    r = launch_train.run(launch_train.parser().parse_args(base + [
        "--steps", str(CKPT_RESUME_AT), "--ckpt-every", str(CKPT_EVERY), "--ckpt-keep",
        str(CKPT_KEEP), "--ckpt-writers", str(CKPT_WRITERS), "--ckpt-procs"]),
        log_fn=lambda *a: None)
    torch.cuda.synchronize()
    del r["state"]
    torch.cuda.empty_cache()
    procs = _saving_row("procs", r, refs["no_write_steps"])
    lines = []
    resume = launch_train.run(launch_train.parser().parse_args(base + [
        "--steps", str(CKPT_RESUME_AT + 2), "--ckpt-every", NO_SAVE]), log_fn=lines.append)
    del resume["state"]
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    resumed = [x for _, x in resume["history"]]
    ok = (resume["ckpt"]["start"] == CKPT_RESUME_AT
          and f"restored checkpoint at step {CKPT_RESUME_AT}" in lines
          and _gate(resumed, la[CKPT_RESUME_AT:], lb[CKPT_RESUME_AT:])
          and _gate(procs["losses"], la[:CKPT_RESUME_AT], lb[:CKPT_RESUME_AT])
          and len(procs["writes"]) == CKPT_RESUME_AT // CKPT_EVERY
          and procs["handover"] in ("shm", "spill")
          and len(procs["spawn_to_first_heartbeat_s"]) == CKPT_WRITERS)
    return ok, dict(layers=layers or get_config(ARCH).num_layers, writers=CKPT_WRITERS,
                    threads=refs["threads"], procs=procs, resumed_losses=resumed,
                    want_losses=la[CKPT_RESUME_AT:], restore_s=resume["ckpt"]["restore_s"],
                    shm_free_bytes=_shm_free(), ok=ok)


def _shm_free():
    try:
        return shutil.disk_usage("/dev/shm").free
    except OSError:
        return None


def runtime_phase(ckpt_refs):
    """The training runtime on the training cell: guard_skip, rollback
    (with the hang) and ckpt_procs (module docstring, phase 14)."""
    import tempfile
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    parts = {}
    try:
        cfg4 = get_config(ARCH).scaled(num_layers=RUNTIME_LAYERS)
        for name, fn in (("guard_skip", lambda: guard_skip_part(cfg4)),
                         ("rollback", lambda: rollback_part(cfg4, root)),
                         ("kill9", lambda: kill9_part(cfg4, root)),
                         ("ckpt_procs", lambda: procs_part(ckpt_refs, root)
                          if ckpt_refs is not None else (False, "no ckpt references"))):
            t1 = time.perf_counter()
            try:
                ok, line = fn()
            except Exception as e:                # the part fails; the phase goes on
                ok, line = False, f"{type(e).__name__}: {e}"
            parts[name] = ok
            log(f"runtime_{name} " + json.dumps(dict(line, part_s=time.perf_counter() - t1)
                                               if isinstance(line, dict) else
                                               dict(error=line, ok=False)))
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = all(parts.values())
    log("runtime " + json.dumps(dict(parts=parts, phase_s=time.perf_counter() - t0, ok=ok)))
    return ok


def grid_runtime_phase():
    """The 1x2x2 grid at RUNTIME_LAYERS layers with --guard --ckpt-procs and
    a blocklist (module docstring, phase 15)."""
    import tempfile
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_grid_runtime_")
    try:
        torch.cuda.empty_cache()
        bl = list(GRID_BLOCKLIST)
        rt_guard.publish_blocklist(root, bl)
        d, mx, my = GRID
        base = ["--arch", ARCH, "--dtype", "bfloat16", "--device", DEV,
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--microbatches", str(TRAIN_MICRO), "--layers", str(RUNTIME_LAYERS),
                "--steps", str(GRID_RUNTIME_STEPS), "--ckpt-dir", root, "--guard"]
        grid = ["--strategy", "hecaton", "--data", str(d), "--mx", str(mx), "--my", str(my),
                "--overlap", "fused", "--comm-dtype", "bf16", "--timeout", str(GRID_TIMEOUT_S)]
        parse = launch_train.parser().parse_args
        g = launch_train.run_grid(parse(base + grid + ["--ckpt-every", "1", "--ckpt-procs",
                                                        "--ckpt-writers", "2"]), log_fn=log)
        retired = ckpt_manager.CheckpointManager(root).retire_steps_after(1)
        lines = []
        one = launch_train.run(parse(base + ["--ckpt-every", NO_SAVE]), log_fn=lines.append)
        del one["state"]
        torch.cuda.empty_cache()
        hists = g["histories"]
        same = all(h == hists[0] for h in hists.values())
        want = g["history"][1][1]
        one_rel = abs(one["history"][0][1] - want) / abs(want)
        parents = g["pids"]["writer_parents"]
        ok = (len(hists) == 4 and same and g["first_data_index"] == rt_guard.data_index(0, bl)
              and one["first_data_index"] == rt_guard.data_index(1, bl)
              and all(s == [0.0] * GRID_RUNTIME_STEPS for s in g["skipped"].values())
              and retired == [GRID_RUNTIME_STEPS] and one["ckpt"]["start"] == 1
              and "restored checkpoint at step 1" in lines and one_rel <= GRID_LOSS_TOL
              and len(parents) == 2 and set(parents.values()) == {g["pids"]["rank"]}
              and len(g["ckpt"]["writes"]) == GRID_RUNTIME_STEPS
              and all(math.isfinite(x) for _, x in g["history"]))
        log("grid_runtime " + json.dumps(dict(
            arch=ARCH, layers=RUNTIME_LAYERS, grid="x".join(map(str, GRID)), overlap="fused",
            blocklist=bl, first_data_index=g["first_data_index"], ranks_equal=same,
            losses={r: [x for _, x in h] for r, h in hists.items()}, skipped=g["skipped"],
            one_card_loss=one["history"][0][1], one_card_rel=one_rel, tol_rel=GRID_LOSS_TOL,
            writer_parents=parents, rank0_pid=g["pids"]["rank"],
            spawn_to_first_heartbeat_s=[s for _, s in g["ckpt"]["spawn_s"]],
            handover=g["ckpt"]["handover"], fleet_saves=g["ckpt"]["fleet_saves"],
            fleet_events=g["ckpt"]["fleet_events"],
            save_stall_ms=[1e3 * x for _, x in g["ckpt"]["save_s"]],
            writes=_write_rows(g["ckpt"]["writes"]), step_ms=[1e3 * x for x in g["step_s"]],
            step_ms_note=GRID_LABEL, one_card_restore_s=one["ckpt"]["restore_s"],
            phase_s=time.perf_counter() - t0, ok=ok)))
        return ok
    except Exception as e:                        # the phase fails; the script goes on
        log(f"grid_runtime FAILED: {type(e).__name__}: {e}")
        return False
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the rest of serving: the dense KV cache, the int8 paged arena, the grid
# ---------------------------------------------------------------------------

def _max_rel(a, b):
    """max |a - b| over max |b|, in fp32 (tensors or numpy arrays)."""
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def serve_dense_phase():
    """Full-width qwen3-0.6b in fp32: each of DENSE_PROMPT_LENS prefilled
    into its own dense cache (``serve/step.build_prefill``, one length a
    batch) and decoded GEN tokens greedily (``build_decode_step``), then
    the same prompts through the paged engine: every sequence's tokens
    must be equal (JAX's ``test_decode_parity_dense_paged_teacher``), and
    the dense run must launch the serving kernels."""
    from repro_torch.serve import engine as SE
    from repro_torch.serve import step as SRV
    from repro_torch.serve.cache import blocks_for
    torch.cuda.empty_cache()
    cfg = get_config(ARCH)
    dt = torch.float32
    params = lm.init_params(cfg, seed=SEED, device=DEV, dtype=dt)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in DENSE_PROMPT_LENS]
    max_seq = max(DENSE_PROMPT_LENS) + GEN
    rc = RunConfig("serve", "decode", max_seq, 1)
    prefill = SRV.build_prefill(cfg, rc=rc, compute_dtype=dt)
    decode = SRV.build_decode_step(cfg, compute_dtype=dt)
    dense, pre_ms, tick_ms = [], [], []
    ops.reset_launches()
    with torch.inference_mode():                  # the main path
        for p in prompts:
            t0 = time.perf_counter()
            logits, caches = prefill(params, {"tokens": torch.from_numpy(
                p.astype(np.int64))[None].to(DEV)})
            tok = SRV.greedy_sample(logits)
            torch.cuda.synchronize()
            pre_ms.append(1e3 * (time.perf_counter() - t0))
            toks = [int(tok[0, 0])]
            t0 = time.perf_counter()
            for i in range(GEN - 1):
                pos = torch.full((1, 1), len(p) + i, dtype=torch.int64, device=DEV)
                logits, caches = decode(params, caches, tok.long(), pos)
                tok = SRV.greedy_sample(logits)
                toks.append(int(tok[0, 0]))
            torch.cuda.synchronize()
            tick_ms.append(1e3 * (time.perf_counter() - t0) / (GEN - 1))
            dense.append(toks)
    launches = dict(ops.LAUNCHES)
    pool = PoolConfig(slots=len(prompts), block=BLOCK,
                      num_blocks=len(prompts) * blocks_for(max_seq, BLOCK) + 1,
                      max_seq=max_seq)
    eng = SE.DecodeEngine(cfg, params, pool, device=DEV, compute_dtype=dt)
    fin = eng.run([SE.Request(rid=i, prompt=p, max_new=GEN) for i, p in enumerate(prompts)])
    paged = [fin[i].tokens for i in range(len(prompts))]
    same = [a == b for a, b in zip(dense, paged)]
    ok = all(same) and all(launches[k] > 0 for k in SERVE_KERNELS)
    log("serve_dense " + json.dumps(dict(
        arch=ARCH, dtype="float32", prompt_lens=DENSE_PROMPT_LENS, gen=GEN,
        tokens_equal_paged=same, first_tokens=[t[:8] for t in dense],
        prefill_ms=pre_ms, decode_tick_ms=tick_ms, decode_note=HOST_BOUND,
        dense_cache_bytes=[dense_cache_bytes(cfg, 1, len(p) + GEN, dt) for p in prompts],
        launches=launches,
        ok=ok)))
    del params, eng
    return ok


def _quant_gather_check(bf16_pool):
    """Every K/V row the bf16 pool holds (all layers, the leased blocks),
    written on the card through ``quant_paged_write`` into a fresh int8
    arena and read back through ``quant_paged_gather`` in fp32: within
    scale / 2 of the row (round to nearest; QUANT_ROUND_SLACK for the
    fp32 roundings), per element, and each row's scale read back is
    max |row| / 127 of the written row (QUANT_SCALE_RTOL), so a scale too
    large cannot pass the rounding bound.  Returns (ok, the largest
    |read - written| / scale, the largest |scale - max|row|/127| over
    max|row|/127, rows checked)."""
    from repro_torch.models import attention as ATT
    worst, scale_worst, rows = 0.0, 0.0, 0
    slots = [s for s in range(bf16_pool.pool.slots) if bf16_pool.active[s]]
    table = torch.as_tensor(bf16_pool.table[slots], dtype=torch.int64, device=DEV)
    lengths = torch.zeros(len(slots), dtype=torch.int32, device=DEV)
    for arena in bf16_pool.arenas["attn"]:
        for layer in arena:
            n = [int(bf16_pool.lengths[s]) for s in slots]
            vals = ATT.paged_gather(layer, table)[:, :max(n)]
            q = torch.zeros(layer.shape, dtype=torch.int8, device=DEV)
            sc = torch.ones(layer.shape[:-1] + (1,), dtype=torch.float32, device=DEV)
            ATT.quant_paged_write(q, sc, vals, table, lengths)
            got = ATT.quant_paged_gather(q, sc, table, torch.float32)[:, :max(n)]
            scale = ATT.paged_gather(sc, table)[:, :max(n)]
            for b, m in enumerate(n):
                row = vals[b, :m].float()
                err = (got[b, :m] - row).abs() / scale[b, :m]
                worst = max(worst, float(err.max()))
                amax = row.abs().amax(dim=-1, keepdim=True).double()
                want = torch.where(amax > 0, amax / 127, torch.ones_like(amax))
                scale_worst = max(scale_worst, float(
                    ((scale[b, :m].double() - want).abs() / want).max()))
                rows += m * (layer[0, 0].numel() // layer.shape[-1])
    ok = worst <= 0.5 + QUANT_ROUND_SLACK and scale_worst <= QUANT_SCALE_RTOL
    return ok, worst, scale_worst, rows


def serve_quant_kv_phase(bf16_tok_s, arch=ARCH, prompt_lens=PROMPT_LENS,
                         want_ratio=QUANT_KV_RATIO, logit_tol=QUANT_KV_LOGIT_TOL,
                         kernels=SERVE_KERNELS, name="serve_quant_kv"):
    """The serve phase's trace through ``--quant-kv`` (bf16): every request
    finishes with GEN tokens; one int8 block is ``want_ratio`` of the bf16
    pool's exactly; on the card ``quant_paged_gather`` reads back every
    row the bf16 arena holds within scale / 2; the first decode tick's
    logits, teacher-forced on the same tokens over the same prompts,
    against the bf16 arena's (``logit_tol``).  Decode tok/s is printed
    beside the ``serve`` line's, both host-bound.  Returns (ok, the
    main path's launches)."""
    from repro_torch.serve import step as SRV
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    args = launch_serve.parser().parse_args([
        "--arch", arch, "--dtype", "bfloat16", "--device", DEV,
        "--slots", str(SLOTS), "--block", str(BLOCK), "--requests", str(REQUESTS),
        "--prompt-lens", ",".join(map(str, prompt_lens)), "--gen", str(GEN),
        "--seed", str(SEED), "--quant-kv"])
    ops.reset_launches()
    r = launch_serve.run(args)                    # the main path
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    dims = dict(kfa.DIM_LAUNCHES)
    md = dict(kfa.IMPL_LAUNCHES["mla_decode"])
    fin = r["finished"]
    ok_fin = len(fin) == REQUESTS and all(len(f.tokens) == GEN for f in fin.values())
    ratio = r["block_bytes"] / r["dense_block_bytes"]
    ok_ratio = ratio == want_ratio
    # teacher-forced: the same SLOTS prompts prefilled into a bf16 and an
    # int8 pool, then one decode tick on the same tokens
    cfg = get_config(arch)
    # MLA: every prefill's attention at (96, 64), natively on the tensor cores
    ok_dims = cfg.mla is None or \
        native_launches(dims, "flash_attention", mla_dims(cfg)) == launches["flash_attention"]
    # MLA: every absorbed decode on the tensor cores
    ok_md = cfg.mla is None or (md["wgmma"] == launches["mla_decode"] > 0 and md["simt"] == 0)
    params = r["engine"].params
    rng = np.random.default_rng(SEED + 1)
    lens = [prompt_lens[i % len(prompt_lens)] for i in range(SLOTS)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    pc = PoolConfig(slots=SLOTS, block=BLOCK, num_blocks=r["engine"].pool.pool.num_blocks,
                    max_seq=r["engine"].pool.pool.max_seq)
    prefill = SRV.build_prefill_paged(cfg, compute_dtype=torch.bfloat16)
    decode = SRV.build_decode_step(cfg, compute_dtype=torch.bfloat16)
    pools, logits = {}, {}
    with torch.inference_mode():
        for quant in (False, True):
            pool = CachePool(cfg, pc, device=DEV, dtype=torch.bfloat16, quant_kv=quant)
            for p in prompts:
                slot = pool.admit(len(p))
                prefill(params, pool.prefill_tree(slot),
                        torch.from_numpy(p.astype(np.int64))[None].to(DEV), len(p))
                pool.commit_prefill(slot, len(p))
                pool.ensure_append(slot)
            tokens = torch.arange(1, SLOTS + 1, device=DEV)[:, None] * 7
            pos = torch.from_numpy(pool.lengths.astype(np.int64)[:, None]).to(DEV)
            logits[quant] = decode(params, pool.decode_tree(), tokens, pos)[0]
            pools[quant] = pool
        ok_gather, worst, scale_worst, rows = _quant_gather_check(pools[False])
    torch.cuda.synchronize()
    rel = _max_rel(logits[True], logits[False])
    argmax_same = bool((logits[True].argmax(-1) == logits[False].argmax(-1)).all())
    ok = (ok_fin and ok_ratio and ok_gather and rel <= logit_tol and ok_dims and ok_md
          and all(launches[k] > 0 for k in kernels))
    log(f"{name} " + json.dumps(dict(
        arch=arch, dtype="bfloat16", sequences=r["sequences"], ticks=r["ticks"],
        preemptions=r["preemptions"], prefill_ms_mean=r["prefill_ms_mean"],
        decode_tok_s=r["decode_tok_s"], serve_bf16_decode_tok_s=bf16_tok_s,
        decode_note=HOST_BOUND, block_bytes=r["block_bytes"],
        bf16_block_bytes=r["dense_block_bytes"], ratio=ratio, want_ratio=want_ratio,
        paged_peak_bytes=r["paged_peak_bytes"], gather_worst_over_scale=worst,
        scale_worst_rel=scale_worst, tol_scale_rel=QUANT_SCALE_RTOL, gather_rows=rows,
        tick_logits_rel=rel, tol_tick_logits_rel=logit_tol,
        tick_argmax_same=argmax_same, launches=launches, attention_dims=dims_json(dims),
        mla_decode_routes=md,
        seconds=time.perf_counter() - t_phase, ok=ok)))
    del pools, logits, r
    return ok, launches


def grid_serve_phase():
    """Full-width qwen3-0.6b served on a 1x2x2 grid of four rank processes
    (hecaton, fused, bf16) through the serving launcher's grid entry:
    ``build_prefill`` of GRID_SERVE_BATCH x GRID_SERVE_PROMPT into sharded
    dense caches, then GRID_SERVE_TICKS decode ticks teacher-forced on the
    one-card dense path's greedy tokens.  Every step's logits of every
    rank against the one-card path's (GRID_SERVE_TOL); every rank must
    launch the ring kernels in prefill, every AG-matmul and matmul-RS of
    them on wgmma, and the serving kernels in decode."""
    from repro_torch.serve import step as SRV
    torch.cuda.empty_cache()
    cfg = get_config(ARCH)
    dt = torch.bfloat16
    plen, B, ticks = GRID_SERVE_PROMPT, GRID_SERVE_BATCH, GRID_SERVE_TICKS
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, size=(B, plen))
    params = lm.init_params(cfg, seed=SEED, device=DEV, dtype=dt)
    rc = RunConfig("serve", "decode", plen + ticks + 1, B)
    prefill = SRV.build_prefill(cfg, rc=rc, compute_dtype=dt)
    decode = SRV.build_decode_step(cfg, compute_dtype=dt)
    want, teacher = [], []
    with torch.inference_mode():
        logits, caches = prefill(params, {"tokens": torch.from_numpy(prompts).to(DEV)})
        want.append(logits.float().cpu())
        for i in range(ticks):
            tok = SRV.greedy_sample(logits)
            teacher.append(tok[:, 0].cpu().numpy())
            pos = torch.full((B, 1), plen + i, dtype=torch.int64, device=DEV)
            logits, caches = decode(params, caches, tok.long(), pos)
            want.append(logits.float().cpu())
    del params, caches, logits
    torch.cuda.empty_cache()
    d, mx, my = GRID_SERVE
    args = launch_serve.parser().parse_args([
        "--arch", ARCH, "--dtype", "bfloat16", "--device", DEV, "--slots", str(B),
        "--prompt-lens", str(plen), "--gen", str(ticks + 1), "--seed", str(SEED),
        "--data", str(d), "--mx", str(mx), "--my", str(my), "--overlap", "fused",
        "--timeout", str(GRID_TIMEOUT_S)])
    try:
        r = launch_serve.run_grid(args, teacher=np.stack(teacher, axis=1),
                                  keep_logits=True)          # the main path
    except Exception as e:
        log(f"grid_serve FAILED: {type(e).__name__}: {e}")
        return False, {}
    rels = {}
    for rank, got in r["logits"].items():
        lo, hi = r["rows"][rank]
        rels[rank] = [_max_rel(g, w[lo:hi]) for g, w in zip(got, want)]
    worst = max(max(v) for v in rels.values())
    launches = r["launches"]
    ok_launch = all(lc["prefill"][k] > 0 for lc in launches.values() for k in
                    ("ag_matmul", "matmul_rs")) and all(
        lc["decode"][k] > 0 for lc in launches.values() for k in ("matmul", "flash_attention"))
    ok_routes = ring_route_check("grid_serve", r["ring_paths"],
                                 {rk: lc["prefill"] for rk, lc in launches.items()})
    ok = (len(rels) == d * mx * my and all(len(v) == ticks + 1 for v in rels.values())
          and worst <= GRID_SERVE_TOL and ok_launch and ok_routes)
    log("grid_serve_kernels " + json.dumps(launches))
    log("grid_serve " + json.dumps(dict(
        arch=ARCH, grid="x".join(map(str, GRID_SERVE)), strategy="hecaton", overlap="fused",
        dtype="bfloat16", batch=B, prompt=plen, ticks=ticks,
        logits_rel_prefill=[v[0] for v in rels.values()],
        logits_rel_ticks_max=[max(v[1:]) for v in rels.values()], logits_rel_worst=worst,
        tol_logits_rel=GRID_SERVE_TOL, prefill_ms=1e3 * r["prefill_s"],
        decode_tok_s=r["decode_tok_s"], note=GRID_LABEL, wall_s=r["wall_s"], ok=ok)))
    return ok, launches


# ---------------------------------------------------------------------------
# multi-head latent attention (minicpm3-4b)
# ---------------------------------------------------------------------------

def check_mla_decode(results, gen, B, T, kv_len, dtype, *, main=True, label=""):
    """The absorbed decode kernel against ``ref.mla_decode_plain`` at
    minicpm3-4b's dims (40 heads, latent 256, rope 32, scale 96^-0.5):
    c_kv and k_rope are strided views of one gathered [B, T, 288] buffer,
    as the paged gather hands them over.  fp32 out of both dtypes, held
    to the fp32 bound.  The case takes ``mla_impl``'s route: on the tensor
    cores (bf16) the SIMT route is held and timed on the same inputs, in
    turns, and the tensor-core row (the main one) carries its time as
    ``simt_ms``.  The yardstick is one F.scaled_dot_product_attention on
    the concatenated latent (q [B, 40, 1, 288] against one kv head, k =
    [c_kv | k_rope], v = c_kv, ``scale=``), which the port never calls.
    The bound counts the visible latent rows (a row of kv_len 0 reads all
    T) and 2 x 40 x (288 + 256) operations per visible row."""
    nh, (Ld, R) = 40, kfa.MLA_DIMS
    elt = torch.tensor([], dtype=dtype).element_size()
    rows = sum(T if n <= 0 else min(n, T) for n in kv_len)
    nbytes = (B * nh * (Ld + R) + rows * (Ld + R)) * elt + B * nh * Ld * 4
    nops = 2 * rows * nh * (Ld + R + Ld)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=DEV)
    scale = 96 ** -0.5
    sets = []
    for _ in range(n_copies(B * T * (Ld + R) * elt)):
        q_lat, q_rope = randn(gen, (B, nh, Ld), dtype), randn(gen, (B, nh, R), dtype)
        sets.append((q_lat, q_rope, randn(gen, (B, T, Ld + R), dtype),
                     torch.cat([q_lat, q_rope], dim=-1)[:, :, None]))
    mask = (torch.arange(T, device=DEV)[None, :] < kl[:, None])[:, None, None, :]
    args = lambda s: (s[0], s[1], s[2][..., :Ld], s[2][..., Ld:], kl, scale)  # noqa: E731
    kern = lambda s, p: kfa.mla_decode(*args(s), impl=p)  # noqa: E731
    plain = lambda s: ref.mla_decode_plain(*args(s))  # noqa: E731
    lib = lambda s: F.scaled_dot_product_attention(  # noqa: E731
        s[3], s[2][:, None], s[2][:, None, :, :Ld], attn_mask=mask, scale=scale,
        enable_gqa=True)
    a0 = args(sets[0])[:4]
    impl = kfa.mla_impl(dtype, B, nh, T, tuple(st for t in a0 for st in t.stride()[:2]),
                        tuple(t.data_ptr() for t in a0))
    paths = kfa.IMPLS if impl == "wgmma" else (impl,)
    calls = {p: [lambda s=s, p=p: kern(s, p) for s in sets] for p in paths}
    times = paired_ms(bench_ms, calls) if impl == "wgmma" else {impl: None}
    lib_ms, want, ok = bench_ms([lambda s=s: lib(s) for s in sets]), plain(sets[0]), True
    for p in times:                     # the chosen route first: its row is the main one
        extra = dict(simt_ms=times["simt"]) if p == "wgmma" else None
        ok &= record(results, "mla_decode", f"{label} B={B} nh={nh} T={T} kv_len={kv_len}",
                     dtype, main and p == impl, kern(sets[0], p), want, calls[p],
                     [lambda s=s: plain(s) for s in sets], None, nbytes, nops,
                     kernel_ms=times[p], path=p, library_ms=lib_ms, extra=extra)
    return ok


def mla_dims(cfg):
    """(dk, dv) of MLA's prefill and training attention: (dn + dr, dv)."""
    m = cfg.mla
    return m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim


def native_launches(dims_counts, kernel, dims):
    """Launches of ``kernel`` at (dk, dv) = ``dims`` natively on the tensor
    cores, in a snapshot of ``kfa.DIM_LAUNCHES``."""
    return dims_counts.get((kernel, "wgmma", *dims, "native"), 0)


def dims_json(dims_counts):
    """A snapshot of ``kfa.DIM_LAUNCHES`` with string keys."""
    return {f"{n} {p} {a}x{b} {how}": c for (n, p, a, b, how), c in sorted(dims_counts.items())}


def mla_kernel_phase(cfg):
    """MLA's kernels at minicpm3-4b's full-width shapes: the absorbed
    decode at the serving tick (4 slots over the pool's 544-row page view,
    one slot idle at length 1; bf16, the kernels line's row) and off it
    (B 1 to 3, T of 64, off the key tiles, 256 with an empty row; fp32
    and bf16; bf16 on the tensor cores beside SIMT, timed in turns); then rows 3 and 3b at dk 96 / dv 64 (natively on the tensor
    cores in bf16, beside the route that padded v to 96 and all three to
    128, timed in turns; padded to 128 on the SIMT path), off the kernels
    line's sums: the three serving prefills, the training microbatch's
    forward, its backward in bf16 and, at batch 1, fp32."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    nh, (dk, dv) = cfg.num_heads, mla_dims(cfg)
    Tpool = -(-(max(MLA_PROMPT_LENS) + GEN) // BLOCK) * BLOCK
    bf, f32 = torch.bfloat16, torch.float32
    results, ok = [], True
    for dtype in (bf, f32):
        ok &= check_mla_decode(results, gen, SLOTS, Tpool, [64, 301, 512, 1], dtype,
                               main=dtype == bf, label="decode tick")
        ok &= check_mla_decode(results, gen, 1, 64, [64], dtype, main=False, label="one row")
        ok &= check_mla_decode(results, gen, 2, 100, [37, 100], dtype, main=False,
                               label="T off the tile")
        ok &= check_mla_decode(results, gen, 3, 256, [256, 0, 129], dtype, main=False,
                               label="empty row")
    for P in MLA_PROMPT_LENS:
        ok &= check_attention(results, gen, 1, nh, nh, dk, P, Tpool, [0], [P], bf, main=False,
                              label="mla prefill", dv=dv)
    ok &= check_attention(results, gen, 1, nh, nh, dk, 256, Tpool, [0], [256], f32,
                          main=False, label="mla prefill", dv=dv)
    B = TRAIN_BATCH // TRAIN_MICRO
    ok &= check_attention(results, gen, B, nh, nh, dk, TRAIN_SEQ, TRAIN_SEQ, [0] * B,
                          [TRAIN_SEQ] * B, bf, main=False, label="mla train", dv=dv)
    ok &= check_attention_bwd(results, gen, B, nh, nh, dk, TRAIN_SEQ, bf, main=False, dv=dv)
    ok &= check_attention_bwd(results, gen, 1, nh, nh, dk, TRAIN_SEQ, f32, main=False, dv=dv)
    log("mla_kernels " + json.dumps(dict(cases=len(results), seconds=time.perf_counter() - t0,
                                         ok=ok)))
    return results, ok


def _paged_logits(cfg, params, toks, plen, dtype, plain):
    """Logits of a ``plen``-token prefill into a fresh paged pool, then one
    decode step per remaining token of ``toks`` (fed, not sampled, so both
    paths see the same inputs) at its position: [len(toks), V] fp32."""
    n = len(toks)
    pool = CachePool(cfg, PoolConfig(1, BLOCK, -(-n // BLOCK) + 1, n), device=DEV, dtype=dtype)
    slot = pool.admit(plen)
    pctx, t = PCtx(plain=plain), torch.from_numpy(toks).to(DEV)[None]
    with torch.inference_mode():
        out = lm.forward(pctx, cfg, params, {"tokens": t[:, :plen], "_dtype": dtype},
                         caches=pool.prefill_tree(slot))
        pool.commit_prefill(slot, plen)
        logits = [out.logits[0]]
        for i in range(plen, n):
            if not pool.ensure_append(slot):
                raise RuntimeError("the check's pool is sized for every token")
            pos = torch.full((1, 1), i, dtype=torch.int64, device=DEV)
            step = lm.forward(pctx, cfg, params, {"tokens": t[:, i:i + 1], "positions": pos,
                                                  "_dtype": dtype}, caches=pool.decode_tree())
            pool.advance(slot)
            logits.append(step.logits[0])
    return torch.cat(logits).float()


def mla_model_check(cfg):
    """minicpm3-4b at full width: a MLA_CHECK_PROMPT-token prompt's prefill
    and MLA_CHECK_DECODE decode steps through the kernels against the
    plain-op path, bf16 at 62 layers (and both against the plain fp32
    forward), fp32 at 2 layers; the gates of ``ssm_model_check`` (bf16:
    5e-2 relative, and the kernel path as close to fp32 as the plain bf16
    path, 25% margin; fp32 1e-4).  The kernel path must launch the
    absorbed decode once a layer and step (bf16 on wgmma, fp32 on SIMT;
    the routes reported), and every prefill attention on the tensor cores
    in bf16, natively at (dk, dv) = (96, 64)."""
    t0 = time.perf_counter()
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=MLA_CHECK_PROMPT + MLA_CHECK_DECODE)
    ok, report = True, {}
    for dtype, layers in ((torch.bfloat16, cfg.num_layers), (torch.float32, 2)):
        c = cfg.scaled(num_layers=layers)
        paths = [("kernel", dtype, False), ("plain", dtype, True)]
        if dtype == torch.bfloat16:
            paths.append(("plain_fp32", torch.float32, True))
        logits = {}
        for name, dt_, plain in paths:
            params = lm.init_params(c, seed=SEED, device=DEV, dtype=dt_)
            ops.reset_launches()
            logits[name] = _paged_logits(c, params, toks, MLA_CHECK_PROMPT, dt_, plain)
            if name == "kernel":
                launches = dict(ops.LAUNCHES)
                fa = dict(kfa.IMPL_LAUNCHES["flash_attention"])
                md = dict(kfa.IMPL_LAUNCHES["mla_decode"])
                dims = dict(kfa.DIM_LAUNCHES)
            del params
            torch.cuda.empty_cache()
        rel = lambda a, b: ((logits[a] - logits[b]).norm() / logits[b].norm()).item()  # noqa
        want_fa = "wgmma" if dtype == torch.bfloat16 else "simt"
        ok_launch = (launches["mla_decode"] == MLA_CHECK_DECODE * layers
                     and md[want_fa] == launches["mla_decode"]
                     and fa[want_fa] == launches["flash_attention"] == layers)
        if dtype == torch.bfloat16:         # every bf16 prefill at (96, 64), natively
            ok_launch &= native_launches(dims, "flash_attention", mla_dims(cfg)) == layers
        entry = dict(layers=layers, prompt=MLA_CHECK_PROMPT, decode_steps=MLA_CHECK_DECODE,
                     max_abs_err=(logits["kernel"] - logits["plain"]).abs().max().item(),
                     rel_kernel_vs_plain=rel("kernel", "plain"),
                     mla_decode_launches=launches["mla_decode"], mla_decode_routes=md,
                     attention_paths=fa,
                     attention_dims=dims_json(dims))
        good = bool(torch.isfinite(logits["kernel"]).all()) and ok_launch
        if dtype == torch.bfloat16:
            entry.update(rel_kernel_vs_fp32=rel("kernel", "plain_fp32"),
                         rel_plain_vs_fp32=rel("plain", "plain_fp32"), tol_rel=5e-2)
            good &= entry["rel_kernel_vs_plain"] <= 5e-2 and \
                entry["rel_kernel_vs_fp32"] <= 1.25 * entry["rel_plain_vs_fp32"] + 1e-3
        else:
            entry["tol_rel"] = 1e-4
            good &= entry["rel_kernel_vs_plain"] <= 1e-4
        entry["ok"] = good
        ok &= good
        report[str(dtype).replace("torch.", "")] = entry
    report["seconds"] = time.perf_counter() - t0
    log("mla_model_check " + json.dumps(report))
    return ok


def serve_mla_phase():
    """Full-width minicpm3-4b in bf16 through the serving entry point (the
    serve phase's trace, prompts of MLA_PROMPT_LENS): beside the serve
    phase's gates, every decode tick (the warm-up's included) launches the
    absorbed decode kernel once a layer, on the tensor cores every time
    (``mla::decode_wgmma``), and every prefill's attention runs on the
    tensor cores at (dk, dv) = (96, 64), natively."""
    t0 = time.perf_counter()
    ok, launches = serve_phase(False, MLA_ARCH, MLA_PROMPT_LENS, MLA_SERVE_KERNELS, "_mla")
    cfg = get_config(MLA_ARCH)
    L, ticks = cfg.num_layers, SERVE_TICKS[MLA_ARCH]
    fa = dict(kfa.IMPL_LAUNCHES["flash_attention"])
    md = dict(kfa.IMPL_LAUNCHES["mla_decode"])
    dims = dict(kfa.DIM_LAUNCHES)
    ok_ticks = (launches["mla_decode"] == L * (ticks + 1) and md["simt"] == 0
                and md["wgmma"] == launches["mla_decode"])
    ok_prefill = fa["simt"] == 0 and fa["wgmma"] == launches["flash_attention"] > 0 and \
        native_launches(dims, "flash_attention", mla_dims(cfg)) == fa["wgmma"]
    ok &= ok_ticks and ok_prefill
    log("serve_mla_paths " + json.dumps(dict(
        mla_decode=md, mla_decode_per_tick=launches["mla_decode"] / (ticks + 1),
        layers=L, ticks=ticks, warmup_ticks=1, flash_attention=fa,
        attention_dims=dims_json(dims), seconds=time.perf_counter() - t0,
        ok=ok_ticks and ok_prefill)))
    return ok, launches


def train_mla_phase():
    """Full-width minicpm3-4b at MLA_TRAIN_LAYERS of its 62 layers through
    the training launcher (bf16 over fp32 masters, batch 8 x 512, 2
    microbatches, remat fusion, MLA_TRAIN_STEPS steps, the first a
    warm-up): every training kernel launches, every attention forward and
    backward on the tensor cores natively at (dk, dv) = (96, 64), every tile matmul
    and gate on wgmma; step ms and peak memory; then the loss and every
    gradient of one microbatch against the plain path (``grad_check``:
    bf16 at MLA_TRAIN_LAYERS layers, fp32 at 2)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    args = launch_train.parser().parse_args([
        "--arch", MLA_ARCH, "--layers", str(MLA_TRAIN_LAYERS), "--dtype", "bfloat16",
        "--device", DEV, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--microbatches", str(TRAIN_MICRO), "--steps", str(MLA_TRAIN_STEPS)])
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    r = launch_train.run(args, log_fn=log)            # the main path
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(ops.LAUNCHES)
    paths = {k: dict(v) for k, v in kfa.IMPL_LAUNCHES.items()}
    dims = dict(kfa.DIM_LAUNCHES)
    mm_paths = {k: dict(kmm.IMPL_LAUNCHES[k]) for k in ("tile_matmul", "gated_matmul")}
    cfg, losses = r["cfg"], [loss for _, loss in r["history"]]
    step_ms_all = [1e3 * t for t in r["step_s"]]
    step_ms = float(np.median(step_ms_all[1:]))
    ok_paths = all(paths[k]["simt"] == 0 and paths[k]["wgmma"] == launches[k] > 0
                   and native_launches(dims, k, mla_dims(cfg)) == launches[k]
                   for k in ("flash_attention", "flash_attention_bwd"))
    ok_mm = all(c["wgmma"] == launches[k] > 0 and c["wgmma"] == sum(c.values())
                for k, c in mm_paths.items())
    ok = (all(math.isfinite(x) for x in losses) and ok_paths and ok_mm
          and all(launches[k] > 0 for k in TRAIN_KERNELS) and launches["mla_decode"] == 0)
    n_params = sum(t.numel() for _, t in lm.flatten(r["state"]["params"]))
    del r
    torch.cuda.empty_cache()
    t_run = time.perf_counter() - t0
    ok_g = grad_check(cfg, "mla_grad_check")
    log("train_mla " + json.dumps(dict(
        arch=MLA_ARCH, layers=cfg.num_layers, params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        microbatches=TRAIN_MICRO, remat="fusion", dtype="bfloat16", losses=losses,
        step_ms_median=step_ms, step_ms=step_ms_all[1:], warmup_step_ms=step_ms_all[0],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3), peak_gib=peak_gib,
        launches=launches, attention_paths=paths, attention_dims=dims_json(dims),
        mm_paths=mm_paths, run_seconds=t_run,
        seconds=time.perf_counter() - t0, ok=ok, grad_check_ok=ok_g)))
    return ok and ok_g, launches


def check_moe_grouped(results, gen, E, C, K, N, dtype, *, gated, act, main=True, label="",
                      empty=0):
    """One grouped product of E experts, C rows each, [C, K] x [K, N] (and
    a second weight when ``gated``), against its plain version on the
    route ``kmoe.grouped_impl`` chooses; ``empty`` experts' slots all
    zero (an expert no token chose) and as many more half zero.  The
    library yardstick: one ``torch.bmm`` (the down-projection) or two
    (the gated product's products only, as the gated matmul's
    ``products_only``)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nw = 2 if gated else 1
    nbytes = (E * C * K + nw * E * K * N + E * C * N) * elt
    sets = []
    for _ in range(n_copies(nbytes)):
        x = randn(gen, (E, C, K), dtype)
        x[:empty] = 0
        x[empty:2 * empty, C // 2:] = 0
        sets.append((x, [randn(gen, (E, K, N), dtype, K ** -0.5) for _ in range(nw)]))
    name = "moe_grouped_gated" if gated else "moe_grouped_mm"
    impl = kmoe.grouped_impl(dtype, C)
    kern = lambda s: kmoe.grouped(s[0], *s[1], act=act)  # noqa: E731
    plain = (lambda s: ref.grouped_gated_plain(s[0], *s[1], act=act)) if gated else \
        (lambda s: ref.grouped_mm_plain(s[0], s[1][0], act=act))
    lib = [(lambda s=s: [torch.bmm(s[0], w) for w in s[1]]) for s in sets]
    before = kmoe.IMPL_LAUNCHES[name][impl]
    out = kern(sets[0])
    on_route = kmoe.IMPL_LAUNCHES[name][impl] == before + 1
    big = nbytes > 4e9                    # grok-1's layer: event windows, no graph of its plain
    timer = (lambda calls: event_ms(calls[0], reps=2, windows=3)) if big else bench_ms
    case = f"E={E} C={C} K={K} N={N} act={act}" + (f" {label}" if label else "")
    ok = record(results, name, case, dtype, main, out, plain(sets[0]),
                [lambda s=s: kern(s) for s in sets], [lambda s=s: plain(s) for s in sets], lib,
                nbytes, nw * 2 * E * C * K * N, timer=timer, path=impl,
                extra=dict(route_counted=on_route,
                           library="torch.bmm" + (" x 2: the products only" if gated else "")))
    del sets, out
    torch.cuda.empty_cache()
    return ok and on_route


def _moe_slots(gen, T, k, E, cap):
    """A real dispatch of T tokens' random top-k choices: slot_of [T, k]
    int32 (-1 where dropped) and the count of valid assignments."""
    scores = torch.rand((T, E), generator=gen, device=DEV)
    idx = MLP.top_k(scores, k)[1]
    st = MLP._dispatch_indices(idx.reshape(-1), E, 0, cap)
    slot_of = MLP.slot_of_assignments(st, T * k).reshape(T, k)
    return slot_of, int((slot_of >= 0).sum().item())


def check_moe_combine(results, gen, T, k, E, H, dtype, *, main=True):
    """The combine of T tokens' k expert rows over a real dispatch (C at
    the model's capacity, dropped assignments -1) against its plain
    version, which it must equal bit for bit; the bound counts the valid
    rows read once, the gates, the slots and the output.  The library
    yardstick: one ``F.embedding_bag`` (mode sum, the gates as per-sample
    weights) over the rows, a dropped assignment given row 0 and gate 0
    and the gates cast to yd's dtype (which it requires) outside the
    timed call."""
    cap = max(1, int(k * T * 1.25 / E))
    elt = torch.tensor([], dtype=dtype).element_size()
    slot_of, n_valid = _moe_slots(gen, T, k, E, cap)
    nbytes = n_valid * H * elt + T * k * 8 + T * H * elt
    sets = []
    for _ in range(n_copies(E * cap * H * elt)):
        gate = torch.rand((T, k), generator=gen, device=DEV)
        sets.append((randn(gen, (E, cap, H), dtype), gate / gate.sum(-1, keepdim=True),
                     slot_of))
    bags = [(s[0].view(-1, H), slot_of.clamp(min=0),
             torch.where(slot_of >= 0, s[1], 0.0).to(dtype)) for s in sets]
    lib = [(lambda b=b: F.embedding_bag(b[1], b[0], per_sample_weights=b[2], mode="sum"))
           for b in bags]
    before = kmoe.IMPL_LAUNCHES["moe_combine"]["token"]
    out = kmoe.combine(*sets[0])
    want = ref.moe_combine_plain(*sets[0])
    exact = bool(torch.equal(out, want))
    lib_err = (lib[0]().float() - want.float()).abs().max().item()
    ok = record(results, "moe_combine", f"T={T} k={k} E={E} C={cap} H={H}", dtype, main, out,
                want, [lambda s=s: kmoe.combine(*s) for s in sets],
                [lambda s=s: ref.moe_combine_plain(*s) for s in sets], lib, nbytes,
                2 * n_valid * H, path="token",
                extra=dict(valid=n_valid, dropped=T * k - n_valid, exact=exact,
                           route_counted=kmoe.IMPL_LAUNCHES["moe_combine"]["token"] ==
                           before + 1,
                           library="F.embedding_bag(mode='sum', per_sample_weights)",
                           library_max_err=lib_err))
    return ok and exact


def moe_kernel_phase():
    """The MoE's kernels at the serving shapes of granite-moe-3b-a800m and
    one layer of grok-1-314b (module docstring, phase 26)."""
    cfg, grok = get_config(MOE_ARCH), get_config(GROK_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    results, ok = [], True
    E, H, F = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    for C in MOE_CS:
        for dtype in (torch.bfloat16, torch.float32) if C in (1, 37) else (torch.bfloat16,):
            main = dtype == torch.bfloat16 and C in MOE_MAIN_CS
            ok &= check_moe_grouped(results, gen, E, C, H, F, dtype, gated=True, act="silu",
                                    main=main, empty=5)
            ok &= check_moe_grouped(results, gen, E, C, F, H, dtype, gated=False, act="none",
                                    main=main, empty=5)
    Eg, Hg, Fg = grok.moe.num_experts, grok.d_model, grok.d_ff
    for C in GROK_CS:
        ok &= check_moe_grouped(results, gen, Eg, C, Hg, Fg, torch.bfloat16, gated=True,
                                act="gelu", main=False, label="grok-1")
        ok &= check_moe_grouped(results, gen, Eg, C, Fg, Hg, torch.bfloat16, gated=False,
                                act="none", main=False, label="grok-1")
    for T in COMBINE_TS:
        for dtype in (torch.bfloat16, torch.float32) if T == COMBINE_TS[0] else \
                (torch.bfloat16,):
            ok &= check_moe_combine(results, gen, T, cfg.moe.top_k, E, H, dtype,
                                    main=dtype == torch.bfloat16)
    return results, ok


def _moe_control(kind, gated, mm):
    """The kernel path's grouped products (``gated``, ``mm``: the ops) with
    one change, for ``moe_model_check``'s controls: ``h_bf16`` rounds each
    product of the gated form to bf16 before the activation and the gate
    multiply, and the activation too (JAX's roundings); ``w_e4m3`` and
    ``w_e5m2`` round the expert weights to fp8 (3 and 2 mantissa bits)
    before the kernels take them."""
    if kind == "h_bf16":
        def gated_h(xd, w1, w1b, *, act):
            a, b = kmoe.grouped(xd, w1), kmoe.grouped(xd, w1b)
            return (ref.EPILOGUE_ACTS[act](a.float()).to(a.dtype).float() * b.float()).to(
                a.dtype)
        return gated_h, mm
    fp8 = {"w_e4m3": torch.float8_e4m3fn, "w_e5m2": torch.float8_e5m2}[kind]
    q = lambda w: w.to(fp8).to(w.dtype)  # noqa: E731
    return (lambda xd, w1, w1b, *, act: gated(xd, q(w1), q(w1b), act=act),
            lambda h, w, *, act="none": mm(h, q(w), act=act))


def moe_model_check(cfg):
    """granite-moe-3b-a800m at full width: a MOE_CHECK_PROMPT-token prefill
    and MOE_CHECK_DECODE decode steps through the kernels against the plain
    path (module docstring, phase 27).  A top-k choice flips between two
    paths where two experts' router probabilities nearly tie, and a
    flipped token's expert rows then differ wholly and spread, so every
    gate compares paths on one routing: the kernel path's choices, each
    layer's replayed in call order into the other paths (their gates
    re-weighed from their own probabilities).  bf16 at MOE_GATE_LAYERS
    layers: ``mla_model_check``'s gates, the kernel path within 5e-2 of
    the plain bf16 path and as close to the plain fp32 forward as the
    plain bf16 path (25% margin); controls, the kernel path with one
    change each (``_moe_control``), held to the same gates, of which the
    fp8 ones must fail them.  bf16 at all 32 layers, where the plain bf16
    path itself stands ~0.11 from fp32: the fp32-distance gate, and,
    reported beside it, the two bf16 paths' gap on one routing and each
    routing freely, and per layer the top-k choices they differ on.  fp32
    at 32 layers: within 1e-4 of the plain path."""
    t0 = time.perf_counter()
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=MOE_CHECK_PROMPT + MOE_CHECK_DECODE)
    c_pre = MLP.capacity(cfg, MOE_CHECK_PROMPT)
    steps = 1 + MOE_CHECK_DECODE
    ok, report = True, {}
    chosen, mode = {}, {"path": None, "replay": None, "i": 0}
    real_top_k, replayed = MLP.top_k, {}
    real_ops = (ops.moe_grouped_gated, ops.moe_grouped_mm)

    def routing_top_k(probs, k):
        if mode["replay"] is not None:         # the kernel path's choices, in call order
            idx = mode["replay"][mode["i"]]
            mode["i"] += 1
            return probs.gather(-1, idx), idx
        vals, idx = real_top_k(probs, k)
        chosen.setdefault(mode["path"], []).append(idx)
        return vals, idx

    MLP.top_k = routing_top_k
    try:
        for dtype, L in ((torch.bfloat16, MOE_GATE_LAYERS), (torch.bfloat16, cfg.num_layers),
                         (torch.float32, cfg.num_layers)):
            c = cfg.scaled(num_layers=L)
            gate_depth = dtype == torch.bfloat16 and L == MOE_GATE_LAYERS
            # (name, dtype, plain, on the kernel path's routing, control)
            paths = [("kernel", dtype, False, False, None),
                     ("plain_pinned", dtype, True, True, None)]
            if dtype == torch.bfloat16:
                paths.append(("fp32_pinned", torch.float32, True, True, None))
                paths += [(f"control_{k}", dtype, False, True, k) for k in MOE_CONTROLS] \
                    if gate_depth else [("plain", dtype, True, False, None)]
            logits = {}
            chosen.clear()
            for name, dt_, plain, pinned, control in paths:
                params = lm.init_params(c, seed=SEED, device=DEV, dtype=dt_)
                ops.reset_launches()
                mode.update(path=name, i=0, replay=chosen["kernel"] if pinned else None)
                if control is not None:
                    ops.moe_grouped_gated, ops.moe_grouped_mm = _moe_control(control, *real_ops)
                try:
                    logits[name] = _paged_logits(c, params, toks, MOE_CHECK_PROMPT, dt_, plain)
                finally:
                    ops.moe_grouped_gated, ops.moe_grouped_mm = real_ops
                if name == "kernel":
                    launches = dict(ops.LAUNCHES)
                    routes = {k: dict(kmoe.IMPL_LAUNCHES[k]) for k in MOE_KERNELS}
                replayed[name] = mode["i"]
                del params
                torch.cuda.empty_cache()
            rel = lambda a, b: ((logits[a] - logits[b]).norm() / logits[b].norm()).item()  # noqa
            if dtype == torch.bfloat16:
                want = {"moe_grouped_gated": {"wgmma": L, "gemv": MOE_CHECK_DECODE * L,
                                              "simt": 0}}
            else:
                want = {"moe_grouped_gated": {"wgmma": 0, "gemv": 0, "simt": steps * L}}
            want["moe_grouped_mm"] = want["moe_grouped_gated"]
            ok_launch = (all(launches[k] == steps * L for k in MOE_KERNELS)
                         and all(routes[k] == want[k] for k in want)
                         and routes["moe_combine"]["token"] == steps * L
                         and all(replayed[n] == steps * L for n, _, _, pin, _ in paths if pin))
            entry = dict(layers=L, prompt=MOE_CHECK_PROMPT, decode_steps=MOE_CHECK_DECODE,
                         prefill_capacity=c_pre, decode_capacity=MLP.capacity(cfg, 1),
                         max_abs_err=(logits["kernel"] - logits["plain_pinned"]).abs().max()
                         .item(),
                         rel_kernel_vs_plain=rel("kernel", "plain_pinned"),
                         launches={k: launches[k] for k in MOE_KERNELS}, routes=routes)
            good = bool(torch.isfinite(logits["kernel"]).all()) and ok_launch
            if dtype == torch.bfloat16:
                floor = rel("plain_pinned", "fp32_pinned")
                passes = lambda n: ((not gate_depth or rel(n, "plain_pinned") <= 5e-2)  # noqa
                                    and rel(n, "fp32_pinned") <= 1.25 * floor + 1e-3)
                entry.update(rel_kernel_vs_fp32=rel("kernel", "fp32_pinned"),
                             rel_plain_vs_fp32=floor, tol_fp32=1.25 * floor + 1e-3)
                good &= passes("kernel")
                if gate_depth:
                    entry["tol_rel"] = 5e-2
                    entry["controls"] = {k: dict(
                        rel_vs_plain=rel(f"control_{k}", "plain_pinned"),
                        rel_vs_fp32=rel(f"control_{k}", "fp32_pinned"),
                        passes_gates=passes(f"control_{k}"), must_fail=k in MOE_CONTROLS_FAIL)
                        for k in MOE_CONTROLS}
                    entry["controls_failed_as_required"] = not any(
                        entry["controls"][k]["passes_gates"] for k in MOE_CONTROLS_FAIL)
                    good &= entry["controls_failed_as_required"]
                else:
                    # per layer: the top-k choices (over the prefill and every step) where
                    # the kernel path and the plain bf16 path, each routing freely, differ
                    diff = []
                    for i in range(L):
                        n = 0
                        for s in range(steps):
                            a = chosen["kernel"][s * L + i]
                            b = chosen["plain"][s * L + i]
                            oa = torch.zeros(a.shape[0], cfg.moe.num_experts, device=DEV)
                            ob = torch.zeros_like(oa)
                            oa.scatter_(1, a, 1.0)
                            ob.scatter_(1, b, 1.0)
                            n += int((oa * (1 - ob)).sum().item())
                        diff.append(n)
                    entry.update(rel_kernel_vs_plain_free=rel("kernel", "plain"),
                                 topk_diff_per_layer=diff,
                                 topk_choices_per_layer=(MOE_CHECK_PROMPT + MOE_CHECK_DECODE)
                                 * cfg.moe.top_k)
            else:
                entry["tol_rel"] = 1e-4
                good &= entry["rel_kernel_vs_plain"] <= 1e-4
            entry["ok"] = good
            ok &= good
            report[f"{str(dtype).replace('torch.', '')}_{L}"] = entry
    finally:
        MLP.top_k = real_top_k
    report["seconds"] = time.perf_counter() - t0
    log("moe_model_check " + json.dumps(report))
    return ok


def serve_moe_phase():
    """Full-width granite-moe-3b-a800m in bf16 through the serving entry
    point (module docstring, phase 28)."""
    t0 = time.perf_counter()
    ok, launches = serve_phase(False, MOE_ARCH, MOE_PROMPT_LENS, MOE_SERVE_KERNELS, "_moe")
    cfg = get_config(MOE_ARCH)
    L, ticks, prefills = cfg.num_layers, SERVE_TICKS[MOE_ARCH], SERVE_PREFILLS[MOE_ARCH]
    routes = {k: dict(kmoe.IMPL_LAUNCHES[k]) for k in MOE_KERNELS}
    steps = ticks + 1 + prefills             # the warm-up's tick and prefills included
    # prefills whose C is at most 16 (gemv): the warm-up's and the trace's
    # 64-token prompts, when nothing was preempted (a re-admitted prompt is longer)
    small = [n for n in MOE_PROMPT_LENS if MLP.capacity(cfg, n) <= kmoe.GEMV_MAX_C]
    trace = [MOE_PROMPT_LENS[i % len(MOE_PROMPT_LENS)] for i in range(REQUESTS)]
    n_small = len(small) + sum(n in small for n in trace)
    exact = prefills == len(MOE_PROMPT_LENS) + REQUESTS
    ok_paths = all(launches[k] == L * steps for k in MOE_KERNELS) and \
        routes["moe_combine"]["token"] == L * steps
    for k in ("moe_grouped_gated", "moe_grouped_mm"):
        r = routes[k]
        ok_paths &= r["simt"] == 0 and r["wgmma"] + r["gemv"] == launches[k]
        ok_paths &= (r["gemv"] == L * (ticks + 1 + n_small) and
                     r["wgmma"] == L * (prefills - n_small)) if exact else \
            r["gemv"] >= L * (ticks + 1) and r["wgmma"] > 0
    ok &= ok_paths
    log("serve_moe_paths " + json.dumps(dict(
        routes=routes, per_step={k: launches[k] / steps for k in MOE_KERNELS}, layers=L,
        ticks=ticks, warmup_ticks=1, prefills=prefills, gemv_prefills=n_small if exact else None,
        seconds=time.perf_counter() - t0, ok=ok_paths)))
    return ok, launches


PHASE_S = {}                              # seconds of each phase, in run order


def timed(name, fn, *a, **kw):
    """``fn(*a, **kw)``, its seconds kept in PHASE_S under ``name``."""
    t0 = time.perf_counter()
    try:
        return fn(*a, **kw)
    finally:
        PHASE_S[name] = time.perf_counter() - t0
        log(f"phase {name} {PHASE_S[name]:.1f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace decode ticks and a training step with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t_start = t0 = time.perf_counter()
    logs = build.build_all()
    PHASE_S["build"] = time.perf_counter() - t0
    log(f"build {time.perf_counter() - t0:.2f}s " +
        json.dumps({k: v.strip()[-400:] for k, v in logs.items()}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         check=True, capture_output=True, text=True).stdout.strip()

    ok_sass = timed("sass", sass_counts)
    cfg = get_config(ARCH)
    results, ok_k = timed("kernels", kernel_phase, cfg)
    t_results, ok_tk = timed("train_kernels", train_kernel_phase, cfg)
    results += t_results
    ok_m = timed("model_check", model_check, cfg)
    ok_g = timed("grad_check", grad_check, cfg)
    ok_t, t_launches = timed("train", train_phase, args.profile)
    ok_s, s_launches = timed("serve", serve_phase, args.profile)
    ssm_cfg = get_config(SSM_ARCH)
    s_results, ok_sk = timed("ssd_kernels", ssd_kernel_phase, ssm_cfg)
    results += s_results
    ok_sm = timed("ssm_model_check", ssm_model_check, ssm_cfg)
    ok_ss, ss_launches = timed("serve_ssm", serve_phase, args.profile, SSM_ARCH,
                               SSM_PROMPT_LENS, SSM_SERVE_KERNELS, "_ssm")
    l_results, ok_rl = timed("ring_loopback", ring_loopback_phase)
    results += l_results
    r_results, ok_rk = timed("ring_kernels", ring_kernels_phase)
    results += r_results
    ok_gt, g_launches, bf16_step0, hec_nop = timed("grid_train", grid_train_phase)
    ok_gq, q_launches, _, _ = timed("grid_train_int8", grid_train_phase, "grid_train_int8",
                                    wire="int8", steps=INT8_STEPS, kernels=INT8_KERNELS,
                                    bf16_step0=bf16_step0)
    ok_gb, _, _, _ = timed("grid_bidir", grid_train_phase, "grid_bidir", overlap="bidir",
                           wire="int8", steps=BIDIR_STEPS, layers=BIDIR_LAYERS, kernels=())
    ok_gm, _, _, meg_nop = timed("grid_megatron", grid_train_phase, "grid_megatron",
                                 steps=MEG_STEPS, kernels=MEG_KERNELS, strategy="megatron")
    log("grid_nop_bytes " + json.dumps(dict(
        note="per rank and step: the logged forward collectives (recompute included), "
             "bytes received; the backward's transposes are not logged",
        hecaton=hec_nop, megatron=meg_nop,
        megatron_over_hecaton={r: meg_nop[r]["total"] / hec_nop[r]["total"]
                               for r in meg_nop if r in hec_nop and hec_nop[r]["total"]})))
    ok_c, ckpt_refs = timed("ckpt", ckpt_phase)
    ok_gc = timed("grid_ckpt", grid_ckpt_phase)
    ok_rt = timed("runtime", runtime_phase, ckpt_refs)
    ok_grt = timed("grid_runtime", grid_runtime_phase)
    p_results, ok_pk = timed("pipe_kernels", pipe_kernel_phase, get_config(PIPE_ARCH))
    results += p_results
    ok_gp, _ = timed("grid_pipeline", grid_pipeline_phase, layers=PIPE_LAYERS)
    ok_gph, _ = timed("grid_pipeline_hecaton", grid_pipeline_phase, "grid_pipeline_hecaton",
                      grid=PIPE_HEC_GRID, layers=PIPE_HEC_LAYERS, steps=PIPE_HEC_STEPS,
                      overlap="fused", kernels=RING_KERNELS, wgmma=False)
    ok_gpd, _, _, _ = timed("grid_pod_data", grid_train_phase, "grid_pod_data",
                            steps=POD_DATA_STEPS, layers=POD_DATA_LAYERS, grid=POD_DATA_GRID,
                            pods=POD_DATA_PODS)
    ok_sd = timed("serve_dense", serve_dense_phase)
    ok_sq, _ = timed("serve_quant_kv", serve_quant_kv_phase, SERVE_TOK_S.get(ARCH))
    ok_gs, _ = timed("grid_serve", grid_serve_phase)
    torch.cuda.empty_cache()
    mla_cfg = get_config(MLA_ARCH)
    m_results, ok_mk = timed("mla_kernels", mla_kernel_phase, mla_cfg)
    results += m_results
    ok_mm = timed("mla_model_check", mla_model_check, mla_cfg)
    ok_ms, ms_launches = timed("serve_mla", serve_mla_phase)
    ok_mq, _ = timed("serve_mla_quant_kv", serve_quant_kv_phase, SERVE_TOK_S.get(MLA_ARCH),
                     MLA_ARCH, MLA_PROMPT_LENS, MLA_QUANT_RATIO, MLA_QUANT_LOGIT_TOL,
                     MLA_SERVE_KERNELS, "serve_mla_quant_kv")
    ok_mt, _ = timed("train_mla", train_mla_phase)
    torch.cuda.empty_cache()
    x_results, ok_xk = timed("moe_kernels", moe_kernel_phase)
    results += x_results
    ok_xm = timed("moe_model_check", moe_model_check, get_config(MOE_ARCH))
    ok_xs, xs_launches = timed("serve_moe", serve_moe_phase)
    log("phase_s " + json.dumps(dict(PHASE_S, total=time.perf_counter() - t_start)))
    # each kernel's count from the run of the path it serves: the scan's
    # from the SSM serving run, the dense serving kernels' from the dense
    # serving run, the ring kernels' from the bf16 grid run and their int8
    # variants' from the int8 grid run (summed over the four ranks), the
    # absorbed decode's from the MLA serving run, the MoE's from the MoE
    # serving run, the training kernels' from the training run
    launches = {k: (ms_launches if k == "mla_decode" else ss_launches if k == "ssd"
                    else xs_launches if k in MOE_KERNELS
                    else s_launches if k in SERVE_KERNELS
                    else g_launches if k in RING_KERNELS
                    else q_launches if k in INT8_KERNELS else t_launches).get(k, 0)
                for k in KERNELS}

    line = []
    for name, (src, replaces) in KERNELS.items():
        rows = [r for r in results if r["kernel"] == name and r["main"]]
        if not rows:
            continue
        libs = [r["library_ms"] for r in rows]
        b_by = {}
        for r in rows:
            b_by[r["bound_by"]] = b_by.get(r["bound_by"], 0.0) + r["bound_ms"]
        line.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_err"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(b_by, key=b_by.get),
            "library_ms": None if None in libs else sum(libs),
        })
    failed = [n for n, ok in (("sass", ok_sass), ("kernels", ok_k), ("train_kernels", ok_tk),
                              ("model_check", ok_m), ("grad_check", ok_g), ("train", ok_t),
                              ("serve", ok_s), ("ssd_kernels", ok_sk),
                              ("ssm_model_check", ok_sm), ("serve_ssm", ok_ss),
                              ("ring_loopback", ok_rl), ("ring_kernels", ok_rk),
                              ("grid_train", ok_gt),
                              ("grid_train_int8", ok_gq), ("grid_bidir", ok_gb),
                              ("grid_megatron", ok_gm),
                              ("ckpt", ok_c), ("grid_ckpt", ok_gc), ("runtime", ok_rt),
                              ("grid_runtime", ok_grt), ("pipe_kernels", ok_pk),
                              ("grid_pipeline", ok_gp), ("grid_pipeline_hecaton", ok_gph),
                              ("grid_pod_data", ok_gpd), ("serve_dense", ok_sd),
                              ("serve_quant_kv", ok_sq), ("grid_serve", ok_gs),
                              ("mla_kernels", ok_mk), ("mla_model_check", ok_mm),
                              ("serve_mla", ok_ms), ("serve_mla_quant_kv", ok_mq),
                              ("train_mla", ok_mt), ("moe_kernels", ok_xk),
                              ("moe_model_check", ok_xm), ("serve_moe", ok_xs),
                              ("kernel_rows", len(line) == len(KERNELS)),
                              ("launches", all(launches.values())))
              if not ok]
    if failed:
        print("chip_smoke: failed phases: " + ", ".join(failed), file=sys.stderr)
        return 1
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
