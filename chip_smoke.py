#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result):

1. environment: torch, CUDA, the card, its power limit, nvcc;
2. build the CUDA kernels from kernels/csrc at first use; then (line
   ``threefry (a)``) core.random's threefry draws on the card against
   jax.random's own values (recorded with JAX and embedded here: key,
   fold_in, split, bits, uniform, rademacher, randint, permutation, top_k
   over bits, the per-chunk round's last chunk key and the head of its
   srht draw; normal within 1e-6), and the per-chunk round's draws at full
   width (126,075 chunk keys: bits, uniform, rademacher, SparseProj's
   randint, Rand-k's permutation, the srht rows' top_k, normal), each
   timed and held against the CPU bitwise on 2,049 rows spread over every
   tile (normal within 1e-6);
3. hold each kernel against its plain PyTorch version on the card: bitwise
   on the golden grid (d = 2 to 16384, and 32768 for K1; small integers,
   +-1 signs, ragged chunk counts, shared and per-chunk draws, bf16 input
   for the FWHT, the per-row-sign FWHT with its signs before, after and on
   both sides of the transform; K4 both alone and as the fused CG step, with
   a frozen chunk and one that converges), and on random float32 at the
   main path's shapes: K1 (also in bf16), K3 and both K4 entries (shared and
   per-chunk draws) bitwise, K2 within rtol 1e-5 / atol 1e-5;
4. the main path at full width: ``compressed_mean_tree`` of
   ``RandProjSpatial(k=64, d_block=1024, transform="avg")`` over a gradient
   tree with mamba2-130m's 11 parameter leaves (129,100,224 values) for 4
   clients correlated at rho = 0.9: three rounds with shared randomness, one
   with a draw per chunk, all seeded as the JAX package seeds them (threefry
   keys and JAX's call sequence of draws), each with its wall ms and peak
   memory. Launch counts are zeroed just before these rounds
   and read just after; K1, K2, K3 and the fused CG step (K4) must have
   launched, the step in every round, and K4 alone never. Each round is then
   re-run with the plain versions on the card (relative L2 gap <= 1e-3), and
   its error against the true mean must beat Rand-k's expected error (Eq. 1);
   then (line ``main path (b)``) the four clients' per-chunk draws alone,
   which the round makes once and shares between encode and decode: wall
   ms and peak memory beside the round's;
   then the paper's comparison on the same tree, each round re-run through
   the plain versions (gap <= 1e-3): with the per-chunk round's seed and a
   draw per chunk, (a) Rand-k within 1 % of Eq. 1, (b) Rand-k-Spatial below
   (a), (c) the subsample projection within relative L2 1e-6 of (b) (Lemma
   4.1), the per-chunk srht round below (b); with the first shared round's
   seed, (d) the srht gram and (e) direct decodes within 1e-3 of each other,
   (f) the gauss projection (logged). (a)-(c) and (f) launch no kernel, (d)
   and (e) K1 once a client and nothing else;
   then the codec layer on the same tree (``phase_codec``), each path's
   counts zeroed just before it and read just after: (a) round 1 with each
   quantizer (int8, correlated, bf16): payload bytes a client, error within
   0.1 % of the unquantized round's, gap to the plain path <= 1e-3, K1 x 4,
   K3 x 1 and 1-8 CG steps a round, and int8's rounding on the card bitwise
   against the CPU on the same uniforms; (b) ``SparseProj(k=64, s=16)``
   with shared draws: error below Rand-k's Eq. 1, gap to a rerun <= 1e-4
   (its scatter-adds add in an unspecified order), no kernel, the bank's
   build time and the CG steps; (c) top_k with error feedback, 4 rounds
   (the last with clients 0-2 reporting): the running average's error
   falls every round, each residual is x - self_decode within 1e-6 and the
   absent client's row is kept bitwise; (d) the entropy coder on the host
   over the first 2,048 chunks of each client's int8 payload and of a top_k
   payload's indices: exact coded size, bitwise round trip, coded over raw;
   (e) every new config on a small tree, card against CPU within 1e-4;
   then the mesh route of dist/ (``phase_dist``, lines ``dist (a)`` and
   ``dist (b)``), on the same tree and the first shared round's key: (a)
   one rank over NCCL in this process (``sharding.make_mesh``), each of
   ``compressed_mean_tree_shardmap`` sync, with ``ownership=True``, with
   ``overlap=True`` (tiles of 8,192 chunks) and with both, and
   ``compressed_mean_tree(shardings=dme_shardings(mesh))``, each bitwise
   the local route's mean, its counts zeroed just before it and read just
   after: K1 x 4 and K3 x 1 a decode (16 decodes overlapped), 1-64 CG steps
   a decode, its wall ms beside the local round's; ``psum_scatter_mean`` on
   (1, 126,075, 1024) within 1e-5 / 1e-6 of the plain weighted mean; one
   DME step of mamba2-130m at full width (4 x 4 x 1024) on the mesh, its
   update bitwise the mesh-less step's; (b) four ranks spawned on the one
   card, each on cuda:0 with one client of the same tree, over gloo (NCCL
   refuses two ranks on one card), a join deadline of 240 s: the shard_map
   route sync and owner-routed, rank 0's mean bitwise the local route's and
   every rank's equal to rank 0's (SHA-256 of the mean's bytes), the
   intra-pod columns (the owner route moves 1,646,048,256 bytes against
   387,302,400: 768 B of remote payload a chunk against 4,096 B of decoded
   mean), each rank's ``dist/host_staged_bytes`` and wall ms (four
   processes on one card, not a multi-card time);
   then the federated round driver (``phase_fl``, lines ``fl (a)``-``fl (f)``)
   on the dme task at the same width (4 clients x 129,100,224 values, rho
   0.9, ``codec.build("rand_proj_spatial", k=64, d_block=1024,
   transform="avg")``), each round's wall ms (CUDA events from its client
   vectors to its task step) beside the ms of the encode_all and decode
   calls inside it: (a) 3 sync rounds, counts zeroed just before them and
   read just after: 4 x 32,275,200 bytes a round, K1 x 4, K3 x 1 and 1-8 CG
   steps a round and no K4 alone, mse below Rand-k's Eq. 1, gap to the plain
   path <= 1e-3; (b) 4 async rounds with ``Cohort(4, dropout=0.25)`` and
   round seed 9 (stragglers in rounds 0-2): bytes = fresh survivors' +
   stale bytes, stragglers admitted, finite means, mse_pop beside
   staleness 0; (c) (a) again with the overlapped stream (tiles of 8,192
   chunks) and with 4 owners: History and the final state bitwise (a)'s,
   the ownership ledger; (d) temporal against spatial on drift at
   tests/test_fl.py's sizes (ratio < 0.7, equal ledgers); (e) the CLI's
   ``--compare`` on power_iteration, 20 rounds; (f) a small dme run on the
   card and the CPU (ledgers equal, floats within 1e-4, top_k's state
   bitwise); (g) the CLI on the dme task at the same width, 3 sync rounds,
   with ``--profile-dir`` and ``--metrics-json``, counts zeroed just before
   it and read just after: one trace file that names K1's, K3's and the CG
   step's kernels, ``kernels/dispatch`` on the kernel route alone for the
   SRHT ops and equal to the launches, ``kernels/decode_route`` fused once
   a round, ``kernels/cg_iters`` one sample a decode, its CG steps launched
   within each count rounded up to the host check's 8;
   then hierarchical rounds (``phase_hier``, lines ``hier (a)``-``hier
   (d)``, runtime/) on the same dme task through ``runtime.workers``'
   ``round_worker``, 3 sync rounds: (a) one pod bitwise the flat rounds;
   (b) two pods in this process: ``dcn_bytes`` each round the model's
   (``cross_pod_traffic``: 1,032,806,400), mse below Eq. 1, K1 x 4, K3 x 2
   and 2-16 CG steps a round; (c) two pods over two processes on the card
   (``runtime.spawn_local``, their records through process 0's TCPStore):
   each process's History bitwise (b)'s, K1 x 2, K3 x 1 and 1-8 CG steps a
   round each, the pickled record bytes and the exchange's seconds; (d)
   ``fl.run --task dme --pods 2 --hosts 2`` at 8,388,608 values exits 0;
   then the training path (``phase_train``, lines ``train (a)``-``train
   (c)``): (a) musicgen-medium at full width, 24 of its 48 layers
   (685,843,968 float32 parameters, bf16 compute, remat by block, the dense
   attention), 4 clients x batch 4 x 128 tokens through
   ``train.make_train_step`` with ``codec.build("rand_proj_spatial", k=64,
   d_block=1024, transform="avg")`` and ``AdamW(lr=3e-3, warmup_steps=20)``:
   K5's kernel route must refuse tensors that require grad, launching
   nothing; the first step must move every parameter leaf; a warm step and
   5 timed ones (CUDA events: wall, the clients' forward and backward,
   ``compressed_mean_tree``, the optimizer; loss, grad_norm,
   compression_ratio, peak memory), counts zeroed just before the timed
   steps and read after each: K1 x 4, K3 x 1 and 1-64 CG steps a step,
   nothing else; one profiled step; then one more step from the same state
   with the kernels and through the plain versions (streamed in tiles of
   65,536 chunks, bit-identical to the whole exchange, so that their
   temporaries fit): the updates within relative L2 1e-3; (b) the training
   CLI at its default arch, mamba2-130m (tiny preset, 4 clients, 60 steps,
   a failure injected at step 20, a resize to 3 clients at 40, checkpoints
   every 10): the loss falls, the failure is recovered from a checkpoint,
   the resize happens, and the same command with 70 steps resumes at step
   60; the final checkpoint's bytes and seconds; (c) 3 DME steps of tiny
   musicgen-medium, gemma3-4b, mamba2-130m, deepseek-moe-16b and jamba from
   the same state on the card and the CPU: losses and parameters within
   1e-4; (d) mamba2-130m at full width, nothing cut (24 SSD layers,
   129,100,224 float32 parameters, the estimator phases' tree, leaf for
   leaf), 4 clients x batch 4 x 1024 tokens (4 SSD chunks of 256), the same
   estimator, optimizer, timing, launch counts and profiled step as (a);
   every client gradient leaf finite in every step; one step's update with
   the kernels against the plain versions within 1e-6;
   then the GPipe schedule (``phase_pipeline``, lines ``pipeline (a)``,
   ``pipeline (b)``) on (d)'s cell: (a) one NCCL rank,
   ``pipeline_stages=1`` (the full schedule on one stage: its hops, the
   NCCL broadcasts and the stage-gradient all-reduce), 4 microbatches, a
   first and a warm step in bf16 and one in float32, each beside the step
   without a pipeline: losses within 2e-5, the float32 gradient entering
   AdamW within relative L2 1e-5, the float32 update that AdamW at eps 1e-6
   makes of both steps' gradients within 2e-5, the update gaps recorded
   beside a witness's (the step without a pipeline against itself with the
   rows reversed), K1 x 4, K3 x 1 and 1-64 CG steps a step;
   (b) two gloo ranks on the card (NCCL refuses two a card),
   ``pipeline_stages=2`` (12 blocks a stage), a first and a warm step: each
   rank's update bitwise (a)'s bf16 one or within 2e-5 of it, the ranks'
   equal, each rank's ``dist/host_staged_bytes``, wall ms (two processes on
   one card, not a multi-card time), peak memory and launches;
5. profile one more shared-randomness round (torch.profiler): device time
   by kernel against the round's wall time; every K1, K3 and CG step launch
   in it must be the register-resident butterfly kernel, by name;
6. a small tree through every ported config (rand_k, Rand-k-Spatial in both
   r_modes, Rand-Proj-Spatial's srht fused, gram and direct decodes and its
   subsample and gauss projections, each in both draw modes; top_k,
   identity, induced, wangni) on the card and on the CPU, which draw the same
   maps: bitwise where no reduction order differs (rand_k, Rand-k-Spatial
   fixed, subsample, top_k, identity, induced), else relative L2 <= 1e-4;
7. the flash-attention kernel (K5) against its plain version on the card,
   both routes (bf16: the wgmma kernel; float32: the split-TF32 one),
   on a grid (rep 1/2; window 0/8/64/1024; q_offset 0/384 with Sq < Sk;
   d_head 64/128/256; Sq 1/100/128/129/200 against 128-row q tiles, ragged
   Sk; float32 within 2e-5, or 3e-5 / 1e-4 with a window or an offset,
   bfloat16 within 2e-2), and at the serve shape (q (32, 2048, 256), k/v
   (16, 2048, 256), window 1024 and 0) in bf16 and, on the same inputs, in
   float32 at the grid's float32 tolerances;
8. the serving path at full width: gemma3-4b (3,879,907,840 parameters,
   random from a fixed seed, float32 on the card, bf16 compute) with
   ``attn_impl="flash"`` serves 4 prompts of 2048 tokens and decodes 32
   greedy tokens through ``launch.serve.serve``. Launch counts are zeroed
   just before and read just after: the bf16 route of K5 (the wgmma
   kernel) must have launched 34 times, once per attention layer of the
   prefill, and the float32 route never. The prefill is re-run through the
   plain versions on the card (last-position logits within relative L2 5e-2
   in bf16), and once more for each of four roundings of the bf16 kernel
   put into the plain attention (none, exp2, P split, P in bf16), whose
   gaps to the plain path tell the bf16 gap's causes apart. Then ``serve``
   runs once more in float32 (2 tokens), counts zeroed around it: the
   float32 route must have launched 34 times, and its logits must be within
   1e-4 of the plain path's; three warm prefills in float32 and three in
   bf16 are timed (host clock, median). One more bf16 prefill is
   profiled (device time by kernel, K5's share, idle share; every K5 launch
   in it must be the wgmma kernel);
9. tiny gemma (float32) through the kernel on the card and the plain
   versions on the CPU, with the same weights: logits within relative L2
   1e-4 and equal greedy tokens over 8 decode steps; then mamba2-130m at
   full width through ``serve`` in bf16 and in float32 (4 prompts of 2048
   tokens, 8 SSD chunks, 32 greedy tokens; no kernel launches on its path):
   prefill ms (first, median of 3 warm), decode ms a step, tokens/s, and
   the last decode step's logits against a full forward over the prompt and
   the generated tokens (relative L2 1e-3 in float32, 5e-2 in bf16); then
   deepseek-moe-16b at full width, its dense prologue and 8 of its 27 MoE
   blocks (5,206,349,824 float32 parameters), ``attn_impl="flash"``, bf16,
   the same prompts and tokens: K5's bf16 route x 9 a prefill (counts zeroed
   just before ``serve`` and read after), prefill and decode ms, the share
   of routed slots the capacity (960 an expert) drops, last-position logits
   within 5e-2 of the plain path on the card (the plain path's own float32
   reordering recorded beside it: routing is discrete, so such a change
   anywhere can move an expert in bf16); then one float32 prefill of the
   same weights and prompts through K5's float32 route x 9, logits within
   1e-3 of the plain float32 path's and first tokens equal;
   then parameters placed over the data (FSDP) and model (tensor-parallel)
   axes (``phase_placed``, lines ``placed (a)``, ``placed (b)``,
   ``placed rank N``): four gloo ranks on the card (NCCL refuses two a
   card; any rank's failure fails the run), (a) musicgen-medium at full
   width, 8 of 48 layers (232,809,984 parameters), 4 clients x 4 x 128,
   on the mesh (pod, data, model) = (1, 2, 2) through
   ``make_train_step(mesh=)``, the exchange streamed in tiles of 65,536
   chunks: a first and a warm bf16 step (wall ms, peak memory,
   ``dist/host_staged_bytes``, K1 x 4 / K3 x 1 / 1-64 CG steps a tile, each
   rank's counts zeroed just before its step and read just after), then a
   float32 step whose update, under AdamW at eps 1e-6, is within 2e-5 of
   the mesh-less step's (computed first in this process), each rank
   holding only its shards at rest (by its allocated memory); (b)
   gemma3-4b at full width served on (1, 1, 4), 2 prompts of 2048 and 8
   greedy tokens, in float32 (logits within relative L2 1e-4 of the
   one-rank kernel route, tokens equal) and bf16 (printed): K5 once an
   attention layer a prefill on every rank, and against its plain version
   at a rank's head shape (2 x 2 heads over 1 kv head of 256); and which
   of gloo's collectives take CUDA tensors (each on a group of its own);
10. time each kernel at its main path's shapes (CUDA events, median of 10),
   beside its plain version, its bound and a one-call PyTorch equivalent (a
   dense float32 matmul or einsum for K1-K4, scaled_dot_product_attention
   with K/V repeated for K5, each checked against the kernel); the fused CG
   step beside its bound and the unfused path it replaced (K4 alone plus
   the step's updates as PyTorch ops; no one PyTorch call computes a CG
   step); K5's two routes both at the serve shape, each with its bound
   share and achieved TFLOP/s; print them as one JSON line. The float32
   route's bound counts its operations at split TF32's 495 / 3 = 165
   TFLOP/s, the faster of the card's two float32-accurate rates
   (``bound_ms``), and also at the CUDA cores' 67 TFLOP/s
   (``bound_ms_cuda_cores``, the bound a CUDA-core kernel would face);
   and K5's bf16 route once more at deepseek-moe-16b's prefill shape (16
   heads of 128, 4 x 2048, window 0: ``flash_attention_bf16_d128``), its
   launches from that serving run.

The build phase prints ``-Xptxas -v``'s registers, shared memory and
spills for both K5 kernels (one entry a padded d_head each) and for the
butterfly kernels of K1, K3 and both K4 entries (one entry a width and
dtype) and fails if any of them spills.

The last line is {"ok": true, "device": {...}}. Needs one card; exits 1
without CUDA or outside a checkout of the repository.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
SPLIT_TF32_OPS_PER_S = 495e12 / 3  # TF32 tensor cores, dense, three products a float32 one
N_CLIENTS, K, D_BLOCK, RHO = 4, 64, 1024, 0.9
BASELINE_SEED = 4         # the main path's per-chunk round, and baselines (a)-(c)
SHARED_BASELINE_SEED = 1  # the main path's first shared round, and baselines (d)-(f)

# mamba2-130m (src/repro/configs/mamba2_130m.py): its parameter tree, as
# jax.eval_shape(init_params) gives it; 129,100,224 values, 126,075 chunks
MAMBA2_130M_LEAVES = {
    "blocks": {"l00": {"mamba": {
        "a_log": (24, 24),
        "conv_b": (24, 1792),
        "conv_w": (24, 1792, 4),
        "d_skip": (24, 24),
        "dt_bias": (24, 24),
        "in_proj": (24, 768, 3352),
        "norm": (24, 768),
        "out_norm": (24, 1536),
        "out_proj": (24, 1536, 768),
    }}},
    "embed": (50432, 768),
    "final_norm": (768,),
}
MAMBA2_130M_PARAMS = 129_100_224

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "fwht": ("src/repro_torch/kernels/csrc/fwht.cu", "src/repro/kernels/fwht.py:86"),
    "fwht_rowsigns": ("src/repro_torch/kernels/csrc/srht_fused.cu",
                      "src/repro/kernels/srht_fused.py:147"),
    "srht_decode_sum": ("src/repro_torch/kernels/csrc/srht_fused.cu",
                        "src/repro/kernels/srht_fused.py:191"),
    "srht_gram_apply": ("src/repro_torch/kernels/csrc/srht_fused.cu",
                        "src/repro/kernels/srht_fused.py:240"),
    # K4 with one CG iteration fused into its epilogue: what the decode runs
    "srht_cg_step": ("src/repro_torch/kernels/csrc/srht_fused.cu",
                     "src/repro/kernels/srht_fused.py:240"),
    # K5's two routes, by dtype
    "flash_attention_bf16": ("src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                             "src/repro/kernels/flash_attention.py:77"),
    # the bf16 route at deepseek-moe-16b's prefill shape (d_head 128, window 0)
    "flash_attention_bf16_d128": ("src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                                  "src/repro/kernels/flash_attention.py:77"),
    "flash_attention_f32": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:77"),
}
FLASH_ROUTES = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}
TC_KERNEL = "flash_attention_kernel_bf16_wgmma"  # K5's bf16 kernel in a profile
# K5's two kernels by source: function name, entries in ptxas's output (one a padded d_head)
FLASH_KERNELS = {"flash_attention_tc": ("flash_attention_kernel_bf16_wgmma", 3),
                 "flash_attention": ("flash_attention_kernel_f32_tf32", 3)}
# the register-resident butterfly kernels (K1, K3, K4's two entries), by
# function name, and their entries in ptxas's output (one a width and dtype)
BUTTERFLY_KERNELS = {"fwht": ("fwht", "fwht_butterfly_kernel", 30),
                     "srht_decode_sum": ("srht_fused", "decode_sum_butterfly_kernel", 14),
                     "srht_gram_apply": ("srht_fused", "gram_apply_butterfly_kernel", 14),
                     "srht_cg_step": ("srht_fused", "cg_step_butterfly_kernel", 14)}
GOLDEN_WIDTHS = (2, 8, 32, 64, 512, 1024, 2048, 4096, 16384)
K1_ONLY_WIDTH = 32768  # K1 takes d up to 32768, the others up to 16384
ESTIMATOR_KERNELS = ("fwht", "fwht_rowsigns", "srht_decode_sum", "srht_cg_step")

# the serving path: gemma3-4b at full width (src/repro/configs/gemma3_4b.py)
GEMMA3_4B_PARAMS = 3_879_907_840
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_SEED = 4, 2048, 32, 0
SERVE_WINDOWS = {1024: 29, 0: 5}  # window -> attention layers of gemma3-4b with it
# mamba2-130m serving at full width: 2048 tokens are 8 SSD chunks of 256;
# the last decode step's logits against a full forward, by compute dtype
MAMBA_SERVE_TOL = {"bfloat16": 5e-2, "float32": 1e-3}
# deepseek-moe-16b serving (src/repro/configs/deepseek_moe_16b.py): its dense
# prologue and 8 of its 27 MoE blocks; the whole model (16,375,728,128
# float32 parameters, 65.5 GB) leaves under 8 GB beside what earlier phases hold
MOE_SERVE_BLOCKS, MOE_SERVE_PARAMS = 8, 5_206_349_824
MOE_SERVE_CAPACITY = 960  # slots an expert, at 4 x 2048 tokens


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def time_ms(fn, reps: int = 10, warmup: int = 2, prep=None) -> float:
    """Median milliseconds of ``fn`` on the card, by CUDA events; ``prep``
    (untimed) runs before each call."""
    for _ in range(warmup):
        if prep:
            prep()
        fn()
    pairs = []
    for _ in range(reps):
        if prep:
            prep()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 1, 2

def phase_environment() -> str:
    smi = smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    log("nvcc: " + ver.stdout.strip().splitlines()[-1])
    log("nvidia-smi: " + smi)
    return smi


def _ptxas_entries(info: str, kernel: str) -> list:
    """(mangled name, registers, spill store bytes, spill load bytes) of each
    entry of ``kernel`` in ptxas's ``-v`` lines."""
    out, name, spill = [], None, None
    for line in info.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name and spill is not None:
            out.append((name, int(m.group(1)), *spill))
    return out


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc, {len(_build.SOURCES)} sources in parallel)")
    smem = {dhp: _build.build()["flash_attention_tc"].flash_attention_bf16_wgmma_smem(dhp)
            for dhp in (64, 128, 256)}
    for source, (kernel, n_entries) in FLASH_KERNELS.items():
        info = _build.ptxas_info(source)
        log(f"ptxas, K5's {kernel} (one entry per padded d_head):\n" + info.rstrip())
        entries = _ptxas_entries(info, kernel)
        if len(entries) != n_entries or any(st or ld for _, _, st, ld in entries):
            fail(f"{kernel}: {len(entries)} entries of {n_entries} in ptxas's output, or spills: "
                 f"{[(n[:80], st, ld) for n, _, st, ld in entries]}")
    log(f"K5 bf16: dynamic shared memory a block, by padded d_head: {smem} bytes")
    for source in sorted({source for source, _, _ in BUTTERFLY_KERNELS.values()}):
        log(f"ptxas, {source}.cu:\n" + _build.ptxas_info(source).rstrip())
    for name, (source, kernel, n_entries) in BUTTERFLY_KERNELS.items():
        info = _build.ptxas_info(source)
        entries = _ptxas_entries(info, kernel)
        log(f"{name} ({kernel}): registers by entry "
            f"{[regs for _, regs, _, _ in entries]}, spill bytes "
            f"{sum(st + ld for _, _, st, ld in entries)}")
        if len(entries) != n_entries or any(st or ld for _, _, st, ld in entries):
            fail(f"{kernel}: {len(entries)} entries of {n_entries} in ptxas's output, or spills: "
                 f"{[(n[:80], st, ld) for n, _, st, ld in entries if st or ld]}")


# -------------------------------------------------------------------- phase 3

def _ints(g, shape, hi=8, dtype=torch.float32):
    return torch.randint(-hi, hi, shape, generator=g, device=DEV).to(dtype)


def _signs(g, shape):
    return (torch.randint(0, 2, shape, generator=g, device=DEV) * 2 - 1).float()


def _rows(g, lead, k, d):
    score = torch.rand(lead + (d,), generator=g, device=DEV)
    return torch.topk(score, k, dim=-1).indices


def _mask(rows, d):
    from repro_torch.kernels import ref

    return ref.srht_scatter_ref(torch.ones(rows.shape, device=rows.device), rows, d)


def cg_state(y: torch.Tensor, c0, c1, *, frozen: bool) -> tuple:
    """A CG state as the solve's first step sees it: x = 0, r = p = y, rs =
    <y, y>, tol2 = 1e-8 rs. With ``frozen``, chunk 0 is already done and
    chunk 1 converges in this step. -> ([x, r, p, rs, done], c0, c1, tol2)"""
    from repro_torch.kernels import ref

    rs = ref.row_dot_ref(y, y)
    tol2 = 1e-8 * rs
    done = torch.zeros(rs.shape, dtype=torch.bool, device=y.device)
    if frozen and y.shape[0] > 2:
        done[0] = True
        tol2[1] = 3.0e38
    return [torch.zeros_like(y), y.clone(), y.clone(), rs, done], c0, c1, tol2


def cg_step(state, signs, rows, use_kernel: str) -> list:
    """One CG step on a copy of ``state``; -> the new [x, r, p, rs, done]."""
    from repro_torch.kernels import ops

    (x, r, p, rs, done), c0, c1, tol2 = state
    out = [t.clone() for t in (x, r, p, rs, done)]
    ops.srht_cg_step(*out, c0, c1, tol2, signs, rows, use_kernel=use_kernel)
    return out


def check_cg_step(errs, state, signs, rows, what: str) -> None:
    """The fused CG step against the plain step: every output bitwise."""
    got, want = cg_step(state, signs, rows, "force"), cg_step(state, signs, rows, "never")
    for name, g, w in zip(("x", "r", "p", "rs", "done"), got, want):
        errs.check("srht_cg_step", g, w, exact=True, what=f"{what} {name}")


class Errors:
    """Largest |kernel - plain| per kernel over every comparison."""

    def __init__(self):
        self.max = {name: 0.0 for name in KERNELS}

    def check(self, name, got, want, *, exact, rtol=1e-5, atol=1e-5, what=""):
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {what}: {tuple(got.shape)} {got.dtype} != plain "
                 f"{tuple(want.shape)} {want.dtype}")
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        if not np.isfinite(err):
            fail(f"{name} {what}: non-finite output")
        self.max[name] = max(self.max[name], err)
        if exact and not torch.equal(got, want):
            fail(f"{name} {what}: not bitwise equal to the plain version (max err {err})")
        if not exact and not torch.allclose(got, want, rtol=rtol, atol=atol):
            fail(f"{name} {what}: max err {err} beyond rtol {rtol} atol {atol}")


def phase_kernel_checks(errs: Errors) -> None:
    from repro_torch.kernels import ops, ref, srht_fused

    g = torch.Generator(device=DEV).manual_seed(1234)
    n, n_golden = 3, 0
    for d in GOLDEN_WIDTHS:
        k = max(1, d // 4)
        for c in (1, 5, 9):
            for shared in (True, False):
                cs = 1 if shared else c
                tag = f"golden d={d} C={c} {'shared' if shared else 'per-chunk'}"
                x = _ints(g, (n, c, d))
                signs = _signs(g, (n, cs, d))
                rows = _rows(g, (n, cs), k, d)
                # K1: shared-sign encode (gather fused), f32 and bf16, and the bare FWHT
                for dt in (torch.float32, torch.bfloat16):
                    xd = x[0].to(dt)
                    s0, r0 = signs[0, 0], rows[0, 0]
                    errs.check("fwht", ops.srht_encode(xd, s0, r0, use_kernel="force"),
                               ops.srht_encode(xd, s0, r0, use_kernel="never"),
                               exact=True, what=f"{tag} {dt}")
                    errs.check("fwht", ops.fwht(xd, scale=0.25, use_kernel="force"),
                               ops.fwht(xd, scale=0.25, use_kernel="never"),
                               exact=True, what=f"{tag} {dt} bare")
                    # from the second row: at d = 2 not 16-byte aligned
                    errs.check("fwht", ops.fwht(xd[1:], scale=0.25, use_kernel="force"),
                               ops.fwht(xd[1:], scale=0.25, use_kernel="never"),
                               exact=True, what=f"{tag} {dt} bare, from row 1")
                # K2: per-row-draw encode, and the full-width transform with
                # the signs before it, after it, or both
                s_full = signs.expand(n, c, d)
                r_full = rows.expand(n, c, k)
                errs.check("fwht_rowsigns",
                           ops.srht_encode_batch(x, s_full, r_full, use_kernel="force"),
                           ops.srht_encode_batch(x, s_full, r_full, use_kernel="never"),
                           exact=True, what=tag)
                x2, s2 = x.reshape(-1, d), s_full.reshape(-1, d).contiguous()
                for pre, post in ((True, False), (False, True), (True, True)):
                    errs.check("fwht_rowsigns",
                               srht_fused.fwht_rowsigns_cuda(x2, s2, sign_pre=pre, sign_post=post,
                                                             scale=0.25),
                               ref.fwht_rowsigns_ref(x2, s2, sign_pre=pre, sign_post=post,
                                                     scale=0.25),
                               exact=True, what=f"{tag} full width pre={pre} post={post}")
                # K3: client-summed adjoint from (n, C, k) payloads
                z = _ints(g, (n, c, k))
                errs.check("srht_decode_sum",
                           ops.srht_decode_sum(z, signs, rows, d, use_kernel="force"),
                           ops.srht_decode_sum(z, signs, rows, d, use_kernel="never"),
                           exact=True, what=tag)
                # K4: the Gram apply, and the fused CG step (c0, c1 one value
                # with shared draws, one a chunk with per-chunk draws)
                v = _ints(g, (c, d), hi=4)
                errs.check("srht_gram_apply",
                           ops.srht_gram_apply(v, signs, rows, use_kernel="force"),
                           ops.srht_gram_apply(v, signs, rows, use_kernel="never"),
                           exact=True, what=tag)
                if shared:
                    c0, c1 = torch.tensor(0.125, device=DEV), torch.tensor(0.875, device=DEV)
                else:
                    c1 = torch.rand((c,), generator=g, device=DEV) * 0.8 + 0.1
                    c0 = 1.0 - c1 + 0.01
                check_cg_step(errs, cg_state(v, c0, c1, frozen=True), signs, rows, tag)
                n_golden += 1
    for c in (1, 5, 9):  # K1 alone at its widest
        d = K1_ONLY_WIDTH
        x = _ints(g, (c, d))
        signs, rows = _signs(g, (d,)), _rows(g, (), d // 4, d)
        for dt in (torch.float32, torch.bfloat16):
            errs.check("fwht", ops.srht_encode(x.to(dt), signs, rows, use_kernel="force"),
                       ops.srht_encode(x.to(dt), signs, rows, use_kernel="never"),
                       exact=True, what=f"golden d={d} C={c} {dt}")
            errs.check("fwht", ops.fwht(x.to(dt), scale=0.25, use_kernel="force"),
                       ops.fwht(x.to(dt), scale=0.25, use_kernel="never"),
                       exact=True, what=f"golden d={d} C={c} {dt} bare")
    torch.cuda.synchronize()
    log(f"kernels vs plain, golden grid: {n_golden} cells x 5 kernels (d = "
        f"{', '.join(map(str, GOLDEN_WIDTHS))}) and K1 at d = {K1_ONLY_WIDTH} ok")


def full_width_inputs(seed: int = 7) -> dict:
    """Random float32 inputs at the shapes the main path gives each kernel."""
    from repro_torch.core import random as prand

    c = -(-MAMBA2_130M_PARAMS // D_BLOCK)
    g = torch.Generator(device=DEV).manual_seed(seed)
    key = prand.key(seed, DEV)
    shared = prand.srht_draw(prand.fold_in(key, torch.arange(N_CLIENTS, device=DEV))[:, None],
                             D_BLOCK, K)
    per_chunk = prand.srht_draw(prand.fold_in(key, torch.arange(c, device=DEV)), D_BLOCK, K)
    # K3's inputs in a per-chunk round: a draw per (client, chunk)
    client_keys = prand.fold_in(key, torch.arange(N_CLIENTS, device=DEV))[:, None]
    decode_pc = prand.srht_draw(prand.fold_in(client_keys, torch.arange(c, device=DEV)),
                                D_BLOCK, K)
    return {
        "C": c,
        "x": torch.randn((c, D_BLOCK), generator=g, device=DEV),
        "z": torch.randn((N_CLIENTS, c, K), generator=g, device=DEV),
        "signs": shared["signs"], "rows": shared["rows"],
        "pc_signs": per_chunk["signs"], "pc_rows": per_chunk["rows"],
        "decode_pc_signs": decode_pc["signs"], "decode_pc_rows": decode_pc["rows"],
    }


def kernel_calls(inp: dict) -> dict:
    """name -> (kernel call, plain call, ops, bytes) at full width."""
    from repro_torch.kernels import ops

    c, d, k, n = inp["C"], D_BLOCK, K, N_CLIENTS
    x, z = inp["x"], inp["z"]
    s1, r1 = inp["signs"][0, 0], inp["rows"][0, 0]
    fl = d * np.log2(d)
    return {
        "fwht": (lambda u: ops.srht_encode(x, s1, r1, use_kernel=u),
                 c * (fl + 2 * d), 4 * (c * d + d + c * k) + 8 * k),
        "fwht_rowsigns": (
            lambda u: ops.srht_encode_batch(x, inp["pc_signs"], inp["pc_rows"], use_kernel=u),
            c * (fl + 2 * d), 4 * (2 * c * d + c * k) + 8 * c * k),
        "srht_decode_sum": (
            lambda u: ops.srht_decode_sum(z, inp["signs"], inp["rows"], d, use_kernel=u),
            c * n * (fl + 3 * d), 4 * (n * c * k + n * d + c * d) + 8 * n * k),
        "srht_gram_apply": (
            lambda u: ops.srht_gram_apply(x, inp["signs"], inp["rows"], use_kernel=u),
            c * n * (2 * fl + 5 * d), 4 * (2 * c * d + n * d) + 8 * n * k),
    }


def cg_step_work(inp: dict) -> tuple:
    """(operations, bytes) of one fused CG step at full width, shared draws:
    per chunk and client the Gram apply's two transforms and 5 d products
    and sums, per chunk 13 d for the update (ap 3 d, the two dot products
    4 d, x, r and p 2 d each); x, r and p read once and written once, rs
    and done read and written, tol2 read (c0 and c1 one value each), the
    draws read once."""
    c, d, k, n = inp["C"], D_BLOCK, K, N_CLIENTS
    fl = d * np.log2(d)
    return (c * (n * (2 * fl + 5 * d) + 13 * d),
            4 * 6 * c * d + c * (4 + 4 + 1 + 1 + 4) + 8 + 4 * n * d + 8 * n * k)


def phase_full_width_checks(errs: Errors, calls: dict, inp: dict) -> None:
    """Every kernel at the main path's shapes on random float32: K1, K3 and
    both K4 entries bitwise (K1 also in bf16, K3 and K4 also with a draw per
    chunk), K2 within rtol 1e-5 / atol 1e-5."""
    from repro_torch.kernels import ops

    for name, (call, _, _) in calls.items():
        errs.check(name, call("force"), call("never"), exact=name in BUTTERFLY_KERNELS,
                   what="full-width random f32")
    xb = inp["x"].to(torch.bfloat16)
    s1, r1 = inp["signs"][0, 0], inp["rows"][0, 0]
    errs.check("fwht", ops.srht_encode(xb, s1, r1, use_kernel="force"),
               ops.srht_encode(xb, s1, r1, use_kernel="never"), exact=True,
               what="full-width random bf16")
    del xb
    z, s, r = inp["z"], inp["decode_pc_signs"], inp["decode_pc_rows"]
    errs.check("srht_decode_sum", ops.srht_decode_sum(z, s, r, D_BLOCK, use_kernel="force"),
               ops.srht_decode_sum(z, s, r, D_BLOCK, use_kernel="never"), exact=True,
               what="full-width random f32, a draw per chunk")
    x = inp["x"]
    errs.check("srht_gram_apply", ops.srht_gram_apply(x, s, r, use_kernel="force"),
               ops.srht_gram_apply(x, s, r, use_kernel="never"), exact=True,
               what="full-width random f32, a draw per chunk")
    c1 = torch.full((inp["C"],), RHO, device=DEV)
    for what, signs, rows, c0, c1 in (
            ("shared draws", inp["signs"], inp["rows"], 1.0 - c1[0], c1[0]),
            ("a draw per chunk", s, r, 1.0 - c1 + 0.01, c1)):
        check_cg_step(errs, cg_state(x, c0, c1, frozen=True), signs, rows,
                      f"full-width random f32, {what}")
    torch.cuda.synchronize()
    log("kernels vs plain, random f32 at full width: ok (K1 in f32 and bf16, K3 and both K4 "
        "entries bitwise)")


# ------------------------------------------------------- phase_threefry (a)

# jax.random's own values (jax 0.9.0, jax_threefry_partitionable=True),
# recorded on a machine with JAX, since the card's machine has none
THREEFRY_JAX = {
    "key_42": [0, 42],
    "fold_in_42_7": [2547012911, 1371500959],
    "split_42": [[1832780943, 270669613], [64467757, 2916123636]],
    "bits_42_5": [2098992034, 2919706841, 2646866425, 2409546199, 1935504149],
    "uniform_42_5": [0.48870956897735596, 0.6797971725463867, 0.6162714958190918,
                     0.5610160827636719, 0.4506446123123169],
    "rademacher_42_8": [1, -1, -1, -1, 1, -1, 1, -1],
    "randint_42_5": [15684, 8394, 14511, 26929, 41189],
    "permutation_42_16": [7, 4, 2, 5, 3, 6, 10, 11, 15, 8, 9, 13, 14, 0, 1, 12],
    "top_k_42_1024_8": [155, 603, 1006, 477, 88, 1021, 649, 134],
    "normal_42_5": [-0.02830461598932743, 0.4671318531036377, 0.2957029640674591,
                    0.15354591608047485, -0.12403281778097153],
    # the per-chunk round's (seed 4) key of client 3, chunk 126,074, and the
    # heads of its srht draw's signs and rows
    "chunk_4_3_126074": [1893995629, 1058926201],
    "chunk_signs_head": [-1, 1, -1, -1, -1, 1, -1, 1, 1, -1, -1, -1, -1, 1, 1, 1],
    "chunk_rows_head": [345, 138, 694, 267, 473, 673, 35, 84],
}
NORMAL_ATOL = 1e-6      # tests/test_torch_threefry.py: normal is within 3 float32 ulp of JAX's
THREEFRY_SAMPLE_ROWS = 2048  # rows of each full-width draw recomputed on the CPU


def _threefry_literals() -> None:
    """The card's draws against jax.random's recorded values."""
    from repro_torch.core import random as prand

    k = prand.key(42, DEV)
    got = {
        "key_42": k, "fold_in_42_7": prand.fold_in(k, 7), "split_42": prand.split(k),
        "bits_42_5": prand.bits(k, (5,)), "uniform_42_5": prand.uniform(k, (5,)),
        "rademacher_42_8": prand.rademacher(k, (8,)),
        "randint_42_5": prand.randint(k, (5,), 0, 50280),
        "permutation_42_16": prand.permutation(k, 16),
        "top_k_42_1024_8": prand.top_k_bits(k, 1024, 8),
    }
    ck = prand.fold_in(prand.fold_in(prand.key(BASELINE_SEED, DEV), 3), 126074)
    draw = prand.srht_draw(ck, D_BLOCK, K)
    got.update(chunk_4_3_126074=ck, chunk_signs_head=draw["signs"][:16],
               chunk_rows_head=draw["rows"][:8])
    for name, value in got.items():
        want = THREEFRY_JAX[name]
        if value.cpu().tolist() != want:
            fail(f"(a) threefry {name} on the card {value.cpu().tolist()}, jax.random {want}")
    normal = prand.normal(k, (5,)).cpu()
    gap = float((normal - torch.tensor(THREEFRY_JAX["normal_42_5"])).abs().max())
    if gap > NORMAL_ATOL:
        fail(f"(a) threefry normal {normal.tolist()} is {gap} from jax.random's")


def phase_threefry(smi: str) -> dict:
    """(a) core.random's threefry on the card: jax.random's recorded values,
    and the per-chunk round's draws at full width (client 0's 126,075 chunk
    keys of seed 4): bits, uniform, rademacher, randint (SparseProj's
    columns), permutation (Rand-k's rows), top_k_bits (the srht rows) and
    normal, each timed on the card and held against the CPU on
    THREEFRY_SAMPLE_ROWS rows spread over every tile: bitwise, normal
    within NORMAL_ATOL."""
    from repro_torch.core import random as prand

    _threefry_literals()
    c = -(-MAMBA2_130M_PARAMS // D_BLOCK)
    keys = prand.fold_in(prand.fold_in(prand.key(BASELINE_SEED, DEV), 0),
                         torch.arange(c, device=DEV))
    rows = torch.unique(torch.cat([torch.linspace(0, c - 1, THREEFRY_SAMPLE_ROWS).long(),
                                   torch.tensor([c - 1])]))
    draws = {
        "bits": lambda kk: prand.bits(kk, (D_BLOCK,)),
        "uniform": lambda kk: prand.uniform(kk, (D_BLOCK,)),
        "rademacher": lambda kk: prand.rademacher(kk, (D_BLOCK,)),
        "randint": lambda kk: prand.randint(kk, (K, 16), 0, D_BLOCK),
        "permutation": lambda kk: prand.permutation(kk, D_BLOCK),
        "top_k_bits": lambda kk: prand.top_k_bits(kk, D_BLOCK, K),
        "normal": lambda kk: prand.normal(kk, (D_BLOCK,)),
    }
    out = {}
    for name, fn in draws.items():
        fn(keys[:2])  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        card = fn(keys)
        b.record()
        torch.cuda.synchronize()
        cpu = fn(keys[rows.to(DEV)].cpu())
        got = card[rows.to(DEV)].cpu()
        gap = float((got.double() - cpu.double()).abs().max())
        out[name] = {"ms": a.elapsed_time(b), "shape": list(card.shape),
                     "peak_gb_over_base": (torch.cuda.max_memory_allocated() - base) / 1e9,
                     "max_abs_gap_vs_cpu": gap}
        if name == "normal" and not (gap <= NORMAL_ATOL and torch.isfinite(card).all()):
            fail(f"(a) normal on the card is {gap} from the CPU's (limit {NORMAL_ATOL})")
        if name != "normal" and not torch.equal(got, cpu):
            fail(f"(a) {name} on the card differs from the CPU's at {int((got != cpu).sum())} "
                 "sampled entries")
        del card
    log(f"threefry (a) [{smi}] {c} chunk keys, {rows.numel()} rows on the CPU: "
        + json.dumps(out))
    return out


# -------------------------------------------------------------------- phase 4

def gradient_tree(seed: int = 0) -> dict:
    """Per-client gradients for mamba2-130m's leaves: a shared component plus
    independent noise, correlated at RHO between clients."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    noise = float(np.sqrt(1.0 / RHO - 1.0))

    def leaf(shape):
        common = torch.randn(shape, generator=g, device=DEV)
        return common[None] + noise * torch.randn((N_CLIENTS,) + shape, generator=g,
                                                  device=DEV)

    def build(node):
        return {k: build(v) for k, v in node.items()} if isinstance(node, dict) else leaf(node)

    return build(MAMBA2_130M_LEAVES)


def _flat(tree) -> torch.Tensor:
    from repro_torch.core import chunking

    return torch.cat([leaf.reshape(-1) for leaf in chunking.tree_leaves(tree)])


def _spec(shared: bool, use_kernel: str):
    from repro_torch.core import codec

    return codec.RandProjSpatial(k=K, d_block=D_BLOCK, transform="avg",
                                 shared_randomness=shared, use_kernel=use_kernel)


def phase_main_path(tree: dict) -> tuple:
    """-> (the kernels' launches in these rounds, {"true_mean", "randk_err",
    "per_chunk_err": the per-chunk round's error})."""
    from repro_torch.dist import collectives
    from repro_torch.kernels import ops

    n_params = sum(leaf[0].numel() for leaf in _leaves(tree))
    if n_params != MAMBA2_130M_PARAMS or len(_leaves(tree)) != 11:
        fail(f"gradient tree has {n_params} values in {len(_leaves(tree))} leaves")
    flat_clients = torch.stack([_flat(_take(tree, i)) for i in range(N_CLIENTS)])
    true_mean = flat_clients.mean(0)
    randk_err = float(np.sqrt((D_BLOCK / K - 1.0) * float((flat_clients.double() ** 2).sum()))
                      / N_CLIENTS / float(true_mean.double().norm()))
    del flat_clients
    rounds = [(seed, True) for seed in (1, 2, 3)] + [(BASELINE_SEED, False)]

    outs, rows = [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the main path's window opens here
    for seed, shared in rounds:
        before = ops.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        mean_tree, info, _ = collectives.compressed_mean_tree(_spec(shared, "auto"), seed, tree,
                                                              device=DEV)
        b.record()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        outs.append(_flat(mean_tree))
        rows.append({
            "round": len(rows) + 1, "shared_randomness": shared,
            "wall_ms": a.elapsed_time(b),
            "peak_gb_over_tree": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "cg_iterations_launched": after.get("srht_cg_step", 0)
            - before.get("srht_cg_step", 0),
            "rel_err_vs_true_mean": rel_l2(outs[-1], true_mean),
            "bytes_sent_over_full": info["bytes_sent"] / info["full_bytes"],
        })
    launches = ops.launch_counts()  # ... and closes here
    missing = [name for name in ESTIMATOR_KERNELS if launches.get(name, 0) == 0]
    if missing:
        fail(f"the main path launched no {missing}")
    if launches.get("srht_gram_apply", 0):
        fail("the main path launched K4 alone; its CG runs the fused step")
    steps = [r["cg_iterations_launched"] for r in rows]
    if min(steps) == 0:
        fail(f"CG steps launched by round: {steps}; every round runs its solve on the step")

    for r, (seed, shared), out in zip(rows, rounds, outs):
        plain_tree, _, _ = collectives.compressed_mean_tree(_spec(shared, "never"), seed, tree,
                                                            device=DEV)
        r["rel_gap_vs_plain_on_card"] = rel_l2(out, _flat(plain_tree))
        if not torch.isfinite(out).all():
            fail(f"round {r['round']}: non-finite mean")
        if r["rel_gap_vs_plain_on_card"] > 1e-3:
            fail(f"round {r['round']}: kernel and plain paths differ by "
                 f"{r['rel_gap_vs_plain_on_card']}")
        if r["rel_err_vs_true_mean"] >= randk_err:
            fail(f"round {r['round']}: error {r['rel_err_vs_true_mean']} is not below "
                 f"Rand-k's expected {randk_err}")
        log("round " + json.dumps(r))
    log(f"main path: 4 rounds of 4 x {MAMBA2_130M_PARAMS} values ok; launches {dict(launches)}; "
        f"Rand-k expected rel err {randk_err:.4f}")
    _draw_cost(rows[-1])
    return dict(launches), {"true_mean": true_mean, "randk_err": randk_err,
                            "round1_err": rows[0]["rel_err_vs_true_mean"],
                            "per_chunk_err": rows[-1]["rel_err_vs_true_mean"]}


def _draw_cost(threefry_row: dict) -> dict:
    """(b) what JAX's draws cost the per-chunk round: its wall ms and peak
    memory beside the four clients' draws alone (``_fused_draws``, made
    once a round and shared by the encode and the decode; CUDA events)."""
    from repro_torch.core.estimators import rand_proj_spatial

    c = -(-MAMBA2_130M_PARAMS // D_BLOCK)
    out = {"round_wall_ms": threefry_row["wall_ms"],
           "round_peak_gb_over_tree": threefry_row["peak_gb_over_tree"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a = _event()
    draws = rand_proj_spatial._fused_draws(_spec(False, "auto"), BASELINE_SEED, N_CLIENTS, c,
                                           device=DEV)
    b = _event()
    torch.cuda.synchronize()
    out.update(draws_ms=a.elapsed_time(b),
               draws_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
               draws_gb=sum(v.numel() * v.element_size() for v in draws.values()) / 1e9)
    del draws
    log("main path (b) the per-chunk round and its threefry draws " + json.dumps(out))
    return out


def _baseline_specs(use_kernel: str) -> dict:
    """The paper's comparison: (a)-(c) with a draw per chunk, (d)-(f) with
    one draw per client; every Rand-Proj-Spatial round on ``use_kernel``."""
    from repro_torch.core import codec

    per_chunk = dict(k=K, d_block=D_BLOCK, shared_randomness=False)
    rps = dict(k=K, d_block=D_BLOCK, transform="avg", use_kernel=use_kernel)
    return {
        "a_rand_k": codec.RandK(**per_chunk),
        "b_rand_k_spatial": codec.RandKSpatial(transform="avg", **per_chunk),
        "c_subsample": codec.RandProjSpatial(projection="subsample", **dict(rps, **per_chunk)),
        "d_srht_gram": codec.RandProjSpatial(decode_method="gram", **rps),
        "e_srht_direct": codec.RandProjSpatial(decode_method="direct", **rps),
        "f_gauss_gram": codec.RandProjSpatial(projection="gauss", **rps),
    }


def phase_baselines(tree: dict, main: dict) -> dict:
    """The paper's comparison at full width on the main path's tree: Rand-k,
    Rand-k-Spatial and Rand-Proj-Spatial's subsample projection with the
    per-chunk round's seed (the same key gives all three the same indices),
    then the srht gram and direct decodes and the gauss projection with the
    first shared round's seed. Each round: wall ms (CUDA events), error
    against the true mean, gap to the same round through the plain versions
    on the card, the kernels it launched. -> the rounds, by name."""
    from repro_torch.core import beta as beta_lib
    from repro_torch.dist import collectives
    from repro_torch.kernels import ops

    true_mean = main["true_mean"]
    t0 = time.perf_counter()  # set-up outside the timed rounds
    beta_lib.srht_eig_bank(N_CLIENTS, K, D_BLOCK, device=DEV, projection="gauss")
    torch.cuda.synchronize()
    log(f"baselines: gauss eigenvalue bank ready in {time.perf_counter() - t0:.3f} s")
    specs, plain_specs = _baseline_specs("auto"), _baseline_specs("never")
    rows, outs = {}, {}
    for name, spec in specs.items():
        seed = SHARED_BASELINE_SEED if spec.shared_randomness else BASELINE_SEED
        torch.cuda.synchronize()
        before = ops.launch_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        mean_tree, _, _ = collectives.compressed_mean_tree(spec, seed, tree, device=DEV)
        b.record()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        out = _flat(mean_tree)
        del mean_tree
        if not torch.isfinite(out).all():
            fail(f"baseline {name}: non-finite mean")
        # the plain rerun is a warm second call of the round (of the same code
        # where the round launches no kernel): its wall ms shows first-call costs
        a2, b2 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a2.record()
        plain_tree, _, _ = collectives.compressed_mean_tree(plain_specs[name], seed, tree,
                                                            device=DEV)
        b2.record()
        torch.cuda.synchronize()
        rows[name] = {
            "round": name, "config": repr(spec), "seed": seed, "wall_ms": a.elapsed_time(b),
            "plain_wall_ms": a2.elapsed_time(b2),
            "rel_err_vs_true_mean": rel_l2(out, true_mean),
            "rel_gap_vs_plain_on_card": rel_l2(out, _flat(plain_tree)),
            "launches": {k: after.get(k, 0) - before.get(k, 0) for k in sorted(after)
                         if after.get(k, 0) != before.get(k, 0)},
        }
        del plain_tree
        log("baseline round " + json.dumps(rows[name]))
        if rows[name]["rel_gap_vs_plain_on_card"] > 1e-3:
            fail(f"baseline {name}: kernel and plain paths differ by "
                 f"{rows[name]['rel_gap_vs_plain_on_card']}")
        if name in ("b_rand_k_spatial", "c_subsample", "d_srht_gram", "e_srht_direct"):
            outs[name] = out

    err = {name: r["rel_err_vs_true_mean"] for name, r in rows.items()}
    summary = {
        "randk_expected": main["randk_err"], "per_chunk_srht_fused": main["per_chunk_err"],
        "a_over_expected": err["a_rand_k"] / main["randk_err"],
        # Lemma 4.1 at full width: a reciprocal-then-multiply against a divide
        "c_vs_b_rel_l2": rel_l2(outs["c_subsample"], outs["b_rand_k_spatial"]),
        "d_vs_e_rel_l2": rel_l2(outs["d_srht_gram"], outs["e_srht_direct"]),
    }
    log("baselines " + json.dumps(summary))
    if not abs(summary["a_over_expected"] - 1.0) <= 0.01:
        fail(f"Rand-k's error {err['a_rand_k']} is not within 1 % of Eq. 1's "
             f"{main['randk_err']}")
    if not err["b_rand_k_spatial"] < err["a_rand_k"]:
        fail(f"Rand-k-Spatial's error {err['b_rand_k_spatial']} is not below Rand-k's "
             f"{err['a_rand_k']}")
    if not summary["c_vs_b_rel_l2"] <= 1e-6:
        fail(f"the subsample projection differs from Rand-k-Spatial by "
             f"{summary['c_vs_b_rel_l2']} (Lemma 4.1)")
    if not main["per_chunk_err"] < err["b_rand_k_spatial"]:
        fail(f"the per-chunk srht round's error {main['per_chunk_err']} is not below "
             f"Rand-k-Spatial's {err['b_rand_k_spatial']}")
    if not summary["d_vs_e_rel_l2"] <= 1e-3:
        fail(f"the gram and direct decodes differ by {summary['d_vs_e_rel_l2']}")
    for name, r in rows.items():
        want = {"fwht": N_CLIENTS} if name in ("d_srht_gram", "e_srht_direct") else {}
        if r["launches"] != want:
            fail(f"baseline {name} launched {r['launches']}, expected {want}: the encode's "
                 "K1 once a client on the srht rounds, no kernel on the others")
    return rows


CODEC_KEYS = {"a_quantized": 1, "b_sparse_proj": SHARED_BASELINE_SEED, "c_ef": 3}  # seeds
QUANT_BYTES = {"int8": 8_573_100, "correlated": 8_573_100, "bf16": 16_137_600}  # a client
UNQUANTIZED_BYTES = 32_275_200
SPARSE_S, EF_ROUNDS, ENTROPY_CHUNKS = 16.0, 4, 2048


def _timed_round(fn) -> tuple:
    """(result, wall ms by CUDA events) of one synchronised call."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _codec_quantized(tree: dict, main: dict) -> dict:
    """(a) the main path's round 1 with each quantizer: bytes, error against
    the unquantized round's, gap to the plain path, launches (counts zeroed
    before these rounds, read after); then Int8's rounding on the card
    against the CPU on the same uniforms."""
    from repro_torch.core import codec
    from repro_torch.core import random as prand
    from repro_torch.core.codec import quantizers
    from repro_torch.dist import collectives
    from repro_torch.kernels import ops

    seed, true_mean = CODEC_KEYS["a_quantized"], main["true_mean"]
    quants = {"int8": codec.Int8Quant(), "correlated": codec.CorrelatedQuant(),
              "bf16": codec.Bf16Quant()}
    rows, outs = {}, {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the quantized path's window opens here
    for name, q in quants.items():
        before = ops.launch_counts()
        (mean_tree, info, _), ms = _timed_round(lambda: collectives.compressed_mean_tree(
            codec.Pipeline([_spec(True, "auto"), q]), seed, tree, device=DEV))
        after = ops.launch_counts()
        outs[name] = _flat(mean_tree)
        del mean_tree
        rows[name] = {"round": name, "wall_ms": ms, "payload_bytes_per_client":
                      info["payload_bytes_per_client"],
                      "launches": {k: after.get(k, 0) - before.get(k, 0) for k in sorted(after)
                                   if after.get(k, 0) != before.get(k, 0)}}
    window = ops.launch_counts()  # ... and closes here
    for name, q in quants.items():
        out, r = outs.pop(name), rows[name]
        # a warm second call of the same round: the first call's own costs
        _, r["warm_wall_ms"] = _timed_round(lambda: collectives.compressed_mean_tree(
            codec.Pipeline([_spec(True, "auto"), q]), seed, tree, device=DEV))
        plain, _, _ = collectives.compressed_mean_tree(
            codec.Pipeline([_spec(True, "never"), q]), seed, tree, device=DEV)
        r["rel_err_vs_true_mean"] = rel_l2(out, true_mean)
        r["err_over_unquantized"] = r["rel_err_vs_true_mean"] / main["round1_err"]
        r["rel_gap_vs_plain_on_card"] = rel_l2(out, _flat(plain))
        del plain, out
        log("codec (a) quantized round " + json.dumps(r))
        if r["payload_bytes_per_client"] != QUANT_BYTES[name]:
            fail(f"(a) {name}: {r['payload_bytes_per_client']} payload bytes a client, "
                 f"not {QUANT_BYTES[name]}")
        if not abs(r["err_over_unquantized"] - 1.0) <= 1e-3:
            fail(f"(a) {name}: error {r['rel_err_vs_true_mean']} is not within 0.1 % of the "
                 f"unquantized round's {main['round1_err']}")
        if not r["rel_gap_vs_plain_on_card"] <= 1e-3:
            fail(f"(a) {name}: kernel and plain paths differ by {r['rel_gap_vs_plain_on_card']}")
        steps = r["launches"].pop("srht_cg_step", 0)
        if r["launches"] != {"fwht": N_CLIENTS, "srht_decode_sum": 1} or not 1 <= steps <= 8:
            fail(f"(a) {name} launched {r['launches']} and {steps} CG steps, not K1 x "
                 f"{N_CLIENTS}, K3 x 1 and 1-8 steps")
        r["launches"]["srht_cg_step"] = steps
    # Int8's rounding: card and CPU on the same values and uniforms, bitwise
    chunks = collectives._chunk_clients(tree, D_BLOCK)[0]
    vals = _spec(True, "auto").encode(seed, 0, chunks[0])["vals"]
    del chunks
    qkey = prand.fold_in(prand.key(seed, DEV), 0)
    u = prand.uniform(prand.fold_in(qkey, quantizers._salt("vals")), tuple(vals.shape))
    u_cpu = prand.uniform(prand.fold_in(qkey.cpu(), quantizers._salt("vals")),
                          tuple(vals.shape))
    q_card, s_card = quantizers.stochastic_round(vals, u)
    q_cpu, s_cpu = quantizers.stochastic_round(vals.cpu(), u_cpu)
    same = {"uniforms": torch.equal(u.cpu(), u_cpu), "int8": torch.equal(q_card.cpu(), q_cpu),
            "scales": torch.equal(s_card.cpu(), s_cpu)}
    log(f"codec (a): int8 rounding of client 0's {tuple(vals.shape)} values, card vs CPU on "
        f"the same uniforms, bitwise: {same}; unquantized payload {UNQUANTIZED_BYTES} bytes a "
        f"client; launches in the window {dict(window)}")
    if not all(same.values()):
        fail(f"(a) int8 rounding on the card differs from the CPU's: bitwise {same}")
    return rows


def _codec_sparse_proj(tree: dict, main: dict) -> dict:
    """(b) SparseProj(k=64, s=16) with shared draws through the collective:
    the bank's build, wall ms, CG steps (Gram applies), error, and the gap to
    a rerun on the card (scatter-adds in an unspecified order)."""
    from repro_torch.core import beta as beta_lib
    from repro_torch.core import codec
    from repro_torch.dist import collectives
    from repro_torch.kernels import ops

    spec = codec.SparseProj(k=K, d_block=D_BLOCK, s=SPARSE_S)
    t0 = time.perf_counter()
    beta_lib.sparse_eig_bank(N_CLIENTS, K, D_BLOCK, spec.nnz, device=DEV)
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    applies = [0]
    gram_apply = ops.sparse_proj_gram_apply

    def counted(*args):
        applies[0] += 1
        return gram_apply(*args)

    ops.sparse_proj_gram_apply = counted
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()  # the sparse path's window opens here
        (mean_tree, info, _), ms = _timed_round(lambda: collectives.compressed_mean_tree(
            spec, CODEC_KEYS["b_sparse_proj"], tree, device=DEV))
        launches = ops.launch_counts()  # ... and closes here
        steps = applies[0]
        out = _flat(mean_tree)
        del mean_tree
        (again, _, _), ms2 = _timed_round(lambda: collectives.compressed_mean_tree(
            spec, CODEC_KEYS["b_sparse_proj"], tree, device=DEV))
    finally:
        ops.sparse_proj_gram_apply = gram_apply
    row = {"round": "sparse_proj", "nnz": spec.nnz, "bank_build_s": bank_s, "wall_ms": ms,
           "rerun_wall_ms": ms2, "cg_steps": steps,
           "payload_bytes_per_client": info["payload_bytes_per_client"],
           "rel_err_vs_true_mean": rel_l2(out, main["true_mean"]),
           "rel_gap_vs_rerun_on_card": rel_l2(out, _flat(again)), "launches": dict(launches)}
    log("codec (b) " + json.dumps(row))
    if not torch.isfinite(out).all() or not row["rel_err_vs_true_mean"] < main["randk_err"]:
        fail(f"(b) SparseProj's error {row['rel_err_vs_true_mean']} is not below Rand-k's "
             f"expected {main['randk_err']}")
    if not row["rel_gap_vs_rerun_on_card"] <= 1e-4:
        fail(f"(b) SparseProj differs from its rerun by {row['rel_gap_vs_rerun_on_card']}")
    if launches or steps < 1:
        fail(f"(b) SparseProj launched {dict(launches)} and ran {steps} Gram applies; it runs "
             "no kernel and its solve at least one step")
    return row


def _codec_error_feedback(tree: dict, main: dict) -> tuple:
    """(c) top_k with error feedback over rounds on the fixed tree, keys
    folded by round; the last round with clients 0-2 reporting. -> (rows,
    round 1's top_k payload for (d))."""
    from repro_torch.core import codec
    from repro_torch.core import random as prand
    from repro_torch.dist import collectives
    from repro_torch.kernels import ops

    pipe = codec.Pipeline([codec.TopK(k=K, d_block=D_BLOCK), codec.ErrorFeedback()])
    chunks = collectives._chunk_clients(tree, D_BLOCK)[0]
    true_mean, x_norm = main["true_mean"], float(chunks.double().norm())
    ef, total, rows = None, torch.zeros_like(true_mean), []
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the error-feedback path's window opens here
    for t in range(EF_ROUNDS):
        key = prand.fold_in(prand.key(CODEC_KEYS["c_ef"], DEV), t)
        participants = [0, 1, 2] if t == EF_ROUNDS - 1 else None
        ef_in = ef
        (mean_tree, _, ef), ms = _timed_round(lambda: collectives.compressed_mean_tree(
            pipe, key, tree, ef_chunks=ef_in, participants=participants, device=DEV))
        out = _flat(mean_tree)
        del mean_tree
        total += out
        # the residual, recomputed: x with its top-k coordinates zeroed
        gap = 0.0
        for i in range(N_CLIENTS if participants is None else len(participants)):
            x = chunks[i] if ef_in is None else chunks[i] + ef_in[i]
            idx = torch.sort(x.abs(), dim=-1, descending=True, stable=True).indices[:, :K]
            want = x.scatter(-1, idx, 0.0)
            gap = max(gap, rel_l2(ef[i], want))
            del x, idx, want
        rows.append({"round": t + 1, "participants": participants, "wall_ms": ms,
                     "rel_err_vs_true_mean": rel_l2(out, true_mean),
                     "running_avg_rel_err": rel_l2(total / (t + 1), true_mean),
                     "residual_norm_over_inputs": float(ef.double().norm()) / x_norm,
                     "residual_rel_gap_vs_x_minus_self_decode": gap,
                     "residual_bytes": ef.numel() * ef.element_size()})
        if participants is not None:
            rows[-1]["absent_row_bitwise"] = bool(torch.equal(ef[3], ef_in[3]))
        del ef_in, out
        log("codec (c) error feedback " + json.dumps(rows[-1]))
    launches = ops.launch_counts()  # ... and closes here
    payload, _ = codec.Pipeline([codec.TopK(k=K, d_block=D_BLOCK)]).encode_all(0, chunks[:1])
    del chunks, ef
    errs = [r["running_avg_rel_err"] for r in rows]
    if not all(b < a for a, b in zip(errs, errs[1:])):
        fail(f"(c) the running average's error does not fall every round: {errs}")
    if max(r["residual_rel_gap_vs_x_minus_self_decode"] for r in rows) > 1e-6:
        fail("(c) a residual is not x - self_decode within 1e-6")
    if not rows[-1]["absent_row_bitwise"]:
        fail("(c) the absent client's residual row changed")
    if launches:
        fail(f"(c) top_k with error feedback launched {dict(launches)}; it runs no kernel")
    return rows, payload


def _codec_entropy(tree: dict, top_k_payload) -> dict:
    """(d) the entropy coder on the host: the first ENTROPY_CHUNKS chunks of
    each client's int8 payload (the quantized round's) and of client 0's
    top_k indices: exact coded size, round trip, coded over raw."""
    from repro_torch.core import codec
    from repro_torch.dist import collectives

    pipe = codec.Pipeline([_spec(True, "auto"), codec.Int8Quant()])
    chunks = collectives._chunk_clients(tree, D_BLOCK)[0]
    payloads, _ = pipe.encode_all(CODEC_KEYS["a_quantized"], chunks)
    del chunks
    code, c = codec.EntropyCode(), ENTROPY_CHUNKS
    t0 = time.perf_counter()
    parts = [{name: v[i, :c].cpu() for name, v in payloads.arrays.items()}
             for i in range(N_CLIENTS)]
    parts.append({"idx": top_k_payload.arrays["idx"][0, :c].cpu()})
    coded, raw = {"vals": 0, "idx": 0}, {"vals": 0, "idx": 0}
    for arrays in parts:
        schema = tuple(codec.ArraySpec(n, tuple(v.shape), str(v.dtype).removeprefix("torch."),
                                       codec.VALUES) for n, v in arrays.items())
        stream = code.encode_stream(arrays)
        if code.coded_nbytes(arrays) != len(stream):
            fail(f"(d) coded_nbytes {code.coded_nbytes(arrays)} != the stream's {len(stream)}")
        back = code.decode_stream(stream, schema)
        if any(not torch.equal(back[n], v) for n, v in arrays.items()):
            fail(f"(d) the stream of {sorted(arrays)} does not decode to its arrays")
        name = "idx" if "idx" in arrays else "vals"
        coded[name] += code.coded_nbytes({name: arrays[name]})
        raw[name] += arrays[name].numel() * arrays[name].element_size()
    row = {"chunks": c, "int8_symbols": N_CLIENTS * c * K, "index_symbols": c * K,
           "int8_coded_over_raw": coded["vals"] / raw["vals"],
           "index_coded_over_raw": coded["idx"] / raw["idx"],
           "seconds": time.perf_counter() - t0}
    log("codec (d) entropy " + json.dumps(row))
    return row


def _small_codec_cases() -> dict:
    """name -> pipeline of the codec layer on the small tree."""
    from repro_torch.core import codec

    kw = dict(k=16, d_block=256)
    return {
        "int8": codec.Pipeline([codec.RandProjSpatial(**kw), codec.Int8Quant()]),
        "correlated": codec.Pipeline([codec.RandProjSpatial(**kw), codec.CorrelatedQuant()]),
        "bf16": codec.Pipeline([codec.RandProjSpatial(**kw), codec.Bf16Quant()]),
        "sparse_proj": codec.Pipeline([codec.SparseProj(s=SPARSE_S, **kw)]),
        "ef_top_k": codec.Pipeline([codec.TopK(**kw), codec.ErrorFeedback()]),
        "temporal_rand_k": codec.Pipeline([codec.RandK(**kw), codec.Temporal()]),
        "build_entropy": codec.build("rand_proj_spatial", payload_dtype="int8",
                                     entropy_code=True, **kw),
    }


def _small_codec_run(name, pipe, tree, dev) -> list:
    """Every output of one small-tree case on ``dev``, as CPU tensors."""
    from repro_torch.core import chunking, codec
    from repro_torch.dist import collectives

    if name == "temporal_rand_k":
        chunks = collectives._chunk_clients(chunking.tree_unflatten(
            tree, [leaf.to(dev) for leaf in chunking.tree_leaves(tree)]), 256)[0]
        states, outs = pipe.init_client_state(N_CLIENTS, chunks.shape[1], device=dev), []
        for t in range(3):
            side = states.memory.mean(0)
            payloads, states = pipe.encode_all(t, chunks + 0.1 * t, states=states)
            outs += [pipe.decode(t, payloads, N_CLIENTS, side_info=side), states.memory]
        return [o.cpu() for o in outs]
    if name == "ef_top_k":
        ef, outs = None, []
        for t in range(3):
            mean, _, ef = collectives.compressed_mean_tree(pipe, t, tree, ef_chunks=ef,
                                                           device=dev)
            outs += [_flat(mean), ef]
        return [o.cpu() for o in outs]
    mean, _, _ = collectives.compressed_mean_tree(pipe, 9, tree, device=dev)
    outs = [_flat(mean).cpu()]
    if name == "build_entropy":
        chunks = collectives._chunk_clients(chunking.tree_unflatten(
            tree, [leaf.to(dev) for leaf in chunking.tree_leaves(tree)]), 256)[0]
        payloads, _ = pipe.encode_all(9, chunks)
        outs.append(torch.tensor([float(codec.coded_payload_nbytes(pipe, payloads))]))
    return outs


def _codec_small(tree: dict) -> dict:
    """(e) every new config on the small tree, card against CPU: relative
    L2 of every output within 1e-4."""
    gaps = {}
    for name, pipe in _small_codec_cases().items():
        got = _small_codec_run(name, pipe, tree, DEV)
        want = _small_codec_run(name, pipe, tree, "cpu")
        gaps[name] = max(rel_l2(g, w) for g, w in zip(got, want))
        if not gaps[name] <= 1e-4 or not all(torch.isfinite(g).all() for g in got):
            fail(f"(e) small tree, {name}: card and CPU differ by {gaps[name]} (limit 1e-4)")
    log("codec (e) small tree: card vs CPU, largest relative L2 gap by config " + json.dumps(gaps))
    return gaps


def phase_codec(tree: dict, main: dict) -> dict:
    """The codec layer at full width on the main path's tree: (a) the
    quantized main path, (b) SparseProj, (c) error feedback, (d) entropy
    coding of payload prefixes on the host, (e) the small tree card vs CPU."""
    out = {"a": _codec_quantized(tree, main), "b": _codec_sparse_proj(tree, main)}
    out["c"], top_k_payload = _codec_error_feedback(tree, main)
    out["d"] = _codec_entropy(tree, top_k_payload)
    out["e"] = _codec_small(small_tree())
    return out



# -------------------------------------------------- phase_dist (dist/ mesh)

DIST_RANKS = 4            # (b): ranks on the one card, over gloo, one client each
DIST_OVERLAP_TILE = 8192  # (a): chunks a tile of the overlapped routes
DIST_JOIN_S = 240         # (b): the spawned ranks' deadline
# (b), at 4 ranks of one client: (n - n/s) k 4 = 768 B a chunk against d 4 =
# 4096 B, so the owner route moves more intra-pod bytes (the model says so)
DIST_OWNER_BYTES, DIST_ALLGATHER_BYTES = 1_646_048_256, 387_302_400
DIST_ROUTES = {  # (a): route -> (entry, keyword arguments)
    "shard_map": ("shard_map", {}),
    "shard_map_owners": ("shard_map", {"ownership": True}),
    "shard_map_overlap": ("shard_map", {"overlap": True, "overlap_tile": DIST_OVERLAP_TILE}),
    "shard_map_owners_overlap": ("shard_map", {"ownership": True, "overlap": True,
                                               "overlap_tile": DIST_OVERLAP_TILE}),
    "gspmd": ("gspmd", {}),
}


def _sha256(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _dist_one_rank(tree: dict, smi: str) -> dict:
    """(a) the mesh routes on one rank over NCCL, in this process, against
    the local route; psum_scatter_mean; one mesh DME step of mamba2-130m."""
    import torch.distributed as dist

    from repro_torch.dist import collectives, sharding
    from repro_torch.kernels import ops

    seed = SHARED_BASELINE_SEED
    local_ms = []  # a first and a warm call
    for _ in range(2):
        local, ms = _timed_round(lambda: collectives.compressed_mean_tree(
            _spec(True, "auto"), seed, tree, device=DEV))
        local_ms.append(ms)
    local_mean = _flat(local[0])
    local_sha = _sha256(local_mean)
    del local
    mesh = sharding.make_mesh((1,), ("pod",), device=DEV)
    if dist.get_backend() != "nccl":
        fail(f"(a) the one-rank mesh runs on {dist.get_backend()}, not NCCL")
    rows, launches = [], {}
    n_chunks = -(-MAMBA2_130M_PARAMS // D_BLOCK)
    for route, (entry, kw) in DIST_ROUTES.items():
        if entry == "shard_map":
            call = lambda: collectives.compressed_mean_tree_shardmap(  # noqa: E731
                _spec(True, "auto"), seed, tree, mesh, device=DEV, **kw)
        else:
            call = lambda: collectives.compressed_mean_tree(  # noqa: E731
                _spec(True, "auto"), seed, tree, collectives.dme_shardings(mesh), device=DEV,
                **kw)
        first_ms = _timed_round(call)[1]  # the route's first call, then a warm one
        torch.cuda.synchronize()
        ops.reset_launch_counts()  # the warm call's window opens here
        (mean_tree, info, _), route_ms = _timed_round(call)
        counts = dict(ops.launch_counts())  # ... and closes here
        decodes = -(-n_chunks // kw["overlap_tile"]) if kw.get("overlap") else 1
        steps = counts.pop("srht_cg_step", 0)
        bitwise = bool(torch.equal(_flat(mean_tree), local_mean))
        del mean_tree
        rows.append({"route": route, "wall_ms": route_ms, "first_wall_ms": first_ms,
                     "local_wall_ms": local_ms[1], "local_first_wall_ms": local_ms[0],
                     "bitwise_local": bitwise, "decodes": decodes,
                     "launches": {**counts, "srht_cg_step": steps}, "n_shards": info["n_shards"]})
        log(f"dist (a) [{smi}] " + json.dumps(rows[-1]))
        if not bitwise:
            fail(f"(a) {route}: the mean is not the local route's, bitwise")
        if counts != {"fwht": N_CLIENTS * decodes, "srht_decode_sum": decodes} or \
                not decodes <= steps <= 64 * decodes:
            fail(f"(a) {route} launched {rows[-1]['launches']}: not K1 x {N_CLIENTS} and K3 x 1 "
                 f"a decode ({decodes}) and 1-64 CG steps a decode")
        for name, n in rows[-1]["launches"].items():
            launches[name] = launches.get(name, 0) + n
    del local_mean
    # psum_scatter_mean on (1, C, d_block) against the plain weighted mean
    g = torch.Generator(device=DEV).manual_seed(5)
    tiles = torch.randn((1, n_chunks, D_BLOCK), generator=g, device=DEV)
    got, psum_ms = _timed_round(lambda: collectives.psum_scatter_mean(tiles, [4.0], mesh))
    want = (4.0 * tiles[0]) / 4.0
    psum = {"shape": list(tiles.shape), "wall_ms": psum_ms,
            "max_abs_err": float((got - want).abs().max()),
            "allclose_rtol1e-5_atol1e-6": bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))}
    del tiles, got, want
    log(f"dist (a) psum_scatter_mean [{smi}] " + json.dumps(psum))
    if not psum["allclose_rtol1e-5_atol1e-6"]:
        fail(f"(a) psum_scatter_mean differs from the weighted mean by {psum['max_abs_err']}")
    step = _dist_train_step(mesh, smi)
    dist.destroy_process_group()
    return {"routes": rows, "launches": launches, "psum": psum, "train": step,
            "local_sha256": local_sha}


def _dist_train_step(mesh, smi: str) -> dict:
    """(a) one DME step of mamba2-130m at full width (4 x 4 x 1024) on the
    mesh (the shard_map route: each rank its own clients) and without it,
    from the same state: the updates bitwise."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train import init_train_state, make_train_step

    cfg = configs.preset_config(TRAIN_MAMBA_ARCH, "full")
    params = init_params(cfg, 0, device=DEV)
    opt = _train_opt()
    state = init_train_state(cfg, opt, params, _train_spec(), N_CLIENTS)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_MAMBA_SEQ, batch=TRAIN_BATCH,
                        n_clients=N_CLIENTS, seed=0).batch_at(0, DEV)
    out = {}
    # a warm-up step first, so that both timed steps are warm
    for name, kw in (("warm_up", {}), ("meshless", {}), ("mesh", {"mesh": mesh})):
        step_fn = make_train_step(cfg, opt, dme_spec=_train_spec(), device=DEV, **kw)
        (new_params, _, metrics), ms = _timed_round(lambda: step_fn(params, state, batch, 0))
        out[name] = (new_params, float(metrics["loss"]), ms)
    del out["warm_up"]
    bitwise = all(torch.equal(a, b) for a, b in zip(_leaves(out["meshless"][0]),
                                                    _leaves(out["mesh"][0])))
    row = {"params": cfg.n_params(), "tokens": [N_CLIENTS, TRAIN_BATCH, TRAIN_MAMBA_SEQ],
           "loss": [out["meshless"][1], out["mesh"][1]],
           "wall_ms": {"meshless": out["meshless"][2], "mesh": out["mesh"][2]},
           "update_bitwise": bitwise}
    del out, params, state
    log(f"dist (a) train step [{smi}] " + json.dumps(row))
    if not bitwise:
        fail("(a) the mesh DME step's update is not the mesh-less step's, bitwise")
    return row


def _dist_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """(b) one rank of DIST_RANKS on the card over gloo: its client of the
    full-width tree through the shard_map route, sync and owner-routed."""
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.dist import collectives, sharding

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = sharding.make_mesh((world,), ("pod",), device=DEV)
        # the same tree on every rank (one seed), cut to this rank's client
        mine = _take(gradient_tree(), slice(rank, rank + 1))
        obs.enable()
        out = {}
        for route, kw in (("shard_map", {}), ("shard_map_owners", {"ownership": True})):
            ms = []  # a first call, then a warm one whose staged bytes are counted
            for _ in range(2):
                obs.reset()
                dist.barrier()
                (mean_tree, info, _), t = _timed_round(
                    lambda: collectives.compressed_mean_tree_shardmap(
                        _spec(True, "auto"), SHARED_BASELINE_SEED, mine, mesh, device=DEV,
                        **kw))
                ms.append(t)
            staged = obs.snapshot()["counters"].get("dist/host_staged_bytes", 0)
            out[route] = {"wall_ms": ms[1], "first_wall_ms": ms[0],
                          "sha256": _sha256(_flat(mean_tree)),
                          "host_staged_bytes": int(staged),
                          **{k: info[k] for k in ("n_shards", "intra_pod_bytes",
                                                  "intra_pod_bytes_allgather",
                                                  "intra_pod_bytes_ownership")}}
            del mean_tree
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _dist_four_ranks(local_sha: str, smi: str) -> dict:
    """(b) DIST_RANKS processes on the one card over gloo, each on cuda:0
    with one client: rank 0's mean bitwise the local route's (by SHA-256 of
    its bytes), every rank's equal to rank 0's, the intra-pod columns the
    model's. Four processes share one card: not a multi-card time."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_dist_rank, args=(DIST_RANKS, os.path.join(tmp, "store"), tmp),
                                 nprocs=DIST_RANKS, join=False, start_method="spawn")
        deadline = t0 + DIST_JOIN_S
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.perf_counter())):
                if time.perf_counter() >= deadline:
                    fail(f"(b) the {DIST_RANKS} ranks did not finish in {DIST_JOIN_S} s")
        except mp.ProcessRaisedException as e:
            fail(f"(b) a rank failed: {e}")
        except mp.ProcessExitedException as e:
            fail(f"(b) a rank exited: {e}")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(DIST_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    out = {"ranks": DIST_RANKS, "backend": "gloo", "device": "cuda:0 (all ranks)",
           "seconds_with_spawn": seconds}
    for route in ("shard_map", "shard_map_owners"):
        rows = [rk[route] for rk in ranks]
        out[route] = {"bitwise_local": rows[0]["sha256"] == local_sha,
                      "ranks_equal": all(r["sha256"] == rows[0]["sha256"] for r in rows),
                      "wall_ms_by_rank_four_processes_one_card": [r["wall_ms"] for r in rows],
                      "first_wall_ms_by_rank": [r["first_wall_ms"] for r in rows],
                      "host_staged_bytes_by_rank": [r["host_staged_bytes"] for r in rows],
                      **{k: rows[0][k] for k in ("n_shards", "intra_pod_bytes",
                                                 "intra_pod_bytes_allgather",
                                                 "intra_pod_bytes_ownership")}}
        log(f"dist (b) {route} [{smi}] " + json.dumps(out[route]))
        if not out[route]["bitwise_local"]:
            fail(f"(b) {route}: rank 0's mean is not the local route's, bitwise")
        if not out[route]["ranks_equal"]:
            fail(f"(b) {route}: the ranks' means differ")
        if out[route]["n_shards"] != DIST_RANKS:
            fail(f"(b) {route}: info says {out[route]['n_shards']} shards")
        if min(out[route]["host_staged_bytes_by_rank"]) <= 0:
            fail(f"(b) {route}: gloo's payloads were not staged through the host")
    own = out["shard_map_owners"]
    if (own["intra_pod_bytes_ownership"], own["intra_pod_bytes_allgather"]) != \
            (DIST_OWNER_BYTES, DIST_ALLGATHER_BYTES) or \
            own["intra_pod_bytes"] != own["intra_pod_bytes_ownership"]:
        fail(f"(b) the intra-pod columns {own} are not the model's")
    if not own["intra_pod_bytes_ownership"] > own["intra_pod_bytes_allgather"]:
        fail("(b) the info does not say the owner route moves more bytes at this configuration")
    return out


def phase_dist(tree: dict, smi: str) -> dict:
    """The mesh route of dist/ at the estimator's full width: (a) one rank
    over NCCL in this process, (b) four ranks on the card over gloo."""
    t0 = time.perf_counter()
    one = _dist_one_rank(tree, smi)
    four = _dist_four_ranks(one["local_sha256"], smi)
    out = {"a": one, "b": four, "seconds": time.perf_counter() - t0}
    log(f"dist: {out['seconds']:.1f} s")
    return out


# ---------------------------------------- phase_pipeline (the GPipe schedule)

PIPE_MICRO = 4      # microbatches a client's batch of TRAIN_BATCH splits into
# tests/test_pipeline.py:117-118's bound, PIPE_TOL: the loss within it of
# the step without a pipeline, (b)'s update within it of (a)'s, and (a)'s
# float32 update within it of the step without a pipeline under AdamW at
# PIPE_EPS, the eps the CPU tests give AdamW (tests/test_torch_train.py):
# at the cell's eps of 1e-8 AdamW's first step, lr * g / (|g| + eps), turns
# the rounding of a near-zero g into update gaps of up to 2 lr. So (a)
# replays AdamW at PIPE_EPS on both steps' gradients, and holds the float32
# gradient entering AdamW within the port's float32 tolerance
# PIPE_GRAD_RTOL (relative L2). Its witness is the step without a pipeline
# against itself with every client's rows in reverse order: the same sum
# in another order, its update gaps at both eps printed beside (a)'s.
PIPE_TOL, PIPE_GRAD_RTOL, PIPE_EPS = 2e-5, 1e-5, 1e-6
PIPE_RANKS = 2      # (b): stages, one gloo rank each on the one card (12 blocks a stage)
PIPE_JOIN_S = 420   # (b): the spawned ranks' deadline
PIPE_KERNELS = ("fwht", "srht_decode_sum", "srht_cg_step")


class _GradRecorder:
    """An optimizer that keeps the gradient leaves of its last update."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, *args):
        self.grads, self.args = grads, args
        return self.inner.update(grads, *args)

    def replay(self, opt) -> list:
        """The parameters ``opt`` makes of the last update's gradient and
        state."""
        return _leaves(opt.update(self.grads, *self.args)[0])


def _pipe_cell(mesh=None, stages: int = 0, dtype: str = "bfloat16") -> tuple:
    """(config, params, state, batch, step) of the mamba2-130m DME cell of
    ``phase_train`` (d) (full width, 4 clients x 4 x 1024 tokens, remat by
    block) in the compute ``dtype``, pipelined over ``mesh``'s ``pipe`` axis
    when ``stages``; ``step.grads`` is the last step's gradient (the
    clients' decoded mean) that entered AdamW."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train import init_train_state, make_train_step

    cfg = configs.preset_config(TRAIN_MAMBA_ARCH, "full").replace(dtype=dtype)
    params = init_params(cfg, 0, device=DEV)
    opt = _GradRecorder(_train_opt())
    state = init_train_state(cfg, opt, params, _train_spec(), N_CLIENTS)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_MAMBA_SEQ, batch=TRAIN_BATCH,
                        n_clients=N_CLIENTS, seed=0).batch_at(0, DEV)
    step = make_train_step(cfg, opt, dme_spec=_train_spec(), device=DEV, mesh=mesh,
                           pipeline_stages=stages,
                           pipeline_microbatches=PIPE_MICRO if stages else 0)
    step.grads, step.replay = lambda: _leaves(opt.grads), opt.replay
    return cfg, params, state, batch, step


def _pipe_run(step, params, state, batch, warm: bool = True) -> dict:
    """A first and (``warm``) a warm call of ``step`` from the same state:
    the last call's wall ms, launches, host-staged bytes and peak memory,
    and its new parameters."""
    from repro_torch import obs
    from repro_torch.kernels import ops

    first_ms = _timed_round(lambda: step(params, state, batch, 0))[1] if warm else None
    obs.enable()
    obs.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the warm call's window opens here
    (new, _, metrics), ms = _timed_round(lambda: step(params, state, batch, 0))
    launches = dict(ops.launch_counts())  # ... and closes here
    staged = obs.snapshot()["counters"].get("dist/host_staged_bytes", 0)
    obs.disable()
    obs.reset()
    return {"new": _leaves(new), "grads": step.grads(), "wall_ms": ms, "first_wall_ms": first_ms,
            "new_eps": step.replay(_train_opt(eps=PIPE_EPS)),
            "loss": float(metrics["loss"]), "launches": launches,
            "host_staged_bytes": int(staged),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _pipe_launch_check(tag: str, launches: dict) -> None:
    launched = dict(launches)
    steps = launched.pop("srht_cg_step", 0)
    lo, hi = TRAIN_CG_STEPS
    if launched != {"fwht": N_CLIENTS, "srht_decode_sum": 1} or not lo <= steps <= hi:
        fail(f"({tag}) the pipelined step launched {launches}: not K1 x {N_CLIENTS}, K3 x 1 and "
             f"{lo}-{hi} CG steps")


def _max_gap(a: list, b: list) -> float:
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def _pipe_one_rank(smi: str, ref_path: str) -> dict:
    """(a) one NCCL rank, ``pipeline_stages=1``, 4 microbatches: in bf16
    beside the step without a pipeline (its update saved to ``ref_path`` for
    (b)), and once more in float32, where the gradient must be within
    PIPE_GRAD_RTOL, and the update under AdamW at PIPE_EPS within PIPE_TOL,
    of the step without a pipeline. The witness, in both dtypes: the step
    without a pipeline against itself with the rows reversed."""
    import torch.distributed as dist

    from repro_torch.dist import sharding

    mesh = sharding.make_mesh((1,), ("pipe",), device=DEV)
    if dist.get_backend() != "nccl":
        fail(f"(a) the one-rank pipe axis runs on {dist.get_backend()}, not NCCL")
    row = {"stages": 1, "microbatches": PIPE_MICRO, "backend": "nccl", "eps_replayed": PIPE_EPS}
    for dtype in ("bfloat16", "float32"):
        _, params, state, batch, plain_step = _pipe_cell(dtype=dtype)
        warm = dtype == "bfloat16"  # the timed cell; float32 checks the update alone
        plain = _pipe_run(plain_step, params, state, batch, warm)
        witness = _pipe_run(plain_step, params, state,
                            {k: v.flip(1) for k, v in batch.items()}, warm=False)
        piped = _pipe_run(_pipe_cell(mesh, 1, dtype)[-1], params, state, batch, warm)
        row[dtype] = {
            "grad_rel_gap_vs_no_pipeline": rel_l2(_flat(piped["grads"]), _flat(plain["grads"])),
            "max_abs_update_gap_vs_no_pipeline": _max_gap(piped["new"], plain["new"]),
            "max_abs_update_gap_vs_no_pipeline_eps": _max_gap(piped["new_eps"],
                                                              plain["new_eps"]),
            "update_rel_gap_vs_no_pipeline": _update_gap(params, piped["new"], plain["new"]),
            "update_bitwise_no_pipeline": all(torch.equal(a, b) for a, b in
                                              zip(piped["new"], plain["new"])),
            "witness_rows_reversed": {
                "grad_rel_gap": rel_l2(_flat(witness["grads"]), _flat(plain["grads"])),
                "max_abs_update_gap": _max_gap(witness["new"], plain["new"]),
                "max_abs_update_gap_eps": _max_gap(witness["new_eps"], plain["new_eps"]),
                "loss": witness["loss"]},
            "loss": [piped["loss"], plain["loss"]],
            **{k: piped[k] for k in ("wall_ms", "first_wall_ms", "launches",
                                     "host_staged_bytes", "peak_gb")},
            "no_pipeline": {k: plain[k] for k in ("wall_ms", "first_wall_ms", "peak_gb")}}
        log(f"pipeline (a) {dtype} [{smi}] " + json.dumps(row[dtype]))
        _pipe_launch_check("a", piped["launches"])
        if not abs(piped["loss"] - plain["loss"]) <= PIPE_TOL:
            fail(f"(a) {dtype}: the one-stage pipelined loss {piped['loss']} is not within "
                 f"{PIPE_TOL} of the step without a pipeline ({plain['loss']})")
        if warm:
            torch.save([t.cpu() for t in piped["new"]], ref_path)
        del piped, plain, witness, params, state, plain_step
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    f32 = row["float32"]
    if not f32["grad_rel_gap_vs_no_pipeline"] <= PIPE_GRAD_RTOL:
        fail(f"(a) the one-stage pipelined gradient in float32 differs from the step without a "
             f"pipeline by {f32['grad_rel_gap_vs_no_pipeline']} (relative L2; limit "
             f"{PIPE_GRAD_RTOL})")
    if not f32["max_abs_update_gap_vs_no_pipeline_eps"] <= PIPE_TOL:
        fail(f"(a) under AdamW at eps {PIPE_EPS} the one-stage pipelined update in float32 "
             f"differs from the step without a pipeline by "
             f"{f32['max_abs_update_gap_vs_no_pipeline_eps']} (limit {PIPE_TOL})")
    row["launches"] = row["bfloat16"]["launches"]
    return row


def _pipe_rank(rank: int, world: int, store: str, out_dir: str, ref_path: str) -> None:
    """(b) one stage of PIPE_RANKS on the card over gloo: the pipelined DME
    step, a first and a warm call, against (a)'s update."""
    import torch.distributed as dist

    from repro_torch.dist import sharding

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = sharding.make_mesh((world,), ("pipe",), device=DEV)
        _, params, state, batch, step = _pipe_cell(mesh, world)
        run = _pipe_run(step, params, state, batch)
        ref = [t.to(DEV) for t in torch.load(ref_path)]
        out = {k: run[k] for k in ("wall_ms", "first_wall_ms", "loss", "launches",
                                   "host_staged_bytes", "peak_gb")}
        out.update(bitwise_a=all(torch.equal(a, b) for a, b in zip(run["new"], ref)),
                   max_abs_gap_a=_max_gap(run["new"], ref), sha256=_sha256(_flat(run["new"])))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _pipe_two_ranks(smi: str, ref_path: str, tmp: str) -> dict:
    """(b) PIPE_RANKS processes on the one card over gloo (NCCL refuses two
    ranks on one card), ``pipeline_stages=2``: every rank's update bitwise
    (a)'s or within PIPE_TOL of it. Two processes on one card: not a
    multi-card time."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(_pipe_rank, args=(PIPE_RANKS, os.path.join(tmp, "store"), tmp,
                                               ref_path),
                             nprocs=PIPE_RANKS, join=False, start_method="spawn")
    deadline = t0 + PIPE_JOIN_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.perf_counter())):
            if time.perf_counter() >= deadline:
                fail(f"(b) the {PIPE_RANKS} stages did not finish in {PIPE_JOIN_S} s")
    except mp.ProcessRaisedException as e:
        fail(f"(b) a stage failed: {e}")
    except mp.ProcessExitedException as e:
        fail(f"(b) a stage exited: {e}")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = []
    for r in range(PIPE_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    out = {"stages": PIPE_RANKS, "microbatches": PIPE_MICRO, "backend": "gloo",
           "device": "cuda:0 (all ranks)", "seconds_with_spawn": time.perf_counter() - t0,
           "note": "two processes share one card: not a multi-card time", "ranks": ranks}
    log(f"pipeline (b) [{smi}] " + json.dumps(out))
    for r, rk in enumerate(ranks):
        if not (rk["bitwise_a"] or rk["max_abs_gap_a"] <= PIPE_TOL):
            fail(f"(b) stage {r}'s update differs from (a)'s by {rk['max_abs_gap_a']}")
        if rk["sha256"] != ranks[0]["sha256"]:
            fail(f"(b) stage {r}'s update is not stage 0's")
        if rk["host_staged_bytes"] <= 0:
            fail(f"(b) stage {r}: gloo's hops were not staged through the host")
        _pipe_launch_check("b", rk["launches"])
    return out


def phase_pipeline(smi: str) -> dict:
    """The GPipe schedule (``make_train_step(pipeline_stages=)``) on
    mamba2-130m at full width: (a) one stage on one NCCL rank against the
    step without a pipeline, (b) two stages on two gloo ranks on the card
    against (a). -> the launches of both."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "a_update.pt")
        one = _pipe_one_rank(smi, ref_path)
        torch.cuda.empty_cache()
        two = _pipe_two_ranks(smi, ref_path, tmp)
    launches = dict(one["launches"])
    for rk in two["ranks"]:
        for name, n in rk["launches"].items():
            launches[name] = launches.get(name, 0) + n
    out = {"a": one, "b": two, "launches": launches, "seconds": time.perf_counter() - t0}
    log(f"pipeline: {out['seconds']:.1f} s; launches {launches}")
    return out


# ------------------------- phase_placed (parameters placed over data / model)

PLACED_RANKS = 4            # gloo ranks on the one card (NCCL refuses two a card)
PLACED_JOIN_S = 600         # the spawned ranks' deadline
PLACED_TRAIN_MESH = (1, 2, 2)   # (pod, data, model)
# (a): musicgen-medium at full width, 8 of its 48 layers. Each rank holds
# every client's whole gradient and its chunked copy for the exchange (2 x
# 4 x 0.93 GB): at 12 layers (346,068,480 parameters) a rank reached 16.3
# GB in the CG decode and the four ranks ran out of the card's 80 GB
PLACED_TRAIN_BLOCKS, PLACED_TRAIN_PARAMS = 8, 232_809_984
# the compressed mean streamed in tiles of 65,536 chunks (bitwise the whole
# exchange), so that its CG temporaries are a tile's, not the tree's
PLACED_OVERLAP_TILE = 65536
PLACED_SERVE_MESH = (1, 1, 4)
PLACED_SERVE_BATCH, PLACED_SERVE_PROMPT, PLACED_SERVE_GEN = 2, 2048, 8
PLACED_SERVE_TOL = 1e-4     # float32 logits, relative L2, and equal tokens
PLACED_LOCAL_HEADS = (2, 1, 256)  # gemma3-4b's q heads, kv heads, d_head a rank over 4
PLACED_KERNELS = ("fwht", "srht_decode_sum", "srht_cg_step", "flash_attention_f32",
                  "flash_attention_bf16")
PLACED_PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "all_to_all_single")


def _placed_serve_cfg():
    from repro_torch import configs

    return configs.preset_config("gemma3-4b", "full").replace(attn_impl="flash")


def _placed_train_cfg(dtype: str):
    from repro_torch import configs

    return configs.preset_config(TRAIN_ARCH, TRAIN_PRESET).replace(
        n_blocks=PLACED_TRAIN_BLOCKS, dtype=dtype)


def _placed_step(cfg, mesh=None, shardings=None):
    """(params, state, batch, step) of (a)'s cell in ``cfg``'s compute
    dtype: AdamW at PIPE_EPS, the training CLI's codec, 4 clients x 4 x 128
    tokens; placed over ``mesh`` when given."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train import init_train_state, make_train_step

    params = init_params(cfg, 0, device=DEV, shardings=shardings)
    opt = _train_opt(eps=PIPE_EPS)
    state = init_train_state(cfg, opt, params, _train_spec(), N_CLIENTS, shardings=shardings)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                        n_clients=N_CLIENTS, seed=0).batch_at(0, DEV)
    step = make_train_step(cfg, opt, dme_spec=_train_spec(), mesh=mesh,
                           param_shardings=shardings, dme_overlap=True,
                           dme_overlap_tile=PLACED_OVERLAP_TILE, device=DEV)
    return params, state, batch, step


def _placed_run(step, params, state, batch) -> dict:
    """One call of ``step`` from ``params``/``state``: its wall ms (host
    clock, synchronised), launches, host-staged bytes, peak memory, loss
    and new parameters."""
    from repro_torch import obs
    from repro_torch.kernels import ops

    obs.enable()
    obs.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the step's window opens here
    t0 = time.perf_counter()
    new, new_state, metrics = step(params, state, batch, 0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.launch_counts())  # ... and closes here
    staged = obs.snapshot()["counters"].get("dist/host_staged_bytes", 0)
    obs.disable()
    obs.reset()
    return {"new": new, "state": new_state, "wall_ms": wall_ms, "launches": launches,
            "host_staged_bytes": int(staged), "loss": float(metrics["loss"]),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _placed_launch_check(tag: str, launches: dict) -> None:
    launched = dict(launches)
    steps = launched.pop("srht_cg_step", 0)
    lo, hi = TRAIN_CG_STEPS
    # the overlapped stream encodes and decodes a tile at a time
    chunks = -(-PLACED_TRAIN_PARAMS // D_BLOCK)
    tiles = -(-chunks // PLACED_OVERLAP_TILE)
    if launched != {"fwht": N_CLIENTS * tiles, "srht_decode_sum": tiles} or \
            not lo * tiles <= steps <= hi * tiles:
        fail(f"({tag}) the placed step launched {launches}: not K1 x {N_CLIENTS * tiles}, "
             f"K3 x {tiles} and {lo * tiles}-{hi * tiles} CG steps")


def _placed_train_ref(ref_dir: str) -> dict:
    """(a)'s one-rank reference: the mesh-less step in float32 (its update
    saved for the ranks) and in bf16 (wall and peak memory)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _placed_train_cfg(dtype)
        if cfg.n_params() != PLACED_TRAIN_PARAMS:
            fail(f"(a) musicgen-medium at {PLACED_TRAIN_BLOCKS} blocks has {cfg.n_params()} "
                 f"parameters, not {PLACED_TRAIN_PARAMS}")
        params, state, batch, step = _placed_step(cfg)
        at_rest = torch.cuda.memory_allocated()
        step(params, state, batch, 0)  # first call
        run = _placed_run(step, params, state, batch)
        out[dtype] = {k: run[k] for k in ("wall_ms", "loss", "peak_gb", "launches")}
        out[dtype]["at_rest_gb"] = at_rest / 1e9
        if dtype == "float32":
            torch.save({"leaves": [t.cpu() for t in _leaves(run["new"])], "loss": run["loss"]},
                       os.path.join(ref_dir, "train_f32.pt"))
        del params, state, batch, step, run
        _free()
    return out


def _free() -> None:
    """Collect what reference cycles hold, then hand the cache back: the
    four ranks need the card's memory."""
    gc.collect()
    torch.cuda.empty_cache()


def _placed_serve_ref(ref_dir: str) -> dict:
    """(b)'s one-rank reference: gemma3-4b at full width served on the
    kernel route in float32 and bf16 (logits and tokens saved)."""
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    cfg = _placed_serve_cfg()
    params = init_params(cfg, SERVE_SEED, device=DEV)
    out = {}
    for dtype in ("float32", "bfloat16"):
        res = serve.serve(cfg.replace(dtype=dtype), params, batch=PLACED_SERVE_BATCH,
                          prompt_len=PLACED_SERVE_PROMPT, gen=PLACED_SERVE_GEN, seed=SERVE_SEED,
                          device=DEV)
        out[dtype] = {k: res[k].cpu() for k in ("tokens", "prefill_logits", "last_logits")}
        out[dtype]["prefill_ms"] = res["prefill_s"] * 1e3
        out[dtype]["decode_ms_per_step"] = res["decode_s"] * 1e3 / (PLACED_SERVE_GEN - 1)
    torch.save(out, os.path.join(ref_dir, "serve.pt"))
    del params, res
    _free()
    return {d: {k: v for k, v in r.items() if k.endswith("ms") or k.endswith("step")}
            for d, r in out.items()}


def _placed_gloo_probe(rank: int, world: int) -> dict:
    """Which of gloo's collectives take CUDA tensors: each on a group of its
    own with a 60 s timeout, so that one that fails on some ranks only
    cannot hold the others. -> {op: "ok" | the error's first line}."""
    import datetime

    import torch.distributed as dist

    out = {}
    for op in PLACED_PROBE_OPS:
        group = dist.new_group(list(range(world)), backend="gloo",
                               timeout=datetime.timedelta(seconds=60))
        t = torch.full((world * 4,), float(rank + 1), device=DEV)
        try:
            if op == "all_reduce":
                dist.all_reduce(t, group=group)
            elif op == "broadcast":
                dist.broadcast(t, src=0, group=group)
            elif op == "all_gather":
                dist.all_gather([torch.empty_like(t) for _ in range(world)], t, group=group)
            elif op == "all_gather_into_tensor":
                dist.all_gather_into_tensor(t.new_empty(world * t.numel()), t, group=group)
            elif op == "reduce_scatter_tensor":
                dist.reduce_scatter_tensor(t.new_empty(4), t, group=group)
            else:
                dist.all_to_all_single(torch.empty_like(t), t, group=group)
            torch.cuda.synchronize()
            out[op] = "ok"
        except Exception as e:  # the finding: recorded, not fatal
            out[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def _placed_rank(rank: int, world: int, store: str, out_dir: str, ref_dir: str) -> None:
    """One of PLACED_RANKS gloo ranks on the card: (a) the placed DME step
    of musicgen-medium on (1, 2, 2), bf16 first and warm, then float32
    against the reference's update; (b) gemma3-4b served on (1, 1, 4) in
    float32 and bf16 against the one-rank kernel route; then the gloo
    probe."""
    import torch.distributed as dist

    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    out = {"rank": rank}
    try:
        # ---- (a) training on (1, 2, 2)
        mesh = sharding.make_mesh(PLACED_TRAIN_MESH, ("pod", "data", "model"), device=DEV)
        pl = sharding.Placement(mesh)
        for dtype in ("bfloat16", "float32"):
            cfg = _placed_train_cfg(dtype)
            sh = sharding.param_shardings(cfg, mesh)
            params, state, batch, step = _placed_step(cfg, mesh, sh)
            torch.cuda.synchronize()
            at_rest = torch.cuda.memory_allocated()
            want_rest = 3 * sum(t.numel() * 4 for t in _leaves(params))  # params, mu, nu
            whole_rest = 3 * PLACED_TRAIN_PARAMS * 4
            first = _placed_run(step, params, state, batch) if dtype == "bfloat16" else None
            run = _placed_run(step, params, state, batch)
            row = {k: run[k] for k in ("wall_ms", "loss", "launches", "host_staged_bytes",
                                       "peak_gb")}
            row.update(first_wall_ms=None if first is None else first["wall_ms"],
                       at_rest_gb=at_rest / 1e9, shard_bytes_at_rest=want_rest,
                       whole_bytes_at_rest=whole_rest)
            if dtype == "float32":
                ref = torch.load(os.path.join(ref_dir, "train_f32.pt"), mmap=True)
                specs = [s.spec for s in _leaves(sh)]
                gap = max(float((a.float() - pl.local(b.to(DEV), spec).float()).abs().max())
                          for a, b, spec in zip(_leaves(run["new"]), ref["leaves"], specs))
                row.update(max_abs_update_gap_vs_meshless=gap, meshless_loss=ref["loss"])
                del ref
            # what a rank holds after the step, the step still alive (a tree
            # gathered over data that it kept, across steps or not, would
            # show here): its shards of the new state, and little else
            del first, params, state
            torch.cuda.synchronize()
            row["after_step_gb"] = torch.cuda.memory_allocated() / 1e9
            row["after_step_shard_gb"] = 3 * sum(t.numel() * 4 for t in _leaves(run["new"])) / 1e9
            row["gathered_gb"] = sum(
                math.prod(sharding.whole_shape(t.shape, tuple(e if e == "data" else None
                                                              for e in spec), mesh)) * 4
                for t, spec in zip(_leaves(run["new"]), (s.spec for s in _leaves(sh)))) / 1e9
            out[f"train_{dtype}"] = row
            del run, batch, step
            _free()
        # ---- (b) serving on (1, 1, 4)
        mesh = sharding.make_mesh(PLACED_SERVE_MESH, ("pod", "data", "model"), device=DEV)
        cfg = _placed_serve_cfg()
        sh = sharding.param_shardings(cfg, mesh)
        params = init_params(cfg, SERVE_SEED, device=DEV, shardings=sh)
        torch.cuda.synchronize()
        ref = torch.load(os.path.join(ref_dir, "serve.pt"))
        out["serve_params_gb"] = torch.cuda.memory_allocated() / 1e9
        for dtype in ("float32", "bfloat16"):
            torch.cuda.synchronize()
            ops.reset_launch_counts()  # the serving path's window opens here
            res = serve.serve(cfg.replace(dtype=dtype), params, batch=PLACED_SERVE_BATCH,
                              prompt_len=PLACED_SERVE_PROMPT, gen=PLACED_SERVE_GEN,
                              seed=SERVE_SEED, device=DEV, mesh=mesh, param_shardings=sh)
            torch.cuda.synchronize()
            launches = dict(ops.launch_counts())  # ... and closes here
            want = ref[dtype]
            out[f"serve_{dtype}"] = {
                "launches": launches, "prefill_ms": res["prefill_s"] * 1e3,
                "decode_ms_per_step": res["decode_s"] * 1e3 / (PLACED_SERVE_GEN - 1),
                "tokens_equal": bool(torch.equal(res["tokens"].cpu(), want["tokens"])),
                "prefill_logits_gap": rel_l2(res["prefill_logits"].cpu(), want["prefill_logits"]),
                "last_logits_gap": rel_l2(res["last_logits"].cpu(), want["last_logits"])}
            del res
        del params
        _free()
        out["gloo_cuda"] = _placed_gloo_probe(rank, world)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        import traceback

        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _placed_spawn(tmp: str, ref_dir: str) -> list:
    """PLACED_RANKS processes on the one card over gloo; any rank's failure
    fails the run."""
    import torch.multiprocessing as mp

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_placed_rank, args=(PLACED_RANKS, os.path.join(tmp, "store"), tmp,
                                                 ref_dir),
                             nprocs=PLACED_RANKS, join=False, start_method="spawn")
    deadline = t0 + PLACED_JOIN_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.perf_counter())):
            if time.perf_counter() >= deadline:
                fail(f"the {PLACED_RANKS} placed ranks did not finish in {PLACED_JOIN_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        errors = {r: open(os.path.join(tmp, f"rank{r}.err")).read()[-3000:]
                  for r in range(PLACED_RANKS) if os.path.exists(os.path.join(tmp, f"rank{r}.err"))}
        fail(f"a placed rank failed: {e}; each rank's error: {errors}")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = []
    for r in range(PLACED_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def _placed_flash_local(errs: Errors) -> dict:
    """K5 against its plain version at (b)'s per-rank shape: 2 requests x 2
    q heads over 1 kv head of 256, 2048 tokens, both routes and windows."""
    from repro_torch.kernels import ops

    h, kvh, dh = PLACED_LOCAL_HEADS
    g = torch.Generator(device=DEV).manual_seed(78)
    base = _qkv(g, PLACED_SERVE_BATCH * kvh, h // kvh, PLACED_SERVE_PROMPT, PLACED_SERVE_PROMPT,
                dh, torch.float32)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in base)
        for window in SERVE_WINDOWS:
            atol, rtol = _flash_tol(dtype, window, 0)
            got = ops.flash_attention(q, k, v, rep=h // kvh, window=window, use_kernel="force")
            want = ops.flash_attention(q, k, v, rep=h // kvh, window=window, use_kernel="never")
            errs.check(FLASH_ROUTES[dtype], got, want, exact=False, rtol=rtol, atol=atol,
                       what=f"placed local heads {dtype} window={window}")
            out[f"{dtype} window={window}"] = float((got.float() - want.float()).abs().max())
    return out


def phase_placed(smi: str, errs: Errors) -> dict:
    """Parameters placed over the data (FSDP) and model (tensor-parallel)
    axes, PLACED_RANKS gloo ranks on the one card: (a) the DME step of
    musicgen-medium at full width, 8 layers, on (1, 2, 2), its float32
    update within PIPE_TOL of the mesh-less step's under AdamW at
    PIPE_EPS, each rank holding its shards at rest; (b) gemma3-4b at full
    width served on (1, 1, 4): float32 logits within PLACED_SERVE_TOL of
    the one-rank kernel route and the tokens equal (bf16 printed), K5 once
    an attention layer a prefill on every rank, and K5 against its plain
    version at a rank's head shape. -> the launches of every rank."""
    import tempfile

    t0 = time.perf_counter()
    _free()
    with tempfile.TemporaryDirectory() as tmp:
        ref_dir = os.path.join(tmp, "ref")
        os.makedirs(ref_dir)
        train_ref = _placed_train_ref(ref_dir)
        log(f"placed (a) mesh-less reference [{smi}] " + json.dumps(train_ref))
        serve_ref = _placed_serve_ref(ref_dir)
        log(f"placed (b) one-rank reference [{smi}] " + json.dumps(serve_ref))
        t_ref = time.perf_counter() - t0
        log(f"placed: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated in this process "
            "before the ranks start")
        ranks = _placed_spawn(tmp, ref_dir)
    t_ranks = time.perf_counter() - t0 - t_ref
    flash_local = _placed_flash_local(errs)
    n_attn = sum(spec.kind == "attn" for spec in _placed_serve_cfg().layers)
    launches = {}
    for r in ranks:
        for key in ("train_bfloat16", "train_float32"):
            _placed_launch_check(f"a {key} rank {r['rank']}", r[key]["launches"])
        for dtype, kernel in (("float32", "flash_attention_f32"),
                              ("bfloat16", "flash_attention_bf16")):
            if r[f"serve_{dtype}"]["launches"] != {kernel: n_attn}:
                fail(f"(b) rank {r['rank']} {dtype} serving launched "
                     f"{r[f'serve_{dtype}']['launches']}, not {kernel} x {n_attn}")
        for key in ("train_bfloat16", "serve_float32", "serve_bfloat16"):
            for name, n in r[key]["launches"].items():
                launches[name] = launches.get(name, 0) + n
    out = {"train_mesh": PLACED_TRAIN_MESH, "serve_mesh": PLACED_SERVE_MESH,
           "backend": "gloo", "device": "cuda:0 (all ranks)",
           "note": "four processes share one card: not a multi-card time",
           "reference_seconds": t_ref, "ranks_seconds_with_spawn": t_ranks,
           "train_reference": train_ref, "serve_reference": serve_ref,
           "flash_local_heads_max_abs_err": flash_local, "launches": launches}
    for r in ranks:
        log(f"placed rank {r['rank']} [{smi}] " + json.dumps(r))
    log(f"placed [{smi}] " + json.dumps(out))
    for r in ranks:
        a = r["train_float32"]
        if not a["max_abs_update_gap_vs_meshless"] <= PIPE_TOL:
            fail(f"(a) rank {r['rank']}: the placed float32 update differs from the mesh-less "
                 f"step's by {a['max_abs_update_gap_vs_meshless']} (limit {PIPE_TOL})")
        if not abs(a["loss"] - a["meshless_loss"]) <= 1e-5:
            fail(f"(a) rank {r['rank']}: placed loss {a['loss']} against {a['meshless_loss']}")
        for key in ("train_bfloat16", "train_float32"):
            row = r[key]
            if not row["shard_bytes_at_rest"] < row["whole_bytes_at_rest"] / 2:
                fail(f"(a) rank {r['rank']} holds {row['shard_bytes_at_rest']} bytes of "
                     f"parameters and moments, not a shard of {row['whole_bytes_at_rest']}")
            # at rest: the shards of the new state, and less than half of the
            # parameters gathered over data, which a step holds while it runs
            if not row["after_step_gb"] < row["after_step_shard_gb"] + row["gathered_gb"] / 2:
                fail(f"(a) rank {r['rank']} {key}: {row['after_step_gb']} GB allocated at rest "
                     f"against {row['after_step_shard_gb']} GB of shards (the parameters "
                     f"gathered over data: {row['gathered_gb']} GB)")
            if row["host_staged_bytes"] <= 0:
                fail(f"(a) rank {r['rank']}: gloo's collectives were not staged through the host")
        s = r["serve_float32"]
        if not (s["tokens_equal"] and s["prefill_logits_gap"] <= PLACED_SERVE_TOL
                and s["last_logits_gap"] <= PLACED_SERVE_TOL):
            fail(f"(b) rank {r['rank']}: float32 placed serving against the one-rank kernel "
                 f"route: tokens equal {s['tokens_equal']}, logits gaps "
                 f"{s['prefill_logits_gap']} / {s['last_logits_gap']} (limit {PLACED_SERVE_TOL})")
    out["seconds"] = time.perf_counter() - t0
    log(f"placed: {out['seconds']:.1f} s; launches {launches}")
    return out


# ------------------------------------- phase_hier (the hierarchical runtime)

HIER_ROUNDS = 3
HIER_JOIN_S = 600   # (c), (d): the spawned processes' deadline
HIER_CLI_DIM = 8 * 1024 * 1024  # (d): the CLI's dme width, 8,192 chunks


def _hier_spec(**rounds) -> dict:
    """The FL dme task at the estimator's full width, as a worker spec."""
    return {"task": "dme", "task_kw": {"n_clients": N_CLIENTS, "d": FL_D, "rho": RHO, "seed": 0},
            "stages": [("rand_proj_spatial", {"k": K, "d_block": D_BLOCK, "transform": "avg"})],
            "cohort": {"n_clients": N_CLIENTS}, "rounds": {"n_rounds": HIER_ROUNDS, **rounds}}


def _hier_worker(ctx, spec: dict) -> dict:
    """``round_worker`` with the kernel launches of its rounds and the
    exchange's pickled bytes and seconds."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.runtime import workers

    obs.enable()
    obs.reset()
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the rounds' window opens here
    out = workers.round_worker(ctx, spec)
    torch.cuda.synchronize()
    out["launches"] = dict(ops.launch_counts())  # ... and closes here
    snap = obs.snapshot()
    out["xpod_bytes"] = int(snap["counters"].get("runtime/xpod_bytes", 0))
    out["xpod_seconds"] = snap["histograms"].get("runtime/xpod_seconds")
    out["xpod_wait_seconds"] = snap["histograms"].get("runtime/xpod_wait_seconds")
    obs.disable()
    obs.reset()
    return out


def _hier_local(task, spec: dict) -> dict:
    """``round_worker``'s rounds in this process, on ``task`` (built once,
    as the worker builds it from ``spec``): the History arrays, the rounds'
    wall s and kernel launches."""
    from repro_torch.fl import Cohort, RoundConfig, run_rounds
    from repro_torch.kernels import ops
    from repro_torch.runtime import workers

    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the rounds' window opens here
    t0 = time.perf_counter()
    _, hist = run_rounds(task, workers.build_pipeline(spec["stages"]), Cohort(**spec["cohort"]),
                         RoundConfig(**spec["rounds"]), device=DEV)
    torch.cuda.synchronize()
    out = workers.history_arrays(hist)
    out.update(wall_s=time.perf_counter() - t0, launches=dict(ops.launch_counts()))
    return out


HIER_COLUMNS = ("metric", "mse", "mse_pop", "bytes", "n_survivors", "n_sampled", "n_stale",
                "stale_bytes", "intra_pod_bytes", "dcn_bytes", "rho_hat")  # history_arrays'


def _bitwise_history(a: dict, b: dict) -> bool:
    return all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in HIER_COLUMNS)


def phase_hier(smi: str, task) -> dict:
    """Hierarchical FL rounds (``RoundConfig(hierarchy="hier")``, runtime/)
    on the dme task at the estimator's full width (4 clients x 129,100,224
    values, rho 0.9, Rand-Proj-Spatial k 64 / 1024 / avg, 3 sync rounds):
    (a) one pod bitwise the flat rounds; (b) two pods in this process, the
    cross-pod ledger the model's and mse below Rand-k's Eq. 1; (c) two pods
    over two processes on the card (``spawn_local``), each History bitwise
    (b)'s; (d) the CLI's ``--pods 2 --hosts 2``. ``task`` is ``fl_task()``,
    which ``round_worker`` builds from ``_hier_spec()``. -> the launches of
    (b) and (c)."""
    from repro_torch.core import codec
    from repro_torch.fl import Cohort
    from repro_torch.fl import run as fl_run
    from repro_torch.runtime import PodPlan, cross_pod_traffic, spawn_local

    t0 = time.perf_counter()
    xs = task.aux["xs"]
    sumsq = sum(float((xs[i].double() ** 2).sum()) for i in range(N_CLIENTS))
    randk_mse = (D_BLOCK / K - 1.0) * sumsq / N_CLIENTS**2  # Eq. 1
    del xs
    flat = _hier_local(task, _hier_spec())
    one_pod = _hier_local(task, _hier_spec(hierarchy="hier", pods=1))
    a = {"bitwise_flat": _bitwise_history(one_pod, flat), "mse": one_pod["mse"].tolist(),
         "wall_s": {"flat": flat["wall_s"], "hier_1pod": one_pod["wall_s"]},
         "dcn_bytes": one_pod["dcn_bytes"].tolist()}
    log(f"hier (a) one pod against flat [{smi}] " + json.dumps(a))
    if not a["bitwise_flat"]:
        fail("(a) the one-pod hierarchical rounds are not the flat rounds, bitwise")
    two = _hier_local(task, _hier_spec(hierarchy="hier", pods=2))
    pipe = codec.as_pipeline(codec.RandProjSpatial(k=K, d_block=D_BLOCK, transform="avg"))
    n_chunks = -(-FL_D // D_BLOCK)
    model = cross_pod_traffic(pipe, Cohort(n_clients=N_CLIENTS), np.arange(N_CLIENTS),
                              PodPlan(N_CLIENTS, 2), n_chunks)
    b = {"mse": two["mse"].tolist(), "randk_expected_mse": randk_mse,
         "mse_flat": flat["mse"].tolist(), "dcn_bytes": two["dcn_bytes"].tolist(),
         "dcn_model": model, "bytes": two["bytes"].tolist(), "launches": two["launches"],
         "wall_s": two["wall_s"]}
    log(f"hier (b) two pods, one process [{smi}] " + json.dumps(b))
    if b["dcn_bytes"] != [model["dcn_bytes"]] * HIER_ROUNDS or model["dcn_bytes"] <= 0:
        fail(f"(b) dcn_bytes {b['dcn_bytes']} are not the model's {model['dcn_bytes']}")
    if not max(b["mse"]) < randk_mse:
        fail(f"(b) mse {b['mse']} is not below Rand-k's Eq. 1 ({randk_mse})")
    launched = dict(two["launches"])
    steps = launched.pop("srht_cg_step", 0)
    if launched != {"fwht": N_CLIENTS * HIER_ROUNDS, "srht_decode_sum": 2 * HIER_ROUNDS} or \
            not 2 * HIER_ROUNDS <= steps <= 16 * HIER_ROUNDS:
        fail(f"(b) {HIER_ROUNDS} rounds launched {two['launches']}: not K1 x {N_CLIENTS}, "
             "K3 x 2 and 2-16 CG steps a round")
    del flat, one_pod, task
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    procs = spawn_local(_hier_worker, 2, args=(_hier_spec(hierarchy="hier", pods=2),),
                        timeout_s=HIER_JOIN_S)
    c = {"seconds_with_spawn": time.perf_counter() - t1,
         "bitwise_b": [_bitwise_history(p, two) for p in procs],
         "launches": [p["launches"] for p in procs],
         "pickled_record_bytes": [p["xpod_bytes"] for p in procs],
         "exchange_seconds": [p["xpod_seconds"] for p in procs],
         "exchange_wait_seconds": [p["xpod_wait_seconds"] for p in procs],
         "wall_s": [p["wall_s"] for p in procs],
         "note": "two processes share one card and exchange through the host's store"}
    log(f"hier (c) two pods over two processes [{smi}] " + json.dumps(c))
    if not all(c["bitwise_b"]):
        fail(f"(c) the processes' Histories are not (b)'s, bitwise: {c['bitwise_b']}")
    for pid, launches in enumerate(c["launches"]):
        launched = dict(launches)
        steps = launched.pop("srht_cg_step", 0)
        if launched != {"fwht": 2 * HIER_ROUNDS, "srht_decode_sum": HIER_ROUNDS} or \
                not HIER_ROUNDS <= steps <= 8 * HIER_ROUNDS:
            fail(f"(c) process {pid} launched {launches}: not K1 x 2, K3 x 1 and 1-8 CG "
                 "steps a round (its own pod)")
    t1 = time.perf_counter()
    code = fl_run.main(["--task", "dme", "--pods", "2", "--hosts", "2", "--clients",
                        str(N_CLIENTS), "--dim", str(HIER_CLI_DIM), "--k", str(K),
                        "--d-block", str(D_BLOCK), "--rounds", str(HIER_ROUNDS)])
    d = {"exit_code": code, "seconds": time.perf_counter() - t1, "dim": HIER_CLI_DIM}
    log(f"hier (d) fl.run --pods 2 --hosts 2 [{smi}] " + json.dumps(d))
    if code != 0:
        fail(f"(d) the CLI exited {code}")
    launches = dict(two["launches"])
    for p in c["launches"]:
        for name, n in p.items():
            launches[name] = launches.get(name, 0) + n
    out = {"a": a, "b": b, "c": c, "d": d, "launches": launches,
           "seconds": time.perf_counter() - t0}
    log(f"hier: {out['seconds']:.1f} s; launches {launches}")
    return out

# ----------------------------------------------------------- phase_fl (FL)

FL_D = MAMBA2_130M_PARAMS   # the dme task's width: mamba2-130m's parameter count
FL_BYTES = UNQUANTIZED_BYTES  # a client's Rand-Proj-Spatial payload at that width
FL_SYNC_ROUNDS, FL_ASYNC_ROUNDS = 3, 4
FL_ASYNC_SEED = 9     # Cohort(4, dropout=0.25): stragglers in rounds 0-2, admitted in 1-3
FL_OVERLAP_TILE, FL_OWNERS = 8192, 4
FL_SMALL_D = 256      # (f): the card against the CPU


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _clocked(task, marks: list):
    """``task`` with a CUDA event and the launch counts taken where each
    round starts (its client vectors) and ends (its task step)."""
    import dataclasses

    from repro_torch.kernels import ops

    def client_vectors(state, key):
        marks.append(("start", _event(), ops.launch_counts()))
        return task.client_vectors(state, key)

    def step(state, mean):
        out = task.step(state, mean)
        marks.append(("end", _event(), ops.launch_counts()))
        return out

    return dataclasses.replace(task, client_vectors=client_vectors, step=step)


def _clock_codec(marks: list):
    """Patch ``Pipeline.encode_all`` and ``Pipeline.decode_payload`` (which
    every decode route calls: whole, streamed tile, owner slice) to append
    (name, event before, event after) to ``marks``; -> the restore function."""
    from repro_torch.core import codec

    saved = {name: getattr(codec.Pipeline, name) for name in ("encode_all", "decode_payload")}

    def timed(name, fn):
        def call(self, *args, **kw):
            before = _event()
            out = fn(self, *args, **kw)
            marks.append((name, before, _event()))
            return out
        return call

    for name, fn in saved.items():
        setattr(codec.Pipeline, name, timed(name, fn))

    def restore():
        for name, fn in saved.items():
            setattr(codec.Pipeline, name, fn)
    return restore


def _fl_rounds(task, spec, cohort=None, clocked=False, **cfg) -> tuple:
    """(final state, History, per-round rows) of ``run_rounds`` on the card;
    with ``clocked``, each row has the round's wall ms (CUDA events from its
    client vectors to its task step), the ms of the encode_all and decode
    calls inside it, and its kernel launches."""
    from repro_torch.fl import rounds as fl_rounds

    marks: list = []
    restore = _clock_codec(marks) if clocked else None
    try:
        state, hist = fl_rounds.run_rounds(_clocked(task, marks) if clocked else task, spec,
                                           cohort, fl_rounds.RoundConfig(**cfg), device=DEV)
        torch.cuda.synchronize()
    finally:
        if restore:
            restore()
    rows, cur = [], None
    for mark in marks:
        if mark[0] == "start":
            cur = {"start": mark[1], "counts": mark[2], "codec_ms": 0.0, "calls": []}
        elif mark[0] == "end":
            launches = {k: v - cur["counts"].get(k, 0) for k, v in mark[2].items()
                        if v != cur["counts"].get(k, 0)}
            rows.append({"round": len(rows), "wall_ms": cur["start"].elapsed_time(mark[1]),
                         "encode_decode_ms": cur["codec_ms"], "calls": cur["calls"],
                         "launches": launches})
        else:
            cur["codec_ms"] += mark[1].elapsed_time(mark[2])
            cur["calls"].append(mark[0])
    for r in rows:
        r["fl_overhead_ms"] = r["wall_ms"] - r["encode_decode_ms"]
    return state, hist, rows


def _fl_spec(use_kernel: str = "auto", **kw):
    from repro_torch.core import codec

    return codec.build("rand_proj_spatial", k=K, d_block=D_BLOCK, transform="avg",
                       use_kernel=use_kernel, **kw)


def _fl_sync(task, smi: str) -> dict:
    """(a) 3 sync rounds at full width: ledger, launches a round, error
    against Rand-k's Eq. 1, gap to the plain path; round wall ms beside the
    encode_all + decode inside it."""
    from repro_torch.kernels import ops

    xs = task.aux["xs"]
    sumsq = sum(float((xs[i].double() ** 2).sum()) for i in range(N_CLIENTS))
    randk_mse = (D_BLOCK / K - 1.0) * sumsq / N_CLIENTS**2  # Eq. 1
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the FL path's window opens here
    state, hist, rows = _fl_rounds(task, _fl_spec(), clocked=True, n_rounds=FL_SYNC_ROUNDS)
    window = ops.launch_counts()  # ... and closes here
    p_state, p_hist, _ = _fl_rounds(task, _fl_spec("never"), n_rounds=FL_SYNC_ROUNDS)
    gap = rel_l2(state["mean"], p_state["mean"])
    mse_gap = max(abs(a - b) / b for a, b in zip(hist.mse, p_hist.mse))
    for r, mse, nbytes in zip(rows, hist.mse, hist.bytes):
        r.update(mse=mse, bytes=nbytes, randk_expected_mse=randk_mse)
        del r["calls"]
        log(f"fl (a) sync round [{smi}] " + json.dumps(r))
    out = {"rows": rows, "mse": hist.mse, "state": state, "randk_mse": randk_mse,
           "rel_gap_vs_plain_on_card": gap, "mse_rel_gap_vs_plain": mse_gap,
           "launches": dict(window)}
    log(f"fl (a): gap to the plain path on the card {gap} (mse {mse_gap}); launches in the "
        f"window {dict(window)}")
    # where one FL round's time goes (torch.profiler), beside the bare
    # collective's round that phase_profile reads on the same shapes
    by_name, wall_ms, _ = _profiled(lambda: _fl_rounds(task, _fl_spec(), n_rounds=1))
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out["profile"] = {"wall_ms": wall_ms, "device_ms": device_ms,
                      "idle_share": 1.0 - device_ms / wall_ms,
                      "top_device_ms": [[name[:160], ms] for name, ms in top]}
    log(f"fl (a) profiled round [{smi}] " + json.dumps(out["profile"]))
    if hist.bytes != [N_CLIENTS * FL_BYTES] * FL_SYNC_ROUNDS:
        fail(f"(a) bytes a round {hist.bytes}, not {N_CLIENTS} x {FL_BYTES}")
    for r in rows:
        launched = dict(r["launches"])
        steps = launched.pop("srht_cg_step", 0)
        if launched != {"fwht": N_CLIENTS, "srht_decode_sum": 1} or not 1 <= steps <= 8:
            fail(f"(a) round {r['round']} launched {r['launches']}: not K1 x {N_CLIENTS}, "
                 "K3 x 1 and 1-8 CG steps, and no K4 alone")
        if not r["mse"] < randk_mse:
            fail(f"(a) round {r['round']}: mse {r['mse']} is not below Rand-k's {randk_mse}")
    if not (gap <= 1e-3 and mse_gap <= 1e-3) or not torch.isfinite(state["mean"]).all():
        fail(f"(a) the kernel and plain rounds differ by {gap} (mse {mse_gap})")
    return out


def _fl_async(task, smi: str) -> dict:
    """(b) 4 async rounds at full width, Cohort(4, dropout=0.25): the ledger
    identity, admitted stragglers, finite means; mse_pop beside staleness 0."""
    from repro_torch.fl import Cohort

    cohort = Cohort(N_CLIENTS, dropout=0.25)
    runs = {}
    for staleness in (1, 0):
        state, hist, rows = _fl_rounds(task, _fl_spec(), cohort, clocked=True,
                                       n_rounds=FL_ASYNC_ROUNDS, async_rounds=True,
                                       staleness=staleness, seed=FL_ASYNC_SEED)
        runs[staleness] = hist
        for r in rows:
            t = r["round"]
            r.update(staleness=staleness, survivors=hist.n_survivors[t],
                     n_stale=hist.n_stale[t], bytes=hist.bytes[t],
                     stale_bytes=hist.stale_bytes[t], mse=hist.mse[t], mse_pop=hist.mse_pop[t])
            del r["calls"], r["launches"]
            log(f"fl (b) async round [{smi}] " + json.dumps(r))
        if not (all(np.isfinite(hist.mse + hist.mse_pop)) and torch.isfinite(state["mean"]).all()):
            fail(f"(b) staleness {staleness}: a mean is not finite")
    hist = runs[1]
    fresh = [s * FL_BYTES for s in hist.n_survivors]
    if hist.bytes != [f + st for f, st in zip(fresh, hist.stale_bytes)]:
        fail(f"(b) bytes {hist.bytes} != fresh {fresh} + stale {hist.stale_bytes}")
    if not any(n > 0 for n in hist.n_stale[1:]) or runs[0].n_stale != [0] * FL_ASYNC_ROUNDS:
        fail(f"(b) admitted stragglers by round {hist.n_stale} (staleness 0: "
             f"{runs[0].n_stale}); seed {FL_ASYNC_SEED} has stragglers in rounds 0-2")
    out = {"mse_pop": hist.mse_pop, "mse_pop_staleness0": runs[0].mse_pop,
           "n_stale": hist.n_stale, "stale_bytes": hist.stale_bytes}
    log(f"fl (b) [{smi}] " + json.dumps(out))
    return out


def _fl_overlap_ownership(task, sync: dict, smi: str) -> dict:
    """(c) (a) again with the overlapped stream and with 4 owners: History
    and the final state bitwise equal to (a)'s; the ownership ledger."""
    from repro_torch.dist import collectives

    out = {}
    for name, cfg in (("overlap", dict(overlap=True, overlap_tile=FL_OVERLAP_TILE)),
                      ("ownership", dict(ownership=True, n_owners=FL_OWNERS))):
        state, hist, rows = _fl_rounds(task, _fl_spec(), clocked=True,
                                       n_rounds=FL_SYNC_ROUNDS, **cfg)
        same = hist.mse == sync["mse"] and torch.equal(state["mean"], sync["state"]["mean"])
        out[name] = {"bitwise": same, "wall_ms": [r["wall_ms"] for r in rows],
                     "encode_decode_ms": [r["encode_decode_ms"] for r in rows],
                     "launches": [r["launches"] for r in rows],
                     "intra_pod_bytes": hist.intra_pod_bytes}
        log(f"fl (c) {name} [{smi}] " + json.dumps(out[name]))
        if not same:
            fail(f"(c) {name}: mse {hist.mse} and the final state are not bitwise (a)'s "
                 f"{sync['mse']}")
    n_chunks = -(-FL_D // D_BLOCK)
    traffic = collectives.intra_pod_traffic(
        _fl_spec(), N_CLIENTS, n_chunks, FL_OWNERS,
        plan=collectives.ownership_plan(FL_OWNERS, n_chunks, FL_OWNERS))
    out["traffic"] = traffic
    log(f"fl (c) modelled intra-pod bytes a round at {FL_OWNERS} owners [{smi}] "
        + json.dumps(traffic))
    if out["ownership"]["intra_pod_bytes"] != [traffic["intra_pod_bytes_ownership"]] * \
            FL_SYNC_ROUNDS or not traffic["intra_pod_bytes_ownership"] > 0:
        fail(f"(c) ownership ledgered {out['ownership']['intra_pod_bytes']}, not the "
             f"ownership column {traffic['intra_pod_bytes_ownership']} a round")
    return out


def _fl_temporal(smi: str) -> dict:
    """(d) temporal against spatial on drift at tests/test_fl.py's sizes
    (n k = d, the regime where the broadcast delta decodes), on the card."""
    from repro_torch.core import codec
    from repro_torch.fl import get_task

    task = get_task("drift", device=DEV, n_clients=8, d=128, rho=0.95, omega=0.03)
    spec = codec.build("rand_proj_spatial", k=16, d_block=128, transform="avg")
    _, h_sp, _ = _fl_rounds(task, spec, n_rounds=20)
    _, h_tm, _ = _fl_rounds(task, spec, n_rounds=20, temporal=True)
    out = {"spatial_mse_2_19": float(np.mean(h_sp.mse[2:])),
           "temporal_mse_2_19": float(np.mean(h_tm.mse[2:])), "bytes": h_sp.total_bytes}
    out["ratio"] = out["temporal_mse_2_19"] / out["spatial_mse_2_19"]
    log(f"fl (d) temporal vs spatial on drift [{smi}] " + json.dumps(out))
    if h_sp.bytes != h_tm.bytes or not out["ratio"] < 0.7:
        fail(f"(d) temporal/spatial mse {out['ratio']} (limit 0.7), ledgers "
             f"{h_tm.total_bytes} / {h_sp.total_bytes}")
    return out


def _fl_cli(smi: str) -> dict:
    """(e) the CLI's --compare on power_iteration, 20 rounds, at its default
    sizes (d = 1024, 4000 samples, 10 clients), on the card."""
    import tempfile

    from repro_torch import obs
    from repro_torch.fl import run as fl_run

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "metrics.json")
        t0 = time.perf_counter()
        if fl_run.main(["--task", "power_iteration", "--compare", "--rounds", "20",
                        "--metrics-json", path]) != 0:
            fail("(e) the CLI's --compare did not exit 0")
        seconds = time.perf_counter() - t0
        with open(path) as f:
            data = json.load(f)
    obs.disable()
    obs.reset()
    out = {r["estimator"]: {"final_eig_err": r["rounds"][-1]["metric"],
                            "total_bytes": sum(x["bytes"] for x in r["rounds"])}
           for r in data["runs"]}
    log(f"fl (e) CLI --compare power_iteration, 20 rounds, {seconds:.1f} s on "
        f"{data['run']['device']} [{smi}] " + json.dumps(out))
    if len(out) != 4 or not all(np.isfinite(v["final_eig_err"]) for v in out.values()):
        fail(f"(e) the CLI's compare gave {out}")
    return out


# (g): the launch-count name of each op that kernels/dispatch labels
DISPATCH_LAUNCHES = {"fwht": "fwht", "srht_encode": "fwht", "srht_decode": "fwht",
                     "srht_encode_batch": "fwht_rowsigns", "srht_decode_sum": "srht_decode_sum",
                     "srht_gram_apply": "srht_gram_apply", "srht_cg_step": "srht_cg_step"}


def _labels(key: str) -> dict:
    """{"op": ..., "route": ...} of a ``component/name{k=v,...}`` key."""
    inner = key[key.index("{") + 1:-1]
    return dict(item.split("=", 1) for item in inner.split(","))


def _fl_cli_profile(smi: str) -> dict:
    """(g) the CLI on the dme task at the estimator's width (the phase's
    spec: k 64, d_block 1024, avg) for 3 sync rounds with --profile-dir and
    --metrics-json; counts zeroed just before and read just after. The trace
    must name K1's, K3's and the CG step's kernels; kernels/dispatch must
    count the kernel route alone for the SRHT ops, as often as they launched;
    kernels/decode_route fused once a round; kernels/cg_iters one sample a
    decode, each decode's CG steps launched its count rounded up to the host
    check's 8."""
    import glob
    import tempfile

    from repro_torch import obs
    from repro_torch.fl import run as fl_run
    from repro_torch.kernels import ops

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        prof_dir, path = os.path.join(tmp, "profile"), os.path.join(tmp, "metrics.json")
        torch.cuda.synchronize()
        ops.reset_launch_counts()  # the CLI's window opens here
        t0 = time.perf_counter()
        rc = fl_run.main(["--task", "dme", "--dim", str(FL_D), "--clients", str(N_CLIENTS),
                          "--rho", str(RHO), "--k", str(K), "--d-block", str(D_BLOCK),
                          "--rounds", str(FL_SYNC_ROUNDS), "--profile-dir", prof_dir,
                          "--metrics-json", path])
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()  # ... and closes here
        obs.disable()
        obs.reset()
        traces = glob.glob(os.path.join(prof_dir, "*.json"))
        trace_bytes = sum(os.path.getsize(t) for t in traces)
        kernels = set()
        for t in traces:
            with open(t) as f:
                kernels |= {ev.get("name", "") for ev in json.load(f).get("traceEvents", [])
                            if ev.get("cat") == "kernel"}
        with open(path) as f:
            metrics = json.load(f)["runs"][0]["metrics"]
    if rc != 0:
        fail(f"(g) the CLI exited {rc}")
    named = {name: sorted(k[:80] for k in kernels if kernel in k)
             for name, (_, kernel, _) in BUTTERFLY_KERNELS.items() if name != "srht_gram_apply"}
    dispatch = {}
    for key, v in metrics["counters"].items():
        if key.startswith("kernels/dispatch{"):
            lab = _labels(key)
            dispatch[lab["op"], lab["route"]] = int(v)
    routes = {k: v for k, v in metrics["counters"].items()
              if k.startswith("kernels/decode_route")}
    cg = metrics["histograms"].get("kernels/cg_iters", {})
    out = {"seconds": seconds, "traces": len(traces), "trace_mb": trace_bytes / 1e6,
           "kernels_named": named, "launches": dict(launches),
           "dispatch": {f"{op}/{route}": v for (op, route), v in sorted(dispatch.items())},
           "decode_route": routes, "cg_iters": cg}
    log(f"fl (g) CLI --profile-dir --metrics-json, {FL_SYNC_ROUNDS} rounds of {N_CLIENTS} x "
        f"{FL_D} [{smi}] " + json.dumps(out))
    if len(traces) != 1 or not all(named.values()):
        fail(f"(g) {len(traces)} trace files; kernels named in them {named}")
    plain = sorted(op for op, route in dispatch if route != "kernel" and op in DISPATCH_LAUNCHES)
    if plain:
        fail(f"(g) SRHT ops took the plain route: {plain}")
    by_launch = {}
    for (op, _), v in dispatch.items():
        if op in DISPATCH_LAUNCHES:
            by_launch[DISPATCH_LAUNCHES[op]] = by_launch.get(DISPATCH_LAUNCHES[op], 0) + v
    if by_launch != {k: v for k, v in launches.items() if v}:
        fail(f"(g) kernels/dispatch counts {by_launch}, the wrappers launched {launches}")
    if routes != {"kernels/decode_route{estimator=rand_proj_spatial,method=fused}":
                  FL_SYNC_ROUNDS}:
        fail(f"(g) decode routes {routes}, not fused once a round")
    steps = launches.get("srht_cg_step", 0)
    if cg.get("count") != FL_SYNC_ROUNDS or not cg["sum"] <= steps <= cg["sum"] + 7 * cg["count"]:
        fail(f"(g) cg_iters {cg} against {steps} CG steps launched")
    return out


def _fl_small_configs() -> dict:
    from repro_torch.core import codec

    return {
        "rps_avg": codec.build("rand_proj_spatial", k=16, d_block=64, transform="avg"),
        "rps_wavg": codec.build("rand_proj_spatial", k=16, d_block=64, transform="wavg"),
        "top_k_ef_temporal": codec.build("top_k", k=8, d_block=64, ef=True, temporal=True),
    }


def _fl_card_vs_cpu(smi: str) -> dict:
    """(f) a small FL run on the card and on the CPU: ledgers equal, floats
    within 1e-4, top_k's final mean and client state bitwise (no reduction
    order differs there)."""
    from repro_torch.fl import get_task, run_rounds, RoundConfig

    gaps = {}
    for name, spec in _fl_small_configs().items():
        got, want = ({"hist": h, "state": s} for s, h in [
            run_rounds(get_task("dme", device=dev, n_clients=N_CLIENTS, d=FL_SMALL_D), spec,
                       cfg=RoundConfig(n_rounds=4), device=dev) for dev in (DEV, "cpu")])
        hg, hw = got["hist"], want["hist"]
        for col in ("bytes", "coded_bytes", "n_survivors", "n_stale", "intra_pod_bytes"):
            if getattr(hg, col) != getattr(hw, col):
                fail(f"(f) {name}: {col} {getattr(hg, col)} on the card, {getattr(hw, col)} "
                     "on the CPU")
        gap = max(abs(a - b) / max(abs(b), 1e-30) for col in ("mse", "mse_pop")
                  for a, b in zip(getattr(hg, col), getattr(hw, col)))
        rho = [abs(a - b) for a, b in zip(hg.rho_hat, hw.rho_hat) if b == b]
        mean_gap = rel_l2(got["state"]["mean"].cpu(), want["state"]["mean"])
        gaps[name] = {"history": gap, "rho_hat": max(rho, default=0.0), "mean": mean_gap}
        if name == "top_k_ef_temporal":
            cs_g, cs_w = hg.client_state, hw.client_state
            gaps[name]["bitwise"] = (torch.equal(got["state"]["mean"].cpu(), want["state"]["mean"])
                                     and torch.equal(cs_g.ef.cpu(), cs_w.ef)
                                     and torch.equal(cs_g.memory.cpu(), cs_w.memory))
            if not gaps[name]["bitwise"]:
                fail(f"(f) {name}: the final mean or client state differs from the CPU's")
        if not max(gap, mean_gap, gaps[name]["rho_hat"]) <= 1e-4:
            fail(f"(f) {name}: card and CPU differ by {gaps[name]} (limit 1e-4)")
    log(f"fl (f) small dme card vs CPU [{smi}] " + json.dumps(gaps))
    return gaps


def fl_task():
    """The dme task at the estimator's full width that ``phase_fl`` and
    ``phase_hier`` run (built once for both)."""
    from repro_torch.fl import get_task

    t0 = time.perf_counter()
    task = get_task("dme", device=DEV, n_clients=N_CLIENTS, d=FL_D, rho=RHO, seed=0)
    torch.cuda.synchronize()
    log(f"fl: dme task of {N_CLIENTS} x {FL_D} values built in "
        f"{time.perf_counter() - t0:.1f} s (host numpy, then one copy to the card)")
    return task


def phase_fl(smi: str, task) -> dict:
    """The federated round driver on the card: (a)-(c) at full width on the
    dme task ``task`` (``fl_task()``), (d) temporal on drift, (e) the CLI,
    (f) the card against the CPU. Fatal on any failed check."""
    from repro_torch.core import beta as beta_lib

    start = t0 = time.perf_counter()  # the banks of every survivor count, outside the timed rounds
    for n in range(1, N_CLIENTS + 1):
        beta_lib.srht_eig_bank(n, K, D_BLOCK, device=DEV)
    torch.cuda.synchronize()
    log(f"fl: eigenvalue banks for 1-{N_CLIENTS} clients ready in "
        f"{time.perf_counter() - t0:.3f} s")
    out = {"a": _fl_sync(task, smi)}
    out["b"] = _fl_async(task, smi)
    out["c"] = _fl_overlap_ownership(task, out["a"], smi)
    del task
    out["d"] = _fl_temporal(smi)
    out["e"] = _fl_cli(smi)
    out["f"] = _fl_card_vs_cpu(smi)
    out["g"] = _fl_cli_profile(smi)
    log(f"fl: phase done in {time.perf_counter() - start:.1f} s")
    return out


# ------------------------------------------------------ phase_train (training)

# (a): musicgen-medium (src/repro/configs/musicgen_medium.py) at full width,
# 24 of its 48 layers: 4 clients at 48 layers would hold about 89 GB
TRAIN_ARCH, TRAIN_PRESET, TRAIN_BLOCKS = "musicgen-medium", "full", 24
TRAIN_PARAMS = 685_843_968
TRAIN_BATCH, TRAIN_SEQ = 4, 128       # the training CLI's defaults, per client
TRAIN_TIMED_STEPS = 5
TRAIN_PLAIN_TILE = 65536   # chunks a tile of the plain reference's stream
TRAIN_CG_STEPS = (1, 64)   # the decode's CG launches a step: at least one, at most cg_iters
# (b): the CLI at its default arch (mamba2-130m) and preset: at "small"
# (musicgen-medium's 31,465,984 parameters) the loss rises over 60 steps of
# 16x compressed gradients in both packages
TRAIN_CLI_ARCH, TRAIN_CLI_PRESET = "mamba2-130m", "tiny"
TRAIN_CLI_STEPS, TRAIN_CLI_RESUME_STEPS = 60, 70
TRAIN_CLI_FAIL, TRAIN_CLI_RESIZE = 20, (40, 3)
# (c): tiny configs on the card and the CPU
TRAIN_SMALL_ARCHS = ("musicgen-medium", "gemma3-4b", "mamba2-130m", "deepseek-moe-16b",
                     "jamba-v0.1-52b")
TRAIN_SMALL_STEPS = 3
# (d): mamba2-130m at full width, nothing cut: 1024 tokens are 4 SSD chunks
# of 256, so the cross-chunk recurrence and its backward run
TRAIN_MAMBA_ARCH, TRAIN_MAMBA_SEQ = "mamba2-130m", 1024


def _train_spec(use_kernel: str = "auto"):
    from repro_torch.core import codec

    return codec.build("rand_proj_spatial", k=K, d_block=D_BLOCK, transform="avg",
                       use_kernel=use_kernel)


def _train_opt(**kw):
    from repro_torch.optim import AdamW

    return AdamW(lr=3e-3, warmup_steps=20, **kw)  # the training CLI's


class _ClockedOptimizer:
    """An optimizer whose ``update`` appends ("optimizer", event before,
    event after) to ``marks``."""

    def __init__(self, inner, marks: list):
        self.inner, self.marks = inner, marks

    def init(self, params):
        return self.inner.init(params)

    def update(self, *args):
        before = _event()
        out = self.inner.update(*args)
        self.marks.append(("optimizer", before, _event()))
        return out


def _clock_collective(marks: list, finite: list):
    """Patch ``dist.collectives.compressed_mean_tree`` (which the train step
    calls through the module) to append ("compressed_mean_tree", event
    before, event after) to ``marks``, and after it to ``finite`` a device
    tensor of one flag a leaf of its stacked client gradients: all finite
    (read after the step, so nothing syncs inside it); -> the restore
    function."""
    from repro_torch.dist import collectives

    saved = collectives.compressed_mean_tree

    def call(spec, key, tree, *args, **kw):
        before = _event()
        out = saved(spec, key, tree, *args, **kw)
        marks.append(("compressed_mean_tree", before, _event()))
        finite.append(torch.stack([torch.isfinite(leaf).all() for leaf in _leaves(tree)]))
        return out

    collectives.compressed_mean_tree = call
    return lambda: setattr(collectives, "compressed_mean_tree", saved)


def _tree_sq(tree) -> float:
    return sum(float((leaf.double() ** 2).sum()) for leaf in _leaves(tree))


def _update_gap(old, new_a, new_b) -> float:
    """Relative L2 gap between two updates of ``old``: |b - a| / |b - old|."""
    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(_leaves(new_a), _leaves(new_b)))
    den = sum(float(((b.double() - o.double()) ** 2).sum())
              for o, b in zip(_leaves(old), _leaves(new_b)))
    return (num / max(den, 1e-300)) ** 0.5


def _flash_refusal() -> None:
    """K5's kernel route on tensors that require grad must raise, and
    launch nothing; no K5 backward exists in either package."""
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    g = torch.Generator(device=DEV).manual_seed(3)
    for dtype in FLASH_ROUTES:
        q, k, v = (torch.randn((2, TRAIN_SEQ, 64), generator=g, device=DEV).to(dtype)
                   for _ in range(3))
        for t in (q, k, v):
            t.requires_grad_()
        try:
            ops.flash_attention(q, k, v, rep=1)
        except NotImplementedError as e:
            if "ROADMAP A.11" not in str(e):
                fail(f"(a) K5's refusal does not name ROADMAP A.11: {e}")
        else:
            fail(f"(a) K5's kernel route ran on {dtype} tensors that require grad")
    if ops.launch_counts() != before:
        fail("(a) K5's refused calls launched a kernel")


def _aten_ops(fn) -> int:
    """The aten ops that one call of ``fn`` dispatches (each a host round
    trip through PyTorch's dispatcher)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _train_cell(smi: str, tag: str, cfg, n_params: int, seq: int, gap_limit: float) -> dict:
    """One full-width training cell, 4 clients: a warm step and 5 timed ones
    through ``make_train_step``, each split into the clients' forward and
    backward, compressed_mean_tree and the optimizer; launches a step; one
    profiled step; then one more step from the same state with the kernels
    and through the plain versions (update gap within ``gap_limit``). Every
    stacked client gradient leaf of every step must be finite."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.train import init_train_state, make_train_step

    if cfg.n_params() != n_params:
        fail(f"({tag}) {cfg.name} at {cfg.n_blocks} blocks has {cfg.n_params()} parameters, "
             f"not {n_params}")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=DEV)
    opt, marks, finite = _train_opt(), [], []
    state = init_train_state(cfg, opt, params, _train_spec(), N_CLIENTS)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, batch=TRAIN_BATCH,
                       n_clients=N_CLIENTS, seed=0)
    step_fn = make_train_step(cfg, _ClockedOptimizer(opt, marks), dme_spec=_train_spec(),
                              device=DEV)
    torch.cuda.synchronize()
    log(f"train ({tag}): {cfg.name}, {cfg.n_blocks} blocks, {cfg.n_params()} float32 "
        f"parameters, {cfg.dtype} compute, remat {cfg.remat}, {N_CLIENTS} clients x batch "
        f"{TRAIN_BATCH} x {seq} tokens; state built in {time.perf_counter() - t0:.1f} s")
    rows = []
    restore = _clock_collective(marks, finite)
    try:
        for step in range(1 + TRAIN_TIMED_STEPS):
            batch = data.batch_at(step, DEV)
            if step == 1:  # the timed steps' window opens here
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
            marks.clear()
            counts = ops.launch_counts()
            start = _event()
            new_params, new_state, metrics = step_fn(params, state, batch, step)
            end = _event()
            torch.cuda.synchronize()
            if step == 0:
                unchanged = [i for i, (a, b) in enumerate(zip(_leaves(params),
                                                              _leaves(new_params)))
                             if torch.equal(a, b)]
                if unchanged:
                    fail(f"({tag}) the first step left parameter leaves {unchanged} unchanged: "
                         "a gradient skipped them")
            params, state = new_params, new_state
            spans = {name: before.elapsed_time(after) for name, before, after in marks}
            row = {"step": step, "wall_ms": start.elapsed_time(end),
                   "fwd_bwd_ms": start.elapsed_time(
                       {name: before for name, before, _ in marks}["compressed_mean_tree"]),
                   "compressed_mean_tree_ms": spans["compressed_mean_tree"],
                   "optimizer_ms": spans["optimizer"],
                   **{k: float(v) for k, v in metrics.items()},
                   "launches": {k: v - counts.get(k, 0) for k, v in ops.launch_counts().items()
                                if v != counts.get(k, 0)}}
            bad = [i for i, ok in enumerate(finite.pop().tolist()) if not ok]
            if bad:
                fail(f"({tag}) step {step}: client gradient leaves {bad} are not finite")
            if step > 0:
                row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rows.append(row)
            log(f"train ({tag}) step [{smi}] " + json.dumps(row))
    finally:
        restore()
    window = ops.launch_counts()  # ... and closes here
    for r in rows:
        if not np.isfinite(r["loss"]):
            fail(f"({tag}) step {r['step']}: loss {r['loss']}")
        if r["step"] == 0:
            continue
        launched = dict(r["launches"])
        steps = launched.pop("srht_cg_step", 0)
        lo, hi = TRAIN_CG_STEPS
        if launched != {"fwht": N_CLIENTS, "srht_decode_sum": 1} or not lo <= steps <= hi:
            fail(f"({tag}) step {r['step']} launched {r['launches']}: not K1 x {N_CLIENTS}, "
                 f"K3 x 1 and {lo}-{hi} CG steps, and no K4 alone nor K5")
    # one more step from the same state: with the kernels, and through the
    # plain versions, streamed in tiles (bit-identical to the whole
    # exchange) so that their (n, C, d) temporaries fit beside the state
    step = 1 + TRAIN_TIMED_STEPS
    batch = data.batch_at(step, DEV)
    # where one step's time goes: device time by kernel against its wall time
    by_name, wall_ms, _ = _profiled(lambda: step_fn(params, state, batch, step))
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    profile = {"wall_ms": wall_ms, "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
               "top_device_ms": [[name[:160], ms] for name, ms in top]}
    log(f"train ({tag}) profiled step [{smi}] " + json.dumps(profile))
    profile["aten_ops"] = _aten_ops(lambda: step_fn(params, state, batch, step))
    log(f"train ({tag}): one step dispatches {profile['aten_ops']} aten ops from the host")
    kernel = make_train_step(cfg, opt, dme_spec=_train_spec(), device=DEV)(
        params, state, batch, step)
    kernel_params, k_metrics = kernel[0], kernel[2]
    del kernel  # its optimizer state: 8 bytes a parameter
    plain = make_train_step(cfg, opt, dme_spec=_train_spec("never"), dme_overlap=True,
                            dme_overlap_tile=TRAIN_PLAIN_TILE, device=DEV)(
        params, state, batch, step)
    plain_params, p_metrics = plain[0], plain[2]
    del plain
    torch.cuda.synchronize()
    gap = _update_gap(params, kernel_params, plain_params)
    timed = rows[1:]
    out = {"params": cfg.n_params(), "rows": rows, "launches": dict(window),
           "profile": profile, "update_gap_vs_plain_on_card": gap,
           "loss_kernel_vs_plain": [float(k_metrics["loss"]), float(p_metrics["loss"])],
           "peak_gb": max(r["peak_gb"] for r in timed),
           "median_ms": {key: statistics.median(r[key] for r in timed) for key in
                         ("wall_ms", "fwd_bwd_ms", "compressed_mean_tree_ms", "optimizer_ms")}}
    log(f"train ({tag}) [{smi}] " + json.dumps({k: v for k, v in out.items()
                                               if k not in ("rows", "profile")}))
    if not gap <= gap_limit:
        fail(f"({tag}) one step's update with the kernels and through the plain versions "
             f"differ by {gap} (limit {gap_limit})")
    return out


def _train_full_width(smi: str) -> dict:
    """(a) musicgen-medium at full width, 24 of its 48 layers, 128 tokens;
    first K5's refusal under grad."""
    from repro_torch import configs

    _flash_refusal()
    cfg = configs.preset_config(TRAIN_ARCH, TRAIN_PRESET).replace(n_blocks=TRAIN_BLOCKS)
    return _train_cell(smi, "a", cfg, TRAIN_PARAMS, TRAIN_SEQ, 1e-3)


def _train_mamba(smi: str) -> dict:
    """(d) mamba2-130m at full width, nothing cut, 1024 tokens (4 SSD chunks
    of 256): its parameter tree is the estimator phases' tree; every client
    gradient leaf must be finite in every step."""
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.preset_config(TRAIN_MAMBA_ARCH, "full")

    def meta(node):  # a tree of shapes as meta tensors
        return {k: meta(v) for k, v in node.items()} if isinstance(node, dict) else \
            torch.empty(node, device="meta")

    shapes = [tuple(t.shape) for t in _leaves(transformer.map_defs(
        lambda d: torch.empty(d.shape, device="meta"), transformer.param_defs(cfg)))]
    if shapes != [tuple(t.shape) for t in _leaves(meta(MAMBA2_130M_LEAVES))]:
        fail(f"(d) {cfg.name}'s parameter shapes {shapes} are not the estimator tree's")
    if cfg.mamba_chunk * 4 != TRAIN_MAMBA_SEQ:
        fail(f"(d) {TRAIN_MAMBA_SEQ} tokens are not 4 SSD chunks of {cfg.mamba_chunk}")
    return _train_cell(smi, "d", cfg, MAMBA2_130M_PARAMS, TRAIN_MAMBA_SEQ, 1e-6)


class _Tee:
    """A text stream writing to several."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _train_cli_run(argv: list) -> tuple:
    """(history, printed text) of ``launch.train.main(argv)``, its final
    checkpoint's save timed."""
    import contextlib
    import io

    from repro_torch.launch import train as train_cli
    from repro_torch.train import checkpoint as ckpt_lib

    saved, saves = ckpt_lib.save, []

    def timed_save(ckpt_dir, step, tree, **kw):
        t0 = time.perf_counter()
        path = saved(ckpt_dir, step, tree, **kw)
        saves.append({"step": step, "s": time.perf_counter() - t0,
                      "bytes": sum(os.path.getsize(os.path.join(path, f))
                                   for f in os.listdir(path))})
        return path

    buf = io.StringIO()
    ckpt_lib.save = timed_save
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            hist = train_cli.main(argv)
    finally:
        ckpt_lib.save = saved
    return hist, buf.getvalue(), saves[-1]


def _train_cli(smi: str) -> dict:
    """(b) the CLI (launch.train.main) on the card at its default arch
    (mamba2-130m) and preset, 4 clients, a failure injected and recovered
    from a checkpoint, an elastic resize to 3 clients; then the same command
    with more steps resumes from the last checkpoint."""
    import tempfile

    from repro_torch.train import checkpoint as ckpt_lib

    fail_at, (resize_at, resize_to) = TRAIN_CLI_FAIL, TRAIN_CLI_RESIZE
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        argv = ["--preset", TRAIN_CLI_PRESET, "--clients", str(N_CLIENTS),
                "--ckpt-every", "10", "--ckpt-dir", tmp]  # the default arch
        t0 = time.perf_counter()
        hist, text, final = _train_cli_run(argv + [
            "--steps", str(TRAIN_CLI_STEPS), "--inject-failures", str(fail_at),
            "--resize", f"{resize_at}:{resize_to}"])
        seconds = time.perf_counter() - t0
        ck = os.path.join(tmp, f"{TRAIN_CLI_ARCH}_{TRAIN_CLI_PRESET}")
        if not hist or not hist[-1][1] < hist[0][1]:
            fail(f"(b) the loss did not fall: {hist}")
        if f"step {fail_at} failed (injected node failure at step {fail_at}); restoring" \
                not in text:
            fail(f"(b) no recovery from the failure injected at step {fail_at}")
        if f"elastic resize {N_CLIENTS} -> {resize_to} at step {resize_at}" not in text:
            fail(f"(b) no resize to {resize_to} clients at step {resize_at}")
        if ckpt_lib.latest_step(ck) != TRAIN_CLI_STEPS - 1:
            fail(f"(b) the last checkpoint is step {ckpt_lib.latest_step(ck)}")
        t0 = time.perf_counter()
        hist2, text2, final2 = _train_cli_run(argv + ["--steps", str(TRAIN_CLI_RESUME_STEPS)])
        seconds2 = time.perf_counter() - t0
        if f"resumed from step {TRAIN_CLI_STEPS - 1}" not in text2 or \
                [s for s, _ in hist2][:1] != [TRAIN_CLI_STEPS]:
            fail(f"(b) the second run did not resume at step {TRAIN_CLI_STEPS}: {hist2}")
    out = {"history": hist, "resumed_history": hist2, "seconds": seconds,
           "resumed_seconds": seconds2, "final_checkpoint": final,
           "resumed_final_checkpoint": final2}
    log(f"train (b) CLI [{smi}] " + json.dumps(out))
    return out


def _train_small(arch: str, dev) -> tuple:
    """(losses, params before, params after) of TRAIN_SMALL_STEPS DME steps
    of tiny ``arch`` on ``dev``, from CPU-drawn parameters and batches."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train import init_train_state, make_train_step

    cfg = configs.preset_config(arch, "tiny")
    params = _move(init_params(cfg, 1, device="cpu"), dev)
    opt = _train_opt()
    state = init_train_state(cfg, opt, params, _train_spec(), N_CLIENTS)
    step_fn = make_train_step(cfg, opt, dme_spec=_train_spec(), device=dev)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, batch=2, n_clients=N_CLIENTS)
    start, losses = params, []
    for step in range(TRAIN_SMALL_STEPS):
        params, state, metrics = step_fn(params, state, data.batch_at(step, "cpu"), step)
        losses.append(float(metrics["loss"]))
    return losses, _move(start, "cpu"), _move(params, "cpu")


def _train_card_vs_cpu(smi: str) -> dict:
    """(c) 3 DME steps of each tiny config of TRAIN_SMALL_ARCHS from the
    same state on the card (the kernels) and the CPU (the plain versions)."""
    out = {}
    for arch in TRAIN_SMALL_ARCHS:
        l_card, p0, p_card = _train_small(arch, DEV)
        l_cpu, _, p_cpu = _train_small(arch, "cpu")
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
        param_gap = (sum(float(((a.double() - b.double()) ** 2).sum()) for a, b in
                         zip(_leaves(p_card), _leaves(p_cpu))) / _tree_sq(p_cpu)) ** 0.5
        out[arch] = {"loss_gap": loss_gap, "param_gap": param_gap,
                     "update_gap": _update_gap(p0, p_card, p_cpu), "losses": l_card}
        if not max(loss_gap, param_gap) <= 1e-4 or not np.isfinite(l_card).all():
            fail(f"(c) {arch}: card and CPU differ by {out[arch]} (limit 1e-4)")
    log(f"train (c) tiny card vs CPU [{smi}] " + json.dumps(out))
    return out


def phase_train(smi: str) -> dict:
    """The training path on the card: (a) musicgen-medium at full width
    (24 of 48 layers), (b) the CLI at its default arch with a failure, a
    resize and a resume, (c) tiny configs on the card against the CPU, (d)
    mamba2-130m at full width. Fatal on any failed check."""
    start, out, seconds = time.perf_counter(), {}, {}
    for tag, run in (("a", _train_full_width), ("b", _train_cli), ("c", _train_card_vs_cpu),
                     ("d", _train_mamba)):
        t0 = time.perf_counter()
        out[tag] = run(smi)
        torch.cuda.empty_cache()
        seconds[tag] = time.perf_counter() - t0
    log(f"train: phase done in {time.perf_counter() - start:.1f} s; by part {seconds}")
    return out


def _device_ms_by_kernel(prof) -> tuple:
    """(device ms by kernel name, launches by kernel name)."""
    by_name, counts = {}, {}
    for ev in prof.key_averages():
        # device-side events only: the aten ops' own entries repeat their kernels' time
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return by_name, counts


def _profiled(fn) -> tuple:
    """(device ms by kernel, wall ms, launches by kernel) of one
    synchronised call of ``fn``."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, counts = _device_ms_by_kernel(prof)
    device_ms = sum(by_name.values())
    if device_ms <= 0:
        fail("the profiler saw no device time")
    if device_ms > wall_ms:
        fail(f"the profile counts {device_ms} ms of device time in {wall_ms} ms of wall time")
    return by_name, wall_ms, counts


def phase_profile(tree: dict) -> dict:
    """Where one shared-randomness round's time goes: device time by kernel
    (torch.profiler) against the round's wall time. Every K1, K3 and CG
    step launch the wrappers count in it must show in the profile as the
    butterfly kernel, by name."""
    from repro_torch.dist import collectives
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    by_name, wall_ms, counts = _profiled(
        lambda: collectives.compressed_mean_tree(_spec(True, "auto"), 5, tree, device=DEV))
    after = ops.launch_counts()
    butterfly = {}
    for name, (_, kernel, _) in BUTTERFLY_KERNELS.items():
        if name not in ESTIMATOR_KERNELS:
            continue
        launched = after.get(name, 0) - before.get(name, 0)
        named = {key: counts[key] for key in by_name if kernel in key}
        if launched == 0 or sum(named.values()) != launched:
            fail(f"the profiled round launched {name} {launched} times, the profile shows "
                 f"{kernel} {named}")
        butterfly[name] = {"launches": launched, "ms": sum(by_name[key] for key in named),
                           "kernels": sorted(key[:120] for key in named)}
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": 1.0 - device_ms / wall_ms, "butterfly": butterfly,
           "top_device_ms": [[name[:200], ms] for name, ms in top]}
    log("profile " + json.dumps(out))
    return out


def _leaves(tree):
    from repro_torch.core import chunking

    return chunking.tree_leaves(tree)


def _take(tree, i):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _small_cases() -> dict:
    """name -> (config, limit of the card's relative L2 gap to the CPU; 0.0
    means bitwise): bitwise where no reduction order differs between the two."""
    from repro_torch.core import codec

    kw = dict(k=16, d_block=256)
    cases = {}
    for shared in (True, False):
        s = dict(kw, shared_randomness=shared)
        mode = "shared" if shared else "per_chunk"
        cases.update({
            f"srht_fused/{mode}": (codec.RandProjSpatial(**s), 1e-4),  # the kernels' sums
            f"rand_k/{mode}": (codec.RandK(**s), 0.0),
            f"rand_k_spatial/{mode}": (codec.RandKSpatial(**s), 0.0),
            # R-hat sums the whole vector
            f"rand_k_spatial_est/{mode}": (codec.RandKSpatial(r_mode="est", **s), 1e-4),
            f"subsample/{mode}": (codec.RandProjSpatial(projection="subsample", **s), 0.0),
            # cuSOLVER against LAPACK, cuBLAS against the CPU's matmuls
            f"srht_gram/{mode}": (codec.RandProjSpatial(decode_method="gram", **s), 1e-4),
            f"srht_direct/{mode}": (codec.RandProjSpatial(decode_method="direct", **s), 1e-4),
            f"gauss_gram/{mode}": (codec.RandProjSpatial(projection="gauss", **s), 1e-4),
        })
    cases.update({
        "top_k": (codec.TopK(**kw), 0.0), "identity": (codec.Identity(d_block=256), 0.0),
        "induced": (codec.Induced(**kw), 0.0),
        "wangni": (codec.Wangni(**kw), 1e-4),  # its water level sums over d
    })
    return cases


def small_tree() -> dict:
    """A small three-leaf tree for 4 clients, on the CPU."""
    g = torch.Generator().manual_seed(5)
    return {"w": torch.randn(N_CLIENTS, 40, 70, generator=g),
            "b": torch.randn(N_CLIENTS, 333, generator=g),
            "e": [torch.randn(N_CLIENTS, 7, 11, generator=g)]}


def phase_small_reference() -> None:
    """A small three-leaf tree through every ported config on the card (the
    kernels where the config has them) and on the CPU (the plain versions):
    the draws are the same bits on both."""
    from repro_torch.dist import collectives

    tree = small_tree()
    gaps = {}
    for name, (spec, limit) in _small_cases().items():
        got, _, _ = collectives.compressed_mean_tree(spec, 9, tree, device=DEV)
        want, _, _ = collectives.compressed_mean_tree(spec, 9, tree, device="cpu")
        got, want = _flat(got).cpu(), _flat(want)
        gaps[name] = rel_l2(got, want)
        ok = torch.equal(got, want) if limit == 0.0 else gaps[name] <= limit
        if not ok or not torch.isfinite(got).all():
            fail(f"small tree, {name}: card and CPU differ by {gaps[name]} (limit {limit})")
    log("small tree: card vs CPU, relative L2 gap by config " + json.dumps(gaps))


# -------------------------------------------------------------------- phase 7

def _flash_tol(dtype, window: int, q_offset: int) -> tuple:
    """(atol, rtol): the JAX package's tolerances for its kernel against the
    oracle (tests/test_flash_attention.py)."""
    if dtype == torch.bfloat16:
        return 2e-2, 2e-2
    return (3e-5, 1e-4) if window or q_offset else (2e-5, 2e-5)


def _qkv(g, n_kv, rep, sq, sk, dh, dtype):
    return tuple(torch.randn(shape, generator=g, device=DEV).to(dtype)
                 for shape in ((n_kv * rep, sq, dh), (n_kv, sk, dh), (n_kv, sk, dh)))


def phase_flash_checks(errs: Errors) -> dict:
    """K5 against its plain version on a grid, then at the serve shape; ->
    the serve-shape inputs (bf16) for the timing phase."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=DEV).manual_seed(77)
    n, by_dtype = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128, 256):
            for rep in (1, 2):
                for window in (0, 8, 64, 1024):
                    # (Sq, Sk, q_offset): ragged square, offset, ragged offset, one row
                    # past a 128-row q tile, one query row; q_offset + Sq <= Sk throughout
                    for sq, sk, q_offset in ((200, 200, 0), (128, 512, 384), (100, 484, 384),
                                             (129, 129, 0), (1, 385, 384)):
                        q, k, v = _qkv(g, 2, rep, sq, sk, dh, dtype)
                        kw = dict(rep=rep, window=window, q_offset=q_offset)
                        atol, rtol = _flash_tol(dtype, window, q_offset)
                        got = ops.flash_attention(q, k, v, use_kernel="force", **kw)
                        want = ops.flash_attention(q, k, v, use_kernel="never", **kw)
                        errs.check(FLASH_ROUTES[dtype], got, want, exact=False, rtol=rtol,
                                   atol=atol, what=f"{dtype} dh={dh} rep={rep} window={window} "
                                                   f"Sq={sq} Sk={sk} q_offset={q_offset}")
                        err = float((got.float() - want.float()).abs().max())
                        by_dtype[str(dtype)] = max(by_dtype.get(str(dtype), 0.0), err)
                        n += 1
    serve_in = _qkv(g, 16, 2, SERVE_PROMPT, SERVE_PROMPT, 256, torch.bfloat16)
    # the serve shape in bf16, then the same inputs in float32 at the grid's f32 tolerances
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dtype) for t in serve_in)
        for window in SERVE_WINDOWS:
            atol, rtol = _flash_tol(dtype, window, 0)
            got = ops.flash_attention(q, k, v, rep=2, window=window, use_kernel="force")
            want = ops.flash_attention(q, k, v, rep=2, window=window, use_kernel="never")
            errs.check(FLASH_ROUTES[dtype], got, want, exact=False, rtol=rtol, atol=atol,
                       what=f"serve shape {dtype} window={window}")
            key = f"serve {dtype}"
            by_dtype[key] = max(by_dtype.get(key, 0.0), float((got.float() - want.float()).abs().max()))
            del got, want
    torch.cuda.synchronize()
    log(f"flash attention vs plain: {n} grid cells and the serve shape (bf16 and f32, window "
        f"1024 and 0) ok; max abs err by dtype {by_dtype}")
    return {"q": serve_in[0], "k": serve_in[1], "v": serve_in[2]}


# -------------------------------------------------------------------- phase 8

def _greedy(params, cfg, prompts, steps: int, use_kernel: str = "auto"):
    """Prefill (through the kernel or, with ``use_kernel="never"``, the plain
    versions) and ``steps`` greedy decode steps; -> (tokens (B, steps + 1),
    last-position logits per step (steps + 1, B, vocab_padded))."""
    from repro_torch.models import transformer
    from repro_torch.train import make_decode_step

    b, s = prompts.shape
    cache = transformer.init_cache(cfg, b, s + steps, device=prompts.device)
    logits, cache = transformer.prefill(params, cfg, cache, prompts, use_kernel=use_kernel)
    tok = torch.argmax(logits[:, -1, : cfg.vocab_size], -1)[:, None].int()
    toks, all_logits = [tok], [logits[:, -1]]
    decode = make_decode_step(cfg)
    for i in range(steps):
        pos = torch.full((b, 1), s + i, dtype=torch.int32, device=prompts.device)
        nxt, lg, cache = decode(params, cache, tok, pos)
        tok = nxt[:, None].int()
        toks.append(tok)
        all_logits.append(lg[:, -1])
    return torch.cat(toks, 1), torch.stack(all_logits)


def _plain_attention_rounded(kind: str):
    """The plain attention with one of the bf16 kernel's roundings put in,
    to tell the bf16 logits gap's causes apart. All kinds exponentiate the
    masked scores less their row max and divide P V by P's row sum at the
    end, as the kernel does; "none" changes nothing else (a float32-level
    change only: the gap any reordering reaches); "exp2" scales the scores
    by log2(e) / sqrt(dh) and takes exp2, the kernel's exponent path;
    "p_split" carries P as bf16(P) + bf16(P - bf16(P)), the kernel's P;
    "p_bf16" rounds P to bf16, the kernel's P before the split."""
    def attn(q, k, v, *, rep, window=0, q_offset=0):
        sq, dh = q.shape[1], q.shape[2]
        k = torch.repeat_interleave(k, rep, dim=0).float()
        v = torch.repeat_interleave(v, rep, dim=0).float()
        s = torch.einsum("nqd,nkd->nqk", q.float(), k)
        q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window > 0:
            mask &= q_pos - k_pos < window
        scale = (1.4426950408889634 if kind == "exp2" else 1.0) / np.sqrt(dh)
        t = torch.where(mask[None], s * scale, -torch.inf)
        p = (torch.exp2 if kind == "exp2" else torch.exp)(t - t.amax(-1, keepdim=True))
        if kind in ("p_split", "p_bf16"):
            hi = p.bfloat16().float()
            p = hi + (p - hi).bfloat16().float() if kind == "p_split" else hi
        return (torch.einsum("nqk,nkd->nqd", p, v) / p.sum(-1, keepdim=True)).to(q.dtype)
    return attn


def phase_serve() -> dict:
    """gemma3-4b at full width through launch.serve.serve: K5 must launch
    once per attention layer of the prefill; the prefill's last-position
    logits against the plain versions on the card in bf16 and float32."""
    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = configs.preset_config("gemma3-4b", "full").replace(attn_impl="flash")
    if cfg.n_params() != GEMMA3_4B_PARAMS or cfg.n_layers != sum(SERVE_WINDOWS.values()):
        fail(f"gemma3-4b has {cfg.n_params()} parameters in {cfg.n_layers} layers")
    layer_windows = {w: sum(1 for s in cfg.layers if s.window == w) for w in SERVE_WINDOWS}
    if layer_windows != SERVE_WINDOWS:
        fail(f"gemma3-4b's attention windows are {layer_windows}")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, SERVE_SEED, device=DEV)
    torch.cuda.synchronize()
    log(f"serve: gemma3-4b, {GEMMA3_4B_PARAMS} float32 parameters on the card in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the serving path's window opens here
    res = serve.serve(cfg, params, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                      seed=SERVE_SEED, device=DEV)
    torch.cuda.synchronize()
    launches = ops.launch_counts()  # ... and closes here
    if launches != {"flash_attention_bf16": cfg.n_layers}:
        fail(f"the serving path launched {launches}, not K5's bf16 kernel "
             f"(flash_attention_bf16) x {cfg.n_layers}")
    tokens, logits = res["tokens"], res["prefill_logits"][:, -1]
    if tokens.shape != (SERVE_BATCH, SERVE_GEN) or not torch.isfinite(logits).all():
        fail(f"serve gave tokens {tuple(tokens.shape)}, finite logits {bool(torch.isfinite(logits).all())}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        fail("serve generated a token outside the vocabulary")

    prompts = res["prompts"]
    plain_tok, plain = _greedy(params, cfg, prompts, 0, "never")
    gap_bf16 = rel_l2(logits, plain[0])
    first_same = bool(torch.equal(tokens[:, :1], plain_tok))
    # the same gap for the plain path with one of the kernel's roundings in it
    gap_rounded = {}
    for kind in ("none", "exp2", "p_split", "p_bf16"):
        plain_attention, ref.flash_attention_ref = ref.flash_attention_ref, \
            _plain_attention_rounded(kind)
        try:
            gap_rounded[kind] = rel_l2(_greedy(params, cfg, prompts, 0, "never")[1][0], plain[0])
        finally:
            ref.flash_attention_ref = plain_attention
    del plain

    # serving in float32: the float32 route of K5, counted the same way
    cfg32 = cfg.replace(dtype="float32")
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the float32 serving path's window opens here
    res32 = serve.serve(cfg32, params, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=2,
                        seed=SERVE_SEED, device=DEV)
    torch.cuda.synchronize()
    launches_f32 = ops.launch_counts()  # ... and closes here
    if launches_f32 != {"flash_attention_f32": cfg.n_layers}:
        fail(f"float32 serving launched {launches_f32}, not K5's float32 kernel x {cfg.n_layers}")
    if not torch.equal(res32["prompts"], prompts):
        fail("float32 serving drew other prompts from the same seed")
    p32_tok, p32 = _greedy(params, cfg32, prompts, 0, "never")
    gap_f32 = rel_l2(res32["prefill_logits"][:, -1], p32[0])
    first_same32 = bool(torch.equal(res32["tokens"][:, :1], p32_tok))
    del res32, p32

    # warm prefill wall times, host clock around a synchronised call
    walls = {}
    for c in (cfg32, cfg):
        walls[c.dtype] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _greedy(params, c, prompts, 0)
            torch.cuda.synchronize()
            walls[c.dtype].append((time.perf_counter() - t0) * 1e3)
    out = {
        "launches": launches, "launches_f32_serving": launches_f32,
        "tokens_request0": tokens[0].tolist(),
        "prefill_ms_first": res["prefill_s"] * 1e3,
        "prefill_ms_warm_median3": statistics.median(walls[cfg.dtype]),
        "prefill_ms_f32_warm_median3": statistics.median(walls["float32"]),
        "prefill_ms_f32_warm": walls["float32"],
        "decode_ms_per_step": res["decode_s"] * 1e3 / (SERVE_GEN - 1),
        "decode_tokens_per_s": SERVE_BATCH * (SERVE_GEN - 1) / res["decode_s"],
        "logits_gap_bf16": gap_bf16, "first_tokens_agree_bf16": first_same,
        "logits_gap_bf16_plain_rounded": gap_rounded,
        "logits_gap_f32": gap_f32, "first_tokens_agree_f32": first_same32,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("serve " + json.dumps(out))
    if not gap_bf16 <= 5e-2 or not first_same:
        fail(f"bf16 prefill: kernel and plain logits differ by {gap_bf16} (limit 5e-2), "
             f"first tokens equal: {first_same}")
    if not gap_f32 <= 1e-4 or not first_same32:
        fail(f"float32 prefill: kernel and plain logits differ by {gap_f32} (limit 1e-4), "
             f"first tokens equal: {first_same32}")
    out["profile"] = phase_serve_profile(params, cfg, prompts)
    return out


def phase_serve_profile(params, cfg, prompts) -> dict:
    """Where one bf16 prefill's time goes, and one decode step's after it:
    device time by kernel (torch.profiler) against wall time; K5's share."""
    from repro_torch.models import transformer
    from repro_torch.train import make_decode_step

    cache = transformer.init_cache(cfg, prompts.shape[0], prompts.shape[1] + SERVE_GEN,
                                   device=prompts.device)
    by_name, wall_ms, counts = _profiled(lambda: transformer.prefill(params, cfg, cache, prompts))
    device_ms = sum(by_name.values())
    k5 = {name: ms for name, ms in by_name.items() if "flash_attention_kernel" in name}
    k5_ms = sum(k5.values())
    k5_launches = sum(counts[name] for name in k5)
    k5_tc_launches = sum(counts[name] for name in k5 if TC_KERNEL in name)
    if k5_ms <= 0 or k5_tc_launches != k5_launches or k5_launches != cfg.n_layers:
        fail(f"the profiled prefill ran K5 as {dict((n[:120], counts[n]) for n in k5)}, not the "
             f"bf16 kernel x {cfg.n_layers}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
           "k5_ms": k5_ms, "k5_share_of_device": k5_ms / device_ms,
           "k5_launches": k5_launches, "k5_tensor_core_launches": k5_tc_launches,
           "top_device_ms": [[name[:200], ms] for name, ms in top]}
    log("serve profile, prefill " + json.dumps(out))
    tok = torch.zeros((prompts.shape[0], 1), dtype=torch.int32, device=prompts.device)
    pos = torch.full_like(tok, prompts.shape[1])
    decode = make_decode_step(cfg)
    by_name, wall_ms, _ = _profiled(lambda: decode(params, cache, tok, pos))
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out["decode_step"] = {"wall_ms": wall_ms, "device_ms": device_ms,
                          "idle_share": 1.0 - device_ms / wall_ms,
                          "top_device_ms": [[name[:200], ms] for name, ms in top]}
    log("serve profile, decode step " + json.dumps(out["decode_step"]))
    return out


def _prefill_walls(params, cfg, prompts, n: int = 3) -> list:
    """Wall ms of ``n`` warm prefills (host clock around a synchronised
    call, each from an empty cache)."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _greedy(params, cfg, prompts, 0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def _prefill_profile(what: str, params, cfg, prompts, smi: str) -> dict:
    """Where one prefill's time goes: device time by kernel against its
    wall time (torch.profiler)."""
    from repro_torch.models import transformer

    cache = transformer.init_cache(cfg, prompts.shape[0], prompts.shape[1], device=prompts.device)
    by_name, wall_ms, _ = _profiled(lambda: transformer.prefill(params, cfg, cache, prompts))
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
           "top_device_ms": [[name[:160], ms] for name, ms in top]}
    log(f"serve {what} profile, prefill [{smi}] " + json.dumps(out))
    return out


def _serve_row(res, walls, gen) -> dict:
    batch = res["tokens"].shape[0]
    return {"prefill_ms_first": res["prefill_s"] * 1e3,
            "prefill_ms_warm_median3": statistics.median(walls), "prefill_ms_warm": walls,
            "decode_ms_per_step": res["decode_s"] * 1e3 / (gen - 1),
            "decode_tokens_per_s": batch * (gen - 1) / res["decode_s"]}


def _check_tokens(what: str, res, cfg, batch: int, gen: int) -> None:
    tokens, logits = res["tokens"], res["prefill_logits"][:, -1]
    if tokens.shape != (batch, gen) or not torch.isfinite(logits).all():
        fail(f"{what}: tokens {tuple(tokens.shape)}, finite logits "
             f"{bool(torch.isfinite(logits).all())}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        fail(f"{what}: a token outside the vocabulary")


def phase_serve_mamba(smi: str) -> dict:
    """mamba2-130m at full width through launch.serve.serve, in bf16 and
    then float32: 4 prompts of 2048 tokens (8 SSD chunks), 32 greedy tokens;
    no kernel of the port runs on this path. Decode must agree with the
    chunked scan: the last decode step's logits against a full forward over
    the prompt and the generated tokens, at that position."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    start = time.perf_counter()
    cfg = configs.preset_config("mamba2-130m", "full")
    if cfg.n_params() != MAMBA2_130M_PARAMS or SERVE_PROMPT != 8 * cfg.mamba_chunk:
        fail(f"mamba2-130m: {cfg.n_params()} parameters, chunk {cfg.mamba_chunk}")
    params = transformer.init_params(cfg, SERVE_SEED, device=DEV)
    out = {}
    for c in (cfg, cfg.replace(dtype="float32")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()  # this serving run's window opens here
        res = serve.serve(c, params, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                          seed=SERVE_SEED, device=DEV)
        torch.cuda.synchronize()
        launches = ops.launch_counts()  # ... and closes here
        if launches:
            fail(f"mamba2-130m serving ({c.dtype}) launched {launches}; its path has no kernel")
        _check_tokens(f"mamba2-130m serving ({c.dtype})", res, c, SERVE_BATCH, SERVE_GEN)
        prompts = res["prompts"]
        row = _serve_row(res, _prefill_walls(params, c, prompts), SERVE_GEN)
        toks, step_logits = _greedy(params, c, prompts, SERVE_GEN - 1)
        full, _ = transformer.forward(params, c, torch.cat([prompts, toks[:, :-1]], dim=1))
        gap = rel_l2(step_logits[-1], full[:, -1])
        del full
        row.update(decode_vs_forward_gap=gap, tokens_equal_serve=bool(torch.equal(toks, res["tokens"])),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   tokens_request0=res["tokens"][0].tolist())
        out[c.dtype] = row
        log(f"serve mamba2-130m {c.dtype} [{smi}] " + json.dumps(row))
        if not gap <= MAMBA_SERVE_TOL[c.dtype]:
            fail(f"mamba2-130m ({c.dtype}): the last decode step's logits differ from the full "
                 f"forward's by {gap} (limit {MAMBA_SERVE_TOL[c.dtype]})")
    out["profile"] = _prefill_profile("mamba2-130m bfloat16", params, cfg, prompts, smi)
    out["seconds"] = time.perf_counter() - start
    log(f"serve mamba2-130m: phase done in {out['seconds']:.1f} s")
    return out


def _count_drops(dropped: list):
    """Patch ``models.moe.dispatch`` to append each call's dropped slots
    (a device tensor) and its slot count to ``dropped``; -> the restore
    function."""
    from repro_torch.models import moe

    saved = moe.dispatch

    def dispatch(sel, n_experts, cap, before=None):
        out = saved(sel, n_experts, cap, before)
        dropped.append(((~out[3]).sum(), out[3].numel()))
        return out

    moe.dispatch = dispatch
    return lambda: setattr(moe, "dispatch", saved)


def phase_serve_moe(smi: str) -> dict:
    """deepseek-moe-16b at full width, its dense prologue and 8 of 27 MoE
    blocks, ``attn_impl="flash"``, bf16, through launch.serve.serve: 4
    prompts of 2048 tokens, 32 greedy tokens. K5's bf16 route must launch
    once per attention layer of the prefill (9); the prefill's last-position
    logits against the plain path on the card (relative L2 5e-2); the same
    weights and prompts through K5's float32 route, whose first tokens must
    equal the plain float32 path's (logits within 1e-3); the share of routed
    slots that the capacity (960 an expert) drops in a prefill.

    The first tokens are held in float32, not bf16: at these weights the
    bf16 model amplifies a float32-level change anywhere in its attention
    (routing is discrete) to a logits change as large as the kernel's, so
    its first tokens test the draw of the weights, not the kernel. The bf16
    run records the plain path's own such change beside the kernel's."""
    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import moe, transformer

    start = time.perf_counter()
    cfg = configs.preset_config("deepseek-moe-16b", "full").replace(
        n_blocks=MOE_SERVE_BLOCKS, attn_impl="flash")
    n_tokens = SERVE_BATCH * SERVE_PROMPT
    if cfg.n_params() != MOE_SERVE_PARAMS or moe.capacity(cfg, n_tokens) != MOE_SERVE_CAPACITY:
        fail(f"deepseek-moe-16b at {MOE_SERVE_BLOCKS} blocks: {cfg.n_params()} parameters, "
             f"capacity {moe.capacity(cfg, n_tokens)}")
    params = transformer.init_params(cfg, SERVE_SEED, device=DEV)
    torch.cuda.synchronize()
    log(f"serve deepseek-moe-16b: {cfg.n_params()} float32 parameters ({cfg.n_layers} layers) "
        f"on the card in {time.perf_counter() - start:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the serving path's window opens here
    res = serve.serve(cfg, params, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                      seed=SERVE_SEED, device=DEV)
    torch.cuda.synchronize()
    launches = ops.launch_counts()  # ... and closes here
    n_attn = sum(1 for spec in cfg.layers if spec.kind == "attn")
    if launches != {"flash_attention_bf16": n_attn}:
        fail(f"deepseek-moe-16b serving launched {launches}, not K5's bf16 kernel x {n_attn}")
    _check_tokens("deepseek-moe-16b serving", res, cfg, SERVE_BATCH, SERVE_GEN)
    prompts, logits = res["prompts"], res["prefill_logits"][:, -1]
    row = _serve_row(res, _prefill_walls(params, cfg, prompts), SERVE_GEN)
    dropped = []
    restore = _count_drops(dropped)
    try:
        _greedy(params, cfg, prompts, 0)
    finally:
        restore()
    n_dropped = sum(int(d) for d, _ in dropped)
    n_slots = sum(n for _, n in dropped)
    plain_tok, plain = _greedy(params, cfg, prompts, 0, "never")
    gap = rel_l2(logits, plain[0])
    first_same = bool(torch.equal(res["tokens"][:, :1], plain_tok))
    # the plain path's own noise in bf16: the same attention in another
    # float32 order (recorded, not held: see the docstring)
    saved, ref.flash_attention_ref = ref.flash_attention_ref, _plain_attention_rounded("none")
    try:
        reordered = _greedy(params, cfg, prompts, 0, "never")[1][0]
    finally:
        ref.flash_attention_ref = saved
    top2 = plain[0][:, :cfg.vocab_size].float().topk(2, dim=-1).values
    f32 = cfg.replace(dtype="float32")
    before = ops.launch_counts().get("flash_attention_f32", 0)
    tok32, logits32 = _greedy(params, f32, prompts, 0)
    f32_launches = ops.launch_counts().get("flash_attention_f32", 0) - before
    plain_tok32, plain32 = _greedy(params, f32, prompts, 0, "never")
    gap32 = rel_l2(logits32, plain32)
    first_same32 = bool(torch.equal(tok32, plain_tok32))
    top2_32 = plain32[0][:, :cfg.vocab_size].float().topk(2, dim=-1).values
    profile = _prefill_profile("deepseek-moe-16b", params, cfg, prompts, smi)
    row.update(launches=launches, moe_layers=len(dropped), dropped_slots=n_dropped,
               routed_slots=n_slots, dropped_share=n_dropped / n_slots,
               logits_gap_bf16=gap, first_tokens_agree_bf16=first_same,
               plain_reordered_gap_bf16=rel_l2(reordered, plain[0]),
               plain_top2_margin_bf16=(top2[:, 0] - top2[:, 1]).tolist(),
               first_tokens_bf16=res["tokens"][:, 0].tolist(),
               plain_first_tokens_bf16=plain_tok[:, 0].tolist(),
               f32_launches=f32_launches, logits_gap_f32=gap32,
               first_tokens_agree_f32=first_same32,
               plain_top2_margin_f32=(top2_32[:, 0] - top2_32[:, 1]).tolist(),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               tokens_request0=res["tokens"][0].tolist(), profile=profile)
    del params, plain, reordered, logits32, plain32
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - start
    log(f"serve deepseek-moe-16b [{smi}] " + json.dumps(row))
    if len(dropped) != MOE_SERVE_BLOCKS or n_slots != MOE_SERVE_BLOCKS * n_tokens * cfg.top_k_experts:
        fail(f"deepseek-moe-16b: {len(dropped)} routed layers, {n_slots} slots in a prefill")
    if not gap <= 5e-2:
        fail(f"deepseek-moe-16b bf16 prefill: kernel and plain logits differ by {gap} "
             f"(limit 5e-2)")
    if f32_launches != n_attn or not gap32 <= 1e-3 or not first_same32:
        fail(f"deepseek-moe-16b float32 prefill: K5's float32 route launched {f32_launches} "
             f"times (want {n_attn}); kernel and plain logits differ by {gap32} (limit 1e-3); "
             f"first tokens equal: {first_same32}")
    return row


# -------------------------------------------------------------------- phase 9

def phase_tiny_gemma() -> None:
    """Tiny gemma with the same float32 weights: the kernel on the card,
    the plain versions on the CPU."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg = configs.preset_config("gemma3-4b", "tiny").replace(attn_impl="flash")
    params = transformer.init_params(cfg, 3, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (3, 40), generator=torch.Generator().manual_seed(4),
                            dtype=torch.int32)
    card = _move(params, DEV)
    before = ops.launch_counts().get("flash_attention_f32", 0)
    got_tok, got = _greedy(card, cfg, prompts.to(DEV), 8)
    if ops.launch_counts().get("flash_attention_f32", 0) - before != cfg.n_layers:
        fail("tiny gemma's float32 prefill on the card did not run K5's float32 kernel")
    want_tok, want = _greedy(params, cfg, prompts, 8)
    gap = rel_l2(got.cpu(), want)
    if not gap <= 1e-4 or not torch.equal(got_tok.cpu(), want_tok):
        fail(f"tiny gemma: card vs CPU logits gap {gap}, tokens equal "
             f"{torch.equal(got_tok.cpu(), want_tok)}")
    log(f"tiny gemma: card (kernel) vs CPU (plain): logits rel L2 {gap:.3e}, "
        f"greedy tokens equal over 8 decode steps")


def _move(tree, dev):
    if isinstance(tree, dict):
        return {k: _move(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_move(v, dev) for v in tree)
    return tree.to(dev)


# ------------------------------------------------------------------- phase 10

def _library_calls(inp: dict) -> dict:
    """One float32 PyTorch call per kernel computing the same function, with
    the dense matrices built beforehand and not timed: for the encodes a
    matmul against the (signed, scaled) Hadamard matrix, for fwht_rowsigns
    after its per-row sign flip; for the decode sum an einsum with the
    stacked SRHT maps G_i (n, k, d); for the Gram apply a matmul with
    S = sum_i G_i^T G_i (d, d)."""
    from repro_torch.kernels import ops, ref

    d = D_BLOCK
    h = torch.as_tensor(ref.hadamard_matrix(d), device=DEV) * (1.0 / np.sqrt(d))
    s1, r1 = inp["signs"][0, 0], inp["rows"][0, 0]
    w_enc = (s1[:, None] * h)[:, r1].contiguous()        # (d, k)
    x, z = inp["x"], inp["z"]
    x_signed = x * inp["pc_signs"]
    g = ops.srht_rows_matrix(inp["signs"][:, 0], inp["rows"][:, 0], d)  # (n, k, d)
    s = torch.einsum("nkd,nke->de", g, g).contiguous()
    return {
        "fwht": lambda: torch.matmul(x, w_enc),
        "fwht_rowsigns": lambda: torch.matmul(x_signed, h),
        "srht_decode_sum": lambda: torch.einsum("nck,nkd->cd", z, g),
        "srht_gram_apply": lambda: torch.matmul(x, s),
    }


def phase_timing(calls: dict, launches: dict, errs: Errors, inputs: dict) -> list:
    library = _library_calls(inputs)
    out = []
    for name, (call, n_ops, n_bytes) in calls.items():
        ms = time_ms(lambda: call("force"))
        plain_ms = time_ms(lambda: call("never"), reps=3, warmup=1)
        lib = library[name]
        same = lib()
        if name == "fwht_rowsigns":  # the matmul gives every column, the kernel its rows'
            same = torch.gather(same, -1, inputs["pc_rows"].long())
        gap = rel_l2(same, call("force"))
        if not gap <= 1e-4:
            fail(f"{name}: the library yardstick differs from the kernel by {gap}")
        del same
        library_ms = time_ms(lib)
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        out.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": int(launches.get(name, 0)),
            "max_abs_err": errs.max[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bound_share": max(t_bytes, t_ops) / ms,
            "over_library": ms / library_ms,
        })
        log(f"{name}: {json.dumps(out[-1])}")
    out.append(cg_step_timing(launches, errs, inputs))
    return out


def cg_step_timing(launches: dict, errs: Errors, inp: dict) -> dict:
    """The fused CG step at full width from the solve's first state (no
    chunk done), shared draws, the state restored before each launch
    (untimed): against its bound, its plain version and the unfused path it
    replaced (K4 alone, then the step's updates as PyTorch ops). No one
    PyTorch call computes a CG step, so ``library_ms`` is null. Also timed,
    outside the bound: the step with a draw per (client, chunk), as the
    per-chunk round runs it (2 GB of signs more a launch)."""
    from repro_torch.kernels import ops, ref

    c0, c1 = torch.tensor(1.0 - RHO, device=DEV), torch.tensor(RHO, device=DEV)
    state = cg_state(inp["x"], c0, c1, frozen=False)
    work = [t.clone() for t in state[0]]

    def restore():
        for w, s0 in zip(work, state[0]):
            w.copy_(s0)

    def run(signs, rows, use_kernel):
        return lambda: ops.srht_cg_step(*work, c0, c1, state[3], signs, rows,
                                        use_kernel=use_kernel)

    signs, rows = inp["signs"], inp["rows"]
    ms = time_ms(run(signs, rows, "force"), prep=restore)
    plain_ms = time_ms(run(signs, rows, "never"), reps=3, warmup=1, prep=restore)
    mask = _mask(rows, D_BLOCK)

    def unfused():
        ref.srht_cg_step_ref(*work, c0, c1, state[3], signs, mask,
                             gram_apply=lambda v, s, _m: ops.srht_gram_apply(
                                 v, s, rows, use_kernel="force"))

    unfused_ms = time_ms(unfused, prep=restore)
    pc_ms = time_ms(run(inp["decode_pc_signs"], inp["decode_pc_rows"], "force"), prep=restore)
    n_ops, n_bytes = cg_step_work(inp)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    out = {
        "name": "srht_cg_step", "route": "cuda", "source": KERNELS["srht_cg_step"][0],
        "replaces": KERNELS["srht_cg_step"][1], "launches": int(launches.get("srht_cg_step", 0)),
        "max_abs_err": errs.max["srht_cg_step"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "bound_share": max(t_bytes, t_ops) / ms,
        "unfused_ms": unfused_ms, "over_unfused": ms / unfused_ms,
        "ms_draw_per_chunk": pc_ms,
    }
    log(f"srht_cg_step: {json.dumps(out)}")
    return out



def _flash_pairs(sq: int, sk: int, window: int) -> int:
    """(query, key) pairs the mask keeps for q_offset 0."""
    total = 0
    for i in range(sq):
        lo = max(0, i - window + 1) if window else 0
        total += min(i, sk - 1) - lo + 1
    return total


def phase_flash_timing(inp: dict, launches: dict, errs: Errors) -> list:
    """K5's two routes at the serve shape, windowed and global: kernel,
    plain version, bound, and scaled_dot_product_attention on K/V repeated
    beforehand. bf16 runs the wgmma kernel, float32 (the same inputs) the
    split-TF32 one. Each entry's figures are per launch, weighted as the
    prefill runs them (29 windowed, 5 global); ``launches`` is each route's
    count from its serving run. The float32 bound is its operations at
    split TF32's rate; ``bound_ms_cuda_cores`` keeps them at the CUDA
    cores' rate, the bound a CUDA-core kernel would face."""
    from repro_torch.kernels import ops

    out = []
    for dtype, peak, lib_tol in ((torch.bfloat16, BF16_OPS_PER_S, 2e-2),
                                 (torch.float32, SPLIT_TF32_OPS_PER_S, 1e-4)):
        name = FLASH_ROUTES[dtype]
        q, k, v = (inp[key].to(dtype) for key in ("q", "k", "v"))
        n_q, sq, dh = q.shape
        rep = n_q // k.shape[0]
        # (1, heads, S, dh), K/V repeated to every query head, outside the timing
        q4 = q[None]
        k_rep = torch.repeat_interleave(k, rep, 0)[None]
        v_rep = torch.repeat_interleave(v, rep, 0)[None]
        n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))  # q, k, v in; o out
        idx = torch.arange(sq, device=DEV)
        per_window = {}
        for window in SERVE_WINDOWS:
            call = lambda u, w=window: ops.flash_attention(q, k, v, rep=rep, window=w, use_kernel=u)
            if window:
                mask = (idx[None, :] <= idx[:, None]) & (idx[:, None] - idx[None, :] < window)
                lib = lambda m=mask: torch.nn.functional.scaled_dot_product_attention(
                    q4, k_rep, v_rep, attn_mask=m)
            else:
                lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k_rep, v_rep, is_causal=True)
            gap = rel_l2(lib()[0].float(), call("force").float())
            if not gap <= lib_tol:
                fail(f"{name} window={window}: the library yardstick differs by {gap}")
            n_ops = 4 * dh * n_q * _flash_pairs(sq, sq, window)
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / peak * 1e3
            ms = time_ms(lambda: call("force"))
            per_window[window] = {
                "ms": ms,
                "plain_ms": time_ms(lambda: call("never"), reps=3, warmup=1),
                "library_ms": time_ms(lib),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_share": max(t_bytes, t_ops) / ms, "tflops": n_ops / ms / 1e9,
                "gflop": n_ops / 1e9, "mbytes": n_bytes / 1e6, "library_rel_gap": gap,
            }
            if dtype == torch.float32:
                cuda_cores = max(t_bytes, n_ops / F32_OPS_PER_S * 1e3)
                per_window[window].update(bound_ms_cuda_cores=cuda_cores,
                                          bound_share_cuda_cores=cuda_cores / ms)
            log(f"{name} window={window}: " + json.dumps(per_window[window]))
        del q, k, v, q4, k_rep, v_rep
        weights = SERVE_WINDOWS
        total = sum(weights.values())
        keys = ["ms", "plain_ms", "library_ms", "bound_ms", "tflops"]
        if dtype == torch.float32:
            keys.append("bound_ms_cuda_cores")
        mean = {key: sum(per_window[w][key] * c for w, c in weights.items()) / total
                for key in keys}
        if dtype == torch.float32:
            mean["bound_share_cuda_cores"] = mean["bound_ms_cuda_cores"] / mean["ms"]
        bound_by = {per_window[w]["bound_by"] for w in weights}
        out.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": int(launches.get(name, 0)),
            "max_abs_err": errs.max[name], **mean, "bound_share": mean["bound_ms"] / mean["ms"],
            "bound_by": bound_by.pop() if len(bound_by) == 1 else "operations",
            "per_window": {str(w): per_window[w] for w in weights},
        })
    return out


def phase_flash_timing_d128(launches: dict, errs: Errors) -> dict:
    """K5's bf16 route at deepseek-moe-16b's prefill shape (16 heads of
    128, 4 x 2048, window 0, no GQA): against its plain version (the grid's
    bf16 tolerance), its bound, and scaled_dot_product_attention;
    ``launches`` is the count from the deepseek serving run."""
    from repro_torch.kernels import ops

    name = "flash_attention_bf16_d128"
    g = torch.Generator(device=DEV).manual_seed(78)
    q, k, v = _qkv(g, SERVE_BATCH * 16, 1, SERVE_PROMPT, SERVE_PROMPT, 128, torch.bfloat16)
    call = lambda u: ops.flash_attention(q, k, v, rep=1, window=0, use_kernel=u)
    atol, rtol = _flash_tol(torch.bfloat16, 0, 0)
    errs.check(name, call("force"), call("never"), exact=False, rtol=rtol, atol=atol,
               what="deepseek-moe-16b prefill shape")
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q[None], k[None], v[None],
                                                                   is_causal=True)
    gap = rel_l2(lib()[0].float(), call("force").float())
    if not gap <= 2e-2:
        fail(f"{name}: the library yardstick differs by {gap}")
    n_q, sq, dh = q.shape
    n_ops = 4 * dh * n_q * _flash_pairs(sq, sq, 0)
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))  # q, k, v in; o out
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / BF16_OPS_PER_S * 1e3
    ms = time_ms(lambda: call("force"))
    out = {"name": name, "route": "cuda", "source": KERNELS[name][0],
           "replaces": KERNELS[name][1], "launches": int(launches.get("flash_attention_bf16", 0)),
           "max_abs_err": errs.max[name], "ms": ms,
           "plain_ms": time_ms(lambda: call("never"), reps=3, warmup=1),
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": time_ms(lib), "bound_share": max(t_bytes, t_ops) / ms,
           "tflops": n_ops / ms / 1e9, "library_rel_gap": gap,
           "shape": {"q": list(q.shape), "kv": list(k.shape), "window": 0}}
    out["over_library"] = ms / out["library_ms"]
    log(f"{name}: {json.dumps(out)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_environment()
    phase_build()
    phase_threefry(smi)
    errs = Errors()
    phase_kernel_checks(errs)
    inputs = full_width_inputs()
    calls = kernel_calls(inputs)
    phase_full_width_checks(errs, calls, inputs)
    tree = gradient_tree()
    launches, main_path = phase_main_path(tree)
    phase_baselines(tree, main_path)
    phase_codec(tree, main_path)
    del main_path
    dist_launches = phase_dist(tree, smi)["a"]["launches"]
    task = fl_task()
    phase_fl(smi, task)
    hier_launches = phase_hier(smi, task)["launches"]
    del task
    phase_train(smi)
    pipeline_launches = phase_pipeline(smi)["launches"]
    phase_profile(tree)
    del tree
    phase_small_reference()
    flash_inputs = phase_flash_checks(errs)
    serve_out = phase_serve()
    phase_tiny_gemma()
    phase_serve_mamba(smi)
    moe_serve = phase_serve_moe(smi)
    placed_launches = phase_placed(smi, errs)["launches"]
    kernels = phase_timing(calls, launches, errs, inputs)
    kernels += phase_flash_timing(
        flash_inputs, {**serve_out["launches"], **serve_out["launches_f32_serving"]}, errs)
    kernels.append(phase_flash_timing_d128(moe_serve["launches"], errs))
    for row in kernels:  # the launches of phase_dist (a)'s five mesh routes,
        # phase_hier's (b) and (c), phase_pipeline's (a) and (b) and every
        # rank of phase_placed's (a) and (b)
        row["launches_dist"] = int(dist_launches.get(row["name"], 0))
        row["launches_hier"] = int(hier_launches.get(row["name"], 0))
        row["launches_pipeline"] = int(pipeline_launches.get(row["name"], 0))
        row["launches_placed"] = int(placed_launches.get(row["name"], 0))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
