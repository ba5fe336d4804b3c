"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--device-qubits N]
                          [--device-skip-gates G] [--seed S]

Phases, in order (any failure exits non-zero and prints no result):

1. build        — compile every CUDA source under src/repro_torch/csrc/,
                  one nvcc per source, all started together; time the
                  build.  For each tensor-core kernel instantiation
                  (gemm_planes_tc_kernel, flash_bf16_kernel,
                  flash_f32_kernel) print its ptxas registers and spills
                  (kernel_ptxas) and its HMMA/HGMMA count in the SASS of
                  the built library (kernel_sass, cuobjdump -sass); a count
                  of 0 fails.  kernel_ptxas lines too for the ring bodies
                  of B1/B6 and B7 at K <= 32 (gemm_planes_ring_kernel,
                  gemm_planes_mid_ring_kernel) and for B11
                  (kvdq_partial_kernel).
2. kernels      — hold each kernel against its plain PyTorch version on the
                  card, at the main paths' shapes and at small (for the
                  codec: ragged) shapes, and time kernel, plain version and
                  (where one exists) one library call beside the kernel's
                  bound (bytes over 3.35 TB/s or operations over the peak
                  rate of the kernel's arithmetic, whichever is larger: 67
                  TFLOP/s f32 FMAs, 495 TFLOP/s TF32 with split TF32 as
                  three products, 989 TFLOP/s bf16; timed rows also give
                  the f32-FMA bound): gemm_planes_batch, the codec's
                  encode/decode, gemm_planes (K = 4 ... 128; split TF32 on
                  the tensor cores for K >= 64), gemm_planes_mid,
                  diag_apply (within 1e-4 on unit-scale inputs; B7 also
                  at every K in 2 ... 32 with a ragged I, O > 1 with I
                  below a slab, planes off 16-byte alignment),
                  gemm_planes_mid_batch (the wave path's MidGemmOp, within
                  rtol 1e-5, atol 1e-6: main_batch's wave of 16 rows at
                  (O, K, I) = (1, 4, 2^20) and (16384, 32, 8), timed
                  beside one complex torch.einsum, distinct U per lane;
                  K = 128 with U at lane stride 0, narrow, ragged and
                  unaligned shapes untimed; row l of a 16-lane call bit
                  for bit the one-lane call on row l at L = 1, 2, 3, 16)
                  and the packing kernels (bit for bit; pack_bitmap_tiles
                  also on bool bits, timed on int32 and bool bits at 2^22
                  beside its bytes bound on kernel_time lines, and at n
                  a multiple of 32 and not of 128 through its C entry, and
                  off the 16-byte boundary).  gemm_planes_batch and
                  gemm_planes at K <= 32 (the ring body) are held within
                  rtol 1e-5, atol 1e-6, also at every K in 2 ... 32 with
                  three lanes and B at lane stride 0, R*K past a ragged
                  tile, R*K not a multiple of 4 and planes off 16-byte
                  alignment, and timed at a batched wave's shape (L = 16
                  rows of 2^22 amplitudes, K = 32 and 16, operands of 8
                  lanes tiled groups-major, beside torch.matmul).
                  Then the attention kernels (within 2e-4 of their plain
                  versions on f32 inputs, as the Pallas tests hold them):
                  flash_attention at the TPU tests' shapes, causal and
                  full, at a ragged S and in the model's GQA layout
                  (bf16: within 2^-8 max|v| + one bf16 step of the plain
                  version, which rounds P to bf16 as repro does);
                  kv_dequant_decode_attention at the TPU tests' shapes, a
                  ragged T, pos 0, a mask that crosses pos inside a block,
                  rep 48 (MQA), the serving layout as views of a stacked
                  cache, pos just past a tile and a split's edge, and a
                  cache of every code with both signs at scales from -149
                  up (bf16 q: K/V and P rounded to bf16, held to 2^-8
                  max|v| + one bf16 step); B11's dequantize bit for bit
                  against its previous form over all codes x signs x
                  scales (kv_dequant_rows_f32); B10 at hd 256 and with a
                  sliding window (below, at and across a block, a window
                  of 1, gemma3's 1,024 at its width), B11 at hd 256 (ring,
                  pos past T, all codes); timed at (BH, S, hd) = (128,
                  2048, 128) causal f32 and in bf16 at the serve shape (B
                  8, S 2,048, Hq 32, G 8; library:
                  F.scaled_dot_product_attention, f32 with TF32 off, bf16
                  on expanded kv heads) and at gemma3's (Hq 16, G 8, hd
                  256; global, and local with the window as an explicit
                  mask for the library), B11 at the serve
                  shape with an f32 and a bf16 q beside its bytes bound
                  and its MUFU.EX2 bound (sfu_bound_ms), and with pos a
                  device tensor at live 2,050 of 4,096 (hd 128 and 256)
                  beside the grid a host-int pos sized (host_grid_ms, bit
                  for bit the same output), and on a gemma3 ring.  Then
                  at the GQA shapes of mixtral-8x22b (Hq 48, G 8, hd 128,
                  W 4,096), arctic-480b (Hq 56, G 8, hd 128) and
                  recurrentgemma-2b (Hq 10, G 1, hd 256, W 2,048; rep 6,
                  7 and 10 leave a partial last block of query rows in
                  B11's grid): small cases, then B10 timed at each
                  prefill's shape and B11 at its decode's.  Then B10
                  under autograd (FlashAttentionFn) at a small causal,
                  windowed and T != S shape in f32 and bf16: the output
                  and flash_attention_gqa_bwd's dq, dk, dv against
                  autograd through the plain version (within 1e-5, bf16
                  one bf16 step, of max|g|); B10 timed at the train shape
                  (B 2, S 2,048, Hq 32, G 8, hd 128, causal, bf16) and
                  the backward there beside B10's forward and
                  F.scaled_dot_product_attention's forward and forward +
                  backward, with its TF32 bound.
3. ops          — the kernels/ops.py entry points on one group plane of
                  2^22 amplitudes: quantize_block -> pack_codes ->
                  unpack_codes -> dequantize_block and pack_sign_bitmap ->
                  unpack_sign_bitmap, round trips exact and the decode
                  within b_r; every packing kernel must launch.
4. single_group — repro_torch.core.execute_schedule on every distinct
                  stage schedule of qft-26 (one seeded group of 2^22
                  amplitudes on cuda:0) against execute_schedule_batched
                  with one lane, within 1e-5 relative 2-norm, and one
                  synthetic schedule with a minor-most k = 7 diagonal:
                  gemm_planes and gemm_planes_mid must launch, and
                  diag_apply exactly once for the synthetic op.  Then the
                  same for qft-26's schedules at max_fused_qubits=7, whose
                  dense fused gates of K = 128 run on gemm_planes'
                  tensor-core kernel (it must launch at least once per
                  such GemmOp).
5. main         — repro_torch.Simulator(build_circuit("qft", 26),
                  EngineConfig()).run() on cuda:0 (host codec, default
                  planning).
   dryrun       — python -m repro_torch.launch.dryrun --all, started in the
                  background after the build with no card visible to it
                  (it works on meta tensors, on one host thread beside
                  the kernel phases and main), joined after main: exit 0,
                  the 40 cells, no applicable cell raising; one
                  dryrun_cell line a cell (applicability or skip reason,
                  each device's argument and output bytes, model_flops,
                  counted_flops, the roofline terms from the H100's
                  data-sheet rates).
6. main_device  — the same for qft-28 less its first 70 gates (a depth
                  cut: 15 of qft-28's 32 stages, every op kind kept) with
                  EngineConfig(codec_backend="device") (--device-qubits
                  sets another size, e.g. 26 to compare the two codecs at
                  one size): the codec runs in the encode/decode kernels.
7. main_pergate — qft-26 with EngineConfig(codec_backend="device",
                  gate_schedule=False): the per-gate path, one group at a
                  time; gemm_planes and diag_apply must launch once per
                  dense / diagonal fused gate per group, encode and decode
                  once per group, gemm_planes_batch never.
                  Each main path runs with every launch count set to 0 just
                  before and read just after (the wave paths must launch
                  gemm_planes_batch and gemm_planes_mid_batch); the
                  boundary bytes must equal
                  the plan's; fidelity against the port's dense oracle
                  computed on the card, then sample(1024) and one
                  expectation as readout.  With --profile each run is
                  traced with torch.profiler (CUDA activity only) and a
                  *_profile line gives device time by kernel and the
                  device's idle share of the run's wall time.
8. main_batch   — Simulator(with_depolarizing(build_circuit("qft", 24),
                  0.02), EngineConfig(codec_backend="device"))
                  .run(trajectories=8, seed=0): 8 noise trajectories as
                  one lane-batched run, each wave 2 groups x 8 lanes = 16
                  rows.  Exact launches (gemm_planes_batch once per GemmOp
                  and gemm_planes_mid_batch once per MidGemmOp per wave,
                  encode and decode once per wave, nothing else: no
                  cuBLAS call is left on the wave path), boundary bytes
                  equal to the plan's times 8, each
                  lane's fidelity >= 0.99 against the dense oracle of its
                  realization on the card, BatchResult.expectation of
                  <sum Z> within 1e-2 of the oracles' mean, sample(1024)
                  on lane 0 (with --profile a main_batch_profile line,
                  which must list no library matrix-product kernel).
9. service      — SimService on 4 co-admitted qaoa_template(22) jobs with
                  the device codec at local_bits 18 (8 stages, waves of
                  2 groups x 4 lanes): one merged width-4 run_batch, each
                  lane's state bit for bit that of the job run solo
                  through a fresh SimService; then the first two jobs
                  merged at width 2, bit for bit the same solo runs.
10. precision   — TF32 turned on (set_float32_matmul_precision("high"),
                  allow_tf32 = True): one bound stage of qft-24 through
                  execute_schedule_batched (use_kernel True and False)
                  and execute_schedule (use_kernel False), and
                  simulate_dense at 20 qubits, each within rtol 1e-5,
                  atol 1e-6 of the same call with TF32 off; every flag
                  must read afterwards what the phase set.
11. resilience  — ising-24 on the device codec with the disk tier forced
                  (1 MiB of RAM), checkpointed every 2 stages: a
                  codec.decode crash two thirds of the way in, resumed
                  from its checkpoint, bit for bit the uninterrupted run;
                  a store.spill_read corruption detected and replayed
                  (n_replays >= 1) to the same state.  Prints walls,
                  checkpoint bytes, replays and emergency checkpoints.
12. multidevice — several devices as slots of cuda:0 (paper §4.2):
                  qft-26 on the device codec block-sharded over 4 slots,
                  bit for bit the one-slot run, fidelity >= 0.99, the
                  exchange ledger's blocks equal to a recount from the
                  plan's layouts and device_slot, 0 < exchange bytes <
                  the moved blocks' raw bytes, stage sums = total with
                  stage 0 free, boundary bytes and launches equal to the
                  one-slot run's; noisy qft-20 x 8 trajectories on the
                  host codec lane-sharded over 2 slots, every lane bit
                  for bit and every launch count as on one slot, nothing
                  exchanged; a pipeline.exchange crash at qft-16 on 2
                  slots resumed bit for bit;
                  simulate_dense_sharded(qft-26) over 4 slots within
                  1e-6 of simulate_dense.
13. cli         — python -m repro_torch.launch.qsim --circuit qft
                  --qubits 20 --noise 0.02 --trajectories 4
                  --codec-backend device --expect zsum as a subprocess:
                  exit 0, the batched-run line and the average printed;
                  then qsim --devices 2 on the device codec: exit 0, the
                  slots line and an exchange line with hand-offs.
14. tooling     — the port's host tooling as subprocesses with no card
                  (CUDA_VISIBLE_DEVICES empty, the checkout's src on
                  PYTHONPATH), all started together: python -m
                  repro_torch.analysis src/repro_torch (exit 0, 0
                  violations in every .py of src/repro_torch, none
                  quarantined), --list (the four checkers), --plan on
                  the JSON of a qft-26 plan compiled on cuda:0 here
                  (exit 0, 0 errors, its fingerprint named),
                  repro_torch.analysis.linkcheck README.md docs and
                  repro_torch.analysis.api_doc --check docs/API_torch.md
                  (exit 0 each); one tooling_check line a command.
15. examples    — examples/quickstart_torch.py and
                  examples/qaoa_sim_torch.py, loaded by path and run in
                  this process on cuda:0: quickstart at its defaults
                  (qft-14) prints a fidelity >= 0.99999 and launches
                  gemm_planes_batch; qaoa at its defaults (18 qubits, 3
                  points) prints 3 runs and no stage-fn compile after
                  run 1; qaoa at 12 qubits, block bits 7, 2 points on
                  the card and with --device cpu: <cut> within 1e-4
                  relative.  One example_check line a run; the card
                  runs' launches add to the report's.
16. serve       — qwen3-4b at full width and depth (4.0 B bf16 weights
                  drawn on cuda:0 from --seed): make_prefill_step on 8
                  random prompts of 2,048 tokens with max_len 4,096 (36
                  flash_attention launches), compress_prefill_cache, then
                  from two copies of that cache 32 greedy steps of
                  make_compressed_decode_step, eagerly and through
                  serving.CapturedDecodeStep (one CUDA graph a step,
                  captured before the timed steps): their logits bit for
                  bit equal at every step, 1,152 kv_dequant_decode_attention
                  launches each (the captured run's counted by the step:
                  recorded at capture x replays; with --profile the
                  trace's kvdq_partial_kernel count must equal it); then
                  the same prompts through the same functions with the two
                  kernels' plain versions patched in (0 launches),
                  teacher-forced on the captured run's tokens: every
                  step's logits within 2e-2 * max|logits|; compressed
                  cache >= 1.7x smaller than bf16.  Prints prefill s,
                  decode ms a step and tokens/s of both runs, the weights'
                  read time at 3.35 TB/s, peak device memory (and with
                  --profile each run's device busy and idle share).  Then
                  serve_seqattn on the same weights and prompts: the
                  config with seq_parallel_attn=True, prefill (36 B10
                  launches) and 32 captured compressed steps, every
                  logits tensor bit for bit the captured run's.
17. serve_gemma3 — gemma3-12b at full width and depth (48 layers, 40
                  sliding-window ones of W 1,024 and 8 global, hd 256;
                  11.8 B bf16 weights drawn after qwen3-4b's are freed),
                  the same prompts: prefill longer than the window (48
                  windowed / global B10 launches; the local layers' caches
                  are rings of 1,024), 16 captured compressed decode steps
                  (48 B11 a step), the plain teacher-forced run within
                  2e-2, cache >= 1.7x smaller than bf16.
18-21. serve_mixtral, serve_arctic, serve_recurrentgemma, serve_xlstm —
                  the MoE and recurrent models (ROADMAP A12c, A12d) through
                  the same serving entry points and checks, each after the
                  last one's memory is freed, 8 captured and 8 eager
                  compressed decode steps from two copies of one cache
                  (bit for bit equal): mixtral-8x22b cut to 4 of 56 layers
                  (10.2 B weights: windowed attention, W 4,096, 8
                  experts top-2), arctic-480b cut to 2 of 35 (27.5 B: 128
                  experts top-2 and the dense residual branch),
                  recurrentgemma-2b whole (26 layers: 18 RG-LRU, 8
                  windowed attention, W 2,048, hd 256, one kv head) and
                  xlstm-125m whole (12 mLSTM / sLSTM layers, no
                  attention).  B10 and B11 launch once a prefill and once
                  a step per attention layer (none for xlstm); the cache
                  ratio reads the attention caches only (xlstm: a line
                  says it has none); MoE phases record both runs'
                  expert sets, print the share of (token, layer) sets
                  that differ, and hold the (step, row) logits where the
                  token's sets agree to 2e-2 and where they parted to
                  MOE_PARTED_RTOL.  In every serve phase the plain run's
                  B10 goes a batch row at a time, and the phase prints
                  its peak device memory.
22. serve_llama_vision — llama-3.2-vision-90b (ROADMAP A12e) at full
                  width cut to 10 of its 100 layers (2 units of 4
                  self-attention and 1 cross-attention layer, 10.7 B
                  weights), 576 image embeddings from --seed as the
                  stub frontend's output: prefill (8 self-attention B10
                  launches and 2 cross-attention ones over the 576 image
                  tokens), the compressed cache (image k/v included), 8
                  eager and 8 captured steps bit for bit equal (10 B11 a
                  step: the cross layers' over every image slot), the
                  plain run within 2e-2, the attention cache (self and
                  cross) >= 1.7x smaller than bf16.
23. serve_whisper — whisper-large-v3 whole (32 encoder and 32 decoder
                  layers, 1.5 B weights), 8 x 1,500 frames from --seed as
                  the stub conv frontend's output and a 64-token decoder
                  prompt, max_len 512 (its dec_len): 96 B10 launches a
                  prefill (32 non-causal encoder, 32 causal decoder, 32
                  cross over the 1,500 frames), then 16 eager and 16
                  captured raw decode steps (repro decodes whisper on raw
                  caches: no hand kernel a step), bit for bit equal, and
                  the plain run within 2e-2.
24. train       — qwen3-4b whole (36 layers, 4.02 B bf16 weights from
                  --seed) trained on cuda:0 through
                  repro_torch.train.step: step 0's loss and gradients
                  through B10 (72 launches: 36 in the forward, 36 in the
                  remat recompute; the torch backward
                  flash_attention_gqa_bwd) and again with its plain
                  version patched in (0 launches; autograd through it):
                  loss within 1e-3, each gradient leaf at cosine >= 0.999
                  and max|Δ|/max|g| <= 0.1 (printed per leaf), every
                  leaf's gradient nonzero and finite;
                  then 4 steps of make_train_step (the config's AdamW,
                  f32 moments, lr 3e-4, remat on; B 2 x S 2,048 tokens of
                  SyntheticTokens(--seed)), 72 B10 launches and a finite
                  loss each; prints each step's loss, grad_norm and wall
                  time, tokens/s and peak memory (with --profile the
                  last step's device time: GEMMs, B10, the attention
                  backward, the optimizer; that step is left out of the
                  mean step time and tokens/s).
25. train_gc    — qwen3-4b at full width cut to 4 of 36 layers (printed)
                  with GradCompressor(1e-2) for 4 steps: residuals and
                  losses finite, no gradient cut, one leaf's round trip
                  within 1.01 b_r wherever its code is nonzero.
26. train_runtime — reduced qwen3-4b through TrainRuntime on cuda:0,
                  checkpoints every step in a temporary directory: a
                  failure injected at step 2, restarted from the last
                  checkpoint, equal bit for bit (parameters and optimizer
                  state) to an uninterrupted run; then python -m
                  repro_torch.launch.train --arch qwen3-4b --steps 3 as a
                  subprocess, its [train] line printed.
27. train_sharded — the train step sharded FSDP x TP by hand over
                  torch.distributed (ROADMAP A12h): the train phase's run
                  (qwen3-4b whole, B 2 x S 2,048, AdamW, remat, 4 steps)
                  again through make_train_step(..., mesh=...) on a 1x1
                  mesh over NCCL, 72 B10 launches and a finite grad_norm
                  a step, each loss within 1e-5 of the train phase's, its
                  step time and peak memory printed beside them; then a
                  2x2 mesh as four spawned processes of cuda:0 over gloo
                  (host copies: NCCL refuses two ranks on one card),
                  qwen3-4b at full width cut to 4 of 36 layers, 3 steps
                  on each data rank's rows of the global batch, against
                  the one-device run of the same cut model and data: each
                  step's loss within 1e-3, every gathered leaf moved,
                  within 3 x (2 lr + 2^-7 max|w|) and its updates at
                  cosine >= 0.99, B10 at the local head counts (16/4 of
                  32/8) 8 times a step on every rank, and every rank's
                  collective bytes by kind equal to the dry run's
                  collective_bytes plus the terms it leaves out
                  (train.step.sharded_extra_bytes).  A rank that fails
                  fails the phase.
28. report      — one JSON line of kernels (B10's and B11's launches
                  summed over the serve and train phases, train_sharded's
                  ranks included), the card's name and power limit, and
                  last the ok line.

It imports nothing of JAX and nothing of the JAX package.  Without CUDA,
or without the repository around it, it exits non-zero.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_QUBITS = 26                 # host codec path
DEVICE_QUBITS = 28               # device codec path
#: main_device's depth cut (PR 24, keeping the smoke's length with the
#: multidevice phase added): the QFT less its first 70 gates (the top
#: qubits' first rows), 15 stages of qft-28's 32 with every op kind kept
#: (GemmOps, MidGemmOps, diagonals); still 28 qubits wide
DEVICE_SKIP_GATES = 70
FIDELITY_MIN = 0.99
RTOL, ATOL = 1e-5, 1e-6          # f32 summation order differs from cuBLAS
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM tensor cores, dense TF32
BF16_FLOP_PER_S = 989e12         # H100 SXM tensor cores, dense bf16
SPLIT_TF32 = 3                   # split TF32: three TF32 products a product
SFU_PER_SM_CLOCK = 16            # MUFU.EX2 results an SM a clock (CC 9.0)
SMS = 132                        # H100 SXM
HOST_AHEAD_CYCLES = 100_000_000  # ~50 ms of card clock: the host's queue time
COLD_BYTES = 128 << 20           # inputs cycled per timing, > 2x the L2
# the codec kernels against their plain versions (ROADMAP "The pwrel
# tolerance"): log2f is accurate to 1 ulp, so a code may differ by 1 at a
# rounding tie, in at most 0.1% of elements; exp2f to 2 ulp
B_R = 1e-3
CODE_DIFF_SHARE = 1e-3
DECODE_RTOL = 1e-6
ROUNDTRIP_BOUND = 1.01 * B_R     # b_r + the f32 slack of ROADMAP C
CODEC_MAIN = (2, 4, 1 << 20)     # (rows, blocks per row, n): a qft-28 wave
CODEC_RAGGED = (77, 192, 1000, 4097)
GATE_ATOL = 1e-4                 # B6-B8 against their plain versions
GROUP_BITS = 22                  # a qft-26 / qft-28 group: 2^22 amplitudes
GROUP = 1 << GROUP_BITS
BATCH_QUBITS = 24                # main_batch: noisy qft-24 ...
BATCH_LANES = 8                  # ... as 8 trajectories (README's recipe)
BATCH_NOISE = 0.02
TRAJ_AVG_ATOL = 1e-2             # BatchResult.expectation vs the oracles'
SERVICE_QUBITS = 22              # service: 4 qaoa_template(22) jobs
SERVICE_JOBS = 4
SERVICE_BUDGET = 16 << 30
#: the planner's heuristic pick at n = 22 without a budget (under the
#: service's budget it would hold the state in one block, one stage):
#: 8 stages, a wave 2 groups x 4 lanes with MidGemmOps among its ops
SERVICE_LOCAL_BITS = 18
SCHEDULE_RTOL = 1e-5             # execute_schedule vs the batched form
PRECISION_DENSE_QUBITS = 20      # precision: simulate_dense with TF32 on
#: resilience: ising-24 (its amplitudes take many magnitudes, so the
#: codec's codes take many values; 12 stages of 4 groups), checkpointed
#: every 2 stages with the disk tier forced
RESILIENCE_CIRCUIT = ("ising", 24)
RESILIENCE_EVERY = 2
RESILIENCE_RAM = 1 << 20
#: multidevice: qft-26 block-sharded over 4 slots of cuda:0 on the device
#: codec, noisy qft-20 x 8 trajectories lane-sharded over 2 slots on the
#: host codec, a pipeline.exchange crash at qft-16 on 2 slots, and the
#: sharded dense baseline at 26 qubits over 4 slots
MULTI_QUBITS = 26
MULTI_SLOTS = 4
MULTI_LANE_QUBITS = 20
MULTI_LANE_SLOTS = 2
MULTI_CRASH_QUBITS = 16          # the same 8 stages and 48 hand-offs as 20
MULTI_DENSE_ATOL = 1e-6
ATTN_ATOL = 2e-4                 # B10/B11 vs plain, the Pallas tests' bound
BF16_RTOL = 2.0 ** -7            # one bf16 step: ulp(x) <= 2^-7 |x|
KV_ORDER_TOL = 2.0 ** -15        # of max|v|: B11 vs its plain version in its
#                                  own order (see kvdq_check)
SERVE_ARCH = "qwen3-4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN, SERVE_STEPS = 8, 2048, 4096, 32
SERVE_LOGIT_RTOL = 2e-2          # of max|logits|: tests/test_serving.py's
#: an MoE model's (step, row) logits where that token's expert set at
#: some layer differs between the kernel and the plain run (bf16 noise
#: flips a near-tie of two router probabilities): the token then takes
#: another expert's output
#: (measured 2.77% on one H100, 2 of mixtral's 72 (step, row) pairs;
#: where the routing agrees, 0.42% under SERVE_LOGIT_RTOL)
MOE_PARTED_RTOL = 1e-1
KV_RATIO_MIN = 1.7
GEMMA_ARCH, GEMMA_STEPS = "gemma3-12b", 16   # serve_gemma3: 16 captured steps
GEMMA_WINDOW = 1024                          # its local layers' window
#: the MoE and recurrent serve phases: (label, arch, layers kept or None
#: for the whole depth).  mixtral-8x22b and arctic-480b are cut in depth
#: to fit the card (4 of 56 layers, 10.2 B parameters; 2 of 35, 27.5 B);
#: recurrentgemma-2b and xlstm-125m run whole
HYBRID_PHASES = [("serve_mixtral", "mixtral-8x22b", 4),
                 ("serve_arctic", "arctic-480b", 2),
                 ("serve_recurrentgemma", "recurrentgemma-2b", None),
                 ("serve_xlstm", "xlstm-125m", None)]
HYBRID_STEPS = 8                             # captured steps a phase
#: their attention layers' (Hq, G, hd, window): rep 6, 7 and 10 leave a
#: partial last block of query rows in B11's grid; recurrentgemma has one
#: kv head
HYBRID_GQA = [(48, 8, 128, 4096), (56, 8, 128, 0), (10, 1, 256, 2048)]
#: serve_llama_vision: llama-3.2-vision-90b cut in depth to 10 of its 100
#: layers (2 units of 4 self- and 1 cross-attention layer, 10.7 B
#: parameters; whole it needs several cards), 8 captured steps
VISION_ARCH, VISION_LAYERS, VISION_STEPS = "llama-3.2-vision-90b", 10, 8
#: serve_whisper: whisper-large-v3 whole, a 64-token decoder prompt, 16
#: raw decode steps (its max_len is its dec_len, 512)
WHISPER_ARCH, WHISPER_PROMPT, WHISPER_STEPS = "whisper-large-v3", 64, 16
#: (B, S, T, Hq, G, hd, causal) of B10 at the two models' prefill shapes:
#: llama-vision's cross layers over 576 image tokens, whisper's encoder
#: (non-causal over 1,500 frames) and its decoder's cross layers
CROSS_FLASH = [(SERVE_BATCH, SERVE_PROMPT, 576, 64, 8, 128, False),
               (SERVE_BATCH, 1500, 1500, 20, 20, 64, False),
               (SERVE_BATCH, WHISPER_PROMPT, 1500, 20, 20, 64, False)]
#: training: qwen3-4b whole, B 2 x S 2,048 tokens of SyntheticTokens(seed)
#: a step, TRAIN_STEPS steps of the config's AdamW (f32 moments) at lr
#: TRAIN_LR with remat; step 0 (B10 and its torch backward) against
#: autograd through the plain version: the loss within TRAIN_LOSS_RTOL,
#: each gradient leaf at cosine >= TRAIN_GRAD_COS and max|Δg|/max|g| <=
#: TRAIN_GRAD_RTOL (measured on one H100: 9.7e-5, 1 - 5e-5, 0.040)
TRAIN_ARCH = "qwen3-4b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 4, 3e-4
TRAIN_LOSS_RTOL, TRAIN_GRAD_COS, TRAIN_GRAD_RTOL = 1e-3, 0.999, 0.1
#: train_gc: qwen3-4b cut to 4 layers, GradCompressor(1e-2)
TRAIN_GC_LAYERS, TRAIN_GC_BR = 4, 1e-2
#: train_runtime: reduced qwen3-4b, a failure at step 2 of 5
RUNTIME_STEPS, RUNTIME_FAIL_AT = 5, 2
#: train_sharded: the train phase's run again through the sharded step on
#: a 1x1 mesh over NCCL, each step's loss within SHARDED_1X1_LOSS_RTOL of
#: the train phase's (measured on one H100: equal, 0.0); then a 2x2 mesh
#: as four processes of cuda:0 over
#: gloo, qwen3-4b cut to TRAIN_GC_LAYERS layers, SHARDED_STEPS steps of
#: the global batch (each data rank its rows) against the one-device run
#: of the same cut model and data: each step's loss within
#: SHARDED_LOSS_RTOL (bf16, tests/test_torch_sharded_train.py's; measured
#: 2.3e-5, 3.5e-4, 5.0e-4); each gathered leaf after the steps moved from
#: its initial value, its three updates at cosine >= SHARDED_UPDATE_COS
#: with the one-device run's (measured >= 0.99928), and every element
#: within what the steps can part it by: a step moves an element about lr
#: either way in each run (an element whose gradient is near 0 takes its
#: sign from rounding) and rounds it once to bf16, so SHARDED_STEPS x (2
#: lr + 2^-7 max|w|) (measured: 60% of it at worst)
SHARDED_MESH, SHARDED_STEPS = (2, 2), 3
SHARDED_1X1_LOSS_RTOL = 1e-5
SHARDED_LOSS_RTOL = 1e-3
SHARDED_UPDATE_COS = 0.99
SHARDED_TIMEOUT_S = 600
#: (B, S, T, Hq, G, hd, causal, window) of B10's autograd checks: causal,
#: windowed, and over T != S keys; gradients within GRAD_RTOL (f32) or
#: BF16_TOL_GRAD (bf16, one bf16 step) of max|g|
TRAIN_GRAD = [(2, 256, 256, 8, 2, 128, True, 0),
              (1, 300, 300, 4, 2, 256, True, 100),
              (2, 130, 77, 8, 2, 64, False, 0)]
GRAD_RTOL, BF16_TOL_GRAD = 1e-5, 2.0 ** -7


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, inputs, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call ``fn(*args)``: CUDA events around ``iters``
    calls after ``warmup``, cycling through the argument tuples
    ``inputs`` (see :func:`cold_copies`).  A sleep kernel holds the card
    while the host queues every call, so a kernel shorter than its
    wrapper's host overhead is timed on the card, not on the host."""
    import torch
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_copies(args: tuple, big: tuple[int, ...]) -> list[tuple]:
    """``args`` and as many copies of it as make a timing loop that cycles
    through them find its large inputs out of the 50 MB L2 cache, as a
    caller streaming fresh data would: the tensors at positions ``big``
    are cloned (COLD_BYTES of them in all), the rest shared."""
    nbytes = sum(args[i].numel() * args[i].element_size() for i in big)
    copies = [tuple(args)]
    while len(copies) * nbytes < COLD_BYTES:
        copies.append(tuple(a.clone() if i in big else a
                            for i, a in enumerate(args)))
    return copies


def bound(nbytes: int, ops: int, rate: float = F32_FLOP_PER_S
          ) -> tuple[float, str]:
    """The least time the card could take: bytes over its memory rate or
    operations over the peak ``rate`` of the arithmetic that does them
    (default f32 FMAs on the CUDA cores; split TF32 passes
    SPLIT_TF32 * ops at TF32_FLOP_PER_S, bf16 BF16_FLOP_PER_S), whichever
    is larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / rate * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def bounds(nbytes: int, flops: int, ops: int, rate: float) -> dict:
    """A timed row's bound under the kernel's own arithmetic (``ops`` at
    ``rate``: what ``bound_ms`` reports) beside the bound as f32 FMAs on
    the CUDA cores (``flops`` at F32_FLOP_PER_S)."""
    b, by = bound(nbytes, ops, rate)
    bf, bfy = bound(nbytes, flops)
    return {"bound_ms": b, "bound_by": by, "bound_f32_fma_ms": bf,
            "bound_f32_fma_by": bfy, "bytes": nbytes, "flops": flops}


# -- phase 1: the tensor-core kernels, shown in the built code ----------------

#: source -> symbols of the kernels that must run on the tensor cores
TENSOR_CORE_KERNELS = {
    "gate_apply": ("gemm_planes_tc_kernel",),
    "attention": ("flash_bf16_kernel", "flash_f32_kernel"),
}
#: source -> symbols of the CUDA-core kernels whose registers and spills
#: are printed too (the ring bodies of B1/B6 and B7 at K <= 32, B11)
PTXAS_KERNELS = {"gate_apply": ("gemm_planes_ring_kernel",
                                "gemm_planes_mid_ring_kernel"),
                 "attention": ("kvdq_partial_kernel",)}


def ptxas_lines(text: str) -> dict[str, list[str]]:
    """``nvcc -Xptxas -v`` output by entry function: its register and
    spill lines."""
    out: dict[str, list[str]] = {}
    fn = None
    for ln in text.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln.split()[-1]
            out.setdefault(fn, [])
        elif fn and ("registers" in ln or "spill" in ln):
            out[fn].append(" ".join(ln.replace("ptxas info    :", "")
                                    .split()))
    return out


def tensor_core_check(build, log) -> None:
    """For each redesigned kernel instantiation: its ``ptxas -v`` registers
    and spills, and for the tensor-core ones the number of HMMA / HGMMA
    instructions in its SASS (``cuobjdump -sass`` of the built library); 0
    fails the smoke."""
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name, symbols in TENSOR_CORE_KERNELS.items():
        shown = symbols + PTXAS_KERNELS.get(name, ())
        for fn, lines in ptxas_lines(log[name][1]).items():
            if any(sym in fn for sym in shown):
                print(f"kernel_ptxas {fn} " + " | ".join(lines), flush=True)
        lib = build._target(name)[1]
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=300)
        if out.returncode != 0:
            fail(f"cuobjdump -sass {lib.name} failed: {out.stderr.strip()}")
        counts: dict[str, int] = {}
        fn = None
        for ln in out.stdout.splitlines():
            if "Function :" in ln:
                fn = ln.split("Function :")[1].strip()
                if any(sym in fn for sym in symbols):
                    counts[fn] = 0
                else:
                    fn = None
            elif fn and ("HMMA" in ln or "HGMMA" in ln):
                counts[fn] += 1
        if not counts:
            fail(f"no {symbols} in the SASS of {lib.name}")
        for fn, n in counts.items():
            print(f"kernel_sass {fn} hmma={n}", flush=True)
            if n <= 0:
                fail(f"{fn} has no HMMA/HGMMA instruction: it does not run "
                     "on the tensor cores")


# -- phase 2: gemm_planes_batch against its plain version ---------------------

def gemm_case(L: int, R: int, K: int, broadcast: bool, seed: int,
              timed: bool, offset: int = 0, tiled: int = 0) -> dict:
    """One shape of gemm_planes_batch on the card: agreement with the
    plain version, and (when ``timed``) kernel / plain / library times
    beside the bound.  ``offset`` floats shift the planes off 16-byte
    alignment (the kernel's 4-byte copy path).  ``tiled`` = D lanes: the
    L operand rows are D lanes' U tiled groups-major (row w is lane
    w % D), as a batched wave of L / D groups passes them."""
    import numpy as np
    import torch
    from repro_torch.kernels.gate_apply import gemm_planes_batch
    from repro_torch.kernels.ref import gemm_planes_batch_ref

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    planes = torch.randn((L * 2 * R * K + offset,), generator=g,
                         device=dev)[offset:].reshape(L, 2, R * K)
    ar = planes[:, 0].reshape(L, R, K)           # lane stride 2RK, as a wave
    ai = planes[:, 1].reshape(L, R, K)
    U = torch.randn((1 if broadcast else tiled or L, 2, K, K),
                    generator=g, device=dev) / np.sqrt(K)
    if broadcast:                                # one U, lane stride 0
        U = U.expand(L, 2, K, K)
    elif tiled:                                  # a batched wave's rows
        U = U.repeat(L // tiled, 1, 1, 1)
    br, bi = U[:, 0].transpose(1, 2), U[:, 1].transpose(1, 2)   # U^T views
    cr, ci = gemm_planes_batch(ar, ai, br, bi)
    rr, ri = gemm_planes_batch_ref(ar, ai, br, bi)
    torch.cuda.synchronize()
    err = max(float((cr - rr).abs().max()), float((ci - ri).abs().max()))
    ok = (torch.allclose(cr, rr, rtol=RTOL, atol=ATOL)
          and torch.allclose(ci, ri, rtol=RTOL, atol=ATOL))
    out = {"L": L, "R": R, "K": K, "broadcast": broadcast,
           "tiled": tiled, "offset": offset, "max_abs_err": err,
           "ok": bool(ok)}
    if not timed:
        return out
    n_b = 1 if broadcast else L
    bytes_moved = 4 * (2 * L * R * K + 2 * n_b * K * K + 2 * L * R * K)
    flops = 8 * L * R * K * K
    b, by = bound(bytes_moved, flops)
    inputs = [(p[:, 0].reshape(L, R, K), p[:, 1].reshape(L, R, K), br, bi)
              for (p,) in cold_copies((planes,), (0,))]
    lib = [(torch.complex(a, c), torch.complex(br, bi))
           for a, c, _, _ in inputs]
    out.update(
        ms=cuda_ms(gemm_planes_batch, inputs),
        plain_ms=cuda_ms(gemm_planes_batch_ref, inputs),
        library_ms=cuda_ms(torch.matmul, lib),
        bound_ms=b, bound_by=by, bytes=bytes_moved, flops=flops)
    return out


#: (L, R, K, broadcast, offset) of the ring body (K <= 32): three lanes
#: with B at lane stride 0 and R*K past 2^22 by a ragged tile, so every
#: block walks several tiles of the ring; R*K not a multiple of 4 and
#: planes one float off 16-byte alignment; one lane of a few rows
RING_SHAPES = [s for K in (2, 4, 8, 16, 32)
               for s in ((3, (1 << 22) // K + 3, K, True, 0),
                         (2, 1001, K, False, 1), (1, 777, K, True, 0))]


#: (L, K) of a batched wave: 2 groups of 2^22 amplitudes x BATCH_LANES
#: trajectories (main_batch), every row with its lane's own operand
BATCH_WAVE_SHAPES = [(16, 32), (16, 16)]


def kernel_phase() -> dict:
    main_shapes = [(2, (1 << 22) // K, K) for K in (16, 32)]
    small = [(3, 5, 2, False), (1, 7, 4, True), (2, 64, 8, False),
             (3, 33, 16, True), (2, 100, 32, False), (2, 40, 64, True),
             (3, 9, 128, False)]
    cases = []
    for i, (L, R, K) in enumerate(main_shapes):
        cases.append(gemm_case(L, R, K, True, seed=i, timed=True))
    for i, (L, R, K, bc) in enumerate(small):
        cases.append(gemm_case(L, R, K, bc, seed=100 + i, timed=False))
    for i, (L, R, K, bc, off) in enumerate(RING_SHAPES):
        cases.append(gemm_case(L, R, K, bc, seed=400 + i, timed=False,
                               offset=off))
    for i, (L, K) in enumerate(BATCH_WAVE_SHAPES):
        cases.append(gemm_case(L, GROUP // K, K, False, seed=500 + i,
                               timed=True, tiled=BATCH_LANES))
    for c in cases:
        print("kernel_check gemm_planes_batch " + json.dumps(c), flush=True)
        if not c["ok"]:
            fail(f"gemm_planes_batch disagrees with its plain version at "
                 f"L={c['L']} R={c['R']} K={c['K']} offset={c['offset']} "
                 f"tiled={c['tiled']}: "
                 f"max abs err {c['max_abs_err']:.3e} (rtol {RTOL}, atol "
                 f"{ATOL})")
    return {"gemm_planes_batch": cases}


# -- phase 2: the codec kernels against their plain versions -----------------

def codec_stack(R: int, nb: int, n: int, seed: int):
    """An (R, 2, nb*n) plane stack: its last plane all zeros, the one
    before state-like, the rest log-uniform over 60 octaves with random
    signs and 2% exact zeros."""
    import torch
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    P = 2 * R * nb
    x = torch.exp2(-60.0 * torch.rand((P, n), generator=g, device=dev))
    x = torch.where(torch.rand((P, n), generator=g, device=dev) < 0.5, -x, x)
    x[torch.rand((P, n), generator=g, device=dev) < 0.02] = 0.0
    z = torch.randn((2, n), generator=g, device=dev)
    x[P - 2] = z[0] / z.norm()
    x[P - 1] = 0.0
    return x.reshape(R, nb, 2, n).transpose(1, 2).reshape(R, 2, nb * n) \
        .contiguous()


def codec_case(R: int, nb: int, n: int, seed: int, timed: bool) -> dict:
    """The fused encode and decode kernels at one shape: encode against its
    plain version (sign words and flags equal, codes within one), decode
    against its plain version on identical codes, encode -> decode within
    b_r; with ``timed``, kernel / plain times beside the bytes bound."""
    import torch
    from repro_torch.compression.pwrel import log_step
    from repro_torch.kernels import codec as kc
    from repro_torch.kernels import ref

    step = log_step(B_R)
    planes = codec_stack(R, nb, n, seed)
    P = 2 * R * nb
    l_max = kc.plane_l_max(planes, n)
    ck, sk, fk = kc.encode_planes(planes, n, l_max, step, flags_tile_rows=8)
    cr, sr, fr = ref.encode_planes_ref(planes, n, l_max, step, 8)
    dcode = ((ck.to(torch.int32) & 0xFFFF) - (cr.to(torch.int32) & 0xFFFF)) \
        .abs()
    out_k = torch.empty_like(planes)
    out_r = torch.empty_like(planes)
    kc.decode_planes(ck, sk, l_max, step, out_k, n)
    ref.decode_planes_ref(ck, sk, l_max, step, out_r, n)
    # through a plane map: wire plane j lands on stack plane P-1-j
    rev = torch.arange(P - 1, -1, -1, dtype=torch.int32, device=planes.device)
    back = rev.long()
    map_k = torch.empty_like(planes)
    map_r = torch.empty_like(planes)
    kc.decode_planes(ck[back].contiguous(), sk[back].contiguous(),
                     l_max[back].contiguous(), step, map_k, n, rev)
    ref.decode_planes_ref(ck[back], sk[back], l_max[back], step, map_r, n,
                          rev)
    torch.cuda.synchronize()
    nz = out_r != 0
    dec_rel = float(((out_k - out_r).abs()[nz] / out_r.abs()[nz]).max()) \
        if bool(nz.any()) else 0.0
    xnz = planes != 0
    trip = float(((out_k - planes).abs()[xnz] / planes.abs()[xnz]).max())
    out = {
        "R": R, "blocks": nb, "n": n, "planes": P,
        "max_code_diff": int(dcode.max()),
        "code_diff_share": float((dcode != 0).sum()) / (P * n),
        "signs_equal": bool(torch.equal(sk, sr)),
        "flags_equal": bool(torch.equal(fk, fr)),
        "decode_max_rel": dec_rel,
        "decode_max_abs": float((out_k - out_r).abs().max()),
        "decode_zeros_equal": bool(torch.equal(out_k[~nz], out_r[~nz])),
        "plane_map_max_rel": float(
            ((map_k - map_r).abs()[nz] / map_r.abs()[nz]).max())
        if bool(nz.any()) else 0.0,
        "roundtrip_max_rel": trip,
        "roundtrip_zeros": bool((out_k[~xnz] == 0).all()),
    }
    out["ok"] = (out["max_code_diff"] <= 1
                 and out["code_diff_share"] <= CODE_DIFF_SHARE
                 and out["signs_equal"] and out["flags_equal"]
                 and dec_rel <= DECODE_RTOL and out["decode_zeros_equal"]
                 and out["plane_map_max_rel"] <= DECODE_RTOL
                 and trip <= ROUNDTRIP_BOUND and out["roundtrip_zeros"])
    if not timed:
        return out
    words = -(-n // 32)
    wire = P * (2 * n + 4 * words)           # u16 codes + sign words
    enc_bytes = P * 4 * n + P * 4 + wire     # planes and l_max in, wire out
    dec_bytes = wire + P * 4 + P * 4 * n     # wire and l_max in, planes out
    # f32 operations per element: encode abs, log2, sub, div, rint, sub,
    # two clips; decode sub, mul, sub, exp2 (the bytes bound is ~10x more)
    enc_ops, dec_ops = 8 * P * n, 4 * P * n

    eb, eby = bound(enc_bytes, enc_ops)
    db, dby = bound(dec_bytes, dec_ops)
    enc_in = cold_copies((planes, n, l_max, step), (0,))
    dec_in = cold_copies((ck, sk, l_max, step, out_k, n), (0, 1))
    out["encode"] = {
        "ms": cuda_ms(kc.encode_planes, enc_in),
        "plain_ms": cuda_ms(ref.encode_planes_ref, enc_in),
        "bound_ms": eb, "bound_by": eby, "bytes": enc_bytes}
    out["decode"] = {
        "ms": cuda_ms(kc.decode_planes, dec_in),
        "plain_ms": cuda_ms(ref.decode_planes_ref, dec_in),
        "bound_ms": db, "bound_by": dby, "bytes": dec_bytes}
    return out


def tiles_case(rows: int, tile_rows: int, seed: int) -> dict:
    """The TPU-layout wrappers quantize_tiles / dequantize_tiles (the same
    kernels with int32 codes) against their plain versions."""
    import torch
    from repro_torch.compression.pwrel import log_step
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref

    step = log_step(B_R)
    x = codec_stack(1, 2, rows * 32, seed).reshape(rows, 128)
    l_max = torch.log2(x.abs().max()).reshape(1, 1)
    ck, pk, fk = qz.quantize_tiles(x, l_max, step, tile_rows=tile_rows)
    cr, pr, fr = ref.quantize_tiles_ref(x, l_max, step, tile_rows)
    dk = qz.dequantize_tiles(ck, pk, l_max, step)
    dr = ref.dequantize_tiles_ref(ck, pk, l_max, step)
    torch.cuda.synchronize()
    dcode = (ck - cr).abs()
    nz = dr != 0
    rel = float(((dk - dr).abs()[nz] / dr.abs()[nz]).max())
    out = {"rows": rows, "tile_rows": tile_rows,
           "max_code_diff": int(dcode.max()),
           "code_diff_share": float((dcode != 0).sum()) / x.numel(),
           "signs_equal": bool(torch.equal(pk, pr)),
           "flags_equal": bool(torch.equal(fk, fr)),
           "decode_max_rel": rel,
           "decode_zeros_equal": bool(torch.equal(dk[~nz], dr[~nz]))}
    out["ok"] = (out["max_code_diff"] <= 1
                 and out["code_diff_share"] <= CODE_DIFF_SHARE
                 and out["signs_equal"] and out["flags_equal"]
                 and rel <= DECODE_RTOL and out["decode_zeros_equal"])
    return out


def codec_phase() -> dict:
    cases = [codec_case(*CODEC_MAIN, seed=0, timed=True)]
    for i, n in enumerate(CODEC_RAGGED):
        cases.append(codec_case(1, 3, n, seed=10 + i, timed=False))
    for c in cases:
        print("kernel_check codec " + json.dumps(c), flush=True)
        if not c["ok"]:
            fail(f"the codec kernels disagree with their plain versions at "
                 f"n={c['n']}: {json.dumps(c)}")
    tiles = [tiles_case(r, 8, seed=20 + r) for r in (1, 8, 24, 33)]
    for c in tiles:
        print("kernel_check codec_tiles " + json.dumps(c), flush=True)
        if not c["ok"]:
            fail(f"quantize_tiles/dequantize_tiles disagree with their "
                 f"plain versions at rows={c['rows']}: {json.dumps(c)}")
    return {"codec": cases, "codec_tiles": tiles}


# -- phase 2: the single-group gate kernels against their plain versions ------

def unit_planes(shape, seed: int, offset: int = 0):
    """Two unit-scale f32 planes of ``shape`` on the card, ``offset``
    floats past the start of their buffer (1: off 16-byte alignment)."""
    import math

    import torch
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    n = math.prod(shape)
    p = torch.randn((2 * n + offset,), generator=g, device="cuda:0")
    p = p[offset:].reshape((2,) + tuple(shape))
    return p[0], p[1]


def gate_check(name: str, fn, ref_fn, args, big, timed: bool, nbytes: int,
               ops: int, library=None, split_tf32: bool = False,
               tight: bool = False, **shape) -> dict:
    """One call of a gate kernel against its plain version on the same
    inputs (max abs error <= GATE_ATOL; ``tight``: within RTOL, ATOL, as
    B1, for B6's ring body at K <= 32); with ``timed``, kernel / plain /
    library times beside the bound, over cold copies of the ``big``
    inputs (``library`` maps an argument tuple to the library call's
    arguments: one PyTorch call, ``torch.matmul`` or a multiply).
    ``split_tf32``: the kernel's products run as split TF32 on the tensor
    cores, so its own bound counts three TF32 products a product."""
    import torch
    cr, ci = fn(*args)
    rr, ri = ref_fn(*args)
    torch.cuda.synchronize()
    err = max(float((cr - rr).abs().max()), float((ci - ri).abs().max()))
    ok = err <= GATE_ATOL
    if tight:
        ok = (torch.allclose(cr, rr, rtol=RTOL, atol=ATOL)
              and torch.allclose(ci, ri, rtol=RTOL, atol=ATOL))
    out = {**shape, "max_abs_err": err, "ok": bool(ok)}
    if tight:
        out["tolerance"] = [RTOL, ATOL]
    if timed:
        inputs = cold_copies(args, big)
        lib_fn, lib_args = library
        out.update(ms=cuda_ms(fn, inputs),
                   plain_ms=cuda_ms(ref_fn, inputs),
                   library_ms=cuda_ms(lib_fn, [lib_args(a) for a in inputs]),
                   **(bounds(nbytes, ops, SPLIT_TF32 * ops, TF32_FLOP_PER_S)
                      if split_tf32 else bounds(nbytes, ops, ops,
                                                F32_FLOP_PER_S)))
        out["arithmetic"] = "split TF32" if split_tf32 else "f32 FMA"
    print(f"kernel_check {name} " + json.dumps(out), flush=True)
    if not out["ok"]:
        fail(f"{name} disagrees with its plain version at {shape}: max abs "
             f"err {err:.3e} (bound "
             f"{f'rtol {RTOL}, atol {ATOL}' if tight else GATE_ATOL})")
    return out


def gemm_planes_case(R: int, K: int, seed: int, timed: bool,
                     offset: int = 0) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import gate_apply as ga
    from repro_torch.kernels import ref
    ar, ai = unit_planes((R, K), seed, offset)
    ur, ui = unit_planes((K, K), seed + 1)
    br, bi = ur.T / np.sqrt(K), ui.T / np.sqrt(K)   # U^T, strided views
    return gate_check(
        "gemm_planes", ga.gemm_planes, ref.gemm_planes_ref,
        (ar, ai, br, bi), (0, 1), timed, 4 * (4 * R * K + 2 * K * K),
        8 * R * K * K, (torch.matmul, lambda a: (torch.complex(a[0], a[1]),
                                                  torch.complex(a[2], a[3]))),
        split_tf32=K >= 64, tight=K <= 32, R=R, K=K, offset=offset)


def gemm_planes_mid_case(O: int, K: int, I: int, seed: int,
                         timed: bool, offset: int = 0) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import gate_apply as ga
    from repro_torch.kernels import ref
    ar, ai = unit_planes((O, K, I), seed, offset)
    ur, ui = unit_planes((K, K), seed + 1)
    ur, ui = ur / np.sqrt(K), ui / np.sqrt(K)
    return gate_check(
        "gemm_planes_mid", ga.gemm_planes_mid, ref.gemm_planes_mid_ref,
        (ar, ai, ur, ui), (0, 1), timed, 4 * (4 * O * K * I + 2 * K * K),
        8 * O * K * K * I, (torch.matmul,
                            lambda a: (torch.complex(a[2], a[3]),
                                       torch.complex(a[0], a[1]))),
        O=O, K=K, I=I, offset=offset)


def mid_batch_operands(L: int, O: int, K: int, I: int, seed: int,
                       broadcast: bool, offset: int = 0):
    """Unit-scale (L, O, K, I) A planes on the card and U planes (L, K, K)
    scaled by 1/sqrt(K): one per lane, or one at lane stride 0."""
    import numpy as np
    ar, ai = unit_planes((L, O, K, I), seed, offset)
    ur, ui = unit_planes((1 if broadcast else L, K, K), seed + 1)
    ur, ui = ur / np.sqrt(K), ui / np.sqrt(K)
    return ar, ai, ur.expand(L, K, K), ui.expand(L, K, K)


def gemm_planes_mid_batch_case(L: int, O: int, K: int, I: int, seed: int,
                               timed: bool, broadcast: bool = False,
                               offset: int = 0) -> dict:
    """The wave path's MidGemmOp kernel against its plain version (the
    einsum it replaced) within RTOL, ATOL; timed beside one complex
    torch.einsum of the same contraction."""
    import torch
    from repro_torch.kernels import gate_apply as ga
    from repro_torch.kernels import ref
    args = mid_batch_operands(L, O, K, I, seed, broadcast, offset)
    n = L * O * K * I
    return gate_check(
        "gemm_planes_mid_batch", ga.gemm_planes_mid_batch,
        ref.gemm_planes_mid_batch_ref, args, (0, 1), timed,
        4 * (4 * n + 2 * (1 if broadcast else L) * K * K), 8 * n * K,
        (lambda u, a: torch.einsum("ljk,loki->loji", u, a),
         lambda a: (torch.complex(a[2], a[3]), torch.complex(a[0], a[1]))),
        tight=True, L=L, O=O, K=K, I=I, broadcast=broadcast, offset=offset)


def mid_batch_row_invariance(O: int, K: int, I: int, seed: int) -> dict:
    """Row l of an L-lane gemm_planes_mid_batch call against the one-lane
    call on row l's operands, bit for bit, for L in MID_BATCH_LANES."""
    import torch
    from repro_torch.kernels import gate_apply as ga
    ar, ai, ur, ui = mid_batch_operands(16, O, K, I, seed, False)
    solo = [ga.gemm_planes_mid_batch(ar[j:j + 1].clone(),
                                     ai[j:j + 1].clone(), ur[j:j + 1],
                                     ui[j:j + 1]) for j in range(16)]
    equal = {}
    for L in MID_BATCH_LANES:
        cr, ci = ga.gemm_planes_mid_batch(ar[:L], ai[:L], ur[:L], ui[:L])
        equal[L] = all(torch.equal(cr[j], solo[j][0][0])
                       and torch.equal(ci[j], solo[j][1][0])
                       for j in range(L))
    out = {"O": O, "K": K, "I": I, "lanes": list(MID_BATCH_LANES),
           "bitwise_equal": [equal[L] for L in MID_BATCH_LANES]}
    print("kernel_check gemm_planes_mid_batch_row_invariance "
          + json.dumps(out), flush=True)
    if not all(equal.values()):
        fail(f"gemm_planes_mid_batch rows depend on the lane count at "
             f"(O, K, I) = {(O, K, I)}: {equal}")
    return out


def diag_apply_case(R: int, K: int, seed: int, timed: bool) -> dict:
    import torch
    from repro_torch.kernels import gate_apply as ga
    from repro_torch.kernels import ref
    ar, ai = unit_planes((R, K), seed)
    phase = unit_planes((K,), seed + 1)[0]
    dr, di = torch.cos(phase), torch.sin(phase)
    return gate_check(
        "diag_apply", ga.diag_apply, ref.diag_apply_ref, (ar, ai, dr, di),
        (0, 1), timed, 4 * (4 * R * K + 2 * K), 6 * R * K,
        (torch.mul, lambda a: (torch.complex(a[0], a[1]),
                               torch.complex(a[2], a[3]))), R=R, K=K)


#: (O, K, I, offset) of B7's ring body (K <= 32): every block walks many
#: units and I is ragged; I and planes off 16-byte alignment (4-byte
#: copies); O > 1 with I below a slab's columns
MID_RING_SHAPES = [s for K in (2, 4, 8, 16, 32)
                   for s in ((3, K, (1 << 21) // K + 3, 0), (2, K, 1001, 1),
                             (5, K, 77, 0), (2, K, 4096, 1))]
#: gemm_planes_mid_batch: main_batch's wave (16 rows of 2^22 amplitudes)
#: at its wide (1, 4, 2^20) and narrow (16384, 32, 8) MidGemmOps, timed
MID_BATCH_TIMED = [(16, 1, 4, 1 << 20), (16, 16384, 32, 8)]
#: (L, O, K, I, lane stride 0, offset), untimed: K = 128 with one U for
#: every lane, I narrower than a slab and not a multiple of 4, I ragged,
#: planes off 16-byte alignment
MID_BATCH_SHAPES = [(4, 16, 128, 64, True, 0), (3, 7, 16, 24, False, 0),
                    (5, 33, 8, 6, True, 1), (2, 5, 32, 77, False, 1),
                    (3, 2, 64, 256, False, 0)]
MID_BATCH_LANES = (1, 2, 3, 16)


def gate_phase() -> dict:
    """B6 at R*K = 2^22 (K = 4, 16, 32: the per-gate and schedule shapes
    at the default fusion width; 64, 128: max_fused_qubits 6 and 7, on the
    split-TF32 tensor-core kernel), B7 at the schedules' (O, K, I), its
    lane-batched form at main_batch's wave (and its rows bit for bit
    against one-lane calls), B8 at K = 4, 32, 128; then small, odd and
    ragged shapes untimed."""
    b6 = [gemm_planes_case(GROUP // K, K, seed=10 + K, timed=True)
          for K in (4, 16, 32, 64, 128)]
    b6 += [gemm_planes_case(R, K, seed=20 + i, timed=False)
           for i, (R, K) in enumerate([(7, 2), (33, 8), (5, 64), (3, 128),
                                       (1000, 128), (77, 64), (4097, 64)])]
    # the ring body: R*K past 2^22 by a ragged tile; R*K not a multiple of
    # 4 on planes off 16-byte alignment
    b6 += [gemm_planes_case(R, K, seed=80 + i, timed=False, offset=off)
           for i, (R, K, off) in enumerate(
               (r, K, off) for K in (2, 4, 8, 16, 32)
               for r, off in (((1 << 22) // K + 3, 0), (1001, 1)))]
    b7 = [gemm_planes_mid_case(1, 4, 1 << 20, seed=30, timed=True),
          gemm_planes_mid_case(1, 32, 1 << 17, seed=31, timed=True)]
    b7 += [gemm_planes_mid_case(O, K, I, seed=40 + i, timed=False)
           for i, (O, K, I) in enumerate([(3, 16, 128), (2, 2, 160),
                                          (2, 64, 256), (1, 128, 384),
                                          (5, 8, 200)])]
    b7 += [gemm_planes_mid_case(O, K, I, seed=90 + i, timed=False,
                                offset=off)
           for i, (O, K, I, off) in enumerate(MID_RING_SHAPES)]
    b7b = [gemm_planes_mid_batch_case(L, O, K, I, seed=70 + i, timed=True)
           for i, (L, O, K, I) in enumerate(MID_BATCH_TIMED)]
    b7b += [gemm_planes_mid_batch_case(L, O, K, I, seed=75 + i, timed=False,
                                       broadcast=bc, offset=off)
            for i, (L, O, K, I, bc, off) in enumerate(MID_BATCH_SHAPES)]
    for i, (_, O, K, I) in enumerate(MID_BATCH_TIMED):
        mid_batch_row_invariance(O, K, I, seed=85 + i)
    b8 = [diag_apply_case(GROUP // K, K, seed=50 + K, timed=True)
          for K in (4, 32, 128)]
    b8 += [diag_apply_case(R, K, seed=60 + i, timed=False)
           for i, (R, K) in enumerate([(3, 2), (5, 1), (7, 16)])]
    return {"gemm_planes": b6, "gemm_planes_mid": b7,
            "gemm_planes_mid_batch": b7b, "diag_apply": b8}


# -- phase 2: the standalone packing kernels, bit for bit ---------------------

#: B9a (pack_bitmap_tiles) beyond the main shape, untimed: (n, bits' dtype,
#: elements off the allocation's 16-byte boundary).  n a multiple of 32 and
#: not of 128 leaves a ragged last word row and a ragged last 1,024-element
#: round (through the C entry: the wrapper takes whole 128-lane rows); an
#: offset puts the bits off the 16-byte boundary (the kernel's unaligned
#: chunk loads).
BITMAP_EDGES = [(GROUP + 96, "int32", 0), (GROUP + 96, "bool", 0),
                (32, "int32", 0), (1056, "bool", 0), (4224, "int32", 1),
                (4256, "bool", 3), (GROUP, "bool", 5)]


def bitmap_words(bits):
    """B9a's plain version on n bits (n a multiple of 32): zeros to a whole
    128-lane row, ref.pack_bitmap_tiles_ref, the first n / 32 words."""
    import torch
    from repro_torch.kernels import ref
    n = bits.numel()
    rows = bits.view(-1, 128) if n % 128 == 0 else torch.cat([
        bits, bits.new_zeros(-n % 128)]).view(-1, 128)
    return ref.pack_bitmap_tiles_ref(rows).view(-1)[:n // 32]


def bitmap_call(bits):
    """B9a on n bits: through the wrapper for whole 128-lane rows, else
    through its C entry (which takes any multiple of 32)."""
    import torch
    from repro_torch.kernels import pack as pk
    n = bits.numel()
    if n % 128 == 0:
        return pk.pack_bitmap_tiles(bits.view(-1, 128)).view(-1)
    words = torch.empty(n // 32, dtype=torch.int32, device=bits.device)
    pk._launch("pack_bitmap_tiles", bits.device, bits.data_ptr(),
               bits.element_size(), words.data_ptr(), n)
    return words


def bitmap_case(n: int, dtype: str, seed: int, timed: bool,
                offset: int = 0) -> dict:
    """B9a on n bits of ``dtype`` (int32 in {-1, 0, 1}: nonzero values
    other than 1 count as set; or bool), ``offset`` elements into their
    allocation, against its plain version bit for bit; with ``timed``,
    kernel and plain times beside the bytes bound (each bit read once,
    each word written once; no library call packs bits) on a
    ``kernel_time pack_bitmap_tiles`` line."""
    import torch
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    raw = torch.randint(-1, 2, (n + offset,), generator=g, device="cuda:0",
                        dtype=torch.int32)
    bits = (raw if dtype == "int32" else raw != 0)[offset:]
    got, want = bitmap_call(bits), bitmap_words(bits)
    torch.cuda.synchronize()
    c = {"name": "pack_bitmap_tiles", "dtype": dtype, "n": n,
         "offset": offset, "aligned": bits.data_ptr() % 16 == 0,
         "equal": bool(torch.equal(got, want)),
         "max_abs_err": int((got.long() - want.long()).abs().max())}
    if timed:
        nbytes = n * bits.element_size() + n // 8
        b, by = bound(nbytes, 0)
        inputs = cold_copies((bits,), (0,))
        c.update(ms=cuda_ms(bitmap_call, inputs),
                 plain_ms=cuda_ms(bitmap_words, inputs), library_ms=None,
                 bound_ms=b, bound_by=by, bytes=nbytes)
        print("kernel_time pack_bitmap_tiles " + json.dumps(c), flush=True)
    print("kernel_check packing " + json.dumps(c), flush=True)
    if not c["equal"]:
        fail(f"pack_bitmap_tiles differs from its plain version: "
             f"{json.dumps(c)}")
    return c


def pack_case(rows: int, seed: int, timed: bool) -> list[dict]:
    """pack/unpack of codes and of sign bitmaps at ``rows`` x 128 against
    their plain versions, bit for bit; with ``timed``, kernel / plain
    times beside the bytes bound (no library call packs bits; one cast,
    ``to(int16)`` viewed as int32 words, packs u16 codes).  The sign
    bitmap is packed from int32 bits (:func:`bitmap_case`)."""
    import torch
    from repro_torch.kernels import pack as pk
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    n = rows * 128
    codes = torch.randint(0, 65536, (rows, 128), generator=g,
                          device="cuda:0", dtype=torch.int32)
    bits = (torch.rand((rows, 128), generator=g, device="cuda:0") < 0.5) \
        .to(torch.int32)
    words = pk.pack_codes_tiles(codes)
    signs = pk.pack_bitmap_tiles(bits)

    def lib_pack(c):
        return c.to(torch.int16).view(torch.int32)

    cases = [
        ("pack_codes_tiles", pk.pack_codes_tiles, ref.pack_codes_tiles_ref,
         codes, 4 * n + 2 * n, lib_pack),
        ("unpack_codes_tiles", pk.unpack_codes_tiles,
         ref.unpack_codes_tiles_ref, words, 2 * n + 4 * n, None),
        ("unpack_bitmap_tiles", pk.unpack_bitmap_tiles,
         ref.unpack_bitmap_tiles_ref, signs, n // 8 + 4 * n, None),
    ]
    out = [bitmap_case(n, "int32", seed, timed)]
    for name, kern, plain, x, nbytes, lib in cases:
        got, want = kern(x), plain(x)
        torch.cuda.synchronize()
        c = {"name": name, "rows": rows,
             "equal": bool(torch.equal(got, want)),
             "max_abs_err": int((got.long() - want.long()).abs().max())}
        if name == "unpack_codes_tiles":
            c["equal"] = c["equal"] and bool(torch.equal(got, codes))
        if name == "unpack_bitmap_tiles":
            c["equal"] = c["equal"] and bool(torch.equal(got, bits))
        if timed:
            b, by = bound(nbytes, 0)
            inputs = cold_copies((x,), (0,))
            lib_ok = lib is not None and bool(torch.equal(lib(x), want))
            c.update(ms=cuda_ms(kern, inputs), plain_ms=cuda_ms(plain, inputs),
                     library_ms=cuda_ms(lib, inputs) if lib_ok else None,
                     bound_ms=b, bound_by=by, bytes=nbytes)
        print("kernel_check packing " + json.dumps(c), flush=True)
        if not c["equal"]:
            fail(f"{name} differs from its plain version at rows={rows}")
        out.append(c)
    return out


def pack_phase() -> dict:
    """The packing kernels at 2^22 elements (timed) and small rows; B9a
    also on bool bits at 2^22 (timed) and at :data:`BITMAP_EDGES`."""
    cases = pack_case(GROUP // 128, seed=70, timed=True)
    for i, rows in enumerate((1, 8, 24, 33)):
        cases += pack_case(rows, seed=71 + i, timed=False)
    cases.append(bitmap_case(GROUP, "bool", seed=76, timed=True))
    cases += [bitmap_case(n, dt, seed=77 + i, timed=False, offset=off)
              for i, (n, dt, off) in enumerate(BITMAP_EDGES)]
    by_name: dict[str, list] = {}
    for c in cases:
        by_name.setdefault(c["name"], []).append(c)
    return by_name


# -- phase 2: the attention kernels against their plain versions -------------

def attn_check(name: str, got, want, shape: dict, atol: float = ATTN_ATOL,
               rtol: float = 0.0) -> dict:
    """max |got - want| within ``atol + rtol*max(|got|, |want|)``, as one
    case (``rtol`` for outputs rounded to bf16 on both sides, which may
    land one bf16 step apart; see :func:`bf16_atol`)."""
    import torch
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * torch.maximum(got.abs(), want.abs()))
              .all())
    out = {**shape, "max_abs_err": err, "ok": ok}
    if rtol:
        out.update(rtol=rtol, atol=atol)
    print(f"kernel_check {name} " + json.dumps(out), flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version at {shape}: max abs "
             f"err {err:.3e} (atol {atol}, rtol {rtol})")
    return out


def flash_case(BH: int, S: int, hd: int, causal: bool, seed: int) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    q, k, v = torch.randn((3, BH, S, hd), generator=g, device="cuda:0")
    return attn_check("flash_attention", fa.flash_attention(q, k, v,
                                                            causal=causal),
                      ref.flash_attention_ref(q, k, v, causal),
                      {"BH": BH, "S": S, "hd": hd, "causal": causal})


def gqa_operands(B: int, S: int, T: int, Hq: int, G: int, hd: int,
                 g) -> tuple:
    """The projections that q (B,S,Hq,hd) and k/v (B,T,G,hd) are strided
    slices of (bf16 values; :func:`gqa_split`): one (B,S,Hq+2G,hd) tensor
    for self-attention (T == S, as attention_full hands them over), else a
    (B,S,Hq,hd) one and a (B,T,2G,hd) one (attention_cross's q and its
    source's k/v)."""
    import torch
    if T == S:
        shapes = [(B, S, Hq + 2 * G, hd)]
    else:
        shapes = [(B, S, Hq, hd), (B, T, 2 * G, hd)]
    return tuple(torch.randn(sh, generator=g, device="cuda:0")
                 .to(torch.bfloat16) for sh in shapes)


def gqa_split(bases: tuple, Hq: int, G: int) -> tuple:
    """(q, k, v) as views of :func:`gqa_operands`' tensors."""
    if len(bases) == 1:
        x, = bases
        return x[:, :, :Hq], x[:, :, Hq:Hq + G], x[:, :, Hq + G:]
    q, kv = bases
    return q, kv[:, :, :G], kv[:, :, G:]


def flash_gqa_cases(B: int, S: int, Hq: int, G: int, hd: int,
                    seed: int, window: int = 0, T: int | None = None,
                    causal: bool = True) -> list[dict]:
    """The model layout (:func:`gqa_operands`) in f32 and in bf16, with a
    sliding ``window`` (0 none), over ``T`` keys (None: S; another T is
    cross-attention's, unmasked)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    T = S if T is None else T
    bases = gqa_operands(B, S, T, Hq, G, hd, g)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = gqa_split(tuple(x.to(dt) for x in bases), Hq, G)
        shape = {"B": B, "S": S, "Hq": Hq, "G": G, "hd": hd,
                 "dtype": str(dt).split(".")[-1], "causal": causal}
        if T != S:
            shape["T"] = T
        if window:
            shape["window"] = window
        bf = dt == torch.bfloat16
        out.append(attn_check(
            "flash_attention", fa.flash_attention_gqa(q, k, v, causal=causal,
                                                      window=window),
            ref.flash_attention_gqa_ref(q, k, v, causal, window), shape,
            atol=bf16_atol(v) if bf else ATTN_ATOL,
            rtol=BF16_RTOL if bf else 0.0))
    return out


def bf16_atol(v) -> float:
    """The absolute half of the bf16 check of B10 and B11, 2^-8 max|v|:
    the kernels round unnormalised probabilities to bf16 and the plain
    versions normalised ones.  Each rounding is within 2^-8 relative of
    the exact p (bf16's unit roundoff), so the two P·V could differ by
    2^-7 max|v| (the probabilities sum to 1) if every rounding went the
    worst way at once; they do not line up, and the check holds them to
    half that.  B10's outputs then round to bf16 up to one step
    (BF16_RTOL) apart."""
    return 2.0 ** -8 * float(v.float().abs().max())


def kv_cache_case(lead: tuple, T: int, hd: int, seed: int):
    """Six cache leaves (codes, signs, scale for K and V) of shape
    ``lead[:1] + (T,) + lead[1:]`` from quantize_kv of seeded normals."""
    import torch
    from repro_torch.serving.kvcache import quantize_kv
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    shape = lead[:1] + (T,) + lead[1:] + (hd,)
    leaves = []
    for _ in range(2):
        x = torch.randn(shape, generator=g, device="cuda:0")
        x[..., ::7] = 0.0                      # exact-zero escapes
        qz = quantize_kv(x.to(torch.bfloat16))
        leaves += [qz["codes"], qz["signs"], qz["scale"]]
    return leaves


def kvdq_case(BG: int, T: int, hd: int, rep: int, pos: int,
              seed: int, q_dtype: str = "float32", cache=None,
              label: str | None = None, kv_dtype: str | None = None
              ) -> dict:
    """B11 in the TPU layout against its plain version (see
    :func:`kvdq_check`); ``kv_dtype="bfloat16"`` with an f32 q is the
    ``KV_BF16`` build, the compressed decode of an f32 model."""
    import torch
    from repro_torch.kernels import kv_dequant_attention as kd
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    q = torch.randn((BG, rep, hd), generator=g, device="cuda:0") \
        .to(getattr(torch, q_dtype))
    if cache is None:
        cache = [t.squeeze(2)
                 for t in kv_cache_case((BG, 1), T, hd, seed + 1)]
    shape = {"BG": BG, "T": T, "hd": hd, "rep": rep, "pos": pos}
    if q_dtype == "bfloat16" or label or kv_dtype:
        shape["q_dtype"] = q_dtype
    if kv_dtype:
        shape["kv_dtype"] = kv_dtype
    if label:
        shape["case"] = label
    kv = getattr(torch, kv_dtype) if kv_dtype else None
    return kvdq_check(kd.kv_dequant_decode_attention(q, *cache, pos,
                                                     kv_dtype=kv),
                      q, cache, pos, shape, kv)


def kvdq_check(got, q, cache, pos: int, shape: dict, kv_dtype=None) -> dict:
    """B11's output ``got`` for q (..., rep, hd) and cache leaves (..., T,
    .) against its plain version: an f32 q within ATTN_ATOL.  A bf16 q, or
    an f32 q with ``kv_dtype`` bf16 (the ``KV_BF16`` build, rounded as a
    bf16 q is but with QK^T as f32 FMAs and p normalised, in two passes),
    twice: within the bf16 bound (:func:`bf16_atol`; the bf16-q kernel
    rounds p unnormalised against its running max, the plain version
    normalised),
    and against the plain version in the kernel's own order
    (ref.kv_dequant_decode_attention_tiled_ref on the spans and tiles the
    kernel launched with) within KV_ORDER_TOL max|v|.  That one differs
    only by f32 sums in another order (QK^T's on the tensor cores) and the
    odd p that these send to its other bf16 neighbour: on one H100, 1.5e-8
    to 1.2e-5 max|v| over the smoke's cases, so the limit is 2.5 times the
    worst reading and 128 times under the bf16 bound's 2^-8 max|v|.  A
    wrong 16-dim chunk, tile edge or sign pair moves outputs by about a
    typical |output| (~4e-3 max|v| at the serve shape) and fails it; so
    does p rounded where the plain version rounds it at the serve shape
    and the tile and split edges (4.6e-5 to 2.9e-4 max|v| away).  Where a
    row goes past the limit, it passes only as one p on its other bf16
    neighbour (:func:`one_p_flips`): first seen with more rows a case
    (rep 7 and 4 at 16 to 64 kv heads, a short cache of 129 tokens)."""
    import torch
    from repro_torch.kernels import kv_dequant_attention as kd
    from repro_torch.kernels import ref
    want = ref.kv_dequant_decode_attention_ref(q, *cache, pos,
                                               kv_dtype=kv_dtype)
    if q.dtype != torch.bfloat16 and kv_dtype is None:
        return attn_check("kv_dequant_decode_attention", got, want, shape)
    v = ref.kv_dequant_ref(*cache[3:])
    out = attn_check("kv_dequant_decode_attention", got, want, shape,
                     atol=bf16_atol(v), rtol=BF16_RTOL)
    rep, hd = q.shape[-2:]
    live = min(cache[0].shape[-2], pos + 1)
    _, span, tile = kd.grid(q[..., 0, 0].numel(), rep, hd, live, q.dtype,
                            q.device, kv_dtype=kv_dtype)
    tight = ref.kv_dequant_decode_attention_tiled_ref(
        q, *cache, pos, span, tile, kv_dtype=kv_dtype)
    err = float((got.float() - tight).abs().max())
    lim = KV_ORDER_TOL * float(v.abs().max())
    flips = one_p_flips(got, tight, q, cache, live, lim) if err > lim else 0
    line = {**shape, "span": span, "tile": tile, "max_abs_err": err,
            "atol": lim, "ok": err <= lim or flips > 0,
            "rows_one_p_flip": flips,
            "plain_vs_order": float((want - tight).abs().max())}
    print("kernel_check kv_dequant_decode_attention_kernel_order "
          + json.dumps(line), flush=True)
    if not line["ok"]:
        fail(f"kv_dequant_decode_attention disagrees with its plain version "
             f"in its own order at {shape}: max abs err {err:.3e} (atol "
             f"{lim:.3e})")
    out.update(max_abs_err_kernel_order=err, atol_kernel_order=lim)
    return out


def one_p_flips(got, tight, q, cache, live: int, lim: float) -> int:
    """Rows where B11 and its plain version in kernel order differ by more
    than ``lim``, each explained as one p on its other bf16 neighbour:
    both round each p to bf16, from f32 scores summed in other orders, so
    a p within that rounding of a bf16 midpoint may land one step apart
    (seen on one H100 at 4.3e-5 max|v|: rep 7, pos 128).
    Such a row's difference is c times that token's v row, |c| at most one
    bf16 step of its weight (2^-7 w_j; the weight in f64), and what
    remains is within ``lim`` (1% of slack on the step for the weight's
    normaliser).  Returns the number of rows so explained,
    0 when a row over ``lim`` is not: a wrong chunk, tile edge or sign
    moves a row by a mix of v rows or by far more."""
    import torch
    from repro_torch.kernels import ref
    rep, hd = q.shape[-2:]
    d = (got.double() - tight.double()).reshape(-1, rep, hd)
    v = ref.kv_dequant_ref(*cache[3:]).bfloat16().double()
    k = ref.kv_dequant_ref(*cache[:3]).bfloat16().double()
    v = v[..., :live, :].reshape(-1, live, hd)
    k = k[..., :live, :].reshape(-1, live, hd)
    w = torch.softmax(q.double().reshape(-1, rep, hd) @ k.transpose(1, 2)
                      / hd ** 0.5, dim=-1)                # (BG, rep, live)
    n = 0
    for bg, r in (d.abs().amax(-1) > lim).nonzero().tolist():
        vv, dv = v[bg], d[bg, r]
        c = (vv @ dv) / (vv * vv).sum(-1).clamp(min=1e-300)
        rest = (dv[None, :] - c[:, None] * vv).abs().amax(-1)
        j = int(rest.argmin())
        step = 1.01 * 2.0 ** -7 * float(w[bg, r, j])
        if not (rest[j] <= lim and abs(c[j]) <= step):
            return 0
        n += 1
    return n


def gqa_as_heads(q, leaves):
    """B11's serving layout (q (B, 1, Hq, hd), leaves (B, T, G, .)) as the
    TPU layout's (q (B, G, rep, hd), leaves (B, G, T, .)), as views."""
    B, _, Hq, hd = q.shape
    G = leaves[0].shape[2]
    return (q[:, 0].unflatten(1, (G, Hq // G)),
            [t.transpose(1, 2) for t in leaves])


#: scales of the all-codes cache: the exp2 argument below -126 (exp2f's
#: subnormal path) down to the bottom of f32, around the fast form's
#: threshold (-100), and ordinary ones
KV_SWEEP_SCALES = (-149.0, -140.0, -126.0, -110.5, -100.0, -99.5, -30.0,
                   -3.0, 0.0, 2.5)


def all_codes_cache(BG: int, T: int, hd: int, seed: int):
    """Six (BG, T, .) cache leaves holding every code 0 ... 255 with both
    signs: token t of K has codes (t hd + d) mod 256, V the reverse order;
    sign bytes random; the first half of the tokens ordinary scales, the
    rest cycling through KV_SWEEP_SCALES (so some tiles take the kernel's
    fast exp2 and some exp2f's subnormal path)."""
    import torch
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    idx = torch.arange(T * hd, device="cuda:0").reshape(1, T, hd)
    codes_k = (idx % 256).to(torch.uint8).expand(BG, T, hd).contiguous()
    codes_v = (255 - idx % 256).to(torch.uint8).expand(BG, T, hd) \
        .contiguous()
    sweep = torch.tensor(KV_SWEEP_SCALES, device="cuda:0")
    half = T // 2
    leaves = []
    for codes in (codes_k, codes_v):
        signs = torch.randint(0, 256, (BG, T, hd // 8), generator=g,
                              device="cuda:0", dtype=torch.uint8)
        scale = torch.rand((BG, T, 1), generator=g, device="cuda:0") * 4 - 2
        scale[:, half:, 0] = sweep[torch.arange(T - half, device="cuda:0")
                                   % len(KV_SWEEP_SCALES)]
        leaves += [codes, signs, scale]
    return leaves


def kv_dequant_bitwise() -> dict:
    """B11's dequantize (dequant4, through kv_dequant_rows_f32 of the built
    attention library) against the previous form (dequant1 + round_as)
    bit for bit, for an f32 and a bf16 q, over all 256 codes x both signs
    x scales from -150 to 130 in steps of 0.25 (and KV_SWEEP_SCALES); and
    the largest difference from the plain version (ref.kv_dequant_ref, then
    bf16 for a bf16 q) in units of the last place, which must be 0 too."""
    import ctypes

    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import ref
    lib = build.load("attention")
    fn = lib.kv_dequant_rows_f32
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    scales = torch.cat([torch.arange(-150.0, 130.0, 0.25, device=dev),
                        torch.tensor(KV_SWEEP_SCALES, device=dev)])
    n = len(scales)
    codes = torch.arange(256, device=dev).to(torch.uint8).repeat(2 * n, 1)
    signs = torch.zeros((2 * n, 32), dtype=torch.uint8, device=dev)
    signs[n:] = 255                                  # every code negative
    scale = torch.cat([scales, scales]).reshape(-1, 1).contiguous()
    out = {"rows": 2 * n, "codes": 256}
    for dt, bf16 in (("float32", 0), ("bfloat16", 1)):
        got = torch.empty((2 * n, 256), device=dev)
        want = torch.empty_like(got)
        rc = fn(codes.data_ptr(), signs.data_ptr(), scale.data_ptr(),
                got.data_ptr(), want.data_ptr(), 2 * n, 256, bf16,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"kv_dequant_rows_f32 launch failed (cudaError {rc})")
        torch.cuda.synchronize()
        diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        plain = ref.kv_dequant_ref(codes, signs, scale)
        if bf16:
            plain = plain.bfloat16().float()
        ulps = (got.view(torch.int32).long()
                - plain.view(torch.int32).long()).abs()
        out[dt] = {"bits_differ": diff, "max_ulp_vs_plain": int(ulps.max())}
    print("kernel_check kv_dequant_bitwise " + json.dumps(out), flush=True)
    if any(out[dt]["bits_differ"] or out[dt]["max_ulp_vs_plain"]
           for dt in ("float32", "bfloat16")):
        fail(f"B11's dequantize differs from dequant1 + round_as or from "
             f"the plain version: {out}")
    return out


def kvdq_serving_cases(U: int, B: int, T: int, G: int, rep: int, hd: int,
                       pos: int, seed: int) -> list[dict]:
    """The serving layout: one layer's views of a stacked (U, B, T, G, .)
    cache, q (B, 1, Hq, hd) in f32 and bf16."""
    import torch
    from repro_torch.kernels import kv_dequant_attention as kd
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    stacked = kv_cache_case((U * B, G), T, hd, seed + 1)
    layer = [t.unflatten(0, (U, B))[U // 2] for t in stacked]
    q = torch.randn((B, 1, G * rep, hd), generator=g, device="cuda:0")
    out = []
    for dt in (torch.float32, torch.bfloat16):
        qd = q.to(dt)
        got = kd.kv_dequant_decode_attention_gqa(qd, *layer, pos)
        qh, heads = gqa_as_heads(qd, layer)
        out.append(kvdq_check(
            got[:, 0].reshape(qh.shape), qh, heads, pos,
            {"U": U, "B": B, "T": T, "G": G, "rep": rep, "hd": hd,
             "pos": pos, "q_dtype": str(dt).split(".")[-1]}))
    return out


def flash_timed(BH: int, S: int, hd: int) -> dict:
    """B10 at (BH, S, hd) causal f32: kernel, plain version and
    F.scaled_dot_product_attention (TF32 off) beside the operations
    bound (2 matmuls over the S(S+1)/2 unmasked pairs) in split TF32, and
    as f32 FMAs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda:0").manual_seed(5)
    q, k, v = torch.randn((3, BH, S, hd), generator=g, device="cuda:0")
    out = attn_check("flash_attention", fa.flash_attention(q, k, v),
                     ref.flash_attention_ref(q, k, v, True),
                     {"BH": BH, "S": S, "hd": hd, "causal": True,
                      "timed": True})
    nbytes = 4 * 4 * BH * S * hd
    flops = 4 * BH * hd * (S * (S + 1) // 2)
    inputs = cold_copies((q, k, v), (0, 1, 2))
    lib = [(a.unsqueeze(0), c.unsqueeze(0), d.unsqueeze(0))
           for a, c, d in inputs]
    out.update(
        ms=cuda_ms(fa.flash_attention, inputs),
        plain_ms=cuda_ms(lambda a, c, d: ref.flash_attention_ref(a, c, d,
                                                                 True),
                         inputs, iters=5, warmup=1),
        library_ms=cuda_ms(lambda a, c, d: F.scaled_dot_product_attention(
            a, c, d, is_causal=True), lib),
        arithmetic="split TF32",
        **bounds(nbytes, flops, SPLIT_TF32 * flops, TF32_FLOP_PER_S))
    print("kernel_time flash_attention " + json.dumps(out), flush=True)
    return out


def window_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal pass over S tokens computes: S(S+1)/2,
    or with a sliding window W the sum of min(i + 1, W)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_timed_bf16(B: int, S: int, Hq: int, G: int, hd: int,
                     window: int = 0, T: int | None = None,
                     causal: bool = True) -> dict:
    """B10 at a prefill's shape in the model's GQA layout, bf16 (causal as
    qwen3-4b's and gemma3's prefills call it, ``window`` for gemma3's
    local layers; non-causal over ``T`` keys as llama-vision's and
    whisper's cross layers and whisper's encoder do): kernel and plain
    version beside the bf16 tensor-core bound and the f32-FMA bound over
    the unmasked pairs; the library yardstick is
    F.scaled_dot_product_attention in bf16 on (B, Hq, S, hd) copies with
    the kv heads expanded outside the timed call (with a window, its mask
    an explicit (S, S) boolean made outside it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda:0").manual_seed(8)
    T = S if T is None else T
    bases = gqa_operands(B, S, T, Hq, G, hd, g)
    q, k, v = gqa_split(bases, Hq, G)
    shape = {"B": B, "S": S, "Hq": Hq, "G": G, "hd": hd, "dtype": "bfloat16",
             "causal": causal, "timed": True}
    if T != S:
        shape["T"] = T
    if window:
        shape["window"] = window
    out = attn_check("flash_attention",
                     fa.flash_attention_gqa(q, k, v, causal=causal,
                                            window=window),
                     ref.flash_attention_gqa_ref(q, k, v, causal, window),
                     shape, atol=bf16_atol(v), rtol=BF16_RTOL)
    nbytes = 2 * (2 * B * S * Hq * hd + 2 * B * T * G * hd)
    pairs = window_pairs(S, window) if causal else S * T
    flops = 4 * B * Hq * hd * pairs
    inputs = [gqa_split(c, Hq, G)
              for c in cold_copies(bases, tuple(range(len(bases))))]
    rep = Hq // G
    mask = None
    if window and window < S:
        i = torch.arange(S, device="cuda:0")
        d = i[:, None] - i[None, :]
        mask = (d >= 0) & (d < window)

    def heads_first(a, c, d):
        return (a.transpose(1, 2).contiguous(),
                c.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous(),
                d.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous())

    lib = [heads_first(*a) for a in inputs[:2]]
    out.update(
        ms=cuda_ms(lambda a, c, d: fa.flash_attention_gqa(
            a, c, d, causal=causal, window=window), inputs),
        plain_ms=cuda_ms(lambda a, c, d: ref.flash_attention_gqa_ref(
            a, c, d, causal, window), inputs[:2], iters=3, warmup=1),
        library_ms=cuda_ms(lambda a, c, d: F.scaled_dot_product_attention(
            a, c, d, attn_mask=mask, is_causal=causal and mask is None),
            lib),
        arithmetic="bf16", **bounds(nbytes, flops, flops, BF16_FLOP_PER_S))
    del lib
    print("kernel_time flash_attention " + json.dumps(out), flush=True)
    return out


def kvdq_timed(B: int, G: int, rep: int, T: int, hd: int, pos: int,
               q_dtype: str = "float32", host_grid: bool = False,
               kv_dtype: str | None = None) -> dict:
    """B11 at a decode step's shape in the serving layout, q in
    ``q_dtype`` (the serve path's is bfloat16; an f32 q with ``kv_dtype``
    bfloat16 is the ``KV_BF16`` build), pos a 0-d int32 tensor on
    the card as decode passes it: kernel and plain version beside the
    bytes bound (every cache byte of the tokens j <= pos read once, q
    read and the output written once).  ``host_grid``: also the same
    kernel on the grid a host-int pos sized (splits at live, no idle
    splits, no combine where one split does), timed in turns with it
    (device, host, host, device)."""
    import torch
    from repro_torch.kernels import kv_dequant_attention as kd
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda:0").manual_seed(6)
    cache = kv_cache_case((B, G), T, hd, 7)
    q = torch.randn((B, 1, G * rep, hd), generator=g, device="cuda:0") \
        .to(getattr(torch, q_dtype))
    kv = getattr(torch, kv_dtype) if kv_dtype else None
    got = kd.kv_dequant_decode_attention_gqa(q, *cache, pos, kv_dtype=kv)
    qh, heads = gqa_as_heads(q, cache)
    shape = {"BG": B * G, "T": T, "hd": hd, "rep": rep, "pos": pos,
             "q_dtype": q_dtype, "timed": True}
    if kv_dtype:
        shape["kv_dtype"] = kv_dtype
    out = kvdq_check(got[:, 0].reshape(qh.shape), qh, heads, pos, shape, kv)
    live = min(T, pos + 1)
    nbytes = (2 * B * G * live * (hd + hd // 8 + 4)
              + (q.element_size() + 4) * B * G * rep * hd)
    flops = 4 * B * G * rep * live * hd
    b, by = bound(nbytes, flops)
    # one MUFU.EX2 a cached element of K and V at the SM clock's maximum
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
        .stdout.split()[0])
    ex2 = 2 * B * G * live * hd
    dpos = torch.tensor(pos, dtype=torch.int32, device="cuda:0")
    inputs = cold_copies((q, *cache, dpos), (1, 2, 3, 4, 5, 6))

    def kernel(*a):
        return kd.kv_dequant_decode_attention_gqa(*a, kv_dtype=kv)

    def plain(*a):
        return ref.kv_dequant_decode_attention_gqa_ref(*a, kv_dtype=kv)
    ms = cuda_ms(kernel, inputs)
    if host_grid:
        def on_host_grid(qq, *rest):
            qh, heads = gqa_as_heads(qq, rest[:6])
            return kd._launch(qh, tuple(heads), rest[6], qh.device,
                              grid_live=live)
        host = [cuda_ms(on_host_grid, inputs) for _ in range(2)]
        ms = (ms + cuda_ms(kernel, inputs)) / 2
        got_h = on_host_grid(q, *cache, dpos)
        blocks, slots, tile = kd._blocks_slots_tile(B * G, rep, hd, q.dtype,
                                                    q.device)
        out.update(host_grid_ms=sum(host) / 2, host_grid_bitwise=bool(
            torch.equal(got_h.reshape(got.shape), got)),
            grid_splits=kd.grid_splits(blocks, T, slots, tile),
            host_grid_splits=kd.splits(blocks, live, slots, tile)[0])
        if not out["host_grid_bitwise"]:
            fail(f"kv_dequant_decode_attention at {out}: the fixed grid and "
                 "the host-int grid disagree")
    out.update(
        ms=ms,
        plain_ms=cuda_ms(plain, inputs),
        library_ms=None, bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
        sfu_bound_ms=ex2 / (SFU_PER_SM_CLOCK * SMS * mhz * 1e6) * 1e3,
        sfu_clock_mhz=mhz)
    print("kernel_time kv_dequant_decode_attention " + json.dumps(out),
          flush=True)
    return out


def flash_grad_cases() -> list[dict]:
    """B10 under autograd on the card (FlashAttentionFn: the kernel's
    forward, flash_attention_gqa_bwd's gradients) against autograd
    through the plain version, at a small causal, windowed and T != S
    shape in f32 and bf16: the outputs as the forward cases hold them, the
    gradients within 1e-5 (f32) or one bf16 step (2^-7) of max|g|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    out = []
    for i, (B, S, T, Hq, G, hd, causal, window) in enumerate(TRAIN_GRAD):
        g = torch.Generator(device="cuda:0").manual_seed(600 + i)
        q = torch.randn((B, S, Hq, hd), generator=g, device="cuda:0")
        k, v = torch.randn((2, B, T, G, hd), generator=g, device="cuda:0")
        do = torch.randn((B, S, Hq, hd), generator=g, device="cuda:0")
        for dt in (torch.float32, torch.bfloat16):
            ops = [t.to(dt) for t in (q, k, v)]
            lk = [t.clone().requires_grad_() for t in ops]
            lp = [t.clone().requires_grad_() for t in ops]
            got = fa.flash_attention_gqa(*lk, causal=causal, window=window)
            want = ref.flash_attention_gqa_ref(*lp, causal, window)
            if got.grad_fn is None:
                fail("flash_attention under autograd returned no grad_fn")
            gk = torch.autograd.grad(got, lk, do.to(dt))
            gp = torch.autograd.grad(want, lp, do.to(dt))
            bf = dt == torch.bfloat16
            shape = {"B": B, "S": S, "T": T, "Hq": Hq, "G": G, "hd": hd,
                     "causal": causal, "window": window,
                     "dtype": str(dt).split(".")[-1]}
            attn_check("flash_attention", got.detach(), want.detach(),
                       {**shape, "autograd": True},
                       atol=bf16_atol(ops[2]) if bf else ATTN_ATOL,
                       rtol=BF16_RTOL if bf else 0.0)
            for name, a, b in zip("qkv", gk, gp):
                scale = float(b.float().abs().max())
                tol = (BF16_TOL_GRAD if bf else GRAD_RTOL) * scale
                out.append(attn_check(f"flash_attention_gqa_bwd_d{name}", a,
                                      b, {**shape, "max_abs_grad": scale},
                                      atol=tol))
    return out


def flash_bwd_timed(B: int, S: int, Hq: int, G: int, hd: int) -> dict:
    """flash_attention_gqa_bwd at the train shape (causal, bf16) beside
    B10's forward at that shape and F.scaled_dot_product_attention's
    forward and forward + backward (kv heads expanded outside the timed
    call).  Its bound: the seven TF32 products it runs (S, dP, dV, and dQ,
    dK as two each) over the unmasked pairs at the TF32 rate, or its
    bytes (q, k, v, dO read, dQ, dK, dV written)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda:0").manual_seed(9)
    bases = gqa_operands(B, S, S, Hq, G, hd, g)
    q, k, v = gqa_split(bases, Hq, G)
    do = torch.randn((B, S, Hq, hd), generator=g,
                     device="cuda:0").to(torch.bfloat16)
    rep = Hq // G
    pairs = window_pairs(S, 0)
    ops = 7 * 2 * B * Hq * hd * pairs
    nbytes = 2 * (3 * B * S * Hq * hd + 4 * B * S * G * hd)
    lib = (q.transpose(1, 2).contiguous().requires_grad_(),
           k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
           .requires_grad_(),
           v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
           .requires_grad_())
    dlib = do.transpose(1, 2).contiguous()

    def sdpa_fwd_bwd(a, c, d):
        o = F.scaled_dot_product_attention(a, c, d, is_causal=True)
        torch.autograd.grad(o, (a, c, d), dlib)

    def sdpa_fwd(a, c, d):
        with torch.no_grad():
            F.scaled_dot_product_attention(a, c, d, is_causal=True)
    inputs = [(q, k, v, do)]
    out = {"B": B, "S": S, "Hq": Hq, "G": G, "hd": hd, "dtype": "bfloat16",
           "causal": True,
           "ms": cuda_ms(lambda a, c, d, e: fa.flash_attention_gqa_bwd(
               a, c, d, e), inputs, iters=5, warmup=1),
           "forward_ms": cuda_ms(lambda a, c, d, e: fa.flash_attention_gqa(
               a, c, d), inputs),
           "library_forward_ms": cuda_ms(sdpa_fwd, [lib]),
           "library_forward_backward_ms": cuda_ms(sdpa_fwd_bwd, [lib],
                                                  iters=5, warmup=1),
           "arithmetic": "TF32 (bf16 values exact; dS split)"}
    b, by = bound(nbytes, ops, TF32_FLOP_PER_S)
    out.update(bound_ms=b, bound_by=by, bytes=nbytes, ops=ops)
    print("kernel_time flash_attention_gqa_bwd " + json.dumps(out),
          flush=True)
    return out


def attention_phase() -> dict:
    """B10 and B11 against their plain versions, then timed."""
    b10 = [flash_case(BH, S, hd, causal, seed=200 + i)
           for i, (BH, S, hd) in enumerate([(2, 128, 64), (4, 256, 32),
                                            (1, 512, 128), (3, 96, 16)])
           for causal in (True, False)]
    b10 += [flash_case(2, 1000, 64, causal, seed=210) for causal in
            (True, False)]
    b10 += flash_gqa_cases(2, 384, 32, 8, 128, seed=220)
    b11 = [kvdq_case(BG, T, hd, rep, pos, seed=300 + i)
           for i, (BG, T, hd, rep, pos) in enumerate([
               (2, 64, 32, 2, 63), (4, 128, 64, 1, 100), (1, 256, 16, 4, 17),
               (2, 1000, 64, 4, 999), (2, 1000, 128, 4, 0),
               (3, 700, 32, 2, 300), (1, 512, 128, 48, 400)])]
    b11 += kvdq_serving_cases(3, 2, 600, 4, 4, 128, 517, seed=320)
    # the split and tile edges (tiles of 128 tokens, kKvTile): pos just
    # past a tile (a second split of one token), a tile's last token, rep
    # not a multiple of 4; on the serve-like grid (4 splits) a last split
    # whose last tile holds one token, and splits of whole tiles
    b11 += [kvdq_case(BG, T, hd, rep, pos, seed=340 + i, q_dtype=dt)
            for i, (BG, T, hd, rep, pos) in enumerate([
                (2, 1000, 128, 4, 128), (2, 1000, 128, 4, 127),
                (2, 1000, 64, 3, 256), (64, 1100, 128, 4, 1024),
                (64, 1100, 128, 4, 767)])
            for dt in ("float32", "bfloat16")]
    b11 += [kvdq_case(4, 512, hd, 4, 511, seed=360, q_dtype=dt,
                      cache=all_codes_cache(4, 512, hd, seed=361),
                      label="all codes, sweep of scales")
            for hd in (128, 32) for dt in ("float32", "bfloat16")]
    # the KV_BF16 build (an f32 q, K/V and p rounded to bf16: the
    # compressed decode of an f32 model) at the same edges, hd 256 and
    # the all-codes cache; timed at the serve shape below
    b11 += [kvdq_case(BG, T, hd, rep, pos, seed=390 + i,
                      kv_dtype="bfloat16")
            for i, (BG, T, hd, rep, pos) in enumerate([
                (2, 1000, 128, 4, 128), (2, 1000, 128, 4, 127),
                (2, 1000, 64, 3, 256), (64, 1100, 128, 4, 1024),
                (64, 4096, 256, 2, 2049), (3, 300, 16, 5, 299)])]
    b11.append(kvdq_case(4, 512, 128, 4, 511, seed=360, kv_dtype="bfloat16",
                         cache=all_codes_cache(4, 512, 128, seed=361),
                         label="all codes, sweep of scales"))
    # hd 256 (gemma3-12b) and sliding windows: windows below, at and
    # across the 64-row blocks, a window of 1, gemma3's own at its width
    b10 += [c for i, (B, S, Hq, G, hd, W) in enumerate([
        (1, 300, 4, 2, 256, 0), (2, 333, 4, 2, 256, 64),
        (1, 1100, 2, 1, 256, GEMMA_WINDOW), (2, 500, 4, 2, 128, 100),
        (1, 260, 2, 1, 64, 1), (1, 2048, 16, 8, 256, GEMMA_WINDOW)])
        for c in flash_gqa_cases(B, S, Hq, G, hd, seed=230 + i, window=W)]
    b11 += [kvdq_case(BG, T, 256, rep, pos, seed=370 + i, q_dtype=dt)
            for i, (BG, T, rep, pos) in enumerate([
                (2, 1000, 2, 999), (4, 1024, 2, 5000), (64, 1100, 2, 767),
                (64, 4096, 2, 2049), (3, 300, 5, 64)])
            for dt in ("float32", "bfloat16")]
    b11 += [kvdq_case(4, 512, 256, 2, 511, seed=380, q_dtype=dt,
                      cache=all_codes_cache(4, 512, 256, seed=381),
                      label="all codes, sweep of scales")
            for dt in ("float32", "bfloat16")]
    kv_dequant_bitwise()
    b10.append(flash_timed(128, 2048, 128))
    b10.append(flash_timed_bf16(SERVE_BATCH, SERVE_PROMPT, 32, 8, 128))
    b11 += [kvdq_timed(SERVE_BATCH, 8, 4, SERVE_MAX_LEN, 128,
                       SERVE_MAX_LEN - 1, dt) for dt in ("float32",
                                                         "bfloat16")]
    b11.append(kvdq_timed(SERVE_BATCH, 8, 4, SERVE_MAX_LEN, 128,
                          SERVE_MAX_LEN - 1, "float32", kv_dtype="bfloat16"))
    # gemma3-12b's prefill (global and local layers) and decode (a global
    # layer half way through the cache, against the host-int grid; a ring)
    b10 += [flash_timed_bf16(SERVE_BATCH, SERVE_PROMPT, 16, 8, 256, W)
            for W in (0, GEMMA_WINDOW)]
    b11 += [kvdq_timed(SERVE_BATCH, 8, 2, SERVE_MAX_LEN, 256, pos, "bfloat16",
                       host_grid=True)
            for pos in (SERVE_PROMPT + 1, SERVE_MAX_LEN - 1)]
    b11.append(kvdq_timed(SERVE_BATCH, 8, 2, GEMMA_WINDOW, 256,
                          SERVE_PROMPT + GEMMA_STEPS - 1, "bfloat16"))
    b11.append(kvdq_timed(SERVE_BATCH, 8, 4, SERVE_MAX_LEN, 128,
                          SERVE_PROMPT + 1, "bfloat16", host_grid=True))
    # mixtral-8x22b's, arctic-480b's and recurrentgemma-2b's shapes: small
    # cases (B11 at a tile's edge, mid tile, and past a ring's end), then
    # timed at their serve shapes (decode at the last of HYBRID_STEPS)
    for i, ((Hq, G, hd, W), T, pos) in enumerate(zip(
            HYBRID_GQA, (1000, 1000, 512), (999, 128, 700))):
        b10 += flash_gqa_cases(2, 300, Hq, G, hd, seed=250 + i, window=W)
        b11 += [kvdq_case(2 * G, T, hd, Hq // G, p, seed=400 + i, q_dtype=dt)
                for p in (pos, 255) for dt in ("float32", "bfloat16")]
    for Hq, G, hd, W in HYBRID_GQA:
        b10.append(flash_timed_bf16(SERVE_BATCH, SERVE_PROMPT, Hq, G, hd, W))
        b11.append(kvdq_timed(SERVE_BATCH, G, Hq // G,
                              min(W, SERVE_MAX_LEN) or SERVE_MAX_LEN, hd,
                              SERVE_PROMPT + HYBRID_STEPS - 1, "bfloat16"))
    # cross-attention (llama-vision, whisper): B10 over T != S keys (ragged
    # last tiles, GQA and MHA, T above and below S) and whisper's
    # non-causal encoder at hd 64; B11 over a compressed image cache read
    # whole (pos = T - 1), then both timed at the two models' shapes
    b10 += [c for i, (B, S, T, Hq, G, hd, causal) in enumerate([
        (2, 130, 77, 4, 2, 128, False), (2, 64, 1500, 20, 20, 64, False),
        (1, 300, 576, 64, 8, 128, False), (2, 100, 33, 8, 1, 64, False),
        (1, 1500, 1500, 20, 20, 64, False), (2, 64, 64, 20, 20, 64, True)])
        for c in flash_gqa_cases(B, S, Hq, G, hd, seed=270 + i, T=T,
                                 causal=causal)]
    b11 += [kvdq_case(64, 576, 128, 8, 575, seed=420, q_dtype=dt)
            for dt in ("float32", "bfloat16")]
    b11.append(kvdq_case(64, 576, 128, 8, 575, seed=421,
                         kv_dtype="bfloat16"))
    b10 += [flash_timed_bf16(B, S, Hq, G, hd, T=T, causal=causal)
            for B, S, T, Hq, G, hd, causal in CROSS_FLASH]
    b11.append(kvdq_timed(SERVE_BATCH, 8, 8, 576, 128, 575, "bfloat16"))
    # training (qwen3-4b, B 2 x S 2,048): B10 under autograd at small
    # shapes, then the forward and the torch backward timed at the train
    # shape
    bwd = flash_grad_cases()
    b10.append(flash_timed_bf16(TRAIN_BATCH, TRAIN_SEQ, 32, 8, 128))
    bwd.append(flash_bwd_timed(TRAIN_BATCH, TRAIN_SEQ, 32, 8, 128))
    return {"flash_attention": b10, "kv_dequant_decode_attention": b11,
            "flash_attention_gqa_bwd": bwd}


# -- phase 3: the kernels/ops.py entry points ---------------------------------

def group_state(seed: int):
    """One seeded, normalised complex64 group of 2^22 amplitudes."""
    import torch
    g = torch.Generator(device="cuda:0").manual_seed(seed)
    z = torch.randn((2, GROUP), generator=g, device="cuda:0")
    z = z / z.norm()
    return z


def _count_modules():
    from repro_torch.kernels import (codec, flash_attention, gate_apply,
                                     kv_dequant_attention, pack)
    return (gate_apply, codec, pack, flash_attention, kv_dequant_attention)


def reset_counts() -> None:
    for mod in _count_modules():
        mod.reset_launch_counts()


def read_counts() -> dict:
    out = {}
    for mod in _count_modules():
        out.update(mod.launch_counts)
    return out


def ops_phase() -> dict:
    """quantize_block -> pack_codes -> unpack_codes -> dequantize_block and
    pack_sign_bitmap -> unpack_sign_bitmap on the real plane of a group,
    with every launch count set to 0 just before and read just after."""
    import torch
    from repro_torch.kernels import ops
    x = group_state(80)[0].contiguous()
    reset_counts()
    t0 = time.perf_counter()
    codes, signs, flags, l_max = ops.quantize_block(x, B_R)
    words = ops.pack_codes(codes)
    back = ops.unpack_codes(words)
    neg = ops.unpack_sign_bitmap(signs)
    signs2 = ops.pack_sign_bitmap(neg)
    y = ops.dequantize_block(back, signs2, l_max, B_R)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    nz = x != 0
    rel = float(((y - x).abs()[nz] / x.abs()[nz]).max())
    out = {"n": GROUP, "wall_s": wall, "codes_round_trip":
           bool(torch.equal(back, codes)),
           "signs_round_trip": bool(torch.equal(signs2, signs)),
           "signs_match_x": bool(torch.equal(neg, x < 0)),
           "roundtrip_max_rel": rel,
           "launches": {k: v for k, v in launches.items() if v}}
    print("ops_check " + json.dumps(out), flush=True)
    if not (out["codes_round_trip"] and out["signs_round_trip"]
            and out["signs_match_x"] and rel <= ROUNDTRIP_BOUND):
        fail(f"the ops round trip is wrong: {json.dumps(out)}")
    for k in ("pack_codes_tiles", "unpack_codes_tiles", "pack_bitmap_tiles",
              "unpack_bitmap_tiles", "encode", "decode"):
        if launches[k] <= 0:
            fail(f"the ops path launched {k} no time")
    return launches


# -- phase 4: the single-group scheduled compute ------------------------------

def qft_schedules(max_fused_qubits: int) -> list:
    """The distinct (schedule, operands) of qft-26's bound stages at one
    fusion width, each on a group of GROUP_BITS qubits."""
    from repro_torch import EngineConfig, Simulator, build_circuit
    cfg = EngineConfig(max_fused_qubits=max_fused_qubits)
    with Simulator(build_circuit("qft", MAIN_QUBITS), cfg) as sim:
        scheds = {}
        for bs in sim._engine._bind_stages(None):
            if bs.plan:
                scheds.setdefault((bs.plan, bs.sched.nv), (bs.sched, bs.mats))
    for sched, _ in scheds.values():
        if sched.nv != GROUP_BITS:
            fail(f"a qft-{MAIN_QUBITS} group has {sched.nv} qubits, not "
                 f"{GROUP_BITS}")
    return list(scheds.values())


def run_schedules(scheds, z) -> tuple[dict, list[dict]]:
    """execute_schedule on each schedule (every launch count set to 0 just
    before, read just after), then each against execute_schedule_batched
    with one lane within SCHEDULE_RTOL (relative 2-norm)."""
    from repro_torch.core.schedule import (execute_schedule,
                                           execute_schedule_batched)
    reset_counts()
    got = [execute_schedule(sched, z.clone(), mats, use_kernel=True)
           for sched, mats in scheds]
    launches = read_counts()
    out = []
    for (sched, mats), g in zip(scheds, got):
        want = execute_schedule_batched(
            sched, z.clone().unsqueeze(0),
            [m.unsqueeze(0) for m in mats], use_kernel=True)[0]
        rel = float((g - want).norm() / want.norm())
        out.append({"ops": len(sched.ops), "rel_2norm": rel})
        if not rel <= SCHEDULE_RTOL:
            fail(f"execute_schedule differs from the batched form by "
                 f"{rel:.3e} (relative 2-norm, bound {SCHEDULE_RTOL})")
    return launches, out


def single_group_phase() -> dict:
    """execute_schedule on every distinct stage schedule of qft-26 against
    execute_schedule_batched with one lane, then a synthetic schedule with
    a minor-most k = 7 diagonal, then qft-26's schedules at
    max_fused_qubits=7 (dense fused gates of K = 128 on B6's tensor-core
    kernel)."""
    import numpy as np
    import torch
    from repro_torch.core.schedule import (GemmOp, compile_schedule,
                                           execute_schedule)

    z = group_state(90)
    cases = qft_schedules(5)
    launches, out = run_schedules(cases, z)
    # a minor-most k = 7 diagonal: the one schedule branch of diag_apply
    plan = ((tuple(range(7)), True),)
    sched = compile_schedule(plan, GROUP_BITS)
    phase = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 2 * np.pi, 128).astype(np.float32)).to("cuda:0")
    dmat = torch.stack([torch.cos(phase), torch.sin(phase)])
    before = read_counts()["diag_apply"]
    got = execute_schedule(sched, z.clone(), [dmat], use_kernel=True)
    diag_launches = read_counts()["diag_apply"] - before
    want = execute_schedule(sched, z.clone(), [dmat], use_kernel=False)
    rel = float((got - want).norm() / want.norm())
    res = {"schedules": len(cases), "cases": out, "launches": launches,
           "synthetic_diag": {"launches": diag_launches, "rel_2norm": rel}}
    print("single_group_check " + json.dumps(res), flush=True)
    if launches["gemm_planes"] <= 0 or launches["gemm_planes_mid"] <= 0:
        fail("the single-group phase launched gemm_planes or "
             "gemm_planes_mid no time")
    if diag_launches != 1 or not rel <= SCHEDULE_RTOL:
        fail(f"the minor-most k=7 diagonal: {diag_launches} diag_apply "
             f"launches (want 1), relative 2-norm {rel:.3e}")

    wide = qft_schedules(7)
    k128 = sum(isinstance(op, GemmOp) and op.k == 7
               for sched, _ in wide for op in sched.ops)
    launches7, out7 = run_schedules(wide, z)
    res7 = {"max_fused_qubits": 7, "schedules": len(wide),
            "gemm_ops_k128": k128, "cases": out7,
            "launches": {k: v for k, v in launches7.items() if v}}
    print("single_group_k128_check " + json.dumps(res7), flush=True)
    if k128 <= 0 or launches7["gemm_planes"] < k128:
        fail(f"qft-{MAIN_QUBITS} at max_fused_qubits=7: {k128} GemmOps of "
             f"K = 128, {launches7['gemm_planes']} gemm_planes launches")
    return launches


# -- phases 5 to 7: the main paths --------------------------------------------

#: kernel names of library matrix products (cuBLAS, cuBLASLt, CUTLASS)
LIBRARY_GEMM = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")


def device_profile(prof, wall_s: float) -> dict:
    """Device time by kernel name from a CUDA-activity trace, the share
    of ``wall_s`` the device spent idle (one stream: the busy times do not
    overlap), and every library matrix-product kernel the trace holds."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    library = [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in rows
               if "gemm_planes" not in k
               and any(w in k.lower() for w in LIBRARY_GEMM)]
    return {"device_busy_ms": busy_ms, "wall_s": wall_s,
            "idle_share": 1.0 - busy_ms / 1e3 / wall_s,
            "top": [{"name": k[:80], "ms": ms, "count": c}
                    for k, ms, c in rows[:12]],
            "library_gemm": library}


def expected_launches(sim, backend: str, gate_schedule: bool) -> dict:
    """The launches a run must show: on the per-gate path exactly one
    gemm_planes per dense and one diag_apply per diagonal fused gate per
    group, and one encode and one decode per group, from the bound
    stages; on the wave path gemm_planes_batch, gemm_planes_mid_batch
    (and the codec kernels) at least once (None = at least once)."""
    if gate_schedule:
        want = {"gemm_planes_batch": None, "gemm_planes_mid_batch": None}
        if backend == "device":
            want.update(encode=None, decode=None)
        return want
    bound = [bs for bs in sim._engine._bind_stages(None) if bs.plan]
    groups = sum(bs.layout.n_groups for bs in bound)
    return {
        "gemm_planes": sum(sum(not d for _, d in bs.plan)
                           * bs.layout.n_groups for bs in bound),
        "diag_apply": sum(sum(d for _, d in bs.plan) * bs.layout.n_groups
                          for bs in bound),
        "gemm_planes_batch": 0,
        "gemm_planes_mid_batch": 0,
        "encode": groups if backend == "device" else 0,
        "decode": groups if backend == "device" else 0}


def main_phase(label: str, qubits: int, backend: str, profile: bool,
               gate_schedule: bool = True, skip_gates: int = 0) -> dict:
    """Drive Simulator(build_circuit("qft", qubits),
    EngineConfig(codec_backend=backend, gate_schedule=...)).run() on
    cuda:0 with every launch count set to 0 just before and read just
    after; check the launches, the state against the dense oracle and
    read it out.  ``skip_gates`` drops the QFT's first gates (a depth
    cut).  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch import (EngineConfig, Simulator, build_circuit,
                             fidelity, zsum_cost_fn)
    from repro_torch.core.circuit import Circuit
    from repro_torch.core.dense_engine import simulate_dense

    circuit = build_circuit("qft", qubits)
    circuit = Circuit(qubits, circuit.gates[skip_gates:])
    torch.cuda.reset_peak_memory_stats()
    sim = Simulator(circuit, EngineConfig(codec_backend=backend,
                                          gate_schedule=gate_schedule))
    plan = sim.compile()
    want = expected_launches(sim, backend, gate_schedule)
    print(f"{label}_plan qft-{qubits} skip_gates={skip_gates} "
          f"gates={len(circuit.gates)} codec={backend} "
          f"gate_schedule={gate_schedule} "
          f"local_bits={plan.local_bits} stages={plan.n_stages} "
          f"depth={plan.pipeline_depth} device={sim._engine.device} "
          f"expected_launches={json.dumps(want)}", flush=True)
    trace = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        trace = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
    reset_counts()
    with trace as prof:
        t0 = time.perf_counter()
        result = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts()
    st = sim.stats
    peak_dev = torch.cuda.max_memory_allocated()
    print(f"{label}_stats " + json.dumps({
        "wall_s": wall, "t_total": st.t_total, "t_compute": st.t_compute,
        "t_decompress": st.t_decompress, "t_compress": st.t_compress,
        "t_fetch": st.t_fetch, "h2d_bytes": st.h2d_bytes,
        "d2h_bytes": st.d2h_bytes, "peak_ram_bytes": st.peak_ram_bytes,
        "memory_reduction": st.memory_reduction,
        "max_memory_allocated": peak_dev, "launches": launches}),
        flush=True)
    if profile:
        print(f"{label}_profile " + json.dumps(device_profile(prof, wall)),
              flush=True)
    for k, n in want.items():
        if n is None and launches[k] <= 0:
            fail(f"the {label} path launched {k} no time")
        if n is not None and launches[k] != n:
            fail(f"the {label} path launched {k} {launches[k]} times, "
                 f"not {n}")
    # every block of every stage crosses once each way, as the plan prices
    # it (device codec: wire; a RAW-escape block would cross raw instead)
    wire = (sum(sp.est_h2d_bytes for sp in plan.stages if sp.plan),
            sum(sp.est_d2h_bytes for sp in plan.stages if sp.plan))
    if (st.h2d_bytes, st.d2h_bytes) != wire:
        fail(f"{label}: boundary bytes h2d {st.h2d_bytes} d2h "
             f"{st.d2h_bytes}, the plan's are {wire[0]} and {wire[1]}")

    t0 = time.perf_counter()
    state = torch.from_numpy(result.statevector(force=True)).to("cuda:0")
    ideal = simulate_dense(circuit, device="cuda:0")
    fid = fidelity(ideal, state)
    t_oracle = time.perf_counter() - t0
    finite = bool(torch.isfinite(torch.view_as_real(state)).all())
    del state, ideal
    counts = result.sample(1024, seed=0)
    zsum = result.expectation(zsum_cost_fn(qubits))
    print(f"{label}_check " + json.dumps({
        "fidelity": fid, "finite": finite, "oracle_s": t_oracle,
        "plan_boundary_bytes": wire,
        "shots": int(sum(counts.values())), "distinct": len(counts),
        "zsum": zsum}), flush=True)
    sim.close()
    if not finite:
        fail(f"{label}: the final state holds non-finite amplitudes")
    if not fid >= FIDELITY_MIN:
        fail(f"{label}: fidelity {fid} < {FIDELITY_MIN} against the dense "
             "oracle")
    if sum(counts.values()) != 1024 or not np.isfinite(zsum):
        fail(f"{label}: readout returned a malformed sample or expectation")
    return launches


# -- phases 8 to 12: batched runs, the service, precision, resilience and ---
# -- the command line --------------------------------------------------------

def batch_launches(sim, bindings) -> dict:
    """The launches a batched run must show, from its bound stages: one
    gemm_planes_batch per GemmOp, one gemm_planes_mid_batch per MidGemmOp
    and one encode and one decode per wave, however many lanes a wave
    holds; no other kernel."""
    from repro_torch.core.schedule import GemmOp, MidGemmOp
    eng = sim._engine
    depth = eng.cfg.pipeline_depth
    want = {k: 0 for k in read_counts()}
    for bs in eng._bind_stages_batch(bindings):
        if not bs.plan:
            continue
        n = bs.layout.n_groups
        waves = -(-n // min(depth, n))
        want["gemm_planes_batch"] += waves * sum(
            isinstance(op, GemmOp) for op in bs.sched.ops)
        want["gemm_planes_mid_batch"] += waves * sum(
            isinstance(op, MidGemmOp) for op in bs.sched.ops)
        want["encode"] += waves
        want["decode"] += waves
    return want


def zsum_on_card(state, n: int) -> float:
    """<sum_i Z_i> of a dense state on the card."""
    import torch
    idx = torch.arange(state.numel(), device=state.device)
    pop = torch.zeros_like(idx)
    for k in range(n):
        pop += (idx >> k) & 1
    probs = state.abs().to(torch.float64) ** 2
    return float((probs * (n - 2 * pop).to(torch.float64)).sum())


def batch_phase(profile: bool) -> dict:
    """Drive Simulator(with_depolarizing(build_circuit("qft", 24), 0.02),
    EngineConfig(codec_backend="device")).run(trajectories=8, seed=0) on
    cuda:0 with every launch count set to 0 just before and read just
    after; check the exact launches, the boundary bytes (the plan's times
    the lanes), each lane against the dense oracle of its realization,
    the trajectory average, and a readout.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch import (EngineConfig, Simulator, build_circuit,
                             fidelity, with_depolarizing, zsum_cost_fn)
    from repro_torch.core.dense_engine import simulate_dense

    label = "main_batch"
    noisy = with_depolarizing(build_circuit("qft", BATCH_QUBITS),
                              BATCH_NOISE)
    torch.cuda.reset_peak_memory_stats()
    sim = Simulator(noisy, EngineConfig(codec_backend="device"))
    plan = sim.compile()
    print(f"{label}_plan qft-{BATCH_QUBITS} depolarizing p={BATCH_NOISE} "
          f"trajectories={BATCH_LANES} codec=device "
          f"local_bits={plan.local_bits} stages={plan.n_stages} "
          f"depth={plan.pipeline_depth} device={sim._engine.device}",
          flush=True)
    trace = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        trace = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
    reset_counts()
    with trace as prof:
        t0 = time.perf_counter()
        batch = sim.run(trajectories=BATCH_LANES, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts()
    st = sim.stats
    peak_dev = torch.cuda.max_memory_allocated()
    want = batch_launches(sim, tuple((None, j) for j in range(BATCH_LANES)))
    wire = tuple(BATCH_LANES * sum(getattr(sp, f) for sp in plan.stages
                                   if sp.plan)
                 for f in ("est_h2d_bytes", "est_d2h_bytes"))
    print(f"{label}_stats " + json.dumps({
        "wall_s": wall, "t_total": st.t_total, "t_compute": st.t_compute,
        "t_decompress": st.t_decompress, "t_compress": st.t_compress,
        "t_fetch": st.t_fetch, "h2d_bytes": st.h2d_bytes,
        "d2h_bytes": st.d2h_bytes, "plan_bytes_times_lanes": wire,
        "n_lanes": st.n_lanes, "n_batch_chunks": st.n_batch_chunks,
        "pressure_rungs": st.pressure_rungs,
        "peak_ram_bytes": st.peak_ram_bytes,
        "max_memory_allocated": peak_dev, "launches": launches,
        "expected_launches": want}), flush=True)
    if profile:
        trace_row = device_profile(prof, wall)
        print(f"{label}_profile " + json.dumps(trace_row), flush=True)
        if trace_row["library_gemm"]:
            fail(f"the {label} path ran library matrix products: "
                 f"{trace_row['library_gemm']}")
    if launches != want:
        fail(f"the {label} path launched {launches}, not {want}")
    # every lane's blocks cross once each way a stage, as the plan prices
    # one lane (device codec: fixed-size wire a block)
    if (st.h2d_bytes, st.d2h_bytes) != wire:
        fail(f"{label}: boundary bytes h2d {st.h2d_bytes} d2h "
             f"{st.d2h_bytes}, the plan's times {BATCH_LANES} lanes are "
             f"{wire[0]} and {wire[1]}")

    t0 = time.perf_counter()
    fids, zs, finite = [], [], True
    for j in range(BATCH_LANES):
        state = torch.from_numpy(batch[j].statevector(force=True)).to(
            "cuda:0")
        ideal = simulate_dense(noisy.realize(j), device="cuda:0")
        fids.append(fidelity(ideal, state))
        zs.append(zsum_on_card(ideal, BATCH_QUBITS))
        finite &= bool(torch.isfinite(torch.view_as_real(state)).all())
        del state, ideal
    t_oracle = time.perf_counter() - t0
    avg = batch.expectation(zsum_cost_fn(BATCH_QUBITS))
    counts = batch[0].sample(1024, seed=0)
    print(f"{label}_check " + json.dumps({
        "fidelity": fids, "finite": finite, "oracle_s": t_oracle,
        "zsum_avg": avg, "oracle_zsum_avg": float(np.mean(zs)),
        "oracle_zsum": zs, "shots": int(sum(counts.values())),
        "distinct": len(counts)}), flush=True)
    sim.close()
    if not finite:
        fail(f"{label}: a lane holds non-finite amplitudes")
    if not min(fids) >= FIDELITY_MIN:
        fail(f"{label}: lane fidelity {min(fids)} < {FIDELITY_MIN} against "
             "the dense oracle of its realization")
    if not abs(avg - float(np.mean(zs))) <= TRAJ_AVG_ATOL:
        fail(f"{label}: trajectory average {avg} is not within "
             f"{TRAJ_AVG_ATOL} of the oracles' {float(np.mean(zs))}")
    if sum(counts.values()) != 1024:
        fail(f"{label}: readout returned a malformed sample")
    return launches


def service_phase() -> dict:
    """SimService on SERVICE_JOBS co-admitted qaoa_template(22) jobs with
    the device codec on cuda:0 (launch counts set to 0 just before the
    drain, read just after): they must merge into one run_batch, and each
    lane's final state must equal bit for bit the same job run solo
    through a fresh SimService (width 1); then the first two jobs merged
    at width 2, held to the same solo runs.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch import EngineConfig, SimService, qaoa_template

    label = "service"
    qc = qaoa_template(SERVICE_QUBITS)
    cfg = EngineConfig(codec_backend="device", local_bits=SERVICE_LOCAL_BITS)
    points = [{"gamma0": 0.2 + 0.3 * i, "beta0": 0.1 + 0.15 * i}
              for i in range(SERVICE_JOBS)]

    def grab(view):
        return view.statevector(force=True)

    with SimService(SERVICE_BUDGET, config=cfg) as svc:
        jobs = [svc.submit(qc, params=p, readout=grab) for p in points]
        reset_counts()
        t0 = time.perf_counter()
        svc.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        summary = svc.stats.summary()
    # the first two jobs again, merged at width 2
    with SimService(SERVICE_BUDGET, config=cfg) as svc:
        pair = [svc.submit(qc, params=p, readout=grab) for p in points[:2]]
        t0 = time.perf_counter()
        svc.drain()
        pair_wall = time.perf_counter() - t0
    solo, solo_s = [], []
    for p in points:
        with SimService(SERVICE_BUDGET, config=cfg) as one:
            job = one.submit(qc, params=p, readout=grab)
            t0 = time.perf_counter()
            one.drain()
            solo_s.append(time.perf_counter() - t0)
            solo.append(job)
    equal = [bool(np.array_equal(m.result["readout"], s.result["readout"]))
             for m, s in zip(jobs, solo)]
    pair_equal = [bool(np.array_equal(m.result["readout"],
                                      s.result["readout"]))
                  for m, s in zip(pair, solo)]
    finite = all(bool(np.isfinite(m.result["readout"]).all()) for m in jobs)
    print(f"{label}_check " + json.dumps({
        "jobs": SERVICE_JOBS, "qubits": SERVICE_QUBITS,
        "merge_widths_checked": [SERVICE_JOBS, 2],
        "merge_widths": [j.merge_width for j in jobs],
        "pair_widths": [j.merge_width for j in pair],
        "solo_widths": [j.merge_width for j in solo],
        "states": [j.state for j in jobs + pair + solo],
        "merged_wall_s": wall, "pair_wall_s": pair_wall,
        "solo_wall_s": solo_s, "bitwise_equal": equal,
        "pair_bitwise_equal": pair_equal, "finite": finite,
        "stats": summary,
        "launches": {k: v for k, v in launches.items() if v}}), flush=True)
    if any(j.state != "done" for j in jobs + pair + solo):
        fail(f"{label}: a job did not finish")
    if [j.merge_width for j in jobs] != [SERVICE_JOBS] * SERVICE_JOBS:
        fail(f"{label}: the {SERVICE_JOBS} jobs did not merge into one "
             "run_batch")
    if [j.merge_width for j in pair] != [2, 2]:
        fail(f"{label}: the two jobs did not merge into one run_batch")
    if not (all(equal) and all(pair_equal) and finite):
        fail(f"{label}: a merged lane differs from its solo run "
             f"(width {SERVICE_JOBS}: {equal}; width 2: {pair_equal})")
    for k in ("gemm_planes_batch", "gemm_planes_mid_batch", "encode",
              "decode"):
        if launches[k] <= 0:
            fail(f"the {label} path launched {k} no time")
    return launches


def tf32_flags() -> dict:
    """The TF32 flags as torch reports them ("error" where torch refuses
    to answer for a mix of its legacy and new APIs)."""
    import torch
    m = torch.backends.cuda.matmul
    out = {}
    for name, get in (("allow_tf32", lambda: m.allow_tf32),
                      ("fp32_precision",
                       lambda: getattr(m, "fp32_precision", None)),
                      ("float32_matmul_precision",
                       torch.get_float32_matmul_precision)):
        try:
            out[name] = get()
        except RuntimeError:
            out[name] = "error"
    return out


def precision_phase() -> None:
    """With TF32 turned on the way a caller would
    (torch.set_float32_matmul_precision("high"), allow_tf32 = True), one
    bound stage of qft-24 (the one with the most GemmOps and MidGemmOps)
    through execute_schedule_batched (use_kernel True and False, a wave
    of 2 groups) and execute_schedule (use_kernel False, one group), and
    simulate_dense at PRECISION_DENSE_QUBITS qubits: each within RTOL,
    ATOL of the same call with TF32 off.  Every flag must read afterwards
    what the phase set; then TF32 goes off again."""
    import torch
    from repro_torch import EngineConfig, Simulator, build_circuit
    from repro_torch.core.dense_engine import simulate_dense
    from repro_torch.core.schedule import (GemmOp, MidGemmOp,
                                           execute_schedule,
                                           execute_schedule_batched)
    label = "precision"
    with Simulator(build_circuit("qft", BATCH_QUBITS), EngineConfig()) as sim:
        bound = [bs for bs in sim._engine._bind_stages(None) if bs.plan]

        def kinds(bs):
            ops = bs.sched.ops
            return (sum(isinstance(op, GemmOp) for op in ops),
                    sum(isinstance(op, MidGemmOp) for op in ops))
        bs = max(bound, key=lambda b: min(kinds(b)))
        sched, mats = bs.sched, bs.mats
    if min(kinds(bs)) <= 0:
        fail(f"{label}: no qft-{BATCH_QUBITS} stage holds both a GemmOp "
             "and a MidGemmOp")
    g = torch.Generator(device="cuda:0").manual_seed(24)
    wave = torch.randn((2, 2, 1 << sched.nv), generator=g, device="cuda:0")
    wave /= wave.norm(dim=(1, 2), keepdim=True)
    bmats = [m.unsqueeze(0).expand((2,) + tuple(m.shape)) for m in mats]
    dense = build_circuit("qft", PRECISION_DENSE_QUBITS)
    calls = {
        "batched_use_kernel": lambda: execute_schedule_batched(
            sched, wave.clone(), bmats, use_kernel=True),
        "batched_plain": lambda: execute_schedule_batched(
            sched, wave.clone(), bmats, use_kernel=False),
        "single_group_plain": lambda: execute_schedule(
            sched, wave[0].clone(), mats, use_kernel=False),
        "simulate_dense": lambda: torch.view_as_real(
            simulate_dense(dense, device="cuda:0")),
    }
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    set_flags = tf32_flags()
    on = {}
    after = {}
    for name, call in calls.items():
        on[name] = call()
        torch.cuda.synchronize()
        after[name] = tf32_flags()
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    off_flags = tf32_flags()
    rows = {}
    for name, call in calls.items():
        want = call()
        torch.cuda.synchronize()
        rows[name] = {
            "max_abs_diff": float((on[name] - want).abs().max()),
            "ok": bool(torch.allclose(on[name], want, rtol=RTOL,
                                      atol=ATOL))}
    print(f"{label}_check " + json.dumps({
        "stage_ops": {"gemm": kinds(bs)[0], "mid_gemm": kinds(bs)[1],
                      "all": len(sched.ops)},
        "flags_set": set_flags, "flags_after": after,
        "flags_off": off_flags, "tolerance": [RTOL, ATOL],
        "calls": rows}), flush=True)
    for name, flags in after.items():
        if flags != set_flags:
            fail(f"{label}: {name} left the TF32 flags at {flags}, not "
                 f"{set_flags}")
    if set_flags["allow_tf32"] is not True or off_flags["allow_tf32"]:
        fail(f"{label}: TF32 did not turn on and off ({set_flags}, "
             f"{off_flags})")
    bad = [name for name, row in rows.items() if not row["ok"]]
    if bad:
        fail(f"{label}: {bad} moved beyond rtol {RTOL}, atol {ATOL} with "
             "TF32 on")


def _plan_exchange(plan) -> tuple[int, list[int]]:
    """The blocks that change owners at the stage boundaries, recounted
    on the host from the plan artifact alone (each stage's layout and its
    StagePlan.device_slot): the total, and the moved keys a stage."""
    owners: dict[int, int] = {}
    moved = []
    for sp in plan.stages:
        if not sp.plan:
            continue
        keys = 0
        for g, row in enumerate(sp.layout.group_block_ids()):
            slot = sp.device_slot(g)
            for k in row.tolist():
                keys += owners.get(k, slot) != slot
                owners[k] = slot
        moved.append(keys)
    return sum(moved), moved


def multidevice_phase() -> dict:
    """Several devices (paper §4.2) on one card, as D slots of cuda:0.
    Block sharding: qft-26 on the device codec over 4 slots against the
    one-slot run: the state bit for bit, fidelity >= 0.99 against the
    dense oracle, the exchange ledger's block count equal to a recount
    from the plan, 0 < exchange bytes < the moved blocks' raw bytes, the
    stages summing to the total with stage 0 free, boundary bytes and
    every launch count equal to the one-slot run's.  Lane sharding: noisy
    qft-20, 8 trajectories, host codec, over 2 slots: every lane bit for
    bit the one-slot run's, every launch count equal to it (the two slots
    are one card, so the one-device waves), nothing exchanged.  Then a
    pipeline.exchange crash two thirds of the way through qft-16's
    hand-offs on 2 slots,
    resumed bit for bit, and simulate_dense_sharded at 26 qubits over 4
    slots against simulate_dense within MULTI_DENSE_ATOL.  Returns the
    block-sharded run's launches."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch import (EngineConfig, InjectedCrash, Simulator,
                             build_circuit, fidelity, inject_faults,
                             with_depolarizing)
    from repro_torch.core.dense_engine import (simulate_dense,
                                               simulate_dense_sharded)
    label = "multidevice"
    card = torch.device("cuda", 0)
    out, walls = {}, {}

    # block sharding
    qc = build_circuit("qft", MULTI_QUBITS)
    runs = {}
    for slots in (1, MULTI_SLOTS):
        with Simulator(qc, EngineConfig(codec_backend="device",
                                        devices=[card] * slots)) as sim:
            plan = sim.compile()
            reset_counts()
            t0 = time.perf_counter()
            result = sim.run()
            torch.cuda.synchronize()
            walls[f"block_{slots}"] = time.perf_counter() - t0
            st = sim.stats
            runs[slots] = {
                "launches": read_counts(), "plan": plan,
                "state": result.statevector(force=True),
                "boundary": (st.h2d_bytes, st.d2h_bytes),
                "n_exchanged_blocks": st.n_exchanged_blocks,
                "exchange_bytes": st.exchange_bytes,
                "per_stage": list(st.per_stage_exchange_bytes)}
    one, many = runs[1], runs[MULTI_SLOTS]
    recount, per_stage_keys = _plan_exchange(many["plan"])
    raw = many["n_exchanged_blocks"] * (1 << many["plan"].local_bits) * 8
    state = torch.from_numpy(many["state"]).to(card)
    ideal = simulate_dense(qc, device=card)
    fid = fidelity(ideal, state)
    del state
    out["block"] = {
        "circuit": f"qft-{MULTI_QUBITS}", "codec": "device",
        "slots": MULTI_SLOTS, "n_devices": many["plan"].n_devices,
        "local_bits": many["plan"].local_bits,
        "bitwise_equal": bool(np.array_equal(one["state"], many["state"])),
        "fidelity": fid, "n_exchanged_blocks": many["n_exchanged_blocks"],
        "plan_recount": recount, "plan_recount_per_stage": per_stage_keys,
        "exchange_bytes": many["exchange_bytes"], "raw_bytes": raw,
        "per_stage_exchange_bytes": many["per_stage"],
        "boundary_bytes": many["boundary"],
        "boundary_equal": many["boundary"] == one["boundary"],
        "launches": many["launches"],
        "launches_equal": many["launches"] == one["launches"]}
    b = out["block"]
    checks = {
        "bitwise": b["bitwise_equal"], "fidelity": fid >= FIDELITY_MIN,
        "recount": b["n_exchanged_blocks"] == recount > 0,
        "bytes": 0 < b["exchange_bytes"] < raw,
        "stages": (sum(b["per_stage_exchange_bytes"]) == b["exchange_bytes"]
                   and b["per_stage_exchange_bytes"][0] == 0),
        "boundary": b["boundary_equal"], "launches": b["launches_equal"],
        "launched": all(b["launches"][k] > 0 for k in (
            "gemm_planes_batch", "gemm_planes_mid_batch", "encode",
            "decode")),
        "one_slot_free": one["n_exchanged_blocks"] == 0}
    del runs, one, many

    # lane sharding
    noisy = with_depolarizing(build_circuit("qft", MULTI_LANE_QUBITS),
                              BATCH_NOISE)
    lanes = {}
    for slots in (1, MULTI_LANE_SLOTS):
        with Simulator(noisy, EngineConfig(devices=[card] * slots)) as sim:
            reset_counts()
            t0 = time.perf_counter()
            batch = sim.run(trajectories=BATCH_LANES, seed=0)
            torch.cuda.synchronize()
            walls[f"lanes_{slots}"] = time.perf_counter() - t0
            lanes[slots] = ([lane.statevector() for lane in batch],
                            sim.stats.exchange_bytes,
                            sim.stats.n_exchanged_blocks, read_counts())
    equal = [bool(np.array_equal(a, c)) for a, c in
             zip(lanes[1][0], lanes[MULTI_LANE_SLOTS][0])]
    out["lanes"] = {"circuit": f"noisy qft-{MULTI_LANE_QUBITS}",
                    "trajectories": BATCH_LANES, "codec": "host",
                    "slots": MULTI_LANE_SLOTS, "lanes_bitwise_equal": equal,
                    "exchange_bytes": lanes[MULTI_LANE_SLOTS][1],
                    "n_exchanged_blocks": lanes[MULTI_LANE_SLOTS][2],
                    "launches": lanes[MULTI_LANE_SLOTS][3],
                    "launches_equal": lanes[1][3] == lanes[MULTI_LANE_SLOTS][3]}
    checks["lanes"] = all(equal) and len(equal) == BATCH_LANES
    checks["lanes_free"] = lanes[MULTI_LANE_SLOTS][1:3] == (0, 0)
    checks["lanes_launches"] = out["lanes"]["launches_equal"]
    del lanes

    # a crash at a block hand-off, resumed from the last checkpoint
    t0 = time.perf_counter()
    qc16 = build_circuit("qft", MULTI_CRASH_QUBITS)

    def cfg():
        return EngineConfig(devices=[card] * MULTI_LANE_SLOTS)

    never = 1 << 40
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        ck = os.path.join(tmp, "ck.bmq")
        with inject_faults([f"pipeline.exchange:ioerror:hit={never}"]) \
                as inj:
            with Simulator(qc16, cfg()) as sim:
                want = sim.run().statevector()
                n_stages = sim.stats.n_stages
            hits = inj._hits["pipeline.exchange"]
        crash_hit = 2 * hits // 3
        crashed = False
        with inject_faults([f"pipeline.exchange:crash:hit={crash_hit}"]) \
                as inj:
            with Simulator(qc16, cfg()) as sim:
                try:
                    sim.run(checkpoint_path=ck, checkpoint_every=1)
                except InjectedCrash:
                    crashed = True
            fired = inj.fired["pipeline.exchange:crash"]
        start = None
        resumed_equal = False
        if crashed and os.path.exists(ck):
            with Simulator.resume(ck, circuit=qc16, config=cfg()) as sim:
                start = sim._start_stage
                resumed_equal = bool(np.array_equal(
                    sim.run().statevector(), want))
    walls["crash"] = time.perf_counter() - t0
    out["crash"] = {"circuit": f"qft-{MULTI_CRASH_QUBITS}",
                    "slots": MULTI_LANE_SLOTS, "exchange_hits": hits,
                    "crash_hit": crash_hit, "fired": fired,
                    "resumed_from_stage": start, "stages": n_stages,
                    "resumed_bitwise_equal": resumed_equal}
    checks["crash"] = (crashed and fired == 1 and start is not None
                       and 0 < start < n_stages and resumed_equal)

    # the sharded dense baseline
    t0 = time.perf_counter()
    slices = simulate_dense_sharded(qc, [card] * MULTI_SLOTS)
    torch.cuda.synchronize()
    walls["dense_sharded"] = time.perf_counter() - t0
    err = float((torch.cat(slices) - ideal).abs().max())
    del slices, ideal
    out["dense_sharded"] = {"qubits": MULTI_QUBITS, "slots": MULTI_SLOTS,
                            "max_abs_err": err, "atol": MULTI_DENSE_ATOL}
    checks["dense_sharded"] = err <= MULTI_DENSE_ATOL
    print(f"{label}_check " + json.dumps({**out, "walls_s": walls,
                                          "checks": checks}), flush=True)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"{label}: {bad} did not hold ({json.dumps(out)[:3000]})")
    return b["launches"]


def resilience_phase() -> None:
    """Resilience on the card, device codec, the disk tier forced: a
    checkpointed ising-24 run (RESILIENCE_CIRCUIT) counting the fault
    points' hits; a codec.decode crash two thirds of the way in, resumed
    from its last checkpoint, must reproduce the uninterrupted state bit
    for bit; a store.spill_read corruption two thirds of the way in must
    be detected and replayed from the last checkpoint, with the same
    state."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch import (EngineConfig, Simulator, build_circuit,
                             inject_faults)
    from repro_torch.faults import InjectedCrash
    label = "resilience"
    name, n = RESILIENCE_CIRCUIT
    qc = build_circuit(name, n)

    def cfg():
        return EngineConfig(codec_backend="device",
                            ram_budget_bytes=RESILIENCE_RAM)

    never = 1 << 40
    walls = {}
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        ck = os.path.join(tmp, "ck.bmq")
        with inject_faults([f"codec.decode:ioerror:hit={never}",
                            f"store.spill_read:ioerror:hit={never}"]) as inj:
            with Simulator(qc, cfg()) as sim:
                t0 = time.perf_counter()
                result = sim.run(checkpoint_path=ck,
                                 checkpoint_every=RESILIENCE_EVERY)
                torch.cuda.synchronize()
                walls["uninterrupted"] = time.perf_counter() - t0
                hits = dict(inj._hits)
                want = result.statevector(force=True)
                st = sim.stats
                base = {"stages": st.n_stages, "n_spills": st.n_spills,
                        "disk_bytes": st.disk_bytes}
        ck_bytes = os.path.getsize(ck)
        os.unlink(ck)
        crash_hit = 2 * hits["codec.decode"] // 3
        crashed = False
        with inject_faults([f"codec.decode:crash:hit={crash_hit}"]):
            with Simulator(qc, cfg()) as sim:
                t0 = time.perf_counter()
                try:
                    sim.run(checkpoint_path=ck,
                            checkpoint_every=RESILIENCE_EVERY)
                except InjectedCrash:
                    crashed = True
                walls["crashed"] = time.perf_counter() - t0
        if not crashed or not os.path.exists(ck):
            fail(f"{label}: the codec.decode crash at hit {crash_hit} did "
                 "not end the run with a checkpoint on disk")
        with Simulator.resume(ck, circuit=qc, config=cfg()) as sim:
            start = sim._start_stage
            t0 = time.perf_counter()
            got = sim.run().statevector(force=True)
            walls["resumed"] = time.perf_counter() - t0
        resumed_equal = bool(np.array_equal(got, want))
        corrupt_hit = 2 * hits["store.spill_read"] // 3
        with inject_faults([f"store.spill_read:corrupt:hit={corrupt_hit}"]) \
                as inj:
            with Simulator(qc, cfg()) as sim:
                t0 = time.perf_counter()
                got = sim.run(checkpoint_path=os.path.join(tmp, "ck2.bmq"),
                              checkpoint_every=RESILIENCE_EVERY) \
                    .statevector(force=True)
                walls["replayed"] = time.perf_counter() - t0
                replays = sim.stats.n_replays
                emergency = sim.stats.n_emergency_checkpoints
                detected = sim.stats.n_corruptions_detected
        fired = inj.fired["store.spill_read:corrupt"]
        replayed_equal = bool(np.array_equal(got, want))
    print(f"{label}_stats " + json.dumps({
        "circuit": f"{name}-{n}", "codec": "device",
        "ram_budget_bytes": RESILIENCE_RAM,
        "checkpoint_every": RESILIENCE_EVERY, **base, "walls_s": walls,
        "checkpoint_bytes": ck_bytes, "hits": hits,
        "crash_hit": crash_hit, "resumed_from_stage": start,
        "resumed_bitwise_equal": resumed_equal,
        "corrupt_hit": corrupt_hit, "corruptions_fired": fired,
        "n_corruptions_detected": detected, "n_replays": replays,
        "n_emergency_checkpoints": emergency,
        "replayed_bitwise_equal": replayed_equal}), flush=True)
    if not 0 < start < base["stages"]:
        fail(f"{label}: resumed at stage {start} of {base['stages']}")
    if not resumed_equal:
        fail(f"{label}: the resumed run differs from the uninterrupted one")
    if fired != 1 or replays < 1 or not replayed_equal:
        fail(f"{label}: the corrupted spill read (fired {fired}) was not "
             f"replayed to the same state ({replays} replays, equal "
             f"{replayed_equal})")


CLI_ARGS = ["--circuit", "qft", "--qubits", "20", "--noise", "0.02",
            "--trajectories", "4", "--codec-backend", "device",
            "--expect", "zsum"]


CLI_DEVICES_ARGS = ["--circuit", "qft", "--qubits", "20", "--devices",
                    "2", "--codec-backend", "device"]


def _src_env(**extra) -> dict:
    """This process's environment with the checkout's ``src`` first on
    PYTHONPATH (and ``extra`` set): what every subprocess gets."""
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _qsim(argv: list) -> tuple:
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.qsim"] + argv,
        cwd=HERE, env=_src_env(), capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    print("cli_check " + json.dumps({
        "argv": argv, "rc": out.returncode, "wall_s": wall,
        "lines": lines[-12:]}), flush=True)
    if out.returncode != 0:
        fail(f"qsim exited {out.returncode}: {out.stderr.strip()[-2000:]}")
    return lines


def cli_phase() -> None:
    """``python -m repro_torch.launch.qsim`` as a subprocess on the card,
    with noise trajectories (it must exit 0 and print the batched-run
    line and the trajectory average) and with ``--devices 2`` (exit 0,
    the slots line naming one physical device and an exchange line with
    hand-offs)."""
    lines = _qsim(CLI_ARGS)
    batched = [ln for ln in lines if ln.startswith("[qsim] batched run:")]
    zsum = [ln for ln in lines if ln.startswith("[qsim] <sum Z_i>")]
    if not batched or not zsum:
        fail("qsim printed no batched-run line or no trajectory average")
    lines = _qsim(CLI_DEVICES_ARGS)
    slots = [ln for ln in lines if ln.startswith(
        "[qsim] 2 device slots on 1 physical device(s): cuda:0")]
    moved = [ln for ln in lines if ln.startswith(
        "[qsim] device exchange (2 devices):")]
    if not slots or not moved or moved[0].endswith(" 0 block hand-off(s)"):
        fail("qsim --devices 2 printed no slots line or no exchange line "
             "with hand-offs")


# -- the host tooling and the Simulator's examples ---------------------------

TOOLING_QUBITS = 26              # the --plan check's plan: qft-26 on the card
TOOLING_TIMEOUT_S = 300
LINT_CHECKERS = ("fault-coverage", "jit-purity", "lock-discipline",
                 "typed-errors")


def _tool(argv: list, env: dict) -> dict:
    """``python -m <argv>`` from the checkout's root; killed, with rc
    "timeout", past TOOLING_TIMEOUT_S."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-m"] + argv, cwd=HERE,
                             env=env, capture_output=True, text=True,
                             timeout=TOOLING_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {"argv": argv, "rc": "timeout",
                "wall_s": time.perf_counter() - t0, "lines": [],
                "stderr": ""}
    return {"argv": argv, "rc": out.returncode,
            "wall_s": time.perf_counter() - t0,
            "lines": out.stdout.splitlines()[-6:],
            "stderr": out.stderr.strip()[-2000:]}


def tooling_phase(tmp: str) -> dict:
    """The port's host tooling as subprocesses with no card and the
    checkout's src on PYTHONPATH, all started together: the lint over
    src/repro_torch (0 violations in every .py, none quarantined), its
    checker list, --plan on the JSON of a qft-26 plan the port compiled
    on cuda:0 here (0 errors, the plan's fingerprint named), the link
    check of README.md and docs/, and api_doc --check of
    docs/API_torch.md.  One tooling_check line a command."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import EngineConfig, Simulator, build_circuit

    with Simulator(build_circuit("qft", TOOLING_QUBITS),
                   EngineConfig()) as sim:
        if sim._engine.device.type != "cuda":
            fail(f"tooling: the plan compiled on {sim._engine.device}")
        plan = sim.compile()
    plan_path = os.path.join(tmp, f"qft{TOOLING_QUBITS}_plan.json")
    with open(plan_path, "w", encoding="utf-8") as f:
        f.write(plan.to_json())
    runs = {
        "lint": ["repro_torch.analysis", "src/repro_torch"],
        "list": ["repro_torch.analysis", "--list"],
        "plan": ["repro_torch.analysis", "--plan", plan_path],
        "linkcheck": ["repro_torch.analysis.linkcheck", "README.md", "docs"],
        "api_doc": ["repro_torch.analysis.api_doc", "--check",
                    "docs/API_torch.md"],
    }
    env = _src_env(CUDA_VISIBLE_DEVICES="")
    with ThreadPoolExecutor(len(runs)) as ex:
        futures = {k: ex.submit(_tool, argv, env) for k, argv in runs.items()}
        res = {k: f.result() for k, f in futures.items()}
    for r in res.values():
        print("tooling_check " + json.dumps(
            {k: v for k, v in r.items() if k != "stderr"}), flush=True)
    for k, r in res.items():
        if r["rc"] != 0:
            fail(f"tooling: {' '.join(r['argv'])} exited {r['rc']}: "
                 f"{r['lines'][-3:]} {r['stderr']}")
    from pathlib import Path
    n_files = len(list(Path(HERE, "src", "repro_torch").rglob("*.py")))
    want = f"0 violation(s) in {n_files} file(s) checked"
    if res["lint"]["lines"][-1:] != [want]:
        fail(f"tooling: the lint printed {res['lint']['lines'][-1:]}, "
             f"not {want!r} (every .py of src/repro_torch, none quarantined)")
    listed = {ln.split()[0] for ln in res["list"]["lines"] if ln.strip()}
    if listed != set(LINT_CHECKERS):
        fail(f"tooling: --list named {sorted(listed)}")
    verdict = f"plan {plan.fingerprint[:12]}: 0 error(s)"
    if not any(ln.startswith(verdict) for ln in res["plan"]["lines"]):
        fail(f"tooling: --plan printed {res['plan']['lines']}, not "
             f"{verdict!r}")
    return {"n_files": n_files, "fingerprint": plan.fingerprint[:12],
            "wall_s": {k: r["wall_s"] for k, r in res.items()}}


EXAMPLE_FIDELITY_MIN = 0.99999
EXAMPLE_CUT_RTOL = 1e-4          # <cut> on the card against the CPU run
EXAMPLE_QAOA_RUNS = 3            # qaoa_sim's default sweep
EXAMPLE_QAOA_SMALL = ["--qubits", "12", "--block-bits", "7", "--sweep", "2"]


def _example(name: str, argv: list, label: str) -> tuple[list, dict]:
    """Load examples/<name>.py by path and call its main(argv) in this
    process, its output captured, with every launch count set to 0 just
    before and read just after.  Prints one example_check line."""
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in read_counts().items() if n}
    lines = buf.getvalue().splitlines()
    print("example_check " + json.dumps({
        "example": name, "run": label, "argv": argv, "wall_s": wall,
        "launches": launches, "lines": lines}), flush=True)
    return lines, launches


def _cuts(lines: list) -> list[float]:
    return [float(ln.split("<cut> = ")[1].split()[0]) for ln in lines
            if "<cut> = " in ln]


def examples_phase() -> dict:
    """examples/quickstart_torch.py and examples/qaoa_sim_torch.py in this
    process on cuda:0: quickstart at its defaults (qft-14) prints a
    fidelity >= 0.99999 and launches gemm_planes_batch; qaoa at its
    defaults (18 qubits, 3 points) prints 3 runs with the stage-fn
    compiles of run 1 unchanged after it; then qaoa at 12 qubits, block
    bits 7, 2 points on the card and with --device cpu beside it, every
    <cut> within 1e-4 relative.  Returns the launches of the card runs."""
    total: dict[str, int] = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    lines, launches = _example("quickstart_torch", [], "card")
    add(launches)
    fid = [float(ln.split(":")[1]) for ln in lines
           if ln.startswith("fidelity")]
    if not fid or not fid[0] >= EXAMPLE_FIDELITY_MIN:
        fail(f"examples: quickstart printed fidelity {fid}, want >= "
             f"{EXAMPLE_FIDELITY_MIN}")
    if launches.get("gemm_planes_batch", 0) <= 0:
        fail("examples: quickstart on cuda:0 launched gemm_planes_batch no "
             "time")

    lines, launches = _example("qaoa_sim_torch", [], "card")
    add(launches)
    compiles = [int(ln.split("compiles so far: ")[1].rstrip(")"))
                for ln in lines if "compiles so far: " in ln]
    if len(compiles) != EXAMPLE_QAOA_RUNS or len(set(compiles)) != 1:
        fail(f"examples: qaoa printed stage-fn compiles {compiles}, want "
             f"{EXAMPLE_QAOA_RUNS} runs with run 1's count kept")
    if not all(math.isfinite(c) for c in _cuts(lines)):
        fail("examples: qaoa printed a non-finite <cut>")

    card, launches = _example("qaoa_sim_torch", EXAMPLE_QAOA_SMALL, "card")
    add(launches)
    cpu, _ = _example("qaoa_sim_torch",
                      EXAMPLE_QAOA_SMALL + ["--device", "cpu"], "cpu")
    got, want = _cuts(card), _cuts(cpu)
    if len(got) != len(want) or not got or any(
            abs(g - w) > EXAMPLE_CUT_RTOL * abs(w) for g, w in zip(got, want)):
        fail(f"examples: qaoa <cut> on the card {got}, on the CPU {want}")
    return total


# -- phases 13-14: LLM serving on the compressed KV cache --------------------

def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone()


def _trace(profile: bool):
    import torch
    if not profile:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(activities=[ProfilerActivity.CUDA])


def _entries(cache) -> list:
    """The cache's entries: a decoder-only LM's units and remainder, an
    encoder-decoder's one flat dict."""
    if "units" in cache:
        return list(cache["units"]) + list(cache["rem"])
    return [cache]


def _cache_bytes(cache, key: str) -> int:
    """Bytes of the cache's entries that hold ``key``: "k" the raw
    attention entries (self and cross), "codes_k" the compressed ones
    (recurrent states hold neither)."""
    return sum(t.numel() * t.element_size() for c in _entries(cache)
               if key in c for t in c.values())


def _state_bytes(cfg, cache) -> int:
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    M = E if cfg.family == "audio" else T
    return sum(t.numel() * t.element_size()
               for t in M.state_leaves(cfg, cache))


def _serve_inputs(cfg, seed: int) -> tuple:
    """(prefill batch, prompt length, max_len, compressed decode) of a
    serve phase: 8 prompts of 2,048 tokens, max_len 4,096 and a compressed
    cache; a VLM's image embeddings (8, n_image_tokens, d_model) beside
    them; an encoder-decoder's 8 x n_frames frames and a prompt of
    WHISPER_PROMPT tokens, max_len its dec_len, raw decode (as repro).
    Tokens from a numpy generator of ``seed``, the embeddings drawn on
    the card from ``seed``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda:0").manual_seed(seed + 1)
    audio = cfg.family == "audio"
    prompt = WHISPER_PROMPT if audio else SERVE_PROMPT
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, prompt))).to("cuda:0")}
    n_src = (cfg.encoder.n_frames if audio else cfg.n_image_tokens
             if "cross_attn" in cfg.pattern else 0)
    if n_src:
        batch["frames" if audio else "aux"] = torch.randn(
            (SERVE_BATCH, n_src, cfg.d_model), generator=g,
            device="cuda:0").bfloat16()
    max_len = cfg.encoder.dec_len if audio else SERVE_MAX_LEN
    return batch, prompt, max_len, not audio


def _prefill(cfg, params, batch, max_len: int, compress: bool,
             profile: bool = False) -> tuple:
    """Prefill ``batch`` with room for ``max_len`` and (``compress``)
    compress the cache, through the serving entry points; returns the
    last logits, the cache and timings.  The cache ratio reads the
    attention entries only (None for a model without attention, or one
    decoding on raw caches); recurrent states stay raw."""
    import torch
    from repro_torch.serving import make_prefill_step
    from repro_torch.serving.kvcache import compress_prefill_cache
    prefill = make_prefill_step(cfg, max_len=max_len)
    with _trace(profile) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    raw = _cache_bytes(cache, "k")
    if compress:
        cache = compress_prefill_cache(cache)
    comp = _cache_bytes(cache, "codes_k")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    timing = {"prefill_s": t1 - t0, "compress_s": t2 - t1,
              "prefill_tokens_per_s": batch["tokens"].numel() / (t1 - t0),
              "raw_cache_bytes": raw, "compressed_cache_bytes": comp,
              "cache_ratio": raw / comp if comp else None,
              "state_bytes": _state_bytes(cfg, cache)}
    if profile:
        timing["profile"] = device_profile(prof, t1 - t0)
    return logits, cache, timing


def _decode(cfg, params, qcache, first, start: int, steps: int,
            captured: bool, compressed: bool = True, forced=None,
            profile: bool = False) -> tuple:
    """``steps`` decode steps from ``start`` on ``qcache`` (compressed,
    or raw; greedy from ``first``, or the ``forced`` tokens), eager or
    through CapturedDecodeStep (warmed up and captured on the first
    step's inputs before the timed run, so every step is a replay).  The
    launch counts are set to 0 just before the steps; returns every step's
    logits, the tokens fed, timings and the steps' launches (the captured
    step's replays counted by the step)."""
    import torch
    from repro_torch.serving import CapturedDecodeStep, make_decode_step
    from repro_torch.serving.kvcache import make_compressed_decode_step
    decode = (make_compressed_decode_step(cfg) if compressed
              else make_decode_step(cfg))
    first = first if forced is None else forced[:, :1]
    if captured:
        step = CapturedDecodeStep(cfg, decode, params, qcache)
        step.capture(first, start)
        torch.cuda.synchronize()
    else:
        def step(tok, pos):
            return decode(params, {"token": tok, "cache": qcache,
                                   "pos": pos})[0]
    reset_counts()
    out, fed, tok = [], [], first
    with _trace(profile) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            if i:
                tok = (out[-1].argmax(-1)[:, None] if forced is None
                       else forced[:, i:i + 1])
            fed.append(tok)
            logits = step(tok, start + i)
            out.append(logits.clone() if captured else logits)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = read_counts()
    if captured:
        for k, n in step.launches().items():
            launches[k] += n
    B = first.shape[0]
    timing = {"decode_s": t1 - t0, "decode_ms_per_step": (t1 - t0) / steps
              * 1e3, "decode_tokens_per_s": B * steps / (t1 - t0),
              "launches": {k: v for k, v in launches.items() if v}}
    if profile:
        timing["profile"] = device_profile(prof, t1 - t0)
        timing["profile"]["kernel_counts"] = {
            k: sum(e.count for e in prof.key_averages()
                   if k in e.key and e.self_device_time_total > 0)
            for k in ("kvdq_partial_kernel", "kvdq_combine_kernel",
                      "flash_bf16_kernel", "flash_f32_kernel")}
    return out, torch.cat(fed, dim=1), timing, launches


def _init_model(label: str, arch: str, seed: int, layers=None):
    """``arch`` at full width on cuda:0, bf16 weights drawn from ``seed``
    (an encoder-decoder's through ``encdec``); ``layers`` cuts its depth
    (a printed cut), None keeps it whole."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    if layers is not None:
        print(f"{label}_cut {arch} layers={layers} of {cfg.n_layers} "
              f"param_count()={cfg.with_(n_layers=layers).param_count()} "
              f"of {cfg.param_count()}", flush=True)
        cfg = cfg.with_(n_layers=layers)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    init = E.init_encdec_params if cfg.family == "audio" else T.init_params
    params = init(cfg, torch.Generator(device=dev).manual_seed(seed),
                  device=dev)
    leaves = list(_leaves(params))
    n_bf16 = sum(t.numel() for t in leaves if t.dtype == torch.bfloat16)
    n_f32 = sum(t.numel() for t in leaves if t.dtype == torch.float32)
    torch.cuda.synchronize()
    print(f"{label}_model {arch} layers={cfg.n_layers} "
          f"kinds={','.join(sorted(set(cfg.pattern)))} "
          f"window={cfg.sliding_window} d_model={cfg.d_model} "
          f"encoder_layers={cfg.encoder.n_layers if cfg.encoder else 0} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} "
          f"params={n_bf16 + n_f32} bf16={n_bf16} f32={n_f32} "
          f"param_count()={cfg.param_count()} "
          f"init_s={time.perf_counter() - t0:.3f}", flush=True)
    return cfg, params, 2 * n_bf16 + 4 * n_f32


@contextlib.contextmanager
def _routing(log: list):
    """Record every MoE layer's expert choices (each token's sorted top-k
    ids, on the card) into ``log`` while the block runs: the router as
    ``moe.route`` computes it, once more beside the layer."""
    from unittest import mock

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    real = T.moe_layer

    def moe_layer(x, prm, cfg):
        _, ids = moe_mod.route(x.reshape(-1, x.shape[-1]), prm["router"],
                               cfg.moe.top_k)
        log.append(ids.sort(dim=-1).values)
        return real(x, prm, cfg)
    with mock.patch.object(T, "moe_layer", moe_layer):
        yield


def _plain_flash_by_row(q, k, v, causal=True, window=0):
    """B10's plain version a batch row at a time: the same function, with
    its f32 score matrices one row's size (arctic's whole batch would need
    ~26 GB beside 55 GB of weights)."""
    import torch
    from repro_torch.kernels import ref
    return torch.cat([ref.flash_attention_gqa_ref(q[b:b + 1], k[b:b + 1],
                                                  v[b:b + 1], causal, window)
                      for b in range(q.shape[0])])


def _row_errs(got, want) -> list:
    """Each step's max|Δlogits| a batch row over that step's max|logits|
    (on the host)."""
    return [((a - b).abs().amax(-1) / a.abs().max()).float().cpu()
            for a, b in zip(got, want)]


def _masked_max(x, mask) -> float:
    return float(x[mask].max()) if bool(mask.any()) else 0.0


def _parted_rows(routes: dict, batch: int, steps: int) -> list:
    """For the prefill's last token and each decode step's token: the
    batch rows whose expert set differs between the kernel run and the
    plain run at any MoE layer (bool (batch,) on the host)."""
    def per_token(kernel, plain, last: bool):
        out = None
        for a, b in zip(kernel, plain):
            d = (a != b).any(-1).reshape(batch, -1)
            d = d[:, -1] if last else d.any(-1)
            out = d if out is None else out | d
        return out.cpu()
    parted = [per_token(routes["kernels"], routes["plain"], True)]
    n = len(routes["kernels_steps"]) // steps
    for i in range(steps):
        parted.append(per_token(routes["kernels_steps"][i * n:(i + 1) * n],
                                routes["plain_steps"][i * n:(i + 1) * n],
                                False))
    return parted


def _rel_errs(got, want) -> list[float]:
    return [float((a - b).abs().max()) / float(a.abs().max())
            for a, b in zip(got, want)]


def seqattn_check(label: str, cfg, params, batch, prompt: int,
                  max_len: int, steps: int, want_logits: list) -> dict:
    """The serve phase's model with ``seq_parallel_attn=True`` on its
    weights and prompts: prefill (one B10 launch an attention layer: the
    same call as with False; repro's flag only adds sharding constraints),
    compress, and ``steps`` greedy captured compressed decode steps from
    the prefill's own argmax.  Every logits tensor (the prefill's last and
    each step's) must equal ``want_logits``, the False run's, bit for bit.
    Returns the run's launches (prefill and replays)."""
    import torch
    from repro_torch.models import transformer as T
    scfg = cfg.with_(seq_parallel_attn=True)
    n_attn = sum(k in T.ATTN_KINDS for k in scfg.layer_kinds())
    t0 = time.perf_counter()
    reset_counts()
    logits0, qcache, _ = _prefill(scfg, params, batch, max_len, True)
    prefill_launches = read_counts()
    out, _, timing, launches = _decode(scfg, params, qcache,
                                       logits0.argmax(-1)[:, None], prompt,
                                       steps, True)
    del qcache
    got = [logits0] + out
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, want_logits)]
    launches = dict(launches)
    launches["flash_attention"] += prefill_launches["flash_attention"]
    res = {"arch": scfg.name, "seq_parallel_attn": True,
           "bitwise_equal": equal, "steps": steps,
           "prefill_launches": {k: v for k, v in prefill_launches.items()
                                if v},
           "decode_ms_per_step": timing["decode_ms_per_step"],
           "wall_s": time.perf_counter() - t0}
    print(f"{label}_seqattn_check " + json.dumps(res), flush=True)
    if prefill_launches["flash_attention"] != n_attn:
        fail(f"{label}: seq_parallel_attn prefill launched flash_attention "
             f"{prefill_launches['flash_attention']} times, not {n_attn}")
    if len(equal) != len(want_logits) or not all(equal):
        fail(f"{label}: seq_parallel_attn=True logits differ from the "
             f"False run's at {[i for i, e in enumerate(equal) if not e]}")
    return launches


def serve_phase(label: str, arch: str, steps: int, seed: int,
                profile: bool, eager_too: bool, layers=None,
                seqattn: dict | None = None) -> dict:
    """``arch`` at full width (and depth, or ``layers`` of it; bf16
    weights drawn on cuda:0 from ``seed``): prefill 8 x 2,048 tokens
    (max_len 4,096; a VLM with its image embeddings; an encoder-decoder
    :func:`_serve_inputs`' frames and prompt), compress the cache,
    ``steps`` compressed decode steps (an encoder-decoder's raw, as
    repro's) through CapturedDecodeStep (with ``eager_too`` first eagerly,
    from a copy of the same cache: the two bit for bit at every step);
    exactly one B10 launch an attention layer (self, cross or encoder) and
    one B11 a self- or cross-attention layer a compressed step; then the
    same inputs with the two kernels' plain versions
    patched in (0 launches; B10's a batch row at a time), teacher-forced
    on the captured run's tokens, within
    SERVE_LOGIT_RTOL * max|logits| at every step; the attention cache >=
    KV_RATIO_MIN smaller than bf16 (a model without attention says so).
    For an MoE model both prefills record every layer's expert choices and
    the share of (token, layer) expert sets that differ between them is
    printed.  With ``seqattn`` (a dict), :func:`seqattn_check` runs on the
    same weights and prompts after the captured run and puts its launches
    in ``seqattn``.  Prints the phase's peak device memory.  Returns the
    captured run's launches (prefill and replays)."""
    from unittest import mock

    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as T
    from repro_torch.serving import kvcache as kv_mod

    torch.cuda.empty_cache()
    at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, weight_bytes = _init_model(label, arch, seed, layers)
    audio = cfg.family == "audio"
    kinds = cfg.layer_kinds()
    n_attn = sum(k in T.ATTN_KINDS for k in kinds)
    n_cross = cfg.n_layers if audio else sum(k in T.CROSS_KINDS
                                             for k in kinds)
    n_enc = cfg.encoder.n_layers if audio else 0
    moe = cfg.moe is not None
    batch, prompt, max_len, compressed = _serve_inputs(cfg, seed)
    reset_counts()
    routes = {run: [] for run in ("kernels", "plain", "kernels_steps",
                                  "plain_steps")}
    with (_routing(routes["kernels"]) if moe else contextlib.nullcontext()):
        logits0, qcache, stats = _prefill(cfg, params, batch, max_len,
                                          compressed, profile)
    prefill_launches = read_counts()
    first = logits0.argmax(-1)[:, None]
    want_b10 = {"flash_attention": n_enc + n_attn + n_cross,
                "kv_dequant_decode_attention": 0}
    want_b11 = {"flash_attention": 0, "kv_dequant_decode_attention":
                (n_attn + n_cross) * steps if compressed else 0}
    runs = {}
    if eager_too:
        eager_cache = _clone_tree(qcache)
        with (_routing(routes["kernels_steps"]) if moe
              else contextlib.nullcontext()):
            runs["eager"] = _decode(cfg, params, eager_cache, first, prompt,
                                    steps, False, compressed,
                                    profile=profile)
        del eager_cache
    runs["captured"] = _decode(cfg, params, qcache, first, prompt, steps,
                               True, compressed, profile=profile)
    del qcache
    if seqattn is not None:
        seqattn.update(seqattn_check(label, cfg, params, batch, prompt,
                                     max_len, steps,
                                     [logits0] + runs["captured"][0]))
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    stats["weight_bytes"] = weight_bytes
    stats["weight_read_floor_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
    stats["prefill_launches"] = {k: v for k, v in prefill_launches.items()
                                 if v}
    stats["attention_layers"] = n_attn
    stats["cross_attention_layers"] = n_cross
    stats["encoder_layers"] = n_enc
    for name, (_, _, timing, _) in runs.items():
        stats[name] = timing
    print(f"{label}_stats " + json.dumps(stats), flush=True)
    checks = [("prefill", prefill_launches, want_b10)]
    checks += [(name, run[3], want_b11) for name, run in runs.items()]
    for name, got, want in checks:
        for k, n in want.items():
            if got[k] != n:
                fail(f"{label}: {name} launched {k} {got[k]} times, not {n}")
    cap_prof = runs["captured"][2].get("profile")
    if cap_prof is not None:
        # a trace of graph replays may drop some records of every kernel
        # of the step alike (seen on one H100, under one replay's worth):
        # it must hold what the step counted, less fewer than one replay's
        # launches
        traced = cap_prof["kernel_counts"]["kvdq_partial_kernel"]
        counted = want_b11["kv_dequant_decode_attention"]
        if not (counted - n_attn - n_cross < traced <= counted
                or traced == counted == 0):
            fail(f"{label}: the captured run's trace holds {traced} "
                 f"kvdq_partial_kernel launches, the step counted {counted}")
    if not compressed:
        print(f"{label}_cache raw: an encoder-decoder decodes on raw "
              f"caches, as repro does; {stats['raw_cache_bytes']} B",
              flush=True)
    elif stats["cache_ratio"] is None:
        print(f"{label}_cache no attention layer: no KV cache to compress; "
              f"recurrent states {stats['state_bytes']} B stay raw",
              flush=True)
    elif stats["cache_ratio"] < KV_RATIO_MIN:
        fail(f"{label}: compressed cache only {stats['cache_ratio']:.3f}x "
             f"smaller than bf16 (want >= {KV_RATIO_MIN})")
    steps_c, fed = [logits0] + runs["captured"][0], runs["captured"][1]
    equal = None
    if eager_too:
        equal = [bool(torch.equal(a, b)) for a, b in
                 zip(runs["eager"][0], runs["captured"][0])]
        del runs["eager"]

    # the same inputs on the plain versions, patched in where the model
    # modules call the kernels, teacher-forced on the captured run's tokens
    with mock.patch.object(attn_mod, "flash_attention_gqa",
                           _plain_flash_by_row), \
            mock.patch.object(kv_mod, "kv_dequant_decode_attention_gqa",
                              ref.kv_dequant_decode_attention_gqa_ref):
        reset_counts()
        with (_routing(routes["plain"]) if moe
              else contextlib.nullcontext()):
            p0, pcache, ptiming = _prefill(cfg, params, batch, max_len,
                                           compressed)
        with (_routing(routes["plain_steps"]) if moe
              else contextlib.nullcontext()):
            plain, _, pdec, _ = _decode(cfg, params, pcache, None, prompt,
                                        steps, False, compressed,
                                        forced=fed)
        plain_launches = read_counts()
        del pcache
    if any(plain_launches.values()):
        fail(f"{label}: the plain run launched kernels: {plain_launches}")
    errs = _rel_errs(steps_c, [p0] + plain)
    rows = _row_errs(steps_c, [p0] + plain)
    parted = (_parted_rows(routes, SERVE_BATCH, steps) if moe
              else [torch.zeros(SERVE_BATCH, dtype=torch.bool)] * len(rows))
    held = max(_masked_max(r, ~p) for r, p in zip(rows, parted))
    finite = all(bool(torch.isfinite(a).all()) for a in steps_c)
    res = {"max_rel_err": max(errs), "prefill_rel_err": errs[0],
           "decode_rel_err_max": max(errs[1:]), "bound": SERVE_LOGIT_RTOL,
           "eager_equals_captured": equal, "finite": finite,
           "logits_shape": list(steps_c[0].shape),
           "tokens": fed[0, :8].tolist(),
           "plain_prefill_s": ptiming["prefill_s"],
           "plain_decode_ms_per_step": pdec["decode_ms_per_step"]}
    if moe:
        differ = [(a != b).any(-1) for a, b in zip(
            routes["kernels"] + routes["kernels_steps"],
            routes["plain"] + routes["plain_steps"])]
        res["routing_sets"] = sum(d.numel() for d in differ)
        res["routing_differ"] = sum(int(d.sum()) for d in differ)
        res["routing_differ_share"] = res["routing_differ"] / max(
            res["routing_sets"], 1)
        res["held_rel_err"] = held
        res["parted_rows"] = [int(p.sum()) for p in parted]
        res["parted_rel_err"] = max(_masked_max(r, p)
                                    for r, p in zip(rows, parted))
        res["parted_bound"] = MOE_PARTED_RTOL
    print(f"{label}_check " + json.dumps(res), flush=True)
    if moe:
        print(f"{label}_rows " + json.dumps({
            "rel_err": [[round(float(x), 6) for x in r] for r in rows],
            "parted": [p.int().tolist() for p in parted]}), flush=True)
    print(f"{label}_memory " + json.dumps({
        "allocated_at_start": at_start,
        "peak_allocated": torch.cuda.max_memory_allocated(),
        "weight_bytes": weight_bytes}), flush=True)
    if not finite or list(steps_c[0].shape) != [SERVE_BATCH, cfg.vocab]:
        fail(f"{label}: logits are not finite or not (batch, vocab)")
    if equal is not None and not all(equal):
        fail(f"{label}: the captured step's logits differ from the eager "
             f"step's at steps {[i for i, e in enumerate(equal) if not e]}")
    if not held <= SERVE_LOGIT_RTOL:
        fail(f"{label}: kernel and plain runs differ by {held:.3e} of "
             f"max|logits| (bound {SERVE_LOGIT_RTOL})")
    if moe and not res["parted_rel_err"] <= MOE_PARTED_RTOL:
        fail(f"{label}: where the routing parted, kernel and plain runs "
             f"differ by {res['parted_rel_err']:.3e} of max|logits| (bound "
             f"{MOE_PARTED_RTOL})")
    launches = dict(runs["captured"][3])
    launches["flash_attention"] += prefill_launches["flash_attention"]
    del params, runs, batch
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# -- phases 22-24: training ---------------------------------------------------

def _train_batch(cfg, step: int, seed: int, batch: int = TRAIN_BATCH,
                 seq: int = TRAIN_SEQ) -> dict:
    """Step ``step``'s tokens of SyntheticTokens(seed) on cuda:0."""
    import torch
    from repro_torch.train.data import SyntheticTokens
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                          seed=seed)
    return {"tokens": torch.from_numpy(src.batch(step)).to(
        device="cuda:0", dtype=torch.int64)}


def _grad_compare(got: dict, want: dict) -> list[dict]:
    """Per gradient leaf (checkpoint keys): cosine of the two, max|Δ| over
    max|want|, and whether ``got`` is nonzero; in f32, a slice at a
    time."""
    import torch
    from repro_torch.optim.adamw import slices
    out = []
    for key, g in got.items():
        dot = na = nb = torch.zeros((), dtype=torch.float64, device=g.device)
        dmax = gmax = torch.zeros((), dtype=torch.float32, device=g.device)
        for a, b in slices(g, want[key]):
            a, b = a.float(), b.float()
            dot = dot + (a * b).sum(dtype=torch.float64)
            na = na + (a * a).sum(dtype=torch.float64)
            nb = nb + (b * b).sum(dtype=torch.float64)
            dmax = torch.maximum(dmax, (a - b).abs().max())
            gmax = torch.maximum(gmax, b.abs().max())
        cos = float(dot / (na.sqrt() * nb.sqrt()).clamp_min(1e-300))
        out.append({"leaf": key, "cosine": cos,
                    "max_rel_err": float(dmax / gmax.clamp_min(1e-30)),
                    "nonzero": bool(na > 0),
                    "finite": bool(torch.isfinite(na))})
    return out


class _Timed:
    """CUDA events around each call of ``fn``: ``ms()`` sums their
    device-timeline spans (read after a synchronize)."""

    def __init__(self, fn):
        self.fn, self.events = fn, []

    def __call__(self, *args, **kw):
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


class _TimedOptimizer:
    """An optimizer whose update is timed by :class:`_Timed`."""

    def __init__(self, opt):
        self.opt, self.update = opt, _Timed(opt.update)

    def init(self, params):
        return self.opt.init(params)


def _train_profile(prof, wall_s: float, bwd: _Timed,
                   opt: _TimedOptimizer) -> dict:
    """A traced train step's device time by kernel (the library GEMMs, B10,
    the rest; the idle share of its wall time), and the device spans of
    the attention backward's calls and of the optimizer update (CUDA
    events around them)."""
    out = device_profile(prof, wall_s)
    gemm = b10 = 0.0
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if "flash_bf16_kernel" in e.key or "flash_f32_kernel" in e.key:
            b10 += ms
        elif any(w in e.key.lower() for w in LIBRARY_GEMM):
            gemm += ms
    out.update(gemm_ms=gemm, flash_attention_ms=b10,
               attention_backward_ms=bwd.ms(),
               attention_backward_calls=len(bwd.events),
               optimizer_ms=opt.update.ms())
    del out["library_gemm"]
    return out


def train_phase(seed: int, profile: bool) -> dict:
    """qwen3-4b whole (36 layers, full width, 4.02 B bf16 weights from
    ``seed``) trained on cuda:0: step 0's loss and gradients twice,
    through B10 (exactly 2 launches a layer: the forward and the remat
    recompute; its backward flash_attention_gqa_bwd) and with its plain
    version patched in (0 launches; autograd through it): loss within
    TRAIN_LOSS_RTOL, each gradient leaf at cosine >= TRAIN_GRAD_COS and
    max|Δ|/max|g| <= TRAIN_GRAD_RTOL, every leaf's gradient nonzero and
    finite;
    then TRAIN_STEPS steps of make_train_step (the config's AdamW, f32
    moments, lr TRAIN_LR, remat on), B 2 x S 2,048 tokens of
    SyntheticTokens(seed) a step, each step's loss finite and 72 B10
    launches.  Prints each step's loss, grad_norm and wall time, tokens/s
    and peak memory (with ``profile`` the last step's device time by
    part: the kernels by name, and CUDA-event times of the attention
    backward's calls and of the optimizer update; that step is left out
    of the steady-state mean and tokens/s).  Returns the launches of the
    steps and the printed stats."""
    from unittest import mock

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn_mod
    from repro_torch.optim import make_optimizer
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.step import (init_train_state, make_loss_fn,
                                        make_train_step, value_and_grad)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, weight_bytes = _init_model("train", TRAIN_ARCH, seed)
    if not cfg.remat:
        fail("train: qwen3-4b's config has remat off")
    n_attn = cfg.n_layers
    loss_fn = make_loss_fn(cfg)
    batch0 = _train_batch(cfg, 0, seed)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_k, grads_k = value_and_grad(loss_fn, params, batch0)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    kernel_launches = read_counts()["flash_attention"]
    with mock.patch.object(attn_mod, "flash_attention_gqa",
                           _plain_flash_by_row):
        reset_counts()
        t0 = time.perf_counter()
        loss_p, grads_p = value_and_grad(loss_fn, params, batch0)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        plain_launches = read_counts()["flash_attention"]
    leaves = _grad_compare(flatten(grads_k), flatten(grads_p))
    del grads_k, grads_p
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check = {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
             "loss_rel_err": loss_rel, "loss_bound": TRAIN_LOSS_RTOL,
             "min_cosine": min(c["cosine"] for c in leaves),
             "cosine_bound": TRAIN_GRAD_COS,
             "max_grad_rel_err": max(c["max_rel_err"] for c in leaves),
             "grad_rel_bound": TRAIN_GRAD_RTOL,
             "kernel_launches": kernel_launches,
             "plain_launches": plain_launches,
             "kernel_s": t_kernel, "plain_s": t_plain}
    print("train_step0_check " + json.dumps(check), flush=True)
    for c in leaves:
        print("train_grad_leaf " + json.dumps(c), flush=True)
    if kernel_launches != 2 * n_attn or plain_launches:
        fail(f"train: step 0 launched flash_attention {kernel_launches} "
             f"times through the kernel (want {2 * n_attn}: forward and "
             f"recompute) and {plain_launches} on the plain version")
    bad = [c["leaf"] for c in leaves if not (c["nonzero"] and c["finite"])]
    if bad:
        fail(f"train: gradients zero or not finite at step 0: {bad}")
    if not loss_rel <= TRAIN_LOSS_RTOL:
        fail(f"train: kernel and plain losses {loss_rel:.3e} apart "
             f"(bound {TRAIN_LOSS_RTOL})")
    low = [c["leaf"] for c in leaves if not c["cosine"] >= TRAIN_GRAD_COS]
    if low:
        fail(f"train: gradient leaves below cosine {TRAIN_GRAD_COS} against "
             f"the plain run: {low}")
    far = [c["leaf"] for c in leaves
           if not c["max_rel_err"] <= TRAIN_GRAD_RTOL]
    if far:
        fail(f"train: gradient leaves past max|dg|/max|g| {TRAIN_GRAD_RTOL} "
             f"against the plain run: {far}")

    opt = make_optimizer(cfg.optimizer, TRAIN_LR,
                         moment_dtype=cfg.opt_state_dtype)
    state = init_train_state(cfg, params, opt)
    step_fn = make_train_step(cfg, opt)
    steps, launches = [], {"flash_attention": 0}
    for i in range(TRAIN_STEPS):
        batch = _train_batch(cfg, i, seed)
        traced = profile and i == TRAIN_STEPS - 1
        if traced:     # the same step, its backward and update timed
            timed_opt = _TimedOptimizer(opt)
            step_fn = make_train_step(cfg, timed_opt)
            bwd = _Timed(fa.flash_attention_gqa_bwd)
        reset_counts()
        with _trace(traced) as prof, \
                (mock.patch.object(fa, "flash_attention_gqa_bwd", bwd)
                 if traced else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n = read_counts()["flash_attention"]
        launches["flash_attention"] += n
        row = {"step": i, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "wall_s": wall,
               "flash_attention_launches": n, "traced": traced}
        if traced:
            row["profile"] = _train_profile(prof, wall, bwd, timed_opt)
        print("train_step " + json.dumps(row), flush=True)
        steps.append(row)
        if not (math.isfinite(row["loss"])
                and math.isfinite(row["grad_norm"])):
            fail(f"train: step {i} loss or grad_norm not finite: {row}")
        if n != 2 * n_attn:
            fail(f"train: step {i} launched flash_attention {n} times, "
                 f"not {2 * n_attn}")
    steady = [s["wall_s"] for s in steps[1:] if not s["traced"]]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    stats = {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "steps": TRAIN_STEPS, "lr": TRAIN_LR, "remat": cfg.remat,
             "optimizer": type(opt).__name__,
             "moment_dtype": opt.moment_dtype,
             "step0_s": steps[0]["wall_s"],
             "step_s_mean_after_first": sum(steady) / len(steady),
             "tokens_per_s": tokens * len(steady) / sum(steady),
             "weight_bytes": weight_bytes,
             "peak_allocated": torch.cuda.max_memory_allocated(),
             "losses": [s["loss"] for s in steps]}
    print("train_stats " + json.dumps(stats), flush=True)
    del params, state, step_fn
    torch.cuda.empty_cache()
    return launches, stats


def train_gc_phase(seed: int) -> dict:
    """qwen3-4b at full width cut to TRAIN_GC_LAYERS layers (a printed
    cut) trained TRAIN_STEPS steps with GradCompressor(TRAIN_GC_BR) and
    AdamW: 2 B10 launches a layer a step, the losses and every residual
    finite; then one more step's gradients: none cut (every leaf nonzero),
    and one leaf's round trip from its residual within 1.01 b_r of its
    input wherever its code is nonzero.  Returns the steps' launches."""
    import torch
    from repro_torch.optim import GradCompressor, make_optimizer
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.step import (init_train_state, make_loss_fn,
                                        make_train_step, value_and_grad)

    torch.cuda.empty_cache()
    cfg, params, _ = _init_model("train_gc", TRAIN_ARCH, seed,
                                 layers=TRAIN_GC_LAYERS)
    gc = GradCompressor(TRAIN_GC_BR)
    opt = make_optimizer(cfg.optimizer, TRAIN_LR,
                         moment_dtype=cfg.opt_state_dtype)
    state = init_train_state(cfg, params, opt, gc)
    step_fn = make_train_step(cfg, opt, gc)
    launches, losses = {"flash_attention": 0}, []
    for i in range(TRAIN_STEPS):
        reset_counts()
        params, state, metrics = step_fn(params, state,
                                         _train_batch(cfg, i, seed))
        n = read_counts()["flash_attention"]
        launches["flash_attention"] += n
        losses.append(float(metrics["loss"]))
        if n != 2 * cfg.n_layers:
            fail(f"train_gc: step {i} launched flash_attention {n} times, "
                 f"not {2 * cfg.n_layers}")
    err = flatten(state["gc_err"])
    finite = all(bool(torch.isfinite(e).all()) for e in err.values())
    _, grads = value_and_grad(make_loss_fn(cfg), params,
                              _train_batch(cfg, TRAIN_STEPS, seed))
    grads = flatten(grads)
    cut = [k for k, g in grads.items() if not bool(g.any())]
    # the f32 dequantized value is g32 - the new residual (what the
    # gradient's dtype then rounds is bf16's, as in repro)
    key = "units/0/attn/wq"
    g32 = grads[key].float() + err[key]
    q, e = gc.roundtrip({"w": grads[key].clone()},
                        {"w": err[key].clone()})
    live = q["w"] != 0
    rel = float((e["w"].abs() / g32.abs())[live].max())
    res = {"losses": losses, "residuals_finite": finite,
           "cut_leaves": cut, "leaf": key, "max_rel_err": rel,
           "bound": 1.01 * TRAIN_GC_BR, "nonzero_codes": int(live.sum()),
           "elements": live.numel(), "bytes_ratio": gc.bytes_ratio}
    print("train_gc_check " + json.dumps(res), flush=True)
    if not (finite and all(math.isfinite(x) for x in losses)):
        fail("train_gc: a loss or a residual is not finite")
    if cut:
        fail(f"train_gc: gradients cut (all zero): {cut}")
    if not rel <= 1.01 * TRAIN_GC_BR:
        fail(f"train_gc: the round trip of {key} is {rel:.3e} from its "
             f"input (bound {1.01 * TRAIN_GC_BR})")
    del params, state, grads
    torch.cuda.empty_cache()
    return launches


def train_runtime_phase() -> dict:
    """Reduced qwen3-4b on cuda:0 through TrainRuntime, checkpointing every
    step into a temporary directory: a run with fail_at_step 2 (restarted
    from its last checkpoint) against an uninterrupted run from the same
    initial state, parameters and optimizer state bit for bit; then
    ``python -m repro_torch.launch.train --arch qwen3-4b --steps 3`` as a
    subprocess, its [train] line printed.  Returns the two runs'
    launches."""
    import tempfile

    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.data import SyntheticTokens
    from repro_torch.train.runtime import RuntimeConfig, TrainRuntime
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = reduced_config(get_config(TRAIN_ARCH))
    dev = torch.device("cuda", 0)
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=64, global_batch=4)
    runs = {}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for label, fail_at in (("restarted", RUNTIME_FAIL_AT),
                               ("uninterrupted", None)):
            params = T.init_params(cfg, 0, dtype=torch.float32, device=dev)
            opt = AdamW(lr=3e-3)
            state = init_train_state(cfg, params, opt)
            rt = TrainRuntime(
                cfg=RuntimeConfig(ckpt_dir=os.path.join(tmp, label),
                                  ckpt_every=1, fail_at_step=fail_at),
                train_step=make_train_step(cfg, opt), data_source=src,
                device=dev)
            runs[label] = rt.run(params, state, n_steps=RUNTIME_STEPS)
        launches = read_counts()
        a, b = (flatten(runs[k][:2]) for k in ("restarted",
                                               "uninterrupted"))
        differ = [k for k in b if not torch.equal(a[k], b[k])]
        hist = runs["restarted"][2]
        res = {"steps": RUNTIME_STEPS, "fail_at_step": RUNTIME_FAIL_AT,
               "restarts": max(m["restarts"] for m in hist),
               "leaves": len(b), "differ": differ,
               "losses": [m["loss"] for m in hist],
               "flash_attention_launches": launches["flash_attention"]}
        print("train_runtime_check " + json.dumps(res), flush=True)
        if res["restarts"] != 1 or differ:
            fail(f"train_runtime: the restarted run ({res['restarts']} "
                 f"restarts) differs from the uninterrupted one at {differ}")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             TRAIN_ARCH, "--steps", "3", "--ckpt-dir",
             os.path.join(tmp, "launch")],
            cwd=HERE, env=_src_env(), capture_output=True, text=True,
            timeout=600)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(f"[train] {TRAIN_ARCH} mesh=1x1: loss ")]
    print("train_cli_check " + json.dumps({
        "rc": out.returncode, "wall_s": time.perf_counter() - t0,
        "lines": out.stdout.splitlines()[-4:]}), flush=True)
    if out.returncode != 0 or not lines:
        fail(f"launch.train exited {out.returncode} without its [train] "
             f"line: {out.stderr.strip()[-2000:]}")
    return launches


# -- phase 27: the train step sharded over a host mesh (ROADMAP A12h) ---------

def _sharded_steps(step_fn, params, state, batches: list) -> tuple:
    """``step_fn`` over ``batches``, each step timed (host clock between
    two synchronizes), with the kernel and collective counts set to 0 just
    before it and read just after (the collectives' bytes by kind and
    their host seconds); returns (params, state, rows)."""
    import torch
    from repro_torch.distributed import collectives as C
    rows = []
    for i, batch in enumerate(batches):
        reset_counts()
        C.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        rows.append({"step": i, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "wall_s": time.perf_counter() - t0,
                     "flash_attention_launches":
                         read_counts()["flash_attention"],
                     "collective_bytes": C.read_counts(),
                     "collective_s": C.read_seconds()["total"]})
    return params, state, rows


def _sharded_rank(view, seed: int, ref_path: str) -> dict:
    """One rank of train_sharded's 2x2 mesh (a spawned process on cuda:0):
    the cut model from ``seed``, its blocks, SHARDED_STEPS steps on its
    rows of each batch; the collective bytes the dry run predicts for a
    rank (plus the terms it leaves out); each leaf gathered whole after
    the steps, which rank 0 holds against the one-device run's (read from
    ``ref_path``) and against its initial value."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.models import transformer as T
    from repro_torch.optim import make_optimizer
    from repro_torch.train.checkpoint import flatten, flatten_specs
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        sharded_extra_bytes)
    dev = view.device
    cfg = get_config(TRAIN_ARCH).with_(n_layers=TRAIN_GC_LAYERS)
    full = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    specs = SH.param_pspecs(cfg, full, view)
    params = SH.shard_tree(full, specs, view)
    init = flatten(full) if view.rank == 0 else None
    del full
    opt = make_optimizer(cfg.optimizer, TRAIN_LR,
                         moment_dtype=cfg.opt_state_dtype)
    state = init_train_state(cfg, params, opt)
    dp = view.shape["data"]
    b = TRAIN_BATCH // dp
    first = view.index("data") * b
    batches = [{"tokens": _train_batch(cfg, i, seed)["tokens"][
        first:first + b]} for i in range(SHARDED_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    params, state, rows = _sharded_steps(
        make_train_step(cfg, opt, mesh=view), params, state, batches)
    peak = torch.cuda.max_memory_allocated()
    meta = D.abstract_params(cfg)
    mspecs = SH.param_pspecs(cfg, meta, view)
    want = D.collective_bytes(cfg, "train", TRAIN_BATCH, TRAIN_SEQ, meta,
                              mspecs, view)
    extra = sharded_extra_bytes(cfg, TRAIN_BATCH, TRAIN_SEQ, meta, mspecs,
                                view)
    for k in ("all-gather", "reduce-scatter", "all-reduce"):
        want[k] += extra[k]
    want["total"] = sum(want[k] for k in ("all-gather", "reduce-scatter",
                                          "all-reduce"))
    out = {"rank": view.rank, "coords": list(view.coords), "steps": rows,
           "expected_bytes": want, "extra_terms": extra["terms"],
           "peak_allocated": peak}
    leaf_specs = flatten_specs(params, specs)
    ref = (torch.load(ref_path, map_location="cpu", weights_only=True)
           if view.rank == 0 else None)
    leaves = []
    for key, block in flatten(params).items():
        whole = SH.gather_leaf(block, leaf_specs[key], view)
        if view.rank == 0:
            r = ref[key].to(dev).float()
            w = whole.float()
            d0 = r - init[key].float()
            leaves.append({
                "leaf": key, "dtype": str(block.dtype),
                "max_abs_diff": float((w - r).abs().max()),
                "bound": SHARDED_STEPS * (2 * TRAIN_LR + 2.0 ** -7
                                          * float(r.abs().max())),
                "update_cosine": float(
                    ((w - init[key].float()) * d0).sum()
                    / ((w - init[key].float()).norm() * d0.norm())
                    .clamp_min(1e-30)),
                "moved": not torch.equal(whole, init[key]),
                "finite": bool(torch.isfinite(w).all())})
        del whole
    out["leaves"] = leaves
    return out


def train_sharded_phase(seed: int, train_stats: dict, tmp: str) -> dict:
    """The train step sharded FSDP x TP by hand (ROADMAP A12h).  First
    qwen3-4b whole at the train phase's shape, seed, optimizer and steps
    through make_train_step(..., mesh=...) on a 1x1 mesh over NCCL (a
    world of one rank): 2 B10 launches a layer a step, each loss within
    SHARDED_1X1_LOSS_RTOL of the train phase's, grad_norm finite; its
    step time and peak memory printed beside the train phase's.  Then a
    2x2 mesh as four spawned processes of cuda:0 over gloo (NCCL refuses
    two ranks on one card): qwen3-4b at full width cut to TRAIN_GC_LAYERS
    layers, each rank at its local head counts (16 of 32 query and 4 of 8
    kv heads) and its rows of the global batch, SHARDED_STEPS steps,
    against the one-device run of the same cut model and data: each
    step's loss (the same on every rank) within SHARDED_LOSS_RTOL, every
    leaf gathered after the steps moved, within SHARDED_STEPS x (2 lr +
    2^-7 max|w|) and its updates at cosine >= SHARDED_UPDATE_COS,
    2 B10 launches a layer a step on every rank, and every rank's
    collective bytes by kind equal to launch/dryrun.py::collective_bytes
    for the mesh and shape plus train.step.sharded_extra_bytes' terms.
    The ranks' step times, and the host seconds of their collectives, are
    of four processes sharing one card through host copies: no
    interconnect is measured.  Returns the launches of
    both meshes' steps."""
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import make_optimizer
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.step import init_train_state, make_train_step

    dev = torch.device("cuda", 0)
    launches = {"flash_attention": 0}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, _ = _init_model("train_sharded", TRAIN_ARCH, seed)
    n_attn = cfg.n_layers
    batches = [_train_batch(cfg, i, seed) for i in range(TRAIN_STEPS)]
    view = C.init_rank(make_host_mesh(1, 1, devices=[dev]), 0,
                       os.path.join(tmp, "rendezvous_1x1"))
    try:
        backend = str(torch.distributed.get_backend())
        opt = make_optimizer(cfg.optimizer, TRAIN_LR,
                             moment_dtype=cfg.opt_state_dtype)
        state = init_train_state(cfg, params, opt)
        params, state, rows = _sharded_steps(
            make_train_step(cfg, opt, mesh=view), params, state, batches)
    finally:
        C.destroy()
    del params, state, batches
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    want = train_stats["losses"]
    rel = [abs(r["loss"] - w) / abs(w) for r, w in zip(rows, want)]
    steady = [r["wall_s"] for r in rows[1:]]
    res = {"mesh": "1x1", "backend": backend, "arch": TRAIN_ARCH,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "losses": [r["loss"] for r in rows], "train_losses": want,
           "loss_rel_err": rel, "loss_bound": SHARDED_1X1_LOSS_RTOL,
           "grad_norms": [r["grad_norm"] for r in rows],
           "launches": [r["flash_attention_launches"] for r in rows],
           "step_s": [r["wall_s"] for r in rows],
           "step_s_mean_after_first": sum(steady) / len(steady),
           "train_step_s_mean_after_first":
               train_stats["step_s_mean_after_first"],
           "peak_allocated": peak,
           "train_peak_allocated": train_stats["peak_allocated"],
           "collective_bytes": [r["collective_bytes"]["total"]
                                for r in rows]}
    print("train_sharded_1x1 " + json.dumps(res), flush=True)
    launches["flash_attention"] += sum(res["launches"])
    if backend != "nccl":
        fail(f"train_sharded: the 1x1 mesh on cuda:0 ran over {backend}, "
             f"not nccl")
    if any(n != 2 * n_attn for n in res["launches"]):
        fail(f"train_sharded: 1x1 steps launched flash_attention "
             f"{res['launches']} times, not {2 * n_attn} each")
    if not all(math.isfinite(g) for g in res["grad_norms"]):
        fail(f"train_sharded: a 1x1 grad_norm is not finite: "
             f"{res['grad_norms']}")
    if not max(rel) <= SHARDED_1X1_LOSS_RTOL:
        fail(f"train_sharded: 1x1 losses {max(rel):.3e} from the train "
             f"phase's (bound {SHARDED_1X1_LOSS_RTOL})")

    # the one-device run of the cut model, the 2x2 mesh's oracle
    cfg, params, _ = _init_model("train_sharded_2x2", TRAIN_ARCH, seed,
                                 layers=TRAIN_GC_LAYERS)
    opt = make_optimizer(cfg.optimizer, TRAIN_LR,
                         moment_dtype=cfg.opt_state_dtype)
    state = init_train_state(cfg, params, opt)
    params, state, ref_rows = _sharded_steps(
        make_train_step(cfg, opt), params, state,
        [_train_batch(cfg, i, seed) for i in range(SHARDED_STEPS)])
    ref_path = os.path.join(tmp, "train_sharded_ref.pt")
    torch.save({k: t.cpu() for k, t in flatten(params).items()}, ref_path)
    del params, state
    torch.cuda.empty_cache()
    mesh = make_host_mesh(*SHARDED_MESH,
                          devices=[dev] * math.prod(SHARDED_MESH))
    t0 = time.perf_counter()
    try:
        ranks = C.run_ranks(_sharded_rank, mesh, args=(seed, ref_path),
                            timeout=SHARDED_TIMEOUT_S)
    except Exception as e:  # a rank that fails fails the phase
        fail(f"train_sharded: the 2x2 mesh failed: {e!r}"[:4000])
    wall = time.perf_counter() - t0
    os.remove(ref_path)
    ref_losses = [r["loss"] for r in ref_rows]
    bad = []
    for rk in ranks:
        rk_rel = [abs(r["loss"] - w) / abs(w)
                  for r, w in zip(rk["steps"], ref_losses)]
        got = [{k: r["collective_bytes"][k] for k in rk["expected_bytes"]}
               for r in rk["steps"]]
        line = {"rank": rk["rank"], "coords": rk["coords"],
                "losses": [r["loss"] for r in rk["steps"]],
                "loss_rel_err": rk_rel,
                "grad_norms": [r["grad_norm"] for r in rk["steps"]],
                "launches": [r["flash_attention_launches"]
                             for r in rk["steps"]],
                "collective_bytes": got[0],
                "expected_bytes": rk["expected_bytes"],
                "extra_terms": rk["extra_terms"],
                "step_s": [r["wall_s"] for r in rk["steps"]],
                "collective_s": [r["collective_s"] for r in rk["steps"]],
                "peak_allocated": rk["peak_allocated"],
                "wire": "gloo through host copies, 4 ranks on one card"}
        print("train_sharded_2x2_rank " + json.dumps(line), flush=True)
        launches["flash_attention"] += sum(line["launches"])
        if not max(rk_rel) <= SHARDED_LOSS_RTOL:
            bad.append(f"rank {rk['rank']} losses {max(rk_rel):.3e} from "
                       f"the one-device run's (bound {SHARDED_LOSS_RTOL})")
        if any(n != 2 * cfg.n_layers for n in line["launches"]):
            bad.append(f"rank {rk['rank']} launched flash_attention "
                       f"{line['launches']} times, not {2 * cfg.n_layers} "
                       f"a step")
        if any(g != rk["expected_bytes"] for g in got):
            bad.append(f"rank {rk['rank']} moved {got} collective bytes, "
                       f"not {rk['expected_bytes']}")
        if not all(math.isfinite(g) for g in line["grad_norms"]):
            bad.append(f"rank {rk['rank']} grad_norm not finite")
    leaves = ranks[0]["leaves"]
    far = [c["leaf"] for c in leaves
           if not c["max_abs_diff"] <= c["bound"]]
    turned = [c["leaf"] for c in leaves
              if not c["update_cosine"] >= SHARDED_UPDATE_COS]
    still = [c["leaf"] for c in leaves if not (c["moved"] and c["finite"])]
    worst = max(leaves, key=lambda c: c["max_abs_diff"] / c["bound"])
    check = {"mesh": "2x2", "arch": TRAIN_ARCH, "layers": cfg.n_layers,
             "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": SHARDED_STEPS,
             "lr": TRAIN_LR, "one_device_losses": ref_losses,
             "one_device_step_s": [r["wall_s"] for r in ref_rows],
             "leaves": len(leaves), "worst_leaf": worst,
             "min_update_cosine": min(c["update_cosine"] for c in leaves),
             "cosine_bound": SHARDED_UPDATE_COS, "not_moved": still,
             "past_bound": far, "below_cosine": turned,
             "mesh_wall_s": wall}
    print("train_sharded_2x2_check " + json.dumps(check), flush=True)
    if far:
        bad.append(f"leaves past {SHARDED_STEPS} x (2 lr + 2^-7 max|w|) "
                   f"from the one-device run: {far}")
    if turned:
        bad.append(f"leaves whose updates are below cosine "
                   f"{SHARDED_UPDATE_COS} with the one-device run's: "
                   f"{turned}")
    if still:
        bad.append(f"leaves that did not move or are not finite: {still}")
    if bad:
        fail("train_sharded: " + "; ".join(bad))
    return launches


# -- the dry run (ROADMAP A12g): every cell on the host ------------------------

DRYRUN_CELLS = 40                # 10 architectures x 4 shapes
DRYRUN_WAIT_S = 600              # the most the phase waits for it


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def dryrun_start(tmp: str) -> tuple:
    """Start ``python -m repro_torch.launch.dryrun --all`` in the
    background, with no card visible to it (CUDA_VISIBLE_DEVICES empty: it
    works on meta tensors and touches no device) and one thread; it runs
    beside the kernel phases and :func:`dryrun_phase` joins it.  It is
    stopped at exit if still running."""
    out = os.path.join(tmp, "dryrun.json")
    env = _src_env(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log = open(os.path.join(tmp, "dryrun.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", out], env=env, stdout=log, stderr=subprocess.STDOUT,
        cwd=HERE)
    atexit.register(_stop, proc)
    return proc, out, log, time.perf_counter()


def dryrun_phase(handle: tuple) -> dict:
    """Join the dry run: exit 0, all 40 cells, no applicable cell raised;
    one ``dryrun_cell`` line a cell with its applicability (or skip
    reason), each device's argument and output bytes, model_flops, the
    port's counted_flops and roofline terms (H100 data-sheet rates).
    Returns the summary."""
    proc, out, log, t0 = handle
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_WAIT_S -
                                   (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        _stop(proc)
        fail(f"the dry run did not end within {DRYRUN_WAIT_S} s")
    log.close()
    with open(log.name) as f:
        text = f.read()
    if rc != 0 or not os.path.exists(out):
        fail(f"the dry run exited {rc}: {text[-3000:]}")
    with open(out) as f:
        recs = json.load(f)
    errors = [r for r in recs if "error" in r]
    for r in recs:
        line = {"arch": r["arch"], "shape": r["shape"],
                "applicable": "skipped" not in r and "error" not in r}
        if "skipped" in r:
            line["skipped"] = r["skipped"]
        elif "error" in r:
            line["error"] = r["error"]
        else:
            port = r["port"]
            line.update(step_kind=r["step_kind"], mesh=r["mesh"],
                        bytes_per_device=r["bytes_per_device"],
                        model_flops=r["model_flops"],
                        counted_flops=port["counted_flops"],
                        compute_s=port["compute_s"],
                        memory_s=port["memory_s"],
                        collective_s=port["collective_s"],
                        bottleneck=port["bottleneck"])
        print("dryrun_cell " + json.dumps(line), flush=True)
    applicable = [r for r in recs if "port" in r]
    res = {"cells": len(recs), "applicable": len(applicable),
           "skipped": sum("skipped" in r for r in recs),
           "errors": len(errors), "wall_s": time.perf_counter() - t0}
    print("dryrun_check " + json.dumps(res), flush=True)
    if errors:
        fail("dry run cells raised: "
             f"{[(r['arch'], r['shape']) for r in errors]}")
    if len(recs) != DRYRUN_CELLS:
        fail(f"the dry run gave {len(recs)} cells, not {DRYRUN_CELLS}")
    if not all(r["port"]["counted_flops"] and r["port"]["counted_flops"] > 0
               for r in applicable):
        fail("a dry-run cell counted no FLOPs")
    return res


# -- phase 14: the report -----------------------------------------------------

GATE_CU = "src/repro_torch/csrc/gate_apply.cu"
PACK_CU = "src/repro_torch/csrc/pack.cu"
#: kernel -> (source, the TPU kernel's pl.pallas_call, the path whose
#: launches are reported, the timed case's selector)
KERNELS = {
    "gemm_planes_batch": (GATE_CU, "src/repro/kernels/gate_apply.py:112",
                          "main_device", {"K": 32}),
    "encode": ("src/repro_torch/csrc/codec.cu",
               "src/repro/kernels/quantize.py:75, "
               "src/repro/kernels/pack.py:61", "main_device", None),
    "decode": ("src/repro_torch/csrc/codec.cu",
               "src/repro/kernels/pack.py:85, "
               "src/repro/kernels/quantize.py:123", "main_device", None),
    "gemm_planes": (GATE_CU, "src/repro/kernels/gate_apply.py:69",
                    "main_pergate", {"K": 32}),
    "gemm_planes_mid": (GATE_CU, "src/repro/kernels/gate_apply.py:153",
                        "single_group", {"K": 32}),
    # the lane-batched form of B7 has no Pallas kernel: repro runs the
    # wave path's MidGemmOp as this XLA einsum
    "gemm_planes_mid_batch": (GATE_CU, "src/repro/core/schedule.py:365",
                              "main_batch", {"K": 32}),
    "diag_apply": (GATE_CU, "src/repro/kernels/gate_apply.py:186",
                   "main_pergate", {"K": 32}),
    "pack_codes_tiles": (PACK_CU, "src/repro/kernels/pack.py:61", "ops",
                         {}),
    "unpack_codes_tiles": (PACK_CU, "src/repro/kernels/pack.py:85", "ops",
                           {}),
    "pack_bitmap_tiles": (PACK_CU, "src/repro/kernels/pack.py:109", "ops",
                          {"dtype": "int32"}),
    "unpack_bitmap_tiles": (PACK_CU, "src/repro/kernels/pack.py:132", "ops",
                            {}),
    # their launches: every serve phase's (the prefills and the captured
    # steps) and every train phase's (forward and remat recompute), summed
    "flash_attention": ("src/repro_torch/csrc/attention.cu",
                        "src/repro/kernels/flash_attention.py:90", "models",
                        {"dtype": "bfloat16"}),
    "kv_dequant_decode_attention": (
        "src/repro_torch/csrc/attention.cu",
        "src/repro/kernels/kv_dequant_attention.py:98", "models",
        {"q_dtype": "bfloat16"}),
}


def kernel_report(checks: dict, launches: dict) -> list[dict]:
    """One entry per kernel of the port: its timed main-shape case, its
    worst error over every case, and its launches on the path that runs
    it (the codec kernels: their fused wave case) plus the examples'."""
    out = []
    for name, (source, replaces, path, sel) in KERNELS.items():
        if name in ("encode", "decode"):
            t = checks["codec"][0][name]
            err = (max(c["max_code_diff"] for c in checks["codec"])
                   if name == "encode" else
                   max(c["decode_max_abs"] for c in checks["codec"]))
            t = {**t, "library_ms": None}
        else:
            cases = checks[name]
            t = next(c for c in cases if "ms" in c
                     and all(c.get(k) == v for k, v in sel.items()))
            # bf16-output cases are held to one bf16 rounding instead
            err = max(c["max_abs_err"] for c in cases if not c.get("rtol"))
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[path][name]
            + launches["examples"].get(name, 0),
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the main paths' device time")
    ap.add_argument("--device-qubits", type=int, default=DEVICE_QUBITS,
                    help="qubits of the device-codec path (default 28)")
    ap.add_argument("--device-skip-gates", type=int,
                    default=DEVICE_SKIP_GATES,
                    help="first QFT gates the device-codec path leaves out "
                         f"(default {DEVICE_SKIP_GATES}; 0 runs it whole)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serve phase's weights and prompts")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import torch
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    try:
        log = build.build_all()
    except RuntimeError as e:
        fail(str(e))
    print(f"build_s {time.perf_counter() - t0:.3f}", flush=True)
    for name, (secs, text) in log.items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build {name} {secs:.3f}s " + " | ".join(regs[:14]),
              flush=True)
    tensor_core_check(build, log)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    dry = dryrun_start(tmp)

    t_phase = time.perf_counter()

    def timed(name: str, result=None):
        """Print the seconds since the last phase ended (the phase
        ``name``'s) and pass ``result`` through."""
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase_s {name} {now - t_phase:.3f}", flush=True)
        t_phase = now
        return result

    checks = timed("kernels", kernel_phase())
    checks.update(timed("codec", codec_phase()))
    checks.update(timed("gate", gate_phase()))
    checks.update(timed("pack", pack_phase()))
    checks.update(timed("attention", attention_phase()))
    launches = {"ops": timed("ops", ops_phase()),
                "single_group": timed("single_group", single_group_phase())}
    launches["main"] = timed("main", main_phase("main", MAIN_QUBITS, "host",
                                                args.profile))
    timed("dryrun", dryrun_phase(dry))
    launches["main_device"] = timed("main_device", main_phase(
        "main_device", args.device_qubits, "device", args.profile,
        skip_gates=args.device_skip_gates))
    launches["main_pergate"] = timed("main_pergate", main_phase(
        "main_pergate", MAIN_QUBITS, "device", args.profile,
        gate_schedule=False))
    launches["main_batch"] = timed("main_batch", batch_phase(args.profile))
    launches["service"] = timed("service", service_phase())
    timed("precision", precision_phase())
    timed("resilience", resilience_phase())
    launches["multidevice"] = timed("multidevice", multidevice_phase())
    timed("cli", cli_phase())
    timed("tooling", tooling_phase(tmp))
    launches["examples"] = timed("examples", examples_phase())
    launches["serve_seqattn"] = {}
    launches["serve"] = timed("serve", serve_phase(
        "serve", SERVE_ARCH, SERVE_STEPS, args.seed, args.profile,
        eager_too=True, seqattn=launches["serve_seqattn"]))
    launches["serve_gemma3"] = timed("serve_gemma3", serve_phase(
        "serve_gemma3", GEMMA_ARCH, GEMMA_STEPS, args.seed, args.profile,
        eager_too=False))
    for label, arch, layers in HYBRID_PHASES:
        launches[label] = timed(label, serve_phase(
            label, arch, HYBRID_STEPS, args.seed, args.profile,
            eager_too=True, layers=layers))
    launches["serve_llama_vision"] = timed("serve_llama_vision", serve_phase(
        "serve_llama_vision", VISION_ARCH, VISION_STEPS, args.seed,
        args.profile, eager_too=True, layers=VISION_LAYERS))
    launches["serve_whisper"] = timed("serve_whisper", serve_phase(
        "serve_whisper", WHISPER_ARCH, WHISPER_STEPS, args.seed,
        args.profile, eager_too=True))
    launches["train"], train_stats = timed(
        "train", train_phase(args.seed, args.profile))
    launches["train_gc"] = timed("train_gc", train_gc_phase(args.seed))
    launches["train_runtime"] = timed("train_runtime",
                                      train_runtime_phase())
    launches["train_sharded"] = timed("train_sharded", train_sharded_phase(
        args.seed, train_stats, tmp))
    launches["models"] = {
        k: sum(launches[p].get(k, 0) for p in launches
               if p.startswith(("serve", "train")))
        for k in ("flash_attention", "kv_dequant_decode_attention")}
    print(json.dumps({"kernels": kernel_report(checks, launches)}),
          flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
