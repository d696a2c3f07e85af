#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pafuse_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:
  1. device  - the card (nvidia-smi name and power limit), torch and CUDA.
  2. build   - nvcc builds every kernel from the repository's sources,
               and g++ the native batcher (build_batcher).
  2b. gemm_kernel - the block chain's Hopper GEMM alone (ops.gemm,
               csrc/gemm.cu) against its plain version at every stage
               (qkv, proj, fc1, fc2) x part shape of one block call at
               bucket 16 and at the evaluation window batch 64, float32 and
               bfloat16, with its time, TFLOP/s and F.linear's (cuBLAS, a
               yardstick only); then one "gemm" line of sums.
  3. kernel  - the fused block kernel against its plain PyTorch version on
               the same seeded inputs, at every part's spatial and temporal
               shape as the serving path gives it at bucket 16 (P=10, flip
               on), in float32 and bfloat16, with its time, the plain
               version's, one PyTorch library composition's (SDPA + cuBLAS,
               a yardstick only) and the card's lower bound; each row with
               one call's device ms by stage (weight splits, LayerNorms,
               the four GEMMs, the tensor-core attention), summed over the
               shapes in one kernel_stages line a dtype.
  3b. attention_stage - the chain's attention stage alone
               (ops.attention_core, the kernel of block_chain.cuh's step 2)
               against its plain version at the same six shapes, on the
               qkv the chain computes there, float32 and bfloat16: its
               time, the plain version's, scaled_dot_product_attention's
               on the same qkv (a yardstick only) and its bound from the
               bytes (qkv read once, the output written once) and the
               operations (4*B*L^2*C).
  4. serve   - LiftingService at full width (the D3DPConfig defaults: part
               based, merged hands, 27 frames, 134 joints, depth 8) with
               seeded weights, P=10, T=5, buckets (1,2,4,8,16), float32,
               host noise, dynamic batching on: warm-up and three requests,
               with shape, finiteness, determinism and kernel-launch checks;
               the 27-frame request with batching off, bit-equal to the
               lone request through the batcher; and one request held
               against the same service with every block on the plain
               version.  Then, on the same weights:
     serve_concurrent - 8 client threads x 4 requests of 27 frames, first
               with batching off (each request its lone run), then through
               the batcher: requests/s, p50/p95 latency, batch_calls (fewer
               than the requests), busy seconds over wall, peak device
               memory (and memory back where it was), every co-batched
               result within SERVE_TOL of its lone run;
     serve_modes - a noise=device, readback=mean service with tiers
               ["10x5", "1x1"]: warm-up, 27- and 405-frame latencies per
               tier, device-noise determinism (same seed bit-equal, another
               seed differs), host noise against device noise at 405 frames
               (interleaved), and the mean within MEAN_TOL of the 'all'
               service's host mean;
     serve_stream - one 1x1 session pushing 60 frames one at a time (p50/p95
               per push), then 4 concurrent sessions of 30 pushes each,
               co-batched (batch_calls below the pushes), each emit within
               SERVE_TOL of the same session run alone;
     serve_http - cli.serve.build_service from the default config and
               make_http_server(port=0): /healthz, a /lift bit-equal to the
               same request in-process, a stream round trip and /metrics;
     serve_profile - one 405-frame request under torch.profiler on the
               host-noise 'all' service and on the device-noise mean
               service: device time by kernel group and the idle share;
     bf16_serve - the same service at compute_dtype=bfloat16 on the same
               weights: warm-up and 27/100/405-frame latencies, all on
               kernel #1 in bfloat16; the 405-frame request against the
               same service on #1's plain version within BF16_POSE_TOL,
               and against the plain bfloat16 path (use_pallas=false)
               within BF16_NOISE_RATIO times that path's distance from
               the float32 service (the distance from float32 in mm
               reported).
               Every serve phase checks kernel #1's launches.
  5. train_kernel - the training block kernels (#5 forward, #6 backward)
               against their plain PyTorch versions at every part's
               spatial and temporal shape of a training step (37 sequences
               of 27 frames), with x (and g) in float32 and in bfloat16,
               with their times, the plain versions', one PyTorch library
               composition's (layer_norm + linear + SDPA + gelu, and its
               autograd backward; a yardstick only) and the bound; and the
               backward's tensor-core GEMMs alone at each shape (its four
               data gradients on wgmma, its four weight gradients with
               their bias gradients on wgmma), their time and TFLOP/s
               beside cuBLAS's (a @ w, d^T @ x with d.sum(0); a yardstick
               only), and the forward's four GEMMs
               alone (wgmma, with their epilogues) beside F.linear's; and
               at each shape the two attention stages alone in float32:
               the forward (ops.attention_core, #5's step 3) on
               the qkv the forward computes there and the backward
               (ops.attention_core_bwd, #6's step 9) on that qkv and a
               unit-variance dO, each against its plain version, with its
               time, the plain version's, scaled_dot_product_attention's
               (the backward: autograd through it; a yardstick only) and
               its bound.
  6. train   - the trainer at full width (D3DPConfig defaults with
               drop_path_rate 0.1; depth 8, float32, lr 6e-5, weighted MPJPE)
               on synthetic H3WB (S1, S5, S6, S7) through ChunkedSampler
               (augment) and PrefetchingLoader, 37 sequences a step: five
               steps with finite losses, 48 launches of each kernel a step
               and every parameter moved; two runs from one seed
               bit-identical after two steps; one step against the same
               step with every block on the plain versions; and the loss
               falling over 16 steps on one repeated batch at lr 1e-3.
               One more step runs under torch.profiler: device time by
               kernel group (the wgmma GEMMs split by their epilogue into
               #5's forward products and #6's data gradients; both must
               show) and the device's idle share.
  7. attention_kernel - the attention kernel (#2) against its plain PyTorch
               version at every part's spatial and temporal shape of the
               evaluation path (window batch 64, P=10, flip on), in float32
               and bfloat16, with its time, the plain version's, one PyTorch
               library composition's (linear + SDPA + linear, a yardstick
               only) and the bound, and in float32 its two wgmma GEMMs
               alone (ops.gemm.fused_linear, the same GEMM on the same
               split weights), their time and TFLOP/s beside F.linear's; and
               in float32 at the serving shapes of bucket 16, the shapes of
               the kernel phase; with float32 x also #2's attention stage
               alone (ops.attention_core in float32 on the qkv of its
               first GEMM) against its plain version, timed beside SDPA.
  8. eval    - the H3WB CLI (cli.main_h3wb) evaluating a checkpoint of
               seeded full-width weights saved with checkpoints.save_state
               on synthetic H3WB (test subject S8; 2 actions x 4 cameras x
               1000 frames, so each action dispatches two full window
               batches of 64 rows and a 24-row tail) at
               gpu.use_pallas=true, P=10, T=5, float32, depth 4 (for the
               run's time limit): the batches and
               rows dispatched, 24*T launches of kernel #2 for every window
               batch and none of kernel #1, finite metrics, the report file
               with the reference's lines; wall seconds, windows/s and
               frames/s.  Then one action's evaluate_sequences (the same
               three batches) with injected noise at
               use_pallas=true against the same call with every attention on
               the plain version and against use_pallas=auto (kernel #1);
               one DDIM step of that action under torch.profiler; and a
               short CLI run that trains one step (kernels #5/#6) and
               evaluates (ft2d.debug=true, P=2, T=2).
  9. block_temporal_kernel - the temporal block kernel (#3) against its
               plain PyTorch version on (B, 27, N, C) at every part's
               temporal shape, at the evaluation window batch 64 (B = 1280)
               in float32 and at serve bucket 16 (B = 320) in float32 and
               bfloat16, with its time, the plain version's, the path it
               replaces (transpose, kernel #1, transpose), one PyTorch
               library composition's (the same transposes around
               layer_norm + linear + SDPA + gelu, a yardstick only) and
               the bound.
 10. layer_kernel - the layer kernel (#4) the same way for each part, with
               the temporal position embedding (layer 0) and without, the
               replaced path being kernel #1 spatial, + tpe, transpose,
               kernel #1 temporal, transpose.
 11. eval_experimental - the CLI evaluating a checkpoint of the eval
               phase's seeded weights at gpu.use_pallas=block_t and at
               layer (gpu.experimental_kernels=true), P=10, T=5, float32,
               depth 4, on
               synthetic S8 at data.synthetic_actions=1,
               data.synthetic_frames=500 (76 windows: one 64-row batch and
               a 12-row tail): 12*T launches of #3 and 12*T of #1 a window
               batch at block_t, 12*T of #4 at layer, none of the other
               kernels; finite metrics, the report's lines; wall seconds,
               windows/s and frames/s.  Then that action's
               evaluate_sequences with one injected noise table at block_t,
               layer, auto and false, and one DDIM step of the 64-row batch
               at layer and at block_t under torch.profiler (device time by
               kernel group, copies included, and the idle share).
 12. dhp3_kernel - the 3DHP model's one network (17 joints, model.cs 288,
               8 heads of d = 36) against the plain versions: kernel #1 at
               window batches of 64, 38 and 16 (R = 1280, 760 and 320 rows
               of windows x P=10 x flip: spatial (R*27, 17, 288), temporal
               (R*17, 27, 288)) in float32 and bfloat16; the Hopper GEMM
               alone at 64 windows (N x K = 864 x 288, 288 x 288, 576 x 288,
               288 x 576); #5/#6 at 37 sequences ((999, 17, 288) and (629,
               27, 288)); #2 at 64 windows in float32; each with its time,
               bound and library time.
 13. dhp3_train - the 3DHP trainer (cli.main_3dhp's model: depth 8,
               mm_scale, unweighted MPJPE in mm) on
               dhp3.make_synthetic(num_train_seqs=16, frames=1000), 37
               sequences a step, through the same checks as train: 16 + 16
               launches a step.
 14. dhp3_eval - cli.main_3dhp.main at full width on its default synthetic
               data: one epoch (train, its P=1, T=1 evaluation, the final
               P=10, T=5 evaluation, the report, epoch_1), then
               evaluate-only from epoch_1 (the same metrics); then
               evaluate_3dhp on those weights over two 1000-frame test
               sequences (38 windows each, one sampler call each) at
               use_pallas=auto (16*T launches of #1 a call) and true (of
               #2): windows/s; one injected noise table at auto, true and
               false; one DDIM step traced.
 15. in_the_wild - cli.in_the_wild.lift_to_world at full width (the H3WB
               model at depth 4, for the run's time limit) on an OpenPifPaf
               JSON of 1000 frames the script writes: 38 windows in a
               37-window chunk and a 1-window tail, 24*T launches of #1 a
               chunk, shape (T, P, 1000, 134, 3); frames/s; then the same
               frames and chunks with one injected noise table against the
               plain block.
 16. draw    - cli.draw_h3wb.draw_poses at full width (depth 4, for the
               run's time limit) on synthetic S8 (one 1000-frame action,
               camera 0): 38 windows in one call (24*T launches of #1), the
               J-Agg pick, world coordinates; frames/s; then the same call
               with one injected noise table against the plain block.
               Rendering (matplotlib, OpenCV) is left to the CPU tests.
 17. bf16_eval - gpu.compute_dtype=bfloat16 at full width (depth 4, for
               the run's time limit): the H3WB CLI on the seeded weights'
               checkpoint on the 76-window action of
               eval_experimental at use_pallas=auto (#1), true (#2),
               block_t (#1 + #3) and layer (#4), their launches counted,
               beside float32 at auto: seconds, windows/s, every metric's
               delta from float32; then the action's first sequence with
               one noise table, every prediction of the bfloat16 kernel
               paths auto, true, block_t (#1 + #3) and layer (#4) held
               against the same model on those kernels' plain versions
               within BF16_POSE_TOL, and auto and true against the plain
               bfloat16 path (false) within BF16_NOISE_RATIO times its
               distance from float32; then evaluate_3dhp on the seeded
               3DHP model (2 x 1000 frames) the same way at auto, its
               outputs caught at eval_forward.
 18. bf16_train - the train and dhp3_train trainers at
               compute_dtype=bfloat16 (#5/#6 on bfloat16 activations)
               through the same checks, the plain comparison within the
               bfloat16 training bounds.
 19. autodiff_train - gpu.train_kernel=false on the H3WB model at full
               width: one step from equal params, t, noise and masks on
               the autodiff path and on #5/#6, float32 (the train bounds)
               and bfloat16 (the bfloat16 training bounds), ms/step, peak
               memory and no launch of #5/#6 on the autodiff path;
               remat=true bit-identical with its peak memory;
               model.dropout=0.1: the loss falls on one batch and a seed
               repeats bit for bit.
 20. mono134_kernel - #5/#6 against their plain versions at the
               monolithic 134-joint model's shapes ((999, 134, 288) and
               (4958, 27, 288)), float32 and bfloat16 x, with the two
               attention stages alone as in train_kernel.
 21. mono134_train - that model (general.part_based_model=false,
               model.cs 288) trained on #5/#6 through run_trainer's checks
               (16 + 16 launches a step).
 21b. mixste243 - MixSTE's published model (general.part_based_model=
               false model.cs=512 model.number_of_frames=243, depth 8,
               1024 frames a step): the attention stages alone at (L, d) =
               (243, 64), (351, 64), (351, 48), (243, 128), (134, 128),
               forward float32 and bfloat16 and backward float32, on the
               route the library takes (resident or streamed through
               shared memory) against their plain versions, a repeat bit
               for bit, beside the bound and SDPA; #5/#6 at (972, 134,
               512) and (536, 243, 512) as in train_kernel; #1 at its 243-
               and 351-frame serve windows against block_reference; 3
               training steps through run_trainer's checks (16 + 16
               launches a step, ms/step, peak memory, one step profiled),
               the streamed kernels' launches counted in their libraries
               (the forward's in the 351-frame window, the backward's two
               passes in the training steps) and shown by the profile.
 22. ddp_train - data parallel (parallel.mesh): the H3WB trainer at full
               width through DistributedDataParallel in a world of one on
               NCCL (make_mesh under torchrun's RANK/WORLD_SIZE/LOCAL_RANK
               variables), bit for bit against the plain trainer over 5 steps
               (ms/step, its overhead, the all-reduced bytes; 48 + 48
               launches a step); then two ranks in a gloo world on this
               card (NCCL refuses two ranks on one device) at depth 2, one
               step on the global batch of 36 against one process (loss
               and gradients within TRAIN_LOSS_RTOL, params within
               DDP_PARAM_ATOL, replicas bit for bit).
 23. ddp_eval - sharded evaluate_sequences on the 76-window action at
               P=10, T=2 (depth 4, for the run's time limit): a launched
               world of one on NCCL bit for bit against the unsharded run;
               two gloo ranks on this card at auto (#1) and true (#2)
               within DDP_EVAL_RTOL of one process.
 24. serve_sharded - LiftingService(devices=[cuda:0, cuda:0]): two
               replicas, each its share of a sampler call's rows, against
               one replica on 27- and 405-frame requests (SERVE_TOL), #1's
               launches counted per replica; then whether a row's result
               depends on its call's row count: #1 at bucket 16 vs 8 and
               cuBLAS's F.linear at the model's library products.
 25. observability - the H3WB CLI, launched as torchrun launches a
               world of one (NCCL, DDP training, sharded evaluation),
               without general.nolog and with gpu.profile=true: an event
               file with the JAX CLI's tags and a Chrome trace; the CLI
               loop's steps timed with and without the trace.
 26. packed_serve - packed parts at full width, at depth 4 for the run's
               time limit (body/face/hands at C = 384/224/256 padded to one
               (68, 384), run as one batched call, models/packed.py):
               LiftingService on D3DP(packed_parts=True,
               experimental_kernels=True) beside the
               same weights unpacked at use_pallas=auto, P=10, T=5,
               buckets 1..16, float32 and bfloat16: 27- and 405-frame
               latency, frames/s, peak memory; none of #1-#6 launched by a
               packed service; ddim_sample on 4 windows with one noise
               table, packed against the unpacked plain path
               (use_pallas=false) within PACKED_ATOL / PACKED_RTOL.
 27. native_batcher - the native batcher (runtime/batcher.cpp, g++ at its
               first use, in the build phase): the H3WB CLI with its
               training loop cut to 6 steps assembles on the native path;
               one of its batches natively and with NumPy, bit for bit,
               host ms each; ms per step of the CLI's loop.
 28. dryrun  - pafuse_tpu_torch.dryrun: entry()'s step (the flagship model
               at P=4) on kernel #1 against use_pallas=false within
               DRYRUN_TOL; dryrun_multichip(1) in a world of one launched as
               torchrun launches it (NCCL) and dryrun_multichip(2) in two
               gloo ranks sharing the card: DDP step (#5/#6), sharded eval
               step and a two-tier service with a stream (#1).
Each phase from bf16_serve and from 12 on prints its wall seconds, and a
"run" line the whole run's.  Then the {"kernels": [...]} line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}.  Any failed check raises: the script exits
non-zero and prints no result.  Without CUDA it exits non-zero at once.

Bounds: bound_ms = max(operations over the peak, bytes over 3.35 TB/s),
float32 work at 165 TFLOP/s (three TF32 tensor-core products per
float32-accurate product, 495 / 3), bfloat16 at 989; simt_bound_ms counts
float32 at the 67 TFLOP/s scalar rate, as PRs 1-4 did.

Tolerances (max abs, elementwise):
  gemm float32     1e-5 (outputs O(1); three TF32 products drop only
                   a_lo*w_lo, ~2^-22 relative, and sum in another order);
                   bfloat16 the kernel bound below (max 2^-4, mean 1e-3):
                   single-ulp flips of the rounded output, of the product
                   rounded before a residual add (an ulp of the product
                   and one of the sum, which can be the larger), and of
                   normalised A elements rounded on ~1e-7 differences of
                   the row statistics;
  kernel float32   1e-4: same rounding points, only the order of f32 sums
                   differs (TF32 off on both sides);
  kernel bfloat16  max 2^-4 and mean 1e-3: both sides round the output and
                   five intermediates to bfloat16, so an order-of-summation
                   difference flips a bf16 ulp somewhere; a flip of the
                   residual stream x2 (|x2| up to ~8, ulp 2^-5) passes
                   through the outer LayerNorm into the output, and the
                   output's own rounding adds one ulp (2^-6 at |y| in
                   [2, 4)).  Such flips touch ~1% of elements, so the mean
                   stays near 1e-4, while a misplaced rounding point or a
                   wrong index moves most elements.  A flat 5e-3 max cannot
                   hold: one output ulp at |y| >= 2 is 0.0156;
  serve            1e-3 on poses (O(1) values): 16 blocks per part network,
                   5 DDIM steps feeding back, each block within ~1e-6; the
                   same bound holds a co-batched request against its lone
                   run (cuBLAS picks its algorithm by the row count of the
                   embedding and head GEMMs);
  serve mean       1e-6: a hypothesis mean of 10 O(1) values summed on the
                   card against NumPy's on the host, the same poses;
  train kernels    forward 1e-4 max abs in float32 (float32 arithmetic on
                   both sides, sums in another order; TF32 off); bfloat16 x:
                   |diff| <= 2^-7 |y| + 1e-4 elementwise, one bfloat16 ulp
                   of the value plus the float32 bound (both sides round
                   float32 values that differ by ~1e-6, so a value near a
                   rounding boundary flips one ulp, and a value near zero
                   keeps the float32 difference); backward
                   1e-4 x max|plain gradient| per tensor (dx and the 14
                   parameter gradients);
  train step       kernel path vs plain path from equal params and equal t,
                   noise and masks: loss 1e-5 relative, gradients 1e-4 x
                   max|plain gradient| per parameter (48 blocks deep, each
                   within ~1e-6);
  attention kernel float32 1e-5 max abs (float32 arithmetic on both sides,
                   only the order of sums differs; outputs are O(1));
                   bfloat16 x: |diff| <= 2^-7 |y| + 1e-5 elementwise, one
                   bfloat16 ulp of the value plus the float32 bound (both
                   sides round only the output, from float32 values that
                   differ by ~1e-6);
  attention_stage  float32 1e-5 max abs (three TF32 products, whose
                   emulation on the CPU stays within 3e-7 of the plain
                   version on the chain's qkv, plus the tensor cores'
                   truncating accumulation; measured 5.1e-7 at these
                   shapes on an H100 80GB HBM3); bfloat16 2^-7 x (|y| +
                   max|v|) elementwise: one ulp of the rounded output (at
                   most 2^-7 |y|) plus the probabilities that round the
                   other way from f32 values ~1e-7 apart (a p below 1
                   moves by at most 2^-8, so up to two flips in a row carry
                   at most 2^-7 max|v|; measured max abs 3.9e-3);
  attention_bwd    #6's attention backward alone: ATTN_BWD_RTOL =
                   1e-5 x max|plain| for each of dq, dk and dv (three TF32
                   products a product; the CPU emulation of that arithmetic
                   stays within 1.0e-6 on the training qkv, and the tensor
                   cores' truncating accumulation adds a few f32 ulps), and
                   a repeat bit for bit; #2's and #5's forward stage alone
                   in float32: attention_stage's 1e-5;
  block_temporal   kernel #3: kernel's bounds (the same block and rounding
                   points on the transposed rows);
  layer kernel     kernel #4: float32 1e-4 (two blocks, each within ~1e-6);
                   bfloat16 max 2^-3 and mean 2e-3, twice kernel's: the
                   spatial block's output, with its flipped ulps, and the
                   tpe sum, rounded once more, are the temporal block's
                   input, so the output carries the flips of two blocks;
  eval             every metric (mm, means over ~10^6 joint errors) within
                   1e-4 relative of the same evaluation with every attention
                   on the plain version, and of the same evaluation on
                   kernel #1: all three compute the same float32 function
                   (each block within ~1e-6, 16 blocks a part network, 5
                   DDIM steps feeding back), so the metrics agree to ~1e-6
                   relative; the argmin selections of P_Best and J_Agg are
                   made on errors that agree as closely, and a selection
                   that flips at a near-tie moves a mean by its gap over
                   ~10^5 selections;
  eval_experimental block_t and layer within EVAL_RTOL (1e-4) relative of
                   auto and of false, for the same reasons;
  dhp3_*           the kernels at the 3DHP shapes under the bounds above
                   (the same arithmetic at C = 288); the 3DHP metrics (mm)
                   of auto and true within EVAL_RTOL relative of false, and
                   evaluate-only within it of the evaluation after
                   training (both are the same float32 function);
  in_the_wild      1e-3 on poses, as serve (16 blocks per network, 5 DDIM
                   steps feeding back, each block within ~1e-6);
  bf16 paths       a bfloat16 kernel path's poses against the same model
                   on its kernels' plain versions within BF16_POSE_TOL (max
                   and mean), and against the plain bfloat16 path
                   (use_pallas=false) within BF16_NOISE_RATIO times that
                   path's own distance from float32 on the same weights and
                   noise, plus BF16_FLOOR; bfloat16 training steps of
                   two paths from equal draws: loss BF16_TRAIN_LOSS_RTOL
                   relative, gradients BF16_TRAIN_GRAD_RTOL x max|gradient|
                   (the measurements behind both are beside the constants);
  train kernels    bfloat16 backward: the 14 parameter gradients within
                   the float32 bound, dx within 2^-7 |dx| + 1e-4 x max|dx|
                   (one bfloat16 ulp of a float32 value ~1e-6 apart).
"""

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

# published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense).
# float32 work counts at the rate of float32-accurate tensor-core products:
# three TF32 products make one (495 / 3 TFLOP/s), as the block chain's GEMM
# computes them; SIMT_FLOPS, the scalar float32 rate that bounded PRs 1-4's
# kernels, gives each row's simt_bound_ms beside it (bfloat16 keeps 989).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
SIMT_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
KERNEL_TOL_F32 = 1e-4
KERNEL_TOL_BF16 = (2.0 ** -4, 1e-3)     # (max, mean)
SERVE_TOL = 1e-3
MEAN_TOL = 1e-6
SERVE_CLIENTS = 8               # serve_concurrent: client threads
SERVE_PER_CLIENT = 4            # ... and requests each
STREAM_FRAMES = 60              # serve_stream: pushes of the lone session
SERVE_REST = "PyTorch (embedding, head, sampler, noise, assembly)"
CUBLAS_WORKSPACE_BOUND = 64 << 20   # bytes a new client thread may add
REPLACES = "pafuse_tpu/ops/attention.py:405"
SOURCE = "pafuse_tpu_torch/ops/csrc/block.cu"
TRAIN_SOURCE = "pafuse_tpu_torch/ops/csrc/block_train.cu"
TRAIN_REPLACES = {"block_train_fwd": "pafuse_tpu/ops/block_grad.py:306",
                  "block_train_bwd": "pafuse_tpu/ops/block_grad.py:344"}
TRAIN_FWD_TOL = 1e-4
TRAIN_GRAD_RTOL = 1e-4
TRAIN_LOSS_RTOL = 1e-5
TRAIN_SEQS = 1024 // 27         # model.batch_size // number_of_frames
TRAIN_STEPS = 5
OVERFIT_STEPS = 16
# bfloat16 model compute.  A bfloat16 kernel path is held against the same
# model with its kernels on their plain versions (_plain_fns), on the same
# weights and noise, at fixed (max abs, mean abs) bounds on every output
# (serve poses and 3DHP outputs in metres or mm, eval predictions of every
# DDIM step and hypothesis in metres).  The two round at the same points
# and differ only where a float32 sum in another order flips a bfloat16
# rounding; over 16 blocks a network and 5 DDIM steps such flips grow to
# the size of bfloat16's own distance from float32, so these bounds catch
# a fault in how the model feeds a kernel (it shows at the pose's scale,
# ~0.1-1 m), not one rounding: each kernel is held to one or two bfloat16
# ulps of its plain version in the kernels line, and the depth-2 model in
# tests/test_torch_cuda.py.  Measured on the H100 (H100 80GB HBM3,
# 700.00 W) at full width: serve 9.37e-3 / 1.36e-3 m (the plain path's
# distance from float32 1.97e-2 / 3.26e-3); eval auto, block_t and layer
# 3.38e-2 / 4.11e-3 m, true 3.44e-2 / 3.94e-3 (float32: 4.03e-2 /
# 4.50e-3); 3DHP 22.94 / 3.34 mm (float32: 23.04 / 3.37).  About twice
# that:
BF16_POSE_TOL = {"serve": (2e-2, 3e-3), "eval": (7e-2, 8e-3),
                 "3dhp": (50.0, 7.0)}
# The kernel path against the JAX model's rounding points (use_pallas=
# false) too: within BF16_NOISE_RATIO times the plain path's own distance
# from float32 on the same weights and noise (max and mean), plus
# BF16_FLOOR.  The CPU rehearsal (depth 1, P <= 2, T = 2) puts #1's plain
# version at 0.92 / 0.80 (serve), 1.01 / 0.81 (eval auto), 1.17 / 0.90
# (eval true) and 0.99 / 0.87 (3DHP) of that distance, the H100 at full
# width at 0.48 / 0.42, 0.85 / 0.94, 0.94 / 1.04 and 1.05 / 1.02.
BF16_NOISE_RATIO = 2.0
BF16_FLOOR = 1e-3               # mm (3DHP poses); x 1e-3 on poses in metres
# a bfloat16 training step against another bfloat16 path from equal
# params, t, noise and masks: the CPU rehearsal of autodiff_train (depth
# 1, 2 sequences) puts the autodiff path's loss 2.6e-4 relative and its
# gradients 9.2e-3 x max|gradient| per tensor from the kernel path's (the
# kernel path's own distance from float32: 5.1e-4, 8.1e-3); about 5x that
BF16_TRAIN_LOSS_RTOL = 1e-3
BF16_TRAIN_GRAD_RTOL = 5e-2
DROPOUT = 0.1                   # autodiff_train's model.dropout
MONO_CS = 288                   # the monolithic H3WB model's model.cs
DHP3_CS = 288                   # model.cs: the 3DHP network's channels
DHP3_TRAIN_SEQS = 16            # dhp3_train: synthetic training sequences
DHP3_FRAMES = 1000              # ... of 1000 frames (dhp3_eval: the test set)
DHP3_EVAL_WINDOWS = 64          # evaluate_3dhp's largest sampler call
ATTN_SOURCE = "pafuse_tpu_torch/ops/csrc/attention.cu"
ATTN_REPLACES = "pafuse_tpu/ops/attention.py:158"
ATTN_TOL_F32 = 1e-5
ATTN_TOL_BF16 = (2.0 ** -7, 1e-5)       # (relative, absolute)
EVAL_WINDOWS = 64               # pinned window batch of the eval path
EVAL_RTOL = 1e-4
BT_SOURCE = "pafuse_tpu_torch/ops/csrc/block_temporal.cu"
BT_REPLACES = "pafuse_tpu/ops/attention.py:525"
LAYER_SOURCE = "pafuse_tpu_torch/ops/csrc/layer.cu"
LAYER_REPLACES = "pafuse_tpu/ops/attention.py:646"
LAYER_TOL_BF16 = (2.0 ** -3, 2e-3)      # (max, mean)
GEMM_SOURCE = "pafuse_tpu_torch/ops/csrc/gemm.cu"
GEMM_TOL_F32 = 1e-5
ATTN_CORE_SOURCE = "pafuse_tpu_torch/ops/csrc/attention_sm90.cuh"
ATTN_CORE_REPLACES = "pafuse_tpu/ops/attention.py:300"   # _block_body's attention
ATTN_CORE_TOL_F32 = 1e-5
ATTN_CORE_TOL_BF16 = 2.0 ** -7          # x (|y| + max|v|), elementwise
ATTN_BWD_SOURCE = "pafuse_tpu_torch/ops/csrc/attention_bwd_sm90.cuh"
ATTN_BWD_REPLACES = "pafuse_tpu/ops/block_grad.py:203"   # _train_bwd_kernel's attention
ATTN_BWD_RTOL = 1e-5                    # x max|plain| for each of dq, dk, dv
WGRAD_SOURCE = "pafuse_tpu_torch/ops/csrc/wgrad_sm90.cuh"
WGRAD_REPLACES = "pafuse_tpu/ops/block_grad.py:174"   # _train_bwd_kernel's dW, db
WGRAD_RTOL = 1e-5                       # x max|plain| for each of dW and db
#: phase -> launches of #6's weight-gradient kernel in its main-path run,
#: as the block_train library counts them (run_trainer)
WGRAD_LAUNCHES = {}
LNB_REPLACES = "pafuse_tpu/ops/block_grad.py:55"     # _ln_bwd, at :166, :188, :237
# #6's LayerNorm backward alone against its plain version: float32 sums
# over C columns (the two row means) and over the rows (dscale, dbias) in
# another order; 1e-5 x max|plain| for each of dx, dxm, dscale and dbias
LNB_RTOL = 1e-5
#: phase -> launches of #6's LayerNorm backward (ln_bwd_kernel) in its
#: main-path run, as the block_train library counts them (run_trainer)
LNB_LAUNCHES = {}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def device_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """The device time of one ``fn()`` call, for a call whose host work (a
    wrapper's checks, allocations and ctypes call) is about as long as its
    kernels, where back-to-back CUDA events would time the host: the
    ``reps`` calls are queued behind a spin of the device
    (``torch.cuda._sleep``), so the events around them see the device
    alone.  The spin grows until the first event is still pending when the
    last call has been queued."""
    import torch
    for _ in range(warm):
        fn()
    cycles = 1 << 24                # ~9 ms at the H100's clock
    while cycles <= 1 << 32:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        queued = not start.query()
        stop.record()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the host could not queue the calls ahead "
                       "of the device")


def cuda_time_ms(fn, reps: int = 5, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


#: sequences per scaled_dot_product_attention call: its bf16 kernels put the
#: batch on gridDim.y, which holds at most 65535 blocks
SDPA_CHUNK = 32768


def library_sdpa(q, k, v):
    """scaled_dot_product_attention over (B, H, L, d), in chunks of
    SDPA_CHUNK sequences where B is larger."""
    import torch
    import torch.nn.functional as F
    if q.shape[0] <= SDPA_CHUNK:
        return F.scaled_dot_product_attention(q, k, v)
    return torch.cat([F.scaled_dot_product_attention(
        q[i:i + SDPA_CHUNK], k[i:i + SDPA_CHUNK], v[i:i + SDPA_CHUNK])
        for i in range(0, q.shape[0], SDPA_CHUNK)])


def library_block(x, bp, on, num_heads, m1=None, m2=None):
    """The same block as one composition of PyTorch library calls
    (layer_norm, cuBLAS linear, scaled_dot_product_attention, gelu), with
    optional per-sequence branch masks: the yardstick ``library_ms``.  The
    port never calls it."""
    import torch.nn.functional as F
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2,
     bfc2) = bp
    B, L, C = x.shape
    d = C // num_heads
    h = F.layer_norm(x, (C,), n1s, n1b, 1e-6)
    q, k, v = F.linear(h, wqkv, bqkv).view(B, L, 3, num_heads, d).permute(
        2, 0, 3, 1, 4)
    a = library_sdpa(q, k, v).transpose(1, 2).reshape(B, L, C)
    a = F.linear(a, wproj, bproj)
    x = x + (a if m1 is None else m1.to(x.dtype)[:, None, None] * a)
    h = F.linear(F.gelu(F.linear(F.layer_norm(x, (C,), n2s, n2b, 1e-6),
                                 wfc1, bfc1)), wfc2, bfc2)
    x = x + (h if m2 is None else m2.to(x.dtype)[:, None, None] * h)
    return F.layer_norm(x, (C,), on[0], on[1], 1e-6)


def bound(flops, nbytes, dtype_name):
    """The least time of a call, max(operations over the peak for
    ``dtype_name``, bytes over HBM), what bounds it, and the same with the
    scalar float32 rate (SIMT_FLOPS) as PRs 1-4 counted it."""
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "simt_bound_ms": max(flops / SIMT_FLOPS[dtype_name],
                                 t_bytes) * 1e3}


def block_bound(B, L, C, dtype_name, param_bytes):
    """Bound of one block call: 16*M*C^2 + 4*B*L^2*C operations; bytes: x
    read once, out written once, params."""
    M = B * L
    itemsize = 4 if dtype_name == "float32" else 2
    return bound(16 * M * C * C + 4 * B * L * L * C,
                 2 * M * C * itemsize + param_bytes, dtype_name)


def train_bound(B, L, C, itemsize, param_bytes, backward: bool):
    """Bound of one training-block call, all arithmetic float32: forward
    16*M*C^2 + 4*B*L^2*C FLOPs and the backward twice that (no recompute
    counted); bytes: x and y (forward) or x, g and dx (backward) once each,
    plus the params (and their gradients)."""
    M = B * L
    flops = (16 * M * C * C + 4 * B * L * L * C) * (2 if backward else 1)
    nbytes = ((3 if backward else 2) * M * C * itemsize
              + (2 if backward else 1) * param_bytes + 2 * B * 4)
    return bound(flops, nbytes, "float32")


def layer_bound(B, F, N, C, dtype_name, param_bytes):
    """Bound of one call of kernel #4 (B, F, N, C): both blocks'
    operations, 16*M*C^2 + 4*B*F*N^2*C spatial and 16*M*C^2 +
    4*B*N*F^2*C temporal (M = B*F*N), against x read once, the output
    written once and the params (both blocks', and tpe)."""
    M = B * F * N
    itemsize = 4 if dtype_name == "float32" else 2
    return bound(32 * M * C * C + 4 * B * F * N * N * C + 4 * B * N * F * F * C,
                 2 * M * C * itemsize + param_bytes, dtype_name)


def _within(diff, dtype, bf16_tol) -> bool:
    """A block kernel's bound: KERNEL_TOL_F32 max abs in float32,
    ``bf16_tol`` = (max, mean) abs in bfloat16."""
    import torch
    if dtype == torch.float32:
        return bool(diff.max() <= KERNEL_TOL_F32)
    max_tol, mean_tol = bf16_tol
    return bool(diff.max() <= max_tol and diff.mean() <= mean_tol)


def h3wb_parts():
    """(name, joints, channels) of the default config's part networks."""
    from pafuse_tpu_torch.models.parts import PART_CHANNELS
    from pafuse_tpu_torch.skeleton import parts_table
    return [(part, len(joints), PART_CHANNELS[part])
            for part, joints in parts_table(True).items()]


#: the block chain's four GEMMs in launch order (block_chain.cuh)
CHAIN_GEMMS = ("qkv", "proj", "fc1", "fc2")


def block_cases(windows, P, frames, parts=None):
    """(part, kind, B, L, C) of each network's spatial (B =
    windows*P*2*frames sequences of its joints) and temporal (B =
    windows*P*2*joints sequences of the frames) block; ``parts``: (name,
    joints, channels) of the networks, the default config's when omitted."""
    seqs = windows * P * 2                          # windows x hypotheses x flip
    return [case for part, N, C in parts or h3wb_parts()
            for case in ((part, "spatial", seqs * frames, N, C),
                         (part, "temporal", seqs * N, frames, C))]


def chain_stages(fn):
    """Device ms by stage of one block-chain call ``fn()`` under
    torch.profiler: each kernel of the chain by its name without namespace
    and template arguments (split_weights_kernel, row_stats_kernel,
    attention_kernel, layernorm_kernel, ...), summed over its launches, and
    the wgmma GEMMs apart by launch order as CHAIN_GEMMS says."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    stages, gemms = {}, 0
    for e in events:
        name = re.sub(r"\(.*", "", re.sub(r"^.*::", "", re.sub(r"<.*", "", e.name)))
        if name in ("gemm_kernel", "gemm_bf16_kernel"):
            name = f"gemm_{CHAIN_GEMMS[gemms % len(CHAIN_GEMMS)]}"
            gemms += 1
        stages[name] = stages.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    return stages


def kernel_phase(seed: int, windows: int, P: int, frames: int, parts=None,
                 phase="kernel", stages=False):
    """Kernel #1 against its plain version at block_cases' shapes.  With
    ``stages``, each row carries the device ms of one call by stage
    (chain_stages), and one ``<phase>_stages`` line a dtype sums them over
    the shapes."""
    import torch
    from pafuse_tpu_torch.ops.block import block_reference, fused_block
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device("cuda")
    heads = 8
    results = []
    for i, (part, kind, B, L, C) in enumerate(
            block_cases(windows, P, frames, parts)):
        g = torch.Generator().manual_seed(seed * 100 + i)
        params = _random_block_params(C, g, dev)
        bp, on = params[:12], params[12:]
        param_bytes = 4 * sum(t.numel() for t in bp + on)
        x32 = torch.randn(B, L, C, generator=g).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            x = x32.to(dtype)
            got = fused_block(x, bp, on, heads)
            sync(dev)           # a fault inside the kernel surfaces here
            want = block_reference(x, bp, on, heads)
            diff = (got.float() - want.float()).abs()
            ok = _within(diff, dtype, KERNEL_TOL_BF16)
            lib_bp = tuple(t.to(dtype) for t in bp)
            lib_on = tuple(t.to(dtype) for t in on)
            ms = cuda_time_ms(lambda: fused_block(x, bp, on, heads))
            plain_ms = cuda_time_ms(lambda: block_reference(x, bp, on, heads))
            lib_ms = cuda_time_ms(
                lambda: library_block(x, lib_bp, lib_on, heads))
            r = {"phase": phase, "name": "fused_block", "part": part,
                 "kind": kind, "dtype": name, "windows": windows, "B": B,
                 "L": L, "C": C,
                 "max_abs_err": float(diff.max()),
                 "mean_abs_err": float(diff.mean()), "ok": ok, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 **block_bound(B, L, C, name, param_bytes)}
            if stages:
                r["stages_ms"] = chain_stages(
                    lambda: fused_block(x, bp, on, heads))
            emit(r)
            results.append(r)
            del got, want, diff
        del x32, x
        torch.cuda.empty_cache()
    for name in ("float32", "bfloat16") if stages else ():
        total = {}
        for r in results:
            for k, v in r["stages_ms"].items() if r["dtype"] == name else ():
                total[k] = total.get(k, 0.0) + v
        emit({"phase": f"{phase}_stages", "dtype": name,
              "windows": windows, "stages_ms": total,
              "device_ms": sum(total.values()),
              "gemm_ms": sum(v for k, v in total.items()
                             if k.startswith("gemm_"))})
    return results


def attention_stage_phase(seed: int, windows: int, P: int, frames: int):
    """The chain's attention stage alone (ops.attention_core) against its
    plain version at block_cases' shapes, on the qkv the chain computes
    there (LN1(x) @ Wqkv + bqkv in the dtype), float32 and bfloat16: ms,
    plain ms, library ms (library_sdpa on the same qkv) and the bound
    (4*B*L^2*C operations; qkv read once, the output written once)."""
    import torch
    from pafuse_tpu_torch.ops.attention_core import (attention_core,
                                                     attention_core_reference)
    from pafuse_tpu_torch.ops.gemm import linear_reference
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device("cuda")
    heads = 8
    results = []
    for i, (part, kind, B, L, C) in enumerate(block_cases(windows, P, frames)):
        g = torch.Generator().manual_seed(seed * 100 + 200 + i)
        p = _random_block_params(C, g, dev)
        x32 = torch.randn(B, L, C, generator=g).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            qkv = linear_reference(x32.to(dtype), p[2], p[3], p[0:2])
            got = attention_core(qkv, heads)
            sync(dev)           # a fault inside the kernel surfaces here
            want = attention_core_reference(qkv, heads).float()
            diff = (got.float() - want).abs()
            if dtype == torch.float32:
                ok = bool(diff.max() <= ATTN_CORE_TOL_F32)
            else:
                vmax = qkv[..., 2 * C:].float().abs().max()
                ok = bool((diff <= ATTN_CORE_TOL_BF16
                           * (want.abs() + vmax)).all())
            err = float(diff.max())
            del got, want, diff
            q, k, v = qkv.view(B, L, 3, heads, C // heads).permute(
                2, 0, 3, 1, 4)
            ms = cuda_time_ms(lambda: attention_core(qkv, heads))
            plain_ms = cuda_time_ms(
                lambda: attention_core_reference(qkv, heads))
            lib_ms = cuda_time_ms(lambda: library_sdpa(q, k, v))
            r = {"phase": "attention_stage", "name": "attention_core",
                 "part": part, "kind": kind, "dtype": name,
                 "windows": windows, "B": B, "L": L, "C": C,
                 "max_abs_err": err, "ok": ok, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 **bound(4 * B * L * L * C,
                         4 * B * L * C * qkv.element_size(), name)}
            emit(r)
            results.append(r)
            del qkv, q, k, v
        del x32
        torch.cuda.empty_cache()
    return results


def gemm_kernel_phase(seed: int, windows: int, P: int, frames: int,
                      shapes: str, parts=None, phase="gemm_kernel"):
    """The chain's Hopper GEMM alone (ops.gemm.fused_linear) against its
    plain version at each stage x network shape of one block call (M =
    windows*P*2*frames*N rows, the same for the spatial and the temporal
    block; ``parts`` as kernel_phase's), in float32 and bfloat16: its time,
    TFLOP/s (2*M*N*K over the time, three TF32 products counted once), its
    bound (A, the weights, the residual read once, Y written once) and
    F.linear's time in the same dtype (cuBLAS, the yardstick)."""
    import torch
    import torch.nn.functional as F
    from pafuse_tpu_torch.ops.gemm import fused_linear, linear_reference
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device("cuda")
    results = []
    for i, (part, joints, C) in enumerate(parts or h3wb_parts()):
        M = windows * P * 2 * frames * joints
        g = torch.Generator().manual_seed(seed * 100 + 150 + i)
        gd = torch.Generator(device=dev).manual_seed(seed * 100 + 150 + i)
        p = _random_block_params(C, g, dev)
        # stage: (W, b, LayerNorm, epilogue)
        stages = {"qkv": (p[2], p[3], p[0:2], "store"),
                  "proj": (p[4], p[5], None, "residual"),
                  "fc1": (p[8], p[9], p[6:8], "gelu"),
                  "fc2": (p[10], p[11], None, "residual")}
        a32 = {K: torch.randn(M, K, generator=gd, device=dev)
               for K in (C, 2 * C)}
        r32 = torch.randn(M, C, generator=gd, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            for stage, (w, b, ln, epi) in stages.items():
                N, K = w.shape
                a = a32[K].to(dtype)
                res = r32.to(dtype) if epi == "residual" else None
                got = fused_linear(a, w, b, ln, epi, res)
                sync(dev)       # a fault inside the kernel surfaces here
                want = linear_reference(a, w, b, ln, epi, res).float()
                diff = (got.float() - want).abs()
                ok = (bool(diff.max() <= GEMM_TOL_F32)
                      if dtype == torch.float32
                      else _within(diff, dtype, KERNEL_TOL_BF16))
                err = float(diff.max())
                del got, want, diff
                wl, bl = w.to(dtype), b.to(dtype)
                ms = cuda_time_ms(lambda: fused_linear(a, w, b, ln, epi, res))
                lib_ms = cuda_time_ms(lambda: F.linear(a, wl, bl))
                size = a.element_size()
                nbytes = (M * K + (2 if res is not None else 1) * M * N) * size
                r = {"phase": phase, "name": "fused_linear",
                     "shapes": shapes, "part": part, "stage": stage,
                     "dtype": name, "M": M, "N": N, "K": K,
                     "max_abs_err": err, "ok": ok, "ms": ms,
                     "tflops": 2 * M * N * K / ms / 1e9,
                     "library_ms": lib_ms,
                     "library_tflops": 2 * M * N * K / lib_ms / 1e9,
                     **bound(2 * M * N * K, nbytes + 4 * (N * K + N), name)}
                emit(r)
                results.append(r)
                del a, res
        del a32, r32
        torch.cuda.empty_cache()
    return results


def _per_chunk(model, T):
    """Kernel #1 launches of one sampler call: parts x depth x 2 blocks x T
    DDIM steps."""
    return len(model.pose_estimator.specs) * model.cfg.depth * 2 * T


def _kp(rng, frames, J=134):
    import numpy as np
    return rng.uniform(-1, 1, (frames, J, 2)).astype(np.float32)


def _pcts(lat_ms):
    """p50 and p95 of a list of latencies (ms)."""
    import numpy as np
    return {"p50_ms": float(np.percentile(lat_ms, 50)),
            "p95_ms": float(np.percentile(lat_ms, 95))}


def serve_phase(seed: int, device: str = "cuda", cfg=None):
    """LiftingService at full width (see the module docstring; a CPU
    rehearsal passes device="cpu" and a small cfg, and checks no launches).
    Returns (the kernel launches of the main-path runs, the service, the
    27-frame request and its poses)."""
    import numpy as np
    import torch
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.models.mixste import MixSTE2
    from pafuse_tpu_torch.ops.block import block_reference, fused_block
    from pafuse_tpu_torch.serve import LiftingService, bucket_for

    cfg = cfg or D3DPConfig()       # flagship: depth 8, 27 frames, P=10, T=5
    on_card = device != "cpu"
    model = D3DP(cfg, device=device,
                 generator=torch.Generator().manual_seed(seed))
    svc = LiftingService(model, buckets=(1, 2, 4, 8, 16), device=device)
    P, T = cfg.num_proposals, cfg.sampling_timesteps
    per_chunk = _per_chunk(model, T)
    rng = np.random.RandomState(seed)

    def chunks(frames):
        w = max(1, -(-frames // cfg.frames))
        return -(-w // bucket_for(w, svc.buckets))

    def check(label, launches, expected):
        if on_card and launches != expected:
            raise AssertionError(f"{label}: {launches} launches, expected "
                                 f"{expected}")

    main_path_launches = 0
    fused_block.launches = 0
    t0 = time.time()
    svc.warmup()
    warm_s = time.time() - t0
    check("warmup", fused_block.launches, per_chunk * len(svc.buckets))
    emit({"phase": "serve_warmup", "seconds": warm_s,
          "launches": fused_block.launches})
    main_path_launches += fused_block.launches

    requests = [
        ("27 frames", (27, 134, 2), {}),
        ("100 frames, pixels, world", (100, 134, 2),
         {"width": 1280, "height": 720, "world": True}),
        ("405 frames, all hypotheses", (405, 134, 2), {"all_hypotheses": True}),
        ("27 frames again", None, {}),
    ]
    outputs = {}
    first_kp = None
    for label, shape, kw in requests:
        if shape is None:
            kp = first_kp
        else:
            kp = rng.uniform(-1, 1, shape).astype(np.float32)
            if "width" in kw:
                kp = (kp + 1) * 0.5 * np.array([kw["width"], kw["height"]],
                                               np.float32)
        if first_kp is None:
            first_kp = kp
        fused_block.launches = 0
        res = svc.lift(kp, seed=seed, **kw)
        launches = fused_block.launches
        main_path_launches += launches
        poses = res["poses"]
        want_shape = ((P,) if kw.get("all_hypotheses") else ()) + (
            kp.shape[0], 134, 3)
        if poses.shape != want_shape:
            raise AssertionError(f"{label}: shape {poses.shape} != {want_shape}")
        if not np.all(np.isfinite(poses)):
            raise AssertionError(f"{label}: non-finite poses")
        check(label, launches, per_chunk * chunks(kp.shape[0]))
        if kw.get("world") and poses[..., 2].min() < 0.0:
            raise AssertionError(f"{label}: pose below the rebased floor")
        outputs[label] = poses
        emit({"phase": "serve", "request": label, "frames": kp.shape[0],
              "chunks": chunks(kp.shape[0]), "launches": launches,
              "latency_ms": res["latency_ms"],
              "frames_per_s": kp.shape[0] / (res["latency_ms"] / 1e3),
              "pose_abs_mean": float(np.abs(poses).mean())})
    if not np.array_equal(outputs["27 frames"], outputs["27 frames again"]):
        raise AssertionError("same (request, seed) gave different poses")

    # a lone request through the (default) batcher == batching off, bit for
    # bit: the same rows through the same calls
    off = LiftingService(model, buckets=svc.buckets, dynamic_batching=False,
                         device=device)
    fused_block.launches = 0
    lone = off.lift(first_kp, seed=seed)["poses"]
    main_path_launches += fused_block.launches
    check("batching off", fused_block.launches, per_chunk)
    emit({"phase": "serve_vs_batching_off",
          "bit_equal": bool(np.array_equal(lone, outputs["27 frames"]))})
    if not np.array_equal(lone, outputs["27 frames"]):
        raise AssertionError("a lone request through the batcher differs "
                             "from the same request with batching off")

    # the same service with every block on the plain version, on the card
    nets = [m for m in model.modules() if isinstance(m, MixSTE2)]
    for m in nets:
        m.block_fn = block_reference
    try:
        ref = svc.lift(first_kp, seed=seed)["poses"]
    finally:
        for m in nets:
            m.block_fn = fused_block
    err = float(np.abs(ref - outputs["27 frames"]).max())
    emit({"phase": "serve_vs_plain", "max_abs_err": err, "tol": SERVE_TOL})
    if not err <= SERVE_TOL:
        raise AssertionError(f"kernel path vs plain path: {err} > {SERVE_TOL}")
    emit({"phase": "serve_health", **svc.health()})
    return main_path_launches, svc, first_kp, outputs["27 frames"]


def _memory(device):
    import torch
    if device.type != "cuda":
        return {}
    return {"allocated_bytes": torch.cuda.memory_allocated(device),
            "peak_bytes": torch.cuda.max_memory_allocated(device)}


def _reset_peak(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def serve_concurrent_phase(svc, seed: int, clients: int = SERVE_CLIENTS,
                           per_client: int = SERVE_PER_CLIENT,
                           frames: int = 27):
    """``clients`` threads x ``per_client`` requests of ``frames`` frames on
    the default tier, first with batching off (requests serialise: each is
    its lone run), then through the batcher.  Checks batch_calls <
    requests, every co-batched result within SERVE_TOL of its lone run,
    the launch counts, and that device memory returns to where it was (no
    graph kept alive by the dispatch threads).  Returns the launches."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.serve import LiftingService

    dev = svc.device
    on_card = dev.type == "cuda"
    model = svc.model
    per_chunk = _per_chunk(model, svc.default_op_point[1])
    rng = np.random.RandomState(seed + 1)
    n = clients * per_client
    reqs = [(_kp(rng, frames), seed + i) for i in range(n)]
    off = LiftingService(model, buckets=svc.buckets, dynamic_batching=False,
                         device=dev)

    def load(service):
        """Each client sends its requests one after another."""
        lat = [None] * n

        def client(c):
            out = {}
            for i in range(c, n, clients):
                kp, s = reqs[i]
                t0 = time.time()
                out[i] = service.lift(kp, seed=s)["poses"]
                lat[i] = (time.time() - t0) * 1e3
            return out

        stats0 = dict(service.stats)
        _reset_peak(dev)
        mem0 = _memory(dev)
        fused_block.launches = 0
        t0 = time.time()
        with ThreadPoolExecutor(clients) as ex:
            futs = [ex.submit(client, c) for c in range(clients)]
            poses = {}
            for f in futs:
                poses.update(f.result(timeout=600))
        wall = time.time() - t0
        launches = fused_block.launches
        mem1 = _memory(dev)
        calls = service.stats["batch_calls"] - stats0["batch_calls"]
        busy = service.stats["busy_seconds"] - stats0["busy_seconds"]
        r = {"requests": n, "clients": clients, "frames": frames,
             "wall_s": wall, "requests_per_s": n / wall,
             "frames_per_s": n * frames / wall, **_pcts(lat),
             "mean_ms": float(np.mean(lat)), "batch_calls": calls,
             "busy_s": busy, "busy_share": busy / wall,
             "launches": launches}
        if on_card:
            r.update(peak_bytes=mem1["peak_bytes"],
                     allocated_before=mem0["allocated_bytes"],
                     allocated_after=mem1["allocated_bytes"])
        return r, [poses[i] for i in range(n)]

    r_off, lone = load(off)
    emit({"phase": "serve_concurrent", "batching": "off", **r_off})
    r_on, batched = load(svc)
    err = max(float(np.abs(a - b).max()) for a, b in zip(batched, lone))
    emit({"phase": "serve_concurrent", "batching": "on", **r_on,
          "max_abs_err_vs_lone": err, "tol": SERVE_TOL})
    if not err <= SERVE_TOL:
        raise AssertionError(f"co-batched vs lone: {err} > {SERVE_TOL}")
    if not r_on["batch_calls"] < n:
        raise AssertionError(f"no co-batching: {r_on['batch_calls']} batch "
                             f"calls for {n} requests")
    if on_card:
        if r_off["launches"] != per_chunk * n:
            raise AssertionError(f"batching off: {r_off['launches']} "
                                 f"launches, expected {per_chunk * n}")
        # every co-batched call holds <= max(buckets) one-window rows: one
        # chunk
        if r_on["launches"] != per_chunk * r_on["batch_calls"]:
            raise AssertionError(f"batching on: {r_on['launches']} launches "
                                 f"for {r_on['batch_calls']} batch calls")
        # each client thread's first cuBLAS call allocates a workspace for
        # that thread's handle (PyTorch keeps one per handle, 33 MiB on the
        # H100), which stays for the process: the batching-off load runs on
        # `clients` fresh threads, the batcher on its one dispatch thread,
        # whose workspace exists already
        grown = r_off["allocated_after"] - r_off["allocated_before"]
        if grown > clients * CUBLAS_WORKSPACE_BOUND:
            raise AssertionError(f"batching off: device memory grew by "
                                 f"{grown} bytes under load")
        if r_on["allocated_after"] > r_on["allocated_before"] + (1 << 20):
            raise AssertionError(f"batching on: device memory grew under "
                                 f"load: {r_on}")
    return r_off["launches"] + r_on["launches"]


def serve_modes_phase(svc, kp27, poses27, seed: int):
    """A noise=device, readback=mean service with tiers ["10x5", "1x1"] (or
    the service's P x T and 1x1) on the same weights: warm-up, 27- and
    405-frame latencies per tier, host noise against device noise at 405
    frames (a host-noise mean service, interleaved), device-noise
    determinism, and the mean service's 27-frame poses against the 'all'
    service's host mean.  Returns (launches, the modes service)."""
    import numpy as np
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.serve import LiftingService

    dev = svc.device
    on_card = dev.type == "cuda"
    model = svc.model
    P, T = svc.default_op_point
    tiers = [f"{P}x{T}", "1x1"]
    rf = svc.receptive_field
    modes = LiftingService(model, buckets=svc.buckets, noise_mode="device",
                           readback="mean", op_points=tiers, device=dev)
    host = LiftingService(model, buckets=svc.buckets, noise_mode="host",
                          readback="mean", op_points=tiers, device=dev)
    launches = 0

    def run(service, kp, s, tier):
        nonlocal launches
        fused_block.launches = 0
        t0 = time.time()
        out = service.lift(kp, seed=s, op_point=tier)
        ms = (time.time() - t0) * 1e3
        n = fused_block.launches
        launches += n
        pt = service._resolve_op_point(tier)
        w = max(1, -(-kp.shape[0] // rf))
        want = _per_chunk(model, pt[1]) * -(-w // min(w, max(svc.buckets)))
        if on_card and n != want:
            raise AssertionError(f"serve_modes {tier}: {n} launches, "
                                 f"expected {want}")
        if out["poses"].shape != (kp.shape[0], 134, 3) or not np.all(
                np.isfinite(out["poses"])):
            raise AssertionError(f"serve_modes {tier}: bad poses")
        return out["poses"], ms

    fused_block.launches = 0
    t0 = time.time()
    modes.warmup()
    warm_s = time.time() - t0
    launches += fused_block.launches
    want = sum(_per_chunk(model, t) for _, t in modes.op_points) * len(
        modes.buckets)
    if on_card and fused_block.launches != want:
        raise AssertionError(f"serve_modes warmup: {fused_block.launches} "
                             f"launches, expected {want}")
    emit({"phase": "serve_modes_warmup", "seconds": warm_s,
          "launches": fused_block.launches})

    rng = np.random.RandomState(seed + 2)
    kp405 = _kp(rng, 405)
    for tier in tiers:
        lat = {}
        for label, kp in (("27", kp27), ("405", kp405)):
            a, ms1 = run(modes, kp, seed, tier)
            b, ms2 = run(modes, kp, seed, tier)
            c, ms3 = run(modes, kp, seed + 1, tier)
            if not np.array_equal(a, b):
                raise AssertionError(f"device noise, tier {tier}, {label} "
                                     "frames: same seed, other poses")
            if not np.abs(a - c).max() > 0:
                raise AssertionError(f"device noise, tier {tier}: another "
                                     "seed gave the same poses")
            lat[f"latency_{label}_ms"] = [ms1, ms2, ms3]
        emit({"phase": "serve_modes", "tier": tier, "noise": "device",
              "readback": "mean", **lat, "same_seed_bit_equal": True})

    # host vs device noise at 405 frames on the default tier, interleaved
    times = {"host": [], "device": []}
    for which in ("host", "device", "device", "host"):
        _, ms = run(host if which == "host" else modes, kp405, seed, tiers[0])
        times[which].append(ms)
    emit({"phase": "serve_modes_noise", "frames": 405, "tier": tiers[0],
          "host_ms": times["host"], "device_ms": times["device"]})

    mean27, _ = run(host, kp27, seed, tiers[0])
    err = float(np.abs(mean27 - poses27).max())
    emit({"phase": "serve_modes_mean", "max_abs_err_vs_host_mean": err,
          "tol": MEAN_TOL})
    if not err <= MEAN_TOL:
        raise AssertionError(f"mean readback vs host mean: {err} > {MEAN_TOL}")
    emit({"phase": "serve_modes_health", **modes.health()})
    host.close()
    return launches, modes


def serve_stream_phase(modes, seed: int, frames: int = STREAM_FRAMES,
                       sessions: int = 4):
    """One 1x1 session on ``modes`` pushing ``frames`` frames one at a time
    (latency per push), then ``sessions`` concurrent sessions pushing
    ``frames // 2`` frames each, co-batched through the tier's batcher
    (batch_calls < pushes) and each emit within SERVE_TOL of the same
    session run alone.  Returns the launches."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.serve import StreamingSession

    on_card = modes.device.type == "cuda"
    per_push = _per_chunk(modes.model, 1)
    rng = np.random.RandomState(seed + 3)
    kp = _kp(rng, frames)
    sess = StreamingSession(modes, seed=seed, op_point="1x1")
    fused_block.launches = 0
    lat = []
    for t in range(frames):
        out = sess.push(kp[t])
        lat.append(out["latency_ms"])
        if out["poses"].shape != (1, 134, 3) or not np.all(
                np.isfinite(out["poses"])):
            raise AssertionError("serve_stream: bad poses")
    launches = fused_block.launches
    if on_card and launches != per_push * frames:
        raise AssertionError(f"serve_stream: {launches} launches, expected "
                             f"{per_push * frames}")
    emit({"phase": "serve_stream", "sessions": 1, "pushes": frames,
          **_pcts(lat), "mean_ms": float(np.mean(lat)),
          "launches": launches})

    n = frames // 2
    streams = [_kp(rng, n) for _ in range(sessions)]

    def run_session(i):
        s = StreamingSession(modes, seed=seed + i, op_point="1x1",
                             per_frame_noise=True)
        res, ms = [], []
        for t in range(n):
            out = s.push(streams[i][t])
            res.append(out["poses"])
            ms.append(out["latency_ms"])
        return np.concatenate(res), ms

    lone = [run_session(i)[0] for i in range(sessions)]
    calls0 = modes.stats["batch_calls"]
    fused_block.launches = 0
    t0 = time.time()
    with ThreadPoolExecutor(sessions) as ex:
        futs = [ex.submit(run_session, i) for i in range(sessions)]
        done = [f.result(timeout=600) for f in futs]
    wall = time.time() - t0
    conc = fused_block.launches
    calls = modes.stats["batch_calls"] - calls0
    err = max(float(np.abs(d[0] - l).max()) for d, l in zip(done, lone))
    lat = [m for d in done for m in d[1]]
    emit({"phase": "serve_stream", "sessions": sessions,
          "pushes": sessions * n, "batch_calls": calls, "wall_s": wall,
          "pushes_per_s": sessions * n / wall, **_pcts(lat),
          "launches": conc, "max_abs_err_vs_lone": err, "tol": SERVE_TOL})
    if not err <= SERVE_TOL:
        raise AssertionError(f"co-batched streams vs lone: {err}")
    if not calls < sessions * n:
        raise AssertionError(f"streams did not co-batch: {calls} calls")
    if on_card and conc != per_push * calls:
        raise AssertionError(f"serve_stream: {conc} launches for {calls} "
                             "batch calls")
    return launches + conc


def serve_http_phase(seed: int, overrides=()):
    """cli.serve.build_service from the default config (full width, a seeded
    model) behind make_http_server(port=0): /healthz, a /lift equal bit for
    bit to the same request in-process, a stream round trip (create, push
    three frames, delete) and /metrics.  Returns the launches."""
    import threading
    import urllib.request
    import numpy as np
    from pafuse_tpu_torch import config as cfg_mod
    from pafuse_tpu_torch.cli.serve import build_service
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.serve import make_http_server

    args = cfg_mod.load_config(overrides=[f"gpu.seed={seed}", "serve.port=0",
                                          *overrides])
    svc = build_service(args, warmup=False)
    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def call(path, payload=None, method=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(f"{base}{path}", data=data,
                                     method=method)
        with urllib.request.urlopen(req, timeout=300) as r:
            body = r.read()
        return body if path == "/metrics" else json.loads(body)

    try:
        kp = _kp(np.random.RandomState(seed + 4), 27)
        fused_block.launches = 0
        if call("/healthz")["status"] != "ok":
            raise AssertionError("serve_http: /healthz not ok")
        t0 = time.time()
        out = call("/lift", {"keypoints": kp.tolist(), "seed": seed})
        http_ms = (time.time() - t0) * 1e3
        t0 = time.time()
        want = svc.lift(kp, seed=seed)["poses"]
        lift_ms = (time.time() - t0) * 1e3
        got = np.asarray(out["poses"], np.float32)
        if out["shape"] != [27, 134, 3] or not np.array_equal(got, want):
            raise AssertionError("serve_http: /lift differs from the same "
                                 "request in-process")
        sid = call("/stream", {"seed": seed, "delay": 2})["session"]
        pushed = call(f"/stream/{sid}", {"keypoints": kp[:3].tolist()})
        if pushed["shape"] != [3, 134, 3] or pushed["frame_indices"] != [
                0, 0, 0]:
            raise AssertionError(f"serve_http: stream push {pushed['shape']}"
                                 f" {pushed['frame_indices']}")
        closed = call(f"/stream/{sid}", method="DELETE")
        if closed != {"closed": True, "frames": 3}:
            raise AssertionError(f"serve_http: stream close {closed}")
        metrics = call("/metrics").decode()
        for line in ("pafuse_requests 2", "pafuse_stream_frames 3",
                     "pafuse_mesh_devices 1", "# TYPE pafuse_requests counter"):
            if line not in metrics.splitlines():
                raise AssertionError(f"serve_http: /metrics lacks {line!r}")
        launches = fused_block.launches
        per_chunk = _per_chunk(svc.model, svc.default_op_point[1])
        if svc.device.type == "cuda" and launches != 3 * per_chunk:
            raise AssertionError(f"serve_http: {launches} launches, expected "
                                 f"{3 * per_chunk}")
        emit({"phase": "serve_http", "http_lift_ms": http_ms,
              "inprocess_lift_ms": lift_ms, "launches": launches,
              "metrics_lines": len(metrics.splitlines())})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        svc.close()
    return launches


def serve_profile_phase(svc, modes, seed: int):
    """One 405-frame request under torch.profiler on the 'all' service
    (host noise) and on the modes service (device noise, mean): device time
    by kernel group and the idle share.  Returns the launches."""
    import numpy as np
    from pafuse_tpu_torch.ops.block import fused_block

    kp = _kp(np.random.RandomState(seed + 5), 405)
    launches = 0
    for label, service in (("host noise, readback all", svc),
                           ("device noise, readback mean", modes)):
        fused_block.launches = 0
        groups = profile_step(lambda: service.lift(kp, seed=seed),
                              phase="serve_profile", rest=SERVE_REST,
                              request="405 frames", service=label)
        if service.device.type == "cuda" and fused_block.launches == 0:
            raise AssertionError("serve_profile: kernel #1 did not launch")
        if (service.device.type == "cuda" and groups is not None
                and groups.get(ATTN_CORE_GROUP, 0.0) <= 0.0):
            raise AssertionError(f"serve_profile: kernel #1's attention is "
                                 f"not the tensor-core kernel: {groups}")
        launches += fused_block.launches
    return launches


def _random_block_params(C, g, dev):
    """The 14 block tensors (torch layout) from generator ``g``."""
    import torch

    def u(*shape, scale):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(dev)

    hid = 2 * C
    return (1 + u(C, scale=0.1), u(C, scale=0.1),
            u(3 * C, C, scale=C ** -0.5), u(3 * C, scale=C ** -0.5),
            u(C, C, scale=C ** -0.5), u(C, scale=C ** -0.5),
            1 + u(C, scale=0.1), u(C, scale=0.1),
            u(hid, C, scale=C ** -0.5), u(hid, scale=C ** -0.5),
            u(C, hid, scale=hid ** -0.5), u(C, scale=hid ** -0.5),
            1 + u(C, scale=0.1), u(C, scale=0.1))


def _rel_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


ROUTES = {1: "resident", 2: "streamed"}


def _stage_ok(got, want, qkv):
    """(within the stage's bound, max abs error): ATTN_CORE_TOL_F32 in
    float32, ATTN_CORE_TOL_BF16 x (|want| + max|v|) elementwise in
    bfloat16."""
    import torch
    diff = (got.float() - want).abs()
    if got.dtype == torch.float32:
        return bool(diff.max() <= ATTN_CORE_TOL_F32), float(diff.max())
    vmax = qkv[..., 2 * (qkv.shape[-1] // 3):].float().abs().max()
    return (bool((diff <= ATTN_CORE_TOL_BF16 * (want.abs() + vmax)).all()),
            float(diff.max()))


def attention_stage_row(qkv, heads, phase, **fields):
    """The attention forward alone (ops.attention_core on a (B, L, 3C) qkv
    in its dtype; in float32 the stage of #2 and #5) against its plain
    version (_stage_ok), a repeat bit for bit, and the route the library
    takes (its rule, and the streamed kernel's launches that its library
    counted in the first call: one where the rule streams, else none): ms,
    plain ms, library ms (library_sdpa on the same qkv) and the bound
    (4*B*L^2*C operations; qkv read once, the output written once)."""
    import torch
    from pafuse_tpu_torch.ops.attention_core import (attention_core,
                                                     attention_core_reference,
                                                     stream_launches, variant)
    B, L, C3 = qkv.shape
    C = C3 // 3
    name = "float32" if qkv.dtype == torch.float32 else "bfloat16"
    route = variant(name == "bfloat16", L, C // heads)
    stream_launches(zero=True)
    got = attention_core(qkv, heads)
    streamed = stream_launches(zero=True)["forward"]
    torch.cuda.synchronize()
    want = attention_core_reference(qkv, heads).float()
    ok, err = _stage_ok(got, want, qkv)
    repeat = bool(torch.equal(got, attention_core(qkv, heads)))
    del got, want
    q, k, v = qkv.view(B, L, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    r = {"phase": phase, "name": "attention_core", "dtype": name,
         **fields, "B": B, "L": L, "C": C, "route": ROUTES[route],
         "stream_launches": streamed, "max_abs_err": err,
         "deterministic": repeat,
         "ok": ok and repeat and streamed == int(route == 2),
         "ms": cuda_time_ms(lambda: attention_core(qkv, heads)),
         "plain_ms": cuda_time_ms(lambda: attention_core_reference(qkv, heads)),
         "library_ms": cuda_time_ms(lambda: library_sdpa(q, k, v)),
         **bound(4 * B * L * L * C, 4 * B * L * C * qkv.element_size(), name)}
    emit(r)
    return r


def _bwd_rel(got, want, C):
    """max|got - want| / max|want| for each of dq, dk and dv."""
    return [float((got[..., i * C:(i + 1) * C] - want[..., i * C:(i + 1) * C])
                  .abs().max() / want[..., i * C:(i + 1) * C].abs().max())
            for i in range(3)]


def attention_bwd_stage_row(qkv, do, heads, phase, **fields):
    """#6's attention backward alone (ops.attention_core_bwd) on float32 qkv
    (B, L, 3C) and dO (B, L, C) against its plain version (ATTN_BWD_RTOL x
    max|plain| for each of dq, dk, dv; a repeat bit for bit), and the route
    the library takes (its rule, and the launches of each streamed pass
    that its library counted in the first call): ms, plain ms, library ms
    (autograd through
    library_sdpa on the same qkv) and the bound (10*B*L^2*C operations; qkv
    and dO read once, dqkv written once)."""
    import torch
    from pafuse_tpu_torch.ops.attention_core import (
        attention_core_bwd, attention_core_bwd_reference, bwd_variant,
        stream_launches)
    B, L, C3 = qkv.shape
    C = C3 // 3
    route = bwd_variant(L, C // heads)
    stream_launches(zero=True)
    got = attention_core_bwd(qkv, do, heads)
    passes = stream_launches(zero=True)
    streamed = [passes["backward_a"], passes["backward_b"]]
    torch.cuda.synchronize()
    want = attention_core_bwd_reference(qkv, do, heads)
    rel = _bwd_rel(got, want, C)
    err = float((got - want).abs().max())
    repeat = bool(torch.equal(got, attention_core_bwd(qkv, do, heads)))
    del got, want
    q, k, v = (t.detach().requires_grad_() for t in qkv.view(
        B, L, 3, heads, C // heads).permute(2, 0, 3, 1, 4))
    o = library_sdpa(q, k, v)
    go = do.view(B, L, heads, C // heads).transpose(1, 2)
    r = {"phase": phase, "name": "attention_core_bwd", "dtype": "float32",
         **fields, "B": B, "L": L, "C": C, "route": ROUTES[route],
         "stream_launches": streamed, "max_abs_err": err,
         "max_rel_err": max(rel), "deterministic": repeat,
         "ok": (max(rel) <= ATTN_BWD_RTOL and repeat
                and streamed == [int(route == 2)] * 2),
         "ms": cuda_time_ms(lambda: attention_core_bwd(qkv, do, heads)),
         "plain_ms": cuda_time_ms(
             lambda: attention_core_bwd_reference(qkv, do, heads)),
         "library_ms": cuda_time_ms(lambda: torch.autograd.grad(
             o, (q, k, v), go, retain_graph=True)),
         **bound(10 * B * L * L * C, 28 * B * L * C, "float32")}
    emit(r)
    del q, k, v, o
    return r


GRAD_NAMES = ("dx", "norm1.weight", "norm1.bias", "qkv.weight", "qkv.bias",
              "proj.weight", "proj.bias", "norm2.weight", "norm2.bias",
              "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias",
              "outer.weight", "outer.bias")


def train_kernel_phase(seed: int, seqs: int, frames: int, keep: float = 0.9,
                       parts=None, phase="train_kernel"):
    """Kernels #5 and #6 against their plain versions at each network's
    spatial (B = seqs*frames, L = joints) and temporal (B = seqs*joints,
    L = frames) training shape (``parts`` as kernel_phase's), with x (and
    the backward's g) in float32 and in bfloat16; masks drawn per sample
    and repeated like MixSTE2 repeats them.  At each shape also their
    attention stages alone (float32 by contract): the forward
    (attention_stage_row) on the qkv the forward computes there (LN1(x) @
    Wqkv + bqkv) and the backward (attention_bwd_stage_row) on that qkv and
    a unit-variance dO."""
    import torch
    from pafuse_tpu_torch.ops.block_train import (block_train_bwd,
                                                  block_train_fwd,
                                                  train_bwd_reference,
                                                  train_fwd_reference)
    from pafuse_tpu_torch.ops.gemm import linear_reference
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device("cuda")
    heads = 8
    cases = []
    for part, N, C in parts or h3wb_parts():
        cases.append((part, "spatial", frames, N, C))
        cases.append((part, "temporal", N, frames, C))

    results = []
    for i, (part, kind, reps, L, C) in enumerate(cases):
        g = torch.Generator().manual_seed(seed * 100 + 50 + i)
        params = _random_block_params(C, g, dev)
        param_bytes = 4 * sum(t.numel() for t in params)
        B = seqs * reps
        masks = [((torch.rand(seqs, generator=g) < keep).float() / keep)
                 .repeat_interleave(reps).to(dev) for _ in range(2)]
        m1, m2 = masks
        x32 = torch.randn(B, L, C, generator=g).to(dev)
        g32 = torch.randn(B, L, C, generator=g).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            x = x32.to(dtype)
            y, saved = block_train_fwd(x, m1, m2, params, heads)
            sync(dev)           # a fault inside a kernel surfaces here
            want = train_fwd_reference(x, m1, m2, params, heads)
            diff = (y.float() - want.float()).abs()
            if dtype == torch.float32:
                ok = bool(diff.max() <= TRAIN_FWD_TOL)
            else:
                ok = bool(torch.all(diff <= 2.0 ** -7 * want.float().abs()
                                    + TRAIN_FWD_TOL))
            # the library composition runs in x's dtype throughout
            lib_p = [t.detach().to(dtype).requires_grad_() for t in params]
            lib_x = x.detach().requires_grad_()

            def lib_fwd():
                return library_block(lib_x, lib_p[:12], lib_p[12:], heads,
                                     m1, m2)

            ms = cuda_time_ms(lambda: block_train_fwd(x, m1, m2, params,
                                                      heads))
            plain_ms = cuda_time_ms(lambda: train_fwd_reference(
                x, m1, m2, params, heads))
            with torch.no_grad():
                lib_ms = cuda_time_ms(lib_fwd)
            r = {"phase": phase, "name": "block_train_fwd",
                 "part": part, "kind": kind, "dtype": name, "B": B, "L": L,
                 "C": C, "max_abs_err": float(diff.max()), "ok": ok,
                 "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 **(forward_gemm_times(B, L, params)
                    if dtype == torch.float32 else {}),
                 **train_bound(B, L, C, x.element_size(), param_bytes,
                               backward=False)}
            emit(r)
            results.append(r)

            gr = g32.to(dtype)
            dx, grads = block_train_bwd(saved, gr)
            sync(dev)
            want_dx, want_grads = train_bwd_reference(x, gr, m1, m2, params,
                                                      heads)
            got_all, want_all = (dx,) + grads, (want_dx,) + want_grads
            rel = {n: _rel_err(a, b)
                   for n, a, b in zip(GRAD_NAMES, got_all, want_all)}
            dx_ok = True
            if dtype != torch.float32:
                # dx rounded to bfloat16 from float32 values ~1e-6 apart:
                # one ulp of the value plus the float32 bound
                del rel["dx"]
                dx_ok = bool(torch.all(
                    (dx.float() - want_dx.float()).abs()
                    <= 2.0 ** -7 * want_dx.float().abs()
                    + TRAIN_GRAD_RTOL * want_dx.float().abs().max()))
            max_abs = max(float((a - b).abs().max())
                          for a, b in zip(got_all, want_all))
            dx2, grads2 = block_train_bwd(saved, gr)
            deterministic = all(torch.equal(a, b) for a, b in
                                zip(got_all, (dx2,) + grads2))
            ms = cuda_time_ms(lambda: block_train_bwd(saved, gr))
            plain_ms = cuda_time_ms(lambda: train_bwd_reference(
                x, gr, m1, m2, params, heads))
            y_lib = lib_fwd()
            lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
                y_lib, [lib_x] + lib_p, gr, retain_graph=True))
            gemms = ({**backward_gemm_times(B * L, params),
                      **ln_backward_times(B, L, params)}
                     if dtype == torch.float32 else {})
            r = {"phase": phase, "name": "block_train_bwd",
                 "part": part, "kind": kind, "dtype": name, "B": B, "L": L,
                 "C": C, "max_abs_err": max_abs,
                 "max_rel_grad_err": max(rel.values()), "rel_grad_err": rel,
                 "deterministic": deterministic, "dx_ok": dx_ok,
                 "ok": (max(rel.values()) <= TRAIN_GRAD_RTOL and deterministic
                        and dx_ok and gemms.get("wgrad_ok", True)
                        and gemms.get("lnb_ok", True)),
                 "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 **gemms,
                 **train_bound(B, L, C, x.element_size(), param_bytes,
                               backward=True)}
            emit(r)
            results.append(r)
            del y_lib, dx, grads, dx2, grads2, want_dx, want_grads
        del x32, g32, x, y, saved, want, diff, lib_x, lib_p
        torch.cuda.empty_cache()
        qkv = linear_reference(torch.randn(B, L, C, generator=g).to(dev),
                               params[2], params[3], params[0:2])
        fields = {"part": part, "kind": kind, "shapes": "train"}
        results.append(attention_stage_row(qkv, heads, phase, **fields))
        do = torch.randn(B, L, C, generator=g).to(dev)
        results.append(attention_bwd_stage_row(qkv, do, heads, phase,
                                               **fields))
        del qkv, do
        torch.cuda.empty_cache()
    return results


def forward_gemm_times(B, L, params):
    """Kernel #5's GEMMs alone on B*L rows of random float32 operands, as
    its forward runs them (ops.block_train.fwd_linear, wgmma): qkv, proj
    with the masked residual, fc1 with (u, gelu(u)), fc2 with the masked
    residual; their ms and TFLOP/s (2*M*N*K per product) beside cuBLAS's
    F.linear with bias for the same four products."""
    import torch
    import torch.nn.functional as F
    from pafuse_tpu_torch.ops.block_train import fwd_linear
    M = B * L
    wqkv, wproj, wfc1, wfc2 = params[2], params[4], params[8], params[10]
    dev = wqkv.device
    g = torch.Generator(device=dev).manual_seed(M + 1)
    rows = lambda n: torch.randn(M, n, generator=g, device=dev)  # noqa: E731
    mask = (torch.rand(B, generator=g, device=dev) < 0.9).float() / 0.9
    calls = [(rows(w.shape[1]), w, b, epi, rows(w.shape[0]) if epi == "residual"
              else None) for w, b, epi in ((wqkv, params[3], "store"),
                                           (wproj, params[5], "residual"),
                                           (wfc1, params[9], "gelu"),
                                           (wfc2, params[11], "residual"))]
    flop = sum(2 * M * w.numel() for w in (wqkv, wproj, wfc1, wfc2))
    times = {
        "fgemm_ms": cuda_time_ms(lambda: [fwd_linear(a, w, b, epi, r, mask, L)
                                          for a, w, b, epi, r in calls]),
        "fgemm_library_ms": cuda_time_ms(
            lambda: [F.linear(a, w, b) for a, w, b, _, _ in calls]),
    }
    del calls
    return {**times, **{k.replace("_ms", "_tflops"): flop / v / 1e9
                        for k, v in times.items()}}


def backward_gemm_times(M, params):
    """Kernel #6's GEMMs alone on M rows of random float32 operands, as its
    backward runs them: the four data gradients (ops.block_train.data_grad,
    wgmma; fc2 with the GELU' epilogue) and the four weight gradients with
    their bias gradients (weight_grads, wgmma, with the ordered pass), each
    group's ms and TFLOP/s (2*M*N*K per product) beside cuBLAS's a @ w, and
    d^T @ x plus d.sum(0); for the weight gradients also the plain version's
    time (weights_grads_reference), the bound (2*M*N*K operations; d and x
    read, dW and db written) and each product's dW and db against the plain
    version: the largest max|got - plain| / max|plain| (wgrad_ok within
    WGRAD_RTOL) and max abs error."""
    import torch
    from pafuse_tpu_torch.ops.block_train import (data_grad, weight_grads,
                                                  weight_grads_reference)
    wqkv, wproj, wfc1, wfc2 = params[2], params[4], params[8], params[10]
    g = torch.Generator(device=wqkv.device).manual_seed(M)
    rows = lambda n: torch.randn(M, n, generator=g, device=wqkv.device)  # noqa: E731
    # (weight, aux width or None): du = dm wfc2 * gelu'(u), dh2 = du wfc1,
    # dO = da wproj, dh1 = dqkv wqkv; the weight gradients pair each
    # gradient with the activation of the other side
    dgrad = [(rows(w.shape[0]), w, rows(w.shape[1]) if w is wfc2 else None)
             for w in (wfc2, wfc1, wproj, wqkv)]
    wgrad = [(rows(w.shape[0]), rows(w.shape[1]))
             for w in (wfc2, wfc1, wproj, wqkv)]
    flop = sum(2 * M * w.numel() for w in (wfc2, wfc1, wproj, wqkv))
    times = {
        "dgrad_ms": cuda_time_ms(lambda: [data_grad(*a) for a in dgrad]),
        "dgrad_library_ms": cuda_time_ms(
            lambda: [a @ w for a, w, _ in dgrad]),
        "wgrad_ms": cuda_time_ms(lambda: [weight_grads(*a) for a in wgrad]),
        "wgrad_library_ms": cuda_time_ms(
            lambda: [(d.t() @ x, d.sum(0)) for d, x in wgrad]),
    }
    rel, err = 0.0, 0.0
    for d, x in wgrad:
        for a, b in zip(weight_grads(d, x), weight_grads_reference(d, x)):
            rel = max(rel, _rel_err(a, b))
            err = max(err, float((a - b).abs().max()))
    plain_ms = cuda_time_ms(lambda: [weight_grads_reference(*a) for a in wgrad])
    nbytes = sum(4 * (M * (d.shape[1] + x.shape[1]) + d.shape[1] * (x.shape[1] + 1))
                 for d, x in wgrad)
    wb = bound(flop, nbytes, "float32")
    del dgrad, wgrad
    return {**times, **{k.replace("_ms", "_tflops"): flop / v / 1e9
                        for k, v in times.items()},
            "wgrad_plain_ms": plain_ms, "wgrad_max_rel_err": rel,
            "wgrad_max_abs_err": err, "wgrad_ok": rel <= WGRAD_RTOL,
            **{f"wgrad_{k}": v for k, v in wb.items()}}


def ln_backward_times(B, L, params):
    """Kernel #6's LayerNorm backward alone on B*L rows of random float32
    operands, in the three forms its backward runs (ops.block_train.
    ln_backward): the outer norm (g, x2, dx2 and dm = m2 * dx2), LN2 (the
    residual dx2 added, da = m1 * dx1) and LN1 (the residual dx1 added);
    the three calls' device ms (device_ms) beside the plain version's
    (ln_backward_reference) and the library composition's (aten's
    native_layer_norm_backward, the residual add and the mask multiply;
    CUDA events),
    the bound (bytes: g, x, the residual read, dx and dxm written, the row
    statistics, the mask, the scale and the partials), every output's
    largest max|got - plain| / max|plain| (lnb_ok within LNB_RTOL), max
    abs error and whether a repeat gives the same bits."""
    import torch
    from pafuse_tpu_torch.ops.block_train import (ln_backward,
                                                  ln_backward_reference,
                                                  ln_backward_rows)
    M, C = B * L, params[0].shape[0]
    dev = params[0].device
    g = torch.Generator(device=dev).manual_seed(M + 2)
    rows = lambda: torch.randn(M, C, generator=g, device=dev)  # noqa: E731
    x, gr, res = rows(), rows(), rows()
    mean, rstd = x.mean(1), torch.rsqrt(x.var(1, unbiased=False) + 1e-6)
    mask = (torch.rand(B, generator=g, device=dev) < 0.9).float() / 0.9
    calls = [((gr, x, mean, rstd, params[12]), {"mask": mask}),
             ((gr, x, mean, rstd, params[6]), {"residual": res, "mask": mask}),
             ((gr, x, mean, rstd, params[0]), {"residual": res})]
    zero = torch.zeros(C, device=dev)

    def library(a, kw):
        dx, ds, db = torch.ops.aten.native_layer_norm_backward(
            a[0], a[1], [C], mean[:, None], rstd[:, None], a[4], zero,
            [True, True, True])
        if "residual" in kw:
            dx = kw["residual"] + dx
        if "mask" in kw:
            return dx, dx.view(B, L, C) * kw["mask"][:, None, None], ds, db
        return dx, ds, db

    rel, err, repeat = 0.0, 0.0, True
    for a, kw in calls:
        got = ln_backward(*a, seq_len=L, **kw)
        again = ln_backward(*a, seq_len=L, **kw)
        want = ln_backward_reference(*a, seq_len=L, **kw)
        for u, v, w in zip(got, again, want):
            if w is not None:
                rel = max(rel, _rel_err(u, w))
                err = max(err, float((u - w).abs().max()))
                repeat = repeat and bool(torch.equal(u, v))
    # the kernels' device time (the wrapper's host work is about as long
    # as its kernels); the plain version's and the library's few large
    # PyTorch calls keep the device busy, so CUDA events time them
    times = {
        "lnb_ms": device_ms(lambda: [ln_backward(*a, seq_len=L, **kw)
                                     for a, kw in calls]),
        "lnb_plain_ms": cuda_time_ms(lambda: [ln_backward_reference(
            *a, seq_len=L, **kw) for a, kw in calls]),
        "lnb_library_ms": cuda_time_ms(lambda: [library(a, kw)
                                                for a, kw in calls]),
    }
    parts = -(-M // ln_backward_rows(M, C))
    nbytes = ((16 + 20 + 16) * M * C + 3 * (8 * M + 12 * C + 16 * parts * C)
              + 2 * 4 * B)
    del x, gr, res, calls
    return {**times, "lnb_max_rel_err": rel, "lnb_max_abs_err": err,
            "lnb_deterministic": repeat,
            "lnb_ok": rel <= LNB_RTOL and repeat,
            **{f"lnb_{k}": v for k, v in bound(3 * 14 * M * C, nbytes,
                                                "float32").items()}}


def lnb_cases(cases):
    """The float32 block_train_bwd rows of ``cases`` as rows of #6's
    LayerNorm backward alone (ln_backward_times' lnb_* numbers)."""
    return [{"dtype": "float32", "kind": c.get("kind"), "B": c["B"],
             "L": c["L"], "C": c["C"],
             **{k: c[f"lnb_{k}"] for k in ("max_abs_err", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "simt_bound_ms", "library_ms")},
             "ms": c["lnb_ms"]}
            for c in cases
            if c["name"] == "block_train_bwd" and c["dtype"] == "float32"]


def _synthetic_batches(seed: int, seqs: int, frames: int):
    """Synthetic H3WB (S1, S5, S6, S7) through fetch, ChunkedSampler
    (shuffle, flip augmentation) and PrefetchingLoader, as the H3WB CLI
    wires them; returns (loader, sampler)."""
    from pafuse_tpu_torch.data import h3wb
    from pafuse_tpu_torch.data.prefetch import PrefetchingLoader
    from pafuse_tpu_torch.data.sampling import ChunkedSampler

    subjects = ["S1", "S5", "S6", "S7"]
    dataset = h3wb.load_dataset(synthetic=True, subjects=tuple(subjects),
                                seed=seed)
    keypoints = h3wb.prepare_data(dataset)
    cams, poses_3d, poses_2d = h3wb.fetch(subjects, keypoints, dataset)
    sampler = ChunkedSampler(seqs, cams, poses_3d, poses_2d, frames,
                             shuffle=True, augment=True,
                             flip_permutation=dataset.flip_permutation)
    return PrefetchingLoader(sampler, depth=2), sampler


def train_phase(seed: int, device: str = "cuda", depth: int = 8,
                seqs: int = TRAIN_SEQS, steps: int = TRAIN_STEPS, kinds=None):
    """The H3WB trainer at full width (the defaults; a CPU rehearsal passes
    device="cpu" and a smaller depth and batch).  Returns the kernel
    launches of the main-path run; the attention kernels' launches in it,
    as their libraries count them, go into ``kinds`` when given a dict (on
    the card the backward's mma.sync kernel must run: every H3WB shape is
    up to 80 keys)."""
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DPConfig

    cfg = D3DPConfig(depth=depth, drop_path_rate=0.1)
    loader, sampler = _synthetic_batches(seed, seqs, cfg.frames)
    kinds = {} if kinds is None else kinds
    launches = run_trainer(seed, device, cfg, loader, sampler, seqs, steps,
                           weights=tr.mixste_weight_table(cfg.num_kps),
                           phase="train", streams=kinds)
    if device != "cpu" and not kinds["backward_tc"]:
        raise AssertionError(f"train: the resident attention backward did "
                             f"not run on the main path: {kinds}")
    return launches


def dhp3_train_phase(seed: int, device: str = "cuda", depth: int = 8,
                     seqs: int = TRAIN_SEQS, steps: int = TRAIN_STEPS,
                     train_seqs: int = DHP3_TRAIN_SEQS,
                     frames: int = DHP3_FRAMES, kinds=None):
    """The 3DHP trainer at full width (cli.main_3dhp's model: monolithic,
    17 joints, model.cs 288, depth 8, mm_scale, unweighted MPJPE in mm) on
    dhp3.make_synthetic(num_train_seqs=16, frames=1000) through
    ChunkedSampler (augment, the 3DHP flip table) and PrefetchingLoader,
    37 sequences a step.  Returns the kernel launches of the main-path
    run; the attention kernels' launches in it go into ``kinds`` (a dict;
    on the card the backward's mma.sync kernel must run)."""
    from pafuse_tpu_torch import skeleton as sk
    from pafuse_tpu_torch.data import dhp3
    from pafuse_tpu_torch.data.prefetch import PrefetchingLoader
    from pafuse_tpu_torch.data.sampling import ChunkedSampler
    from pafuse_tpu_torch.diffusion import D3DPConfig

    cfg = D3DPConfig(num_kps=sk.NUM_JOINTS_3DHP, cs=DHP3_CS, depth=depth,
                     part_based=False, mm_scale=True, drop_path_rate=0.1)
    train, _ = dhp3.make_synthetic(num_train_seqs=train_seqs, frames=frames,
                                   seed=seed)
    p3, p2 = dhp3.train_arrays(train)
    sampler = ChunkedSampler(seqs, None, p3, p2, cfg.frames, augment=True,
                             flip_permutation=sk.FLIP_PERMUTATION_3DHP)
    kinds = {} if kinds is None else kinds
    launches = run_trainer(seed, device, cfg, PrefetchingLoader(sampler, depth=2),
                           sampler, seqs, steps, part_based=False,
                           flip_permutation=sk.FLIP_PERMUTATION_3DHP,
                           phase="dhp3_train", streams=kinds)
    if device != "cpu" and not kinds["backward_tc"]:
        raise AssertionError(f"dhp3_train: the resident attention backward "
                             f"did not run on the main path: {kinds}")
    return launches


def run_trainer(seed, device, cfg, loader, sampler, seqs, steps, *,
                weights=None, part_based=True, flip_permutation=None,
                phase="train", compute_dtype="float32", profile=True,
                streams=None, profile_groups=None):
    """The checks of a training path: ``steps`` steps through ``loader``
    (finite losses, 2 x depth launches of #5 and of #6 per network a step,
    every parameter moved; ms/step and trained frames/s), one step traced
    (``profile``), two runs from one seed bit-identical after two steps,
    one step against the same step on the plain versions (float32 bounds,
    or the bfloat16 ones at ``compute_dtype=bfloat16``), and the loss
    falling on one repeated batch.  Returns the launches of the main-path
    run; the streamed attention kernels' launches in it, as their libraries
    count them (ops.attention_core.stream_launches), go into ``streams``
    when given a dict, with the resident attention kernels' (``forward_tc``,
    ``forward_wg``, ``backward_tc``, ``backward_wg``).  The profiled step must also show the groups
    ``profile_groups`` (by default the resident attention backward's: a
    model whose every backward streams, as MixSTE's, names its own)."""
    import numpy as np
    import torch
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DP
    from pafuse_tpu_torch.models.mixste import MixSTE2
    from pafuse_tpu_torch.ops import _build
    from pafuse_tpu_torch.ops.attention_core import stream_launches
    from pafuse_tpu_torch.ops.block_train import (block_train_bwd,
                                                  block_train_fwd,
                                                  block_train_plain)
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device(device)
    lr, lr_decay = 6e-5, 0.993

    def fresh():
        model = D3DP(cfg, device=dev,
                     generator=torch.Generator().manual_seed(seed),
                     flip_permutation=flip_permutation,
                     compute_dtype=compute_dtype)
        state = tr.create_train_state(model, seed=seed, device=dev)
        return model, state, tr.build_train_step(
            model, state.optimizer, weights=weights, part_based=part_based)

    model, state, step = fresh()
    part_names = [spec.name for spec in model.pose_estimator.specs]
    per_step = 2 * len(part_names) * cfg.depth if dev.type == "cuda" else 0
    before = [p.detach().clone() for p in model.parameters()]

    # main path: steps through the loader, lr decayed per epoch as the CLI
    block_train_fwd.launches = block_train_bwd.launches = 0
    if dev.type == "cuda":
        stream_launches(zero=True)
        _build.kernel_launches("block_train", zero=True)
    losses, step_s, batches = [], [], []
    while len(losses) < steps:
        for _, b3d, b2d in loader.next_epoch():
            b2d, _ = tr.pad_batch(b2d, seqs)
            b3d, _ = tr.pad_batch(b3d, seqs)
            batches.append((b2d, b3d))
            t0 = time.time()
            loss = float(step(state, lr, b2d, b3d))    # waits for the step
            step_s.append(time.time() - t0)
            losses.append(loss)
            if len(losses) == steps:
                break
        else:
            lr *= lr_decay
    launches = (block_train_fwd.launches, block_train_bwd.launches)
    streamed = stream_launches() if dev.type == "cuda" else {}
    # the resident attention stages, as their libraries count them: the
    # forward (mma.sync; float32 at 81-144 keys wgmma) and the backward
    # (mma.sync up to 80 keys, wgmma past at d <= 48)
    if dev.type == "cuda":
        bwd = _build.kernel_launches("attention_core_bwd")
        fwd = _build.kernel_launches("attention_core")
        wg = {"forward_tc": fwd["attention_tc"], "forward_wg": fwd["attention_wg"],
              "backward_tc": bwd["attention_bwd_tc"],
              "backward_wg": bwd["attention_bwd_wg"]}
    else:
        wg = {}
    # #6's weight- and bias-gradient kernel and its ordered pass: four
    # launches each a call; its LayerNorm backward and that one's ordered
    # pass: three each
    ours = (_build.kernel_launches("block_train") if dev.type == "cuda"
            else dict.fromkeys(_build.LAUNCH_KINDS, 0))
    wgrad = WGRAD_LAUNCHES[phase] = ours["wgrad_wgmma"]
    lnb = LNB_LAUNCHES[phase] = ours["ln_bwd"]
    if wgrad != 4 * launches[1] or ours["reduce_partials"] != wgrad:
        raise AssertionError(f"{phase}: {wgrad} launches of the weight-"
                             f"gradient kernel and {ours['reduce_partials']} of "
                             f"its ordered pass, expected {4 * launches[1]} "
                             f"of each")
    if lnb != 3 * launches[1] or ours["ln_sums"] != lnb:
        raise AssertionError(f"{phase}: {lnb} launches of the LayerNorm "
                             f"backward and {ours['ln_sums']} of its ordered "
                             f"pass, expected {3 * launches[1]} of each")
    if streams is not None:
        streams.update(streamed, **wg)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if launches != (per_step * steps, per_step * steps):
        raise AssertionError(f"{phase}: launches {launches}, expected "
                             f"{per_step * steps} of each")
    still = [n for (n, p), b in zip(model.named_parameters(), before)
             if torch.equal(p.detach(), b)]
    if still:
        raise AssertionError(f"{phase}: parameters did not move: {still[:5]}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2] if steps > 1 else step_s[0]
    emit({"phase": phase, "steps": steps, "seqs_per_step": seqs,
          "compute_dtype": compute_dtype,
          "frames": cfg.frames, "depth": cfg.depth, "joints": cfg.num_kps,
          "networks": part_names, "losses": losses,
          "launches_fwd": launches[0], "launches_bwd": launches[1],
          "wgrad_launches": wgrad, "stream_launches": streamed,
          "wg_launches": wg, "step_s": step_s, "ms_per_step": steady * 1e3,
          "frames_per_s": seqs * cfg.frames / steady,
          "batches_per_epoch": sampler.batch_num(),
          "max_memory_gb": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None)})
    if dev.type == "cuda" and profile:
        groups = profile_step(lambda: float(step(state, lr, *batches[-1])),
                              phase=f"{phase}_profile", names=TRAIN_GROUPS)
        expected = (ATTN_BWD_GROUP,) if profile_groups is None else profile_groups
        missing = ({g for _, g in TRAIN_GROUPS[:2]} | {ATTN_CORE_GROUP}
                   | set(expected)) - set(groups or {})
        if groups and missing:
            raise AssertionError(f"{phase}: the profile shows no {missing}: "
                                 f"{sorted(groups)}")
    del model, state, step, before

    # two runs from one seed: bit-identical losses and params after 2 steps
    runs = []
    for _ in range(2):
        model, state, step = fresh()
        run_losses = [float(step(state, lr, *batches[i])) for i in range(2)]
        runs.append((run_losses, [p.detach().clone()
                                  for p in model.parameters()]))
        del model, state, step
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    emit({"phase": f"{phase}_determinism", "losses": [r[0] for r in runs],
          "bit_identical": same})
    if not same:
        raise AssertionError(f"{phase}: two runs from one seed differ")
    del runs

    # one step through the kernels vs the same step on the plain versions,
    # from equal params with equal t, noise and masks
    g = torch.Generator().manual_seed(seed + 1)
    b2d, b3d = batches[0]
    t = torch.randint(0, cfg.timesteps, (seqs,), generator=g)
    noise = torch.randn(b3d.shape, generator=g)
    masks = {part: [tuple((torch.rand(seqs, generator=g) < 0.9).float()
                          / 0.9 for _ in range(2))
                    for _ in range(2 * cfg.depth)]
             for part in part_names}
    out = []
    for plain in (False, True):
        model, state, step = fresh()
        if plain:
            for m in model.modules():
                if isinstance(m, MixSTE2):
                    m.train_block_fn = block_train_plain
        loss = float(step(state, lr, b2d, b3d, t=t.to(dev),
                          noise=noise.to(dev), masks=masks))
        sync(dev)
        out.append((loss, {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}))
        del model, state, step
    (k_loss, k_grads), (p_loss, p_grads) = out
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    grad_err = max(_rel_err(k_grads[n], p_grads[n]) for n in p_grads)
    loss_tol, grad_tol = ((TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL)
                          if compute_dtype == "float32"
                          else (BF16_TRAIN_LOSS_RTOL, BF16_TRAIN_GRAD_RTOL))
    emit({"phase": f"{phase}_vs_plain", "loss": k_loss, "plain_loss": p_loss,
          "loss_rel_err": loss_err, "max_rel_grad_err": grad_err,
          "loss_rtol": loss_tol, "grad_rtol": grad_tol})
    if not (loss_err <= loss_tol and grad_err <= grad_tol):
        raise AssertionError(f"{phase}: kernel path vs plain path: loss "
                             f"{loss_err:.2e}, grads {grad_err:.2e}")
    del out, k_grads, p_grads

    # one repeated batch (equal t, noise and masks every step) at lr 1e-3:
    # Adam's first steps overshoot (the loss jumps, then falls), so the
    # check is the mean of the last four losses against the first
    model, state, step = fresh()
    fit = [float(step(state, 1e-3, b2d, b3d, t=t.to(dev),
                      noise=noise.to(dev), masks=masks))
           for _ in range(OVERFIT_STEPS)]
    emit({"phase": f"{phase}_overfit", "lr": 1e-3, "losses": fit})
    if not np.mean(fit[-4:]) < fit[0]:
        raise AssertionError(f"{phase}: loss did not fall on one batch: "
                             f"{fit}")
    del model, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


#: the profiles' group of PyTorch's copy kernels (.contiguous() of a
#: transposed tensor, dtype and device copies)
COPY_GROUP = "copies (transposes, .contiguous())"
ATTN_CORE_GROUP = "attention (#1-#5, tensor cores)"
ATTN_BWD_GROUP = "attention backward (#6, tensor cores)"
ATTN_STREAM_GROUP = "attention, streamed (#1-#5, tensor cores)"
ATTN_BWD_STREAM_GROUP = "attention backward, streamed (#6, passes A and B)"

#: kernel-name patterns of the port's CUDA sources (and PyTorch's copies and
#: cuBLAS), for the profiles; the first pattern found in a kernel's name
#: names its group
KERNEL_GROUPS = (("copy_kernel", COPY_GROUP),
                 (r"sm90::gemm_(bf16_)?kernel", "wgmma GEMMs (#1, #3, #4)"),
                 ("sm90::split_weights_t", "transposed weight splits (#6)"),
                 ("sm90::split_weights", "weight splits (#1, #3, #4)"),
                 ("sm90::row_stats", "row statistics (#1, #3, #4)"),
                 ("wgrad_wgmma_kernel",
                  "weight and bias gradients (#6, wgmma)"),
                 ("attention_bwd_(tc|wg)_kernel", ATTN_BWD_GROUP),
                 ("attention_bwd_stream_[ab]_kernel", ATTN_BWD_STREAM_GROUP),
                 ("attention_(tc|wg)_kernel", ATTN_CORE_GROUP),
                 ("attention_stream_kernel", ATTN_STREAM_GROUP),
                 ("bf16_to_f32_kernel", "bfloat16 x to float32 (#2)"),
                 ("layernorm_kernel", "outer LayerNorm (#1, #3, #4)"),
                 ("layernorm_bf16_kernel",
                  "bf16 LayerNorms (#1, #3, #4: pre-passes and outer)"),
                 ("ln_bwd_kernel", "LayerNorm backward"),
                 ("ln_fwd_kernel", "LayerNorm forward"),
                 ("reduce_partials_kernel|ln_sums_kernel",
                  "ordered partial sums"),
                 ("gemm", "cuBLAS GEMMs"))


#: the training step's wgmma GEMMs by the epilogue, the last template
#: argument of their name: #5's forward products (EPI_STORE 0,
#: EPI_MASK_RESIDUAL 5, EPI_STORE_GELU 6) and #6's data gradients (EPI_NONE
#: 3, EPI_GELU_GRAD 4); the plain weight splits are #5's
TRAIN_GROUPS = ((r"sm90::gemm_kernel<[^>]*\D[056]>", "forward GEMMs (#5, wgmma)"),
                (r"sm90::gemm_kernel<[^>]*\D[34]>",
                 "data-gradient GEMMs (#6, wgmma)"),
                ("sm90::split_weights_kernel", "weight splits (#5)"))
#: a use_pallas=true step's wgmma GEMMs and weight splits are #2's
EVAL_TRUE_GROUPS = (("sm90::gemm_kernel", "#2's GEMMs (wgmma)"),
                    ("sm90::split_weights", "#2's weight splits"))


def kernel_group(key, names=(), rest=None):
    """The profile group of a CUDA kernel named ``key``: that of the first
    pattern (a regular expression) of ``names``, then of KERNEL_GROUPS,
    found in it; else ``rest``."""
    return next((g for pat, g in tuple(names) + KERNEL_GROUPS
                 if re.search(pat, key)), rest)


#: the CUDA runtime and driver calls that launch a kernel, as the profiler
#: names them on the host
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def library_launches():
    """The kernel launches that the port's libraries counted where they
    launched them, by kind (``ops._build.LAUNCH_KINDS``), summed over every
    library."""
    from pafuse_tpu_torch.ops import _build
    total = {}
    for name in _build.KERNELS:
        for kind, n in _build.kernel_launches(name).items():
            total[kind] = total.get(kind, 0) + n
    return total


def traced(run):
    """``run()`` once under torch.profiler (host and device): returns (the
    profile's device events by name as {name: (device ms, count)}, what it
    dropped, the host ms of the run, profiler overhead included, and the
    annotations left out, as the events).

    The device events are kernels, copies and fills; not the GPU user
    annotations (a host range such as ``Optimizer.step#AdamW.step`` drawn
    on the device's timeline, which holds no work of its own).  A profile
    can lose kernel records (late profiles of a long process do), so each
    is counted against an independent tally: what the port's libraries counted during the run
    (library_launches, read before and after; the counts are not zeroed),
    kind by kind against the profile's kernels of that name; and every
    launch call the host made (the port's, PyTorch's and cuBLAS's) against
    the profile's kernels (dropped_kernels: {} when the profile is
    whole)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    before = library_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    counted = {k: n - before[k] for k, n in library_launches().items()}
    avgs = prof.key_averages()
    host = {e.key for e in avgs if e.device_type == cpu}
    events, annotations = {}, {}
    for e in avgs:
        if e.device_type == cuda and e.self_device_time_total > 0:
            into = (annotations if getattr(e, "is_user_annotation", False)
                    or e.key in host else events)
            into[e.key] = (e.self_device_time_total / 1e3, e.count)
    calls = sum(e.count for e in avgs
                if e.device_type == cpu and e.key in LAUNCH_CALLS)
    return events, dropped_kernels(events, counted, calls), wall_ms, annotations


def dropped_kernels(events, counted, calls):
    """What a profile dropped: for each kind of ``counted`` (the launches
    the port's libraries counted, by ``ops._build.LAUNCH_KINDS``), the
    launches beyond the profile's kernels named "<kind>_kernel", and the
    host's ``calls`` of LAUNCH_CALLS beyond all its kernels ("launch
    calls"); ``events``: {name: (device ms, count)}, whose copies and fills
    (Memcpy, Memset) are no kernels.  {} when nothing is missing."""
    kernels = {k: c for k, (_, c) in events.items()
               if not k.startswith(("Memcpy", "Memset"))}
    dropped = {}
    for kind, n in counted.items():
        seen = sum(c for k, c in kernels.items()
                   if re.search(rf"\b{kind}_kernel\b", k))
        if seen < n:
            dropped[kind] = n - seen
    if sum(kernels.values()) < calls:
        dropped["launch calls"] = calls - sum(kernels.values())
    return dropped


def profile_step(run_step, phase="train_profile",
                 rest="PyTorch (embedding, head, loss, AdamW)", names=(),
                 **fields):
    """``run_step`` under torch.profiler (``traced``): device time by kernel
    group (the port's kernels by source pattern, ``names`` before
    KERNEL_GROUPS, PyTorch's copy kernels, cuBLAS, the rest as ``rest``),
    the copies' device time and the device's idle share of its wall time
    (host clock, profiler overhead included), emitted with ``fields``.  A
    profile that dropped kernels is taken once more; if that one drops
    kernels too, it is reported as such, unread, and None is returned.
    ``run_step`` ends by reading a result from the device."""
    for attempt in range(2):
        events, dropped, wall_ms, _ = traced(run_step)
        if not dropped:
            break
        emit({"phase": phase, **fields, "attempt": attempt,
              "profile": "dropped kernels", "dropped": dropped})
    if dropped:
        return None
    groups = {}
    for key, (ms, _) in events.items():
        group = kernel_group(key, names, rest)
        groups[group] = groups.get(group, 0.0) + ms
    device_ms = sum(groups.values())
    emit({"phase": phase, **fields, "wall_ms": wall_ms,
          "device_ms": device_ms if events else "not measured",
          "copies_ms": groups.get(COPY_GROUP, 0.0) if events
          else "not measured",
          "idle_share": 1 - device_ms / wall_ms if events else "not measured",
          "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
          "kernel_launches": sum(c for _, c in events.values())})
    return groups


def library_attention(x, wqkv, bqkv, wproj, bproj, num_heads):
    """The attention as PyTorch library calls in x's dtype (cuBLAS linear,
    library_sdpa, linear): the yardstick ``library_ms`` of kernel #2.  The
    port never calls it."""
    import torch.nn.functional as F
    B, L, C = x.shape
    d = C // num_heads
    q, k, v = F.linear(x, wqkv, bqkv).view(B, L, 3, num_heads, d).permute(
        2, 0, 3, 1, 4)
    a = library_sdpa(q, k, v)
    return F.linear(a.transpose(1, 2).reshape(B, L, C), wproj, bproj)


def attention_bound(B, L, C, itemsize):
    """Bound of one call of kernel #2: 8*M*C^2 + 4*B*L^2*C FLOPs of float32
    work (the kernel computes in float32 for either dtype of x) against x
    read once, the output written once and the four float32 parameters."""
    M = B * L
    return bound(8 * M * C * C + 4 * B * L * L * C,
                 2 * M * C * itemsize + 4 * (4 * C * C + 4 * C), "float32")


def attention_gemm_times(x, attn):
    """Kernel #2's two GEMMs alone on float32 x (B, L, C): the QKV and the
    projection product as it runs them (ops.gemm.fused_linear: the same
    wgmma GEMM, float32 in and out, on the weights split per call), their
    ms and TFLOP/s (8*M*C^2 FLOPs) beside F.linear's (cuBLAS SGEMM)."""
    import torch.nn.functional as F
    from pafuse_tpu_torch.ops.gemm import fused_linear
    wqkv, bqkv, wproj, bproj = attn
    C = x.shape[-1]
    a = x.reshape(-1, C)
    o = a.flip(0)                       # any float32 (M, C) operand
    flop = 8 * a.shape[0] * C * C
    times = {
        "gemm_ms": cuda_time_ms(lambda: (fused_linear(a, wqkv, bqkv),
                                         fused_linear(o, wproj, bproj))),
        "gemm_library_ms": cuda_time_ms(lambda: (F.linear(a, wqkv, bqkv),
                                                 F.linear(o, wproj, bproj)))}
    return {**times, **{k.replace("_ms", "_tflops"): flop / v / 1e9
                        for k, v in times.items()}}


def attention_kernel_phase(seed: int, windows: int, P: int, frames: int,
                           dtypes=("float32", "bfloat16"), shapes="eval",
                           parts=None, phase="attention_kernel"):
    """Kernel #2 against its plain version at each network's spatial (B =
    windows*P*2*frames sequences of its joints) and temporal (B =
    windows*P*2*joints sequences of the frames) shape (``parts`` as
    kernel_phase's).  With float32 x, also #2's attention stage alone
    (attention_stage_row) on the float32 qkv of its first GEMM there."""
    import torch
    import torch.nn.functional as F
    from pafuse_tpu_torch.ops.attention import (attention_reference,
                                                fused_attention)
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device("cuda")
    heads = 8
    seqs = windows * P * 2                  # windows x hypotheses x flip
    cases = []
    for part, N, C in parts or h3wb_parts():
        cases.append((part, "spatial", seqs * frames, N, C))
        cases.append((part, "temporal", seqs * N, frames, C))

    results = []
    for i, (part, kind, B, L, C) in enumerate(cases):
        g = torch.Generator().manual_seed(seed * 100 + 80 + i)
        attn = _random_block_params(C, g, dev)[2:6]
        x32 = torch.randn(B, L, C, generator=g).to(dev)
        for name in dtypes:
            dtype = getattr(torch, name)
            x = x32.to(dtype)
            got = fused_attention(x, *attn, heads)
            sync(dev)           # a fault inside a kernel surfaces here
            want = attention_reference(x, *attn, heads).float()
            diff = (got.float() - want).abs()
            if dtype == torch.float32:
                ok = bool(diff.max() <= ATTN_TOL_F32)
            else:
                rel, atol = ATTN_TOL_BF16
                ok = bool(torch.all(diff <= rel * want.abs() + atol))
            del got, want
            lib = tuple(t.to(dtype) for t in attn)
            ms = cuda_time_ms(lambda: fused_attention(x, *attn, heads))
            plain_ms = cuda_time_ms(lambda: attention_reference(x, *attn,
                                                                heads))
            lib_ms = cuda_time_ms(lambda: library_attention(x, *lib, heads))
            r = {"phase": phase, "name": "fused_attention",
                 "shapes": shapes, "part": part, "kind": kind, "dtype": name,
                 "B": B, "L": L, "C": C, "max_abs_err": float(diff.max()),
                 "ok": ok, "ms": ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms,
                 **(attention_gemm_times(x, attn) if name == "float32"
                    else {}),
                 **attention_bound(B, L, C, x.element_size())}
            emit(r)
            results.append(r)
            del diff
            if name == "float32":
                qkv = F.linear(x, attn[0], attn[1])
                results.append(attention_stage_row(
                    qkv, heads, phase, shapes=shapes, part=part, kind=kind))
                del qkv
        del x32, x
        torch.cuda.empty_cache()
    return results


def frames_as_tokens(block, x, *args):
    """A (B, L, C) block function on the (B*N, F, C) frame sequences of x
    (B, F, N, C), transposed back: the temporal block as the layer runs it
    without kernel #3, two device-memory transposes around the block."""
    B, F, N, C = x.shape
    y = block(x.transpose(1, 2).reshape(B * N, F, C), *args)
    return y.view(B, N, F, C).transpose(1, 2).contiguous()


def layer_of_blocks(block, x, spatial, temporal, num_heads, tpe=None):
    """One layer as two calls of a (B, L, C) block function: the spatial
    block on (B*F, N, C), + tpe, and the temporal block through
    frames_as_tokens; with fused_block it is the path kernel #4 replaces,
    with library_block its yardstick."""
    B, F, N, C = x.shape
    ys = block(x.reshape(B * F, N, C), *spatial, num_heads).view(B, F, N, C)
    if tpe is not None:
        ys = ys + tpe.to(x.dtype)[None, :, None, :]
    return frames_as_tokens(block, ys, *temporal, num_heads)


def block_temporal_kernel_phase(seed: int, windows: int, P: int, frames: int,
                                dtypes=("float32", "bfloat16"),
                                shapes="serve"):
    """Kernel #3 against its plain version at each part's temporal shape,
    x (windows*P*2, frames, N, C): its time, the plain version's, the path
    it replaces (transpose, kernel #1, transpose), the library yardstick
    (the same transposes around library_block) and the bound."""
    import torch
    from pafuse_tpu_torch.models.parts import PART_CHANNELS
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.ops.block_temporal import (block_temporal_reference,
                                                     fused_block_temporal)
    from pafuse_tpu_torch.skeleton import parts_table
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device("cuda")
    heads = 8
    B = windows * P * 2                     # windows x hypotheses x flip
    results = []
    for i, (part, joints) in enumerate(parts_table(True).items()):
        N, C = len(joints), PART_CHANNELS[part]
        g = torch.Generator().manual_seed(seed * 100 + 110 + i)
        params = _random_block_params(C, g, dev)
        bp, on = params[:12], params[12:]
        param_bytes = 4 * sum(t.numel() for t in params)
        x32 = torch.randn(B, frames, N, C, generator=g).to(dev)
        for name in dtypes:
            dtype = getattr(torch, name)
            x = x32.to(dtype)
            got = fused_block_temporal(x, bp, on, heads)
            sync(dev)           # a fault inside a kernel surfaces here
            want = block_temporal_reference(x, bp, on, heads)
            diff = (got.float() - want.float()).abs()
            ok = _within(diff, dtype, KERNEL_TOL_BF16)
            del got, want
            lib_bp = tuple(t.to(dtype) for t in bp)
            lib_on = tuple(t.to(dtype) for t in on)
            ms = cuda_time_ms(lambda: fused_block_temporal(x, bp, on, heads))
            plain_ms = cuda_time_ms(lambda: block_temporal_reference(
                x, bp, on, heads))
            replaced_ms = cuda_time_ms(lambda: frames_as_tokens(
                fused_block, x, bp, on, heads))
            lib_ms = cuda_time_ms(lambda: frames_as_tokens(
                library_block, x, lib_bp, lib_on, heads))
            r = {"phase": "block_temporal_kernel",
                 "name": "fused_block_temporal", "shapes": shapes,
                 "part": part, "dtype": name, "B": B, "F": frames, "N": N,
                 "C": C, "max_abs_err": float(diff.max()),
                 "mean_abs_err": float(diff.mean()), "ok": ok, "ms": ms,
                 "plain_ms": plain_ms, "replaced_ms": replaced_ms,
                 "library_ms": lib_ms,
                 **block_bound(B * N, frames, C, name, param_bytes)}
            emit(r)
            results.append(r)
            del diff
        del x32, x
        torch.cuda.empty_cache()
    return results


def layer_kernel_phase(seed: int, windows: int, P: int, frames: int,
                       dtypes=("float32", "bfloat16"), shapes="serve"):
    """Kernel #4 against its plain version for each part, x
    (windows*P*2, frames, N, C), with the temporal position embedding
    (layer 0) and without (layers 1-7): its time, the plain version's, the
    path it replaces (kernel #1 spatial, + tpe, transpose, kernel #1
    temporal, transpose), the library yardstick (the same path on
    library_block) and the bound."""
    import torch
    from pafuse_tpu_torch.models.parts import PART_CHANNELS
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.ops.layer import fused_layer, layer_reference
    from pafuse_tpu_torch.skeleton import parts_table
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device("cuda")
    heads = 8
    B = windows * P * 2
    results = []
    for i, (part, joints) in enumerate(parts_table(True).items()):
        N, C = len(joints), PART_CHANNELS[part]
        g = torch.Generator().manual_seed(seed * 100 + 130 + i)
        sparams = _random_block_params(C, g, dev)
        tparams = _random_block_params(C, g, dev)
        tpe = torch.randn(frames, C, generator=g).to(dev)
        blocks = (sparams[:12], sparams[12:], tparams[:12], tparams[12:])
        param_bytes = 4 * sum(t.numel() for t in sparams + tparams)
        x32 = torch.randn(B, frames, N, C, generator=g).to(dev)
        for name in dtypes:
            dtype = getattr(torch, name)
            x = x32.to(dtype)
            lib = [tuple(t.to(dtype) for t in ts) for ts in blocks]
            for t in (tpe, None):
                got = fused_layer(x, *blocks, heads, tpe=t)
                sync(dev)
                want = layer_reference(x, *blocks, heads, tpe=t)
                diff = (got.float() - want.float()).abs()
                ok = _within(diff, dtype, LAYER_TOL_BF16)
                del got, want
                ms = cuda_time_ms(lambda: fused_layer(x, *blocks, heads,
                                                      tpe=t))
                plain_ms = cuda_time_ms(lambda: layer_reference(
                    x, *blocks, heads, tpe=t))
                replaced_ms = cuda_time_ms(lambda: layer_of_blocks(
                    fused_block, x, blocks[:2], blocks[2:], heads, t))
                lib_ms = cuda_time_ms(lambda: layer_of_blocks(
                    library_block, x, lib[:2], lib[2:], heads, t))
                r = {"phase": "layer_kernel", "name": "fused_layer",
                     "shapes": shapes, "part": part, "dtype": name,
                     "tpe": t is not None, "B": B, "F": frames, "N": N,
                     "C": C, "max_abs_err": float(diff.max()),
                     "mean_abs_err": float(diff.mean()), "ok": ok, "ms": ms,
                     "plain_ms": plain_ms, "replaced_ms": replaced_ms,
                     "library_ms": lib_ms,
                     **layer_bound(B, frames, N, C, name, param_bytes + (
                         0 if t is None else 4 * t.numel()))}
                emit(r)
                results.append(r)
                del diff
        del x32, x
        torch.cuda.empty_cache()
    return results


#: the eval phase's synthetic test set (data.synthetic_actions and
#: data.synthetic_frames): subject S8, 2 actions x 4 cameras x 1000 frames,
#: so that each action dispatches two full batches of the pinned 64 windows
#: and a 24-row tail bucket (152 windows), as evaluations of real sequences
#: of thousands of frames are mostly full batches
EVAL_ACTIONS, EVAL_CAMERAS, EVAL_FRAMES = 2, 4, 1000

#: every line of a report file starts with one of these
REPORT_VOCABULARY = ("----", "step ", "-----------------> Part-Based", " ")


def _set_use_pallas(model, use_pallas):
    """Every part network of ``model`` on the eval functions of
    ``use_pallas``, the experimental gate open."""
    from pafuse_tpu_torch.models.mixste import MixSTE2
    for m in model.modules():
        if isinstance(m, MixSTE2):
            m.set_use_pallas(use_pallas, experimental_kernels=True)


def _wrappers():
    """name -> the kernel wrapper whose ``launches`` counts its launches."""
    from pafuse_tpu_torch.ops.attention import fused_attention
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.ops.block_temporal import fused_block_temporal
    from pafuse_tpu_torch.ops.block_train import (block_train_bwd,
                                                  block_train_fwd)
    from pafuse_tpu_torch.ops.layer import fused_layer
    return {"fused_block": fused_block, "fused_attention": fused_attention,
            "fused_block_temporal": fused_block_temporal,
            "fused_layer": fused_layer, "block_train_fwd": block_train_fwd,
            "block_train_bwd": block_train_bwd}


def _launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def _expect(**launches):
    """Launch counts with every wrapper not named at 0."""
    return {name: launches.get(name, 0) for name in _wrappers()}


def _check_report(out_dir, P, T, what):
    """The CLI's report file holds only lines of the reference's vocabulary,
    with its last step's J_Agg and part-based RIGHT HAND lines; returns its
    line count."""
    report = os.path.join(out_dir, f"h36m_test_log_H{P}_K{T}.txt")
    with open(report) as f:
        lines = f.read().splitlines()
    bad = [ln for ln in lines if not ln.startswith(REPORT_VOCABULARY)]
    need = [f"step {T - 1} : Protocol #1 Error (MPJPE) J_Agg: ",
            f"step {T - 1} Protocol #1   (MPJPE) action-wise average P_Agg "
            "(Part-Based) RIGHT HAND: "]
    if bad or not all(any(ln.startswith(n) for ln in lines) for n in need):
        raise AssertionError(f"{what}: report {report} lacks the reference "
                             f"lines or has others: {bad[:3]}")
    return len(lines)


def _cli(argv, log_path):
    """cli.main_h3wb.main(argv) with its printed reports appended to
    ``log_path``."""
    from pafuse_tpu_torch.cli import main_h3wb
    with open(log_path, "a") as f, contextlib.redirect_stdout(f):
        return main_h3wb.main(argv)


def _max_rel(a, b):
    import numpy as np
    return max(float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k]))) for k in b)


def eval_phase(seed: int, workdir: str, device: str = "cuda", depth: int = 8,
               P: int = 10, T: int = 5):
    """The evaluation path through the CLI at full width (see the module
    docstring; a CPU rehearsal passes device="cpu" and a smaller depth, P
    and T, and expects no launches).  Returns the kernel launches of the
    main-path run."""
    import numpy as np
    import torch
    from pafuse_tpu_torch import checkpoints, evaluate as ev
    from pafuse_tpu_torch.cli import main_h3wb
    from pafuse_tpu_torch.data import h3wb
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.evaluate import _tail_rows
    from pafuse_tpu_torch.skeleton import parts_table

    # full width (the D3DPConfig defaults), the CLI's defaults beside
    cfg = D3DPConfig(depth=depth, num_proposals=P, sampling_timesteps=T)
    rf = cfg.frames
    cli = ["data.synthetic=true", "gpu.use_pallas=true", "general.nolog=true",
           f"gpu.device={device}", f"model.dep={depth}", f"gpu.seed={seed}"]
    on_card = torch.device(device).type == "cuda"
    model = D3DP(cfg, device=device,
                 generator=torch.Generator().manual_seed(seed),
                 use_pallas="true")
    ckpt = checkpoints.save_state(workdir, "seeded", model=model)
    del model
    synthetic = [f"data.synthetic_actions={EVAL_ACTIONS}",
                 f"data.synthetic_frames={EVAL_FRAMES}"]
    per_action = EVAL_CAMERAS * -(-EVAL_FRAMES // rf)
    bs = min(EVAL_WINDOWS, 1 << (EVAL_ACTIONS * per_action - 1).bit_length())
    full, rest = divmod(per_action, bs)         # per action
    tail = _tail_rows(rest, bs) if rest else 0
    batches = EVAL_ACTIONS * (full + (rest > 0))
    blocks = len(parts_table(True)) * depth * 2 if on_card else 0
    per_batch = blocks * T

    # main path: the CLI evaluating the checkpoint at use_pallas=true
    out_dir = os.path.join(workdir, "eval")
    cli_log = os.path.join(workdir, "cli.log")
    _reset_launches()
    t0 = time.time()
    out = _cli(cli + synthetic + [
        f"ft2d.num_proposals={P}", f"ft2d.sampling_timesteps={T}",
        f"general.evaluate={ckpt}", f"general.checkpoint={out_dir}"], cli_log)
    wall_s = time.time() - t0
    launches = _launch_counts()
    if launches != _expect(fused_attention=per_batch * batches):
        raise AssertionError(f"eval: launches {launches}, expected "
                             f"{per_batch} x {batches} batches of kernel #2")
    rows = out["batches"] * out["window_batch"] - out["tail_rows_saved"]
    if ((out["batches"], out["windows"], out["window_batch"], rows)
            != (batches, EVAL_ACTIONS * per_action, bs,
                EVAL_ACTIONS * (full * bs + tail))):
        raise AssertionError(
            f"eval: {out['batches']} batches of {out['window_batch']} rows, "
            f"{rows} rows dispatched for {out['windows']} windows; expected "
            f"{EVAL_ACTIONS} x ({full} x {bs} + one of {tail}) rows")
    avg = out["final"]["all"]
    if not all(np.all(np.isfinite(v)) for v in avg.values()):
        raise AssertionError(f"eval: non-finite metrics {avg}")
    report_lines = _check_report(out_dir, P, T, "eval")
    eval_s = out["eval_seconds"]
    emit({"phase": "eval", "P": P, "T": T, "depth": cfg.depth,
          "windows": out["windows"], "batches": out["batches"],
          "window_batch": bs, "full_batches": EVAL_ACTIONS * full,
          "tail_rows": tail, "rows": rows,
          "launches": launches, "cli_wall_s": wall_s,
          "eval_s": eval_s, "windows_per_s": out["windows"] / eval_s,
          "frames_per_s": out["windows"] * rf / eval_s,
          "report_lines": report_lines,
          "final_step": {k: float(np.atleast_1d(v)[-1])
                         for k, v in sorted(avg.items())}})

    # one action with injected noise: kernel #2 vs plain attention vs kernel #1
    dataset = h3wb.load_dataset(synthetic=True,
                                actions_per_subject=EVAL_ACTIONS,
                                frames_per_action=EVAL_FRAMES)
    keypoints = h3wb.prepare_data(dataset)
    action = sorted(main_h3wb.collect_actions(dataset, ["S8"])[0].items())[0]
    seqs = list(zip(*h3wb.fetch_actions(action[1], keypoints, dataset)))
    r = np.random.RandomState(seed)
    table = (r.randn(per_action, P, rf, cfg.num_kps, 3).astype(np.float32),
             r.randn(per_action, T, P, rf, cfg.num_kps, 3).astype(np.float32))
    model = D3DP(cfg, device=device, use_pallas="true")
    checkpoints.load_state(ckpt, model)
    means, seconds = {}, {}
    for use_pallas in ("true", "false", "auto"):
        _set_use_pallas(model, use_pallas)
        t0 = time.time()
        acc, _ = ev.evaluate_sequences(model, seqs, receptive_field=rf,
                                       num_proposals=P, sampling_timesteps=T,
                                       window_batch=bs, noise_table=table)
        seconds[use_pallas] = time.time() - t0
        means[use_pallas] = acc.means_mm()
    errs = {"vs_plain": _max_rel(means["true"], means["false"]),
            "vs_kernel_1": _max_rel(means["true"], means["auto"])}
    emit({"phase": "eval_vs_plain", "action": action[0],
          "windows": per_action, "max_rel_err": errs, "rtol": EVAL_RTOL,
          "seconds": seconds})
    if not max(errs.values()) <= EVAL_RTOL:
        raise AssertionError(f"eval: kernel #2 path disagrees: {errs}")

    # where the time goes: one DDIM step of that action at use_pallas=true
    _set_use_pallas(model, "true")
    if on_card:
        profile_step(lambda: ev.evaluate_sequences(
            model, seqs, receptive_field=rf, num_proposals=P,
            sampling_timesteps=1, window_batch=bs),
            phase="eval_profile", names=EVAL_TRUE_GROUPS,
            rest="PyTorch (LayerNorm, GELU, residuals, embedding, head, "
                 "sampler, metrics)")
    del model

    # the trainer through the CLI: one step, then the evaluations
    train_dir = os.path.join(workdir, "train")
    _reset_launches()
    t0 = time.time()
    _cli(cli + ["ft2d.debug=true", "model.epochs=1", "ft2d.num_proposals=2",
                "ft2d.sampling_timesteps=2", f"general.checkpoint={train_dir}"],
         cli_log)
    train_launches = _launch_counts()
    # one step; the per-epoch eval (P=1, T=1) and each action's final eval
    # (T=2) dispatch one batch each in quick-debug mode
    want = _expect(fused_attention=blocks * (1 + EVAL_ACTIONS * 2),
                   block_train_fwd=blocks, block_train_bwd=blocks)
    for name in ("best_epoch.npz", "training_log.txt",
                 "h36m_test_log_H2_K2.txt"):
        if not os.path.exists(os.path.join(train_dir, name)):
            raise AssertionError(f"eval_cli_train: no {name}")
    if train_launches != want:
        raise AssertionError(f"eval_cli_train: launches {train_launches}, "
                             f"expected {want}")
    with open(os.path.join(train_dir, "training_log.txt")) as f:
        log = f.readline().strip()
    emit({"phase": "eval_cli_train", "seconds": time.time() - t0,
          "launches": train_launches, "training_log": log})
    if on_card:
        torch.cuda.empty_cache()
    return launches


#: the eval_experimental phase's synthetic test set: S8, one action x 4
#: cameras x 500 frames = 76 windows, one full 64-row batch and a tail
EXP_FRAMES = 500


def eval_experimental_phase(seed: int, workdir: str, device: str = "cuda",
                            depth: int = 8, P: int = 10, T: int = 5):
    """The evaluation path at use_pallas=block_t and layer (behind
    gpu.experimental_kernels=true) through the CLI at full width, from a
    checkpoint of the eval phase's seeded weights (see the module
    docstring; a CPU rehearsal passes device="cpu" and a smaller depth, P
    and T, and expects no launches).  Returns {mode: the kernel launches
    of its CLI run}."""
    import numpy as np
    import torch
    from pafuse_tpu_torch import checkpoints, evaluate as ev
    from pafuse_tpu_torch.cli import main_h3wb
    from pafuse_tpu_torch.data import h3wb
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.evaluate import _tail_rows
    from pafuse_tpu_torch.skeleton import parts_table

    cfg = D3DPConfig(depth=depth, num_proposals=P, sampling_timesteps=T)
    rf = cfg.frames
    on_card = torch.device(device).type == "cuda"
    model = D3DP(cfg, device=device,
                 generator=torch.Generator().manual_seed(seed))
    ckpt = checkpoints.save_state(workdir, "seeded", model=model)
    del model
    windows = EVAL_CAMERAS * -(-EXP_FRAMES // rf)
    bs = min(EVAL_WINDOWS, 1 << (windows - 1).bit_length())
    full, rest = divmod(windows, bs)
    tail = _tail_rows(rest, bs) if rest else 0
    batches = full + (rest > 0)
    # per DDIM step: one layer call of each part network per layer
    layers = len(parts_table(True)) * depth if on_card else 0
    want = {"block_t": _expect(fused_block=layers * T * batches,
                               fused_block_temporal=layers * T * batches),
            "layer": _expect(fused_layer=layers * T * batches)}
    cli = ["data.synthetic=true", "general.nolog=true",
           "data.synthetic_actions=1", f"data.synthetic_frames={EXP_FRAMES}",
           f"gpu.device={device}", f"model.dep={depth}", f"gpu.seed={seed}",
           "gpu.experimental_kernels=true", f"ft2d.num_proposals={P}",
           f"ft2d.sampling_timesteps={T}", f"general.evaluate={ckpt}"]
    cli_log = os.path.join(workdir, "cli.log")
    launches = {}
    for mode in ("block_t", "layer"):
        out_dir = os.path.join(workdir, f"eval_{mode}")
        _reset_launches()
        t0 = time.time()
        out = _cli(cli + [f"gpu.use_pallas={mode}",
                          f"general.checkpoint={out_dir}"], cli_log)
        wall_s = time.time() - t0
        launches[mode] = _launch_counts()
        if launches[mode] != want[mode]:
            raise AssertionError(f"eval_experimental {mode}: launches "
                                 f"{launches[mode]}, expected {want[mode]}")
        rows = out["batches"] * out["window_batch"] - out["tail_rows_saved"]
        if ((out["batches"], out["windows"], out["window_batch"], rows)
                != (batches, windows, bs, full * bs + tail)):
            raise AssertionError(
                f"eval_experimental {mode}: {out['batches']} batches of "
                f"{out['window_batch']} rows, {rows} rows for "
                f"{out['windows']} windows")
        avg = out["final"]["all"]
        if not all(np.all(np.isfinite(v)) for v in avg.values()):
            raise AssertionError(f"eval_experimental {mode}: non-finite "
                                 f"metrics {avg}")
        eval_s = out["eval_seconds"]
        emit({"phase": "eval_experimental", "use_pallas": mode, "P": P,
              "T": T, "depth": depth, "windows": out["windows"],
              "batches": out["batches"], "window_batch": bs,
              "tail_rows": tail, "rows": rows, "launches": launches[mode],
              "cli_wall_s": wall_s, "eval_s": eval_s,
              "windows_per_s": out["windows"] / eval_s,
              "frames_per_s": out["windows"] * rf / eval_s,
              "report_lines": _check_report(out_dir, P, T,
                                            f"eval_experimental {mode}"),
              "final_step": {k: float(np.atleast_1d(v)[-1])
                             for k, v in sorted(avg.items())}})

    # the action with one injected noise table at every mode
    dataset = h3wb.load_dataset(synthetic=True, actions_per_subject=1,
                                frames_per_action=EXP_FRAMES)
    keypoints = h3wb.prepare_data(dataset)
    action = sorted(main_h3wb.collect_actions(dataset, ["S8"])[0].items())[0]
    seqs = list(zip(*h3wb.fetch_actions(action[1], keypoints, dataset)))
    r = np.random.RandomState(seed)
    table = (r.randn(windows, P, rf, cfg.num_kps, 3).astype(np.float32),
             r.randn(windows, T, P, rf, cfg.num_kps, 3).astype(np.float32))
    model = D3DP(cfg, device=device)
    checkpoints.load_state(ckpt, model)
    means, seconds = {}, {}
    for mode in ("block_t", "layer", "auto", "false"):
        _set_use_pallas(model, mode)
        t0 = time.time()
        acc, _ = ev.evaluate_sequences(model, seqs, receptive_field=rf,
                                       num_proposals=P, sampling_timesteps=T,
                                       window_batch=bs, noise_table=table)
        seconds[mode] = time.time() - t0
        means[mode] = acc.means_mm()
    errs = {f"{m}_vs_{ref}": _max_rel(means[m], means[ref])
            for m in ("block_t", "layer") for ref in ("auto", "false")}
    emit({"phase": "eval_experimental_vs", "action": action[0],
          "windows": windows, "max_rel_err": errs, "rtol": EVAL_RTOL,
          "seconds": seconds})
    if not max(errs.values()) <= EVAL_RTOL:
        raise AssertionError(f"eval_experimental: modes disagree: {errs}")

    # where the time goes: one DDIM step of the 64-row batch at each mode
    if on_card:
        for mode in ("layer", "block_t"):
            _set_use_pallas(model, mode)
            profile_step(lambda: ev.evaluate_sequences(
                model, seqs, receptive_field=rf, num_proposals=P,
                sampling_timesteps=1, window_batch=bs, quickdebug=True),
                phase="eval_experimental_profile", use_pallas=mode, rows=bs,
                rest="PyTorch (embedding, head, sampler, metrics)")
    del model
    if on_card:
        torch.cuda.empty_cache()
    return launches


def _cli_3dhp(argv, log_path):
    """cli.main_3dhp.main(argv) with its printed lines appended to
    ``log_path``."""
    from pafuse_tpu_torch.cli import main_3dhp
    with open(log_path, "a") as f, contextlib.redirect_stdout(f):
        return main_3dhp.main(argv)


def _check_3dhp_report(path, T, runs, what):
    """The 3DHP report holds the JAX CLI's two lines per DDIM step, once
    per CLI run; returns its lines."""
    with open(path) as f:
        lines = f.read().splitlines()
    want = [f"step {i} : 3DHP MPJPE {m}: " for i in range(T)
            for m in ("P_Best", "P_Agg")] * runs
    if len(lines) != len(want) or not all(
            ln.startswith(w) and ln.endswith(" mm")
            for ln, w in zip(lines, want)):
        raise AssertionError(f"{what}: report {path} is not the 3DHP "
                             f"report: {lines[:4]}")
    return lines


def dhp3_eval_phase(seed: int, workdir: str, device: str = "cuda",
                    depth: int = 8, P: int = 10, T: int = 5,
                    frames: int = DHP3_FRAMES):
    """The 3DHP CLI at full width (model.cs 288, 27 frames, P and T) on its
    default synthetic data: one epoch of training with its P=1, T=1
    evaluation and the final evaluation, then evaluate-only from the
    epoch_1 checkpoint; then cli.main_3dhp.evaluate_3dhp on that
    checkpoint's weights over dhp3.make_synthetic(num_test_seqs=2,
    frames=1000) (38 windows a sequence, one sampler call each) at
    use_pallas=auto and true, one injected noise table at auto, true and
    false, and one DDIM step traced.  A CPU rehearsal passes device="cpu"
    and a smaller depth, P, T and frames, and expects no launches.  Returns
    {run: its kernel launches}."""
    import numpy as np
    import torch
    from pafuse_tpu_torch import checkpoints, config as cfg_mod
    from pafuse_tpu_torch.cli import main_3dhp
    from pafuse_tpu_torch.data import dhp3
    from pafuse_tpu_torch.data.sampling import ChunkedSampler

    on_card = torch.device(device).type == "cuda"
    blocks = 2 * depth if on_card else 0        # one network, two blocks a layer
    rf = 27
    out_dir = os.path.join(workdir, "dhp3")
    log = os.path.join(workdir, "dhp3_cli.log")
    cli = [f"gpu.device={device}", f"gpu.seed={seed}", f"model.dep={depth}",
           "data.synthetic=true", f"ft2d.num_proposals={P}",
           f"ft2d.sampling_timesteps={T}", f"general.checkpoint={out_dir}"]
    train_cli, test_cli = dhp3.make_synthetic()  # the CLI's synthetic data
    steps = ChunkedSampler(1024 // rf, None, *dhp3.train_arrays(train_cli),
                           rf, augment=True).batch_num()
    launches = {}

    # the CLI: one epoch (its steps, a P=1, T=1 evaluation), the final
    # evaluation, the report and epoch_1
    _reset_launches()
    t0 = time.time()
    trained = _cli_3dhp(cli + ["model.epochs=1",
                               "general.checkpoint_frequency=1"], log)
    train_s = time.time() - t0
    launches["cli_train"] = _launch_counts()
    want = _expect(fused_block=blocks * len(test_cli) * (1 + T),
                   block_train_fwd=blocks * steps,
                   block_train_bwd=blocks * steps)
    if launches["cli_train"] != want:
        raise AssertionError(f"dhp3_eval: CLI train launches "
                             f"{launches['cli_train']}, expected {want}")
    ckpt = os.path.join(out_dir, "epoch_1.npz")
    if not os.path.exists(ckpt):
        raise AssertionError("dhp3_eval: the CLI wrote no epoch_1.npz")
    with open(log) as f:
        epoch_line = next(ln.strip() for ln in f if ln.startswith("[1] time"))

    # evaluate-only from epoch_1: the same weights and noise, the same metrics
    _reset_launches()
    t0 = time.time()
    again = _cli_3dhp(cli + ["general.evaluate=epoch_1.npz"], log)
    eval_cli_s = time.time() - t0
    launches["cli_evaluate"] = _launch_counts()
    if launches["cli_evaluate"] != _expect(fused_block=blocks * len(test_cli)
                                           * T):
        raise AssertionError(f"dhp3_eval: CLI evaluate launches "
                             f"{launches['cli_evaluate']}")
    lines = _check_3dhp_report(trained["report"], T, 2, "dhp3_eval")
    cli_metrics = {k: trained[k] for k in ("P_Best", "P_Agg")}
    cli_err = _max_rel(again, cli_metrics)
    if not (all(np.all(np.isfinite(v)) for v in cli_metrics.values())
            and cli_err <= EVAL_RTOL):
        raise AssertionError(f"dhp3_eval: evaluate-only {again} vs the "
                             f"evaluation after training {cli_metrics}")
    emit({"phase": "dhp3_eval_cli", "P": P, "T": T, "depth": depth,
          "train_steps": steps, "epoch_log": epoch_line,
          "train_and_eval_s": train_s, "evaluate_only_s": eval_cli_s,
          "windows": again["windows"], "eval_s": again["eval_seconds"],
          "report_lines": len(lines), "report_last": lines[-2:],
          "evaluate_only_bit_equal": all(np.array_equal(again[k], v)
                                         for k, v in cli_metrics.items()),
          "evaluate_only_max_rel_err": cli_err,
          "launches": {k: v for k, v in launches.items()}})

    # evaluate_3dhp on the checkpoint's weights, 1000-frame sequences
    args = cfg_mod.parse_cli(cli)
    model = main_3dhp.build_model_3dhp(args, device)
    checkpoints.load_state(ckpt, model)
    _, test = dhp3.make_synthetic(num_test_seqs=2, frames=frames, seed=seed)
    per_seq = [-(-v["data_2d"].shape[0] // rf) for v in test.values()]
    windows = sum(per_seq)
    calls = sum(-(-n // 64) for n in per_seq)     # evaluate_3dhp's window batch
    kernel = {"auto": "fused_block", "true": "fused_attention"}
    results, seconds = {}, {}
    for use_pallas in ("auto", "true"):
        _set_use_pallas(model, use_pallas)
        _reset_launches()
        t0 = time.time()
        err, agg = main_3dhp.evaluate_3dhp(
            model, test, args, num_proposals=P, sampling_timesteps=T)
        seconds[use_pallas] = time.time() - t0
        launches[use_pallas] = _launch_counts()
        if launches[use_pallas] != _expect(
                **{kernel[use_pallas]: blocks * T * calls}):
            raise AssertionError(f"dhp3_eval: {use_pallas} launches "
                                 f"{launches[use_pallas]}")
        if not (np.all(np.isfinite(err)) and np.all(np.isfinite(agg))):
            raise AssertionError(f"dhp3_eval: non-finite metrics {err} {agg}")
        results[use_pallas] = {"P_Best": err.tolist(), "P_Agg": agg.tolist()}
        emit({"phase": "dhp3_eval", "use_pallas": use_pallas, "P": P, "T": T,
              "depth": depth, "sequences": len(test), "windows": windows,
              "rows_per_call": windows // len(test) * P * 2,
              "launches": launches[use_pallas], "seconds": seconds[use_pallas],
              "windows_per_s": windows / seconds[use_pallas],
              "frames_per_s": windows * rf / seconds[use_pallas],
              "metrics_mm": results[use_pallas]})

    # one injected noise table: the kernel paths against the plain path (mm)
    r = np.random.RandomState(seed)
    table = (r.randn(windows, P, rf, 17, 3).astype(np.float32),
             r.randn(windows, T, P, rf, 17, 3).astype(np.float32))
    means = {}
    for use_pallas in ("auto", "true", "false"):
        _set_use_pallas(model, use_pallas)
        err, agg = main_3dhp.evaluate_3dhp(
            model, test, args, num_proposals=P, sampling_timesteps=T,
            noise_table=table)
        means[use_pallas] = {"P_Best": err, "P_Agg": agg}
    errs = {k: _max_rel(means[k], means["false"]) for k in ("auto", "true")}
    abs_mm = {k: max(float(np.abs(means[k][m] - means["false"][m]).max())
                     for m in means[k]) for k in ("auto", "true")}
    emit({"phase": "dhp3_eval_vs_plain", "windows": windows,
          "max_rel_err": errs, "max_abs_err_mm": abs_mm, "rtol": EVAL_RTOL,
          "plain_mm": {k: v.tolist() for k, v in means["false"].items()}})
    if not max(errs.values()) <= EVAL_RTOL:
        raise AssertionError(f"dhp3_eval: a kernel path disagrees: {errs}")

    # where the time goes: one DDIM step at auto
    _set_use_pallas(model, "auto")
    if on_card:
        profile_step(lambda: main_3dhp.evaluate_3dhp(
            model, test, args, num_proposals=P, sampling_timesteps=1),
            phase="dhp3_eval_profile",
            rest="PyTorch (embedding, head, sampler, metric)")
        torch.cuda.empty_cache()
    del model
    return launches


def _write_openpifpaf(path, frames, rng, missing=()):
    """An OpenPifPaf whole-body JSON-lines file of ``frames`` frames (133
    keypoints in a 1000 x 1002 frame, confidence 0.9), no person in the
    frames of ``missing``."""
    import numpy as np
    with open(path, "w") as f:
        for i in range(frames):
            kp = np.column_stack([rng.uniform(100, 900, 133),
                                  rng.uniform(100, 900, 133),
                                  np.full(133, 0.9)]).ravel().tolist()
            preds = [] if i in missing else [{"keypoints": kp}]
            f.write(json.dumps({"predictions": preds}) + "\n")


def in_the_wild_phase(seed: int, workdir: str, device: str = "cuda",
                      depth: int = 8, P: int = 10, T: int = 5,
                      frames: int = 1000):
    """The in-the-wild CLI's compute path at full width (the H3WB model of
    the default config, seeded): an OpenPifPaf JSON of 1000 frames ->
    cli.in_the_wild.lift_to_world (normalisation, chunks of 1024 // 27 = 37
    windows through utils.device.run_chunked: 38 windows are a 37-window
    chunk and a 1-window tail; flip-TTA DDIM, whole-body assembly,
    stitching, world coordinates).  Then the same frames and chunks with
    one injected noise table, kernel #1 against the plain block.  A CPU
    rehearsal passes device="cpu" and smaller sizes.  Returns the
    main-path launches."""
    import numpy as np
    import torch
    from pafuse_tpu_torch import config as cfg_mod
    from pafuse_tpu_torch.cli import in_the_wild as itw
    from pafuse_tpu_torch.cli.main_h3wb import build_model

    rf = 27
    base = [f"gpu.device={device}", f"gpu.seed={seed}", f"model.dep={depth}",
            f"ft2d.num_proposals={P}", f"ft2d.sampling_timesteps={T}"]
    args = cfg_mod.parse_cli(base)
    model = build_model(args, device)
    on_card = torch.device(device).type == "cuda"
    path = os.path.join(workdir, "video.mp4.openpifpaf.json")
    _write_openpifpaf(path, frames, np.random.RandomState(seed),
                      missing=(frames // 2,))
    keypoints = itw.load_openpifpaf_keypoints(path)
    windows = -(-frames // rf)
    chunk = args.model.batch_size // rf
    chunks = -(-windows // chunk)
    w, h, _ = itw.DEFAULT_VIDEO

    _reset_launches()
    t0 = time.time()
    prediction, world, kp_norm = itw.lift_to_world(args, keypoints, model, w, h)
    wall = time.time() - t0
    launches = _launch_counts()
    if launches != _expect(fused_block=_per_chunk(model, T) * chunks
                           if on_card else 0):
        raise AssertionError(f"in_the_wild: launches {launches}, expected "
                             f"{_per_chunk(model, T)} x {chunks} chunks")
    want = (T, P, frames, 134, 3)
    if prediction.shape != want or world.shape != want:
        raise AssertionError(f"in_the_wild: shapes {prediction.shape} "
                             f"{world.shape}, expected {want}")
    if not (np.all(np.isfinite(prediction)) and np.all(np.isfinite(world))
            and world[..., 2].min() == 0.0):
        raise AssertionError("in_the_wild: non-finite poses or no floor")

    # the same 1000 frames and chunks with one injected noise table:
    # kernel #1 at the timed shapes against the plain block
    r = np.random.RandomState(seed + 1)
    table = (r.randn(windows, P, rf, 134, 3).astype(np.float32),
             r.randn(windows, T, P, rf, 134, 3).astype(np.float32))
    got = itw.lift_video(args, kp_norm, model, noise_table=table)
    _set_use_pallas(model, "false")
    plain = itw.lift_video(args, kp_norm, model, noise_table=table)
    err = float(np.abs(got - plain).max())
    del got, plain, table
    emit({"phase": "in_the_wild", "P": P, "T": T, "depth": depth,
          "frames": frames, "windows": windows, "chunk_windows": chunk,
          "chunks": chunks, "launches": launches, "seconds": wall,
          "frames_per_s": frames / wall, "windows_per_s": windows / wall,
          "shape": list(prediction.shape),
          "world_z_max": float(world[..., 2].max()),
          "vs_plain": {"frames": frames, "chunk_windows": chunk,
                       "max_abs_err": err, "tol": SERVE_TOL}})
    if not err <= SERVE_TOL:
        raise AssertionError(f"in_the_wild: kernel vs plain block {err}")
    del model
    if on_card:
        torch.cuda.empty_cache()
    return launches


def draw_phase(seed: int, device: str = "cuda", depth: int = 8, P: int = 10,
               T: int = 5, frames: int = 1000):
    """The draw CLI's compute path at full width (the seeded H3WB model) on
    synthetic S8 (one action of 1000 frames, camera 0):
    cli.draw_h3wb.draw_poses samples all 38 windows in one call, re-adds
    the trajectory, stitches, picks each joint's hypothesis by its
    reprojection error and converts to world coordinates.  Then the same
    call with one injected noise table, kernel #1 against the plain block.
    A CPU rehearsal passes device="cpu" and smaller sizes.  Returns the
    main-path launches."""
    import numpy as np
    import torch
    from pafuse_tpu_torch import config as cfg_mod
    from pafuse_tpu_torch.cli import draw_h3wb
    from pafuse_tpu_torch.cli.main_h3wb import build_model
    from pafuse_tpu_torch.data import h3wb

    args = cfg_mod.parse_cli([
        f"gpu.device={device}", f"gpu.seed={seed}", f"model.dep={depth}",
        f"ft2d.num_proposals={P}", f"ft2d.sampling_timesteps={T}"])
    dataset = h3wb.make_synthetic(subjects=("S8",), actions_per_subject=1,
                                  frames_per_action=frames, seed=seed)
    keypoints = h3wb.prepare_data(dataset)
    model = build_model(args, device, flip_permutation=dataset.flip_permutation)
    on_card = torch.device(device).type == "cuda"
    _reset_launches()
    t0 = time.time()
    poses = draw_h3wb.draw_poses(args, model, dataset, keypoints, "S8",
                                 "Walking 1", 0)
    wall = time.time() - t0
    launches = _launch_counts()
    if launches != _expect(fused_block=_per_chunk(model, T) if on_card else 0):
        raise AssertionError(f"draw: launches {launches}")
    stitched, selected = poses["stitched"], poses["selected"]
    if (stitched.shape != (T, P, frames, 134, 3)
            or selected.shape != (T, frames, 134, 3)):
        raise AssertionError(f"draw: shapes {stitched.shape} {selected.shape}")
    picked = np.all(np.any(np.all(selected[:, None] == stitched, axis=-1),
                           axis=1))
    if not (picked and all(np.all(np.isfinite(v)) for v in poses.values())):
        raise AssertionError("draw: a selected joint is no hypothesis's, or "
                             "non-finite poses")
    # the same call with one injected noise table: kernel #1 at the timed
    # shapes against the plain block (the J-Agg picks are reported, not
    # held: a pick may turn on a near tie of two reprojection errors)
    windows = -(-frames // 27)
    r = np.random.RandomState(seed + 1)
    table = (r.randn(windows, P, 27, 134, 3).astype(np.float32),
             r.randn(windows, T, P, 27, 134, 3).astype(np.float32))
    got = draw_h3wb.draw_poses(args, model, dataset, keypoints, "S8",
                               "Walking 1", 0, noise_table=table)
    _set_use_pallas(model, "false")
    plain = draw_h3wb.draw_poses(args, model, dataset, keypoints, "S8",
                                 "Walking 1", 0, noise_table=table)
    err = float(np.abs(got["stitched"] - plain["stitched"]).max())

    def picks(p):   # the hypothesis each selected joint came from
        return np.abs(p["stitched"] - p["selected"][:, None]).sum(-1).argmin(1)

    same_pick = float(np.mean(picks(got) == picks(plain)))
    del got, plain, table
    emit({"phase": "draw", "P": P, "T": T, "depth": depth, "frames": frames,
          "windows": windows, "launches": launches, "seconds": wall,
          "frames_per_s": frames / wall,
          "gt_vs_selected_mm": float(1000 * np.linalg.norm(
              poses["sel_world"][-1] - poses["gt_world"], axis=-1).mean()),
          "vs_plain": {"frames": frames, "windows": windows,
                       "max_abs_err": err, "tol": SERVE_TOL,
                       "same_pick_share": same_pick}})
    if not err <= SERVE_TOL:
        raise AssertionError(f"draw: kernel vs plain block {err}")
    del model
    if on_card:
        torch.cuda.empty_cache()
    return launches


def _pose_check(what, got, want, tol):
    """``got`` against ``want`` (NumPy arrays) within ``tol`` = (max abs,
    mean abs).  Returns the numbers; raises where they miss."""
    import numpy as np
    d = np.abs(got - want)
    out = {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
           "tol": list(tol)}
    if not (out["max_abs_err"] <= tol[0] and out["mean_abs_err"] <= tol[1]):
        raise AssertionError(f"{what}: the bfloat16 kernel path against its "
                             f"plain versions: {out}")
    return out


def _noise_check(what, got, plain, f32, floor):
    """A bfloat16 path's output ``got`` against the plain bfloat16 path's
    ``plain`` (NumPy arrays), within BF16_NOISE_RATIO times ``plain``'s
    own distance from the float32 output ``f32`` plus ``floor``, in max
    and in mean abs.  Returns the numbers; raises where they miss."""
    import numpy as np
    d, noise = np.abs(got - plain), np.abs(plain - f32)
    out = {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
           "plain_vs_f32_max_abs": float(noise.max()),
           "plain_vs_f32_mean_abs": float(noise.mean()),
           "ratio": BF16_NOISE_RATIO, "floor": floor}
    if not (out["max_abs_err"] <= BF16_NOISE_RATIO
            * out["plain_vs_f32_max_abs"] + floor
            and out["mean_abs_err"] <= BF16_NOISE_RATIO
            * out["plain_vs_f32_mean_abs"] + floor):
        raise AssertionError(f"{what}: the bfloat16 path against the plain "
                             f"bfloat16 path: {out}")
    return out


def _plain_fns(mode):
    """The eval functions of ``use_pallas=mode`` with every kernel on its
    plain version: #1 block_reference, #2 attention_reference inside the
    unfused block, #3 block_temporal_reference, #4 layer_reference (the
    last two run block_reference on the rows #1 would take)."""
    import functools
    from pafuse_tpu_torch.models.mixste import unfused_block
    from pafuse_tpu_torch.ops.attention import attention_reference
    from pafuse_tpu_torch.ops.block import block_reference
    from pafuse_tpu_torch.ops.block_temporal import block_temporal_reference
    from pafuse_tpu_torch.ops.layer import layer_reference
    return {"auto": {"block_fn": block_reference},
            "true": {"block_fn": functools.partial(
                unfused_block, attention_fn=attention_reference)},
            "block_t": {"block_fn": block_reference,
                        "block_t_fn": block_temporal_reference},
            "layer": {"layer_fn": layer_reference}}[mode]


def _set_mode(model, mode):
    """Every part network of ``model`` on ``use_pallas=mode``'s eval
    functions, or on their plain versions for "plain_{mode}"."""
    from pafuse_tpu_torch.models.mixste import MixSTE2
    plain = mode.startswith("plain_")
    _set_use_pallas(model, mode[len("plain_"):] if plain else mode)
    if plain:
        for m in model.modules():
            if isinstance(m, MixSTE2):
                for k, v in _plain_fns(mode[len("plain_"):]).items():
                    setattr(m, k, v)


def _metrics(means):
    """The metrics of a report (``means_mm()`` or evaluate_3dhp's) as one
    flat float64 array, in key order."""
    import numpy as np
    return np.concatenate([np.atleast_1d(np.asarray(means[k], np.float64))
                           .ravel() for k in sorted(means)])


def bf16_serve_phase(seed: int, f32_svc, device: str = "cuda", cfg=None):
    """LiftingService at compute_dtype=bfloat16 on the serve phase's seeded
    weights (batcher on, host noise): warm-up and requests of 27, 100 and
    405 frames, each with 48*T launches of kernel #1 a chunk in bfloat16;
    then the 405-frame request against the same service on #1's plain
    version (BF16_POSE_TOL) and on the plain bfloat16 path (use_pallas=
    false, the JAX model's rounding points; within BF16_NOISE_RATIO times
    that path's distance from the float32 service ``f32_svc`` on the same
    weights and noise), and its distance from float32 in mm.  A CPU
    rehearsal passes device="cpu" and a small cfg.  Returns the kernel
    launches of the main-path requests."""
    import numpy as np
    import torch
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.serve import LiftingService, bucket_for

    cfg = cfg or D3DPConfig()
    on_card = device != "cpu"
    model = D3DP(cfg, device=device,
                 generator=torch.Generator().manual_seed(seed),
                 compute_dtype="bfloat16")
    svc = LiftingService(model, buckets=(1, 2, 4, 8, 16), device=device)
    per_chunk = _per_chunk(model, cfg.sampling_timesteps)
    rng = np.random.RandomState(seed + 7)

    def chunks(frames):
        w = max(1, -(-frames // cfg.frames))
        return -(-w // bucket_for(w, svc.buckets))

    def check(label, launches, expected):
        if on_card and launches != expected:
            raise AssertionError(f"bf16_serve {label}: {launches} launches, "
                                 f"expected {expected}")

    fused_block.launches = 0
    t0 = time.time()
    svc.warmup()
    emit({"phase": "bf16_serve_warmup", "seconds": time.time() - t0,
          "launches": fused_block.launches})
    check("warmup", fused_block.launches, per_chunk * len(svc.buckets))
    launches = fused_block.launches
    kp, poses = {}, {}
    for frames in (27, 100, 405):
        kp[frames] = _kp(rng, frames)
        fused_block.launches = 0
        res = svc.lift(kp[frames], seed=seed)
        n = fused_block.launches
        launches += n
        check(f"{frames} frames", n, per_chunk * chunks(frames))
        poses[frames] = res["poses"]
        if (poses[frames].shape != (frames, cfg.num_kps, 3)
                or not np.all(np.isfinite(poses[frames]))):
            raise AssertionError(f"bf16_serve: {frames} frames gave "
                                 f"{poses[frames].shape} or non-finite poses")
        emit({"phase": "bf16_serve", "frames": frames,
              "chunks": chunks(frames), "launches": n,
              "latency_ms": res["latency_ms"],
              "frames_per_s": frames / (res["latency_ms"] / 1e3)})

    # the same 405-frame request, the same weights and host noise: on the
    # float32 service, on #1's plain version and on the plain bfloat16
    # path (the JAX model's rounding points)
    f32 = f32_svc.lift(kp[405], seed=seed)["poses"]
    out = {}
    for mode in ("plain_auto", "false"):
        _set_mode(model, mode)
        out[mode] = svc.lift(kp[405], seed=seed)["poses"]
    _set_use_pallas(model, "auto")
    got = poses[405]
    emit({"phase": "bf16_serve_vs_plain", "frames": 405,
          "vs_plain_versions": _pose_check("bf16_serve", got,
                                           out["plain_auto"],
                                           BF16_POSE_TOL["serve"]),
          "vs_false": _noise_check("bf16_serve", got, out["false"], f32,
                                   BF16_FLOOR * 1e-3),
          "vs_float32_max_mm": float(1e3 * np.abs(got - f32).max()),
          "vs_float32_mean_mm": float(1e3 * np.abs(got - f32).mean())})
    svc.close()
    del svc, model
    if on_card:
        torch.cuda.empty_cache()
    return launches


def bf16_eval_phase(seed: int, workdir: str, device: str = "cuda",
                    depth: int = 8, P: int = 10, T: int = 5,
                    frames: int = DHP3_FRAMES):
    """Evaluation at gpu.compute_dtype=bfloat16 at full width: the H3WB CLI
    on a checkpoint of the seeded weights, on eval_experimental's 76-window
    action (P, T), at use_pallas=auto (48*T launches of #1 a window batch),
    true (of #2), block_t (24*T of #1 and of #3) and layer (24*T of #4;
    both behind gpu.experimental_kernels=true), beside the float32 run at
    auto: seconds, windows/s, every metric's delta from float32.  Then the action's first sequence
    with one injected noise table through evaluate_sequences, predictions
    returned: the bfloat16 kernel paths auto, true, block_t and layer
    against the same model on their kernels' plain versions
    (BF16_POSE_TOL), and auto and true against the plain bfloat16 path
    (false) within BF16_NOISE_RATIO times its distance from float32.  Then
    evaluate_3dhp on the seeded 3DHP model over two sequences of
    ``frames`` frames at auto in bfloat16 (16*T launches of #1 a call) and
    float32, and with one noise table its outputs (caught at
    ``eval_forward``) against #1's plain version and the plain path the
    same way.  Returns {run: its kernel launches}."""
    import numpy as np
    import torch
    from pafuse_tpu_torch import checkpoints, config as cfg_mod
    from pafuse_tpu_torch import evaluate as ev
    from pafuse_tpu_torch.cli import main_3dhp, main_h3wb
    from pafuse_tpu_torch.data import dhp3, h3wb
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.skeleton import parts_table

    cfg = D3DPConfig(depth=depth, num_proposals=P, sampling_timesteps=T)
    rf = cfg.frames
    on_card = torch.device(device).type == "cuda"
    model = D3DP(cfg, device=device,
                 generator=torch.Generator().manual_seed(seed))
    ckpt = checkpoints.save_state(workdir, "seeded_bf16", model=model)
    del model
    windows = EVAL_CAMERAS * -(-EXP_FRAMES // rf)
    batches = -(-windows // EVAL_WINDOWS)
    per_batch = len(parts_table(True)) * depth * 2 * T if on_card else 0
    want = {"auto": _expect(fused_block=per_batch * batches),
            "true": _expect(fused_attention=per_batch * batches),
            "block_t": _expect(fused_block=per_batch // 2 * batches,
                               fused_block_temporal=per_batch // 2 * batches),
            "layer": _expect(fused_layer=per_batch // 2 * batches)}
    cli = ["data.synthetic=true", "general.nolog=true",
           "data.synthetic_actions=1", f"data.synthetic_frames={EXP_FRAMES}",
           f"gpu.device={device}", f"model.dep={depth}", f"gpu.seed={seed}",
           f"ft2d.num_proposals={P}", f"ft2d.sampling_timesteps={T}",
           f"general.evaluate={ckpt}"]
    cli_log = os.path.join(workdir, "cli.log")
    launches, metrics = {}, {}
    for dtype, mode in (("float32", "auto"), ("bfloat16", "auto"),
                        ("bfloat16", "true"), ("bfloat16", "block_t"),
                        ("bfloat16", "layer")):
        run = f"{dtype}_{mode}"
        gate = (["gpu.experimental_kernels=true"]
                if mode in ("block_t", "layer") else [])
        _reset_launches()
        out = _cli(cli + gate + [f"gpu.compute_dtype={dtype}",
                                 f"gpu.use_pallas={mode}",
                                 f"general.checkpoint={workdir}/bf16_{run}"],
                   cli_log)
        launches[run] = _launch_counts()
        if launches[run] != want[mode]:
            raise AssertionError(f"bf16_eval {run}: launches "
                                 f"{launches[run]}, expected {want[mode]}")
        avg = out["final"]["all"]
        if not all(np.all(np.isfinite(v)) for v in avg.values()):
            raise AssertionError(f"bf16_eval {run}: non-finite metrics")
        metrics[run] = avg
        emit({"phase": "bf16_eval", "run": run, "P": P, "T": T,
              "depth": depth, "windows": out["windows"],
              "batches": out["batches"], "launches": launches[run],
              "eval_s": out["eval_seconds"],
              "windows_per_s": out["windows"] / out["eval_seconds"],
              "frames_per_s": out["windows"] * rf / out["eval_seconds"],
              "delta_from_float32_mm": {
                  k: float(np.abs(np.atleast_1d(v) - np.atleast_1d(
                      metrics["float32_auto"][k])).max())
                  for k, v in sorted(avg.items())},
              "final_step": {k: float(np.atleast_1d(v)[-1])
                             for k, v in sorted(avg.items())}})

    # the action's first sequence, one noise table, every prediction
    dataset = h3wb.load_dataset(synthetic=True, actions_per_subject=1,
                                frames_per_action=EXP_FRAMES)
    keypoints = h3wb.prepare_data(dataset)
    action = sorted(main_h3wb.collect_actions(dataset, ["S8"])[0].items())[0]
    seqs = list(zip(*h3wb.fetch_actions(action[1], keypoints, dataset)))[:1]
    n_win = -(-seqs[0][2].shape[0] // rf)
    r = np.random.RandomState(seed)
    table = (r.randn(n_win, P, rf, cfg.num_kps, 3).astype(np.float32),
             r.randn(n_win, T, P, rf, cfg.num_kps, 3).astype(np.float32))
    preds, seconds = {}, {}
    for dtype, modes in (("float32", ("auto",)),
                         ("bfloat16", ("auto", "true", "block_t", "layer",
                                       "plain_auto", "plain_true",
                                       "false"))):
        model = D3DP(cfg, device=device, compute_dtype=dtype)
        checkpoints.load_state(ckpt, model)
        for mode in modes:
            _set_mode(model, mode)
            t0 = time.time()
            _, pred = ev.evaluate_sequences(
                model, seqs, receptive_field=rf, num_proposals=P,
                sampling_timesteps=T, noise_table=table,
                return_predictions=True)
            seconds[f"{dtype}_{mode}"] = time.time() - t0
            if pred.shape != (n_win, T, P, rf, cfg.num_kps, 3) or not (
                    np.all(np.isfinite(pred))):
                raise AssertionError(f"bf16_eval {dtype} {mode}: "
                                     f"predictions {pred.shape}")
            preds[f"{dtype}_{mode}"] = pred
        del model
    f32, plain = preds["float32_auto"], preds["bfloat16_false"]
    vs = {}
    for mode, ref in (("auto", "auto"), ("true", "true"),
                      ("block_t", "auto"), ("layer", "auto")):
        # #3's and #4's plain versions are block_reference on the rows #1
        # would take: the plain_auto run is theirs
        got = preds[f"bfloat16_{mode}"]
        vs[mode] = {"vs_plain_versions": _pose_check(
            f"bf16_eval {mode}", got, preds[f"bfloat16_plain_{ref}"],
            BF16_POSE_TOL["eval"])}
        if mode in ("auto", "true"):
            vs[mode]["vs_false"] = _noise_check(f"bf16_eval {mode}", got,
                                                plain, f32, BF16_FLOOR * 1e-3)
        vs[mode]["vs_float32_max_mm"] = float(1e3 * np.abs(got - f32).max())
        vs[mode]["vs_float32_mean_mm"] = float(1e3 * np.abs(got - f32).mean())
    emit({"phase": "bf16_eval_vs_plain", "action": action[0],
          "windows": n_win, "P": P, "T": T, "by_mode": vs,
          "seconds": seconds})
    del preds

    # evaluate_3dhp on the seeded 3DHP model: bfloat16 at auto beside
    # float32 (timed, launches counted), then with one noise table
    _, test = dhp3.make_synthetic(num_test_seqs=2, frames=frames, seed=seed)
    per_seq = [-(-v["data_2d"].shape[0] // rf) for v in test.values()]
    calls = sum(-(-n // 64) for n in per_seq)
    blocks = 2 * depth if on_card else 0
    r = np.random.RandomState(seed)
    table = (r.randn(sum(per_seq), P, rf, 17, 3).astype(np.float32),
             r.randn(sum(per_seq), T, P, rf, 17, 3).astype(np.float32))
    res3, outs = {}, {}
    for dtype, modes in (("float32", ("auto",)),
                         ("bfloat16", ("auto", "plain_auto", "false"))):
        args = cfg_mod.parse_cli([f"gpu.device={device}", f"gpu.seed={seed}",
                                  f"model.dep={depth}",
                                  f"gpu.compute_dtype={dtype}"])
        model = main_3dhp.build_model_3dhp(args, device)
        run = f"dhp3_{dtype}_auto"
        _reset_launches()
        t0 = time.time()
        err, agg = main_3dhp.evaluate_3dhp(model, test, args,
                                           num_proposals=P,
                                           sampling_timesteps=T)
        secs = time.time() - t0
        launches[run] = _launch_counts()
        if launches[run] != _expect(fused_block=blocks * T * calls):
            raise AssertionError(f"bf16_eval {run}: launches "
                                 f"{launches[run]}")
        if not (np.all(np.isfinite(err)) and np.all(np.isfinite(agg))):
            raise AssertionError(f"bf16_eval {run}: non-finite metrics")
        res3[run] = {"P_Best": err, "P_Agg": agg}
        emit({"phase": "bf16_eval_3dhp", "run": run, "P": P, "T": T,
              "windows": sum(per_seq), "launches": launches[run],
              "seconds": secs, "windows_per_s": sum(per_seq) / secs,
              "metrics_mm": {k: v.tolist() for k, v in res3[run].items()}})
        forward = model.eval_forward
        for mode in modes:
            caught = []

            def eval_forward(*a, **kw):
                y = forward(*a, **kw)
                caught.append(y.float().cpu().numpy())
                return y

            model.eval_forward = eval_forward
            _set_mode(model, mode)
            main_3dhp.evaluate_3dhp(model, test, args, num_proposals=P,
                                    sampling_timesteps=T, noise_table=table)
            outs[f"{dtype}_{mode}"] = np.concatenate(caught)
        del model
    f32, got = outs["float32_auto"], outs["bfloat16_auto"]
    emit({"phase": "bf16_eval_3dhp_vs_plain", "windows": sum(per_seq),
          "vs_plain_versions": _pose_check("bf16_eval 3dhp", got,
                                           outs["bfloat16_plain_auto"],
                                           BF16_POSE_TOL["3dhp"]),
          "vs_false": _noise_check("bf16_eval 3dhp", got,
                                   outs["bfloat16_false"], f32, BF16_FLOOR),
          "vs_float32_max_mm": float(np.abs(got - f32).max()),
          "vs_float32_mean_mm": float(np.abs(got - f32).mean()),
          "metric_delta_from_float32_mm": float(np.abs(
              _metrics(res3["dhp3_bfloat16_auto"])
              - _metrics(res3["dhp3_float32_auto"])).max())})
    if on_card:
        torch.cuda.empty_cache()
    return launches


def bf16_train_phase(seed: int, device: str = "cuda", depth: int = 8,
                     seqs: int = TRAIN_SEQS, steps: int = TRAIN_STEPS):
    """The H3WB and the 3DHP trainers of train and dhp3_train at
    gpu.compute_dtype=bfloat16 (kernels #5/#6 on bfloat16 activations),
    through run_trainer's checks with the bfloat16 bounds against the plain
    versions; the H3WB step traced.  Returns {trainer: the launches of its
    main-path run}."""
    from pafuse_tpu_torch import skeleton as sk, train as tr
    from pafuse_tpu_torch.data import dhp3
    from pafuse_tpu_torch.data.prefetch import PrefetchingLoader
    from pafuse_tpu_torch.data.sampling import ChunkedSampler
    from pafuse_tpu_torch.diffusion import D3DPConfig

    cfg = D3DPConfig(depth=depth, drop_path_rate=0.1)
    loader, sampler = _synthetic_batches(seed, seqs, cfg.frames)
    h3wb = run_trainer(seed, device, cfg, loader, sampler, seqs, steps,
                       weights=tr.mixste_weight_table(cfg.num_kps),
                       phase="bf16_train", compute_dtype="bfloat16")
    cfg3 = D3DPConfig(num_kps=sk.NUM_JOINTS_3DHP, cs=DHP3_CS, depth=depth,
                      part_based=False, mm_scale=True, drop_path_rate=0.1)
    train, _ = dhp3.make_synthetic(num_train_seqs=DHP3_TRAIN_SEQS,
                                   frames=DHP3_FRAMES, seed=seed)
    sampler3 = ChunkedSampler(seqs, None, *dhp3.train_arrays(train),
                              cfg3.frames, augment=True,
                              flip_permutation=sk.FLIP_PERMUTATION_3DHP)
    dhp3_launches = run_trainer(
        seed, device, cfg3, PrefetchingLoader(sampler3, depth=2), sampler3,
        seqs, steps, part_based=False,
        flip_permutation=sk.FLIP_PERMUTATION_3DHP, phase="bf16_dhp3_train",
        compute_dtype="bfloat16", profile=False)
    return {"h3wb": h3wb, "dhp3": dhp3_launches}


def autodiff_train_phase(seed: int, device: str = "cuda", depth: int = 8,
                         seqs: int = TRAIN_SEQS, timed: int = 3):
    """gpu.train_kernel=false on the H3WB model at full width (depth 8, 37
    sequences, synthetic H3WB through the sampler): one step from equal
    params, t, noise and stochastic-depth masks (drawn at each block's
    rate) on the autodiff path and on kernels #5/#6, in float32 (loss and
    gradients within the train bounds) and in bfloat16 (within the
    bfloat16 ones; the kernel path's distance from float32 beside), each
    path's ms/step (median of ``timed`` more steps) and peak memory, no
    launch of #5/#6 on the autodiff path; gpu.remat=true: the same loss and
    gradients bit for bit, its peak memory beside; model.dropout=0.1: the
    loss falls on one repeated batch and two runs from one seed are
    bit-identical.  Returns {run: launches of #5/#6} of the kernel runs."""
    import dataclasses
    import numpy as np
    import torch
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.models.mixste import branch_masks
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device(device)
    lr = 6e-5
    cfg = D3DPConfig(depth=depth, drop_path_rate=0.1)
    loader, _ = _synthetic_batches(seed, seqs, cfg.frames)
    _, b3d, b2d = next(iter(loader.next_epoch()))
    b2d, _ = tr.pad_batch(b2d, seqs)
    b3d, _ = tr.pad_batch(b3d, seqs)
    weights = tr.mixste_weight_table(cfg.num_kps)
    g = torch.Generator().manual_seed(seed + 2)
    t = torch.randint(0, cfg.timesteps, (seqs,), generator=g).to(dev)
    noise = torch.randn(b3d.shape, generator=g).to(dev)
    rates = np.repeat(np.linspace(0.0, cfg.drop_path_rate, depth), 2)

    def fresh(**kw):
        model = D3DP(dataclasses.replace(cfg, **kw.pop("cfg", {})),
                     device=dev, generator=torch.Generator().manual_seed(seed),
                     **kw)
        state = tr.create_train_state(model, seed=seed, device=dev)
        return model, state, tr.build_train_step(model, state.optimizer,
                                                 weights=weights)

    masks = {s.name: [tuple(m.to(dev) for m in branch_masks(
        float(r), seqs, "cpu", g)) for r in rates]
        for s in fresh()[0].pose_estimator.specs}
    draws = dict(t=t, noise=noise, masks=masks)

    def one(**kw):
        """One step from the seeded params with ``draws``: loss, grads,
        launches, peak memory, then ms/step of ``timed`` more steps."""
        model, state, step = fresh(**kw)
        _reset_launches()
        _reset_peak(dev)
        loss = float(step(state, lr, b2d, b3d, **draws))
        launches = _launch_counts()
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else None)
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        times = []
        for _ in range(timed):
            sync(dev)
            t0 = time.time()
            float(step(state, lr, b2d, b3d, **draws))
            times.append(time.time() - t0)
        path = model.train_path
        del model, state, step
        return {"loss": loss, "grads": grads, "path": path,
                "launches": {k: launches[k] for k in ("block_train_fwd",
                                                      "block_train_bwd")},
                "peak_gb": peak,
                "ms_per_step": sorted(times)[len(times) // 2] * 1e3}

    runs = {}
    for dtype in ("float32", "bfloat16"):
        for kernel in ("true", "false"):
            runs[f"{dtype}_{kernel}"] = one(compute_dtype=dtype,
                                            train_kernel=kernel)
    runs["float32_false_remat"] = one(train_kernel="false", remat=True)
    per_step = 2 * 3 * depth if dev.type == "cuda" else 0
    for name, r in runs.items():
        want = per_step if name.endswith("_true") else 0
        if r["launches"] != {"block_train_fwd": want, "block_train_bwd": want}:
            raise AssertionError(f"autodiff_train {name}: launches "
                                 f"{r['launches']}")
        if r["path"] != ("kernels" if name.endswith("_true") else "autodiff"):
            raise AssertionError(f"autodiff_train {name}: path {r['path']}")

    def diff(a, b):
        return {"loss_rel_err": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                "max_rel_grad_err": max(_rel_err(a["grads"][n], b["grads"][n])
                                        for n in b["grads"])}

    f32 = diff(runs["float32_false"], runs["float32_true"])
    bf16 = diff(runs["bfloat16_false"], runs["bfloat16_true"])
    noise_bf16 = diff(runs["bfloat16_true"], runs["float32_true"])
    remat = runs["float32_false_remat"]
    remat_same = (remat["loss"] == runs["float32_false"]["loss"] and all(
        torch.equal(remat["grads"][n], v)
        for n, v in runs["float32_false"]["grads"].items()))
    emit({"phase": "autodiff_train", "seqs_per_step": seqs, "depth": depth,
          **{f"{k}_{f}": v[f] for k, v in runs.items()
             for f in ("loss", "ms_per_step", "peak_gb")},
          "frames_per_s": {k: seqs * cfg.frames / (v["ms_per_step"] / 1e3)
                           for k, v in runs.items()},
          "float32_vs_kernels": f32, "bfloat16_vs_kernels": bf16,
          "bfloat16_kernels_vs_float32": noise_bf16,
          "remat_bit_identical": remat_same,
          "tol": {"float32": [TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL],
                  "bfloat16": [BF16_TRAIN_LOSS_RTOL, BF16_TRAIN_GRAD_RTOL]}})
    if not (f32["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and f32["max_rel_grad_err"] <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"autodiff_train: float32 autodiff vs kernels "
                             f"{f32}")
    if not (bf16["loss_rel_err"] <= BF16_TRAIN_LOSS_RTOL
            and bf16["max_rel_grad_err"] <= BF16_TRAIN_GRAD_RTOL):
        raise AssertionError(f"autodiff_train: bfloat16 autodiff vs kernels "
                             f"{bf16}")
    if not remat_same:
        raise AssertionError("autodiff_train: remat changed the gradients")
    del runs

    # dropout: the loss falls on one repeated batch (dropout masks drawn
    # anew each step), and two runs from one seed are bit-identical
    drop = {"cfg": {"dropout": DROPOUT}}
    model, state, step = fresh(**drop)
    fit = [float(step(state, 1e-3, b2d, b3d, **draws))
           for _ in range(OVERFIT_STEPS)]
    path = model.train_path
    del model, state, step
    repeat = []
    for _ in range(2):
        model, state, step = fresh(**drop)
        repeat.append(([float(step(state, lr, b2d, b3d)) for _ in range(2)],
                       [p.detach().clone() for p in model.parameters()]))
        del model, state, step
    same = repeat[0][0] == repeat[1][0] and all(
        torch.equal(a, b) for a, b in zip(repeat[0][1], repeat[1][1]))
    emit({"phase": "autodiff_train_dropout", "dropout": DROPOUT,
          "path": path, "lr": 1e-3, "losses": fit,
          "repeat_losses": [r[0] for r in repeat], "bit_identical": same})
    if path != "autodiff" or not np.mean(fit[-4:]) < fit[0] or not same:
        raise AssertionError(f"autodiff_train: dropout path {path}, losses "
                             f"{fit}, bit-identical {same}")
    del repeat
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def mono134_train_phase(seed: int, device: str = "cuda", depth: int = 8,
                        seqs: int = TRAIN_SEQS, steps: int = TRAIN_STEPS):
    """The monolithic 134-joint H3WB model (general.part_based_model=false,
    model.cs 288, 8 heads of 36) trained on kernels #5/#6 through
    run_trainer's checks on synthetic H3WB, 37 sequences a step, the loss
    centred at the root as the CLI does: its spatial blocks' attention runs
    on the wgmma kernels (the float32 forward at 134 keys and the resident
    backward), its temporal blocks' on the mma.sync ones, whose launches
    their libraries count in the main-path run.  Returns the main-path launches and those counts (run_trainer's
    ``streams``; none on the CPU)."""
    from pafuse_tpu_torch.diffusion import D3DPConfig

    cfg = D3DPConfig(depth=depth, part_based=False, cs=MONO_CS,
                     drop_path_rate=0.1)
    loader, sampler = _synthetic_batches(seed, seqs, cfg.frames)
    wg = {}
    launches = run_trainer(seed, device, cfg, loader, sampler, seqs, steps,
                           part_based=False, phase="mono134_train",
                           profile=False, streams=wg)
    if device != "cpu" and not (wg["forward_wg"] and wg["backward_wg"]
                                and wg["backward_tc"]):
        raise AssertionError(f"mono134_train: the wgmma attention kernels did "
                             f"not run on the main path: {wg}")
    return launches, wg


# ---------------------------------------------------------------------------
# MixSTE's published model: the attention stages streamed through shared
# memory where one (sequence, head) does not fit a CTA
# ---------------------------------------------------------------------------

#: MixSTE (Zhang et al., CVPR 2022), the denoiser D3DP and PAFUSE build on:
#: 8 layers of 512 channels (8 heads of 64) over 243 frames, run as
#: general.part_based_model=false model.cs=512 model.number_of_frames=243
#: on the 134 H3WB joints, 1024 frames (4 sequences) a step
MIXSTE_CS, MIXSTE_FRAMES = 512, 243
MIXSTE_SEQS = 1024 // MIXSTE_FRAMES
MIXSTE_STEPS = 3
#: (L, d) of the attention stages alone: streamed in both dtypes (past 144
#: keys, or d above 64) the model's temporal block (243 x 64), 351 frames
#: at d = 64 and 48, and d = 128 (model.cs=1024) at 243 frames and at the
#: 134 joints; resident the model's spatial block (134 x 64: the float32
#: forward and the backward on wgmma, the bf16 forward on mma.sync)
STREAM_STAGES = ((243, 64), (351, 64), (351, 48), (243, 128), (134, 128),
                 (134, 64))
#: its serve windows for kernel #1: (frames, hypotheses); both stream the
#: temporal attention
MIXSTE_WINDOWS = ((243, 10), (351, 5))


def mixste243_phase(seed: int, depth: int = 8, steps: int = MIXSTE_STEPS):
    """MixSTE's 243-frame, 512-wide monolithic model on the card:
    (a) the attention stages alone at STREAM_STAGES (B: the model's 536
        temporal sequences, or its 972 spatial ones at 134 tokens), the
        forward in float32 and bfloat16 and the backward in float32,
        against their plain versions with a repeat bit for bit, each beside
        its bound and SDPA's time, on the route the library takes;
    (b) kernels #5/#6 against their plain versions at the model's spatial
        (972, 134, 512) and temporal (536, 243, 512) shapes, x in float32
        and bfloat16 (train_kernel_phase);
    (c) kernel #1 at its serve windows (MIXSTE_WINDOWS, flip on) against
        block_reference, float32 and bfloat16 (kernel_phase), counting the
        streamed forward's launches in its library;
    (d) ``steps`` training steps of the model at ``depth`` through
        run_trainer's checks (16 + 16 launches a step at depth 8, ms/step,
        peak memory), counting the launches of the streamed backward's two
        passes in its library, one step profiled, which must show them.
    Returns {"stages", "trains", "blocks": the rows of (a), (b), (c);
    "launches": #5/#6's in (d); "block_launches": #1's in (c); "streams":
    the streamed kernels' launches, "forward" in (c), "backward_a" and
    "backward_b" in (d)}."""
    import torch
    from pafuse_tpu_torch.diffusion import D3DPConfig
    from pafuse_tpu_torch.ops.attention_core import stream_launches
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.ops.gemm import linear_reference

    dev = torch.device("cuda")
    heads = 8
    model = [("whole_body", 134, MIXSTE_CS)]
    stages = []
    for i, (L, d) in enumerate(STREAM_STAGES):
        C = heads * d
        B = MIXSTE_SEQS * (MIXSTE_FRAMES if L == 134 else 134)
        g = torch.Generator().manual_seed(seed * 100 + 700 + i)
        p = _random_block_params(C, g, dev)
        x = torch.randn(B, L, C, generator=g).to(dev)
        fields = {"L_d": [L, d], "shapes": "mixste243"}
        for dtype in (torch.float32, torch.bfloat16):
            qkv = linear_reference(x.to(dtype), p[2], p[3], p[0:2])
            stages.append(attention_stage_row(qkv, heads, "mixste243_stage",
                                              **fields))
            del qkv
        qkv = linear_reference(x, p[2], p[3], p[0:2])
        do = torch.randn(B, L, C, generator=g).to(dev)
        stages.append(attention_bwd_stage_row(qkv, do, heads,
                                              "mixste243_stage", **fields))
        del x, qkv, do, p
        torch.cuda.empty_cache()
    emit({"phase": "mixste243_bf16_routes",
          "stages": [{k: r[k] for k in ("L_d", "route", "stream_launches",
                                        "ms", "library_ms", "bound_ms")}
                     for r in stages if r["dtype"] == "bfloat16"]})
    bad = [r for r in stages if not r["ok"]]
    if bad:
        raise AssertionError(f"mixste243: an attention stage disagrees with "
                             f"its plain version: {bad}")

    trains = train_kernel_phase(seed, MIXSTE_SEQS, frames=MIXSTE_FRAMES,
                                parts=model, phase="mixste243_kernel")
    bad = [r for r in trains if not r["ok"]]
    if bad:
        raise AssertionError(f"mixste243: a training kernel disagrees with "
                             f"its plain version: {bad}")

    fused_block.launches = 0
    stream_launches(zero=True)
    blocks = [r for frames, P in MIXSTE_WINDOWS
              for r in kernel_phase(seed, 1, P=P, frames=frames, parts=model,
                                    phase="mixste243_block")]
    streams = {"forward": stream_launches()["forward"]}
    block_launches = fused_block.launches
    bad = [r for r in blocks if not r["ok"]]
    if bad:
        raise AssertionError(f"mixste243: fused_block disagrees with "
                             f"block_reference: {bad}")

    cfg = D3DPConfig(depth=depth, part_based=False, cs=MIXSTE_CS,
                     frames=MIXSTE_FRAMES, drop_path_rate=0.1)
    loader, sampler = _synthetic_batches(seed, MIXSTE_SEQS, cfg.frames)
    torch.cuda.reset_peak_memory_stats(dev)
    trained = {}
    launches = run_trainer(seed, "cuda", cfg, loader, sampler, MIXSTE_SEQS,
                           steps, part_based=False, phase="mixste243_train",
                           streams=trained,
                           profile_groups=(ATTN_BWD_STREAM_GROUP,))
    streams.update(backward_a=trained["backward_a"],
                   backward_b=trained["backward_b"],
                   forward_wg=trained["forward_wg"])
    if not all(streams.values()):
        raise AssertionError(f"mixste243: the streamed kernels or the "
                             f"spatial blocks' wgmma forward did not run "
                             f"on the main path: {streams}")
    emit({"phase": "mixste243", "stream_launches": streams,
          "attention_bwd_stream_launches_per_step": trained["backward_a"] / steps,
          "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30})
    return {"stages": stages, "trains": trains, "blocks": blocks,
            "launches": launches, "block_launches": block_launches,
            "streams": streams}


# ---------------------------------------------------------------------------
# PR 11: data parallel (training, sharded evaluation, multi-replica serving)
# and the CLI's observability
# ---------------------------------------------------------------------------

#: a collective or a spawned rank may take this long before the phase fails
DDP_DEADLINE = 300
DDP_GLOO_DEPTH = 2              # ddp_train's two-rank gloo world
DDP_EVAL_T = 2                  # ddp_eval's DDIM steps (P=10)
#: params after the two-rank step against one process, max abs: Adam's
#: first step moves a parameter by lr * g / (|g| + eps), at most lr, so
#: where |g| is near eps a rounding-level change of g moves it by a
#: fraction of lr (a CPU rehearsal at depth 1: 0.17 x lr); half of lr 6e-5.
#: The gradients (TRAIN_LOSS_RTOL) carry the check of the averaging, which
#: Adam's scale invariance would hide.
DDP_PARAM_ATOL = 3e-5
#: ddp_eval's two-rank world against one process, relative per metric:
#: not bit for bit on the card (the 64-row batches split bit for bit, but
#: in the 12-row tail cuBLAS rounds the time MLP's second product
#: otherwise at 120 rows than at 240: the row_independence line), so
#: float32 rounding of means over ~10^6 errors.  Measured 4.3e-8 / 5.3e-8
#: at auto / true (H100 80GB HBM3, 700 W); 1e-6 is about 20x that.
DDP_EVAL_RTOL = 1e-6
OBS_STEPS = 4                   # observability: steps timed with the trace


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _launch_env():
    """torchrun's launch contract for a world of one rank (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT on a free port), restored
    after: under it ``parallel.mesh.make_mesh`` takes the launched branch
    every ``torchrun`` run takes (cuda:LOCAL_RANK, NCCL through env://;
    gloo on the CPU)."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _launched_world_of_one(device):
    """``parallel.mesh.make_mesh(device=device)`` under :func:`_launch_env`:
    yields the World and leaves its process group after."""
    from pafuse_tpu_torch.parallel import mesh
    with _launch_env():
        world = mesh.make_mesh(device=device)
        try:
            if not world.distributed:
                raise AssertionError("make_mesh under a launch started no "
                                     "process group")
            yield world
        finally:
            mesh.close(world)


def _gloo_rank(rank, port, workdir, device, job):
    """One rank of a two-rank gloo world, both ranks on ``device`` (NCCL
    refuses two ranks on one card; gloo all-reduces CUDA tensors too):
    runs ``job`` (a function of this module) on the inputs in ``workdir``
    and saves what it returns."""
    import torch
    import torch.distributed as dist
    from pafuse_tpu_torch.parallel import mesh
    from pafuse_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2, timeout=mesh.TIMEOUT)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                            weights_only=False)
        _reset_launches()
        out = globals()[job](mesh.World(rank, 2, dev, True), inputs)
        out["launches"] = _launch_counts()
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _gloo_world(workdir, device, job, inputs):
    """Run ``job`` in a two-rank gloo world of spawned processes (each
    killed at DDP_DEADLINE) and return the ranks' results."""
    import multiprocessing
    import torch
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, port, workdir, str(device), job))
             for r in range(2)]
    for p in procs:
        p.start()
    end = time.time() + DDP_DEADLINE
    for p in procs:
        p.join(max(1.0, end - time.time()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{job}: a rank failed or hung: exit codes "
                             f"{[p.exitcode for p in procs]}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]


def _train_run(cfg, seed, device, batches, weights, world=None):
    """A fresh model and AdamW from ``seed`` stepped over ``batches``:
    (losses, params, gradients of the last step, seconds a step)."""
    import torch
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DP
    model = D3DP(cfg, device=device,
                 generator=torch.Generator().manual_seed(seed))
    state = tr.create_train_state(model, seed=seed, device=device)
    step = tr.build_train_step(model, state.optimizer, weights=weights,
                               world=world)
    losses, secs = [], []
    for b2d, b3d in batches:
        t0 = time.time()
        losses.append(float(step(state, 6e-5, b2d, b3d)))   # waits
        secs.append(time.time() - t0)
    return (losses, [p.detach().clone() for p in model.parameters()],
            [p.grad.detach().clone() for p in model.parameters()], secs)


def _ddp_train_job(world, inputs):
    import torch
    losses, params, grads, _ = _train_run(
        inputs["cfg"], inputs["seed"], world.device, inputs["batches"],
        inputs["weights"], world)
    return {"losses": losses, "params": [p.cpu() for p in params],
            "grads": [g.cpu() for g in grads],
            "device": torch.cuda.get_device_name(world.device)
            if world.device.type == "cuda" else "cpu"}


def ddp_train_phase(seed: int, workdir: str, device: str = "cuda",
                    depth: int = 8, seqs: int = TRAIN_SEQS,
                    steps: int = TRAIN_STEPS, gloo_depth: int = DDP_GLOO_DEPTH):
    """Data-parallel training: the H3WB trainer at full width through
    ``parallel.mesh.replicate`` (DistributedDataParallel) in a world of one
    on NCCL (``make_mesh`` under :func:`_launch_env`), held bit for bit against the plain trainer over ``steps``
    steps of the same batches (ms/step, its overhead, the all-reduced
    gradient bytes); then a two-rank gloo world on this card at depth
    ``gloo_depth`` against one process on the global batch (36 sequences:
    37 rounded to whole shards): loss and gradients within TRAIN_LOSS_RTOL,
    params within DDP_PARAM_ATOL, the two replicas bit for bit.  Returns the
    kernel launches of the world-of-one run."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DPConfig
    from pafuse_tpu_torch.parallel import mesh

    dev = torch.device(device)
    cfg = D3DPConfig(depth=depth, drop_path_rate=0.1)
    loader, _ = _synthetic_batches(seed, seqs, cfg.frames)
    batches = []
    for _, b3d, b2d in loader.next_epoch():
        batches.append((tr.pad_batch(b2d, seqs)[0], tr.pad_batch(b3d, seqs)[0]))
        if len(batches) == steps:
            break
    weights = tr.mixste_weight_table(cfg.num_kps)
    plain = _train_run(cfg, seed, dev, batches, weights)
    with _launched_world_of_one(device) as world:
        backend = dist.get_backend()
        _reset_launches()
        ddp = _train_run(cfg, seed, world.device, batches, weights, world)
        launches = _launch_counts()
    same = plain[0] == ddp[0] and all(
        torch.equal(a, b) for a, b in zip(plain[1] + plain[2],
                                          ddp[1] + ddp[2]))
    per_step = 2 * 3 * depth if dev.type == "cuda" else 0
    n_params = sum(p.numel() for p in plain[1])
    ms = [float(np.median(r[3][1:]) * 1e3) for r in (plain, ddp)]
    emit({"phase": "ddp_train", "world": 1, "backend": backend,
          "depth": depth, "steps": steps,
          "seqs_per_step": seqs, "losses": ddp[0], "plain_losses": plain[0],
          "bit_identical": same, "ms_per_step": ms[1],
          "plain_ms_per_step": ms[0], "overhead_ms": ms[1] - ms[0],
          "params": n_params, "allreduce_bytes_per_step": 4 * n_params,
          "launches": launches})
    if not same:
        raise AssertionError("ddp_train: the world of one differs from the "
                             "plain trainer")
    if launches != _expect(block_train_fwd=per_step * steps,
                           block_train_bwd=per_step * steps):
        raise AssertionError(f"ddp_train: launches {launches}")
    del plain, ddp

    # two ranks on this card (gloo) against one process, one step
    cfg2 = D3DPConfig(depth=gloo_depth, drop_path_rate=0.1)
    g = 2 * mesh.per_rank_batch(seqs, mesh.World(size=2))
    step1 = [(b2d[:g], b3d[:g]) for b2d, b3d in batches[:1]]
    one = _train_run(cfg2, seed, dev, step1, weights)
    ranks = _gloo_world(os.path.join(workdir, "ddp_train"), dev,
                        "_ddp_train_job", {"cfg": cfg2, "seed": seed,
                                           "batches": step1,
                                           "weights": weights})
    loss_err = max(abs(r["losses"][0] - one[0][0]) / abs(one[0][0])
                   for r in ranks)
    grad_err = max(_rel_err(a.to(dev), b) for r in ranks
                   for a, b in zip(r["grads"], one[2]))
    param_err = max(float((a.to(dev) - b).abs().max()) for r in ranks
                    for a, b in zip(r["params"], one[1]))
    replicas_equal = all(torch.equal(a, b) for a, b in
                         zip(ranks[0]["params"], ranks[1]["params"]))
    per_rank = 2 * 3 * gloo_depth if dev.type == "cuda" else 0
    emit({"phase": "ddp_train_gloo", "world": 2, "backend": "gloo",
          "device": ranks[0]["device"], "depth": gloo_depth,
          "global_seqs": g, "loss": ranks[0]["losses"][0],
          "one_process_loss": one[0][0], "loss_rel_err": loss_err,
          "max_rel_grad_err": grad_err, "max_abs_param_err": param_err,
          "rtol": TRAIN_LOSS_RTOL, "param_atol": DDP_PARAM_ATOL,
          "replicas_bit_identical": replicas_equal,
          "launches_per_rank": [r["launches"] for r in ranks]})
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_LOSS_RTOL
            and param_err <= DDP_PARAM_ATOL and replicas_equal):
        raise AssertionError("ddp_train: the two-rank step differs from one "
                             "process on the global batch")
    if any(r["launches"] != _expect(block_train_fwd=per_rank,
                                    block_train_bwd=per_rank)
           for r in ranks):
        raise AssertionError("ddp_train: a rank did not run #5/#6")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def _eval_action(seed, frames=EXP_FRAMES):
    """The first synthetic S8 action: 4 cameras x ``frames`` frames."""
    from pafuse_tpu_torch.cli import main_h3wb
    from pafuse_tpu_torch.data import h3wb
    dataset = h3wb.load_dataset(synthetic=True, actions_per_subject=1,
                                frames_per_action=frames)
    keypoints = h3wb.prepare_data(dataset)
    action = sorted(main_h3wb.collect_actions(dataset, ["S8"])[0].items())[0]
    return list(zip(*h3wb.fetch_actions(action[1], keypoints, dataset)))


def _ddp_eval_job(world, inputs):
    import torch
    from pafuse_tpu_torch import evaluate as ev
    from pafuse_tpu_torch.diffusion import D3DP
    model = D3DP(inputs["cfg"], device=world.device,
                 generator=torch.Generator().manual_seed(inputs["seed"]))
    out = {}
    for mode in ("auto", "true"):
        _set_use_pallas(model, mode)
        before = _launch_counts()
        t0 = time.time()
        acc, _ = ev.evaluate_sequences(
            model, inputs["seqs"], receptive_field=27,
            num_proposals=inputs["cfg"].num_proposals,
            sampling_timesteps=inputs["cfg"].sampling_timesteps,
            world=world)
        after = _launch_counts()
        out[mode] = {"means": acc.means_mm(), "seconds": time.time() - t0,
                     "launches": {k: after[k] - before[k] for k in after}}
    return out


def ddp_eval_phase(seed: int, workdir: str, device: str = "cuda",
                   depth: int = 8, P: int = 10, T: int = DDP_EVAL_T,
                   frames: int = EXP_FRAMES):
    """Sharded evaluation: ``evaluate_sequences`` on the 76-window action of
    eval_experimental (a 64-row batch and a 12-row tail) in a world of
    one on NCCL (``make_mesh`` under :func:`_launch_env`), bit for bit against the unsharded run; then a two-rank
    gloo world on this card at use_pallas=auto (#1) and true (#2), every
    metric within DDP_EVAL_RTOL of one process.  Returns the kernel
    launches of the world-of-one run ("world1") and of rank 0's runs at
    auto and true ("world2_auto", "world2_true")."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from pafuse_tpu_torch import evaluate as ev
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig

    dev = torch.device(device)
    cfg = D3DPConfig(depth=depth, num_proposals=P, sampling_timesteps=T)
    seqs = _eval_action(seed, frames)
    model = D3DP(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    kw = dict(receptive_field=cfg.frames, num_proposals=P,
              sampling_timesteps=T)
    one, seconds = {}, {}
    for mode in ("auto", "true"):
        _set_use_pallas(model, mode)
        t0 = time.time()
        one[mode] = ev.evaluate_sequences(model, seqs, **kw)[0].means_mm()
        seconds[mode] = time.time() - t0
    _set_use_pallas(model, "auto")
    with _launched_world_of_one(device) as world:
        backend = dist.get_backend()
        _reset_launches()
        t0 = time.time()
        w1 = ev.evaluate_sequences(model, seqs, world=world, **kw)[0]
        w1_s = time.time() - t0
        launches = _launch_counts()
    w1 = w1.means_mm()
    same = all(np.array_equal(w1[k], one["auto"][k]) for k in one["auto"])
    del model
    ranks = _gloo_world(os.path.join(workdir, "ddp_eval"), dev,
                        "_ddp_eval_job", {"cfg": cfg, "seed": seed,
                                          "seqs": seqs})
    errs = {mode: max(float(np.max(np.abs(r[mode]["means"][k] - one[mode][k])))
                      for r in ranks for k in one[mode])
            for mode in one}
    rel = {mode: max(float(np.max(np.abs(r[mode]["means"][k] - one[mode][k])
                                  / np.abs(one[mode][k])))
                     for r in ranks for k in one[mode])
           for mode in one}
    bitwise = {mode: all(np.array_equal(r[mode]["means"][k], one[mode][k])
                         for r in ranks for k in one[mode]) for mode in one}
    emit({"phase": "ddp_eval", "P": P, "T": T, "depth": depth,
          "windows": sum(-(-s[2].shape[0] // cfg.frames) for s in seqs),
          "world1_backend": backend, "world1_bit_identical": same,
          "world1_seconds": w1_s,
          "one_process_seconds": seconds, "world1_launches": launches,
          "world2_max_abs_err_mm": errs, "world2_max_rel_err": rel,
          "world2_bit_identical": bitwise, "rtol": DDP_EVAL_RTOL,
          "world2_seconds": {m: [r[m]["seconds"] for r in ranks]
                             for m in one},
          "world2_launches_per_rank": {m: [r[m]["launches"] for r in ranks]
                                       for m in one}})
    if not same:
        raise AssertionError("ddp_eval: the world of one differs from the "
                             "unsharded evaluation")
    if not max(rel.values()) <= DDP_EVAL_RTOL:
        raise AssertionError(f"ddp_eval: two ranks differ from one process "
                             f"by {rel} (relative)")
    if dev.type == "cuda" and not (
            launches["fused_block"] > 0
            and all(r["auto"]["launches"]["fused_block"] > 0
                    and r["true"]["launches"]["fused_attention"] > 0
                    for r in ranks)):
        raise AssertionError(f"ddp_eval: #1/#2 did not launch: {launches}, "
                             f"{[{m: r[m]['launches'] for m in one} for r in ranks]}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"world1": launches, "world2_auto": ranks[0]["auto"]["launches"],
            "world2_true": ranks[0]["true"]["launches"]}


def serve_sharded_phase(seed: int, device: str = "cuda", cfg=None):
    """Multi-replica serving: a service with ``devices=[device, device]``
    (two replicas on this card, each its share of every sampler call's
    rows) against one replica on 27- and 405-frame requests: poses within
    SERVE_TOL (bit for bit where each replica's GEMMs see the row counts
    of the lone replica's), #1's launches counted per replica.  Returns
    the launches of #1 in the two-replica service's requests."""
    import numpy as np
    import torch
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.models.mixste import MixSTE2
    from pafuse_tpu_torch.ops.block import fused_block
    from pafuse_tpu_torch.serve import LiftingService

    cfg = cfg or D3DPConfig()
    on_card = torch.device(device).type == "cuda"

    def service(**kw):
        return LiftingService(
            D3DP(cfg, device=device,
                 generator=torch.Generator().manual_seed(seed)),
            buckets=(1, 2, 4, 8, 16), **kw)

    one, two = service(device=device), service(devices=[device, device])
    calls = [0, 0]

    def counted(fn, i):
        def block(*args, **kwargs):
            calls[i] += 1
            return fn(*args, **kwargs)
        return block

    for i, replica in enumerate(two.replicas):
        for m in replica.modules():
            if isinstance(m, MixSTE2):
                m.block_fn = counted(m.block_fn, i)
    rng = np.random.RandomState(seed)
    rows, launches = [], 0
    try:
        for frames in (27, 405):
            kp = rng.uniform(-1, 1, (frames, cfg.num_kps, 2)).astype(np.float32)
            a = one.lift(kp, seed=seed)
            calls[:] = [0, 0]
            fused_block.launches = 0
            b = two.lift(kp, seed=seed)
            launches += fused_block.launches
            if on_card and sum(calls) != fused_block.launches:
                raise AssertionError(f"serve_sharded: {calls} block calls, "
                                     f"{fused_block.launches} launches")
            err = float(np.max(np.abs(a["poses"] - b["poses"])))
            rows.append({"frames": frames, "max_abs_err": err,
                         "bit_identical": bool(np.array_equal(a["poses"],
                                                              b["poses"])),
                         "one_replica_ms": a["latency_ms"],
                         "two_replica_ms": b["latency_ms"],
                         "launches_per_replica": list(calls)})
            if not (err <= SERVE_TOL and np.all(np.isfinite(b["poses"]))):
                raise AssertionError(f"serve_sharded: {frames} frames differ "
                                     f"by {err}")
        health = two.health()
    finally:
        one.close()
        two.close()
    row_independence(seed, device, cfg)
    emit({"phase": "serve_sharded", "replicas": 2, "buckets":
          health["buckets"], "mesh_devices": health["mesh_devices"],
          "tol": SERVE_TOL, "requests": rows})
    if health["mesh_devices"] != 2:
        raise AssertionError("serve_sharded: mesh_devices != 2")
    if on_card and not all(r["launches_per_replica"][0] > 0 for r in rows):
        raise AssertionError("serve_sharded: replica 0 launched no #1")
    if on_card and rows[-1]["launches_per_replica"][1] == 0:
        raise AssertionError("serve_sharded: replica 1 launched no #1")
    return launches


def row_independence(seed: int, device: str, cfg):
    """Whether splitting a sampler call's rows can change a row's result:
    kernel #1 on a body spatial block's rows at serve bucket 16 against
    the first half of them alone (bucket 8), and F.linear (cuBLAS) at the
    row counts of the model's library products (embedding, time MLP,
    head) at bucket 16 and at ddp_eval's 12-row tail (the time MLP's two
    products at 240 rows) against half of them; emitted, not asserted
    (serve_sharded and ddp_eval bound the end result)."""
    import torch
    import torch.nn.functional as F
    from pafuse_tpu_torch.ops.block import fused_block

    g = torch.Generator().manual_seed(seed)
    dev = torch.device(device)
    P, C, L = cfg.num_proposals, 384, 24
    seqs = 16 * P * 2 * cfg.frames          # bucket 16, P, flip, frames
    x = torch.randn(seqs, L, C, generator=g).to(dev)
    p = _random_block_params(C, g, dev)
    launches = fused_block.launches
    half = seqs // 2
    block_same = torch.equal(fused_block(x, p[:12], p[12:], 8)[:half],
                             fused_block(x[:half], p[:12], p[12:], 8))
    fused_block.launches = launches        # comparison launches
    linear = {}
    for name, (M, K, N) in (("embedding", (seqs * L, 5, C)),
                            ("time_mlp", (16 * P * 2, C, 2 * C)),
                            ("head", (seqs * L, C, 3)),
                            ("time_mlp_fc1_tail12", (12 * P * 2, C, 2 * C)),
                            ("time_mlp_fc2_tail12", (12 * P * 2, 2 * C, C))):
        a = torch.randn(M, K, generator=g).to(dev)
        w = (torch.randn(N, K, generator=g) * K ** -0.5).to(dev)
        b = torch.zeros(N, device=dev)
        linear[name] = torch.equal(F.linear(a, w, b)[:M // 2],
                                   F.linear(a[:M // 2], w, b))
    emit({"phase": "row_independence", "fused_block_16_vs_8": block_same,
          "library_linear_half_rows_equal": linear})


#: the JAX CLI's TensorBoard tags (pafuse_tpu/cli/main_h3wb.py:128-129,
#: 334-339), the misspelt "learing" included
JAX_TAGS = ("description", "command", "Loss/3d training loss",
            "Loss/3d validation loss", "Parameters/learing rate",
            "Parameters/training time per epoch")


def observability_phase(seed: int, workdir: str, device: str = "cuda",
                        depth: int = 8, steps: int = OBS_STEPS):
    """The CLI's observability at full width: a one-epoch quick-debug
    training run, launched as torchrun launches a world of one
    (:func:`_launch_env`: the CLI's ``make_mesh`` starts NCCL, training
    runs through DDP and evaluation through the sharded path), without
    general.nolog and with gpu.profile=true, writes a
    TensorBoard event file holding the JAX CLI's tags and a Chrome trace;
    then ``steps`` steps of the CLI's loop (``train.run_epoch``) timed with
    and without ``utils.observability.profile_trace``.  Returns the kernel
    launches of the CLI run."""
    import glob
    import torch
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.utils import observability as obs
    from pafuse_tpu_torch.utils.device import sync

    dev = torch.device(device)
    out_dir = os.path.join(workdir, "observability")
    os.makedirs(out_dir, exist_ok=True)
    _reset_launches()
    cli_log = os.path.join(workdir, "obs_cli.log")
    with _launch_env():
        _cli(["data.synthetic=true", f"gpu.device={device}",
              f"model.dep={depth}", f"gpu.seed={seed}", "ft2d.debug=true",
              "model.epochs=1", "ft2d.num_proposals=2",
              "ft2d.sampling_timesteps=2", "gpu.profile=true",
              f"general.log={out_dir}/log", f"general.checkpoint={out_dir}"],
             cli_log)
    launches = _launch_counts()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    logs = [cli_log] + glob.glob(os.path.join(out_dir, "log_*", "*.log"))
    launched = any(f"rank 0 of 1 ({backend})" in open(p).read() for p in logs)
    events = glob.glob(os.path.join(out_dir, "log_*", "events.out.tfevents*"))
    data = b"".join(open(p, "rb").read() for p in events)
    missing = [t for t in JAX_TAGS if t.encode() not in data
               and t.replace(" ", "_").encode() not in data]
    trace = os.path.join(out_dir, "profile", "trace.json")
    trace_mb = os.path.getsize(trace) / 2 ** 20 if os.path.exists(trace) else 0

    cfg = D3DPConfig(depth=depth, drop_path_rate=0.1)
    loader, _ = _synthetic_batches(seed, TRAIN_SEQS, cfg.frames)
    batches = []
    for batch in loader.next_epoch():
        batches.append(batch)
        if len(batches) == steps + 1:
            break
    model = D3DP(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    state = tr.create_train_state(model, seed=seed, device=dev)
    step = tr.build_train_step(model, state.optimizer)
    tr.run_epoch(step, state, 6e-5, batches[:1], TRAIN_SEQS)   # warm
    seconds = {}
    for traced in (False, True, True, False):
        ctx = (obs.profile_trace(os.path.join(workdir, "obs_trace"), dev)
               if traced else contextlib.nullcontext())
        sync(dev)
        t0 = time.time()
        with ctx:
            tr.run_epoch(step, state, 6e-5, batches[1:], TRAIN_SEQS)
            sync(dev)
        seconds.setdefault("traced" if traced else "plain", []).append(
            time.time() - t0)
    emit({"phase": "observability", "launched_world": launched,
          "event_files": len(events),
          "missing_tags": missing, "trace_mb": trace_mb,
          "cli_launches": launches, "steps": steps,
          "epoch_s_plain": seconds["plain"], "epoch_s_traced": seconds["traced"],
          "trace_overhead": min(seconds["traced"]) / min(seconds["plain"]) - 1})
    if not events or missing or not trace_mb:
        raise AssertionError(f"observability: event files {events}, missing "
                             f"tags {missing}, trace {trace_mb} MB")
    if not launched or torch.distributed.is_initialized():
        raise AssertionError(f"observability: the CLI did not run (and "
                             f"leave) a launched {backend} world of one")
    if dev.type == "cuda" and not (launches["block_train_fwd"] > 0
                                   and launches["fused_block"] > 0):
        raise AssertionError(f"observability: launches {launches}")
    del model, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Packed parts, the native batcher on the training path and the dry run
# ---------------------------------------------------------------------------

#: packed_serve: ddim_sample on the packed parts against the unpacked
#: plain path (use_pallas=false) from one injected noise table, float32:
#: tests/test_packed.py's bounds (each network within ~1e-6, T steps
#: feeding back)
PACKED_ATOL, PACKED_RTOL = 2e-5, 1e-4
#: dryrun: entry()'s step on kernel #1 against use_pallas=false on the
#: card, max abs on x_start (clamped to [-1.1, 1.1]): kernel #1's float32
#: bound (1e-4 a block); 16 blocks a part network, each within ~1e-6
DRYRUN_TOL = 1e-4
NATIVE_STEPS = 6                # native_batcher: steps of the CLI's loop


def packed_serve_phase(seed: int, device: str = "cuda", cfg=None,
                       hold_windows: int = 4):
    """Packed parts at full width (the D3DPConfig defaults: widths 384 /
    224 / 256 padded to one (68, 384)): LiftingService on
    D3DP(packed_parts=True, experimental_kernels=True) against the same
    weights unpacked at use_pallas=auto (kernel #1), P=10, T=5, flip-TTA,
    buckets 1..16, float32 and bfloat16: 27- and 405-frame (bucket 16)
    latency and frames/s and the peak memory of each service; no launch of
    #1-#6 while a packed service runs (its products are PyTorch's
    ``bmm``).  Then ``ddim_sample`` on ``hold_windows`` windows with one
    injected noise table, packed against the unpacked plain path
    (use_pallas=false), float32, within PACKED_ATOL / PACKED_RTOL.  A CPU
    rehearsal passes device="cpu" and a small cfg.  Returns the launches
    of the packed services' runs."""
    import numpy as np
    import torch
    from pafuse_tpu_torch import skeleton as sk
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.serve import LiftingService

    cfg = cfg or D3DPConfig()
    dev = torch.device(device)
    rng = np.random.RandomState(seed + 12)
    kp = {frames: _kp(rng, frames, cfg.num_kps) for frames in (27, 405)}
    packed_launches = {}
    for dtype in ("float32", "bfloat16"):
        for name, packed in (("packed", True), ("unpacked_auto", False)):
            model = D3DP(cfg, device=dev,
                         generator=torch.Generator().manual_seed(seed),
                         packed_parts=packed, experimental_kernels=packed,
                         compute_dtype=dtype)
            svc = LiftingService(model, buckets=(1, 2, 4, 8, 16),
                                 device=dev)
            # warm the buckets the timed requests use; a packed 405-frame
            # request (~14 s) is its bucket's first call, whose cuBLAS
            # heuristics and allocator growth take milliseconds
            for frames in (27,) if packed else (27, 405):
                svc.lift(kp[frames], seed=seed)
            _reset_peak(dev)
            _reset_launches()
            row = {"phase": "packed_serve", "model": name,
                   "compute_dtype": dtype}
            for frames in (27, 405):
                res = svc.lift(kp[frames], seed=seed)
                if (res["poses"].shape != (frames, cfg.num_kps, 3)
                        or not np.all(np.isfinite(res["poses"]))):
                    raise AssertionError(f"packed_serve {name} {dtype}: "
                                         f"{frames} frames gave bad poses")
                row[f"latency_ms_{frames}"] = res["latency_ms"]
                row[f"frames_per_s_{frames}"] = frames / (
                    res["latency_ms"] / 1e3)
            launches = _launch_counts()
            if packed:
                packed_launches[dtype] = launches
                if any(launches.values()):
                    raise AssertionError(f"packed_serve: the packed service "
                                         f"launched kernels: {launches}")
            elif dev.type == "cuda" and not launches["fused_block"]:
                raise AssertionError(f"packed_serve: unpacked auto launched "
                                     f"no #1: {launches}")
            emit({**row, "launches": launches,
                  "peak_gb": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                              if dev.type == "cuda" else None)})
            svc.close()
            del svc, model
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    # the packed sampler against the unpacked plain path, one noise table
    P, T, F, N = (cfg.num_proposals, cfg.sampling_timesteps, cfg.frames,
                  cfg.num_kps)
    x2d = rng.uniform(-1, 1, (hold_windows, F, N, 2)).astype(np.float32)
    x2d_flip = (x2d[:, :, sk.FLIP_PERMUTATION] * [-1, 1]).astype(np.float32)
    init = rng.randn(hold_windows, P, F, N, 3).astype(np.float32)
    steps = rng.randn(T, hold_windows, P, F, N, 3).astype(np.float32)
    out = {}
    for name, packed in (("packed", True), ("false", False)):
        model = D3DP(cfg, device=dev,
                     generator=torch.Generator().manual_seed(seed),
                     packed_parts=packed, experimental_kernels=packed,
                     use_pallas="auto" if packed else "false")
        _reset_launches()
        out[name] = model.ddim_sample(
            *(torch.as_tensor(a, device=dev) for a in (x2d, x2d_flip)),
            init_noise=torch.as_tensor(init, device=dev),
            step_noise=torch.as_tensor(steps, device=dev)).cpu().numpy()
        if any(_launch_counts().values()):
            raise AssertionError(f"packed_serve hold: {name} launched "
                                 f"kernels: {_launch_counts()}")
        del model
    err = np.abs(out["packed"] - out["false"])
    ok = bool(np.all(err <= PACKED_ATOL + PACKED_RTOL * np.abs(out["false"])))
    emit({"phase": "packed_serve_vs_false", "windows": hold_windows,
          "P": P, "T": T, "max_abs_err": float(err.max()),
          "atol": PACKED_ATOL, "rtol": PACKED_RTOL, "ok": ok})
    if not ok:
        raise AssertionError(f"packed_serve: packed ddim_sample vs false: "
                             f"{err.max()}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return packed_launches


def native_batcher_phase(seed: int, workdir: str, device: str = "cuda",
                         depth: int = 8, steps: int = NATIVE_STEPS,
                         overrides=()):
    """The native batcher (pafuse_tpu_torch/runtime, built with g++ at its
    first use, the build phase's :func:`batcher_library`): the H3WB CLI
    (cli.main_h3wb.main, synthetic data, full width, P=1, T=1) run with
    its training loop cut to ``steps`` steps: its sampler on the native
    path; one of its batches assembled natively and with NumPy, bit for
    bit, host ms per batch of each; the loop's steady ms per step (the
    median interval after the first).  A CPU rehearsal passes
    device="cpu", a small depth and CLI ``overrides``.  Returns the kernel
    launches of the CLI run."""
    import itertools
    import numpy as np
    from pafuse_tpu_torch import runtime, train as tr
    from pafuse_tpu_torch.data import sampling

    lib_path = batcher_library()

    samplers, timing = [], {}
    real_init, real_epoch = sampling.ChunkedSampler.__init__, tr.run_epoch

    def spy_init(self, *a, **kw):
        real_init(self, *a, **kw)
        samplers.append(self)

    def cut_epoch(step, state, lr, batches, seqs_per_batch, **kw):
        marks = []
        kw["progress"] = lambda it: marks.append(time.time())
        t0 = time.time()
        out = real_epoch(step, state, lr, itertools.islice(batches, steps),
                         seqs_per_batch, **kw)
        batches.close()                       # stop the prefetch thread
        timing.update(seconds=time.time() - t0, marks=marks)
        return out

    out_dir = os.path.join(workdir, "native_batcher")
    os.makedirs(out_dir, exist_ok=True)
    sampling.ChunkedSampler.__init__ = spy_init
    tr.run_epoch = cut_epoch
    _reset_launches()
    try:
        _cli(["data.synthetic=true", f"gpu.device={device}",
              f"model.dep={depth}", f"gpu.seed={seed}", "model.epochs=1",
              "experiment.no_eval=true", "ft2d.num_proposals=1",
              "ft2d.sampling_timesteps=1", "general.nolog=true",
              f"general.checkpoint={out_dir}", *overrides],
             os.path.join(workdir, "native_cli.log"))
    finally:
        sampling.ChunkedSampler.__init__ = real_init
        tr.run_epoch = real_epoch
    launches = _launch_counts()
    if len(samplers) != 1 or samplers[0]._native is not runtime.assemble_batch:
        raise AssertionError(f"native_batcher: the CLI's samplers "
                             f"{[s._native for s in samplers]}")
    gen = samplers[0]

    # one CLI batch, assembled natively and with NumPy
    order = np.arange(len(gen.pairs))
    times = {}
    batches = {}
    for path in ("native", "numpy"):
        gen._native = runtime.assemble_batch if path == "native" else None
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            batches[path] = gen._batch(order, 0)
            ts.append(time.perf_counter() - t0)
        times[path] = sorted(ts)[2] * 1e3
    gen._native = runtime.assemble_batch
    same = all(np.array_equal(a, b)
               for a, b in zip(batches["native"], batches["numpy"]))
    # the loop reads step i-1's loss after queueing step i, so in steady
    # state the calls of progress(i) are one step apart; the first
    # interval holds the fresh model's first step
    marks = timing["marks"]
    per_step = [b - a for a, b in zip(marks, marks[1:])]
    steady = sorted(per_step[1:])[len(per_step[1:]) // 2]
    emit({"phase": "native_batcher", "library": os.path.relpath(
              lib_path, os.path.dirname(os.path.abspath(__file__))),
          "cli_sampler_native": True,
          "batch_shape_2d": list(batches["native"][2].shape),
          "native_ms_per_batch": times["native"],
          "numpy_ms_per_batch": times["numpy"], "bit_equal": same,
          "steps": steps, "loop_seconds": timing["seconds"],
          "ms_per_step": 1e3 * steady,
          "ms_between_steps": [1e3 * s for s in per_step],
          "host_cpus": os.cpu_count(),
          "launches": launches})
    if not same:
        raise AssertionError("native_batcher: native and NumPy batches "
                             "differ")
    if device != "cpu" and not (launches["block_train_fwd"] > 0
                                and launches["block_train_bwd"] > 0):
        raise AssertionError(f"native_batcher: launches {launches}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def batcher_library() -> str:
    """The native batcher's library path, built (at its first use in this
    process) and loaded; raises without a C++ compiler."""
    import shutil as sh
    from pafuse_tpu_torch import runtime
    cxx = sh.which(runtime.CXX)
    if cxx is None or runtime.get_library() is None:
        raise AssertionError(f"no {runtime.CXX} on the PATH: the native "
                             f"batcher cannot build")
    path = runtime.library_path(cxx)
    if not (os.path.isfile(path) and path.startswith(runtime.BUILD_ROOT)):
        raise AssertionError(f"the native batcher is not at {path}")
    return path


def _dryrun_job(world, inputs):
    from pafuse_tpu_torch import dryrun
    return {"result": dryrun.dryrun_multichip(world.size, world=world)}


def dryrun_phase(seed: int, workdir: str, device: str = "cuda"):
    """pafuse_tpu_torch.dryrun on the card: entry()'s step (the flagship
    model at P=4, flip-TTA) at use_pallas=auto (kernel #1) against the same
    step at use_pallas=false within DRYRUN_TOL; dryrun_multichip(1) in a
    world of one launched as torchrun launches it (make_mesh: NCCL), and
    dryrun_multichip(2) in two gloo ranks sharing the card; the two ranks
    return one result.  Returns the launches of each run."""
    import numpy as np
    import torch
    from pafuse_tpu_torch import dryrun

    fn, args = dryrun.entry(device)
    model = args[0]
    fn(*args)                                   # warm-up
    _reset_launches()
    t0 = time.time()
    got = fn(*args).cpu().numpy()               # waits
    entry_s = time.time() - t0
    entry_launches = _launch_counts()
    _set_use_pallas(model, "false")
    want = fn(*args).cpu().numpy()
    _set_use_pallas(model, "auto")
    err = float(np.abs(got - want).max())
    blocks = len(model.pose_estimator.specs) * model.cfg.depth * 2
    emit({"phase": "dryrun_entry", "shape": list(got.shape),
          "max_abs_err_vs_false": err, "tol": DRYRUN_TOL,
          "ms": entry_s * 1e3, "launches": entry_launches})
    if device != "cpu" and entry_launches != _expect(fused_block=blocks):
        raise AssertionError(f"dryrun entry: launches {entry_launches}")
    if not (got.shape == (2, 4, 27, 134, 3) and err <= DRYRUN_TOL):
        raise AssertionError(f"dryrun entry: {got.shape}, {err}")
    del fn, args, model

    _reset_launches()
    t0 = time.time()
    with _launched_world_of_one(device) as world:
        one = dryrun.dryrun_multichip(1, world=world)
    one_s = time.time() - t0
    world1 = _launch_counts()
    two = _gloo_world(os.path.join(workdir, "dryrun2"), device, "_dryrun_job",
                      {})
    world2 = [r.pop("launches") for r in two]
    results = [r["result"] for r in two]
    for r in [one] + results:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["J_Best"])
                and r["poses"] == (18, 134, 3) and r["stream_emits"] == 3
                and r["num_hypotheses_1x1"] == 1):
            raise AssertionError(f"dryrun_multichip: {r}")
    if results[0] != results[1]:
        raise AssertionError(f"dryrun_multichip(2): the ranks differ: "
                             f"{results}")
    emit({"phase": "dryrun_multichip", "world1": {**one, "seconds": one_s,
                                                  "launches": world1},
          "world2_gloo": {**results[0], "launches": world2}})
    if device != "cpu" and not all(
            c["fused_block"] and c["block_train_fwd"] and c["block_train_bwd"]
            for c in (world1, world2[0])):
        raise AssertionError(f"dryrun_multichip: launches {world1}, "
                             f"{world2}")
    if device != "cpu":
        torch.cuda.empty_cache()
    return {"entry": entry_launches, "world1": world1, "world2": world2}


def _sums(cases):
    """Float32 numbers of ``cases`` summed (max_abs_err: the largest)."""
    f32 = [c for c in cases if c["dtype"] == "float32"]
    bound_by = max(("operations", "bytes"), key=lambda b: sum(
        c["bound_ms"] for c in f32 if c["bound_by"] == b))
    return {"max_abs_err": max(c["max_abs_err"] for c in f32),
            "ms": sum(c["ms"] for c in f32),
            "plain_ms": sum(c["plain_ms"] for c in f32),
            "bound_ms": sum(c["bound_ms"] for c in f32),
            "bound_by": bound_by,
            "simt_bound_ms": sum(c["simt_bound_ms"] for c in f32),
            "library_ms": sum(c["library_ms"] for c in f32)}


def _kernel_entry(name, route, source, replaces, launches, cases, **extra):
    """One entry of the kernels line: float32 numbers summed over the
    main-path shapes."""
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches, **_sums(cases),
            **extra}


def wgrad_cases(cases):
    """The float32 block_train_bwd rows of ``cases`` as rows of #6's weight-
    and bias-gradient stage alone (backward_gemm_times' wgrad_* numbers)."""
    return [{"dtype": "float32", "kind": c.get("kind"), "B": c["B"],
             "L": c["L"], "C": c["C"],
             **{k: c[f"wgrad_{k}"] for k in ("max_abs_err", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "simt_bound_ms", "library_ms")},
             "ms": c["wgrad_ms"]}
            for c in cases
            if c["name"] == "block_train_bwd" and c["dtype"] == "float32"]


def _dhp3(cases, launches, windows=None):
    """The 3DHP shapes of a kernel's entry: its float32 sums over
    ``cases`` (those of ``windows`` windows when given) and its launches on
    each 3DHP path."""
    picked = [c for c in cases if windows is None or c["windows"] == windows]
    return {"dhp3": {**_sums(picked), "launches": launches,
                     "shapes": sorted({f'{c["kind"]} ({c["B"]}, {c["L"]}, '
                                       f'{c["C"]})' for c in picked})}}


def emit_gemm_sums(cases, phase):
    """One line of the GEMM's sums per (shapes, dtype): ms, library ms,
    bound ms and the TFLOP/s of each."""
    sums = {}
    for c in cases:
        key = f'{c["shapes"]}_{c["dtype"]}'
        tot = sums.setdefault(key, {"ms": 0.0, "library_ms": 0.0,
                                    "bound_ms": 0.0, "flop": 0})
        for k in ("ms", "library_ms", "bound_ms"):
            tot[k] += c[k]
        tot["flop"] += 2 * c["M"] * c["N"] * c["K"]
    emit({"phase": phase, "source": GEMM_SOURCE, "sums": {
        k: {**v, "tflops": v["flop"] / v["ms"] / 1e9,
            "library_tflops": v["flop"] / v["library_ms"] / 1e9}
        for k, v in sums.items()}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, inputs and requests")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    run_start = time.time()
    from pafuse_tpu_torch.ops import _build
    from pafuse_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.time()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": sorted(libs)})
    # the native batcher (g++), built at its first use: here
    from pafuse_tpu_torch import runtime
    cxx = shutil.which(runtime.CXX)
    prebuilt = bool(cxx) and os.path.exists(runtime.library_path(cxx))
    t0 = time.time()
    batcher = batcher_library()
    emit({"phase": "build_batcher", "seconds": time.time() - t0,
          "library": os.path.relpath(batcher, os.path.dirname(
              os.path.abspath(__file__))), "built_in_this_run": not prebuilt})

    # wall seconds of the phases from 3DHP on
    def timed(name, fn, *a, **kw):
        t0 = time.time()
        out = fn(*a, **kw)
        emit({"phase": f"{name}_seconds", "seconds": time.time() - t0})
        return out

    gemm_cases = (gemm_kernel_phase(args.seed, 16, P=10, frames=27,
                                    shapes="serve")
                  + gemm_kernel_phase(args.seed, EVAL_WINDOWS, P=10,
                                      frames=27, shapes="eval"))
    bad = [c for c in gemm_cases if not c["ok"]]
    if bad:
        raise AssertionError(f"fused_linear disagrees with linear_reference: "
                             f"{bad}")
    emit_gemm_sums(gemm_cases, "gemm")
    cases = kernel_phase(args.seed, windows=16, P=10, frames=27, stages=True)
    stage_cases = attention_stage_phase(args.seed, windows=16, P=10,
                                        frames=27)
    bad = [c for c in stage_cases if not c["ok"]]
    if bad:
        raise AssertionError(f"attention_core disagrees with "
                             f"attention_core_reference: {bad}")
    launches, svc, kp27, poses27 = serve_phase(args.seed)
    launches += serve_concurrent_phase(svc, args.seed)
    modes_launches, modes = serve_modes_phase(svc, kp27, poses27, args.seed)
    launches += modes_launches
    launches += serve_stream_phase(modes, args.seed)
    launches += serve_http_phase(args.seed)
    launches += serve_profile_phase(svc, modes, args.seed)
    bf16_serve_launches = timed("bf16_serve", bf16_serve_phase, args.seed,
                                svc)
    svc.close()
    modes.close()
    del svc, modes
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"fused_block disagrees with block_reference: {bad}")
    train_cases = train_kernel_phase(args.seed, TRAIN_SEQS, frames=27)
    bad = [c for c in train_cases if not c["ok"]]
    if bad:
        raise AssertionError(f"a training kernel disagrees with its plain "
                             f"version: {bad}")
    train_kinds = {}
    train_launches = train_phase(args.seed, kinds=train_kinds)
    attn_cases = attention_kernel_phase(args.seed, EVAL_WINDOWS, P=10,
                                        frames=27)
    serve_attn = attention_kernel_phase(args.seed, windows=16, P=10,
                                        frames=27, dtypes=("float32",),
                                        shapes="serve")
    bad = [c for c in attn_cases + serve_attn if not c["ok"]]
    if bad:
        raise AssertionError(f"fused_attention (or its attention stage) "
                             f"disagrees with its plain version: {bad}")
    # #2's attention stage alone at the window-batch-64 and bucket-16 rows
    attn_stage = [c for c in attn_cases + serve_attn
                  if c["name"] == "attention_core"]
    attn_cases, serve_attn = ([c for c in cs if c["name"] == "fused_attention"]
                              for cs in (attn_cases, serve_attn))
    bt_cases = block_temporal_kernel_phase(args.seed, EVAL_WINDOWS, P=10,
                                           frames=27, dtypes=("float32",),
                                           shapes="eval")
    serve_bt = block_temporal_kernel_phase(args.seed, windows=16, P=10,
                                           frames=27)
    layer_cases = layer_kernel_phase(args.seed, EVAL_WINDOWS, P=10,
                                     frames=27, dtypes=("float32",),
                                     shapes="eval")
    serve_layer = layer_kernel_phase(args.seed, windows=16, P=10, frames=27)
    bad = [c for c in bt_cases + serve_bt + layer_cases + serve_layer
           if not c["ok"]]
    if bad:
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{bad}")
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    # depth 4 for eval and eval_experimental, as for in_the_wild below: the
    # run's time limit
    eval_launches = eval_phase(args.seed, workdir, depth=4)
    exp_launches = eval_experimental_phase(args.seed, workdir, depth=4)

    # the 3DHP model (one network: 17 joints, model.cs 288, d = 36), the
    # in-the-wild and the draw paths
    def dhp3_kernels():
        parts = [("whole_body", 17, DHP3_CS)]
        blocks = [c for w in (DHP3_EVAL_WINDOWS, 38, 16) for c in kernel_phase(
            args.seed, w, P=10, frames=27, parts=parts, phase="dhp3_kernel")]
        gemms = gemm_kernel_phase(args.seed, DHP3_EVAL_WINDOWS, P=10,
                                  frames=27, shapes="dhp3_eval", parts=parts,
                                  phase="dhp3_kernel")
        trains = train_kernel_phase(args.seed, TRAIN_SEQS, frames=27,
                                    parts=parts, phase="dhp3_kernel")
        attns = attention_kernel_phase(args.seed, DHP3_EVAL_WINDOWS, P=10,
                                       frames=27, dtypes=("float32",),
                                       shapes="dhp3_eval", parts=parts,
                                       phase="dhp3_kernel")
        emit_gemm_sums(gemms, "dhp3_gemm")
        bad = [c for c in blocks + gemms + trains + attns if not c["ok"]]
        if bad:
            raise AssertionError(f"a kernel disagrees with its plain version "
                                 f"at the 3DHP shapes: {bad}")
        return blocks, trains, attns

    dhp3_blocks, dhp3_train, dhp3_attn = timed("dhp3_kernel", dhp3_kernels)
    dhp3_attn = [c for c in dhp3_attn if c["name"] == "fused_attention"]
    dhp3_kinds = {}
    dhp3_train_launches = timed("dhp3_train", dhp3_train_phase, args.seed,
                                kinds=dhp3_kinds)
    dhp3_launches = timed("dhp3_eval", dhp3_eval_phase, args.seed, workdir)
    # depth 4 for in_the_wild, draw, ddp_eval and packed_serve, as for
    # bf16_eval below: the run's time limit, which the attention stages'
    # build (attention_core.cu, ~100-140 s) takes a share of
    itw_launches = timed("in_the_wild", in_the_wild_phase, args.seed, workdir,
                         depth=4)
    draw_launches = timed("draw", draw_phase, args.seed, depth=4)
    # bfloat16 model compute, the autodiff path, the monolithic 134-joint
    # model in training
    # depth 4 for the run's time limit; the bfloat16 bounds hold the more
    # easily at half the depth
    bf16_eval_launches = timed("bf16_eval", bf16_eval_phase, args.seed,
                               workdir, depth=4)
    shutil.rmtree(workdir, ignore_errors=True)
    bf16_train_launches = timed("bf16_train", bf16_train_phase, args.seed)
    timed("autodiff_train", autodiff_train_phase, args.seed)
    mono_cases = timed("mono134_kernel", train_kernel_phase, args.seed,
                       TRAIN_SEQS, frames=27,
                       parts=[("whole_body", 134, MONO_CS)],
                       phase="mono134_kernel")
    bad = [c for c in mono_cases if not c["ok"]]
    if bad:
        raise AssertionError(f"a training kernel disagrees with its plain "
                             f"version at the monolithic shapes: {bad}")
    mono_launches, mono_wg = timed("mono134_train", mono134_train_phase,
                                   args.seed)
    # MixSTE's 243-frame, 512-wide model: the streamed attention stages
    m243 = timed("mixste243", mixste243_phase, args.seed)
    # data parallel on torch.distributed and the CLI's observability
    ddp_train_launches = timed("ddp_train", ddp_train_phase, args.seed,
                               workdir)
    ddp_eval_launches = timed("ddp_eval", ddp_eval_phase, args.seed, workdir,
                              depth=4)
    sharded_launches = timed("serve_sharded", serve_sharded_phase, args.seed)
    obs_launches = timed("observability", observability_phase, args.seed,
                         workdir)
    # packed parts, the native batcher on the CLI's training loop, the dry
    # run
    from pafuse_tpu_torch.diffusion import D3DPConfig
    packed_launches = timed("packed_serve", packed_serve_phase, args.seed,
                            cfg=D3DPConfig(depth=4))
    native_launches = timed("native_batcher", native_batcher_phase,
                            args.seed, workdir)
    dryrun_launches = timed("dryrun", dryrun_phase, args.seed, workdir)
    shutil.rmtree(workdir, ignore_errors=True)

    def bf16(cs):
        cs = [c for c in cs if c["dtype"] == "bfloat16"]
        return {f"{k}_bf16": (max if k == "max_abs_err" else sum)(
            c[k] for c in cs) for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "library_ms")}

    def serve16(cs, keys=("ms", "plain_ms", "library_ms", "bound_ms")):
        cs = [c for c in cs if c["dtype"] == "float32"]
        return {f"serve_bucket16_{k}": sum(c[k] for c in cs) for k in keys}

    def f32_sums(cs, keys):
        cs = [c for c in cs if c["dtype"] == "float32"]
        return {k: sum(c[k] for c in cs) for k in keys}

    def replaced(cs):
        return sum(c["replaced_ms"] for c in cs if c["dtype"] == "float32")

    def tpe(cs, with_tpe):
        return [c for c in cs if c["tpe"] == with_tpe]

    def mono134(name, launches):
        cs = [c for c in mono_cases if c["name"] == name]
        return {"mono134": {**_sums(cs), **bf16(cs), "launches": launches,
                            "shapes": sorted({f'({c["B"]}, {c["L"]}, '
                                              f'{c["C"]})' for c in cs})}}

    def mixste243(cases, name, launches):
        cs = [c for c in cases if c["name"] == name]
        return {"mixste243": {**_sums(cs), **bf16(cs), "launches": launches,
                              "shapes": sorted({f'({c["B"]}, {c["L"]}, '
                                                f'{c["C"]})' for c in cs})}}

    def streamed(name):
        return [c for c in m243["stages"] if c["name"] == name
                and c["route"] == "streamed"]

    def spatial(name):
        # mixste243's spatial stage alone (134 x 64), float32
        return [c for c in m243["stages"] if c["name"] == name
                and c["L"] == 134 and c["C"] == 512
                and c["dtype"] == "float32"]

    def _packed(launches, name):
        return {f"packed_serve_{dtype}": c[name]
                for dtype, c in launches.items()}

    def _dryrun(launches, name):
        return {"dryrun_entry": launches["entry"][name],
                "dryrun_world1_nccl": launches["world1"][name],
                "dryrun_world2_gloo_rank0": launches["world2"][0][name]}

    fwd = [c for c in train_cases if c["name"] == "block_train_fwd"]
    bwd = [c for c in train_cases if c["name"] == "block_train_bwd"]
    bf16_train = {f"bf16_{k}": v for k, v in bf16_train_launches.items()}
    dhp3_fwd = [c for c in dhp3_train if c["name"] == "block_train_fwd"]
    dhp3_bwd = [c for c in dhp3_train if c["name"] == "block_train_bwd"]
    cli_launches = {run: dhp3_launches[run] for run in ("cli_train",
                                                        "cli_evaluate")}
    emit({"phase": "run", "seconds": time.time() - run_start})
    # float32 numbers summed over each kernel's main-path shapes: for
    # fused_block one spatial + one temporal block of each part at bucket
    # 16, for the training kernels each part's two blocks of a step
    emit({"kernels": [
        # the chain's attention stage at the six bucket-16 shapes; launched
        # once by every call of fused_block and fused_block_temporal and
        # twice by fused_layer (block_chain.cuh step 2), so its main-path
        # launches are fused_block's
        # also #2's (attention.cu step 2) and #5's (block_train.cu step 3)
        # attention, in float32: their stage sums and launches beside
        _kernel_entry("attention_core", "cuda", ATTN_CORE_SOURCE,
                      ATTN_CORE_REPLACES, launches, stage_cases,
                      **bf16(stage_cases),
                      launched_by="fused_block, fused_block_temporal, "
                                  "fused_layer (block_chain.cuh step 2), "
                                  "fused_attention (attention.cu step 2), "
                                  "block_train_fwd (block_train.cu step 3)",
                      fused_attention_eval={
                          **_sums([c for c in attn_stage
                                   if c["shapes"] == "eval"]),
                          "launches": eval_launches["fused_attention"]},
                      block_train_fwd={
                          **_sums([c for c in train_cases
                                   if c["name"] == "attention_core"]),
                          "launches": train_launches[0]},
                      mono134_fwd={
                          **_sums([c for c in mono_cases
                                   if c["name"] == "attention_core"
                                   and c["L"] != 134]),
                          "launches": mono_wg["forward_tc"]}),
        # the streamed forward (attention_sm90.cuh's attention_stream_kernel,
        # the same entry and replaces) at mixste243's stage shapes where the
        # library streams; launched by fused_block in mixste243's 351-frame
        # serve window (float32 temporal blocks), as its library counts
        _kernel_entry("attention_core_streamed", "cuda", ATTN_CORE_SOURCE,
                      ATTN_CORE_REPLACES, m243["streams"]["forward"],
                      streamed("attention_core"),
                      **bf16(streamed("attention_core")),
                      launched_by="any wrapper of the attention forward "
                                  "where one (sequence, head) does not fit "
                                  "a CTA, d > 64, or past 144 keys in bf16 "
                                  "(and float32 at d > 48) (mixste243: "
                                  "fused_block's temporal blocks at 243 and "
                                  "351 frames)"),
        # the streamed backward's two kernels (pass A, pass B), launched by
        # block_train_bwd at mixste243's temporal blocks (243 frames at d =
        # 64), as its library counts: launches sums both passes
        _kernel_entry("attention_core_bwd_streamed", "cuda", ATTN_BWD_SOURCE,
                      ATTN_BWD_REPLACES,
                      m243["streams"]["backward_a"]
                      + m243["streams"]["backward_b"],
                      streamed("attention_core_bwd"),
                      launches_pass_a=m243["streams"]["backward_a"],
                      launches_pass_b=m243["streams"]["backward_b"],
                      launched_by="block_train_bwd (mixste243_train's "
                                  "temporal blocks, block_train.cu step 9)"),
        # the float32 forward at 81-144 keys on wgmma (attention_sm90.cuh's
        # attention_wg_kernel, the same entry and replaces): MixSTE's spatial
        # blocks (134 x 64) and the monolithic model's (134 x 36); launched
        # by block_train_fwd in mixste243_train's spatial blocks, as its
        # library counts
        _kernel_entry("attention_core_wg", "cuda", ATTN_CORE_SOURCE,
                      ATTN_CORE_REPLACES,
                      m243["streams"]["forward_wg"] + mono_wg["forward_wg"],
                      spatial("attention_core") + [
                          c for c in mono_cases if c["name"] == "attention_core"
                          and c["L"] == 134],
                      launched_by="any wrapper of the float32 attention "
                                  "forward at 81-144 keys (mixste243_train's "
                                  "and mono134_train's block_train_fwd, "
                                  "spatial blocks, block_train.cu step 3)"),
        # the resident backward on wgmma (attention_bwd_sm90.cuh's
        # attention_bwd_wg_kernel: past 80 keys at d <= 48) at the
        # monolithic model's 134 joints; launched by block_train_bwd in
        # mono134_train's spatial blocks, as its library counts
        _kernel_entry("attention_core_bwd_wg", "cuda", ATTN_BWD_SOURCE,
                      ATTN_BWD_REPLACES, mono_wg["backward_wg"],
                      [c for c in mono_cases
                       if c["name"] == "attention_core_bwd" and c["L"] == 134],
                      launched_by="block_train_bwd (mono134_train's spatial "
                                  "blocks, block_train.cu step 9)"),
        # #6's attention backward at the training shapes (once a call of
        # block_train_bwd, block_train.cu step 9): the resident mma.sync
        # kernel (attention_bwd_tc_kernel) up to 80 keys, its launches as
        # the library counts them in the H3WB, monolithic and 3DHP runs
        _kernel_entry("attention_core_bwd", "cuda", ATTN_BWD_SOURCE,
                      ATTN_BWD_REPLACES, train_kinds["backward_tc"],
                      [c for c in train_cases
                       if c["name"] == "attention_core_bwd"],
                      launched_by="block_train_bwd (block_train.cu step 9)",
                      mono134={
                          **_sums([c for c in mono_cases
                                   if c["name"] == "attention_core_bwd"
                                   and c["L"] <= 80]),
                          "launches": mono_wg["backward_tc"]},
                      **_dhp3([c for c in dhp3_train
                               if c["name"] == "attention_core_bwd"],
                              {"dhp3_train": dhp3_kinds["backward_tc"]})),
        _kernel_entry("fused_block", "cuda", SOURCE, REPLACES, launches,
                      cases, **bf16(cases),
                      **mixste243(m243["blocks"], "fused_block",
                                  m243["block_launches"]),
                      **_dhp3(dhp3_blocks, {
                          "dhp3_cli": sum(v["fused_block"]
                                          for v in cli_launches.values()),
                          "dhp3_evaluate_auto":
                              dhp3_launches["auto"]["fused_block"],
                          "in_the_wild": itw_launches["fused_block"],
                          "draw": draw_launches["fused_block"]},
                          windows=DHP3_EVAL_WINDOWS),
                      bf16_launches={
                          "bf16_serve": bf16_serve_launches,
                          "bf16_eval_auto": bf16_eval_launches[
                              "bfloat16_auto"]["fused_block"],
                          "bf16_evaluate_3dhp": bf16_eval_launches[
                              "dhp3_bfloat16_auto"]["fused_block"]},
                      pr11_launches={
                          "ddp_eval_world1": ddp_eval_launches["world1"][
                              "fused_block"],
                          "ddp_eval_world2_rank0": ddp_eval_launches[
                              "world2_auto"]["fused_block"],
                          "serve_sharded": sharded_launches,
                          "observability_cli": obs_launches["fused_block"]},
                      launches_by_phase={
                          **_packed(packed_launches, "fused_block"),
                          **_dryrun(dryrun_launches, "fused_block")}),
        # with its four GEMMs alone (wgmma) and cuBLAS's F.linear's
        _kernel_entry("block_train_fwd", "cuda", TRAIN_SOURCE,
                      TRAIN_REPLACES["block_train_fwd"], train_launches[0],
                      fwd, **bf16(fwd),
                      **f32_sums(fwd, ("fgemm_ms", "fgemm_library_ms")),
                      **_dhp3(dhp3_fwd, {
                          "dhp3_train": dhp3_train_launches[0],
                          "dhp3_cli": cli_launches["cli_train"][
                              "block_train_fwd"]}),
                      **mono134("block_train_fwd", mono_launches[0]),
                      **mixste243(m243["trains"], "block_train_fwd",
                                  m243["launches"][0]),
                      bf16_launches={k: v[0] for k, v in bf16_train.items()},
                      pr11_launches={
                          "ddp_train_world1": ddp_train_launches[
                              "block_train_fwd"],
                          "observability_cli": obs_launches[
                              "block_train_fwd"]},
                      launches_by_phase={
                          "native_batcher_cli": native_launches[
                              "block_train_fwd"],
                          **_packed(packed_launches, "block_train_fwd"),
                          **_dryrun(dryrun_launches, "block_train_fwd")}),
        # with its GEMMs alone: data gradients (wgmma) and weight and bias
        # gradients (wgmma), and cuBLAS's (and d.sum(0)) for the same
        _kernel_entry("block_train_bwd", "cuda", TRAIN_SOURCE,
                      TRAIN_REPLACES["block_train_bwd"], train_launches[1],
                      bwd, max_rel_grad_err=max(
                          c["max_rel_grad_err"] for c in bwd), **bf16(bwd),
                      **f32_sums(bwd, ("dgrad_ms", "dgrad_library_ms",
                                       "wgrad_ms", "wgrad_library_ms")),
                      **_dhp3(dhp3_bwd, {
                          "dhp3_train": dhp3_train_launches[1],
                          "dhp3_cli": cli_launches["cli_train"][
                              "block_train_bwd"]}),
                      **mono134("block_train_bwd", mono_launches[1]),
                      **mixste243(m243["trains"], "block_train_bwd",
                                  m243["launches"][1]),
                      bf16_launches={k: v[1] for k, v in bf16_train.items()},
                      pr11_launches={
                          "ddp_train_world1": ddp_train_launches[
                              "block_train_bwd"],
                          "observability_cli": obs_launches[
                              "block_train_bwd"]},
                      launches_by_phase={
                          "native_batcher_cli": native_launches[
                              "block_train_bwd"],
                          **_packed(packed_launches, "block_train_bwd"),
                          **_dryrun(dryrun_launches, "block_train_bwd")}),
        # #6's weight and bias gradients alone (wgrad_sm90.cuh's kernel and
        # the ordered pass, ops.block_train.weight_grads) at the float32
        # training shapes; launched four times by every call of
        # block_train_bwd, as the block_train library counts them;
        # library_ms: cuBLAS's d.t() @ x with d.sum(0)
        _kernel_entry("weight_grads", "cuda", WGRAD_SOURCE, WGRAD_REPLACES,
                      WGRAD_LAUNCHES["train"], wgrad_cases(bwd),
                      max_rel_err=max(c["wgrad_max_rel_err"] for c in bwd
                                      if c["dtype"] == "float32"),
                      launched_by="block_train_bwd (block_train.cu steps 3, "
                                  "5, 8 and 11)",
                      mono134={**_sums(wgrad_cases(mono_cases)),
                               "launches": WGRAD_LAUNCHES["mono134_train"]},
                      **_dhp3(wgrad_cases(dhp3_bwd),
                              {"dhp3_train": WGRAD_LAUNCHES["dhp3_train"]}),
                      mixste243={**_sums(wgrad_cases(m243["trains"])),
                                 "launches": WGRAD_LAUNCHES["mixste243_train"]},
                      launches_by_phase={k: v for k, v in WGRAD_LAUNCHES.items()
                                         if k not in ("train", "dhp3_train",
                                                      "mono134_train",
                                                      "mixste243_train")}),
        # #6's LayerNorm backward alone (ln_bwd_kernel and its ordered pass
        # ln_sums_kernel, ops.block_train.ln_backward) in its three forms at
        # the float32 training shapes; launched three times by every call
        # of block_train_bwd, as the block_train library counts them;
        # library_ms: aten's native_layer_norm_backward with the residual
        # add and the mask multiply
        _kernel_entry("ln_backward", "cuda", TRAIN_SOURCE, LNB_REPLACES,
                      LNB_LAUNCHES["train"], lnb_cases(bwd),
                      max_rel_err=max(c["lnb_max_rel_err"] for c in bwd
                                      if c["dtype"] == "float32"),
                      ok=all(c["lnb_ok"] for c in bwd
                             if c["dtype"] == "float32"),
                      launched_by="block_train_bwd (block_train.cu steps 1, "
                                  "6 and 12)",
                      mono134={**_sums(lnb_cases(mono_cases)),
                               "launches": LNB_LAUNCHES["mono134_train"]},
                      **_dhp3(lnb_cases(dhp3_bwd),
                              {"dhp3_train": LNB_LAUNCHES["dhp3_train"]}),
                      mixste243={**_sums(lnb_cases(m243["trains"])),
                                 "launches": LNB_LAUNCHES["mixste243_train"]},
                      launches_by_phase={k: v for k, v in LNB_LAUNCHES.items()
                                         if k not in ("train", "dhp3_train",
                                                      "mono134_train",
                                                      "mixste243_train")}),
        # eval shapes (window batch 64); the serve bucket-16 shapes beside;
        # its two GEMMs alone and F.linear's
        _kernel_entry("fused_attention", "cuda", ATTN_SOURCE, ATTN_REPLACES,
                      eval_launches["fused_attention"], attn_cases,
                      **bf16(attn_cases), **serve16(serve_attn),
                      **f32_sums(attn_cases, ("gemm_ms", "gemm_library_ms")),
                      **_dhp3(dhp3_attn, {
                          "dhp3_evaluate_true":
                              dhp3_launches["true"]["fused_attention"]}),
                      bf16_launches={"bf16_eval_true": bf16_eval_launches[
                          "bfloat16_true"]["fused_attention"]},
                      pr11_launches={"ddp_eval_world2_rank0": ddp_eval_launches[
                          "world2_true"]["fused_attention"]},
                      launches_by_phase=_packed(packed_launches,
                                            "fused_attention")),
        # eval shapes, the serve bucket-16 shapes beside; replaced_ms is the
        # path each kernel replaces (kernel #1 and the transposes)
        _kernel_entry("fused_block_temporal", "cuda", BT_SOURCE, BT_REPLACES,
                      exp_launches["block_t"]["fused_block_temporal"],
                      bt_cases, replaced_ms=replaced(bt_cases),
                      **bf16(serve_bt),
                      **serve16(serve_bt, ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "replaced_ms")),
                      bf16_launches={"bf16_eval_block_t": bf16_eval_launches[
                          "bfloat16_block_t"]["fused_block_temporal"]},
                      launches_by_phase=_packed(packed_launches,
                                            "fused_block_temporal")),
        # layers 1-7 (no tpe); layer 0's times (with tpe) beside
        _kernel_entry("fused_layer", "cuda", LAYER_SOURCE, LAYER_REPLACES,
                      exp_launches["layer"]["fused_layer"],
                      tpe(layer_cases, False),
                      replaced_ms=replaced(tpe(layer_cases, False)),
                      tpe_ms=sum(c["ms"] for c in tpe(layer_cases, True)),
                      max_abs_err_tpe=max(c["max_abs_err"]
                                          for c in tpe(layer_cases, True)),
                      **bf16(tpe(serve_layer, False)),
                      **serve16(tpe(serve_layer, False),
                                ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "replaced_ms")),
                      bf16_launches={"bf16_eval_layer": bf16_eval_launches[
                          "bfloat16_layer"]["fused_layer"]},
                      launches_by_phase=_packed(packed_launches,
                                                "fused_layer")),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
