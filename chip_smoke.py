#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --multicard    # phases 1, 2, 25 and 34 over four cards

Phases, one line or more each, run in this order: 1, 2, 3, 7, 17, 18, 15, 11, 4,
8, 12, 5, 6, 9 with 13 after each mode, 16, 14, 19, 20, 21, 22, 23, 24, 25, 26, 27,
28, 29, 30, 31, 32, 33, 10 (33's CPU processes start after phase 2 and run beside
the card's phases); any failure exits non-zero before the last line:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the path from the sources in this checkout
     (one nvcc per source, all started together) and time it;
     The SFB kernel's dynamic shared memory must equal sfb_report's at the
     main path's 32x32 patches and at the phase-3 shapes, and the qSFB
     kernel's (csrc/qsfb.cu) qsfb_report's at 32x32 and the phase-15 shapes,
     both modes, the DSConv walker's (csrc/dsconv.cu, fp32 and both code
     types) dsconv_report's at the phase-17 shapes, the BSConv walker's
     (csrc/bsconv.cu, fp32 and both code types, Cin 3 and Cin = C)
     bsconv_report's at the phase-18 shapes, and the two megakernels'
     group_report's and qgroup_report's at their checked shapes;
  3. hold each kernel against its plain PyTorch version on the card, at C54
     and C27 (bsconv also at Cin = 3) and N in {1, 7, 512}, rtol 1e-4 /
     atol 1e-5 (TF32 off for the plain versions); SFB also at shapes that cut
     a patch into column bands or end on a ragged step (2x40x72 C54,
     3x13x21 C27, 1x33x32 C54); the subnet-group megakernel (the whole
     12-layer chain, csrc/mega.cu) against its plain version (rtol 1e-3 /
     atol 1e-3) and torch.equal to the layer chain of kernels (both sum
     every output in the same order) at C54 and C27, with non-zero biases,
     at the shapes of MEGA_SHAPES: Table I's patches 16, 32, 48 and 64,
     N in {1, 7, 512} at 32x32, an odd 13x21 patch, ragged last strips
     and an idle last block;
  4. time each kernel at N = 1024 C54 32x32 patches (CUDA events, median of
     25 launches) beside its plain version, a cuDNN composition of the same
     function (a yardstick only: the port never calls it) and its bound;
     the megakernel also beside the layer chain (the sum of the per-op
     kernels' times), torch.equal to it at N = 1024, and both through their
     entry points (pixel shuffle included) at C54 and C27;
  5. the main path: SREngine.from_config(ESSRConfig(scale=4)) on the card
     with the default plan and backend "cuda", warm-up, then three
     synthetic 1920x1080 LR frames to 7680x4320 with every routing bucket
     filled; the launch counts of that run must show one edge launch per
     frame (the scores) and bsconv, 5 x sfb and dsconv for each non-empty
     conv bucket and no megakernel; the three
     frames again through backend "ref" must route identically and agree
     (rtol 1e-3 / atol 1e-3); one more frame runs under torch.profiler for
     device time by kernel;
  6. group fusion: the same engine's weights under
     ExecutionPlan(fusion="group") serve the same three frames; the launch
     counts must show one megakernel launch per non-empty conv bucket, one
     edge launch a frame and no per-op launch, the ids must equal the layer
     frames' and the images
     the "ref" frames' (rtol 1e-3 / atol 1e-3); one frame is profiled;
  7. the four quantized kernels (quantize, qBSConv, qSFB, qDSConv) against
     their plain versions on the card with torch.equal (integer codes), for
     "int8" and "fxp10", C54 and C27 (qBSConv at Cin = 3 and Cin = C), N in
     {1, 7, 512} and a 13x21 patch, with non-zero biases; the plain quantize
     and qDSConv on the card also equal to the same plain versions on the
     CPU (a division by a CPU scalar on the card would not be IEEE);
  8. each quantized kernel timed at N = 1024 C54 32x32 beside its plain
     version and its bound, per mode (no single PyTorch call computes any of
     them: library "none"); quantize, a ~5 us kernel, as the device time of
     one call from a CUDA graph of GRAPH_LAUNCHES captured calls replayed,
     rotating over copies of its input that together exceed the L2 cache
     (its plain version too), beside the same on one L2-resident input, its
     evented median and the host time of one wrapper call; integer
     operations priced at the int8 tensor-core
     rate for "int8" and at the TF32 rate for "fxp10", where they are exact,
     each rounded fp32 operation as one instruction and each requantize
     division as FDIV_RN_INSTRUCTIONS, counted on this run's data (a ReLU
     site divides only where its value is > 0);
  9. quantized serving: ExecutionPlan(quant=mode) for both modes serves the
     same three frames; the label must be "cuda-<mode>", the ids equal to
     the fp32 layer frames', the launches 1 + 1 + 5 + 1 per non-empty conv
     bucket, one edge launch a frame and nothing else, and each frame equal
     (torch.equal) to its
     routed buckets run through the port's integer reference
     (essr_forward_qref) on the card; PSNR against the fp32 frame is
     reported (the weights are random); one frame per mode is profiled;
 10. the TPU kernel table with each row's port status, the per-kernel JSON
     line, and the result line;
 11. the quantized megakernel (csrc/qmega.cu, its 1x1 dots on the tensor
     cores) against its plain version (recon codes), and its images against
     the qconv kernel chain and the integer reference essr_forward_qref on
     the card, all with torch.equal, for "int8" and "fxp10", C54 and C27, N in
     {1, 7, 512, 1024} and the patches of QMEGA_SHAPES (ragged last strips,
     an idle block, Table I's 48x48 and 64x64: 8- and 16-block clusters at
     C54), with non-zero biases; and on
     synthetic extreme operands
     at C54 (every weight code at +-qmax, site steps that saturate the codes,
     so the fxp10 sums reach 511^2 * 54), its codes against the plain version
     and the qconv kernel chain;
 12. the quantized megakernel timed at N = 1024 C54 32x32 beside its plain
     version, the qconv chain's summed time from phase 8 and its bound at the
     data sheet's rates, with its resident clusters and shared memory per
     block;
 13. quantized group serving: ExecutionPlan(quant=mode, fusion="group")
     serves the same three frames on the same weights and pack; the label
     must be "cuda-<mode>", the launches one qmega per non-empty conv bucket,
     one edge a frame and nothing else, the ids equal to the fp32 frames' and
     each image
     torch.equal to the quant layer frame's; one frame is profiled;
 14. the edge-score kernel (csrc/edge.cu) on the serving path: the scores
     phase 5's layer frames were routed by (the kernel's) within rtol 1e-4 /
     atol 1e-3 of the plain edge_score of the same patches, and the frames'
     routing ids equal to the plain scores' ids; then timed on one frame's
     2,304 patches as quantize is (from a CUDA graph over inputs past the
     L2, and on one L2-resident input), beside its evented median, the host
     time of one wrapper call and its bound by bytes;
 15. the qSFB kernel (csrc/qsfb.cu, the band walker with its 1x1 dots on the
     tensor cores) torch.equal to its plain version at the shapes that cut a
     patch into column bands or end on a ragged step (QSFB_SHAPES), on the
     calibrated model's operands at C54 and C27 and on synthetic extreme
     operands at C64 (every code and weight at +-qmax, so fxp10 sums reach
     511^2 * 64), for "int8" and "fxp10";
 16. Table I's larger patches and one past it: one frame under
     ExecutionPlan(patch=48, 64 and 80, fusion="group"), fp32, "int8" and
     "fxp10", torch.equal to the same frame under fusion="layer" at that
     patch with equal ids, one megakernel launch per non-empty conv bucket
     and one edge launch; at 80 the megakernels serve each patch in 2 x 2
     recompute-halo windows of 52 (the window plan is printed, and three
     later calls of each in turns; the fp32 group frame is profiled); then
     ("patch80 time") the windowed megakernels
     timed at N = PATCH80_N C54 80x80 patches beside their layer chains
     (essr_forward_kernels, essr_forward_qkernels), torch.equal to them;
 17. the DSConv band walker (csrc/dsconv.cu) at DSCONV_SHAPES (N in {1, 7,
     1024} at 32x32, 13x21, 17x9, 64x64 and 80x80 cut into three column
     bands), C54 and C27, non-zero biases: fp32 DSConv against its plain
     version (rtol 1e-4 / atol 1e-5), qDSConv (its codes datapath, the
     calibrated model's recon operands on codes spread over the lattice)
     torch.equal to its plain version, both modes;
 18. the BSConv band walker (csrc/bsconv.cu) at BSCONV_SHAPES (N in {1, 7,
     1024} at 32x32, 80x80 in three column bands, 40x72 in three, ragged
     steps of 33 and 13 rows, odd widths), C54 and C27, non-zero biases:
     fp32 BSConv at Cin 3 and Cin = C, with and without ReLU, against its
     plain version (rtol 1e-4 / atol 1e-5); qBSConv (its codes datapath: the
     calibrated model's first layer, and its first SFB's b1 group with ReLU,
     on codes spread over the lattice) torch.equal to its plain version,
     both modes;
 19. the stream ("stream"): phase 5's weights serve STREAM_FRAMES 1080p
     frames through SREngine.stream under host dispatch with a
     SwitchingConfig whose frame_high lies below the frames' 576 C54
     patches, so the thresholds move; per frame the ids and thresholds must
     equal a host-only AdaptiveSwitcher fed the same scores, and the image
     torch.equal to upscale(frame, ids_override=ids);
 20. fused dispatch ("fused"), all six modes (fp32, int8, fxp10 x layer,
     group): each frame one CUDA graph replay (captured on the first frame
     of its capacity profile) against the same frames under host dispatch:
     ids equal, image torch.equal, spills zero; the launches a replay adds
     (the capture's deltas: 15 / 3 / 17 / 3 a frame) and the graph's pool
     bytes; a replay must look up no C entry (no wrapper launch) and capture
     nothing; then STEADY_FRAMES frames each of host and fused dispatch in
     turns, host-clock latency median, quartiles and range, and one
     profiled frame each (busy time, idle share); a "fused:" JSON line
     before the kernels line holds the numbers;
 21. the fused stream ("fused stream"): the STREAM_FRAMES frames through
     SREngine.stream under dispatch="fused" with inflight 1 and 2 (frozen
     thresholds): results equal, in order, with marginal latencies;
 22. one graph pool a device ("pools"): one 1080p frame under POOL_PROFILES
     pinned capacity profiles, each fused engine alive (that many graphs):
     the reserved memory after each, every frame torch.equal to host
     dispatch; the growth past the first graph must stay under half its
     pool (private pools grew by a whole pool each);
 23. multi-tenant serving ("streams"): four 960x540 -> 3840x2160 tenants,
     shares TENANT_SHARES, ragged lengths TENANT_FRAMES (ticks of 4, 3, 2
     live streams) through SREngine.serve_streams under fp32 "layer" and
     "group" and int8 "group", capacity pinned per stream: each tenant
     torch.equal to the tenant served solo, round-robin order, one capture
     per live count, a second run with no capture and no wrapper call (the
     launches the captures' deltas), two ticks in flight equal to
     synchronous; launches a tick, tick latency quartiles, marginal latency
     in flight and pool bytes per live count;
 24. faults ("faults"): seeded FaultPlans on three FAULT_HW tenants, each
     run again on the CPU: injected backend failures step the ladder
     group->layer->ref, a poisoned tenant is quarantined and re-admitted
     with the healthy ones torch.equal to a run without faults, an iterator
     that raises retires its stream alone; the ledgers equal the CPU's.
     Then every engine of the run built without a FaultPlan must have left
     its ladder at level 0 with no degrade or watchdog event ("ladder"); a
     "streams:" JSON line before the kernels line holds phases 22-24;
 25. the sharded patch stream ("shards"): the three frames under
     ExecutionPlan(shards=4) on the one card warn as the reference does
     (single-device dispatch, per-shard routing unchanged); each frame's ids
     and per-shard thresholds equal a host-only ShardSwitcherBank fed the
     same scores, its image torch.equal to upscale(ids_override=ids) at
     shards=1, the layer kernels launched for its buckets; the split forward
     over cuda:0 named four times torch.equal to the unsplit kernels at
     N = 2,303 in fp32 layer and group and int8 layer and group, every
     kernel of the mode launched once a chunk; an impossible deadline
     demotes the overloaded top strip alone. With --multicard, on a host of
     several cards, phase 25 runs alone after the build, over the first
     min(4, cards) cards: the frames' chunks and the split forward on their
     own cards (each must hold its weight copy), still torch.equal to one
     card, the split timed beside the unsplit forward, fused dispatch
     refused (ROADMAP item 12b);
 26. supernet training ("train"): ESSRConfig(scale=4) (C54, 5 SFBs) from a
     seeded init, patch_batches(batch=16, lr_patch=24), Lamb with a cosine
     lr of 3e-3, TF32 off: the first three steps' losses (rtol 1e-4) and
     weights (within 1e-4 of each leaf's max) equal to the same steps on the
     CPU; then 100 steps, whose loss must fall, with steps a second and peak
     memory beside the card; the megakernel's gradients at C27 and C54, N =
     16 32x32, against the plain forward's (normalized atol 1e-3), one mega
     launch each; two GAN steps; a checkpoint written from the card served
     by SREngine.from_checkpoint, torch.equal to from_params of the same
     EMA; a "train:" JSON line before the kernels line holds phases 25-26;
 27. the baselines ("baselines"), library convolutions (cuDNN; the
     reference's are lax convolutions outside any Pallas kernel), at their
     published widths on one synthetic 1920x1080 LR frame, TF32 off:
     bicubic x4 to 8K, FSRCNN x4 (d 56, s 12, m 4) on its luma, pruned RLFN
     x4 (46 channels, 4 RLFBs) and base RLFN x4 (52, 6), each against the
     same module on the CPU in float64 on a 128x128 crop (rtol 1e-3 / atol
     1e-3; its distance to the CPU's fp32 output beside it), timed
     at 1080p (CUDA events, median of BASELINE_RUNS) beside its MACs a
     frame, its bound and ESSR's fp32 layer frame of phase 20; then
     extract_patches and fuse_patches_average at 1080p -> 8K torch.equal to
     PatchGeometry.extract and within rtol 1e-6 of fuse_average;
 28. the training supervisor ("supervisor"): TrainSupervisor around the
     supernet step as phase 26 trains, 30 steps, async checkpoints every 10,
     uninterrupted and with an InjectedFailure at step 23: one restart, a
     resume at step 20, params, optimizer state and EMA torch.equal to the
     uninterrupted run; both wall times;
 29. the examples ("examples"): examples/torch_quickstart.py,
     torch_serve_8k.py --frames 4 --hw 96 under host and fused dispatch
     (--inflight 2), torch_train_essr.py --steps 20 and
     torch_dynamic_width_lm.py as subprocesses on the card, together, then
     torch_serve_8k.py from the training's checkpoint; each must exit 0. A
     "baselines:" JSON line before the kernels line holds phases 27-29;
 30. the LM side ("lm"), which reaches no hand-written kernel (its matmuls
     are cuBLAS; the launch counts stay 0 through it): granite-8b FULL (36
     layers, d 4096, 32 / 8 heads, d_ff 14336) in bf16 on the card from a
     seeded generator, after the earlier phases' graphs and caches are
     freed, served as is and as FULL_DYNWIDTH on the same weights: for each,
     lm_prefill of LM_BATCH x LM_PROMPT tokens (max_len LM_MAX_LEN), then
     LM_DECODE greedy lm_decode_steps, prefill and decode timed with CUDA
     events beside their bounds (bf16 tensor-core rate, HBM bytes; causal
     prefill counts the keys each query needs, a decode step the positions
     filled), peak memory; the logits finite; the static variant's decode at positions S
     and S + LM_DECODE - 1 within rtol/atol 8e-2 of a prefill of the same
     tokens, its argmax a near-tie (<= 0.1) of the prefill's max
     (tests/test_lm_archs.py:90-94); the dynamic-width variant's every FFN
     call routing exactly max(1, int(t / 2)) of its t tokens (t = 2048 at
     prefill, 4 at decode) to the full width, the highest scores, every
     token once. Then ("lm fp32") granite-8b FULL cut to LM_CHECK_LAYERS
     layers in fp32 (TF32 off), built on the CPU and copied to the card:
     a prefill of 1 x LM_CHECK_PROMPT tokens and LM_CHECK_STEPS decode
     steps, static and dynamic width, the card's logits within rtol/atol
     1e-3 of the CPU's, the dynamic width's routing ids equal but where a
     score lies within float noise of the cut;
 31. every architecture's SMOKE config ("lm-archs": MoE, MLA, both Mamba
     forms, the hybrid shared block, enc-dec, the VLM prefix), its port
     init in fp32 on the CPU copied to the card: prefill and one decode
     step (lm_ or encdec_), logits and every cache leaf within rtol/atol
     1e-3 of the CPU's. An "lm:" JSON line before the kernels line holds
     phases 30-31;
 32. LM training ("lm train"), after phase 30's weights and caches are
     freed: granite-8b FULL at full width with its depth cut to
     LM_TRAIN_LAYERS (printed as a reduction with its reason), bf16 weights
     from a seeded generator on the card, remat, launch/steps.py's
     make_train_step with chain_clip(adam(LM_TRAIN_LR), 1.0) and fp32
     moments, one sequence of LM_TRAIN_SEQ tokens (the next tokens its
     labels) every step, static and FULL_DYNWIDTH from the same weights one
     after the other: LM_TRAIN_WARMUP steps, then LM_TRAIN_STEPS timed with
     CUDA events (median, tokens a second), peak allocated memory beside
     abstract_train_state's size on the meta device and the predicted
     LM_TRAIN_PEAK_BYTES_PER_PARAM a parameter, the bound from the port's
     cell_cost and roofline, the model FLOPs' share of the bf16 peak, one
     step profiled (busy and idle share); every loss finite and the last
     timed below the first; under dynamic width every FFN call of the
     warm-up steps (forward and recompute) routing max(1, int(t / 2)) of
     its t tokens to the full width, the highest scores, every token once.
     Then ("lm train fp32") phase 30b's CPU model: the loss and every
     gradient leaf on the card within rtol 1e-3 / atol 1e-3 x the leaf's
     largest of the CPU's; and ("lm-archs train") every SMOKE config in
     fp32, one step on the card against the CPU: loss, parameters and
     moments within rtol/atol 1e-3. An "lm_train:" JSON line before the
     kernels line holds it. The LM path launches none of the port's
     kernels through phases 30-32.
 33. the dry run ("dryrun"; launch/dryrun.py, no card): first (b)'s real
     step and (d) on the card, then CPU processes (CUDA_VISIBLE_DEVICES
     empty), started once the card's phases are done, run one rank's step
     of (a) granite-8b FULL's train_4k, prefill_32k and decode_32k on the
     single (16 x 16) and multi-pod (2 x 16 x 16)
     meshes and essr-x4's serve_8k, (b) phase 32's own configuration on a
     1 x 1 mesh and (c) item 16d's cell, granite-8b FULL at 1 x
     LM_TRAIN_SEQ on DRYRUN_16D_MESH; each cell's own seconds, one rank's
     argument and temporary bytes, FLOPs, collective bytes by kind and mesh
     axis and roofline terms are printed as predictions on the H100
     constants of launch/roofline.py (a cell not "ok" fails the run). (b)
     is held against one real step of that configuration on the card:
     FLOPs within 1% of FlopCounterMode around it and argument bytes equal
     to the real state's and batch's, or the run fails; the predicted peak
     against phase 32's max_memory_allocated and the bound against its
     median step are printed as ratios. (d) The dry run's knobs at full
     width on the card: zamba2-1.2b FULL's Mamba-2 in the SSD form against
     the scan form (a bf16 prefill of 1 x KNOB_SEQ and one train step each,
     CUDA events, peak memory; the same prefill in fp32 within rtol/atol
     1e-3; in bf16 the forms' difference is reported beside each form's
     departure from its own fp32 logits, the rounding of 38 bf16 layers,
     which tests/test_torch_lm_ssd_depth.py holds to the reference's), one
     layer of deepseek-v3 FULL's MLA lazy against eager at 1 x KNOB_SEQ
     (8e-2), and
     the token-sharded MoE on deepseek-v3 SMOKE torch.equal to the knob off.
     A "dryrun:" JSON line before the kernels line holds it;
 34. the collectives over four cards ("collectives"; --multicard only,
     after phase 25): four ranks of this script (--collectives-rank), one
     card each, over NCCL, meeting through a file store in a temporary
     folder; a rank that fails or outlives COLL_TIMEOUT_S fails the phase.
     Each rank prints its figures beside its card's name and power limit.
     (a) distributed/collectives.py: flash_decode_attention at granite-8b
     FULL's decode shapes (COLL_FD: a cache sharded over the four cards,
     fp32) against the port's one-card decode_attention (rtol 1e-4 / atol
     1e-5), and compressed_psum over one granite-8b FULL layer's gradient
     leaves (each rank its own, two steps with the error carried) against
     its plain formula on one card (codes equal, results within 1e-6 of
     each leaf's largest); each timed beside its one-card or plain fp32
     all-reduce counterpart. (b) tests/_torch_gloo_mesh.py's SMOKE
     comparison over NCCL: the train step on (2, 2) and (1, 4) (granite-8b,
     zamba2-1.2b, deepseek-v3 with the einsum MoE and the shard_map MoE in
     both modes) and prefill + decode, each within 1e-4 of each tensor's
     largest of the plain one-card step. (c) item 16d's cell at full width:
     granite-8b FULL, all 36 layers, one sequence of LM_TRAIN_SEQ tokens,
     bf16, make_optimizer()'s functional Adam, on (data=1, model=4):
     COLL_16D_WARMUP warm-up and COLL_16D_STEPS timed steps, each rank's
     max_memory_allocated against the dry run's prediction (COLL_16D_ARG_GIB +
     COLL_16D_TEMP_GIB) and the median step against its predicted compute
     and collective times; the loss finite and equal on every rank. A
     "collectives:" JSON line before the last holds it. No kernel of the
     port lies on this path.

It imports torch and the port (src/repro_torch), never JAX or the JAX
package. It exits non-zero without a result when no CUDA card is visible or
when the port's sources are not beside it.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = dict(rtol=1e-4, atol=1e-5)          # kernel vs plain, fp32 both sides
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)    # whole frame, "cuda" vs "ref"
TIMING_N, TIMING_RUNS = 1024, 25
#: Small kernels (quantize, edge) are timed from a CUDA graph of this many
#: captured calls, replayed GRAPH_REPLAYS times.
GRAPH_LAUNCHES, GRAPH_REPLAYS = 100, 10
#: The H100's L2 cache (data sheet): a graph that replays one input keeps a
#: small kernel's operands there; `cold_inputs` rotates past it.
L2_BYTES = 50 * 2 ** 20
#: Patches of the windowed megakernels' timing at 80x80 (phase 16).
PATCH80_N = 256
#: Frames of the streaming phases (19, 21), and the Algorithm-1 trim band
#: of phase 19: below the frames' 576 C54 patches, so the thresholds move.
STREAM_FRAMES = 8
STREAM_FRAME_HIGH, STREAM_FRAME_LOW = 400, 100
#: Steady frames timed per serving mode and dispatch in phase 20, in turns.
STEADY_FRAMES = 12
#: Phase 22: the pinned capacity profiles served one after another.
POOL_PROFILES = 6
#: Phase 23: the tenants' frame counts (ragged: ticks of 4, 3 and 2 live
#: streams), their QoS shares and their pinned per-stream capacity (a 960x540
#: tenant routes (288, 144, 144) of its 576 patches; the host buckets are 256).
TENANT_HW = (540, 960)
TENANT_FRAMES = (8, 8, 6, 4)
TENANT_SHARES = (2.0, 1.0, 1.0, 1.0)
TENANT_CAPACITY = (0, 256, 256)
#: Phase 24: the tenants' frame size, small enough to serve on the CPU too.
FAULT_HW = (96, 160)
#: Phase 25: the logical shards, and the patches of the split forward (not a
#: multiple of SHARDS, so the last chunk is padded).
SHARDS, SHARD_N = 4, 2303
#: Phase 25 on several cards: the timed calls of the split and unsplit forward.
SHARD_REPEATS = 7
#: Phase 26: the training batch (the reference launcher's 16 LR patches of
#: 24x24), the first steps held against the CPU, then the steps timed.
TRAIN_BATCH, TRAIN_PATCH = 16, 24
TRAIN_CHECK, TRAIN_STEPS = 3, 100
#: Phase 27: the baselines' CPU check crop and the timed calls a model.
BASELINE_CROP, BASELINE_RUNS = 128, 10
#: Phase 28: the supervised steps, the checkpoint interval and the step
#: whose failure hook raises once.
SUPERVISED_STEPS, SUPERVISED_CKPT_EVERY, SUPERVISED_FAIL_AT = 30, 10, 23
#: Phase 29: seconds each example may take (the kernels are built by then).
EXAMPLE_TIMEOUT_S = 300
#: Phase 30: granite-8b served at full width and depth: the batch, the
#: prompt, the cache length and the greedy decode steps; the CPU check's
#: depth, prompt and decode steps (fp32).
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_DECODE = 4, 512, 576, 32
LM_PREFILL_RUNS = 3
LM_CHECK_LAYERS, LM_CHECK_PROMPT, LM_CHECK_STEPS = 2, 64, 4
#: Phase 31: the smoke configs' batch, prompt and cache length
#: (tests/test_lm_archs.py:15).
LM_ARCH_B, LM_ARCH_S, LM_ARCH_ML = 2, 16, 24
#: Phase 32: granite-8b trained at full width, its depth cut to
#: LM_TRAIN_LAYERS of 36 (the whole model's train state does not fit one
#: card under the functional Adam: ~8.25 B params x 12 B is 99 GB before
#: the update's transients); one sequence of train_4k's 4096 tokens; warm-up
#: and timed steps a variant; Adam's constant lr (make_optimizer's warmup
#: would step by 3e-6 at step 20, lost under bf16 weights of scale 0.02).
LM_TRAIN_LAYERS, LM_TRAIN_SEQ = 8, 4096
LM_TRAIN_WARMUP, LM_TRAIN_STEPS = 3, 10
LM_TRAIN_LR = 1e-3
#: Bytes a parameter at the update's peak under the functional Adam: bf16
#: params, grads, clipped grads and updates, fp32 m and v old and new.
LM_TRAIN_PEAK_BYTES_PER_PARAM = 24
#: Every engine the phases construct: (phase, its guard, its FaultPlan). A
#: phase without a FaultPlan must leave the ladder where it started.
GUARDS = []

#: Published H100/H200 peaks (NVIDIA data sheets): fp32 outside the tensor
#: cores, and device-memory bandwidth, by a substring of the card's name.
PEAKS = (("H100 PCIe", 51e12, 2.0e12), ("H100 NVL", 60e12, 3.9e12),
         ("H200", 67e12, 4.8e12), ("H100", 67e12, 3.35e12))
#: Dense int8 tensor-core peak of the same parts (data sheets), by name.
INT8_PEAKS = (("H100 PCIe", 1513e12), ("H100 NVL", 1671e12), ("H200", 1979e12),
              ("H100", 1979e12))
#: Dense TF32 tensor-core peak of the same parts (data sheets), by name: the
#: rate of qSFB's fxp10 integer dots, exact there (csrc/qsfb.cu).
TF32_PEAKS = (("H100 PCIe", 378e12), ("H100 NVL", 418e12), ("H200", 495e12),
              ("H100", 495e12))
#: Dense fp16 tensor-core peak of the same parts (data sheets), by name: the
#: rate of qmega's fxp10 integer dots, exact there (csrc/qmma.cuh).
FP16_PEAKS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H200", 989e12),
              ("H100", 989e12))
QUANT_MODES = ("int8", "fxp10")
#: SFB checks beyond the main path's 32x32 (N, H, W, C): column bands with a
#: recomputed halo (72 wide), ragged last steps (13 and 33 rows).
SFB_SHAPES = ((2, 40, 72, 54), (3, 13, 21, 27), (1, 33, 32, 54))
QKERNELS = ("quantize", "qbsconv", "qsfb", "qdsconv")
#: Instructions of one __fdiv_rn on sm_90a: its fast path as cuobjdump -sass
#: shows it (scripts/torch_bsconv_ab.py --sass). The integer kernels' bounds
#: price each requantize division at this count, not at one instruction.
FDIV_RN_INSTRUCTIONS = 10
#: qSFB checks beyond the main path's 32x32 (N, H, W): column bands with a
#: recomputed halo (72 wide), ragged last steps (13, 17 and 33 rows), odd widths.
QSFB_SHAPES = ((2, 40, 72), (3, 13, 21), (1, 33, 32), (2, 17, 9))
#: qmega checks (N, H, W): the main path's 32x32 at four batch sizes, then
#: ragged last strips (13, 17 and 25 rows), a patch whose last block is idle
#: (5 rows) and Table I's 48 and 64 (at C54 8 blocks of 6 rows and 16 of 4).
QMEGA_SHAPES = ((1, 32, 32), (7, 32, 32), (512, 32, 32), (1024, 32, 32), (3, 13, 21),
                (2, 17, 9), (1, 25, 32), (2, 5, 9), (4, 48, 48), (2, 64, 64))
#: DSConv / qDSConv walker checks (N, H, W): the main path's 32x32 at three
#: batch sizes, ragged steps and odd widths, Table I's 64 and an 80x80 patch
#: cut into three column bands.
DSCONV_SHAPES = ((1, 32, 32), (7, 32, 32), (1024, 32, 32), (3, 13, 21), (2, 17, 9),
                 (2, 64, 64), (1, 80, 80))
#: BSConv / qBSConv walker checks (N, H, W): the main path's 32x32 at three
#: batch sizes, an 80x80 patch cut into three column bands, 72 wide in three
#: bands, ragged last steps (33 and 13 rows) and odd widths.
BSCONV_SHAPES = ((1, 32, 32), (7, 32, 32), (1024, 32, 32), (1, 80, 80), (2, 40, 72),
                 (1, 33, 32), (3, 13, 21))
#: fp32 megakernel checks (N, H, W): the main path's 32x32 at three batch
#: sizes, Table I's other patches (16: one block a patch; 48: 16 blocks at
#: C54; 64: 16 blocks, unpadded pixels at C54), an odd patch in one block,
#: ragged last strips (17x9; 25x32: 4 blocks of 7 rows), a patch shorter than
#: its blocks (5x9) and idle last blocks (33x32: 16 blocks of 3 rows at C54).
MEGA_SHAPES = ((1, 32, 32), (7, 32, 32), (512, 32, 32), (4, 16, 16), (4, 48, 48), (2, 64, 64),
               (3, 13, 21), (2, 17, 9), (1, 25, 32), (2, 5, 9), (1, 33, 32))

#: Every TPU kernel of the JAX package (each function reaching pl.pallas_call).
TPU_KERNELS = (
    ("bsconv_fused", "src/repro/kernels/bsconv.py:57", "ported"),
    ("sfb_fused", "src/repro/kernels/sfb.py:42", "ported"),
    ("dsconv_fused", "src/repro/kernels/dsconv.py:34", "ported"),
    ("essr_forward_megakernel", "src/repro/kernels/megakernel.py:292", "ported"),
    ("essr_forward_qmegakernel", "src/repro/kernels/megakernel.py:360", "ported"),
    ("quantize_fused", "src/repro/kernels/qconv.py:147", "ported"),
    ("qbsconv_fused", "src/repro/kernels/qconv.py:175", "ported"),
    ("qsfb_fused", "src/repro/kernels/qconv.py:224", "ported"),
    ("qdsconv_fused", "src/repro/kernels/qconv.py:270", "ported"),
    ("edge_score_fused", "src/repro/kernels/edge.py:33", "ported"),
)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi printed nothing")
    return out[0]


def peaks_for(name: str):
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    return PEAKS[-1][1:]


def int8_peak_for(name: str) -> float:
    return next((ops for key, ops in INT8_PEAKS if key in name), INT8_PEAKS[-1][1])


def int_peak_for(name: str, bits: int, fp16: bool = False) -> float:
    """The rate of a quantized kernel's integer operations: the int8 tensor
    cores for int8 codes, for fxp10 codes the TF32 tensor cores (qSFB) or,
    with ``fp16``, the fp16 ones (qmega): integers up to 2^11 are exact in
    both, and the sums stay below 2^24."""
    if bits <= 8:
        return int8_peak_for(name)
    table = FP16_PEAKS if fp16 else TF32_PEAKS
    return next((ops for key, ops in table if key in name), table[-1][1])


# ---------------------------------------------------------------------------
# operands, plain versions, cuDNN yardsticks, work counts
# ---------------------------------------------------------------------------

def operands(kind: str, n: int, c: int, g, torch, cin: int = 3, cout: int = 48,
             hw: tuple = (32, 32)):
    """Random (n, *hw) activations and He-normal weights with non-zero biases
    (a halo pixel reading pw(0) + b instead of 0 would show)."""
    def he(shape, fan):
        return (torch.randn(shape, generator=g) * (2.0 / fan) ** 0.5).cuda()

    def bias(k):
        return (0.1 * torch.randn(k, generator=g)).cuda()

    if kind == "bsconv":
        x = torch.rand((n, *hw, cin), generator=g).cuda()
        return x, dict(pw=he((cin, c), cin), pw_b=bias(c), dw=he((3, 3, c), 9), dw_b=bias(c))
    x = torch.rand((n, *hw, c), generator=g).cuda()
    if kind == "dsconv":
        return x, dict(dw=he((3, 3, c), 9), dw_b=bias(c), pw=he((c, cout), c), pw_b=bias(cout))
    p = {}
    for b in ("b1", "b2"):
        p.update({f"{b}_pw": he((c, c), c), f"{b}_pwb": bias(c),
                  f"{b}_dw": he((3, 3, c), 9), f"{b}_dwb": bias(c)})
    p.update(fuse=he((c, c), c), fuse_b=bias(c))
    return x, p


def runners(kind: str, torch):
    """(kernel, plain, cuDNN composition) for one kernel, each f(x, w)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsconv import bsconv_fused
    from repro_torch.kernels.dsconv import dsconv_fused
    from repro_torch.kernels.sfb import sfb_fused

    def conv1x1(xc, w, b):            # xc: NCHW view of NHWC data; w: (Ci, Co)
        return F.conv2d(xc, w.t().reshape(w.shape[1], w.shape[0], 1, 1), b)

    def dw3(xc, w, b):                # w: (3, 3, C)
        return F.conv2d(xc, w.permute(2, 0, 1)[:, None], b, padding=1, groups=w.shape[-1])

    def nhwc(y):
        return y.permute(0, 2, 3, 1)

    if kind == "bsconv":
        def lib(x, w):
            return nhwc(dw3(conv1x1(x.permute(0, 3, 1, 2), w["pw"], w["pw_b"]),
                            w["dw"], w["dw_b"]))
        return (lambda x, w: bsconv_fused(x, w["pw"], w["pw_b"], w["dw"], w["dw_b"]),
                lambda x, w: ref.bsconv_ref(x, w["pw"], w["pw_b"], w["dw"], w["dw_b"]), lib)
    if kind == "dsconv":
        def lib(x, w):
            return nhwc(conv1x1(dw3(x.permute(0, 3, 1, 2), w["dw"], w["dw_b"]),
                                w["pw"], w["pw_b"]))
        return (lambda x, w: dsconv_fused(x, w["dw"], w["dw_b"], w["pw"], w["pw_b"]),
                lambda x, w: ref.dsconv_ref(x, w["dw"], w["dw_b"], w["pw"], w["pw_b"]), lib)

    def lib(x, p):
        xc = x.permute(0, 3, 1, 2)
        y = torch.relu(dw3(conv1x1(xc, p["b1_pw"], p["b1_pwb"]), p["b1_dw"], p["b1_dwb"]))
        y = torch.relu(dw3(conv1x1(y, p["b2_pw"], p["b2_pwb"]), p["b2_dw"], p["b2_dwb"]))
        return nhwc(torch.relu(conv1x1(y + xc, p["fuse"], p["fuse_b"])))
    return sfb_fused, ref.sfb_ref, lib


def work(kind: str, n: int, c: int, cin: int = 3, cout: int = 48):
    """(bytes each input read once and each output written once, flops)."""
    px = n * 32 * 32
    if kind == "bsconv":
        return 4 * (px * (cin + c) + cin * c + 11 * c), 2 * px * (cin * c + 9 * c)
    if kind == "dsconv":
        return 4 * (px * (c + cout) + 10 * c + c * cout + cout), 2 * px * (9 * c + c * cout)
    return 4 * (2 * px * c + 3 * c * c + 23 * c), 2 * px * (3 * c * c + 18 * c)


def mega_operands(width: int, g, torch):
    """An ESSR x4 param tree on the card (He-normal weights from ``g``, and
    non-zero biases: a halo reading pw(0) + b instead of 0 would show) and
    its packed megakernel buffer at ``width``."""
    from repro_torch.kernels import megakernel as mk
    from repro_torch.models.essr import ESSR, ESSRConfig
    tree = ESSR(ESSRConfig(scale=4), generator=g).cuda().requires_grad_(False).tree()
    for leaf in mk._leaves(tree):
        if leaf.ndim == 1:
            leaf.copy_(0.1 * torch.randn(leaf.shape, generator=g))
    return tree, mk.pack_weights(tree, width)


def mega_library(x, w, torch):
    """The whole chain as a cuDNN composition (NCHW 1x1 and depthwise
    conv2d), on the unpacked weights ``w``: a yardstick only."""
    import torch.nn.functional as F

    def conv1x1(xc, m, b):
        return F.conv2d(xc, m.t().reshape(m.shape[1], m.shape[0], 1, 1), b)

    def dw3(xc, k, b):
        return F.conv2d(xc, k.permute(2, 0, 1)[:, None], b, padding=1, groups=k.shape[-1])

    p = w["first"]
    f = dw3(conv1x1(x.permute(0, 3, 1, 2), p["pw"], p["pw_b"]), p["dw"], p["dw_b"])
    for s in w["sfbs"]:
        y = torch.relu(dw3(conv1x1(f, s["b1_pw"], s["b1_pwb"]), s["b1_dw"], s["b1_dwb"]))
        y = torch.relu(dw3(conv1x1(y, s["b2_pw"], s["b2_pwb"]), s["b2_dw"], s["b2_dwb"]))
        f = torch.relu(conv1x1(y + f, s["fuse"], s["fuse_b"]))
    r = w["recon"]
    return conv1x1(dw3(f, r["dw"], r["dw_b"]), r["pw"], r["pw_b"]).permute(0, 2, 3, 1)


def quant_setup(mode: str, g, torch):
    """An ESSR x4 param tree on the card (He-normal weights from ``g``,
    non-zero biases), its QuantPack calibrated on the default batch, the
    prepared operands at both conv widths, and the tree."""
    from repro_torch.api.engine import default_calibration_batch
    from repro_torch.kernels import qconv as tq
    from repro_torch.models.essr import ESSRConfig
    from repro_torch.quant.pams import build_quant_pack
    tree, _ = mega_operands(54, g, torch)
    cfg = ESSRConfig(scale=4)
    pack = build_quant_pack(tree, cfg, mode, default_calibration_batch(32, 4).cuda())
    return cfg, pack, {w: tq.prepare_qparams(tree, cfg, w, pack, device="cuda")[0]
                       for w in (54, 27)}, tree


def quant_stages(q, x, bits: int, torch):
    """The chain's stages on input ``x``, each as (kernel, kernel fn, plain
    fn, its input codes): every stage's input is the plain output of the
    stage before, so each kernel is held to its plain version alone."""
    from repro_torch.kernels import qconv as tq
    from repro_torch.kernels import ref
    from repro_torch.quant.pams import code_dtype
    p, r = q["first"], q["recon"]
    b = (p["pwq"], p["pw_scale"], p["pwb"], p["dw_fq"], p["dwb"], p["qc"])
    d = (r["dwq"], r["dw_scale"], r["dwb"], r["pw_fq"], r["pwb"], r["qc"])
    stages = [("quantize", lambda v: tq.quantize_fused(v, q["in_qc"], bits=bits),
               lambda v: ref.quantize_ref(v, q["in_qc"], code_dtype(bits)), x)]
    f = stages[0][2](x)
    stages.append(("qbsconv", lambda v: tq.qbsconv_fused(v, *b, relu=False),
                   lambda v: ref.qbsconv_ref(v, *b, relu=False), f))
    f = stages[-1][2](f)
    for s in q["sfbs"]:
        stages.append(("qsfb", lambda v, s=s: tq.qsfb_fused(v, s, s["qc"]),
                       lambda v, s=s: ref.qsfb_ref(v, s, s["qc"]), f))
        f = stages[-1][2](f)
    stages.append(("qdsconv", lambda v: tq.qdsconv_fused(v, *d),
                   lambda v: ref.qdsconv_ref(v, *d), f))
    # qBSConv at Cin = C: the first SFB's b1 group on its own
    s0 = q["sfbs"][0]
    bc = (s0["b1_pwq"], s0["b1_pw_scale"], s0["b1_pwb"], s0["b1_dw_fq"], s0["b1_dwb"],
          s0["qc"][0:2])
    stages.append(("qbsconv", lambda v: tq.qbsconv_fused(v, *bc, relu=True),
                   lambda v: ref.qbsconv_ref(v, *bc, relu=True), stages[2][3]))
    return stages


def qsfb_extreme_operands(n: int, h: int, w: int, c: int, bits: int, g, torch):
    """Synthetic qSFB operands (codes, operands, site constants) on the card
    at the lattice's extremes: every input code and weight code at +-qmax
    (random signs), a third of the patches all +qmax, the weights of every
    third output channel all +qmax and of the next all -qmax; scales that
    keep the sites' codes spread (the b1 and b2 codes saturate at +qmax on
    the all-positive channels), so the integer sums reach qmax^2 * c."""
    qmax = 127 if bits <= 8 else 511
    dtype = torch.int8 if bits <= 8 else torch.int32

    def signs(*shape):
        return torch.randint(0, 2, shape, generator=g) * 2 - 1

    def scale():
        return (torch.rand(c, generator=g) + 0.5) / (qmax * qmax * c ** 0.5)

    xq = signs(n, h, w, c) * qmax
    xq[: max(1, n // 3)] = qmax
    q = {}
    for k in ("b1_pwq", "b2_pwq", "fuseq"):
        wq = signs(c, c) * qmax
        wq[:, 0::3], wq[:, 1::3] = qmax, -qmax
        q[k] = wq.to(dtype)
    for b in ("b1", "b2"):
        q.update({f"{b}_pw_scale": scale(), f"{b}_pwb": 0.1 * torch.randn(c, generator=g),
                  f"{b}_dw_fq": torch.rand((3, 3, c), generator=g) * 0.4 - 0.1,
                  f"{b}_dwb": 0.1 * torch.randn(c, generator=g)})
    q.update(fuse_scale_y=scale(), fuse_scale_x=scale(), fuseb=0.1 * torch.randn(c, generator=g))
    qc = torch.tensor([2.0, 2.0 / qmax] * 3, dtype=torch.float32)
    return (xq.to(dtype).cuda(), {k: v.contiguous().cuda() for k, v in q.items()}, qc.cuda())


def qmega_extreme_operands(c: int, bits: int, g, torch, cout: int = 48, n_sfb: int = 5):
    """Synthetic prepared operands of the whole integer chain on the card at
    the lattice's extremes (the keys of `prepare_qparams`): every weight code
    at +-qmax (random signs; in each qSFB 1x1 every third output channel all
    +qmax and the next all -qmax), scales that put the dequantized values
    past the sites' clip, and site steps of 2 / qmax at a clip of 2, so the
    codes saturate at +-qmax. In the middle qSFB every b1 code is +qmax (a
    bias past the clip after a near-zero pointwise), so its second 1x1's sums
    reach +-qmax^2 * c."""
    qmax = 127 if bits <= 8 else 511
    dtype = torch.int8 if bits <= 8 else torch.int32

    def codes(*shape, columns=False):
        wq = (torch.randint(0, 2, shape, generator=g) * 2 - 1) * qmax
        if columns:
            wq[:, 0::3], wq[:, 1::3] = qmax, -qmax
        return wq.to(dtype)

    def scale(k):
        return (torch.rand(c, generator=g) + 0.5) * 4.0 / (qmax * qmax * k ** 0.5)

    def bias(k=c):
        return 0.1 * torch.randn(k, generator=g)

    def taps():
        return torch.rand((3, 3, c), generator=g) * 0.4 - 0.1

    site = torch.tensor([2.0, 2.0 / qmax], dtype=torch.float32)
    first = dict(pwq=codes(3, c), pw_scale=scale(3), pwb=bias(), dw_fq=taps(), dwb=bias(),
                 qc=site)
    sfbs = []
    for _ in range(n_sfb):
        s = {}
        for b in ("b1", "b2"):
            s.update({f"{b}_pwq": codes(c, c, columns=True), f"{b}_pw_scale": scale(c),
                      f"{b}_pwb": bias(), f"{b}_dw_fq": taps(), f"{b}_dwb": bias()})
        s.update(fuseq=codes(c, c, columns=True), fuse_scale_y=scale(c), fuse_scale_x=scale(c),
                 fuseb=bias(), qc=torch.cat([site] * 3))
        sfbs.append(s)
    mid = sfbs[n_sfb // 2]
    mid["b1_pw_scale"] = mid["b1_pw_scale"] * 1e-4
    mid["b1_dwb"] = torch.full((c,), 8.0)
    recon = dict(dwq=codes(3, 3, c).to(torch.int32),
                 dw_scale=(torch.rand(c, generator=g) + 0.5) / (qmax * qmax * 3),
                 dwb=bias(), pw_fq=torch.randn((c, cout), generator=g) * 4 / c ** 0.5,
                 pwb=bias(cout), qc=site)
    in_qc = torch.tensor([1.0, 1.0 / qmax], dtype=torch.float32)
    q = dict(first=first, sfbs=sfbs, recon=recon, in_qc=in_qc,
             consts=torch.cat([in_qc, site] + [s["qc"] for s in sfbs] + [site]))

    def cuda(tree):
        if isinstance(tree, dict):
            return {k: cuda(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cuda(v) for v in tree]
        return tree.contiguous().cuda()
    return cuda(q)


def qchain_kernels(q, x, bits: int):
    """The recon codes of ``x`` through the per-layer quantized kernels
    (quantize, qBSConv, n x qSFB, qDSConv), each fed the kernel before."""
    from repro_torch.kernels import qconv as tq
    p, r = q["first"], q["recon"]
    f = tq.quantize_fused(x, q["in_qc"], bits=bits)
    f = tq.qbsconv_fused(f, p["pwq"], p["pw_scale"], p["pwb"], p["dw_fq"], p["dwb"], p["qc"],
                         relu=False)
    for s in q["sfbs"]:
        f = tq.qsfb_fused(f, s, s["qc"])
    return tq.qdsconv_fused(f, r["dwq"], r["dw_scale"], r["dwb"], r["pw_fq"], r["pwb"], r["qc"])


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def qwork(kind: str, n: int, c: int, bits: int, cin: int = 3, cout: int = 48):
    """(bytes each input read once and each output written once, integer
    ops, fp32 ops) of one quantized kernel on n 32x32 patches; codes take 1
    (int8) or 4 (fxp10) bytes."""
    px, cb = n * 32 * 32, 1 if bits <= 8 else 4
    if kind == "quantize":
        return px * cin * (4 + cb) + 8, 0, 3 * px * cin
    if kind == "qbsconv":        # the first layer, cin -> c
        return (px * (cin + c) * cb + cin * c * cb + 4 * 12 * c + 8,
                2 * px * cin * c, px * c * 24)
    if kind == "qsfb":           # b1, b2 and the fuse's two integer dots
        return (2 * px * c * cb + 3 * c * c * cb + 4 * 27 * c + 24,
                2 * px * 4 * c * c, px * c * 58)
    return (px * (c + cout) * cb + 4 * (9 * c + 2 * c + c * cout + cout) + 8,
            2 * px * 9 * c, px * (2 * c + 2 * c * cout + 4 * cout))


def qsfb_divisions(xq, sfb, qc, torch) -> int:
    """The requantize divisions of one qSFB on codes ``xq``: its three sites
    (b1, b2, out) are ReLU sites, which divide only where the value is > 0
    (relu_requant), so the count is this data's, from the plain version's
    steps (kernels/ref.py::qsfb_ref)."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L

    def site(x, k):
        y = ref._dequant(ref._idot(x, sfb[f"{k}_pwq"]), sfb[f"{k}_pw_scale"], sfb[f"{k}_pwb"])
        return L._dw3_shift(y, sfb[f"{k}_dw_fq"]) + sfb[f"{k}_dwb"]

    v1 = site(xq, "b1")
    v2 = site(ref.quantize_ref(torch.relu(v1), qc[0:2], xq.dtype), "b2")
    y2 = ref.quantize_ref(torch.relu(v2), qc[2:4], xq.dtype)
    v3 = (ref._idot(y2, sfb["fuseq"]).to(torch.float32) * sfb["fuse_scale_y"]
          + ref._idot(xq, sfb["fuseq"]).to(torch.float32) * sfb["fuse_scale_x"]) + sfb["fuseb"]
    return sum(int((v > 0).sum().item()) for v in (v1, v2, v3))


def qdivisions(kind: str, q, inp, bits: int, torch):
    """(divisions taken, divisions counted): the requantize divisions one
    quantized kernel takes on input ``inp`` (``q``: the prepared operands at
    its width), one per output code where no ReLU precedes the site (the
    first qBSConv, qDSConv; quantize where the clipped value is not 0) and
    for each ReLU site one per value > 0 (qSFB; qmega, the whole chain); and
    the one per site and output that qwork and qgroup_report count as one
    operation each."""
    from repro_torch.kernels import ref
    from repro_torch.quant.pams import code_dtype
    px = inp.numel() // inp.shape[-1]
    c, cout = q["first"]["pwq"].shape[-1], q["recon"]["pw_fq"].shape[-1]
    if kind == "quantize":          # a clipped 0 is code 0 with no division
        a = q["in_qc"][0]
        return int((torch.minimum(torch.maximum(inp, -a), a) != 0).sum().item()), inp.numel()
    if kind == "qbsconv":
        return px * c, px * c
    if kind == "qdsconv":
        return px * cout, px * cout
    if kind == "qsfb":
        return qsfb_divisions(inp, q["sfbs"][0], q["sfbs"][0]["qc"], torch), 3 * px * c
    f = ref.quantize_ref(inp, q["in_qc"], code_dtype(bits))          # qmega, fp patches in
    p = q["first"]
    f = ref.qbsconv_ref(f, p["pwq"], p["pw_scale"], p["pwb"], p["dw_fq"], p["dwb"], p["qc"],
                        relu=False)
    n = inp.numel() + f.numel() + px * cout
    for sfb in q["sfbs"]:
        n += qsfb_divisions(f, sfb, sfb["qc"], torch)
        f = ref.qsfb_ref(f, sfb, sfb["qc"])
    return n, px * (inp.shape[-1] + c + 3 * c * len(q["sfbs"]) + cout)


def psnr(a, b, torch) -> float:
    mse = torch.mean((a.clamp(0, 1) - b.clamp(0, 1)).double() ** 2).item()
    return float("inf") if mse == 0 else -10.0 * math.log10(mse)


def median_ms(fn, torch, runs: int = TIMING_RUNS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, torch, launches: int = GRAPH_LAUNCHES, replays: int = GRAPH_REPLAYS) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in one
    CUDA graph, the graph replayed ``replays`` times between two events, the
    elapsed time over every call. No host launch cost is in it, so a kernel
    of a few microseconds is timed by its own work and its launch on the
    card, not by the host's Python and runtime calls. ``fn`` may be a list
    of calls, captured in turn (on inputs that together exceed the L2
    cache, `cold_inputs`, every call reads device memory). Warm-up calls
    first, so nothing is built or sized during the capture."""
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    for f in fns + fns[:1] * 2:
        f()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fns[0]()                        # warm the side stream's allocator too
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(launches):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / (replays * launches)


def cold_inputs(x, torch) -> list:
    """``x`` and copies of it, together at least twice the H100's 50 MB L2
    cache, so a call on each in turn reads its input from device memory."""
    k = max(2, -(-2 * L2_BYTES // (x.numel() * x.element_size())))
    return [x] + [x.clone() for _ in range(k - 1)]


def host_ms(fn, torch, calls: int = GRAPH_LAUNCHES) -> float:
    """Host time of one call of ``fn`` (the wrapper's checks, its
    allocation, the runtime's launch), on the host clock over ``calls``
    calls; the card's queue is drained before and after, outside the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / calls


# ---------------------------------------------------------------------------
# the main path's synthetic frames
# ---------------------------------------------------------------------------

def mixed_frame(seed: int, h: int = 1080, w: int = 1920):
    """Left half a smooth gradient (bilinear), then a mildly textured
    quarter (C27) and a strongly textured quarter (C54), from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    smooth = np.stack([yy, xx, (yy + xx) / 2], axis=-1)
    amp = np.where(xx < 0.5, 0.0, np.where(xx < 0.75, 0.12, 0.5)).astype(np.float32)
    noise = rng.random((h, w, 3), dtype=np.float32) - 0.5
    return np.clip(smooth + amp[..., None] * noise, 0.0, 1.0).astype(np.float32)


def profile_frame(engine, frame, wall_s: float, torch):
    """One more frame under torch.profiler: device time by kernel (the ten
    longest and every kernel of the port's sources), and the device's busy
    share of the unprofiled frame's wall time. Returns the busy ms (None when
    the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.upscale(frame)
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or "Activity Buffer" in e.key:
            continue                    # host ops, and the profiler's own buffers
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(ms for ms, _, _ in rows)
    if not rows:
        say("phase profile: the profiler recorded no device time (not measured)")
        return None
    say(f"phase profile: device busy {busy:.3f} ms of an unprofiled frame's "
        f"{wall_s * 1e3:.3f} ms wall (idle share "
        f"{max(0.0, 1 - busy / (wall_s * 1e3)):.3f})")
    # the ten longest, and every kernel of the port's own sources besides
    for k, (ms, count, key) in enumerate(sorted(rows, reverse=True)):
        if k < 10 or "(anonymous namespace)::" in key:
            say(f"  {ms:9.3f} ms  x{count:<4d} {key[:100]}")
    return busy


def serving_phases(engine, frames, cfg, torch) -> list:
    """Phases 19-21 on ``engine``'s weights and device: the host-dispatch
    stream, fused dispatch in six modes against host dispatch, and the fused
    stream in flight. Returns phase 20's numbers, one row a mode."""
    import numpy as np
    from repro_torch.api import ExecutionPlan, SREngine
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    dev = engine.device
    h, w = frames[0].shape[:2]
    sr_shape = (h * cfg.scale, w * cfg.scale, 3)

    # 19. the stream: serve()/stream() on the phase-5 weights under host
    # dispatch, Algorithm-1 thresholds that move
    from repro_torch.core import pipeline as pl
    from repro_torch.core.adaptive import AdaptiveSwitcher, SwitchingConfig
    frames8 = frames + [mixed_frame(SEED + i, h, w) for i in range(len(frames), STREAM_FRAMES)]
    moving = SwitchingConfig(frame_high=STREAM_FRAME_HIGH, frame_low=STREAM_FRAME_LOW)
    streamer = SREngine(engine.model, switching=moving, device=dev)
    shadow = AdaptiveSwitcher(moving)
    seen = set()
    for i, r in enumerate(streamer.stream(frames8)):
        want = shadow.assign(r.scores)
        alone = streamer.upscale(frames8[i], ids_override=r.ids)
        same = torch.equal(r.image, alone.image)
        ok = (np.array_equal(r.ids, want) and r.thresholds == shadow.thresholds and same
              and tuple(r.image.shape) == sr_shape)
        say(f"phase stream frame {i}: latency {r.latency_s * 1e3:.2f} ms, counts {r.counts}, "
            f"thresholds after it {r.thresholds} (host-only switcher {shadow.thresholds}), ids "
            f"equal to its {np.array_equal(r.ids, want)}, image torch.equal to "
            f"upscale(ids_override=ids) {same}")
        if not ok:
            fail(f"stream frame {i} disagrees with the host-only switcher or with its "
                 f"ids_override frame")
        seen.add(r.thresholds)
    if len(seen) < 2:
        fail("the stream's thresholds never moved")
    say(f"phase stream summary: {json.dumps(streamer.summary())}")
    del streamer

    # 20. fused dispatch, six modes: each frame one CUDA graph replay,
    # against the same frames under host dispatch
    from repro_torch.kernels import _build as kbuild
    per_frame = {"layer": {"edge": 1, "bsconv": 2, "sfb": 5 * 2, "dsconv": 2},
                 "group": {"edge": 1, "mega": 2}}
    qper_frame = {"layer": {"edge": 1, "quantize": 2, "qbsconv": 2, "qsfb": 5 * 2,
                            "qdsconv": 2},
                  "group": {"edge": 1, "qmega": 2}}
    fused_report = []
    for qmode in (None,) + QUANT_MODES:
        for fusion in ("layer", "group"):
            name_m = f"{qmode or 'fp32'} {fusion}"
            plan = ExecutionPlan(quant=qmode, fusion=fusion)
            host = SREngine(engine.model, plan=plan, device=dev)
            fused = SREngine(engine.model, plan=plan.replace(dispatch="fused"), device=dev)
            pl._fused_frame_fn.cache_clear()
            host.upscale(frames[0])
            first = fused.upscale(frames[0])
            graph = pl._fused_frame_fn.values()[0]
            expect = (qper_frame if qmode else per_frame)[fusion]
            say(f"phase fused {name_m}: first frame (probe + warm-up + capture) "
                f"{first.latency_s * 1e3:.1f} ms, capacity profile "
                f"{list(fused._fused_caps.values())}, graph pool "
                f"{graph.pool_bytes} B ({graph.pool_bytes / 2 ** 20:.1f} MiB), launches a "
                f"replay from the capture {graph.launches} (expected {expect})")
            if graph.launches != expect or graph.pool_bytes <= 0:
                fail(f"the fused {name_m} graph did not capture the expected launches")
            for i, f in enumerate(frames):
                a, b = host.upscale(f), fused.upscale(f)
                ids_equal = bool(np.array_equal(b.ids.cpu().numpy(), a.ids))
                same = torch.equal(a.image, b.image)
                say(f"phase fused {name_m} frame {i}: counts {b.counts}, spills "
                    f"{b.spill_counts}, ids equal {ids_equal}, image torch.equal to the host "
                    f"frame {same}, label {b.backend}")
                if not (ids_equal and same and b.spill_counts == (0, 0, 0)
                        and b.dispatch == "fused" and b.backend == a.backend):
                    fail(f"the fused {name_m} frame {i} disagrees with host dispatch")
            # a replay looks up no C entry (no wrapper launches) and captures
            # nothing; its launches are the capture's deltas
            calls, real_entry = [], kbuild.entry
            kbuild.entry = lambda *a: (calls.append(a[:2]), real_entry(*a))[1]
            misses = pl._fused_frame_fn.occupancy()["misses"]
            reset_launch_counts()
            try:
                b = fused.upscale(frames[1])
            finally:
                kbuild.entry = real_entry
            counted = {k: v for k, v in launch_counts().items() if v}
            if calls or counted != expect or pl._fused_frame_fn.occupancy()["misses"] != misses:
                fail(f"the fused {name_m} replay called {calls} or counted {counted}")
            say(f"phase fused {name_m} replay: no wrapper call, no capture, launches {counted}")
            lat = {"host": [], "fused": []}
            for k in range(STEADY_FRAMES):
                f = frames[k % len(frames)]
                lat["host"].append(host.upscale(f).latency_s * 1e3)
                lat["fused"].append(fused.upscale(f).latency_s * 1e3)
            row = {"mode": name_m, "pool_bytes": graph.pool_bytes, "launches": graph.launches}
            for which, eng in (("host", host), ("fused", fused)):
                v = sorted(lat[which])
                med = statistics.median(v)
                busy = profile_frame(eng, frames[1], med / 1e3, torch)
                row[which] = {"median_ms": med, "min_ms": v[0], "max_ms": v[-1],
                              "q1_ms": v[len(v) // 4], "q3_ms": v[(3 * len(v)) // 4],
                              "busy_ms": busy,
                              "idle_share": None if busy is None else max(0.0, 1 - busy / med)}
                say(f"phase fused {name_m} {which} dispatch: {STEADY_FRAMES} steady frames, "
                    f"latency median {med:.3f} ms (min {v[0]:.3f}, quartiles "
                    f"{row[which]['q1_ms']:.3f}-{row[which]['q3_ms']:.3f}, max {v[-1]:.3f}); "
                    f"profiled frame busy {busy if busy is None else round(busy, 3)} ms")
            fused_report.append(row)
            del host, fused, graph, first, a, b
            pl._fused_frame_fn.cache_clear()
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    # 21. the fused stream, synchronous and with two frames in flight
    stable = SwitchingConfig(frame_high=10 ** 9, frame_low=0)
    streams = {}
    for n in (1, 2):
        eng = SREngine(engine.model, plan=ExecutionPlan(dispatch="fused", inflight=n),
                       switching=stable, device=dev)
        t0 = time.perf_counter()
        streams[n] = list(eng.stream(frames8))
        wall = time.perf_counter() - t0
        marg = [r.latency_s * 1e3 for r in streams[n]]
        say(f"phase fused stream inflight={n}: {len(marg)} frames in {wall * 1e3:.1f} ms, "
            f"marginal latencies {', '.join(f'{m:.2f}' for m in marg)} ms (steady median "
            f"{statistics.median(marg[1:]):.2f}), spills {[r.spill_counts for r in streams[n]]}")
        del eng
    for i, (a, b) in enumerate(zip(streams[1], streams[2])):
        if not (a.counts == b.counts and torch.equal(a.ids, b.ids)
                and torch.equal(a.image, b.image)):
            fail(f"the in-flight fused stream's frame {i} differs from the synchronous one")
    say(f"phase fused stream: inflight 2 equals inflight 1 on all {len(streams[1])} frames, "
        f"in order")
    del streams
    pl._fused_frame_fn.cache_clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return fused_report


# ---------------------------------------------------------------------------
# phases 22-24: one graph pool a device, multi-tenant ticks, faults
# ---------------------------------------------------------------------------

class Boom:
    """A tenant iterator that yields one frame, then raises (phase 24)."""

    def __init__(self, frames):
        self.frames = frames

    def __iter__(self):
        yield self.frames[0]
        raise RuntimeError("tenant iterator died")


def _ticks(results):
    """Results grouped by tick: a new tick starts where the stream id does
    not rise (within a tick, streams come in id order)."""
    ticks = []
    for r in results:
        if not ticks or r.stream_id <= ticks[-1][-1].stream_id:
            ticks.append([])
        ticks[-1].append(r)
    return ticks


def _quartiles(v):
    v = sorted(v)
    return {"median_ms": statistics.median(v), "q1_ms": v[len(v) // 4],
            "q3_ms": v[(3 * len(v)) // 4], "min_ms": v[0], "max_ms": v[-1]}


def pool_phase(engine, frames, torch) -> dict:
    """22. Fault 5: one 1080p frame under POOL_PROFILES distinct pinned
    capacity profiles, one fused engine each (so that many graphs live at
    once): the reserved device memory after each, and each frame torch.equal
    to host dispatch. The graphs share the device's pool, so the reserved
    memory may not grow by anything near a pool per profile."""
    from repro_torch.api import ExecutionPlan, SREngine
    from repro_torch.core import pipeline as pl
    dev = engine.device
    pl._fused_frame_fn.cache_clear()
    pl._fused_stream_fn.cache_clear()
    want = engine.upscale(frames[0]).image
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    rows, keep = [], []
    for j in range(POOL_PROFILES):
        caps = (0, 1024 + 128 * j, 1024)
        eng = SREngine(engine.model, plan=ExecutionPlan(dispatch="fused", capacity=caps),
                       device=dev)
        r = eng.upscale(frames[0])
        torch.cuda.synchronize()
        graph = pl._fused_frame_fn.values()[-1]
        same = torch.equal(r.image, want)
        row = {"profiles": j + 1, "capacity": caps,
               "reserved_mib": (torch.cuda.memory_reserved(dev) - base) / 2 ** 20,
               "allocated_mib": torch.cuda.memory_allocated(dev) / 2 ** 20,
               "graph_pool_mib": graph.pool_bytes / 2 ** 20, "equal_to_host": same}
        say(f"phase pools: {json.dumps(row)}")
        if not (same and r.spill_counts == (0, 0, 0)):
            fail(f"the fused frame under pinned capacity {caps} differs from host dispatch")
        rows.append(row)
        keep.append(eng)
        del r
    first = rows[0]["graph_pool_mib"]
    grown = rows[-1]["reserved_mib"] - rows[0]["reserved_mib"]
    say(f"phase pools: {POOL_PROFILES} graphs reserve {rows[-1]['reserved_mib']:.1f} MiB above "
        f"the host frame, {grown:.1f} MiB more than one graph (its pool {first:.1f} MiB); the "
        f"six modes' fused frames were torch.equal to host dispatch in phase 20 with the shared "
        f"pool")
    if not (first > 0 and grown <= first / 2):
        fail(f"{POOL_PROFILES} graphs grew the reserved memory by {grown:.1f} MiB past one "
             f"graph's pool of {first:.1f} MiB: the graphs do not share a pool")
    del keep
    pl._fused_frame_fn.cache_clear()
    torch.cuda.empty_cache()
    return {"rows": rows, "growth_past_one_graph_mib": grown}


def stream_phase(engine, torch) -> list:
    """23. Four tenants of 960x540 -> 3840x2160 (a tick holds 4 x 576 =
    2,304 patches, one 1080p frame's worth), shares (2, 1, 1, 1), ragged
    lengths TENANT_FRAMES, under fp32 "layer" and "group" and int8
    "group", capacity pinned per stream: each tenant's frames torch.equal
    to the tenant served solo, round-robin order, one capture per live
    count and none on a second run (no wrapper call; launches the captures'
    deltas), two ticks in flight equal to synchronous. Returns a row a
    mode: launches a tick, tick latency quartiles, marginal latency in
    flight, pool bytes per live count."""
    import tempfile
    import numpy as np
    from repro_torch.api import ExecutionPlan, SREngine
    from repro_torch.core import pipeline as pl
    from repro_torch.core.adaptive import SwitchingConfig
    from repro_torch.kernels import _build as kbuild
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    dev = engine.device
    stable = SwitchingConfig(frame_high=10 ** 9, frame_low=0)
    tenants = [[mixed_frame(SEED + 100 * s + i, *TENANT_HW) for i in range(n)]
               for s, n in enumerate(TENANT_FRAMES)]
    order = [s for t in range(max(TENANT_FRAMES)) for s, n in enumerate(TENANT_FRAMES) if t < n]
    report = []
    alphas = tempfile.mkdtemp(prefix="essr_alphas_")
    for qmode, fusion in ((None, "layer"), (None, "group"), ("int8", "group")):
        name_m = f"{qmode or 'fp32'} {fusion}"
        pl._fused_frame_fn.cache_clear()
        pl._fused_stream_fn.cache_clear()
        plan = ExecutionPlan(dispatch="fused", quant=qmode, fusion=fusion,
                             capacity=TENANT_CAPACITY)
        mk = dict(switching=stable, device=dev, quant_cache=alphas)
        mux = SREngine(engine.model, plan=plan.replace(streams=len(tenants),
                                                        stream_shares=TENANT_SHARES), **mk)
        misses = pl._fused_stream_fn.occupancy()["misses"]
        first = list(mux.serve_streams(tenants))
        captured = pl._fused_stream_fn.occupancy()["misses"] - misses
        ids = [r.stream_id for r in first]
        graphs = {g.streams: g for g in pl._fused_stream_fn.values()}
        say(f"phase streams {name_m}: {len(first)} frames in {len(_ticks(first))} ticks, "
            f"stream order {ids}, {captured} captures for live counts {sorted(graphs)}")
        if ids != order or captured != len(graphs) or sorted(graphs) != [2, 3, 4]:
            fail(f"the {name_m} ticks broke round-robin order or captured {captured} graphs "
                 f"for live counts {sorted(graphs)}")
        # each tenant against the same tenant served solo
        for s, frames_s in enumerate(tenants):
            solo = SREngine(engine.model, plan=plan, **mk)
            mine = [r for r in first if r.stream_id == s]
            for i, (a, b) in enumerate(zip(mine, solo.stream(frames_s))):
                if not (a.counts == b.counts and a.spill_counts == b.spill_counts == (0, 0, 0)
                        and torch.equal(a.ids, b.ids) and torch.equal(a.image, b.image)
                        and a.backend == b.backend):
                    fail(f"{name_m}: tenant {s} frame {i} differs from the tenant served solo")
            del solo
        say(f"phase streams {name_m}: every tenant's {sum(TENANT_FRAMES)} frames torch.equal "
            f"to the tenant served solo (ids, counts equal, no spills), label {first[0].backend}")
        # a second run replays: no capture, no wrapper call, the deltas
        calls, real_entry = [], kbuild.entry
        kbuild.entry = lambda *a: (calls.append(a[:2]), real_entry(*a))[1]
        misses = pl._fused_stream_fn.occupancy()["misses"]
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            again = list(mux.serve_streams(tenants))
        finally:
            kbuild.entry = real_entry
        wall = time.perf_counter() - t0
        counted = {k: v for k, v in launch_counts().items() if v}
        want = {}
        for r in _ticks(again):
            for k, v in graphs[len(r)].launches.items():
                want[k] = want.get(k, 0) + v
        if calls or counted != want or pl._fused_stream_fn.occupancy()["misses"] != misses:
            fail(f"{name_m}: the second run called {calls}, counted {counted} (the captures' "
                 f"deltas {want}) or captured again")
        if not all(torch.equal(a.image, b.image) for a, b in zip(first, again)):
            fail(f"{name_m}: the replayed ticks differ from the first run")
        sync_ms = [t[0].latency_s * 1e3 for t in _ticks(again)]
        by_live = {}
        for t, ms in zip(_ticks(again)[1:], sync_ms[1:]):
            by_live.setdefault(len(t), []).append(ms)
        # two ticks in flight against the synchronous run
        flight = SREngine(engine.model, plan=mux.plan.replace(inflight=2), **mk)
        t0 = time.perf_counter()
        async_res = list(flight.serve_streams(tenants))
        wall_async = time.perf_counter() - t0
        if [r.stream_id for r in async_res] != order or not all(
                a.counts == b.counts and torch.equal(a.image, b.image)
                for a, b in zip(again, async_res)):
            fail(f"{name_m}: two ticks in flight differ from synchronous ticks")
        async_ms = [t[0].latency_s * 1e3 for t in _ticks(async_res)]
        row = {"mode": name_m, "tenants": list(TENANT_FRAMES), "shares": list(TENANT_SHARES),
               "launches_per_tick": {n: g.launches for n, g in sorted(graphs.items())},
               "pool_bytes_per_live_count": {n: g.pool_bytes for n, g in sorted(graphs.items())},
               "reserved_mib": (torch.cuda.memory_reserved(dev) / 2 ** 20
                                if dev.type == "cuda" else None),
               "tick_latency": _quartiles(sync_ms[1:]), "tick_ms": sync_ms,
               "tick_median_ms_by_live": {n: statistics.median(v)
                                          for n, v in sorted(by_live.items())},
               "wall_ms": wall * 1e3, "inflight2_tick_ms": async_ms,
               "inflight2_marginal": _quartiles(async_ms[1:]),
               "inflight2_wall_ms": wall_async * 1e3,
               "counts_tick0": [r.counts for r in _ticks(again)[0]]}
        q = row["tick_latency"]
        say(f"phase streams {name_m}: launches a tick {row['launches_per_tick']}, pool bytes "
            f"per live count {row['pool_bytes_per_live_count']}; {len(sync_ms)} ticks in "
            f"{wall * 1e3:.1f} ms, steady tick latency median {q['median_ms']:.3f} ms "
            f"(quartiles {q['q1_ms']:.3f}-{q['q3_ms']:.3f}, range {q['min_ms']:.3f}-"
            f"{q['max_ms']:.3f}; by live count {row['tick_median_ms_by_live']}); two in flight: "
            f"{wall_async * 1e3:.1f} ms, marginal median "
            f"{row['inflight2_marginal']['median_ms']:.3f} ms; torch.equal to synchronous")
        report.append(row)
        del mux, flight, first, again, async_res, graphs
        pl._fused_stream_fn.cache_clear()
        pl._fused_frame_fn.cache_clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return report


def fault_phase(engine, torch) -> dict:
    """24. Seeded FaultPlans on the card, each run again on the CPU with the
    same plan and frames: injected backend failures step the ladder from
    group->layer to ->ref (every tick says what served it); a poisoned
    tenant is quarantined and re-admitted while the healthy tenants stay
    torch.equal to a run without faults; an iterator that raises retires
    its own stream only. The ledgers (watchdog events aside) equal the
    CPU's."""
    from repro_torch.api import ExecutionPlan, SREngine
    from repro_torch.core import pipeline as pl
    from repro_torch.core.adaptive import SwitchingConfig
    from repro_torch.runtime.guard import FaultPlan
    stable = SwitchingConfig(frame_high=10 ** 9, frame_low=0)
    tenants = [[mixed_frame(SEED + 200 + 10 * s + i, *FAULT_HW) for i in range(4)]
               for s in range(3)]
    cpu_model = copy.deepcopy(engine.model).cpu()        # an engine moves its model
    runs = {
        "ladder": (dict(fusion="group", faults=FaultPlan(seed=4, backend_failure_rate=1.0)),
                   tenants),
        "quarantine": (dict(capacity=(0, 24, 24), quarantine_ticks=1, faults=FaultPlan(
            seed=7, poison_rate=1.0, poison_kinds=("nan",), target_streams=(1,))), tenants),
        "iterator": (dict(capacity=(0, 24, 24)), [tenants[0], Boom(tenants[1]), tenants[2]]),
    }
    report = {}
    for name, (kw, streams) in runs.items():
        plan = ExecutionPlan(dispatch="fused", streams=3, **kw)
        out = {}
        for where, model in (("card", engine.model), ("cpu", cpu_model)):
            eng = SREngine(model, plan=plan, switching=stable,
                           device=engine.device if where == "card" else "cpu")
            res = list(eng.serve_streams(streams))
            ledger = eng.summary().get("degradations", {})
            events = [e for e in ledger.get("events", []) if e["kind"] != "watchdog"]
            out[where] = (eng, res, events)
        eng, res, events = out["card"]
        say(f"phase faults {name}: {len(res)} frames, streams {[r.stream_id for r in res]}, "
            f"steps {[t[0].degraded for t in _ticks(res)]}, labels "
            f"{[t[0].backend for t in _ticks(res)]}, ledger {json.dumps(events)}")
        ticks = {where: [(r.stream_id, r.degraded, r.backend.replace("cuda-plain", "cuda"),
                          r.counts) for r in o[1]] for where, o in out.items()}
        if events != out["cpu"][2] or ticks["card"] != ticks["cpu"]:
            fail(f"phase faults {name}: the card's ledger or ticks differ from the CPU run's "
                 f"({json.dumps(out['cpu'][2])})")
        if name == "ladder":
            steps = [t[0].degraded for t in _ticks(res)]
            labels = [t[0].backend for t in _ticks(res)]
            if steps[:3] != [("fusion:group->layer",), ("backend:->ref",), ("retry",)] or \
                    labels[1] != "ref" or not labels[0].startswith("cuda") or eng.guard.level != 2:
                fail(f"the injected failures did not step the ladder as planned: {steps}, "
                     f"{labels}")
        else:
            clean = SREngine(engine.model, plan=plan.replace(faults=None), switching=stable,
                             device=engine.device)
            base = list(clean.serve_streams(tenants))
            healthy = (0, 2)
            for s in healthy:
                a = [r.image for r in res if r.stream_id == s]
                b = [r.image for r in base if r.stream_id == s]
                if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
                    fail(f"phase faults {name}: healthy tenant {s} differs from the run "
                         f"without faults")
            kinds = eng.summary()["degradations"]["by_kind"]
            ok = ({"quarantine", "readmit", "poison"} <= set(kinds) if name == "quarantine"
                  else kinds == {"retire": 1})
            n1 = sum(r.stream_id == 1 for r in res)
            if not ok or (name == "iterator" and n1 != 1) or (name == "quarantine" and n1):
                fail(f"phase faults {name}: ledger {kinds}, stream 1 served {n1} frames")
            say(f"phase faults {name}: healthy tenants {healthy} torch.equal to the run "
                f"without faults; ledger by kind {kinds}; stream 1 served {n1} frames")
        report[name] = {"events": events, "steps": [t[0].degraded for t in _ticks(res)],
                        "labels": [t[0].backend for t in _ticks(res)]}
        del out
        pl._fused_stream_fn.cache_clear()
        if engine.device.type == "cuda":
            torch.cuda.empty_cache()
    return report


def shard_phase(engine, frames, torch) -> dict:
    """25. The sharded patch stream: the three 1080p frames under
    ExecutionPlan(shards=SHARDS) warn as the reference does (on one card:
    single-device dispatch); each frame's ids and per-shard thresholds
    equal a host-only ShardSwitcherBank fed the same scores; each image
    torch.equal to upscale(frame, ids_override=ids) at shards=1 on one card.
    Then the split forward, torch.equal to the unsplit kernels at N =
    SHARD_N (not a multiple of SHARDS) in fp32 layer and group and int8
    layer and group, each kernel of the mode launched once a chunk; then an
    impossible deadline demotes the overloaded strip alone. On one card the
    split runs over the card named SHARDS times. On several (``--multicard``)
    the frames and the split run over the first min(SHARDS, cards) cards,
    each of which must hold its weight copy, the split is timed beside the
    unsplit forward, and fused dispatch must refuse the devices (ROADMAP
    item 12b)."""
    import tempfile
    import warnings
    import numpy as np
    from repro_torch.api import ExecutionPlan, SREngine
    from repro_torch.core import subnet_policy as sp
    from repro_torch.core.adaptive import ShardSwitcherBank, SwitchingConfig
    from repro_torch.core.pipeline import _sharded_forward, resolve_forward
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_patch_devices
    dev = engine.device
    plan = ExecutionPlan(shards=SHARDS)
    cards = torch.cuda.device_count()
    spread = min(SHARDS, cards)
    if cards == 1:
        want_warnings = [f"plan.shards={SHARDS} on a single-device host; dispatch falls back "
                         f"to one device (per-shard routing control unchanged)"]
    elif cards < SHARDS:
        want_warnings = [f"plan.shards={SHARDS} but only {cards} devices visible; dispatching "
                         f"over {cards} (per-shard routing control unchanged)"]
    else:
        want_warnings = []
    want_devices = None if cards == 1 else make_patch_devices(spread)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sharded = SREngine(engine.model, plan=plan, device=dev)
    texts = [str(w.message) for w in caught]
    say(f"phase shards: {cards} card(s) visible; devices {sharded.devices}; warnings {texts}")
    if texts != want_warnings or sharded.devices != want_devices:
        fail(f"plan.shards={SHARDS} on {cards} card(s) did not warn or pick its devices as "
             f"the reference does")
    single = SREngine(engine.model, device=dev)
    shadow = ShardSwitcherBank(SwitchingConfig(), SHARDS)
    macs = sp.SubnetMacs.make(sharded.cfg, plan.patch)
    report = {"cards": cards, "warnings": texts, "frames": []}
    reset_launch_counts()
    served = [sharded.serve(f) for f in frames]
    launches = launch_counts()
    for i, (f, r) in enumerate(zip(frames, served)):
        slices = plan.geometry(*f.shape[:2], sharded.cfg.scale, dev).shard_slices(SHARDS)
        ids = shadow.assign(r.scores, slices)
        counts = [sp.subnet_counts(ids[sl]) for sl in slices]
        shadow.note_frame(r.deadline_missed, [macs.total(c) for c in counts])
        alone = single.upscale(f, ids_override=r.ids)
        ok_ids = np.array_equal(r.ids, ids) and r.shard_thresholds == shadow.thresholds
        same = torch.equal(r.image, alone.image)
        say(f"phase shards frame {i}: shard counts {r.shard_counts}, thresholds "
            f"{r.shard_thresholds}, ids and thresholds equal to a host-only bank {ok_ids}, "
            f"image torch.equal to upscale(ids_override=ids) at shards=1 {same}")
        if not (ok_ids and same and list(r.shard_counts) == counts):
            fail(f"sharded frame {i} disagrees with the host-only bank or its "
                 f"ids_override frame")
        report["frames"].append({"shard_counts": r.shard_counts,
                                 "shard_thresholds": r.shard_thresholds})
    # on several cards every conv bucket runs as one chunk a card
    conv = sum(1 for r in served for c in (r.counts[1], r.counts[2]) if c)
    conv *= 1 if cards == 1 else spread
    want = {"edge": len(frames), "bsconv": conv, "sfb": 5 * conv, "dsconv": conv}
    say(f"phase shards launches: {launches} (expected {want} and nothing else)")
    if any(launches[k] != want.get(k, 0) for k in launches):
        fail("the sharded frames did not launch the layer kernels of their buckets")
    # the split forward (over the card named SHARDS times, or over the
    # cards), against the unsplit kernels on the first card
    cfg = sharded.cfg
    x = torch.rand((SHARD_N, 32, 32, 3), generator=torch.Generator().manual_seed(SEED)).to(dev)
    alphas = tempfile.mkdtemp(prefix="essr_alphas_")
    qeng = SREngine(engine.model, plan=ExecutionPlan(quant="int8"), device=dev,
                    quant_cache=alphas)
    devices = (torch.device("cuda", 0),) * SHARDS if cards == 1 else want_devices
    where = "cuda:0" if cards == 1 else f"cuda:0..{spread - 1}"
    kernels = {("fp32", "layer"): ("bsconv", "sfb", "dsconv"), ("fp32", "group"): ("mega",),
               ("int8", "layer"): ("quantize", "qbsconv", "qsfb", "qdsconv"),
               ("int8", "group"): ("qmega",)}
    report["split"] = {}
    with torch.inference_mode():
        for (mode, fusion), ks in kernels.items():
            pack = qeng.qpack if mode == "int8" else None
            reset_launch_counts()
            got = _sharded_forward(engine.params, x, cfg, 54, devices=devices, backend="cuda",
                                   quant=pack, fusion=fusion)
            torch.cuda.synchronize()
            split = launch_counts()
            want_out = resolve_forward("cuda", pack, fusion)(engine.params, x, cfg, 54)
            same = torch.equal(got, want_out)
            per = {k: split[k] for k in ks}
            say(f"phase shards split {mode} {fusion}: N={SHARD_N} over {len(devices)} chunks "
                f"of {-(-SHARD_N // len(devices))} on {where}, torch.equal to the unsplit "
                f"forward {same}; launches {per}")
            expect = {q: (5 if q in ("sfb", "qsfb") else 1) * len(devices) for q in ks}
            if not same or per != expect:
                fail(f"the split {mode} {fusion} forward differs from the unsplit one or "
                     f"launched {per} (expected {expect})")
            report["split"][f"{mode} {fusion}"] = {"equal": same, "launches": per}
            del got, want_out
        if cards > 1:
            report["multicard"] = multicard_checks(engine, sharded, frames[0], x, devices,
                                                   torch)
    # an impossible deadline: the noisy top strip is the overload, demoted alone
    h, w = frames[0].shape[:2]
    top = np.broadcast_to(np.linspace(0, 1, w, dtype=np.float32)[None, :, None],
                          (h, w, 3)).copy()
    top[: h // SHARDS] = np.random.default_rng(SEED).random((h // SHARDS, w, 3), np.float32)
    flat = SwitchingConfig(c54_per_sec_budget=10 ** 9, frame_high=10 ** 9, frame_low=0)
    late = SREngine(engine.model, plan=plan, device=dev, deadline_s=1e-9, switching=flat)
    r1, r2 = late.serve(top), late.serve(top)
    base = flat.t1, flat.t2
    say(f"phase shards deadline: shard C54 counts {[c[2] for c in r1.shard_counts]} -> "
        f"{[c[2] for c in r2.shard_counts]}, demoted {r1.shard_deadline_missed}, thresholds "
        f"{r2.shard_thresholds}")
    heavy = r1.shard_deadline_missed
    if not (r1.deadline_missed and heavy[0] and not any(heavy[1:])
            and r2.shard_thresholds[0] > r1.shard_thresholds[0] > base
            and all(t == base for t in r2.shard_thresholds[1:])
            and r2.shard_counts[0][2] <= r1.shard_counts[0][2]):
        fail("the missed deadline did not demote the overloaded strip alone")
    report["deadline"] = {"demoted": heavy, "thresholds": r2.shard_thresholds,
                          "c54": [[c[2] for c in r.shard_counts] for r in (r1, r2)]}
    torch.cuda.empty_cache()
    return report


def multicard_checks(engine, sharded, frame, x, devices, torch) -> dict:
    """Phase 25 on several cards: each card holds its copy of the weights,
    the fp32 group split over the cards is timed beside the unsplit forward
    on the first card (every card synchronized around each call: a median
    wall time), and fused dispatch refuses the
    devices (item 12b)."""
    from repro_torch.api import SREngine
    from repro_torch.core.pipeline import _sharded_forward, resolve_forward
    held = [torch.cuda.memory_allocated(d) for d in devices]
    say(f"phase shards cards: bytes allocated a card after the split {held}")
    if not all(held):
        fail("a card of the split holds nothing: its chunk did not run there")

    def wall_ms(fn) -> float:
        times = []
        for _ in range(SHARD_REPEATS):
            for d in devices:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            fn()
            for d in devices:
                torch.cuda.synchronize(d)
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    with torch.inference_mode():
        whole = resolve_forward("cuda", None, "group")
        split_ms = wall_ms(lambda: _sharded_forward(engine.params, x, engine.cfg, 54,
                                                    devices=devices, fusion="group"))
        one_ms = wall_ms(lambda: whole(engine.params, x, engine.cfg, 54))
    say(f"phase shards cards time: fp32 group, N={SHARD_N} 32x32 at C54: over {len(devices)} "
        f"cards {split_ms:.3f} ms, on one card {one_ms:.3f} ms (median wall of "
        f"{SHARD_REPEATS}, copies included)")
    fused = SREngine(engine.model, plan=sharded.plan.replace(dispatch="fused"),
                     device=engine.device)
    try:
        fused.serve(frame)
        refused = ""
    except ValueError as e:
        refused = str(e)
    say(f"phase shards cards fused: {refused or 'served, not refused'}")
    if "12b" not in refused:
        fail("fused dispatch over several cards was not refused")
    return {"bytes_held": held, "split_ms": split_ms, "one_card_ms": one_ms,
            "fused_refused": refused}


def train_phase(torch) -> dict:
    """26. Supernet training at full width on the card: ESSRConfig(scale=4)
    (C54, 5 SFBs) from a seeded init, patch_batches(batch=TRAIN_BATCH,
    lr_patch=TRAIN_PATCH), Lamb with a cosine lr of 3e-3, TF32 off. The
    first TRAIN_CHECK steps' losses and weights against the same steps on
    the CPU (rtol 1e-4; weights within 1e-4 of each leaf's max); then
    TRAIN_STEPS steps: the loss must fall (first against the mean of the
    last 10), steps a second and peak memory. The megakernel's gradients at
    C54, N = 16 32x32 patches, against the plain forward's (normalized atol
    1e-3), with its launches counted; two GAN steps; a checkpoint written
    from the card served by SREngine.from_checkpoint, torch.equal to
    from_params of the same EMA."""
    import tempfile
    import numpy as np
    from repro_torch.api import SREngine
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import patch_batches
    from repro_torch.kernels.megakernel import essr_forward_megakernel
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.essr import ESSRConfig, essr_forward, init_essr
    from repro_torch.train import optimizer as O
    from repro_torch.train.gan import train_essr_gan
    from repro_torch.train.trainer import train_essr_supernet
    cfg = ESSRConfig(scale=4)
    dev = torch.device("cuda")
    steps = TRAIN_CHECK + TRAIN_STEPS
    t0 = time.perf_counter()
    data = patch_batches(SEED, batch=TRAIN_BATCH, lr_patch=TRAIN_PATCH, scale=cfg.scale,
                         device=dev)
    first = [next(data) for _ in range(TRAIN_CHECK)]
    say(f"phase train data: a pool of 16 256x256 HR images and the first {TRAIN_CHECK} "
        f"batches in {time.perf_counter() - t0:.1f} s")
    report = {"card": card_line(), "batch": TRAIN_BATCH, "lr_patch": TRAIN_PATCH}
    # the first steps on the card and on the CPU, from the same weights and batches
    runs = {}
    for where in ("cuda", "cpu"):
        model = init_essr(cfg, torch.Generator().manual_seed(SEED)).to(where)
        batches = iter([(a.to(where), b.to(where)) for a, b in first])
        opt = O.lamb(O.cosine_decay(3e-3, steps))
        m, ema, hist = train_essr_supernet(model, cfg, batches, TRAIN_CHECK, opt=opt, seed=SEED,
                                           log_every=0)
        runs[where] = ([p.detach().cpu() for p in tree_leaves(m.tree())], hist)
    (card_w, card_h), (cpu_w, cpu_h) = runs["cuda"], runs["cpu"]
    loss_ok = np.allclose(card_h, cpu_h, rtol=1e-4, atol=0)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
                for a, b in zip(card_w, cpu_w))
    say(f"phase train check: {TRAIN_CHECK} steps, losses card {card_h} cpu {cpu_h} (rtol 1e-4 "
        f"{'ok' if loss_ok else 'MISMATCH'}); weights worst leaf max_abs / leaf max "
        f"{worst:.3e} (1e-4)")
    if not loss_ok or worst > 1e-4:
        fail("the first training steps on the card disagree with the same steps on the CPU")
    report.update(check_losses_card=card_h, check_losses_cpu=cpu_h, check_worst_leaf=worst)
    # TRAIN_STEPS steps on the card: the loss falls; steps a second, peak memory
    warm = init_essr(cfg, torch.Generator().manual_seed(SEED + 1)).to(dev)
    train_essr_supernet(warm, cfg, iter(first), 1, log_every=0)      # warm-up, thrown away
    del warm
    model = init_essr(cfg, torch.Generator().manual_seed(SEED)).to(dev)
    opt = O.lamb(O.cosine_decay(3e-3, TRAIN_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()         # earlier phases' tensors and the model
    t0 = time.perf_counter()
    model, ema, hist = train_essr_supernet(model, cfg, data, TRAIN_STEPS, opt=opt, seed=SEED,
                                           log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    last = float(np.mean(hist[-10:]))
    say(f"phase train: {TRAIN_STEPS} steps at C54 x4, batch {TRAIN_BATCH} of {TRAIN_PATCH}x"
        f"{TRAIN_PATCH} LR patches, Lamb cosine 3e-3, TF32 off: loss {hist[0]:.5f} -> mean of "
        f"the last 10 {last:.5f}; {TRAIN_STEPS / wall:.2f} steps/s "
        f"({wall * 1e3 / TRAIN_STEPS:.2f} ms a step incl. the data and a loss copy a step); "
        f"peak memory allocated {peak:.1f} "
        f"MiB above the {held / 2 ** 20:.1f} MiB held before ({card_line()})")
    if not (np.all(np.isfinite(hist)) and last < hist[0]):
        fail("the training loss did not fall")
    report.update(steps=TRAIN_STEPS, loss_first=hist[0], loss_last10=last,
                  steps_per_s=TRAIN_STEPS / wall, peak_mib=peak)
    # three more steps under the profiler: device kernels a step, busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_essr_supernet(model, cfg, data, 3, opt=O.lamb(3e-3), seed=SEED, log_every=0)
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) / 3
    dev_rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "Activity Buffer" not in e.key]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in dev_rows) / 1e3 / 3
    kernels = sum(e.count for e in dev_rows) / 3
    say(f"phase train profile: {kernels:.0f} device kernels a step, device busy {busy:.3f} ms "
        f"of a profiled step's {pwall * 1e3:.2f} ms wall (idle share "
        f"{max(0.0, 1 - busy / (pwall * 1e3)):.3f}); the most launched:")
    for e in sorted(dev_rows, key=lambda e: -e.count)[:6]:
        ms = getattr(e, "self_device_time_total", 0) / 3e3
        say(f"  x{e.count / 3:6.0f} a step, {ms:.3f} ms  {e.key[:90]}")
    report.update(kernels_per_step=kernels, busy_ms_per_step=busy, profiled_step_ms=pwall * 1e3)
    # the megakernel's gradients on the card at C54
    x = torch.rand((16, 32, 32, 3), generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    params = model.tree()
    leaves = tree_leaves(params)
    worst = 0.0
    for width in (27, 54):
        xg = x.clone().requires_grad_(True)
        reset_launch_counts()
        out = essr_forward_megakernel(params, xg, cfg, width=width)
        got = torch.autograd.grad(torch.sum(out ** 2), [xg] + leaves)
        torch.cuda.synchronize()
        mega = launch_counts()["mega"]
        want = torch.autograd.grad(torch.sum(essr_forward(params, xg, cfg, width=width) ** 2),
                                   [xg] + leaves)
        err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)
                  for a, b in zip(got, want))
        worst = max(worst, err)
        say(f"phase train mega grad C{width}: N=16 32x32, {mega} mega launch(es), the gradient "
            f"of x and {len(leaves)} weight leaves against the plain forward's, worst "
            f"normalized max_abs {err:.3e} (atol 1e-3)")
        if err > 1e-3 or mega != 1:
            fail("the megakernel's gradient disagrees with the plain forward's")
    report["mega_grad_worst"] = worst
    # two GAN steps
    _, _, ghist = train_essr_gan(model, cfg, data, 2, seed=SEED, log_every=0)
    say(f"phase train gan: 2 steps, (G, D) losses {ghist}")
    if len(ghist) != 2 or not np.all(np.isfinite(ghist)):
        fail("the GAN steps did not run")
    report["gan"] = ghist
    # a checkpoint from the card, served
    ckdir = tempfile.mkdtemp(prefix="essr_ckpt_")
    CheckpointManager(ckdir).save(steps, {"params": model.tree(), "ema": ema})
    frame = mixed_frame(SEED + 7, 270, 480)
    a = SREngine.from_checkpoint(ckdir, cfg=cfg, device=dev).upscale(frame)
    b = SREngine.from_params(params_to_numpy_tree(ema), cfg, device=dev).upscale(frame)
    same = torch.equal(a.image, b.image)
    say(f"phase train checkpoint: written from the card to {ckdir}, SREngine.from_checkpoint "
        f"torch.equal to from_params of the same EMA {same}")
    if not same:
        fail("the checkpoint's EMA serves differently from the same EMA through from_params")
    report["checkpoint_equal"] = same
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phases 27-29: the baselines, the training supervisor, the examples
# ---------------------------------------------------------------------------

def baselines_phase(essr_row, torch) -> dict:
    """27. The paper's baselines at their published widths on one synthetic
    1920x1080 LR frame (data/synthetic.py random_image), TF32 off: bicubic
    x4 to 8K, FSRCNN x4 (d 56, s 12, m 4) on its luma, pruned RLFN x4 (46
    channels, 4 RLFBs, ESA 16) and base RLFN x4 (52, 6). Each against the
    same module on the CPU in float64 on a BASELINE_CROP crop (rtol 1e-3 /
    atol 1e-3; its distance to the CPU's fp32 output, and that output's to
    fp64, are printed: random-weight RLFN's fp32 rounding reaches ~1e-3, so
    two fp32 results differ by about the sum of two), then timed at 1080p
    (CUDA events, median of BASELINE_RUNS) beside its
    MACs a frame, its bound and ESSR's fp32 frame from phase 20. These are
    library convolutions (cuDNN), as the reference's are lax convolutions
    outside any Pallas kernel: no hand-written kernel runs here. Then
    extract_patches and fuse_patches_average at 1080p -> 8K against the
    frame geometry's extract (torch.equal) and fuse_average (rtol 1e-6)."""
    import numpy as np
    from repro_torch.core import patching as P
    from repro_torch.data.synthetic import random_image
    from repro_torch.models import fsrcnn as F
    from repro_torch.models import rlfn as R
    from repro_torch.models.essr import ESSRConfig, essr_macs
    from repro_torch.models.layers import bicubic_resize, rgb_to_luma
    dev = torch.device("cuda")
    peak_flops, peak_bw = peaks_for(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    lr = torch.from_numpy(random_image(SEED, 1080, 1920))[None]
    say(f"phase baselines data: one 1920x1080 LR frame (random_image) in "
        f"{time.perf_counter() - t0:.1f} s")
    g = lambda: torch.Generator().manual_seed(SEED)
    fsrcnn = F.init_fsrcnn(F.FSRCNNConfig(), g())
    pruned, base = R.init_rlfn(R.RLFN_PRUNED_X4, g()), R.init_rlfn(R.RLFN_BASE_X4, g())
    luma = lambda x: rgb_to_luma(x)[..., None] / 255.0
    px = 1080 * 1920
    models = (
        ("bicubic", lambda x: bicubic_resize(x, (x.shape[1] * 4, x.shape[2] * 4)), None, 0),
        ("fsrcnn", lambda x: fsrcnn(luma(x)), fsrcnn, F.fsrcnn_macs_per_lr_pixel(fsrcnn.cfg) * px),
        ("rlfn_pruned", pruned, pruned, R.rlfn_macs_per_lr_pixel(pruned.cfg) * px),
        ("rlfn_base", base, base, R.rlfn_macs_per_lr_pixel(base.cfg) * px))
    crop = lr[:, :BASELINE_CROP, :BASELINE_CROP]
    rows = []
    for name, fn, module, macs in models:
        with torch.inference_mode():
            want = fn(crop)
            if module is not None:
                module.double()
            exact = fn(crop.double())
            if module is not None:
                module.float()                   # fp32 -> fp64 -> fp32 is exact
        if module is not None:
            module.to(dev)
        x = lr.to(dev)
        with torch.inference_mode():
            got = fn(crop.to(dev)).cpu()
            err = float((got.double() - exact).abs().max())
            err32 = float((got - want).abs().max())
            cpu_err = float((want.double() - exact).abs().max())
            close = torch.allclose(got.double(), exact, **CHAIN_TOL)
            out = fn(x)
            shape = tuple(out.shape)
            finite = bool(torch.isfinite(out).all())
            del out
            ms = median_ms(lambda: fn(x), torch, BASELINE_RUNS)
        nbytes = 4 * (3 * px + 16 * px * shape[-1])      # the RGB frame in, the 8K frame out
        flops = 2 * macs if macs else 2 * 8 * 16 * px * 3   # bicubic: 4 + 4 taps a pixel
        t_bytes, t_flops = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
        row = dict(name=name, route="library convs (cuDNN)" if module is not None
                   else "library (F.interpolate)", macs_per_frame=macs, ms=ms,
                   bound_ms=max(t_bytes, t_flops),
                   bound_by="bytes" if t_bytes >= t_flops else "operations",
                   max_abs_err_vs_cpu_fp64=err, max_abs_err_vs_cpu_fp32=err32,
                   cpu_fp32_max_abs_err_vs_fp64=cpu_err, out_shape=shape)
        rows.append(row)
        say(f"phase baselines {name}: {shape} from the 1080p frame, {ms:.3f} ms (median of "
            f"{BASELINE_RUNS}, CUDA events; {row['route']}, not a hand-written kernel), "
            f"{macs / 1e9:.1f} GMAC a frame, bound {row['bound_ms']:.3f} ms by "
            f"{row['bound_by']}; at {BASELINE_CROP}x{BASELINE_CROP} against the CPU in fp64 "
            f"max_abs {err:.3e} (rtol 1e-3 atol 1e-3) {'ok' if close else 'MISMATCH'}, against "
            f"the CPU in fp32 {err32:.3e}, the CPU's fp32 against its fp64 {cpu_err:.3e} "
            f"({card_line()})")
        if not (close and finite and shape[1:3] == (4320, 7680)):
            fail(f"the {name} baseline on the card disagrees with the CPU or is not finite")
        if module is not None:
            module.cpu()
        del x
        torch.cuda.empty_cache()
    essr = essr_macs(ESSRConfig(scale=4), (1080, 1920))
    say(f"phase baselines essr: ESSR C54 x4 fp32 layer frame of phase 20, host median "
        f"{essr_row['host']['median_ms']:.3f} ms, fused median "
        f"{essr_row['fused']['median_ms']:.3f} ms (routed (1152, 576, 576)); "
        f"{essr / 1e9:.1f} GMAC a frame at all-C54")
    # the patching helpers on the card, against the frame geometry's maps
    x = torch.from_numpy(mixed_frame(SEED)).to(dev)
    geom = P.get_geometry(1080, 1920, 32, 2, 4, str(dev))
    with torch.inference_mode():
        patches, pos = P.extract_patches(x)
        same = torch.equal(patches, geom.extract(x)) and np.array_equal(pos, geom.pos)
        sr = torch.rand((geom.n, 128, 128, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
        got = P.fuse_patches_average(sr, pos, 4, (4320, 7680))
        want = geom.fuse_average(sr)
        fuse_err = float((got - want).abs().max())
        close = torch.allclose(got, want, rtol=1e-6, atol=0)
        del got, want
        t_fuse = median_ms(lambda: P.fuse_patches_average(sr, pos, 4, (4320, 7680)), torch,
                           BASELINE_RUNS)
        t_geom = median_ms(lambda: geom.fuse_average(sr), torch, BASELINE_RUNS)
    say(f"phase baselines patching: extract_patches on the card torch.equal to "
        f"PatchGeometry.extract {same} ({geom.n} patches); fuse_patches_average to 8K against "
        f"fuse_average max_abs {fuse_err:.3e} (rtol 1e-6) {'ok' if close else 'MISMATCH'}; "
        f"{t_fuse:.3f} ms against {t_geom:.3f} ms")
    if not (same and close):
        fail("extract_patches / fuse_patches_average on the card disagree with the geometry's")
    del x, sr, patches
    torch.cuda.empty_cache()
    return {"card": card_line(), "models": rows, "essr_c54_macs": essr,
            "essr_fp32_layer_host_ms": essr_row["host"]["median_ms"],
            "essr_fp32_layer_fused_ms": essr_row["fused"]["median_ms"],
            "fuse_patches_average_ms": t_fuse, "fuse_average_ms": t_geom}


def supervisor_phase(torch) -> dict:
    """28. TrainSupervisor around the port's supernet step on the card, as
    phase 26 trains (C54 x4, batch 16 of 24x24, Lamb cosine 3e-3, EMA, TF32
    off): SUPERVISED_STEPS steps with a checkpoint every
    SUPERVISED_CKPT_EVERY (async writes into a temporary directory), once
    uninterrupted and once with an InjectedFailure at SUPERVISED_FAIL_AT.
    The batches and widths are drawn up front (supernet_draws), so a batch
    is a function of its step alone. The interrupted run must count one
    restart, resume at the last checkpoint and end torch.equal to the
    uninterrupted one in params, optimizer state and EMA."""
    import itertools
    import tempfile
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core import supernet
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import patch_batches
    from repro_torch.models.essr import ESSRConfig, init_essr
    from repro_torch.runtime.fault_tolerance import (InjectedFailure, SupervisorConfig,
                                                     TrainSupervisor)
    from repro_torch.train import optimizer as O
    from repro_torch.train.trainer import make_supervised_step, supernet_draws
    cfg, dev = ESSRConfig(scale=4), torch.device("cuda")
    data = patch_batches(SEED, batch=TRAIN_BATCH, lr_patch=TRAIN_PATCH, scale=cfg.scale,
                         device=dev)
    draws = list(itertools.islice(supernet_draws(data, cfg, SEED), SUPERVISED_STEPS))
    resume = SUPERVISED_FAIL_AT // SUPERVISED_CKPT_EVERY * SUPERVISED_CKPT_EVERY
    runs = {}
    for name, fail_at in (("uninterrupted", None), ("interrupted", SUPERVISED_FAIL_AT)):
        model = init_essr(cfg, torch.Generator().manual_seed(SEED)).to(dev)
        opt = O.lamb(O.cosine_decay(3e-3, SUPERVISED_STEPS))
        tree = model.tree()
        state = {"params": tree, "opt_state": opt.init(tree), "ema": supernet.ema_init(tree)}
        seen = []
        with tempfile.TemporaryDirectory(prefix=f"essr_sup_{name}_") as ckdir:
            sup = TrainSupervisor(make_supervised_step(cfg, opt), draws.__getitem__,
                                  CheckpointManager(ckdir), SupervisorConfig(
                                      ckpt_every=SUPERVISED_CKPT_EVERY))

            def hook(step, sup=sup, seen=seen, fail_at=fail_at):
                seen.append(step)
                if step == fail_at and not sup.restarts:
                    raise InjectedFailure("lost the card")

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sup.run(state, 0, SUPERVISED_STEPS, failure_hook=hook)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            kept = sup.ckpt.all_steps()
        resumed_at = seen[seen.index(fail_at) + 1] if fail_at is not None else None
        runs[name] = (out, sup, wall, resumed_at)
        say(f"phase supervisor {name}: {SUPERVISED_STEPS} steps at C54 x4, batch "
            f"{TRAIN_BATCH} of {TRAIN_PATCH}x{TRAIN_PATCH}, async checkpoints every "
            f"{SUPERVISED_CKPT_EVERY} (kept {kept}): wall "
            f"{wall:.3f} s, {len(seen)} steps run, restarts {sup.restarts}, failures "
            f"{sup.failures}, resumed at {resumed_at}")
    (a, sa, wa, _), (b, sb, wb, resumed_at) = runs["uninterrupted"], runs["interrupted"]
    leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
    equal = {k: all(torch.equal(x, y) for x, y in zip(tree_leaves(a[k]), tree_leaves(b[k])))
             for k in ("params", "opt_state", "ema")}
    say(f"phase supervisor: {len(leaves_b)} leaves, torch.equal to the uninterrupted run "
        f"{equal}; the restart cost {wb - wa:.3f} s ({wb:.3f} against {wa:.3f} s: "
        f"{SUPERVISED_FAIL_AT - resume} steps replayed, the restore) ({card_line()})")
    if not (sa.restarts == 0 and sb.restarts == 1 and resumed_at == resume
            and sb.failures == [f"step {SUPERVISED_FAIL_AT}: lost the card"]
            and len(leaves_a) == len(leaves_b) and all(equal.values())):
        fail("the supervised run with a failure did not restart once, resume at the last "
             "checkpoint and end torch.equal to the uninterrupted run")
    torch.cuda.empty_cache()
    return {"card": card_line(), "steps": SUPERVISED_STEPS, "ckpt_every": SUPERVISED_CKPT_EVERY,
            "fail_at": SUPERVISED_FAIL_AT, "resumed_at": resumed_at, "restarts": sb.restarts,
            "equal": equal, "wall_uninterrupted_s": wa, "wall_interrupted_s": wb,
            "restart_cost_s": wb - wa}


def examples_phase() -> dict:
    """29. The port's four examples as subprocesses on the card: the
    quickstart, the serving example at 4 frames of 96x96 under host and
    fused dispatch (two in flight), the training example for 20 steps into
    a temporary checkpoint directory, the dynamic-width LM example (30
    steps each variant), then the serving example from the checkpoint.
    The first five run together, the last after the training; each must
    exit 0 within EXAMPLE_TIMEOUT_S."""
    import tempfile
    ex = ROOT / "examples"
    with tempfile.TemporaryDirectory(prefix="essr_example_ckpt_") as ckdir:
        waves = ([("quickstart", ["torch_quickstart.py"]),
                  ("serve host", ["torch_serve_8k.py", "--frames", "4", "--hw", "96"]),
                  ("serve fused", ["torch_serve_8k.py", "--frames", "4", "--hw", "96",
                                   "--dispatch", "fused", "--inflight", "2"]),
                  ("train", ["torch_train_essr.py", "--steps", "20", "--ckpt-dir", ckdir]),
                  ("dynamic width lm", ["torch_dynamic_width_lm.py"])],
                 [("serve ckpt", ["torch_serve_8k.py", "--ckpt", ckdir])])
        report = {}
        for wave in waves:
            t0 = time.perf_counter()
            procs = [(name, subprocess.Popen([sys.executable, str(ex / argv[0]), *argv[1:]],
                                             cwd=str(ROOT), stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
                     for name, argv in wave]
            outs = {}
            try:
                for name, proc in procs:
                    outs[name] = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)[0]
            finally:
                for _, proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.communicate()
            wall = time.perf_counter() - t0
            for (name, argv), (_, proc) in zip(wave, procs):
                lines = outs.get(name, "").strip().splitlines()
                say(f"phase examples {name}: python3 examples/{' '.join(argv)} exit "
                    f"{proc.returncode} (this wave {wall:.1f} s); its last lines:")
                for line in lines[-4:]:
                    say(f"  {line[:200]}")
                report[name] = {"exit": proc.returncode, "last": lines[-1] if lines else ""}
                if proc.returncode != 0:
                    fail(f"the example {argv[0]} ({name}) exited {proc.returncode}")
        return report


def tree_to(tree, device):
    """A nested dict / list tree of tensors, copied to ``device`` (a copy
    also where it is there already: decode writes its caches in place)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device, copy=True)


def profile_lm(fn, wall_ms: float, label: str, torch) -> dict:
    """One call of ``fn`` under torch.profiler: device busy time against
    the unprofiled call's ``wall_ms``, the device kernels it launched and
    the five longest."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or "Activity Buffer" in e.key:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        say(f"phase lm profile {label}: the profiler recorded no device time (not measured)")
        return {}
    busy = sum(ms for ms, _, _ in rows)
    kernels = sum(c for _, c, _ in rows)
    groups = {}
    for ms, count, key in rows:
        k = key.lower()
        group = ("fp32 GEMM (the attention's scores and P.V)" if "sgemm" in k or "f32f32" in k
                 else "bf16 GEMM (cuBLAS)" if "nvjet" in k or "gemm" in k or "bf16" in k
                 else "copies and casts" if "copy" in k
                 else "elementwise, reductions, softmax, index")
        ms0, n0 = groups.get(group, (0.0, 0))
        groups[group] = (ms0 + ms, n0 + count)
    say(f"phase lm profile {label}: device busy {busy:.3f} ms of the unprofiled call's "
        f"{wall_ms:.3f} ms (idle share {max(0.0, 1 - busy / wall_ms):.3f}), {kernels} device "
        f"kernels: " + "; ".join(f"{g} {ms:.3f} ms x{n}" for g, (ms, n) in
                                 sorted(groups.items(), key=lambda kv: -kv[1][0]))
        + "; the longest:")
    for ms, count, key in sorted(rows, reverse=True)[:6]:
        say(f"  {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    return {"busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall_ms), "kernels": kernels,
            "groups": {g: list(v) for g, v in groups.items()},
            "top": [[key[:80], ms, count] for ms, count, key in sorted(rows, reverse=True)[:6]]}


def lm_macs(cfg, b: int, s: int, kv_len: int, n_full=None, causal: bool = False) -> int:
    """Multiply-adds of one granite-style forward over b x s new tokens: the
    layers' projections and FFN (under dynamic width ``n_full`` tokens a
    layer at full width, the rest at half), the attention (``causal``: query
    i over its i + 1 keys; else each query over ``kv_len`` keys), the head
    on the last token."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    t = b * s
    proj = t * (2 * d * h * hd + 2 * d * g * hd)
    ffn = t * 3 * d * f if n_full is None else \
        n_full * 3 * d * f + (t - n_full) * 3 * d * (f // 2)
    keys = s * (s + 1) // 2 if causal else s * kv_len
    attn = 2 * b * h * keys * hd
    return L * (proj + ffn + attn) + b * d * cfg.vocab_padded


def lm_needed_bytes(params, cfg, b: int, s: int, kv_read: int, kv_written: int) -> int:
    """Bytes a forward must move, each input read once: every weight but the
    embedding table (only its b x s rows), the K/V positions it reads and
    writes (bf16)."""
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    emb = params["embed"]
    kv = 2 * cfg.n_layers * b * cfg.n_kv_heads * cfg.resolved_head_dim * emb.element_size()
    return (weights - emb.numel() * emb.element_size() + b * s * cfg.d_model * emb.element_size()
            + kv * (kv_read + kv_written))


@contextlib.contextmanager
def recorded_splits(FF):
    """Inside the block, every dynamic-width FFN call's split (what
    ``FF.dynamic_width_split`` returned to it) is appended to the yielded
    list as ``{"tokens", "full", "half", "score"}``, the score detached (under
    autograd it would hold its layer's graph and saved activations)."""
    log, split = [], FF.dynamic_width_split

    def recorded(xf, capacity_frac):
        full, half, score = split(xf, capacity_frac)
        log.append({"tokens": xf.shape[0], "full": full, "half": half,
                    "score": score.detach()})
        return full, half, score

    FF.dynamic_width_split = recorded
    try:
        yield log
    finally:
        FF.dynamic_width_split = split


def check_routing(log, t_expected: int, torch, where: str) -> int:
    """Every dynamic-width call of ``log`` routed max(1, int(t / 2)) of its
    t tokens to the full width, the highest scores, every token once."""
    for rec in log:
        t = rec["tokens"]
        n_full = max(1, int(t * 0.5))
        full, half, score = rec["full"], rec["half"], rec["score"]
        every = torch.sort(torch.cat([full, half])).values
        ok = (t == t_expected and full.numel() == n_full and half.numel() == t - n_full
              and torch.equal(every, torch.arange(t, device=every.device))
              and (half.numel() == 0 or score[full].min().item() >= score[half].max().item()))
        if not ok:
            fail(f"{where}: a dynamic-width call routed {full.numel()} of {t} tokens to the full "
                 f"width (expected {n_full} of {t_expected}, the highest scores, each token once)")
    return len(log)


def decode_vs_prefill(ld, lr, torch):
    """tests/test_lm_archs.py:89-92: rtol/atol 8e-2, argmax a near-tie."""
    err = (ld - lr).abs().max().item()
    close = bool(torch.all((ld - lr).abs() <= 8e-2 + 8e-2 * lr.abs()))
    gap = (lr.max(-1).values - lr.gather(-1, ld.argmax(-1, keepdim=True))[:, 0]).max().item()
    return err, gap, close and gap <= 0.1


def lm_phase(torch) -> dict:
    """30. granite-8b at full width and depth in bf16, static and dynamic
    width (see the module docstring), then the fp32 check against the CPU.
    Returns the report and the fp32 check's CPU model."""
    import gc
    from repro_torch.configs import granite_8b
    from repro_torch.configs.base import param_count_estimate
    from repro_torch.core import pipeline as pl
    from repro_torch.models.lm import ffn as FF
    from repro_torch.models.lm import transformer as T
    pl._fused_frame_fn.cache_clear()
    pl._fused_stream_fn.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    name = torch.cuda.get_device_name(0)
    bf16_peak = next((ops for key, ops in FP16_PEAKS if key in name), FP16_PEAKS[-1][1])
    bw = peaks_for(name)[1]
    cfg = granite_8b.FULL
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = T.init_lm(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    estimate = param_count_estimate(cfg)
    weight_gb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    say(f"phase lm: granite-8b FULL bf16 on the card: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}; "
        f"{n_params:,} parameters (param_count_estimate {estimate:,}, which leaves out the "
        f"norms), {weight_gb:.3f} GB, built in {init_s:.1f} s; allocated before it "
        f"{before / 2**20:.0f} MiB (earlier phases' graphs and caches freed)")
    if n_params - estimate != (2 * cfg.n_layers + 1) * cfg.d_model:
        fail("granite-8b's parameters differ from param_count_estimate by more than its norms")
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device="cuda",
                           generator=gen)
    report = {"card": card_line(), "params": n_params, "weights_gb": weight_gb,
              "init_s": init_s}
    with torch.inference_mode():
        for label, vcfg in (("static", cfg), ("dynwidth", granite_8b.FULL_DYNWIDTH)):
            dyn = vcfg.dynamic_width
            t = LM_BATCH * LM_PROMPT
            with recorded_splits(FF) as warm_log:
                T.lm_prefill(params, vcfg, prompt, LM_MAX_LEN)
            torch.cuda.synchronize()
            times = []
            for _ in range(LM_PREFILL_RUNS):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                logits, caches = T.lm_prefill(params, vcfg, prompt, LM_MAX_LEN)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            pre_ms = statistics.median(times)
            if not torch.isfinite(logits).all():
                fail(f"lm {label}: prefill logits are not finite")
            tok = logits.argmax(-1, keepdim=True)
            toks, steps, dec_logits = [tok], [], []

            def step(tok, caches, pos):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                out, caches = T.lm_decode_step(params, vcfg, tok, caches, pos)
                b.record()
                steps.append((a, b))
                dec_logits.append(out)
                return out.argmax(-1, keepdim=True), caches

            with recorded_splits(FF) as dec_log:         # the first step's calls
                tok, caches = step(tok, caches, LM_PROMPT)
            toks.append(tok)
            for i in range(1, LM_DECODE):
                tok, caches = step(tok, caches, LM_PROMPT + i)
                toks.append(tok)
            torch.cuda.synchronize()
            dec_times = [a.elapsed_time(b) for a, b in steps]
            dec_ms = statistics.median(dec_times)
            if not all(bool(torch.isfinite(x).all()) for x in dec_logits):
                fail(f"lm {label}: decode logits are not finite")
            prof_pre = profile_lm(lambda: T.lm_prefill(params, vcfg, prompt, LM_MAX_LEN),
                                  pre_ms, f"{label} prefill", torch)
            spare = {k: v.clone() for k, v in caches.items()}
            prof_dec = profile_lm(lambda: T.lm_decode_step(params, vcfg, tok, spare,
                                                           LM_PROMPT + LM_DECODE),
                                  dec_ms, f"{label} decode step", torch)
            del spare
            peak = torch.cuda.max_memory_allocated()
            n_full = max(1, int(t * 0.5)) if dyn else None
            pre_macs = lm_macs(vcfg, LM_BATCH, LM_PROMPT, LM_PROMPT, n_full, causal=True)
            pre_bytes = lm_needed_bytes(params, vcfg, LM_BATCH, LM_PROMPT, 0, LM_PROMPT)
            # a decode step at position pos reads pos cached K/V and writes
            # one; the mean over the run's steps
            positions = range(LM_PROMPT, LM_PROMPT + LM_DECODE)
            dec_macs = statistics.mean(lm_macs(vcfg, LM_BATCH, 1, pos + 1,
                                               max(1, int(LM_BATCH * 0.5)) if dyn else None)
                                       for pos in positions)
            dec_bytes = statistics.mean(lm_needed_bytes(params, vcfg, LM_BATCH, 1, pos, 1)
                                        for pos in positions)
            # what this implementation moves beyond that: the half-width
            # slice re-reads half of every FFN weight
            reread = (cfg.n_layers * 3 * cfg.d_model * (cfg.d_ff // 2) * 2) if dyn else 0
            pre_bound = max(2 * pre_macs / bf16_peak, pre_bytes / bw) * 1e3
            dec_bound = max(2 * dec_macs / bf16_peak, dec_bytes / bw) * 1e3
            dec_impl_bound = max(2 * dec_macs / bf16_peak, (dec_bytes + reread) / bw) * 1e3
            row = {"prefill_ms": pre_ms, "prefill_runs_ms": times,
                   "prefill_tokens_per_s": t / pre_ms * 1e3,
                   "prefill_tflop": 2 * pre_macs / 1e12, "prefill_gb": pre_bytes / 1e9,
                   "prefill_bound_ms": pre_bound,
                   "decode_ms_median": dec_ms, "decode_ms_min": min(dec_times),
                   "decode_ms_max": max(dec_times), "decode_tokens_per_s": LM_BATCH / dec_ms * 1e3,
                   "decode_gflop": 2 * dec_macs / 1e9, "decode_gb": dec_bytes / 1e9,
                   "decode_bound_ms": dec_bound, "decode_reread_gb": reread / 1e9,
                   "decode_bound_with_reread_ms": dec_impl_bound,
                   "peak_mib": peak / 2**20, "profile_prefill": prof_pre,
                   "profile_decode": prof_dec}
            say(f"phase lm {label}: prefill {LM_BATCH}x{LM_PROMPT} (max_len {LM_MAX_LEN}) "
                f"{pre_ms:.3f} ms (median of {LM_PREFILL_RUNS}: "
                f"{', '.join(f'{x:.3f}' for x in times)}), {row['prefill_tokens_per_s']:,.0f} "
                f"tokens/s; bound {pre_bound:.3f} ms ({row['prefill_tflop']:.2f} TFLOP at "
                f"{bf16_peak / 1e12:g} TFLOP/s bf16, {row['prefill_gb']:.2f} GB at "
                f"{bw / 1e12:g} TB/s); decode {dec_ms:.3f} ms a step (median of {LM_DECODE}, "
                f"{min(dec_times):.3f}-{max(dec_times):.3f}), {row['decode_tokens_per_s']:,.0f} "
                f"tokens/s; bound {dec_bound:.3f} ms (a step's mean: {row['decode_gb']:.2f} GB each "
                f"input once, "
                f"{row['decode_gflop']:.1f} GFLOP)"
                + (f", {dec_impl_bound:.3f} ms with the half-width slice's re-read "
                   f"{reread / 1e9:.2f} GB" if dyn else "")
                + f"; peak allocated {peak / 2**20:,.0f} MiB")
            if dyn:
                n_pre = check_routing(warm_log, t, torch, "lm dynwidth prefill")
                n_dec = check_routing(dec_log, LM_BATCH, torch, "lm dynwidth decode")
                if (n_pre, n_dec) != (cfg.n_layers, cfg.n_layers):
                    fail(f"lm dynwidth: {n_pre} prefill / {n_dec} decode FFN calls recorded, "
                         f"expected {cfg.n_layers} each")
                row["routing"] = {"prefill_calls": n_pre, "prefill_full": n_full,
                                  "prefill_tokens": t, "decode_calls": n_dec,
                                  "decode_full": max(1, int(LM_BATCH * 0.5)),
                                  "decode_tokens": LM_BATCH}
                say(f"phase lm dynwidth routing: each of {n_pre} prefill FFN calls sent {n_full} "
                    f"of {t} tokens to the full width and each of {n_dec} decode calls "
                    f"{row['routing']['decode_full']} of {LM_BATCH}, the highest scores, every "
                    f"token once; decode is not held to prefill here: a token's rank is "
                    f"against the other tokens of the same call ({LM_BATCH} at decode, {t:,} at "
                    f"prefill)")
            else:
                seq = torch.cat([prompt] + toks, dim=1)
                checks = []
                for i in (0, LM_DECODE - 1):
                    ref, _ = T.lm_prefill(params, vcfg, seq[:, :LM_PROMPT + i + 1], LM_MAX_LEN)
                    err, gap, ok = decode_vs_prefill(dec_logits[i], ref, torch)
                    checks.append({"position": LM_PROMPT + i, "max_abs": err, "argmax_gap": gap})
                    say(f"phase lm static decode vs prefill at position {LM_PROMPT + i}: "
                        f"max_abs {err:.4e} (rtol/atol 8e-2), the decode's argmax "
                        f"{gap:.4e} below the prefill's max (<= 0.1) {'ok' if ok else 'MISMATCH'}")
                    if not ok:
                        fail("lm static: decode disagrees with a prefill of the same tokens")
                row["decode_vs_prefill"] = checks
            report[label] = row
            del logits, caches, dec_logits, warm_log, dec_log
            torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    report["fp32_check"], check_model = lm_cpu_check(torch)
    return report, check_model


def lm_cpu_check(torch):
    """30 ("lm fp32"): granite-8b FULL cut to LM_CHECK_LAYERS layers in fp32,
    the card against the CPU on the same weights, static and dynamic width.
    Returns its report and its CPU model (config, params), which phase 32's
    gradient check takes again."""
    import dataclasses
    from repro_torch.configs import granite_8b
    from repro_torch.models.lm import ffn as FF
    from repro_torch.models.lm import transformer as T
    from repro_torch.models.lm.params import ParamTree
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(granite_8b.FULL, n_layers=LM_CHECK_LAYERS)
    cpu = T.init_lm(cfg, generator=gen, device="cpu", dtype=torch.float32)
    gpu = ParamTree(tree_to(cpu.tree(), "cuda"))
    prompt = torch.randint(0, cfg.vocab_size, (1, LM_CHECK_PROMPT), generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (1, LM_CHECK_STEPS), generator=gen)
    max_len = LM_CHECK_PROMPT + LM_CHECK_STEPS
    report = {"layers": LM_CHECK_LAYERS, "prompt": LM_CHECK_PROMPT, "steps": LM_CHECK_STEPS}
    with torch.inference_mode():
        for label, vcfg in (("static", cfg), ("dynwidth", dataclasses.replace(
                granite_8b.FULL_DYNWIDTH, n_layers=LM_CHECK_LAYERS))):
            runs = {}
            for dev, params in (("cpu", cpu), ("cuda", gpu)):
                with recorded_splits(FF) as log:
                    lg, caches = T.lm_prefill(params, vcfg, prompt.to(dev), max_len)
                    out = [lg]
                    for i in range(LM_CHECK_STEPS):
                        lg, caches = T.lm_decode_step(params, vcfg, nxt[:, i:i + 1].to(dev),
                                                      caches, LM_CHECK_PROMPT + i)
                        out.append(lg)
                runs[dev] = ([x.cpu() for x in out], log, caches)
            errs = [(g - c).abs().max().item() for c, g in zip(runs["cpu"][0], runs["cuda"][0])]
            ok = all(torch.allclose(g, c, rtol=1e-3, atol=1e-3)
                     for c, g in zip(runs["cpu"][0], runs["cuda"][0]))
            kv = max((runs["cuda"][2][k].cpu() - runs["cpu"][2][k]).abs().max().item()
                     for k in ("k", "v"))
            moved, near = 0, 0.0
            for rc, rg in zip(runs["cpu"][1], runs["cuda"][1]):
                fc, fg = set(rc["full"].tolist()), set(rg["full"].cpu().tolist())
                if fc == fg:
                    continue
                score = rc["score"]
                cut = score[rc["full"]].min().item()
                for tk in fc ^ fg:
                    moved += 1
                    near = max(near, abs(score[tk].item() - cut) / abs(cut))
            route_ok = moved == 0 or near <= 1e-4
            report[label] = {"max_abs": errs, "kv_max_abs": kv, "moved_ids": moved,
                             "moved_max_rel_from_cut": near}
            say(f"phase lm fp32 {label}: granite-8b FULL cut to {LM_CHECK_LAYERS} layers, fp32, "
                f"prefill 1x{LM_CHECK_PROMPT} and {LM_CHECK_STEPS} decode steps, card vs CPU "
                f"logits max_abs {', '.join(f'{e:.3e}' for e in errs)} (rtol/atol 1e-3), caches "
                f"{kv:.3e} {'ok' if ok else 'MISMATCH'}"
                + (f"; routing ids differing on {moved} tokens (each within "
                   f"{near:.2e} of the cut, float noise <= 1e-4) {'ok' if route_ok else 'MOVED'}"
                   if vcfg.dynamic_width else ""))
            if not (ok and route_ok):
                fail(f"lm fp32 {label}: the card disagrees with the CPU")
    report["seconds"] = time.perf_counter() - t0
    return report, (cfg, cpu)


def lm_archs_phase(torch) -> dict:
    """31. Every architecture's SMOKE config on the card against the CPU."""
    from repro_torch.configs.registry import ARCH_NAMES, get_config
    from repro_torch.models.lm import encdec as E
    from repro_torch.models.lm import transformer as T
    from repro_torch.models.lm.params import ParamTree
    b, s, ml = LM_ARCH_B, LM_ARCH_S, LM_ARCH_ML
    report = {}
    for arch in ARCH_NAMES:
        cfg = get_config(arch, smoke=True)
        gen = torch.Generator().manual_seed(SEED)
        init = E.init_encdec if cfg.is_encoder_decoder else T.init_lm
        cpu = init(cfg, generator=gen, device="cpu", dtype=torch.float32)
        gpu = ParamTree(tree_to(cpu.tree(), "cuda"))
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen)
        src = torch.randn((b, s, cfg.d_model), generator=gen)
        pe = (torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
              if cfg.frontend == "vision" else None)
        off = 0 if pe is None else pe.shape[1]
        runs = {}
        with torch.inference_mode():
            for dev, params in (("cpu", cpu), ("cuda", gpu)):
                t = toks.to(dev)
                if cfg.is_encoder_decoder:
                    lp, caches = E.encdec_prefill(params, cfg, src.to(dev), t[:, :s], ml)
                    pre = tree_to(caches, "cpu")
                    ld, caches = E.encdec_decode_step(params, cfg, t[:, s:], caches, s)
                else:
                    lp, caches = T.lm_prefill(params, cfg, t[:, :s], ml + off,
                                              None if pe is None else pe.to(dev))
                    pre = tree_to(caches, "cpu")
                    ld, caches = T.lm_decode_step(params, cfg, t[:, s:], caches, s + off)
                runs[dev] = (lp.cpu(), pre, ld.cpu(), tree_to(caches, "cpu"))

        def leaves(tree, path=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    yield from leaves(v, f"{path}.{k}" if path else k)
            else:
                yield path, tree

        errs, ok = {}, True
        for what, i in (("prefill", 0), ("prefill caches", 1), ("decode", 2),
                        ("decode caches", 3)):
            c, g = dict(leaves(runs["cpu"][i])), dict(leaves(runs["cuda"][i]))
            errs[what] = max((g[k] - c[k]).abs().max().item() for k in c)
            ok = ok and set(c) == set(g) and all(
                torch.allclose(g[k], c[k], rtol=1e-3, atol=1e-3) for k in c)
        ok = ok and all(bool(torch.isfinite(runs["cuda"][i]).all()) for i in (0, 2))
        report[arch] = errs
        say(f"phase lm-archs {arch} ({cfg.family}): card vs CPU, fp32 SMOKE, B {b} S {s} "
            f"max_len {ml + off}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (rtol/atol 1e-3) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"lm-archs {arch}: the card disagrees with the CPU")
    return report


def lm_train_phase(check_model, torch) -> dict:
    """32. granite-8b trained at full width (see the module docstring):
    LM_TRAIN_LAYERS layers, bf16, static and FULL_DYNWIDTH from the same
    seeded weights; then the fp32 gradient check on phase 30b's CPU model
    ("lm train fp32") and one step of every SMOKE config ("lm-archs
    train")."""
    import dataclasses
    import gc
    from repro_torch.configs import granite_8b
    from repro_torch.configs.base import ShapeSpec, active_param_count_estimate
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import costmodel as C
    from repro_torch.launch import roofline as R
    from repro_torch.launch import steps as ST
    from repro_torch.models.lm import ffn as FF
    from repro_torch.models.lm import transformer as T
    from repro_torch.train import optimizer as O
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(granite_8b.FULL, n_layers=LM_TRAIN_LAYERS)
    shape = ShapeSpec("train", LM_TRAIN_SEQ, 1, "train")
    opt = O.chain_clip(O.adam(LM_TRAIN_LR), 1.0)
    abstract = ST.abstract_train_state(cfg, opt)
    n_params = sum(t.numel() for t in tree_leaves(abstract["params"]))
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(abstract))
    predicted = n_params * LM_TRAIN_PEAK_BYTES_PER_PARAM
    cost = C.cell_cost(cfg, shape, 1)
    mflops = R.model_flops(cfg, shape, active_param_count_estimate(cfg))
    terms = R.roofline(cost.flops_global, cost.hbm_bytes_global, 0.0, 1, mflops)
    bound_ms = max(terms.compute_s, terms.memory_s) * 1e3
    say(f"phase lm train: granite-8b FULL at full width (d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_padded}), reduced: depth {LM_TRAIN_LAYERS} of {granite_8b.FULL.n_layers} "
        f"layers, because the whole model's train state does not fit one card under the "
        f"functional Adam ({granite_8b.FULL.n_layers} layers: ~8.25 B params x 12 B of bf16 "
        f"weights and fp32 moments = 99 GB before the update's transients; sharding it is ROADMAP "
        f"item 16c); {n_params:,} parameters; abstract_train_state on the meta device "
        f"{state_bytes / 1e9:.3f} GB, predicted peak at the update {predicted / 1e9:.3f} GB "
        f"({LM_TRAIN_PEAK_BYTES_PER_PARAM} B a parameter); batch 1 x {LM_TRAIN_SEQ} "
        f"(train_4k's sequence), bf16, remat, chain_clip(adam({LM_TRAIN_LR:g}), 1.0) with fp32 "
        f"moments; cell_cost {cost.flops_global / 1e12:.3f} TFLOP and "
        f"{cost.hbm_bytes_global / 1e9:.3f} GB, bound {bound_ms:.3f} ms by {terms.dominant} at "
        f"{R.PEAK_FLOPS / 1e12:g} TFLOP/s and {R.HBM_BW / 1e12:g} TB/s (the cost model counts "
        f"the full-width FFN under dynamic width too); model FLOPs {mflops / 1e12:.3f} TFLOP; "
        f"{held / 2 ** 20:,.0f} MiB held before it")
    report = {"card": card_line(), "layers": LM_TRAIN_LAYERS, "seq": LM_TRAIN_SEQ,
              "params": n_params, "abstract_state_gb": state_bytes / 1e9,
              "predicted_peak_gb": predicted / 1e9, "cell_cost": cost.as_dict(),
              "roofline": terms.as_dict(), "bound_ms": bound_ms, "model_flops": mflops,
              "held_mib": held / 2 ** 20}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    seq = torch.randint(0, cfg.vocab_size, (1, LM_TRAIN_SEQ + 1), device="cuda", generator=gen)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    first_weights = None
    for label, vcfg in (("static", cfg), ("dynwidth", dataclasses.replace(
            granite_8b.FULL_DYNWIDTH, n_layers=LM_TRAIN_LAYERS))):
        params = T.init_lm(vcfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
                           device="cuda")
        fingerprint = float(params["embed"].float().sum()) + float(
            params["layers"][-1]["mlp"]["w_out"].float().sum())
        first_weights = fingerprint if first_weights is None else first_weights
        if fingerprint != first_weights:
            fail("lm train: the two variants do not start from the same weights")
        state = {"params": params, "opt": opt.init(params.tree())}
        step = ST.make_train_step(vcfg, opt, remat=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        with recorded_splits(FF) as log:
            for _ in range(LM_TRAIN_WARMUP):
                state, m = step(state, batch)
                losses.append(m["loss"])
            torch.cuda.synchronize()
        n_calls = check_routing(log, LM_TRAIN_SEQ, torch, f"lm train {label}") if \
            vcfg.dynamic_width else 0
        del log
        events = []
        for _ in range(LM_TRAIN_STEPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            state, m = step(state, batch)
            b.record()
            events.append((a, b))
            losses.append(m["loss"])
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in events]
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x) for x in losses]
        timed = losses[LM_TRAIN_WARMUP:]

        def one_step():
            nonlocal state
            state, _ = step(state, batch)

        prof = profile_lm(one_step, ms, f"train {label} step", torch)
        row = {"step_ms": ms, "step_runs_ms": times, "tokens_per_s": LM_TRAIN_SEQ / ms * 1e3,
               "bound_ms": bound_ms, "x_bound": ms / bound_ms,
               "model_flops_share": mflops / (ms / 1e3) / R.PEAK_FLOPS,
               "peak_mib": peak / 2 ** 20, "peak_above_held_mib": (peak - held) / 2 ** 20,
               "losses": losses, "profile": prof}
        say(f"phase lm train {label}: step {ms:.3f} ms (median of {LM_TRAIN_STEPS} after "
            f"{LM_TRAIN_WARMUP} warm-up, {min(times):.3f}-{max(times):.3f}), "
            f"{row['tokens_per_s']:,.0f} tokens/s; {row['x_bound']:.2f}x the {bound_ms:.3f} ms "
            f"bound; model FLOPs at {row['model_flops_share']:.4f} of the bf16 peak; peak "
            f"allocated {peak / 2 ** 20:,.0f} MiB ({(peak - held) / 2 ** 20:,.0f} above the held, "
            f"predicted {predicted / 2 ** 20:,.0f} + activations); loss "
            + " ".join(f"{x:.4f}" for x in losses))
        if not all(math.isfinite(x) for x in losses) or not timed[-1] < timed[0]:
            fail(f"lm train {label}: the loss is not finite or did not fall over the timed steps")
        if vcfg.dynamic_width:
            if n_calls != 2 * LM_TRAIN_LAYERS * LM_TRAIN_WARMUP:
                fail(f"lm train dynwidth: {n_calls} FFN calls recorded over {LM_TRAIN_WARMUP} "
                     f"steps, expected {2 * LM_TRAIN_LAYERS} a step (forward and recompute)")
            row["routing"] = {"calls": n_calls, "tokens": LM_TRAIN_SEQ,
                              "full": max(1, int(LM_TRAIN_SEQ * 0.5))}
            say(f"phase lm train dynwidth routing: each of {n_calls} FFN calls of the "
                f"{LM_TRAIN_WARMUP} warm-up steps (forward and remat recompute) sent "
                f"{row['routing']['full']} of {LM_TRAIN_SEQ} tokens to the full width, the "
                f"highest scores, every token once")
        report[label] = row
        del state, params, step, m, one_step
        gc.collect()
        torch.cuda.empty_cache()
    report["dynwidth_over_static"] = report["dynwidth"]["step_ms"] / report["static"]["step_ms"]
    report["fp32_check"] = lm_train_cpu_check(check_model, torch)
    report["archs"] = lm_archs_train(torch)
    return report


def _max_rel(got, want) -> float:
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def lm_train_cpu_check(check_model, torch) -> dict:
    """32 ("lm train fp32"): phase 30b's CPU model (granite-8b FULL cut to
    LM_CHECK_LAYERS layers, fp32) and a copy on the card, the loss and every
    gradient leaf on 1 x LM_CHECK_PROMPT tokens (labels the next tokens),
    the card within rtol 1e-3 / atol 1e-3 x the leaf's largest of the
    CPU's."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps as ST
    from repro_torch.train.trainer import value_and_grad
    cfg, cpu = check_model
    t0 = time.perf_counter()
    seq = torch.randint(0, cfg.vocab_size, (1, LM_CHECK_PROMPT + 1),
                        generator=torch.Generator().manual_seed(SEED + 33))
    loss_fn = ST.make_loss_fn(cfg, remat=True)
    runs = {}
    for dev in ("cpu", "cuda"):
        tree = tree_to(cpu.tree(), dev) if dev == "cuda" else cpu.tree()
        s = seq.to(dev)
        loss, grads = value_and_grad(loss_fn, tree, {"tokens": s[:, :-1], "labels": s[:, 1:]})
        runs[dev] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)])
        del tree, grads
    (lc, gc_), (lg, gg) = runs["cpu"], runs["cuda"]
    ok = bool(torch.allclose(lg, lc, rtol=1e-3, atol=1e-3)) and all(
        torch.allclose(g, c, rtol=1e-3, atol=1e-3 * max(c.abs().max().item(), 1e-30))
        for g, c in zip(gg, gc_))
    worst = max(_max_rel(g, c) for g, c in zip(gg, gc_))
    say(f"phase lm train fp32: granite-8b FULL cut to {LM_CHECK_LAYERS} layers, fp32, TF32 off, "
        f"1 x {LM_CHECK_PROMPT} tokens: loss card {lg.item():.6f} CPU {lc.item():.6f}; "
        f"{len(gc_)} gradient leaves, worst max_abs / the leaf's largest {worst:.3e} (rtol 1e-3, "
        f"atol 1e-3 x the leaf's largest) {'ok' if ok else 'MISMATCH'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not ok:
        fail("lm train fp32: the card's gradients disagree with the CPU's")
    return {"loss_card": lg.item(), "loss_cpu": lc.item(), "leaves": len(gc_),
            "worst_rel": worst, "seconds": time.perf_counter() - t0}


def lm_archs_train(torch) -> dict:
    """32 ("lm-archs train"): every architecture's SMOKE config in fp32 from
    one CPU init, one make_train_step step of chain_clip(adam(1e-2), 1.0)
    on the card and on the CPU (LM_ARCH_B x LM_ARCH_S tokens, labels the
    next tokens): the loss, every parameter leaf after the step and the
    moments within rtol/atol 1e-3 (the moments' atol x the leaf's largest).
    Adam's first step is g / (|g| + eps) an entry, so where the CPU's
    gradient is within float noise of zero (its first moment below 1e-5 of
    the leaf's largest) the sign is not determined: there the step is held
    to its size, |delta| <= lr."""
    from repro_torch.configs.registry import ARCH_NAMES, get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps as ST
    from repro_torch.models.lm import encdec as E
    from repro_torch.models.lm import transformer as T
    from repro_torch.train import optimizer as O
    b, s, lr = LM_ARCH_B, LM_ARCH_S, 1e-2
    report = {}
    for arch in ARCH_NAMES:
        cfg = get_config(arch, smoke=True)
        gen = torch.Generator().manual_seed(SEED)
        init = E.init_encdec if cfg.is_encoder_decoder else T.init_lm
        start = init(cfg, generator=gen, device="cpu", dtype=torch.float32).tree()
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.is_encoder_decoder:
            batch["src_embeds"] = torch.randn((b, s, cfg.d_model), generator=gen)
        if cfg.frontend == "vision":
            batch["embeds"] = torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
        runs = {}
        for dev in ("cpu", "cuda"):
            opt = O.chain_clip(O.adam(lr), 1.0)
            tree = tree_to(start, dev)
            state, m = ST.make_train_step(cfg, opt, remat=True)(
                {"params": tree, "opt": opt.init(tree)}, {k: v.to(dev) for k, v in batch.items()})
            runs[dev] = (m["loss"].cpu(), [t.detach().cpu() for t in tree_leaves(state["params"])],
                         [t.cpu() for t in tree_leaves(state["opt"]["m"])],
                         [t.cpu() for t in tree_leaves(state["opt"]["v"])])
        (lc, pc, mc, vc), (lg, pg, mg, vg) = runs["cpu"], runs["cuda"]
        p0 = tree_leaves(start)
        ok = bool(torch.isfinite(lg)) and bool(torch.allclose(lg, lc, rtol=1e-3, atol=1e-3))
        worst_p = 0.0
        for before, g, c, mom in zip(p0, pg, pc, mc):
            noise = mom.abs() < 1e-5 * max(mom.abs().max().item(), 1e-30)
            ok = ok and bool(torch.allclose(g[~noise], c[~noise], rtol=1e-3, atol=1e-3)) and \
                bool(((g - before).abs()[noise] <= lr * (1 + 1e-3)).all())
            worst_p = max(worst_p, (g - c)[~noise].abs().max().item() if (~noise).any() else 0.0)
        worst_m = max(_max_rel(g, c) for g, c in zip(mg + vg, mc + vc))
        ok = ok and all(torch.allclose(g, c, rtol=1e-3, atol=1e-3 * max(c.abs().max().item(),
                                                                            1e-30))
                        for g, c in zip(mg + vg, mc + vc))
        report[arch] = {"loss_card": lg.item(), "loss_cpu": lc.item(),
                        "params_max_abs": worst_p, "moments_worst_rel": worst_m}
        say(f"phase lm-archs train {arch} ({cfg.family}): one step card vs CPU, fp32 SMOKE, "
            f"B {b} S {s}: loss {lg.item():.6f} / {lc.item():.6f}, params after the step max_abs "
            f"{worst_p:.3e}, moments worst max_abs / the leaf's largest {worst_m:.3e} "
            f"(rtol/atol 1e-3) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"lm-archs train {arch}: the card's step disagrees with the CPU's")
    return report


def params_to_numpy_tree(tree):
    """A param tree of tensors as numpy leaves (the form from_params takes)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# 33. the dry run
# ---------------------------------------------------------------------------

#: (arch, shapes, mesh) of phase 33a, each one `launch/dryrun.py` process
DRYRUN_CELLS = (("granite-8b", "train_4k,prefill_32k,decode_32k", "single"),
                ("granite-8b", "train_4k,prefill_32k,decode_32k", "multi"),
                ("essr-x4", "serve_8k", "single"))
#: item 16d's four cards: one sequence, so no data axis to split; the model
#: axis carries tensor and sequence parallelism (phase 33c)
DRYRUN_16D_MESH = ((1, 4), ("data", "model"))
DRYRUN_TIMEOUT_S = 400
KNOB_SEQ = 4096
DRYPROCS = []


def start_dryrun(out_dir: Path) -> None:
    """Phase 33's cells as CPU processes (no card: CUDA_VISIBLE_DEVICES is
    empty), started once the card's phases are done, so that they share the
    host with none of them; `stop_dryrun` ends any still running."""
    import atexit
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    cmds = [(f"{a} {m}", [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                          "--shape", s, "--mesh", m, "--force", "--out-dir", str(out_dir)])
            for a, s, m in DRYRUN_CELLS]
    cmds += [(name, [sys.executable, str(Path(__file__).resolve()), "--dryrun-cell", name,
                     str(out_dir)]) for name in ("rank", "16d")]
    for name, cmd in cmds:
        log = open(out_dir / f"{name.replace(' ', '_')}.log", "w")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        DRYPROCS.append((name, proc, time.perf_counter(), log))
    atexit.register(stop_dryrun)


def stop_dryrun() -> None:
    for _, proc, _, log in DRYPROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def dryrun_cell(name: str, out_dir: str) -> int:
    """A process of phase 33: granite-8b's one-rank cell of phase 32's own
    configuration ("rank": LM_TRAIN_LAYERS layers, 1 x LM_TRAIN_SEQ, on a
    1 x 1 mesh) or item 16d's ("16d": all layers on DRYRUN_16D_MESH)."""
    import dataclasses
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import granite_8b
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import run_cell
    shape = ShapeSpec(f"train_1x{LM_TRAIN_SEQ}", LM_TRAIN_SEQ, 1, "train")
    if name == "rank":
        cfg = dataclasses.replace(granite_8b.FULL, n_layers=LM_TRAIN_LAYERS)
        mesh = ((1, 1), ("data", "model"))
    else:
        cfg, mesh = granite_8b.FULL, DRYRUN_16D_MESH
    rec = run_cell("granite-8b", shape.name, name, cfg=cfg, shape=shape, mesh_shape=mesh,
                   out_dir=out_dir, force=True)
    print(json.dumps({k: rec.get(k) for k in ("status", "error", "total_s")}), flush=True)
    return 0 if rec["status"] == "ok" else 1


def wait_dryrun(out_dir: Path) -> float:
    """Wait for phase 33's processes (DRYRUN_TIMEOUT_S from their start);
    -> seconds until the last ended. A process that failed or timed out
    fails the run."""
    for name, proc, t0, log in DRYPROCS:
        left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0))
        try:
            rc = proc.wait(timeout=left)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"dryrun {name}: not done in {DRYRUN_TIMEOUT_S} s")
        log.flush()
        tail = (out_dir / f"{name.replace(' ', '_')}.log").read_text().splitlines()[-6:]
        for line in tail:
            if line.startswith("["):
                say(f"  {line}")
        if rc != 0:
            fail(f"dryrun {name}: exit {rc}: " + " | ".join(tail)[-1500:])
    return time.perf_counter() - min(t0 for _, _, t0, _ in DRYPROCS)


def _gb(x: float) -> str:
    return f"{x / 2 ** 30:.3f} GiB"


def say_cell(label: str, rec: dict) -> dict:
    """Print one dry-run record: one rank's memory, FLOPs, collectives by
    kind and axis, the roofline terms and the dominant one."""
    if rec.get("status") != "ok":
        fail(f"dryrun {label}: status {rec.get('status')}: {rec.get('error', rec.get('reason'))}")
    mem, r = rec["memory_per_device"], rec["roofline"]
    coll = {k: v for k, v in rec["collectives_per_device_bytes"].items() if v}
    say(f"phase dryrun {label}: {rec['n_chips']} ranks {rec['mesh_shape']}, lowered in "
        f"{rec['lower_s']:.1f} s ({rec['total_s']:.1f} s the cell); one rank: arguments {_gb(mem['argument_bytes'])}, temporaries "
        f"{_gb(mem['temp_bytes'])} (peak), total {mem['total_gb']:.3f} GiB; matmul FLOPs "
        f"{rec['measured_dot_flops_per_device']:.4g}; collectives {json.dumps(coll)} by axis "
        f"{json.dumps(rec['collectives_by_axis'])} (links {json.dumps(rec['axis_link_bw'])} B/s); "
        f"roofline compute {r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} ms, "
        f"collective {r['collective_s'] * 1e3:.3f} ms: {r['dominant']} (predictions on the "
        f"H100 constants of launch/roofline.py, not measurements)")
    return {"ranks": rec["n_chips"], "mesh": rec["mesh_shape"], "lower_s": rec["lower_s"],
            "total_s": rec["total_s"], "memory": mem, "flops": rec["measured_dot_flops_per_device"],
            "collectives": rec["collectives_per_device_bytes"],
            "collectives_by_axis": rec["collectives_by_axis"], "roofline": r,
            "top_collectives": rec["top_collectives"][:4]}


def dryrun_phase(out_dir: Path, lm_train_report: dict, torch) -> dict:
    """33. the dry run (see the module docstring)."""
    import dataclasses
    import gc
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import granite_8b
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps as ST
    from repro_torch.models.lm import transformer as T
    # (b)'s real step and (d) on the card first; then the CPU processes,
    # with the card idle and the host to themselves
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(granite_8b.FULL, n_layers=LM_TRAIN_LAYERS)
    opt = ST.make_optimizer()
    params = T.init_lm(cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
                       device="cuda")
    state = {"params": params, "opt": opt.init(params.tree())}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    seq = torch.randint(0, cfg.vocab_size, (1, LM_TRAIN_SEQ + 1), device="cuda", generator=gen)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    real_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves((params.tree(), state["opt"], batch)))
    step = ST.make_train_step(cfg, opt, remat=True)
    with FlopCounterMode(display=False) as fc:
        state, m = step(state, batch)
        torch.cuda.synchronize()
    real_flops = fc.get_total_flops()
    loss = float(m["loss"])
    del state, params, step, m, batch, seq
    gc.collect()
    torch.cuda.empty_cache()
    knobs = knob_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    start_dryrun(out_dir)
    wall = wait_dryrun(out_dir)
    load = lambda mesh, arch, shape: json.loads(  # noqa: E731
        (out_dir / mesh / f"{arch}__{shape}.json").read_text())
    shape_name = f"train_1x{LM_TRAIN_SEQ}"
    recs = {f"{mesh} {arch} {shape}": load(mesh, arch, shape)
            for arch, shapes, mesh in DRYRUN_CELLS for shape in shapes.split(",")}
    recs.update({name: load(name, "granite-8b", shape_name) for name in ("rank", "16d")})
    secs = {k: r.get("total_s") for k, r in recs.items()}
    say(f"phase dryrun: {len(DRYPROCS)} CPU processes, no card, started after the card's "
        f"phases, all done in {wall:.1f} s; each cell's own seconds: "
        + ", ".join(f"{k} {v} s" for k, v in secs.items()))
    try:
        from torch.distributed._tools.mem_tracker import MemTracker  # noqa: F401
        mem_tracker = True
    except ImportError:
        mem_tracker = False
    say(f"phase dryrun: torch {torch.__version__} here; torch.distributed._tools.mem_tracker."
        f"MemTracker importable: {mem_tracker} (the dry run tracks its own storages, "
        f"launch/counters.py)")
    report = {"card": card_line(), "seconds": secs, "wall_s": wall, "mem_tracker": mem_tracker,
              "cells": {}}
    # (a) the production meshes
    for arch, shapes, mesh in DRYRUN_CELLS:
        for shape in shapes.split(","):
            report["cells"][f"{mesh} {arch} {shape}"] = say_cell(
                f"{mesh} {arch} {shape}", recs[f"{mesh} {arch} {shape}"])
    # (b) the one-rank cell against the real step of phase 32's configuration
    rec = recs["rank"]
    rank = say_cell(f"rank granite-8b {LM_TRAIN_LAYERS} layers 1x{LM_TRAIN_SEQ}", rec)
    static = lm_train_report["static"]
    pred_bytes = rec["memory_per_device"]["argument_bytes"] + rec["memory_per_device"]["temp_bytes"]
    found_bytes = static["peak_above_held_mib"] * 2 ** 20
    bound_ms = max(rec["roofline"][k] for k in ("compute_s", "memory_s", "collective_s")) * 1e3
    flop_ratio = rec["measured_dot_flops_per_device"] / real_flops
    rank.update(real_flops=real_flops, flop_ratio=flop_ratio, real_argument_bytes=real_bytes,
                loss=loss, predicted_peak_bytes=pred_bytes, found_peak_bytes=found_bytes,
                peak_ratio=pred_bytes / found_bytes, bound_ms=bound_ms,
                found_step_ms=static["step_ms"], step_over_bound=static["step_ms"] / bound_ms)
    say(f"phase dryrun rank vs card: FLOPs dry run {rec['measured_dot_flops_per_device']:.6g}, "
        f"FlopCounterMode around a real step on the card {real_flops:.6g} (ratio "
        f"{flop_ratio:.6f}, within 1%: {abs(flop_ratio - 1) <= 0.01}); argument bytes dry run "
        f"{rec['memory_per_device']['argument_bytes']:,}, the real state and batch "
        f"{real_bytes:,} (equal: {rec['memory_per_device']['argument_bytes'] == real_bytes}); "
        f"predicted peak {_gb(pred_bytes)} against phase 32's {_gb(found_bytes)} above the held "
        f"(max_memory_allocated; ratio {pred_bytes / found_bytes:.3f}); roofline bound "
        f"{bound_ms:.3f} ms against phase 32's median step {static['step_ms']:.3f} ms (the step "
        f"is {static['step_ms'] / bound_ms:.2f}x the bound); loss {loss:.4f}")
    if abs(flop_ratio - 1) > 0.01:
        fail(f"dryrun rank: FLOPs {rec['measured_dot_flops_per_device']} against the card's "
             f"{real_flops} (ratio {flop_ratio})")
    if rec["memory_per_device"]["argument_bytes"] != real_bytes:
        fail(f"dryrun rank: argument bytes {rec['memory_per_device']['argument_bytes']} against "
             f"the real state's {real_bytes}")
    report["rank"] = rank
    # (c) item 16d's cell: each of the four ranks holds the same shard sizes
    d16 = say_cell(f"16d granite-8b all {granite_8b.FULL.n_layers} layers 1x{LM_TRAIN_SEQ}",
                   recs["16d"])
    for row in d16["top_collectives"]:
        say(f"  16d top collective: {row['op']} over {row['axis']}, {row['bytes'] / 2 ** 20:.1f} "
            f"MiB in {row['trips']} calls of {row['shape']} at {row['op_name']}")
    report["16d"] = d16
    # (d) the knobs at full width on the card (run above)
    report["knobs"] = knobs
    return report


def _timed(fn, torch):
    """(result, ms by CUDA events, peak allocated bytes above the start)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b), torch.cuda.max_memory_allocated() - base


def knob_phase(torch) -> dict:
    """33d: the dry run's three model knobs at full width on the card."""
    import dataclasses
    import gc
    from repro_torch.configs import deepseek_v3_671b, zamba2_1_2b
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as ST
    from repro_torch.models.lm import attention as A
    from repro_torch.models.lm import ffn as FF
    from repro_torch.models.lm import transformer as T
    from repro_torch.train import optimizer as O
    out = {}
    # Mamba-2: the SSD form against the scan form, zamba2-1.2b FULL, bf16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    tokens = torch.randint(0, zamba2_1_2b.FULL.vocab_size, (1, KNOB_SEQ + 1), device="cuda",
                           generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    logits = {}
    for impl in ("scan", "ssd"):
        cfg = dataclasses.replace(zamba2_1_2b.FULL, mamba2_impl=impl)
        params = T.init_lm(cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
                           device="cuda")
        prefill = ST.make_prefill_step(cfg, ShapeSpec("p", KNOB_SEQ, 1, "prefill"))
        ST.make_prefill_step(cfg, ShapeSpec("w", 256, 1, "prefill"))(
            params, {"tokens": batch["tokens"][:, :256]})             # warm-up
        (lg, _), pre_ms, pre_peak = _timed(lambda: prefill(params, {"tokens": batch["tokens"]}),
                                           torch)
        logits[impl] = lg.float()
        opt = O.chain_clip(O.adam(1e-3), 1.0)
        state = {"params": params, "opt": opt.init(params.tree())}
        step = ST.make_train_step(cfg, opt, remat=True)
        (state, m), tr_ms, tr_peak = _timed(lambda: step(state, batch), torch)
        out[f"zamba2 {impl}"] = {"prefill_ms": pre_ms, "prefill_peak_mib": pre_peak / 2 ** 20,
                                 "train_step_ms": tr_ms, "train_peak_mib": tr_peak / 2 ** 20,
                                 "loss": float(m["loss"])}
        say(f"phase knobs zamba2-1.2b FULL mamba2_impl={impl}: bf16 prefill 1x{KNOB_SEQ} "
            f"{pre_ms:.1f} ms (peak {pre_peak / 2 ** 20:,.0f} MiB above the start), one train "
            f"step {tr_ms:.1f} ms (peak {tr_peak / 2 ** 20:,.0f} MiB), loss {float(m['loss']):.4f}")
        del params, state, step, m, lg
        gc.collect()
        torch.cuda.empty_cache()
    diff = (logits["ssd"] - logits["scan"]).abs().max().item()
    within = torch.allclose(logits["ssd"], logits["scan"], rtol=8e-2, atol=8e-2)
    # the same prefill in fp32: the two forms are one function, summed in
    # another order; in bf16 each of the 38 layers rounds its output, and
    # the forms' last-bit differences grow through the stack
    for impl in ("scan", "ssd"):
        cfg = dataclasses.replace(zamba2_1_2b.FULL, mamba2_impl=impl)
        params = T.init_lm(cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
                           device="cuda", dtype=torch.float32)
        prefill = ST.make_prefill_step(cfg, ShapeSpec("p", KNOB_SEQ, 1, "prefill"))
        logits[f"{impl} fp32"] = prefill(params, {"tokens": batch["tokens"]})[0].float()
        del params
        gc.collect()
        torch.cuda.empty_cache()
    diff32 = (logits["ssd fp32"] - logits["scan fp32"]).abs().max().item()
    ok = torch.allclose(logits["ssd fp32"], logits["scan fp32"], rtol=1e-3, atol=1e-3)
    # each form's bf16 logits against its own fp32 logits: the rounding that
    # 38 bf16 layers add, beside which the bf16 gap between the forms stands
    rounding = {impl: (logits[impl] - logits[f"{impl} fp32"]).abs().max().item()
                for impl in ("scan", "ssd")}
    out["zamba2 ssd vs scan logits max abs diff"] = {
        "bf16": diff, "fp32": diff32, "bf16_within_8e-2": within,
        "bf16_vs_fp32": rounding}
    say(f"phase knobs zamba2 ssd vs scan: prefill logits, max abs diff {diff:.4g} in bf16 "
        f"(within rtol/atol 8e-2: {within}; reported, not gated) and {diff32:.4g} in fp32 "
        f"(within rtol/atol 1e-3: {ok}); each form's bf16 logits against its own fp32 logits: "
        f"scan {rounding['scan']:.4g}, ssd {rounding['ssd']:.4g} (the bf16 gap between the "
        f"forms is {diff / max(rounding.values()):.3f}x the larger); ssd "
        f"{out['zamba2 ssd']['prefill_ms'] / out['zamba2 scan']['prefill_ms']:.3f}x the scan's "
        f"bf16 prefill, {out['zamba2 ssd']['train_step_ms'] / out['zamba2 scan']['train_step_ms']:.3f}"
        f"x its train step")
    if not ok:
        fail(f"knobs: zamba2 ssd logits differ from scan by {diff32} in fp32")
    # MLA: the lazy expansion against the eager one, deepseek-v3 FULL, one layer
    cfg = deepseek_v3_671b.FULL
    p = A.init_mla(cfg, generator=torch.Generator(device="cuda").manual_seed(SEED + 35),
                   device=torch.device("cuda"), dtype=torch.bfloat16)
    x = torch.randn((1, KNOB_SEQ, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    res = {}
    with torch.no_grad():
        for lazy in (False, True):
            c = dataclasses.replace(cfg, mla_lazy_kv=lazy)
            A.mla_self_attention(p, x, c)                      # warm-up
            y, ms, peak = _timed(lambda: A.mla_self_attention(p, x, c), torch)
            res[lazy] = y.float()
            out[f"mla {'lazy' if lazy else 'eager'}"] = {"ms": ms, "peak_mib": peak / 2 ** 20}
            say(f"phase knobs deepseek-v3 FULL MLA {'lazy' if lazy else 'eager'}: one layer of "
                f"mla_self_attention at 1x{KNOB_SEQ}, bf16, {ms:.3f} ms, peak {peak / 2 ** 20:,.0f} "
                f"MiB above the start")
    diff = (res[True] - res[False]).abs().max().item()
    ok = torch.allclose(res[True], res[False], rtol=8e-2, atol=8e-2)
    out["mla lazy vs eager max abs diff"] = diff
    say(f"phase knobs MLA lazy vs eager: within rtol/atol 8e-2: {ok} (max abs diff {diff:.4g})")
    if not ok:
        fail(f"knobs: lazy MLA differs from eager by {diff}")
    del p, x, res
    # the token-sharded MoE dispatch without a mesh, deepseek-v3 SMOKE
    cfg = deepseek_v3_671b.SMOKE
    p = FF.init_moe(cfg, generator=torch.Generator(device="cuda").manual_seed(SEED + 36),
                    device=torch.device("cuda"), dtype=torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=gen, device="cuda")
    off, aoff = FF.moe_forward(p, x, cfg)
    on, aon = FF.moe_forward(p, x, dataclasses.replace(cfg, moe_dispatch_token_shard=True))
    same = torch.equal(on, off) and torch.equal(aon, aoff)
    out["token_shard equal"] = same
    say(f"phase knobs moe_dispatch_token_shard on deepseek-v3 SMOKE's MoE on the card: "
        f"torch.equal to the knob off: {same}")
    if not same:
        fail("knobs: the token-sharded MoE differs from the knob off on one card")
    return out


# ---------------------------------------------------------------------------
# 34. the collectives over four cards (--multicard)
# ---------------------------------------------------------------------------

COLL_WORLD = 4
COLL_TIMEOUT_S = 900
#: (a) flash decode at granite-8b FULL's decode shapes: 4 sequences, a cache
#: of 4,096 positions split over the four cards, 8 KV heads, 32 query heads,
#: head_dim 128; the fill leaves the last card's slice empty
COLL_FD = dict(b=4, s=4096, g=8, h=32, d=128, length=3000)
COLL_TIMING_RUNS = 10
#: (b) tests/_torch_gloo_mesh.py's cases (ARCH[@DxM][+MODE], default 2x2)
COLL_TRAIN_CASES = ("granite-8b", "deepseek-v3-671b", "zamba2-1.2b",
                    "deepseek-v3-671b+expert_tp", "deepseek-v3-671b+ep_alltoall",
                    "granite-8b@1x4", "zamba2-1.2b@1x4", "deepseek-v3-671b@1x4",
                    "deepseek-v3-671b@1x4+expert_tp", "qwen2-14h@1x4", "falcon-mamba-7b@1x4")
COLL_SERVE_CASES = ("granite-8b", "deepseek-v3-671b", "zamba2-1.2b",
                    "deepseek-v3-671b+expert_tp", "deepseek-v3-671b+ep_alltoall",
                    "granite-8b@1x4", "qwen2-14h@1x4", "falcon-mamba-7b@1x4")
#: (c) item 16d's cell: the dry run's prediction for each rank (PERF.md section 6,
#: phase 33c: the dry run on the H100 constants of launch/roofline.py)
COLL_16D_ARG_GIB, COLL_16D_TEMP_GIB = 19.22, 27.38
COLL_16D_COMPUTE_MS, COLL_16D_COLL_MS = 71.9, 17.9
COLL_16D_WARMUP, COLL_16D_STEPS = 1, 4


def card_line_of(index: int) -> str:
    out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else "?"


def collectives_phase(torch) -> dict:
    """34. Four ranks of this script over NCCL (see the module docstring);
    -> each rank's report."""
    import os
    import tempfile
    if torch.cuda.device_count() < COLL_WORLD:
        fail(f"collectives: phase 34 needs {COLL_WORLD} cards, "
             f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(prefix="collectives_") as tmp:
        tmp = Path(tmp)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        procs, logs = [], []
        t0 = time.perf_counter()
        for r in range(COLL_WORLD):
            logs.append(open(tmp / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--collectives-rank", str(r),
                 str(tmp / "store"), str(tmp)], stdout=logs[-1], stderr=subprocess.STDOUT,
                env=env, cwd=ROOT))
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if time.perf_counter() - t0 > COLL_TIMEOUT_S:
                    failed = f"not done in {COLL_TIMEOUT_S} s"
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            failed = f"ranks {bad} failed" if bad else None
        texts = [(tmp / f"rank{r}.log").read_text() for r in range(COLL_WORLD)]
        for r, text in enumerate(texts):
            for line in text.splitlines():
                if line.startswith("phase collectives") or line.startswith("FAIL"):
                    say(line)
        if failed:
            fail(f"collectives: {failed}:\n" + "\n".join(
                f"--- rank {r}:\n{t[-3000:]}" for r, t in enumerate(texts)))
        reports = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(COLL_WORLD)]
    wall = time.perf_counter() - t0
    losses = [rep["16d"]["losses"] for rep in reports]
    if any(x != losses[0] for x in losses):
        fail(f"collectives 16d: the ranks' losses differ: {losses}")
    peaks = [rep["16d"]["peak_gib"] for rep in reports]
    steps = [rep["16d"]["step_ms"] for rep in reports]
    pred = COLL_16D_ARG_GIB + COLL_16D_TEMP_GIB
    say(f"phase collectives: {COLL_WORLD} ranks over NCCL, done in {wall:.1f} s; 16d peaks "
        + ", ".join(f"{x:.2f}" for x in peaks) + f" GiB against the predicted {pred:.2f} "
        f"(ratio {max(peaks) / pred:.3f} at the largest); median steps "
        + ", ".join(f"{x:.1f}" for x in steps) + f" ms against the predicted "
        f"{COLL_16D_COMPUTE_MS} ms of compute and {COLL_16D_COLL_MS} ms of collectives; loss "
        + " ".join(f"{x:.4f}" for x in losses[0]) + " on every rank")
    return {"wall_s": wall, "ranks": reports, "predicted_peak_gib": pred,
            "predicted_compute_ms": COLL_16D_COMPUTE_MS,
            "predicted_collective_ms": COLL_16D_COLL_MS}


def _events_ms(fn, torch, runs: int = COLL_TIMING_RUNS) -> float:
    """Median ms of ``fn()`` by CUDA events, the ranks lined up by a
    barrier before each run."""
    import torch.distributed as dist
    fn()
    times = []
    for _ in range(runs):
        dist.barrier()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def coll_flash(rank: int, dev: str, torch) -> dict:
    """34a, flash decode against decode_attention on one card."""
    from _torch_gloo_mesh import cached_mesh
    from repro_torch.distributed import collectives as C
    from repro_torch.models.lm.attention import decode_attention
    c = COLL_FD
    mesh = cached_mesh((COLL_WORLD,), ("model",))
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    q = torch.randn(c["b"], 1, c["h"], c["d"], device=dev, generator=gen)
    k = torch.randn(c["b"], c["s"], c["g"], c["d"], device=dev, generator=gen)
    v = torch.randn(c["b"], c["s"], c["g"], c["d"], device=dev, generator=gen)
    s_l = c["s"] // COLL_WORLD
    kl, vl = (t[:, rank * s_l:(rank + 1) * s_l].contiguous() for t in (k, v))
    length = torch.tensor(c["length"], device=dev)
    got = C.flash_decode_attention(mesh, "model", q, kl, vl, length)
    want = decode_attention(q, k, v, length)
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, rtol=1e-4, atol=1e-5)
    ms = _events_ms(lambda: C.flash_decode_attention(mesh, "model", q, kl, vl, length), torch)
    one_ms = _events_ms(lambda: decode_attention(q, k, v, length), torch)
    say(f"phase collectives flash rank {rank}: flash_decode_attention B {c['b']} cache "
        f"{c['s']} ({s_l} a card) G {c['g']} H {c['h']} D {c['d']} fill {c['length']}, fp32: "
        f"max abs err {err:.3g} against decode_attention on one card (rtol 1e-4 / atol 1e-5: "
        f"{ok}); {ms:.4f} ms (one MAX and two SUM all-reduces) against {one_ms:.4f} ms for the "
        f"whole cache on one card")
    if not ok:
        fail(f"collectives flash rank {rank}: max abs err {err}")
    return {"max_abs_err": err, "ms": ms, "one_card_ms": one_ms}


def coll_psum(rank: int, dev: str, torch) -> dict:
    """34a, compressed psum over one granite-8b FULL layer's gradient leaves,
    each rank its own, two steps with the error carried, against the plain
    formula for all four ranks' gradients on this card."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import granite_8b
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from _torch_gloo_mesh import cached_mesh
    from repro_torch.distributed import collectives as C
    from repro_torch.models.lm import transformer as T
    layer = T.init_lm(dataclasses.replace(granite_8b.FULL, n_layers=1), generator=None,
                      device="meta").tree()["layers"][0]
    shapes = [t.shape for t in tree_leaves(layer)]
    mesh = cached_mesh((COLL_WORLD,), ("model",))

    def grads(r: int, step: int):
        g = torch.Generator(device=dev).manual_seed(SEED + 3400 + 97 * r + step)
        return [torch.randn(sh, device=dev, generator=g) * (0.5 + r) for sh in shapes]

    def plain(g, err):                       # the reference's arithmetic, written out
        g = g + err
        scale = g.abs().max() / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q, scale, q.float() * scale, g

    err_port = [torch.zeros(sh, device=dev) for sh in shapes]
    errs_plain = [[torch.zeros(sh, device=dev) for sh in shapes] for _ in range(COLL_WORLD)]
    worst, codes_equal = 0.0, True
    for step in range(2):
        own = tree_unflatten(layer, grads(rank, step))
        red, err_new = C.compressed_psum(mesh, "model", own, tree_unflatten(layer, err_port))
        red, err_new = tree_leaves(red), tree_leaves(err_new)
        all_g = [grads(r, step) for r in range(COLL_WORLD)]
        for i in range(len(shapes)):
            outs = [plain(all_g[r][i], errs_plain[r][i]) for r in range(COLL_WORLD)]
            want = sum(o[2] for o in outs) / float(COLL_WORLD)
            q, scale, _, g = outs[rank]
            # the port's codes, read back from its residual: g + err - new_err
            codes = torch.round((g - err_new[i]) / scale).to(torch.int8)
            codes_equal &= bool(torch.equal(codes, q))
            for r in range(COLL_WORLD):
                errs_plain[r][i] = outs[r][3] - outs[r][2]
            worst = max(worst, (red[i] - want).abs().max().item() / want.abs().max().item(),
                        (err_new[i] - errs_plain[rank][i]).abs().max().item()
                        / max(errs_plain[rank][i].abs().max().item(), 1e-30))
        err_port = err_new
        del all_g
    tree = tree_unflatten(layer, grads(rank, 0))
    zero = tree_unflatten(layer, [torch.zeros(sh, device=dev) for sh in shapes])
    ms = _events_ms(lambda: C.compressed_psum(mesh, "model", tree, zero), torch)
    leaves = tree_leaves(tree)

    def fp32_all_reduce():
        for t in leaves:
            y = t.clone()
            dist.all_reduce(y)
            y /= COLL_WORLD
    plain_ms = _events_ms(fp32_all_reduce, torch)
    n = sum(t.numel() for t in leaves)
    say(f"phase collectives psum rank {rank}: compressed_psum over one granite-8b FULL layer's "
        f"{len(shapes)} gradient leaves ({n:,} values, each rank its own), two steps with the "
        f"error carried: codes equal to the plain formula's {codes_equal}, results and "
        f"residuals within {worst:.3g} of each leaf's largest (1e-6); {ms:.3f} ms against "
        f"{plain_ms:.3f} ms for the plain fp32 all-reduce of the same tree (both all-reduce "
        f"fp32: the reference's wire format)")
    if not codes_equal or worst > 1e-6:
        fail(f"collectives psum rank {rank}: codes equal {codes_equal}, worst {worst}")
    return {"leaves": len(shapes), "values": n, "codes_equal": codes_equal, "worst_rel": worst,
            "ms": ms, "fp32_all_reduce_ms": plain_ms}


def coll_smoke(rank: int, dev: str, torch) -> dict:
    """34b, tests/_torch_gloo_mesh.py's SMOKE comparison over NCCL."""
    from _torch_gloo_mesh import run_case
    out = {}
    for kind, cases, keys in (("train", COLL_TRAIN_CASES, ("loss", "grads")),
                              ("serve", COLL_SERVE_CASES, ("prefill logits", "prefill caches",
                                                           "decode logits", "decode caches"))):
        for case in cases:
            r = run_case(case, kind, dev)
            worst = max(r[k] for k in keys)
            say(f"phase collectives smoke rank {rank}: {kind} {case}: "
                + ", ".join(f"{k} {r[k]:.3g}" for k in keys)
                + f" of each tensor's largest from the plain one-card step ({r['leaves']} "
                f"leaves, {r['seconds']:.1f} s)")
            if not worst <= 1e-4:
                fail(f"collectives smoke rank {rank}: {kind} {case}: {r}")
            out[f"{kind} {case}"] = r
    return out


def own_shard(t, mesh, placements):
    """This rank's shard of the whole tensor ``t`` under ``placements``
    (DTensor's even split, major mesh dim first), as a tensor of its own."""
    from torch.distributed.tensor import Shard
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return t.detach().clone()


def coll_16d(rank: int, dev: str, torch, cfg=None, seq: int = LM_TRAIN_SEQ) -> dict:
    """34c, item 16d's cell (see the module docstring)."""
    import gc
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import granite_8b
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.ctx import use_ctx
    from _torch_gloo_mesh import cached_mesh
    from repro_torch.launch import steps as ST
    from repro_torch.models.lm import transformer as T
    cfg = cfg or granite_8b.FULL
    mi = SH.mesh_info(cached_mesh((1, COLL_WORLD)))
    opt = ST.make_optimizer()
    # every rank draws the same whole weights and keeps its own shard of
    # each, leaf by leaf, so that one whole copy at most is ever held
    params = T.init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev).tree()
    placements = ST._shardings(SH.param_specs(params, cfg, mi), mi)

    def keep_shards(tree, pls):
        for key in (range(len(tree)) if isinstance(tree, list) else list(tree)):
            if isinstance(tree[key], (dict, list)):
                keep_shards(tree[key], pls[key])
            else:
                tree[key] = DTensor.from_local(own_shard(tree[key], mi.mesh, pls[key]),
                                               mi.mesh, pls[key], run_check=False)
    keep_shards(params, placements)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    state = {"params": params, "opt": opt.init(params)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq + 1), device=dev, generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    batch = tree_map(lambda t, pl: distribute_tensor(t, mi.mesh, pl), batch,
                     ST._shardings(SH.batch_specs(batch, mi), mi))
    arg_bytes = sum(getattr(t, "_local_tensor", t).untyped_storage().nbytes()
                    for t in tree_leaves((state, batch)))
    step = ST.make_train_step(cfg, opt, remat=True)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if dev == "cuda" else 0
    losses, times = [], []
    with use_ctx(mi.ctx()), implicit_replication():
        for i in range(COLL_16D_WARMUP + COLL_16D_STEPS):
            dist.barrier()
            t0 = time.perf_counter()
            if dev == "cuda":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
            state, m = step(state, batch)
            loss = m["loss"]
            loss = float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss)
            if dev == "cuda":
                b.record()
                torch.cuda.synchronize()
                ms = a.elapsed_time(b)
            else:
                ms = (time.perf_counter() - t0) * 1e3
            losses.append(loss)
            times.append(ms)
    warm, times = times[:COLL_16D_WARMUP], times[COLL_16D_WARMUP:]
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    step_ms = statistics.median(times)
    gathered = [None] * COLL_WORLD
    dist.all_gather_object(gathered, losses)
    pred = COLL_16D_ARG_GIB + COLL_16D_TEMP_GIB
    say(f"phase collectives 16d rank {rank}: granite-8b FULL, {cfg.n_layers} layers, 1 x {seq} "
        f"tokens, bf16, make_optimizer()'s Adam, (data=1, model={COLL_WORLD}): arguments "
        f"{arg_bytes / 2 ** 30:.3f} GiB (predicted {COLL_16D_ARG_GIB}), held before the first "
        f"step {held / 2 ** 30:.3f} GiB, peak allocated {peak / 2 ** 30:.3f} GiB against the "
        f"predicted {pred:.2f} (ratio {peak / 2 ** 30 / pred:.3f}); median step {step_ms:.1f} ms "
        f"of {COLL_16D_STEPS} after {COLL_16D_WARMUP} warm-up ({min(times):.1f}-{max(times):.1f};"
        f" the warm-up {', '.join(f'{x:.1f}' for x in warm)}) against the predicted "
        f"{COLL_16D_COMPUTE_MS} ms of "
        f"compute and {COLL_16D_COLL_MS} ms of collectives; loss "
        + " ".join(f"{x:.4f}" for x in losses))
    if not all(math.isfinite(x) for x in losses):
        fail(f"collectives 16d rank {rank}: a loss is not finite: {losses}")
    if any(g != losses for g in gathered):
        fail(f"collectives 16d rank {rank}: the ranks' losses differ: {gathered}")
    return {"layers": cfg.n_layers, "seq": seq, "argument_gib": arg_bytes / 2 ** 30,
            "held_gib": held / 2 ** 30, "peak_gib": peak / 2 ** 30, "step_ms": step_ms,
            "step_runs_ms": times, "warmup_ms": warm, "losses": losses}


def collectives_rank(rank: int, store: str, out_dir: str) -> int:
    """One rank of phase 34: card ``rank``, NCCL, (a), (b), (c) in order;
    its report goes to ``out_dir/rank<rank>.json``."""
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))           # the SMOKE comparison's harness
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        fail("collectives: no CUDA card visible to a rank")
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                            world_size=COLL_WORLD,
                            timeout=datetime.timedelta(seconds=COLL_TIMEOUT_S))
    try:
        card = card_line_of(rank)
        say(f"phase collectives rank {rank}: card {rank}: {card}; torch {torch.__version__}")
        rep = {"rank": rank, "card": card}
        t0 = time.perf_counter()
        rep["flash"] = coll_flash(rank, "cuda", torch)
        rep["psum"] = coll_psum(rank, "cuda", torch)
        rep["smoke"] = coll_smoke(rank, "cuda", torch)
        rep["16d"] = coll_16d(rank, "cuda", torch)
        rep["seconds"] = time.perf_counter() - t0
        say(f"phase collectives rank {rank}: done in {rep['seconds']:.1f} s; {card}")
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rep))
    finally:
        dist.destroy_process_group()
    return 0


def main() -> None:
    if sys.argv[1:2] == ["--dryrun-cell"] and len(sys.argv) == 4:
        sys.exit(dryrun_cell(sys.argv[2], sys.argv[3]))     # a phase-33 process, no card
    if sys.argv[1:2] == ["--collectives-rank"] and len(sys.argv) == 5:
        sys.exit(collectives_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))   # phase 34
    multicard = sys.argv[1:] == ["--multicard"]
    if sys.argv[1:] and not multicard:
        fail(f"usage: python3 {Path(__file__).name} [--multicard]")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources (src/repro_torch) are not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    from repro_torch.api import ExecutionPlan, SREngine
    from repro_torch.api.result import summarize_stats
    from repro_torch.kernels import _build
    real_init = SREngine.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        GUARDS.append((sys._getframe(1).f_code.co_name, self.guard, self.plan.faults))

    SREngine.__init__ = init
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels.ops import essr_forward_kernels, launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import mega_ref
    from repro_torch.kernels.bsconv import bsconv_report
    from repro_torch.kernels.dsconv import dsconv_report
    from repro_torch.kernels.qconv import qsfb_report
    from repro_torch.kernels.sfb import sfb_report
    from repro_torch.models.essr import ESSRConfig

    # 1. the card
    card = card_line()
    say(card)
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks_for(name)
    say(f"phase card: {name}; fp32 peak {peak_flops / 1e12:g} TFLOP/s, "
        f"memory {peak_bw / 1e12:g} TB/s (data sheet); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build(["bsconv", "sfb", "dsconv", "mega", "qconv", "qsfb", "qmega", "edge"])
    say(f"phase build: {time.perf_counter() - t0:.1f} s")
    if multicard:
        # phase 25 alone, over the cards of this host
        if torch.cuda.device_count() < 2:
            fail(f"--multicard needs two cards or more, {torch.cuda.device_count()} visible")
        engine = SREngine.from_config(ESSRConfig(scale=4), seed=SEED, device="cuda")
        report = shard_phase(engine, [mixed_frame(SEED + i) for i in range(3)], torch)
        # 34. the collectives, each rank a process on its own card
        del engine
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        coll_report = collectives_phase(torch)
        say(card)
        say("shards: " + json.dumps(report))
        say("collectives: " + json.dumps(coll_report))
        say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                               "count": torch.cuda.device_count()}}))
        return
    for lib, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                say(f"  ptxas {lib}: {line.split(chr(39))[1][:90]}")
            if "registers" in line or "spill" in line:
                say(f"  ptxas {lib}: {line.strip()}")
    bs_lib = _build.load("bsconv")
    bs_lib.bsconv_smem_bytes.argtypes = [ctypes.c_int] * 5
    bs_lib.bsconv_smem_bytes.restype = ctypes.c_longlong
    bs_lib.bsconv_blocks_per_sm.argtypes = [ctypes.c_int] * 6
    for m, b in (("fp32", None), ("int8", 8), ("fxp10", 10)):
        for cin, c in ((3, 54), (3, 27), (54, 54), (27, 27)):
            for h, w in sorted({(h, w) for _, h, w in BSCONV_SHAPES}):
                rep = bsconv_report(cin, c, h, w, b)
                got = bs_lib.bsconv_smem_bytes(w, cin, c, b or 0, rep["rows_per_step"])
                say(f"  bsconv {m} {cin}->{c} {h}x{w}: {got} B of dynamic shared memory per "
                    f"block (bsconv_report {rep['smem_bytes']} B: {rep['bands']} band(s) of "
                    f"{rep['band_width']} px, {rep['rows_per_step']} rows a step, "
                    f"{rep['threads']} threads, pointwise busy {rep['pointwise_busy']:.3f}, "
                    f"depthwise busy {rep['depthwise_busy']:.3f}); "
                    f"{bs_lib.bsconv_blocks_per_sm(w, cin, c, b or 0, rep['rows_per_step'], rep['threads'])}"
                    f" block(s) per SM (report: {rep['blocks_per_sm']})")
                if got != rep["smem_bytes"]:
                    fail("bsconv_report disagrees with the BSConv walker's shared-memory size")
    ds_lib = _build.load("dsconv")
    ds_lib.dsconv_smem_bytes.argtypes = [ctypes.c_int] * 5
    ds_lib.dsconv_smem_bytes.restype = ctypes.c_longlong
    ds_lib.dsconv_blocks_per_sm.argtypes = [ctypes.c_int] * 6
    for m, b in (("fp32", None), ("int8", 8), ("fxp10", 10)):
        for c in (54, 27):
            for h, w in sorted({(h, w) for _, h, w in DSCONV_SHAPES}):
                rep = dsconv_report(c, 48, h, w, b)
                got = ds_lib.dsconv_smem_bytes(w, c, 48, b or 0, rep["rows_per_step"])
                say(f"  dsconv {m} C{c} {h}x{w}: {got} B of dynamic shared memory per block "
                    f"(dsconv_report {rep['smem_bytes']} B: {rep['bands']} band(s) of "
                    f"{rep['band_width']} px, {rep['rows_per_step']} rows a step, "
                    f"{rep['threads']} threads, depthwise busy {rep['depthwise_busy']:.3f}, "
                    f"pointwise busy {rep['pointwise_busy']:.3f}); "
                    f"{ds_lib.dsconv_blocks_per_sm(w, c, 48, b or 0, rep['rows_per_step'], rep['threads'])}"
                    f" block(s) per SM (report: {rep['blocks_per_sm']})")
                if got != rep["smem_bytes"]:
                    fail("dsconv_report disagrees with the DSConv walker's shared-memory size")
    qsfb_lib = _build.load("qsfb")
    qsfb_lib.qsfb_smem_bytes.argtypes = [ctypes.c_int] * 4
    qsfb_lib.qsfb_smem_bytes.restype = ctypes.c_longlong
    qsfb_lib.qsfb_blocks_per_sm.argtypes = [ctypes.c_int] * 5
    for m, b in (("int8", 8), ("fxp10", 10)):
        for c, h, w in ((54, 32, 32), (27, 32, 32), (64, 32, 32)) + tuple(
                (c, h, w) for _, h, w in QSFB_SHAPES for c in (54, 27, 64)):
            rep = qsfb_report(c, h, w, b)
            got = qsfb_lib.qsfb_smem_bytes(w, c, b, rep["rows_per_step"])
            say(f"  qsfb {m} C{c} {h}x{w}: {got} B of dynamic shared memory per block "
                f"(qsfb_report {rep['smem_bytes']} B: {rep['bands']} band(s) of "
                f"{rep['band_width']} px, {rep['rows_per_step']} rows a step, {rep['threads']} "
                f"threads, {rep['pixel_dots_per_output_px']:.4f} pixel-dots per output px, dot "
                f"busy {rep['dot_busy']:.3f}, depthwise busy {rep['depthwise_busy']:.3f}); "
                f"{qsfb_lib.qsfb_blocks_per_sm(w, c, b, rep['rows_per_step'], rep['threads'])} "
                f"block(s) per SM (report, by shared memory and threads: "
                f"{rep['blocks_per_sm']})")
            if got != rep["smem_bytes"]:
                fail("qsfb_report disagrees with the qSFB kernel's shared-memory size")
    qsmem = _build.load("qmega").qmega_smem_bytes
    qsmem.argtypes, qsmem.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    for c in (54, 27):
        for m, b in (("int8", 8), ("fxp10", 10)):
            for h, w in ((32, 32),) + tuple((h, w) for _, h, w in QMEGA_SHAPES[4:]):
                qrep = mk.qgroup_report(c, (h, w), 4, 5, b)
                got = qsmem(w, 3, c, 48, 5, qrep["rows_per_cta"], b)
                say(f"  qmega C{c} {m} {h}x{w}: {got} B of dynamic shared memory per block "
                    f"(qgroup_report {qrep['smem_bytes']} B, clusters of {qrep['cluster']}, "
                    f"{qrep['rows_per_cta']} rows, {qrep['threads']} threads)")
                if got != qrep["smem_bytes"]:
                    fail("qgroup_report disagrees with the kernel's shared-memory size")
    msmem = _build.load("mega").mega_smem_bytes
    msmem.argtypes, msmem.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    for c in (54, 27):
        for h, w in tuple((h, w) for _, h, w in MEGA_SHAPES[2:]):
            mrep = mk.group_report(c, (h, w), 4, 5)
            got = msmem(w, 3, c, 48, 5, mrep["rows_per_cta"], mrep["pixel_pad"])
            say(f"  mega C{c} {h}x{w}: {got} B of dynamic shared memory per block "
                f"(group_report {mrep['smem_bytes']} B, clusters of {mrep['cluster']}, "
                f"{mrep['rows_per_cta']} rows, {mrep['threads']} threads, pixel pad "
                f"{mrep['pixel_pad']})")
            if got != mrep["smem_bytes"]:
                fail("group_report disagrees with the megakernel's shared-memory size")
    sfb_lib = _build.load("sfb")
    sfb_lib.sfb_smem_bytes.argtypes, sfb_lib.sfb_smem_bytes.restype = [ctypes.c_int] * 3, \
        ctypes.c_longlong
    sfb_lib.sfb_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    for c, h, w in ((54, 32, 32), (27, 32, 32)) + tuple((c, h, w) for _, h, w, c in SFB_SHAPES):
        rep = sfb_report(c, h, w)
        got = sfb_lib.sfb_smem_bytes(w, c, rep["rows_per_step"])
        say(f"  sfb C{c} {h}x{w}: {got} B of dynamic shared memory per block (sfb_report "
            f"{rep['smem_bytes']} B: {rep['bands']} band(s) of {rep['band_width']} px, "
            f"{rep['rows_per_step']} rows a step, {rep['threads']} threads, "
            f"{rep['pointwise_px_per_output_px']:.4f} pointwise px per output px, pointwise "
            f"busy {rep['pointwise_busy']:.3f}, depthwise busy {rep['depthwise_busy']:.3f}); "
            f"{sfb_lib.sfb_blocks_per_sm(w, c, rep['rows_per_step'], rep['threads'])} "
            f"block(s) per SM")
        if got != rep["smem_bytes"]:
            fail("sfb_report disagrees with the SFB kernel's shared-memory size")

    # 3. each kernel against its plain version
    g = torch.Generator().manual_seed(SEED)
    cases = [("bsconv", 54, 3), ("bsconv", 27, 3), ("bsconv", 54, 54), ("bsconv", 27, 27),
             ("sfb", 54, None), ("sfb", 27, None), ("dsconv", 54, None), ("dsconv", 27, None)]
    runs = [(kind, c, cin, n, (32, 32)) for kind, c, cin in cases for n in (1, 7, 512)]
    runs += [("sfb", c, None, n, (h, w)) for n, h, w, c in SFB_SHAPES]
    max_err = {"bsconv": 0.0, "sfb": 0.0, "dsconv": 0.0, "mega": 0.0}
    for kind, c, cin, n, hw in runs:
        kern, plain, _ = runners(kind, torch)
        x, w = operands(kind, n, c, g, torch, cin=cin or 3, hw=hw)
        got = kern(x, w)
        torch.cuda.synchronize()
        want = plain(x, w)
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-6)).max().item()
        ok = torch.allclose(got, want, **TOL)
        say(f"phase check {kind} C={c}{'' if cin is None else f' Cin={cin}'} N={n} "
            f"{hw[0]}x{hw[1]}: "
            f"max_abs {err:.3e} max_rel {rel:.3e} "
            f"(rtol {TOL['rtol']:g} atol {TOL['atol']:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{kind} disagrees with its plain version")
        max_err[kind] = max(max_err[kind], err)

    cfg = ESSRConfig(scale=4)
    for width in (54, 27):
        tree, wbuf = mega_operands(width, g, torch)
        lay = mk.WeightLayout(3, width, cfg.out_channels, cfg.n_sfb)
        for n, h, w in MEGA_SHAPES:
            x = torch.rand((n, h, w, 3), generator=g).cuda()
            got = mk.mega_fused(x, wbuf, width=width, n_sfb=cfg.n_sfb,
                                out_channels=cfg.out_channels)
            torch.cuda.synchronize()
            want = mega_ref(x, mk.unpack_weights(wbuf, lay))
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **CHAIN_TOL)
            layer = essr_forward_kernels(tree, x, cfg, width=width)
            mega = mk.essr_forward_megakernel(tree, x, cfg, width=width)
            torch.cuda.synchronize()
            err_layer = (mega - layer).abs().max().item()
            ok_layer = torch.equal(mega, layer)     # the same order of every sum: bit for bit
            mrep = mk.group_report(width, (h, w), cfg.scale, cfg.n_sfb)
            say(f"phase check mega C={width} N={n} {h}x{w} ({mrep['cluster']} x "
                f"{mrep['rows_per_cta']} rows): max_abs vs plain {err:.3e} (rtol "
                f"{CHAIN_TOL['rtol']:g} atol {CHAIN_TOL['atol']:g}), vs layer chain "
                f"{err_layer:.3e} (torch.equal) {'ok' if ok and ok_layer else 'MISMATCH'}")
            if not (ok and ok_layer):
                fail("the megakernel disagrees with its plain version or the layer chain")
            max_err["mega"] = max(max_err["mega"], err)
        del tree, wbuf, x, got, want, layer, mega

    # 7. the quantized kernels against their plain versions, bit for bit
    quant = {m: quant_setup(m, g, torch) for m in QUANT_MODES}
    qerr = dict.fromkeys(QKERNELS, 0)     # max |kernel - plain| in codes, over every check
    for mode in QUANT_MODES:
        _, pack, qs, _ = quant[mode]
        for width in (54, 27):
            for n, h, w in ((1, 32, 32), (7, 32, 32), (512, 32, 32), (3, 13, 21)):
                x = torch.rand((n, h, w, 3), generator=g).cuda()
                seen = {}
                for kind, kern, plain, inp in quant_stages(qs[width], x, pack.bits, torch):
                    got, want = kern(inp), plain(inp)
                    torch.cuda.synchronize()
                    err = (got.long() - want.long()).abs().max().item() if got.numel() else 0
                    qerr[kind] = max(qerr[kind], err)
                    if not torch.equal(got, want):
                        fail(f"{kind} ({mode}, C{width}, N={n} {h}x{w}) differs from its plain "
                             f"version by up to {err} codes")
                    if want.abs().max().item() == 0:
                        fail(f"{kind} ({mode}, C{width}, N={n}): every code is 0, the check "
                             f"would see nothing")
                    seen[kind] = seen.get(kind, 0) + 1
                say(f"phase check q* {mode} C{width} N={n} {h}x{w}: "
                    + ", ".join(f"{k} x{v}" for k, v in seen.items()) + " torch.equal ok")
        # the plain versions on the card against the same on the CPU
        x = torch.rand((7, 32, 32, 3), generator=g).cuda()
        on_card = quant_stages(qs[54], x, pack.bits, torch)
        on_cpu = quant_stages(to_cpu(qs[54]), x.cpu(), pack.bits, torch)
        for i in (0, -2):                      # quantize, qdsconv
            kind, _, plain, inp = on_card[i]
            if not torch.equal(plain(inp).cpu(), on_cpu[i][2](inp.cpu())):
                fail(f"the plain {kind} ({mode}) differs between the card and the CPU")
        say(f"phase check q* {mode}: the plain quantize and qdsconv on the card equal "
            f"the same on the CPU")
    del x, got, want, inp

    # 17. the DSConv walker (csrc/dsconv.cu) at every DSCONV_SHAPES shape, C54
    # and C27, non-zero biases: fp32 against its plain version (TOL), the codes
    # datapath (qDSConv, the calibrated model's recon operands) torch.equal
    from repro_torch.kernels import qconv as tq
    from repro_torch.kernels.ref import qdsconv_ref
    ds_kern, ds_plain, _ = runners("dsconv", torch)
    for width in (54, 27):
        for n, h, w in DSCONV_SHAPES:
            x, wts = operands("dsconv", n, width, g, torch, hw=(h, w))
            got, want = ds_kern(x, wts), ds_plain(x, wts)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **TOL)
            max_err["dsconv"] = max(max_err["dsconv"], err)
            seen = []
            for mode in QUANT_MODES:
                _, pack, qs, _ = quant[mode]
                r = qs[width]["recon"]
                qmax = 127 if pack.bits <= 8 else 511
                xq = torch.randint(-qmax, qmax + 1, (n, h, w, width), generator=g).to(
                    torch.int8 if pack.bits <= 8 else torch.int32).cuda()
                args = (r["dwq"], r["dw_scale"], r["dwb"], r["pw_fq"], r["pwb"], r["qc"])
                qgot, qwant = tq.qdsconv_fused(xq, *args), qdsconv_ref(xq, *args)
                torch.cuda.synchronize()
                qerr["qdsconv"] = max(qerr["qdsconv"],
                                      (qgot.long() - qwant.long()).abs().max().item())
                eq = torch.equal(qgot, qwant) and qwant.abs().max().item() > 0
                seen.append(f"qdsconv {mode} torch.equal {eq}")
                if not eq:
                    fail(f"qdsconv ({mode}, C{width}, N={n} {h}x{w}) differs from its plain "
                         f"version or every code is 0")
            say(f"phase check dsconv walker C{width} N={n} {h}x{w} "
                f"({dsconv_report(width, 48, h, w)['bands']} band(s)): fp32 max_abs {err:.3e} "
                f"(rtol {TOL['rtol']:g} atol {TOL['atol']:g}) {'ok' if ok else 'MISMATCH'}; "
                + ", ".join(seen))
            if not ok:
                fail(f"dsconv (C{width}, N={n} {h}x{w}) disagrees with its plain version")
    del x, wts, got, want, xq, qgot, qwant

    # 18. the BSConv walker (csrc/bsconv.cu) at every BSCONV_SHAPES shape, the
    # first layer (Cin = 3) and Cin = C at C54 and C27, non-zero biases: fp32
    # against its plain version (TOL), the codes datapath (qBSConv, the
    # calibrated model's first layer and first SFB's b1 group) torch.equal
    from repro_torch.kernels.bsconv import bsconv_fused
    from repro_torch.kernels.ref import bsconv_ref, qbsconv_ref
    from repro_torch.quant.pams import code_dtype
    for width in (54, 27):
        for n, h, w in BSCONV_SHAPES:
            seen = []
            for cin in (3, width):
                x, wts = operands("bsconv", n, width, g, torch, cin=cin, hw=(h, w))
                for relu in (False, True):
                    args = (wts["pw"], wts["pw_b"], wts["dw"], wts["dw_b"])
                    got = bsconv_fused(x, *args, relu=relu)
                    want = bsconv_ref(x, *args, relu=relu)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    max_err["bsconv"] = max(max_err["bsconv"], err)
                    if not torch.allclose(got, want, **TOL):
                        fail(f"bsconv ({cin}->{width}, relu {relu}, N={n} {h}x{w}) disagrees with "
                             f"its plain version: max_abs {err:.3e}")
                    seen.append(f"fp32 {cin}->{width}{' relu' if relu else ''} max_abs {err:.3e}")
            for mode in QUANT_MODES:
                _, pack, qs, _ = quant[mode]
                p, s0 = qs[width]["first"], qs[width]["sfbs"][0]
                groups = ((3, (p["pwq"], p["pw_scale"], p["pwb"], p["dw_fq"], p["dwb"], p["qc"]),
                           False),
                          (width, (s0["b1_pwq"], s0["b1_pw_scale"], s0["b1_pwb"], s0["b1_dw_fq"],
                                   s0["b1_dwb"], s0["qc"][0:2]), True))
                qmax = 127 if pack.bits <= 8 else 511
                for cin, args, relu in groups:
                    xq = torch.randint(-qmax, qmax + 1, (n, h, w, cin), generator=g).to(
                        code_dtype(pack.bits)).cuda()
                    qgot = tq.qbsconv_fused(xq, *args, relu=relu)
                    qwant = qbsconv_ref(xq, *args, relu=relu)
                    torch.cuda.synchronize()
                    qerr["qbsconv"] = max(qerr["qbsconv"],
                                          (qgot.long() - qwant.long()).abs().max().item())
                    eq = torch.equal(qgot, qwant) and qwant.abs().max().item() > 0
                    seen.append(f"qbsconv {mode} {cin}->{width} torch.equal {eq}")
                    if not eq:
                        fail(f"qbsconv ({mode}, {cin}->{width}, N={n} {h}x{w}) differs from its "
                             f"plain version or every code is 0")
            say(f"phase check bsconv walker C{width} N={n} {h}x{w} "
                f"({bsconv_report(3, width, h, w)['bands']} band(s)): " + ", ".join(seen)
                + f" (rtol {TOL['rtol']:g} atol {TOL['atol']:g})")
    del x, wts, got, want, xq, qgot, qwant

    # 15. the qSFB kernel at banded and ragged shapes and at extreme codes
    from repro_torch.kernels.ref import qsfb_ref
    for mode in QUANT_MODES:
        _, pack, qs, _ = quant[mode]
        cases = []
        for width in (54, 27):
            for n, h, w in QSFB_SHAPES:
                x = torch.rand((n, h, w, 3), generator=g).cuda()
                sfb = qs[width]["sfbs"][0]
                cases.append((f"model C{width}", quant_stages(qs[width], x, pack.bits, torch)[2][3],
                              sfb, sfb["qc"]))
        for n, h, w in ((7, 32, 32),) + QSFB_SHAPES:
            cases.append(("extreme C64", *qsfb_extreme_operands(n, h, w, 64, pack.bits, g, torch)))
        for label, xq, q, qc in cases:
            got, want = tq.qsfb_fused(xq, q, qc), qsfb_ref(xq, q, qc)
            torch.cuda.synchronize()
            err = (got.long() - want.long()).abs().max().item()
            qerr["qsfb"] = max(qerr["qsfb"], err)
            n, h, w, _ = xq.shape
            say(f"phase check qsfb {mode} {label} N={n} {h}x{w}: torch.equal to qsfb_ref "
                f"{torch.equal(got, want)} (max {err} codes apart; nonzero share "
                f"{(want != 0).float().mean().item():.3f})")
            if not torch.equal(got, want):
                fail(f"qsfb ({mode}, {label}, N={n} {h}x{w}) differs from its plain version")
            if want.abs().max().item() == 0:
                fail(f"qsfb ({mode}, {label}): every code is 0, the check would see nothing")
    del cases, xq, q, qc, got, want

    # 11. the quantized megakernel: its codes against its plain version, its
    # images against the qconv kernel chain and the integer reference
    from repro_torch.kernels.qconv import essr_forward_qkernels, essr_forward_qref
    from repro_torch.kernels.ref import qmega_ref
    qerr["qmega"] = 0
    for mode in QUANT_MODES:
        qcfg, pack, qs, qtree = quant[mode]
        for width in (54, 27):
            q = qs[width]
            wbuf = mk.pack_qweights(q, pack.bits)
            lay = mk.QWeightLayout(3, width, qcfg.out_channels, qcfg.n_sfb, pack.bits)
            plain_w = mk.unpack_qweights(wbuf, lay)
            for n, h, w in QMEGA_SHAPES:
                x = torch.rand((n, h, w, 3), generator=g).cuda()
                codes = mk.qmega_fused(x, wbuf, q["consts"], width=width, n_sfb=qcfg.n_sfb,
                                       out_channels=qcfg.out_channels, bits=pack.bits)
                torch.cuda.synchronize()
                want = qmega_ref(x, plain_w, q["consts"], codes.dtype)
                err = (codes.long() - want.long()).abs().max().item()
                qerr["qmega"] = max(qerr["qmega"], err)
                img = mk.essr_forward_qmegakernel(qtree, x, qcfg, width, pack=pack)
                torch.cuda.synchronize()
                chain = essr_forward_qkernels(qtree, x, qcfg, width, pack=pack)
                qref = essr_forward_qref(qtree, x, qcfg, width, pack=pack)
                eq = (torch.equal(codes, want), torch.equal(img, chain), torch.equal(img, qref))
                say(f"phase check qmega {mode} C{width} N={n} {h}x{w}: recon codes torch.equal "
                    f"to the plain version {eq[0]} (max {err} codes apart), image torch.equal "
                    f"to the qconv kernel chain {eq[1]} and to essr_forward_qref {eq[2]}")
                if not all(eq):
                    fail(f"the quantized megakernel ({mode}, C{width}, N={n} {h}x{w}) differs")
                if want.abs().max().item() == 0:
                    fail(f"qmega ({mode}, C{width}, N={n}): every code is 0, the check would "
                         f"see nothing")
        # synthetic extreme operands: codes that saturate, sums up to qmax^2 * 54
        ext = qmega_extreme_operands(54, pack.bits, g, torch)
        wbuf = mk.pack_qweights(ext, pack.bits)
        plain_w = mk.unpack_qweights(wbuf, mk.QWeightLayout(3, 54, qcfg.out_channels,
                                                            qcfg.n_sfb, pack.bits))
        for n, h, w in ((7, 32, 32), (3, 13, 21), (2, 17, 9), (1, 25, 32)):
            x = torch.rand((n, h, w, 3), generator=g).cuda()
            codes = mk.qmega_fused(x, wbuf, ext["consts"], width=54, n_sfb=qcfg.n_sfb,
                                   out_channels=qcfg.out_channels, bits=pack.bits)
            torch.cuda.synchronize()
            want = qmega_ref(x, plain_w, ext["consts"], codes.dtype)
            chain = qchain_kernels(ext, x, pack.bits)
            err = (codes.long() - want.long()).abs().max().item()
            qerr["qmega"] = max(qerr["qmega"], err)
            qmax = 127 if pack.bits <= 8 else 511
            eq = (torch.equal(codes, want), torch.equal(codes, chain))
            saturated = (want.abs() == qmax).float().mean().item()
            say(f"phase check qmega {mode} extreme C54 N={n} {h}x{w}: recon codes torch.equal "
                f"to the plain version {eq[0]} (max {err} codes apart) and to the qconv kernel "
                f"chain {eq[1]}; share of codes at +-qmax {saturated:.3f}, nonzero "
                f"{(want != 0).float().mean().item():.3f}")
            if not all(eq):
                fail(f"the quantized megakernel ({mode}, extreme C54, N={n} {h}x{w}) differs")
            if saturated == 0:
                fail(f"qmega ({mode}, extreme): no code saturates, the check would see nothing")
    del x, codes, want, img, chain, qref, wbuf, plain_w, ext

    # 4. times at N = 1024 C54
    timing = {}
    for kind in ("bsconv", "sfb", "dsconv"):
        kern, plain, lib = runners(kind, torch)
        x, w = operands(kind, TIMING_N, 54, g, torch)
        got, want, yard = kern(x, w), plain(x, w), lib(x, w)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, **TOL):
            fail(f"{kind} disagrees with its plain version at N={TIMING_N}")
        max_err[kind] = max(max_err[kind], (got - want).abs().max().item())
        lib_err = (yard - want).abs().max().item()
        ms = median_ms(lambda: kern(x, w), torch)
        plain_ms = median_ms(lambda: plain(x, w), torch)
        lib_ms = median_ms(lambda: lib(x, w), torch)
        nbytes, flops = work(kind, TIMING_N, 54)
        t_bytes, t_flops = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
        timing[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=max(t_bytes, t_flops),
                            bound_by="bytes" if t_bytes >= t_flops else "operations")
        say(f"phase time {kind} N={TIMING_N} C54: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cuDNN {lib_ms:.4f} ms (max_abs vs plain {lib_err:.2e}), "
            f"bound {timing[kind]['bound_ms']:.4f} ms by {timing[kind]['bound_by']} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        del x, w, got, want, yard
    tree, wbuf = mega_operands(54, g, torch)
    wts = mk.unpack_weights(wbuf, mk.WeightLayout(3, 54, cfg.out_channels, cfg.n_sfb))
    x = torch.rand((TIMING_N, 32, 32, 3), generator=g).cuda()

    def mega():
        return mk.mega_fused(x, wbuf, width=54, n_sfb=cfg.n_sfb, out_channels=cfg.out_channels)

    got, want, yard = mega(), mega_ref(x, wts), mega_library(x, wts, torch)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, **CHAIN_TOL):
        fail(f"mega disagrees with its plain version at N={TIMING_N}")
    if not torch.equal(mk.essr_forward_megakernel(tree, x, cfg, width=54),
                       essr_forward_kernels(tree, x, cfg, width=54)):
        fail(f"mega is not torch.equal to the layer chain at N={TIMING_N}")
    max_err["mega"] = max(max_err["mega"], (got - want).abs().max().item())
    ms = median_ms(mega, torch)
    plain_ms = median_ms(lambda: mega_ref(x, wts), torch)
    lib_ms = median_ms(lambda: mega_library(x, wts, torch), torch)
    sum_ms = timing["bsconv"]["ms"] + cfg.n_sfb * timing["sfb"]["ms"] + timing["dsconv"]["ms"]
    sizing = mk.group_report(54, 32, cfg.scale, cfg.n_sfb)
    flops = TIMING_N * sizing["flops_per_patch"]
    nbytes = TIMING_N * sizing["bytes_per_patch"] + sizing["weight_bytes"]
    t_bytes, t_flops = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
    timing["mega"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=max(t_bytes, t_flops),
                          bound_by="bytes" if t_bytes >= t_flops else "operations")
    say(f"phase time mega N={TIMING_N} C54: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"layer chain {sum_ms:.4f} ms (the per-op kernels' times summed), "
        f"cuDNN {lib_ms:.4f} ms (max_abs vs plain "
        f"{(yard - want).abs().max().item():.2e}), bound {timing['mega']['bound_ms']:.4f} ms "
        f"by {timing['mega']['bound_by']} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
        f"sizing {json.dumps(sizing)}, resident clusters "
        f"{mk.resident_clusters(54, 32, cfg.scale, cfg.n_sfb)}")
    timing["mega"]["layer_chain_ms"] = sum_ms
    for width in (54, 27):           # both through their entry points, pixel shuffle included
        ms_group = median_ms(lambda: mk.essr_forward_megakernel(tree, x, cfg, width=width), torch)
        ms_layer = median_ms(lambda: essr_forward_kernels(tree, x, cfg, width=width), torch)
        say(f"phase time mega vs layer chain N={TIMING_N} C{width} 32x32: "
            f"essr_forward_megakernel {ms_group:.4f} ms, essr_forward_kernels {ms_layer:.4f} ms "
            f"({ms_group / ms_layer:.3f}x)")
    del tree, wbuf, wts, x, got, want, yard

    # 8. the quantized kernels' times at N = 1024 C54
    qtiming = {m: {} for m in QUANT_MODES}
    for mode in QUANT_MODES:
        _, pack, qs, _ = quant[mode]
        x = torch.rand((TIMING_N, 32, 32, 3), generator=g).cuda()
        stages = quant_stages(qs[54], x, pack.bits, torch)
        for kind in QKERNELS:
            _, kern, plain, inp = next(st for st in stages if st[0] == kind)
            got, want = kern(inp), plain(inp)
            qerr[kind] = max(qerr[kind], (got.long() - want.long()).abs().max().item())
            if not torch.equal(got, want):
                fail(f"{kind} ({mode}) differs from its plain version at N={TIMING_N}")
            ms = median_ms(lambda: kern(inp), torch)
            plain_ms = median_ms(lambda: plain(inp), torch)
            small = {}
            if kind == "quantize":     # a ~5 us kernel: its time from a CUDA graph
                cold = cold_inputs(inp, torch)
                small = dict(evented_ms=ms, host_ms=host_ms(lambda: kern(inp), torch),
                             warm_ms=graph_ms(lambda: kern(inp), torch))
                ms = graph_ms([lambda v=v: kern(v) for v in cold], torch)
                plain_ms = graph_ms([lambda v=v: plain(v) for v in cold], torch)
                del cold
            nbytes, iops, fops = qwork(kind, TIMING_N, 54, pack.bits)
            divs, counted = qdivisions(kind, qs[54], inp, pack.bits, torch)
            fops += divs * FDIV_RN_INSTRUCTIONS - counted
            int_peak = int_peak_for(name, pack.bits)
            t_bytes = nbytes / peak_bw * 1e3
            # each rounded fp32 operation is one instruction: half the fp32
            # peak, which counts an FFMA as two
            t_ops = (iops / int_peak + fops / (peak_flops / 2)) * 1e3
            qtiming[mode][kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                                       library_ms=None, **small)
            how = ""
            if small:
                how = (f" (device time a call from a CUDA graph of {GRAPH_LAUNCHES} launches "
                       f"rotating over inputs past the L2; on one L2-resident input "
                       f"{small['warm_ms']:.4f} ms; evented median {small['evented_ms']:.4f} ms; "
                       f"host time a wrapper call {small['host_ms']:.4f} ms; plain from a "
                       f"graph too)")
            say(f"phase time q* {kind} {mode} N={TIMING_N} C54: kernel {ms:.4f} ms{how}, plain "
                f"{plain_ms:.4f} ms, library none, bound {max(t_bytes, t_ops):.4f} ms by "
                f"{qtiming[mode][kind]['bound_by']} ({nbytes / 1e6:.1f} MB, {iops / 1e9:.2f} G "
                f"integer ops at {int_peak / 1e12:g} T/s, {fops / 1e9:.2f} G rounded fp32 ops "
                f"at {peak_flops / 2e12:g} T/s, of them {divs / 1e6:.1f} M divisions at "
                f"{FDIV_RN_INSTRUCTIONS} instructions each)")
        del x, stages, kern, plain, inp, got, want
    torch.cuda.empty_cache()

    # 12. the quantized megakernel's time at N = 1024 C54, beside the chain
    qmega_timing = {}
    for mode in QUANT_MODES:
        qcfg, pack, qs, _ = quant[mode]
        q = qs[54]
        wbuf = mk.pack_qweights(q, pack.bits)
        plain_w = mk.unpack_qweights(wbuf, mk.QWeightLayout(3, 54, qcfg.out_channels, qcfg.n_sfb,
                                                            pack.bits))
        x = torch.rand((TIMING_N, 32, 32, 3), generator=g).cuda()

        def kern():
            return mk.qmega_fused(x, wbuf, q["consts"], width=54, n_sfb=qcfg.n_sfb,
                                  out_channels=qcfg.out_channels, bits=pack.bits)

        got = kern()
        want = qmega_ref(x, plain_w, q["consts"], got.dtype)
        if not torch.equal(got, want):
            fail(f"qmega ({mode}) differs from its plain version at N={TIMING_N}")
        ms = median_ms(kern, torch)
        plain_ms = median_ms(lambda: qmega_ref(x, plain_w, q["consts"], got.dtype), torch)
        qrep = mk.qgroup_report(54, 32, qcfg.scale, qcfg.n_sfb, pack.bits)
        iops, fops = TIMING_N * qrep["int_ops_per_patch"], TIMING_N * qrep["fp_ops_per_patch"]
        divs, counted = qdivisions("qmega", q, x, pack.bits, torch)
        fops += divs * FDIV_RN_INSTRUCTIONS - counted
        nbytes = TIMING_N * qrep["bytes_per_patch"] + qrep["weight_bytes"]
        int_peak = int_peak_for(name, pack.bits, fp16=True)
        t_bytes = nbytes / peak_bw * 1e3
        t_ops = (iops / int_peak + fops / (peak_flops / 2)) * 1e3
        chain_ms = sum(qtiming[mode][k]["ms"] * (qcfg.n_sfb if k == "qsfb" else 1)
                       for k in QKERNELS)
        clusters = mk.qresident_clusters(54, 32, qcfg.scale, qcfg.n_sfb, pack.bits)
        qmega_timing[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                                  bound_by="bytes" if t_bytes >= t_ops else "operations",
                                  library_ms=None, layer_chain_ms=chain_ms)
        say(f"phase time qmega {mode} N={TIMING_N} C54: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, qconv chain {chain_ms:.4f} ms (quantize + qbsconv + "
            f"{qcfg.n_sfb} x qsfb + qdsconv, phase 8 of this run), library none, bound "
            f"{max(t_bytes, t_ops):.4f} ms by {qmega_timing[mode]['bound_by']} ("
            f"{nbytes / 1e6:.1f} MB, {iops / 1e9:.2f} G integer ops at {int_peak / 1e12:g} T/s, "
            f"{fops / 1e9:.2f} G rounded fp32 ops at {peak_flops / 2e12:g} T/s, of them "
            f"{divs / 1e6:.1f} M divisions at {FDIV_RN_INSTRUCTIONS} instructions each); "
            f"resident clusters "
            f"{clusters}, {qrep['smem_bytes']} B of shared memory per block, "
            f"{qrep['threads']} threads")
        del x, got, want, wbuf, plain_w
    torch.cuda.empty_cache()

    # 5. the main path
    engine = SREngine.from_config(cfg, seed=SEED, device="cuda")
    t0 = time.perf_counter()
    engine.warmup((1080, 1920))
    say(f"phase warmup: 1920x1080 -> 7680x4320 in {time.perf_counter() - t0:.3f} s")
    frames = [mixed_frame(SEED + i) for i in range(3)]
    expect = {k: 0 for k in launch_counts()}
    reset_launch_counts()
    layer_ids, lats, served = [], [], []
    for i, f in enumerate(frames):
        r = engine.upscale(f)
        served.append(r)
        if r.backend != "cuda":
            fail(f"frame {i} served by {r.backend!r}, not the kernels")
        if tuple(r.image.shape) != (4320, 7680, 3) or not bool(torch.isfinite(r.image).all()):
            fail(f"frame {i}: image {tuple(r.image.shape)} not a finite 4320x7680x3")
        buckets = sum(1 for k in (1, 2) if r.counts[k] > 0)
        expect["bsconv"] += buckets
        expect["sfb"] += cfg.n_sfb * buckets
        expect["dsconv"] += buckets
        expect["edge"] += 1               # the frame's scores
        say(f"phase frame {i}: latency {r.latency_s * 1e3:.2f} ms, counts "
            f"(bilinear, C27, C54) {r.counts}, mac_saving {r.mac_saving:.4f}")
        layer_ids.append(r.ids)
        lats.append(r.latency_s)
        if i == 0:
            r0 = r
    launches = launch_counts()
    say(f"phase launches over 3 frames: {launches} (expected {expect})")
    if launches != expect or min(launches[k] for k in ("bsconv", "sfb", "dsconv", "edge")) == 0:
        fail("the main path did not launch every kernel as its routing requires")
    layer_served = list(served)
    say(f"phase summary: {json.dumps(summarize_stats(served))}")
    profile_frame(engine, frames[1], statistics.median(lats), torch)
    ref_engine = SREngine(engine.model, backend="ref", device="cuda")
    refs = [ref_engine.upscale(f) for f in frames]
    rr = refs[0]
    ids_equal = all(np.array_equal(a, b.ids) for a, b in zip(layer_ids, refs))
    diff = (r0.image - rr.image).abs().max().item()
    close = torch.allclose(r0.image, rr.image, **CHAIN_TOL)
    say(f"phase ref: ids equal {ids_equal}, image max_abs {diff:.3e} "
        f"(rtol {CHAIN_TOL['rtol']:g} atol {CHAIN_TOL['atol']:g}) {'ok' if close else 'MISMATCH'}, "
        f"ref latency {rr.latency_s * 1e3:.2f} ms")
    if not (ids_equal and close):
        fail("the kernel frame disagrees with the plain-model frame")
    del r0

    # 6. group fusion
    group = SREngine(engine.model, plan=ExecutionPlan(fusion="group"), device="cuda")
    t0 = time.perf_counter()
    group.warmup((1080, 1920))
    say(f"phase group warmup: 1920x1080 -> 7680x4320 in {time.perf_counter() - t0:.3f} s")
    expect = {k: 0 for k in launch_counts()}
    reset_launch_counts()
    glats, served = [], []
    for i, f in enumerate(frames):
        r = group.upscale(f)
        served.append(r)
        if r.backend != "cuda":
            fail(f"group frame {i} served by {r.backend!r}, not the kernels")
        if tuple(r.image.shape) != (4320, 7680, 3) or not bool(torch.isfinite(r.image).all()):
            fail(f"group frame {i}: image {tuple(r.image.shape)} not a finite 4320x7680x3")
        expect["mega"] += sum(1 for k in (1, 2) if r.counts[k] > 0)
        expect["edge"] += 1
        ids_equal = bool(np.array_equal(r.ids, layer_ids[i]))
        diff = (r.image - refs[i].image).abs().max().item()
        close = torch.allclose(r.image, refs[i].image, **CHAIN_TOL)
        say(f"phase group frame {i}: latency {r.latency_s * 1e3:.2f} ms (layer frame "
            f"{lats[i] * 1e3:.2f} ms), counts {r.counts}, ids equal to the layer frame's "
            f"{ids_equal}, image vs ref max_abs {diff:.3e} {'ok' if close else 'MISMATCH'}")
        if not (ids_equal and close):
            fail(f"group frame {i} disagrees with the layer frame's routing or the ref image")
        glats.append(r.latency_s)
    launches_group = launch_counts()
    say(f"phase group launches over 3 frames: {launches_group} (expected {expect})")
    if launches_group != expect or launches_group["mega"] == 0:
        fail("group fusion did not launch the megakernel once per non-empty conv bucket")
    say(f"phase group summary: {json.dumps(summarize_stats(served))}")
    profile_frame(group, frames[1], statistics.median(glats), torch)

    # 9. quantized serving, both modes
    from repro_torch.kernels.qconv import essr_forward_qref
    from repro_torch.models.layers import bilinear_resize
    qlaunches, qglaunches = {}, {}
    for mode in QUANT_MODES:
        t0 = time.perf_counter()
        qeng = SREngine(engine.model, plan=ExecutionPlan(quant=mode), device="cuda")
        say(f"phase quant {mode} calibration: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        qeng.warmup((1080, 1920))
        say(f"phase quant {mode} warmup: {time.perf_counter() - t0:.3f} s")
        expect = {k: 0 for k in launch_counts()}
        reset_launch_counts()
        qlats, qimgs = [], []
        for i, f in enumerate(frames):
            r = qeng.upscale(f)
            if r.backend != f"cuda-{mode}":
                fail(f"quant frame {i} served by {r.backend!r}, not cuda-{mode}")
            if tuple(r.image.shape) != (4320, 7680, 3) or not bool(torch.isfinite(r.image).all()):
                fail(f"quant frame {i}: image {tuple(r.image.shape)} not a finite 4320x7680x3")
            buckets = sum(1 for k in (1, 2) if r.counts[k] > 0)
            for k, per in (("quantize", 1), ("qbsconv", 1), ("qsfb", cfg.n_sfb), ("qdsconv", 1)):
                expect[k] += per * buckets
            expect["edge"] += 1
            ids_equal = bool(np.array_equal(r.ids, layer_ids[i]))
            qlats.append(r.latency_s)
            qimgs.append(r)
            say(f"phase quant {mode} frame {i}: latency {r.latency_s * 1e3:.2f} ms (layer "
                f"frame {lats[i] * 1e3:.2f} ms), counts {r.counts}, ids equal to the fp32 "
                f"frame's {ids_equal}")
            if not ids_equal:
                fail(f"quant frame {i} ({mode}) routed differently from the fp32 frame")
        qlaunches[mode] = launch_counts()
        say(f"phase quant {mode} launches over 3 frames: {qlaunches[mode]} (expected {expect})")
        if qlaunches[mode] != expect or min(qlaunches[mode][k] for k in QKERNELS) == 0:
            fail(f"quant serving ({mode}) did not launch every quantized kernel as its "
                 f"routing requires")
        # every frame equals its routed buckets through the integer reference
        with torch.inference_mode():
            for i, (f, r) in enumerate(zip(frames, qimgs)):
                frame = torch.from_numpy(f).cuda()
                geom = qeng.plan.geometry(1080, 1920, cfg.scale, "cuda")
                patches = geom.extract(frame)
                out = torch.zeros((geom.n, 128, 128, 3), device="cuda")
                for k, width in enumerate(cfg.subnet_widths()):
                    idx = torch.from_numpy(np.flatnonzero(r.ids == k)).cuda()
                    if idx.numel() == 0:
                        continue
                    batch = patches.index_select(0, idx)
                    out[idx] = (bilinear_resize(batch, cfg.scale) if width == 0 else
                                essr_forward_qref(qeng.params, batch, cfg, width,
                                                  pack=qeng.qpack))
                want = geom.fuse_average(out)
                if not torch.equal(r.image, want):
                    err = (r.image - want).abs().max().item()
                    fail(f"quant frame {i} ({mode}) differs from its buckets through "
                         f"essr_forward_qref by up to {err:.3e}")
                say(f"phase quant {mode} frame {i}: equal (torch.equal) to its routed buckets "
                    f"through essr_forward_qref; PSNR against the fp32 'ref' frame "
                    f"{psnr(r.image, refs[i].image, torch):.2f} dB (reported, random weights)")
        say(f"phase quant {mode} summary: {json.dumps(summarize_stats(qimgs))}")
        profile_frame(qeng, frames[1], statistics.median(qlats), torch)

        # 13. the same frames under quant x group fusion: the quantized megakernel
        geng = SREngine(engine.model, plan=ExecutionPlan(quant=mode, fusion="group"),
                        device="cuda")
        if geng.qpack != qeng.qpack:
            fail(f"the quant {mode} group engine calibrated another pack than the layer engine")
        t0 = time.perf_counter()
        geng.warmup((1080, 1920))
        say(f"phase quant {mode} group warmup: {time.perf_counter() - t0:.3f} s")
        expect = {k: 0 for k in launch_counts()}
        reset_launch_counts()
        qglats, served = [], []
        for i, f in enumerate(frames):
            r = geng.upscale(f)
            served.append(r)
            if r.backend != f"cuda-{mode}":
                fail(f"quant group frame {i} served by {r.backend!r}, not cuda-{mode}")
            if tuple(r.image.shape) != (4320, 7680, 3) or not bool(torch.isfinite(r.image).all()):
                fail(f"quant group frame {i}: image {tuple(r.image.shape)} not a finite "
                     f"4320x7680x3")
            expect["qmega"] += sum(1 for k in (1, 2) if r.counts[k] > 0)
            expect["edge"] += 1
            ids_equal = bool(np.array_equal(r.ids, layer_ids[i]))
            same = torch.equal(r.image, qimgs[i].image)
            say(f"phase quant {mode} group frame {i}: latency {r.latency_s * 1e3:.2f} ms (quant "
                f"layer frame {qlats[i] * 1e3:.2f} ms), counts {r.counts}, ids equal to the fp32 "
                f"frame's {ids_equal}, image torch.equal to the quant layer frame's {same}")
            if not (ids_equal and same):
                fail(f"quant group frame {i} ({mode}) disagrees with the fp32 routing or the "
                     f"quant layer frame")
            qglats.append(r.latency_s)
        qglaunches[mode] = launch_counts()
        say(f"phase quant {mode} group launches over 3 frames: {qglaunches[mode]} "
            f"(expected {expect})")
        if qglaunches[mode] != expect or qglaunches[mode]["qmega"] == 0:
            fail(f"quant group serving ({mode}) did not launch the quantized megakernel once "
                 f"per non-empty conv bucket and nothing else")
        say(f"phase quant {mode} group summary: {json.dumps(summarize_stats(served))}")
        profile_frame(geng, frames[1], statistics.median(qglats), torch)
        del qeng, geng, qimgs, out, patches
        torch.cuda.empty_cache()
    del refs

    # 16. Table I's larger patches and one past it: group frames at patches
    # 48, 64 and 80 (recompute-halo windows) against layer frames, fp32 and
    # both quant modes
    for patch in (48, 64, 80):
        for qmode in (None,) + QUANT_MODES:
            kw = dict(patch=patch, overlap=2, quant=qmode)
            layer_p = SREngine(engine.model, plan=ExecutionPlan(**kw), device="cuda")
            group_p = SREngine(engine.model, plan=ExecutionPlan(**kw, fusion="group"),
                               device="cuda")
            a = layer_p.upscale(frames[0])
            reset_launch_counts()
            b = group_p.upscale(frames[0])
            counts = launch_counts()
            kern = "qmega" if qmode else "mega"
            buckets = sum(1 for k in (1, 2) if b.counts[k] > 0)
            same, ids_equal = torch.equal(a.image, b.image), bool(np.array_equal(a.ids, b.ids))
            sizing = (mk.qgroup_report(54, patch, cfg.scale, cfg.n_sfb,
                                       8 if qmode == "int8" else 10) if qmode
                      else mk.group_report(54, patch, cfg.scale, cfg.n_sfb))
            again = ""
            if patch == 80:             # later calls: the first pays packing and sizing
                later = [(layer_p.upscale(frames[0]), group_p.upscale(frames[0]))
                         for _ in range(3)]
                again = ("; later calls in turns: group " + ", ".join(
                    f"{b2.latency_s * 1e3:.2f}" for _, b2 in later) + " ms, layer " + ", ".join(
                    f"{a2.latency_s * 1e3:.2f}" for a2, _ in later) + " ms, torch.equal "
                    f"{all(torch.equal(a2.image, b2.image) for a2, b2 in later)}")
                same = same and all(torch.equal(a2.image, b2.image) for a2, b2 in later)
            say(f"phase patch{patch} {qmode or 'fp32'}: group frame {b.latency_s * 1e3:.2f} ms "
                f"(first call), layer frame {a.latency_s * 1e3:.2f} ms, counts {b.counts}, "
                f"{kern} launches {counts[kern]} (expected {buckets}), edge launches "
                f"{counts['edge']} (expected 1), ids equal {ids_equal}, image torch.equal "
                f"{same}{again}; C54 sizing (windows {sizing['windows']} of {sizing['window']}, "
                f"work factor {sizing['work_factor']:.3f}) {json.dumps(sizing)}")
            want = {**dict.fromkeys(counts, 0), kern: buckets, "edge": 1}
            if not (same and ids_equal and buckets > 0 and counts == want):
                fail(f"the patch-{patch} group frame ({qmode or 'fp32'}) disagrees with the "
                     f"layer frame or did not launch {kern} once per non-empty conv bucket")
            if patch == 80 and qmode is None:
                profile_frame(group_p, frames[0],
                              statistics.median(b2.latency_s for _, b2 in later), torch)
            del layer_p, group_p, a, b
        torch.cuda.empty_cache()

    # 16b. the windowed megakernels' time at 80x80 beside their layer chains,
    # N = PATCH80_N C54 patches (2 x 2 windows of 52, one launch)
    tree80, _ = mega_operands(54, g, torch)
    x80 = torch.rand((PATCH80_N, 80, 80, 3), generator=g).cuda()
    with torch.inference_mode():
        group80 = mk.essr_forward_megakernel(tree80, x80, cfg, width=54)
        if not torch.equal(group80, essr_forward_kernels(tree80, x80, cfg, width=54)):
            fail("the windowed megakernel is not torch.equal to the layer chain at 80x80")
        del group80
        t_group = median_ms(lambda: mk.essr_forward_megakernel(tree80, x80, cfg, width=54), torch)
        t_layer = median_ms(lambda: essr_forward_kernels(tree80, x80, cfg, width=54), torch)
        say(f"phase patch80 time fp32 N={PATCH80_N} C54 80x80: essr_forward_megakernel "
            f"{t_group:.4f} ms ({mk.group_report(54, 80, cfg.scale, cfg.n_sfb)['windows']} "
            f"windows a patch, one launch), essr_forward_kernels {t_layer:.4f} ms "
            f"({t_group / t_layer:.3f}x); torch.equal")
        for mode in QUANT_MODES:
            qcfg, pack, _, qtree = quant[mode]
            got = mk.essr_forward_qmegakernel(qtree, x80, qcfg, 54, pack=pack)
            if not torch.equal(got, essr_forward_qkernels(qtree, x80, qcfg, 54, pack=pack)):
                fail(f"the windowed quantized megakernel ({mode}) is not torch.equal to the "
                     f"qconv chain at 80x80")
            del got
            t_group = median_ms(
                lambda: mk.essr_forward_qmegakernel(qtree, x80, qcfg, 54, pack=pack), torch)
            t_layer = median_ms(
                lambda: essr_forward_qkernels(qtree, x80, qcfg, 54, pack=pack), torch)
            say(f"phase patch80 time {mode} N={PATCH80_N} C54 80x80: essr_forward_qmegakernel "
                f"{t_group:.4f} ms, essr_forward_qkernels {t_layer:.4f} ms "
                f"({t_group / t_layer:.3f}x); torch.equal")
    del tree80, x80
    torch.cuda.empty_cache()

    # 14. the edge-score kernel on the serving path: the layer frames of
    # phase 5 scored through it; their scores against the plain edge_score of
    # the same patches, and the routing ids from both equal
    from repro_torch.core import subnet_policy as sp
    from repro_torch.core.edge_score import edge_score
    from repro_torch.kernels.edge import edge_score_fused
    geom = engine.plan.geometry(1080, 1920, cfg.scale, "cuda")
    t1, t2 = engine.plan.t1, engine.plan.t2
    with torch.inference_mode():
        patches = [geom.extract(torch.from_numpy(f).cuda()) for f in frames]
        edge_err = 0.0
        for i, (p, r) in enumerate(zip(patches, layer_served)):
            want = edge_score(p)
            served_scores = torch.from_numpy(np.asarray(r.scores)).cuda()
            err = (served_scores - want).abs().max().item()
            edge_err = max(edge_err, err)
            close = torch.allclose(served_scores, want, rtol=1e-4, atol=1e-3)
            plain = want.cpu().numpy()
            differ = np.flatnonzero(r.ids != sp.decide(plain, t1, t2))
            near = float(np.min(np.minimum(np.abs(plain - t1), np.abs(plain - t2))))
            say(f"phase check edge frame {i}: the served scores of {p.shape[0]} patches "
                f"{p.shape[1]}x{p.shape[2]} (edge kernel) max_abs vs plain {err:.3e} (rtol 1e-4 "
                f"atol 1e-3) {'ok' if close else 'MISMATCH'}; routing ids from them differ from "
                f"the plain scores' on {differ.size} patches (expected 0; the nearest plain "
                f"score lies {near:.3e} from t1/t2)")
            if not (close and differ.size == 0):
                fail("the edge kernel on the serving path disagrees with its plain version or "
                     "moves the routing")
        p = patches[0]
        got, want = edge_score_fused(p), edge_score(p)
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
            fail("the edge kernel disagrees with its plain version on frame 0's patches")
        ev_ms = median_ms(lambda: edge_score_fused(p), torch)
        cold = cold_inputs(p, torch)
        ms = graph_ms([lambda v=v: edge_score_fused(v) for v in cold], torch)
        warm_ms = graph_ms(lambda: edge_score_fused(p), torch)
        plain_ms = graph_ms([lambda v=v: edge_score(v) for v in cold], torch)
        call_ms = host_ms(lambda: edge_score_fused(p), torch)
        del cold
        n_p, h_p, w_p = p.shape[0], p.shape[1], p.shape[2]
        nbytes = 4 * (p.numel() + n_p)
        flops = n_p * (6 * h_p * w_p + 8 * (h_p - 2) * (w_p - 2))
        t_bytes, t_flops = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
        edge_timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_flops),
                           bound_by="bytes" if t_bytes >= t_flops else "operations",
                           library_ms=None, warm_ms=warm_ms, evented_ms=ev_ms, host_ms=call_ms)
        say(f"phase time edge N={n_p} {h_p}x{w_p}: kernel {ms:.4f} ms (device time a call from "
            f"a CUDA graph of {GRAPH_LAUNCHES} launches rotating over inputs past the L2; on "
            f"one L2-resident input {warm_ms:.4f} ms; evented median {ev_ms:.4f} ms; host "
            f"time a wrapper call {call_ms:.4f} ms), plain {plain_ms:.4f} ms (from a graph), "
            f"library none, bound {edge_timing['bound_ms']:.4f} ms by {edge_timing['bound_by']} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); launches on the main path "
            f"{launches['edge']} (one a frame)")
        del patches, p, got, want

    fused_report = serving_phases(engine, frames, cfg, torch)
    pool_report = pool_phase(engine, frames, torch)
    stream_report = stream_phase(engine, torch)
    fault_report = fault_phase(engine, torch)
    shard_report = shard_phase(engine, frames, torch)
    train_report = train_phase(torch)
    baseline_report = baselines_phase(
        next(r for r in fused_report if r["mode"] == "fp32 layer"), torch)
    supervisor_report = supervisor_phase(torch)
    examples_report = examples_phase()
    # 30-32. the LM side: no kernel of the port lies on it, so every count
    # must stay 0 through it. The SR phases' engines, frames and results go
    # first (lm_phase drops the graph caches), so its peak is its own.
    del engine, ref_engine, group, frames, served, layer_served, rr, r, quant
    reset_launch_counts()
    lm_report, check_model = lm_phase(torch)
    lm_report["archs"] = lm_archs_phase(torch)
    # 32. LM training, once phase 30's weights and caches are freed
    lm_train_report = lm_train_phase(check_model, torch)
    del check_model
    lm_launches = {k: v for k, v in launch_counts().items() if v}
    say(f"phase lm launches: the port's kernels launched {lm_launches or 'none'} through "
        f"phases 30-32 (their matmuls are cuBLAS, their attention and scans PyTorch ops, "
        f"their backward autograd's)")
    if lm_launches:
        fail(f"the LM path launched the port's kernels: {lm_launches}")
    # 33. the dry run, against phase 32's step, and the knobs on the card
    dryrun_report = dryrun_phase(ROOT / "build" / "dryrun", lm_train_report, torch)
    dry_launches = {k: v for k, v in launch_counts().items() if v}
    if dry_launches:
        fail(f"the dry run's phase launched the port's kernels: {dry_launches}")

    # no phase without a FaultPlan moved the ladder
    moved = [(phase, g.level, g.summary()["by_kind"]) for phase, g, faults in GUARDS
             if faults is None and (g.level != 0 or any(
                 e["kind"] in ("degrade", "watchdog", "failure") for e in g.events))]
    say(f"phase ladder: {len(GUARDS)} engines, {sum(f is None for _, _, f in GUARDS)} without a "
        f"FaultPlan, every one at level 0 with no degrade or watchdog event: {not moved}")
    if moved:
        fail(f"engines without a FaultPlan stepped the ladder: {moved}")

    # 10. tables and the result
    say("tpu_kernels: " + json.dumps([dict(name=n, tpu=loc, status=s)
                                      for n, loc, s in TPU_KERNELS]))
    replaces = {n: loc for n, loc, _ in TPU_KERNELS}
    rows = [dict(name=k, route="cuda", source=f"src/repro_torch/csrc/{k}.cu",
                 replaces=replaces[f"{k}_fused"], launches=launches[k],
                 max_abs_err=max_err[k], **timing[k]) for k in ("bsconv", "sfb", "dsconv")]
    rows.append(dict(name="essr_forward_megakernel", route="cuda",
                     source="src/repro_torch/csrc/mega.cu",
                     replaces=replaces["essr_forward_megakernel"],
                     launches=launches_group["mega"], max_abs_err=max_err["mega"],
                     **timing["mega"]))
    for k in QKERNELS:               # timed per mode; the row's own keys are int8's
        row = dict(name=f"{k}_fused", route="cuda",
                   source=f"src/repro_torch/csrc/"
                          f"{dict(qbsconv='bsconv', qsfb='qsfb', qdsconv='dsconv').get(k, 'qconv')}.cu",
                   replaces=replaces[f"{k}_fused"], launches=qlaunches["int8"][k],
                   max_abs_err=qerr[k], **qtiming["int8"][k])
        row.update({f"fxp10_{key}": v for key, v in qtiming["fxp10"][k].items()})
        row["fxp10_launches"] = qlaunches["fxp10"][k]
        rows.append(row)
    row = dict(name="essr_forward_qmegakernel", route="cuda",
               source="src/repro_torch/csrc/qmega.cu",
               replaces=replaces["essr_forward_qmegakernel"], launches=qglaunches["int8"]["qmega"],
               max_abs_err=qerr["qmega"], **qmega_timing["int8"])
    row.update({f"fxp10_{key}": v for key, v in qmega_timing["fxp10"].items()})
    row["fxp10_launches"] = qglaunches["fxp10"]["qmega"]
    rows.append(row)
    rows.append(dict(name="edge_score_fused", route="cuda", source="src/repro_torch/csrc/edge.cu",
                     replaces=replaces["edge_score_fused"], launches=launches["edge"],
                     max_abs_err=edge_err, **edge_timing))
    say(card)                        # the card again, beside the results
    say("fused: " + json.dumps(fused_report))
    say("streams: " + json.dumps({"pools": pool_report, "streams": stream_report,
                                  "faults": fault_report}))
    say("train: " + json.dumps({"shards": shard_report, "train": train_report}))
    say("baselines: " + json.dumps({"baselines": baseline_report,
                                    "supervisor": supervisor_report,
                                    "examples": examples_report}))
    say("lm: " + json.dumps(lm_report))
    say("lm_train: " + json.dumps(lm_train_report))
    say("dryrun: " + json.dumps(dryrun_report))
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
