#!/usr/bin/env python3
'''
Drives the PyTorch port (tcow_tpu_torch) on one NVIDIA GPU and checks it:

  1. device line: the card's name and power limit, torch / CUDA / nvcc versions, and the
     time to build tcow_tpu_torch/ops/csrc/fused_attention.cu (the attention cores of K1
     to K6) and gemm_sm90.cu (their GEMMs and row reductions), one nvcc each, started
     together, with each source's own build time;
  2. each kernel against its plain PyTorch version on the card, at the shapes of the
     inference and training paths (bf16), plus float32 cases; for K4 also the
     gradients of the differentiable fused_attention against autograd through the plain
     forward; for K2, K3, K5 and K6 both training geometries in bf16 and in float32, and
     K6's weight gradients identical across two runs;
  3. the inference slice at full width: a seeded ViT-B/16 seeker (depth 12, T=30,
     240x320, causal_attention=1, bf16) written to an .npz, loaded back through
     load_networks, and 3 InferenceEngine.run_plugin requests of 2 clips each, with the
     kernel launch counts read around them; outputs are checked for shape, finiteness,
     metric schema, and against the same engine with the plain attention swapped in;
  4. inference times: per request, per forward, and per kernel call beside its plain
     version, one PyTorch library call computing the same function, and its bound;
  5. the training slice at full width (2 clips, 3 queries, T=30 at 240x320, M=36, bf16,
     per-block remat, drop-path 0.1, AdamW, clip 0.3) under each pairing of an attention
     backward mode with its remat policy, the step of record first (attention_bwd
     'kernel_x', remat_policy 'dots_nb_out', as bench.py:36-41 of the JAX package):
     init_train_state -> make_optimizer -> make_train_step, one warm-up and 2 timed
     steps, each checked for a finite loss, an applied update, changed parameters and the
     launches of every kernel (PAIRINGS);
  6. training parity with drop-path off, for each mode (first-step loss and concatenated
     gradient: bf16 kernel path and bf16 plain path against the f32 plain path; f32
     kernel vs plain at depth 2);
  7. training times: every kernel per call at the training shapes beside its plain
     version, a library yardstick and its bound, and kernel-path vs plain-path steps;
  8. the time-calibrated rope path (the rope256 configuration: temporal_rope=1,
     rope_time_coords=1, otherwise the configuration of record), whose temporal calls run
     the rope kernels K1r ... K6r: each against its plain version at the temporal
     inference and training shapes (bf16 and float32, row positions and per-row frame
     times drawn as the JAX package's augmentations draw them), K6r twice, bit-equal, and
     the gradients of the differentiable call per mode (phase rope_kernels_vs_plain);
     inference through load_networks -> run_plugin with frame_times, 12 K1r + 12 K1 per
     request and no other kernel, against the plain path, stride-2 times changing the
     output and time_embed not (rope_slice); the training step under each pairing, per
     step 12 rope + 12 plain launches of each kernel of the pairing (rope_train), its
     parity (rope_train_parity); and every rope kernel timed beside its plain version,
     its library yardstick, its bound and the kernel without rope (rope_times);
  9. the bf16 attention core of K1-K3 and K1r-K3r (tensor cores) launched alone through
     tcow_attn_core at the nine shapes the main paths give it (CORE_SHAPES): against its
     plain version, the same bits on a second run (and K1 or K3 through its wrapper), and
     timed beside the plain version, SDPA (or matmul + softmax + matmul for the
     probabilities) and its bound (phase attn_core_times);
 10. the bf16 backward core of K4-K6 and K4r-K6r (tensor cores) launched alone through
     tcow_attn_bwd at training 1800x30 causal, 180x301 and rope 1800x30 with frame times
     (BWD_CORE_SHAPES): attn, dq, dk and dv against the plain core in f32, the same bits
     on a second run, and timed beside the plain core, SDPA's forward and autograd
     backward and its bound (phase attn_bwd_times);
 11. the bf16 GEMMs of K1-K6 and K1r-K6r (wgmma fed by TMA) launched alone through the
     chains' own helpers at every shape the main paths give them (GEMM_SHAPES,
     WGRAD_SHAPES, COLSUM_SHAPES; 54,000 / 54,180 training and 18,000 / 18,060 inference
     rows): gemm_bias, wgrad and colsum against the f32 result of the same bf16 operands,
     the same bits on a second run, and timed beside the plain version, torch.addmm /
     torch.mm / torch.sum and the bound, with the TFLOP/s and share of the bound reached
     (phase gemm_times; a `gemm` sub-entry on every kernel of the kernels line);
 12. the device side of the training step at the step of record, on a batch carrying
     colour-augmentation keys (phase train_device_side): the augmented rgb on the card
     against the CPU; grad_accum=2 beside grad_accum=1 (48 K1 + 48 K4 a step, step ms,
     peak, the bf16 gradient error against the f32 plain path); LAMB; remat_group 2 and
     4 (launches as G = 1, gradients bit-equal to G = 1); a full train state saved after
     one step and loaded into a fresh state, both continuing bit for bit; per-example eval
     against B = 1 eval steps and the vis step;
 13. the training path's host side (phase train_driver): a synthetic Kubric dataset
     written by the port (8 train + 2 val scenes of 36 frames at 240x320, 8 objects;
     4 scenes of 71 frames for rope256), item times uncached and cached, one batch's
     host->device copy pinned and pageable, _H2DPrefetcher against unpack_batch bit for
     bit; then `python train_torch.py` at the step of record as a subprocess: run 1, 2
     epochs of 4 steps with both val phases (24 K1 + 24 K4 per train step, 24 K1 per val
     step, finite losses, a full checkpoint per epoch); run 2, SIGTERM during step 2 of
     epoch 0 (a full mid-epoch checkpoint with 2 steps done); run 3, --resume of run 2,
     ending with run 1's parameters and AdamW moments (bit for bit, or within TOL_RESUME);
     run 4, rope256 through train_torch.main (12 K1r + 12 K1 and 12 K4r + 12 K4 per step,
     the temporal attention rotated by the batch's frame_times); run 5, --device_augs 0
     (colour augmentation on the host), 2 steps of 24 K1 + 24 K4. Run 1's vis-step overlay
     videos are decoded back with cv2. Per run: the host wall time of each step, the
     driver's loader-wait accounting and peak memory;
 14. the evaluation path (phase eval): a seeded checkpoint of the configuration of record
     (query at 0.2 of the clip), a Kubric test set written by the port (6 scenes of 36
     frames at 240x320) and demo/rollball.mp4 through `python eval_torch.py` as a
     subprocess: 2 Kubric device steps (4 clips and a tail of 2) and 1 plugin step (the
     video's two usage modes), 24 K1 each and no other kernel; the itemized CSV (8 rows,
     the plugin clips' friendly names, finite numbers, no self-check error), every overlay
     video decoded back; pick_represent on the results; InferenceEngine.run_kubric on the
     first Kubric batch against the plain attention. Per device step: host wall time, the
     time rendering overlays, peak memory; clips/s per source, the media time and the
     video container written;
 15. streaming (phase stream): the seeded checkpoint of the configuration of record
     through load_networks, demo/rollball.mp4 from its query (frame 15, 185 frames) through
     stream_step at window 30 with 1 pinned frame, 12 K1 a frame (the spatial attention
     over 301 tokens) and no other kernel: per-frame latency (median, p90), peak memory
     and profiled windows of B = 1 steps and of 4-session stream_step_multi steps (device
     busy share, device events, the weight casts' device time); the 2 clips
     of plugin_request streamed unbounded against the batch forward and against the stream
     with the plain attention (bf16), and f32 at depth 2 against the f32 batch forward;
     K1 at 1 x 301 and 4 x 301 against its plain version (bf16, f32), the bits of one
     sequence alone and in a batch of 4, timed beside its plain version, addmm + SDPA +
     addmm and its bound; then `python eval_torch.py --stream_window 30` on the demo video
     as a subprocess: one CSV row, 12 K1 a frame and nothing else;
 16. the tracking server (phase serve) in this process on 127.0.0.1: batch_slots 1, then
     4, each with 4 concurrent clients streaming 60 frames of the demo video at window 30:
     dedicated replies the direct stream's bits, batched ones within 1e-2 rel L2, 12 K1 a
     step; frames/s, round trips, mean sessions per step, peak; then a reload with
     migrate_sessions=True that a live session survives, its next frames against a stream
     under the new weights fed the frames the window retains;
 17. reference .pth checkpoints (phase pth): a reference-layout TCOW checkpoint of the
     configuration of record from seeded weights, loaded by file through load_networks
     (the tree bit-equal to the numpy tree it was written from; one run_plugin request,
     24 K1, finite outputs), as a .pth-only experiment directory through `python
     eval_torch.py --resume` (the demo video, 24 K1), and a seeded random ViT-B/16 state
     dict through `python train_torch.py --tracker_pretrained` for one step (the weights
     before training the inflated file over the init, bit for bit);
 18. K1-K6 alone at S = 9001 (joint space-time attention: 1 + 300 x 30 tokens, not
     causal, bf16; phase joint_kernels) at the joint path's rows (K1 at 2 and 6, K2 and
     K4-K6 at 6, K3 at 4; K4 and K5 also the five gradients of the differentiable call):
     every row against its plain version in f32 run on that row alone, the weight and
     bias gradients against the sum of the rows' plain gradients; then timed there beside
     the bound and one library call, and beside the plain version at 1 row;
 19. the joint seeker (phase joint): run_plugin at B = 2 (12 K1 a request, masks against
     the plain attention in bf16), one warm-up and one timed training step under every
     pairing (12 launches a step of each of the pairing's kernels, 24 K3 for res) with
     peak memory, and the kernel_x gradient parity against the f32 plain step;
 20. K1 and K4 alone at the ViT-L stretch configuration's width (D = 1024, 16 heads;
     phase vitl_kernels) at the shapes of its request (1200 x 60 causal, 60 x 1201) and
     of each training rung below (300 x 30, 30 x 301, 900 x 30, 90 x 301), bf16, plus two
     float32 cases: against the plain version in f32 run by chunks of rows, the same bits
     on a second run, then timed beside the bound, the plain version and the library
     chain;
 21. the stretch configuration (phase vitl; BASELINE.json config 5 of the JAX package,
     ViT-L, depth 24, T = 60 at 480x640): a seeded checkpoint written by the port through
     load_networks -> run_plugin on one clip (48 K1 a request, masks against the plain
     attention); tools/torch_vitl_probe.py as a subprocess over a ladder every rung of
     which must fit in 80 GB (1 x 1 and 1 x 3 queries at T = 30, 240x320, dots_nb_out: 48
     K1 + 48 K4 a step; the full stretch under full remat: 96 K1 + 48 K4), ms/step and
     peak; the kernel_x gradient ratio at ViT-L width and depth 2;
 22. the tools at the configuration of record (phase tools): after train_driver,
     torch_warm_cache.py and torch_validate_dataset.py on its dataset; then
     torch_stream_demo.py (the demo video decoded back), torch_stream_bench.py,
     torch_serve_bench.py (dedicated and 4 slots) and torch_stream_eval.py (2 scenes of
     160 frames, windows 0 and 30, the unbounded stream against the offline forward at T =
     160 in this process), 12 K1 a frame or server step, finite numbers, no traceback;
 23. ResNet-50 (phase resnet; models/resnet.py, cuDNN convolutions) on 60 frames at
     240x320: the card against the CPU in f32 in eval and train mode, bf16 against f32,
     ms and peak;
 24. data parallelism (phases dp and dp_nccl after train_times, dp_driver on a thread
     beside the phases of item 2, on train_driver's dataset): the step of record's global
     batch split over two ranks, subprocesses that share the card as two "hosts" (gloo,
     asserted), each pairing's launches per rank and step, the replicas bit-identical, the
     all-reduced first-step gradients against the one-process ones of train_parity (bf16
     ratio, f32 at depth 2), per rank step ms, peak and the gradient all-reduce's ms; the
     step at world size 1 on NCCL bit-equal to one process; `python train_torch.py
     --multihost 1` as two ranks: a SIGTERM to rank 0 stops both after the same step with
     one mid-epoch checkpoint, and the resume ends bit-equal to an uninterrupted two-rank
     run;
 25. tensor parallelism (phase tp after dp; tp_grid, beside sp_grid, and tp_driver on a
     thread while the threads of item 2 run, tp_driver on its own 4-scene dataset): the step of record's batch on one data
     row of two model ranks that share the card (gloo, asserted), each running K1-K6 on
     its half of every attention call's rows (900 x 30 and 90 x 301 at the step of
     record, recorded): 8 K1 + 8 K4 per rank and step at depth 4 and each other
     pairing's launches at depth 2, the replicated tensors and the shards compared by
     digest, the gathered first-step gradients against train_parity's (bf16 ratio, f32 at
     depth 2), per rank step ms, peak and the model-axis collectives per step (count,
     bytes, ms in the instrumented warm-up step); four ranks as (data 2, model 2), the f32 depth-2 gradient against one process;
     `train_torch.py --multihost 1 --tp_shards 2` as two ranks for one epoch of 2 steps
     at full width and depth 2, its checkpoint in the one-process layout loaded into a
     one-process state on the card, bit for bit; which of all_gather_into_tensor,
     reduce_scatter_tensor, all_to_all_single (even and uneven split sizes) and send / recv
     gloo runs on CUDA tensors (phase gloo_probe, on a thread beside the kernel checks);
 26. sequence parallelism (phase sp after tp; sp_grid beside tp_grid and sp_driver on a
     thread while the threads of item 2 run, sp_driver on its own 4-scene dataset): the step of record's batch on
     one data row of two seq ranks that share the card (gloo), each holding the whole model
     and its chunk of the tokens, K1-K6 on its patches' and its frames' rows (900 x 30 and
     90 x 301, recorded): 24 K1 + 24 K4 per rank and step at depth 12 and each other
     pairing's launches at depth 2, the replicated tensors by digest, the gradients against
     train_parity's (bf16 ratio, f32 at depth 2), causal_attention 0 at depth 2 against
     one process, per rank step ms, peak and the seq collectives per step (count, bytes, ms
     in the instrumented warm-up step); four ranks as (seq 2, model 2), the f32 depth-2
     gradient against one process; `train_torch.py --multihost 1 --seq_shards 2` as two
     ranks for one epoch of 2 steps at full width and depth 2, its checkpoint loaded into a
     one-process state on the card, bit for bit;
 27. pipeline parallelism (phase pp beside tp and sp; pp_grid beside the other grids and
     pp_driver on a thread while the threads of item 2 run, pp_driver on its own 4-scene
     dataset): the step of record's batch on one data row of two pipe stages that share
     the card (gloo), each holding 6 of the 12 blocks, the batch's 6 rows in 2
     microbatches of 3 (900 x 30 and 90 x 301 a kernel call, recorded): 24 K1 + 24 K4 per
     rank and step at depth 12 and each other pairing's launches at depth 2 (one block a
     stage), the replicated tensors by digest, the gradients against train_parity's (bf16
     ratio, f32 at depth 2), drop-path 0.1 at depth 2 against one process with the same
     generator, per rank step ms, peak and the stage hops per step (count, bytes, ms in
     the instrumented warm-up step); four ranks as (model 2, pipe 2), the f32 depth-2
     gradient against one process; `train_torch.py --multihost 1 --pp_stages 2` as two
     ranks for one epoch of 2 steps and the vis step at full width and depth 2, its
     checkpoint loaded into a one-process state on the card, bit for bit.

The Kubric datasets are written on a thread while the kernels build; the inputs of the
kernel comparisons and timings are drawn on the card.

Run from the repository root: `python3 chip_smoke.py`. Prints one JSON object per phase,
then the `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when CUDA is not
available or any phase fails. Needs one GPU.
'''

import argparse
import concurrent.futures
import contextlib
import csv
import dataclasses
import functools
import gc
import importlib
import io
import json
import math
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from tcow_tpu_torch import config as config_lib
from tcow_tpu_torch import serving
from tcow_tpu_torch.data import factory
from tcow_tpu_torch.data import kubric as kubric_lib
from tcow_tpu_torch.data.plugin import PluginVideoDataset
from tcow_tpu_torch.data.synthetic import (synthetic_color_augs, synthetic_device_batch,
                                           synthetic_frame_times,
                                           write_synthetic_kubric_scene)
from tcow_tpu_torch.evaluation.inference import InferenceEngine, load_networks
from tcow_tpu_torch.models import streaming, torch_import
from tcow_tpu_torch.models import timesformer as tsf
from tcow_tpu_torch.models.mask_tracker import MaskTracker, seeker_config_from_args
from tcow_tpu_torch.objectives.losses import LossConfig
from tcow_tpu_torch.objectives.metrics import METRIC_KEYS
from tcow_tpu_torch.ops import _build
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.ops import rope as rope_lib
from tcow_tpu_torch.parallel import mesh as mesh_lib
from tcow_tpu_torch.parallel import pipeline as pipe_lib
from tcow_tpu_torch.parallel import sequence as seq_lib
from tcow_tpu_torch.parallel import tensor as tensor_lib
from tcow_tpu_torch.train import driver as train_driver
from tcow_tpu_torch.train import optim
from tcow_tpu_torch.train import step as step_lib
from tcow_tpu_torch.train.checkpoint import (flatten_with_paths, load_checkpoint,
                                             opt_state_to_jax, peek_meta, save_checkpoint,
                                             save_train_state)
from tcow_tpu_torch.weights import params_to_jax

SEED = 0
DEV = 'cuda'
# H100 SXM dense peaks (NVIDIA data sheet) at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# The configuration of record: ViT-B/16 divided space-time, T=30 at 240x320, causal 1.
SEEKER_ARGS = dict(num_total_frames=30, frame_height=240, frame_width=320, patch_size=16,
                   attention_type='divided_space_time', causal_attention=1,
                   norm_embeddings=False, network_depth=12, track_map_stride=4,
                   track_map_resize='bilinear', query_channels=1, output_channels=3,
                   flag_channels=3, tracker_pretrained='0')
BATCH = 2            # clips per request
REQUESTS = 3
D, HEADS = 768, 12
# K1 geometries of the main path: temporal (B*N sequences of T, causal_attention=1)
# and spatial (B*T sequences of N+1, never causal).
GEOMETRIES = {'temporal': (BATCH * 300, 30, 1), 'spatial': (BATCH * 30, 301, 0)}
# The training step of record (bench.py:36-52 of the JAX package): B=2 clips, Q=3 queries
# folded into a backbone batch of 6; K4 geometries of its backward.
TRAIN_B, TRAIN_Q, TRAIN_M, TRAIN_K = 2, 3, 36, 8
TRAIN_GEOMETRIES = {'temporal': (TRAIN_B * TRAIN_Q * 300, 30, 1),
                    'spatial': (TRAIN_B * TRAIN_Q * 30, 301, 0)}
TRAIN_PROGRESS = 0.1
TRAIN_STEPS = 2      # timed, after one warm-up step
# Each attention-backward mode with the remat policy that keeps what it needs (BASELINE.md
# of the JAX package), the step of record first; and the launches of one training step
# per attention call (two per block), by kernel: the forward kernel runs again in the
# backward only under 'res' / 'dots_nb', whose policy does not keep the residuals.
PAIRINGS = {
    ('kernel_x', 'dots_nb_out'): {'K1': 1, 'K4': 1},
    ('kernel_qkv', 'dots_nb_out_qkv'): {'K2': 1, 'K5': 1},
    ('res', 'dots_nb'): {'K3': 2},
    ('kernel_x_wg', 'dots_nb_out'): {'K1': 1, 'K6': 1},
}
STEP_OF_RECORD = ('kernel_x', 'dots_nb_out')
# The wrapper of each kernel, which counts its launches: `launches` without rope (K1 ...
# K6), `launches_rope` with it (K1r ... K6r).
KERNELS = fa.KERNEL_COUNTERS
# The time-calibrated rope configuration the JAX package trained for 36 epochs
# (docs/campaign_r4/rope256/args_train.txt: temporal_rope 1, rope_time_coords 1, rope time
# stretch 4). Its frame times are drawn per clip as the augmentations draw them, here at
# frame stride 2 so that they reach ~230.
ROPE_ARGS = dict(SEEKER_ARGS, temporal_rope=1, rope_time_coords=1)
ROPE_FRAME_STRIDE = 2
# The temporal attention shapes of the rope path: inference (B clips) and training.
ROPE_GEOMETRIES = {'temporal': GEOMETRIES['temporal'],
                   'train_temporal': TRAIN_GEOMETRIES['temporal']}

# Tolerances, relative L2 error ||kernel - plain|| / ||plain||:
# K1, K2, K3 bf16 vs the plain version in float32 from the same bf16-rounded inputs: the
# kernel rounds qkv, p and attn to bf16 (8 bits of mantissa, ~4e-3 per rounding).
TOL_BF16 = 1e-2
# Every kernel (and the whole differentiable call) in float32 vs its plain version /
# autograd in float32 (TF32 off): only the order of the sums differs.
TOL_F32 = 1e-4
# K4, K5, K6 bf16 vs the plain version in f32 from the same bf16-rounded inputs: the
# kernel rounds qkv, dattn, p, attn, dlog, dq, dk and dv to bf16, and dlog = pf (dp -
# delta) cancels; K6 also sums its 54,000 rows per weight gradient in other runs and
# another order than the plain product.
TOL_K4_BF16 = 2e-2
# Full seeker forward, bf16, kernel path vs plain path: both round to bf16 in every one
# of 12 blocks, at different points (the kernel once per GEMM, the plain path twice).
TOL_SEEKER_BF16 = 5e-2
# Full seeker forward in float32, kernel path vs plain path.
TOL_SEEKER_F32 = 1e-3
# Training step, drop-path off: the kernel path's bf16 error in the loss and in the
# concatenated gradient, against the plain path in f32, may be at most this multiple of
# the plain path's own bf16 error (both round to bf16 in every block, at other points).
TRAIN_BF16_ERR_RATIO = 1.5
# Training step in float32 at depth 2, full width: kernel path vs plain path, relative L2
# of the concatenated gradient and the loss (the order of the sums differs).
TOL_TRAIN_F32 = 1e-3


def fail(msg):
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


# perf_counter() when main() started: every phase line carries its seconds since then.
T0 = time.perf_counter()


# Phases on other threads (start_host_run) print through emit too, and stop their
# subprocesses once ABORT is set.
EMIT_LOCK = threading.Lock()
ABORT = threading.Event()


def emit(obj):
    line = json.dumps({**obj, 'script_s': time.perf_counter() - T0}) + '\n'
    with EMIT_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def cuda_ms(fn, iters=20, warmup=3):
    '''Mean milliseconds per call on the card, with CUDA events after a warm-up.'''
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attended_pairs(S, ca):
    '''(query, key) pairs of one sequence that the mask keeps.'''
    if ca > 0:
        diag = 0 if ca <= 2 else ca - 2
        return sum(min(S, q + diag + 1) for q in range(S))
    return S * S


def k1_flops(B, S, ca, width=None):
    '''Operations one fused attention call needs: qkv and proj GEMMs, and scores + P.v
    over the (query, key) pairs the mask keeps. width: (D, heads), the record's by
    default (every cost function below takes it).'''
    d, heads = width or (D, HEADS)
    return 2 * B * S * d * 4 * d + 2 * 2 * B * heads * attended_pairs(S, ca) * (d // heads)


def k1_bytes(B, S, itemsize, width=None):
    '''x read once, out written once, the f32 weights and biases read once.'''
    d, _ = width or (D, HEADS)
    return 2 * B * S * d * itemsize + (4 * d * d + 4 * d) * 4


def k4_flops(B, S, ca, width=None):
    '''Operations of one K4 call: the qkv recompute and g . proj_w^T (8 B S D^2), and
    per kept (query, key) pair and head the logits, P.v, dv, dp, dq and dk (12 D).'''
    d, _ = width or (D, HEADS)
    return 8 * B * S * d * d + 12 * d * attended_pairs(S, ca) * B


def k4_bytes(B, S, itemsize, width=None):
    '''x and g read once, dqkv and attn written once, the f32 weights read once.'''
    d, _ = width or (D, HEADS)
    return 6 * B * S * d * itemsize + (4 * d * d + 3 * d) * 4


def k2_bytes(B, S, itemsize, width=None):
    '''K1's bytes and qkv written once.'''
    d, _ = width or (D, HEADS)
    return k1_bytes(B, S, itemsize, width) + 3 * B * S * d * itemsize


def k3_bytes(B, S, itemsize, width=None):
    '''K2's bytes, attn and the probabilities (B, H, S, S) written once.'''
    d, heads = width or (D, HEADS)
    return k2_bytes(B, S, itemsize, width) + (B * S * d + B * heads * S * S) * itemsize


def k5_flops(B, S, ca, width=None):
    '''K4's operations without the qkv recompute: g . proj_w^T and the attention.'''
    d, _ = width or (D, HEADS)
    return 2 * B * S * d * d + 12 * d * attended_pairs(S, ca) * B


def k5_bytes(B, S, itemsize, width=None):
    '''qkv and g read once, dqkv and attn written once, proj_w (f32) read once.'''
    d, _ = width or (D, HEADS)
    return 8 * B * S * d * itemsize + 4 * d * d


def k6_flops(B, S, ca, width=None):
    '''K4's operations plus dx (6 B S D^2), dqkv_w (6 B S D^2), dproj_w (2 B S D^2) and
    the column sums of dqkv and g (4 B S D).'''
    d, _ = width or (D, HEADS)
    return k4_flops(B, S, ca, width) + 14 * B * S * d * d + 4 * B * S * d


def k6_bytes(B, S, itemsize, width=None):
    '''x and g read, dx written once; the f32 weights read and the f32 weight and bias
    gradients written once.'''
    d, _ = width or (D, HEADS)
    return 3 * B * S * d * itemsize + (4 * d * d + 3 * d) * 4 + (4 * d * d + 4 * d) * 4


def bound(flops, nbytes):
    '''(least ms on the card, what bounds it) for bf16 work.'''
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def seeker_forward_flops(cfg, B, width=None):
    '''Matmul operations of one seeker forward over B clips.'''
    d, _ = width or (D, HEADS)
    T, p = cfg.num_total_frames, cfg.patch_size
    N = (cfg.frame_height // p) * (cfg.frame_width // p)
    Hm = 4 * d
    block = (k1_flops(B * N, T, cfg.causal_attention, width) + 2 * B * N * T * d * d
             + k1_flops(B * T, N + 1, 0, width) + 2 * 2 * (B * N * T + B) * d * Hm)
    heads = 2 * B * T * N * d * (cfg.output_channels * p * p + cfg.flag_channels)
    return 2 * B * T * N * p * p * cfg.input_channels * d + cfg.network_depth * block + heads


def attn_inputs(B, S, dtype, seed, width=None):
    '''x and weights drawn on the card from a seeded generator; weight scales give peaked
    softmax rows. width: (D, heads), the record's by default.'''
    d, _ = width or (D, HEADS)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(B, S, d, generator=gen, device=DEV).to(dtype)
    w = [torch.randn(shape, generator=gen, device=DEV) * scale for shape, scale in (
        ((d, 3 * d), 0.06), ((3 * d,), 0.02), ((d, d), 0.03), ((d,), 0.02))]
    return x, w


def grad_input(B, S, dtype, seed, width=None):
    d, _ = width or (D, HEADS)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(B, S, d, generator=gen, device=DEV).to(dtype)


def reset_launches():
    for wrapper in KERNELS.values():
        wrapper.launches = 0
        wrapper.launches_rope = 0


read_launches = fa.read_launches
launches_since = fa.launches_since


def plain_fused_attention(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, ca, bwd_mode,
                          rope=False, pos=None):
    '''The model's attention call with the plain version, whatever the mode.'''
    return fa.attention_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, ca, rope, pos)


@contextlib.contextmanager
def plain_attention():
    '''Runs the model's attention through the plain PyTorch version, on the card too, for
    comparisons with the kernel path; restores the kernel on exit.'''
    tsf.fused_attention = plain_fused_attention
    try:
        yield
    finally:
        tsf.fused_attention = fa.fused_attention


def rotate(q, k, cs):
    '''q and k rotated by the head-broadcast rope tables cs (None: unchanged).'''
    if cs is None:
        return q, k
    return rope_lib.apply_rope(q, *cs), rope_lib.apply_rope(k, *cs)


def head_tables(S, pos):
    '''(cos, sin) broadcastable over (B, H, S, dh/2) for per-row positions pos (B, S).'''
    cos, sin = fa.rope_tables_for(S, D // HEADS, pos, pos.device)
    return cos[:, None], sin[:, None]


def library_attention(x, w16, ca, cs=None, heads=None):
    '''One PyTorch call chain computing K1's and K2's function, (out, qkv) (yardstick
    only); with rope tables cs, q and k rotated by apply_rope before SDPA.'''
    B, S, d = x.shape
    heads = heads or HEADS
    qkv = torch.addmm(w16[1], x.reshape(B * S, d), w16[0])
    q, k, v = qkv.reshape(B, S, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    q, k = rotate(q, k, cs)
    o = F.scaled_dot_product_attention(q, k, v, is_causal=ca > 0)
    return torch.addmm(w16[3], o.transpose(1, 2).reshape(B * S, d), w16[2]), qkv


def library_attention_probs(x, w16, ca, cs=None):
    '''K3's function, (out, qkv, probs, attn), with library calls (yardstick only): no
    fused library call returns the probabilities, so addmm, matmul, softmax, matmul,
    addmm; with rope tables cs, q and k rotated by apply_rope first.'''
    B, S, _ = x.shape
    dh = D // HEADS
    qkv = torch.addmm(w16[1], x.reshape(B * S, D), w16[0])
    q, k, v = qkv.reshape(B, S, 3, HEADS, dh).permute(2, 0, 3, 1, 4)
    q, k = rotate(q, k, cs)
    logits = torch.matmul(q, k.transpose(-1, -2)) * dh ** -0.5
    if ca > 0:
        logits = logits.masked_fill(~fa._causal_keep(S, ca, x.device), -1e10)
    probs = torch.softmax(logits, dim=-1, dtype=torch.float32).to(x.dtype)
    attn = torch.matmul(probs, v).transpose(1, 2).reshape(B * S, D)
    return torch.addmm(w16[3], attn, w16[2]), qkv, probs, attn


def phase_device():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), '--version'], capture_output=True, text=True,
                          check=True).stdout
    nvcc_line = next((ln for ln in nvcc.splitlines() if 'release' in ln), nvcc.strip())
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in _build.SOURCES:
        log = _build.lib_path(name).with_suffix('.log')
        ptxas[name] = ([ln.strip() for ln in log.read_text().splitlines()
                        if 'registers' in ln or 'spill' in ln] if log.exists() else [])
    emit({'phase': 'device', 'nvidia_smi': smi, 'torch': torch.__version__,
          'torch_cuda': torch.version.cuda, 'nvcc': nvcc_line, 'build_s': build_s,
          'build_s_by_source': dict(_build.build_seconds), 'ptxas': ptxas})
    return smi


def phase_kernel_vs_plain():
    '''K1 at the inference and training geometries (bf16) and one float32 case, against
    attention_ref in f32 from the same inputs.'''
    cases = [(name, B, S, ca, torch.bfloat16) for name, (B, S, ca) in GEOMETRIES.items()]
    cases += [(f'train_{name}', B, S, ca, torch.bfloat16)
              for name, (B, S, ca) in TRAIN_GEOMETRIES.items()]
    cases.append(('f32_causal3', 16, 301, 3, torch.float32))
    errs = {}
    for i, (name, B, S, ca, dtype) in enumerate(cases):
        x, w = attn_inputs(B, S, dtype, SEED + i)
        got = fa.fused_attention(x, *w, HEADS, ca)
        want = fa.attention_ref(x.float(), *w, HEADS, ca)
        torch.cuda.synchronize()
        if got.shape != x.shape or got.dtype != dtype:
            fail(f'{name}: kernel output {tuple(got.shape)} {got.dtype}')
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        errs[name] = dict(B=B, S=S, ca=ca, dtype=str(dtype).replace('torch.', ''),
                          max_abs_err=float((got.float() - want).abs().max()),
                          rel_l2_err=rel_l2(got.float(), want), tol_rel_l2=tol)
        if not errs[name]['rel_l2_err'] <= tol:
            fail(f'{name}: kernel vs plain rel L2 {errs[name]["rel_l2_err"]} > {tol}')
    emit({'phase': 'kernel_vs_plain', 'cases': errs})
    return errs


def phase_k4_vs_plain():
    '''K4 at the training geometries (bf16) and one float32 case: (dqkv, attn) against
    attention_bwd_ref in f32 from the same inputs, and the Function's gradients of x and
    the four weights against autograd through attention_ref in f32.'''
    cases = [(name, B, S, ca, torch.bfloat16) for name, (B, S, ca) in TRAIN_GEOMETRIES.items()]
    cases.append(('f32_causal3', 16, 301, 3, torch.float32))
    errs = {}
    for i, (name, B, S, ca, dtype) in enumerate(cases):
        x, w = attn_inputs(B, S, dtype, SEED + 10 + i)
        g = grad_input(B, S, dtype, SEED + 20 + i)
        dqkv, attn = fa.fused_attention_bwd(x, g, *w[:3], HEADS, ca)
        want_dqkv, want_attn = fa.attention_bwd_ref(x.float(), g.float(), *w[:3], HEADS, ca)
        leaves = [x.clone().requires_grad_()] + [a.clone().requires_grad_() for a in w]
        fa.fused_attention(*leaves, HEADS, ca, 'kernel_x').backward(g)
        ref = [x.float().requires_grad_()] + [a.clone().requires_grad_() for a in w]
        fa.attention_ref(*ref, HEADS, ca).backward(g.float())
        torch.cuda.synchronize()
        if dqkv.shape != (B, S, 3 * D) or attn.shape != x.shape or dqkv.dtype != dtype:
            fail(f'{name}: K4 outputs {tuple(dqkv.shape)} {tuple(attn.shape)} {dqkv.dtype}')
        tol = TOL_K4_BF16 if dtype == torch.bfloat16 else TOL_F32
        e = dict(B=B, S=S, ca=ca, dtype=str(dtype).replace('torch.', ''), tol_rel_l2=tol,
                 max_abs_err=max(float((dqkv.float() - want_dqkv).abs().max()),
                                 float((attn.float() - want_attn).abs().max())),
                 rel_l2_dqkv=rel_l2(dqkv.float(), want_dqkv),
                 rel_l2_attn=rel_l2(attn.float(), want_attn))
        for gname, a, b in zip(('dx', 'dqkv_w', 'dqkv_b', 'dproj_w', 'dproj_b'), leaves, ref):
            if a.grad is None or a.grad.dtype != a.dtype:
                fail(f'{name}: no {gname} of dtype {a.dtype} from the Function')
            e[f'rel_l2_{gname}'] = rel_l2(a.grad.float(), b.grad)
        errs[name] = e
        bad = {k: v for k, v in e.items() if k.startswith('rel_l2') and not v <= tol}
        if bad:
            fail(f'{name}: K4 vs plain rel L2 above {tol}: {bad}')
    emit({'phase': 'k4_vs_plain', 'cases': errs})
    return errs


def phase_new_kernels_vs_plain():
    '''K2, K3, K5 and K6 at both training geometries, in bf16 and in float32, against
    their plain versions in f32 from the same inputs; K6 run twice must give the same
    bits.'''
    errs = {'K2': {}, 'K3': {}, 'K5': {}, 'K6': {}}
    cases = [(f'{name}_{str(dtype)[6:]}', B, S, ca, dtype)
             for dtype in (torch.bfloat16, torch.float32)
             for name, (B, S, ca) in TRAIN_GEOMETRIES.items()]
    for i, (name, B, S, ca, dtype) in enumerate(cases):
        x, w = attn_inputs(B, S, dtype, SEED + 30 + i)
        g = grad_input(B, S, dtype, SEED + 40 + i)
        k2 = fa.fused_attention_fwd_qkv(x, *w, HEADS, ca)
        k3 = fa.fused_attention_fwd_res(x, *w, HEADS, ca)
        k5 = fa.fused_attention_bwd_qkv(k2[1], g, w[2], HEADS, ca)
        k6 = fa.fused_attention_bwd_wg(x, g, *w[:3], HEADS, ca)
        k6_again = fa.fused_attention_bwd_wg(x, g, *w[:3], HEADS, ca)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k6, k6_again)):
            fail(f'{name}: K6 gave other gradients on a second run')
        del k6_again
        res = fa.attention_res_ref(x.float(), *w, HEADS, ca)
        plain = {'K2': (k2, res[:2], ('out', 'qkv')),
                 'K3': (k3, res, ('out', 'qkv', 'probs', 'attn'))}
        del res
        plain['K5'] = (k5, fa.attention_bwd_qkv_ref(k2[1].float(), g.float(), w[2], HEADS, ca),
                       ('dqkv', 'attn'))
        plain['K6'] = (k6, fa.attention_bwd_wg_ref(x.float(), g.float(), *w[:3], HEADS, ca),
                       ('dx', 'dqkv_w', 'dqkv_b', 'dproj_w', 'dproj_b'))
        for kernel, (got, want, names) in plain.items():
            if [t.shape for t in got] != [t.shape for t in want]:
                fail(f'{name}: {kernel} output shapes {[tuple(t.shape) for t in got]}')
            tol = (TOL_F32 if dtype == torch.float32
                   else TOL_BF16 if kernel in ('K2', 'K3') else TOL_K4_BF16)
            e = dict(B=B, S=S, ca=ca, dtype=str(dtype)[6:], tol_rel_l2=tol,
                     max_abs_err=max(float((a.float() - b).abs().max())
                                     for a, b in zip(got, want)))
            e.update({f'rel_l2_{n}': rel_l2(a.float(), b) for n, a, b in zip(names, got, want)})
            errs[kernel][name] = e
            bad = {k: v for k, v in e.items() if k.startswith('rel_l2') and not v <= tol}
            if bad:
                fail(f'{name}: {kernel} vs plain rel L2 above {tol}: {bad}')
        del plain, k2, k3, k5, k6
    emit({'phase': 'k2_k3_k5_k6_vs_plain', 'cases': errs, 'k6_deterministic': True})
    return errs


def plugin_request(seed):
    '''B clips of rgb, a query box on frame 0, and targets with unannotated frames.'''
    rng = np.random.RandomState(seed)
    T, H, W = (SEEKER_ARGS[k] for k in ('num_total_frames', 'frame_height', 'frame_width'))
    rgb = rng.rand(BATCH, 3, T, H, W).astype(np.float32)
    query = np.zeros((BATCH, 1, T, H, W), np.float32)
    query[:, :, 0, H // 3:2 * H // 3, W // 3:2 * W // 3] = 1.0
    target = np.zeros((BATCH, 3, T, H, W), np.float32)
    target[:, 0, :, H // 3:2 * H // 3, W // 3:2 * W // 3] = 1.0
    target[:, 1, ::3, H // 2:2 * H // 3, W // 2:2 * W // 3] = 1.0
    target[:, :, -T // 6:] = -1.0
    return rgb, query, target


def phase_slice(ckpt_dir):
    '''Checkpoint -> load_networks -> InferenceEngine -> 3 requests (the main path).'''
    cfg0 = seeker_config_from_args(SEEKER_ARGS)
    model = MaskTracker(cfg0)
    model.init_params_(torch.Generator().manual_seed(SEED))
    save_checkpoint(str(ckpt_dir), 0, 'chip_smoke', params_to_jax(model.state_dict()),
                    seeker_args=SEEKER_ARGS)
    del model
    params, cfg, *_ = load_networks(str(ckpt_dir), None, compute_dtype=torch.bfloat16,
                                    device=DEV)
    # The JAX package's default mode; without gradients every mode runs K1 alone.
    cfg = dataclasses.replace(cfg, attention_bwd='res', remat_policy='full')
    engine = InferenceEngine(params, cfg, device=DEV)
    rgb, query, target = plugin_request(SEED)

    reset_launches()
    req_ms, results = [], None
    for _ in range(REQUESTS):
        before = fa.fused_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run_plugin(rgb, query, target)
        torch.cuda.synchronize()
        req_ms.append(1e3 * (time.perf_counter() - t0))
        if fa.fused_attention.launches - before != 2 * cfg.network_depth:
            fail(f'request launched the kernel {fa.fused_attention.launches - before} '
                 f'times, expected {2 * cfg.network_depth}')
    launches = fa.fused_attention.launches
    others = {k: n for k, n in read_launches().items() if k != 'K1' and n}
    if others:
        fail(f'inference ({cfg.attention_bwd!r} mode) launched other kernels: {others}')
    for mode in fa.BWD_MODES:
        eng = InferenceEngine(params, dataclasses.replace(cfg, attention_bwd=mode), device=DEV)
        counts = read_launches()
        eng.run_plugin(rgb, query, target)
        torch.cuda.synchronize()
        got = {k: n - counts[k] for k, n in read_launches().items() if n != counts[k]}
        if got != {'K1': 2 * cfg.network_depth}:
            fail(f'inference in the {mode!r} mode launched {got}')
        del eng

    mask = np.concatenate([m['output_mask'] for m, _ in results])
    flags = np.concatenate([m['output_flags'] for m, _ in results])
    if mask.shape != (BATCH, 3) + rgb.shape[2:] or flags.shape != (BATCH, rgb.shape[2], 3):
        fail(f'output shapes {mask.shape} {flags.shape}')
    if not (np.isfinite(mask).all() and np.isfinite(flags).all()):
        fail('non-finite outputs')
    want_keys = {f'{s}_{k}' for k in METRIC_KEYS for s in ('mean', 'count')}
    for _, loss in results:
        if set(loss['metrics']) != want_keys:
            fail(f'metric keys {sorted(loss["metrics"])}')

    # The same weights through the plain attention (bf16), and both paths in float32.
    def outputs(c, plain):
        eng = InferenceEngine(params, c, device=DEV)
        with plain_attention() if plain else contextlib.nullcontext():
            res = eng.run_plugin(rgb, query, target)
        return (np.concatenate([m['output_mask'] for m, _ in res]),
                np.concatenate([m['output_flags'] for m, _ in res]))

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    plain = outputs(cfg, plain=True)
    f32_plain = outputs(cfg32, plain=True)
    f32_kernel = outputs(cfg32, plain=False)
    t = lambda a: torch.from_numpy(a)
    errs = {
        'mask_kernel_vs_plain_bf16': rel_l2(t(mask), t(plain[0])),
        'flags_kernel_vs_plain_bf16': rel_l2(t(flags), t(plain[1])),
        'mask_kernel_bf16_vs_plain_f32': rel_l2(t(mask), t(f32_plain[0])),
        'mask_plain_bf16_vs_plain_f32': rel_l2(t(plain[0]), t(f32_plain[0])),
        'mask_kernel_vs_plain_f32': rel_l2(t(f32_kernel[0]), t(f32_plain[0])),
        'flags_kernel_vs_plain_f32': rel_l2(t(f32_kernel[1]), t(f32_plain[1])),
    }
    for key, tol in (('mask_kernel_vs_plain_bf16', TOL_SEEKER_BF16),
                     ('flags_kernel_vs_plain_bf16', TOL_SEEKER_BF16),
                     ('mask_kernel_vs_plain_f32', TOL_SEEKER_F32),
                     ('flags_kernel_vs_plain_f32', TOL_SEEKER_F32)):
        if not errs[key] <= tol:
            fail(f'{key}: rel L2 {errs[key]} > {tol}')
    if launches != REQUESTS * 2 * cfg.network_depth:
        fail(f'main path launches {launches}')
    steady = sorted(req_ms[1:])[len(req_ms[1:]) // 2]
    emit({'phase': 'slice', 'requests': REQUESTS, 'clips_per_request': BATCH,
          'launches': launches, 'request_ms': req_ms, 'request_ms_steady': steady,
          'clips_per_s': BATCH / (steady / 1e3), 'rel_l2': errs,
          'tol_rel_l2': {'bf16': TOL_SEEKER_BF16, 'f32': TOL_SEEKER_F32},
          'metrics_example0': results[0][1]['metrics']})
    return params, cfg, launches, (rgb, query)


def phase_times(params, cfg, inputs):
    rgb, query = (torch.as_tensor(a, device=DEV) for a in inputs)
    engine = InferenceEngine(params, cfg, device=DEV)

    def forward_ms(path, warmup):
        with torch.inference_mode(), (plain_attention() if path == 'plain'
                                      else contextlib.nullcontext()):
            return path, cuda_ms(lambda: engine.model(rgb, query), iters=5, warmup=warmup)

    # Alternated in one process: plain, kernel, kernel, plain.
    runs = [forward_ms('plain', 2), forward_ms('kernel', 2), forward_ms('kernel', 0),
            forward_ms('plain', 0)]
    fwd_flops = seeker_forward_flops(cfg, BATCH)
    emit({'phase': 'forward_times', 'forward_ms': runs, 'forward_flops': fwd_flops,
          'forward_bound_ms': 1e3 * fwd_flops / PEAK_BF16_FLOPS})

    per_geom = {}
    with torch.inference_mode():
        for i, (name, (B, S, ca)) in enumerate(GEOMETRIES.items()):
            x, w = attn_inputs(B, S, torch.bfloat16, SEED + 100 + i)
            w16 = [a.to(torch.bfloat16) for a in w]
            bound_ms, bound_by = bound(k1_flops(B, S, ca), k1_bytes(B, S, 2))
            per_geom[name] = dict(
                B=B, S=S, ca=ca,
                ms=cuda_ms(lambda: fa.fused_attention(x, *w, HEADS, ca)),
                plain_ms=cuda_ms(lambda: fa.attention_ref(x, *w, HEADS, ca)),
                library_ms=cuda_ms(lambda: library_attention(x, w16, ca)),
                bound_ms=bound_ms, bound_by=bound_by,
                flops=k1_flops(B, S, ca), bytes=k1_bytes(B, S, 2))
    emit({'phase': 'kernel_times', 'per_call': per_geom})
    return per_geom


# The depths with a preset of the package's own, and the holders of each preset that
# depth_preset registered: the driver threads and the main thread register depth 2 at once.
OWN_PRESETS = frozenset(tsf.DEPTH_PRESETS)
_PRESET_LOCK = threading.Lock()
_PRESET_HOLDERS = {}


@contextlib.contextmanager
def depth_preset(depth, width_heads):
    '''Registers a backbone preset (network_depth -> (width, heads)) for the block. Threads
    may hold one preset at once: the last to leave removes it; another width for a depth
    held raises.'''
    with _PRESET_LOCK:
        if _PRESET_HOLDERS.get(depth) and tsf.DEPTH_PRESETS[depth] != width_heads:
            raise RuntimeError(f'depth {depth} is held at {tsf.DEPTH_PRESETS[depth]}, not '
                               f'{width_heads}')
        tsf.DEPTH_PRESETS[depth] = width_heads
        _PRESET_HOLDERS[depth] = _PRESET_HOLDERS.get(depth, 0) + 1
    try:
        yield
    finally:
        with _PRESET_LOCK:
            _PRESET_HOLDERS[depth] -= 1
            if not _PRESET_HOLDERS[depth]:
                del tsf.DEPTH_PRESETS[depth]


def at_depth(depth):
    '''depth_preset(depth) at full width, unless depth has a preset of the package's own.'''
    return (contextlib.nullcontext() if depth in OWN_PRESETS
            else depth_preset(depth, (D, HEADS)))


def train_config(dtype, drop_path_rate=0.1, depth=12, pairing=STEP_OF_RECORD, rope=False,
                 joint=False, queries=TRAIN_Q, **overrides):
    '''ViT-B/16, T=30 at 240x320, causal 1, per-block remat under the pairing's
    (attention_bwd, remat_policy); the step of record by default; with rope the rope256
    configuration, with joint joint space-time attention; `overrides` set other seeker
    fields (causal_attention).'''
    mode, policy = pairing
    seeker_args = ROPE_ARGS if rope else JOINT_ARGS if joint else SEEKER_ARGS
    seeker = seeker_config_from_args(seeker_args,
                                     drop_path_rate=drop_path_rate,
                                     compute_dtype=dtype, remat=True, network_depth=depth,
                                     attention_bwd=mode, remat_policy=policy, **overrides)
    return step_lib.StepConfig(seeker=seeker, loss=LossConfig(), num_queries=queries)


def train_batch(rope=False, host=None):
    '''The synthetic batch of record on the card (from `host`, its numpy arrays, when
    given); with rope also its seeded frame times (B, T).'''
    if host is None:
        T, H, W = (SEEKER_ARGS[k] for k in ('num_total_frames', 'frame_height', 'frame_width'))
        host = synthetic_device_batch(0, B=TRAIN_B, Q=TRAIN_Q, T=T, H=H, W=W, M=TRAIN_M,
                                      K=TRAIN_K)
        if rope:
            host['frame_times'] = synthetic_frame_times(SEED, TRAIN_B, T, ROPE_FRAME_STRIDE)
    return {k: torch.as_tensor(v, device=DEV) for k, v in host.items()}


def step_flops(cfg):
    '''Matmul operations of one training step over the B*Q folded clips: the forward and a
    backward of twice the forward, 3 forwards. Recomputes under remat are a choice of
    design, not work the step needs.'''
    return 3 * seeker_forward_flops(cfg.seeker, TRAIN_B * TRAIN_Q)


def timed_step(train_step, state, batch, plain=False):
    '''One train step; returns (state, aux, device ms by CUDA events, host ms).'''
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with plain_attention() if plain else contextlib.nullcontext():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, aux = train_step(state, batch, TRAIN_PROGRESS)
        end.record()
        torch.cuda.synchronize()
    return state, aux, start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)


def phase_train(pairing, rope=False):
    '''The training main path under one (attention_bwd, remat_policy) pairing:
    init_train_state -> make_optimizer -> make_train_step, one warm-up and TRAIN_STEPS
    timed steps at full width, bf16, remat, drop-path 0.1. Every kernel's launches are
    counted from 0 over these steps and checked per step against PAIRINGS; with rope (the
    rope256 step, frame times in the batch) the temporal call of each block launches the
    rope variant and the spatial call the plain kernel.'''
    cfg = train_config(torch.bfloat16, pairing=pairing, rope=rope)
    tx = optim.make_optimizer('adamw', learn_rate=1e-4, num_epochs=70, steps_per_epoch=1000,
                              gradient_clip=0.3)
    state = step_lib.init_train_state(SEED, cfg, tx, device=DEV)
    train_step = step_lib.make_train_step(cfg)
    batch = train_batch(rope)
    last = cfg.seeker.network_depth - 1
    watch = ('backbone.blocks.0.attn.qkv.w', f'backbone.blocks.{last}.temporal_attn.proj.w',
             'post_linear.w')
    depth = cfg.seeker.network_depth
    want = {}
    for k, n in PAIRINGS[pairing].items():
        if rope:
            want[k] = want[f'{k}r'] = n * depth
        else:
            want[k] = n * 2 * depth
    per_step = {k: want.get(k, 0) for k in read_launches()}
    steps = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for i in range(1 + TRAIN_STEPS):
        before = {k: state.model.state_dict()[k].clone() for k in watch}
        counts = read_launches()
        state, aux, ms, host_ms = timed_step(train_step, state, batch)
        rec = dict(step=i, step_ms=ms, host_ms=host_ms, loss=float(aux['total_seeker']),
                   grad_norm=float(aux['grad_norm']),
                   skipped_nonfinite=float(aux['skipped_nonfinite']),
                   launches={k: n - counts[k] for k, n in read_launches().items()})
        steps.append(rec)
        if not np.isfinite(rec['loss']) or rec['skipped_nonfinite'] != 0.0:
            fail(f'{pairing} step {i}: loss {rec["loss"]}, skipped {rec["skipped_nonfinite"]}')
        if rec['launches'] != per_step:
            fail(f'{pairing} step {i}: launches {rec["launches"]}, expected {per_step}')
        unchanged = [k for k in watch if torch.equal(state.model.state_dict()[k], before[k])]
        if unchanged:
            fail(f'{pairing} step {i}: parameters did not change: {unchanged}')
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = sum(r['step_ms'] for r in steps[1:]) / TRAIN_STEPS
    flops = step_flops(cfg)
    emit({'phase': 'rope_train' if rope else 'train', 'attention_bwd': pairing[0],
          'remat_policy': pairing[1],
          'clips': TRAIN_B, 'queries': TRAIN_Q, 'steps': steps, 'launches': launches,
          'launches_per_step': per_step, 'step_ms': step_ms,
          'clips_per_s': TRAIN_B / (step_ms / 1e3), 'max_memory_allocated_bytes': peak,
          'step_matmul_flops': flops, 'step_bound_ms': 1e3 * flops / PEAK_BF16_FLOPS})
    return dict(cfg=cfg, state=state, train_step=train_step, batch=batch,
                launches=launches, step_ms=step_ms, peak=peak)


def record_init(rope=False):
    '''The step of record's seeded initial parameters, as phase_train draws them (the
    rope256 step's with rope), and its batch on the card: phase_train_parity's inputs.'''
    cfg = train_config(torch.bfloat16, rope=rope)
    state = step_lib.init_train_state(SEED, cfg, dp_optimizer(), device=DEV)
    return state.model.state_dict(), train_batch(rope)


def loss_and_flat_grad(model, cfg, batch, plain):
    '''(loss, every parameter gradient concatenated in f32) of one batch, drop-path off.'''
    model.zero_grad(set_to_none=True)
    with plain_attention() if plain else contextlib.nullcontext():
        loss, _ = step_lib.loss_and_aux(model, cfg, batch, None, TRAIN_PROGRESS, True)
        loss.backward()
    grad = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().flatten()
                      for p in model.parameters()])
    return float(loss.detach()), grad


def model_from(cfg, state_dict):
    model = MaskTracker(cfg.seeker, device=DEV)
    model.load_state_dict(state_dict)
    return model


def phase_train_parity(init_state, batch, rope=False, keep=False):
    '''First-step loss and gradient with drop-path off, for each backward mode under its
    pairing: the bf16 kernel path against the f32 plain path, whose error may be at most
    TRAIN_BF16_ERR_RATIO x the bf16 plain path's; and f32 kernel vs f32 plain at depth 2.
    The plain paths run under full remat (a policy never changes a result). With rope the
    rope256 step on the batch with frame times. Returns the relative errors, and with keep
    also the losses and the gradients on the host that phase dp holds its ranks against:
    the f32 and bf16 plain paths' and the step of record's (bf16, and f32 at depth 2).'''
    kept = {}
    rel = lambda a, b: abs(a - b) / abs(b)
    plain = (STEP_OF_RECORD[0], 'full')
    cfg16, cfg32 = (train_config(dt, 0.0, pairing=plain, rope=rope)
                    for dt in (torch.bfloat16, torch.float32))
    model = model_from(cfg32, init_state)
    loss_r, grad_r = loss_and_flat_grad(model, cfg32, batch, plain=True)
    del model
    model = model_from(cfg16, init_state)
    loss_p, grad_p = loss_and_flat_grad(model, cfg16, batch, plain=True)
    del model
    if keep:
        kept.update(plain_f32=grad_r.cpu(), plain_bf16=grad_p.cpu())
    errs = {'loss_plain_bf16': rel(loss_p, loss_r), 'grad_plain_bf16': rel_l2(grad_p, grad_r)}
    losses = {'plain_bf16': loss_p, 'plain_f32': loss_r}
    del grad_p
    for pairing in PAIRINGS:
        mode = pairing[0]
        cfg = train_config(torch.bfloat16, 0.0, pairing=pairing, rope=rope)
        model = model_from(cfg, init_state)
        losses[f'kernel_bf16_{mode}'], grad_k = loss_and_flat_grad(model, cfg, batch,
                                                                   plain=False)
        del model
        errs[f'loss_kernel_bf16_{mode}'] = rel(losses[f'kernel_bf16_{mode}'], loss_r)
        errs[f'grad_kernel_bf16_{mode}'] = rel_l2(grad_k, grad_r)
        if keep and pairing == STEP_OF_RECORD:
            kept['kernel_bf16'] = grad_k.cpu()
        del grad_k
    del grad_r
    with depth_preset(2, (D, HEADS)):
        cfg2 = train_config(torch.float32, 0.0, depth=2, pairing=plain, rope=rope)
        model = MaskTracker(cfg2.seeker, device=DEV)
        model.init_params_(torch.Generator().manual_seed(SEED))
        state2 = model.state_dict()
        losses['plain_f32_depth2'], grad_p2 = loss_and_flat_grad(model, cfg2, batch, plain=True)
        del model
        for pairing in PAIRINGS:
            mode = pairing[0]
            cfg = train_config(torch.float32, 0.0, depth=2, pairing=pairing, rope=rope)
            model = model_from(cfg, state2)
            loss_k2, grad_k2 = loss_and_flat_grad(model, cfg, batch, plain=False)
            del model
            losses[f'kernel_f32_depth2_{mode}'] = loss_k2
            errs[f'loss_kernel_vs_plain_f32_depth2_{mode}'] = rel(loss_k2,
                                                                  losses['plain_f32_depth2'])
            errs[f'grad_kernel_vs_plain_f32_depth2_{mode}'] = rel_l2(grad_k2, grad_p2)
            if keep and pairing == STEP_OF_RECORD:
                kept['kernel_f32_depth2'] = grad_k2.cpu()
    ratios = {}
    for mode, _ in PAIRINGS:
        for what in ('loss', 'grad'):
            ratios[f'{what}_{mode}'] = (errs[f'{what}_kernel_bf16_{mode}']
                                        / errs[f'{what}_plain_bf16'])
            if not errs[f'{what}_kernel_bf16_{mode}'] <= (TRAIN_BF16_ERR_RATIO
                                                          * errs[f'{what}_plain_bf16']):
                fail(f'train parity ({mode}): bf16 {what} error of the kernel path '
                     f'{errs[f"{what}_kernel_bf16_{mode}"]} > {TRAIN_BF16_ERR_RATIO} x the '
                     f'plain path\'s {errs[f"{what}_plain_bf16"]}')
            key = f'{what}_kernel_vs_plain_f32_depth2_{mode}'
            if not errs[key] <= TOL_TRAIN_F32:
                fail(f'train parity ({mode}): f32 {what} kernel vs plain at depth 2 '
                     f'{errs[key]} > {TOL_TRAIN_F32}')
    emit({'phase': 'rope_train_parity' if rope else 'train_parity', 'losses': losses,
          'rel_err': errs,
          'bf16_err_ratio': ratios, 'bf16_err_ratio_limit': TRAIN_BF16_ERR_RATIO,
          'tol_f32_depth2': TOL_TRAIN_F32})
    if keep:
        return errs, dict(losses=losses, grads=kept)
    return errs


def library_bwd_core(qkv, dattn, ca, cs, heads=None):
    '''The backward core's function by library calls (yardstick only): SDPA's forward for
    attn and its autograd backward for dq, dk and dv, on the q, k, v views of qkv with the
    same mask; with rope tables cs, q and k go through apply_rope inside the graph.'''
    B, S, d = dattn.shape
    heads = heads or HEADS
    q, k, v = (t.detach().requires_grad_()
               for t in qkv.reshape(B, S, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0))
    da = dattn.reshape(B, S, heads, d // heads).transpose(1, 2)
    with torch.enable_grad():
        attn = F.scaled_dot_product_attention(*rotate(q, k, cs), v, is_causal=ca > 0)
        return attn, torch.autograd.grad(attn, (q, k, v), da)


def library_attention_bwd(x, w16, ca, g, qkv=None, wgrads=False, cs=None, heads=None):
    '''K4's function, (dqkv, attn) from x and g, with library calls (yardstick only): the
    qkv recompute and g . proj_w^T as addmm / mm, then SDPA's forward for attn and its
    autograd backward for dq, dk and dv. With qkv given, no recompute: K5's function.
    With wgrads, also the rest of K6's function: dx and the weight gradients as mm, the
    bias gradients as sums. With rope tables cs, q and k go through apply_rope inside
    the autograd graph, so dq and dk come back un-rotated.'''
    B, S, d = x.shape

    def run():
        qkv_ = torch.addmm(w16[1], x.reshape(B * S, d), w16[0]) if qkv is None else qkv
        g2 = g.reshape(B * S, d)
        attn, grads = library_bwd_core(qkv_.reshape(B, S, 3 * d),
                                       torch.mm(g2, w16[2].T).reshape(B, S, d), ca, cs, heads)
        if not wgrads:
            return attn, grads
        dqkv = torch.stack(grads).permute(1, 3, 0, 2, 4).reshape(B * S, 3 * d)
        attn2 = attn.detach().transpose(1, 2).reshape(B * S, d)
        f32 = torch.float32
        return (torch.mm(dqkv, w16[0].T), torch.mm(x.reshape(B * S, d).T, dqkv, out_dtype=f32),
                dqkv.sum(dim=0, dtype=f32), torch.mm(attn2.T, g2, out_dtype=f32),
                g2.sum(dim=0, dtype=f32))
    return run


# Each kernel's (operations, bytes) as functions of (B, S, ca) and (B, S, itemsize).
KERNEL_COST = {'K1': (k1_flops, k1_bytes), 'K2': (k1_flops, k2_bytes),
               'K3': (k1_flops, k3_bytes), 'K4': (k4_flops, k4_bytes),
               'K5': (k5_flops, k5_bytes), 'K6': (k6_flops, k6_bytes)}


def attention_calls(x, g, qkv, w, w16, ca):
    '''Each kernel's (kernel call, plain call, library call) on x, g (B, S, D) and the
    saved qkv (B, S, 3D), as thunks.'''
    return {
        'K1': (lambda: fa.fused_attention_fwd(x, *w, HEADS, ca),
               lambda: fa.attention_ref(x, *w, HEADS, ca),
               lambda: library_attention(x, w16, ca)),
        'K2': (lambda: fa.fused_attention_fwd_qkv(x, *w, HEADS, ca),
               lambda: fa.attention_qkv_ref(x, *w, HEADS, ca),
               lambda: library_attention(x, w16, ca)),
        'K3': (lambda: fa.fused_attention_fwd_res(x, *w, HEADS, ca),
               lambda: fa.attention_res_ref(x, *w, HEADS, ca),
               lambda: library_attention_probs(x, w16, ca)),
        'K4': (lambda: fa.fused_attention_bwd(x, g, *w[:3], HEADS, ca),
               lambda: fa.attention_bwd_ref(x, g, *w[:3], HEADS, ca),
               library_attention_bwd(x, w16, ca, g)),
        'K5': (lambda: fa.fused_attention_bwd_qkv(qkv, g, w[2], HEADS, ca),
               lambda: fa.attention_bwd_qkv_ref(qkv, g, w[2], HEADS, ca),
               library_attention_bwd(x, w16, ca, g, qkv=qkv)),
        'K6': (lambda: fa.fused_attention_bwd_wg(x, g, *w[:3], HEADS, ca),
               lambda: fa.attention_bwd_wg_ref(x, g, *w[:3], HEADS, ca),
               library_attention_bwd(x, w16, ca, g, wgrads=True)),
    }


def phase_train_times(train):
    '''Every kernel per call at the training geometries beside its plain version, its
    library yardstick and its bound; then a kernel-path step of record against a
    plain-path step, alternated in this process: plain, kernel, kernel, plain.'''
    per_geom = {k: {} for k in KERNELS}
    for i, (name, (B, S, ca)) in enumerate(TRAIN_GEOMETRIES.items()):
        x, w = attn_inputs(B, S, torch.bfloat16, SEED + 200 + i)
        g = grad_input(B, S, torch.bfloat16, SEED + 210 + i)
        w16 = [a.to(torch.bfloat16) for a in w]
        with torch.no_grad():
            qkv = fa.fused_attention_fwd_qkv(x, *w, HEADS, ca)[1]
        calls = attention_calls(x, g, qkv, w, w16, ca)
        with torch.no_grad():
            for kernel, (run, plain, library) in calls.items():
                flops_fn, bytes_fn = KERNEL_COST[kernel]
                flops, nbytes = flops_fn(B, S, ca), bytes_fn(B, S, 2)
                bound_ms, bound_by = bound(flops, nbytes)
                per_geom[kernel][name] = dict(
                    B=B, S=S, ca=ca, ms=cuda_ms(run, iters=10),
                    plain_ms=cuda_ms(plain, iters=10), library_ms=cuda_ms(library, iters=10),
                    bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
        del x, g, qkv, calls
    state, train_step, batch = train['state'], train['train_step'], train['batch']
    runs = []
    for plain in (True, False, False, True):
        state, _, ms, _ = timed_step(train_step, state, batch, plain=plain)
        runs.append(('plain' if plain else 'kernel', ms))
    emit({'phase': 'train_times', 'per_call': per_geom, 'step_ms_alternated': runs})
    return per_geom


# ---------------------------------------------------------------------------------------
# The training step's device side: colour augmentation, grad_accum, LAMB, remat_group,
# full train state in checkpoints, per-example eval and the vis step
# ---------------------------------------------------------------------------------------

# Colour augmentation of the device-side batch, per clip: jitter on both, blur on the
# first, grayscale on the second.
DEVICE_AUGS = dict(jitter=[1, 1], blur=[1, 0], gray=[0, 1])
# The augmented rgb on the card against the same function on the CPU (max abs): f32
# elementwise work, reductions (per-frame luma means) in another order.
TOL_AUG = 1e-5
GRAD_ACCUM = 2
REMAT_GROUPS = (2, 4)
# Per-example eval (one batched forward, losses per clip) against B = 1 eval steps, bf16,
# relative per loss and metric sum, and the vis step's loss against clip 0's: equal bits,
# as two full-width runs on the H100 read them (0.0 both).
TOL_PER_EXAMPLE = 0.0


def device_side_batch():
    '''The batch of record with its colour-augmentation keys (DEVICE_AUGS), on the card.'''
    b = train_batch()
    augs = synthetic_color_augs(SEED, TRAIN_B, **DEVICE_AUGS)
    b.update({k: torch.as_tensor(v, device=DEV) for k, v in augs.items()})
    return b


def drive_steps(what, train_step, state, batch, per_step, steps=1 + TRAIN_STEPS):
    '''`steps` train steps (the first a warm-up), each checked for a finite loss, an
    applied update and exactly `per_step` launches; returns (state, records, mean ms of
    the timed steps, peak bytes). The peak is reset before the first step.'''
    watch = 'backbone.blocks.0.attn.qkv.w'
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recs = []
    for i in range(steps):
        before = state.model.state_dict()[watch].clone()
        counts = read_launches()
        state, aux, ms, host_ms = timed_step(train_step, state, batch)
        got = launches_since(counts)
        recs.append(dict(step=i, step_ms=ms, host_ms=host_ms, loss=float(aux['total_seeker']),
                         grad_norm=float(aux['grad_norm']), launches=got))
        if not np.isfinite(recs[-1]['loss']) or float(aux['skipped_nonfinite']) != 0.0:
            fail(f'{what} step {i}: loss {recs[-1]["loss"]}, skipped')
        if got != per_step:
            fail(f'{what} step {i}: launches {got}, expected {per_step}')
        if torch.equal(state.model.state_dict()[watch], before):
            fail(f'{what} step {i}: parameters did not change')
    timed = [r['step_ms'] for r in recs[1:]]
    return state, recs, sum(timed) / len(timed), torch.cuda.max_memory_allocated()


def accumulated_loss_and_grad(cfg, init_state, batch, plain, grad_accum):
    '''(loss, every gradient concatenated in f32) of one make_train_step(grad_accum) step
    from init_state, read before any update: SGD at rate 0 without clipping leaves the
    averaged gradients in .grad and the parameters as they were.'''
    tx = optim.make_optimizer('sgd', learn_rate=0.0, gradient_clip=0.0)
    state = step_lib.init_train_state(SEED, cfg, tx, device=DEV)
    state.model.load_state_dict(init_state)
    with plain_attention() if plain else contextlib.nullcontext():
        _, aux = step_lib.make_train_step(cfg, grad_accum=grad_accum)(state, batch,
                                                                      TRAIN_PROGRESS)
    grad = torch.cat([p.grad.float().flatten() for p in state.model.parameters()])
    return float(aux['total_seeker']), grad


def with_seeker(cfg, **kw):
    return dataclasses.replace(cfg, seeker=dataclasses.replace(cfg.seeker, **kw))


def phase_train_device_side(ckpt_dir):
    '''The training step of record (kernel_x / dots_nb_out, bf16, full width) with the
    device side of training, on a batch carrying colour-augmentation keys: (a) the
    augmented rgb on the card against the CPU; (b) grad_accum=2 beside grad_accum=1
    (launches, step ms, peak; the bf16 gradient error against the f32 plain path at most
    TRAIN_BF16_ERR_RATIO x the bf16 plain path's); (c) LAMB; (d) remat_group 2 and 4
    (launches as G = 1, gradients bit-equal to G = 1 with drop-path off); (e) a
    full-state checkpoint round trip continuing bit for bit; (f) per-example eval
    against B = 1 eval steps, and the vis step. Kernel launches are counted from 0 over
    the phase.'''
    out = {'phase': 'train_device_side'}
    batch = device_side_batch()
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    # (a) colour augmentation.
    rgb = step_lib.unpack_batch(batch, DEV)['rgb']
    rgb_cpu = step_lib.unpack_batch(cpu_batch, 'cpu')['rgb']
    err = float((rgb.cpu() - rgb_cpu).abs().max())
    moved = float((rgb - batch['rgb']).abs().max())
    if not err <= TOL_AUG or not moved > 0.01:
        fail(f'device augmentation: card vs CPU {err} (limit {TOL_AUG}), change {moved}')
    out['augs'] = dict(per_clip=DEVICE_AUGS, max_abs_card_vs_cpu=err, tol=TOL_AUG,
                       max_abs_change=moved,
                       ms=cuda_ms(lambda: step_lib.unpack_batch(batch, DEV), iters=5))
    del rgb, rgb_cpu, cpu_batch

    reset_launches()
    cfg = train_config(torch.bfloat16)
    depth = cfg.seeker.network_depth
    one = {'K1': 2 * depth, 'K4': 2 * depth}
    adamw = lambda: optim.make_optimizer('adamw', learn_rate=1e-4, num_epochs=70,
                                         steps_per_epoch=1000, gradient_clip=0.3)
    rel = lambda a, b: abs(a - b) / abs(b)
    # (b) grad_accum 1 and 2 on the same batch.
    steps = {}
    for A in (1, GRAD_ACCUM):
        state = step_lib.init_train_state(SEED, cfg, adamw(), device=DEV)
        if A == 1:
            init_state = {k: v.clone() for k, v in state.model.state_dict().items()}
        per_step = {k: n * A for k, n in one.items()}
        state, recs, ms, peak = drive_steps(f'grad_accum={A}',
                                            step_lib.make_train_step(cfg, A), state, batch,
                                            per_step)
        steps[f'grad_accum_{A}'] = dict(step_ms=ms, max_memory_allocated_bytes=peak,
                                        launches_per_step=per_step, steps=recs)
        del state
    plain = (STEP_OF_RECORD[0], 'full')
    runs = {name: accumulated_loss_and_grad(train_config(dt, 0.0, pairing=pairing),
                                            init_state, batch, is_plain, GRAD_ACCUM)
            for name, dt, pairing, is_plain in (
                ('plain_f32', torch.float32, plain, True),
                ('plain_bf16', torch.bfloat16, plain, True),
                ('kernel_bf16', torch.bfloat16, STEP_OF_RECORD, False))}
    loss_r, grad_r = runs['plain_f32']
    errs = {}
    for name in ('plain_bf16', 'kernel_bf16'):
        errs[f'loss_{name}'] = rel(runs[name][0], loss_r)
        errs[f'grad_{name}'] = rel_l2(runs[name][1], grad_r)
    del runs, grad_r
    ratios = {w: errs[f'{w}_kernel_bf16'] / errs[f'{w}_plain_bf16'] for w in ('loss', 'grad')}
    for w, r in ratios.items():
        if not r <= TRAIN_BF16_ERR_RATIO:
            fail(f'grad_accum={GRAD_ACCUM}: bf16 {w} error ratio {r} > {TRAIN_BF16_ERR_RATIO}')
    steps[f'grad_accum_{GRAD_ACCUM}'].update(rel_err=errs, bf16_err_ratio=ratios)
    # (c) LAMB.
    tx = optim.make_optimizer('lamb', learn_rate=1e-4, num_epochs=70, steps_per_epoch=1000,
                              gradient_clip=0.3)
    state = step_lib.init_train_state(SEED, cfg, tx, device=DEV)
    state, recs, ms, peak = drive_steps('lamb', step_lib.make_train_step(cfg), state, batch,
                                        one)
    steps['lamb'] = dict(step_ms=ms, max_memory_allocated_bytes=peak, steps=recs)
    del state
    # (d) remat_group: launches, step time and peak with G blocks per region; then the
    # gradients with drop-path off against G = 1.
    for G in REMAT_GROUPS:
        cfg_g = with_seeker(cfg, remat_group=G)
        state = step_lib.init_train_state(SEED, cfg_g, adamw(), device=DEV)
        state, recs, ms, peak = drive_steps(f'remat_group={G}',
                                            step_lib.make_train_step(cfg_g), state, batch,
                                            one)
        del state
        steps[f'remat_group_{G}'] = dict(step_ms=ms, max_memory_allocated_bytes=peak,
                                         launches_per_step=one, steps=recs)
    grads = {}
    for G in (1,) + REMAT_GROUPS:
        cfg0 = with_seeker(cfg, drop_path_rate=0.0, remat_group=G)
        grads[G] = loss_and_flat_grad(model_from(cfg0, init_state), cfg0, batch, plain=False)[1]
    for G in REMAT_GROUPS:
        if not torch.equal(grads[G], grads[1]):
            fail(f'remat_group={G}: gradients differ from G = 1 '
                 f'(rel L2 {rel_l2(grads[G], grads[1])})')
        steps[f'remat_group_{G}']['grads_equal_g1'] = True
    del grads
    # (e) full train state: save after step 1, load into a fresh state, one more step.
    train_step = step_lib.make_train_step(cfg)
    state = step_lib.init_train_state(SEED, cfg, adamw(), device=DEV)
    state, *_ = timed_step(train_step, state, batch)
    path = save_train_state(str(ckpt_dir), 0, 'chip_smoke_state', state)
    fresh = step_lib.init_train_state(SEED + 1, cfg, adamw(), device=DEV)
    load_checkpoint(path, fresh)
    state, *_ = timed_step(train_step, state, batch)
    fresh, *_ = timed_step(train_step, fresh, batch)
    pairs = list(zip(state.model.parameters(), fresh.model.parameters()))
    same = all(torch.equal(a, b) for a, b in pairs)
    same_moments = all(torch.equal(state.optimizer.torch_opt.state[a][k],
                                   fresh.optimizer.torch_opt.state[b][k])
                       for a, b in pairs for k in ('exp_avg', 'exp_avg_sq'))
    if not (same and same_moments and fresh.step == state.step == 2):
        fail(f'train state round trip: params equal {same}, moments equal {same_moments}, '
             f'steps {state.step} / {fresh.step}')
    out['checkpoint_round_trip'] = dict(params_equal=same, moments_equal=same_moments,
                                        bytes=os.path.getsize(path))
    del state, fresh, pairs
    # (f) per-example eval and the vis step.
    torch.cuda.empty_cache()
    model = model_from(cfg, init_state)
    per_example = step_lib.make_eval_step(cfg, per_example=True)
    vis_step = step_lib.make_vis_step(cfg)
    counts = read_launches()
    got = per_example(model, batch, TRAIN_PROGRESS)
    if launches_since(counts) != {'K1': 2 * depth}:
        fail(f'per-example eval launched {launches_since(counts)}')
    eval_errs, singles = {}, []
    for b in range(TRAIN_B):
        singles.append(step_lib.make_eval_step(cfg)(
            model, {k: (v[b:b + 1] if v.dim() else v) for k, v in batch.items()},
            TRAIN_PROGRESS))
        for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker'):
            eval_errs[f'{k}_{b}'] = rel(float(got[k][b]), float(singles[b][k]))
        for k, v in singles[b]['metric_sums'].items():
            eval_errs[f'{k}_{b}'] = (abs(float(got['metric_sums'][k][b]) - float(v))
                                     / max(abs(float(v)), 1.0))
    worst = max(eval_errs.values())
    if not worst <= TOL_PER_EXAMPLE:
        fail(f'per-example eval vs B = 1 eval: rel error {worst} > {TOL_PER_EXAMPLE}')
    vis = vis_step(model, batch, TRAIN_PROGRESS)
    vis_err = rel(float(vis['total_seeker']), float(singles[0]['total_seeker']))
    shape = tuple(batch['rgb'].shape[2:])
    want_shapes = {'seeker_rgb': (1, 3) + shape, 'output_mask': (1, 2, 3) + shape}
    bad = [k for k, shp in want_shapes.items()
           if tuple(vis[k].shape) != shp or vis[k].dtype != torch.float16
           or not bool(torch.isfinite(vis[k]).all())]
    if bad or not vis_err <= TOL_PER_EXAMPLE:
        fail(f'vis step: payload {bad}, loss vs B = 1 eval {vis_err}')
    out['eval'] = dict(
        per_example_max_rel_err=worst, tol=TOL_PER_EXAMPLE, vis_loss_rel_err=vis_err,
        per_example_ms=cuda_ms(lambda: per_example(model, batch, TRAIN_PROGRESS), iters=3),
        vis_ms=cuda_ms(lambda: vis_step(model, batch, TRAIN_PROGRESS), iters=3))
    del model
    torch.cuda.empty_cache()
    out.update(steps=steps, launches=read_launches())
    emit(out)
    return out


# ---------------------------------------------------------------------------------------
# The training path's host side: the Kubric loader, the epoch driver and train_torch.py
# ---------------------------------------------------------------------------------------

# A synthetic Kubric-format dataset written by the port: (split, scenes, first seed).
# Frames: T = 30 plus kubric_max_delay 6 at 240x320; 8 objects with rich events keep Q = 3
# sampleable (an object hidden at the query frame is unsampleable).
DRIVER_SPLITS = (('train', 8, SEED), ('val', 2, SEED + 100))
DRIVER_MAX_DELAY = 6
DRIVER_FRAMES = SEEKER_ARGS['num_total_frames'] + DRIVER_MAX_DELAY
# The rope256 run loads every second frame: 36 load indices reach frame 70.
ROPE_DRIVER_SCENES = 4
ROPE_DRIVER_FRAMES = (DRIVER_FRAMES - 1) * ROPE_FRAME_STRIDE + 1
DRIVER_EPOCHS = 2
# Steps per epoch: 8 train scenes and 2 val scenes in batches of TRAIN_B; rope256's 4.
DRIVER_TRAIN_STEPS = 4
DRIVER_VAL_STEPS = 1
ROPE_DRIVER_STEPS = 2
# The driver runs its vis step at every 16th global train step (utils/logvis.py:
# MyLogger.step_interval of a train run), so at step 0 of these short runs.
DRIVER_VIS_EVERY = 16
# Launches per step through the driver: the step of record, its val and vis steps (a
# forward, no backward), and rope256 (the temporal half of each kind rotated).
DRIVER_PER_STEP = {'train': {'K1': 24, 'K4': 24}, 'val_aug': {'K1': 24},
                   'val_noaug': {'K1': 24}, 'vis': {'K1': 24}}
DRIVER_PER_ROPE_STEP = {'train': {'K1': 12, 'K1r': 12, 'K4': 12, 'K4r': 12},
                        'vis': {'K1': 12, 'K1r': 12}}
# A driver log must hold none of these: a step the driver tolerated and skipped leaves a
# traceback, a failed vis step or overlay a warning, a non-finite loss a skipped update.
DRIVER_LOG_FAULTS = ('Traceback', 'visualization failed', 'overlay rendering failed',
                     'loss = NaN')
# The overlay videos of a train vis step (logvis.py:_save_query_overlays): the first two
# queries of example 0, each with input, heat map, three channels and loss weights.
VIS_VIDEOS = tuple(f'e0_ptrain_s0_q{q}_{kind}' for q in (0, 1)
                   for kind in ('in', 'out_sn', 'out_oc', 'slw'))
# Run 5: --device_augs 0, the host colour path, 1 epoch of 2 steps (half the train scenes).
HOST_AUGS_STEPS = 2
# SIGTERM lands during this step of epoch 0 (1-based): the mid-epoch checkpoint then holds
# this many completed steps.
PREEMPT_STEPS_DONE = 2
# If the resumed run is not bit-equal to the uninterrupted one: relative L2 limit over the
# final parameters and over each AdamW moment.
TOL_RESUME = 1e-2
RUN_TIMEOUT_S = 300
STEP_STATS = re.compile(r'step_stats (\{.*\})')
ACCOUNTING = re.compile(r'\[(\w+)\] epoch (\d+) wall ([\d.]+)s over (\d+) steps: loader '
                        r'wait ([\d.]+)s')


def driver_argv(root, workdir, name, *extra):
    return ['--name', name, '--data_path', str(root),
            '--checkpoint_root', str(workdir / 'checkpoints'),
            '--log_root', str(workdir / 'logs'),
            '--batch_size', str(TRAIN_B), '--num_queries', str(TRAIN_Q),
            '--num_frames', str(SEEKER_ARGS['num_total_frames']),
            '--frame_height', str(SEEKER_ARGS['frame_height']),
            '--frame_width', str(SEEKER_ARGS['frame_width']), '--device', DEV,
            '--kubric_max_delay', str(DRIVER_MAX_DELAY), '--max_objects', str(TRAIN_M),
            '--causal_attention', '1', '--compute_dtype', 'bfloat16',
            '--drop_path_rate', '0.1', '--optimizer', 'adamw', '--learn_rate', '1e-4',
            '--gradient_clip', '0.3', '--num_epochs', str(DRIVER_EPOCHS),
            '--val_every', '1', '--do_val_aug', '1', '--do_val_noaug', '1',
            '--checkpoint_every', '1', '--num_workers', '4', '--avoid_wandb', '2',
            '--tracker_pretrained', SEEKER_ARGS['tracker_pretrained'],
            '--seed', str(SEED), '--log_level', 'debug', *extra]


def write_dataset(root, splits, frames):
    '''Writes the scenes with the port's writer, one thread per scene (zlib and numpy
    release the interpreter lock); returns (seconds, bytes on disk).'''
    t0 = time.perf_counter()
    jobs = [(str(root / split / f'{split}_scn{i:05d}'), seed + i)
            for split, n, seed in splits for i in range(n)]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: write_synthetic_kubric_scene(
            job[0], job[1], T=frames, H=SEEKER_ARGS['frame_height'],
            W=SEEKER_ARGS['frame_width'], K=TRAIN_K, rich_events=True), jobs))
    seconds = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in root.rglob('*') if f.is_file())
    return seconds, nbytes


# The Kubric datasets the phases read, written on a thread while the kernels build
# (prewrite_datasets): name -> future of (root, seconds, bytes on disk).
DATA_DIR = _build.BUILD_DIR / 'chip_smoke_data'
DATASETS = {}


def dataset_specs():
    '''name -> (splits, frames) of every dataset a phase reads.'''
    return {'driver': (DRIVER_SPLITS, DRIVER_FRAMES),
            'driver_rope': ((('train', ROPE_DRIVER_SCENES, SEED + 200),), ROPE_DRIVER_FRAMES),
            'eval': ((('test', EVAL_SCENES, SEED + 300),), DRIVER_FRAMES),
            'pth': ((('train', PTH_TRAIN_SCENES, SEED + 400),), DRIVER_FRAMES),
            'tp_driver': ((('train', TP_DRIVER_SCENES, SEED + 500),), DRIVER_FRAMES),
            'sp_driver': ((('train', TP_DRIVER_SCENES, SEED + 600),), DRIVER_FRAMES),
            'pp_driver': ((('train', TP_DRIVER_SCENES, SEED + 700),), DRIVER_FRAMES),
            'stream_long': ((('test', STREAM_EVAL_SCENES, SEED + 300),), STREAM_EVAL_FRAMES)}


def prewrite_datasets():
    '''Starts writing every dataset of dataset_specs under DATA_DIR, one after another on
    one thread; the writer's own threads use the cores that nvcc leaves idle.'''
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    for name, (splits, frames) in dataset_specs().items():
        root = DATA_DIR / name
        DATASETS[name] = pool.submit(lambda r=root, sp=splits, f=frames:
                                     (r, *write_dataset(r, sp, f)))
    pool.shutdown(wait=False)


def dataset(name):
    '''(root, seconds its writing took, bytes) of a dataset of dataset_specs, once written.'''
    return DATASETS[name].result()


def parse_steps(log_text):
    return [json.loads(m.group(1)) for m in STEP_STATS.finditer(log_text)]


def driver_records(epochs, steps=DRIVER_TRAIN_STEPS, start_step=0, stop_after=None,
                   val=True):
    '''The (phase, epoch, step) of every step_stats line a driver run must log, in order:
    train steps from start_step of epoch 0, each followed by its vis step where one runs,
    then both val phases; with stop_after = (epoch, step), the run ends there (SIGTERM).'''
    out = []
    for epoch in range(epochs):
        for step in range(start_step if epoch == 0 else 0, steps):
            out.append(('train', epoch, step))
            if (epoch * steps + step) % DRIVER_VIS_EVERY == 0:
                out.append(('vis', epoch, step))
            if stop_after == (epoch, step):
                return out
        if val:
            out += [(phase, epoch, step) for phase in ('val_aug', 'val_noaug')
                    for step in range(DRIVER_VAL_STEPS)]
    return out


def check_steps(name, text, want, per_step):
    '''A driver run's log: exactly the step_stats lines of `want`, each with the launches
    per_step gives its phase, and none of DRIVER_LOG_FAULTS. Returns the records.'''
    faults = [f for f in DRIVER_LOG_FAULTS if f in text]
    if faults:
        print(text[-4000:], file=sys.stderr)
        fail(f'{name}: the driver log holds {faults}')
    steps = parse_steps(text)
    got = [(r['phase'], r['epoch'], r['step']) for r in steps]
    if got != want:
        fail(f'{name}: steps {got}, expected {want}')
    for r in steps:
        if r['launches'] != per_step[r['phase']]:
            fail(f'{name}: {r["phase"]} epoch {r["epoch"]} step {r["step"]} launched '
                 f'{r["launches"]}, expected {per_step[r["phase"]]}')
    return steps


def epoch_stats(steps, log_text):
    '''Per phase and epoch: the host wall ms of each step, their median after the first,
    the loader-wait share of the steps after the first (wait / (wait + step)), and the
    driver's own accounting line.'''
    acct = {(m.group(1), int(m.group(2))): dict(
        wall_s=float(m.group(3)), steps=int(m.group(4)), loader_wait_s=float(m.group(5)))
        for m in ACCOUNTING.finditer(log_text)}
    out = {}
    steps = [r for r in steps if r['phase'] != 'vis']
    for key in sorted({(r['phase'], r['epoch']) for r in steps}):
        recs = [r for r in steps if (r['phase'], r['epoch']) == key]
        walls = [r['wall_ms'] for r in recs]
        later = recs[1:]
        wait = sum(r['wait_ms'] for r in later)
        busy = sum(r['wall_ms'] for r in later)
        out[f'{key[0]}_e{key[1]}'] = dict(
            step_wall_ms=walls, first_wait_ms=recs[0]['wait_ms'],
            median_wall_ms_after_first=float(np.median(walls[1:])) if later else None,
            loader_wait_share_after_first=wait / (wait + busy) if later else None,
            accounting=acct.get(key))
    return out


def run_driver(argv, log_fp, sigterm_after_step=None):
    '''python train_torch.py argv as a subprocess (real argv, real signals), its output to
    log_fp; with sigterm_after_step=k, SIGTERM is sent once train step k of epoch 0
    (0-based) has logged, which the driver does after that step's preemption check: step
    k + 1 is then in flight or waiting for its batch, and the run stops after it. Returns
    (log text, wall seconds); fails on a non-zero exit or after RUN_TIMEOUT_S.'''
    t0 = time.perf_counter()
    with open(log_fp, 'w') as log:
        proc = subprocess.Popen([sys.executable, 'train_torch.py', *argv], stdout=log,
                                stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            while proc.poll() is None:
                if time.perf_counter() - t0 > RUN_TIMEOUT_S:
                    fail(f'train_torch.py {argv[1]} took over {RUN_TIMEOUT_S} s')
                if sigterm_after_step is not None and any(
                        r['phase'] == 'train' and r['epoch'] == 0
                        and r['step'] == sigterm_after_step
                        for r in parse_steps(log_fp.read_text())):
                    proc.send_signal(signal.SIGTERM)
                    sigterm_after_step = None
                time.sleep(0.05)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = log_fp.read_text()
    if proc.returncode != 0:
        print(text[-4000:], file=sys.stderr)
        fail(f'train_torch.py {argv[1]} exited {proc.returncode}')
    return text, time.perf_counter() - t0


def checkpoint_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != '__meta__'}


def compare_final_states(want_fp, got_fp):
    '''Run 3's final checkpoint against run 1's: bit-equal, or the relative L2 of the
    parameters and of each AdamW moment, held to TOL_RESUME.'''
    want, got = checkpoint_arrays(want_fp), checkpoint_arrays(got_fp)
    if set(want) != set(got):
        fail(f'resumed checkpoint keys differ: {sorted(set(want) ^ set(got))[:5]}')
    differ = sorted(k for k in want if not np.array_equal(want[k], got[k]))
    out = {'bit_equal': not differ, 'arrays': len(want), 'arrays_differing': len(differ),
           'first_differing': differ[:5]}
    if differ:
        for group, prefix in (('params', 'params'), ('mu', 'opt_state[1][0].mu'),
                              ('nu', 'opt_state[1][0].nu')):
            keys = [k for k in want if k.startswith(prefix)]
            w = torch.cat([torch.from_numpy(want[k]).double().flatten() for k in keys])
            g = torch.cat([torch.from_numpy(got[k]).double().flatten() for k in keys])
            out[f'rel_l2_{group}'] = float((g - w).norm() / w.norm())
        worst = max(out[f'rel_l2_{g}'] for g in ('params', 'mu', 'nu'))
        if not worst <= TOL_RESUME:
            fail(f'resumed run vs uninterrupted run: rel L2 {worst} > {TOL_RESUME}')
    return out


def host_checks(root):
    '''Item times (uncached: decode + preprocess + cache write; cached), one collated
    batch's host->device copy from pinned and from pageable memory, and one batch through
    _H2DPrefetcher against the same batch through unpack_batch(device='cuda'), bit for
    bit.'''
    args = config_lib.train_args(driver_argv(root, root, '')[2:])
    ds = kubric_lib.KubricQueryDataset(str(root), None, 'train', seed=SEED,
                                       **factory.kubric_dset_args(args))
    t0 = time.perf_counter()
    items = [ds[0]]
    uncached_s = time.perf_counter() - t0
    cached = []
    for _ in range(3):
        t0 = time.perf_counter()
        items.append(ds[0])
        cached.append(time.perf_counter() - t0)
    host = factory.make_kubric_collate(TRAIN_Q, 'train', SEED)(items[-TRAIN_B:])['device']

    def copy_ms(pinned):
        src = {k: torch.from_numpy(np.array(v)) for k, v in host.items()}
        if pinned:
            src = {k: v.pin_memory() for k, v in src.items()}
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = {k: v.to(DEV, non_blocking=pinned) for k, v in src.items()}
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del out
        return float(np.median(times))

    pf = train_driver._H2DPrefetcher(iter([{'device': host, 'meta': {}}]), DEV)
    _, dev = next(iter(pf))
    pf.close()
    a = step_lib.unpack_batch(dev, torch.device(DEV))
    b = step_lib.unpack_batch(host, torch.device(DEV))
    unequal = sorted(k for k in b if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]))
    if set(a) != set(b) or unequal:
        fail(f'_H2DPrefetcher batch differs from unpack_batch: {unequal}')
    return dict(item_uncached_s=uncached_s, item_cached_s=cached,
                batch_bytes=sum(int(np.asarray(v).nbytes) for v in host.values()),
                batch_bytes_by_key={k: int(np.asarray(v).nbytes) for k, v in host.items()},
                h2d_pinned_ms=copy_ms(True), h2d_pageable_ms=copy_ms(False),
                prefetcher_equals_unpack=True)


def rope_driver_run(root, workdir):
    '''Run 4, in this process through train_torch.main: rope256 (temporal_rope,
    rope_time_coords, frame stride 2), 1 epoch of 2 steps, no val. Records the frame
    times of every batch the seeker runs on (the 2 steps' and the vis step's) and the
    positions of every rope attention call after it (forward and remat recompute): they
    must be equal (per query), and the batch's times the clip's load indices (multiples of
    the stride).'''
    import train_torch
    records = []   # (frame_times of a batch, [positions of each rope call on it])
    real_forward, real_attention = step_lib._forward_queries, tsf.Attention.forward

    def forward_queries(model, cfg, batch, *a, **kw):
        records.append((batch['frame_times'].detach().cpu().clone(), []))
        return real_forward(model, cfg, batch, *a, **kw)

    def attention(self, x, causal_attention, rope=False, pos=None):
        if rope:
            records[-1][1].append(pos.detach().cpu().clone())
        return real_attention(self, x, causal_attention, rope, pos)

    argv = driver_argv(root, workdir, 'rope4', '--temporal_rope', '1', '--rope_time_coords',
                       '1', '--kubric_frame_stride', str(ROPE_FRAME_STRIDE),
                       '--num_epochs', '1', '--do_val_aug', '0', '--do_val_noaug', '0')
    log_fp = workdir / 'rope4.log'
    step_lib._forward_queries, tsf.Attention.forward = forward_queries, attention
    t0 = time.perf_counter()
    try:
        with open(log_fp, 'w') as log, contextlib.redirect_stdout(log):
            train_torch.main(argv)
    finally:
        step_lib._forward_queries, tsf.Attention.forward = real_forward, real_attention
    wall_s = time.perf_counter() - t0
    text = log_fp.read_text()
    steps = check_steps('rope4', text, driver_records(1, ROPE_DRIVER_STEPS, val=False),
                        DRIVER_PER_ROPE_STEP)
    train_batches = [times for times, _ in records if times.shape[0] == TRAIN_B]
    if len(train_batches) != 2 or any(not calls for _, calls in records):
        fail(f'rope driver run: {len(train_batches)} train batches, rope calls per batch '
             f'{[len(calls) for _, calls in records]}')
    for i, (times, calls) in enumerate(records):
        B, T = times.shape
        want = times[:, None].expand(B, TRAIN_Q, T).reshape(B * TRAIN_Q, T)
        for pos in calls:
            if not (torch.equal(pos[:, 0], want)
                    and torch.equal(pos, pos[:, :1].expand_as(pos))):
                fail(f'rope driver run batch {i}: the temporal attention got other times '
                     'than the batch frame_times')
        if bool((times % ROPE_FRAME_STRIDE).any()) or float(times.max()) >= ROPE_DRIVER_FRAMES:
            fail(f'rope driver run batch {i}: frame_times {times} are not load indices')
    return dict(wall_s=wall_s, steps=steps,
                rope_calls_per_batch=[len(calls) for _, calls in records],
                frame_times=[t.tolist() for t in train_batches],
                epochs=epoch_stats(steps, text),
                peak_bytes=max(r.get('max_memory_allocated', 0) for r in steps))


def sum_launches(steps):
    out = {}
    for r in steps:
        for k, n in r['launches'].items():
            out[k] = out.get(k, 0) + n
    return out


# The step_stats lines each driver run must log: run 2 is stopped by SIGTERM during the
# step after train step PREEMPT_STEPS_DONE - 2 of epoch 0, run 3 resumes it there.
DRIVER_RUN_RECORDS = {
    'run1': driver_records(DRIVER_EPOCHS),
    'run2': driver_records(DRIVER_EPOCHS, stop_after=(0, PREEMPT_STEPS_DONE - 1)),
    'run3': driver_records(DRIVER_EPOCHS, start_step=PREEMPT_STEPS_DONE)}


def decoded_frames(fp):
    '''The frames cv2 decodes from a video file.'''
    import cv2
    cap = cv2.VideoCapture(str(fp))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def find_video(vis_dir, stem):
    '''The one video written for stem: stem.webm (VP8) or stem.mp4 (mp4v).'''
    found = [vis_dir / (stem + ext) for ext in ('.webm', '.mp4')
             if (vis_dir / (stem + ext)).exists()]
    if len(found) != 1:
        fail(f'{vis_dir}: {len(found)} videos for {stem}')
    return found[0]


def check_vis_videos(log_dir, frames):
    '''A train run's vis-step videos: each present and decoding to `frames` frames (the
    input video holds its query frame three times). Returns {stem: container}.'''
    out = {}
    for stem in VIS_VIDEOS:
        fp = find_video(log_dir / 'visuals', stem)
        want = frames + 2 if stem.endswith('_in') else frames
        if decoded_frames(fp) != want:
            fail(f'{fp} decodes to {decoded_frames(fp)} frames, expected {want}')
        out[stem] = fp.suffix
    return out


def check_run(name, text, workdir):
    '''A driver run's steps and launches (check_steps against DRIVER_RUN_RECORDS) and,
    by run, its checkpoints, losses and vis-step videos.'''
    steps = check_steps(name, text, DRIVER_RUN_RECORDS[name], DRIVER_PER_STEP)
    out = dict(steps=steps, epochs=epoch_stats(steps, text),
               peak_bytes=max(r.get('max_memory_allocated', 0) for r in steps))
    ckpt = workdir / 'checkpoints' / ('run2' if name == 'run3' else name)
    if name in ('run1', 'run3'):
        for e in range(DRIVER_EPOCHS):
            meta = peek_meta(str(ckpt / f'model_{e}.npz'))
            if not meta['opt_restored'] or meta['partial'] or meta['epoch'] != e:
                fail(f'{name}: model_{e}.npz is not a full checkpoint of epoch {e}')
        rows = [json.loads(ln) for ln in (workdir / 'logs' / ckpt.name / 'scalars.jsonl')
                .read_text().splitlines()]
        losses = [v for r in rows for k, v in r.items() if '/loss_' in k]
        if not losses or not np.all(np.isfinite(losses)):
            fail(f'{name}: losses in scalars.jsonl {losses}')
        out['losses_logged'] = len(losses)
    if name == 'run1':
        out['vis_videos'] = check_vis_videos(workdir / 'logs' / name,
                                             SEEKER_ARGS['num_total_frames'])
    if name == 'run2':
        meta = peek_meta(str(ckpt / 'checkpoint.npz'))
        if not (meta['partial'] and meta['epoch'] == 0 and meta['opt_restored']
                and meta['steps_done_in_epoch'] == PREEMPT_STEPS_DONE):
            fail(f'run2: mid-epoch checkpoint {meta}')
        out['preempt_checkpoint'] = {k: meta[k] for k in (
            'epoch', 'partial', 'steps_done_in_epoch', 'opt_restored')}
    return out


def host_augs_run(root, workdir):
    '''Run 5: train_torch.py with --device_augs 0, the colour augmentations applied by
    the loader on the host: 1 epoch of HOST_AUGS_STEPS steps on half the train scenes, no
    val; each step's launches, a finite loss, the loader-wait share.'''
    argv = driver_argv(root, workdir, 'host5', '--device_augs', '0', '--num_epochs', '1',
                       '--use_data_frac', '0.5', '--do_val_aug', '0', '--do_val_noaug', '0')
    text, wall_s = run_driver(argv, workdir / 'host5.log')
    steps = check_steps('host5', text, driver_records(1, HOST_AUGS_STEPS, val=False),
                        DRIVER_PER_STEP)
    ckpt = load_checkpoint(str(workdir / 'checkpoints' / 'host5' / 'checkpoint.npz'))
    if ckpt['dset_args']['kubric']['device_color_jitter'] is not False:
        fail(f'host5: dset_args {ckpt["dset_args"]}')
    rows = [json.loads(ln) for ln in (workdir / 'logs' / 'host5' / 'scalars.jsonl')
            .read_text().splitlines()]
    losses = [v for r in rows for k, v in r.items() if k == 'train/loss_total_seeker']
    if len(losses) != 1 or not np.all(np.isfinite(losses)):
        fail(f'host5: losses in scalars.jsonl {losses}')
    return dict(wall_s=wall_s, steps=steps, loss=losses[0],
                epochs=epoch_stats(steps, text),
                peak_bytes=max(r.get('max_memory_allocated', 0) for r in steps))


def phase_train_driver(workdir):
    '''The training path's host side at the step of record: a synthetic Kubric dataset
    written by the port (DRIVER_SPLITS), then train_torch.py as a subprocess: run 1 trains
    2 epochs of 4 steps with both val phases; run 2 is run 1 under another name, sent
    SIGTERM during step PREEMPT_STEPS_DONE of epoch 0; run 3 resumes run 2 and must end
    where run 1 ended; run 5 trains 2 steps with --device_augs 0 (the host colour path);
    runs 1, 2 then 3, and 5 go at once; run 4 is rope256 through train_torch.main in this
    process, after them. Every step's launches are
    checked (DRIVER_PER_*), every loss finite, every epoch's checkpoint full, run 1's
    vis-step videos decoded. Prints item times, the host->device copy of a batch,
    per-step host times, the loader-wait share and peak memory of each run.'''
    out = {'cpu_count': os.cpu_count()}
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    root, out['dataset_write_s'], out['dataset_bytes'] = dataset('driver')
    rope_root, out['rope_dataset_write_s'], out['rope_dataset_bytes'] = dataset('driver_rope')
    out.update(host_checks(root))
    emit({'phase': 'train_driver_host', **out})

    runs = {}

    def run(name, extra=(), sig=None):
        argv = driver_argv(root, workdir, 'run2' if name == 'run3' else name, *extra)
        text, wall_s = run_driver(argv, workdir / f'{name}.log', sig)
        runs[name] = dict(wall_s=wall_s, **check_run(name, text, workdir))
        emit({'phase': f'train_driver_{name}',
              **{k: v for k, v in runs[name].items() if k != 'steps'}})

    def host5():
        runs['host5'] = host_augs_run(root, workdir)
        emit({'phase': 'train_driver_host5',
              **{k: v for k, v in runs['host5'].items() if k != 'steps'}})

    # Runs 1, 2 (then 3) and 5 at once, each a subprocess waited for on a thread: they
    # share the host and the card, so their host times are no measurement.
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        done = [pool.submit(run, 'run1'),
                pool.submit(lambda: (run('run2', sig=PREEMPT_STEPS_DONE - 2),
                                     run('run3', ('--resume', 'run2')))),
                pool.submit(host5)]
        for future in done:
            future.result()
    resume = compare_final_states(workdir / 'checkpoints' / 'run1' / 'checkpoint.npz',
                                  workdir / 'checkpoints' / 'run2' / 'checkpoint.npz')
    emit({'phase': 'train_driver_resume', **resume})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()   # run 4 shares this process with every phase
    runs['rope4'] = rope_driver_run(rope_root, workdir)
    emit({'phase': 'train_driver_rope4',
          **{k: v for k, v in runs['rope4'].items() if k != 'steps'}})
    launches = sum_launches([r for n in ('run1', 'run2', 'run3', 'host5')
                             for r in runs[n]['steps']])
    rope_launches = sum_launches(runs['rope4']['steps'])
    emit({'phase': 'train_driver', 'launches': launches, 'rope_launches': rope_launches,
          'resume_bit_equal': resume['bit_equal']})
    return {'launches': launches, 'rope_launches': rope_launches}


# ---------------------------------------------------------------------------------------
# Data parallelism: two ranks on the one card, one rank on NCCL, train_torch.py --multihost
# ---------------------------------------------------------------------------------------

# Ranks of phase dp: two "hosts" that share the one card (LOCAL_RANK 0 both), so the
# backend rule picks gloo.
DP_WORLD = 2
DP_TIMEOUT_S = 300
# Seconds a rank of phases dp, tp and sp, started beside the build, waits for its go.
RANK_GO_TIMEOUT_S = 900
# The pairings other than the step of record run at full width and this depth under data,
# tensor and sequence parallelism.
PARALLEL_SHORT_DEPTH = 2
# f32 (TF32 off): the two-rank step's gradient against the one-process step's, at depth 2
# and full width; only the order of the sums differs (the rows split over the ranks).
TOL_DP_F32 = 1e-4


def start_ranks(cmd, log_dir, name, world=DP_WORLD):
    '''`cmd` as `world` ranks of one group on this card (RANK, WORLD_SIZE, LOCAL_RANK 0,
    MASTER_ADDR, MASTER_PORT), each rank's output to <log_dir>/<name>_rank<r>.log.'''
    port = mesh_lib.free_port()
    ranks = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK='0',
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
        fp = log_dir / f'{name}_rank{r}.log'
        with open(fp, 'w') as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                    cwd=os.path.dirname(os.path.abspath(__file__)))
        ranks.append((proc, fp))
    return ranks


def stop_ranks(ranks):
    for p, _ in ranks:
        if p.poll() is None:
            p.kill()
            p.wait()


def wait_ranks(ranks, name, timeout_s, poll=None):
    '''Waits for every rank (calling poll() meanwhile); fails, stopping the others, when
    one exits non-zero, after timeout_s or once ABORT is set. Returns each rank's log
    text.'''
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p, _ in ranks):
            if ABORT.is_set():
                fail(f'{name}: stopped, another phase failed')
            bad = [(r, p.returncode) for r, (p, _) in enumerate(ranks)
                   if p.poll() not in (None, 0)]
            if bad:
                print(ranks[bad[0][0]][1].read_text()[-4000:], file=sys.stderr)
                fail(f'{name}: rank {bad[0][0]} exited {bad[0][1]}')
            if time.perf_counter() - t0 > timeout_s:
                fail(f'{name}: the ranks took over {timeout_s} s')
            if poll is not None:
                poll()
            time.sleep(0.05)
        texts = [fp.read_text() for _, fp in ranks]
        for r, (p, _) in enumerate(ranks):
            if p.returncode != 0:
                print(texts[r][-4000:], file=sys.stderr)
                fail(f'{name}: rank {r} exited {p.returncode}')
        return texts
    finally:
        stop_ranks(ranks)


def dp_rank_main(out_dir):
    '''One rank of phase dp (a), started by start_dp: draws the seeded init on the host,
    waits for <out_dir>/go (phase_dp writes it once the card is free), joins the group
    from the environment (the backend rule must pick gloo: both ranks are on cuda:0), runs
    the step of record's global batch's rows of this rank under each pairing (the step of
    record at depth 12, the others at PARALLEL_SHORT_DEPTH), then the gradients of the
    parity pass, and writes <out_dir>/rank<r>.json (rank 0 also the
    gradients, .pt). It leaves when its parent does.'''
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)   # the host init runs beside the main process's phases
    out_dir = pathlib.Path(out_dir)
    parent = os.getppid()
    # The seeded init of init_train_state(SEED, ...), drawn once for every pass.
    init = params_to_jax(step_lib.init_train_state(
        SEED, train_config(torch.bfloat16), dp_optimizer(), device='cpu').model.state_dict())
    deadline = time.perf_counter() + RANK_GO_TIMEOUT_S
    while not (out_dir / 'go').exists():
        if os.getppid() != parent or time.perf_counter() > deadline:
            fail('dp rank: no go from chip_smoke.py')
        time.sleep(0.05)
    mesh = mesh_lib.make_mesh(DEV)
    try:
        if mesh.backend != 'gloo':
            fail(f'dp rank {mesh.rank}: backend {mesh.backend} ({mesh.reason}), expected '
                 'gloo for two ranks on one GPU')
        out = dict(rank=mesh.rank, world=mesh.world, backend=mesh.backend,
                   reason=mesh.reason, device=str(mesh.device))
        batch = mesh_lib.shard_batch(train_batch(), mesh)
        out['rows'] = int(batch['query_inds'].shape[0])
        out['pairings'] = {'/'.join(STEP_OF_RECORD): dp_rank_pairing(
            mesh, STEP_OF_RECORD, batch, init)}
        with at_depth(PARALLEL_SHORT_DEPTH):
            out['pairings'].update({'/'.join(p): dp_rank_pairing(mesh, p, batch, None,
                                                                 PARALLEL_SHORT_DEPTH)
                                    for p in PAIRINGS if p != STEP_OF_RECORD})
        out['parity'] = dp_rank_parity(mesh, batch, out_dir, init)
    finally:
        mesh.close()
    (out_dir / f'rank{mesh.rank}.json').write_text(json.dumps(out))


def dp_optimizer():
    return optim.make_optimizer('adamw', learn_rate=1e-4, num_epochs=70, steps_per_epoch=1000,
                                gradient_clip=0.3)


def dp_rank_pairing(mesh, pairing, batch, init, depth=12):
    '''phase_train's steps under one pairing on this rank's rows at `depth`, from the
    JAX-layout tree `init` or the seed: launches checked per step, the state placed from
    rank 0 and its replicas compared after the steps; for the step of record the gradient
    all-reduce timed alone, three times.'''
    cfg = train_config(torch.bfloat16, pairing=pairing, depth=depth)
    state = step_lib.init_train_state(SEED, cfg, dp_optimizer(), params=init, device=mesh.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh_lib.shard_state(state, mesh)
    torch.cuda.synchronize()
    place_ms = 1e3 * (time.perf_counter() - t0)
    train_step = step_lib.make_train_step(cfg, mesh=mesh)
    per_step = {k: PAIRINGS[pairing].get(k, 0) * 2 * depth for k in read_launches()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps = []
    for i in range(1 + TRAIN_STEPS):
        counts = read_launches()
        state, aux, ms, host_ms = timed_step(train_step, state, batch)
        rec = dict(step=i, step_ms=ms, host_ms=host_ms, loss=float(aux['total_seeker']),
                   grad_norm=float(aux['grad_norm']),
                   skipped_nonfinite=float(aux['skipped_nonfinite']),
                   launches={k: n - counts[k] for k, n in read_launches().items()})
        steps.append(rec)
        if not np.isfinite(rec['loss']) or rec['skipped_nonfinite'] != 0.0:
            fail(f'dp {pairing} rank {mesh.rank} step {i}: loss {rec["loss"]}')
        if rec['launches'] != per_step:
            fail(f'dp {pairing} rank {mesh.rank} step {i}: launches {rec["launches"]}, '
                 f'expected {per_step}')
    out = dict(steps=steps, launches=read_launches(), launches_per_step=per_step,
               step_ms=sum(r['step_ms'] for r in steps[1:]) / TRAIN_STEPS,
               host_ms=sum(r['host_ms'] for r in steps[1:]) / TRAIN_STEPS,
               peak=torch.cuda.max_memory_allocated(), place_ms=place_ms,
               digest=mesh_lib.check_replicas(state, mesh))
    if pairing == STEP_OF_RECORD:
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        out['allreduce_bytes'] = sum(g.numel() * g.element_size() for g in grads)
        out['allreduce_ms'] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh_lib.all_reduce_grads(state.model.named_parameters(), mesh)
            torch.cuda.synchronize()
            out['allreduce_ms'].append(1e3 * (time.perf_counter() - t0))
    del state, train_step
    torch.cuda.empty_cache()
    return out


def flat_grad(model):
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().flatten()
                      for p in model.parameters()])


def dp_rank_parity(mesh, batch, out_dir, init):
    '''The step of record's first-step gradients, drop-path off, summed over the ranks
    (step.compute_gradients): bf16 at full depth from `init` and f32 at depth 2, the inits
    of phase_train_parity; rank 0 saves them for phase_dp.'''
    out = {}
    cfg = train_config(torch.bfloat16, 0.0)
    state = step_lib.init_train_state(SEED, cfg, dp_optimizer(), params=init, device=mesh.device)
    out['loss_bf16'] = float(step_lib.compute_gradients(state, cfg, batch, TRAIN_PROGRESS,
                                                        mesh=mesh)['total_seeker'])
    if mesh.rank == 0:
        torch.save(flat_grad(state.model).cpu(), out_dir / 'grad_bf16.pt')
    del state
    torch.cuda.empty_cache()
    with depth_preset(2, (D, HEADS)):
        cfg2 = train_config(torch.float32, 0.0, depth=2)
        model = MaskTracker(cfg2.seeker, device=mesh.device)
        model.init_params_(torch.Generator().manual_seed(SEED))
        state2 = step_lib.TrainState(model, None, torch.Generator())
        out['loss_f32_depth2'] = float(step_lib.compute_gradients(
            state2, cfg2, batch, TRAIN_PROGRESS, mesh=mesh)['total_seeker'])
        if mesh.rank == 0:
            torch.save(flat_grad(model).cpu(), out_dir / 'grad_f32_depth2.pt')
    return out


def start_dp(workdir):
    '''Starts phase dp (a)'s ranks (dp_rank_main), which draw their init on the host and
    then wait for phase_dp's go.'''
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    return start_ranks([sys.executable, '-c',
                        f'import chip_smoke as c; c.dp_rank_main({str(workdir)!r})'],
                       workdir, 'dp')


def phase_dp(ranks, parity, workdir):
    '''(a) The step of record's global batch (2 clips x 3 queries) split over DP_WORLD
    ranks that share the card (dp_rank_main, subprocesses): gloo asserted, every pairing's
    launches per rank and step, replicas bit-identical (state digests), the all-reduced
    gradients against phase_train_parity's one-process ones: the bf16 error against the
    f32 plain path <= TRAIN_BF16_ERR_RATIO x the bf16 plain path's, f32 at depth 2 within
    TOL_DP_F32 of the one-process step; per rank step ms, peak and the all-reduce's ms.
    (b) The step of record at world size 1 on NCCL in this process, bit-equal to the
    one-process step (phase_dp_nccl). `ranks` are start_dp's. Returns the launches of
    both by path.'''
    t0 = time.perf_counter()
    (workdir / 'go').touch()
    wait_ranks(ranks, 'dp', DP_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    res = [json.loads((workdir / f'rank{r}.json').read_text()) for r in range(DP_WORLD)]
    for name in res[0]['pairings']:
        digests = {r['pairings'][name]['digest'] for r in res}
        if len(digests) != 1:
            fail(f'dp {name}: the replicas differ after the steps: {digests}')
    grads, losses = parity['grads'], parity['losses']
    grad_dp = torch.load(workdir / 'grad_bf16.pt')
    grad_dp2 = torch.load(workdir / 'grad_f32_depth2.pt')
    rel = lambda a, b: abs(a - b) / abs(b)
    loss_dp = res[0]['parity']['loss_bf16']
    errs = {'grad_plain_bf16': rel_l2(grads['plain_bf16'], grads['plain_f32']),
            'grad_dp_bf16': rel_l2(grad_dp, grads['plain_f32']),
            'grad_dp_vs_one_process_bf16': rel_l2(grad_dp, grads['kernel_bf16']),
            'loss_plain_bf16': rel(losses['plain_bf16'], losses['plain_f32']),
            'loss_dp_bf16': rel(loss_dp, losses['plain_f32']),
            'loss_dp_vs_one_process_bf16': rel(loss_dp, losses['kernel_bf16_kernel_x']),
            'grad_dp_vs_one_process_f32_depth2': rel_l2(grad_dp2, grads['kernel_f32_depth2']),
            'loss_dp_vs_one_process_f32_depth2': rel(
                res[0]['parity']['loss_f32_depth2'], losses['kernel_f32_depth2_kernel_x'])}
    ratios = {w: errs[f'{w}_dp_bf16'] / errs[f'{w}_plain_bf16'] for w in ('grad', 'loss')}
    for what, ratio in ratios.items():
        if not ratio <= TRAIN_BF16_ERR_RATIO:
            fail(f'dp: bf16 {what} error of the two-rank step {errs[f"{what}_dp_bf16"]} > '
                 f'{TRAIN_BF16_ERR_RATIO} x the plain path\'s {errs[f"{what}_plain_bf16"]}')
    for what in ('grad', 'loss'):
        if not errs[f'{what}_dp_vs_one_process_f32_depth2'] <= TOL_DP_F32:
            fail(f'dp: f32 {what} of the two-rank step vs one process at depth 2 '
                 f'{errs[f"{what}_dp_vs_one_process_f32_depth2"]} > {TOL_DP_F32}')
    per_rank = [{'rank': r['rank'], 'backend': r['backend'], 'reason': r['reason'],
                 'rows': r['rows'], 'pairings': {
                     n: {k: v for k, v in p.items() if k not in ('steps', 'launches')}
                     for n, p in r['pairings'].items()}} for r in res]
    emit({'phase': 'dp', 'world': DP_WORLD, 'ranks_wall_s': wall_s, 'ranks': per_rank,
          'rel_err': errs, 'bf16_err_ratio': ratios,
          'bf16_err_ratio_limit': TRAIN_BF16_ERR_RATIO, 'tol_f32_depth2': TOL_DP_F32})
    launches = {}
    for name in res[0]['pairings']:
        for k in read_launches():
            n = sum(r['pairings'][name]['launches'][k] for r in res)
            if n:
                launches.setdefault(k, {})[f'dp_{name.split("/")[0]}'] = n
    for k, n in phase_dp_nccl().items():
        if n:
            launches.setdefault(k, {})['dp_nccl'] = n
    return launches


def profile_step(step):
    '''One call of step() under torch.profiler: host wall and device busy ms, and the
    collectives it made: their count by profiler name and the device ms of NCCL's
    kernels.'''
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, collectives, nccl_us = [], {}, 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            if 'nccl' in ev.name.lower():
                nccl_us += ev.time_range.end - ev.time_range.start
        elif 'allreduce' in ev.name.lower().replace('_', ''):
            collectives[ev.name] = collectives.get(ev.name, 0) + 1
    busy_us, end = 0.0, float('-inf')
    for s0, e in sorted(spans):
        if e > end:
            busy_us += e - max(s0, end)
            end = e
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3, collectives=collectives,
                nccl_kernel_ms=nccl_us / 1e3)


def phase_dp_nccl():
    '''The step of record (drop-path 0.1) at world size 1 on NCCL in this process against
    the one-process step from the same init: after each of 1 + TRAIN_STEPS steps the loss,
    the gradient norm and the state digest (parameters, AdamW moments, generator, counts)
    bit-equal; then one more step of each under torch.profiler (profile_step: the
    collectives' count and device time). Returns the compared NCCL steps' launches.'''
    mesh = mesh_lib.make_mesh(DEV, rank=0, world=1, local_rank=0, addr='127.0.0.1',
                              port=mesh_lib.free_port())
    try:
        if mesh.backend != 'nccl':
            fail(f'dp_nccl: backend {mesh.backend} ({mesh.reason}) at world size 1')
        cfg = train_config(torch.bfloat16)
        one = step_lib.init_train_state(SEED, cfg, dp_optimizer(), device=DEV)
        dp = mesh_lib.shard_state(step_lib.init_train_state(SEED, cfg, dp_optimizer(),
                                                            device=DEV), mesh)
        steps = (step_lib.make_train_step(cfg), step_lib.make_train_step(cfg, mesh=mesh))
        batch = train_batch()
        local = mesh_lib.shard_batch(batch, mesh)
        recs, launches = [], dict.fromkeys(read_launches(), 0)
        for i in range(1 + TRAIN_STEPS):
            one, aux1, ms1, _ = timed_step(steps[0], one, batch)
            counts = read_launches()
            dp, aux2, ms2, _ = timed_step(steps[1], dp, local)
            for k, n in launches_since(counts).items():
                launches[k] += n
            rec = dict(step=i, one_ms=ms1, nccl_ms=ms2,
                       loss_bits_equal=float(aux1['total_seeker']) == float(aux2['total_seeker']),
                       grad_norm_bits_equal=float(aux1['grad_norm']) == float(aux2['grad_norm']),
                       state_bits_equal=(mesh_lib.state_digest(one)
                                         == mesh_lib.state_digest(dp)))
            recs.append(rec)
            if not (rec['loss_bits_equal'] and rec['grad_norm_bits_equal']
                    and rec['state_bits_equal']):
                fail(f'dp_nccl step {i}: world size 1 on NCCL differs from one process: '
                     f'{rec}')
        prof = {'one_process': profile_step(lambda: steps[0](one, batch, TRAIN_PROGRESS)),
                'nccl': profile_step(lambda: steps[1](dp, local, TRAIN_PROGRESS))}
        if not sum(prof['nccl']['collectives'].values()):
            fail(f'dp_nccl: the profiled NCCL step made no all-reduce: {prof["nccl"]}')
        del one, dp, steps
        torch.cuda.empty_cache()
    finally:
        mesh.close()
    emit({'phase': 'dp_nccl', 'backend': mesh.backend, 'reason': mesh.reason,
          'steps': recs, 'launches': launches, 'profile': prof})
    return launches


# The two-rank train_torch.py --multihost 1 runs of phases dp_driver, tp_driver and
# sp_driver run at the configuration of record's width but this depth (their time is the
# ranks' start, loaders and checkpoints, beside which a depth-12 step adds little but the
# 1.5 GB checkpoints); each registers the depth's preset, then runs train_torch.main.
PARALLEL_DRIVER_DEPTH = 2
PARALLEL_DRIVER_PER_STEP = {phase: {k: 2 * PARALLEL_DRIVER_DEPTH for k in per}
                            for phase, per in DRIVER_PER_STEP.items()}


def parallel_driver_cmd(root, workdir, name, *extra):
    '''The command of one rank of a two-rank train_torch.py run at PARALLEL_DRIVER_DEPTH
    (one epoch; driver_argv's flags, then `extra`).'''
    launch = ('import sys; from tcow_tpu_torch.models import timesformer; '
              f'timesformer.DEPTH_PRESETS[{PARALLEL_DRIVER_DEPTH}] = ({D}, {HEADS}); '
              'import train_torch; sys.exit(train_torch.main())')
    return [sys.executable, '-c', launch, *driver_argv(
        root, workdir, name, '--num_epochs', '1', '--network_depth',
        str(PARALLEL_DRIVER_DEPTH), *extra), '--multihost', '1']


# Phase dp (c): train_torch.py --multihost 1 as two ranks on the card, on the train_driver
# dataset: one epoch of DRIVER_TRAIN_STEPS global steps (1 clip x 3 queries a rank).
DP_DRIVER_RECORDS = {
    'dpu': driver_records(1, val=False),
    'dpp': driver_records(1, stop_after=(0, PREEMPT_STEPS_DONE - 1)),
    'dpr': driver_records(1, start_step=PREEMPT_STEPS_DONE)}


def phase_dp_driver(root, workdir):
    '''(c) `python train_torch.py --multihost 1` as DP_WORLD ranks on the card
    (start_ranks) at PARALLEL_DRIVER_DEPTH, on phase_train_driver's dataset at `root`: dpu,
    one uninterrupted epoch without validation, runs beside dpp, the same epoch, whose rank
    0 gets SIGTERM once train step PREEMPT_STEPS_DONE - 2 has logged; dpr resumes dpp, with
    both val phases. Each rank's log must hold exactly its steps (rank 0 also the vis step)
    with the launches of PARALLEL_DRIVER_PER_STEP, the backend gloo and no traceback; dpp
    leaves one mid-epoch checkpoint of PREEMPT_STEPS_DONE steps; dpr's final state must
    equal dpu's (bit for bit, else within TOL_RESUME). main runs it on a thread beside phases that
    time nothing (start_host_run), so none of its times is a measurement. Returns the
    launches of the two-rank runs.'''
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    out = {}
    base = functools.partial(parallel_driver_cmd, root, workdir)
    t0 = time.perf_counter()
    whole = start_ranks(base('dpu', '--do_val_aug', '0', '--do_val_noaug', '0'), workdir,
                        'dpu')
    pre = start_ranks(base('dpp'), workdir, 'dpp')
    sent = {}

    def preempt():
        proc, fp = pre[0]
        if not sent and any(r['phase'] == 'train' and r['epoch'] == 0
                            and r['step'] == PREEMPT_STEPS_DONE - 2
                            for r in parse_steps(fp.read_text())):
            proc.send_signal(signal.SIGTERM)   # logged after that step's check
            sent['dpp'] = time.perf_counter() - t0
    try:
        texts = {'dpp': wait_ranks(pre, 'dpp', RUN_TIMEOUT_S, preempt)}
        ckpt = workdir / 'checkpoints' / 'dpp'
        files = sorted(f.name for f in ckpt.glob('*.npz'))
        meta = peek_meta(str(ckpt / 'checkpoint.npz'))
        if files != ['checkpoint.npz'] or not (
                meta['partial'] and meta['opt_restored']
                and meta['steps_done_in_epoch'] == PREEMPT_STEPS_DONE):
            fail(f'dpp: checkpoints {files}, {meta}')
        texts['dpr'] = wait_ranks(start_ranks(base('dpp', '--resume', 'dpp'), workdir, 'dpr'),
                                  'dpr', RUN_TIMEOUT_S)
        texts['dpu'] = wait_ranks(whole, 'dpu', RUN_TIMEOUT_S)
    finally:
        stop_ranks(whole)
    wall_s = time.perf_counter() - t0
    dp_steps = []
    for name, logs in texts.items():
        for rank, text in enumerate(logs):
            want = [r for r in DP_DRIVER_RECORDS[name] if rank == 0 or r[0] != 'vis']
            steps = check_steps(f'{name} rank {rank}', text, want, PARALLEL_DRIVER_PER_STEP)
            where = {(r['rank'], r['world'], r['backend']) for r in steps}
            if where != {(rank, DP_WORLD, 'gloo')}:
                fail(f'{name} rank {rank}: step_stats of {where}')
            dp_steps += steps
            out[f'{name}_rank{rank}'] = epoch_stats(steps, text)
    resume = compare_final_states(workdir / 'checkpoints' / 'dpu' / 'checkpoint.npz',
                                  ckpt / 'checkpoint.npz')
    launches = sum_launches(dp_steps)
    emit({'phase': 'dp_driver', 'wall_s': wall_s, 'sigterm_at_s': sent, 'runs': out,
          'preempt_checkpoint': {k: meta[k] for k in ('epoch', 'partial',
                                                      'steps_done_in_epoch')},
          'resume': resume, 'launches': launches})
    return launches


def start_host_run(phase, *args):
    '''phase(*args) (phase_dp_driver, phase_parallel_driver, phase_gloo_probe; the last
    argument their work directory) on a thread; returns a function that waits for it and returns
    its result (or raises what it raised). The thread's ranks are host-bound: their start,
    the loaders and the checkpoints take most of their time, beside which the card does the
    main thread's comparisons of kernels against plain versions.'''
    workdir = args[-1]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(phase, *args)
    pool.shutdown(wait=False)

    def finish():
        try:
            return future.result()
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    return finish


# ---------------------------------------------------------------------------------------
# Tensor parallelism: two model ranks on the card, a (data 2, model 2) grid, and
# train_torch.py --tp_shards 2
# ---------------------------------------------------------------------------------------

# Phase tp: one data row of two model ranks that share the one card (gloo); phase tp_grid:
# two data rows of two.
TP_MODEL = 2
TP_GRID_WORLD = 4
TP_TIMEOUT_S = 600
# Phase sp: one data row of two seq ranks that share the card (gloo); phase sp_grid: one
# data row of (seq 2, model 2).
SP_SEQ = 2
# Phase pp: one data row of two pipe stages that share the card (gloo); phase pp_grid: one
# data row of (model 2, pipe 2). The step of record's 6 folded rows go through the stages
# in 2 microbatches of 3 (resolve_pp_microbatches: 2S = 4 does not divide 6).
PP_STAGES = 2
PP_MICROBATCHES = pipe_lib.resolve_pp_microbatches(0, PP_STAGES, TRAIN_B * TRAIN_Q)
# The step of record runs at full width and this depth under tensor parallelism (its
# 9.8-10.8 s a step at depth 12 are almost all collectives through the host, PERF.md);
# the parity gradients stay at depth 12.
TP_RECORD_DEPTH = 4
# The collectives whose handling of CUDA tensors on gloo phase gloo_probe records (the
# pipeline-parallel slice needs send / recv); all_reduce and broadcast are the controls,
# and the port uses every one but send / recv.
GLOO_PROBES = ('all_reduce', 'broadcast', 'all_gather_into_tensor', 'reduce_scatter_tensor',
               'all_to_all_single', 'all_to_all_uneven', 'send_recv')
# The collectives of each axis, by the functions that issue them: parallel/mesh.py's on the
# model axis, parallel/sequence.py's on the seq axis.
MODEL_AXIS = (mesh_lib, ('_gather', '_model_sum', '_model_sum_part'))
SEQ_AXIS = (seq_lib, ('_gather', '_scatter_sum', '_exchange', '_seq_sum', '_from_owner'))
# The pipe axis's stage hops (parallel/pipeline.py), one broadcast each.
PIPE_AXIS = (pipe_lib, ('_hop',))


def gathered_flat_grad(model, mesh):
    '''Every parameter gradient of a tensor- or pipeline-parallel model gathered into the
    one-process layout (a collective), concatenated in f32 in the one-process parameter
    order (a one-process model's on the meta device gives it).'''
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    full = mesh_lib.gather_state_dict(grads, mesh)
    order = [n for n, _ in MaskTracker(model.cfg, device='meta').named_parameters()]
    return torch.cat([full[n].float().flatten() for n in order])


def attention_passes(mesh, depth):
    '''How many blocks' attention calls a rank makes a step: every block, or under
    pipeline parallelism its stage's blocks once a microbatch.'''
    pp = mesh_lib.pp_mesh(mesh)
    return depth if pp is None else depth // pp.n_pipe * PP_MICROBATCHES


@contextlib.contextmanager
def attention_rows_recorded(rows):
    '''Adds the (rows, S) of every attention call a rank makes to the set `rows` (the
    chunk of the rows each rank runs the kernels on): the backbone's own calls and the
    row-parallel ones.'''
    inner = {m: m.fused_attention for m in (tsf, tensor_lib)}   # both ops.fused_attention's

    def recorded(x, *args, **kw):
        rows.add(tuple(x.shape[:2]))
        return fa.fused_attention(x, *args, **kw)
    for m in inner:
        m.fused_attention = recorded
    try:
        yield
    finally:
        for m, fn in inner.items():
            m.fused_attention = fn


@contextlib.contextmanager
def collectives_recorded(stats, axis):
    '''Counts in `stats` every collective of an axis (MODEL_AXIS: parallel/mesh.py's
    gathers, sums and sums into a part; SEQ_AXIS: parallel/sequence.py's gathers,
    reduce-scatters, all-to-alls, sums and broadcasts) under the block: 'calls', and
    'bytes' of the full tensor each gathers, sums or exchanges; when stats['timing'] is
    true, also their host 'seconds', the device synchronised before and after each (an
    instrumented run, not a timed one).'''
    module, names = axis
    inner = {name: getattr(module, name) for name in names}

    def recorded(name):
        def run(t, *args):
            if stats['timing']:
                torch.cuda.synchronize(t.device)
                t0 = time.perf_counter()
            out = inner[name](t, *args)
            if stats['timing']:
                torch.cuda.synchronize(t.device)
                stats['seconds'] += time.perf_counter() - t0
            stats['calls'] += 1
            stats['bytes'] += max(t.numel(), out.numel()) * t.element_size()
            return out
        return run
    for name in inner:
        setattr(module, name, recorded(name))
    try:
        yield
    finally:
        for name, fn in inner.items():
            setattr(module, name, fn)


def rank_pairing(what, mesh, pairing, batch, init, depth, axis):
    '''phase_train's steps under one pairing on a tensor-, sequence- or pipeline-parallel
    rank (`what`: 'tp', 'sp' or 'pp'; the whole batch, this rank's shards, tokens or
    stage), from the
    JAX-layout tree `init` or the seed: launches checked per step, the rows of each kernel
    call, the axis's collectives per step (count and bytes), the state placed from rank 0
    and its replicas and shards compared after the steps; for the step of record the
    collectives of the warm-up step timed (the device synchronised around each; the timed
    steps run without).'''
    cfg = train_config(torch.bfloat16, pairing=pairing, depth=depth)
    state = step_lib.init_train_state(SEED, cfg, dp_optimizer(), params=init,
                                      device=mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh_lib.shard_state(state, mesh)
    torch.cuda.synchronize()
    place_ms = 1e3 * (time.perf_counter() - t0)
    train_step = step_lib.make_train_step(cfg, mesh=mesh)
    per_step = {k: PAIRINGS[pairing].get(k, 0) * 2 * attention_passes(mesh, depth)
                for k in read_launches()}
    stats = dict(calls=0, bytes=0, seconds=0.0, timing=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps, rows = [], set()
    with attention_rows_recorded(rows), collectives_recorded(stats, axis):
        for i in range(1 + TRAIN_STEPS):
            counts = read_launches()
            stats.update(calls=0, bytes=0, seconds=0.0,
                         timing=i == 0 and pairing == STEP_OF_RECORD)
            state, aux, ms, host_ms = timed_step(train_step, state, batch)
            if i == 0 and pairing == STEP_OF_RECORD:
                instrumented = dict(instrumented_step_ms=ms,
                                    collective_ms_per_step=1e3 * stats['seconds'],
                                    collective_gb_per_s=stats['bytes'] / stats['seconds'] / 1e9)
            rec = dict(step=i, step_ms=ms, host_ms=host_ms, loss=float(aux['total_seeker']),
                       grad_norm=float(aux['grad_norm']),
                       skipped_nonfinite=float(aux['skipped_nonfinite']),
                       collectives=stats['calls'], collective_bytes=stats['bytes'],
                       launches={k: n - counts[k] for k, n in read_launches().items()})
            steps.append(rec)
            if not np.isfinite(rec['loss']) or rec['skipped_nonfinite'] != 0.0:
                fail(f'{what} {pairing} rank {mesh.rank} step {i}: loss {rec["loss"]}')
            if rec['launches'] != per_step:
                fail(f'{what} {pairing} rank {mesh.rank} step {i}: launches '
                     f'{rec["launches"]}, expected {per_step}')
    out = dict(steps=steps, launches=read_launches(), launches_per_step=per_step,
               rows_per_call=sorted(rows), depth=depth,
               step_ms=sum(r['step_ms'] for r in steps[1:]) / TRAIN_STEPS,
               host_ms=sum(r['host_ms'] for r in steps[1:]) / TRAIN_STEPS,
               peak=torch.cuda.max_memory_allocated(), place_ms=place_ms,
               collectives_per_step=steps[-1]['collectives'],
               collective_bytes_per_step=steps[-1]['collective_bytes'])
    if pairing == STEP_OF_RECORD:
        out.update(instrumented)
    out['digest'] = mesh_lib.check_replicas(state, mesh)
    out['digests'] = dict(zip(('replicated', 'shards'), mesh_lib.state_digests(state)))
    del state, train_step
    torch.cuda.empty_cache()
    return out


def rank_f32_depth2(mesh, batch, drop_path_rate=0.0, **overrides):
    '''The step of record's first-step gradients in f32 at depth 2, full width, drop-path
    off (or at drop_path_rate, the masks from a fresh default generator; `overrides`
    other seeker fields), from phase_train_parity's seeded init, on this rank's rows,
    shards, tokens or stage (one process's without a mesh): the loss, the gradient
    gathered over the model and pipe groups (every rank calls it), the launches.'''
    with depth_preset(2, (D, HEADS)):
        cfg2 = train_config(torch.float32, drop_path_rate, depth=2, **overrides)
        full = MaskTracker(cfg2.seeker, device='cpu')
        full.init_params_(torch.Generator().manual_seed(SEED))
        model = MaskTracker(cfg2.seeker, device=DEV if mesh is None else mesh.device,
                            mesh=mesh)
        model.load_state_dict(mesh_lib.shard_params(full.state_dict(), mesh))
        counts = read_launches()
        loss = float(step_lib.compute_gradients(step_lib.TrainState(model, None,
                                                                    torch.Generator()),
                                                cfg2, batch, TRAIN_PROGRESS,
                                                mesh=mesh)['total_seeker'])
        launches = launches_since(counts)
        return loss, gathered_flat_grad(model, mesh), launches


def rank_parity(mesh, batch, out_dir, init, prefix):
    '''The step of record's first-step gradients, drop-path off, gathered over the model
    group: bf16 at full depth from `init` and f32 at depth 2; rank 0 saves them for the
    phase (<prefix>_grad_bf16.pt, <prefix>_grad_f32_depth2.pt).'''
    out = {}
    cfg = train_config(torch.bfloat16, 0.0)
    state = step_lib.init_train_state(SEED, cfg, dp_optimizer(), params=init,
                                      device=mesh.device, mesh=mesh)
    out['loss_bf16'] = float(step_lib.compute_gradients(state, cfg, batch, TRAIN_PROGRESS,
                                                        mesh=mesh)['total_seeker'])
    grad = gathered_flat_grad(state.model, mesh)
    if mesh.rank == 0:
        torch.save(grad.cpu(), out_dir / f'{prefix}_grad_bf16.pt')
    del state, grad
    torch.cuda.empty_cache()
    out['loss_f32_depth2'], grad2, _ = rank_f32_depth2(mesh, batch)
    if mesh.rank == 0:
        torch.save(grad2.cpu(), out_dir / f'{prefix}_grad_f32_depth2.pt')
    return out


def gloo_probe_main(out_path):
    '''One rank of a two-rank gloo world on cuda:0 (from the environment) that runs each
    collective of GLOO_PROBES once, in order, on small CUDA tensors; rank 0 rewrites
    out_path after each with what it found (raised, with the error, or the result right
    or wrong) and the collective it runs next. A collective that gloo cannot move may
    abort the process (a C++ exception on gloo's thread): phase_gloo_probe then records
    the exit for that one.'''
    import torch.distributed as dist
    mesh = mesh_lib.make_mesh(DEV)
    n, r, dev = mesh.world, mesh.rank, mesh.device
    part = lambda k: torch.arange(4, dtype=torch.float32, device=dev) + 10 * k
    whole = lambda k: torch.arange(4 * n, dtype=torch.float32, device=dev) + 100 * k

    def all_reduce():
        x = part(r)
        dist.all_reduce(x)
        return torch.equal(x, sum(part(k) for k in range(n)))

    def broadcast():
        x = part(r)
        dist.broadcast(x, src=0)
        return torch.equal(x, part(0))

    def all_gather_into_tensor():
        out = torch.empty(4 * n, device=dev)
        dist.all_gather_into_tensor(out, part(r))
        return torch.equal(out, torch.cat([part(k) for k in range(n)]))

    def reduce_scatter_tensor():
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, whole(r))
        return torch.equal(out, sum(whole(k) for k in range(n))[4 * r:4 * r + 4])

    def all_to_all_single():
        out = torch.empty(4 * n, device=dev)
        dist.all_to_all_single(out, whole(r))
        return torch.equal(out, torch.cat([whole(k)[4 * r:4 * r + 4] for k in range(n)]))

    # Uneven split sizes, as the seq axis's all-to-all splits 30 frames over 4 ranks: rank
    # k sends j + k + 1 elements to rank j.
    sizes = lambda k: [j + k + 1 for j in range(n)]
    sent = lambda k: torch.arange(sum(sizes(k)), dtype=torch.float32, device=dev) + 100 * k

    def all_to_all_uneven():
        out = torch.empty(sum(sizes(r)), device=dev)
        dist.all_to_all_single(out, sent(r), output_split_sizes=sizes(r),
                               input_split_sizes=sizes(r))
        return torch.equal(out, torch.cat([sent(k).split(sizes(k))[r] for k in range(n)]))

    def send_recv():
        x = part(r)
        if r == 0:
            dist.send(x, dst=1)
        else:
            dist.recv(x, src=0)
        return r == 0 or torch.equal(x, part(0))

    probes = dict(all_reduce=all_reduce, broadcast=broadcast,
                  all_gather_into_tensor=all_gather_into_tensor,
                  reduce_scatter_tensor=reduce_scatter_tensor,
                  all_to_all_single=all_to_all_single, all_to_all_uneven=all_to_all_uneven,
                  send_recv=send_recv)
    found = {}
    try:
        for op in GLOO_PROBES:
            if r == 0:
                pathlib.Path(out_path).write_text(json.dumps({'found': found, 'running': op}))
            try:
                torch.cuda.synchronize()
                found[op] = {'result': 'works' if probes[op]() else 'wrong'}
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 — the probe records what raises
                found[op] = {'result': 'raises', 'error': f'{type(e).__name__}: {e}'[:300]}
        if r == 0:
            pathlib.Path(out_path).write_text(json.dumps({'found': found, 'running': None}))
    finally:
        mesh.close()


# Seconds the probe's two ranks may take (their start included).
GLOO_PROBE_TIMEOUT_S = 120


def phase_gloo_probe(workdir):
    '''Which collectives gloo moves for CUDA tensors on this torch (the pipeline-parallel
    slice needs send / recv; the port uses the others: the seq axis all_to_all_single with
    uneven split sizes): GLOO_PROBES in two ranks on cuda:0 (gloo_probe_main), send / recv
    last. An op 'works' (no exception, right result), is 'wrong', 'raises' (the error
    recorded), 'aborts' (a rank died in it: the exit codes and log tails) or 'hangs'. The
    ones the port uses must work. Returns the results.'''
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    t0 = time.perf_counter()
    path = workdir / 'found.json'
    ranks = start_ranks([sys.executable, '-c', f'import chip_smoke as c; '
                         f'c.gloo_probe_main({str(path)!r})'], workdir, 'gloo')
    while any(p.poll() is None for p, _ in ranks) and not ABORT.is_set() \
            and time.perf_counter() < t0 + GLOO_PROBE_TIMEOUT_S:
        time.sleep(0.05)
    codes = [p.poll() for p, _ in ranks]
    stop_ranks(ranks)
    state = json.loads(path.read_text()) if path.exists() else {'found': {},
                                                                 'running': GLOO_PROBES[0]}
    out = state['found']
    if state['running'] is not None:
        out[state['running']] = (
            {'result': 'hangs', 'timeout_s': GLOO_PROBE_TIMEOUT_S} if None in codes else
            {'result': 'aborts', 'exit_codes': codes,
             'log_tail': [fp.read_text()[-300:] for _, fp in ranks]})
    for op in GLOO_PROBES[:-1]:
        if out.get(op, {}).get('result') != 'works':
            fail(f'gloo_probe: {op} on CUDA tensors: {out.get(op, "not run")}')
    emit({'phase': 'gloo_probe', 'torch': torch.__version__, 'wall_s':
          time.perf_counter() - t0, 'collectives_on_cuda_tensors': out})
    return out


# The ranks of each tensor- and sequence-parallel phase: their axis's collectives and
# their mesh (every rank on cuda:0, so gloo).
PARALLEL_RANKS = {'tp': (MODEL_AXIS, dict(model=TP_MODEL)),
                  'tp_grid': (MODEL_AXIS, dict(model=TP_MODEL)),
                  'sp': (SEQ_AXIS, dict(seq=SP_SEQ)),
                  'sp_grid': (SEQ_AXIS, dict(seq=SP_SEQ, model=TP_MODEL)),
                  'pp': (PIPE_AXIS, dict(pipe=PP_STAGES)),
                  'pp_grid': (PIPE_AXIS, dict(model=TP_MODEL, pipe=PP_STAGES))}
PARALLEL_WORLDS = {'tp': TP_MODEL, 'tp_grid': TP_GRID_WORLD, 'sp': SP_SEQ,
                   'sp_grid': SP_SEQ * TP_MODEL, 'pp': PP_STAGES,
                   'pp_grid': TP_MODEL * PP_STAGES}
# The (data, seq, model, pipe) coordinates of rank r of each kind.
PARALLEL_COORDS = {'tp': lambda r: (0, 0, r, 0), 'sp': lambda r: (0, r, 0, 0),
                   'pp': lambda r: (0, 0, 0, r),
                   'tp_grid': lambda r: (r // TP_MODEL, 0, r % TP_MODEL, 0),
                   'sp_grid': lambda r: (0, r // TP_MODEL, r % TP_MODEL, 0),
                   'pp_grid': lambda r: (0, 0, r // PP_STAGES, r % PP_STAGES)}
# How many parts each kind splits an attention call's rows into: the model or seq ranks'
# chunks, or the pipeline's microbatches.
ROW_SPLIT = {'tp': TP_MODEL, 'sp': SP_SEQ, 'pp': PP_MICROBATCHES}


def parallel_rank_main(out_dir, kind):
    '''One rank of phase tp (kind 'tp': 2 ranks, model 2), tp_grid ('tp_grid': 4 ranks,
    data 2 x model 2), sp ('sp': 2 ranks, seq 2), sp_grid ('sp_grid': 4 ranks, seq 2 x
    model 2), pp ('pp': 2 ranks, pipe 2) or pp_grid ('pp_grid': 4 ranks, model 2 x pipe 2),
    started by start_parallel: for 'tp', 'sp' and 'pp' draws the seeded init on the host,
    waits for <out_dir>/go_<kind>, joins the mesh from the environment (gloo: every rank
    is on cuda:0) and writes <out_dir>/<kind>_rank<r>.json. 'tp', 'sp' and 'pp': the step
    of record (at TP_RECORD_DEPTH for 'tp', depth 12 for the others), the other pairings
    at PARALLEL_SHORT_DEPTH, the parity gradients (rank 0 saves them); 'sp' also the f32
    depth-2 gradients under causal_attention 0 (the cls token the mean over the frames, a
    sum over the seq ranks), 'pp' at drop-path 0.1 (each stage keeps its blocks' rows of
    the whole batch's masks), rank 0 holding them against one process on the card. The
    grids: the f32 depth-2 gradients (rank 0 saves them).'''
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)   # the host init runs beside the main process's phases
    axis, mesh_kw = PARALLEL_RANKS[kind]
    out_dir = pathlib.Path(out_dir)
    parent = os.getppid()
    init = None
    if kind in ('tp', 'sp', 'pp'):
        init = params_to_jax(step_lib.init_train_state(
            SEED, train_config(torch.bfloat16), dp_optimizer(),
            device='cpu').model.state_dict())
    T, H, W = (SEEKER_ARGS[k] for k in ('num_total_frames', 'frame_height', 'frame_width'))
    host_batch = synthetic_device_batch(0, B=TRAIN_B, Q=TRAIN_Q, T=T, H=H, W=W, M=TRAIN_M,
                                        K=TRAIN_K)
    deadline = time.perf_counter() + RANK_GO_TIMEOUT_S
    while not (out_dir / f'go_{kind}').exists():
        if os.getppid() != parent or time.perf_counter() > deadline:
            fail(f'{kind} rank: no go from chip_smoke.py')
        time.sleep(0.05)
    mesh = mesh_lib.make_mesh(DEV, **mesh_kw)
    try:
        if mesh.backend != 'gloo':
            fail(f'{kind} rank {mesh.rank}: backend {mesh.backend} ({mesh.reason}), expected '
                 'gloo for ranks that share one GPU')
        out = dict(rank=mesh.rank, world=mesh.world, data_rank=mesh.data_rank,
                   seq_rank=mesh.seq_rank, model_rank=mesh.model_rank,
                   pipe_rank=mesh.pipe_rank, backend=mesh.backend, reason=mesh.reason,
                   device=str(mesh.device))
        batch = mesh_lib.shard_batch(train_batch(host=host_batch), mesh)
        out['rows'] = int(batch['query_inds'].shape[0])
        if kind in ('tp', 'sp', 'pp'):
            depth = TP_RECORD_DEPTH if kind == 'tp' else SEEKER_ARGS['network_depth']
            with at_depth(depth):
                out['pairings'] = {'/'.join(STEP_OF_RECORD): rank_pairing(
                    kind, mesh, STEP_OF_RECORD, batch, None if kind == 'tp' else init, depth,
                    axis)}
            print(f'{kind} rank {mesh.rank}: step of record done', flush=True)
            with at_depth(PARALLEL_SHORT_DEPTH):
                for pairing in PAIRINGS:
                    if pairing != STEP_OF_RECORD:
                        out['pairings']['/'.join(pairing)] = rank_pairing(
                            kind, mesh, pairing, batch, None, PARALLEL_SHORT_DEPTH, axis)
                        print(f'{kind} rank {mesh.rank}: {pairing} done', flush=True)
            out['parity'] = rank_parity(mesh, batch, out_dir, init, kind)
            if kind in ('sp', 'pp'):
                # sp: causal_attention 0; pp: drop-path on.
                extra = dict(causal_attention=0) if kind == 'sp' else dict(drop_path_rate=0.1)
                loss0, grad0, launches0 = rank_f32_depth2(mesh, batch, **extra)
                out['extra'] = dict(loss=loss0, launches=launches0)
                if mesh.rank == 0:
                    one_loss, one_grad, _ = rank_f32_depth2(None, batch, **extra)
                    out['extra'].update(
                        loss_vs_one_process=abs(loss0 - one_loss) / abs(one_loss),
                        grad_vs_one_process=rel_l2(grad0, one_grad))
        else:
            torch.cuda.reset_peak_memory_stats()
            loss, grad, launches = rank_f32_depth2(mesh, batch)
            out.update(loss_f32_depth2=loss, launches=launches,
                       peak=torch.cuda.max_memory_allocated())
            if mesh.rank == 0:
                torch.save(grad.cpu(), out_dir / f'{kind}_grad_f32_depth2.pt')
    finally:
        mesh.close()
    (out_dir / f'{kind}_rank{mesh.rank}.json').write_text(json.dumps(out))


def start_parallel(workdir, kinds):
    '''Starts the ranks of each of `kinds` (parallel_rank_main), which wait for their go:
    {kind: ranks}.'''
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    cmd = lambda kind: [sys.executable, '-c', f'import chip_smoke as c; '
                        f'c.parallel_rank_main({str(workdir)!r}, {kind!r})']
    return {kind: start_ranks(cmd(kind), workdir, kind, PARALLEL_WORLDS[kind])
            for kind in kinds}


def rank_launches(res, key, name):
    '''{kernel: {name: launches summed over the ranks}} of res[r][key]'s launches.'''
    out = {}
    for k in read_launches():
        n = sum(r[key]['launches'].get(k, 0) for r in res)
        if n:
            out.setdefault(k, {})[name] = n
    return out


PARALLELS = ('tp', 'sp', 'pp')
# The extra check of a kind's ranks at depth 2 in f32 against one process, by its name.
PARALLEL_EXTRA = {'sp': 'ca0', 'pp': 'droppath'}


def phase_parallels(ranks, parity, workdir):
    '''(a) Phases tp, sp and pp, all at once (their ranks are host-bound on gloo and share
    the card): parallel_result checks each. `ranks` are start_parallel's (the kinds of
    PARALLELS among them run). Returns {kind: its launches by path}.'''
    kinds = [kind for kind in PARALLELS if kind in ranks]
    t0 = time.perf_counter()
    for kind in kinds:
        (workdir / f'go_{kind}').touch()
    wait_ranks([r for kind in kinds for r in ranks[kind]], ', '.join(kinds), TP_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    return {kind: parallel_result(kind, parity, workdir, wall_s) for kind in kinds}


def parallel_result(kind, parity, workdir, wall_s):
    '''The step of record's batch (2 clips x 3 queries) on one data row of two ranks that
    share the card (parallel_rank_main, subprocesses): kind 'tp', two model ranks, 'sp',
    two seq ranks, or 'pp', two pipe stages; gloo asserted; per rank and step 24 K1 + 24
    K4 at the step of record's depth (TP_RECORD_DEPTH under 'tp': 8 + 8; under 'pp' 6
    blocks a stage, 2 microbatches) on half the rows (900 x 30 and 90 x 301), and each
    other pairing's launches at PARALLEL_SHORT_DEPTH; the replicated tensors equal over
    the world and the shards over their gradient group (check_replicas, inside the
    ranks); the gathered gradients against phase_train_parity's one-process ones: the
    bf16 error against the f32 plain path <= TRAIN_BF16_ERR_RATIO x the bf16 plain path's,
    f32 at depth 2 within TOL_DP_F32 of the one-process step; under 'sp' also
    causal_attention 0, under 'pp' drop-path 0.1, at depth 2 within TOL_DP_F32 of one
    process; per rank step ms, peak, the axis's collectives per step (count, bytes, and
    their ms in an instrumented step); wall_s is phase_parallels' for every kind. Returns
    the launches by path.'''
    world = PARALLEL_WORLDS[kind]
    res = [json.loads((workdir / f'{kind}_rank{r}.json').read_text()) for r in range(world)]
    coords = [(r['data_rank'], r['seq_rank'], r['model_rank'], r['pipe_rank']) for r in res]
    if coords != [PARALLEL_COORDS[kind](r) for r in range(world)]:
        fail(f'{kind}: mesh coordinates {coords}')
    record = res[0]['pairings']['/'.join(STEP_OF_RECORD)]
    want_rows = [[R // ROW_SPLIT[kind], S] for R, S, _ in TRAIN_GEOMETRIES.values()]
    if sorted(record['rows_per_call']) != sorted(want_rows):
        fail(f'{kind}: kernel rows per call {record["rows_per_call"]}, expected {want_rows}')
    for name in res[0]['pairings']:
        if len({r['pairings'][name]['digests']['replicated'] for r in res}) != 1:
            fail(f'{kind} {name}: the replicated tensors differ between the ranks')
    grads, losses = parity['grads'], parity['losses']
    grad_k = torch.load(workdir / f'{kind}_grad_bf16.pt')
    grad_k2 = torch.load(workdir / f'{kind}_grad_f32_depth2.pt')
    rel = lambda a, b: abs(a - b) / abs(b)
    loss_k = res[0]['parity']['loss_bf16']
    errs = {'grad_plain_bf16': rel_l2(grads['plain_bf16'], grads['plain_f32']),
            f'grad_{kind}_bf16': rel_l2(grad_k, grads['plain_f32']),
            f'grad_{kind}_vs_one_process_bf16': rel_l2(grad_k, grads['kernel_bf16']),
            'loss_plain_bf16': rel(losses['plain_bf16'], losses['plain_f32']),
            f'loss_{kind}_bf16': rel(loss_k, losses['plain_f32']),
            f'loss_{kind}_vs_one_process_bf16': rel(loss_k, losses['kernel_bf16_kernel_x']),
            f'grad_{kind}_vs_one_process_f32_depth2': rel_l2(grad_k2,
                                                             grads['kernel_f32_depth2']),
            f'loss_{kind}_vs_one_process_f32_depth2': rel(
                res[0]['parity']['loss_f32_depth2'], losses['kernel_f32_depth2_kernel_x'])}
    if kind in PARALLEL_EXTRA:
        errs.update({f'{w}_{kind}_vs_one_process_f32_depth2_{PARALLEL_EXTRA[kind]}':
                     res[0]['extra'][f'{w}_vs_one_process'] for w in ('grad', 'loss')})
    ratios = {w: errs[f'{w}_{kind}_bf16'] / errs[f'{w}_plain_bf16'] for w in ('grad', 'loss')}
    for what, ratio in ratios.items():
        if not ratio <= TRAIN_BF16_ERR_RATIO:
            fail(f'{kind}: bf16 {what} error of the parallel step {errs[f"{what}_{kind}_bf16"]} '
                 f'> {TRAIN_BF16_ERR_RATIO} x the plain path\'s {errs[f"{what}_plain_bf16"]}')
    for key, err in errs.items():
        if 'f32_depth2' in key and not err <= TOL_DP_F32:
            fail(f'{kind}: f32 {key} {err} > {TOL_DP_F32}')
    per_rank = [{k: r[k] for k in ('rank', 'data_rank', 'seq_rank', 'model_rank', 'pipe_rank',
                                   'backend', 'reason', 'rows')} | {'pairings': {
                     n: {k: v for k, v in p.items() if k not in ('steps', 'launches')}
                     for n, p in r['pairings'].items()}} for r in res]
    emit({'phase': kind, 'world': world, 'mesh': {'data': 1, **PARALLEL_RANKS[kind][1]},
          'ranks_wall_s': wall_s, 'ranks': per_rank, 'rel_err': errs,
          'bf16_err_ratio': ratios, 'bf16_err_ratio_limit': TRAIN_BF16_ERR_RATIO,
          'tol_f32_depth2': TOL_DP_F32})
    launches = {}
    for name in res[0]['pairings']:
        for k, v in rank_launches([r['pairings'] for r in res], name,
                                f'{kind}_{name.split("/")[0]}').items():
            launches.setdefault(k, {}).update(v)
    if kind in PARALLEL_EXTRA:
        for k, v in rank_launches(res, 'extra', f'{kind}_{PARALLEL_EXTRA[kind]}').items():
            launches.setdefault(k, {}).update(v)
    return launches


GRIDS = ('tp_grid', 'sp_grid', 'pp_grid')


def phase_grids(ranks, parity, workdir):
    '''(b) Four ranks on the card as (data 2, model 2) ('tp_grid'), four as (seq 2, model
    2) ('sp_grid') and four as (model 2, pipe 2) ('pp_grid'), all at once (they time
    nothing): the f32 depth-2 first-step gradient of the step of record's batch (under
    'tp_grid' each data row 1 clip x 3 queries), summed over the gradient groups and
    gathered over the model and pipe groups, within TOL_DP_F32 of the one-process step's
    (phase_train_parity). `ranks` are start_parallel's (the grids among them run).
    Returns the launches by path.'''
    kinds = [kind for kind in GRIDS if kind in ranks]
    t0 = time.perf_counter()
    for kind in kinds:
        (workdir / f'go_{kind}').touch()
    wait_ranks([r for kind in kinds for r in ranks[kind]], 'grids', TP_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    launches = {}
    for kind in kinds:
        for k, v in grid_result(kind, parity, workdir, wall_s).items():
            launches.setdefault(k, {}).update(v)
    return launches


def grid_result(kind, parity, workdir, wall_s):
    '''One grid's checks and phase line (phase_grids); its launches by path.'''
    world = PARALLEL_WORLDS[kind]
    res = [json.loads((workdir / f'{kind}_rank{r}.json').read_text()) for r in range(world)]
    coords = [(r['data_rank'], r['seq_rank'], r['model_rank'], r['pipe_rank']) for r in res]
    if coords != [PARALLEL_COORDS[kind](r) for r in range(world)]:
        fail(f'{kind}: mesh coordinates {coords}')
    grad = torch.load(workdir / f'{kind}_grad_f32_depth2.pt')
    err = rel_l2(grad, parity['grads']['kernel_f32_depth2'])
    loss_err = abs(res[0]['loss_f32_depth2'] - parity['losses']['kernel_f32_depth2_kernel_x']) \
        / abs(parity['losses']['kernel_f32_depth2_kernel_x'])
    # Two calls a block: both blocks on every rank, or under 'pp_grid' one block a stage
    # for each of the 2 microbatches.
    want = {'K1': 2 * 2, 'K4': 2 * 2}
    for r in res:
        if r['launches'] != want:
            fail(f'{kind} rank {r["rank"]}: launches {r["launches"]}, expected {want}')
    if not (err <= TOL_DP_F32 and loss_err <= TOL_DP_F32):
        fail(f'{kind}: f32 gradient {err} / loss {loss_err} vs one process at depth 2 > '
             f'{TOL_DP_F32}')
    emit({'phase': kind, 'world': world,
          'mesh': {'data': res[-1]['data_rank'] + 1, 'seq': res[-1]['seq_rank'] + 1,
                   'model': TP_MODEL, 'pipe': res[-1]['pipe_rank'] + 1},
          'ranks_wall_s': wall_s, 'coords': coords, 'rows': [r['rows'] for r in res],
          'peak': [r['peak'] for r in res], 'rel_err': {
              f'grad_{kind}_vs_one_process_f32_depth2': err,
              f'loss_{kind}_vs_one_process_f32_depth2': loss_err},
          'tol_f32_depth2': TOL_DP_F32})
    return {k: {kind: sum(r['launches'].get(k, 0) for r in res)} for k in want}


# Phases tp_driver, sp_driver and pp_driver: train_torch.py --multihost 1 with --tp_shards
# 2, --seq_shards 2 or --pp_stages 2 as two ranks on the card at PARALLEL_DRIVER_DEPTH
# (phases tp, sp and pp run the step of record; here each step's collectives go through
# the host beside the dp_driver ranks), each on its own dataset of TP_DRIVER_SCENES
# scenes: one epoch of 2 global steps without validation, the vis step at step 0 on both
# ranks.
TP_DRIVER_SCENES = 4
TP_DRIVER_RECORDS = driver_records(1, steps=TP_DRIVER_SCENES // TRAIN_B, val=False)
# Each driver phase's flag, run name and the (seq, model, pipe) coordinates of rank r.
PARALLEL_DRIVERS = {'tp': ('--tp_shards', 'tpd', lambda r: (0, r, 0)),
                    'sp': ('--seq_shards', 'spd', lambda r: (r, 0, 0)),
                    'pp': ('--pp_stages', 'ppd', lambda r: (0, 0, r))}
# A pipe stage's launches: its block's two calls once a microbatch (PP_MICROBATCHES in a
# train step, one in the vis step).
PP_DRIVER_PER_STEP = {'train': {k: 2 * PARALLEL_DRIVER_DEPTH // PP_STAGES * PP_MICROBATCHES
                                for k in ('K1', 'K4')},
                      'vis': {'K1': 2 * PARALLEL_DRIVER_DEPTH // PP_STAGES}}


def phase_parallel_driver(kind, root, workdir):
    '''`train_torch.py --multihost 1 --tp_shards 2` (kind 'tp'), `--seq_shards 2` ('sp') or
    `--pp_stages 2` ('pp') at PARALLEL_DRIVER_DEPTH as two ranks on the card (start_ranks,
    parallel_driver_cmd) on the dataset at `root`: each rank's log must hold exactly the
    steps of TP_DRIVER_RECORDS with the launches of PARALLEL_DRIVER_PER_STEP (under 'pp'
    PP_DRIVER_PER_STEP) at its coordinates (data 0, and seq r, model r or pipe r), backend
    gloo and no traceback; the checkpoint rank 0
    writes must hold the one-process layout (full-width block weights) and load into a
    one-process state on the card whose parameters and AdamW state are the file's, bit
    for bit. main runs it on a thread beside
    phases that time nothing (start_host_run). Returns its launches.'''
    flag, name, coords = PARALLEL_DRIVERS[kind]
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    t0 = time.perf_counter()
    cmd = parallel_driver_cmd(root, workdir, name, '--do_val_aug', '0', '--do_val_noaug', '0',
                              flag, '2')
    texts = wait_ranks(start_ranks(cmd, workdir, name, 2), name, RUN_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    steps, runs = [], {}
    per_step = PP_DRIVER_PER_STEP if kind == 'pp' else PARALLEL_DRIVER_PER_STEP
    for rank, text in enumerate(texts):
        recs = check_steps(f'{name} rank {rank}', text, TP_DRIVER_RECORDS, per_step)
        where = {(r['rank'], r['world'], r['backend'], r['data_rank'], r['seq_rank'],
                  r['model_rank'], r['pipe_rank']) for r in recs}
        if where != {(rank, 2, 'gloo', 0, *coords(rank))}:
            fail(f'{name} rank {rank}: step_stats of {where}')
        steps += recs
        runs[f'{name}_rank{rank}'] = epoch_stats(recs, text)
    path = workdir / 'checkpoints' / name / 'checkpoint.npz'
    meta = peek_meta(str(path))
    if meta['partial'] or not meta['opt_restored']:
        fail(f'{name}: checkpoint {meta}')
    file = checkpoint_arrays(path)
    qkv = file["params['backbone']['blocks']['attn']['qkv']['w']"]
    if qkv.shape != (PARALLEL_DRIVER_DEPTH, D, 3 * D):
        fail(f'{name}: the checkpoint holds qkv.w of {qkv.shape}, not the one-process layout')
    with depth_preset(PARALLEL_DRIVER_DEPTH, (D, HEADS)):
        state = step_lib.init_train_state(
            SEED + 1, train_config(torch.bfloat16, depth=PARALLEL_DRIVER_DEPTH),
            dp_optimizer(), device=DEV)
    load_checkpoint(str(path), state_template=state)
    held = {'params' + k: v for k, v in
            flatten_with_paths(params_to_jax(state.model.state_dict())).items()}
    held.update({'opt_state' + k: v for k, v in opt_state_to_jax(state.optimizer).items()})
    differ = [k for k, v in held.items() if not np.array_equal(v, file[k])]
    if differ or len(held) + 2 != len(file):
        fail(f'{name}: the one-process state loaded from the checkpoint differs: '
             f'{differ[:5]}, {len(held)} arrays held of {len(file)}')
    del state
    launches = sum_launches(steps)
    emit({'phase': f'{kind}_driver', 'wall_s': wall_s, 'runs': runs,
          'depth': PARALLEL_DRIVER_DEPTH,
          'checkpoint': {'arrays': len(file), 'qkv_w': list(qkv.shape),
                         'loads_into_one_process': True}, 'launches': launches})
    return launches


# ---------------------------------------------------------------------------------------
# The evaluation path: eval_torch.py, the test driver, overlay media and pick_represent
# ---------------------------------------------------------------------------------------

# A Kubric test set written by the port (36 frames at 240x320, K = 8): at
# --test_device_batch 4 one full batch and a tail of 2. The bundled demo video (200
# frames at 240x320, annotations beside it): with the query at 0.2 of a 30-frame clip its
# usage modes are (9, 1) and (3, 2), one chunk of --plugin_batch 4.
EVAL_SCENES = 6
EVAL_DEVICE_BATCH = 4
EVAL_QUERY_TIME = 0.2
EVAL_DEMO = 'demo/rollball.mp4'
EVAL_PLUGIN_NAMES = ('rollball_i0_f9_s1', 'rollball_i1_f3_s2')
# eval_stats lines: 2 Kubric device steps and 1 plugin step, each one forward (24 K1).
EVAL_STEPS = (('kubric', 0, 4), ('kubric', 1, 2), ('plugin', 0, 2))
EVAL_PER_STEP = {'K1': 24}
EVAL_LOG_FAULTS = ('Traceback', 'overlay rendering failed', 'does not match')
EVAL_STATS = re.compile(r'eval_stats (\{.*\})')
EVAL_TIMEOUT_S = 300


def record_train_args():
    '''The train args a run of the configuration of record writes into its checkpoints
    (the query at EVAL_QUERY_TIME).'''
    return config_lib.train_args([
        '--data_path', 'unused', '--num_frames', str(SEEKER_ARGS['num_total_frames']),
        '--frame_height', str(SEEKER_ARGS['frame_height']),
        '--frame_width', str(SEEKER_ARGS['frame_width']),
        '--seeker_query_time', str(EVAL_QUERY_TIME), '--max_objects', str(TRAIN_M),
        '--device', DEV])


def eval_checkpoint(ckpt_dir):
    '''A seeded seeker of the configuration of record saved as a train run would save it:
    its train args and Kubric dataset arguments (the query at EVAL_QUERY_TIME).'''
    args = record_train_args()
    model = MaskTracker(seeker_config_from_args(SEEKER_ARGS))
    model.init_params_(torch.Generator().manual_seed(SEED))
    save_checkpoint(str(ckpt_dir), 0, 'eval1', params_to_jax(model.state_dict()),
                    train_args=config_lib.args_to_dict(args),
                    dset_args={'kubric': factory.kubric_dset_args(args)},
                    seeker_args=SEEKER_ARGS)
    del model


def eval_argv(workdir, kubric_root):
    return ['--resume', 'eval1', '--name', 'ev', '--data_path', str(kubric_root), EVAL_DEMO,
            '--checkpoint_root', str(workdir / 'checkpoints'),
            '--log_root', str(workdir / 'logs'), '--num_queries', '1', '--avoid_wandb', '2',
            '--test_device_batch', str(EVAL_DEVICE_BATCH), '--plugin_batch', '4',
            '--num_workers', '4', '--device', DEV, '--seed', str(SEED),
            '--log_level', 'debug']


def run_eval(argv, log_fp):
    '''python eval_torch.py argv as a subprocess, its output to log_fp; fails on a
    non-zero exit or after EVAL_TIMEOUT_S. Returns (log text, wall seconds).'''
    t0 = time.perf_counter()
    with open(log_fp, 'w') as log:
        try:
            proc = subprocess.run([sys.executable, 'eval_torch.py', *argv], stdout=log,
                                  stderr=subprocess.STDOUT, timeout=EVAL_TIMEOUT_S,
                                  cwd=os.path.dirname(os.path.abspath(__file__)))
        except subprocess.TimeoutExpired:
            fail(f'eval_torch.py took over {EVAL_TIMEOUT_S} s')
    text = log_fp.read_text()
    if proc.returncode != 0:
        print(text[-4000:], file=sys.stderr)
        fail(f'eval_torch.py exited {proc.returncode}')
    return text, time.perf_counter() - t0


def check_eval_csv(csv_fp):
    '''The itemized CSV: one row per clip, Kubric then plugin, finite numbers.'''
    with open(csv_fp, newline='') as f:
        rows = list(csv.DictReader(f))
    if len(rows) != EVAL_SCENES + len(EVAL_PLUGIN_NAMES):
        fail(f'{csv_fp}: {len(rows)} rows')
    names = [r['friendly_short_name'] for r in rows]
    if tuple(names[EVAL_SCENES:]) != EVAL_PLUGIN_NAMES:
        fail(f'{csv_fp}: plugin clips {names[EVAL_SCENES:]}')
    for r in rows:
        for k, v in r.items():
            if k.startswith(('mean_', 'count_')) or (k.startswith('loss_') and v != ''):
                if not np.isfinite(float(v)):
                    fail(f'{csv_fp}: {r["friendly_short_name"]} {k} = {v}')
    return rows


def check_eval_videos(log_dir, rows, frames):
    '''Every clip's overlay videos decode to their frame count: input (its query frame
    held three times), heat map, three channels, and the ground truth where the clip has
    a target (it must where any metric counted a frame; a plugin clip whose frames hold
    no annotation has none). Returns {stem: container}.'''
    out = {}
    for r in rows:
        name = r['friendly_short_name']
        counted = any(int(v) > 0 for k, v in r.items() if k.startswith('count_'))
        for kind, n in (('in', frames + 2), ('out_sn', frames), ('out_oc', frames),
                        ('gt', frames)):
            stem = f'{name}_q0_{kind}'
            present = [ext for ext in ('.webm', '.mp4')
                       if (log_dir / 'visuals' / (stem + ext)).exists()]
            if kind == 'gt' and not present:
                if counted:
                    fail(f'{name}: metrics counted frames but no ground-truth video')
                continue
            fp = find_video(log_dir / 'visuals', stem)
            if decoded_frames(fp) != n:
                fail(f'{fp} decodes to {decoded_frames(fp)} frames, expected {n}')
            out[stem] = fp.suffix
    return out


def eval_step_stats(text):
    '''The eval_stats lines: each device step's launches exactly EVAL_PER_STEP, in the
    order of EVAL_STEPS, then the media wait.'''
    stats = [json.loads(m.group(1)) for m in EVAL_STATS.finditer(text)]
    steps = [r for r in stats if r['phase'] != 'media_wait']
    got = tuple((r['phase'], r['step'], r['clips']) for r in steps)
    if got != EVAL_STEPS:
        fail(f'eval device steps {got}, expected {EVAL_STEPS}')
    for r in steps:
        if r['launches'] != EVAL_PER_STEP:
            fail(f'eval {r["phase"]} step {r["step"]} launched {r["launches"]}, '
                 f'expected {EVAL_PER_STEP}')
    media = [r for r in stats if r['phase'] == 'media_wait']
    return steps, media[0]['wall_ms'] if media else None


def eval_kernel_vs_plain(workdir, kubric_root):
    '''In this process: the first Kubric test batch through InferenceEngine.run_kubric,
    the kernel path against the same engine with the plain attention (bf16 both): the
    output masks within TOL_SEEKER_BF16, and 24 K1 launches for the kernel path.'''
    test_args = config_lib.test_args(eval_argv(workdir, kubric_root)[:-2]
                                     + ['--name', 'ev_inproc'])
    params, cfg, train_args, dset_args, *_ = load_networks(
        test_args.resume, None, compute_dtype=torch.bfloat16, device=DEV)
    loader, _ = factory.create_test_data_loader(train_args, test_args, dset_args, None,
                                                data_path=str(kubric_root))
    batch = next(iter(loader))['device']
    engine = InferenceEngine(params, cfg, LossConfig(), 1, device=DEV)
    counts = read_launches()
    kernel = engine.run_kubric(batch)
    torch.cuda.synchronize()
    launched = launches_since(counts)
    with plain_attention():
        plain = engine.run_kubric(batch)
    if launched != EVAL_PER_STEP:
        fail(f'run_kubric launched {launched}, expected {EVAL_PER_STEP}')
    t = lambda res: torch.from_numpy(np.concatenate([m['output_mask'] for m, _ in res]))
    err = rel_l2(t(kernel), t(plain))
    if not err <= TOL_SEEKER_BF16:
        fail(f'run_kubric kernel vs plain: rel L2 {err} > {TOL_SEEKER_BF16}')
    loss_err = max(abs(k['total_seeker'] - p['total_seeker']) / max(abs(p['total_seeker']),
                                                                     1e-12)
                   for (_, k), (_, p) in zip(kernel, plain))
    del engine, params
    torch.cuda.empty_cache()
    return dict(clips=len(kernel), launches=launched, mask_rel_l2=err,
                total_seeker_max_rel_diff=loss_err, tol_rel_l2=TOL_SEEKER_BF16)


def phase_eval(workdir):
    '''The evaluation path at full width: a seeded checkpoint of the configuration of
    record, a Kubric test set written by the port and the demo video through
    `python eval_torch.py` as a subprocess (2 Kubric device steps and 1 plugin step, 24 K1
    each and no other kernel; 8 CSV rows, the rollball clips' friendly names, finite
    metrics, no self-check error, traceback or overlay warning; every overlay video
    decoded back), then pick_represent on its results, then run_kubric kernel vs plain in
    this process. Prints per-step host times, clips/s per source, the media time, peak
    memory and the video container written.'''
    shutil.rmtree(workdir, ignore_errors=True)
    out = {}
    kubric_root, out['dataset_write_s'], out['dataset_bytes'] = dataset('eval')
    eval_checkpoint(workdir / 'checkpoints' / 'eval1')
    text, out['wall_s'] = run_eval(eval_argv(workdir, kubric_root), workdir / 'eval.log')
    faults = [f for f in EVAL_LOG_FAULTS if f in text]
    if faults:
        print(text[-4000:], file=sys.stderr)
        fail(f'eval log holds {faults}')
    steps, media_wait_ms = eval_step_stats(text)
    log_dir = workdir / 'logs' / 'eval1' / 'test_ev_e0'
    rows = check_eval_csv(log_dir / 'itemized_results.csv')
    videos = check_eval_videos(log_dir, rows, SEEKER_ARGS['num_total_frames'])
    containers = sorted(set(videos.values()))

    guide = workdir / 'eval_rollball.txt'
    guide.write_text('# both usage modes of the demo video at T = 30\nrollball_i\n')
    rep_dir = workdir / 'represent'
    proc = subprocess.run(
        [sys.executable, '-m', 'tcow_tpu_torch.evaluation.pick_represent', '--testres_path',
         str(log_dir), '--represent_guide', 'rep_lists/demo_rollball.txt', str(guide),
         '--output_dir', str(rep_dir)], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
        fail(f'pick_represent exited {proc.returncode}')
    with open(rep_dir / '_autosmr_0.csv', newline='') as f:
        summary = list(csv.DictReader(f))
    if len(summary) != 1 or summary[0]['num_examples'] != str(len(EVAL_PLUGIN_NAMES)):
        fail(f'pick_represent summary {summary}')

    by_source = {}
    for r in steps:
        agg = by_source.setdefault(r['phase'], {'clips': 0, 'wall_ms': 0.0, 'render_ms': 0.0})
        agg['clips'] += r['clips']
        agg['wall_ms'] += r['wall_ms']
        agg['render_ms'] += r['render_ms']
    for agg in by_source.values():
        agg['clips_per_s'] = agg['clips'] / (agg['wall_ms'] / 1e3)
    out.update(
        steps=[{k: r.get(k) for k in ('phase', 'step', 'clips', 'wall_ms', 'wait_ms',
                                      'render_ms', 'launches', 'max_memory_allocated')}
               for r in steps],
        by_source=by_source, media_wait_ms=media_wait_ms,
        media_ms=sum(r['render_ms'] for r in steps) + (media_wait_ms or 0.0),
        peak_bytes=max(r.get('max_memory_allocated', 0) for r in steps),
        videos=len(videos), containers=containers, csv_rows=len(rows),
        plugin_names=[r['friendly_short_name'] for r in rows[EVAL_SCENES:]],
        pick_represent={k: summary[0][k] for k in ('guide', 'num_examples')})
    out['kernel_vs_plain'] = eval_kernel_vs_plain(workdir, kubric_root)
    launches = sum_launches(steps)
    emit({'phase': 'eval', 'launches': launches, **out})
    return {'launches': launches}


# ---------------------------------------------------------------------------------------
# Streaming and serving: K1 on every frame's spatial attention
# ---------------------------------------------------------------------------------------

# The stream of record: window 30 with 1 pinned frame over demo/rollball.mp4 from its
# query at frame 15 (185 frames), as tools/torch_serve.py's demo client streams it.
STREAM_WINDOW = 30
STREAM_PINNED = 1
STREAM_QUERY_FRAME = 15
STREAM_QUERY = 'demo/rollball_15_query.png'
STREAM_EVAL_NAME = 'rollball_i0_f15_s0'
# K1 per stream frame and per server tick: one spatial attention call per block, over the
# frame's N = 300 patches and the cls token.
K1_PER_FRAME = {'K1': SEEKER_ARGS['network_depth']}
S_SPATIAL = GEOMETRIES['spatial'][1]
# K1 at the stream's shapes: 1 sequence of N + 1 = 301 (a stream, a dedicated session)
# and 4 (a tick of the batched server with 4 sessions), not causal.
STREAM_K1_SEQS = (1, 4)
STREAM_PROFILE_FRAMES = 10
# The f32 stream against the f32 batch forward, at depth 2 and full width.
STREAM_F32_DEPTH = 2
# Batched serve replies against the direct stream (float16 on the wire): the batched
# step runs cuBLAS at another M than the B = 1 stream, which may round differently.
TOL_SERVE_BATCHED = 1e-2
SERVE_CLIENTS = 4
SERVE_FRAMES = 60
SERVE_SLOTS = (1, 4)
SERVE_MIGRATE_AFTER = 35   # frames before the reload: the ring has wrapped
SERVE_TIMEOUT_S = 120


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def stream_model(params, cfg):
    '''The seeker of an InferenceEngine on the card, as the stream's users build it.'''
    return InferenceEngine(params, cfg, device=DEV).model


def stream_clips(model, rgb, query, window=None):
    '''A stream over clips (B, 3, T, H, W) on the card, one stream_step per frame ->
    (masks (B, C, T, H, W), flags (B, T, F)) f32.'''
    B, T = rgb.shape[0], rgb.shape[2]
    state = streaming.init_stream(model, B, max_frames=None if window else T, window=window,
                                  pinned_frames=STREAM_PINNED)
    masks, flags = [], []
    for t in range(T):
        state, m, f = streaming.stream_step(model, state, rgb[:, :, t], query[:, :, t],
                                            window=window, pinned_frames=STREAM_PINNED)
        masks.append(m)
        flags.append(f)
    return torch.stack(masks, 2), torch.stack(flags, 1)


def stream_demo_example():
    '''demo/rollball.mp4 as the streaming evaluation reads it (every frame from the query
    on, at 240x320), and its frames (N, 3, H, W) and queries (N, 1, H, W) pinned.'''
    ds = PluginVideoDataset(EVAL_DEMO, None, 'test', num_clip_frames=SEEKER_ARGS[
        'num_total_frames'], frame_height=SEEKER_ARGS['frame_height'],
        frame_width=SEEKER_ARGS['frame_width'], query_time=EVAL_QUERY_TIME, prefetch=True,
        center_crop=True)
    ex = ds.get_streaming_example()
    pin = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(1, 0, 2, 3))).pin_memory()
    return ex, pin(ex['rgb']), pin(ex['query'])


def stream_k1_times():
    '''K1 at 1 x 301 and 4 x 301 (the stream's and a 4-session tick's spatial call), bf16
    and f32, against its plain version in f32 from the same inputs; whether a sequence's
    output is the same bits alone and inside a batch of 4; and timed beside the plain
    version, addmm + SDPA + addmm and the bound.'''
    S = S_SPATIAL
    out = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace('torch.', '')
            for i, B in enumerate(STREAM_K1_SEQS):
                x, w = attn_inputs(B, S, dtype, SEED + 900 + i)
                got = fa.fused_attention(x, *w, HEADS, 0)
                want = fa.attention_ref(x.float(), *w, HEADS, 0)
                tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
                e = dict(B=B, S=S, ca=0, dtype=name, tol_rel_l2=tol,
                         rel_l2_err=rel_l2(got.float(), want),
                         max_abs_err=float((got.float() - want).abs().max()))
                if not e['rel_l2_err'] <= tol:
                    fail(f'K1 {B}x{S} {name}: kernel vs plain rel L2 {e["rel_l2_err"]} > {tol}')
                if B > 1:
                    alone = fa.fused_attention(x[1:2].contiguous(), *w, HEADS, 0)
                    e['seq_bits_equal_alone_and_in_batch'] = bool(torch.equal(alone, got[1:2]))
                if dtype == torch.bfloat16:
                    w16 = [a.to(dtype) for a in w]
                    bound_ms, bound_by = bound(k1_flops(B, S, 0), k1_bytes(B, S, 2))
                    e.update(ms=cuda_ms(lambda: fa.fused_attention(x, *w, HEADS, 0)),
                             plain_ms=cuda_ms(lambda: fa.attention_ref(x, *w, HEADS, 0)),
                             library_ms=cuda_ms(lambda: library_attention(x, w16, 0)),
                             bound_ms=bound_ms, bound_by=bound_by,
                             flops=k1_flops(B, S, 0), bytes=k1_bytes(B, S, 2))
                out[f'{name}_{B}x{S}'] = e
    return out


def profile_stream_frames(step, n=STREAM_PROFILE_FRAMES):
    '''n calls of step(t) (one stream step each) under torch.profiler: host wall and
    device busy ms per step (the union of the device events), the busy share, the device
    events per step and the device ms per step of the bf16 weight casts (the
    'gemm_weight_cast' range).'''
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(n):
            step(t)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, cast_ms = [], 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
        elif ev.name == 'gemm_weight_cast':
            cast_ms += ev.device_time_total / 1e3
    busy_us, end = 0.0, float('-inf')
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return dict(steps=n, wall_ms_per_step=wall_ms / n, device_busy_ms_per_step=busy_us / 1e3 / n,
                device_busy_share=busy_us / 1e3 / wall_ms, device_events_per_step=len(spans) / n,
                weight_cast_ms_per_step=cast_ms / n)


def profile_stream(model, state, frames, queries):
    '''The profiled window of the B = 1 stream (continuing `state`), then of a
    multi-session state of the 4 sessions a batched server step serves (all active).'''
    up = lambda a, t: a[t:t + 1].to(DEV, non_blocking=True)
    out = {'b1': profile_stream_frames(lambda t: streaming.stream_step(
        model, state, up(frames, t), up(queries, t), window=STREAM_WINDOW,
        pinned_frames=STREAM_PINNED))}
    B = SERVE_CLIENTS
    multi = streaming.init_stream_multi(model, B, window=STREAM_WINDOW,
                                        pinned_frames=STREAM_PINNED)
    active = torch.ones(B, dtype=torch.bool, device=DEV)
    out[f'b{B}_multi'] = profile_stream_frames(lambda t: streaming.stream_step_multi(
        model, multi, up(frames, t).expand(B, -1, -1, -1), up(queries, t).expand(B, -1, -1, -1),
        active, window=STREAM_WINDOW, pinned_frames=STREAM_PINNED))
    return out


def stream_eval_argv(workdir):
    return ['--resume', 'eval1', '--name', 'st', '--data_path', EVAL_DEMO,
            '--checkpoint_root', str(workdir / 'checkpoints'),
            '--log_root', str(workdir / 'logs'), '--num_queries', '1', '--avoid_wandb', '2',
            '--num_workers', '1', '--device', DEV, '--seed', str(SEED), '--log_level', 'debug',
            '--stream_window', str(STREAM_WINDOW)]


def stream_eval_run(workdir):
    '''`python eval_torch.py --stream_window 30` on the demo video as a subprocess: one
    device step of phase plugin_stream over every frame from the query on, 12 K1 a frame
    and no other kernel, one CSV row with the streaming friendly name and finite metrics.'''
    text, wall_s = run_eval(stream_eval_argv(workdir), workdir / 'stream_eval.log')
    faults = [f for f in EVAL_LOG_FAULTS if f in text]
    if faults:
        print(text[-4000:], file=sys.stderr)
        fail(f'stream eval log holds {faults}')
    stats = [json.loads(m.group(1)) for m in EVAL_STATS.finditer(text)]
    steps = [r for r in stats if r['phase'] != 'media_wait']
    if [(r['phase'], r['clips']) for r in steps] != [('plugin_stream', 1)]:
        fail(f'stream eval device steps {steps}')
    step = steps[0]
    want = {k: n * step['frames'] for k, n in K1_PER_FRAME.items()}
    if step['launches'] != want:
        fail(f'stream eval launched {step["launches"]}, expected {want}')
    with open(workdir / 'logs' / 'eval1' / 'test_st_e0' / 'itemized_results.csv',
              newline='') as f:
        rows = list(csv.DictReader(f))
    if len(rows) != 1 or rows[0]['friendly_short_name'] != STREAM_EVAL_NAME:
        fail(f'stream eval CSV rows {[r.get("friendly_short_name") for r in rows]}')
    for k, v in rows[0].items():
        if k.startswith(('mean_', 'count_')) and not np.isfinite(float(v)):
            fail(f'stream eval CSV {k} = {v}')
    return dict(wall_s=wall_s, frames=step['frames'], launches=step['launches'],
                step_wall_ms=step['wall_ms'], ms_per_frame=step['wall_ms'] / step['frames'],
                render_ms=step['render_ms'], peak_bytes=step.get('max_memory_allocated'),
                csv_row={k: rows[0][k] for k in ('friendly_short_name', 'count_snitch_iou',
                                                 'mean_snitch_iou')})


def phase_stream(workdir):
    '''The stream at full width (the configuration of record, bf16, from a seeded
    checkpoint through load_networks): demo/rollball.mp4 through stream_step at window 30
    frame by frame (the main path: 12 K1 a frame and no other kernel; per-frame latency,
    peak, a profiled window); the 2 clips of plugin_request streamed unbounded against the
    batch forward and against the stream with the plain attention; f32 at depth 2 against
    the f32 batch forward; K1 at 1 x 301 and 4 x 301; then eval_torch.py --stream_window.'''
    shutil.rmtree(workdir, ignore_errors=True)
    eval_checkpoint(workdir / 'checkpoints' / 'eval1')
    params, cfg, *_ = load_networks(str(workdir / 'checkpoints' / 'eval1'), None,
                                    compute_dtype=torch.bfloat16, device=DEV)
    model = stream_model(params, cfg)
    ex, frames, queries = stream_demo_example()
    N = frames.shape[0]
    out = {'frames': N, 'annotated': ex['annotated_inds'].tolist()}

    # The main path, counted alone.
    with torch.inference_mode():
        state = streaming.init_stream(model, 1, window=STREAM_WINDOW,
                                      pinned_frames=STREAM_PINNED)
        torch.cuda.synchronize()
        allocated_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        frame_ms, masks = [], []
        for t in range(N):
            t0 = time.perf_counter()
            state, m, _ = streaming.stream_step(
                model, state, frames[t:t + 1].to(DEV, non_blocking=True),
                queries[t:t + 1].to(DEV, non_blocking=True), window=STREAM_WINDOW,
                pinned_frames=STREAM_PINNED)
            torch.cuda.synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            masks.append(m)
        launches = {k: n for k, n in read_launches().items() if n}
        peak = torch.cuda.max_memory_allocated()
        if launches != {k: n * N for k, n in K1_PER_FRAME.items()}:
            fail(f'the stream launched {launches} over {N} frames, expected '
                 f'{K1_PER_FRAME} a frame')
        masks = torch.cat(masks)
        if masks.shape != (N, 3, SEEKER_ARGS['frame_height'], SEEKER_ARGS['frame_width']) \
                or not torch.isfinite(masks).all():
            fail(f'stream masks {tuple(masks.shape)}, finite {bool(torch.isfinite(masks).all())}')
        out['profile'] = profile_stream(model, state, frames, queries)
    out.update(launches=launches, frame_ms_median=percentile(frame_ms[1:], 50),
               frame_ms_p90=percentile(frame_ms[1:], 90), frame_ms_first=frame_ms[0],
               frames_per_s=1e3 / percentile(frame_ms[1:], 50), peak_bytes=peak,
               allocated_before_bytes=allocated_before,
               cache_bytes=2 * cfg.network_depth * (S_SPATIAL - 1) * D * 2 * STREAM_WINDOW)
    del masks, state

    # The 2 clips of a plugin request, unbounded: against the batch forward, the plain
    # attention, and f32 at depth 2.
    rgb, query, _ = (torch.as_tensor(a, device=DEV) for a in plugin_request(SEED))
    with torch.inference_mode():
        counts = read_launches()
        s_mask, s_flags = stream_clips(model, rgb, query)
        clip_launches = launches_since(counts)
        b_mask, b_flags = model(rgb, query)
        with plain_attention():
            p_mask, p_flags = stream_clips(model, rgb, query)
        with depth_preset(STREAM_F32_DEPTH, (D, HEADS)):
            cfg32 = seeker_config_from_args(SEEKER_ARGS, network_depth=STREAM_F32_DEPTH,
                                            compute_dtype=torch.float32)
            m32 = MaskTracker(cfg32, device=DEV)
            m32.init_params_(torch.Generator().manual_seed(SEED + 1))
            m32.eval()
            s32, _ = stream_clips(m32, rgb, query)
            b32, _ = m32(rgb, query)
            del m32
    T = rgb.shape[2]
    if clip_launches != {k: n * T for k, n in K1_PER_FRAME.items()}:
        fail(f'streaming 2 clips launched {clip_launches}')
    errs = {'stream_vs_batch_bf16': rel_l2(s_mask, b_mask),
            'stream_flags_vs_batch_bf16': rel_l2(s_flags, b_flags),
            'stream_kernel_vs_plain_bf16': rel_l2(s_mask, p_mask),
            'stream_flags_kernel_vs_plain_bf16': rel_l2(s_flags, p_flags),
            'stream_vs_batch_f32_depth2': rel_l2(s32, b32)}
    for key, tol in (('stream_vs_batch_bf16', TOL_SEEKER_BF16),
                     ('stream_flags_vs_batch_bf16', TOL_SEEKER_BF16),
                     ('stream_kernel_vs_plain_bf16', TOL_SEEKER_BF16),
                     ('stream_flags_kernel_vs_plain_bf16', TOL_SEEKER_BF16),
                     ('stream_vs_batch_f32_depth2', TOL_SEEKER_F32)):
        if not errs[key] <= tol:
            fail(f'{key}: rel L2 {errs[key]} > {tol}')
    out.update(clip_launches=clip_launches, rel_l2=errs,
               tol_rel_l2={'bf16': TOL_SEEKER_BF16, 'f32': TOL_SEEKER_F32})
    del s_mask, b_mask, p_mask, s32, b32, model
    torch.cuda.empty_cache()

    out['k1'] = stream_k1_times()
    out['eval'] = stream_eval_run(workdir)
    emit({'phase': 'stream', **out})
    return {'launches': launches, 'clip_launches': clip_launches,
            'eval_launches': out['eval']['launches'], 'k1': out['k1'], 'params': params,
            'cfg': cfg}


def serve_frames():
    '''demo/rollball.mp4 as tools/torch_serve.py's client sends it: uint8 (F, H, W, 3)
    frames from the query frame on and the query mask (H, W) bool.'''
    import cv2
    H, W = SEEKER_ARGS['frame_height'], SEEKER_ARGS['frame_width']
    cap = cv2.VideoCapture(EVAL_DEMO)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.resize(bgr[..., ::-1], (W, H)).astype(np.uint8))
    cap.release()
    q = cv2.imread(STREAM_QUERY, cv2.IMREAD_GRAYSCALE)
    if not frames or q is None:
        fail('could not read the demo video or its query mask')
    q = cv2.resize(q, (W, H), interpolation=cv2.INTER_NEAREST) > 127
    return np.stack(frames[STREAM_QUERY_FRAME:]), q


def serve_reference(model, frames, q):
    '''The direct stream of one session on the card from the server's wire inputs (uint8
    normalised on the device, the query > 127 at the first frame) -> float16 masks.'''
    state = streaming.init_stream(model, 1, window=STREAM_WINDOW, pinned_frames=STREAM_PINNED)
    q8 = torch.from_numpy(q.astype(np.uint8) * 255)[None, None].to(DEV)
    masks = []
    for i, frame in enumerate(frames):
        f = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1))[None]).to(DEV)
        qm = (q8 > 127).float() if i == 0 else torch.zeros_like(q8, dtype=torch.float32)
        state, m, _ = streaming.stream_step(model, state, f.float() / 255.0, qm,
                                            window=STREAM_WINDOW, pinned_frames=STREAM_PINNED)
        masks.append(m[0].to(torch.float16))
    return torch.stack(masks).cpu().numpy()


def serve_clients(addr, frames, q):
    '''SERVE_CLIENTS concurrent clients, client k streaming frames k .. k + SERVE_FRAMES
    - 1 with the query at its first frame -> (float16 masks per client, round-trip ms
    per client, wall s).'''
    masks = [[] for _ in range(SERVE_CLIENTS)]
    rtt = [[] for _ in range(SERVE_CLIENTS)]
    errors = []

    def run(k):
        try:
            c = serving.TrackerClient(*addr, timeout=SERVE_TIMEOUT_S)
            c.open(window=STREAM_WINDOW)
            for i in range(SERVE_FRAMES):
                t0 = time.perf_counter()
                m, _, t = c.track(frames[k + i], query_mask=q if i == 0 else None)
                rtt[k].append(1e3 * (time.perf_counter() - t0))
                if t != i:
                    raise RuntimeError(f'client {k}: reply t {t} for frame {i}')
                masks[k].append(m)
            c.close()
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append((k, repr(e)))

    threads = [threading.Thread(target=run, args=(k,)) for k in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=SERVE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads) or errors:
        fail(f'serve clients: errors {errors}, hung {[th.is_alive() for th in threads]}')
    return [np.stack(m) for m in masks], rtt, wall


def phase_serve(params, cfg):
    '''The tracking server in this process on 127.0.0.1: batch_slots 1 (dedicated
    sessions), then 4 (continuous batching), each with SERVE_CLIENTS concurrent clients
    streaming SERVE_FRAMES frames of the demo video at window 30: dedicated replies the
    direct stream's bits, batched within TOL_SERVE_BATCHED, 12 K1 per frame or per tick
    and no other kernel; frames/s, round trips, mean sessions per tick and peak; then a
    reload with migrate_sessions=True that a live session survives.'''
    frames, q = serve_frames()
    ref_model = stream_model(params, cfg)
    with torch.inference_mode():
        refs = [serve_reference(ref_model, frames[k:k + SERVE_FRAMES], q)
                for k in range(SERVE_CLIENTS)]
    out = {}
    launches_by_run = {}
    for slots in SERVE_SLOTS:
        gc.collect()
        torch.cuda.empty_cache()
        server = serving.TrackerServer(params, cfg, batch_slots=slots, device=DEV)
        addr = server.start()
        try:
            torch.cuda.synchronize()
            allocated_before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            masks, rtt, wall = serve_clients(addr, frames, q)
            launches = {k: n for k, n in read_launches().items() if n}
            peak = torch.cuda.max_memory_allocated()
            groups = list(server._groups.values())
        finally:
            server.stop()
        n = SERVE_CLIENTS * SERVE_FRAMES
        steps = groups[0].steps if groups else n
        if launches != {k: v * steps for k, v in K1_PER_FRAME.items()}:
            fail(f'serve batch_slots={slots}: {launches} over {steps} steps, expected '
                 f'{K1_PER_FRAME} a step')
        errs = [rel_l2(torch.from_numpy(m.astype(np.float32)),
                       torch.from_numpy(r.astype(np.float32))) for m, r in zip(masks, refs)]
        r = dict(batch_slots=slots, frames=n, steps=steps, launches=launches, wall_s=wall,
                 frames_per_s=n / wall, sessions_per_step=n / steps,
                 rtt_ms_median=percentile([x for c in rtt for x in c[1:]], 50),
                 rtt_ms_p90=percentile([x for c in rtt for x in c[1:]], 90),
                 rel_l2_vs_direct=errs, peak_bytes=peak,
                 allocated_before_bytes=allocated_before)
        if slots == 1:
            r['bits_equal_direct'] = all(np.array_equal(m, ref) for m, ref in zip(masks, refs))
            if not r['bits_equal_direct']:
                fail(f'dedicated serve replies differ from the direct stream: rel L2 {errs}')
        elif not max(errs) <= TOL_SERVE_BATCHED:
            fail(f'batched serve replies vs the direct stream: rel L2 {max(errs)} > '
                 f'{TOL_SERVE_BATCHED}')
        out[f'slots_{slots}'] = r
        launches_by_run[f'serve_slots_{slots}'] = launches.get('K1', 0)
        del server, groups
    out['reload_migration'] = serve_reload(params, cfg, frames, q)
    del ref_model
    torch.cuda.empty_cache()
    emit({'phase': 'serve', **out})
    return {'launches': launches_by_run}


def serve_reload(params, cfg, frames, q):
    '''A batched server with migrate_sessions=True: one session streams SERVE_MIGRATE_AFTER
    frames, a reload swaps in other seeded weights, the session streams on with a
    continuous t; its next frames against a direct stream under the new weights fed the
    frames the window retains (pinned frame 0 and the last 29), within TOL_SERVE_BATCHED.'''
    model_b = MaskTracker(cfg, device=DEV)
    model_b.init_params_(torch.Generator().manual_seed(SEED + 7))
    model_b.eval()
    params_b = params_to_jax(model_b.state_dict())
    server = serving.TrackerServer(params, cfg, batch_slots=SERVE_CLIENTS, device=DEV,
                                   migrate_sessions=True, params_loader=lambda _: params_b)
    addr = server.start()
    after = 3
    try:
        c = serving.TrackerClient(*addr, timeout=SERVE_TIMEOUT_S)
        c.open(window=STREAM_WINDOW)
        for i in range(SERVE_MIGRATE_AFTER):
            c.track(frames[i], query_mask=q if i == 0 else None)
        admin = serving.TrackerClient(*addr, timeout=SERVE_TIMEOUT_S)
        t0 = time.perf_counter()
        epoch = admin.reload('seeded_b')
        reload_ms = 1e3 * (time.perf_counter() - t0)
        got, ts = [], []
        t0 = time.perf_counter()
        for i in range(SERVE_MIGRATE_AFTER, SERVE_MIGRATE_AFTER + after):
            m, _, t = c.track(frames[i])
            got.append(m)
            ts.append(t)
            if i == SERVE_MIGRATE_AFTER:
                migrate_ms = 1e3 * (time.perf_counter() - t0)
        stats = c.stats()
        c.close()
        admin.close()
    finally:
        server.stop()
    keep = [0] + list(range(SERVE_MIGRATE_AFTER - (STREAM_WINDOW - STREAM_PINNED),
                            SERVE_MIGRATE_AFTER))
    sub = np.concatenate([frames[keep], frames[SERVE_MIGRATE_AFTER:SERVE_MIGRATE_AFTER + after]])
    with torch.inference_mode():
        want = serve_reference(model_b, sub, q)[len(keep):]
    err = rel_l2(torch.from_numpy(np.stack(got).astype(np.float32)),
                 torch.from_numpy(want.astype(np.float32)))
    if ts != list(range(SERVE_MIGRATE_AFTER, SERVE_MIGRATE_AFTER + after)) or epoch != 1 \
            or stats['migrations'] != 1:
        fail(f'reload: t {ts}, params epoch {epoch}, migrations {stats["migrations"]}')
    if not err <= TOL_SERVE_BATCHED:
        fail(f'migrated session vs the new weights\' stream: rel L2 {err} > {TOL_SERVE_BATCHED}')
    del model_b
    return dict(frames_before=SERVE_MIGRATE_AFTER, replayed=len(keep), reload_ms=reload_ms,
                migrated_frame_ms=migrate_ms, rel_l2_vs_new_weights=err,
                migrations=stats['migrations'])


# ---------------------------------------------------------------------------------------
# The time-calibrated rope path: K1r ... K6r
# ---------------------------------------------------------------------------------------

def rope_positions(B, S, seed):
    '''Per-row frame times (B, S) f32 on the card, drawn as the augmentations draw them.'''
    return torch.from_numpy(synthetic_frame_times(seed, B, S, ROPE_FRAME_STRIDE)).to(DEV)


def rope_flops(B, S):
    '''The rotation's operations on top of a kernel's: 6 per rotated element pair of q and
    k (4 products, 2 sums), B S D / 2 pairs each.'''
    return 6 * B * S * D


def table_bytes(B, S):
    '''The per-row cos and sin tables (B, S, dh/2) f32, read once.'''
    return 2 * B * S * (D // HEADS // 2) * 4


def phase_rope_kernels_vs_plain():
    '''K1r ... K6r at the temporal inference and training shapes, bf16 and float32, with
    row positions and with per-row frame times, against their plain versions in f32 from
    the same inputs and positions; K6r twice, bit-equal; and at the training shape in bf16
    with frame times the five gradients of the differentiable call in each mode against
    autograd through the plain forward in f32.'''
    errs = {f'K{i}r': {} for i in range(1, 7)}
    grads = {}
    cases = [(f'{name}_{str(dtype)[6:]}_{"times" if times else "rows"}', B, S, ca, dtype, times)
             for name, (B, S, ca) in ROPE_GEOMETRIES.items()
             for dtype in (torch.bfloat16, torch.float32) for times in (False, True)]
    for i, (name, B, S, ca, dtype, times) in enumerate(cases):
        x, w = attn_inputs(B, S, dtype, SEED + 300 + i)
        g = grad_input(B, S, dtype, SEED + 320 + i)
        pos = rope_positions(B, S, SEED + 340 + i) if times else None
        k1 = fa.fused_attention_fwd(x, *w, HEADS, ca, True, pos)
        k2 = fa.fused_attention_fwd_qkv(x, *w, HEADS, ca, True, pos)
        k3 = fa.fused_attention_fwd_res(x, *w, HEADS, ca, True, pos)
        k4 = fa.fused_attention_bwd(x, g, *w[:3], HEADS, ca, True, pos)
        k5 = fa.fused_attention_bwd_qkv(k2[1], g, w[2], HEADS, ca, True, pos)
        k6 = fa.fused_attention_bwd_wg(x, g, *w[:3], HEADS, ca, True, pos)
        k6_again = fa.fused_attention_bwd_wg(x, g, *w[:3], HEADS, ca, True, pos)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k6, k6_again)):
            fail(f'{name}: K6r gave other gradients on a second run')
        del k6_again
        res = fa.attention_res_ref(x.float(), *w, HEADS, ca, True, pos)
        plain = {'K1r': ((k1,), res[:1], ('out',)),
                 'K2r': (k2, res[:2], ('out', 'qkv')),
                 'K3r': (k3, res, ('out', 'qkv', 'probs', 'attn')),
                 'K4r': (k4, fa.attention_bwd_ref(x.float(), g.float(), *w[:3], HEADS, ca,
                                                  True, pos), ('dqkv', 'attn')),
                 'K5r': (k5, fa.attention_bwd_qkv_ref(k2[1].float(), g.float(), w[2], HEADS,
                                                      ca, True, pos), ('dqkv', 'attn')),
                 'K6r': (k6, fa.attention_bwd_wg_ref(x.float(), g.float(), *w[:3], HEADS,
                                                     ca, True, pos),
                         ('dx', 'dqkv_w', 'dqkv_b', 'dproj_w', 'dproj_b'))}
        del res
        for kernel, (got, want, names) in plain.items():
            if [t.shape for t in got] != [t.shape for t in want]:
                fail(f'{name}: {kernel} output shapes {[tuple(t.shape) for t in got]}')
            tol = (TOL_F32 if dtype == torch.float32
                   else TOL_BF16 if kernel in ('K1r', 'K2r', 'K3r') else TOL_K4_BF16)
            e = dict(B=B, S=S, ca=ca, dtype=str(dtype)[6:], positions=(
                'frame_times' if times else 'rows'), tol_rel_l2=tol,
                max_abs_err=max(float((a.float() - b).abs().max()) for a, b in zip(got, want)))
            e.update({f'rel_l2_{n}': rel_l2(a.float(), b) for n, a, b in zip(names, got, want)})
            errs[kernel][name] = e
            bad = {k: v for k, v in e.items() if k.startswith('rel_l2') and not v <= tol}
            if bad:
                fail(f'{name}: {kernel} vs plain rel L2 above {tol}: {bad}')
        del plain, k1, k2, k3, k4, k5, k6
        if name == 'train_temporal_bfloat16_times':
            for mode in fa.BWD_MODES:
                leaves = [x.clone().requires_grad_()] + [a.clone().requires_grad_() for a in w]
                fa.fused_attention(*leaves, HEADS, ca, mode, True, pos).backward(g)
                ref = [x.float().requires_grad_()] + [a.clone().requires_grad_() for a in w]
                fa.attention_ref(*ref, HEADS, ca, True, pos).backward(g.float())
                grads[mode] = {f'rel_l2_{n}': rel_l2(a.grad.float(), b.grad) for n, a, b in zip(
                    ('dx', 'dqkv_w', 'dqkv_b', 'dproj_w', 'dproj_b'), leaves, ref)}
                bad = {k: v for k, v in grads[mode].items() if not v <= TOL_K4_BF16}
                if bad:
                    fail(f'{name}: gradients of the rope call ({mode}) above {TOL_K4_BF16}: {bad}')
    emit({'phase': 'rope_kernels_vs_plain', 'cases': errs, 'k6r_deterministic': True,
          'grads_train_temporal_bf16_times': grads, 'tol_grads': TOL_K4_BF16})
    return errs


def rope_outputs(engine, rgb, query, target, frame_times, plain=False):
    with plain_attention() if plain else contextlib.nullcontext():
        res = engine.run_plugin(rgb, query, target, frame_times=frame_times)
    return (np.concatenate([m['output_mask'] for m, _ in res]),
            np.concatenate([m['output_flags'] for m, _ in res]))


def phase_rope_slice(ckpt_dir):
    '''The rope256 seeker: checkpoint -> load_networks -> InferenceEngine -> 3 requests of
    B clips with their frame times. Per request 12 K1r (temporal) + 12 K1 (spatial) and
    no other launch; masks and flags against the plain path; stride-2 times change the
    output, row times 0..T-1 equal no times, and time_embed changes nothing.'''
    cfg0 = seeker_config_from_args(ROPE_ARGS)
    model = MaskTracker(cfg0)
    model.init_params_(torch.Generator().manual_seed(SEED))
    save_checkpoint(str(ckpt_dir), 0, 'chip_smoke_rope', params_to_jax(model.state_dict()),
                    seeker_args=ROPE_ARGS)
    del model
    params, cfg, *_ = load_networks(str(ckpt_dir), None, compute_dtype=torch.bfloat16,
                                    device=DEV)
    if not (cfg.temporal_rope and cfg.rope_time_coords):
        fail(f'load_networks lost the rope keys: {cfg}')
    engine = InferenceEngine(params, cfg, device=DEV)
    rgb, query, target = plugin_request(SEED + 1)
    T = rgb.shape[2]
    times = synthetic_frame_times(SEED, BATCH, T, ROPE_FRAME_STRIDE)
    depth = cfg.network_depth
    reset_launches()
    req_ms, results = [], None
    for _ in range(REQUESTS):
        counts = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run_plugin(rgb, query, target, frame_times=times)
        torch.cuda.synchronize()
        req_ms.append(1e3 * (time.perf_counter() - t0))
        got = launches_since(counts)
        if got != {'K1': depth, 'K1r': depth}:
            fail(f'rope request launched {got}, expected {depth} K1r + {depth} K1')
    launches = read_launches()
    mask = np.concatenate([m['output_mask'] for m, _ in results])
    flags = np.concatenate([m['output_flags'] for m, _ in results])
    if mask.shape != (BATCH, 3) + rgb.shape[2:] or flags.shape != (BATCH, T, 3):
        fail(f'rope output shapes {mask.shape} {flags.shape}')
    if not (np.isfinite(mask).all() and np.isfinite(flags).all()):
        fail('rope: non-finite outputs')

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    eng32 = InferenceEngine(params, cfg32, device=DEV)
    plain = rope_outputs(engine, rgb, query, target, times, plain=True)
    f32_plain = rope_outputs(eng32, rgb, query, target, times, plain=True)
    f32_kernel = rope_outputs(eng32, rgb, query, target, times)
    rows = np.tile(np.arange(T, dtype=np.float32), (BATCH, 1))
    f32_rows = rope_outputs(eng32, rgb, query, target, rows)
    f32_none = rope_outputs(eng32, rgb, query, target, None)
    f32_stride2 = rope_outputs(eng32, rgb, query, target, rows * 2.0)
    other = {**params, 'backbone': {**params['backbone'], 'time_embed': np.random.RandomState(
        SEED).randn(*params['backbone']['time_embed'].shape).astype(np.float32)}}
    other_time = rope_outputs(InferenceEngine(other, cfg32, device=DEV), rgb, query, target,
                              times)
    t = torch.from_numpy
    errs = {
        'mask_kernel_vs_plain_bf16': rel_l2(t(mask), t(plain[0])),
        'flags_kernel_vs_plain_bf16': rel_l2(t(flags), t(plain[1])),
        'mask_kernel_bf16_vs_plain_f32': rel_l2(t(mask), t(f32_plain[0])),
        'mask_plain_bf16_vs_plain_f32': rel_l2(t(plain[0]), t(f32_plain[0])),
        'mask_kernel_vs_plain_f32': rel_l2(t(f32_kernel[0]), t(f32_plain[0])),
        'flags_kernel_vs_plain_f32': rel_l2(t(f32_kernel[1]), t(f32_plain[1])),
        'mask_row_times_vs_no_times_f32': rel_l2(t(f32_rows[0]), t(f32_none[0])),
        'mask_stride2_vs_row_times_f32': rel_l2(t(f32_stride2[0]), t(f32_rows[0])),
    }
    for key, tol in (('mask_kernel_vs_plain_bf16', TOL_SEEKER_BF16),
                     ('flags_kernel_vs_plain_bf16', TOL_SEEKER_BF16),
                     ('mask_kernel_vs_plain_f32', TOL_SEEKER_F32),
                     ('flags_kernel_vs_plain_f32', TOL_SEEKER_F32),
                     ('mask_row_times_vs_no_times_f32', TOL_F32)):
        if not errs[key] <= tol:
            fail(f'rope {key}: rel L2 {errs[key]} > {tol}')
    if not errs['mask_stride2_vs_row_times_f32'] > 0:
        fail('rope: stride-2 frame times did not change the output')
    if not all(np.array_equal(a, b) for a, b in zip(other_time, f32_kernel)):
        fail('rope: time_embed changed the output')
    if launches['K1r'] != REQUESTS * depth or launches['K1'] != REQUESTS * depth:
        fail(f'rope main path launches {launches}')
    steady = sorted(req_ms[1:])[len(req_ms[1:]) // 2]
    emit({'phase': 'rope_slice', 'requests': REQUESTS, 'clips_per_request': BATCH,
          'frame_times_example0': times[0].tolist(), 'launches': launches,
          'request_ms': req_ms, 'request_ms_steady': steady,
          'clips_per_s': BATCH / (steady / 1e3), 'rel_l2': errs,
          'time_embed_changes_output': False,
          'tol_rel_l2': {'bf16': TOL_SEEKER_BF16, 'f32': TOL_SEEKER_F32},
          'metrics_example0': results[0][1]['metrics']})
    return launches['K1r']


def phase_rope_times():
    '''K1r ... K6r per call at the temporal inference and training shapes (bf16, per-row
    frame times), beside their plain versions, the library yardstick with q and k rotated
    by apply_rope, their bound and the same kernel without rope.'''
    per_geom = {f'K{i}r': {} for i in range(1, 7)}
    for i, (name, (B, S, ca)) in enumerate(ROPE_GEOMETRIES.items()):
        x, w = attn_inputs(B, S, torch.bfloat16, SEED + 400 + i)
        g = grad_input(B, S, torch.bfloat16, SEED + 410 + i)
        pos = rope_positions(B, S, SEED + 420 + i)
        cs = head_tables(S, pos)
        w16 = [a.to(torch.bfloat16) for a in w]
        with torch.no_grad():
            qkv = fa.fused_attention_fwd_qkv(x, *w, HEADS, ca, True, pos)[1]
        rf, tb = rope_flops(B, S), table_bytes(B, S)
        calls = {
            'K1r': (lambda: fa.fused_attention_fwd(x, *w, HEADS, ca, True, pos),
                    lambda: fa.fused_attention_fwd(x, *w, HEADS, ca),
                    lambda: fa.attention_ref(x, *w, HEADS, ca, True, pos),
                    lambda: library_attention(x, w16, ca, cs),
                    k1_flops(B, S, ca) + rf, k1_bytes(B, S, 2) + tb),
            'K2r': (lambda: fa.fused_attention_fwd_qkv(x, *w, HEADS, ca, True, pos),
                    lambda: fa.fused_attention_fwd_qkv(x, *w, HEADS, ca),
                    lambda: fa.attention_qkv_ref(x, *w, HEADS, ca, True, pos),
                    lambda: library_attention(x, w16, ca, cs),
                    k1_flops(B, S, ca) + rf, k2_bytes(B, S, 2) + tb),
            'K3r': (lambda: fa.fused_attention_fwd_res(x, *w, HEADS, ca, True, pos),
                    lambda: fa.fused_attention_fwd_res(x, *w, HEADS, ca),
                    lambda: fa.attention_res_ref(x, *w, HEADS, ca, True, pos),
                    lambda: library_attention_probs(x, w16, ca, cs),
                    k1_flops(B, S, ca) + rf, k3_bytes(B, S, 2) + tb),
            'K4r': (lambda: fa.fused_attention_bwd(x, g, *w[:3], HEADS, ca, True, pos),
                    lambda: fa.fused_attention_bwd(x, g, *w[:3], HEADS, ca),
                    lambda: fa.attention_bwd_ref(x, g, *w[:3], HEADS, ca, True, pos),
                    library_attention_bwd(x, w16, ca, g, cs=cs),
                    k4_flops(B, S, ca) + 2 * rf, k4_bytes(B, S, 2) + tb),
            'K5r': (lambda: fa.fused_attention_bwd_qkv(qkv, g, w[2], HEADS, ca, True, pos),
                    lambda: fa.fused_attention_bwd_qkv(qkv, g, w[2], HEADS, ca),
                    lambda: fa.attention_bwd_qkv_ref(qkv, g, w[2], HEADS, ca, True, pos),
                    library_attention_bwd(x, w16, ca, g, qkv=qkv, cs=cs),
                    k5_flops(B, S, ca) + 2 * rf, k5_bytes(B, S, 2) + tb),
            'K6r': (lambda: fa.fused_attention_bwd_wg(x, g, *w[:3], HEADS, ca, True, pos),
                    lambda: fa.fused_attention_bwd_wg(x, g, *w[:3], HEADS, ca),
                    lambda: fa.attention_bwd_wg_ref(x, g, *w[:3], HEADS, ca, True, pos),
                    library_attention_bwd(x, w16, ca, g, wgrads=True, cs=cs),
                    k6_flops(B, S, ca) + 2 * rf, k6_bytes(B, S, 2) + tb),
        }
        if name == 'temporal':   # inference: only K1r runs there
            calls = {'K1r': calls['K1r']}
        with torch.no_grad():
            for kernel, (run, off, plain, library, flops, nbytes) in calls.items():
                bound_ms, bound_by = bound(flops, nbytes)
                per_geom[kernel][name] = dict(
                    B=B, S=S, ca=ca, ms=cuda_ms(run, iters=10),
                    rope_off_ms=cuda_ms(off, iters=10), plain_ms=cuda_ms(plain, iters=10),
                    library_ms=cuda_ms(library, iters=10), bound_ms=bound_ms,
                    bound_by=bound_by, flops=flops, bytes=nbytes)
        del x, g, qkv, calls, pos, cs
    emit({'phase': 'rope_times', 'per_call': per_geom})
    return per_geom


# ---------------------------------------------------------------------------------------
# attn_core alone: the bf16 attention core of K1-K3 and K1r-K3r (tensor cores)
# ---------------------------------------------------------------------------------------

# (name, sequences, S, causal_attention, rope with frame times, probabilities) of the
# attention core's calls on the main paths.
CORE_SHAPES = (
    ('inference_temporal', *GEOMETRIES['temporal'], False, False),
    ('inference_spatial', *GEOMETRIES['spatial'], False, False),
    ('train_temporal', *TRAIN_GEOMETRIES['temporal'], False, False),
    ('train_spatial', *TRAIN_GEOMETRIES['spatial'], False, False),
    ('rope_inference_temporal', *GEOMETRIES['temporal'], True, False),
    ('rope_train_temporal', *TRAIN_GEOMETRIES['temporal'], True, False),
    ('probs_train_temporal', *TRAIN_GEOMETRIES['temporal'], False, True),
    ('probs_train_spatial', *TRAIN_GEOMETRIES['spatial'], False, True),
    ('rope_probs_train_temporal', *TRAIN_GEOMETRIES['temporal'], True, True),
)
# The core shapes each kernel of the kernels line runs at.
CORE_OF_KERNEL = {
    'K1': ('inference_temporal', 'inference_spatial', 'train_temporal', 'train_spatial'),
    'K2': ('train_temporal', 'train_spatial'),
    'K3': ('probs_train_temporal', 'probs_train_spatial'),
    'K1r': ('rope_inference_temporal', 'rope_train_temporal'),
    'K2r': ('rope_train_temporal',),
    'K3r': ('rope_probs_train_temporal',),
}


def core_split(qkv, cs):
    '''q, k, v (B, H, S, dh) views of qkv (B, S, 3D); q and k rotated by the rope tables cs
    (None: unchanged).'''
    B, S, _ = qkv.shape
    q, k, v = qkv.reshape(B, S, 3, HEADS, D // HEADS).permute(2, 0, 3, 1, 4)
    return (*rotate(q, k, cs), v)


def core_ref(qkv, ca, cs, probs):
    '''The attention core's plain version, from the bf16 qkv: f32 logits, -1e10 fill, f32
    softmax, p rounded to bf16, p v in f32 -> (attn (B, S, D) f32, p (B, H, S, S) or
    None).'''
    B, S, _ = qkv.shape
    q, k, v = core_split(qkv, cs)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (D // HEADS) ** -0.5
    if ca > 0:
        logits = logits.masked_fill(~fa._causal_keep(S, ca, qkv.device), -1e10)
    p = torch.softmax(logits, dim=-1).to(qkv.dtype)
    attn = torch.matmul(p.float(), v.float()).transpose(1, 2).reshape(B, S, D)
    return attn, (p if probs else None)


def library_core(qkv, ca, cs, probs):
    '''The same function by library calls (yardstick only): SDPA with the causal mask, or
    for the probabilities matmul + softmax + matmul.'''
    q, k, v = core_split(qkv, cs)
    if not probs:
        return F.scaled_dot_product_attention(q, k, v, is_causal=ca > 0)
    logits = torch.matmul(q, k.transpose(-1, -2)) * (D // HEADS) ** -0.5
    if ca > 0:
        logits = logits.masked_fill(~fa._causal_keep(q.shape[2], ca, q.device), -1e10)
    p = torch.softmax(logits, dim=-1, dtype=torch.float32).to(q.dtype)
    return torch.matmul(p, v), p


def core_bound(R, S, ca, rope, probs):
    '''(flops, bytes) of the attention core: 4 dh operations per kept pair and head (q.k
    and p.v), 6 per rotated pair of q and k with rope; qkv read once, attn (and the
    probabilities, the per-row tables) written / read once.'''
    flops = 4 * (D // HEADS) * HEADS * R * attended_pairs(S, ca)
    nbytes = 2 * (4 * R * S * D + (R * HEADS * S * S if probs else 0))
    if rope:
        flops, nbytes = flops + rope_flops(R, S), nbytes + table_bytes(R, S)
    return flops, nbytes


def phase_attn_core_times():
    '''The bf16 attention core launched alone through tcow_attn_core, as the wrapper launches
    it, on a qkv made by K2 at each shape of CORE_SHAPES: against its plain version in f32
    (attn and probabilities, rel L2 <= TOL_BF16), the same bits on a second run, and timed
    beside the plain version, the library yardstick and its bound. K1 (K3 at the
    probability shapes) through its wrapper must give the same bits twice too.'''
    lib = fa._lib()
    dh = D // HEADS
    per_shape = {}
    for i, (name, R, S, ca, rope, probs) in enumerate(CORE_SHAPES):
        x, w = attn_inputs(R, S, torch.bfloat16, SEED + 500 + i)
        pos = rope_positions(R, S, SEED + 520 + i) if rope else None
        cs = head_tables(S, pos) if rope else None
        with torch.no_grad():
            qkv = fa.fused_attention_fwd_qkv(x, *w, HEADS, ca, rope, pos)[1]
            kernel = fa.fused_attention_fwd_res if probs else fa.fused_attention_fwd
            runs = [kernel(x, *w, HEADS, ca, rope, pos) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in (zip(*runs) if probs else [runs])):
            fail(f'attn_core {name}: {"K3" if probs else "K1"} gave other bits on a second run')
        del x, runs
        cos, sin, stride = fa._kernel_tables(qkv, S, dh, rope, pos)
        attn = torch.empty((R, S, D), dtype=qkv.dtype, device=DEV)
        p = torch.empty((R, HEADS, S, S), dtype=qkv.dtype, device=DEV) if probs else None

        def launch():
            fa._check(lib.tcow_attn_core(1, qkv.data_ptr(), attn.data_ptr(), fa._ptr(p),
                                         fa._ptr(cos), fa._ptr(sin), stride, R, S, HEADS, dh,
                                         int(ca > 0), fa._mask_diag(ca), dh ** -0.5,
                                         fa._stream(qkv)), 'attn_core')

        launch()
        got = (attn.clone(), p.clone() if probs else None)
        launch()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], attn) and (not probs or torch.equal(got[1], p))):
            fail(f'attn_core {name}: other bits on a second run')
        want = core_ref(qkv, ca, cs, probs)
        e = dict(R=R, S=S, ca=ca, rope=rope, probs=probs, tol_rel_l2=TOL_BF16,
                 rel_l2_attn=rel_l2(attn.float(), want[0]),
                 max_abs_err=float((attn.float() - want[0]).abs().max()))
        if probs:
            e['rel_l2_probs'] = rel_l2(p.float(), want[1].float())
            e['max_abs_err'] = max(e['max_abs_err'], float((p.float() - want[1].float())
                                                            .abs().max()))
        del want, got
        bad = {k: v for k, v in e.items() if k.startswith('rel_l2') and not v <= TOL_BF16}
        if bad:
            fail(f'attn_core {name}: kernel vs plain rel L2 above {TOL_BF16}: {bad}')
        flops, nbytes = core_bound(R, S, ca, rope, probs)
        bound_ms, bound_by = bound(flops, nbytes)
        with torch.no_grad():
            e.update(ms=cuda_ms(launch), plain_ms=cuda_ms(lambda: core_ref(qkv, ca, cs, probs),
                                                          iters=5),
                     library_ms=cuda_ms(lambda: library_core(qkv, ca, cs, probs)),
                     bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
        per_shape[name] = e
        del qkv, attn, p, cos, sin, cs, pos
        torch.cuda.empty_cache()
    emit({'phase': 'attn_core_times', 'per_shape': per_shape, 'deterministic': True})
    return per_shape


# ---------------------------------------------------------------------------------------
# attn_bwd alone: the bf16 backward core of K4-K6 and K4r-K6r (tensor cores)
# ---------------------------------------------------------------------------------------

# (name, sequences, S, causal_attention, rope with frame times) of the backward core's calls
# on the training paths.
BWD_CORE_SHAPES = (
    ('train_temporal', *TRAIN_GEOMETRIES['temporal'], False),
    ('train_spatial', *TRAIN_GEOMETRIES['spatial'], False),
    ('rope_train_temporal', *TRAIN_GEOMETRIES['temporal'], True),
)
# The backward core shapes each kernel of the kernels line runs at.
BWD_CORE_OF_KERNEL = {k: ('train_temporal', 'train_spatial') for k in ('K4', 'K5', 'K6')}
BWD_CORE_OF_KERNEL.update({k: ('rope_train_temporal',) for k in ('K4r', 'K5r', 'K6r')})


def bwd_core_bound(R, S, ca, rope):
    '''(flops, bytes) of the backward core: 12 dh operations per kept pair and head (the
    logits, p v, dp, dv, dq, dk), 6 per rotated pair of q, k, dq and dk with rope; qkv and
    dattn read once, attn and dqkv written once (16 D bytes a row in bf16), the per-row
    tables read once.'''
    flops = 12 * D * R * attended_pairs(S, ca)
    nbytes = 2 * 8 * R * S * D
    if rope:
        flops, nbytes = flops + 2 * rope_flops(R, S), nbytes + table_bytes(R, S)
    return flops, nbytes


def phase_attn_bwd_times():
    '''The bf16 backward core launched alone through tcow_attn_bwd, as the wrapper launches
    it, on a qkv made by K2 and dattn = g . proj_w^T at each shape of BWD_CORE_SHAPES:
    attn, dq, dk and dv against the plain core in f32 from the same bf16 inputs (rel L2 <=
    TOL_K4_BF16), the same bits on a second run, and timed beside the plain core, the
    library yardstick and its bound.'''
    lib = fa._lib()
    dh = D // HEADS
    per_shape = {}
    for i, (name, R, S, ca, rope) in enumerate(BWD_CORE_SHAPES):
        x, w = attn_inputs(R, S, torch.bfloat16, SEED + 600 + i)
        g = grad_input(R, S, torch.bfloat16, SEED + 610 + i)
        pos = rope_positions(R, S, SEED + 620 + i) if rope else None
        cs = head_tables(S, pos) if rope else None
        with torch.no_grad():
            qkv = fa.fused_attention_fwd_qkv(x, *w, HEADS, ca, rope, pos)[1]
            dattn = torch.matmul(g, w[2].to(torch.bfloat16).T).contiguous()
        del x, g
        cos, sin, stride = fa._kernel_tables(qkv, S, dh, rope, pos)
        attn = torch.empty((R, S, D), dtype=qkv.dtype, device=DEV)
        dqkv = torch.empty((R, S, 3 * D), dtype=qkv.dtype, device=DEV)
        stats = torch.empty((3, R, HEADS, S), dtype=torch.float32, device=DEV)

        def launch():
            fa._check(lib.tcow_attn_bwd(1, qkv.data_ptr(), dattn.data_ptr(), attn.data_ptr(),
                                        dqkv.data_ptr(), stats.data_ptr(), fa._ptr(cos),
                                        fa._ptr(sin), stride, R, S, HEADS, dh, int(ca > 0),
                                        fa._mask_diag(ca), dh ** -0.5, fa._stream(qkv)),
                      'attn_bwd')

        def plain():
            return fa.attention_bwd_core_ref(qkv.float(), dattn.float(), HEADS, ca, rope, pos)

        launch()
        got = (attn.clone(), dqkv.clone())
        launch()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], attn) and torch.equal(got[1], dqkv)):
            fail(f'attn_bwd {name}: other bits on a second run')
        want_dqkv, want_attn = plain()
        parts = {'attn': (attn, want_attn)}
        parts.update({n: (dqkv[..., j * D:(j + 1) * D], want_dqkv[..., j * D:(j + 1) * D])
                      for j, n in enumerate(('dq', 'dk', 'dv'))})
        e = dict(R=R, S=S, ca=ca, rope=rope, tol_rel_l2=TOL_K4_BF16,
                 max_abs_err=max(float((a.float() - b).abs().max()) for a, b in parts.values()))
        e.update({f'rel_l2_{n}': rel_l2(a.float(), b) for n, (a, b) in parts.items()})
        del want_dqkv, want_attn, parts, got
        bad = {k: v for k, v in e.items() if k.startswith('rel_l2') and not v <= TOL_K4_BF16}
        if bad:
            fail(f'attn_bwd {name}: kernel vs plain rel L2 above {TOL_K4_BF16}: {bad}')
        flops, nbytes = bwd_core_bound(R, S, ca, rope)
        bound_ms, bound_by = bound(flops, nbytes)
        with torch.no_grad():
            e.update(ms=cuda_ms(launch), plain_ms=cuda_ms(plain, iters=5),
                     library_ms=cuda_ms(lambda: library_bwd_core(qkv, dattn, ca, cs)),
                     bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
        per_shape[name] = e
        del qkv, dattn, attn, dqkv, stats, cos, sin, cs, pos
        torch.cuda.empty_cache()
    emit({'phase': 'attn_bwd_times', 'per_shape': per_shape, 'deterministic': True})
    return per_shape


# ---------------------------------------------------------------------------------------
# The GEMMs alone: gemm_bias, wgrad and colsum of K1-K6 and K1r-K6r (gemm_sm90.cu)
# ---------------------------------------------------------------------------------------

# Rows of each geometry's GEMMs (sequences x length).
INFER_ROWS = {f'inference_{g}': R * S for g, (R, S, _) in GEOMETRIES.items()}
TRAIN_ROWS = {f'train_{g}': R * S for g, (R, S, _) in TRAIN_GEOMETRIES.items()}
# (name, N, K, W transposed, bias, the geometries that run it) of gemm_bias: qkv and proj
# of the forwards, the backward's dattn = g . proj_w^T and K6's dx = dqkv . qkv_w^T.
GEMM_SHAPES = (
    ('qkv', 3 * D, D, False, True, {**INFER_ROWS, **TRAIN_ROWS}),
    ('proj', D, D, False, True, {**INFER_ROWS, **TRAIN_ROWS}),
    ('dattn', D, D, True, False, TRAIN_ROWS),
    ('dx', D, 3 * D, True, False, TRAIN_ROWS),
)
# K6's weight gradients (name, K, N: f32 (K, N) = a^T . b) and bias gradients (name, N).
WGRAD_SHAPES = (('wgrad_x_dqkv', D, 3 * D), ('wgrad_attn_g', D, D))
COLSUM_SHAPES = (('colsum_dqkv', 3 * D), ('colsum_g', D))
# The launches of each kernel's chain (the qkv GEMM, then the rest), at the geometries
# of its main path.
GEMMS_OF_KERNEL = {
    'K1': ('qkv', 'proj'), 'K2': ('qkv', 'proj'), 'K3': ('qkv', 'proj'),
    'K4': ('qkv', 'dattn'), 'K5': ('dattn',),
    'K6': ('qkv', 'dattn', 'dx', 'wgrad_x_dqkv', 'colsum_dqkv', 'wgrad_attn_g', 'colsum_g'),
}
# wgrad vs the f32 product of the same bf16 operands: the products are exact in f32, only
# the order of the f32 sums over 54,000 rows differs.
TOL_WGRAD = 1e-3


@dataclasses.dataclass
class GemmCase:
    '''One bf16 launch of gemm_bias, wgrad or colsum on the main paths, on seeded inputs:
    args are (a, w f32, bias f32 or None, w_transposed), (a, b) or (a,).'''
    op: str
    geometry: str
    kind: str
    args: tuple
    flops: int
    nbytes: int
    limit: float

    def kernel(self):
        '''The port's launch, as the chains make it (gemm_bias with its weight cast).'''
        return {'gemm_bias': fa._gemm, 'wgrad': fa._wgrad, 'colsum': fa._colsum}[self.kind](
            *self.args)

    def plain(self):
        '''The plain version: gemm_bias_ref (rounded once), wgrad_ref, colsum_ref.'''
        if self.kind == 'gemm_bias':
            return fa.gemm_bias_ref(*self.args)
        if self.kind == 'wgrad':
            return fa.wgrad_ref(*self.args)
        return fa.colsum_ref(*self.args)

    def want(self):
        '''The f32 result from the same bf16 operands, not rounded.'''
        if self.kind != 'gemm_bias':
            return self.plain()
        a, w, bias, wt = self.args
        w16 = w.to(a.dtype).float()
        out = a.float() @ (w16.T if wt else w16)
        return out if bias is None else out + bias

    def library(self):
        '''One PyTorch call computing the same function (yardstick only).'''
        if self.kind == 'gemm_bias':
            a, w, bias, wt = self.args
            w16 = w.to(a.dtype)
            return lambda: (torch.addmm(bias.to(a.dtype), a, w16) if bias is not None
                            else torch.mm(a, w16.T if wt else w16))
        if self.kind == 'wgrad':
            a, b = self.args
            return lambda: torch.mm(a.T, b, out_dtype=torch.float32)
        return lambda: torch.sum(self.args[0], dim=0, dtype=torch.float32)


def gemm_cases():
    '''Every GemmCase of GEMM_SHAPES, WGRAD_SHAPES and COLSUM_SHAPES, one at a time.'''
    def rand(shape, seed, scale=1.0, dtype=torch.bfloat16):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)

    for i, (name, N, K, wt, has_bias, rows) in enumerate(GEMM_SHAPES):
        w = rand((N, K) if wt else (K, N), SEED + 700 + i, K ** -0.5, torch.float32)
        bias = rand((N,), SEED + 710 + i, 0.02, torch.float32) if has_bias else None
        for geom, M in rows.items():
            yield GemmCase(name, geom, 'gemm_bias', (rand((M, K), SEED + 720 + i), w, bias, wt),
                           2 * M * N * K, 2 * M * (K + N) + 4 * N * K + (4 * N if has_bias else 0),
                           TOL_BF16)
    for i, (name, K, N) in enumerate(WGRAD_SHAPES):
        for geom, M in TRAIN_ROWS.items():
            yield GemmCase(name, geom, 'wgrad', (rand((M, K), SEED + 730 + i),
                                                 rand((M, N), SEED + 740 + i)),
                           2 * M * N * K, 2 * M * (K + N) + 4 * K * N, TOL_WGRAD)
    for i, (name, N) in enumerate(COLSUM_SHAPES):
        for geom, M in TRAIN_ROWS.items():
            yield GemmCase(name, geom, 'colsum', (rand((M, N), SEED + 750 + i),),
                           M * N, 2 * M * N + 4 * N, TOL_F32)


def phase_gemm_times():
    '''Every bf16 gemm_bias, wgrad and colsum launch of the main paths alone, through the
    chains' own launch helpers: against the f32 result of the same bf16 operands (rel L2
    <= TOL_BF16 for gemm_bias, TOL_WGRAD for wgrad, TOL_F32 for colsum), the same bits on
    a second run, and timed beside the plain version, one library call and the bound,
    with the rate and share of the bound it reaches.'''
    per_shape = {}
    for case in gemm_cases():
        first, second = case.kernel(), case.kernel()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            fail(f'{case.op} {case.geometry}: other bits on a second run')
        want = case.want()
        e = dict(kind=case.kind, M=case.args[0].shape[0], tol_rel_l2=case.limit,
                 rel_l2=rel_l2(first.float(), want),
                 max_abs_err=float((first.float() - want).abs().max()))
        del first, second, want
        if not e['rel_l2'] <= case.limit:
            fail(f'{case.op} {case.geometry}: kernel vs plain rel L2 {e["rel_l2"]} above '
                 f'{case.limit}')
        bound_ms, bound_by = bound(case.flops, case.nbytes)
        with torch.no_grad():
            e.update(ms=cuda_ms(case.kernel), plain_ms=cuda_ms(case.plain, iters=5),
                     library_ms=cuda_ms(case.library()), bound_ms=bound_ms, bound_by=bound_by,
                     flops=case.flops, bytes=case.nbytes)
            if case.kind == 'gemm_bias':
                w, wt = case.args[1], case.args[3]
                e['weight_cast_ms'] = cuda_ms(lambda: fa.gemm_weight(w, wt))
        e['tflops'] = case.flops / e['ms'] / 1e9
        e['share_of_bound'] = bound_ms / e['ms']
        per_shape[f'{case.op}/{case.geometry}'] = e
        del case
        torch.cuda.empty_cache()
    emit({'phase': 'gemm_times', 'per_shape': per_shape, 'deterministic': True})
    return per_shape


# ---------------------------------------------------------------------------------------
# Reference .pth checkpoints: by file, by a .pth-only experiment directory, and as the
# bootstrap of a training run
# ---------------------------------------------------------------------------------------

PTH_EPOCH = 4
# The bootstrap run: one train step (2 scenes in one batch of TRAIN_B), no val phase, a
# name holding 'ba' so the driver saves model_-1.npz before training.
PTH_TRAIN_SCENES = 2
PTH_RUN = 'pth_ba'
# ViT-B/16 at 224x224 as timm lays it out: 14 x 14 patches, a 1000-way classifier head.
VIT_PATCHES = 196


def imagenet_vit_b16(seed):
    '''A seeded random ViT-B/16 state dict in timm's layout (0.02 x normal, LayerNorm
    gains near 1), the file an ImageNet bootstrap reads.'''
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(0.02 * rng.standard_normal(s, dtype=np.float32))
    sd = {'patch_embed.proj.weight': r(D, 3, 16, 16), 'patch_embed.proj.bias': r(D),
          'cls_token': r(1, 1, D), 'pos_embed': r(1, VIT_PATCHES + 1, D),
          'norm.weight': 1.0 + r(D), 'norm.bias': r(D),
          'head.weight': r(1000, D), 'head.bias': r(1000)}
    for i in range(12):
        for name, shape in (('norm1', (D,)), ('attn.qkv', (3 * D, D)), ('attn.proj', (D, D)),
                            ('norm2', (D,)), ('mlp.fc1', (4 * D, D)), ('mlp.fc2', (D, 4 * D))):
            sd[f'blocks.{i}.{name}.weight'] = r(*shape) + (1.0 if len(shape) == 1 else 0.0)
            sd[f'blocks.{i}.{name}.bias'] = r(shape[0])
    return sd


def trees_equal(a, b):
    '''Two nested dicts of arrays hold the same keys and the same bits.'''
    flat_a, flat_b = flatten_with_paths(a), flatten_with_paths(b)
    return flat_a.keys() == flat_b.keys() and all(np.array_equal(flat_a[k], flat_b[k])
                                                  for k in flat_a)


def phase_pth(workdir):
    '''A reference-layout TCOW checkpoint (.pth: net_seeker with
    tracker_backbone.timesformer.model.*, tracker_post_linear.*, flag_post_linear.*, and
    seeker_args, an argparse train_args, dset_args, epoch) of the configuration of record
    from seeded weights, loaded three ways: (1) by file through load_networks, the tree
    bit-equal to the one it was written from (so the engine gets the numpy tree's weights
    bit for bit), and one run_plugin request on it: 24 K1, finite masks and flags; (2) as
    a .pth-only experiment directory through `python eval_torch.py --resume` (the demo
    video's two usage modes, one plugin step of 24 K1, finite CSV rows); (3) a seeded
    random ViT-B/16 state dict as `python train_torch.py --tracker_pretrained` for one
    step (24 K1 + 24 K4, and its vis step): the weights saved before training are the
    inflated file applied over the init, bit for bit.'''
    shutil.rmtree(workdir, ignore_errors=True)
    out = {}
    cfg0 = seeker_config_from_args(SEEKER_ARGS)
    model = MaskTracker(cfg0)
    model.init_params_(torch.Generator().manual_seed(SEED + 7))
    tree = params_to_jax(model.state_dict())
    del model
    exp = workdir / 'checkpoints' / 'pthexp'
    exp.mkdir(parents=True)
    pth = exp / 'checkpoint.pth'
    args = record_train_args()
    t0 = time.perf_counter()
    torch.save({'epoch': PTH_EPOCH, 'net_seeker': torch_import.seeker_state_dict_to_torch(
                    tree, cfg0),
                'seeker_args': dict(SEEKER_ARGS),
                'train_args': argparse.Namespace(**config_lib.args_to_dict(args)),
                'dset_args': {'kubric': factory.kubric_dset_args(args)}}, pth)
    out['pth_write_s'], out['pth_bytes'] = time.perf_counter() - t0, pth.stat().st_size

    # (1) By file.
    t0 = time.perf_counter()
    params, cfg, _, _, _, epoch = load_networks(str(pth), None, compute_dtype=torch.bfloat16,
                                                device=DEV)
    out['load_s'] = time.perf_counter() - t0
    if epoch != PTH_EPOCH or not trees_equal(params, tree):
        fail(f'.pth by file: epoch {epoch} or a tree other than the one written')
    cfg = dataclasses.replace(cfg, attention_bwd='res', remat_policy='full')
    rgb, query, target = plugin_request(SEED + 7)

    counts = read_launches()
    res = InferenceEngine(params, cfg, device=DEV).run_plugin(rgb, query, target)
    torch.cuda.synchronize()
    launched = launches_since(counts)
    got = [np.concatenate([m[k] for m, _ in res]) for k in ('output_mask', 'output_flags')]
    if launched != {'K1': 2 * cfg.network_depth}:
        fail(f'.pth by file: run_plugin launched {launched}')
    out['by_file'] = dict(launches=launched, tree_bit_equal=True,
                          mask_shape=list(got[0].shape),
                          finite=bool(np.isfinite(got[0]).all() and np.isfinite(got[1]).all()))
    if got[0].shape != (BATCH, 3) + rgb.shape[2:] or not out['by_file']['finite']:
        fail(f'.pth by file: run_plugin outputs {out["by_file"]}')
    del params, res, got
    torch.cuda.empty_cache()

    # (2) A .pth-only experiment directory through eval_torch.py --resume.
    argv = ['--resume', 'pthexp', '--name', 'pe', '--data_path', EVAL_DEMO,
            '--checkpoint_root', str(workdir / 'checkpoints'),
            '--log_root', str(workdir / 'logs'), '--num_queries', '1', '--avoid_wandb', '2',
            '--plugin_batch', '4', '--num_workers', '4', '--device', DEV,
            '--seed', str(SEED), '--log_level', 'debug']
    text, wall_s = run_eval(argv, workdir / 'eval.log')
    faults = [f for f in EVAL_LOG_FAULTS if f in text]
    if faults or f'Loading weights from: {pth}' not in text:
        print(text[-4000:], file=sys.stderr)
        fail(f'eval_torch.py --resume of a .pth-only directory: faults {faults} or not '
             f'loaded from {pth}')
    steps = [json.loads(m.group(1)) for m in EVAL_STATS.finditer(text)]
    steps = [r for r in steps if r['phase'] != 'media_wait']
    if [(r['phase'], r['clips'], r['launches']) for r in steps] != [
            ('plugin', len(EVAL_PLUGIN_NAMES), EVAL_PER_STEP)]:
        fail(f'eval_torch.py on the .pth: device steps {steps}')
    with open(workdir / 'logs' / 'pthexp' / f'test_pe_e{PTH_EPOCH}' / 'itemized_results.csv',
              newline='') as f:
        rows = list(csv.DictReader(f))
    if tuple(r['friendly_short_name'] for r in rows) != EVAL_PLUGIN_NAMES or not all(
            np.isfinite(float(v)) for r in rows for k, v in r.items()
            if k.startswith(('mean_', 'count_'))):
        fail(f'eval_torch.py on the .pth: CSV rows {rows}')
    out['eval_dir'] = dict(wall_s=wall_s, rows=len(rows), step_wall_ms=steps[0]['wall_ms'],
                           launches=steps[0]['launches'])

    # (3) train_torch.py --tracker_pretrained <ViT-B/16 .pth>, one step.
    root, out['dataset_write_s'], _ = dataset('pth')
    vit = imagenet_vit_b16(SEED + 8)
    vit_fp = workdir / 'vit_b16.pth'
    torch.save({'model': vit}, vit_fp)
    argv = driver_argv(root, workdir, PTH_RUN, '--tracker_pretrained', str(vit_fp),
                       '--num_epochs', '1', '--do_val_aug', '0', '--do_val_noaug', '0')
    text, wall_s = run_driver(argv, workdir / 'pth_train.log')
    if 'Bootstrapping backbone from pretrained weights' not in text:
        fail('train_torch.py --tracker_pretrained: no bootstrap in the log')
    steps = check_steps(PTH_RUN, text, driver_records(1, steps=1, val=False), DRIVER_PER_STEP)
    ba = load_checkpoint(str(workdir / 'checkpoints' / PTH_RUN / 'model_-1.npz'))['params']
    bb_cfg = cfg0.backbone_config()
    inflated = torch_import.inflate_imagenet_vit_state_dict(
        vit, in_chans=cfg0.input_channels, num_patches=bb_cfg.num_patches,
        num_frames=bb_cfg.num_frames)
    applied = torch_import.apply_pretrained_to_params(ba['backbone'], inflated, bb_cfg)
    if not trees_equal(applied, ba['backbone']):
        fail('train_torch.py --tracker_pretrained: the weights before training are not the '
             'inflated ViT-B/16 over the init')
    final = load_checkpoint(str(workdir / 'checkpoints' / PTH_RUN / 'checkpoint.npz'))
    out['bootstrap'] = dict(wall_s=wall_s, steps=[{k: r.get(k) for k in (
        'phase', 'step', 'wall_ms', 'launches', 'max_memory_allocated')} for r in steps],
        epoch=final['epoch'], vit_bytes=vit_fp.stat().st_size, pretrained_bit_equal=True)
    launches = sum_launches(steps + [{'launches': launched}, out['eval_dir']])
    emit({'phase': 'pth', 'launches': launches, **out})
    return {'launches': launches}


# ---------------------------------------------------------------------------------------
# Joint space-time attention: K1-K6 at S = 1 + N T = 9001
# ---------------------------------------------------------------------------------------

# --attention_type joint_space_time: one attention per block over the cls token and every
# patch of every frame (1 + 300 x 30 tokens), never causal; no temporal weights.
JOINT_ARGS = dict(SEEKER_ARGS, attention_type='joint_space_time')
JOINT_S = 1 + 300 * SEEKER_ARGS['num_total_frames']
# Kernel geometries (rows, S, causal) of the joint path: inference (B clips) and training.
JOINT_GEOMETRIES = {'joint_inference': (BATCH, JOINT_S, 0),
                    'joint_train': (TRAIN_B * TRAIN_Q, JOINT_S, 0)}
# (B clips, Q queries) of each joint training step. 'res' keeps K3's (rows, 12, S, S) bf16
# probabilities and its torch-op backward makes f32 copies of them, ~18.6 GB a row on an
# H100 80GB: 2 x 3 does not fit, 2 x 2 (4 rows, ~76 GB) is the largest batch that does.
JOINT_TRAIN_BATCH = {('res', 'dots_nb'): (2, 2)}
# The rows K3 runs at on the joint path.
JOINT_RES_ROWS = math.prod(JOINT_TRAIN_BATCH[('res', 'dots_nb')])
# The plain versions in f32 hold (rows, 12, S, S) f32 logits and probabilities, 3.9 GB
# each a row (K4's several such): they run one row at a time, and are timed (with K3's
# library call) at this many rows.
JOINT_CHECK_ROWS = 1
# Gradient parity of the kernel_x step: the f32 plain step holds several (rows, 12, S, S)
# f32 tensors in each block's backward (~16 GB a row), so 1 clip of the 3 queries.
JOINT_PARITY_BATCH = (1, 3)
JOINT_ITERS = 5
# Elements a piece when a kernel's output is compared with its plain version in float64.
ERR_CHUNK = 1 << 27


def joint_kernel_errs():
    '''K1-K6 at the joint path's shapes (bf16, S = 9001, not causal): K1 at the inference
    batch (2 rows); K1, K2 and K4-K6 at the training rows (6); K3 at the `res` pairing's
    rows (4). Each is held against its plain version in f32 from the same bf16 inputs, run
    on one row at a time (the rows are independent, and one row's plain call already holds
    (1, 12, S, S) f32 tensors): every row's out, qkv, probabilities, attn, dqkv and dx
    against that row's plain result, and the weight and bias gradients (K6, and the
    differentiable calls of K4 (kernel_x) and K5 (kernel_qkv)) against the sum of the rows'
    plain gradients. Rel L2 and max abs error are over the whole tensor, summed piece by
    piece. Returns {kernel: {case: errors}}.'''
    errs = {k: {} for k in ('K1', 'K2', 'K3', 'K4', 'K5', 'K6')}
    grad_names = ('dx', 'dqkv_w', 'dqkv_b', 'dproj_w', 'dproj_b')

    def check(kernel, case, got, plain_row, names, summed=()):
        '''got: the kernel's outputs over B rows; plain_row(r): the plain outputs of row r
        alone (a batch of 1), whose first len(names) outputs are compared. The outputs
        named in `summed` reduce over rows.'''
        if len(got) != len(names):
            fail(f'{case}: {kernel} returned {len(got)} outputs, expected {names}')
        tol = TOL_BF16 if kernel in ('K1', 'K2', 'K3') else TOL_K4_BF16
        B = got[0].shape[0]
        acc = {n: [0.0, 0.0, 0.0] for n in names}          # sum diff^2, sum want^2, max |diff|
        sums = {n: None for n in summed}

        def add(n, a, b):
            if a.shape != b.shape:
                fail(f'{case}: {kernel} {n} shape {tuple(a.shape)}, plain {tuple(b.shape)}')
            for pa, pb in zip(a.reshape(-1).split(ERR_CHUNK), b.reshape(-1).split(ERR_CHUNK)):
                d = pa.double() - pb.double()
                acc[n][0] += float(d.square().sum())
                acc[n][1] += float(pb.double().square().sum())
                acc[n][2] = max(acc[n][2], float(d.abs().max()))

        for r in range(B):
            want = plain_row(r)
            for n, a, b in zip(names, got, want):
                if n in sums:
                    sums[n] = b.double() if sums[n] is None else sums[n] + b.double()
                else:
                    add(n, a[r], b[0])
            del want
            torch.cuda.empty_cache()
        for n, total in sums.items():
            add(n, got[names.index(n)], total)
        e = dict(B=B, S=JOINT_S, ca=0, dtype='bfloat16', tol_rel_l2=tol, rows_checked=B,
                 summed_over_rows=list(summed),
                 max_abs_err=max(v[2] for v in acc.values()))
        e.update({f'rel_l2_{n}': math.sqrt(v[0] / v[1]) for n, v in acc.items()})
        errs[kernel][case] = e
        bad = {k: v for k, v in e.items() if k.startswith('rel_l2') and not v <= tol}
        if bad:
            fail(f'{case}: {kernel} vs plain rel L2 above {tol}: {bad}')
        torch.cuda.empty_cache()

    x, w = attn_inputs(BATCH, JOINT_S, torch.bfloat16, SEED + 500)
    row = lambda t, r: t[r:r + 1].float()
    check('K1', 'joint_inference', (fa.fused_attention_fwd(x, *w, HEADS, 0),),
          lambda r: (fa.attention_ref(row(x, r), *w, HEADS, 0),), ('out',))

    B = TRAIN_B * TRAIN_Q
    x, w = attn_inputs(B, JOINT_S, torch.bfloat16, SEED + 501)
    g = grad_input(B, JOINT_S, torch.bfloat16, SEED + 502)
    res_row = lambda r: fa.attention_res_ref(row(x, r), *w, HEADS, 0)
    check('K1', 'joint_train', (fa.fused_attention_fwd(x, *w, HEADS, 0),), res_row, ('out',))
    k2 = fa.fused_attention_fwd_qkv(x, *w, HEADS, 0)
    check('K2', 'joint_train', k2, res_row, ('out', 'qkv'))
    check('K3', 'joint_train_res', fa.fused_attention_fwd_res(x[:JOINT_RES_ROWS], *w, HEADS, 0),
          res_row, ('out', 'qkv', 'probs', 'attn'))
    check('K4', 'joint_train', fa.fused_attention_bwd(x, g, *w[:3], HEADS, 0),
          lambda r: fa.attention_bwd_ref(row(x, r), row(g, r), *w[:3], HEADS, 0),
          ('dqkv', 'attn'))
    qkv = k2[1]
    del k2
    check('K5', 'joint_train', fa.fused_attention_bwd_qkv(qkv, g, w[2], HEADS, 0),
          lambda r: fa.attention_bwd_qkv_ref(row(qkv, r), row(g, r), w[2], HEADS, 0),
          ('dqkv', 'attn'))
    check('K6', 'joint_train', fa.fused_attention_bwd_wg(x, g, *w[:3], HEADS, 0),
          lambda r: fa.attention_bwd_wg_ref(row(x, r), row(g, r), *w[:3], HEADS, 0),
          grad_names, grad_names[1:])

    def autograd_row(r):
        '''Every gradient of attention_ref in f32 on row r alone.'''
        leaves = [row(x, r).requires_grad_()] + [a.clone().requires_grad_() for a in w]
        fa.attention_ref(*leaves, HEADS, 0).backward(row(g, r))
        return [t.grad for t in leaves]

    # The differentiable calls of K4 (kernel_x) and K5 (kernel_qkv): every gradient.
    for kernel, mode in (('K4', 'kernel_x'), ('K5', 'kernel_qkv')):
        leaves = [x.clone().requires_grad_()] + [a.clone().requires_grad_() for a in w]
        fa.fused_attention(*leaves, HEADS, 0, mode).backward(g)
        check(kernel, 'joint_train_grads', [t.grad for t in leaves], autograd_row, grad_names,
              grad_names[1:])
        del leaves
    return errs


def joint_kernel_times():
    '''Every kernel per call at the joint path's rows (K1 at both geometries, K2 and
    K4-K6 at training's, K3 at the `res` pairing's), beside its bound and one library call
    there, and the plain version (and the kernel again) at JOINT_CHECK_ROWS; K3's library
    call (matmul + softmax + matmul) at JOINT_CHECK_ROWS too, as its S x S probabilities
    are the plain version's.'''
    per_geom = {k: {} for k in KERNEL_COST}
    timed = lambda fn: cuda_ms(fn, iters=JOINT_ITERS, warmup=1)
    b = JOINT_CHECK_ROWS
    for i, (name, (B0, S, ca)) in enumerate(JOINT_GEOMETRIES.items()):
        x, w = attn_inputs(B0, S, torch.bfloat16, SEED + 510 + i)
        g = grad_input(B0, S, torch.bfloat16, SEED + 520 + i)
        w16 = [a.to(torch.bfloat16) for a in w]
        with torch.no_grad():
            qkv = fa.fused_attention_fwd_qkv(x, *w, HEADS, ca)[1]
        full = attention_calls(x, g, qkv, w, w16, ca)
        res = attention_calls(*(t[:JOINT_RES_ROWS] for t in (x, g, qkv)), w, w16, ca)
        rows = attention_calls(*(t[:b].contiguous() for t in (x, g, qkv)), w, w16, ca)
        with torch.no_grad():
            for kernel in (('K1',) if name == 'joint_inference' else KERNEL_COST):
                B, calls = (JOINT_RES_ROWS, res) if kernel == 'K3' else (B0, full)
                flops_fn, bytes_fn = KERNEL_COST[kernel]
                flops, nbytes = flops_fn(B, S, ca), bytes_fn(B, S, 2)
                bound_ms, bound_by = bound(flops, nbytes)
                e = dict(B=B, S=S, ca=ca, ms=timed(calls[kernel][0]), bound_ms=bound_ms,
                         bound_by=bound_by, flops=flops, bytes=nbytes, plain_rows=b,
                         ms_at_plain_rows=timed(rows[kernel][0]),
                         plain_ms=timed(rows[kernel][1]))
                torch.cuda.empty_cache()
                library_rows = b if kernel == 'K3' else B
                e.update(library_rows=library_rows, library_ms=timed(
                    (rows if kernel == 'K3' else calls)[kernel][2]))
                e['share_of_bound'] = bound_ms / e['ms']
                per_geom[kernel][name] = e
                torch.cuda.empty_cache()
        del x, g, qkv, full, res, rows
        torch.cuda.empty_cache()
    return {k: v for k, v in per_geom.items() if v}


def phase_joint_kernels():
    '''K1-K6 alone at S = 9001, D = 768, 12 heads, not causal, bf16: each against its
    plain version (joint_kernel_errs), then timed (joint_kernel_times).'''
    t0 = time.perf_counter()
    errs = joint_kernel_errs()
    per_geom = joint_kernel_times()
    emit({'phase': 'joint_kernels', 'cases': errs, 'per_call': per_geom,
          'wall_s': time.perf_counter() - t0})
    return errs, per_geom


def joint_batch(B, Q):
    T, H, W = (SEEKER_ARGS[k] for k in ('num_total_frames', 'frame_height', 'frame_width'))
    b = synthetic_device_batch(0, B=B, Q=Q, T=T, H=H, W=W, M=TRAIN_M, K=TRAIN_K)
    return {k: torch.as_tensor(v, device=DEV) for k, v in b.items()}


def joint_inference():
    '''The joint seeker of the configuration of record (seeded) through
    InferenceEngine.run_plugin, B = 2 clips in bf16: 12 K1 a request at 2 x 9001 and no
    other kernel; masks and flags within TOL_SEEKER_BF16 of the same engine with the plain
    attention (bf16); request times and peak memory.'''
    cfg = seeker_config_from_args(JOINT_ARGS, compute_dtype=torch.bfloat16)
    model = MaskTracker(cfg)
    model.init_params_(torch.Generator().manual_seed(SEED + 9))
    params = params_to_jax(model.state_dict())
    del model
    engine = InferenceEngine(params, cfg, device=DEV)
    rgb, query, target = plugin_request(SEED + 9)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts = read_launches()
    req_ms, results = [], None
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run_plugin(rgb, query, target)
        torch.cuda.synchronize()
        req_ms.append(1e3 * (time.perf_counter() - t0))
    launches = launches_since(counts)
    peak = torch.cuda.max_memory_allocated()
    if launches != {'K1': 2 * cfg.network_depth}:
        fail(f'joint inference: 2 requests launched {launches}, expected '
             f'{2 * cfg.network_depth} K1')
    mask = np.concatenate([m['output_mask'] for m, _ in results])
    flags = np.concatenate([m['output_flags'] for m, _ in results])
    if mask.shape != (BATCH, 3) + rgb.shape[2:] or not (np.isfinite(mask).all()
                                                        and np.isfinite(flags).all()):
        fail(f'joint inference: outputs {mask.shape}, finite {np.isfinite(mask).all()}')
    with plain_attention():
        plain = engine.run_plugin(rgb, query, target)
    t = lambda a: torch.from_numpy(a)
    errs = {'mask_kernel_vs_plain_bf16': rel_l2(t(mask), t(np.concatenate(
                [m['output_mask'] for m, _ in plain]))),
            'flags_kernel_vs_plain_bf16': rel_l2(t(flags), t(np.concatenate(
                [m['output_flags'] for m, _ in plain])))}
    for key, v in errs.items():
        if not v <= TOL_SEEKER_BF16:
            fail(f'joint inference {key}: rel L2 {v} > {TOL_SEEKER_BF16}')
    del engine, plain, results
    torch.cuda.empty_cache()
    return dict(clips=BATCH, launches_per_request=launches.get('K1', 0) // 2, request_ms=req_ms,
                clips_per_s=BATCH / (req_ms[-1] / 1e3), max_memory_allocated_bytes=peak,
                rel_l2=errs, tol_rel_l2=TOL_SEEKER_BF16), launches.get('K1', 0)


def joint_train(pairing):
    '''One warm-up and one timed training step of the joint seeker under the pairing
    (bf16, remat, drop-path 0.1, AdamW, clip 0.3) at JOINT_TRAIN_BATCH's batch (B = 2 x
    Q = 3 by default): a finite loss, changed parameters, per step the pairing's kernels
    once per block (12 K1 + 12 K4 for kernel_x); step ms and peak memory.'''
    B, Q = JOINT_TRAIN_BATCH.get(pairing, (TRAIN_B, TRAIN_Q))
    cfg = train_config(torch.bfloat16, pairing=pairing, joint=True, queries=Q)
    tx = optim.make_optimizer('adamw', learn_rate=1e-4, num_epochs=70, steps_per_epoch=1000,
                              gradient_clip=0.3)
    state = step_lib.init_train_state(SEED, cfg, tx, device=DEV)
    train_step = step_lib.make_train_step(cfg)
    batch = joint_batch(B, Q)
    depth = cfg.seeker.network_depth
    per_step = {k: 0 for k in read_launches()}
    per_step.update({k: n * depth for k, n in PAIRINGS[pairing].items()})
    watch = 'backbone.blocks.0.attn.qkv.w'
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(2):
        before = state.model.state_dict()[watch].clone()
        counts = read_launches()
        state, aux, ms, host_ms = timed_step(train_step, state, batch)
        rec = dict(step=i, step_ms=ms, host_ms=host_ms, loss=float(aux['total_seeker']),
                   skipped_nonfinite=float(aux['skipped_nonfinite']),
                   launches={k: n - counts[k] for k, n in read_launches().items()})
        steps.append(rec)
        if not np.isfinite(rec['loss']) or rec['skipped_nonfinite'] != 0.0:
            fail(f'joint {pairing} step {i}: loss {rec["loss"]}, skipped '
                 f'{rec["skipped_nonfinite"]}')
        if rec['launches'] != per_step:
            fail(f'joint {pairing} step {i}: launches {rec["launches"]}, expected {per_step}')
        if torch.equal(state.model.state_dict()[watch], before):
            fail(f'joint {pairing} step {i}: parameters did not change')
    peak = torch.cuda.max_memory_allocated()
    flops = 3 * joint_forward_flops(B * Q)
    out = dict(attention_bwd=pairing[0], remat_policy=pairing[1], clips=B, queries=Q,
               rows=B * Q, steps=steps, step_ms=steps[-1]['step_ms'],
               clips_per_s=B / (steps[-1]['step_ms'] / 1e3), max_memory_allocated_bytes=peak,
               launches_per_step={k: n for k, n in per_step.items() if n},
               step_matmul_flops=flops, step_bound_ms=1e3 * flops / PEAK_BF16_FLOPS)
    del state, train_step, batch
    torch.cuda.empty_cache()
    return out


def joint_forward_flops(rows):
    '''Matmul operations of one joint seeker forward over `rows` clips.'''
    T, p = JOINT_ARGS['num_total_frames'], JOINT_ARGS['patch_size']
    N = (JOINT_ARGS['frame_height'] // p) * (JOINT_ARGS['frame_width'] // p)
    block = k1_flops(rows, JOINT_S, 0) + 2 * 2 * rows * JOINT_S * D * 4 * D
    heads = 2 * rows * T * N * D * (3 * p * p + 3)
    return 2 * rows * T * N * p * p * 4 * D + 12 * block + heads


def joint_parity():
    '''The kernel_x step's first-step gradient with drop-path off at JOINT_PARITY_BATCH:
    the bf16 kernel path and the bf16 plain path against the f32 plain path; the kernel
    path's error may be at most TRAIN_BF16_ERR_RATIO x the plain path's.'''
    B, Q = JOINT_PARITY_BATCH
    batch = joint_batch(B, Q)
    rel = lambda a, b: abs(a - b) / abs(b)
    plain = (STEP_OF_RECORD[0], 'full')
    cfg16, cfg32 = (train_config(dt, 0.0, pairing=plain, joint=True, queries=Q)
                    for dt in (torch.bfloat16, torch.float32))
    model = MaskTracker(cfg32.seeker, device=DEV)
    model.init_params_(torch.Generator().manual_seed(SEED + 11))
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss_r, grad_r = loss_and_flat_grad(model, cfg32, batch, plain=True)
    peak_f32_plain = torch.cuda.max_memory_allocated()
    del model
    model = model_from(cfg16, init_state)
    loss_p, grad_p = loss_and_flat_grad(model, cfg16, batch, plain=True)
    del model
    cfg = train_config(torch.bfloat16, 0.0, pairing=STEP_OF_RECORD, joint=True, queries=Q)
    model = model_from(cfg, init_state)
    counts = read_launches()
    loss_k, grad_k = loss_and_flat_grad(model, cfg, batch, plain=False)
    launched = launches_since(counts)
    del model
    errs = {'loss_plain_bf16': rel(loss_p, loss_r), 'grad_plain_bf16': rel_l2(grad_p, grad_r),
            'loss_kernel_bf16': rel(loss_k, loss_r), 'grad_kernel_bf16': rel_l2(grad_k, grad_r)}
    del grad_r, grad_p, grad_k
    torch.cuda.empty_cache()
    ratio = errs['grad_kernel_bf16'] / errs['grad_plain_bf16']
    if launched != {'K1': 12, 'K4': 12}:
        fail(f'joint parity: the kernel_x loss and backward launched {launched}')
    if not ratio <= TRAIN_BF16_ERR_RATIO:
        fail(f'joint parity (kernel_x): bf16 gradient error of the kernel path '
             f'{errs["grad_kernel_bf16"]} > {TRAIN_BF16_ERR_RATIO} x the plain path\'s '
             f'{errs["grad_plain_bf16"]}')
    return dict(clips=B, queries=Q, rows=B * Q, losses={'plain_f32': loss_r,
                'plain_bf16': loss_p, 'kernel_bf16': loss_k}, rel_err=errs,
                grad_err_ratio=ratio, grad_err_ratio_limit=TRAIN_BF16_ERR_RATIO,
                max_memory_allocated_f32_plain_bytes=peak_f32_plain), launched


def phase_joint():
    '''Joint space-time attention through the main paths at the configuration of record:
    inference through run_plugin (joint_inference), one timed step of every pairing
    (joint_train), and the kernel_x gradient parity (joint_parity); each part's wall
    seconds. Returns each kernel's launches by path.'''
    out = {}
    t0 = time.perf_counter()
    out['inference'], inference_launches = joint_inference()
    out['inference_wall_s'] = time.perf_counter() - t0
    launches = {'K1': {'joint_inference': inference_launches}}
    out['train'] = []
    for pairing in PAIRINGS:
        t0 = time.perf_counter()
        rec = joint_train(pairing)
        rec['wall_s'] = time.perf_counter() - t0
        out['train'].append(rec)
        for k, n in rec['launches_per_step'].items():
            launches.setdefault(k, {})[f'joint_train_{pairing[0]}'] = 2 * n
    t0 = time.perf_counter()
    out['parity'], parity_launches = joint_parity()
    out['parity_wall_s'] = time.perf_counter() - t0
    for k, n in parity_launches.items():
        launches.setdefault(k, {})['joint_parity'] = n
    emit({'phase': 'joint', **out})
    return launches


# ---------------------------------------------------------------------------------------
# The ViT-L stretch configuration: K1 and K4 at D = 1024, 16 heads
# ---------------------------------------------------------------------------------------

# BASELINE.json config 5 of the JAX package: ViT-L divided space-time (network_depth 24,
# D = 1024, 16 heads of 64, 431M parameters), T = 60 at 480x640 (30 x 40 patches, 72,000
# tokens a clip), causal 1, bf16 over f32 weights; one clip a request.
VITL_DEPTH = 24
VITL_ARGS = dict(SEEKER_ARGS, network_depth=VITL_DEPTH, num_total_frames=60,
                 frame_height=480, frame_width=640)
VITL_BATCH = 1
# tools/torch_vitl_probe.py's rungs (depth, B, Q, T, H, W, grad_accum, remat policy), each
# of which must fit in 80 GB: the flagship clip, the reference's 3 queries, and the full
# stretch under 'full' remat.
VITL_LADDER = ((VITL_DEPTH, 1, 1, 30, 240, 320, 1, 'dots_nb_out'),
               (VITL_DEPTH, 1, 3, 30, 240, 320, 1, 'dots_nb_out'),
               (VITL_DEPTH, 1, 1, 60, 480, 640, 1, 'full'))
# Launches per attention call (two a block) of a kernel_x training step, by remat policy:
# 'full' keeps no attention output, so each block's forward runs again in the backward.
VITL_PER_CALL = {'dots_nb_out': {'K1': 1, 'K4': 1}, 'full': {'K1': 2, 'K4': 1}}
VITL_STEPS = 3           # timed probe steps, after a first and a warm-up step
VITL_PROBE_TIMEOUT_S = 600
# Elements of one f32 (rows, heads, S, S) tensor of a plain version run on a chunk of
# rows: the oracle at 60 x 16 x 1201^2 would be 5.5 GB a tensor at once.
VITL_PLAIN_ELEMS = 1 << 28


def vitl_width():
    '''(D, heads) of the ViT-L preset.'''
    return tsf.DEPTH_PRESETS[VITL_DEPTH]


def vitl_geometries():
    '''{name: (rows, S, causal)} of K1 and K4 at ViT-L: temporal (B Q N sequences of T,
    causal) and spatial (B Q T sequences of N + 1) of the stretch request and of every
    rung of VITL_LADDER (the full stretch rung's shapes are the request's).'''
    out = {}
    for _, B, Q, T, H, W, *_ in ((VITL_DEPTH, VITL_BATCH, 1) + tuple(
            VITL_ARGS[k] for k in ('num_total_frames', 'frame_height', 'frame_width')),
            *VITL_LADDER):
        N = (H // 16) * (W // 16)
        out[f'temporal_{B * Q * N}x{T}'] = (B * Q * N, T, 1)
        out[f'spatial_{B * Q * T}x{N + 1}'] = (B * Q * T, N + 1, 0)
    return out


def plain_by_rows(fn, tensors, S, heads):
    '''fn on chunks of rows of the (rows, S, ...) tensors in f32, each chunk's (rows, heads,
    S, S) f32 tensors at most VITL_PLAIN_ELEMS elements; fn's outputs concatenated.'''
    n = max(1, VITL_PLAIN_ELEMS // (heads * S * S))
    outs = [fn(*(t[r:r + n].float() for t in tensors))
            for r in range(0, tensors[0].shape[0], n)]
    return [torch.cat(parts) for parts in zip(*outs)]


def vitl_kernel_calls(B, S, ca, dtype, seed):
    '''K1's and K4's (kernel, plain version, library chain) thunks on seeded inputs at
    ViT-L width, and the plain versions in f32 by chunks of rows with their output names.'''
    width = vitl_width()
    h = width[1]
    x, w = attn_inputs(B, S, dtype, seed, width)
    g = grad_input(B, S, dtype, seed + 1, width)
    w16 = [a.to(torch.bfloat16) for a in w]
    calls = {'K1': (lambda: (fa.fused_attention_fwd(x, *w, h, ca),),
                    lambda: fa.attention_ref(x, *w, h, ca),
                    lambda: library_attention(x, w16, ca, heads=h)),
             'K4': (lambda: fa.fused_attention_bwd(x, g, *w[:3], h, ca),
                    lambda: fa.attention_bwd_ref(x, g, *w[:3], h, ca),
                    library_attention_bwd(x, w16, ca, g, heads=h))}
    oracles = {'K1': (lambda: plain_by_rows(lambda x_: (fa.attention_ref(x_, *w, h, ca),),
                                            (x,), S, h), ('out',)),
               'K4': (lambda: plain_by_rows(lambda x_, g_: fa.attention_bwd_ref(
                   x_, g_, *w[:3], h, ca), (x, g), S, h), ('dqkv', 'attn'))}
    return calls, oracles


def phase_vitl_kernels():
    '''K1 and K4 alone at every ViT-L shape (D = 1024, 16 heads; bf16) and two float32
    cases: against the plain version in f32 from the same inputs, run by chunks of rows;
    each kernel run twice must give the same bits; then, in bf16, timed beside the bound,
    the plain version and the library chain (addmm + SDPA + addmm; for K4 addmm, mm,
    SDPA forward and autograd backward).'''
    t0 = time.perf_counter()
    width = vitl_width()
    cases = [(name, B, S, ca, torch.bfloat16) for name, (B, S, ca) in vitl_geometries().items()]
    cases += [('f32_temporal_1200x60', 1200, 60, 1, torch.float32),
              ('f32_spatial_8x1201', 8, 1201, 0, torch.float32)]
    errs, per_geom = {'K1': {}, 'K4': {}}, {'K1': {}, 'K4': {}}
    for i, (name, B, S, ca, dtype) in enumerate(cases):
        calls, oracles = vitl_kernel_calls(B, S, ca, dtype, SEED + 600 + 2 * i)
        for kernel, (run, plain, library) in calls.items():
            with torch.no_grad():
                got, again = run(), run()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f'vitl {name}: {kernel} gave other bits on a second run')
            del again
            oracle, names = oracles[kernel]
            want = oracle()
            tol = (TOL_F32 if dtype == torch.float32
                   else TOL_BF16 if kernel == 'K1' else TOL_K4_BF16)
            e = dict(B=B, S=S, ca=ca, dtype=str(dtype)[6:], tol_rel_l2=tol, bits_equal_rerun=True,
                     max_abs_err=max(float((a.float() - b).abs().max())
                                     for a, b in zip(got, want)))
            e.update({f'rel_l2_{n}': rel_l2(a.float(), b) for n, a, b in zip(names, got, want)})
            errs[kernel][name] = e
            bad = {k: v for k, v in e.items() if k.startswith('rel_l2') and not v <= tol}
            if bad:
                fail(f'vitl {name}: {kernel} vs plain rel L2 above {tol}: {bad}')
            del got, want
            torch.cuda.empty_cache()
            if dtype != torch.bfloat16:
                continue
            flops_fn, bytes_fn = KERNEL_COST[kernel]
            flops, nbytes = flops_fn(B, S, ca, width), bytes_fn(B, S, 2, width)
            bound_ms, bound_by = bound(flops, nbytes)
            with torch.no_grad():
                t = dict(B=B, S=S, ca=ca, ms=cuda_ms(run, iters=10), bound_ms=bound_ms,
                         bound_by=bound_by, flops=flops, bytes=nbytes,
                         plain_ms=cuda_ms(plain, iters=3, warmup=1),
                         library_ms=cuda_ms(library, iters=10))
            t['share_of_bound'] = bound_ms / t['ms']
            per_geom[kernel][name] = t
            torch.cuda.empty_cache()
        del calls, oracles
        torch.cuda.empty_cache()
    emit({'phase': 'vitl_kernels', 'width': width, 'cases': errs, 'per_call': per_geom,
          'wall_s': time.perf_counter() - t0})
    return errs, per_geom


def vitl_request(seed):
    '''One clip at the stretch geometry (T = 60 at 480x640): rgb, a query box on frame 0
    and targets with unannotated frames, as plugin_request draws them.'''
    rng = np.random.RandomState(seed)
    T, H, W = (VITL_ARGS[k] for k in ('num_total_frames', 'frame_height', 'frame_width'))
    rgb = rng.rand(VITL_BATCH, 3, T, H, W).astype(np.float32)
    query = np.zeros((VITL_BATCH, 1, T, H, W), np.float32)
    query[:, :, 0, H // 3:2 * H // 3, W // 3:2 * W // 3] = 1.0
    target = np.zeros((VITL_BATCH, 3, T, H, W), np.float32)
    target[:, 0, :, H // 3:2 * H // 3, W // 3:2 * W // 3] = 1.0
    target[:, 1, ::3, H // 2:2 * H // 3, W // 2:2 * W // 3] = 1.0
    target[:, :, -T // 6:] = -1.0
    return rgb, query, target


def vitl_inference(ckpt_dir):
    '''The stretch request: a seeded ViT-L checkpoint written by the port, loaded through
    load_networks in bf16, and InferenceEngine.run_plugin on one clip twice: 48 K1 a
    request (24 temporal at 1200 x 60, causal, and 24 spatial at 60 x 1201) and no other
    kernel, finite masks within TOL_SEEKER_BF16 of the same engine with the plain
    attention; request ms and peak memory.'''
    t0 = time.perf_counter()
    model = MaskTracker(seeker_config_from_args(VITL_ARGS))
    model.init_params_(torch.Generator().manual_seed(SEED + 13))
    n_params = sum(p.numel() for p in model.parameters())
    save_checkpoint(str(ckpt_dir), 0, 'vitl', params_to_jax(model.state_dict()),
                    seeker_args=VITL_ARGS)
    del model
    params, cfg, *_ = load_networks(str(ckpt_dir), None, compute_dtype=torch.bfloat16,
                                    device=DEV)
    engine = InferenceEngine(params, cfg, device=DEV)
    del params
    setup_s = time.perf_counter() - t0
    rgb, query, target = vitl_request(SEED + 13)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    req_ms, results, per_request = [], None, []
    for _ in range(2):
        counts = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run_plugin(rgb, query, target)
        torch.cuda.synchronize()
        req_ms.append(1e3 * (time.perf_counter() - t0))
        per_request.append(launches_since(counts))
    peak = torch.cuda.max_memory_allocated()
    want = {'K1': 2 * cfg.network_depth}
    if any(n != want for n in per_request):
        fail(f'vitl request launched {per_request}, expected {want} each')
    mask = np.concatenate([m['output_mask'] for m, _ in results])
    flags = np.concatenate([m['output_flags'] for m, _ in results])
    if mask.shape != (VITL_BATCH, 3) + rgb.shape[2:] or not (np.isfinite(mask).all()
                                                             and np.isfinite(flags).all()):
        fail(f'vitl request: outputs {mask.shape}, finite {np.isfinite(mask).all()}')
    with plain_attention():
        plain = engine.run_plugin(rgb, query, target)
    t = lambda a: torch.from_numpy(a)
    errs = {'mask_kernel_vs_plain_bf16': rel_l2(t(mask), t(np.concatenate(
                [m['output_mask'] for m, _ in plain]))),
            'flags_kernel_vs_plain_bf16': rel_l2(t(flags), t(np.concatenate(
                [m['output_flags'] for m, _ in plain])))}
    for key, v in errs.items():
        if not v <= TOL_SEEKER_BF16:
            fail(f'vitl request {key}: rel L2 {v} > {TOL_SEEKER_BF16}')
    flops = seeker_forward_flops(cfg, VITL_BATCH, vitl_width())
    del engine, plain, results
    torch.cuda.empty_cache()
    return dict(params=n_params, clips=VITL_BATCH, tokens_per_clip=60 * 1200,
                setup_s=setup_s, launches_per_request=per_request[-1], request_ms=req_ms,
                clips_per_s=VITL_BATCH / (req_ms[-1] / 1e3), max_memory_allocated_bytes=peak,
                forward_matmul_flops=flops, forward_bound_ms=1e3 * flops / PEAK_BF16_FLOPS,
                rel_l2=errs, tol_rel_l2=TOL_SEEKER_BF16), sum(r.get('K1', 0) for r in per_request)


def vitl_probe():
    '''tools/torch_vitl_probe.py over VITL_LADDER as a subprocess: every rung must fit,
    with a finite loss and each step's launches exactly VITL_PER_CALL's per attention call
    (two calls a block); ms/step, clips/s and peak of each. Returns (rungs, launches of
    each kernel by rung).'''
    spec = ';'.join(','.join(str(v) for v in rung) for rung in VITL_LADDER)
    text, wall_s = run_tool('torch_vitl_probe.py', ['--geoms', spec, '--steps', VITL_STEPS,
                                                    '--device', DEV],
                            timeout=VITL_PROBE_TIMEOUT_S)
    rungs = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"probe"')]
    if len(rungs) != len(VITL_LADDER):
        fail(f'vitl probe printed {len(rungs)} rungs, expected {len(VITL_LADDER)}')
    launches = {}
    for rung, r in zip(VITL_LADDER, rungs):
        depth, policy = rung[0], rung[7]
        if not r['fits']:
            fail(f'vitl probe {r["probe"]}: out of memory on the card ({r["error"]})')
        want = {k: n * 2 * depth for k, n in VITL_PER_CALL[policy].items()}
        if not np.isfinite(r['loss']) or any(s != want for s in r['launches']):
            fail(f'vitl probe {r["probe"]}: loss {r["loss"]}, launches {r["launches"]}, '
                 f'expected {want} a step')
        r['launches_per_step'] = want
        for k in want:
            launches.setdefault(k, {})[f'vitl_train_{r["probe"].replace(" ", "_")}'] = sum(
                s.get(k, 0) for s in r['launches'])
        del r['launches']
    return dict(rungs=rungs, wall_s=wall_s), launches


def vitl_parity():
    '''The kernel_x step's first-step loss and gradient at ViT-L width (1024, 16 heads)
    and depth 2, drop-path off, on the batch of record: the bf16 kernel path's error
    against the f32 plain path at most TRAIN_BF16_ERR_RATIO x the bf16 plain path's.'''
    rel = lambda a, b: abs(a - b) / abs(b)
    plain = (STEP_OF_RECORD[0], 'full')
    batch = train_batch()
    with depth_preset(2, vitl_width()):
        model = MaskTracker(train_config(torch.float32, 0.0, depth=2, pairing=plain).seeker,
                            device=DEV)
        model.init_params_(torch.Generator().manual_seed(SEED + 17))
        init_state = {k: v.clone() for k, v in model.state_dict().items()}
        del model
        out = {}
        for name, dtype, pairing, is_plain in (
                ('plain_f32', torch.float32, plain, True),
                ('plain_bf16', torch.bfloat16, plain, True),
                ('kernel_bf16', torch.bfloat16, STEP_OF_RECORD, False)):
            cfg = train_config(dtype, 0.0, depth=2, pairing=pairing)
            counts = read_launches()
            out[name] = loss_and_flat_grad(model_from(cfg, init_state), cfg, batch, is_plain)
            if not is_plain and launches_since(counts) != {'K1': 4, 'K4': 4}:
                fail(f'vitl parity: the kernel_x step launched {launches_since(counts)}')
    loss_r, grad_r = out['plain_f32']
    errs = {}
    for name in ('plain_bf16', 'kernel_bf16'):
        errs[f'loss_{name}'] = rel(out[name][0], loss_r)
        errs[f'grad_{name}'] = rel_l2(out[name][1], grad_r)
    ratio = errs['grad_kernel_bf16'] / errs['grad_plain_bf16']
    if not ratio <= TRAIN_BF16_ERR_RATIO:
        fail(f'vitl parity: bf16 gradient error of the kernel path {errs["grad_kernel_bf16"]} '
             f'> {TRAIN_BF16_ERR_RATIO} x the plain path\'s {errs["grad_plain_bf16"]}')
    del out, grad_r
    torch.cuda.empty_cache()
    return dict(depth=2, width=vitl_width(), losses={'plain_f32': loss_r}, rel_err=errs,
                grad_err_ratio=ratio, grad_err_ratio_limit=TRAIN_BF16_ERR_RATIO)


def phase_vitl(workdir):
    '''The stretch configuration through the main paths: the request (vitl_inference),
    the training ladder (vitl_probe) and the gradient parity at ViT-L width
    (vitl_parity); each part's wall seconds. Returns each kernel's launches by path.'''
    shutil.rmtree(workdir, ignore_errors=True)
    out = {}
    t0 = time.perf_counter()
    out['inference'], inference_launches = vitl_inference(workdir / 'ckpt')
    shutil.rmtree(workdir, ignore_errors=True)
    out['inference_wall_s'] = time.perf_counter() - t0
    launches = {'K1': {'vitl_inference': inference_launches}}
    t0 = time.perf_counter()
    out['train'], train_launches = vitl_probe()
    out['train_wall_s'] = time.perf_counter() - t0
    for k, by_rung in train_launches.items():
        launches.setdefault(k, {}).update(by_rung)
    t0 = time.perf_counter()
    out['parity'] = vitl_parity()
    out['parity_wall_s'] = time.perf_counter() - t0
    emit({'phase': 'vitl', **out})
    return launches


# ---------------------------------------------------------------------------------------
# The tools at the configuration of record: stream demo, stream and serve benches, the
# long-horizon stream_eval and the host data tools
# ---------------------------------------------------------------------------------------

TOOLS_TIMEOUT_S = 300
TOOL_FAULTS = ('Traceback',)
# tools/torch_stream_bench.py and tools/torch_serve_bench.py at the flags of record.
STREAM_BENCH_ARGS = ('--frames', '64', '--windows', '30,120', '--multi', '4', '--repeats', '1')
SERVE_BENCH_ARGS = ('--sessions', '1,4', '--frames', '30', '--window', '30')
SERVE_BENCH_SLOTS = (1, 4)
# The long-horizon stream_eval: Kubric scenes written by the port at 160 frames (5.3x the
# trained horizon), unbounded and window 30, against the offline forward at T = 160.
STREAM_EVAL_SCENES = 2
STREAM_EVAL_FRAMES = 160
STREAM_EVAL_WINDOWS = '0,30'
DEMO_FRAMES = 185        # demo/rollball.mp4 from its query frame (15) on


def run_tool(script, args, timeout=TOOLS_TIMEOUT_S):
    '''python tools/<script> args as a subprocess -> (stdout, wall seconds); fails on a
    non-zero exit, after `timeout` s, or with a traceback or error in its output.'''
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, os.path.join('tools', script), *map(str, args)],
                              capture_output=True, text=True, timeout=timeout,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired:
        fail(f'{script} took over {timeout} s')
    faults = [f for f in TOOL_FAULTS if f in proc.stdout or f in proc.stderr]
    if proc.returncode != 0 or faults:
        print(proc.stdout[-3000:], proc.stderr[-5000:], file=sys.stderr)
        fail(f'{script} exited {proc.returncode}, faults {faults}')
    return proc.stdout, time.perf_counter() - t0


def json_line(text, key):
    '''The JSON line of a tool's stdout that carries `key`.'''
    for ln in text.splitlines():
        if ln.startswith('{') and f'"{key}"' in ln:
            return json.loads(ln)
    fail(f'no {key} line in the tool output: {text[-2000:]}')


def finite_numbers(obj):
    '''Every number in a nested dict / list is finite.'''
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_numbers(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


def tool_main(script, argv):
    '''tools/<script>'s main(argv) in this process -> (its return value, its stdout, wall
    seconds).'''
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tools'))
    module = importlib.import_module(script)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main([str(a) for a in argv])
    return rc, buf.getvalue(), time.perf_counter() - t0


def data_tools_run(root):
    '''tools/torch_warm_cache.py then tools/torch_validate_dataset.py (their main() in
    this process) on the train_driver dataset at the window the driver loads (T + its
    max delay): every scene holds a cc_torch cache after the warm, and every train scene
    supports the record's 3 queries (exit 0).'''
    frames = SEEKER_ARGS['num_total_frames'] + DRIVER_MAX_DELAY
    _, text, warm_s = tool_main('torch_warm_cache', [
        '--data_path', root, '--num_frames', SEEKER_ARGS['num_total_frames'],
        '--max_delay', DRIVER_MAX_DELAY, '--workers', 4])
    scenes = [d for d in root.glob('*/*_scn*') if d.is_dir()]
    cold = [d.name for d in scenes if not any(p.name.startswith(kubric_lib.CACHE_PREFIX)
                                              for p in d.iterdir())]
    if not scenes or cold:
        fail(f'warm_cache: scenes without a cache {cold} of {len(scenes)}')
    rc, out, validate_s = tool_main('torch_validate_dataset', [
        '--data_path', root / 'train', '--num_queries', TRAIN_Q, '--num_frames', frames,
        '--frame_height', SEEKER_ARGS['frame_height'],
        '--frame_width', SEEKER_ARGS['frame_width']])
    n = DRIVER_SPLITS[0][1]
    if rc != 0 or f'{n}/{n} scenes support num_queries={TRAIN_Q}' not in out:
        fail(f'validate_dataset exited {rc}: {out[-1000:]}')
    return dict(scenes=len(scenes), frames=frames, warm_s=warm_s, validate_s=validate_s,
                warm_log=text.strip().splitlines()[-2:], validate_rc=rc,
                validate_last=out.strip().splitlines()[-1])


def start_tools(workdir):
    '''The subprocesses of phase_tools (run_tool), all at once, each waited for on a thread
    of its own, once the seeded checkpoint of record is written: torch_stream_demo.py,
    torch_stream_bench.py, torch_serve_bench.py at each of SERVE_BENCH_SLOTS and
    torch_stream_eval.py. They share the host and the card with each other and with the
    main thread's phases, so their wall seconds and the benches' rates are no measurement.
    Returns (the checkpoint, {run: future of run_tool's (stdout, wall seconds)}).'''
    shutil.rmtree(workdir, ignore_errors=True)
    eval_checkpoint(workdir / 'checkpoints' / 'eval1')
    ckpt = workdir / 'checkpoints' / 'eval1' / 'checkpoint.npz'
    runs = {
        'stream_demo': ('torch_stream_demo.py', [
            '--resume', ckpt, '--video', EVAL_DEMO, '--query', STREAM_QUERY,
            '--query_frame', STREAM_QUERY_FRAME, '--window', STREAM_WINDOW,
            '--out', workdir / 'demo.webm', '--device', DEV]),
        'stream_bench': ('torch_stream_bench.py', [*STREAM_BENCH_ARGS, '--device', DEV]),
        **{f'serve_bench_{slots}': ('torch_serve_bench.py', [
            *SERVE_BENCH_ARGS, '--batch_slots', slots, '--resume', ckpt, '--device', DEV])
           for slots in SERVE_BENCH_SLOTS},
        'stream_eval': ('torch_stream_eval.py', [
            '--resume', ckpt, '--data_path', dataset('stream_long')[0], '--num_frames',
            STREAM_EVAL_FRAMES, '--windows', STREAM_EVAL_WINDOWS,
            '--out', workdir / 'stream_eval.json', '--device', DEV])}
    pool = concurrent.futures.ThreadPoolExecutor(len(runs))
    futures = {name: pool.submit(run_tool, *run) for name, run in runs.items()}
    pool.shutdown(wait=False)
    return ckpt, futures


def tools_stream_eval(workdir, ckpt, run):
    '''tools/torch_stream_eval.py's run (start_tools) on STREAM_EVAL_SCENES port-written
    Kubric scenes of STREAM_EVAL_FRAMES frames at windows 0 and 30 with the offline
    forward; then in this process, scene 0's unbounded stream (12 K1 a frame) against the
    offline forward at T = 160 (24 K1: temporal 300 x 160 causal, spatial 160 x 301)
    within TOL_SEEKER_BF16.'''
    torch_stream_eval = importlib.import_module('torch_stream_eval')
    root, write_s, nbytes = dataset('stream_long')
    out_fp = workdir / 'stream_eval.json'
    _, wall_s = run.result()
    results = json.loads(out_fp.read_text())
    variants = {'stream_winf', 'stream_w30', 'joint'}
    if not variants <= set(results) or not finite_numbers(results):
        fail(f'stream_eval results {sorted(results)}')
    model, cfg = torch_stream_eval.load_model(str(ckpt), '', DEV, torch.bfloat16)
    ds = torch_stream_eval.make_dataset(str(root), cfg, STREAM_EVAL_FRAMES)
    rgb, qmask, _ = torch_stream_eval.scene_inputs(ds[0], DEV)
    counts = read_launches()
    stream, _ = torch_stream_eval.stream_masks(model, rgb, qmask, 0, STREAM_EVAL_FRAMES, DEV)
    stream_launches = launches_since(counts)
    counts = read_launches()
    offline = torch_stream_eval.offline_masks(model, rgb, qmask, DEV)
    offline_launches = launches_since(counts)
    err = rel_l2(stream, offline)
    per_frame = {k: n * STREAM_EVAL_FRAMES for k, n in K1_PER_FRAME.items()}
    if stream_launches != per_frame or offline_launches != {'K1': 2 * cfg.network_depth}:
        fail(f'stream_eval: stream launched {stream_launches}, the offline forward '
             f'{offline_launches}')
    if not err <= TOL_SEEKER_BF16:
        fail(f'stream_eval: unbounded stream vs offline T = {STREAM_EVAL_FRAMES} rel L2 '
             f'{err} > {TOL_SEEKER_BF16}')
    del model, stream, offline
    torch.cuda.empty_cache()
    return dict(scenes=STREAM_EVAL_SCENES, frames=STREAM_EVAL_FRAMES, write_s=write_s,
                dataset_bytes=nbytes, wall_s=wall_s,
                latency_ms={k: v for k, v in results.items() if k.startswith('latency')},
                all={v: results[v]['all'] for v in sorted(variants)},
                stream_vs_offline_rel_l2=err, tol_rel_l2=TOL_SEEKER_BF16,
                launches={'stream': stream_launches, 'offline': offline_launches})


def phase_tools(workdir, data_tools, started):
    '''The tools as subprocesses (start_tools) at the configuration of record (depth 12,
    240x320, a seeded checkpoint): torch_stream_demo.py (window 30 over demo/rollball.mp4
    from its query, the video decoded back, 12 K1 a frame), torch_stream_bench.py and
    torch_serve_bench.py (dedicated and 4 slots; finite numbers, 12 K1 a frame or server
    step) and torch_stream_eval.py (tools_stream_eval); data_tools is data_tools_run's
    record. No traceback in any output. Returns K1's launches by tool.'''
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tools'))
    ckpt, runs = started
    out = {'data_tools': data_tools}
    launches = {}

    text, wall_s = runs['stream_demo'].result()
    demo = json_line(text, 'stream_demo')['stream_demo']
    decoded = decoded_frames(demo['out'])
    want = {k: n * DEMO_FRAMES for k, n in K1_PER_FRAME.items()}
    if demo['frames'] != DEMO_FRAMES or decoded != DEMO_FRAMES or demo['launches'] != want:
        fail(f'stream_demo: {demo}, {decoded} frames decoded, expected {DEMO_FRAMES} and {want}')
    out['stream_demo'] = dict(demo, decoded_frames=decoded, wall_s=wall_s)
    launches['tools_stream_demo'] = demo['launches'].get('K1', 0)

    text, wall_s = runs['stream_bench'].result()
    bench = json_line(text, 'stream_bench')
    for name, r in bench['stream_bench'].items():
        if r['launches_per_step'] != {k: float(n) for k, n in K1_PER_FRAME.items()} \
                or not finite_numbers(r):
            fail(f'stream_bench {name}: {r}')
    out['stream_bench'] = dict(bench, wall_s=wall_s)
    launches['tools_stream_bench'] = sum(r['launches'].get('K1', 0)
                                         for r in bench['stream_bench'].values())

    out['serve_bench'] = {}
    for slots in SERVE_BENCH_SLOTS:
        text, wall_s = runs[f'serve_bench_{slots}'].result()
        recs = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"serve_bench"')]
        lines = [ln for ln in text.splitlines() if ln.startswith('sessions=')]
        for r in recs:
            if r['launches'] != {k: n * r['server_steps'] for k, n in K1_PER_FRAME.items()} \
                    or not finite_numbers(r) or r['serve_bench']['stale_errors']:
                fail(f'serve_bench batch_slots={slots}: {r}')
        if len(recs) != 2 or len(lines) != 2:
            fail(f'serve_bench batch_slots={slots}: {text[-2000:]}')
        out['serve_bench'][f'slots_{slots}'] = dict(runs=recs, lines=lines, wall_s=wall_s)
        launches[f'tools_serve_bench_slots_{slots}'] = sum(r['launches'].get('K1', 0)
                                                            for r in recs)

    out['stream_eval'] = tools_stream_eval(workdir, ckpt, runs['stream_eval'])
    launches['tools_stream_eval'] = sum(n.get('K1', 0)
                                        for n in out['stream_eval']['launches'].values())
    emit({'phase': 'tools', **out})
    return launches


# ---------------------------------------------------------------------------------------
# ResNet-50: the alternative dense backbone (cuDNN convolutions)
# ---------------------------------------------------------------------------------------

# 60 frames at 240x320: one request's 2 clips of 30 frames as per-frame features.
RESNET_FRAMES = BATCH * SEEKER_ARGS['num_total_frames']
# Card vs CPU in f32 (TF32 off): the convolutions sum in another order.
TOL_RESNET_F32 = 1e-4
# bf16 vs f32 on the card in eval mode: the stem convolution rounds its inputs and weights
# to bf16 (the JAX package's promotion carries every later layer in f32). In train mode
# the seeded network normalises every layer by its batch's own moments, which magnifies
# any perturbation of its input (a relative 1e-6 on the frames moves the features by
# ~1e-4, 6 frames on the CPU), so the stem's bf16 rounding moves them by tens of percent:
# that error is recorded beside this sensitivity, not held to a limit.
TOL_RESNET_BF16 = 5e-2


def phase_resnet():
    '''models/resnet.py on RESNET_FRAMES frames at 240x320, seeded weights: the card
    against the CPU port in f32, eval and train mode (the stored BatchNorm statistics
    unchanged by train mode); bf16 against f32 on the card (held in eval mode); in each
    mode the features' response to a relative 1e-6 perturbation of the frames; ms per
    forward and peak.'''
    from tcow_tpu_torch.models import resnet as resnet_lib
    cfg = resnet_lib.DenseResNetConfig(in_channels=3)
    cpu = resnet_lib.DenseResNet(cfg)
    cpu.init_params_(torch.Generator().manual_seed(SEED))
    H, W = SEEKER_ARGS['frame_height'], SEEKER_ARGS['frame_width']
    rng = np.random.RandomState(SEED + 21)
    frames = torch.from_numpy(rng.rand(RESNET_FRAMES, 3, H, W).astype(np.float32))
    x = frames.to(DEV)
    nudged = x * (1 + 1e-6 * torch.from_numpy(
        rng.randn(*frames.shape).astype(np.float32)).to(DEV))
    models = {}
    for name, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        models[name] = resnet_lib.DenseResNet(dataclasses.replace(cfg, compute_dtype=dtype),
                                              device=DEV)
        models[name].load_state_dict(cpu.state_dict())
    before = {k: v.clone() for k, v in models['f32'].state_dict().items()}
    out = {'frames': RESNET_FRAMES, 'height': H, 'width': W}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for train in (False, True):
            mode = 'train' if train else 'eval'
            want = cpu(frames, train)
            got = models['f32'](x, train)
            got16 = models['bf16'](x, train)
            torch.cuda.synchronize()
            if got.shape != (RESNET_FRAMES, 1024, H // 16, W // 16) \
                    or not bool(torch.isfinite(got16).all()):
                fail(f'resnet {mode}: features {tuple(got.shape)}')
            e = dict(card_vs_cpu_f32=rel_l2(got.cpu(), want),
                     bf16_vs_f32=rel_l2(got16.float(), got),
                     response_to_input_1e6=rel_l2(models['f32'](nudged, train), got),
                     ms_f32=cuda_ms(lambda: models['f32'](x, train), iters=5),
                     ms_bf16=cuda_ms(lambda: models['bf16'](x, train), iters=5))
            if not e['card_vs_cpu_f32'] <= TOL_RESNET_F32 or (
                    not train and not e['bf16_vs_f32'] <= TOL_RESNET_BF16):
                fail(f'resnet {mode}: {e}')
            out[mode] = e
            del want, got, got16
    if not all(torch.equal(before[k], v) for k, v in models['f32'].state_dict().items()):
        fail('resnet: train mode changed the stored BatchNorm statistics')
    out.update(max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               tol={'card_vs_cpu_f32': TOL_RESNET_F32, 'bf16_vs_f32_eval': TOL_RESNET_BF16})
    del models, x, nudged
    torch.cuda.empty_cache()
    emit({'phase': 'resnet', **out})
    return out


def kernel_entry(name, source, replaces, launches, errs, per_geom):
    '''One item of the `kernels` line: means over the geometries of the main path (each
    is called once per block).'''
    mean = lambda key: sum(g[key] for g in per_geom.values()) / len(per_geom)
    bf16 = [e for e in errs.values() if e['dtype'] == 'bfloat16']
    return {'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
            'launches': sum(launches.values()), 'launches_by_path': launches,
            'max_abs_err': max(e['max_abs_err'] for e in bf16),
            'ms': mean('ms'), 'plain_ms': mean('plain_ms'), 'bound_ms': mean('bound_ms'),
            'bound_by': ('operations' if all(g['bound_by'] == 'operations'
                                             for g in per_geom.values()) else 'bytes'),
            'library_ms': mean('library_ms'), 'per_geometry': per_geom}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU',
              file=sys.stderr)
        return 2
    global T0
    T0 = time.perf_counter()
    # On stderr, for the command's own time: the wall clock at the start, the script's
    # seconds once it has cleaned up.
    print(f'chip_smoke: started at wall {time.time():.3f}', file=sys.stderr, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prewrite_datasets()
    ranks = []
    try:
        return run_phases(ranks)
    except BaseException:
        ABORT.set()
        raise
    finally:
        stop_ranks(ranks)
        shutil.rmtree(DATA_DIR, ignore_errors=True)
        print(f'chip_smoke: cleaned up at script_s {time.perf_counter() - T0:.1f}',
              file=sys.stderr, flush=True)


def run_phases(ranks):
    '''Every phase, in order; `ranks` gets the subprocesses that outlive a phase, for main
    to stop.'''
    # The phases on threads (start_host_run), each with the function that waits for it.
    # The gloo probe needs no kernel and runs beside the build; the two-rank
    # train_torch.py runs, data-, tensor- and sequence-parallel (host-bound), beside the
    # phases that time nothing: the kernels against their plain versions, the parity
    # passes and the grids.
    finishers = [start_host_run(phase_gloo_probe, _build.BUILD_DIR / 'chip_smoke_gloo')]
    dp_dir = _build.BUILD_DIR / 'chip_smoke_dp'
    par_dir = _build.BUILD_DIR / 'chip_smoke_parallel'
    try:
        # The ranks of phases dp, tp and sp draw their init on the host beside the build
        # and wait for their go.
        dp_ranks = start_dp(dp_dir)
        ranks += dp_ranks
        par_ranks = start_parallel(par_dir, PARALLEL_RANKS)
        ranks += [r for kind in PARALLEL_RANKS for r in par_ranks[kind]]
        smi = phase_device()
        finishers += [start_host_run(phase_dp_driver, dataset('driver')[0],
                                     _build.BUILD_DIR / 'chip_smoke_dp_driver')]
        finishers += [start_host_run(functools.partial(phase_parallel_driver, kind),
                                     dataset(f'{kind}_driver')[0],
                                     _build.BUILD_DIR / f'chip_smoke_{kind}_driver')
                      for kind in PARALLEL_DRIVERS]
        errs = phase_kernel_vs_plain()
        k4_errs = phase_k4_vs_plain()
        new_errs = phase_new_kernels_vs_plain()
        rope_errs = phase_rope_kernels_vs_plain()
        # The parity passes and the grids time nothing either, so they run while the
        # threads do.
        phase_train_parity(*record_init(rope=True), rope=True)
        _, parity = phase_train_parity(*record_init(), keep=True)
        torch.cuda.empty_cache()
        grid_launches = phase_grids(par_ranks, parity, par_dir)
        _, dp_driver_launches, *par_driver_launches = [finish() for finish in finishers]
        par_driver_launches = dict(zip(PARALLEL_DRIVERS, par_driver_launches))
    except BaseException:
        ABORT.set()
        for finish in finishers:
            with contextlib.suppress(BaseException):
                finish()
        raise
    ckpt_dir = _build.BUILD_DIR / 'chip_smoke_ckpt'
    try:
        params, cfg, inference_launches, inputs = phase_slice(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    per_geom = phase_times(params, cfg, inputs)
    trains = {}
    for pairing in PAIRINGS:
        trains[pairing] = phase_train(pairing)
        if pairing != STEP_OF_RECORD:
            for key in ('state', 'train_step', 'batch'):
                del trains[pairing][key]
            torch.cuda.empty_cache()
    emit({'phase': 'train_pairings', 'pairings': [
        {'attention_bwd': m, 'remat_policy': p, 'step_ms': t['step_ms'],
         'clips_per_s': TRAIN_B / (t['step_ms'] / 1e3), 'max_memory_allocated_bytes': t['peak'],
         'launches_per_step': {k: n // (1 + TRAIN_STEPS) for k, n in t['launches'].items() if n}}
        for (m, p), t in trains.items()]})
    record = trains[STEP_OF_RECORD]
    train_geom = phase_train_times(record)
    for key in ('state', 'train_step', 'batch'):
        del record[key]
    torch.cuda.empty_cache()
    try:
        dp_launches = phase_dp(dp_ranks, parity, dp_dir)
    finally:
        shutil.rmtree(dp_dir, ignore_errors=True)
    try:
        par_launches = phase_parallels(par_ranks, parity, par_dir)
        for k, by_path in grid_launches.items():
            for path, n in by_path.items():
                par_launches[path.split('_')[0]].setdefault(k, {})[path] = n
    finally:
        shutil.rmtree(par_dir, ignore_errors=True)
    del parity
    try:
        device_side = phase_train_device_side(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    driver_dir = _build.BUILD_DIR / 'chip_smoke_driver'
    try:
        driver = phase_train_driver(driver_dir)
        data_tools = data_tools_run(dataset('driver')[0])
    finally:
        shutil.rmtree(driver_dir, ignore_errors=True)
    # The tools' subprocesses run beside eval and pth, which time nothing on the card.
    tools_dir = _build.BUILD_DIR / 'chip_smoke_tools'
    tools = start_tools(tools_dir)
    try:
        eval_dir = _build.BUILD_DIR / 'chip_smoke_eval'
        try:
            evaluation = phase_eval(eval_dir)
        finally:
            shutil.rmtree(eval_dir, ignore_errors=True)
        pth_dir = _build.BUILD_DIR / 'chip_smoke_pth'
        try:
            pth = phase_pth(pth_dir)
        finally:
            shutil.rmtree(pth_dir, ignore_errors=True)
        tools_launches = phase_tools(tools_dir, data_tools, tools)
    finally:
        concurrent.futures.wait(tools[1].values())
        shutil.rmtree(tools_dir, ignore_errors=True)
    stream_dir = _build.BUILD_DIR / 'chip_smoke_stream'
    try:
        stream = phase_stream(stream_dir)
    finally:
        shutil.rmtree(stream_dir, ignore_errors=True)
    serve = phase_serve(stream.pop('params'), stream.pop('cfg'))
    torch.cuda.empty_cache()

    try:
        rope_inference_launches = phase_rope_slice(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    rope_trains = {}
    for pairing in PAIRINGS:
        rope_trains[pairing] = phase_train(pairing, rope=True)
        for key in ('state', 'train_step', 'batch'):
            del rope_trains[pairing][key]
        torch.cuda.empty_cache()
    rope_geom = phase_rope_times()
    core = phase_attn_core_times()
    bwd_core = phase_attn_bwd_times()
    gemm = phase_gemm_times()
    torch.cuda.empty_cache()
    joint_errs, joint_geom = phase_joint_kernels()
    joint_launches = phase_joint()
    torch.cuda.empty_cache()
    vitl_errs, vitl_geom = phase_vitl_kernels()
    vitl_dir = _build.BUILD_DIR / 'chip_smoke_vitl'
    try:
        vitl_launches = phase_vitl(vitl_dir)
    finally:
        shutil.rmtree(vitl_dir, ignore_errors=True)
    phase_resnet()

    def train_launches(kernel, runs=trains, prefix='train'):
        return {f'{prefix}_{m}': t['launches'][kernel] for (m, _), t in runs.items()
                if t['launches'][kernel]}

    source = 'tcow_tpu_torch/ops/csrc/fused_attention.cu'
    replaces = 'tcow_tpu/ops/pallas_attention.py:'
    # The device side of training runs the step of record's kernels, K1 and K4, and so
    # does the driver (train_torch.py; its two-rank runs under dp_driver, tp_driver,
    # sp_driver and pp_driver);
    # its rope256 run K1, K1r, K4 and K4r.
    def device_side_launches(kernel):
        return {'train_device_side': device_side['launches'][kernel],
                'train_driver': driver['launches'].get(kernel, 0),
                'train_driver_rope': driver['rope_launches'].get(kernel, 0),
                'pth': pth['launches'].get(kernel, 0),
                'dp_driver': dp_driver_launches.get(kernel, 0),
                **{f'{kind}_driver': par_driver_launches[kind].get(kernel, 0)
                   for kind in PARALLEL_DRIVERS}}

    def parallel_launches(kernel):
        return {path: n for kind in PARALLELS
                for path, n in par_launches.get(kind, {}).get(kernel, {}).items()}
    k1 = kernel_entry('fused_attention', source, replaces + '87',
                      {'inference': inference_launches, **train_launches('K1'),
                       **device_side_launches('K1'),
                       'eval': evaluation['launches'].get('K1', 0),
                       'stream': stream['launches']['K1'],
                       'stream_clips': stream['clip_launches']['K1'],
                       'stream_eval': stream['eval_launches']['K1'],
                       **serve['launches'], **joint_launches['K1'], **vitl_launches['K1'],
                       **tools_launches, **dp_launches.get('K1', {}),
                       **parallel_launches('K1')}, errs, per_geom)
    k1['per_geometry_train'] = train_geom['K1']
    # The stream's spatial call (1 x 301) and a 4-session server tick's (4 x 301).
    k1['per_geometry_stream'] = stream['k1']
    entries = [k1]
    for kernel, name, line, kerrs in (
            ('K2', 'fused_attention_fwd_qkv', '293', new_errs['K2']),
            ('K3', 'fused_attention_fwd_res', '327', new_errs['K3']),
            ('K4', 'fused_attention_bwd', '548', k4_errs),
            ('K5', 'fused_attention_bwd_qkv', '755', new_errs['K5']),
            ('K6', 'fused_attention_bwd_wg', '735', new_errs['K6'])):
        launches = train_launches(kernel)
        if kernel == 'K4':
            launches.update(device_side_launches('K4'))
        launches.update(joint_launches.get(kernel, {}))
        launches.update(vitl_launches.get(kernel, {}))
        launches.update(dp_launches.get(kernel, {}))
        launches.update(parallel_launches(kernel))
        entries.append(kernel_entry(name, source, replaces + line, launches, kerrs,
                                    train_geom[kernel]))
    # The rope variants: the rotation in _kernel (:120-136) for the forwards, in
    # _bwd_kernel (:592-605, un-rotation :626-628) for the backwards.
    for kernel, name, line in (('K1r', 'fused_attention_rope', '120'),
                               ('K2r', 'fused_attention_fwd_qkv_rope', '120'),
                               ('K3r', 'fused_attention_fwd_res_rope', '120'),
                               ('K4r', 'fused_attention_bwd_rope', '592'),
                               ('K5r', 'fused_attention_bwd_qkv_rope', '592'),
                               ('K6r', 'fused_attention_bwd_wg_rope', '592')):
        launches = train_launches(kernel, rope_trains, 'rope_train')
        if kernel == 'K1r':
            launches = {'rope_inference': rope_inference_launches, **launches}
        if kernel in ('K1r', 'K4r'):
            launches['train_driver_rope'] = driver['rope_launches'].get(kernel, 0)
        entries.append(kernel_entry(name, source, replaces + line, launches,
                                    rope_errs[kernel], rope_geom[kernel]))
    # K1-K3 and K1r-K3r: their bf16 attention core (attn_core_mma) timed alone; K4-K6 and
    # K4r-K6r: their bf16 backward core (attn_bwd_q_mma + attn_bwd_kv_mma); every kernel:
    # its GEMMs and row reductions (gemm_sm90.cu) at the geometries of its main path.
    for kernel, entry in zip(('K1', 'K2', 'K3', 'K4', 'K5', 'K6', 'K1r', 'K2r', 'K3r', 'K4r',
                              'K5r', 'K6r'), entries, strict=True):
        if kernel in CORE_OF_KERNEL:
            entry['attn_core'] = {s: core[s] for s in CORE_OF_KERNEL[kernel]}
        if kernel in BWD_CORE_OF_KERNEL:
            entry['attn_bwd'] = {s: bwd_core[s] for s in BWD_CORE_OF_KERNEL[kernel]}
        if kernel in vitl_errs:
            # The same kernel at ViT-L width (D = 1024, 16 heads; stretch shapes).
            entry['vitl'] = {'launches': {p: n for p, n in entry['launches_by_path'].items()
                                          if p.startswith('vitl')},
                             'max_abs_err': max(e['max_abs_err'] for e in
                                                vitl_errs[kernel].values()
                                                if e['dtype'] == 'bfloat16'),
                             'cases': vitl_errs[kernel], 'per_geometry': vitl_geom[kernel]}
        if kernel in joint_errs:
            # The same kernel at S = 9001 (joint space-time attention).
            entry['joint'] = {'launches': {p: n for p, n in entry['launches_by_path'].items()
                                           if p.startswith('joint')},
                              'max_abs_err': max(e['max_abs_err']
                                                 for e in joint_errs[kernel].values()),
                              'cases': joint_errs[kernel], 'per_geometry': joint_geom[kernel]}
        geoms = entry['per_geometry'].keys()
        if kernel == 'K1':
            geoms = [*INFER_ROWS, *TRAIN_ROWS]
        elif kernel == 'K1r':
            geoms = ['inference_temporal', 'train_temporal']
        geoms = [g if g.startswith(('train_', 'inference_')) else f'train_{g}' for g in geoms]
        entry['gemm'] = {'source': 'tcow_tpu_torch/ops/csrc/gemm_sm90.cu', **{
            f'{op}/{g}': gemm[f'{op}/{g}'] for op in GEMMS_OF_KERNEL[kernel.rstrip('r')]
            for g in geoms}}
    emit({'kernels': entries})
    print(smi)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
