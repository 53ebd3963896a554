#!/usr/bin/env python3
'''
Device-time breakdown of the PyTorch port's training step on one NVIDIA GPU.

Builds the training step of chip_smoke.py (2 clips x 3 queries, ViT-B/16, depth 12, T=30,
240x320, causal_attention=1, bf16, per-block remat, drop-path 0.1, AdamW) under an
attention-backward mode and a remat policy, by default the step of record (kernel_x with
dots_nb_out: K1 forward, K4 backward), with --rope the time-calibrated rope step
(temporal_rope, rope_time_coords, frame times in the batch: K1r/K4r on the temporal calls),
with --joint joint space-time attention (one call over 9001 tokens a block, K1 and K4;
the kernel path alone, as the plain path's (6, 12, 9001, 9001) f32 probabilities do not
fit), with --vitl the ViT-L stretch rung of tools/torch_vitl_probe.py (depth 24, D = 1024,
16 heads, one clip and one query at T = 60, 480x640; the kernel path alone), with
--device_augs colour augmentation in the batch and with --grad_accum A
microbatches, and, for the kernel path and the plain attention path, runs one warm-up step
and profiles one step with torch.profiler. Prints one JSON line each: host wall time of the step,
device busy time and its share of the wall time, and device time per kernel group. With
--table_dir DIR the per-kernel tables go to
DIR/torch_profile_train_<mode>_<policy>[_rope][_joint][_augs][_ga<A>]_<path>.txt.

Run from the repository root:
`python3 tools/torch_profile_train.py [--attention_bwd MODE] [--remat_policy POLICY]
[--rope | --joint | --vitl] [--device_augs] [--grad_accum A] [--table_dir DIR]`; the
stretch rung as the probe runs it: `--vitl --remat_policy full`.
'''

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from torch_profile_inference import profile_call  # noqa: E402
from tcow_tpu_torch.data.synthetic import synthetic_device_batch  # noqa: E402
from tcow_tpu_torch.models.mask_tracker import seeker_config_from_args  # noqa: E402
from tcow_tpu_torch.models.timesformer import REMAT_POLICIES  # noqa: E402
from tcow_tpu_torch.objectives.losses import LossConfig  # noqa: E402
from tcow_tpu_torch.ops.fused_attention import BWD_MODES  # noqa: E402
from tcow_tpu_torch.train import optim  # noqa: E402
from tcow_tpu_torch.train import step as step_lib  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument('--attention_bwd', default=cs.STEP_OF_RECORD[0], choices=BWD_MODES,
                    help='attention backward mode (default: the step of record\'s)')
    ap.add_argument('--remat_policy', default=cs.STEP_OF_RECORD[1], choices=REMAT_POLICIES,
                    help='per-block remat policy (default: the step of record\'s)')
    group = ap.add_mutually_exclusive_group()
    group.add_argument('--rope', action='store_true',
                       help='the time-calibrated rope step (rope256 configuration)')
    group.add_argument('--joint', action='store_true',
                       help='joint space-time attention (the kernel path alone)')
    group.add_argument('--vitl', action='store_true',
                       help='the ViT-L stretch rung, 1 clip x 1 query at T=60, 480x640 '
                            '(the kernel path alone)')
    ap.add_argument('--grad_accum', type=int, default=1,
                    help='microbatches per step (make_train_step(grad_accum=))')
    ap.add_argument('--device_augs', action='store_true',
                    help='colour augmentation keys in the batch (chip_smoke.DEVICE_AUGS)')
    ap.add_argument('--table_dir', default=None,
                    help='write the per-kernel profiler tables into this directory')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.vitl:
        # tools/torch_vitl_probe.py's step at its stretch rung.
        seeker = seeker_config_from_args(cs.VITL_ARGS, drop_path_rate=0.1,
                                         compute_dtype=torch.bfloat16, remat=True,
                                         attention_bwd=args.attention_bwd,
                                         remat_policy=args.remat_policy)
        cfg = step_lib.StepConfig(seeker=seeker, loss=LossConfig(), num_queries=1)
        batch = {k: torch.as_tensor(v, device='cuda') for k, v in synthetic_device_batch(
            0, B=1, Q=1, T=seeker.num_total_frames, H=seeker.frame_height,
            W=seeker.frame_width, M=12, K=6).items()}
    else:
        cfg = cs.train_config(torch.bfloat16, pairing=(args.attention_bwd, args.remat_policy),
                              rope=args.rope, joint=args.joint)
        batch = cs.train_batch(args.rope)
    tx = optim.make_optimizer('adamw', learn_rate=1e-4, num_epochs=70, steps_per_epoch=1000)
    state = step_lib.init_train_state(cs.SEED, cfg, tx, device='cuda')
    train_step = step_lib.make_train_step(cfg, args.grad_accum)
    if args.device_augs:
        batch = {**cs.device_side_batch(), **batch}
    extra = ('_rope' if args.rope else '') + ('_joint' if args.joint else '') + (
        '_vitl' if args.vitl else '') + (
        '_augs' if args.device_augs else '') + (
        f'_ga{args.grad_accum}' if args.grad_accum > 1 else '')
    for tag in ('kernel',) if args.joint or args.vitl else ('kernel', 'plain'):
        profile_call(lambda: train_step(state, batch, cs.TRAIN_PROGRESS),
                     f'train_{args.attention_bwd}_{args.remat_policy}{extra}_{tag}',
                     tag == 'plain', args.table_dir)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
