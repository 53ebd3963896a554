'''
The flags of the port: a copy of tcow_tpu/config.py (the shared, train and test flags,
verify_args, args_to_dict, build_seeker_args), so the JAX package's train and eval
commands run unchanged against train_torch.py and eval_torch.py.

--device defaults to cuda and accepts cpu. Training runs data-parallel: --mesh_devices N
(train_torch.py starts N ranks, one per GPU; -1 = every visible GPU, one on the CPU) or
--multihost 1 (this process is one rank of a world its launcher describes in RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT), sequence-parallel over --seq_shards,
tensor-parallel over --tp_shards and pipeline-parallel over --pp_stages of those ranks (the
(data, seq, model, pipe) mesh: N / (seq_shards x tp_shards x pp_stages) data rows of that
many ranks; every combination of the axes trains, with either attention type. tp_shards
must divide the width and the MLP width, seq_shards must leave every seq rank patches and
frames under divided attention (joint attention splits the clips, zero-padded), and the
product must divide the world, else ValueError; the driver checks the pipeline's
divisibility, parallel/pipeline.py:validate_pp_args. --pp_manual 1 parses on every layout,
as JAX's CLI does: the port runs one schedule, its stages local either way.
Flags of what the port does not run raise NotImplementedError from verify_args, naming
the ROADMAP.md item that holds them: --seq_shards > 1, --tp_shards > 1, --pp_stages > 1,
--mesh_devices > 1 or --multihost for evaluation (item 7), which the JAX package does not
run either.
Every other flag parses and behaves as in the JAX package; --resume and
--tracker_pretrained take a reference .pth too (models/torch_import.py).
'''

import argparse
import multiprocessing as mp
import os
from typing import Any, Dict

from tcow_tpu_torch.train import checkpoint as ckpt_lib


def _str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ('yes', 'true', 't', 'y', '1'):
        return True
    if v.lower() in ('no', 'false', 'f', 'n', '0'):
        return False
    raise argparse.ArgumentTypeError('Boolean value expected.')


def shared_args(parser: argparse.ArgumentParser):
    parser.add_argument('--seed', default=900, type=int)
    parser.add_argument('--log_level', default='info', type=str,
                        choices=['debug', 'info', 'warn'])
    parser.add_argument('--device', default='cuda', type=str, choices=['cuda', 'cpu'],
                        help='Where the model runs: the GPU, or the CPU (tests).')
    parser.add_argument('--batch_size', default=4, type=int)
    parser.add_argument('--num_workers', default=-1, type=int)
    parser.add_argument('--worker_mode', default='thread', type=str,
                        choices=['thread', 'process'],
                        help='Data-loader workers: "thread" (few-core hosts / CI) or '
                             '"process" (a forkserver pool; scales item loading with '
                             'cores).')
    parser.add_argument('--checkpoint_root', default='checkpoints/', type=str)
    parser.add_argument('--log_root', default='logs/', type=str)
    parser.add_argument('--name', '--tag', default='', type=str)
    parser.add_argument('--resume', '--checkpoint_name', default='', type=str)
    parser.add_argument('--epoch', default=-1, type=int)
    parser.add_argument('--avoid_wandb', default=0, type=int)
    parser.add_argument('--log_rarely', default=0, type=int)
    parser.add_argument('--data_path', required=True, type=str, nargs='+')
    parser.add_argument('--use_data_frac', default=1.0, type=float)
    parser.add_argument('--num_queries', default=1, type=int)
    # Automatically inferred options (do not assign).
    parser.add_argument('--is_debug', default=False, type=_str2bool)
    parser.add_argument('--checkpoint_path', default='', type=str)
    parser.add_argument('--train_log_path', default='', type=str)
    parser.add_argument('--log_path', default='', type=str)
    parser.add_argument('--wandb_group', default='group', type=str)
    # Resource options. Training runs data-, sequence- and tensor-parallel over
    # --mesh_devices ranks or the --multihost world.
    parser.add_argument('--mesh_devices', default=-1, type=int,
                        help='Data-parallel ranks of a train run, one per GPU; -1 = every '
                             'visible GPU (one on the CPU).')
    parser.add_argument('--seq_shards', default=1, type=int,
                        help='Sequence-parallel shards (seq mesh axis) of a train run: '
                             'each data row of the mesh has seq_shards x tp_shards ranks, '
                             'which split the patches and frames inside the blocks.')
    parser.add_argument('--tp_shards', default=1, type=int,
                        help='Tensor-parallel shards (model mesh axis) of a train run: '
                             'each data row of the mesh has this many ranks.')
    parser.add_argument('--grad_accum', default=1, type=int,
                        help='Gradient accumulation: split the batch into this many '
                             'microbatches, run forward+backward per microbatch in turn, '
                             'average gradients, apply ONE optimizer update. Must divide '
                             'batch_size.')
    parser.add_argument('--pp_stages', default=1, type=int,
                        help='Pipeline-parallel stages (pipe mesh axis) of a train run: the '
                             'blocks split into contiguous stages, one a rank of each data '
                             'row, and microbatches stream through them GPipe-style. '
                             'Requires network_depth %% (pp_stages * remat_group) == 0.')
    parser.add_argument('--pp_microbatches', default=0, type=int,
                        help='Microbatches for pipeline parallelism; 0 = the largest of '
                             '4, 2 and 1 x pp_stages dividing batch_size / grad_accum x '
                             'num_queries.')
    parser.add_argument('--pp_manual', default=0, type=int,
                        help='The JAX package\'s manual-pipe schedule, which it takes on '
                             '(pipe x data) meshes only and turns off elsewhere. The port '
                             'runs one schedule, its stages local either way.')
    parser.add_argument('--compute_dtype', default='bfloat16', type=str,
                        choices=['bfloat16', 'float32'])
    parser.add_argument('--profile_dir', default='', type=str,
                        help='If set, capture a torch.profiler trace of a few train steps '
                             'into this directory (a Chrome trace JSON).')
    parser.add_argument('--device_augs', default=-1, type=int,
                        help='Colour augmentation on the device inside the step: -1 auto '
                             '(on for a CUDA run, host-side on the CPU), 0 forces the '
                             'host colour path, 1 the device.')
    parser.add_argument('--multihost', default=False, type=_str2bool,
                        help='Train as one rank of the world that the environment '
                             'describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, '
                             'MASTER_PORT; torchrun sets them).')
    parser.add_argument('--h2d_prefetch', default=True, type=_str2bool,
                        help='Copy the NEXT batch to the device on a side stream while '
                             'the current step executes (one-deep double buffering from '
                             'pinned memory; costs one extra device-resident batch).')


def train_args(argv=None):
    parser = argparse.ArgumentParser()
    shared_args(parser)
    parser.add_argument('--num_epochs', default=70, type=int)
    parser.add_argument('--checkpoint_every', default=2, type=int)
    parser.add_argument('--save_every', default=1, type=int,
                        help='Epoch interval for updating the latest checkpoint.')
    parser.add_argument('--preempt_save', default=True, type=_str2bool,
                        help='On SIGTERM (preemption/timeout), finish the current step, '
                             'write a FULL mid-epoch checkpoint, and exit cleanly; '
                             '--resume continues that epoch at the exact step.')
    parser.add_argument('--checkpoint_light', default=False, type=_str2bool,
                        help='Per-epoch saves write model params ONLY (about 1/3 of '
                             'the bytes); the full resumable state (optimizer/rng/step) is '
                             'still written every checkpoint_every epochs and at the end. '
                             'Resuming from a light checkpoint reinitializes the optimizer.')
    parser.add_argument('--allow_opt_reinit', default=False, type=_str2bool,
                        help='Permit resuming training from a checkpoint WITHOUT optimizer '
                             'state (a --checkpoint_light save), reinitializing the AdamW '
                             'moments/LR step. Off by default: the driver instead falls '
                             'back to the newest full-state model_{e}.npz snapshot in the '
                             'same directory, or refuses. Also lets a resume with another '
                             'number of ranks than the checkpoint\'s sample the train '
                             'queries afresh.')
    parser.add_argument('--learn_rate', default=1e-4, type=float)
    parser.add_argument('--lr_decay', default=0.3, type=float)
    parser.add_argument('--do_val_aug', default=True, type=_str2bool)
    parser.add_argument('--do_val_noaug', default=False, type=_str2bool)
    parser.add_argument('--val_every', default=2, type=int)
    parser.add_argument('--num_frames', default=24, type=int)
    parser.add_argument('--frame_height', default=240, type=int)
    parser.add_argument('--frame_width', default=320, type=int)
    parser.add_argument('--augs_2d', default=True, type=_str2bool)
    parser.add_argument('--kubric_frame_rate', default=12, type=int)
    parser.add_argument('--kubric_frame_stride', default=1, type=int)
    parser.add_argument('--kubric_max_delay', default=6, type=int)
    parser.add_argument('--kubric_reverse_prob', default=0.1, type=float)
    parser.add_argument('--kubric_palindrome_prob', default=0.1, type=float)
    parser.add_argument('--tracker_pretrained', default='1', type=str)
    parser.add_argument('--attention_type', default='divided_space_time', type=str,
                        choices=['divided_space_time', 'joint_space_time'])
    parser.add_argument('--patch_size', default=16, type=int)
    parser.add_argument('--causal_attention', default=1, type=int)
    parser.add_argument('--temporal_rope', default=0, type=int,
                        help='1: rotary (relative) time encoding on temporal attention; '
                             'requires training with the flag on.')
    parser.add_argument('--rope_time_coords', default=0, type=int,
                        help='1 (with --temporal_rope): feed TRUE source-frame timestamps '
                             'into the rotary tables (time-calibrated rope) — strided / '
                             'subsampled clips (stride augs, plugin usage modes) carry '
                             'their real temporal spacing instead of pretending to be '
                             'contiguous. Stored in seeker_args.')
    parser.add_argument('--rope_time_stretch', default=1.0, type=float,
                        help='> 1 (train, with --rope_time_coords): scale each example\'s '
                             'rope time coordinates by a random log-uniform factor in '
                             '[1, S] — a pure coordinate augmentation exercising LONG '
                             'relative offsets for far-past-horizon streaming.')
    parser.add_argument('--norm_embeddings', default=False, type=_str2bool)
    parser.add_argument('--drop_path_rate', default=0.1, type=float)
    parser.add_argument('--network_depth', default=12, type=int)
    parser.add_argument('--seeker_frames', default=[-1], type=int, nargs='+')
    parser.add_argument('--seeker_query_time', default=0.0, type=float)
    parser.add_argument('--gradient_clip', default=0.3, type=float)
    parser.add_argument('--optimizer', default='adamw', type=str,
                        choices=['sgd', 'adam', 'adamw', 'lamb'])
    parser.add_argument('--track_lw', default=1.0, type=float)
    parser.add_argument('--occl_mask_lw', default=0.5, type=float)
    parser.add_argument('--cont_mask_lw', default=0.5, type=float)
    parser.add_argument('--occluded_weight', default=5.0, type=float)
    parser.add_argument('--occl_cont_zero_weight', default=0.02, type=float)
    parser.add_argument('--class_balancing', default=True, type=_str2bool)
    parser.add_argument('--focal_loss', default=False, type=_str2bool)
    parser.add_argument('--aot_loss', default=0.8, type=float)
    parser.add_argument('--hard_negative_factor', default=3.0, type=float)
    parser.add_argument('--front_occl_thres', default=0.95, type=float)
    parser.add_argument('--outer_cont_thres', default=0.75, type=float)
    parser.add_argument('--max_objects', default=36, type=int,
                        help='Static instance-axis pad M (36 = the Kubric datasets\' '
                             'bound). Datasets with fewer instances can run a smaller M: '
                             'the batch ships B*M*T*H*W/8 packed mask bytes, so M=12 cuts '
                             'that transfer (and the collate memset) 3x. Scenes with more '
                             'than M instances are rejected at load time.')
    parser.add_argument('--remat', default=True, type=_str2bool,
                        help='Per-block rematerialization in the backward pass.')
    parser.add_argument('--remat_group', default=1, type=int,
                        help='Transformer blocks per checkpoint region (1 = per-block; '
                             'larger trades activation memory for less recompute).')
    args = parser.parse_args(argv)
    verify_args(args, is_train=True)
    return args


def test_args(argv=None):
    parser = argparse.ArgumentParser()
    shared_args(parser)
    parser.add_argument('--gpu_id', default=0, type=int)  # accepted, unused
    parser.add_argument('--plugin_frame_rate', default=30, type=int)
    parser.add_argument('--plugin_prefer_frame_stride', default=3, type=int)
    parser.add_argument('--center_crop', default=True, type=_str2bool)
    parser.add_argument('--store_results', default=False, type=_str2bool)
    parser.add_argument('--annots_must_exist', default=False, type=_str2bool)
    parser.add_argument('--extra_visuals', default=False, type=_str2bool)
    parser.add_argument('--stream_window', default=0, type=int,
                        help='>0: evaluate plugin videos by windowed streaming over every '
                             'frame, with a cache of this many frames.')
    parser.add_argument('--plugin_batch', default=4, type=int,
                        help='Usage modes evaluated per device step for plugin videos.')
    parser.add_argument('--test_device_batch', default=4, type=int,
                        help='Kubric test clips scored per device step (one batched '
                             'forward; per-clip losses, metrics and CSV rows).')
    parser.add_argument('--test_log_path', default='', type=str)
    args = parser.parse_args(argv)
    verify_args(args, is_train=False)
    return args


def _refuse_unported(args, is_train: bool):
    unported = [
        (not is_train and args.seq_shards > 1, '--seq_shards > 1 for evaluation',
         '7, sequence-parallel evaluation'),
        (not is_train and args.tp_shards > 1, '--tp_shards > 1 for evaluation',
         '7, tensor-parallel evaluation'),
        (not is_train and args.pp_stages > 1, '--pp_stages > 1 for evaluation',
         '7, pipeline-parallel evaluation'),
        (not is_train and args.mesh_devices > 1, '--mesh_devices > 1 for evaluation',
         '7, data-parallel evaluation'),
        (not is_train and bool(args.multihost), '--multihost for evaluation',
         '7, data-parallel evaluation'),
    ]
    for bad, flag, item in unported:
        if bad:
            raise NotImplementedError(f'{flag} is not ported to tcow_tpu_torch '
                                      f'(ROADMAP.md section 1 item {item})')
    if args.tp_shards > 1 or args.seq_shards > 1 or args.pp_stages > 1:
        _check_shards(args)


def _check_shards(args):
    '''Raises ValueError unless --tp_shards divides the backbone's width and MLP width,
    --seq_shards leaves every seq rank patches and frames (divided attention only: joint
    attention splits the clips, which may leave a rank padding), and seq_shards x
    tp_shards x pp_stages divides the world: --mesh_devices when given, else WORLD_SIZE
    under --multihost, else the one process (a world of -1 visible GPUs is checked when
    train_torch.py counts them).'''
    from tcow_tpu_torch.models.timesformer import DEPTH_PRESETS
    from tcow_tpu_torch.parallel.mesh import check_tp_widths
    from tcow_tpu_torch.parallel.sequence import check_seq_split
    tp, seq, pp = args.tp_shards, args.seq_shards, args.pp_stages
    if tp > 1:
        if args.network_depth not in DEPTH_PRESETS:
            raise ValueError(f'--network_depth {args.network_depth} has no width preset')
        width = DEPTH_PRESETS[args.network_depth][0]
        check_tp_widths(tp, width, 4 * width)
    if seq > 1 and args.attention_type == 'divided_space_time':
        check_seq_split((args.frame_height // args.patch_size)
                        * (args.frame_width // args.patch_size), args.num_frames, seq)
    world = (args.mesh_devices if args.mesh_devices > 0
             else int(os.environ.get('WORLD_SIZE', 1)) if args.multihost
             else None if args.device == 'cuda' else 1)
    if world is not None and world % (seq * tp * pp):
        what = ' x '.join(f'--{name} {n}' for name, n in (
            ('seq_shards', seq), ('tp_shards', tp), ('pp_stages', pp)) if n > 1)
        raise ValueError(f'{what} does not divide the world of {world} ranks')


def resolve_resume_path(checkpoint_root: str, resume: str, epoch: int = -1) -> str:
    '''--resume <name or file> -> the checkpoint to load: a file as given, else the
    experiment directory under checkpoint_root, preferring .npz to a reference .pth
    (model_{epoch} when epoch >= 0, else checkpoint; checkpoint.resolve_checkpoint_path).'''
    path = resume if os.path.isfile(resume) else os.path.join(checkpoint_root, resume)
    return ckpt_lib.resolve_checkpoint_path(path, epoch)


def verify_args(args, is_train: bool = False):
    '''Post-parse derivation (tcow_tpu/config.py:verify_args): the experiment name of a
    bare --resume (train), the debug flag, the test batch from --test_device_batch, the
    worker count, the resolved resume path, and the checkpoint and log directories; a
    test run logs under <log_root>/<resumed experiment>/test_<name>_e<epoch>.'''
    _refuse_unported(args, is_train)
    if is_train and args.resume != '' and args.name == '':
        # Continue the SAME experiment: under the resumed run's own name, or for a
        # checkpoint FILE path under its directory's basename.
        if os.path.isfile(args.resume):
            args.name = os.path.basename(os.path.dirname(os.path.abspath(
                args.resume))) or 'resume'
        else:
            args.name = args.resume
    args.is_debug = args.name.startswith('d')
    args.wandb_group = ('train' if is_train else 'test') + ('_debug' if args.is_debug else '')

    if is_train:
        if not args.occl_cont_zero_weight < 0.5:
            raise ValueError('--occl_cont_zero_weight must be < 0.5')
    else:
        # K clips share one device step; losses and metrics stay per clip.
        args.batch_size = max(1, int(getattr(args, 'test_device_batch', 4)))

    if args.num_workers < 0:
        if is_train:
            frac = 0.30 if args.is_debug else 0.45
            sub = 4 if args.is_debug else 6
            args.num_workers = max(int(mp.cpu_count() * frac) - sub, 4)
        else:
            args.num_workers = 4
        args.num_workers = min(args.num_workers, 80)
    args.num_workers = int(args.num_workers)

    if args.name != '':
        resume_name = args.resume
        if args.resume != '':
            args.resume = resolve_resume_path(args.checkpoint_root, args.resume, args.epoch)
        if is_train:
            args.checkpoint_path = os.path.join(args.checkpoint_root, args.name)
            args.train_log_path = os.path.join(args.log_root, args.name)
            os.makedirs(args.checkpoint_path, exist_ok=True)
            os.makedirs(args.train_log_path, exist_ok=True)
            args.log_path = args.train_log_path
        else:
            if args.resume == '':
                raise ValueError('a test run needs --resume')
            if os.path.isfile(resume_name):
                # --resume may be a checkpoint file: log under its directory's name.
                resume_name = os.path.basename(os.path.dirname(os.path.abspath(
                    resume_name))) or 'resume'
            args.checkpoint_path = os.path.join(args.checkpoint_root, resume_name)
            args.train_log_path = os.path.join(args.log_root, resume_name)
            os.makedirs(args.train_log_path, exist_ok=True)
            args.name += f'_e{ckpt_lib.get_checkpoint_epoch(args.resume)}'
            args.test_log_path = os.path.join(args.train_log_path, 'test_' + args.name)
            args.log_path = args.test_log_path
            os.makedirs(args.test_log_path, exist_ok=True)


def args_to_dict(args) -> Dict[str, Any]:
    return {k: v for k, v in vars(args).items()}


def build_seeker_args(args) -> Dict[str, Any]:
    '''The seeker_args dict embedded in checkpoints.'''
    max_seeker_frames = max(args.seeker_frames)
    if max_seeker_frames < 0 or max_seeker_frames > args.num_frames:
        max_seeker_frames = args.num_frames
    return dict(
        num_total_frames=args.num_frames,
        num_visible_frames=max_seeker_frames,
        frame_height=args.frame_height,
        frame_width=args.frame_width,
        tracker_pretrained=args.tracker_pretrained,
        attention_type=args.attention_type,
        patch_size=args.patch_size,
        causal_attention=args.causal_attention,
        temporal_rope=int(getattr(args, 'temporal_rope', 0)),
        rope_time_coords=int(getattr(args, 'rope_time_coords', 0)),
        norm_embeddings=args.norm_embeddings,
        drop_path_rate=args.drop_path_rate,
        network_depth=args.network_depth,
        track_map_stride=4,
        track_map_resize='bilinear',
        query_channels=1,
        output_channels=3,
        flag_channels=3,
    )
