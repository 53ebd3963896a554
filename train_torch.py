'''
Training CLI of the PyTorch port: parses the train flags (tcow_tpu_torch/config.py, the
JAX package's train flags) and runs tcow_tpu_torch.train.driver.main on the GPU, or on
the CPU with --device cpu. train.py stays the JAX package's.

Data parallelism: --mesh_devices N (default -1: every visible GPU, one process on the CPU)
starts N ranks of this command on this host, rank i on cuda:i (N CPU ranks under --device
cpu), each with --multihost 1 and RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT (a free port) set; N shrinks until it divides batch_size / grad_accum. A rank
that fails stops the others and the command exits with its code; SIGTERM is passed on to
every rank (rank 0's decides). --multihost 1 runs this process as one rank of a world its
launcher (torchrun, or the lines above) describes in those variables. Rank 0 logs under
--log_path, rank r under <log_path>/rank<r>.

Sequence and tensor parallelism: --seq_shards S and --tp_shards M split the N ranks into
N / (S M) data rows of S x M ranks that share the rows of the batch: the S seq ranks of a
row split the patches and frames inside the blocks, the M model ranks hold shards of the
block weights; the data rows shrink until they divide batch_size / grad_accum, and N
becomes their count times S x M. On the CPU:
  python train_torch.py --device cpu --mesh_devices 2 --seq_shards 2 ...
  python train_torch.py --device cpu --mesh_devices 4 --seq_shards 2 --tp_shards 2 ...

Joint attention (--attention_type joint_space_time) under --seq_shards S splits the folded
clips of a data row over its S seq ranks, zero-padded to a multiple of S. On the CPU:
  python train_torch.py --device cpu --mesh_devices 2 --seq_shards 2 \
      --attention_type joint_space_time ...

Pipeline parallelism: --pp_stages P splits each data row's blocks into P stages, one a
rank, with --pp_microbatches M microbatches a step (0: the JAX default) and --seq_shards
and --tp_shards beside it (each data row then seq_shards x tp_shards x pp_stages ranks);
--pp_manual 1 parses on every layout, as the JAX CLI's does, and runs the same schedule.
On the CPU:
  python train_torch.py --device cpu --mesh_devices 2 --pp_stages 2 ...
  python train_torch.py --device cpu --mesh_devices 4 --seq_shards 2 --pp_stages 2 ...
  python train_torch.py --device cpu --mesh_devices 8 --tp_shards 2 --pp_stages 2 ...

Example (the configuration of record):
  python train_torch.py --name v1 --data_path /path/to/kubric_random/ --batch_size 2 \
      --num_queries 3 --num_frames 30 --causal_attention 1
On two GPUs of one host: the same with --mesh_devices 2 (or torchrun --nproc_per_node 2
train_torch.py ... --multihost 1); add --seq_shards 2 (or --tp_shards 2) for one data row
of two sequence- (or tensor-) parallel ranks, or --pp_stages 2 for two pipeline stages;
on four, --seq_shards 2 --pp_stages 2.
A synthetic Kubric-format dataset: python -m tcow_tpu_torch.data.synthetic --out DIR
'''

import os
import signal
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Seconds a rank has to leave after SIGTERM once another rank has failed.
STOP_GRACE_S = 30


def ranks_to_start(args, logger) -> int:
    '''How many ranks --mesh_devices asks of this host: -1 means every visible GPU (one
    on the CPU); more GPUs than the host has raises, and so does a count that
    --seq_shards x --tp_shards x --pp_stages does not divide; the data rows (the count /
    that product) shrink, with a warning, until they divide batch_size / grad_accum
    (tcow_tpu/train/driver.py:186-199), and the count is their number times the
    product.'''
    import torch
    n = args.mesh_devices
    if args.device == 'cuda':
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f'--mesh_devices {n} but this host has {have} CUDA devices')
        n = have if n <= 0 else n
    n = max(n, 1)
    row = (max(1, int(args.tp_shards)) * max(1, int(args.seq_shards))
           * max(1, int(args.pp_stages)))
    if n % row:
        raise ValueError(f'--seq_shards {args.seq_shards} x --tp_shards {args.tp_shards} x '
                         f'--pp_stages {args.pp_stages} do not divide the {n} ranks')
    rows = args.batch_size // max(1, int(args.grad_accum))
    n_data = n // row
    while rows % n_data:
        n_data -= 1
    if n_data * row != n:
        logger.warning(f'Using {n_data * row}/{n} devices so the data axis ({n_data}) '
                       f'divides batch_size / grad_accum ({rows}).')
    return n_data * row


def launch_ranks(command, world: int, logger) -> int:
    '''Runs `command` (this run's command line) as `world` ranks with --multihost 1 and
    returns the exit code: 0 when every rank succeeded, else the first failure's (the
    others are stopped).'''
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR='127.0.0.1')
    from tcow_tpu_torch.parallel.mesh import free_port
    env['MASTER_PORT'] = str(free_port())
    cmd = [*command, '--mesh_devices', str(world), '--multihost', '1']
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(world)]
    logger.info(f'Started {world} ranks: pids {[p.pid for p in procs]}')

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)
    old = signal.signal(signal.SIGTERM, forward)
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                logger.error(f'A rank exited with {failed[0]}: stopping the others.')
                _stop(procs)
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.2)
    finally:
        signal.signal(signal.SIGTERM, old)
        _stop(procs)


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def main(argv=None):
    from tcow_tpu_torch import config as config_lib
    from tcow_tpu_torch.train import driver
    from tcow_tpu_torch.utils.logvis import MyLogger

    # Each rank runs the command that started this one: the interpreter's own command line
    # for a CLI run (options and `-c` code included), this script for a call with argv.
    command = ([sys.executable, *sys.orig_argv[1:]] if argv is None
               else [sys.executable, os.path.abspath(__file__), *argv])
    argv = sys.argv[1:] if argv is None else list(argv)
    args = config_lib.train_args(argv)
    rank = int(os.environ.get('RANK', 0)) if args.multihost else 0
    log_dir = args.log_path if rank == 0 else os.path.join(args.log_path, f'rank{rank}')
    logger = MyLogger(args, context='train', log_dir=log_dir)
    try:
        if not args.multihost:
            world = ranks_to_start(args, logger)
            if world > 1:
                return launch_ranks(command, world, logger)
        logger.info(f'Args: {vars(args)}')
        driver.main(args, logger)
        logger.info('Finished train_torch.py')
        return 0
    except Exception as e:
        logger.exception(e)
        raise
    finally:
        logger.close()


if __name__ == '__main__':
    sys.exit(main())
