'''
The port's multi-process training CLI on the CPU: `train_torch.py --device cpu
--mesh_devices 2` starts two gloo ranks (one intra-op thread each) that train a tiny seeker
(depth 2 at width 32, T = 6 at 32 x 48, f32) on a synthetic Kubric set for two epochs with
validation. A SIGTERM to rank 0 during epoch 0 stops both ranks after the same step with
one mid-epoch checkpoint from rank 0; the --resume relaunch (its two ranks started with
--multihost 1, as torchrun would start them) completes the exact step count
and ends with the parameters and AdamW moments of an uninterrupted two-rank run, bit for
bit (tests/test_multiprocess.py:test_multihost_driver_preempt_and_exact_step_resume is
the JAX package's counterpart).

`train_torch.py --device cpu --mesh_devices 2 --tp_shards 2` runs the two ranks as one
data row of two tensor-parallel ranks: one epoch, and its checkpoint in the one-process
layout, against the one-process run of the same flags.

The ranks run the test's own command line (train_torch.py's launcher starts each rank
with the interpreter's arguments), which registers the tiny width before calling
train_torch.main().
'''

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import conftest
from tcow_tpu_torch.data import synthetic as psyn
from tcow_tpu_torch.parallel import mesh as pmesh
from tcow_tpu_torch.train import checkpoint as pckpt

# Seconds one two-rank run may take (imports, rendezvous, 8 train and 2 val steps).
RUN_TIMEOUT_S = 120
STEPS_PER_EPOCH = 4      # 8 scenes in global batches of 2
STEP_STATS = re.compile(r'step_stats (\{.*\})')
LAUNCH = ("import sys; sys.path.insert(0, {repo!r}); "
          "from tcow_tpu_torch.models import timesformer; "
          "timesformer.DEPTH_PRESETS[2] = (32, 4); "
          "import train_torch; sys.exit(train_torch.main())")


@pytest.fixture(scope='module')
def kubric_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('kub_mp')
    for split, n, seed in (('train', 2 * STEPS_PER_EPOCH, 17), ('val', 2, 29)):
        psyn.write_synthetic_kubric_dataset(str(root / split), num_scenes=n, seed=seed,
                                            T=8, H=48, W=64, K=4)
    return str(root)


def train_argv(root, tmp_path, name, *extra):
    return ['--name', name, '--data_path', root,
            '--checkpoint_root', str(tmp_path / 'checkpoints'),
            '--log_root', str(tmp_path / 'logs'),
            '--batch_size', '2', '--num_queries', '2', '--num_frames', '6',
            '--frame_height', '32', '--frame_width', '48', '--kubric_max_delay', '2',
            '--num_epochs', '2', '--val_every', '1',
            '--tracker_pretrained', '0', '--network_depth', '2', '--num_workers', '1',
            '--compute_dtype', 'float32', '--seed', '3', '--device', 'cpu',
            '--avoid_wandb', '2', '--log_level', 'debug', '--mesh_devices', '2', *extra]


def start(argv, **env_extra):
    env = dict(os.environ, OMP_NUM_THREADS='1', **env_extra)
    env.pop('PYTHONPATH', None)
    return subprocess.Popen([sys.executable, '-c', LAUNCH.format(repo=conftest.REPO_ROOT),
                             *argv], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def start_ranks(argv):
    '''The two ranks of argv with --multihost 1, started as torchrun would start them.'''
    env = dict(WORLD_SIZE='2', MASTER_ADDR='127.0.0.1', MASTER_PORT=str(pmesh.free_port()))
    return [start([*argv, '--multihost', '1'], RANK=str(r), LOCAL_RANK=str(r), **env)
            for r in range(2)]


def finish(proc, deadline):
    try:
        out = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-6000:]
    assert 'Traceback' not in out, out[-6000:]
    return out


def rank_logs(tmp_path, name):
    d = tmp_path / 'logs' / name
    return [(d / 'train.log').read_text(), (d / 'rank1' / 'train.log').read_text()]


def train_steps(log_text):
    recs = [json.loads(m.group(1)) for m in STEP_STATS.finditer(log_text)]
    return [r for r in recs if r['phase'] == 'train']


def checkpoint_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != '__meta__'}


def test_two_ranks_preempt_and_resume_exactly(kubric_root, tmp_path):
    '''The uninterrupted run (no validation, which changes no state) runs beside the
    preempted one.'''
    whole_deadline = time.monotonic() + 2 * RUN_TIMEOUT_S
    whole = start(train_argv(kubric_root, tmp_path, 'mpwhole', '--do_val_aug', '0'))
    deadline = time.monotonic() + RUN_TIMEOUT_S
    proc = start(train_argv(kubric_root, tmp_path, 'mppre', '--do_val_aug', '1'))
    log0 = tmp_path / 'logs' / 'mppre' / 'train.log'
    pids = None
    while time.monotonic() < deadline and proc.poll() is None:
        text = log0.read_text() if log0.exists() else ''
        m = re.search(r'Started 2 ranks: pids \[(\d+), (\d+)\]', text)
        pids = pids or (m and [int(m.group(1)), int(m.group(2))])
        if pids and train_steps(text):
            os.kill(pids[0], signal.SIGTERM)   # rank 0 alone
            break
        time.sleep(0.02)
    finish(proc, deadline)
    logs = rank_logs(tmp_path, 'mppre')
    last = [train_steps(t)[-1] for t in logs]
    assert [(r['rank'], r['world'], r['backend']) for r in last] == [
        (0, 2, 'gloo'), (1, 2, 'gloo')]
    assert last[0]['epoch'] == last[1]['epoch'] == 0
    assert last[0]['step'] == last[1]['step'] < STEPS_PER_EPOCH - 1, last
    for t in logs:
        assert 'stopping after step' in t
    ckpt = tmp_path / 'checkpoints' / 'mppre'
    assert sorted(f.name for f in ckpt.glob('*.npz')) == ['checkpoint.npz']
    meta = pckpt.peek_meta(str(ckpt / 'checkpoint.npz'))
    assert meta['partial'] and meta['steps_done_in_epoch'] == last[0]['step'] + 1
    assert len(meta['loader_state']['train_collate_rng_by_rank']) == 2

    # The resume: its two ranks started directly, as torchrun starts them.
    deadline = time.monotonic() + RUN_TIMEOUT_S
    for rank in start_ranks(train_argv(kubric_root, tmp_path, 'mppre', '--do_val_aug', '1',
                                       '--resume', 'mppre')):
        finish(rank, deadline)
    logs = rank_logs(tmp_path, 'mppre')
    for rank, t in enumerate(logs):
        done = [(r['epoch'], r['step']) for r in train_steps(t)]
        assert done == [(e, s) for e in range(2) for s in range(STEPS_PER_EPOCH)], done
        # Rank 0 alone ran the vis step (global step 0); both ran each epoch's val step.
        others = [(r['phase'], r['epoch']) for r in map(json.loads, STEP_STATS.findall(t))
                  if r['phase'] != 'train']
        assert others == [('vis', 0)] * (rank == 0) + [('val_aug', 0), ('val_aug', 1)], others
    finish(whole, whole_deadline)
    want = checkpoint_arrays(tmp_path / 'checkpoints' / 'mpwhole' / 'checkpoint.npz')
    got = checkpoint_arrays(ckpt / 'checkpoint.npz')
    assert set(got) == set(want)
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not differ, differ[:5]


def test_tensor_parallel_ranks_train_and_write_one_process_checkpoint(kubric_root, tmp_path):
    '''--tp_shards 2 over --mesh_devices 2: both ranks hold data row 0 (model ranks 0 and
    1) and take the epoch's 4 steps and the vis step; rank 0 writes the checkpoint in the
    one-process layout (full-width block weights and AdamW moments), which loads into a
    one-process state and is within 5e-6 of the one-process run's (the same batches and
    masks; only the order of the sums differs).'''
    deadline = time.monotonic() + RUN_TIMEOUT_S
    extra = ('--num_epochs', '1', '--do_val_aug', '0')
    one = start(train_argv(kubric_root, tmp_path, 'mptp1', *extra, '--mesh_devices', '1'))
    proc = start(train_argv(kubric_root, tmp_path, 'mptp', *extra, '--tp_shards', '2'))
    finish(proc, deadline)
    finish(one, deadline)
    for rank, t in enumerate(rank_logs(tmp_path, 'mptp')):
        recs = [json.loads(m.group(1)) for m in STEP_STATS.finditer(t)]
        assert {(r['rank'], r['world'], r['data_rank'], r['model_rank']) for r in recs} == {
            (rank, 2, 0, rank)}
        assert [(r['phase'], r['step']) for r in recs] == [
            ('train', 0), ('vis', 0), *[('train', s) for s in range(1, STEPS_PER_EPOCH)]]
    ckpt = tmp_path / 'checkpoints' / 'mptp' / 'checkpoint.npz'
    got = checkpoint_arrays(ckpt)
    want = checkpoint_arrays(tmp_path / 'checkpoints' / 'mptp1' / 'checkpoint.npz')
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=5e-6, err_msg=k)
    assert got["params['backbone']['blocks']['mlp']['fc1']['w']"].shape == (2, 32, 128)
    assert pckpt.load_checkpoint(str(ckpt))['params']['backbone']['blocks']['attn']['qkv'][
        'w'].shape == (2, 32, 96)
