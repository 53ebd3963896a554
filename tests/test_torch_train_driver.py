'''
The port's training driver on the CPU (depth 2, float32, 32x48 clips of a synthetic
Kubric dataset written by the port), mirroring tests/test_train_driver.py: train + val +
resume, a preemption at mid-epoch whose resume equals the uninterrupted run bit for bit,
the light-resume gate with the full-snapshot fallback, the exception budget and the 'ba'
save, unported flags raising, the host->device prefetcher, and one end-to-end parity
test: tcow_tpu's driver and the port's driver from the same JAX 'ba' checkpoint, one epoch
of two steps on the same dataset, per-step losses, gradient norms and final parameters.
'''

import json
import os
import pickle
import signal
import sys
import time
import types

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu_torch import config as pconfig
from tcow_tpu_torch.data import synthetic as psyn
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import driver as pdriver
from tcow_tpu_torch.utils.logvis import MyLogger

# The tolerances of tests/test_torch_train_step.py (f32 on the CPU, the two packages sum
# in other orders): losses, gradient norms, parameters after AdamW updates. Measured by
# the parity test: 3.4e-7 / 8.1e-7 relative, 2.4e-7 absolute.
LOSS_RTOL = 1e-5
NORM_RTOL = 5e-5
PARAM_ATOL = 5e-6


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('kubric_port4')
    psyn.write_synthetic_kubric_dataset(str(root), num_scenes=4, seed=11, T=8, H=48, W=64,
                                        K=4)
    return str(root)


@pytest.fixture(scope='module')
def synth_root6(tmp_path_factory):
    root = tmp_path_factory.mktemp('kubric_port6')
    psyn.write_synthetic_kubric_dataset(str(root), num_scenes=6, seed=13, T=8, H=48, W=64,
                                        K=4)
    return str(root)


@pytest.fixture
def tiny(monkeypatch):
    '''Depth 2 at width 32, and one intra-op thread: the loader's worker threads run
    numpy beside the step, and several spinning intra-op threads beside them slow the
    CPU step by orders of magnitude.'''
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, 2, (32, 4))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_args(root, tmp_path, name='pdrv1', resume='', extra=()):
    argv = ['--name', name, '--data_path', root,
            '--checkpoint_root', str(tmp_path / 'checkpoints'),
            '--log_root', str(tmp_path / 'logs'),
            '--batch_size', '2', '--num_queries', '2', '--num_frames', '6',
            '--frame_height', '32', '--frame_width', '48', '--kubric_max_delay', '2',
            '--num_epochs', '2', '--val_every', '1', '--do_val_aug', '1',
            '--tracker_pretrained', '0', '--network_depth', '2', '--num_workers', '2',
            '--compute_dtype', 'float32', '--seed', '3', '--device', 'cpu',
            '--avoid_wandb', '2', *extra]
    if resume:
        argv += ['--resume', resume]
    return pconfig.train_args(argv)


def run(args):
    logger = MyLogger(args, context='train')
    try:
        return pdriver.main(args, logger)
    finally:
        logger.close()


def load_flat(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != '__meta__'}


class _FakeWandb(types.ModuleType):
    '''Stand-in for the wandb package (absent here) to check the online-logging contract
    (--avoid_wandb 0/1/2).'''

    def __init__(self):
        super().__init__('wandb')
        self.init_calls = []
        self.logged = []
        self.run = types.SimpleNamespace(summary={})

    def init(self, **kw):
        self.init_calls.append(kw)

    def log(self, payload, step=None):
        self.logged.append(payload)


def test_port_driver_trains_validates_and_resumes(synth_root, tmp_path, tiny, monkeypatch):
    fake_wandb = _FakeWandb()
    monkeypatch.setitem(sys.modules, 'wandb', fake_wandb)
    args = make_args(synth_root, tmp_path, extra=['--avoid_wandb', '0', '--do_val_noaug', '1',
                                                  '--log_level', 'debug'])
    state = run(args)
    assert state.step == 2 * 2          # 4 scenes / batch 2 = 2 steps x 2 epochs
    assert state.optimizer.count == 4
    assert fake_wandb.init_calls and fake_wandb.init_calls[0]['project'] == 'tcow'
    assert any('train/loss_total_seeker' in d for d in fake_wandb.logged)

    ckpt_dir = tmp_path / 'checkpoints' / 'pdrv1'
    assert (ckpt_dir / 'checkpoint.npz').exists() and (ckpt_dir / 'model_0.npz').exists()
    assert int((ckpt_dir / 'checkpoint_epoch.txt').read_text()) == 1
    meta = pckpt.peek_meta(str(ckpt_dir / 'checkpoint.npz'))
    assert meta['opt_restored'] and not meta['partial'] and meta['epoch'] == 1
    log_dir = tmp_path / 'logs' / 'pdrv1'
    rows = [json.loads(line) for line in (log_dir / 'scalars.jsonl').read_text().splitlines()]
    for phase in ('train', 'val_aug', 'val_noaug'):
        losses = [r[f'{phase}/loss_total_seeker'] for r in rows
                  if f'{phase}/loss_total_seeker' in r]
        assert len(losses) == 2 and np.all(np.isfinite(losses)), phase
        assert any(f'{phase}/loader_wait_frac' in r for r in rows)
    assert (log_dir / 'args_train.txt').exists() and (log_dir / 'train.log').exists()
    # At log level debug, one step_stats line per step and per vis step (global step 0),
    # in order; the CPU launches no kernel.
    stats = [json.loads(line.split('step_stats ', 1)[1]) for line in
             (log_dir / 'train.log').read_text().splitlines() if 'step_stats ' in line]
    val = [(phase, step) for phase in ('val_aug', 'val_noaug') for step in (0, 1)]
    assert [(r['phase'], r['epoch'], r['step']) for r in stats] == [
        ('train', 0, 0), ('vis', 0, 0), ('train', 0, 1), *[(p, 0, s) for p, s in val],
        ('train', 1, 0), ('train', 1, 1), *[(p, 1, s) for p, s in val]]
    assert all(r['launches'] == {} and r['wall_ms'] > 0 for r in stats)
    # The vis step's overlay videos: input, heat map, three channels, loss weights and,
    # where the query has a target, the ground truth, for each of the 2 queries.
    videos = sorted(f.name for f in (log_dir / 'visuals').iterdir())
    for q in (0, 1):
        for kind in ('in', 'out_sn', 'out_oc', 'slw'):
            assert any(v.startswith(f'e0_ptrain_s0_q{q}_{kind}.') for v in videos), videos
    assert 'overlay rendering failed' not in (log_dir / 'train.log').read_text()

    # Resume under the same name: the schedule is done, nothing runs.
    state2 = run(make_args(synth_root, tmp_path, resume='pdrv1'))
    assert state2.step == state.step


def test_port_preempted_run_resumes_bit_equal(synth_root6, tmp_path, tiny, monkeypatch):
    '''SIGTERM during epoch 0: the driver finishes the step in flight, writes a FULL
    mid-epoch checkpoint and exits; --resume continues at that step. Drop-path is on, so
    the generator's state matters. The resumed run ends with the parameters, AdamW
    moments, counts and generator of the uninterrupted run, bit for bit.'''
    run(make_args(synth_root6, tmp_path, name='puni'))

    calls = []
    real_log = pdriver._log_step_scalars

    def log_and_signal(*a, **kw):
        # One-step lag: the first call, right after step 1, logs step 0, so the signal
        # lands before step 1's preemption check.
        calls.append(1)
        if len(calls) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return real_log(*a, **kw)

    monkeypatch.setattr(pdriver, '_log_step_scalars', log_and_signal)
    prev = signal.getsignal(signal.SIGTERM)
    state = run(make_args(synth_root6, tmp_path, name='ppre'))
    assert state.step == 2
    assert signal.getsignal(signal.SIGTERM) is prev
    ckpt_dir = tmp_path / 'checkpoints' / 'ppre'
    loaded = pckpt.load_checkpoint(str(ckpt_dir / 'checkpoint.npz'))
    assert loaded['partial'] is True
    assert loaded['epoch'] == 0 and loaded['steps_done_in_epoch'] == 2
    assert loaded['opt_restored'] is True
    assert len(loaded['loader_state']['train_collate_rng_by_rank']) == 1
    assert not (ckpt_dir / 'model_0.npz').exists()

    monkeypatch.setattr(pdriver, '_log_step_scalars', real_log)
    state2 = run(make_args(synth_root6, tmp_path, name='ppre', resume='ppre'))
    assert state2.step == 6            # 1 step left of epoch 0 + 3 of epoch 1
    want = load_flat(str(tmp_path / 'checkpoints' / 'puni' / 'checkpoint.npz'))
    got = load_flat(str(ckpt_dir / 'checkpoint.npz'))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    final = pckpt.peek_meta(str(ckpt_dir / 'checkpoint.npz'))
    assert final['partial'] is False and final['epoch'] == 1


def _set_loader_state(path, loader_state):
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(payload['__meta__'].tobytes())
    meta['loader_state'] = loader_state
    payload['__meta__'] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **payload)


def test_port_resume_checks_the_loader_state_s_world_size(synth_root, tmp_path, tiny):
    '''The checkpoint holds one query stream a rank. A one-process resume of two ranks'
    streams raises unless --allow_opt_reinit (queries then sampled afresh); a checkpoint
    written before ranks (one 'train_collate_rng') still resumes.'''
    one_epoch = ('--num_epochs', '1', '--do_val_aug', '0')
    run(make_args(synth_root, tmp_path, name='pws', extra=one_epoch))
    path = str(tmp_path / 'checkpoints' / 'pws' / 'checkpoint.npz')
    stream, = pckpt.peek_meta(path)['loader_state']['train_collate_rng_by_rank']
    _set_loader_state(path, {'train_collate_rng_by_rank': [stream, stream]})
    with pytest.raises(ValueError, match='loader state of 2 rank'):
        run(make_args(synth_root, tmp_path, name='pws', resume='pws', extra=one_epoch))
    run(make_args(synth_root, tmp_path, name='pws', resume='pws',
                  extra=(*one_epoch, '--allow_opt_reinit', '1')))
    _set_loader_state(path, {'train_collate_rng': stream})
    run(make_args(synth_root, tmp_path, name='pws', resume='pws', extra=one_epoch))


def test_port_light_resume_gate_and_full_snapshot_fallback(synth_root, tmp_path, tiny):
    args = make_args(synth_root, tmp_path, name='plg1', extra=['--checkpoint_every', '1',
                                                              '--do_val_aug', '0'])
    run(args)
    ckpt_dir = tmp_path / 'checkpoints' / 'plg1'
    full = pckpt.load_checkpoint(str(ckpt_dir / 'checkpoint.npz'))
    pckpt.save_checkpoint(str(ckpt_dir), epoch=full['epoch'], name='plg1',
                          params=full['params'], checkpoint_every=10 ** 6)
    assert pckpt.peek_meta(str(ckpt_dir / 'checkpoint.npz'))['light']

    # Fallback: resume loads the newest full snapshot (model_1.npz): nothing left to run.
    state = run(make_args(synth_root, tmp_path, name='plg1', resume='plg1',
                          extra=['--do_val_aug', '0']))
    assert state.step == 4 and state.optimizer.count == 4

    for f in os.listdir(ckpt_dir):
        if f.startswith('model_'):
            os.remove(ckpt_dir / f)
    with pytest.raises(ValueError, match='allow_opt_reinit'):
        run(make_args(synth_root, tmp_path, name='plg1', resume='plg1',
                      extra=['--do_val_aug', '0']))
    state = run(make_args(synth_root, tmp_path, name='plg1', resume='plg1',
                          extra=['--do_val_aug', '0', '--allow_opt_reinit', '1']))
    assert state.step == 0 and state.optimizer.count == 0   # params only; nothing ran


def test_port_exception_budget_and_ba_save(synth_root, tmp_path, tiny, monkeypatch):
    '''A '*ba*' run saves before training (model_-1.npz, the untrained state); a failed
    step is logged and skipped; the 20th failure in an epoch raises.'''
    from tcow_tpu_torch.train import step as pstep
    real = pstep.make_train_step
    failures = []

    def flaky(cfg, grad_accum=1, mesh=None):
        step = real(cfg, grad_accum, mesh)

        def wrapped(state, batch, progress):
            if not failures:
                failures.append(1)
                raise RuntimeError('injected step failure')
            return step(state, batch, progress)
        return wrapped

    monkeypatch.setattr(pstep, 'make_train_step', flaky)
    state = run(make_args(synth_root, tmp_path, name='pba1', extra=['--do_val_aug', '0']))
    assert state.step == 3                 # 4 steps, the first failed
    snap = pckpt.load_checkpoint(str(tmp_path / 'checkpoints' / 'pba1' / 'model_-1.npz'))
    assert snap['epoch'] == -1 and snap['opt_restored']

    def broken(cfg, grad_accum=1, mesh=None):
        def step(state, batch, progress):
            raise RuntimeError('always fails')
        return step

    monkeypatch.setattr(pstep, 'make_train_step', broken)
    monkeypatch.setattr(pdriver, 'MAX_EXCEPTIONS_PER_EPOCH', 2)
    with pytest.raises(RuntimeError, match='always fails'):
        run(make_args(synth_root, tmp_path, name='pbud', extra=['--do_val_aug', '0']))


@pytest.mark.parametrize('flags,world,error', [
    (['--mesh_devices', '4', '--seq_shards', '2', '--pp_stages', '2'], None, None),
    (['--mesh_devices', '2', '--seq_shards', '2', '--attention_type', 'joint_space_time'],
     None, None),
    (['--multihost', '1', '--tp_shards', '2', '--seq_shards', '2', '--pp_stages', '2'], 8,
     None),
    (['--mesh_devices', '2', '--seq_shards', '2', '--pp_stages', '2'], None,
     '--seq_shards 2 x --pp_stages 2 does not divide the world of 2 ranks'),
    (['--multihost', '1', '--tp_shards', '2', '--seq_shards', '2', '--pp_stages', '2'], 4,
     'does not divide the world of 4 ranks')])
def test_port_parallel_layouts_parse_when_they_divide(synth_root, tmp_path, monkeypatch,
                                                      flags, world, error):
    '''Data parallelism (--mesh_devices, --multihost) parses, and so do the pipeline layout
    beside sequence parallelism, alone or beside tensor parallelism, and joint attention
    under sequence parallelism, when their product divides the world (--mesh_devices, or
    WORLD_SIZE under --multihost); else ValueError.'''
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, 2, (32, 4))   # the width tp_shards divides
    if world is not None:
        monkeypatch.setenv('WORLD_SIZE', str(world))
    if error is not None:
        with pytest.raises(ValueError, match=error):
            make_args(synth_root, tmp_path, extra=flags)
        return
    args = make_args(synth_root, tmp_path, extra=flags)
    assert (args.seq_shards, args.attention_type == 'joint_space_time') == (
        2, 'joint_space_time' in flags)
    dp = [f for f in flags if f in ('--mesh_devices', '--multihost')]
    make_args(synth_root, tmp_path, extra=[dp[0], flags[flags.index(dp[0]) + 1]])


@pytest.mark.parametrize('flags', [
    ['--mesh_devices', '2', '--pp_stages', '2'],
    ['--mesh_devices', '4', '--tp_shards', '2', '--pp_stages', '2']])
def test_port_pipeline_flags_parse(synth_root, tmp_path, monkeypatch, flags):
    '''The pipeline layout parses for training, alone or beside tensor parallelism, when
    the world (--mesh_devices) holds its stages.'''
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, 2, (32, 4))   # the width tp_shards divides
    args = make_args(synth_root, tmp_path, extra=flags)
    assert (args.pp_stages, args.tp_shards) == (2, 2 if '--tp_shards' in flags else 1)


def test_port_pipeline_evaluation_raises():
    '''Pipeline-parallel evaluation is not queued: the eval flags raise, naming ROADMAP
    item 7, as data-, tensor- and sequence-parallel evaluation do.'''
    with pytest.raises(NotImplementedError, match='ROADMAP.md section 1 item 7'):
        pconfig.test_args(['--data_path', 'x', '--device', 'cpu', '--pp_stages', '2'])


def test_port_driver_trains_with_host_colour_augs(synth_root, tmp_path, tiny):
    '''--device_augs 0, the host colour path: one epoch of two steps, colour applied by
    the loader, finite losses, and the dataset arguments in the checkpoint say so.'''
    args = make_args(synth_root, tmp_path, name='phost',
                     extra=['--device_augs', '0', '--num_epochs', '1', '--do_val_aug', '0'])
    state = run(args)
    assert state.step == 2 and state.optimizer.count == 2
    ckpt = pckpt.load_checkpoint(str(tmp_path / 'checkpoints' / 'phost' / 'checkpoint.npz'))
    assert ckpt['dset_args']['kubric']['device_color_jitter'] is False
    rows = [json.loads(line) for line in
            (tmp_path / 'logs' / 'phost' / 'scalars.jsonl').read_text().splitlines()]
    losses = [r['train/loss_total_seeker'] for r in rows if 'train/loss_total_seeker' in r]
    assert len(losses) == 1 and np.all(np.isfinite(losses))


def test_port_pth_resume_and_pretrained_path_raise(synth_root, tmp_path, tiny):
    '''A reference .pth resolves as --resume (by directory or file) and then needs
    --allow_opt_reinit, as in JAX; a --tracker_pretrained file that is no torch
    checkpoint raises from torch.load.'''
    pth = tmp_path / 'checkpoints' / 'pth1' / 'checkpoint.pth'
    pth.parent.mkdir(parents=True)
    torch.save({'epoch': 0}, pth)
    for resume in ('pth1', str(pth)):
        args = make_args(synth_root, tmp_path, name='pth2', resume=resume)
        assert args.resume == str(pth)
        with pytest.raises(ValueError, match='--allow_opt_reinit 1'):
            run(args)
    junk = tmp_path / 'junk.pth'
    junk.write_bytes(b'not a checkpoint')
    args = make_args(synth_root, tmp_path, name='pth3',
                     extra=['--tracker_pretrained', str(junk)])
    with pytest.raises(pickle.UnpicklingError):
        run(args)


def test_port_driver_picks_the_attention_mode_by_device(synth_root, tmp_path):
    args = make_args(synth_root, tmp_path)
    seeker_args = pconfig.build_seeker_args(args)
    cpu = pdriver.build_seeker_config(args, seeker_args, torch.device('cpu'))
    gpu = pdriver.build_seeker_config(args, seeker_args, torch.device('cuda'))
    assert (cpu.attention_bwd, cpu.remat_policy) == ('res', 'full')
    assert (gpu.attention_bwd, gpu.remat_policy) == ('kernel_x', 'dots_nb_out')
    assert cpu.compute_dtype == torch.float32 and cpu.remat


def test_port_h2d_prefetcher_order_errors_and_close():
    def batches(n):
        for i in range(n):
            yield {'device': {'x': np.full((8, 2), i, np.float32), 's': np.int32(i)}}

    pf = pdriver._H2DPrefetcher(batches(5), 'cpu')
    seen = []
    for host, dev in pf:
        assert isinstance(dev['x'], torch.Tensor) and dev['x'].shape == (8, 2)
        assert dev['s'].shape == () and int(dev['s']) == int(host['device']['s'])
        seen.append(int(dev['x'][0, 0]))
    pf.close()
    assert seen == [0, 1, 2, 3, 4]

    def broken():
        yield {'device': {'x': np.zeros((8, 2), np.float32)}}
        raise RuntimeError('loader boom')

    pf = pdriver._H2DPrefetcher(broken(), 'cpu')
    it = iter(pf)
    next(it)
    with pytest.raises(RuntimeError, match='loader boom'):
        next(it)
    pf.close()

    pf = pdriver._H2DPrefetcher(batches(50), 'cpu')
    next(iter(pf))
    time.sleep(0.05)   # let the producer refill and block on the bounded queue
    pf.close()
    assert not pf._thread.is_alive()


def test_port_driver_matches_jax_driver(synth_root, tmp_path, tiny, monkeypatch):
    '''tcow_tpu's driver saves its 'ba' checkpoint (random init) and trains one epoch of
    two steps; the port's driver resumes that JAX checkpoint and trains the same epoch on
    the same dataset (drop-path 0, colour augmentation on the device in both). Per-step
    losses and gradient norms, and the final parameters, agree within the train-step
    tolerances.'''
    from tcow_tpu import config as jconfig
    from tcow_tpu.models import timesformer as jtsf
    from tcow_tpu.train import checkpoint as jckpt
    from tcow_tpu.train import driver as jdriver
    from tcow_tpu.utils.logvis import MyLogger as JLogger

    monkeypatch.setitem(jtsf.DEPTH_PRESETS, 2, (32, 4))
    common = ['--data_path', synth_root, '--checkpoint_root', str(tmp_path / 'checkpoints'),
              '--log_root', str(tmp_path / 'logs'), '--batch_size', '2', '--num_queries', '2',
              '--num_frames', '6', '--frame_height', '32', '--frame_width', '48',
              '--kubric_max_delay', '2', '--num_epochs', '1', '--do_val_aug', '0',
              '--tracker_pretrained', '0', '--network_depth', '2', '--num_workers', '1',
              '--compute_dtype', 'float32', '--seed', '3', '--drop_path_rate', '0',
              '--device_augs', '1', '--avoid_wandb', '2', '--learn_rate', '1e-3']

    def recorder(module, into):
        real = module._log_step_scalars

        def log(logger, phase, epoch, cur_step, steps_total, aux):
            into.append((cur_step, float(aux['total_seeker']), float(aux['grad_norm'])))
            return real(logger, phase, epoch, cur_step, steps_total, aux)
        monkeypatch.setattr(module, '_log_step_scalars', log)

    jsteps, psteps = [], []
    recorder(jdriver, jsteps)
    recorder(pdriver, psteps)
    jargs = jconfig.train_args(['--name', 'jpba', '--device', 'cpu', *common])
    jlogger = JLogger(jargs, context='train')
    jdriver.main(jargs, jlogger)
    jdir = tmp_path / 'checkpoints' / 'jpba'
    pargs = pconfig.train_args(['--name', 'ppar', '--device', 'cpu', *common,
                                '--resume', str(jdir / 'model_-1.npz')])
    run(pargs)

    assert [s for s, *_ in psteps] == [s for s, *_ in jsteps] == [0, 1]
    for (_, pl, pn), (_, jl, jn) in zip(psteps, jsteps):
        np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(pn, jn, rtol=NORM_RTOL)
    want = jckpt.load_checkpoint(str(jdir / 'checkpoint.npz'))['params']
    got = pckpt.load_checkpoint(str(tmp_path / 'checkpoints' / 'ppar' / 'checkpoint.npz'))
    assert got['epoch'] == 0
    flat_w, flat_g = pckpt.flatten_with_paths(want), pckpt.flatten_with_paths(got['params'])
    assert set(flat_g) == set(flat_w)
    for k in flat_w:
        np.testing.assert_allclose(flat_g[k], flat_w[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
