'''
The port's tracking server (tcow_tpu_torch/serving.py) on the CPU, at the preset of
tests/test_serving.py (depth 3 at width 48 with 4 heads, T = 6 at 32x48, causal 1,
temporal_fc non-zero, the JAX weights carried over): dedicated replies bit-equal to the
port's direct stream; batched replies within tests/test_serving.py's float16 tolerance of
it, with a JAX stream the oracle of one session; a JAX TrackerClient driving the port's
server; and the behaviours of tests/test_serving.py: overflow, protocol and malformed-header
errors, slot recycling and capacity, failed-step recycling, reload and migration, group
eviction, and the oversized-geometry and aggregate-budget rejections. Every socket, join
and wait has its own short timeout, so a hang fails one test.
'''

import json
import socket
import struct
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.models import mask_tracker as jmt
from tcow_tpu.models import streaming as jstream
from tcow_tpu.models import timesformer as jtsf
from tcow_tpu_torch import serving
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import streaming as pstream
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.weights import params_from_jax

# Float16 replies against a direct stream, as tests/test_serving.py compares them.
F16_TOL = 2e-3
TIMEOUT = 30.0
WINDOW = 4


def client(addr):
    return serving.TrackerClient(*addr, timeout=TIMEOUT)


def np_params(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope='module')
def setup():
    '''JAX params and config as tests/test_serving.py makes them; the port's config and a
    port model from the same weights; a second set of weights for reloads.'''
    old = dict(jtsf.DEPTH_PRESETS), dict(ptsf.DEPTH_PRESETS)
    jtsf.DEPTH_PRESETS[3] = ptsf.DEPTH_PRESETS[3] = (48, 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    kw = dict(num_total_frames=6, frame_height=32, frame_width=48, causal_attention=1,
              drop_path_rate=0.0, network_depth=3)
    jcfg = jmt.SeekerConfig(**kw)
    params = jmt.init_params(jax.random.key(0), jcfg)
    params['backbone']['blocks']['temporal_fc']['w'] = jax.random.normal(
        jax.random.key(7), params['backbone']['blocks']['temporal_fc']['w'].shape) * 0.05
    pcfg = pmt.SeekerConfig(**kw)
    s = types.SimpleNamespace(jcfg=jcfg, jparams=params, params=np_params(params), cfg=pcfg,
                              params_b=np_params(jmt.init_params(jax.random.key(99), jcfg)),
                              models={})
    yield s
    torch.set_num_threads(threads)
    for presets, saved in zip((jtsf.DEPTH_PRESETS, ptsf.DEPTH_PRESETS), old):
        presets.clear()
        presets.update(saved)


@pytest.fixture
def make_server(setup):
    '''Starts port servers on 127.0.0.1, port 0, on the CPU; stops them after the test.'''
    servers = []

    def make(params=None, **kw):
        server = serving.TrackerServer(setup.params if params is None else params,
                                       setup.cfg, port=0, device='cpu', **kw)
        servers.append(server)
        return server, server.start()

    yield make
    for server in servers:
        server.stop()


def frames(seed, T, H=32, W=48):
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, size=(T, H, W, 3), dtype=np.uint8)
    q = np.zeros((H, W), np.uint8)
    q[8:16, 8:24] = 255
    return rgb, q


def port_model(setup, params=None):
    key = id(params)
    if key not in setup.models:
        model = pmt.MaskTracker(setup.cfg, device='cpu')
        model.load_state_dict(params_from_jax(setup.params if params is None else params))
        model.eval()
        setup.models[key] = model
    return setup.models[key]


def direct_stream(setup, rgb_u8, qmask, window=WINDOW, params=None):
    '''The port's stream on the inputs the server makes from the wire (uint8 / 255, the
    query > 127 on frame 0) -> per-frame (mask float16 (C, H, W), flags f32 (F,)).'''
    model = port_model(setup, params)
    state = pstream.init_stream(model, 1, max_frames=None if window else rgb_u8.shape[0],
                                window=window)
    out = []
    for t in range(rgb_u8.shape[0]):
        f = torch.from_numpy(rgb_u8[t].transpose(2, 0, 1)[None].astype(np.float32) / 255.0)
        q = (qmask > 127).astype(np.float32)[None, None] if t == 0 else \
            np.zeros((1, 1) + qmask.shape, np.float32)
        state, m, fl = pstream.stream_step(model, state, f, torch.from_numpy(q),
                                           window=window)
        out.append((m[0].to(torch.float16).numpy(), fl[0].numpy()))
    return out


def jax_stream(setup, rgb_u8, qmask, window=WINDOW):
    '''tcow_tpu's stream on the same inputs (the oracle of tests/test_serving.py).'''
    state = jstream.init_stream(setup.jparams, setup.jcfg, 1, window=window)
    step = jax.jit(lambda s, f, q: jstream.stream_step(setup.jparams, setup.jcfg, s, f, q,
                                                       window=window))
    out = []
    for t in range(rgb_u8.shape[0]):
        f = jnp.asarray(rgb_u8[t].transpose(2, 0, 1)[None].astype(np.float32) / 255.0)
        q = (qmask > 127).astype(np.float32)[None, None] if t == 0 else \
            np.zeros((1, 1) + qmask.shape, np.float32)
        state, m, fl = step(state, f, jnp.asarray(q))
        out.append((np.asarray(m[0], np.float16), np.asarray(fl[0])))
    return out


def assert_f16_close(got, want, what=''):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=F16_TOL, atol=F16_TOL, err_msg=what)


def run_threads(targets):
    '''Runs each callable on its own thread; every join bounded; re-raises the first
    error.'''
    errors = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in targets]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=2 * TIMEOUT)
    assert not any(th.is_alive() for th in threads), 'a client thread hung'
    if errors:
        raise errors[0]


def wait_idle(server):
    deadline = time.time() + 10
    while time.time() < deadline:   # the connection thread releases the slot after close
        if all(g.idle() for g in server._groups.values()):
            return
        time.sleep(0.02)
    raise AssertionError('groups did not go idle')


# ---------------------------------------------------------------------------------------
# Outputs
# ---------------------------------------------------------------------------------------

def test_dedicated_sessions_match_direct_stream_bit_for_bit(setup, make_server):
    '''Two sessions interleaved frame by frame, windowed and unbounded: every reply equals
    the port's direct stream bit for bit (float16 masks, flags); the stats count them.'''
    _, addr = make_server()
    T = 5
    rgb_a, q_a = frames(1, T)
    rgb_b, q_b = frames(2, T)
    ref_a = direct_stream(setup, rgb_a, q_a, window=WINDOW)
    ref_b = direct_stream(setup, rgb_b, q_b, window=None)
    ca, cb = client(addr), client(addr)
    meta = ca.open(window=WINDOW)
    assert (meta['height'], meta['width'], meta['mask_channels']) == (32, 48, 3)
    cb.open(window=0, max_frames=T)
    for t in range(T):
        ma, fa, ta = ca.track(rgb_a[t], query_mask=q_a if t == 0 else None)
        mb, fb, tb = cb.track(rgb_b[t], query_mask=q_b if t == 0 else None)
        assert ta == tb == t
        np.testing.assert_array_equal(ma, ref_a[t][0])
        np.testing.assert_array_equal(mb, ref_b[t][0])
        np.testing.assert_array_equal(np.asarray(fa, np.float32), ref_a[t][1])
        np.testing.assert_array_equal(np.asarray(fb, np.float32), ref_b[t][1])
    stats = ca.stats()
    assert stats['active_sessions'] == 2 and stats['frames_served'] >= 2 * T
    assert stats['ms_per_frame_ema'] > 0
    ca.close()
    cb.close()


def test_batched_server_matches_direct_stream(setup, make_server):
    '''Three concurrent staggered sessions through one batched step: each within the
    float16 tolerance of its direct stream, session 0 also of the JAX stream; one group
    in the stats with the sessions and frames.'''
    server, addr = make_server(batch_slots=3)
    T = 5
    vids = [frames(10 + k, T) for k in range(3)]
    refs = [direct_stream(setup, rgb, q) for rgb, q in vids]
    oracle = jax_stream(setup, *vids[0])
    clients = [client(addr) for _ in range(3)]
    results = [[] for _ in range(3)]

    def run(k):
        clients[k].open(window=WINDOW)
        rgb, q = vids[k]
        time.sleep(0.05 * k)   # staggered: sessions at different positions
        for t in range(T):
            m, fl, tt = clients[k].track(rgb[t], query_mask=q if t == 0 else None)
            assert tt == t
            results[k].append((m, fl))

    run_threads([lambda k=k: run(k) for k in range(3)])
    for k in range(3):
        for t in range(T):
            m, fl = results[k][t]
            assert_f16_close(m, refs[k][t][0], f'session {k} frame {t}')
            np.testing.assert_allclose(np.asarray(fl, np.float32), refs[k][t][1],
                                       rtol=1e-3, atol=1e-4)
    for t in range(T):
        assert_f16_close(results[0][t][0], oracle[t][0], f'jax frame {t}')
    assert len(server._groups) == 1
    (g,) = clients[0].stats()['batch_groups']
    assert g['window'] == WINDOW and g['live_sessions'] == 3
    assert g['frames'] >= 3 * T and g['steps'] >= 1
    for c in clients:
        c.close()


def test_jax_client_drives_port_server(setup, make_server):
    '''The wire protocol is JAX's byte for byte: tcow_tpu's TrackerClient opens, streams,
    reads stats and closes against the port's server, and gets the port's direct stream
    bit for bit.'''
    from tcow_tpu import serving as jserving
    _, addr = make_server()
    T = 4
    rgb, q = frames(3, T)
    ref = direct_stream(setup, rgb, q)
    c = jserving.TrackerClient(*addr, timeout=TIMEOUT)
    meta = c.open(window=WINDOW)
    assert meta['flag_channels'] == 3
    for t in range(T):
        m, fl, tt = c.track(rgb[t], query_mask=q if t == 0 else None)
        assert tt == t and m.dtype == np.float16
        np.testing.assert_array_equal(m, ref[t][0])
        np.testing.assert_array_equal(np.asarray(fl, np.float32), ref[t][1])
    assert c.stats()['frames_served'] >= T
    c.close()


def test_cache_bytes_use_the_compute_dtype():
    '''At the configuration of record in bf16 and window 30, one session holds 12 blocks x
    (k + v) x 300 x 768 x 2 bytes x 30 slots.'''
    cfg = pmt.SeekerConfig(compute_dtype=torch.bfloat16)
    fake = types.SimpleNamespace(cfg=cfg)
    assert serving.TrackerServer._cache_bytes(fake, 30, 1) == 12 * 2 * 300 * 768 * 2 * 30
    assert serving.TrackerServer._cache_bytes(
        types.SimpleNamespace(cfg=pmt.SeekerConfig()), 30, 4) == 4 * 12 * 2 * 300 * 768 * 4 * 30


# ---------------------------------------------------------------------------------------
# Errors that keep the connection, and protocol faults
# ---------------------------------------------------------------------------------------

def test_unbounded_overflow_is_an_application_error(setup, make_server):
    _, addr = make_server()
    rgb, q = frames(3, 3)
    c = client(addr)
    c.open(window=0, max_frames=2)
    c.track(rgb[0], query_mask=q)
    c.track(rgb[1])
    with pytest.raises(RuntimeError, match='full at 2 frames'):
        c.track(rgb[2])
    assert c.stats()['frames_served'] >= 2   # the connection is alive
    c.close()


def _raw(addr):
    return socket.create_connection(addr, timeout=TIMEOUT)


def _frame_before_open(addr):
    c = client(addr)
    with pytest.raises(RuntimeError, match='open a session first'):
        c.track(np.zeros((32, 48, 3), np.uint8))
    c.close()


def _second_open(addr):
    c = client(addr)
    c.open(window=WINDOW)
    with pytest.raises(RuntimeError, match='already open'):
        c.open(window=WINDOW)
    c.close()


def _bad_payload(addr):
    c = client(addr)
    c.open(window=WINDOW)
    serving.send_msg(c._sock, {'cmd': 'frame', 'has_query': False}, b'abc')
    reply, _ = serving.recv_msg(c._sock)
    assert not reply['ok'] and 'payload' in reply['error']
    c.close()


def _non_dict_header(addr):
    s = _raw(addr)
    h = json.dumps([1, 2]).encode()
    s.sendall(struct.pack('>II', len(h), 0) + h)
    reply, _ = serving.recv_msg(s)
    assert not reply['ok'] and 'JSON object' in reply['error']
    serving.send_msg(s, {'cmd': 'stats'})
    assert serving.recv_msg(s)[0]['ok']      # still alive
    s.close()


def _invalid_json(addr):
    s = _raw(addr)
    s.sendall(struct.pack('>II', 3, 0) + b'{{{')
    reply, _ = serving.recv_msg(s)
    assert not reply['ok'] and 'protocol error' in reply['error']
    assert serving.recv_msg(s) is None       # then a clean EOF
    s.close()


def _unknown_command(addr):
    s = _raw(addr)
    serving.send_msg(s, {'cmd': 'fly'})
    reply, _ = serving.recv_msg(s)
    assert not reply['ok'] and 'unknown cmd' in reply['error']
    s.close()


def _reload_disabled(addr):
    c = client(addr)
    with pytest.raises(RuntimeError, match='reload is disabled'):
        c.reload('/nonexistent')
    c.close()


PROTOCOL_CASES = {'frame_before_open': _frame_before_open, 'second_open': _second_open,
                  'bad_payload': _bad_payload, 'non_dict_header': _non_dict_header,
                  'invalid_json': _invalid_json, 'unknown_command': _unknown_command,
                  'reload_disabled': _reload_disabled}


@pytest.mark.parametrize('case', list(PROTOCOL_CASES))
def test_protocol_errors_are_reported(make_server, case):
    _, addr = make_server()
    PROTOCOL_CASES[case](addr)


# ---------------------------------------------------------------------------------------
# Continuous batching: slots, capacity, failed steps
# ---------------------------------------------------------------------------------------

def test_batched_slot_recycling_and_capacity(setup, make_server):
    '''A 4th session of one geometry is refused while 3 are live, and a recycled slot
    serves a fresh session correctly (the previous occupant's cache masked).'''
    server, addr = make_server(batch_slots=3)
    T = 3
    rgb, q = frames(42, T)
    ref = direct_stream(setup, rgb, q)
    holders = [client(addr) for _ in range(3)]
    for c in holders:
        c.open(window=WINDOW)
    holders[0].track(rgb[1], query_mask=q)     # dirty a slot before it is recycled
    extra = client(addr)
    with pytest.raises(RuntimeError, match='batch group full'):
        extra.open(window=WINDOW)
    holders[0].close()
    deadline = time.time() + 10
    while time.time() < deadline and not server._groups[(WINDOW, 1, WINDOW)].free:
        time.sleep(0.02)
    fresh = client(addr)
    fresh.open(window=WINDOW)
    for t in range(T):
        m, _, _ = fresh.track(rgb[t], query_mask=q if t == 0 else None)
        assert_f16_close(m, ref[t][0], f'frame {t}')
    for c in (fresh, extra, holders[1], holders[2]):
        c.close()


def _simulate_recycle(server, group):
    '''The aftermath of a failed step done by hand (tests/test_serving.py): the state
    rebuilt, the epoch bumped, every slot free.'''
    with server._device_lock, server._compute():
        group.state = group._fresh_state()
    with group.cond:
        group.epoch += 1
        group.free = list(range(group.slots))


def _raise_in_step(server, group):
    '''A step that really fails: the next batched step raises inside the device work.'''
    real = group._step

    def failing(*args):
        group._step = real
        raise RuntimeError('injected device fault')

    group._step = failing


@pytest.mark.parametrize('fault', ['simulated_recycle', 'raising_step'])
def test_failed_step_recycles_the_group(setup, make_server, fault):
    '''After a failed step the group rebuilds its state and bumps its epoch: the stale
    session gets an error reply and keeps its connection, a NEW session on the recycled
    group matches the direct stream. A raising step reports "device step failed" to the
    frame that rode it; nothing runs in its place.'''
    server, addr = make_server(batch_slots=3)
    rgb, q = frames(6, 3)
    ref = direct_stream(setup, rgb, q)
    c = client(addr)
    c.open(window=WINDOW)
    c.track(rgb[0], query_mask=q)
    group = next(iter(server._groups.values()))
    epoch = group.epoch
    {'simulated_recycle': _simulate_recycle, 'raising_step': _raise_in_step}[fault](
        server, group)
    match = 'reopen' if fault == 'simulated_recycle' else 'device step failed'
    with pytest.raises(RuntimeError, match=match):
        c.track(rgb[1])
    assert group.epoch == epoch + 1
    assert c.stats()['frames_served'] >= 1
    c.close()
    c2 = client(addr)
    c2.open(window=WINDOW)
    for t in range(3):
        m, _, _ = c2.track(rgb[t], query_mask=q if t == 0 else None)
        assert_f16_close(m, ref[t][0], f'frame {t}')
    c2.close()


def test_recycle_fails_pending_frames_as_stale(setup, make_server):
    '''Frames still pending when a recycle lands fail with _StaleBatch (a ValueError), so
    a migrating server retries them instead of reporting a reopen error.'''
    server, _ = make_server(batch_slots=2, migrate_sessions=True)
    group = serving._BatchGroup(server, window=WINDOW, pinned=1, tmax=WINDOW, slots=2)
    try:
        box = serving._FrameBox(np.zeros((1, 3, 32, 48), np.uint8),
                                np.zeros((1, 1, 32, 48), np.uint8))
        with group.cond:
            group.pending[0] = box
        group.recycle()
        assert box.done.wait(timeout=TIMEOUT)
        assert isinstance(box.error, serving._StaleBatch)
        assert isinstance(box.error, ValueError)
    finally:
        group.stopped.set()
        group._thread.join(timeout=TIMEOUT)
    assert not group._thread.is_alive()


def test_group_eviction_and_capacity(setup, make_server):
    '''Under max_groups=1 a live group refuses a new geometry; once idle it is evicted.'''
    server, addr = make_server(batch_slots=2, max_groups=1)
    a = client(addr)
    a.open(window=WINDOW)
    b = client(addr)
    with pytest.raises(RuntimeError, match='at capacity'):
        b.open(window=WINDOW + 1)
    a.close()
    wait_idle(server)
    b2 = client(addr)
    b2.open(window=WINDOW + 1)
    rgb, q = frames(5, 1)
    m, _, t = b2.track(rgb[0], query_mask=q)
    assert t == 0 and m.shape == (3, 32, 48)
    assert len(server._groups) == 1
    for c in (b, b2):
        c.close()


def test_concurrent_opens_build_one_group(setup, make_server, monkeypatch):
    '''Four clients opening one new geometry at once share one group, and only one state
    of batch_slots caches is ever built (a slow constructor widens the race).'''
    built = []

    class SlowGroup(serving._BatchGroup):
        def __init__(self, *args, **kw):
            built.append(1)
            time.sleep(0.2)
            super().__init__(*args, **kw)

    monkeypatch.setattr(serving, '_BatchGroup', SlowGroup)
    server, addr = make_server(batch_slots=4)
    clients = [client(addr) for _ in range(4)]
    run_threads([lambda c=c: c.open(window=WINDOW) for c in clients])
    assert len(built) == 1 and len(server._groups) == 1
    (g,) = server._groups.values()
    assert g.free == []
    for c in clients:
        c.close()


@pytest.mark.parametrize('slots', [1, 3], ids=['dedicated', 'batched'])
def test_oversized_geometry_rejected_before_allocation(make_server, slots):
    _, addr = make_server(batch_slots=slots)
    c = client(addr)
    with pytest.raises(RuntimeError, match='GiB'):
        c.open(window=10_000_000)
    with pytest.raises(RuntimeError, match='window > pinned_frames'):
        c.open(window=2, pinned_frames=5)
    c.open(window=WINDOW)    # the connection survives and a sane open works
    c.close()


def test_aggregate_cache_budget_and_pinned_normalization(make_server):
    '''The cache budget bounds the SUM over live groups, and pinned_frames does not mint
    distinct unbounded-mode geometries.'''
    server, addr = make_server(batch_slots=2, max_groups=8)
    server.max_cache_bytes = int(server._cache_bytes(5, 2) * 1.5)
    a = client(addr)
    a.open(window=5)
    b = client(addr)
    with pytest.raises(RuntimeError, match='at capacity'):
        b.open(window=WINDOW)
    a.close()
    wait_idle(server)
    b2 = client(addr)
    b2.open(window=WINDOW)
    assert len(server._groups) == 1
    b2.close()
    wait_idle(server)
    c1, c2 = client(addr), client(addr)
    c1.open(window=0, max_frames=3, pinned_frames=1)
    c2.open(window=0, max_frames=3, pinned_frames=2)
    assert sum(1 for (w, _, _) in server._groups if w is None) == 1
    for c in (b, c1, c2):
        c.close()


# ---------------------------------------------------------------------------------------
# Reload and migration
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('slots', [1, 2], ids=['dedicated', 'batched'])
def test_weight_reload(setup, make_server, slots):
    '''"reload" copies new weights into the served model: a session opened before gets a
    reopen error, a fresh one streams the new weights' outputs.'''
    _, addr = make_server(batch_slots=slots,
                          params_loader={'ckpt_b': setup.params_b}.__getitem__)
    T = 2
    rgb, q = frames(77, T)
    ref_b = direct_stream(setup, rgb, q, params=setup.params_b)
    stale = client(addr)
    stale.open(window=WINDOW)
    stale.track(rgb[0], query_mask=q)
    admin = client(addr)
    assert admin.reload('ckpt_b') == 1
    with pytest.raises(RuntimeError, match='reopen'):
        stale.track(rgb[1])
    with pytest.raises(RuntimeError, match='reload failed'):
        admin.reload('missing')
    fresh = client(addr)
    fresh.open(window=WINDOW)
    for t in range(T):
        m, _, _ = fresh.track(rgb[t], query_mask=q if t == 0 else None)
        if slots == 1:
            np.testing.assert_array_equal(m, ref_b[t][0])
        else:
            assert_f16_close(m, ref_b[t][0], f'frame {t}')
    for c in (stale, fresh, admin):
        c.close()


MIGRATION_CASES = {
    # (batch_slots, frames before the reload): all 3 retained (1 pinned + 3 ring) ...
    'dedicated': (1, 3), 'batched': (2, 3),
    # ... or 6, of which the ring keeps frames 0 and 3-5 (the window's retention).
    'dedicated_ring_trimmed': (1, 6),
}


@pytest.mark.parametrize('case', list(MIGRATION_CASES))
def test_session_migration_across_reload(setup, make_server, case):
    '''migrate_sessions=True: a live session survives a reload; its next frames equal a
    fresh stream under the new weights fed the retained frames, and the client's
    timeline stays continuous.'''
    slots, fed = MIGRATION_CASES[case]
    _, addr = make_server(batch_slots=slots, migrate_sessions=True,
                          params_loader={'ckpt_b': setup.params_b}.__getitem__)
    total = fed + 2
    rgb, q = frames(78, total)
    keep = [0] + list(range(max(1, fed - (WINDOW - 1)), fed))
    sub = np.stack([rgb[i] for i in keep + [fed, fed + 1]])
    ref_b = direct_stream(setup, sub, q, params=setup.params_b)[len(keep):]
    c = client(addr)
    c.open(window=WINDOW)
    for t in range(fed):
        c.track(rgb[t], query_mask=q if t == 0 else None)
    admin = client(addr)
    assert admin.reload('ckpt_b') == 1
    for i, t in enumerate((fed, fed + 1)):
        m, _, tt = c.track(rgb[t])
        assert tt == t
        assert_f16_close(m, ref_b[i][0], f'frame {t}')
    assert c.stats()['migrations'] == 1
    c.close()
    admin.close()


def test_migrating_group_is_not_evicted(setup, make_server):
    '''After a reload recycles a group, a session awaiting migration still holds it: a
    new-geometry open must not evict it, and closing the session frees it.'''
    server, addr = make_server(batch_slots=2, max_groups=1, migrate_sessions=True,
                               params_loader={'ckpt_b': setup.params_b}.__getitem__)
    rgb, q = frames(80, 2)
    a = client(addr)
    a.open(window=WINDOW)
    a.track(rgb[0], query_mask=q)
    admin = client(addr)
    admin.reload('ckpt_b')
    b = client(addr)
    with pytest.raises(RuntimeError, match='at capacity'):
        b.open(window=WINDOW + 1)
    m, _, tt = a.track(rgb[1])
    assert tt == 1 and m is not None
    a.close()
    wait_idle(server)
    b2 = client(addr)
    b2.open(window=WINDOW + 1)
    for c in (b2, admin, b):
        c.close()
