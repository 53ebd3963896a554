'''
The port's streaming inference (tcow_tpu_torch/models/streaming.py) against tcow_tpu's on
the CPU in float32, with the JAX weights carried over by params_from_jax, at the preset of
tests/test_streaming.py (depth 3 at width 48 with 4 heads, T = 6 at 32x48, causal 1,
temporal_fc non-zero): stream_step frame by frame in unbounded mode and in windowed mode
(window 4, 1 pinned, 9 frames: past the ring's wrap and past the trained horizon), each
with and without temporal_rope; stream_step_multi with staggered sessions against JAX's
and against single streams; the stream against the port's own batch forward; and frames
after t leaving frame t's output unchanged.
'''

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.models import mask_tracker as jmt
from tcow_tpu.models import streaming as jstream
from tcow_tpu.models import timesformer as jtsf
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import streaming as pstream
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.weights import params_from_jax

# fp32 tolerance of tests/test_streaming.py.
RTOL, ATOL = 2e-4, 2e-5
T, H, W = 6, 32, 48
WINDOW, PINNED, LONG = 4, 1, 9
MODES = {'unbounded': None, 'windowed': WINDOW}


@pytest.fixture(scope='module')
def setup():
    '''JAX params as tests/test_streaming.py makes them, and the port's model per rope
    setting from the same weights.'''
    old = dict(jtsf.DEPTH_PRESETS), dict(ptsf.DEPTH_PRESETS)
    jtsf.DEPTH_PRESETS[3] = ptsf.DEPTH_PRESETS[3] = (48, 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    kw = dict(num_total_frames=T, frame_height=H, frame_width=W, causal_attention=1,
              drop_path_rate=0.0, network_depth=3)
    jcfg = jmt.SeekerConfig(**kw)
    params = jmt.init_params(jax.random.key(0), jcfg)
    params['backbone']['blocks']['temporal_fc']['w'] = jax.random.normal(
        jax.random.key(7), params['backbone']['blocks']['temporal_fc']['w'].shape) * 0.05
    state_dict = params_from_jax(jax.tree.map(np.asarray, params))
    pairs = {}
    for rope in (False, True):
        jc = dataclasses.replace(jcfg, temporal_rope=rope)
        model = pmt.MaskTracker(pmt.SeekerConfig(**kw, temporal_rope=rope), device='cpu')
        model.load_state_dict(state_dict)
        model.eval()
        pairs[rope] = (jc, model)
    yield params, pairs, {}
    torch.set_num_threads(threads)
    for presets, saved in zip((jtsf.DEPTH_PRESETS, ptsf.DEPTH_PRESETS), old):
        presets.clear()
        presets.update(saved)


def video(seed, n, B=1):
    '''(rgb (B, 3, n, H, W), query (B, 1, n, H, W)) f32, the query box on frame 0.'''
    rng = np.random.RandomState(seed)
    rgb = rng.rand(B, 3, n, H, W).astype(np.float32)
    query = np.zeros((B, 1, n, H, W), np.float32)
    query[:, :, 0, 4:12, 8:24] = 1.0
    return rgb, query


def jax_step(setup, rope, window, multi=False):
    '''The JAX stream step jitted once per (rope, window, multi), as the JAX tests jit it.'''
    params, pairs, cache = setup
    key = (rope, window, multi)
    if key not in cache:
        cfg = pairs[rope][0]
        if multi:
            cache[key] = jax.jit(lambda s, f, q, a: jstream.stream_step_multi(
                params, cfg, s, f, q, a, window=window, pinned_frames=PINNED))
        else:
            cache[key] = jax.jit(lambda s, f, q: jstream.stream_step(
                params, cfg, s, f, q, window=window, pinned_frames=PINNED))
    return cache[key]


def jax_stream(setup, rope, window, rgb, query):
    params, pairs, _ = setup
    n = rgb.shape[2]
    state = jstream.init_stream(params, pairs[rope][0], rgb.shape[0],
                                max_frames=None if window else n, window=window,
                                pinned_frames=PINNED)
    step = jax_step(setup, rope, window)
    outs = []
    for t in range(n):
        state, m, f = step(state, jnp.asarray(rgb[:, :, t]), jnp.asarray(query[:, :, t]))
        outs.append((np.asarray(m), np.asarray(f)))
    return outs


def port_stream(model, window, rgb, query, frames=None):
    n = rgb.shape[2]
    state = pstream.init_stream(model, rgb.shape[0], max_frames=None if window else n,
                                window=window, pinned_frames=PINNED)
    outs = []
    for t in range(n if frames is None else frames):
        state, m, f = pstream.stream_step(model, state, torch.from_numpy(rgb[:, :, t]),
                                          torch.from_numpy(query[:, :, t]), window=window,
                                          pinned_frames=PINNED)
        outs.append((m.numpy(), f.numpy()))
    assert state.t == len(outs)
    return outs


@pytest.mark.parametrize('rope', [False, True], ids=['abs_time', 'rope'])
@pytest.mark.parametrize('mode', list(MODES))
def test_stream_step_matches_jax(setup, mode, rope):
    '''Every frame's mask logits and flags; windowed runs 9 frames through a window of 4.'''
    window = MODES[mode]
    rgb, query = video(1 + 2 * rope + (window is not None), LONG if window else T, B=2)
    want = jax_stream(setup, rope, window, rgb, query)
    got = port_stream(setup[1][rope][1], window, rgb, query)
    assert len(got) == len(want)
    for t, ((gm, gf), (wm, wf)) in enumerate(zip(got, want)):
        assert gm.shape == wm.shape == (2, 3, H, W) and gf.shape == wf.shape == (2, 3)
        np.testing.assert_allclose(gm, wm, rtol=RTOL, atol=ATOL, err_msg=f'mask {t}')
        np.testing.assert_allclose(gf, wf, rtol=RTOL, atol=ATOL, err_msg=f'flags {t}')


MULTI_CASES = {'unbounded': (None, False), 'windowed': (WINDOW, False),
               'windowed_rope': (WINDOW, True)}


@pytest.mark.parametrize('case', list(MULTI_CASES))
def test_stream_step_multi_matches_jax_and_single_streams(setup, case):
    '''3 sessions at staggered starts through one multi-session state, slot 2 dirtied
    and recycled first (tests/test_streaming.py:_multi_vs_single): every active output
    against JAX's multi-session step on the same ticks and against the port's single
    stream of that session; the final t per slot.'''
    window, rope = MULTI_CASES[case]
    _, pairs, _ = setup
    model = pairs[rope][1]
    K, n = 3, 5
    vids = [video(11 + k + 5 * (window is not None) + 10 * rope, n) for k in range(K)]
    singles = [port_stream(model, window, rgb, q) for rgb, q in vids]
    params = setup[0]
    jstate = jstream.init_stream_multi(params, pairs[rope][0], K,
                                       max_frames=None if window else n, window=window)
    pstate = pstream.init_stream_multi(model, K, max_frames=None if window else n,
                                       window=window)
    jstep = jax_step(setup, rope, window, multi=True)
    pstep = lambda s, f, q, a: pstream.stream_step_multi(
        model, s, torch.from_numpy(f), torch.from_numpy(q), torch.from_numpy(a),
        window=window, pinned_frames=PINNED)
    dirty = np.concatenate([vids[0][0][:, :, 0]] * K), np.concatenate([vids[0][1][:, :, 0]] * K)
    only2 = np.asarray([False, False, True])
    jstate = jstream.reset_stream_slot(jstep(jstate, *map(jnp.asarray, dirty),
                                             jnp.asarray(only2))[0], 2)
    pstate = pstream.reset_stream_slot(pstep(pstate, *dirty, only2)[0], 2)

    pos = [0] * K
    for tick in range(n + K - 1):
        act = np.asarray([k <= tick and pos[k] < n for k in range(K)])
        frames = np.zeros((K, 3, H, W), np.float32)
        queries = np.zeros((K, 1, H, W), np.float32)
        for k in np.flatnonzero(act):
            frames[k] = vids[k][0][0, :, pos[k]]
            queries[k] = vids[k][1][0, :, pos[k]]
        jstate, jm, jf = jstep(jstate, jnp.asarray(frames), jnp.asarray(queries),
                               jnp.asarray(act))
        pstate, pm, pf = pstep(pstate, frames, queries, act)
        for k in np.flatnonzero(act):
            for got, want, what in ((pm[k].numpy(), np.asarray(jm[k]), 'jax mask'),
                                    (pf[k].numpy(), np.asarray(jf[k]), 'jax flags'),
                                    (pm[k].numpy(), singles[k][pos[k]][0][0], 'single mask'),
                                    (pf[k].numpy(), singles[k][pos[k]][1][0], 'single flags')):
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                           err_msg=f'{what} session {k} frame {pos[k]}')
            pos[k] += 1
    assert pstate.t.tolist() == [n] * K == np.asarray(jstate.t).tolist()


@pytest.mark.parametrize('rope', [False, True], ids=['abs_time', 'rope'])
def test_stream_matches_port_batch_forward(setup, rope):
    '''The unbounded stream equals the port's causal batch forward frame by frame.'''
    model = setup[1][rope][1]
    rgb, query = video(21 + rope, T, B=2)
    with torch.inference_mode():
        mask, flags = model(torch.from_numpy(rgb), torch.from_numpy(query))
    for t, (m, f) in enumerate(port_stream(model, None, rgb, query)):
        np.testing.assert_allclose(m, mask[:, :, t].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f'mask {t}')
        np.testing.assert_allclose(f, flags[:, t].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f'flags {t}')


@pytest.mark.parametrize('mode', list(MODES))
def test_later_frames_leave_earlier_outputs_unchanged(setup, mode):
    '''The online guarantee: a stream stopped after 3 frames gives the first 3 outputs of
    the stream run to the end, bit for bit.'''
    window = MODES[mode]
    model = setup[1][False][1]
    rgb, query = video(31, LONG if window else T)
    short = port_stream(model, window, rgb, query, frames=3)
    full = port_stream(model, window, rgb, query)
    for t in range(3):
        np.testing.assert_array_equal(short[t][0], full[t][0])


def test_stream_refuses_what_it_cannot_run(setup):
    '''A non-causal model, a bad window and an overfull unbounded cache raise.'''
    model = setup[1][False][1]
    noncausal = pmt.MaskTracker(dataclasses.replace(model.cfg, causal_attention=0),
                                device='cpu')
    with pytest.raises(ValueError, match='causal_attention == 1'):
        pstream.init_stream(noncausal, 1)
    with pytest.raises(ValueError, match='window > pinned_frames'):
        pstream.init_stream(model, 1, window=2, pinned_frames=2)
    rgb, query = video(41, 3)
    state = pstream.init_stream(model, 1, max_frames=2)
    for t in range(2):
        state = pstream.stream_step(model, state, torch.from_numpy(rgb[:, :, t]),
                                    torch.from_numpy(query[:, :, t]))[0]
    with pytest.raises(ValueError, match='full at 2 frames'):
        pstream.stream_step(model, state, torch.from_numpy(rgb[:, :, 2]),
                            torch.from_numpy(query[:, :, 2]))
