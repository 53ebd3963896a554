#!/usr/bin/env python3
'''
Serve online tracking over TCP with the PyTorch port (tcow_tpu_torch/serving.py), and a
demo client: the counterpart of tools/serve.py, with its flags and wire protocol, so either
package's client talks to either package's server.

Server (loads a checkpoint, owns the GPU; --device cpu runs it on the CPU):
  python tools/torch_serve.py --resume <name|ckpt.npz> [--host 0.0.0.0 --port 7465] \
      [--batch_slots 4] [--allow_reload --migrate_sessions]

Demo client (streams a video file through a running server, writes an overlay):
  python tools/torch_serve.py --client --port 7465 --video demo/rollball.mp4 \
      --query demo/rollball_15_query.png --query_frame 15 --window 30 [--out serve_out.webm]

The server forces causal_attention=1 (the stream needs it), runs in --compute_dtype
(bfloat16 by default, over float32 weights), and with --allow_reload swaps in a checkpoint
of the same geometry on the 'reload' command.
'''

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def run_server(a):
    from tcow_tpu_torch import config as config_lib
    from tcow_tpu_torch.evaluation import inference as inference_lib
    from tcow_tpu_torch.serving import TrackerServer
    from tcow_tpu_torch.utils.logvis import Logger

    logger = Logger(context='serve')
    resume = a.resume
    if not os.path.isfile(resume):
        resume = config_lib.resolve_resume_path(a.checkpoint_root, resume)
    dtype = DTYPES[a.compute_dtype]
    params, cfg, *_ = inference_lib.load_networks(resume, logger, compute_dtype=dtype,
                                                  device=a.device)
    if cfg.causal_attention != 1:
        logger.warning('checkpoint is not causal_attention=1; forcing it for streaming.')
        cfg = dataclasses.replace(cfg, causal_attention=1)

    def load_same_geometry(path):
        '''Loader of the 'reload' command: the checkpoint must describe the SAME model
        geometry, since the served model's weights are replaced in place.'''
        new_params, new_cfg, *_ = inference_lib.load_networks(path, logger,
                                                              compute_dtype=dtype,
                                                              device=a.device)
        if dataclasses.replace(new_cfg, causal_attention=1) != cfg:
            raise ValueError(f'checkpoint geometry mismatch: {new_cfg} != {cfg}')
        return new_params

    server = TrackerServer(params, cfg, host=a.host, port=a.port,
                           default_max_frames=a.max_frames or None,
                           batch_slots=a.batch_slots,
                           params_loader=load_same_geometry if a.allow_reload else None,
                           migrate_sessions=a.migrate_sessions, device=a.device)
    host, port = server.start()
    where = torch.cuda.get_device_name(server.device) if server.device.type == 'cuda' \
        else 'cpu'
    logger.info(f'serving {a.resume} on {host}:{port} ({cfg.frame_height}x'
                f'{cfg.frame_width}, {a.compute_dtype}, {where}); Ctrl-C to stop')
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        logger.info('stopping')
    finally:
        server.stop()


def run_client(a):
    import cv2
    from tcow_tpu_torch.serving import TrackerClient
    from tcow_tpu_torch.utils.logvis import _write_video

    client = TrackerClient(a.host, a.port)
    meta = client.open(window=a.window)
    H, W = meta['height'], meta['width']

    cap = cv2.VideoCapture(a.video)
    if not cap.isOpened():
        raise OSError(f'could not open video: {a.video}')
    qmask_img = cv2.imread(a.query, cv2.IMREAD_GRAYSCALE)
    if qmask_img is None:
        raise OSError(f'could not read query mask: {a.query}')

    frames_out, lat = [], []
    idx = -1
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        idx += 1
        if idx < a.query_frame:
            continue
        if a.client_frames > 0 and len(frames_out) >= a.client_frames:
            break
        rgb = cv2.resize(bgr[..., ::-1], (W, H)).astype(np.uint8)
        q = None
        if idx == a.query_frame:
            q = cv2.resize(qmask_img, (W, H), interpolation=cv2.INTER_NEAREST) > 127
        t0 = time.time()
        mask_logits, _, _ = client.track(rgb, query_mask=q)
        lat.append(time.time() - t0)
        mask = 1.0 / (1.0 + np.exp(-mask_logits.astype(np.float32)))
        vis = rgb.astype(np.float32) / 255.0 * 0.6
        vis[..., 1] += mask[0] * 0.5
        if mask.shape[0] >= 2:
            vis[..., 0] += mask[1] * 0.5
        if mask.shape[0] >= 3:
            vis[..., 2] += mask[2] * 0.5
        frames_out.append((np.clip(vis, 0, 1) * 255).astype(np.uint8))
    cap.release()
    print(client.stats())
    client.close()

    out_fp = _write_video(a.out, np.stack(frames_out), fps=12)
    print(f'wrote {len(frames_out)} overlay frames to {out_fp}; median round-trip '
          f'{np.median(lat[1:]) * 1e3:.1f} ms/frame')


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--client', action='store_true', help='run the demo client instead')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=7465)
    # server args
    p.add_argument('--resume', default='', help='checkpoint name or path (server)')
    p.add_argument('--checkpoint_root', default='checkpoints/')
    p.add_argument('--max_frames', type=int, default=0,
                   help='cache slots for unbounded (window=0) sessions')
    p.add_argument('--migrate_sessions', action='store_true',
                   help='zero-downtime weight reloads: live sessions are rebuilt (retained '
                        'frames replayed) instead of erroring with reopen')
    p.add_argument('--allow_reload', action='store_true',
                   help='enable the "reload" command (checkpoint hot-swap)')
    p.add_argument('--batch_slots', type=int, default=1,
                   help='>1: continuous batching, same-geometry sessions share one batched '
                        'step')
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    p.add_argument('--compute_dtype', default='bfloat16', choices=sorted(DTYPES))
    # client args
    p.add_argument('--video', default='demo/rollball.mp4')
    p.add_argument('--query', default='demo/rollball_15_query.png')
    p.add_argument('--query_frame', type=int, default=15)
    p.add_argument('--window', type=int, default=30,
                   help='0 = unbounded (exact, bounded length); >0 = windowed, any length')
    p.add_argument('--client_frames', type=int, default=0,
                   help='stop the demo client after this many frames (0 = whole video)')
    p.add_argument('--out', default='serve_out.webm')
    a = p.parse_args(argv)
    if a.client:
        run_client(a)
    elif not a.resume:
        p.error('--resume is required for the server')
    else:
        run_server(a)


if __name__ == '__main__':
    main()
