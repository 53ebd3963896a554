#!/usr/bin/env python3
'''
Online tracking demo with the PyTorch port: run the streaming seeker over a video frame
by frame (causal KV-cached inference, tcow_tpu_torch/models/streaming.py) and write the
mask overlay: the counterpart of tools/stream_demo.py, with its flags.

Usage:
  python tools/torch_stream_demo.py --resume <name|ckpt.npz|ckpt.pth> \
      --video demo/rollball.mp4 --query demo/rollball_15_query.png --query_frame 15 \
      [--window 30] [--max_frames N] [--out stream_out.webm] [--device cpu]

Streaming starts at the query frame; every later frame is processed online at O(1) cost
per frame (O(window) memory with --window, for videos of any length). The overlay mixes
the snitch, occluder and container probabilities into the green, red and blue channels
of the dimmed frame, as the JAX tool does, and is written by utils/logvis._write_video
(VP8 .webm, else mp4v .mp4). Logs the frames written and the median latency per frame
(host clock, the mask on the host), and prints them as one JSON line with the kernel
launches and the card.
'''

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tcow_tpu_torch import config as config_lib  # noqa: E402
from tcow_tpu_torch import resolve_device  # noqa: E402
from tcow_tpu_torch.evaluation import inference as inference_lib  # noqa: E402
from tcow_tpu_torch.models import streaming  # noqa: E402
from tcow_tpu_torch.ops import fused_attention as fa  # noqa: E402
from tcow_tpu_torch.utils.logvis import Logger, _write_video  # noqa: E402

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def overlay(rgb: np.ndarray, mask_logits: np.ndarray) -> np.ndarray:
    '''rgb (H, W, 3) float in [0, 1], mask logits (C, H, W) -> (H, W, 3) uint8.'''
    mask = 1.0 / (1.0 + np.exp(-mask_logits))
    vis = rgb * 0.6
    vis[..., 1] += mask[0] * 0.5
    if mask.shape[0] >= 2:
        vis[..., 0] += mask[1] * 0.5
    if mask.shape[0] >= 3:
        vis[..., 2] += mask[2] * 0.5
    return (np.clip(vis, 0, 1) * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--resume', required=True)
    p.add_argument('--video', required=True)
    p.add_argument('--query', required=True, help='query mask png')
    p.add_argument('--query_frame', type=int, required=True)
    p.add_argument('--max_frames', type=int, default=-1,
                   help='frames to process from the query frame on; -1 = model capacity '
                        '(or the whole video with --window)')
    p.add_argument('--window', type=int, default=0,
                   help='>0: windowed KV cache (pinned query frame + ring of window-1 '
                        'recent frames) -> videos of ANY length at O(window) memory')
    p.add_argument('--out', default='stream_out.webm')
    p.add_argument('--checkpoint_root', default='checkpoints/')
    p.add_argument('--device', default='cuda')
    p.add_argument('--compute_dtype', default='bfloat16', choices=sorted(DTYPES))
    a = p.parse_args(argv)

    import cv2
    logger = Logger(context='stream_demo')
    device = resolve_device(a.device)
    resume = a.resume
    if not os.path.isfile(resume):
        resume = config_lib.resolve_resume_path(a.checkpoint_root, resume)
    params, cfg, *_ = inference_lib.load_networks(resume, logger,
                                                  compute_dtype=DTYPES[a.compute_dtype],
                                                  device=device)
    if cfg.causal_attention != 1:
        logger.warning('checkpoint is not causal_attention=1; streaming semantics require '
                       'it — forcing (outputs will differ from offline eval).')
        cfg = dataclasses.replace(cfg, causal_attention=1)
    model = inference_lib.InferenceEngine(params, cfg, device=device).model
    H, W = cfg.frame_height, cfg.frame_width

    cap = cv2.VideoCapture(a.video)
    if not cap.isOpened():
        raise FileNotFoundError(a.video)
    qmask_img = cv2.imread(a.query, cv2.IMREAD_GRAYSCALE)
    if qmask_img is None:
        raise FileNotFoundError(a.query)

    window = a.window if a.window > 0 else None
    if window:
        T = a.max_frames if a.max_frames > 0 else 10 ** 9   # bounded by the video length
        state = streaming.init_stream(model, 1, window=window)
    else:
        T = cfg.num_total_frames if a.max_frames < 0 else a.max_frames
        state = streaming.init_stream(model, 1, max_frames=T)

    frames_out, lat = [], []
    t_model, idx = 0, -1
    counts = fa.read_launches()
    with torch.inference_mode():
        while t_model < T:
            ok, bgr = cap.read()
            if not ok:
                break
            idx += 1
            if idx < a.query_frame:
                continue   # streaming starts at the query frame (query at position 0)
            rgb = cv2.resize(bgr[..., ::-1], (W, H)).astype(np.float32) / 255.0
            q = np.zeros((1, 1, H, W), np.float32)
            if idx == a.query_frame:
                q[0, 0] = cv2.resize(qmask_img, (W, H), interpolation=cv2.INTER_NEAREST) > 127
            f = torch.from_numpy(np.ascontiguousarray(rgb.transpose(2, 0, 1))[None])
            t0 = time.perf_counter()
            state, mask_logits, _ = streaming.stream_step(
                model, state, f.to(device), torch.from_numpy(q).to(device), window=window)
            mask = mask_logits[0].float().cpu().numpy()
            lat.append(time.perf_counter() - t0)
            frames_out.append(overlay(rgb, mask))
            t_model += 1
    cap.release()
    if not frames_out:
        raise ValueError(f'no frame of {a.video} from frame {a.query_frame} on')

    launches = {k: n for k, n in fa.launches_since(counts).items() if n}
    out_fp = _write_video(a.out, np.stack(frames_out), fps=12)
    med = np.median(lat[1:] if len(lat) > 1 else lat)
    logger.info(f'Wrote {len(frames_out)} overlay frames to {out_fp}; '
                f'median latency {med * 1e3:.1f} ms/frame ({1.0 / med:.0f} fps)')
    where = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    print(json.dumps({'stream_demo': {'frames': len(frames_out), 'out': out_fp,
                                      'latency_ms_median': med * 1e3, 'launches': launches},
                      'device': where}), flush=True)


if __name__ == '__main__':
    main()
