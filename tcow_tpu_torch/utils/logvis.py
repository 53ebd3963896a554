'''
Logging and visualization sink: the port's copy of tcow_tpu/utils/logvis.py.
  - console + per-experiment file logging;
  - scalar reporting with per-epoch weighted accumulation (report_scalar(remember=True) /
    commit_scalars) into <log_dir>/scalars.jsonl, and optional wandb (gated: it runs
    without the package);
  - media writers under <log_dir>/visuals: images (PNG through data/png.py), videos (a
    VP8 .webm where cv2 has the codec, else an mp4v .mp4; cv2 is imported when a video
    is written, never at load; written on a thread pool, waited for at the end of an
    epoch), galleries, and pickles;
  - handle_train_step / handle_test_step: the status line and the per-query overlay
    videos (utils/visualization.py), with friendly_short_name, the key that
    evaluation/pick_represent.py joins on.
'''

import concurrent.futures
import json
import logging
import os
import pickle
import sys
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np

from tcow_tpu_torch.data import png
from tcow_tpu_torch.utils import visualization


def _make_console_logger(log_path: Optional[str], context: str, level: str = 'info'):
    logger = logging.getLogger(f'tcow_tpu_torch.{context}.{os.getpid()}')
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.handlers.clear()
    logger.propagate = False
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter('%(levelname)s %(message)s'))
    logger.addHandler(handler)
    if log_path:
        os.makedirs(log_path, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_path, f'{context}.log'))
        fh.setFormatter(logging.Formatter('%(asctime)s %(levelname)s %(message)s'))
        logger.addHandler(fh)
    return logger


class Logger:
    '''Generic scalar and media logger.'''

    def __init__(self, log_dir: str = '', context: str = 'main', log_level: str = 'info'):
        self.log_dir = log_dir
        self.context = context
        self.vis_dir = os.path.join(log_dir, 'visuals') if log_dir else ''
        if self.vis_dir:
            os.makedirs(self.vis_dir, exist_ok=True)
        self._logger = _make_console_logger(log_dir, context, log_level)
        self._scalar_memory = defaultdict(list)        # key -> [(value, weight)]
        self._wandb = None
        # --avoid_wandb gradations: 1 keeps scalars online but not media.
        self.log_media_online = True
        self.extra_visuals = False
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        self._pending = []

    # ------------------------------------------------------------------ console
    def info(self, msg: str = ''):
        self._logger.info(str(msg))

    def debug(self, msg: str = ''):
        self._logger.debug(str(msg))

    def debug_enabled(self) -> bool:
        return self._logger.isEnabledFor(logging.DEBUG)

    def warning(self, msg: str = ''):
        self._logger.warning(str(msg))

    def error(self, msg: str = ''):
        self._logger.error(str(msg))

    def exception(self, e):
        self._logger.exception(e)

    def close(self):
        '''Waits for the pending media writes, stops the writer threads and closes the
        file handlers (a logger per run in one process keeps no files open).'''
        try:
            self.wait_pending()
        finally:
            self._pool.shutdown(wait=True)
        for h in list(self._logger.handlers):
            h.close()
            self._logger.removeHandler(h)

    # ------------------------------------------------------------------ wandb
    def init_wandb(self, project: str, args, name: Optional[str] = None,
                   group: Optional[str] = None):
        try:
            import wandb
        except ImportError:
            self.warning('wandb unavailable; online logging disabled '
                         '(scalars still land in scalars.jsonl).')
            return
        try:
            wandb.init(project=project, group=group, name=name,
                       config={k: str(v) for k, v in vars(args).items()})
        except Exception as e:  # noqa: BLE001 — online logging is optional
            self.warning(f'wandb.init failed ({e}); online logging disabled.')
            return
        self._wandb = wandb

    # ------------------------------------------------------------------ scalars
    def _append_scalars_jsonl(self, payload: Dict[str, float], step: Optional[int]):
        '''Offline scalar history: every committed/immediate scalar also lands in
        <log_dir>/scalars.jsonl.'''
        if not self.log_dir:
            return
        with open(os.path.join(self.log_dir, 'scalars.jsonl'), 'a') as f:
            f.write(json.dumps({'step': step, **payload}) + '\n')

    def report_scalar(self, key: str, value, step: Optional[int] = None,
                      remember: bool = False, weight: float = 1.0):
        if value is None:
            return
        value = float(value)
        if remember:
            self._scalar_memory[key].append((value, float(weight)))
        else:
            self._append_scalars_jsonl({key: value}, step)
            if self._wandb is not None:
                self._wandb.log({key: value}, step=step)

    def commit_scalars(self, keys=None, step: Optional[int] = None) -> Dict[str, float]:
        '''Flushes remembered scalars as weighted means.'''
        if keys is None:
            keys = list(self._scalar_memory.keys())
        out = {}
        for k in keys:
            entries = self._scalar_memory.pop(k, [])
            if not entries:
                continue
            values, weights = zip(*entries)
            total_w = sum(weights)
            out[k] = float(np.dot(values, weights) / total_w) if total_w > 0 else -1.0
        if out:
            self._append_scalars_jsonl(out, step)
        if self._wandb is not None and out:
            self._wandb.log(out, step=step)
        return out

    def report_single_scalar(self, key: str, value):
        if self._wandb is not None:
            self._wandb.run.summary[key] = value

    def save_args(self, args, context: Optional[str] = None):
        if not self.log_dir:
            return
        fp = os.path.join(self.log_dir, f'args_{context or self.context}.txt')
        with open(fp, 'w') as f:
            json.dump({k: str(v) for k, v in vars(args).items()}, f, indent=2)

    def save_pickle(self, obj, file_name: str):
        if not self.log_dir:
            return None
        fp = os.path.join(self.log_dir, file_name)
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        with open(fp, 'wb') as f:
            pickle.dump(obj, f)
        return fp

    def save_image(self, image: np.ndarray, file_name: str):
        '''(H, W, 3) RGB or (H, W) float in [0, 1] or uint8 -> a PNG under visuals/.'''
        if not self.vis_dir:
            return None
        if image.dtype in (np.float32, np.float64):
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        fp = os.path.join(self.vis_dir, file_name)
        png.write_png(fp, image)
        return fp

    def save_video(self, frames: np.ndarray, file_name: str, fps: int = 12,
                   asynchronous: bool = True, online_name: Optional[str] = None):
        '''(T, H, W, 3) float or uint8 frames -> webm (VP8) or mp4 under visuals/. With
        online_name and active wandb (and log_media_online), also logs the written file
        online.'''
        if not self.vis_dir:
            return None
        fp = os.path.join(self.vis_dir, file_name)
        frames = np.asarray(frames)
        if frames.dtype in (np.float16, np.float32, np.float64):
            frames = (np.clip(frames.astype(np.float32), 0, 1) * 255).astype(np.uint8)
        if asynchronous:
            fut = self._pool.submit(_write_video, fp, frames, fps)
            if online_name:
                fut.add_done_callback(
                    lambda f: self._log_video_online(f, online_name, fps))
            self._pending.append(fut)
        else:
            fp = _write_video(fp, frames, fps)
            if online_name and self._wandb is not None and self.log_media_online:
                try:
                    self._wandb.log({online_name: self._wandb.Video(fp, fps=fps)})
                except Exception as e:  # noqa: BLE001 — online logging is optional
                    self.warning(f'online video logging failed: {e}')
        return fp

    def _log_video_online(self, fut, online_name: str, fps: int):
        if self._wandb is None or not self.log_media_online:
            return
        try:
            fp = fut.result()
            self._wandb.log({online_name: self._wandb.Video(fp, fps=fps)})
        except Exception as e:  # noqa: BLE001 — online logging is optional
            self.warning(f'online video logging failed: {e}')

    def save_gallery(self, images: np.ndarray, file_name: str, num_cols: int = 4):
        '''(N, H, W, 3) -> tiled grid image.'''
        n, h, w = images.shape[:3]
        rows = -(-n // num_cols)
        grid = np.zeros((rows * h, num_cols * w, 3), images.dtype)
        for i in range(n):
            r, c = divmod(i, num_cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = images[i][..., :3]
        return self.save_image(grid, file_name)

    def wait_pending(self):
        '''Waits for every video write submitted so far; a failed write raises here.'''
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def epoch_finished(self, epoch: int):
        self.commit_scalars(step=epoch)
        self.wait_pending()


def _write_video(fp: str, frames: np.ndarray, fps: int) -> str:
    '''Encodes (T, H, W, 3) uint8 RGB frames with cv2: VP8 into root.webm, else mp4v into
    root.mp4, whichever opens first. Returns the path written.'''
    import cv2
    T, H, W = frames.shape[:3]
    root, _ = os.path.splitext(fp)
    for fourcc, out_fp in ((cv2.VideoWriter_fourcc(*'VP80'), root + '.webm'),
                           (cv2.VideoWriter_fourcc(*'mp4v'), root + '.mp4')):
        vw = cv2.VideoWriter(out_fp, fourcc, fps, (W, H))
        if vw.isOpened():
            for t in range(T):
                vw.write(np.ascontiguousarray(frames[t][..., ::-1]))
            vw.release()
            return out_fp
    raise RuntimeError(f'no usable cv2 video codec for {fp}')


class MyLogger(Logger):
    '''Project logger: step handlers and overlay videos, at the JAX package's step
    interval.'''

    def __init__(self, args=None, context: str = 'train', log_dir: Optional[str] = None,
                 log_level: Optional[str] = None):
        if log_dir is None and args is not None:
            log_dir = getattr(args, 'log_path', '')
        if log_level is None:
            log_level = getattr(args, 'log_level', 'info') if args is not None else 'info'
        super().__init__(log_dir or '', context, log_level)
        if args is not None:
            is_debug = getattr(args, 'is_debug', False)
            log_rarely = getattr(args, 'log_rarely', 0)
            if 'train' in context:
                self.step_interval = (64 if log_rarely else 16) if not is_debug \
                    else (16 if log_rarely else 4)
            else:
                self.step_interval = (16 if log_rarely else 4) if not is_debug \
                    else (4 if log_rarely else 1)
        else:
            self.step_interval = 8

    @staticmethod
    def friendly_short_name(data_retval: Dict[str, Any], query_idx: int = 0) -> str:
        '''The join key of pick_represent: <scene_dn>_q<query> for a Kubric clip,
        <video stem>_i<dset_idx>_f<frame_start>_s<frame_stride> for a plugin clip.'''
        source_name = data_retval['source_name']
        if source_name == 'kubric':
            scene_dn = data_retval.get('scene_dn', f's{data_retval.get("scene_idx", 0)}')
            return f'{scene_dn}_q{query_idx}'
        src_path = data_retval.get('src_path', 'video')
        stem = os.path.splitext(os.path.basename(str(src_path)))[0]
        fs = int(data_retval.get('frame_start', 0))
        st = int(data_retval.get('frame_stride', 1))
        return f'{stem}_i{int(data_retval.get("dset_idx", 0))}_f{fs}_s{st}'

    def handle_train_step(self, epoch: int, phase: str, cur_step: int, total_step: int,
                          steps_per_epoch: int, data_retval, model_retval, loss_retval,
                          args=None, commit: bool = False):
        '''Console loss / IoU status line, and at every step_interval-th step the overlay
        videos of the vis step's example.'''
        total = float(loss_retval.get('total_seeker', -1.0))
        track = float(loss_retval.get('track', -1.0))
        miou = loss_retval.get('metrics', {}).get('mean_snitch_iou', -1.0)
        self.info(f'[{phase}] epoch {epoch}  step {cur_step}/{steps_per_epoch}  '
                  f'total: {total:.4f}  track: {track:.4f}  snitch IoU: {miou:.3f}')
        if cur_step % self.step_interval == 0 and model_retval is not None:
            try:
                self._save_query_overlays(phase, epoch, cur_step, data_retval, model_retval)
            except Exception as e:  # noqa: BLE001 — visualization must never kill training
                self.warning(f'overlay rendering failed: {e}')

    def handle_test_step(self, cur_step: int, data_retval, model_retval, loss_retval,
                         all_args=None) -> str:
        '''Console status line and the overlay videos of one test clip; returns the
        clip's friendly_short_name.'''
        metrics = loss_retval.get('metrics', {})
        miou = metrics.get('mean_snitch_iou', -1.0)
        name = self.friendly_short_name(data_retval)
        self.info(f'[test] step {cur_step}  {name}  snitch IoU: {miou:.3f}')
        if model_retval is not None:
            try:
                self._save_query_overlays('test', 0, cur_step, data_retval, model_retval,
                                          name_override=name)
            except Exception as e:  # noqa: BLE001 — visualization must never kill a run
                self.warning(f'overlay rendering failed: {e}')
        return name

    def _save_query_overlays(self, phase, epoch, cur_step, data_retval, model_retval,
                             name_override: Optional[str] = None):
        '''Per query (the first two of example 0): the input, magma snitch, three-channel
        and ground-truth videos, the loss-weight map in training, and with extra_visuals
        the raw channels and concatenated views in testing.'''
        to_np = lambda x: np.asarray(x, np.float32)
        rgb = to_np(model_retval['seeker_input'])        # (B, 3, T, H, W)
        out_mask = to_np(model_retval['output_mask'])    # (B, Q, C, T, H, W) or (B, C, T, H, W)
        qmask = to_np(model_retval['seeker_query_mask'])
        tmask = to_np(model_retval.get('target_mask', out_mask * 0))
        slw = model_retval.get('snitch_weights')         # (B, Q, T, H, W) or None
        slw = None if slw is None else to_np(slw)
        is_test = 'test' in phase
        online = self._wandb is not None and self.log_media_online
        if out_mask.ndim == 5:
            out_mask = out_mask[:, None]
            qmask = qmask[:, None]
            tmask = tmask[:, None]
        B, Q = out_mask.shape[:2]
        b = 0
        for q in range(min(Q, 2)):
            rgb_t = rgb[b].transpose(1, 2, 3, 0)         # (T, H, W, 3)
            om = 1.0 / (1.0 + np.exp(-out_mask[b, q]))   # sigmoid logits
            qm = qmask[b, q, 0] if qmask.ndim == 6 else qmask[b, 0]
            tm = np.clip(tmask[b, q] if tmask.ndim == 6 else tmask[b], 0, 1)
            query_border = visualization.draw_segm_borders(qm[..., None], False)
            snitch_border = visualization.draw_segm_borders(
                (tm[0] > 0.5)[..., None], False)
            front_border = visualization.draw_segm_borders(
                (tm[1] > 0.5)[..., None], False) if tm.shape[0] >= 2 else \
                np.zeros_like(snitch_border)
            outer_border = visualization.draw_segm_borders(
                (tm[2] > 0.5)[..., None], False) if tm.shape[0] >= 3 else \
                np.zeros_like(snitch_border)
            name = name_override or f'e{epoch}_p{phase}_s{cur_step}'
            vid_in = visualization.create_model_input_video(
                rgb_t.copy(), qm, visualization.draw_segm_borders(qm[..., None], False))
            self.save_video(vid_in, f'{name}_q{q}_in.webm', fps=6,
                            online_name=f'in_p{phase}' if online else None)
            vid_sn = visualization.create_model_output_snitch_video(
                rgb_t, om, query_border, snitch_border)
            self.save_video(vid_sn, f'{name}_q{q}_out_sn.webm', fps=6,
                            online_name=f'out_p{phase}_sn' if online else None)
            vid_oc = visualization.create_model_output_snitch_occl_cont_video(
                rgb_t, om, query_border, snitch_border, front_border, outer_border,
                grayscale=False)
            self.save_video(vid_oc, f'{name}_q{q}_out_oc.webm', fps=6,
                            online_name=f'out_p{phase}_oc' if online else None)
            if slw is not None and not is_test:
                vid_slw = visualization.create_snitch_weights_video(rgb_t, slw[b, q])
                self.save_video(vid_slw, f'{name}_q{q}_slw.webm', fps=6)
            vid_gt = None
            if tm.max() > 0:
                vid_gt = visualization.create_model_input_target_video(
                    rgb_t, qm, tm, query_border, snitch_border, front_border,
                    outer_border)
                self.save_video(vid_gt, f'{name}_q{q}_gt.webm', fps=6)
            if is_test and self.extra_visuals:
                extras = [np.stack([tm[1], tm[0], tm[2]], axis=-1) if tm.shape[0] >= 3
                          else np.repeat(tm[0][..., None], 3, -1),
                          np.stack([om[1], om[0], om[2]], axis=-1) if om.shape[0] >= 3
                          else np.repeat(om[0][..., None], 3, -1)]
                pause = np.concatenate([vid_oc[0:1]] * 3 + [vid_oc[1:]], axis=0)
                extras.append(np.concatenate([vid_in, vid_oc], axis=0))
                extras.append(np.concatenate([vid_in, pause], axis=2))
                if vid_gt is not None:
                    gt_pause = np.concatenate([vid_gt[0:1]] * 3 + [vid_gt[1:]], axis=0)
                    extras.append(np.concatenate([gt_pause, vid_oc], axis=0))
                    extras.append(np.concatenate([gt_pause, pause], axis=2))
                for i, vis in enumerate(extras):
                    self.save_video(vis, f'{name}_q{q}_extra{i}.webm', fps=6)
