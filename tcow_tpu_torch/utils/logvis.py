'''
Training logger: the port's copy of the part of tcow_tpu/utils/logvis.py that the driver
needs (:51-224, :240-373): console + per-experiment file logging, scalar reporting with
per-epoch weighted accumulation (report_scalar(remember=True) / commit_scalars) into
<log_dir>/scalars.jsonl, optional wandb (gated: it runs without the package), the args
file, and the train-step status line.

The media writers (images, videos, galleries) and the train overlays need a video
encoder, which the port does not have; they wait (ROADMAP.md section 1 item 2).
'''

import json
import logging
import os
import sys
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


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
    '''Generic scalar logger.'''

    def __init__(self, log_dir: str = '', context: str = 'main', log_level: str = 'info'):
        self.log_dir = log_dir
        self.context = context
        self._logger = _make_console_logger(log_dir, context, log_level)
        self._scalar_memory = defaultdict(list)        # key -> [(value, weight)]
        self._wandb = None
        # --avoid_wandb gradations: 1 keeps scalars online but not media.
        self.log_media_online = True

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
        '''Closes the file handlers (a logger per run in one process keeps no files open).'''
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

    def epoch_finished(self, epoch: int):
        self.commit_scalars(step=epoch)


class MyLogger(Logger):
    '''Project logger: the train-step status line, at the JAX package's step interval.'''

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

    def handle_train_step(self, epoch: int, phase: str, cur_step: int,
                          steps_per_epoch: int, loss_retval):
        '''The console loss / IoU status line of a vis step (the overlay videos wait).'''
        total = float(loss_retval.get('total_seeker', -1.0))
        track = float(loss_retval.get('track', -1.0))
        miou = loss_retval.get('metrics', {}).get('mean_snitch_iou', -1.0)
        self.info(f'[{phase}] epoch {epoch}  step {cur_step}/{steps_per_epoch}  '
                  f'total: {total:.4f}  track: {track:.4f}  snitch IoU: {miou:.3f}')
