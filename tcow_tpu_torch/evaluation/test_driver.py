'''
Evaluation driver: the port of tcow_tpu/evaluation/test_driver.py. The outer loop runs
over the data paths (one loader at a time to bound memory); Kubric scenes are scored a
device batch at a time (InferenceEngine.run_kubric), plugin videos a chunk of usage modes
at a time (run_plugin, the modes' frame indices as frame times); every clip gets a CSV
row, a friendly_short_name and its overlay videos (MyLogger.handle_test_step). The
itemized_results.csv is written with the csv module in the layout pandas'
DataFrame.to_csv gives it, then read back to recompute the weighted and unweighted
aggregates as a self-check.

At log level debug every device step logs one `eval_stats` line of JSON: the source, the
step, its clips, its host wall time and wait for the batch, the time rendering its
overlays, the kernel launches it made and, on the GPU, the peak of
torch.cuda.max_memory_allocated so far; the end of the run logs one with phase
'media_wait', the time spent waiting for the videos still being written.

With --stream_window W > 0 a plugin video is scored by streaming instead: every frame from
the first query on through a windowed cache of W frames (InferenceEngine.run_plugin_stream),
one CSV row per video whose friendly name carries frame stride 0; its eval_stats line has
phase 'plugin_stream' and the frames streamed.
'''

import csv
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from tcow_tpu_torch import resolve_device
from tcow_tpu_torch.data import data_utils, factory
from tcow_tpu_torch.evaluation import inference as inference_lib
from tcow_tpu_torch.objectives import metrics as metrics_lib
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.train import driver as train_driver


# ---------------------------------------------------------------------------------------
# Tables: the rows of a CSV, in the layout of pandas' DataFrame.to_csv
# ---------------------------------------------------------------------------------------

class Table:
    '''Rows (dicts) under an ordered list of columns, each row with an index label (0, 1,
    ... unless given): what the JAX package keeps in a pandas DataFrame. A value missing
    from a row, None, NaN or an empty CSV field are all "missing".'''

    def __init__(self, rows: Sequence[Dict[str, Any]], columns: Optional[List[str]] = None,
                 index: Optional[List[int]] = None):
        self.rows = list(rows)
        if columns is None:
            columns = []
            for row in self.rows:        # the union, in order of first appearance
                columns += [k for k in row if k not in columns]
        self.columns = list(columns)
        self.index = list(range(len(self.rows))) if index is None else list(index)

    def __len__(self):
        return len(self.rows)

    def values(self, column: str) -> list:
        return [row.get(column) for row in self.rows]

    def floats(self, column: str) -> np.ndarray:
        '''The column as float64, missing values NaN.'''
        return np.array([math.nan if _missing(v) else float(v) for v in self.values(column)],
                        np.float64)

    def select(self, mask: Sequence[bool]) -> 'Table':
        '''The rows where mask is true, keeping their index labels.'''
        keep = [i for i, m in enumerate(mask) if m]
        return Table([self.rows[i] for i in keep], self.columns,
                     [self.index[i] for i in keep])


def _missing(v) -> bool:
    return v is None or (isinstance(v, str) and v == '') or (
        isinstance(v, (float, np.floating)) and math.isnan(v))


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))


def _is_number(v) -> bool:
    return _is_int(v) or isinstance(v, (float, np.floating))


def _column_formatter(values: list):
    '''How pandas writes a column of these values: an int64 column as ints; a float64
    column (numbers with a float or a missing value among them) as Python float reprs;
    anything else (strings, bools, a mix) as str(). Missing values are empty fields.'''
    present = [v for v in values if not _missing(v)]
    has_missing = len(present) < len(values)
    if present and all(_is_int(v) for v in present) and not has_missing:
        return lambda v: str(int(v))
    if present and all(_is_number(v) for v in present):
        return lambda v: '' if _missing(v) else repr(float(v))
    if not present and has_missing:
        return lambda v: ''
    return lambda v: '' if _missing(v) else str(v)


def write_csv(path: str, table: Table):
    '''The table as pandas' DataFrame.to_csv(path) writes it: an unnamed leading column of
    index labels, minimal quoting, '\\n' line ends.'''
    fmts = [_column_formatter(table.values(c)) for c in table.columns]
    with open(path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow([''] + table.columns)
        for i, row in zip(table.index, table.rows):
            w.writerow([str(i)] + [fmt(row.get(c)) for fmt, c in zip(fmts, table.columns)])


def read_csv(path: str) -> Table:
    '''A CSV as strings, an unnamed column i named 'Unnamed: i' as pandas' read_csv names
    it; empty fields are missing.'''
    with open(path, newline='') as f:
        rows = list(csv.reader(f))
    header = [c if c else f'Unnamed: {i}' for i, c in enumerate(rows[0])] if rows else []
    return Table([dict(zip(header, r)) for r in rows[1:]], header)


# ---------------------------------------------------------------------------------------
# Rows and aggregates
# ---------------------------------------------------------------------------------------

def test_results_to_table(inference_retvals: List[Dict]) -> Table:
    '''One row per clip: source, dset_idx, scene_idx, scene_dn (Kubric), the friendly
    name, loss_<k> for each loss, then the metrics.'''
    rows = []
    for r in inference_retvals:
        row = {
            'source': r['source_name'],
            'dset_idx': r['dset_idx'],
            'scene_idx': r['scene_idx'],
        }
        if 'scene_dn' in r:
            row['scene_dn'] = r['scene_dn']
        row['friendly_short_name'] = r['friendly_short_name']
        for k, v in r['loss_retval'].items():
            if 'metrics' not in k:
                row['loss_' + k] = v
        row.update(r['loss_retval']['metrics'])
        rows.append(row)
    return Table(rows)


def calculate_weighted_averages_dataframe(table: Table) -> Dict[str, float]:
    '''Frame-weighted means of every count_* / mean_* column pair.'''
    out = {}
    for k in table.columns:
        if 'count' in k:
            counts = table.floats(k)
            means = table.floats(k.replace('count', 'mean'))
            n = counts.sum()
            out[k] = n
            out[k.replace('count', 'mean')] = \
                float((means * counts).sum() / (n + 1e-7)) if n > 0 else -1.0
    return out


def calculate_unweighted_averages_dataframe(table: Table, exclude_value=-1.0
                                            ) -> Dict[str, float]:
    '''Per-clip means of every mean_* column, excluding -1 (no valid frame).'''
    out = {}
    for k in table.columns:
        if 'count' in k:
            vals = table.floats(k.replace('count', 'mean'))
            filt = vals[vals != exclude_value]
            out[k] = len(filt)
            out[k.replace('count', 'mean')] = float(filt.mean()) if len(filt) else float('nan')
    return out


# ---------------------------------------------------------------------------------------
# The loops
# ---------------------------------------------------------------------------------------

def _log_eval_stats(logger, record: Dict[str, Any], counts, device, t_step):
    if counts is None:
        return
    if device.type == 'cuda':
        record['max_memory_allocated'] = torch.cuda.max_memory_allocated(device)
    record.update(wall_ms=(time.time() - t_step) * 1e3, launches=fa.launches_since(counts))
    logger.debug('eval_stats ' + json.dumps(record))


def _test_inner_kubric(all_args, engine, loader, logger, step_offset):
    '''Batched Kubric evaluation: the loader yields B clips per batch and ONE device step
    scores all of them; per-clip CSV rows, friendly names and pickles as the clip-at-a-time
    protocol gives them (per-example losses inside the step). A tail batch runs at its own
    size: nothing is compiled per shape, and a clip's numbers do not depend on B.'''
    retvals = []
    start_time = time.time()
    real_step = step_offset
    debug = logger.debug_enabled()
    t_mark = time.time()
    for cur_step, batch in enumerate(loader):
        t_step = time.time()
        if cur_step == 0:
            logger.info(f'Enter first data loader iteration took '
                        f'{t_step - start_time:.3f}s')
        meta = batch['meta']
        n_valid = len(meta['scene_idx'])
        counts = fa.read_launches() if debug else None
        results = engine.run_kubric(batch['device'], valid=n_valid)
        t_render = time.time()
        for j, (model_retval, loss_retval) in enumerate(results):
            retval = {
                'source_name': 'kubric',
                'dset_idx': int(meta['dset_idx'][j]),
                'scene_idx': int(meta['scene_idx'][j]),
                'scene_dn': meta['scene_dn'][j],
                'loss_retval': loss_retval,
                'model_retval': model_retval,
            }
            retval['friendly_short_name'] = logger.handle_test_step(
                real_step, {'source_name': 'kubric', 'scene_dn': retval['scene_dn'],
                            'dset_idx': retval['dset_idx']},
                model_retval, loss_retval)
            if all_args['test'].store_results:
                logger.save_pickle(
                    {k: v for k, v in retval.items() if k != 'model_retval'},
                    f'results/inference_retval_s{real_step}.p')
            retval.pop('model_retval')
            retvals.append(retval)
            real_step += 1
        _log_eval_stats(logger, {'phase': 'kubric', 'step': cur_step, 'clips': n_valid,
                                 'wait_ms': (t_step - t_mark) * 1e3,
                                 'render_ms': (time.time() - t_render) * 1e3},
                        counts, engine.device, t_step)
        t_mark = time.time()
    return retvals


def _test_inner_plugin(all_args, engine, dataset, logger, step_offset):
    '''The usage modes of one plugin video, plugin_batch modes per device step.'''
    retvals = []
    n = len(dataset)
    plugin_batch = max(1, getattr(all_args['test'], 'plugin_batch', 4))
    debug = logger.debug_enabled()
    for i0 in range(0, n, plugin_batch):
        t_load = time.time()
        # Materialize one chunk at a time (each item is a full decoded clip).
        chunk = [dataset[i] for i in range(i0, min(i0 + plugin_batch, n))]
        rgb = np.stack([it['rgb'] for it in chunk])
        query = np.stack([it['query'] for it in chunk])
        target = np.stack([it['target'] for it in chunk])
        # The true source-frame indices of each usage mode (time-calibrated rope).
        frame_times = (np.stack([it['frame_inds'] for it in chunk]).astype(np.float32)
                       if 'frame_inds' in chunk[0] else None)
        t_step = time.time()
        counts = fa.read_launches() if debug else None
        results = engine.run_plugin(rgb, query, target, frame_times=frame_times)
        t_render = time.time()
        for j, (model_retval, loss_retval) in enumerate(results):
            it = chunk[j]
            real_step = i0 + j + step_offset
            retval = {
                'source_name': 'plugin',
                'dset_idx': int(it['dset_idx']),
                'scene_idx': int(it['scene_idx']),
                'loss_retval': loss_retval,
            }
            retval['friendly_short_name'] = logger.handle_test_step(
                real_step, it, model_retval, loss_retval)
            if all_args['test'].store_results:
                logger.save_pickle(retval, f'results/inference_retval_s{real_step}.p')
            retvals.append(retval)
        _log_eval_stats(logger, {'phase': 'plugin', 'step': i0 // plugin_batch,
                                 'clips': len(chunk), 'wait_ms': (t_step - t_load) * 1e3,
                                 'render_ms': (time.time() - t_render) * 1e3},
                        counts, engine.device, t_step)
    return retvals


def _test_inner_plugin_stream(all_args, engine, dataset, logger, step_offset, window: int):
    '''Streaming evaluation of a plugin video (test_driver.py:130-150 of the JAX
    package): windowed cached inference over EVERY frame, scored at the annotated frames,
    one retval per video.'''
    t_load = time.time()
    ex = dataset.get_streaming_example()
    t_step = time.time()
    counts = fa.read_launches() if logger.debug_enabled() else None
    model_retval, loss_retval = engine.run_plugin_stream(ex, window=window)
    t_render = time.time()
    retval = {
        'source_name': 'plugin',
        'dset_idx': 0,
        'scene_idx': 0,
        'loss_retval': loss_retval,
    }
    data_retval = {k: ex[k] for k in ('source_name', 'src_path', 'dset_idx', 'scene_idx',
                                      'frame_start', 'frame_stride')}
    data_retval['frame_stride'] = 0  # marks the streaming protocol in friendly names
    retval['friendly_short_name'] = logger.handle_test_step(
        step_offset, data_retval, model_retval, loss_retval)
    if all_args['test'].store_results:
        logger.save_pickle(retval, f'results/inference_retval_s{step_offset}.p')
    _log_eval_stats(logger, {'phase': 'plugin_stream', 'step': 0, 'clips': 1,
                             'frames': int(ex['num_frames']),
                             'wait_ms': (t_step - t_load) * 1e3,
                             'render_ms': (time.time() - t_render) * 1e3},
                    counts, engine.device, t_step)
    return [retval]


def _test_postprocess(inference_retvals, logger):
    '''Aggregation, the CSV export and the self-check that recomputes both aggregates
    from the CSV as written.'''
    metrics_retvals = [r['loss_retval']['metrics'] for r in inference_retvals]
    final_weighted = metrics_lib.calculate_weighted_averages(metrics_retvals)
    final_unweighted = metrics_lib.calculate_unweighted_averages(metrics_retvals)

    logger.info('')
    for k in sorted(metrics_lib.METRIC_KEYS):
        logger.info(f'unweighted_mean_{k} (over {len(metrics_retvals)} scenes): '
                    f'{final_unweighted[f"mean_{k}"]:.5f}')
    logger.info('')
    for k in sorted(metrics_lib.METRIC_KEYS):
        logger.info(f'weighted_mean_{k} (over {final_weighted[f"count_{k}"]:.0f} frames): '
                    f'{final_weighted[f"mean_{k}"]:.5f}')

    for k in sorted(metrics_lib.METRIC_KEYS):  # wandb run-summary values
        logger.report_single_scalar(f'weighted_mean_{k}', final_weighted[f'mean_{k}'])
        logger.report_single_scalar(f'unweighted_mean_{k}', final_unweighted[f'mean_{k}'])

    table = test_results_to_table(inference_retvals)
    csv_fp = os.path.join(logger.log_dir, 'itemized_results.csv')
    write_csv(csv_fp, table)
    logger.info(f'Exported quantitative results to: {csv_fp}')

    # Self-check: the aggregates recomputed from the CSV must match.
    written = read_csv(csv_fp)
    verify_w = calculate_weighted_averages_dataframe(written)
    verify_u = calculate_unweighted_averages_dataframe(written)
    for kind, verify, final in (('Weighted', verify_w, final_weighted),
                                ('Unweighted', verify_u, final_unweighted)):
        for k, v in verify.items():
            if not (np.isnan(v) or np.isnan(final[k])) and not np.isclose(v, final[k]):
                logger.error(f'{kind} metric {k} does not match! {v} vs {final[k]}')
    if len(inference_retvals) >= 20:
        logger.warning('Metrics here cover ALL sampled clips; for the paper protocol run '
                       'pick_represent for a balanced evaluation (README).')
    return final_weighted, final_unweighted, table


def main(test_args, logger):
    '''Loads the checkpoint of --resume, evaluates every --data_path, writes
    itemized_results.csv under the test log directory; returns (weighted aggregates,
    unweighted aggregates, the CSV's Table).'''
    device = resolve_device(test_args.device)
    logger.save_args(test_args, 'test')
    np.random.seed(test_args.seed)

    avoid_wandb = int(getattr(test_args, 'avoid_wandb', 0))
    if avoid_wandb < 2:
        logger.init_wandb('tcow', test_args, name=test_args.name or None,
                          group=getattr(test_args, 'wandb_group', 'test'))
    logger.log_media_online = (avoid_wandb == 0)
    logger.extra_visuals = bool(getattr(test_args, 'extra_visuals', False))

    logger.info('Initializing model...')
    compute_dtype = torch.bfloat16 if test_args.compute_dtype == 'bfloat16' else torch.float32
    params, cfg, train_args, train_dset_args, seeker_args, epoch = \
        inference_lib.load_networks(test_args.resume, logger, epoch=test_args.epoch,
                                    compute_dtype=compute_dtype, device=device)

    # The loss config comes from the stored train args (defaults where missing).
    loss_cfg = train_driver.loss_config_from_args(_DictNS(train_args))
    engine = inference_lib.InferenceEngine(params, cfg, loss_cfg, test_args.num_queries,
                                           device=device)

    all_args = {'train': train_args, 'test': test_args, 'train_dset': train_dset_args}

    actual_data_paths = data_utils.get_data_paths_from_args(test_args.data_path)
    inference_retvals = []
    step_offset = 0
    outer_start = time.time()
    logger.info('Starting outer test loop over individual data paths...')
    for outer_step, cur_data_path in enumerate(actual_data_paths):
        logger.info(f'[{outer_step + 1}/{len(actual_data_paths)}] {cur_data_path}')
        loader, test_dset_args = factory.create_test_data_loader(
            train_args, test_args, train_dset_args, logger, data_path=cur_data_path)
        if outer_step == 0:
            logger.info('Final (first) test dataset args: ' + str(test_dset_args))
        stream_window = int(getattr(test_args, 'stream_window', 0) or 0)
        if 'plugin' in test_dset_args and stream_window > 0:
            cur = _test_inner_plugin_stream(all_args, engine, loader.dataset, logger,
                                            step_offset, stream_window)
        elif 'plugin' in test_dset_args:
            cur = _test_inner_plugin(all_args, engine, loader.dataset, logger, step_offset)
        else:
            cur = _test_inner_kubric(all_args, engine, loader, logger, step_offset)
        inference_retvals += cur
        step_offset += len(cur)
        del loader

    result = _test_postprocess(inference_retvals, logger)
    t_wait = time.time()
    logger.epoch_finished(0)
    if logger.debug_enabled():
        logger.debug('eval_stats ' + json.dumps(
            {'phase': 'media_wait', 'wall_ms': (time.time() - t_wait) * 1e3}))
    logger.info(f'Total time: {(time.time() - outer_start) / 3600.0:.3f} hours')
    return result


class _DictNS:
    '''Attribute view over a dict of train args with the train flags' loss defaults.'''
    _DEFAULTS = dict(track_lw=1.0, occl_mask_lw=0.5, cont_mask_lw=0.5, occluded_weight=5.0,
                     occl_cont_zero_weight=0.02, class_balancing=True, focal_loss=False,
                     aot_loss=0.8, hard_negative_factor=3.0, front_occl_thres=0.95,
                     outer_cont_thres=0.75)

    def __init__(self, d: Dict[str, Any]):
        self._d = dict(self._DEFAULTS)
        self._d.update(d or {})

    def __getattr__(self, k):
        try:
            return self._d[k]
        except KeyError:
            raise AttributeError(k) from None
