'''
Representative-subset aggregation of test results: the port of
tcow_tpu/evaluation/pick_represent.py, on the csv module. It globs test-result folders and
guide files, selects the itemized_results.csv rows whose friendly_short_name matches a
guide line (a regular expression searched in it; `scene,friendly` also filters on
scene_dn), re-averages the metrics weighted and unweighted, copies the matching overlay
videos, and writes a summary _autosmr_<i>.csv.

Run: python -m tcow_tpu_torch.evaluation.pick_represent --testres_path 'logs/v1/test_*' \
    --represent_guide rep_lists/demo_rollball.txt --output_dir represent/
'''

import argparse
import glob
import os
import pathlib
import re
import shutil
import sys
from typing import List

from tcow_tpu_torch.evaluation import test_driver
from tcow_tpu_torch.evaluation.test_driver import Table


def read_txt_strip_comments(txt_fp: str) -> List[str]:
    with open(txt_fp, 'r') as f:
        lines = [x.split('#')[0].strip() for x in f.readlines()]
    return [x for x in lines if x]


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--testres_path', required=True, type=str, nargs='+')
    parser.add_argument('--represent_guide', required=True, type=str, nargs='+')
    parser.add_argument('--output_dir', required=True, type=str)
    parser.add_argument('--notes_path', default='', type=str)
    parser.add_argument('--video_suffix', default=['in.webm', 'out_oc.webm', 'out_sn.webm',
                                                   'out.webm', 'out.mp4'],
                        type=str, nargs='+')
    parser.add_argument('--no_video_copy_for', default=['kubcon'], type=str, nargs='*')
    parser.add_argument('--write_summary', default=True,
                        type=lambda v: str(v).lower() in ('1', 'true', 'yes', 'y', 't'))
    return parser.parse_args(argv)


def _contains(values, pattern: str) -> List[bool]:
    '''pandas' Series.str.contains: a regular expression searched in each string; a
    missing value matches nothing.'''
    rx = re.compile(pattern)
    return [bool(v) and rx.search(v) is not None for v in values]


def construct_summary(my_args, actual_guide_paths, actual_testres_paths, model_notes,
                      logger) -> Table:
    summary = []
    for cur_guide_fp in actual_guide_paths:
        guide_name = str(pathlib.Path(cur_guide_fp).name).split('.')[0]
        logger.info(f'Processing guide {cur_guide_fp}...')
        lines = sorted(read_txt_strip_comments(cur_guide_fp))
        if not lines:
            logger.warning(f'Guide {guide_name} seems empty? Skipping...')
            continue

        for src_dp in actual_testres_paths:
            src_csv_fp = os.path.join(src_dp, 'itemized_results.csv')
            if not os.path.exists(src_csv_fp):
                logger.warning(f'CSV file not found: {src_csv_fp}! Skipping...')
                continue
            csv = test_driver.read_csv(src_csv_fp)
            names = csv.values('friendly_short_name')
            agg_mask = _contains(names, lines[0])
            for cand in lines:
                if ',' in cand and 'scene_dn' in csv.columns:
                    cand_scene, cand_friendly = cand.split(',')[:2]
                    cur = _contains(csv.values('scene_dn'), cand_scene)
                    if cand_friendly:
                        cur = [a and b for a, b in zip(cur, _contains(names, cand_friendly))]
                else:
                    cur = _contains(names, cand)
                agg_mask = [a or b for a, b in zip(agg_mask, cur)]
            sel = csv.select(agg_mask)
            if len(sel) == 0:
                continue

            src_dn = str(pathlib.Path(src_dp).name)
            dst_dp = os.path.join(my_args.output_dir, src_dn + '_ar_' + guide_name)
            os.makedirs(dst_dp, exist_ok=True)
            test_driver.write_csv(os.path.join(dst_dp, f'z_filt_item_res_{guide_name}.csv'),
                                  sel)

            w = test_driver.calculate_weighted_averages_dataframe(sel)
            u = test_driver.calculate_unweighted_averages_dataframe(sel)
            w = {k: v for k, v in sorted(w.items())
                 if ('count' in k and v > 0) or ('mean' in k and v > -1.0)}
            u = {k: v for k, v in sorted(u.items())
                 if ('count' in k and v > 0) or ('mean' in k and v > -1.0)}
            with open(os.path.join(dst_dp, f'z_metrics_{guide_name}.txt'), 'w') as f:
                f.write(f'Logs: {src_dn}\nGuide: {guide_name}\n'
                        f'Selected number of examples: {len(sel)}\n\nWeighted:\n')
                f.writelines([f'{k}: {v}\n' for k, v in sorted(w.items())])
                f.write('\nUnweighted:\n')
                f.writelines([f'{k}: {v}\n' for k, v in sorted(u.items())])

            if not any(x in guide_name.lower() for x in my_args.no_video_copy_for):
                src_vid_fps = set()
                for name in sel.values('friendly_short_name'):
                    for suffix in my_args.video_suffix:
                        src_vid_fps.update(glob.glob(os.path.join(
                            src_dp, 'visuals', '*' + str(name) + '*' + suffix)))
                for fp in sorted(src_vid_fps):
                    dst = os.path.join(dst_dp, str(pathlib.Path(fp).name))
                    if not os.path.exists(dst):
                        shutil.copyfile(fp, dst)

            note = {'notes': ' '}
            for pat, val in model_notes.items():
                if pat in src_dn:
                    note = {'notes': val}
                    break
            summary.append({'guide': guide_name, 'testres_dn': src_dn, **note,
                            'num_examples': len(sel),
                            **{'weighted_' + k: v for k, v in w.items()},
                            **{'unweighted_' + k: v for k, v in u.items()}})
            logger.info(f'Subselected {len(sel)} entries for: {src_dn}')
    return Table(summary)


def main(my_args, logger) -> Table:
    actual_testres_paths = []
    for dp in my_args.testres_path:
        actual_testres_paths += glob.glob(dp)
    logger.info(f'Found {len(actual_testres_paths)} test result folders.')
    actual_guide_paths = []
    for fp in my_args.represent_guide:
        actual_guide_paths += glob.glob(fp)
    logger.info(f'Found {len(actual_guide_paths)} guide files.')

    model_notes = {}
    if my_args.notes_path and os.path.exists(my_args.notes_path):
        for line in read_txt_strip_comments(my_args.notes_path):
            pat, note = line.split('=')[:2]
            model_notes[pat.strip()] = note.strip()

    os.makedirs(my_args.output_dir, exist_ok=True)
    summary = construct_summary(my_args, actual_guide_paths, actual_testres_paths,
                                model_notes, logger)
    if my_args.write_summary:
        i = 0
        while os.path.exists(os.path.join(my_args.output_dir, f'_autosmr_{i}.csv')):
            i += 1
        test_driver.write_csv(os.path.join(my_args.output_dir, f'_autosmr_{i}.csv'), summary)
    logger.info('Done!')
    return summary


def cli(argv=None) -> int:
    from tcow_tpu_torch.utils.logvis import Logger
    logger = Logger(context='pickrep')
    try:
        main(get_args(argv), logger)
    finally:
        logger.close()
    return 0


if __name__ == '__main__':
    sys.exit(cli())
