#!/usr/bin/env python3
'''Dataset lint for the PyTorch port's Kubric reader: verify every scene can support the
requested query count. The counterpart of tools/validate_dataset.py, with its flags, its
output and its exit code.

A Kubric-format scene is only trainable if at least `num_queries` instances have positive
query desirability (visible at the query frame etc.; data/query_sampling.py). A scene that
fails this check does not crash training: the reader's retry protocol
(data/kubric.py:__getitem__) resamples another scene, but each failed attempt raises
after augmentation and verification, and with temporal augmentations the failed variant
often misses the preprocessing cache, costing a full re-preprocess every epoch. Run this
once after generating or downloading a dataset to find such scenes.

Checks per scene:
  1. base: deterministic no-aug load; count instances with desirability > 0.
  2. aug probes (--aug_probes N): N augmented loads with distinct RNG streams; count how
     many fail the reader's verify step (augmentations move the query frame, so a scene
     can pass (1) but still fail intermittently under augmentation).

Exit code 1 if any scene fails the base check at --num_queries.

Usage:
  python tools/torch_validate_dataset.py --data_path DIR/train --num_queries 3 \
      [--num_frames 24 --frame_height 240 --frame_width 320] [--aug_probes 3]
'''

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcow_tpu_torch.data.kubric import KubricQueryDataset  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--data_path', required=True)
    p.add_argument('--num_queries', type=int, default=3)
    p.add_argument('--num_frames', type=int, default=24)
    p.add_argument('--frame_height', type=int, default=240)
    p.add_argument('--frame_width', type=int, default=320)
    p.add_argument('--aug_probes', type=int, default=0,
                   help='augmented loads per scene (0 = base check only; probes build '
                        'preprocess caches as a side effect, like torch_warm_cache.py)')
    p.add_argument('--use_cache', type=int, default=1)
    a = p.parse_args(argv)

    base_ds = KubricQueryDataset(
        a.data_path, None, 'val_noaug', num_frames=a.num_frames,
        frame_height=a.frame_height, frame_width=a.frame_width,
        num_queries=a.num_queries, use_cache=bool(a.use_cache))
    aug_ds = None
    if a.aug_probes > 0:
        aug_ds = KubricQueryDataset(
            a.data_path, None, 'train', num_frames=a.num_frames,
            frame_height=a.frame_height, frame_width=a.frame_width,
            num_queries=a.num_queries, use_cache=bool(a.use_cache))

    bad = []
    for si, scene_dp in enumerate(base_ds.scene_dps):
        scene_dn = os.path.basename(scene_dp)
        rng = np.random.default_rng(si)
        try:
            item = base_ds._load_example(scene_dp, rng)
            K = int(item['inst_count'])
            valid = int((np.asarray(item['desirability'])[:K, 0] > 0.0).sum())
            ok = valid >= a.num_queries
        except Exception as e:   # noqa: BLE001 — a scene that fails to load is reported
            valid, ok = 0, False
            print(f'  {scene_dn}: base load FAILED: {e}')
        aug_fail = 0
        if aug_ds is not None and ok:
            for probe in range(a.aug_probes):
                try:
                    aug_ds._load_example(scene_dp, np.random.default_rng(si * 1000 + probe))
                except Exception:   # noqa: BLE001 — counted as a failed probe
                    aug_fail += 1
        verdict = 'OK' if ok and aug_fail == 0 else ('MARGINAL' if ok else 'BAD')
        if not ok:
            bad.append(scene_dn)
        probe_txt = (f'  aug_failures={aug_fail}/{a.aug_probes}' if aug_ds is not None
                     else '')
        print(f'  {scene_dn}: valid_queries={valid} (need {a.num_queries}) '
              f'{verdict}{probe_txt}')

    n = len(base_ds.scene_dps)
    print(f'{n - len(bad)}/{n} scenes support num_queries={a.num_queries}'
          + (f'; BAD: {", ".join(bad)}' if bad else ''))
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
