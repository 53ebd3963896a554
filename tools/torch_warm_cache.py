#!/usr/bin/env python3
'''
Bulk-precomputes the PyTorch port's Kubric preprocessing caches (decode + hue->ID +
occlusion stats + DAG, the `cc_torch_*` directories of tcow_tpu_torch/data/kubric.py) for
a dataset root, so training never waits on first-epoch preprocessing: the counterpart of
tools/warm_cache.py, with its flags.

  python tools/torch_warm_cache.py --data_path DIR --num_frames 30 --max_delay 6 \
      --workers 16

One pass per scene warms a dataset configuration: the cache key is the LOADED frame index
set, range(0, (num_frames + max_delay) * stride, stride); temporal augmentations permute
indices inside the loaded window and never change the key. Re-warm only when num_frames,
max_delay or frame_stride change. Host only: no device is touched.
'''

import argparse
import concurrent.futures
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcow_tpu_torch.data.kubric import KubricQueryDataset  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data_path', required=True)
    p.add_argument('--num_frames', type=int, default=24)
    p.add_argument('--max_delay', type=int, default=6)
    p.add_argument('--frame_stride', type=int, default=1)
    p.add_argument('--workers', type=int, default=max(os.cpu_count() - 1, 1))
    p.add_argument('--phases', nargs='+', default=['train', 'val', 'test'])
    a = p.parse_args(argv)

    for phase in a.phases:
        try:
            ds = KubricQueryDataset(
                a.data_path, None, phase, num_frames=a.num_frames,
                frame_stride=a.frame_stride, max_delay=a.max_delay, num_queries=1,
                augs_2d=False, frame_height=64, frame_width=64)
        except (ValueError, FileNotFoundError):
            continue
        if len(ds) == 0:
            continue
        print(f'[{phase}] warming {ds.dset_size} scene caches with {a.workers} workers...')
        t0 = time.time()
        done = 0

        def warm(i):
            # Only the cached preprocessing matters; augmentations are cheap and random.
            ds[i]
            return i

        with concurrent.futures.ThreadPoolExecutor(a.workers) as pool:
            for _ in pool.map(warm, range(ds.dset_size)):
                done += 1
                if done % 50 == 0:
                    rate = done / (time.time() - t0)
                    print(f'  {done}/{ds.dset_size} ({rate:.2f} scenes/s)', flush=True)
        print(f'[{phase}] done in {time.time() - t0:.1f}s', flush=True)


if __name__ == '__main__':
    main()
