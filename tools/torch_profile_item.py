#!/usr/bin/env python3
'''Profile the PyTorch port's warm host item pipeline (data/kubric.py): the counterpart
of tools/profile_item.py, with its flags.

Times N warm items from a Kubric-format scene root on the flagship loader configuration
(T=30 at 240x320, 3 queries, device colour jitter), then collate at B=2, and prints a
cProfile of the items by cumulative time. Host only: no device is touched (results are
meaningful on an idle core).

Usage: python tools/torch_profile_item.py --data_path DIR [--items 8]
'''

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tcow_tpu_torch.data.kubric import KubricQueryDataset, collate_kubric  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--data_path', required=True)
    ap.add_argument('--items', type=int, default=8)
    ap.add_argument('--num_frames', type=int, default=30)
    ap.add_argument('--profile', type=int, default=1, help='also run cProfile')
    args = ap.parse_args(argv)

    ds = KubricQueryDataset(args.data_path, None, 'train', num_frames=args.num_frames,
                            frame_height=240, frame_width=320, num_queries=3,
                            device_color_jitter=True)
    n = min(args.items, len(ds))
    # Warm pass (builds or loads the caches; not timed).
    for i in range(n):
        ds[i]
    t0 = time.perf_counter()
    items = [ds[i] for i in range(n)]
    t1 = time.perf_counter()
    print(f'warm item: {(t1 - t0) / n * 1000:.0f} ms/item over {n} items')
    t2 = time.perf_counter()
    for i in range(0, n - 1, 2):
        collate_kubric(items[i:i + 2], 3, 'train')
    t3 = time.perf_counter()
    print(f'collate(B=2): {(t3 - t2) / max(1, (n - 1) // 2) * 1000:.0f} ms/batch')

    if args.profile:
        pr = cProfile.Profile()
        pr.enable()
        for i in range(n):
            ds[i]
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats('cumulative').print_stats(30)
        print(s.getvalue())


if __name__ == '__main__':
    sys.exit(main())
