'''
Dataset / loader factory: the port's copy of tcow_tpu/data/factory.py. Source sniffing
(Kubric vs plugin video by path), the bounded-prefetch batcher, the train / val_aug /
val_noaug Kubric loaders, and one test loader per data path: Kubric scenes with the
train dset_args and the test overrides (use_data_frac, augs_2d off, num_queries), or a
plugin video with the test flags (prefetch, center_crop). Any directory that is not a
plugin video source is read as Kubric-format.

The loader's workers are threads ('thread', the default) or processes ('process', one
pool per epoch, so item loading scales with cores where the numpy item pipeline would
serialize on the interpreter lock). Items are pure functions of (seed, epoch, index,
retries) (kubric.py:_item_rng) and collation runs in the parent on a sequential RNG
stream, so both modes give the same batches.
'''

import concurrent.futures
import multiprocessing as mp
import queue
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from tcow_tpu_torch.data import kubric as kubric_lib
from tcow_tpu_torch.data import plugin as plugin_lib
from tcow_tpu_torch.parallel.mesh import shard_rows

# Process workers are forked from a forkserver, never from the trainer: the trainer has
# touched CUDA and runs threads by the time a pool starts, and a child forked from it
# would inherit that state. The forkserver is a fresh interpreter that imports the data
# path once (and no CUDA); its children unpickle the dataset from the pool initializer.
WORKER_START_METHOD = 'forkserver'
_FORKSERVER_PRELOAD = ['tcow_tpu_torch.data.kubric']

# The dataset bound in a process worker by the pool initializer.
_WORKER_DATASET = None


def is_kubric_source(p: str) -> bool:
    pl = p.lower()
    return 'kubcon' in pl or 'kubbench' in pl or 'kubric' in pl


def is_plugin_source(p: str) -> bool:
    pl = p.lower()
    return ('plugin' in pl or 'rubric' in pl
            or pl.endswith(('.mp4', '.avi', '.gif', '.webm')))


def _bind_worker_dataset(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _process_worker_getitem(idx: int):
    return _WORKER_DATASET[idx]


class PrefetchLoader:
    '''Iterates a dataset in batches with background workers + bounded prefetch.

    worker_mode 'thread' shares the parent's interpreter lock (fine when item decode is
    numpy-bound on few cores); 'process' starts a pool of WORKER_START_METHOD processes
    per epoch so item loading scales with cores. Collation always happens in the parent
    (its RNG is a sequential stream), so batches are identical across modes.

    shard_rank/shard_count: each process loads ONLY its batch_size / shard_count rows of
    every global batch (rows [rank*B_local, (rank+1)*B_local) of the shared same-seed
    global order); with microbatches = A > 1 (the train step's grad_accum) its rows of
    each of the A microbatches in turn (parallel/mesh.py:shard_rows), collated in that
    order, as A consecutive batches of batch_size / A would be.'''

    def __init__(self, dataset, batch_size: int, collate_fn: Callable, shuffle: bool,
                 drop_last: bool, num_workers: int = 2, prefetch_depth: int = 2,
                 seed: int = 0, worker_mode: str = 'thread',
                 shard_rank: int = 0, shard_count: int = 1, microbatches: int = 1):
        if worker_mode not in ('thread', 'process'):
            raise ValueError(f'worker_mode must be thread or process, got {worker_mode}')
        if not 0 <= shard_rank < shard_count:
            raise ValueError(f'bad shard {shard_rank}/{shard_count} of batch {batch_size}')
        self.rows = shard_rows(batch_size, shard_rank, shard_count, microbatches)
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = prefetch_depth
        self.seed = seed
        self.worker_mode = worker_mode
        self.shard_rank = shard_rank
        self.shard_count = shard_count
        self.epoch = 0
        self._ahead = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        return self.iter_batches(0)

    def batch_order(self) -> List[np.ndarray]:
        '''This epoch's batches of dataset indices: a pure function of (seed, epoch).'''
        rng = np.random.default_rng(self.seed * 77 + self.epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        return [order[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def start_ahead(self, epoch: int, prefetch_depth: Optional[int] = None):
        '''Begin producing epoch `epoch`'s batches into the bounded prefetch queue now,
        e.g. a validation loader's item pipeline while the train epoch still runs on the
        device, so the val epoch does not start on a cold pipeline. The next
        iter_batches(0) at this epoch consumes the pre-started producer; any other
        iteration tears it down. `prefetch_depth` overrides the queue bound for the
        pre-started producer (a whole small val epoch can be staged during a train
        epoch); item memory stays bounded by depth x batch bytes.'''
        self.set_epoch(epoch)
        self.teardown_ahead()
        self._ahead = (epoch, self._spawn(0, prefetch_depth=prefetch_depth))

    def teardown_ahead(self):
        if self._ahead is not None:
            self._ahead[1][1].set()  # stop event: producer drains and exits
            self._ahead = None

    def iter_batches(self, start_step: int = 0):
        '''Iterate this epoch's batches from `start_step` onward. The batch ORDER is a
        pure function of (seed, epoch), so a mid-epoch resume (preemption checkpoint)
        skips the first `start_step` batches without loading a single item and visits
        exactly the examples the interrupted run had left.'''
        ahead = self._ahead
        if ahead is not None and ahead[0] == self.epoch and start_step == 0:
            self._ahead = None
            handle = ahead[1]
        else:
            self.teardown_ahead()
            handle = self._spawn(start_step)
        q, stop = handle
        try:
            while True:
                kind, payload = q.get()
                if kind == 'done':
                    return
                if kind == 'err':
                    raise payload
                yield payload
        finally:
            stop.set()

    def _make_pool(self):
        if self.worker_mode == 'process':
            ctx = mp.get_context(WORKER_START_METHOD)
            ctx.set_forkserver_preload(_FORKSERVER_PRELOAD)
            pool = concurrent.futures.ProcessPoolExecutor(
                self.num_workers, mp_context=ctx, initializer=_bind_worker_dataset,
                initargs=(self.dataset,))
            return pool, _process_worker_getitem
        return (concurrent.futures.ThreadPoolExecutor(self.num_workers),
                self.dataset.__getitem__)

    def _spawn(self, start_step: int, prefetch_depth: Optional[int] = None):
        '''Starts the producer thread for this epoch; returns (queue, stop_event).'''
        batches = self.batch_order()[start_step:]
        if self.shard_count > 1:
            batches = [b[self.rows] for b in batches]

        q: 'queue.Queue' = queue.Queue(maxsize=prefetch_depth or self.prefetch_depth)
        stop = threading.Event()

        def safe_put(payload) -> bool:
            # Never block forever on a full queue: an abandoned iteration (consumer broke
            # out early) would otherwise leave the producer and its pool alive.
            while not stop.is_set():
                try:
                    q.put(payload, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                pool, getitem = self._make_pool()
            except Exception as e:  # noqa: BLE001 — re-raised in the consumer
                safe_put(('err', e))
                return
            with pool:
                for batch_inds in batches:
                    if stop.is_set():
                        return
                    try:
                        items = list(pool.map(getitem, batch_inds))
                        if not safe_put(('ok', self.collate_fn(items))):
                            return
                    except Exception as e:  # noqa: BLE001 — re-raised in the consumer
                        safe_put(('err', e))
                        return
            safe_put(('done', None))

        threading.Thread(target=producer, daemon=True).start()
        return q, stop


def device_color_jitter(args) -> bool:
    '''--device_augs: 0 / 1 force the host / device colour path; -1 (auto) colours on the
    device for a CUDA run and on the host on the CPU, as the JAX package colours on the
    device on its accelerator and on the host elsewhere.'''
    v = int(getattr(args, 'device_augs', -1))
    if v >= 0:
        return bool(v)
    return torch.device(getattr(args, 'device', 'cuda')).type == 'cuda'


def kubric_dset_args(args) -> Dict[str, Any]:
    return dict(
        device_color_jitter=device_color_jitter(args),
        num_frames=args.num_frames, frame_height=args.frame_height,
        frame_width=args.frame_width, frame_rate=args.kubric_frame_rate,
        frame_stride=args.kubric_frame_stride, max_delay=args.kubric_max_delay,
        use_data_frac=args.use_data_frac, augs_2d=args.augs_2d,
        num_queries=args.num_queries, query_time=args.seeker_query_time,
        max_objects=int(getattr(args, 'max_objects', 36)),
        front_occl_thres=args.front_occl_thres,
        outer_cont_thres=args.outer_cont_thres, reverse_prob=args.kubric_reverse_prob,
        palindrome_prob=args.kubric_palindrome_prob,
        time_stretch_max=(float(getattr(args, 'rope_time_stretch', 1.0))
                          if int(getattr(args, 'rope_time_coords', 0)) else 1.0))


def create_train_val_data_loaders(args, logger, shard=(0, 1)):
    '''(train_loader, val_aug_loader, val_noaug_loader, dset_args_sources).
    shard=(rank, world) makes each rank load only its rows of every global batch: the
    train loader's interleaved per microbatch under --grad_accum (PrefetchLoader).'''
    dset_args_sources = {}
    loaders = {}
    accum = max(1, int(getattr(args, 'grad_accum', 1)))
    for cur_data_path in args.data_path:
        if is_plugin_source(cur_data_path):
            raise NotImplementedError('Plugin video is only available at test time.')
        dset_args = kubric_dset_args(args)
        dset_args_sources['kubric'] = dset_args
        for phase, enabled in (('train', True), ('val_aug', args.do_val_aug),
                               ('val_noaug', args.do_val_noaug)):
            if not enabled:
                loaders.setdefault(phase, None)
                continue
            ds = kubric_lib.KubricQueryDataset(cur_data_path, logger, phase,
                                               seed=args.seed, **dset_args)
            collate = make_kubric_collate(args.num_queries, phase, args.seed)
            mode = getattr(args, 'worker_mode', 'thread')
            # Threads stop paying off past the interpreter lock; processes scale with cores.
            cap = 8 if mode == 'thread' else 32
            loaders[phase] = PrefetchLoader(ds, args.batch_size, collate, shuffle=True,
                                            drop_last=True,
                                            num_workers=min(args.num_workers, cap),
                                            seed=args.seed, worker_mode=mode,
                                            shard_rank=shard[0], shard_count=shard[1],
                                            microbatches=accum if phase == 'train' else 1)
    return loaders['train'], loaders['val_aug'], loaders['val_noaug'], dset_args_sources


class KubricCollate:
    '''The loader's collate: collate_kubric on a sequential query-sampling RNG stream,
    seeded from (seed, phase) as the JAX package seeds it. Each batch's meta carries the
    stream's state after its collation (collate_rng_after), so a checkpoint can store the
    state after the last batch a step consumed and a resumed run can continue the stream
    there (restore()): with it, a preempted and resumed run samples the queries of an
    uninterrupted one.'''

    def __init__(self, num_queries: int, phase: str, seed: int):
        self.num_queries = num_queries
        self.phase = phase
        # zlib.crc32, not hash(): Python string hashes are randomized per process, which
        # would make query selection irreproducible across runs.
        self.rng = np.random.default_rng(seed * 31 + zlib.crc32(phase.encode()) % 1000)

    def restore(self, rng_state: Dict[str, Any]):
        self.rng.bit_generator.state = rng_state

    def __call__(self, items: List[Dict]) -> Dict[str, Any]:
        batch = kubric_lib.collate_kubric(items, self.num_queries, self.phase, rng=self.rng)
        batch_meta = {
            'source_name': 'kubric',
            'scene_dn': [it['scene_dn'] for it in items],
            'scene_idx': np.array([it['scene_idx'] for it in items]),
            'dset_idx': np.array([it['dset_idx'] for it in items]),
            'inst_count': np.array([it['inst_count'] for it in items]),
            'desirability': np.stack([it['desirability'] for it in items]),
            'collate_rng_after': self.rng.bit_generator.state,
        }
        return {'device': batch, 'meta': batch_meta}


def make_kubric_collate(num_queries: int, phase: str, seed: int) -> KubricCollate:
    return KubricCollate(num_queries, phase, seed)


def _plugin_collate(items: List[Dict]) -> Dict[str, Any]:
    device = {
        'rgb': np.stack([it['rgb'] for it in items]),
        'query': np.stack([it['query'] for it in items]),
        'target': np.stack([it['target'] for it in items]),
    }
    meta = {k: [it[k] for it in items]
            for k in ('source_name', 'src_path', 'dset_idx', 'scene_idx', 'usage_mode_idx',
                      'frame_start', 'frame_stride', 'target_coverage',
                      'match_prefer_fstride')}
    meta['source_name'] = 'plugin'
    return {'device': device, 'meta': meta}


def create_test_data_loader(train_args: Dict[str, Any], test_args,
                            train_dset_args_sources: Dict[str, Any], logger,
                            data_path: Optional[str] = None):
    '''Builds ONE test loader for one data path (the test driver builds one at a time to
    bound memory). Returns (loader, test_dset_args_sources).'''
    cur_data_path = data_path if data_path is not None else test_args.data_path[0]
    if 'kubric' not in train_dset_args_sources:
        train_dset_args_sources = {'kubric': train_dset_args_sources}
    test_dset_args_sources = {}

    if is_kubric_source(cur_data_path) or not is_plugin_source(cur_data_path):
        test_dset_args = dict(train_dset_args_sources['kubric'])
        test_dset_args.pop('load_full_segm', None)
        test_dset_args['use_data_frac'] = test_args.use_data_frac
        test_dset_args['augs_2d'] = False
        test_dset_args['num_queries'] = test_args.num_queries
        # dset_args without the key colour on the host, the JAX dataset's default.
        ds = kubric_lib.KubricQueryDataset(
            cur_data_path, logger, 'test', seed=test_args.seed,
            **{'device_color_jitter': False, **test_dset_args})
        collate = make_kubric_collate(test_args.num_queries, 'test', test_args.seed)
        test_dset_args_sources['kubric'] = test_dset_args
    else:
        ka = train_dset_args_sources['kubric']
        test_dset_args = dict(
            num_clip_frames=ka['num_frames'], frame_height=ka['frame_height'],
            frame_width=ka['frame_width'], frame_rate=test_args.plugin_frame_rate,
            prefer_frame_stride=test_args.plugin_prefer_frame_stride,
            query_time=ka['query_time'], annots_must_exist=test_args.annots_must_exist,
            prefetch=True, center_crop=test_args.center_crop)
        ds = plugin_lib.PluginVideoDataset(cur_data_path, logger, 'test', **test_dset_args)
        collate = _plugin_collate
        test_dset_args_sources['plugin'] = test_dset_args

    loader = PrefetchLoader(ds, test_args.batch_size, collate, shuffle=False,
                            drop_last=False, num_workers=min(test_args.num_workers, 4),
                            seed=test_args.seed,
                            worker_mode=getattr(test_args, 'worker_mode', 'thread'))
    return loader, test_dset_args_sources
