'''
Kubric scene dataset: host-side loading + preprocessing + augmentation producing the
train-step batch schema. The port's copy of tcow_tpu/data/kubric.py (:49-474), reading its
PNGs through data/png.py:
  - scene discovery under <root>/{train,val,test} or flat roots, dirs containing 'scn';
  - per-scene preprocessing (PNG decode, hue->ID segmentation decode, amodal masks,
    occlusion fractions, occlusion/containment DAG) cached to disk as a directory of .npy
    files keyed by the loaded frame window, published atomically;
  - temporal + 2D augmentations via data/augs.py, with occlusion fractions recomputed
    post-augmentation and the DAG subsampled on the clip frames; the colour keys drawn
    for the device (device_color_jitter, the default) or applied on the host;
  - desirability scoring + instance-axis padding to max_objects;
  - retry-with-resample on bad scenes (<= 8) and the cache self-healing retry;
  - sanity checks incl. the [SkipCache] insufficient-valid-queries protocol.

Output per item is flat numpy (the batch schema of train/step.py plus bookkeeping);
collate_kubric stacks items into the compact transfer form (rgb_u8, div_segm_packed,
segm_u8) with frame_times.
'''

import json
import os
import pathlib
from typing import Dict, List, Optional

import numpy as np

from tcow_tpu_torch import native
from tcow_tpu_torch.data import augs as augs_lib
from tcow_tpu_torch.data import data_utils, png, vis_codec
from tcow_tpu_torch.data import query_sampling

# The cache is a per-key .npy dir, loaded via mmap: no zipfile CRC pass, and the
# augmentation gathers touch only the pages they read.
PREPROCESS_CACHE_VERSION = 3
CACHE_PREFIX = 'cc_torch'


def read_rgb8(path: str) -> np.ndarray:
    '''(H, W, 3) uint8 RGB of a PNG, as cv2.imread(path, IMREAD_COLOR) gives it in BGR:
    alpha dropped, gray repeated, 16-bit samples reduced to their high byte.'''
    img = png.read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


class ConfigDataMismatchError(ValueError):
    '''A scene can NEVER satisfy the requested clip config (e.g. too few frames on
    disk for frame_inds_load, which is deterministic per config: sample_augs_params).
    Unlike transient per-scene failures this is not retried: resampling augs or
    switching scenes in a homogeneous dataset cannot help.'''


class KubricQueryDataset:

    def __init__(self, dset_root: str, logger, phase: str, num_frames: int = 24,
                 frame_height: int = 240, frame_width: int = 320, frame_rate: int = 12,
                 frame_stride: int = 1, max_delay: int = 0, use_data_frac: float = 1.0,
                 augs_2d: bool = True, num_queries: int = 1, query_time: float = 0.0,
                 max_objects: int = 36, front_occl_thres: float = 0.95,
                 outer_cont_thres: float = 0.75, reverse_prob: float = 0.0,
                 palindrome_prob: float = 0.0, seed: int = 0, use_cache: bool = True,
                 device_color_jitter: bool = True, time_stretch_max: float = 1.0):
        self.dset_root = dset_root
        self.logger = logger
        self.phase = phase
        self.num_frames_load = num_frames + max_delay
        self.num_frames_clip = num_frames
        self.frame_height = frame_height
        self.frame_width = frame_width
        self.frame_rate = frame_rate
        self.frame_stride = frame_stride
        self.max_delay = max_delay
        self.augs_2d = augs_2d
        self.num_queries = num_queries
        self.query_time = query_time
        self.max_objects = max_objects
        self.front_occl_thres = front_occl_thres
        self.outer_cont_thres = outer_cont_thres
        self.use_cache = use_cache
        self.seed = seed
        self.epoch = 0

        self.do_random_augs = (('train' in phase or 'val' in phase) and 'noaug' not in phase)

        if 'train' in phase:
            phase_dn = 'train'
        elif 'val' in phase:
            phase_dn = 'val'
        elif 'test' in phase:
            phase_dn = 'test'
        else:
            raise ValueError(phase)
        phase_dp = os.path.join(dset_root, phase_dn)
        if not os.path.exists(phase_dp):
            phase_dp = dset_root

        scene_dns = sorted(dn for dn in os.listdir(phase_dp) if 'scn' in dn)
        self.scene_dps = [os.path.join(phase_dp, dn) for dn in scene_dns
                          if os.path.isdir(os.path.join(phase_dp, dn))]
        self.phase_dn = phase_dn
        self.dset_size = len(self.scene_dps)
        self.used_dset_size = int(use_data_frac * self.dset_size)
        self.force_shuffle = (use_data_frac < 1.0 and
                              ('train' in phase or 'val' in phase))
        if logger is not None:
            logger.info(f'(KubricQueryDataset) ({phase}) Scene count: {self.dset_size}, '
                        f'used: {self.used_dset_size}')

        self.device_color_jitter = device_color_jitter
        self.augs_pipeline = augs_lib.AugmentationPipeline(
            self.num_frames_load, self.num_frames_clip, frame_height, frame_width,
            frame_stride, self.do_random_augs, augs_2d, reverse_prob, palindrome_prob,
            center_crop=False, defer_color_jitter=device_color_jitter,
            time_stretch_max=(time_stretch_max if self.do_random_augs else 1.0))

    def __getstate__(self):
        # A process worker (data/factory.py) receives the dataset pickled; the logger
        # holds file handles and threads, so workers log nothing (their retries still
        # count in the item's 'retries').
        return {**self.__dict__, 'logger': None}

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.used_dset_size

    def _item_rng(self, index: int, retries: int) -> np.random.Generator:
        seed = (int(self.seed) * 1000003 + int(self.epoch) * 9176
                + int(index) * 131 + int(retries) * 7) % (2 ** 63)
        return np.random.default_rng(seed)

    def __getitem__(self, index: int) -> Dict:
        retries = 0
        while True:
            rng = self._item_rng(index, retries)
            try:
                if not self.force_shuffle and retries == 0:
                    scene_idx = index % self.dset_size
                else:
                    scene_idx = int(rng.integers(self.dset_size))
                scene_dp = self.scene_dps[scene_idx]
                kubric_retval = self._load_example(scene_dp, rng)
                break
            except ConfigDataMismatchError:
                raise  # deterministic per config; resampling cannot help
            except Exception as e:
                retries += 1
                if self.logger is not None:
                    self.logger.warning(f'(KubricQueryDataset) scene {scene_idx}: {e} '
                                        f'(retry {retries})')
                if retries >= 8:
                    raise

        item = dict(kubric_retval)
        item['source_name'] = 'kubric'
        item['dset_idx'] = index
        item['retries'] = retries
        item['scene_idx'] = scene_idx
        item['scene_dp'] = scene_dp
        item['scene_dn'] = str(pathlib.Path(scene_dp).name)
        return item

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    def _load_example(self, scene_dp: str, rng) -> Dict:
        augs_params = self.augs_pipeline.sample_augs_params(rng)
        query_time = int(np.floor(self.query_time * self.num_frames_load))
        # Cache self-healing: retry once with a regenerated cache.
        for retry in range(2):
            try:
                return self._load_example_deterministic(
                    scene_dp, augs_params, query_time, force_renew_cache=(retry >= 1))
            except ConfigDataMismatchError:
                raise  # a cache rebuild cannot add frames to the scene
            except Exception as e:
                if retry == 0 and '[SkipCache]' not in str(e):
                    continue
                raise

    def _load_example_deterministic(self, scene_dp, augs_params, query_time,
                                    force_renew_cache: bool) -> Dict:
        frame_inds_load = augs_params['frame_inds_load']
        cache_dn = (f'{CACHE_PREFIX}_{PREPROCESS_CACHE_VERSION}_{frame_inds_load[0]}_'
                    f'{frame_inds_load[1]}_{frame_inds_load[-1]}')
        cache_dp = os.path.join(scene_dp, cache_dn)
        pre = None
        if self.use_cache and not force_renew_cache and os.path.isdir(cache_dp):
            try:
                pre = {}
                for fn in sorted(os.listdir(cache_dp)):
                    if fn.endswith('.npy'):
                        # mmap the big arrays: the fused gathers fault in only the
                        # pages they touch. Consumers copy on access; `pre` is dropped
                        # at the end of this item so maps do not accumulate.
                        mm = 'r' if fn.startswith('pv_') else None
                        pre[fn[:-4]] = np.load(os.path.join(cache_dp, fn),
                                               mmap_mode=mm, allow_pickle=False)
                if 'pv_div_packed' not in pre or 'pv_rgb_u8' not in pre:
                    pre = None
            except Exception:
                pre = None
        if pre is None:
            pre = self._load_example_preprocess(scene_dp, frame_inds_load)
            if self.use_cache:
                import shutil
                tmp = cache_dp + f'.tmp{os.getpid()}'
                try:
                    os.makedirs(tmp, exist_ok=True)
                    for k, v in pre.items():
                        np.save(os.path.join(tmp, k + '.npy'), v)
                    try:
                        os.rename(tmp, cache_dp)  # atomic publish
                    except OSError:
                        # Target exists: stale/corrupt (we just failed to read it) or a
                        # concurrent writer won the race with identical content — either
                        # way replacing it is sound (open mmaps persist past the unlink).
                        shutil.rmtree(cache_dp, ignore_errors=True)
                        os.rename(tmp, cache_dp)
                except OSError:
                    shutil.rmtree(tmp, ignore_errors=True)
        item = self._load_example_augmentations(pre, augs_params, query_time)
        self._load_example_verify(item, scene_dp)
        return item

    def _load_example_preprocess(self, scene_dp: str, frame_inds_load) -> Dict[str, np.ndarray]:
        '''Deterministic part: decode + derive annotations.'''
        scene_dn = str(pathlib.Path(scene_dp).name)
        if os.path.exists(os.path.join(scene_dp, 'frames')):
            frames_dp = os.path.join(scene_dp, 'frames')
            metadata_fp = os.path.join(scene_dp, scene_dn + '.json')
        else:
            frames_dp = os.path.join(scene_dp, 'frames_p0_v0')
            metadata_fp = os.path.join(scene_dp, scene_dn + '_p0_v0.json')
        with open(metadata_fp, 'r') as f:
            metadata = json.load(f)
        have = int(metadata['scene']['num_frames'])
        need = int(max(frame_inds_load)) + 1
        if have < need:
            raise ConfigDataMismatchError(
                f'{scene_dn}: scene has {have} frames but the clip config needs frame '
                f'index {need - 1} (num_frames={self.num_frames_clip} + '
                f'max_delay={self.max_delay}, frame_stride={self.frame_stride}). This '
                f'holds for every sample of this config — regenerate the dataset with '
                f'more frames (e.g. tcow_tpu_torch.data.synthetic --frames >= {need}) or '
                f'lower --num_frames / --frame_stride.')

        K = metadata['scene']['num_valo_instances']
        pv_rgb, pv_segm_rgb, pv_div = [], [], []
        for t in frame_inds_load:
            rgb_fp = os.path.join(frames_dp, f'rgba_{t:05d}.png')
            if not os.path.exists(rgb_fp):
                break
            pv_rgb.append(read_rgb8(rgb_fp))                       # uint8
            sg = read_rgb8(os.path.join(frames_dp, f'segmentation_{t:05d}.png'))
            pv_segm_rgb.append((sg / 255.0).astype(np.float32))
            per_inst = []
            for k in range(K):
                # The Kubric exporter zero-pads k to 3 digits; older synthetic
                # fixtures wrote bare ints -- accept both.
                for fn in (f'divided_segmentation_{k:03d}_{t:05d}.png',
                           f'divided_segmentation_{k}_{t:05d}.png'):
                    fp = os.path.join(frames_dp, fn)
                    if os.path.exists(fp):
                        break
                dv = png.read_png(fp)
                if dv.ndim == 3:
                    dv = dv.sum(axis=-1)
                per_inst.append((dv > 25).astype(np.uint8))
            pv_div.append(np.stack(per_inst, axis=-1))

        pv_rgb = np.stack(pv_rgb)                                  # (Tv, H, W, 3) uint8
        pv_segm_rgb = np.stack(pv_segm_rgb)                        # (Tv, H, W, 3)
        pv_div_segm = np.stack(pv_div)                             # (Tv, H, W, K)
        pv_segm = vis_codec.segm_rgb_to_ids_kubric(pv_segm_rgb)    # (Tv, H, W, 1)

        occl_fracs = data_utils.get_thing_occl_fracs(pv_segm, pv_div_segm)  # (K, Tv, 3)
        occl_cont_dag, _, _, recon_error = data_utils.get_thing_occl_cont_dag(
            pv_segm, pv_div_segm, metadata, list(frame_inds_load))
        if recon_error >= 0.02 and self.logger is not None:
            self.logger.warning(f'(KubricQueryDataset) Large recon_error {recon_error:.3f} '
                                f'for {scene_dp}')
        return {
            'pv_rgb_u8': pv_rgb,                                   # uint8 (4x smaller IO)
            'pv_segm': pv_segm[..., 0].astype(np.int16),
            'pv_div_packed': np.packbits(pv_div_segm, axis=-1),    # 8x smaller masks
            'div_k': np.int32(K),
            'occl_fracs': occl_fracs,
            'occl_cont_dag': occl_cont_dag,
            'num_valo_instances': np.int32(K),
            'frame_inds_load': np.asarray(frame_inds_load, np.int32),
        }

    def _load_example_augmentations(self, pre, augs_params, query_time) -> Dict:
        K = int(pre['num_valo_instances'])
        frame_inds_clip = augs_params['frame_inds_clip']

        # With the colour math on the device, rgb stays uint8 through the whole host
        # chain and the smooth resize works on uint8 as cv2 does; the host colour path
        # (device_color_jitter off) turns it to float32.
        modalities = {'rgb': pre['pv_rgb_u8'].transpose(3, 0, 1, 2)}    # (3, Tv, H, W) u8

        # Fast path: the segm/div augmentations are pure per-axis index gathers
        # (nearest_index_maps), so the native kernel reads the BIT-PACKED cache and emits
        # the final augmented layouts in one pass (mask planes, the contiguous stats
        # layout, and the W-packed rows the compact collate ships), replacing the
        # unpackbits -> select -> flip -> crop -> resize numpy chain bit-identically
        # (tests/test_torch_kubric_data.py). TCOW_NO_NATIVE=1 runs the numpy chain.
        Tv, H, W = pre['pv_segm'].shape
        maps = self.augs_pipeline.nearest_index_maps(augs_params, H, W)
        use_native = native.enabled() and 1 <= K <= native.MAX_STATS_K
        verify_counts = None
        mask_counts = None
        div_packw = None
        if use_native:
            div_tf, div_thwk, div_packw, div_delta = native.gather_div_bits(
                pre['pv_div_packed'], K, *maps, want_kthw=True, want_thwk=True,
                want_packw=(self.frame_width % 8 == 0), want_delta=True)  # (K,Tc,h,w)...
            segm_hw = native.gather_segm_i16(pre['pv_segm'], *maps)     # (Tc, h, w) i32
            stats = native.scene_overlap_stats(segm_hw, div_thwk)
        aug = self.augs_pipeline.apply_augs_2d_frames(modalities, augs_params)
        rgb_tf = aug['rgb']                                             # (3, Tc, Hf, Wf)
        if use_native:
            segm_tf = segm_hw[None]                                     # (1, Tc, Hf, Wf)
            vis_cnt, tot_cnt, _, dv = stats
            occl_fracs_tf = data_utils._occl_fracs_from_counts(
                vis_cnt, tot_cnt, self.frame_height, self.frame_width)  # (K, Tc, 3)
            # Per-instance totals for _load_example_verify, free from the same counts:
            # vis = sum_t vis_cnt, tot = sum_t tot_cnt, overlap = sum_t dv[t, k, k].
            verify_counts = (vis_cnt.sum(0), tot_cnt.sum(0),
                             np.einsum('tkk->k', dv))
            mask_counts = (tot_cnt, div_delta)
        else:
            div_segm = np.unpackbits(pre['pv_div_packed'], axis=-1, count=K)
            mods2 = {
                'segm': pre['pv_segm'][None].astype(np.uint8),          # (1, Tv, H, W)
                'div_segm': div_segm.transpose(3, 0, 1, 2),             # (K, Tv, H, W)
            }
            aug2 = self.augs_pipeline.apply_augs_2d_frames(mods2, augs_params)
            segm_tf = aug2['segm'].astype(np.int32)                     # (1, Tc, Hf, Wf)
            div_tf = aug2['div_segm']                                   # (K, Tc, Hf, Wf)
            # Recompute occlusion fractions post-augmentation.
            occl_fracs_tf = data_utils.get_thing_occl_fracs(
                segm_tf.transpose(1, 2, 3, 0), div_tf.transpose(1, 2, 3, 0))
        occl_cont_dag_tf = pre['occl_cont_dag'][frame_inds_clip]          # (Tc, K, K, 3)

        desirability_tf = query_sampling.get_thing_traject_desirability(
            div_tf, occl_fracs_tf, query_time, mask_counts=mask_counts)   # (K, 7)

        M = self.max_objects
        occl_fracs_pad, _ = data_utils.pad_div(occl_fracs_tf, [0], M)
        dag_pad, _ = data_utils.pad_div(occl_cont_dag_tf, [1, 2], M)
        desir_pad, _ = data_utils.pad_div(desirability_tf, [0], M)

        item_extra = {}
        if self.device_color_jitter:
            jf = augs_params.get('jitter_factors')
            if jf is not None:
                item_extra['jitter_factors'] = np.array(
                    [jf['fb'], jf['fc'], jf['fs'], jf['fh'], 1.0], np.float32)
                item_extra['jitter_order'] = np.asarray(jf['order'], np.int32)
            else:  # jitter not drawn this item (p=0.9) -> device no-op
                item_extra['jitter_factors'] = np.array([1, 1, 1, 0, 0], np.float32)
                item_extra['jitter_order'] = np.arange(4, dtype=np.int32)
            bs = augs_params.get('blur_sigmas')
            item_extra['blur_gray'] = np.array(
                [bs[0] if bs else 0.0, bs[1] if bs else 0.0,
                 1.0 if augs_params.get('rgb_grayscale') else 0.0], np.float32)

        if div_packw is not None:
            # Pre-packed (K, Tc, Hf, Wf/8) rows for the compact collate (same bytes as
            # np.packbits(div_segm, axis=-1)); collate skips its per-item packbits.
            item_extra['div_segm_packed_w'] = div_packw
        if verify_counts is not None:
            item_extra['_verify_counts'] = verify_counts

        # np.asarray(x, dtype): no copy when the dtype already matches (astype always
        # copies, a large memcpy per item on the hot loader path).
        return {
            **item_extra,
            # uint8 when the colour chain is deferred (device_color_jitter); float32
            # otherwise. The collate handles both.
            'rgb': rgb_tf if rgb_tf.dtype == np.uint8 else np.asarray(rgb_tf, np.float32),
            'segm': segm_tf[0],                       # (Tc, Hf, Wf) int32
            # UNPADDED (K, Tc, Hf, Wf): the M zero-pad happens in the collate AFTER
            # bit-packing (the packed pad is 8x smaller and packbits runs on K rows).
            'div_segm': np.asarray(div_tf, np.uint8),
            'occl_fracs': np.asarray(occl_fracs_pad, np.float32),
            'occl_cont_dag': np.asarray(dag_pad, np.float32),
            'desirability': np.asarray(desir_pad, np.float32),
            'query_time': np.int32(query_time),
            'inst_count': np.int32(K),
            'frame_inds_direct': pre['frame_inds_load'][frame_inds_clip],
            # TRUE source timestamps (x optional stretch) for time-calibrated rope.
            'frame_times': self.augs_pipeline.frame_times(augs_params),
            'augs_params': {k: v for k, v in augs_params.items() if k != '_rng_state'},
        }

    def _load_example_verify(self, item, scene_dp):
        K = int(item['inst_count'])
        segm = item['segm']
        if segm.max() > K:
            raise ValueError(f'K={K} but pv_segm has id {segm.max()}')
        counts = item.pop('_verify_counts', None)
        for k in range(K):
            if counts is not None:
                # From the native overlap stats of the SAME augmented arrays — identical
                # to the boolean-reduction expressions below.
                vis, tot, overlap = (int(counts[0][k]), int(counts[1][k]),
                                     int(counts[2][k]))
            else:
                div = item['div_segm']
                vis = (segm == k + 1).sum()
                tot = (div[k] == 1).sum()
                overlap = np.logical_and(segm == k + 1, div[k] == 1).sum()
            if vis > 0 and tot > 0 and (overlap == 0 or vis >= tot * 1.1):
                raise ValueError(f'Mismatch between segm and div_segm: {scene_dp} k={k} '
                                 f'vis={vis} tot={tot} overlap={overlap}')
        if (item['desirability'][:K, 0] > 0.0).sum() < self.num_queries:
            raise ValueError(f'[SkipCache] Insufficient valid queries in {scene_dp}: '
                             f'{item["desirability"][:K, 0]}')


def collate_kubric(items: List[Dict], num_queries: int, phase: str,
                   rng: Optional[np.random.Generator] = None,
                   compact_transfer: bool = True) -> Dict[str, np.ndarray]:
    '''Stacks dataset items into the device batch schema and samples query indices.

    With compact_transfer, rgb ships as uint8 and the amodal masks bit-packed (the step
    unpacks on the device; ~7x fewer host->device bytes).'''
    B = len(items)
    batch = {k: np.stack([it[k] for it in items])
             for k in ('occl_fracs', 'occl_cont_dag')}
    segm = np.stack([it['segm'] for it in items])
    rgb = np.stack([it['rgb'] for it in items])
    # div_segm arrives UNPADDED (K_i, T, H, W) per item; pad to M here — after the
    # bit-packing on the compact path, so the zero rows only ever exist packed.
    M = items[0]['desirability'].shape[0]
    T, H, W = items[0]['div_segm'].shape[1:]
    if compact_transfer and W % 8 == 0:
        batch['rgb_u8'] = (rgb if rgb.dtype == np.uint8
                           else np.clip(rgb * 255.0, 0, 255).astype(np.uint8))
        packed = np.zeros((B, M, T, H, W // 8), np.uint8)
        for b, it in enumerate(items):
            pw = it.get('div_segm_packed_w')  # native fast path pre-packed these rows
            if pw is None:
                pw = np.packbits(it['div_segm'], axis=-1)
            packed[b, :pw.shape[0]] = pw
        batch['div_segm_packed'] = packed
        batch['segm_u8'] = segm.astype(np.uint8)  # instance ids <= M = 36
    else:
        batch['rgb'] = (rgb.astype(np.float32) / 255.0 if rgb.dtype == np.uint8
                        else rgb)
        div = np.zeros((B, M, T, H, W), np.uint8)
        for b, it in enumerate(items):
            div[b, :it['div_segm'].shape[0]] = it['div_segm']
        batch['div_segm'] = div
        batch['segm'] = segm
    if 'jitter_factors' in items[0]:
        batch['jitter_factors'] = np.stack([it['jitter_factors'] for it in items])
        batch['jitter_order'] = np.stack([it['jitter_order'] for it in items])
    if 'blur_gray' in items[0]:
        batch['blur_gray'] = np.stack([it['blur_gray'] for it in items])
    if 'frame_times' in items[0]:
        batch['frame_times'] = np.stack([it['frame_times'] for it in items]) \
            .astype(np.float32)                                    # (B, Tc)
    inst_count = np.array([it['inst_count'] for it in items])
    desirability = np.stack([it['desirability'] for it in items])
    batch['query_inds'] = query_sampling.sample_query_inds(
        B, num_queries, inst_count, desirability, phase, rng=rng)
    batch['query_time'] = np.int32(items[0]['query_time'])
    return batch
