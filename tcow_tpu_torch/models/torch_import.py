'''
Import of reference PyTorch checkpoints: a TCOW `.pth` (and ImageNet ViT weights to
bootstrap from) into the JAX-layout tree of numpy arrays that `load_networks` returns and
`weights.params_from_jax` carries into the port's modules. The port's own copy of
tcow_tpu/models/torch_import.py (:28-220), with the same trees bit for bit.

  - A TCOW checkpoint is a dict with `net_seeker` / `train_args` / `seeker_args` / `epoch`
    keys; its `seeker_args` rebuild the model.
  - The ImageNet inflation rules: the first conv's channels repeated ceil(C/3) times,
    sliced to C and scaled by 3/C; a 1-D nearest resize of pos_embed (past the cls token)
    and of time_embed; the spatial attention and norm1 copied into the temporal ones
    where absent (divided attention).
'''

import argparse
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from tcow_tpu_torch.models.mask_tracker import SeekerConfig, seeker_config_from_args


def _to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, 'detach') else np.asarray(t)


def load_torch_file(path: str) -> Dict[str, Any]:
    '''The checkpoint's dict, unpickled with weights_only=True (no code in the file runs):
    tensors and plain containers, and argparse Namespaces, which reference checkpoints
    hold as train_args.'''
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location='cpu', weights_only=True)


def _nearest_resize_axis(arr: np.ndarray, new_len: int, axis: int) -> np.ndarray:
    '''torch F.interpolate(mode=nearest) along one axis: src = floor(dst * in/out).'''
    n_in = arr.shape[axis]
    if n_in == new_len:
        return arr
    idx = np.floor(np.arange(new_len) * n_in / new_len).astype(np.int64)
    return np.take(arr, idx, axis=axis)


def _linear(sd, name) -> Dict[str, np.ndarray]:
    # A torch Linear weight is (out, in); the tree's is (in, out).
    return {'w': _to_np(sd[name + '.weight']).T.astype(np.float32),
            'b': _to_np(sd[name + '.bias']).astype(np.float32)}


def _ln(sd, name) -> Dict[str, np.ndarray]:
    return {'g': _to_np(sd[name + '.weight']).astype(np.float32),
            'b': _to_np(sd[name + '.bias']).astype(np.float32)}


def _stack(trees):
    '''Nested dicts of arrays with one structure -> one nested dict of stacked arrays.'''
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees, axis=0)


def backbone_params_from_torch(sd: Dict[str, Any], cfg, prefix: str = '') -> Dict[str, Any]:
    '''A vendored-VisionTransformer state dict (keys like `blocks.0.attn.qkv.weight`) ->
    the backbone tree with stacked blocks.

    :param sd state dict (torch tensors or numpy arrays).
    :param cfg timesformer.TimeSformerConfig.
    :param prefix key prefix inside sd (e.g. 'tracker_backbone.timesformer.model.').
    '''
    g = lambda k: sd[prefix + k]
    D = cfg.embed_dim

    conv_w = _to_np(g('patch_embed.proj.weight')).astype(np.float32)  # (D, C, p, p)
    _, C, p, _ = conv_w.shape
    if C != cfg.in_channels or p != cfg.patch_size:
        raise ValueError(f'patch_embed.proj.weight {conv_w.shape} does not fit '
                         f'in_channels={cfg.in_channels}, patch_size={cfg.patch_size}')
    # The patch vector's layout is (ph, pw, C), as TimeSformer.forward flattens patches.
    pe_w = conv_w.transpose(2, 3, 1, 0).reshape(p * p * C, D)

    params = {
        'patch_embed': {'w': pe_w, 'b': _to_np(g('patch_embed.proj.bias')).astype(np.float32)},
        'cls_token': _to_np(g('cls_token')).astype(np.float32).reshape(D),
        'pos_embed': _to_np(g('pos_embed')).astype(np.float32)[0],     # (N+1, D)
        'time_embed': _to_np(g('time_embed')).astype(np.float32)[0],   # (T, D)
        'norm': _ln(sd, prefix + 'norm'),
    }

    def one_block(i):
        b = f'{prefix}blocks.{i}.'
        d = {
            'norm1': _ln(sd, b + 'norm1'),
            'attn': {'qkv': _linear(sd, b + 'attn.qkv'), 'proj': _linear(sd, b + 'attn.proj')},
            'norm2': _ln(sd, b + 'norm2'),
            'mlp': {'fc1': _linear(sd, b + 'mlp.fc1'), 'fc2': _linear(sd, b + 'mlp.fc2')},
        }
        if cfg.divided:
            d.update({
                'temporal_norm1': _ln(sd, b + 'temporal_norm1'),
                'temporal_attn': {'qkv': _linear(sd, b + 'temporal_attn.qkv'),
                                  'proj': _linear(sd, b + 'temporal_attn.proj')},
                'temporal_fc': _linear(sd, b + 'temporal_fc'),
            })
        return d

    params['blocks'] = _stack([one_block(i) for i in range(cfg.depth)])
    return params


def seeker_params_from_torch(sd: Dict[str, Any], cfg: SeekerConfig,
                             prefix: str = '') -> Dict[str, Any]:
    '''A QueryMaskTracker state dict, also under a `module.` (DataParallel) or `seeker.`
    wrapper, -> the seeker tree.'''
    for wrapper in ('module.', 'seeker.'):
        if all(k.startswith(wrapper) for k in sd):
            sd = {k[len(wrapper):]: v for k, v in sd.items()}
    params = {
        'backbone': backbone_params_from_torch(
            sd, cfg.backbone_config(), prefix=prefix + 'tracker_backbone.timesformer.model.'),
        'post_linear': _linear(sd, prefix + 'tracker_post_linear'),
    }
    if cfg.flag_channels > 0 and (prefix + 'flag_post_linear.weight') in sd:
        params['flag_linear'] = _linear(sd, prefix + 'flag_post_linear')
    return params


def load_tcow_checkpoint(path: str) -> Tuple[Dict[str, Any], SeekerConfig, Dict[str, Any]]:
    '''A reference TCOW checkpoint (.pth) -> (seeker tree, SeekerConfig from its
    seeker_args, the whole checkpoint dict).'''
    ckpt = load_torch_file(path)
    cfg = seeker_config_from_args(dict(ckpt.get('seeker_args', {})))
    return seeker_params_from_torch(ckpt['net_seeker'], cfg), cfg, ckpt


def seeker_state_dict_to_torch(params: Dict[str, Any], cfg: SeekerConfig
                               ) -> Dict[str, torch.Tensor]:
    '''The inverse of seeker_params_from_torch: a seeker tree -> the reference
    QueryMaskTracker's state dict, as a reference .pth holds it under `net_seeker` (the
    vendored VisionTransformer under tracker_backbone.timesformer.model.: a conv patch
    embedding, torch Linear (out, in) weights, (1, 1, D) cls token, (1, N+1, D) and
    (1, T, D) embeddings; tracker_post_linear and flag_post_linear).'''
    bb_cfg = cfg.backbone_config()
    p, C = bb_cfg.patch_size, bb_cfg.in_channels
    pre = 'tracker_backbone.timesformer.model.'
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    bb = params['backbone']
    sd = {pre + 'patch_embed.proj.weight': t(np.asarray(bb['patch_embed']['w']).reshape(
              p, p, C, -1).transpose(3, 2, 0, 1)),
          pre + 'patch_embed.proj.bias': t(bb['patch_embed']['b']),
          pre + 'cls_token': t(np.asarray(bb['cls_token']).reshape(1, 1, -1)),
          pre + 'pos_embed': t(np.asarray(bb['pos_embed'])[None]),
          pre + 'time_embed': t(np.asarray(bb['time_embed'])[None])}

    def layer(node, name, i=None):
        pick = (lambda a: np.asarray(a)) if i is None else (lambda a: np.asarray(a)[i])
        if 'w' in node:
            sd[name + '.weight'], sd[name + '.bias'] = t(pick(node['w']).T), t(pick(node['b']))
        elif 'g' in node:
            sd[name + '.weight'], sd[name + '.bias'] = t(pick(node['g'])), t(pick(node['b']))
        else:
            for k, v in node.items():
                layer(v, f'{name}.{k}', i)

    layer(bb['norm'], pre + 'norm')
    for i in range(bb_cfg.depth):
        layer(bb['blocks'], f'{pre}blocks.{i}', i)
    layer(params['post_linear'], 'tracker_post_linear')
    if 'flag_linear' in params:
        layer(params['flag_linear'], 'flag_post_linear')
    return sd


# ---------------------------------------------------------------------------
# ImageNet ViT inflation (pretrained bootstrap)
# ---------------------------------------------------------------------------

def inflate_imagenet_vit_state_dict(sd: Dict[str, Any], *, in_chans: int, num_patches: int,
                                    num_frames: int,
                                    attention_type: str = 'divided_space_time'
                                    ) -> Dict[str, np.ndarray]:
    '''An image-ViT state dict (timm vit_base_patch16_224 layout) -> a state dict that
    backbone_params_from_torch reads for the video model: the classifier head dropped;
    the first conv's channels repeated ceil(C/3) times, sliced to C and scaled by 3/C
    (from a 3-channel source; a 2-D manual-patchify weight is reshaped to the conv's
    layout first); pos_embed past the cls token nearest-resized to num_patches;
    time_embed, where present, nearest-resized to num_frames (where absent the model
    keeps its init, as a strict=False load does); for divided attention, attn.* and
    norm1.* copied to temporal_attn.* and temporal_norm1.* where missing (temporal_fc
    has no source and keeps its init).'''
    out = {k: _to_np(v).astype(np.float32) for k, v in sd.items() if not k.startswith('head.')}

    cw = out['patch_embed.proj.weight']
    if cw.ndim == 2:
        D = cw.shape[0]
        psz = int(math.isqrt(cw.shape[1] // 3))
        cw = cw.reshape(D, 3, psz, psz)
    if in_chans != cw.shape[1]:
        if cw.shape[1] != 3:
            raise ValueError(f'channel inflation needs a 3-channel source, got {cw.shape[1]}')
        rep = int(math.ceil(in_chans / 3))
        cw = np.tile(cw, (1, rep, 1, 1))[:, :in_chans] * (3.0 / float(in_chans))
    out['patch_embed.proj.weight'] = cw

    pos = out['pos_embed']  # (1, N_src+1, D)
    if pos.shape[1] != num_patches + 1:
        body = _nearest_resize_axis(pos[:, 1:], num_patches, axis=1)
        out['pos_embed'] = np.concatenate([pos[:, 0:1], body], axis=1)

    if 'time_embed' in out and out['time_embed'].shape[1] != num_frames:
        out['time_embed'] = _nearest_resize_axis(out['time_embed'], num_frames, axis=1)

    if attention_type == 'divided_space_time':
        for k in list(out):
            if k.startswith('blocks.') and '.attn.' in k:
                out.setdefault(k.replace('.attn.', '.temporal_attn.'), out[k])
            if k.startswith('blocks.') and '.norm1.' in k:
                out.setdefault(k.replace('.norm1.', '.temporal_norm1.'), out[k])
    return out


def apply_pretrained_to_params(params: Dict[str, Any], inflated_sd: Dict[str, np.ndarray],
                               cfg) -> Dict[str, Any]:
    '''An inflated image-ViT state dict merged into an initialised backbone tree as
    torch's strict=False load would: what the state dict lacks (time_embed, temporal_fc)
    keeps the tree's values.'''
    return backbone_params_from_torch(_fill_missing(inflated_sd, params, cfg), cfg)


def _fill_missing(sd: Dict[str, np.ndarray], params: Dict[str, Any], cfg
                  ) -> Dict[str, np.ndarray]:
    '''sd with the keys a strict=False load leaves at their init exported from `params`.'''
    sd = dict(sd)
    if 'time_embed' not in sd:
        sd['time_embed'] = np.asarray(params['time_embed'])[None]
    for i in range(cfg.depth):
        base = f'blocks.{i}.temporal_fc'
        if base + '.weight' not in sd and cfg.divided:
            sd[base + '.weight'] = np.asarray(params['blocks']['temporal_fc']['w'][i]).T
            sd[base + '.bias'] = np.asarray(params['blocks']['temporal_fc']['b'][i])
    return sd
