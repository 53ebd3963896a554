'''
Dense ResNet-50 feature extractor (the alternative spatial backbone) in PyTorch: the port
of tcow_tpu/models/resnet.py.

A ResNet-50 (v1.5: stride 2 on the 3x3 of a downsampling bottleneck) truncated after
layer3, so (B, C, H, W) frames give (B, 1024, H/16, W/16) features; the first convolution
takes any channel count. The reference never builds this backbone in its default
configuration; it exists for architecture experiments.

Two points where torch's defaults compute another network than the JAX one:
  - JAX pads 'SAME' asymmetrically: a stride-2 7x7 stem on an even size pads 2 before and
    3 after, and the stride-2 3x3 max-pool (`reduce_window(-inf, ..., 'SAME')`) 0 before
    and 1 after. Every convolution and the pool pad explicitly here (`_same_pads`), the
    pool with -inf.
  - In train mode BatchNorm normalises with the batch's mean and biased variance and
    leaves the stored statistics alone (the caller updates them); nn.BatchNorm2d would
    update them. Eval mode uses the stored ones.

Parameters keep the JAX names (`stem.conv`, `layers.<stage>.<block>.bn1.g`, ...). The
convolutions are stored OIHW, as F.conv2d takes them; `state_dict_from_jax` transposes the
JAX tree's HWIO kernels and carries the BatchNorm {g, b, mean, var} entries across. The
convolutions run through F.conv2d (cuDNN on the card): the JAX package computes them with
XLA, outside any Pallas kernel.
'''

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Bottleneck counts for layers 1-3 of ResNet-50 (layer4 truncated).
BLOCK_COUNTS = (3, 4, 6)
STAGE_WIDTHS = (256, 512, 1024)
BN_EPS = 1e-5
_CONV_LEAVES = ('conv', 'conv1', 'conv2', 'conv3', 'down_conv')


@dataclasses.dataclass(frozen=True)
class DenseResNetConfig:
    in_channels: int = 3
    compute_dtype: torch.dtype = torch.float32

    @property
    def output_feature_dim(self) -> int:
        return STAGE_WIDTHS[-1]  # 1024 at stride 16


class BatchNorm(nn.Module):
    '''Scale g and shift b (trained), stored mean and var (buffers, not trained).'''

    def __init__(self, c: int, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(c, device=device))
        self.b = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer('mean', torch.zeros(c, device=device))
        self.register_buffer('var', torch.ones(c, device=device))

    def forward(self, x, train: bool):
        '''x (B, C, H, W); train: the batch's moments over (B, H, W), the stored ones
        untouched (resnet.py:77-84 of the JAX package).'''
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + BN_EPS) * self.g
        return (x - mean[:, None, None]) * inv[:, None, None] + self.b[:, None, None]


def _same_pads(n: int, k: int, s: int):
    '''(before, after) padding of XLA's 'SAME' along one axis of size n.'''
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    t, b = _same_pads(x.shape[-2], k, s)
    l, r = _same_pads(x.shape[-1], k, s)
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


def _conv(x, w, stride: int = 1):
    '''x (B, C, H, W), w (O, I, kh, kw) cast to x's dtype; XLA's 'SAME' padding.'''
    return F.conv2d(_pad_same(x, w.shape[-1], stride), w.to(x.dtype), stride=stride)


def _conv_weight(cout: int, cin: int, k: int, generator: torch.Generator, device=None):
    '''He-normal init as the JAX package's `_conv_init` (std sqrt(2 / (k k cin))).'''
    w = torch.randn((cout, cin, k, k), generator=generator) * np.sqrt(2.0 / (k * k * cin))
    return w.to(device)


class Stem(nn.Module):
    def __init__(self, cin: int, device=None):
        super().__init__()
        self.conv = nn.Parameter(torch.zeros(64, cin, 7, 7, device=device))
        self.bn = BatchNorm(64, device)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, downsample: bool, device=None):
        super().__init__()
        mid = width // 4
        self.stride = stride
        self.conv1 = nn.Parameter(torch.zeros(mid, cin, 1, 1, device=device))
        self.bn1 = BatchNorm(mid, device)
        self.conv2 = nn.Parameter(torch.zeros(mid, mid, 3, 3, device=device))
        self.bn2 = BatchNorm(mid, device)
        self.conv3 = nn.Parameter(torch.zeros(width, mid, 1, 1, device=device))
        self.bn3 = BatchNorm(width, device)
        if downsample:
            self.down_conv = nn.Parameter(torch.zeros(width, cin, 1, 1, device=device))
            self.down_bn = BatchNorm(width, device)

    def forward(self, x, train: bool):
        y = F.relu(self.bn1(_conv(x, self.conv1), train))
        y = F.relu(self.bn2(_conv(y, self.conv2, self.stride), train))
        y = self.bn3(_conv(y, self.conv3), train)
        if hasattr(self, 'down_conv'):
            x = self.down_bn(_conv(x, self.down_conv, self.stride), train)
        return F.relu(x + y)


class DenseResNet(nn.Module):
    '''forward(frames (B, C, H, W), train) -> features (B, 1024, ceil(H/16), ceil(W/16)).'''

    def __init__(self, cfg: DenseResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.stem = Stem(cfg.in_channels, device)
        self.layers = nn.ModuleList()
        cin = 64
        for stage, (n_blocks, width) in enumerate(zip(BLOCK_COUNTS, STAGE_WIDTHS)):
            blocks = nn.ModuleList()
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(Bottleneck(cin, width, stride, b == 0, device))
                cin = width
            self.layers.append(blocks)

    def init_params_(self, generator: torch.Generator):
        '''He-normal convolutions drawn from `generator` in the JAX init's order, unit
        BatchNorm (resnet.py:46-70 of the JAX package; other draws than jax.random).'''
        with torch.no_grad():
            for name, prm in self.named_parameters():
                leaf = name.rsplit('.', 1)[-1]
                if leaf in _CONV_LEAVES:
                    o, i, k, _ = prm.shape
                    prm.copy_(_conv_weight(o, i, k, generator, prm.device))
                elif leaf == 'g':
                    prm.fill_(1.0)
                else:
                    prm.zero_()
            for name, buf in self.named_buffers():
                buf.fill_(1.0 if name.endswith('var') else 0.0)

    def forward(self, frames: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = frames.to(self.cfg.compute_dtype)
        x = _conv(x, self.stem.conv, stride=2)
        x = F.relu(self.stem.bn(x, train))
        x = F.max_pool2d(_pad_same(x, 3, 2, value=float('-inf')), 3, stride=2)
        for blocks in self.layers:
            for block in blocks:
                x = block(x, train)
        return x


def _walk(tree, prefix=''):
    '''(dot-joined path, leaf) of a nested dict / list tree.'''
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            yield from _walk(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v


def state_dict_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    '''The JAX package's ResNet tree (HWIO kernels) -> this module's state_dict (OIHW),
    float32 on the CPU.'''
    state = {}
    for key, arr in _walk(tree):
        arr = np.asarray(arr, dtype=np.float32)
        if key.rsplit('.', 1)[-1] in _CONV_LEAVES:
            arr = arr.transpose(3, 2, 0, 1)
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def state_dict_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    '''This module's state_dict -> the JAX package's tree of float32 numpy arrays.'''
    tree = {'stem': {'bn': {}}, 'layers': [[{} for _ in range(n)] for n in BLOCK_COUNTS]}
    for key, t in state.items():
        arr = t.detach().to('cpu', torch.float32).numpy()
        *path, leaf = key.split('.')
        if leaf in _CONV_LEAVES:
            arr = arr.transpose(2, 3, 1, 0)
        node = tree
        for k in path:
            node = node[int(k)] if isinstance(node, list) else node.setdefault(k, {})
        node[leaf] = arr
    return tree


def import_torch_resnet50(state_dict, cfg: DenseResNetConfig) -> Dict[str, Any]:
    '''A torchvision / timm resnet50 state dict -> the JAX-layout tree of numpy arrays
    (load with `state_dict_from_jax`), the first convolution adapted when cfg.in_channels
    != 3: channels tiled and rescaled by 3 / in_channels (resnet.py:125-158 of the JAX
    package).'''
    def t(name):
        v = state_dict[name]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, 'detach') else v)

    def conv(name):
        return t(name).transpose(2, 3, 1, 0)   # (O, I, kh, kw) -> (kh, kw, I, O)

    def bn(prefix):
        return {'g': t(prefix + '.weight'), 'b': t(prefix + '.bias'),
                'mean': t(prefix + '.running_mean'), 'var': t(prefix + '.running_var')}

    stem_w = t('conv1.weight')
    if cfg.in_channels != 3:
        rep = -(-cfg.in_channels // 3)
        stem_w = np.tile(stem_w, (1, rep, 1, 1))[:, :cfg.in_channels] \
            * (3.0 / cfg.in_channels)
    params = {'stem': {'conv': stem_w.transpose(2, 3, 1, 0), 'bn': bn('bn1')},
              'layers': []}
    for stage in range(3):
        blocks = []
        for b in range(BLOCK_COUNTS[stage]):
            pre = f'layer{stage + 1}.{b}'
            block = {'conv1': conv(pre + '.conv1.weight'), 'bn1': bn(pre + '.bn1'),
                     'conv2': conv(pre + '.conv2.weight'), 'bn2': bn(pre + '.bn2'),
                     'conv3': conv(pre + '.conv3.weight'), 'bn3': bn(pre + '.bn3')}
            if b == 0:
                block['down_conv'] = conv(pre + '.downsample.0.weight')
                block['down_bn'] = bn(pre + '.downsample.1')
            blocks.append(block)
        params['layers'].append(blocks)
    return params
