'''
Plain PyTorch reference of the TCOW seeker, its supervision, its losses and AdamW: the
yardstick that decides whether a benchmark run is `correct`.

It follows the published model (TimeSformer, Bertasius et al., ICML 2021, divided or joint
space-time attention, as TCOW, CVPR 2023, drives it with a query-mask channel and a
patch-pixel mask head), written down once more in torch operations: it imports nothing of
the program under test and takes nothing the program made. Weights and batches come from
the benchmark (perfbench/core), which hands the same ones to the program.

It computes in float32 with TF32 off (`Precision('f32')`). `Precision('fp8')` rounds the
operands of every product to float8 e4m3 with one scale per tensor: the control, the
reference in the precision below the configuration's bfloat16 compute. The rounding is
straight-through (the backward is that of the rounded forward).

Attention runs in blocks of query rows (`BlockedAttention`) with a backward that recomputes
each block's probabilities, so that 9001-token joint attention fits; each backbone block is
checkpointed under `remat`.
'''

import functools
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

# Elements of one block of attention probabilities, f32: 2**28 is 1 GiB.
ATTN_BLOCK_ELEMS = 2 ** 28
FP8_MAX = 448.0   # largest finite float8 e4m3fn


def f32_matmuls():
    '''Turns TF32 off, so that every f32 product is a true f32 product.'''
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    '''What the operands of each product are rounded to: 'f32' leaves them as they are,
    'fp8' rounds each to float8 e4m3 with the scale amax / 448 (the control).'''

    def __init__(self, name: str):
        if name not in ('f32', 'fp8'):
            raise ValueError(f'unknown precision {name!r}')
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == 'f32':
            return x
        d = x.detach()
        scale = d.abs().amax().clamp(min=1e-30) / FP8_MAX
        r = (d / scale).to(torch.float8_e4m3fn).to(d.dtype) * scale
        return x + (r - d)


# ---------------------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------------------

def is_divided(model: Dict) -> bool:
    if model['attention_type'] not in ('divided_space_time', 'joint_space_time'):
        raise ValueError(f"unknown attention_type {model['attention_type']!r}")
    return model['attention_type'] == 'divided_space_time'


def grid(model: Dict):
    p = model['patch_size']
    return model['frame_height'] // p, model['frame_width'] // p


def param_shapes(model: Dict) -> Dict[str, tuple]:
    '''Every parameter's name and shape, in a fixed order. Linear weights are (in, out).'''
    D, Hm, p = model['embed_dim'], model['mlp_dim'], model['patch_size']
    gh, gw = grid(model)
    c_in = 3 + model['query_channels']
    shapes = {'backbone.patch_embed.w': (p * p * c_in, D), 'backbone.patch_embed.b': (D,),
              'backbone.cls_token': (D,), 'backbone.pos_embed': (gh * gw + 1, D),
              'backbone.time_embed': (model['num_total_frames'], D),
              'backbone.norm.g': (D,), 'backbone.norm.b': (D,)}

    def dense(name, din, dout):
        shapes[f'{name}.w'] = (din, dout)
        shapes[f'{name}.b'] = (dout,)

    def norm(name):
        shapes[f'{name}.g'] = (D,)
        shapes[f'{name}.b'] = (D,)

    for i in range(model['network_depth']):
        b = f'backbone.blocks.{i}'
        norm(f'{b}.norm1')
        dense(f'{b}.attn.qkv', D, 3 * D)
        dense(f'{b}.attn.proj', D, D)
        norm(f'{b}.norm2')
        dense(f'{b}.mlp.fc1', D, Hm)
        dense(f'{b}.mlp.fc2', Hm, D)
        if is_divided(model):
            norm(f'{b}.temporal_norm1')
            dense(f'{b}.temporal_attn.qkv', D, 3 * D)
            dense(f'{b}.temporal_attn.proj', D, D)
            dense(f'{b}.temporal_fc', D, D)
    dense('post_linear', D, model['output_channels'] * p * p)
    dense('flag_linear', D, model['flag_channels'])
    return shapes


# ---------------------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------------------

def dense(params, name, x, prec):
    return torch.matmul(prec(x), prec(params[f'{name}.w'])) + params[f'{name}.b']


def layer_norm(params, name, x, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * params[f'{name}.g'] + params[f'{name}.b']


class BlockedAttention(torch.autograd.Function):
    '''softmax(q k^T / sqrt(dh), masked) v over (G, S, dh) in blocks of query rows; the
    backward recomputes each block's probabilities. causal: keys after the query are
    masked. p_round rounds the probabilities before the product with v (the control).'''

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, p_round):
        G, S, dh = q.shape
        scale = dh ** -0.5
        rows = max(1, ATTN_BLOCK_ELEMS // max(1, G * S))
        out = torch.empty_like(q)
        lse = torch.empty(G, S, dtype=q.dtype, device=q.device)
        for a in range(0, S, rows):
            b = min(S, a + rows)
            s = torch.matmul(q[:, a:b], k.transpose(1, 2)) * scale
            if causal:
                s = s.masked_fill(_future(a, b, S, q.device), float('-inf'))
            lse[:, a:b] = torch.logsumexp(s, dim=-1)
            p = torch.exp(s - lse[:, a:b, None])
            out[:, a:b] = torch.matmul(p_round(p), v)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        G, S, dh = q.shape
        scale = dh ** -0.5
        rows = max(1, ATTN_BLOCK_ELEMS // max(1, G * S))
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        delta = (g * out).sum(-1)
        for a in range(0, S, rows):
            b = min(S, a + rows)
            s = torch.matmul(q[:, a:b], k.transpose(1, 2)) * scale
            if ctx.causal:
                s = s.masked_fill(_future(a, b, S, q.device), float('-inf'))
            p = torch.exp(s - lse[:, a:b, None])
            dv += torch.matmul(p.transpose(1, 2), g[:, a:b])
            dp = torch.matmul(g[:, a:b], v.transpose(1, 2))
            ds = p * (dp - delta[:, a:b, None]) * scale
            dq[:, a:b] = torch.matmul(ds, k)
            dk += torch.matmul(ds.transpose(1, 2), q[:, a:b])
        return dq, dk, dv, None, None


def _future(a, b, S, device):
    '''(b - a, S) True where the key comes after the query.'''
    return torch.arange(S, device=device)[None, :] > torch.arange(a, b, device=device)[:, None]


def attention(params, name, x, heads: int, causal: bool, prec):
    '''Multi-head self-attention over x (B, S, D): qkv, the heads' attention, proj.'''
    B, S, D = x.shape
    dh = D // heads
    qkv = dense(params, f'{name}.qkv', x, prec)
    q, k, v = qkv.reshape(B, S, 3, heads, dh).permute(2, 0, 3, 1, 4).reshape(3, B * heads, S, dh)
    o = BlockedAttention.apply(prec(q), prec(k), prec(v), causal, prec)
    o = o.reshape(B, heads, S, dh).transpose(1, 2).reshape(B, S, D)
    return dense(params, f'{name}.proj', o, prec)


def mlp(params, name, x, prec):
    return dense(params, f'{name}.fc2', F.gelu(dense(params, f'{name}.fc1', x, prec)), prec)


def drop_path(x, mask, keep):
    if mask is None:
        return x
    return x * mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())).to(x.dtype) / keep


def divided_block(params, name, model, prec, xs, cls, masks):
    '''xs (R, N, T, D), cls (R, D): temporal attention per patch, temporal_fc, spatial
    attention per frame with the cls token, the MLP.'''
    R, N, T, D = xs.shape
    heads, eps, ca = model['num_heads'], model['ln_eps'], model['causal_attention']
    if ca not in (0, 1):
        raise ValueError(f'the reference covers causal_attention 0 and 1, not {ca}')
    keep, m_t, m_s, m_m = masks if masks is not None else (None, None, None, None)
    h = layer_norm(params, f'{name}.temporal_norm1', xs, eps).reshape(R * N, T, D)
    res_t = attention(params, f'{name}.temporal_attn', h, heads, ca == 1, prec)
    res_t = drop_path(res_t.reshape(R, N, T, D), m_t, keep)
    xt = xs + dense(params, f'{name}.temporal_fc', res_t, prec)
    seq = torch.cat([cls[:, None, None, :].expand(R, T, 1, D), xt.transpose(1, 2)], dim=2)
    h = layer_norm(params, f'{name}.norm1', seq, eps).reshape(R * T, N + 1, D)
    res_s = attention(params, f'{name}.attn', h, heads, False, prec).reshape(R, T, N + 1, D)
    res_s = drop_path(res_s, m_s, keep)
    cls_new = res_s[:, :, 0].mean(dim=1) if ca == 0 else res_s[:, 0, 0]
    tokens = xt + res_s[:, :, 1:].transpose(1, 2)
    cls = cls + cls_new
    tokens = tokens + drop_path(mlp(params, f'{name}.mlp',
                                    layer_norm(params, f'{name}.norm2', tokens, eps), prec),
                                m_m, keep)
    cls = cls + drop_path(mlp(params, f'{name}.mlp',
                              layer_norm(params, f'{name}.norm2', cls, eps), prec), m_m, keep)
    return tokens, cls


def joint_block(params, name, model, prec, xs, cls, masks):
    '''One attention over the cls token and every patch of every frame, then the MLP.'''
    R, N, T, D = xs.shape
    heads, eps = model['num_heads'], model['ln_eps']
    keep, _, m_s, m_m = masks if masks is not None else (None, None, None, None)
    flat = torch.cat([cls[:, None], xs.reshape(R, N * T, D)], dim=1)
    flat = flat + drop_path(attention(params, f'{name}.attn',
                                      layer_norm(params, f'{name}.norm1', flat, eps),
                                      heads, False, prec), m_s, keep)
    flat = flat + drop_path(mlp(params, f'{name}.mlp',
                                layer_norm(params, f'{name}.norm2', flat, eps), prec),
                            m_m, keep)
    return flat[:, 1:].reshape(R, N, T, D), flat[:, 0]


def _bilinear_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    '''(n_out, n_in): bilinear interpolation with aligned corners along one axis.'''
    src = torch.arange(n_out, dtype=torch.float64) * (n_in - 1) / max(1, n_out - 1)
    i0 = src.floor().long().clamp(0, max(0, n_in - 2))
    frac = (src - i0).float()
    M = torch.zeros(n_out, n_in)
    M[torch.arange(n_out), i0] = 1.0 - frac
    M[torch.arange(n_out), (i0 + 1).clamp(max=n_in - 1)] += frac
    return M.to(device)


def coarsen(mask, stride: int, mode: str):
    '''Average over stride x stride cells, then back to full size (bilinear with aligned
    corners, or nearest).'''
    if stride <= 1:
        return mask
    *lead, H, W = mask.shape
    x = mask.reshape(*lead, H // stride, stride, W // stride, stride).mean(dim=(-3, -1))
    if mode == 'nearest':
        return x.repeat_interleave(stride, dim=-2).repeat_interleave(stride, dim=-1)
    if mode != 'bilinear':
        raise ValueError(f'unknown track_map_resize {mode!r}')
    Mh = _bilinear_matrix(H // stride, H, mask.device)
    Mw = _bilinear_matrix(W // stride, W, mask.device)
    return torch.matmul(torch.matmul(Mh, x), Mw.T)


def seeker_forward(params, model: Dict, rgb, query, masks=None, prec=None,
                   remat: bool = False):
    '''rgb (R, 3, T, H, W), query (R, 1, T, H, W) f32 -> (mask logits (R, C, T, H, W),
    flags (R, T, F)). masks: per block (keep, temporal, spatial, mlp) drop-path draws or
    None.'''
    prec = prec or Precision('f32')
    p, D = model['patch_size'], model['embed_dim']
    x = torch.cat([rgb.float(), query.float()], dim=1)
    R, C, T, H, W = x.shape
    gh, gw = H // p, W // p
    N = gh * gw
    x = x.permute(0, 2, 3, 4, 1).reshape(R, T, gh, p, gw, p, C)
    x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(R, T, N, p * p * C)
    x = dense(params, 'backbone.patch_embed', x, prec)
    pos = params['backbone.pos_embed']
    x = x + pos[None, None, 1:] + params['backbone.time_embed'][None, :T, None]
    cls = (params['backbone.cls_token'] + pos[0])[None].expand(R, D)
    xs = x.transpose(1, 2)
    block = divided_block if is_divided(model) else joint_block
    for i in range(model['network_depth']):
        fn = functools.partial(block, params, f'backbone.blocks.{i}', model, prec)
        m = None if masks is None else masks[i]
        if remat and torch.is_grad_enabled():
            xs, cls = torch.utils.checkpoint.checkpoint(fn, xs, cls, m, use_reentrant=False)
        else:
            xs, cls = fn(xs, cls, m)
    if model.get('norm_embeddings'):
        xs = layer_norm(params, 'backbone.norm', xs, model['ln_eps'])
    feats = xs.reshape(R, gh, gw, T, D).permute(0, 3, 1, 2, 4)        # (R, T, gh, gw, D)
    Co = model['output_channels']
    out = dense(params, 'post_linear', feats, prec).reshape(R, T, gh, gw, Co, p, p)
    out = out.permute(0, 4, 1, 2, 5, 3, 6).reshape(R, Co, T, H, W)
    out = coarsen(out, model['track_map_stride'], model['track_map_resize'])
    flags = dense(params, 'flag_linear', feats, prec).mean(dim=(2, 3))
    return out, flags


def draw_drop_masks(generator: torch.Generator, model: Dict, rate: float, R: int, device):
    '''Every block's drop-path draws for R folded rows, in the order the seeker's training
    step draws them from its generator: per-block keep 1 - linspace(0, rate, depth); a
    divided model draws (depth, R, N) for temporal attention, then (depth, R, T) for
    spatial attention, then (depth, R) for the MLP; a joint one (depth, R) for attention,
    then (depth, R) for the MLP. A row is kept where its uniform draw is below keep.'''
    L = model['network_depth']
    gh, gw = grid(model)
    N, T = gh * gw, model['num_total_frames']
    keep = 1.0 - torch.linspace(0.0, rate, L, dtype=torch.float32)

    def draw(*shape):
        u = torch.rand((L, R) + shape, generator=generator, device=generator.device)
        return (u < keep.reshape((L,) + (1,) * (len(shape) + 1))).to(device)

    if is_divided(model):
        temporal, spatial = draw(N), draw(T)
    else:
        temporal, spatial = None, draw()
    mlp_m = draw()
    keep = keep.to(device)
    return [(keep[i], None if temporal is None else temporal[i], spatial[i], mlp_m[i])
            for i in range(L)]


# ---------------------------------------------------------------------------------------
# Supervision, losses, metric sums
# ---------------------------------------------------------------------------------------

def supervision(batch, front_thres: float, cont_thres: float):
    '''Per (example, query): the query mask (the snitch visible at the query frame), the
    occluder-pointer map, the target (amodal snitch; the frontmost occluder where the snitch
    is occluded; the outermost container where it is contained). Ties of argmax / argmin
    go to the lowest instance index.'''
    segm = batch['segm'].long()
    div = batch['div_segm'].long()
    qi = batch['query_inds'].long()
    qt = int(batch['query_time'])
    B, T, H, W = segm.shape
    Q = qi.shape[1]
    dev = segm.device
    bi = torch.arange(B, device=dev)[:, None].expand(B, Q)
    snitch = div[bi, qi]                                             # (B, Q, T, H, W)
    visible = segm[:, None] == (qi + 1)[..., None, None, None]
    query_mask = visible & (torch.arange(T, device=dev) == qt)[:, None, None]
    occl_ptr = torch.where((snitch == 1) & ~visible, segm[:, None], 0)
    t = torch.arange(T, device=dev)

    def instance(ids):
        return div[bi[..., None], ids, t]

    dag = batch['occl_cont_dag'].float()
    of_rows = dag[..., 2].transpose(1, 2)[bi, qi]                    # (B, Q, T, M)
    occl_frac = batch['occl_fracs'].float()[..., 0][bi, qi]          # (B, Q, T)
    front = (occl_frac >= front_thres) & (of_rows.amax(-1) >= front_thres / 2.0)
    target1 = front[..., None, None] & (instance(of_rows.argmax(-1)) == 1)
    cont = dag[..., 0]
    c_rows = cont.transpose(1, 2)[bi, qi]
    contained = c_rows.amax(-1) >= cont_thres
    score = cont.amax(-1)[:, None]
    outer = torch.where(c_rows >= cont_thres, score, torch.full_like(score, 3.4e38)).argmin(-1)
    target2 = contained[..., None, None] & (instance(outer) == 1)
    target = torch.stack([snitch == 1, target1, target2], dim=2).float()
    return {'query': query_mask.float()[:, :, None], 'occl_ptr': occl_ptr[:, :, None],
            'target': target}


def bce(logits, targets):
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def topk_mean(values, mask, k, iters: int = 48):
    '''Per row c: the mean of the k[c] largest values[c] where mask[c], by a bisection of
    the threshold; ties at the threshold count at its upper end.'''
    C = values.shape[0]
    values, mask = values.reshape(C, -1), mask.reshape(C, -1)
    big = 3.4e38
    vm = torch.where(mask, values, torch.full_like(values, -big))
    lo = torch.where(mask, values, torch.full_like(values, big)).amin(1)
    hi = vm.amax(1)
    k = k.clamp(min=1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        many = (vm > mid[:, None]).sum(1) > k
        lo, hi = torch.where(many, mid, lo), torch.where(many, hi, mid)
    above = vm > hi[:, None]
    return (torch.where(above, vm, 0.0).sum(1) + (k - above.sum(1)) * hi) / k


def dilate(mask, band: int):
    *lead, H, W = mask.shape
    y = F.max_pool2d(mask.reshape(-1, 1, H, W).float(), band, stride=1, padding=band // 2)
    return (y > 0.0).reshape(*lead, H, W)


def losses(loss_cfg: Dict, out_mask, target, occl_fracs_q, occl_ptr, query_time, progress):
    '''The seeker's losses over (B, Q, 3, T, H, W) logits and targets: per channel a
    weighted BCE blended with a bootstrapped top-k BCE and, for the occluder and container
    channels, a Tversky term; returns (total, {track, occl_mask, cont_mask}).'''
    lc = loss_cfg
    if lc['focal_loss'] or lc['qt_downweight_last_only']:
        raise ValueError('the reference covers the BCE loss with every query frame weighted')
    B, Q, C, T, H, W = out_mask.shape
    dev = out_mask.device
    # Frame weights of the snitch channel.
    fw = (occl_fracs_q[..., 0] * lc['occluded_weight']).clamp(min=1.0)
    fw = torch.where(torch.arange(T, device=dev) == query_time, fw * 0.2, fw)
    # Pixel weights: class balance, occluded snitch doubled, hard negatives.
    tgt0 = target[:, :, 0]
    pw = torch.ones_like(tgt0)
    if lc['class_balancing']:
        numel = float(tgt0.numel())
        pos, neg = tgt0 == 1.0, tgt0 == 0.0
        pf = (pos.sum() / numel).clamp(min=0.05)
        nf = (neg.sum() / numel).clamp(min=0.05)
        ratio = torch.minimum(pf, nf) / torch.maximum(pf, nf)
        boost, damp = ratio ** -0.3, ratio ** 0.7
        pos_min = pf <= nf
        pw = pw * torch.where(neg, torch.where(pos_min, damp, boost), 1.0) \
            * torch.where(pos, torch.where(pos_min, boost, damp), 1.0)
    pw = torch.where(occl_ptr[:, :, 0] != 0, pw * 2.0, pw)
    if lc['hard_negative_factor'] > 1.0:
        band = int((H * W) ** 0.5 / 12.0)
        band += 1 - band % 2
        hard = dilate(tgt0, band) & (tgt0 < 0.5)
        pw = torch.where(hard, pw * lc['hard_negative_factor'], pw)
    weights = [fw[..., None, None] * pw]
    z = lc['occl_cont_zero_weight']
    for ch in (1, 2):
        has = (target[:, :, ch] > 0.0).any(-1).any(-1).float()[..., None, None]
        weights.append((has * (1.0 - z) + z).expand(target[:, :, ch].shape))
    weights = torch.stack(weights)                                   # (3, B, Q, T, H, W)
    logits, tgt = out_mask.movedim(2, 0), target.movedim(2, 0)
    dims = tuple(range(1, logits.dim()))
    sel = (weights != 0.0).any(-1).any(-1)[..., None, None].expand(logits.shape)
    sel_f = sel.float()
    numel = float(logits[0].numel())
    l_bce = bce(logits, tgt)
    n_sel = sel_f.sum(dims)
    custom = (l_bce * weights * sel_f).sum(dims) / n_sel.clamp(min=1.0)
    aot_w = torch.stack([torch.ones_like(weights[0]), weights[1], weights[2]])
    k = torch.floor(torch.clamp(torch.tensor(1.0 - progress * 8.5), 0.15, 1.0) * n_sel)
    boot = topk_mean(l_bce * aot_w, sel, k.to(torch.int64).to(torch.float32))
    p0 = torch.sigmoid(logits[0])
    s0, t0 = sel_f[0], tgt[0]
    n0 = s0.sum().clamp(min=1.0)
    tp, fp, fn = (p0 * t0 * s0).sum(), (p0 * (1 - t0) * s0).sum(), ((1 - p0) * t0 * s0).sum()
    tversky = torch.where((t0 * s0).sum() / n0 >= 1e-6, 1.0 - tp / (tp + fp + fn + 0.1),
                          torch.zeros((), device=dev))
    jac = torch.stack([tversky, boot[1], boot[2]])
    aot = (boot + jac) / 2.0
    per = (aot * lc['aot_loss'] + custom * (1.0 - lc['aot_loss'])) * torch.sqrt(n_sel / numel)
    valid = (n_sel > 0.0) & (weights.sum(dims) / numel >= 1e-4)
    per = torch.where(valid, per, torch.zeros_like(per))
    total = per[0] * lc['track_lw'] + per[1] * lc['occl_mask_lw'] + per[2] * lc['cont_mask_lw']
    return total, {'track': per[0], 'occl_mask': per[1], 'cont_mask': per[2]}


METRIC_FAMILIES = ('snitch_iou', 'occl_mask_iou', 'cont_mask_iou', 'snitch_during_vis_iou',
                   'snitch_during_occl_iou', 'snitch_during_cont_iou')


def metric_sums(out_mask, target) -> Dict[str, float]:
    '''IoU of (logit > 0) against (target > 0.5) per clip, channel and frame, summed and
    counted over the frames whose target is non-empty, for six families: out_mask and
    target (C, T, H, W) of one clip.'''
    o, t = out_mask > 0.0, target > 0.5
    inter = (o & t).sum((-2, -1)).double()
    union = (o | t).sum((-2, -1)).double()
    iou = inter / (union + 1e-7)
    has = t.sum((-2, -1)) > 0
    fams = {'snitch_iou': (has[0], iou[0]), 'occl_mask_iou': (has[1], iou[1]),
            'cont_mask_iou': (has[2], iou[2]),
            'snitch_during_vis_iou': (has[0] & ~has[1], iou[0]),
            'snitch_during_occl_iou': (has[0] & has[1], iou[0]),
            'snitch_during_cont_iou': (has[0] & has[2], iou[0])}
    out = {}
    for name, (valid, values) in fams.items():
        out[f'sum_{name}'] = float(torch.where(valid, values, 0.0).sum())
        out[f'count_{name}'] = float(valid.sum())
    return out


# ---------------------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------------------

def fold_queries(batch, sup):
    '''rgb and query masks of every (example, query) pair as (B Q, ., T, H, W).'''
    rgb = batch['rgb'].float()
    B, Q = batch['query_inds'].shape
    rgb_q = rgb[:, None].expand((B, Q) + rgb.shape[1:]).reshape((B * Q,) + rgb.shape[1:])
    return rgb_q, sup['query'].reshape((B * Q,) + sup['query'].shape[2:])


def train_loss(params, model: Dict, train: Dict, batch, masks, prec):
    '''The seeker's training loss on one batch (dict of tensors on the device).'''
    lc = train['loss']
    sup = supervision(batch, lc['front_occl_thres'], lc['outer_cont_thres'])
    rgb_q, query = fold_queries(batch, sup)
    out, _ = seeker_forward(params, model, rgb_q, query, masks, prec, remat=train['remat'])
    B, Q = batch['query_inds'].shape
    out = out.reshape((B, Q) + out.shape[1:])
    bi = torch.arange(B, device=out.device)[:, None]
    occl_q = batch['occl_fracs'].float()[bi, batch['query_inds'].long()]
    total, _ = losses(lc, out, sup['target'], occl_q, sup['occl_ptr'],
                      int(batch['query_time']), train['progress'])
    return total


class AdamW:
    '''AdamW over a dict of f32 tensors (decoupled weight decay on every tensor), after
    clipping the gradients to a global norm (scaled only when the norm reaches the clip).'''

    def __init__(self, params: Dict[str, torch.Tensor], train: Dict):
        self.lr, self.wd, self.eps = train['learn_rate'], train['weight_decay'], train['eps']
        self.b1, self.b2 = train['betas']
        self.clip = train['gradient_clip']
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    def clipped(self, grads: Dict[str, torch.Tensor]):
        '''(the gradients clipped, their global norm before clipping).'''
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        if self.clip > 0 and norm >= self.clip:
            return {n: g / norm * self.clip for n, g in grads.items()}, float(norm)
        return grads, float(norm)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[n] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)


def train_steps(params: Dict[str, torch.Tensor], model: Dict, train: Dict, batches: List,
                generator: Optional[torch.Generator], prec=None):
    '''Runs len(batches) training steps from `params` (a dict of f32 tensors, updated in
    place), drawing each step's drop-path masks from `generator`. Returns the losses, the
    first step's clipped gradient per leaf and its global norm before clipping, and
    nothing else that is large.'''
    prec = prec or Precision('f32')
    opt = AdamW(params, train)
    losses_out, first_grads, first_norm = [], None, None
    rate = train['drop_path_rate']
    for batch in batches:
        R = batch['query_inds'].shape[0] * batch['query_inds'].shape[1]
        dev = batch['rgb'].device
        masks = (draw_drop_masks(generator, model, rate, R, dev)
                 if rate > 0.0 and generator is not None else None)
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        loss = train_loss(leaves, model, train, batch, masks, prec)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g)
                 for (n, p), g in zip(leaves.items(), grads)}
        del leaves
        grads, norm = opt.clipped(grads)
        if first_grads is None:
            first_grads = {n: float(g.double().norm()) for n, g in grads.items()}
            first_norm = norm
        opt.step(params, grads)
        losses_out.append(float(loss.detach()))
        del grads, loss
    return losses_out, first_grads, first_norm


def as_params(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    '''Fresh f32 copies of the benchmark's weights.'''
    return {n: w.detach().to(torch.float32).clone() for n, w in weights.items()}

