'''
Operations and bytes that the work needs, from the model's shapes and never from a kernel:
the yardstick of every roofline share and of mfu. The first functions are frozen copies of
the cost functions of the repository's chip_smoke.py (attended_pairs, k1_flops, k4_flops,
bound, seeker_forward_flops, step_flops, joint_forward_flops) with the configuration passed
in; the rest split a forward into its attention cores and its GEMMs.

Needed work only: a remat recompute is a choice of design and is not counted, and the
causal mask's pairs count as kept. A training step is three forwards (the backward twice
the forward), as chip_smoke.py counts it. Bytes: each input read once and each output
written once, in bfloat16.

Peaks: one NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet).
'''

from typing import Dict, List, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def attended_pairs(S, ca):
    '''(query, key) pairs of one sequence that the mask keeps.'''
    if ca > 0:
        diag = 0 if ca <= 2 else ca - 2
        return sum(min(S, q + diag + 1) for q in range(S))
    return S * S


def k1_flops(B, S, ca, width):
    '''Operations one fused attention call needs: qkv and proj GEMMs, and scores + P.v
    over the (query, key) pairs the mask keeps. width: (D, heads).'''
    d, heads = width
    return 2 * B * S * d * 4 * d + 2 * 2 * B * heads * attended_pairs(S, ca) * (d // heads)


def k4_flops(B, S, ca, width):
    '''Operations of one K4 call: the qkv recompute and g . proj_w^T (8 B S D^2), and per
    kept (query, key) pair and head the logits, P.v, dv, dp, dq and dk (12 D).'''
    d, _ = width
    return 8 * B * S * d * d + 12 * d * attended_pairs(S, ca) * B


def bound(flops, nbytes):
    '''(least ms on the card, what bounds it) for bf16 work.'''
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def _dims(m: Dict):
    p = m['patch_size']
    N = (m['frame_height'] // p) * (m['frame_width'] // p)
    return m['num_total_frames'], p, N, m['embed_dim'], m['num_heads']


def seeker_forward_flops(m: Dict, B):
    '''Matmul operations of one divided seeker forward over B clips.'''
    T, p, N, d, heads = _dims(m)
    width = (d, heads)
    Hm = m['mlp_dim']
    block = (k1_flops(B * N, T, m['causal_attention'], width) + 2 * B * N * T * d * d
             + k1_flops(B * T, N + 1, 0, width) + 2 * 2 * (B * N * T + B) * d * Hm)
    heads_ops = 2 * B * T * N * d * (m['output_channels'] * p * p + m['flag_channels'])
    return (2 * B * T * N * p * p * (3 + m['query_channels']) * d
            + m['network_depth'] * block + heads_ops)


def joint_forward_flops(m: Dict, rows):
    '''Matmul operations of one joint seeker forward over `rows` clips.'''
    T, p, N, d, heads = _dims(m)
    S = 1 + N * T
    block = k1_flops(rows, S, 0, (d, heads)) + 2 * 2 * rows * S * d * m['mlp_dim']
    heads_ops = 2 * rows * T * N * d * (m['output_channels'] * p * p + m['flag_channels'])
    return (2 * rows * T * N * p * p * (3 + m['query_channels']) * d
            + m['network_depth'] * block + heads_ops)


def forward_flops(m: Dict, rows):
    divided = m['attention_type'] == 'divided_space_time'
    return seeker_forward_flops(m, rows) if divided else joint_forward_flops(m, rows)


def step_flops(m: Dict, rows):
    '''Matmul operations of one training step over `rows` folded clips: 3 forwards.'''
    return 3 * forward_flops(m, rows)


def attention_calls(m: Dict, rows) -> List[Tuple[int, int, int]]:
    '''(sequences, length, causal_attention) of every attention call of one forward.'''
    T, _, N, _, _ = _dims(m)
    if m['attention_type'] == 'divided_space_time':
        per_block = [(rows * N, T, m['causal_attention']), (rows * T, N + 1, 0)]
    else:
        per_block = [(rows, 1 + N * T, 0)]
    return per_block * m['network_depth']


def linears(m: Dict, rows) -> List[Tuple[int, int, int]]:
    '''(M, K, N) of every GEMM of one forward: x (M, K) times w (K, N).'''
    T, p, N, d, _ = _dims(m)
    Hm = m['mlp_dim']
    out = [(rows * T * N, p * p * (3 + m['query_channels']), d)]
    for _ in range(m['network_depth']):
        if m['attention_type'] == 'divided_space_time':
            tok, sp = rows * N * T, rows * T * (N + 1)
            out += [(tok, d, 3 * d), (tok, d, d), (tok, d, d), (sp, d, 3 * d), (sp, d, d),
                    (tok, d, Hm), (tok, Hm, d), (rows, d, Hm), (rows, Hm, d)]
        else:
            S = rows * (1 + N * T)
            out += [(S, d, 3 * d), (S, d, d), (S, d, Hm), (S, Hm, d)]
    out += [(rows * T * N, d, m['output_channels'] * p * p), (rows * T * N, d, m['flag_channels'])]
    return out


def attention_core(m: Dict, rows, train: bool) -> Tuple[float, float]:
    '''(operations, bytes) of the attention cores of one forward, or of one training step
    (the forward's scores and P.v, 4 D a kept pair; the backward's dv, dp, dq and dk, 8 D a
    kept pair). Bytes: q, k, v read and the output written in the forward; q, k, v and
    the output's gradient read and dq, dk, dv written in the backward.'''
    d = m['embed_dim']
    ops = nbytes = 0
    for seqs, S, ca in attention_calls(m, rows):
        pairs = attended_pairs(S, ca) * seqs
        ops += (12 if train else 4) * d * pairs
        nbytes += (11 if train else 4) * seqs * S * d * BF16
    return ops, nbytes


def gemms(m: Dict, rows, train: bool) -> Tuple[float, float]:
    '''(operations, bytes) of the GEMMs of one forward, or of one training step (3 times
    the forward's operations; bytes: the forward's x, w and y, the backward's g, w and dx
    and x, g and dw, each once).'''
    ops = nbytes = 0
    for M, K, N in linears(m, rows):
        ops += 2 * M * K * N
        nbytes += (M * K + K * N + M * N) * BF16
    if train:
        return 3 * ops, 3 * nbytes
    return ops, nbytes
