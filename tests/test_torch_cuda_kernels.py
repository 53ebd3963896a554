'''
The CUDA kernels of tcow_tpu_torch against their plain versions, on the GPU only: edge
geometries that the full-width run in chip_smoke.py does not reach (S=1, ragged row,
column and depth tiles, head sizes 32, 40 and 128, every causal mode), and the launch
count of the seeker's entry points on the card. Every test carries
the `cuda` marker and skips without CUDA. The file imports neither JAX nor the tests'
conftest, so on a GPU machine without JAX it runs as:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
'''

import numpy as np
import pytest
import torch

from tcow_tpu_torch.evaluation.inference import InferenceEngine
from tcow_tpu_torch.models.mask_tracker import MaskTracker, seeker_config_from_args
from tcow_tpu_torch.models.seeker import Seeker
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.train.checkpoint import save_checkpoint
from tcow_tpu_torch.weights import params_to_jax

pytestmark = pytest.mark.cuda

# Relative L2 error against the plain version in float32 from the same inputs (as in
# chip_smoke.py): bf16 rounds qkv, p and attn (8 mantissa bits); float32 differs only
# in the order of sums (TF32 off).
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the kernels have no CPU or interpret mode')
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def inputs(B, S, D, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).to(device, dtype)
    w = [torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.randn(D, 3 * D) * 1.6 / np.sqrt(D), rng.randn(3 * D) * 0.02,
        rng.randn(D, D) * 0.8 / np.sqrt(D), rng.randn(D) * 0.02)]
    return x, w


@pytest.mark.parametrize('B,S,D,H,ca,dtype', [
    (3, 1, 64, 2, 1, torch.bfloat16),      # one row per sequence, head 32
    (5, 33, 128, 4, 3, torch.bfloat16),    # two query and key tiles, diag 1
    (7, 45, 256, 2, 0, torch.bfloat16),    # head 128: >48 KB dynamic shared memory
    (2, 70, 200, 5, 2, torch.float32),     # head 40, K and N not tile multiples
    (4, 30, 768, 12, 1, torch.float32),    # temporal geometry in float32
    (2, 301, 96, 3, -1, torch.bfloat16),   # spatial length, ca -1 is not causal
])
def test_kernel_matches_plain(cuda, B, S, D, H, ca, dtype):
    x, w = inputs(B, S, D, dtype, cuda)
    before = fa.fused_attention.launches
    got = fa.fused_attention(x, *w, H, ca)
    torch.cuda.synchronize()
    assert fa.fused_attention.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    want = fa.attention_ref(x.float(), *w, H, ca)
    err = float((got.double() - want.double()).norm() / want.double().norm())
    assert err <= TOL[dtype], err


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w = inputs(2, 8, 64, torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        fa.fused_attention(x.half(), *w, 2, 0)
    with pytest.raises(ValueError, match='contiguous'):
        fa.fused_attention(x.transpose(0, 1), *w, 2, 0)
    with pytest.raises(ValueError, match='qkv_w'):
        fa.fused_attention(x, w[0].to(torch.bfloat16), *w[1:], 2, 0)
    with pytest.raises(ValueError, match='head_dim'):
        fa.fused_attention(x, *w, 32, 0)


def test_seeker_entry_points_launch_the_kernel(cuda, tmp_path):
    '''ViT-B/16 on small frames: Seeker.from_checkpoint, Seeker.from_seeker_args and
    InferenceEngine each launch the kernel twice per block and forward on CUDA.'''
    args = dict(num_total_frames=4, frame_height=32, frame_width=48, network_depth=12,
                causal_attention=1)
    model = MaskTracker(seeker_config_from_args(args))
    model.init_params_(torch.Generator().manual_seed(0))
    params = params_to_jax(model.state_dict())
    path = save_checkpoint(str(tmp_path), 0, 'k', params, seeker_args=args)
    rng = np.random.RandomState(0)
    rgb = rng.rand(1, 3, 4, 32, 48).astype(np.float32)
    query = (rng.rand(1, 1, 4, 32, 48) > 0.5).astype(np.float32)
    runs = (lambda: Seeker.from_checkpoint(path, device='cuda')(rgb, query),
            lambda: Seeker.from_seeker_args(args, device='cuda')(rgb, query),
            lambda: InferenceEngine(params, seeker_config_from_args(args), device='cuda')
            .run_plugin(rgb, query, np.zeros((1, 3, 4, 32, 48), np.float32)))
    for run in runs:
        before = fa.fused_attention.launches
        run()
        torch.cuda.synchronize()
        assert fa.fused_attention.launches - before == 24
