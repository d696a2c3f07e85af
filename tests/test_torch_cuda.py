"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports torch and numpy only (no JAX), so it runs on a machine that has
just the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda

Bounds (those of chip_smoke.py; TF32 off on both sides):
  fused_block float32    1e-4 max abs (same rounding points, sums in another
                         order);
  fused_block bfloat16   max 2^-4 and mean 1e-3 (flips of single bf16 ulps);
  block_train forward    1e-4 max abs (float32 arithmetic for either dtype;
                         a bfloat16 output is compared after both round);
  block_train backward   1e-4 x max|plain gradient| per tensor (dx and the 14
                         parameter gradients);
  fused_attention        float32 1e-5 max abs (float32 throughout, sums in
                         another order); bfloat16 x: 2^-7 |y| + 1e-5
                         elementwise (one bf16 ulp of the one rounded
                         output, plus the float32 bound);
  fused_block_temporal   fused_block's bounds (the same block and rounding
                         points, the frames as tokens);
  fused_layer            float32 1e-4 max abs; bfloat16 max 2^-3 and mean
                         2e-3 (two blocks deep plus one tpe rounding:
                         chip_smoke.py states why);
  attention_core         float32 ATTN_CORE_TOL_F32 = 1e-5 max abs (three
                         TF32 products; the CPU emulation of that
                         arithmetic stays within 3e-7 on the chain's qkv,
                         and the tensor cores' truncating accumulation adds
                         a few f32 ulps: measured on an H100 80GB HBM3 at
                         most 5.1e-7 on the chain's qkv at serve bucket 16
                         and 2.7e-6 on unit-variance qkv up to L = 243);
                         bfloat16 elementwise ATTN_CORE_TOL_BF16 x (|y| +
                         max|v|), 2^-7: one ulp of the rounded output (<=
                         2^-7 |y|) plus the probabilities that round the
                         other way (a p below 1 moves by <= 2^-8, so up to
                         two flips in a row carry <= 2^-7 max|v|); measured
                         at most 1.3e-3 x (|y| + max|v|);
  attention_core_bwd     ATTN_BWD_RTOL = 1e-5 x max|plain| for each of dq,
                         dk and dv (three TF32 products a product; the CPU
                         emulation of that arithmetic stays within 1.0e-6
                         on the training qkv and 1.9e-6 on unit-variance
                         qkv at L = 243, and the tensor cores' truncating
                         accumulation adds a few f32 ulps: measured on an
                         H100 80GB HBM3 at most 4.0e-6 on unit-variance
                         qkv at L = 243);
  fused_linear           float32 1e-5 max abs (outputs O(1); three TF32
                         products per product drop only a_lo*w_lo, ~2^-22
                         relative, and sum in another order); bfloat16
                         fused_block's bound, max 2^-4 and mean 1e-3:
                         single-ulp flips of the rounded output, of the
                         product rounded before a residual add, and of
                         normalised A elements rounded on ~1e-7
                         differences of the row statistics;
  data_grad, weight_grad 1e-5 x max|plain| (the backward's GEMMs alone:
                         float32 products as three TF32 products, sums in
                         another order; the backward's own bound is ten
                         times looser);
  fwd_linear             1e-5 x max|plain| per output (the forward's GEMM
                         alone, the same arithmetic as data_grad; a
                         bfloat16 residual is exact in float32 on both
                         sides);
  bfloat16 model         a bfloat16 model on the kernels against the same
                         model on their plain versions: BF16_MODEL_TOL (max
                         and mean), tests/test_torch_bf16.py's bounds for
                         the plain versions against the JAX kernels; a
                         bfloat16
                         training step loss 1e-3 relative, gradients 5e-2 x
                         max|plain gradient| (chip_smoke.py's bfloat16
                         training bounds).
"""

import numpy as np
import pytest
import torch

from pafuse_tpu_torch.ops.attention import attention_reference, fused_attention
from pafuse_tpu_torch.ops.attention_core import (attention_core,
                                                 attention_core_bwd,
                                                 attention_core_bwd_reference,
                                                 attention_core_reference,
                                                 stream_launches)
from pafuse_tpu_torch.ops.block import block_reference, fused_block
from pafuse_tpu_torch.ops.block_temporal import (block_temporal_reference,
                                                 fused_block_temporal)
from pafuse_tpu_torch.ops.gemm import fused_linear, linear_reference
from pafuse_tpu_torch.ops.block_train import (RED_ROWS, block_train_bwd,
                                              block_train_fwd, data_grad,
                                              data_grad_reference,
                                              fwd_linear, fwd_linear_reference,
                                              train_bwd_reference,
                                              train_fwd_reference, weight_grad,
                                              weight_grad_reference)
from pafuse_tpu_torch.ops.layer import fused_layer, layer_reference

HEADS = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m cuda)")
    from pafuse_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _params(C, seed, device):
    """The 14 block tensors (torch layout): Linear weights U(+-1/sqrt(in)),
    LayerNorm affines near (1, 0)."""
    r = np.random.RandomState(seed)
    hid = 2 * C

    def u(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return r.uniform(-b, b, shape)

    def ln():
        return [1 + 0.1 * r.randn(C), 0.1 * r.randn(C)]

    arrays = (ln() + [u((3 * C, C), C), u((3 * C,), C), u((C, C), C),
                      u((C,), C)] + ln()
              + [u((hid, C), C), u((hid,), C), u((C, hid), hid), u((C,), hid)]
              + ln())
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in arrays)


def _inputs(B, L, C, seed, device):
    """x, g and masks that mix 0, 1/keep and 1 (keep = 0.9)."""
    r = np.random.RandomState(seed)
    pattern = np.array([0.0, 1.0 / 0.9, 1.0], np.float32)
    arrays = (r.randn(B, L, C), r.randn(B, L, C), pattern[np.arange(B) % 3],
              pattern[(np.arange(B) + 1) % 3])
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in arrays)


def _rel_errs(got, want):
    return [float((a.double() - b.double()).abs().max()
                  / b.double().abs().max().clamp_min(1e-30))
            for a, b in zip(got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,C", [(16, 24, 384), (16, 68, 224),
                                   (16, 42, 256), (16, 27, 256),
                                   (16, 17, 288), (16, 27, 288)])
def test_fused_block_kernel_matches_plain_on_gpu(cuda_device, dtype, B, L, C):
    params = _params(C, seed=C + L, device=cuda_device)
    bp, on = params[:12], params[12:]
    x = _inputs(B, L, C, seed=1, device=cuda_device)[0].to(dtype)
    launches = fused_block.launches
    got = fused_block(x, bp, on, HEADS)
    torch.cuda.synchronize()
    assert fused_block.launches == launches + 1
    diff = (got.float() - block_reference(x, bp, on, HEADS).float()).abs()
    if dtype == torch.float32:
        assert diff.max() <= 1e-4
    else:
        assert diff.max() <= 2.0 ** -4 and diff.mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,C", [(64, 24, 384), (64, 27, 384),
                                   (64, 68, 224), (64, 27, 224),
                                   (64, 42, 256), (64, 27, 256),
                                   (37, 17, 288), (37, 27, 288),
                                   (16, 134, 288)])
def test_block_train_kernels_match_plain_on_gpu(cuda_device, B, L, C):
    """Kernels #5 and #6 at each part's spatial and temporal (L, C)."""
    params = _params(C, seed=C + L, device=cuda_device)
    x, g, m1, m2 = _inputs(B, L, C, seed=1, device=cuda_device)
    launches = (block_train_fwd.launches, block_train_bwd.launches)
    y, saved = block_train_fwd(x, m1, m2, params, HEADS)
    dx, grads = block_train_bwd(saved, g)
    torch.cuda.synchronize()
    assert (block_train_fwd.launches, block_train_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert (y - train_fwd_reference(x, m1, m2, params, HEADS)).abs().max() <= 1e-4
    want_dx, want = train_bwd_reference(x, g, m1, m2, params, HEADS)
    assert max(_rel_errs((dx,) + grads, (want_dx,) + want)) <= 1e-4
    # deterministic: a second backward gives the same bits
    dx2, grads2 = block_train_bwd(saved, g)
    assert all(torch.equal(a, b) for a, b in zip((dx,) + grads, (dx2,) + grads2))


@pytest.mark.cuda
def test_block_train_bf16_input_on_gpu(cuda_device):
    """bfloat16 x: float32 arithmetic inside, y and dx in bfloat16."""
    B, L, C = 32, 27, 256
    params = _params(C, seed=5, device=cuda_device)
    x, g, m1, m2 = _inputs(B, L, C, seed=2, device=cuda_device)
    x, g = x.bfloat16(), g.bfloat16()
    y, saved = block_train_fwd(x, m1, m2, params, HEADS)
    dx, grads = block_train_bwd(saved, g)
    assert y.dtype == dx.dtype == torch.bfloat16
    want = train_fwd_reference(x, m1, m2, params, HEADS)
    assert (y.float() - want.float()).abs().max() <= 2.0 ** -5
    want_dx, want_grads = train_bwd_reference(x, g, m1, m2, params, HEADS)
    assert max(_rel_errs(grads, want_grads)) <= 1e-4
    assert max(_rel_errs((dx.float(),), (want_dx.float(),))) <= 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,C", [(40, 24, 384), (40, 27, 384),
                                   (40, 68, 224), (40, 27, 224),
                                   (40, 42, 256), (40, 21, 256),
                                   (40, 17, 288), (40, 27, 288)])
def test_fused_attention_kernel_matches_plain_on_gpu(cuda_device, dtype, B, L,
                                                      C):
    """Kernel #2 at each part's spatial and temporal (L, C) and one unmerged
    hand; 40 sequences leave ragged GEMM row tiles."""
    params = _params(C, seed=C + L, device=cuda_device)
    attn = (params[2], params[3], params[4], params[5])
    x = _inputs(B, L, C, seed=3, device=cuda_device)[0].to(dtype)
    launches = fused_attention.launches
    got = fused_attention(x, *attn, HEADS)
    torch.cuda.synchronize()
    assert fused_attention.launches == launches + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = attention_reference(x, *attn, HEADS).float()
    diff = (got.float() - want).abs()
    if dtype == torch.float32:
        assert diff.max() <= 1e-5
    else:
        assert torch.all(diff <= 2.0 ** -7 * want.abs() + 1e-5)


@pytest.mark.cuda
def test_fused_attention_keeps_leading_dims_on_gpu(cuda_device):
    params = _params(256, seed=9, device=cuda_device)
    attn = (params[2], params[3], params[4], params[5])
    x = _inputs(12, 27, 256, seed=4, device=cuda_device)[0].reshape(3, 4, 27, 256)
    got = fused_attention(x, *attn, HEADS)
    assert got.shape == x.shape
    assert (got - attention_reference(x, *attn, HEADS)).abs().max() <= 1e-5


@pytest.mark.cuda
def test_unfused_model_runs_kernel_2_on_gpu(cuda_device):
    """One part network at use_pallas=true: every block's attention is a
    launch of kernel #2 and none of kernel #1; the output agrees with the
    plain block (use_pallas=false) within 1e-4 (two blocks deep, each
    within ~1e-6)."""
    from pafuse_tpu_torch.models.mixste import (MixSTE2, MixSTEConfig,
                                                select_block_fn)
    net = MixSTE2(MixSTEConfig(num_frames=27, num_joints=24, depth=2),
                  device=cuda_device, use_pallas="true")
    r = np.random.RandomState(5)
    x2d, x3d = (torch.tensor(r.randn(4, 27, 24, c), dtype=torch.float32,
                             device=cuda_device) for c in (2, 3))
    t = torch.tensor([1, 5, 200, 999], device=cuda_device)
    launches = (fused_attention.launches, fused_block.launches)
    with torch.no_grad():
        got = net(x2d, x3d, t)
        torch.cuda.synchronize()
        assert (fused_attention.launches - launches[0],
                fused_block.launches - launches[1]) == (4, 0)
        net.block_fn = select_block_fn("false")
        want = net(x2d, x3d, t)
    assert (got - want).abs().max() <= 1e-4


def _bf16_ok(diff, max_tol, mean_tol):
    return bool(diff.max() <= max_tol and diff.mean() <= mean_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,C", [(24, 384), (68, 224), (42, 256), (21, 256)])
def test_fused_block_temporal_kernel_matches_plain_on_gpu(cuda_device, dtype,
                                                          N, C):
    """Kernel #3 at each part's temporal shape (27 frames, N joints) and one
    unmerged hand, on (B, F, N, C)."""
    params = _params(C, seed=C + N, device=cuda_device)
    bp, on = params[:12], params[12:]
    x = _inputs(6 * 27, N, C, seed=6, device=cuda_device)[0]
    x = x.reshape(6, 27, N, C).to(dtype)
    launches = fused_block_temporal.launches
    got = fused_block_temporal(x, bp, on, HEADS)
    torch.cuda.synchronize()
    assert fused_block_temporal.launches == launches + 1
    assert got.dtype == dtype and got.shape == x.shape
    diff = (got.float()
            - block_temporal_reference(x, bp, on, HEADS).float()).abs()
    if dtype == torch.float32:
        assert diff.max() <= 1e-4
    else:
        assert _bf16_ok(diff, 2.0 ** -4, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_tpe", [True, False])
@pytest.mark.parametrize("N,C", [(24, 384), (68, 224), (21, 256)])
def test_fused_layer_kernel_matches_plain_on_gpu(cuda_device, dtype, with_tpe,
                                                 N, C):
    """Kernel #4 for the body, the face and one unmerged hand, with the
    temporal position embedding (layer 0) and without."""
    sp = _params(C, seed=C + N, device=cuda_device)
    tp = _params(C, seed=C + N + 1, device=cuda_device)
    blocks = (sp[:12], sp[12:], tp[:12], tp[12:])
    tpe = (torch.tensor(np.random.RandomState(N).randn(27, C),
                        dtype=torch.float32, device=cuda_device)
           if with_tpe else None)
    x = _inputs(5 * 27, N, C, seed=7, device=cuda_device)[0]
    x = x.reshape(5, 27, N, C).to(dtype)
    launches = fused_layer.launches
    got = fused_layer(x, *blocks, HEADS, tpe=tpe)
    torch.cuda.synchronize()
    assert fused_layer.launches == launches + 1
    assert got.dtype == dtype and got.shape == x.shape
    diff = (got.float()
            - layer_reference(x, *blocks, HEADS, tpe=tpe).float()).abs()
    if dtype == torch.float32:
        assert diff.max() <= 1e-4
    else:
        assert _bf16_ok(diff, 2.0 ** -3, 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["block_t", "layer"])
def test_experimental_model_runs_kernels_3_and_4_on_gpu(cuda_device, mode):
    """One part network at use_pallas=block_t (every temporal block on
    kernel #3, every spatial one on #1) and at layer (every layer on #4);
    the output agrees with the plain block (use_pallas=false) within 1e-4
    (four blocks deep, each within ~1e-6)."""
    from pafuse_tpu_torch.models.mixste import MixSTE2, MixSTEConfig
    net = MixSTE2(MixSTEConfig(num_frames=27, num_joints=24, depth=2),
                  device=cuda_device, use_pallas=mode,
                  experimental_kernels=True)
    with torch.no_grad():
        net.Temporal_pos_embed.normal_()
    r = np.random.RandomState(8)
    x2d, x3d = (torch.tensor(r.randn(4, 27, 24, c), dtype=torch.float32,
                             device=cuda_device) for c in (2, 3))
    t = torch.tensor([1, 5, 200, 999], device=cuda_device)
    before = (fused_block.launches, fused_block_temporal.launches,
              fused_layer.launches, fused_attention.launches)
    with torch.no_grad():
        got = net(x2d, x3d, t)
        torch.cuda.synchronize()
        after = (fused_block.launches, fused_block_temporal.launches,
                 fused_layer.launches, fused_attention.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (
            (2, 2, 0, 0) if mode == "block_t" else (0, 0, 2, 0))
        net.set_use_pallas("false")
        want = net(x2d, x3d, t)
    assert (got - want).abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [384, 224, 256, 288])
@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("epilogue", ["store", "gelu", "residual"])
def test_fused_linear_matches_plain_on_gpu(cuda_device, dtype, C, ln,
                                           epilogue):
    """The chain's Hopper GEMM alone: every prologue x epilogue pair at each
    part's widths (N, K = 3C, C for a store, 2C, C for GELU, C, C or C, 2C
    for a residual), on 64*5 + 37 rows (a ragged last row tile)."""
    N, K = {"store": (3 * C, C), "gelu": (2 * C, C),
            "residual": (C, C if ln else 2 * C)}[epilogue]
    M = 64 * 5 + 37
    r = np.random.RandomState(C + 2 * ln + len(epilogue))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    a = t(r.randn(M, K)).to(dtype)
    w, b = t(r.uniform(-1, 1, (N, K)) / np.sqrt(K)), t(r.uniform(-1, 1, N) / np.sqrt(K))
    norm = (t(1 + 0.1 * r.randn(K)), t(0.1 * r.randn(K))) if ln else None
    res = t(r.randn(M, N)).to(dtype) if epilogue == "residual" else None
    launches = fused_linear.launches
    got = fused_linear(a, w, b, norm, epilogue, res)
    torch.cuda.synchronize()
    assert fused_linear.launches == launches + 1
    assert got.dtype == dtype and got.shape == (M, N)
    want = linear_reference(a, w, b, norm, epilogue, res).float()
    diff = (got.float() - want).abs()
    if dtype == torch.float32:
        assert diff.max() <= 1e-5
    else:
        assert _bf16_ok(diff, 2.0 ** -4, 1e-3)


#: N of the bfloat16 GEMM's tile widths: 256, 224 and 192 wide, 128, 96
#: (N a multiple of 96 and not of 128), and a ragged N on 128; GELU takes
#: 128 (96) wide tiles at every N
BF16_TILE_NS = [256, 224, 192, 128, 96, 136]


@pytest.mark.cuda
@pytest.mark.parametrize("N", BF16_TILE_NS)
@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("epilogue", ["store", "gelu", "residual"])
def test_bf16_linear_every_tile_width_on_gpu(cuda_device, N, ln, epilogue):
    """The bfloat16 GEMM at each tile width its launcher picks, at a ragged
    M (64*5 + 37 rows, not a multiple of the 128-row tiles) and every
    epilogue, with and without the LayerNorm pre-pass, against
    linear_reference; two identical calls give the same bits."""
    K, M = 224, 64 * 5 + 37
    r = np.random.RandomState(N + 2 * ln + len(epilogue))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    a = t(r.randn(M, K)).to(torch.bfloat16)
    w, b = t(r.uniform(-1, 1, (N, K)) / np.sqrt(K)), t(r.uniform(-1, 1, N) / np.sqrt(K))
    norm = (t(1 + 0.1 * r.randn(K)), t(0.1 * r.randn(K))) if ln else None
    res = (t(r.randn(M, N)).to(torch.bfloat16) if epilogue == "residual"
           else None)
    got = fused_linear(a, w, b, norm, epilogue, res)
    again = fused_linear(a, w, b, norm, epilogue, res)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.equal(got, again)
    want = linear_reference(a, w, b, norm, epilogue, res).float()
    assert _bf16_ok((got.float() - want).abs(), 2.0 ** -4, 1e-3)


@pytest.mark.cuda
def test_bf16_chain_kernels_repeat_bit_for_bit_on_gpu(cuda_device):
    """Kernels #1, #3 and #4 in bfloat16 at the face's shape (68 joints, C
    224): within their bounds of the plain versions, and a second call
    gives the same bits (one fixed summation order, no split K)."""
    C, N = 224, 68
    sp = _params(C, seed=11, device=cuda_device)
    tp = _params(C, seed=12, device=cuda_device)
    x = _inputs(2 * 27, N, C, seed=13, device=cuda_device)[0]
    x = x.to(torch.bfloat16)
    x4 = x.reshape(2, 27, N, C)
    runs = [
        (lambda: fused_block(x, sp[:12], sp[12:], HEADS),
         lambda: block_reference(x, sp[:12], sp[12:], HEADS), 2.0 ** -4, 1e-3),
        (lambda: fused_block_temporal(x4, tp[:12], tp[12:], HEADS),
         lambda: block_temporal_reference(x4, tp[:12], tp[12:], HEADS),
         2.0 ** -4, 1e-3),
        (lambda: fused_layer(x4, sp[:12], sp[12:], tp[:12], tp[12:], HEADS),
         lambda: layer_reference(x4, sp[:12], sp[12:], tp[:12], tp[12:],
                                 HEADS), 2.0 ** -3, 2e-3)]
    for kernel, plain, max_tol, mean_tol in runs:
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert _bf16_ok((got.float() - plain().float()).abs(), max_tol,
                        mean_tol)


@pytest.mark.cuda
def test_block_chain_runs_only_its_own_kernels_on_gpu(cuda_device):
    """Kernel #1's launches under torch.profiler: the Hopper GEMM, its
    weight split and row statistics, the tensor-core attention and the
    LayerNorm, and no cuBLAS or other PyTorch kernel."""
    from torch.profiler import ProfilerActivity, profile
    params = _params(224, seed=3, device=cuda_device)
    x = _inputs(8, 68, 224, seed=2, device=cuda_device)[0]
    fused_block(x, params[:12], params[12:], HEADS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_block(x, params[:12], params[12:], HEADS)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    ours = ("sm90::gemm_kernel", "sm90::split_weights_kernel",
            "sm90::row_stats_kernel", "attention_tc_kernel",
            "layernorm_kernel")
    assert names and all(any(k in n for k in ours) for n in names), names
    assert any("sm90::gemm_kernel" in n for n in names)
    assert any("attention_tc_kernel" in n for n in names), names


def _device_kernels(fn):
    """The names of the CUDA kernels that one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("C", [384, 224, 256, 288])
@pytest.mark.parametrize("stage", ["fc2", "fc1", "proj", "qkv"])
def test_data_grad_matches_plain_on_gpu(cuda_device, C, stage):
    """Kernel #6's data-gradient GEMM alone (gemm_sm90.cuh on the weight's
    transposed split): every stage of the backward at each part's width,
    fc2 with the GELU' epilogue, on 64*5 + 37 rows (a ragged row tile)."""
    params = _params(C, seed=C + len(stage), device=cuda_device)
    w = {"fc2": params[10], "fc1": params[8], "proj": params[4],
         "qkv": params[2]}[stage]
    K, N = w.shape
    M = 64 * 5 + 37
    r = np.random.RandomState(C + len(stage))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    a = t(r.randn(M, K))
    aux = t(r.randn(M, N)) if stage == "fc2" else None
    launches = data_grad.launches
    got = data_grad(a, w, aux)
    torch.cuda.synchronize()
    assert data_grad.launches == launches + 1 and got.shape == (M, N)
    assert _rel_errs([got], [data_grad_reference(a, w, aux)])[0] <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("C", [384, 224, 256, 288])
@pytest.mark.parametrize("stage,r_dtype", [
    ("qkv", None), ("proj", torch.float32), ("proj", torch.bfloat16),
    ("fc1", None), ("fc2", torch.float32)])
def test_fwd_linear_matches_plain_on_gpu(cuda_device, C, stage, r_dtype):
    """Kernel #5's forward GEMM alone (gemm_sm90.cuh on the weight's split as
    stored): every product of the forward at each part's width (C = 224
    gives N = 224, 448 and 672: the BN = 112 tiles), qkv with the bias
    epilogue, fc1 with the pair (u, gelu(u)), proj and fc2 with the masked
    residual (proj's in float32 and, as a bfloat16 x gives it, bfloat16),
    on 37 sequences of 9 rows (333 rows: a ragged row tile); a repeat gives
    the same bits."""
    params = _params(C, seed=C + len(stage), device=cuda_device)
    w, b, epilogue = {"qkv": (params[2], params[3], "store"),
                      "proj": (params[4], params[5], "residual"),
                      "fc1": (params[8], params[9], "gelu"),
                      "fc2": (params[10], params[11], "residual")}[stage]
    N, K = w.shape
    B, L = 37, 9
    r = np.random.RandomState(C + N + K)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    a = t(r.randn(B * L, K))
    residual = None if r_dtype is None else t(r.randn(B * L, N)).to(r_dtype)
    mask = t(np.array([0.0, 1.0 / 0.9, 1.0])[np.arange(B) % 3])
    args = (a, w, b, epilogue, residual, mask, L)
    launches = fwd_linear.launches
    got = fwd_linear(*args)
    torch.cuda.synchronize()
    assert fwd_linear.launches == launches + 1
    want = fwd_linear_reference(*args)
    got, want = ((got,), (want,)) if epilogue != "gelu" else (got, want)
    assert all(g.shape == (B * L, N) and g.dtype == torch.float32 for g in got)
    assert max(_rel_errs(got, want)) <= 1e-5
    again = fwd_linear(*args)
    assert all(torch.equal(x, y) for x, y in zip(
        got, (again,) if epilogue != "gelu" else again))


@pytest.mark.cuda
def test_kernel_5_runs_its_gemms_on_the_tensor_cores_on_gpu(cuda_device):
    """One call of kernel #5 under torch.profiler launches the wgmma GEMM
    (its four products), the weight splits, the LayerNorm forward and the
    tensor-core attention, and no other kernel (no scalar-FMA GEMM, no
    cuBLAS);
    chip_smoke.py's training profile files these GEMMs under the forward
    and kernel #6's under the data gradients, by the epilogue in the
    kernel's name."""
    import chip_smoke
    params = _params(224, seed=4, device=cuda_device)
    x, g, m1, m2 = _inputs(8, 68, 224, seed=3, device=cuda_device)
    names = _device_kernels(lambda: block_train_fwd(x, m1, m2, params, HEADS))
    ours = ("sm90::gemm_kernel", "sm90::split_weights_kernel",
            "ln_fwd_kernel", "attention_tc_kernel")
    assert all(any(k in n for k in ours) for n in names), names
    fwd = [n for n in names if "sm90::gemm_kernel" in n]
    assert len(fwd) == 3, fwd          # store, store + GELU, masked residual
    _, saved = block_train_fwd(x, m1, m2, params, HEADS)
    bwd = [n for n in _device_kernels(lambda: block_train_bwd(saved, g))
           if "sm90::gemm_kernel" in n]
    assert len(bwd) == 2, bwd          # none, GELU'
    groups = {n: chip_smoke.kernel_group(n, chip_smoke.TRAIN_GROUPS)
              for n in fwd + bwd}
    assert {groups[n] for n in fwd} == {"forward GEMMs (#5, wgmma)"}, groups
    assert {groups[n] for n in bwd} == {"data-gradient GEMMs (#6, wgmma)"}, groups


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(384, 768), (768, 384), (384, 384),
                                 (1152, 384), (224, 448), (672, 224),
                                 (288, 576), (576, 288), (864, 288)])
def test_weight_grad_matches_plain_on_gpu(cuda_device, N, K):
    """Kernel #6's weight-gradient GEMM alone (mma.sync, TF32): each weight
    shape of the backward, over two full chunks of RED_ROWS rows and a
    ragged one; a repeat gives the same bits."""
    M = 2 * RED_ROWS + 333
    r = np.random.RandomState(N + K)
    d, x = (torch.tensor(r.randn(M, n), dtype=torch.float32,
                         device=cuda_device) for n in (N, K))
    launches = weight_grad.launches
    got = weight_grad(d, x)
    torch.cuda.synchronize()
    assert weight_grad.launches == launches + 1 and got.shape == (N, K)
    assert _rel_errs([got], [weight_grad_reference(d, x)])[0] <= 1e-5
    assert torch.equal(got, weight_grad(d, x))


@pytest.mark.cuda
def test_kernels_2_and_6_run_their_gemms_on_the_tensor_cores_on_gpu(
        cuda_device):
    """One call of kernel #2 and one of kernel #6 under torch.profiler: #2
    launches the wgmma GEMM, its weight splits and the tensor-core
    attention; #6 the wgmma GEMM (data gradients), its transposed weight
    splits, the mma.sync weight-gradient kernel and the tensor-core
    attention backward, and neither a scalar-FMA GEMM, cuBLAS or any other
    PyTorch kernel.  The profiled call's output of #2 is held
    against ``attention_reference`` (1e-5, the file's bound), and every
    failure of #2's checks reports that output's error beside the profiled
    kernel names, so a miss of the GEMM in the profile shows whether the
    kernel or the profiler missed."""
    params = _params(224, seed=4, device=cuda_device)
    x, g, m1, m2 = _inputs(8, 68, 224, seed=3, device=cuda_device)
    outs = []
    names = _device_kernels(
        lambda: outs.append(fused_attention(x, *params[2:6], HEADS)))
    err = float((outs[-1] - attention_reference(x, *params[2:6], HEADS))
                .abs().max())
    what = (f"#2's profiled output: max abs error {err:.3g} against "
            f"attention_reference (bound 1e-5); profiled kernels: "
            f"{sorted(names)}")
    assert err <= 1e-5, what
    ours = ("sm90::gemm_kernel", "sm90::split_weights_kernel",
            "attention_tc_kernel")
    assert all(any(k in n for k in ours) for n in names), what
    assert any("sm90::gemm_kernel" in n for n in names), what

    _, saved = block_train_fwd(x, m1, m2, params, HEADS)
    names = _device_kernels(lambda: block_train_bwd(saved, g))
    ours = ("sm90::gemm_kernel", "sm90::split_weights_t_kernel",
            "wgrad_mma_kernel", "attention_bwd_tc_kernel", "ln_bwd_kernel",
            "colsum_kernel", "reduce_partials_kernel")
    assert all(any(k in n for k in ours) for n in names), names
    assert {k for k in ours[:4] if any(k in n for n in names)} == set(ours[:4])


@pytest.mark.cuda
def test_readback_waits_for_its_own_chunk_only_on_gpu(cuda_device):
    """Two chunks queued back to back, each followed by its readback
    (``utils.device.to_host``): waiting for chunk 0's copy returns while
    chunk 1's work (40 float32 4096^3 products, ~0.1 s) still runs, as the
    events' ``query()`` shows; a blocking ``.cpu()`` would have waited for
    both."""
    from pafuse_tpu_torch.utils.device import run_chunked, to_host
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4096, 4096, generator=g, device=cuda_device) / 64
    torch.cuda.synchronize()
    h0 = to_host(a[:8] * 2)                     # chunk 0: tiny work
    big = a
    for _ in range(40):                         # chunk 1: long work
        big = big @ a
    h1 = to_host(big[:8])
    first = h0.numpy()
    assert h0.ready() and not h1.ready()
    np.testing.assert_array_equal(first, (a[:8] * 2).cpu().numpy())
    h1.numpy()
    assert h1.ready()

    # chunked on the card == one call
    rows = torch.randn(7, 64, generator=g, device=cuda_device).cpu().numpy()
    w = torch.randn(64, 32, generator=g, device=cuda_device)
    fn = lambda x: torch.tanh(torch.from_numpy(x).to(cuda_device) @ w)  # noqa: E731
    want = fn(rows).cpu().numpy()
    for chunk in (1, 2, 5):
        np.testing.assert_array_equal(run_chunked(fn, (rows,), chunk), want)


@pytest.mark.cuda
def test_served_requests_run_kernel_1_on_gpu(cuda_device):
    """A depth-1 service on the card: a lone request through the batcher
    equals the same request with batching off bit for bit, kernel #1
    launches 2 * parts * T times per chunk, device noise repeats per seed,
    and mean readback equals the host mean."""
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.serve import LiftingService
    cfg = D3DPConfig(frames=9, timesteps=20, sampling_timesteps=2,
                     num_proposals=2, depth=1)
    model = D3DP(cfg, device=cuda_device,
                 generator=torch.Generator().manual_seed(0))
    kp = np.random.RandomState(0).uniform(-1, 1, (20, 134, 2)).astype(
        np.float32)
    on = LiftingService(model, buckets=(1, 2, 4), device=cuda_device)
    off = LiftingService(model, buckets=(1, 2, 4), dynamic_batching=False,
                         device=cuda_device)
    dev_mean = LiftingService(model, buckets=(1, 2, 4), noise_mode="device",
                              readback="mean", device=cuda_device)
    try:
        fused_block.launches = 0
        a = on.lift(kp, seed=3)["poses"]
        assert fused_block.launches == 2 * 3 * cfg.sampling_timesteps
        np.testing.assert_array_equal(a, off.lift(kp, seed=3)["poses"])
        full = on.lift(kp, seed=3, all_hypotheses=True)["poses"]
        np.testing.assert_allclose(full.mean(axis=0), a, rtol=0, atol=1e-6)
        d = dev_mean.lift(kp, seed=3)["poses"]
        assert np.all(np.isfinite(d))
        np.testing.assert_array_equal(d, dev_mean.lift(kp, seed=3)["poses"])
        assert np.abs(d - dev_mean.lift(kp, seed=4)["poses"]).max() > 0
    finally:
        on.close()
        dev_mean.close()


@pytest.mark.cuda
def test_block_train_bf16_at_134_joints_on_gpu(cuda_device):
    """Kernels #5/#6 on the monolithic 134-joint model's spatial shape
    (L = 134, d = 36: the attention backward's largest shared-memory
    footprint) with bfloat16 x and g."""
    B, L, C = 16, 134, 288
    params = _params(C, seed=7, device=cuda_device)
    x, g, m1, m2 = _inputs(B, L, C, seed=3, device=cuda_device)
    x, g = x.bfloat16(), g.bfloat16()
    y, saved = block_train_fwd(x, m1, m2, params, HEADS)
    dx, grads = block_train_bwd(saved, g)
    torch.cuda.synchronize()
    want = train_fwd_reference(x, m1, m2, params, HEADS)
    assert (y.float() - want.float()).abs().max() <= 2.0 ** -5
    want_dx, want_grads = train_bwd_reference(x, g, m1, m2, params, HEADS)
    assert max(_rel_errs(grads, want_grads)) <= 1e-4
    assert max(_rel_errs((dx.float(),), (want_dx.float(),))) <= 2.0 ** -7


def _model_outputs(make, x2d, x3d, t, **swap):
    """A depth-2 model's output with its blocks' functions swapped in."""
    m = make()
    for net in m.pose_estimator.values():
        for k, v in swap.items():
            setattr(net, k, v)
    with torch.no_grad():
        return m.pose_estimator(x2d, x3d, t).float().cpu().numpy()


#: (max abs, mean abs) on outputs of ~1-3: tests/test_torch_bf16.py's
#: bound at auto for the plain versions against the JAX kernels at depth 2
#: (the same kind of difference: one set of bfloat16 rounding points,
#: float32 sums in another order).  On the card #2's products run as
#: three TF32 products in another order than cuBLAS's, so its output
#: roundings flip as often as #1's.  Measured on the H100: auto, block_t
#: and layer 1.14e-2 / 1.72e-3, true 7.8e-3 / 1.08e-3 (the CPU's JAX
#: comparison gives true 3.4e-3 / 5.6e-5); the plain versions sit 1.8e-2 /
#: 3.2e-3 from the float32 model.
BF16_MODEL_TOL = (2e-2, 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", ["auto", "true", "block_t", "layer"])
def test_bf16_model_on_kernels_matches_plain_on_gpu(cuda_device, use_pallas):
    """The part router in bfloat16 at depth 2 on kernel #1 (auto), #2
    (true), #1 and #3 (block_t) or #4 (layer) against the same model on
    those kernels' plain versions, within BF16_MODEL_TOL."""
    import functools
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.models.mixste import unfused_block
    r = np.random.RandomState(0)
    x2d, x3d = (torch.tensor(r.randn(4, 27, 134, c), dtype=torch.float32,
                             device=cuda_device) for c in (2, 3))
    t = torch.tensor([0, 10, 500, 999], device=cuda_device)

    def make():
        return D3DP(D3DPConfig(depth=2), device=cuda_device,
                    generator=torch.Generator().manual_seed(0),
                    use_pallas=use_pallas, experimental_kernels=True,
                    compute_dtype="bfloat16")

    plain = {"auto": {"block_fn": block_reference},
             "true": {"block_fn": functools.partial(
                 unfused_block, attention_fn=attention_reference)},
             "block_t": {"block_fn": block_reference,
                         "block_t_fn": block_temporal_reference},
             "layer": {"layer_fn": layer_reference}}[use_pallas]
    got = _model_outputs(make, x2d, x3d, t)
    want = _model_outputs(make, x2d, x3d, t, **plain)
    d = np.abs(got - want)
    assert (d.max() <= BF16_MODEL_TOL[0]
            and d.mean() <= BF16_MODEL_TOL[1]), (d.max(), d.mean())


@pytest.mark.cuda
def test_bf16_training_step_matches_plain_on_gpu(cuda_device):
    """A bfloat16 training step at depth 1 on kernels #5/#6 against the
    same step on their plain versions (block_train_plain)."""
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.ops.block_train import block_train_plain
    r = np.random.RandomState(1)
    x2d = r.randn(4, 27, 134, 2).astype(np.float32)
    x3d = (r.randn(4, 27, 134, 3) * 0.1).astype(np.float32)
    out = []
    for plain in (False, True):
        m = D3DP(D3DPConfig(depth=1, drop_path_rate=0.1), device=cuda_device,
                 generator=torch.Generator().manual_seed(0),
                 compute_dtype="bfloat16")
        if plain:
            for net in m.pose_estimator.values():
                net.train_block_fn = block_train_plain
        st = tr.create_train_state(m, seed=0, device=cuda_device)
        loss = float(tr.build_train_step(m, st.optimizer)(st, 1e-4, x2d, x3d))
        out.append((loss, [p.grad for p in m.parameters()]))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-3 * abs(lp)
    assert max(_rel_errs(gk, gp)) <= 5e-2


@pytest.mark.cuda
def test_loss_readback_waits_for_its_own_step_only_on_gpu(cuda_device):
    """The training loop's one-deep loss readback (``train.run_epoch``, the
    CLIs' loop): step 0's loss is read after step 1 (40 float32 4096^3
    products, ~0.1 s) has been queued, and the read returns while step 1
    still runs, as its event's ``query()`` shows when batch 2 starts; a
    blocking ``float()`` would have waited for step 1 too.  One product
    runs first: the first product of a process initialises cuBLAS, which
    blocks the host for the whole queue."""
    from pafuse_tpu_torch import train as tr
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4096, 4096, generator=g, device=cuda_device) / 64
    a @ a
    torch.cuda.synchronize()
    done, seen = [], []

    def step(state, lr, b2d, b3d):
        loss = a[:2, :2].sum() * float(b2d[0, 0] + 1)
        if b2d[0, 0] == 1:                      # step 1: long work
            big = a
            for _ in range(40):
                big = big @ a
            loss = loss + 0 * big[0, 0]
        ev = torch.cuda.Event()
        ev.record()
        done.append(ev)
        return loss

    def progress(it):
        if it == 2:
            seen.append(done[1].query())

    batches = [(None, np.zeros((2, 1), np.float32),
                np.full((2, 1), i, np.float32)) for i in range(3)]
    total, n = tr.run_epoch(step, None, 0.0, batches, 2, progress=progress)
    assert seen == [False]
    s = float(a[:2, :2].sum())
    assert n == 6 and abs(total - 2 * s * (1 + 2 + 3)) <= 1e-4 * abs(total)


@pytest.mark.cuda
def test_autodiff_dropout_step_queues_without_waiting_on_gpu(cuda_device,
                                                            monkeypatch):
    """An autodiff training step with dropout, attention dropout and drop
    path (depth 1) queued behind long work (80 float32 4096^3 products,
    ~0.2 s) returns while that work still runs, as its event's ``query()``
    shows: the keep probabilities of ``models.mixste._dropout`` and
    ``_drop_path`` are filled on the device (``_keep_prob``).  With the
    former ``torch.tensor(1 - rate, device=)`` in its place, a copy from
    pageable host memory, the same step waits for the whole queue.  One
    step runs first (cuBLAS, the allocator, the AdamW state)."""
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.models import mixste
    model = D3DP(D3DPConfig(frames=9, timesteps=50, depth=1, dropout=0.1,
                            attn_dropout=0.1, drop_path_rate=0.1),
                 device=cuda_device,
                 generator=torch.Generator().manual_seed(0))
    assert model.train_path == "autodiff"
    st = tr.create_train_state(model, seed=0, device=cuda_device)
    step = tr.build_train_step(model, st.optimizer)
    r = np.random.RandomState(0)
    x2d = r.randn(4, 9, 134, 2).astype(np.float32)
    x3d = (r.randn(4, 9, 134, 3) * 0.1).astype(np.float32)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4096, 4096, generator=g, device=cuda_device) / 64
    float(step(st, 1e-4, x2d, x3d))
    a @ a
    torch.cuda.synchronize()

    def queued_behind_long_work():
        big = a
        for _ in range(80):
            big = big @ a
        long_done = torch.cuda.Event()
        long_done.record()
        loss = step(st, 1e-4, x2d, x3d)
        waited = long_done.query()
        assert np.isfinite(float(loss))
        return waited

    assert queued_behind_long_work() is False
    monkeypatch.setattr(mixste, "_keep_prob", lambda x, rate: torch.tensor(
        1.0 - rate, dtype=x.dtype, device=x.device))
    assert queued_behind_long_work() is True


@pytest.mark.cuda
def test_eval_drain_waits_for_its_own_batch_only_on_gpu(cuda_device,
                                                        monkeypatch):
    """The evaluation drain: batch 0's metrics are read after batch 1 has
    been dispatched, from a copy queued right behind batch 0's work, so
    the read returns while batch 1 (its sampler call followed by 40
    float32 4096^3 products) still runs; a blocking ``.cpu()`` would have
    waited for batch 1 too.  One product runs first, as in the loss
    readback test."""
    from pafuse_tpu_torch import evaluate as ev
    from pafuse_tpu_torch.data import h3wb
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    model = D3DP(D3DPConfig(frames=9, timesteps=20, depth=1), device=cuda_device)
    ds = h3wb.make_synthetic(subjects=("S8",), actions_per_subject=1,
                             frames_per_action=36, seed=0)
    kp = h3wb.prepare_data(ds)
    seqs = list(zip(*h3wb.fetch(["S8"], kp, ds)))      # 4 x 4 windows
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4096, 4096, generator=g, device=cuda_device) / 64
    a @ a
    torch.cuda.synchronize()
    real, events, seen = model.eval_forward, [], []

    def slow_second(*args, **kw):
        out = real(*args, **kw)
        if len(events) == 1:                    # batch 1: long work after
            big = a
            for _ in range(40):
                big = big @ a
            out = out + 0 * big[0, 0]
        e = torch.cuda.Event()
        e.record()
        events.append(e)
        return out

    add = ev.EvalAccumulator.add

    def spy(self, metrics, weight):
        if not seen:
            seen.append(events[1].query())
        return add(self, metrics, weight)

    monkeypatch.setattr(model, "eval_forward", slow_second)
    monkeypatch.setattr(ev.EvalAccumulator, "add", spy)
    acc, _ = ev.evaluate_sequences(model, seqs, receptive_field=9,
                                   num_proposals=2, sampling_timesteps=1,
                                   window_batch=8)
    assert len(events) == 2 and seen == [False]
    assert all(np.all(np.isfinite(v)) for v in acc.means_mm().values())


@pytest.mark.cuda
def test_two_replicas_on_one_card_serve_as_one_on_gpu(cuda_device):
    """``LiftingService(devices=[cuda, cuda])``: the rows of each sampler
    call split over two replicas (each on the card's stream) and read back
    in row order equal one replica's poses within chip_smoke.py's
    SERVE_TOL (the library GEMMs of the embedding and head may round a row
    differently at another row count)."""
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    from pafuse_tpu_torch.serve import LiftingService
    cfg = D3DPConfig(frames=9, timesteps=20, sampling_timesteps=2,
                     num_proposals=2, depth=1)

    def service(**kw):
        return LiftingService(D3DP(cfg, device=cuda_device,
                                   generator=torch.Generator().manual_seed(0)),
                              buckets=(1, 2, 4, 8), **kw)

    one, two = service(device=cuda_device), service(
        devices=[cuda_device, cuda_device])
    try:
        kp = np.random.RandomState(0).uniform(-1, 1, (60, 134, 2))
        for frames in (9, 40, 60):
            a, b = (s.lift(kp[:frames], seed=2)["poses"] for s in (one, two))
            assert np.max(np.abs(a - b)) <= 1e-3
        assert two.health()["mesh_devices"] == 2
    finally:
        one.close()
        two.close()


ATTN_CORE_TOL_F32 = 1e-5
ATTN_CORE_TOL_BF16 = 2.0 ** -7

#: (L, C) of the attention stage: the six serve bucket-16 shapes (each
#: part's joints and 27 frames), 3DHP's (C 288, d 36), the monolithic
#: model's 134 joints, 243 frames (two passes over chunks of 64 keys) and
#: one token; then the shapes the streamed kernel takes in float32 (and in
#: bfloat16 past 512 tokens or d = 64): MixSTE's cs=512 model at 243 frames
#: (resident) and 351 (streamed), 351 frames at d = 48, d = 128 (C = 1024)
#: at 243 frames, 134 joints and one token, and an odd d = 65 (C = 520)
ATTN_CORE_SHAPES = [(24, 384), (27, 384), (68, 224), (27, 224), (42, 256),
                    (27, 256), (17, 288), (27, 288), (134, 288), (243, 384),
                    (243, 224), (1, 384), (243, 512), (351, 512), (351, 384),
                    (243, 1024), (134, 1024), (1, 1024), (300, 520)]


def _attention_core_ok(got, want, qkv):
    """(within the bound, max abs error): ATTN_CORE_TOL_F32 in float32,
    ATTN_CORE_TOL_BF16 x (|want| + max|v|) elementwise in bfloat16."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return bool(diff.max() <= ATTN_CORE_TOL_F32), float(diff.max())
    vmax = qkv[..., 2 * (qkv.shape[-1] // 3):].float().abs().max()
    bound = ATTN_CORE_TOL_BF16 * (want.float().abs() + vmax)
    return bool((diff <= bound).all()), float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["S=1", "S=N"])
@pytest.mark.parametrize("L,C", ATTN_CORE_SHAPES)
def test_attention_core_matches_plain_on_gpu(cuda_device, dtype, layout, L,
                                             C):
    """The chain's tensor-core attention alone against its plain version,
    on (24, L, 3C) sequences and on the (2, L, 12, 3C) frames-first layout
    of kernels #3 and #4; a repeat gives the same bits."""
    r = np.random.RandomState(L + C)
    shape = (24, L) if layout == "S=1" else (2, L, 12)
    qkv = torch.tensor(r.randn(*shape, 3 * C), dtype=torch.float32,
                       device=cuda_device).to(dtype)
    launches = attention_core.launches
    got = attention_core(qkv, HEADS)
    torch.cuda.synchronize()
    assert attention_core.launches == launches + 1
    assert got.shape == qkv.shape[:-1] + (C,) and got.dtype == dtype
    ok, err = _attention_core_ok(got, attention_core_reference(qkv, HEADS),
                                 qkv)
    assert ok, err
    assert torch.equal(got, attention_core(qkv, HEADS))


@pytest.mark.cuda
def test_chains_run_the_tensor_core_attention_on_gpu(cuda_device):
    """Under torch.profiler kernels #1 (float32 and bfloat16), #3, #4, #2
    and #5 launch attention_tc_kernel, #6 attention_bwd_tc_kernel, and none
    launches a kernel named attention_kernel or attn_bwd_kernel (the scalar
    stages the tensor-core ones replaced)."""
    sp = _params(224, seed=5, device=cuda_device)
    tp = _params(224, seed=6, device=cuda_device)
    x, _, m1, m2 = _inputs(2 * 27, 68, 224, seed=7, device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        x3 = x.to(dtype)
        x4 = x3.reshape(2, 27, 68, 224)
        for what, fn in (
                ("#1", lambda: fused_block(x3, sp[:12], sp[12:], HEADS)),
                ("#3", lambda: fused_block_temporal(x4, tp[:12], tp[12:],
                                                    HEADS)),
                ("#4", lambda: fused_layer(x4, sp[:12], sp[12:], tp[:12],
                                           tp[12:], HEADS))):
            names = _device_kernels(fn)
            assert any("attention_tc_kernel" in n for n in names), (what, names)
            assert not any("attention_kernel" in n for n in names), (what,
                                                                     names)
    for what, fn in (
            ("#2", lambda: fused_attention(x, *sp[2:6], HEADS)),
            ("#5", lambda: block_train_fwd(x, m1, m2, sp, HEADS))):
        names = _device_kernels(fn)
        assert any("attention_tc_kernel" in n for n in names), (what, names)
        assert not any("attention_kernel" in n for n in names), (what, names)
    _, saved = block_train_fwd(x, m1, m2, sp, HEADS)
    names = _device_kernels(lambda: block_train_bwd(saved, x))
    assert any("attention_bwd_tc_kernel" in n for n in names), names
    assert not any("attn_bwd_kernel" in n or "attention_kernel" in n
                   for n in names), names


@pytest.mark.cuda
def test_chains_reject_shapes_the_attention_does_not_take_on_gpu(
        cuda_device):
    """The shapes the resident attention refused run on the streamed one
    against their plain versions: a head size of 72 in #1, one (sequence,
    head) beyond a CTA's shared memory (float32, d = 64, 300 tokens) in #3
    and the stage alone; a head size above 128 raises ValueError, naming
    the limit, before any launch."""
    wide = _params(8 * 72, seed=8, device=cuda_device)
    x, _, _, _ = _inputs(2, 10, 8 * 72, seed=8, device=cuda_device)
    got = fused_block(x, wide[:12], wide[12:], HEADS)
    want = block_reference(x, wide[:12], wide[12:], HEADS)
    assert float((got - want).abs().max()) <= 1e-4
    p = _params(8 * 64, seed=9, device=cuda_device)
    x, _, _, _ = _inputs(2, 300, 8 * 64, seed=9, device=cuda_device)
    x = x.view(1, 300, 2, 8 * 64)
    got = fused_block_temporal(x, p[:12], p[12:], HEADS)
    want = block_temporal_reference(x, p[:12], p[12:], HEADS)
    assert float((got - want).abs().max()) <= 1e-4
    qkv = torch.randn(1, 300, 3 * 8 * 64, device=cuda_device)
    got = attention_core(qkv, HEADS)
    ok, err = _attention_core_ok(got, attention_core_reference(qkv, HEADS),
                                 qkv)
    assert ok, err
    over = _params(8 * 136, seed=10, device=cuda_device)
    launches = fused_block.launches
    with pytest.raises(ValueError, match="head sizes from 1 to 128"):
        fused_block(torch.zeros(2, 10, 8 * 136, device=cuda_device),
                    over[:12], over[12:], HEADS)
    with pytest.raises(ValueError, match="head sizes from 1 to 128"):
        attention_core(torch.zeros(1, 5, 3 * 8 * 136, device=cuda_device),
                       HEADS)
    assert fused_block.launches == launches


@pytest.mark.cuda
def test_streamed_kernels_run_past_the_resident_shapes_on_gpu(cuda_device):
    """The library routes the forward at 351 tokens (d = 64) and at d = 128,
    and the backward at 243 tokens (d = 64), to the streamed kernels: each
    call launches the streamed forward once, or each of the backward's two
    passes once, as the libraries count their launches, and repeats bit
    for bit; 134 tokens at d = 36 keep the resident kernels and launch
    none."""
    for L, C, streamed in ((351, 512, True), (17, 1024, True),
                           (134, 288, False)):
        qkv = torch.randn(4, L, 3 * C, device=cuda_device)
        stream_launches(zero=True)
        got = attention_core(qkv, HEADS)
        assert stream_launches(zero=True) == {
            "forward": int(streamed), "backward_a": 0, "backward_b": 0}
        assert torch.equal(got, attention_core(qkv, HEADS))
    for L, C, streamed in ((243, 512, True), (134, 288, False)):
        qkv = torch.randn(4, L, 3 * C, device=cuda_device)
        do = torch.randn(4, L, C, device=cuda_device)
        stream_launches(zero=True)
        got = attention_core_bwd(qkv, do, HEADS)
        assert stream_launches(zero=True) == {
            "forward": 0, "backward_a": int(streamed),
            "backward_b": int(streamed)}
        assert torch.equal(got, attention_core_bwd(qkv, do, HEADS))


ATTN_BWD_RTOL = 1e-5

#: (B, L, C) of the attention backward: each part's spatial and temporal
#: training shape (37 sequences of 27 frames), 3DHP's, the monolithic
#: model's 134 joints, and 243 frames at each part width; then the shapes
#: the streamed backward takes: MixSTE's cs=512 model at 243 and 351
#: frames, 351 frames at d = 48, d = 128 (C = 1024) at 243 frames, 134
#: joints and 17, and an odd d = 65 (C = 520)
ATTN_BWD_SHAPES = [(999, 24, 384), (888, 27, 384), (999, 68, 224),
                   (2516, 27, 224), (999, 42, 256), (1554, 27, 256),
                   (999, 17, 288), (629, 27, 288), (999, 134, 288),
                   (4958, 27, 288), (64, 243, 224), (64, 243, 256),
                   (64, 243, 288), (64, 243, 384), (64, 243, 512),
                   (64, 351, 512), (64, 351, 384), (32, 243, 1024),
                   (64, 134, 1024), (256, 17, 1024), (32, 300, 520)]


def _attention_bwd_errs(got, want):
    """max|got - want| / max|want| for dq, dk and dv of (B, L, 3C)."""
    C = got.shape[-1] // 3
    return [float((got[..., i * C:(i + 1) * C] - want[..., i * C:(i + 1) * C])
                  .abs().max() / want[..., i * C:(i + 1) * C].abs().max())
            for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,C", ATTN_BWD_SHAPES)
def test_attention_core_bwd_matches_plain_on_gpu(cuda_device, B, L, C):
    """Kernel #6's attention backward alone against its plain version on
    unit-variance qkv and dO; a repeat gives the same bits."""
    r = np.random.RandomState(B + L + C)
    qkv, do = (torch.tensor(r.randn(B, L, n), dtype=torch.float32,
                            device=cuda_device) for n in (3 * C, C))
    launches = attention_core_bwd.launches
    got = attention_core_bwd(qkv, do, HEADS)
    torch.cuda.synchronize()
    assert attention_core_bwd.launches == launches + 1
    assert got.shape == qkv.shape and bool(torch.isfinite(got).all())
    errs = _attention_bwd_errs(got, attention_core_bwd_reference(qkv, do,
                                                                 HEADS))
    assert max(errs) <= ATTN_BWD_RTOL, errs
    assert torch.equal(got, attention_core_bwd(qkv, do, HEADS))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,C", [(37, 243, 256), (8, 243, 384),
                                   (8, 243, 512), (4, 243, 1024),
                                   (8, 134, 1024), (16, 27, 1024)])
def test_block_train_at_243_frames_on_gpu(cuda_device, B, L, C):
    """Kernels #5/#6 at 243 tokens (MixSTE's receptive field; head sizes 32
    and 48 resident, 64 and 128 streamed) and at C = 1024 (the LayerNorm
    backward's wide rows), against their plain versions; a second backward
    gives the same bits."""
    params = _params(C, seed=L + C, device=cuda_device)
    x, g, m1, m2 = _inputs(B, L, C, seed=2, device=cuda_device)
    y, saved = block_train_fwd(x, m1, m2, params, HEADS)
    dx, grads = block_train_bwd(saved, g)
    torch.cuda.synchronize()
    assert (y - train_fwd_reference(x, m1, m2, params, HEADS)).abs().max() <= 1e-4
    want_dx, want = train_bwd_reference(x, g, m1, m2, params, HEADS)
    assert max(_rel_errs((dx,) + grads, (want_dx,) + want)) <= 1e-4
    dx2, grads2 = block_train_bwd(saved, g)
    assert all(torch.equal(a, b) for a, b in zip((dx,) + grads, (dx2,) + grads2))


@pytest.mark.cuda
def test_float32_training_step_repeats_bit_for_bit_on_gpu(cuda_device):
    """Two float32 training steps at depth 2 on kernels #5/#6 from one seed
    give the same loss and the same parameters, bit for bit."""
    from pafuse_tpu_torch import train as tr
    from pafuse_tpu_torch.diffusion import D3DP, D3DPConfig
    r = np.random.RandomState(3)
    x2d = r.randn(8, 27, 134, 2).astype(np.float32)
    x3d = (r.randn(8, 27, 134, 3) * 0.1).astype(np.float32)
    runs = []
    for _ in range(2):
        m = D3DP(D3DPConfig(depth=2, drop_path_rate=0.1), device=cuda_device,
                 generator=torch.Generator().manual_seed(0))
        st = tr.create_train_state(m, seed=0, device=cuda_device)
        step = tr.build_train_step(m, st.optimizer)
        losses = [float(step(st, 1e-4, x2d, x3d)) for _ in range(2)]
        runs.append((losses, [p.detach().clone() for p in m.parameters()]))
    (l1, p1), (l2, p2) = runs
    assert l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


@pytest.mark.cuda
def test_kernels_2_and_5_reject_shapes_the_attention_does_not_take_on_gpu(
        cuda_device):
    """The shapes kernel #2 and kernels #5/#6 refused run against their
    plain versions: a head size of 72 (C = 288, 4 heads), 300 tokens at d =
    64 in the forward and 200 in the backward; a head size above 128 raises
    ValueError, naming the limit, before any launch."""
    wide = _params(288, seed=8, device=cuda_device)
    x, g, m1, m2 = _inputs(3, 10, 288, seed=8, device=cuda_device)
    got = fused_attention(x, *wide[2:6], 4)
    assert float((got - attention_reference(x, *wide[2:6], 4)).abs().max()
                 ) <= 1e-5
    y, saved = block_train_fwd(x, m1, m2, wide, 4)
    assert float((y - train_fwd_reference(x, m1, m2, wide, 4)).abs().max()
                 ) <= 1e-4
    dx, grads = block_train_bwd(saved, g)
    want_dx, want = train_bwd_reference(x, g, m1, m2, wide, 4)
    assert max(_rel_errs((dx,) + grads, (want_dx,) + want)) <= 1e-4
    p = _params(8 * 64, seed=9, device=cuda_device)
    for L in (300, 200):
        x, g, m1, m2 = _inputs(1, L, 8 * 64, seed=L, device=cuda_device)
        got = fused_attention(x, *p[2:6], HEADS)
        assert float((got - attention_reference(x, *p[2:6], HEADS)).abs()
                     .max()) <= 1e-5
        y, saved = block_train_fwd(x, m1, m2, p, HEADS)
        dx, grads = block_train_bwd(saved, g)
        want_dx, want = train_bwd_reference(x, g, m1, m2, p, HEADS)
        assert max(_rel_errs((dx,) + grads, (want_dx,) + want)) <= 1e-4
    qkv = torch.randn(1, 200, 3 * 8 * 64, device=cuda_device)
    do = torch.randn(1, 200, 8 * 64, device=cuda_device)
    errs = _attention_bwd_errs(attention_core_bwd(qkv, do, HEADS),
                               attention_core_bwd_reference(qkv, do, HEADS))
    assert max(errs) <= ATTN_BWD_RTOL, errs
    x = torch.zeros(2, 10, 288, device=cuda_device)
    ones = torch.ones(2, device=cuda_device)
    launches = (fused_attention.launches, block_train_fwd.launches)
    with pytest.raises(ValueError, match="head sizes from 1 to 128"):
        fused_attention(x, *wide[2:6], 2)
    with pytest.raises(ValueError, match="head sizes from 1 to 128"):
        block_train_fwd(x, ones, ones, wide, 2)
    assert (fused_attention.launches, block_train_fwd.launches) == launches
