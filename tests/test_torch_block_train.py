"""Port trainable block (pafuse_tpu_torch.ops.block_train) against the JAX
package.

The same seeded inputs, weights, branch masks and output gradient go through
the port's plain versions (``train_fwd_reference`` / ``train_bwd_reference``,
which the kernel wrappers use for CPU tensors) and through two JAX
references: the TPU kernels ``_train_fwd_kernel`` / ``_train_bwd_kernel``
themselves, run by ``pl.pallas_call`` in interpret mode over a grid of two
batch tiles with L padded to a multiple of 8 as ``block_grad._pad_tiles``
pads it (so the cross-tile gradient accumulation and the pad masking are
exercised), and the XLA block (``mixste._attention``/``_mlp`` with the masks
applied, then the outer LayerNorm) with ``jax.grad``.  Weights cross through
``checkpoints.params_from_jax``.

Tolerances (float32): forward 2e-5 max abs (sums differ only in order; the
TPU kernel's A&S erf differs from the exact erf by <= ~1e-7); gradients
1e-4 x max|reference gradient| per tensor (dx and each of the 14 parameter
gradients).

Then the CUDA backward's arithmetic, emulated in the plain backward: every
product of its GEMMs as three TF32 products, the weight gradients summed
per chunk of ``weight_grad_chunk_rows`` rows in partial sums of two 32-row
slices and then in chunk order, the bias gradients per chunk as four
row-order sums (rows m with m % 8 in {2t, 2t + 1}) added (s0 + s1) + (s2 +
s3) and then in chunk order, within the same 1e-4 x max|gradient| of the
plain gradients.  The chunk rule itself at every training shape of H3WB,
3DHP and MixSTE: each row in one chunk, in order, and the last wave of
work items at least half full.

The forward's GEMM stage, ``fwd_linear_reference`` (through which the plain
forward runs its four products), against the intermediates of the JAX
forward ``block_grad._fwd_core(..., want_residuals=True)`` on the same
inputs: qkv (bias), x1 (masked residual on x0), u and gu (bias and GELU)
from JAX's own h1, o and h2, and x2 from JAX's gu and x1 against float64;
FWD_TOL max abs (float32 sums of at most 2C products in another order, the
A&S erf within ~1e-7).  Then the CUDA forward's arithmetic emulated in the
plain forward (three TF32 products per product, partial sums over pairs of
32-deep K slices added in float32) within TRAIN_FWD_TOL, chip_smoke.py's
bound for kernel #5, of the JAX forward.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from pafuse_tpu.models import mixste
from pafuse_tpu.ops import block_grad
from pafuse_tpu_torch import checkpoints
from pafuse_tpu_torch.models.mixste import Block
from pafuse_tpu_torch.ops import block_train as port_block_train
from pafuse_tpu_torch.ops.block_train import (block_train, block_train_bwd,
                                              block_train_fwd, fwd_linear,
                                              fwd_linear_reference,
                                              train_bwd_reference,
                                              train_fwd_reference,
                                              weight_grad_chunk_rows)
from pafuse_tpu_torch.ops.gemm import split_tf32

torch.set_num_threads(2)

HEADS = 8
FWD_TOL = 2e-5
TRAIN_FWD_TOL = 1e-4
GRAD_RTOL = 1e-4
KEEP = 0.9


def _jax_block(C, seed):
    """Random block params (LayerNorm affine included) + outer norm."""
    r = np.random.RandomState(seed)
    hid = 2 * C

    def lin(i, o):
        b = 1.0 / np.sqrt(i)
        return {"kernel": r.uniform(-b, b, (i, o)).astype(np.float32),
                "bias": r.uniform(-b, b, (o,)).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * r.randn(C)).astype(np.float32),
                "bias": (0.1 * r.randn(C)).astype(np.float32)}

    p = {"norm1": ln(), "attn": {"qkv": lin(C, 3 * C), "proj": lin(C, C)},
         "norm2": ln(), "mlp": {"fc1": lin(C, hid), "fc2": lin(hid, C)}}
    return p, ln()


def _port_params(p, outer):
    """The 14 port tensors (torch layout) of a JAX block + outer norm."""
    C = p["norm1"]["scale"].shape[0]
    blk = Block(C, 2.0)
    blk.load_state_dict(checkpoints.params_from_jax(p), strict=True)
    return tuple(t.detach() for t in blk.params()) + tuple(
        torch.tensor(np.asarray(outer[k])) for k in ("scale", "bias"))


def _inputs(B, L, C, seed):
    """x, g and masks that mix 0, 1/keep and 1."""
    r = np.random.RandomState(seed)
    x = r.randn(B, L, C).astype(np.float32)
    g = r.randn(B, L, C).astype(np.float32)
    pattern = np.array([0.0, 1.0 / KEEP, 1.0], np.float32)
    m1 = pattern[np.arange(B) % 3]
    m2 = pattern[(np.arange(B) + 1) % 3]
    return x, g, m1, m2


def _tiled(x, m1, m2, g=None):
    """Pad L to a multiple of 8 and lay out two batch tiles."""
    B, L, C = x.shape
    Lp = -(-L // 8) * 8
    pad = ((0, 0), (0, Lp - L), (0, 0))
    out = [jnp.asarray(np.pad(x, pad)), jnp.asarray(m1.reshape(B, 1, 1)),
           jnp.asarray(m2.reshape(B, 1, 1))]
    if g is not None:
        out.insert(1, jnp.asarray(np.pad(g, pad)))
    return out, B // 2, Lp


def _specs(flat, TB, Lp, C):
    full = lambda a: pl.BlockSpec(a.shape, lambda i, n=a.ndim: (0,) * n)  # noqa: E731
    xspec = pl.BlockSpec((TB, Lp, C), lambda i: (i, 0, 0))
    mspec = pl.BlockSpec((TB, 1, 1), lambda i: (i, 0, 0))
    return xspec, mspec, [full(a) for a in flat]


def _kernel_fwd(p, outer, x, m1, m2):
    """The TPU forward kernel through pallas_call in interpret mode."""
    B, L, C = x.shape
    (xf, mf1, mf2), TB, Lp = _tiled(x, m1, m2)
    flat = [jnp.asarray(a) for a in block_grad._flat_params(p, outer)]
    xspec, mspec, pspecs = _specs(flat, TB, Lp, C)
    kernel = functools.partial(block_grad._train_fwd_kernel, num_heads=HEADS,
                               seq_len=L, head_dim=C // HEADS)
    out = pl.pallas_call(
        kernel, grid=(B // TB,), in_specs=[xspec, mspec, mspec] + pspecs,
        out_specs=xspec, out_shape=jax.ShapeDtypeStruct((B, Lp, C), jnp.float32),
        interpret=True)(xf, mf1, mf2, *flat)
    return np.asarray(out)[:, :L]


def _kernel_bwd(p, outer, x, g, m1, m2):
    """The TPU backward kernel in interpret mode: (dx, JAX-layout grads)."""
    B, L, C = x.shape
    (xf, gf, mf1, mf2), TB, Lp = _tiled(x, m1, m2, g)
    flat = [jnp.asarray(a) for a in block_grad._flat_params(p, outer)]
    xspec, mspec, pspecs = _specs(flat, TB, Lp, C)
    kernel = functools.partial(block_grad._train_bwd_kernel, num_heads=HEADS,
                               seq_len=L, head_dim=C // HEADS)
    outs = pl.pallas_call(
        kernel, grid=(B // TB,),
        in_specs=[xspec, xspec, mspec, mspec] + pspecs,
        out_specs=[xspec] + pspecs,
        out_shape=[jax.ShapeDtypeStruct((B, Lp, C), jnp.float32)]
        + [jax.ShapeDtypeStruct(a.shape, jnp.float32) for a in flat],
        interpret=True)(xf, gf, mf1, mf2, *flat)
    return np.asarray(outs[0])[:, :L], [np.asarray(o) for o in outs[1:]]


def _xla_block(bp, on, x, m1, m2):
    h = mixste._attention(bp["attn"], mixste._layernorm(bp["norm1"], x),
                          HEADS, jnp.float32)
    x = x + h * m1[:, None, None]
    h = mixste._mlp(bp["mlp"], mixste._layernorm(bp["norm2"], x), jnp.float32)
    x = x + h * m2[:, None, None]
    return mixste._layernorm(on, x)


def _xla_grads(p, outer, x, g, m1, m2):
    """jax.grad of the XLA block: (dx, 14 grads in torch layout)."""
    m1, m2 = jnp.asarray(m1), jnp.asarray(m2)

    def loss(bp, on, xx):
        return jnp.vdot(_xla_block(bp, on, xx, m1, m2), jnp.asarray(g))

    gb, go, gx = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        p, outer, jnp.asarray(x))
    return np.asarray(gx), _port_params(jax.device_get(gb),
                                        jax.device_get(go))


def _to_torch_layout(jax_grads):
    """The TPU kernel's 14 gradients (JAX layout) -> torch layout."""
    names = ["norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"]
    tree = {}
    for i, name in enumerate(names):
        node = tree
        for part in name.split(".")[:-1]:
            node = node.setdefault(part, {})
        key = "scale" if name.startswith("norm") else "kernel"
        node[name.split(".")[-1]] = {key: jax_grads[2 * i],
                                     "bias": jax_grads[2 * i + 1]}
    return _port_params(tree, {"scale": jax_grads[12], "bias": jax_grads[13]})


def _assert_grads(got_dx, got, want_dx, want, what):
    pairs = [("dx", got_dx, want_dx)] + [
        (f"grad {i}", a, b) for i, (a, b) in enumerate(zip(got, want))]
    for name, a, b in pairs:
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= GRAD_RTOL, f"{what}: {name} rel err {err:.2e}"


CASES = [(4, L, C) for L in (24, 68, 42, 27) for C in (32, 64)] + [
    (2, 68, 224)]


@pytest.mark.parametrize("B,L,C", CASES)
def test_train_fwd_reference_matches_jax(B, L, C):
    p, outer = _jax_block(C, seed=L * 1000 + C)
    x, _, m1, m2 = _inputs(B, L, C, seed=L + C)
    params = _port_params(p, outer)
    got = train_fwd_reference(torch.from_numpy(x), torch.from_numpy(m1),
                              torch.from_numpy(m2), params, HEADS).numpy()
    np.testing.assert_allclose(got, _kernel_fwd(p, outer, x, m1, m2),
                               rtol=0, atol=FWD_TOL)
    want = _xla_block(p, outer, jnp.asarray(x), jnp.asarray(m1),
                      jnp.asarray(m2))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FWD_TOL)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    launches = block_train_fwd.launches
    y, _ = block_train_fwd(torch.from_numpy(x), torch.from_numpy(m1),
                           torch.from_numpy(m2), params, HEADS)
    np.testing.assert_array_equal(y.numpy(), got)
    assert block_train_fwd.launches == launches


@pytest.mark.parametrize("B,L,C", CASES)
def test_train_bwd_reference_matches_jax(B, L, C):
    p, outer = _jax_block(C, seed=L * 1000 + C + 1)
    x, g, m1, m2 = _inputs(B, L, C, seed=L + C + 1)
    params = _port_params(p, outer)
    dx, grads = train_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(m1),
        torch.from_numpy(m2), params, HEADS)
    k_dx, k_grads = _kernel_bwd(p, outer, x, g, m1, m2)
    _assert_grads(dx, grads, k_dx, _to_torch_layout(k_grads),
                  "vs TPU kernel")
    x_dx, x_grads = _xla_grads(p, outer, x, g, m1, m2)
    _assert_grads(dx, grads, x_dx, x_grads, "vs jax.grad")


@pytest.mark.parametrize("B,L,C", [(4, 24, 32), (3, 27, 64)])
def test_block_train_autograd_equals_plain_backward(B, L, C):
    p, outer = _jax_block(C, seed=B + L + C)
    x, g, m1, m2 = _inputs(B, L, C, seed=C)
    params = [t.clone().requires_grad_() for t in _port_params(p, outer)]
    xt = torch.from_numpy(x).requires_grad_()
    m1t, m2t = torch.from_numpy(m1), torch.from_numpy(m2)
    launches = (block_train_fwd.launches, block_train_bwd.launches)
    y = block_train(xt, m1t, m2t, params, HEADS)
    got = torch.autograd.grad(y, [xt] + params, torch.from_numpy(g))
    dx, grads = train_bwd_reference(torch.from_numpy(x), torch.from_numpy(g),
                                    m1t, m2t, [t.detach() for t in params],
                                    HEADS)
    for a, b in zip(got, (dx,) + tuple(grads)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (block_train_fwd.launches, block_train_bwd.launches) == launches
    # the masks get zero gradients when asked for, as in the JAX VJP
    m1r = m1t.clone().requires_grad_()
    y = block_train(xt, m1r, m2t, params, HEADS)
    (dm1,) = torch.autograd.grad(y, [m1r], torch.from_numpy(g))
    assert torch.count_nonzero(dm1) == 0


def test_block_train_rejects_bad_input():
    p, outer = _jax_block(32, seed=0)
    params = _port_params(p, outer)
    m = torch.ones(2)
    with pytest.raises(ValueError, match="unsupported device"):
        block_train_fwd(torch.empty(2, 5, 32, device="meta"), m, m, params,
                        HEADS)



def _three_products(a, b):
    """a @ b as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi on the TF32 halves."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _emulated_data_grad(a, w, aux=None):
    """The data-gradient GEMM on W^T's TF32 halves (N, K), as split once a
    call for the wgmma GEMM."""
    w_hi, w_lo = split_tf32(w.t())
    a_hi, a_lo = split_tf32(a)
    y = a_lo @ w_hi.t() + a_hi @ w_lo.t() + a_hi @ w_hi.t()
    return y if aux is None else y * port_block_train._gelu_grad(aux)


def _emulated_weight_grad(d, x):
    """d^T x in the kernel's order: per chunk of weight_grad_chunk_rows
    rows, partial sums of two 32-row slices (three TF32 products each)
    added in float32, then the chunks in order."""
    M, rows = d.shape[0], weight_grad_chunk_rows(*d.shape, x.shape[1])
    total = None
    for r0 in range(0, M, rows):
        acc = torch.zeros(d.shape[1], x.shape[1])
        for p0 in range(r0, min(r0 + rows, M), 64):
            p1 = min(p0 + 64, r0 + rows, M)
            acc = acc + _three_products(d[p0:p1].t(), x[p0:p1])
        total = acc if total is None else total + acc
    return total


def _emulated_bias_grad(d, width):
    """d.sum(0) in the kernel's order for a weight gradient of ``width``
    columns (the chunk rule's K): per chunk, the four threads of a quad sum
    their rows in order (thread t the rows m with m % 8 in {2t, 2t + 1}),
    the quad adds (s0 + s1) + (s2 + s3), then the chunks in order."""
    M, N = d.shape
    rows = weight_grad_chunk_rows(M, N, width)
    total = None
    for r0 in range(0, M, rows):
        s = [torch.zeros(N) for _ in range(4)]
        for m in range(r0, min(r0 + rows, M)):
            s[m % 8 // 2] = s[m % 8 // 2] + d[m]
        b = (s[0] + s[1]) + (s[2] + s[3])
        total = b if total is None else total + b
    return total


def _emulated_weight_grads(d, x):
    return _emulated_weight_grad(d, x), _emulated_bias_grad(d, x.shape[1])


def _chunks(M, rows):
    return [(r0, min(r0 + rows, M)) for r0 in range(0, M, rows)]


@pytest.mark.parametrize("B,L,C", [(90, 27, 64), (44, 68, 32), (60, 42, 64),
                                   (40, 243, 64)])
def test_tensor_core_backward_order_keeps_the_gradient_bound(monkeypatch, B, L,
                                                             C):
    """The plain backward with its data, weight and bias gradients computed
    as the CUDA kernel computes them, over several chunks of the chunk rule
    (the last one ragged; at 243 frames chunks of more than one pair of
    slices), against the plain backward."""
    p, outer = _jax_block(C, seed=B + L + C)
    x, g, m1, m2 = (torch.from_numpy(a) for a in _inputs(B, L, C, seed=B))
    params = _port_params(p, outer)
    M = B * L
    for N, K in ((C, 2 * C), (2 * C, C), (C, C), (3 * C, C)):
        chunks = _chunks(M, weight_grad_chunk_rows(M, N, K))
        assert len(chunks) >= 2 and M % (chunks[0][1] - chunks[0][0])
    if L == 243:
        assert weight_grad_chunk_rows(M, C, 2 * C) > 64
    want_dx, want = train_bwd_reference(x, g, m1, m2, params, HEADS)
    with monkeypatch.context() as m:
        m.setattr(port_block_train, "data_grad_reference", _emulated_data_grad)
        m.setattr(port_block_train, "weight_grads_reference",
                  _emulated_weight_grads)
        got_dx, got = train_bwd_reference(x, g, m1, m2, params, HEADS)
    _assert_grads(got_dx, got, want_dx, want, "tensor-core order")


#: (model, part, rows M = sequences x frames x joints, C) of every training
#: block: H3WB's parts (37 x 27 frames), 3DHP (17 joints, model.cs 288), the
#: monolithic 134-joint H3WB model (288) and MixSTE's (4 x 243 frames, 512)
TRAIN_ROWS = (("h3wb", "body", 999 * 24, 384), ("h3wb", "face", 999 * 68, 224),
              ("h3wb", "hands", 999 * 42, 256), ("3dhp", "whole_body", 999 * 17, 288),
              ("mono134", "whole_body", 999 * 134, 288),
              ("mixste243", "whole_body", 4 * 243 * 134, 512))


@pytest.mark.parametrize("model,part,M,C", TRAIN_ROWS)
def test_weight_grad_chunk_rule_covers_every_row_once(model, part, M, C):
    """The chunk rule at each weight gradient (N, K) of a training block:
    chunks of a multiple of 64 rows (whole pairs of 32-row slices) that take
    every row once and in order, the last one ragged or full; the same
    rows for the same shape whatever was asked before (a function of the
    shape alone); and at least half of the last wave of (tile, chunk) work
    items on 132 SMs busy."""
    shapes = ((C, 2 * C), (2 * C, C), (C, C), (3 * C, C))
    rows = [weight_grad_chunk_rows(M, N, K) for N, K in shapes]
    assert rows == [weight_grad_chunk_rows(M, N, K)
                    for N, K in reversed(shapes)][::-1]
    for (N, K), r in zip(shapes, rows):
        assert r % 64 == 0 and r >= 64
        chunks = _chunks(M, r)
        assert chunks[0][0] == 0 and chunks[-1][1] == M
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all(0 < hi - lo <= r for lo, hi in chunks)
        bn = port_block_train._wgrad_tile_n(K)
        items = -(-N // 128) * -(-K // bn) * len(chunks)
        last = items - (-(-items // 132) - 1) * 132
        assert 2 * last >= 132, (model, part, N, K, r, items)


def _jax_fwd_residuals(p, outer, x, m1, m2):
    """block_grad._fwd_core's intermediates (h1, qkv, o, x1, h2, u, gu) on
    the (B, L, C) batch as one tile, without padding."""
    B, L, C = x.shape
    flat = [jnp.asarray(a) for a in block_grad._flat_params(p, outer)]
    out = block_grad._fwd_core(
        jnp.asarray(x), jnp.asarray(m1.reshape(B, 1, 1)),
        jnp.asarray(m2.reshape(B, 1, 1)), *flat, num_heads=HEADS, seq_len=L,
        head_dim=C // HEADS, want_residuals=True)
    h1, qkv, o, x1, h2, u, gu = (np.array(out[i]).reshape(B * L, -1)
                                 for i in (1, 4, 6, 7, 8, 11, 12))
    return h1, qkv, o, x1, h2, u, gu


@pytest.mark.parametrize("B,L,C", [(4, 24, 32), (4, 68, 64), (4, 27, 64),
                                   (2, 68, 224)])
def test_fwd_linear_reference_matches_jax_fwd_core(B, L, C):
    p, outer = _jax_block(C, seed=L * 1000 + C + 2)
    x, _, m1, m2 = _inputs(B, L, C, seed=L + C + 2)
    params = _port_params(p, outer)
    h1, qkv, o, x1, h2, u, gu = _jax_fwd_residuals(p, outer, x, m1, m2)
    t = torch.from_numpy
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        a.numpy(), b, rtol=0, atol=FWD_TOL)
    close(fwd_linear_reference(t(h1), params[2], params[3]), qkv)
    close(fwd_linear_reference(t(o), params[4], params[5], "residual",
                               t(x.reshape(B * L, C)), t(m1), L), x1)
    got_u, got_gu = fwd_linear_reference(t(h2), params[8], params[9], "gelu")
    close(got_u, u)
    close(got_gu, gu)
    # x2 (not among the JAX residuals) against float64 on JAX's gu and x1
    want = x1 + np.repeat(m2, L)[:, None] * (
        gu.astype(np.float64) @ params[10].double().numpy().T
        + params[11].double().numpy())
    close(fwd_linear_reference(t(gu), params[10], params[11], "residual",
                               t(x1), t(m2), L), want)


def test_fwd_linear_on_cpu_is_the_plain_version():
    r = np.random.RandomState(0)
    a, res = (torch.from_numpy(r.randn(18, n).astype(np.float32))
              for n in (16, 24))
    w = torch.from_numpy(r.randn(24, 16).astype(np.float32))
    b = torch.from_numpy(r.randn(24).astype(np.float32))
    mask = torch.tensor([0.0, 1.0 / KEEP, 1.0])
    launches = fwd_linear.launches
    for epilogue in ("store", "gelu", "residual"):
        args = (a, w, b, epilogue, res.bfloat16(), mask, 6)
        got, want = fwd_linear(*args), fwd_linear_reference(*args)
        for g, v in zip(*(((got,), (want,)) if epilogue != "gelu"
                          else (got, want))):
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, v, rtol=0, atol=0)
    assert fwd_linear.launches == launches
    with pytest.raises(ValueError, match="unsupported device"):
        fwd_linear(a.to("meta"), w, b)
    with pytest.raises(ValueError, match="unknown epilogue"):
        fwd_linear_reference(a, w, b, "bias")


def _emulated_fwd_linear(a, w, b, epilogue="store", residual=None, mask=None,
                         seq_len=1):
    """The forward GEMM as the wgmma kernel computes it: per pair of
    32-deep K slices a partial sum of three TF32 products (a_lo*w_hi +
    a_hi*w_lo + a_hi*w_hi), the partials added in float32 in K order, then
    the bias and the epilogue."""
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = split_tf32(w)
    acc = torch.zeros(a.shape[0], w.shape[0])
    for k0 in range(0, a.shape[1], 64):
        k = slice(k0, k0 + 64)
        acc = acc + (a_lo[:, k] @ w_hi[:, k].t() + a_hi[:, k] @ w_lo[:, k].t()
                     + a_hi[:, k] @ w_hi[:, k].t())
    y = acc + b
    if epilogue == "gelu":
        return y, port_block_train._gelu(y)
    if epilogue == "residual":
        return residual.float() + mask.repeat_interleave(seq_len)[:, None] * y
    return y


@pytest.mark.parametrize("B,L,C", [(4, 27, 64), (4, 42, 64), (2, 68, 224)])
def test_tensor_core_forward_order_keeps_the_forward_bound(monkeypatch, B, L,
                                                           C):
    """The plain forward with its four products computed as the CUDA
    forward computes them (K up to 2C = 448: seven pairs of slices) against
    the JAX forward (the XLA block), within kernel #5's bound."""
    p, outer = _jax_block(C, seed=B + L + C + 3)
    x, _, m1, m2 = _inputs(B, L, C, seed=B + 3)
    params = _port_params(p, outer)
    with monkeypatch.context() as m:
        m.setattr(port_block_train, "fwd_linear_reference",
                  _emulated_fwd_linear)
        got = train_fwd_reference(torch.from_numpy(x), torch.from_numpy(m1),
                                  torch.from_numpy(m2), params, HEADS)
    want = _xla_block(p, outer, jnp.asarray(x), jnp.asarray(m1),
                      jnp.asarray(m2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TRAIN_FWD_TOL)
