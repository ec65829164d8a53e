"""The arithmetic of kernel K4 (csrc/se_conv.cu), emulated on the CPU:
3xTF32 tensor-core products against `se_conv_plain` and the JAX `se_conv`
(Pallas in interpret mode).

The kernels split each GEMM operand as hi = rna_tf32(v), lo = rna_tf32(v -
hi) and sum three products (lo.hi + hi.lo + hi.hi) in float32:

  forward  u = x*s + t (0 outside the image) against the taps w;
  dgrad    g = (dy + dsum + 2 y dsq + dm) relu'(y) against the flipped,
           transposed taps Wd[ci][co][kh][kw] = w[co][ci][2 - kh][2 - kw];
  wgrad    dW[co][ci][kh][kw] = S over positions of g[co] u[ci] shifted by
           (kh - 1, kw - 1), one GEMM per tap.

Here each product is a float32 convolution (wgrad: a float32 matmul per
tap) of the split operands. Bounds, as chip_smoke.py holds K4 on the card:
5e-4 absolute on y and dx, 1e-4 x the largest value on every reduction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_se_conv import _jax_se_conv
from test_torch_tf32_split import split

from zerovox_tpu_torch.ops.se_conv import se_conv_plain

C = 32
TOL = 5e-4
RED_TOL = 1e-4


def tf32x3(op, a, b):
    """op(a, b) as the kernels compute it: three TF32 products summed in
    float32. Float64 operands go through unsplit (the index maps alone)."""
    if a.dtype == torch.float64:
        return op(a, b)
    ah, al = split(a)
    bh, bl = split(b)
    return op(al, bh) + op(ah, bl) + op(ah, bh)


def tc3(a, w):
    """'same' 3x3 conv of a with taps w, as the kernels compute it."""
    return tf32x3(lambda p, q: F.conv2d(p, q, padding=1), a, w)


def fwd_tc(x, w, s, t, relu):
    u = x * s[None, :, None, None] + t[None, :, None, None]
    y = tc3(u, w)  # zero padding of u, as the kernel's window
    if relu:
        y = torch.relu(y)
    return y, y.sum((0, 2, 3)), (y * y).sum((0, 2, 3)), y.sum((2, 3))


def bwd_tc(x, y, dy, w, s, t, dsum, dsq, dm, relu):
    B, _, H, W = x.shape
    g = dy + dsum[None, :, None, None] + 2 * y * dsq[None, :, None, None] + dm[:, :, None, None]
    if relu:
        g = torch.where(y > 0, g, torch.zeros_like(g))
    wd = w.flip(2, 3).transpose(0, 1)  # [ci][co][kh][kw] = w[co][ci][2 - kh][2 - kw]
    du = tc3(g, wd)
    u = F.pad(x * s[None, :, None, None] + t[None, :, None, None], (1, 1, 1, 1))
    gm = g.transpose(0, 1).reshape(C, -1)
    dw = torch.empty(C, C, 3, 3, dtype=x.dtype)
    for kh in range(3):
        for kw in range(3):
            um = u[:, :, kh:kh + H, kw:kw + W].transpose(0, 1).reshape(C, -1)
            dw[:, :, kh, kw] = tf32x3(lambda p, q: p @ q.T, gm, um)
    return du * s[None, :, None, None], dw, (du * x).sum((0, 2, 3)), du.sum((0, 2, 3))


# W not a multiple of the kernels' 32-column tile; each relu variant once
@pytest.mark.parametrize("B,H,W,relu", [(2, 8, 40, True), (1, 6, 34, False)])
def test_emulated_se_conv_matches_plain_and_jax(B, H, W, relu):
    rng = np.random.default_rng(B * H + W + relu)
    x = rng.normal(size=(B, C, H, W)).astype(np.float32)
    w = (rng.normal(size=(C, C, 3, 3)) / np.sqrt(9 * C)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, C).astype(np.float32)
    t = (rng.normal(size=C) * 0.3).astype(np.float32)
    cts = [rng.normal(size=shape).astype(np.float32) for shape in ((B, C, H, W), (C,), (C,), (B, C))]

    def jax_loss(*args):
        outs = _jax_se_conv(*args, relu)
        return sum(jnp.vdot(o, ct) for o, ct in zip(outs, cts)), outs

    (_, want), want_g = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                                   has_aux=True))(x, w, s, t)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, s, t)]
    plain = se_conv_plain(*leaves, relu)
    torch.autograd.backward(plain, [torch.tensor(ct) for ct in cts])

    xt, wt, st, tt = (torch.tensor(a) for a in (x, w, s, t))
    got = [a.numpy() for a in fwd_tc(xt, wt, st, tt, relu)]
    got_g = [a.numpy() for a in bwd_tc(xt, plain[0].detach(), torch.tensor(cts[0]), wt, st, tt,
                                       *(torch.tensor(ct) for ct in cts[1:]), relu)]
    # against the plain version, then against the JAX kernel
    for ref, ref_g in (([a.detach().numpy() for a in plain], [p.grad.numpy() for p in leaves]),
                       ([np.asarray(a) for a in want], [np.asarray(a) for a in want_g])):
        assert np.abs(got[0] - ref[0]).max() < TOL  # y
        assert np.abs(got_g[0] - ref_g[0]).max() < TOL  # dx
        for a, b in zip(got[1:] + got_g[1:], ref[1:] + ref_g[1:]):  # sum, sq, m, dW, ds, dt
            assert np.abs(a - b).max() <= RED_TOL * max(np.abs(b).max(), 1e-12)


def test_emulated_dgrad_and_wgrad_are_autograds_of_the_conv():
    """Flip, transpose and shifts on their own: with float64 operands (no
    split), the emulated dgrad and wgrad are conv2d's own gradients."""
    rng = np.random.default_rng(5)
    x, g = (torch.tensor(rng.normal(size=(2, C, 7, 37))) for _ in range(2))
    w = torch.tensor(rng.normal(size=(C, C, 3, 3)))
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    torch.autograd.backward(F.conv2d(xl, wl, padding=1), g)
    ones, zeros = torch.ones(C, dtype=torch.float64), torch.zeros(C, dtype=torch.float64)
    dx, dw, _, _ = bwd_tc(x, torch.ones_like(x), g, w, ones, zeros, zeros, zeros,
                          torch.zeros(2, C, dtype=torch.float64), relu=False)
    assert torch.allclose(dx, xl.grad, rtol=0, atol=1e-10)
    assert torch.allclose(dw, wl.grad, rtol=0, atol=1e-9 * wl.grad.abs().max().item())
