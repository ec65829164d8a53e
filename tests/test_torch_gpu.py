"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: on a machine without a CUDA device every test skips (decided
in the `cuda` fixture, so every pytest worker collects the same tests). On
the card: `python -m pytest -m gpu tests/test_torch_gpu.py`. TF32 is off,
so the plain versions run in full float32; the bound is the fused-vs-unfused
tolerance the JAX package holds its own kernels to (5e-4). The bf16 K4 is
held to its plain version's rounding: y and dx within one bf16 step of the
largest value (2^-8 x max), the float32 sums and gradients 1e-3 x max. The
bf16 K1, K2 and K3 (bf16 inference) are within one bf16 step of the largest
output (2^(floor(log2 max) - 7)) of their plain versions (float32 on the
widened inputs, rounded once), and, their bf16 products taking each
activation as two bf16 terms, leave at most 1 % of the outputs off the plain
version's rounding (and at most 3 of a result of fewer than 300 values).
Flash attention (K5) in float32 is within 5e-4 of its plain version forward
(its lse within 1e-5 x the largest of the float64 log-sum-exp, in every
layout the forward picks) and within 1e-4 x each gradient's largest value
backward (3xTF32 products);
in bf16 its output is within one bf16 step of the plain output's largest
value and its gradients within two (P and dS rounded to bf16 before their
products, in the online softmax's order, against the plain version's
normalized P and float32 dS).
"""

import numpy as np
import pytest
import torch

from zerovox_tpu_torch.device import use_full_f32
from zerovox_tpu_torch.ops.mrf import fused_mrf, mrf_plain, pack_towers, widen
from zerovox_tpu_torch.ops.resblock import fused_resblock1, resblock1_plain
from zerovox_tpu_torch.ops.upsample_stage import (KERNEL_WIDTHS, fused_upsample_stage,
                                                   pack_upsampler, upsample_stage_plain)

pytestmark = pytest.mark.gpu

KS = (3, 7, 11)
DILS = (1, 3, 5)
TOL = 5e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    use_full_f32()
    return torch.device("cuda")


def _w(rng, *shape, fan_in):
    return torch.tensor((rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32))


def _towers(rng, C, ks=KS, dils=DILS):
    P = len(dils)
    return [(_w(rng, P, k, C, C, fan_in=k * C), _w(rng, P, C, fan_in=4),
             _w(rng, P, k, C, C, fan_in=k * C), _w(rng, P, C, fan_in=4)) for k in ks]


def _to(dev, towers):
    return [tuple(t.to(dev) for t in tw) for tw in towers]


def _stage_inputs(rng, dev, B, T_in, C_in, C_out, post):
    x = torch.tensor(rng.normal(size=(B, T_in, C_in)).astype(np.float32)).to(dev)
    up = pack_upsampler(_w(rng, 4, C_in, C_out, fan_in=2 * C_in).to(dev),
                        _w(rng, C_out, fan_in=4).to(dev), 2)
    towers = _to(dev, _towers(rng, C_out))
    p = (_w(rng, 7, C_out, 1, fan_in=7 * C_out).to(dev), _w(rng, 1, fan_in=4).to(dev)) if post else None
    return x, up, towers, p


# T below the 60-row halo and below one tile, off the tile grid, and the
# streaming window's stage-1 length (96 + 2 x 38 frames x 64); C = 16 and 8
# are the narrow widths (HiFi-GAN V2's last stages)
@pytest.mark.parametrize("C,T", [(128, 5), (128, 37), (128, 101), (128, 1000), (128, 11008),
                                 (64, 333), (64, 2049), (32, 77), (32, 5000), (16, 41),
                                 (16, 9000), (8, 7), (8, 20000)])
@pytest.mark.parametrize("B", [1, 2])
def test_mrf_kernel_matches_plain(cuda, C, T, B):
    rng = np.random.default_rng(C + T + B)
    x = torch.tensor(rng.normal(size=(B, T, C)).astype(np.float32)).to(cuda)
    towers = _to(cuda, _towers(rng, C))
    n0 = fused_mrf.launches
    got = fused_mrf(x, pack_towers(towers), DILS, KS)
    torch.cuda.synchronize()
    assert fused_mrf.launches == n0 + 1
    ref = mrf_plain(x, towers, DILS)
    assert got.shape == ref.shape
    assert torch.max(torch.abs(got - ref)).item() < TOL


def test_mrf_kernel_batch(cuda):
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(3, 150, 64)).astype(np.float32)).to(cuda)
    towers = _to(cuda, _towers(rng, 64, ks=(3, 5), dils=(1, 2)))
    got = fused_mrf(x, pack_towers(towers), (1, 2), (3, 5))
    ref = mrf_plain(x, towers, (1, 2))
    assert torch.max(torch.abs(got - ref)).item() < TOL


@pytest.mark.parametrize("widths", KERNEL_WIDTHS)
@pytest.mark.parametrize("T_in", [3, 29, 80, 101, 700])
@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("B", [1, 2])
def test_upsample_stage_kernel_matches_plain(cuda, widths, T_in, post, B):
    C_in, C_out = widths
    rng = np.random.default_rng(C_in + T_in + post + 10 * B)
    x, up, towers, p = _stage_inputs(rng, cuda, B, T_in, C_in, C_out, post)
    n0 = fused_upsample_stage.launches
    got = fused_upsample_stage(x, up, 1, pack_towers(towers), DILS, KS, post=p)
    torch.cuda.synchronize()
    assert fused_upsample_stage.launches == n0 + 1
    ref = upsample_stage_plain(x, up.w, up.b, 2, 1, towers, DILS, post=p)
    assert got.shape == ref.shape == ((B, 2 * T_in) if post else (B, 2 * T_in, C_out))
    assert torch.max(torch.abs(got - ref)).item() < TOL


@pytest.mark.parametrize("T_in,C_in,C_out,post", [(11008, 128, 64, False), (22016, 64, 32, True)])
def test_upsample_stage_kernel_at_the_streaming_window(cuda, T_in, C_in, C_out, post):
    """Stages 2 and 3 of one streamed window (172 mel frames)."""
    x, up, towers, p = _stage_inputs(np.random.default_rng(T_in), cuda, 1, T_in, C_in, C_out, post)
    got = fused_upsample_stage(x, up, 1, pack_towers(towers), DILS, KS, post=p)
    ref = upsample_stage_plain(x, up.w, up.b, 2, 1, towers, DILS, post=p)
    assert torch.max(torch.abs(got - ref)).item() < TOL


def test_kernels_are_bitwise_repeatable(cuda):
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.normal(size=(2, 3000, 128)).astype(np.float32)).to(cuda)
    mrf = pack_towers(_to(cuda, _towers(rng, 128)))
    assert torch.equal(fused_mrf(x, mrf, DILS, KS), fused_mrf(x, mrf, DILS, KS))
    for C_in, C_out, post in ((128, 64, False), (64, 32, True)):
        xs, up, towers, p = _stage_inputs(rng, cuda, 2, 1500, C_in, C_out, post)
        tw = pack_towers(towers)
        a = fused_upsample_stage(xs, up, 1, tw, DILS, KS, post=p)
        b = fused_upsample_stage(xs, up, 1, tw, DILS, KS, post=p)
        assert torch.equal(a, b)


def test_kernel_tiles(cuda):
    """The tiles the kernels take: a window that fits shared memory, and
    no more than the sequence."""
    from zerovox_tpu_torch.ops import _cuda

    tower = [3, 3, 7, 11, 3, 1, 3, 5]
    for B, T, C in ((1, 5, 128), (1, 44096, 128), (1, 11008, 128), (4, 44096, 128), (1, 500, 32)):
        tt = _cuda.lib("mrf").zv_mrf_tile(B, T, C, *tower)
        assert 16 <= tt <= max(T, 16) + 3 and tt % 4 == 0
    for B, T_in, ci, co, post_k in ((1, 44096, 128, 64, 0), (1, 88192, 64, 32, 7), (2, 7, 32, 16, 7)):
        tt = _cuda.lib("upsample_stage").zv_upsample_stage_tile(B, T_in, ci, co, 4, 2, 1, post_k,
                                                                *tower)
        assert 16 <= tt <= max(2 * T_in, 16) + 3 and tt % 4 == 0
    assert _cuda.lib("mrf").zv_mrf_tile(1, 100, 48, *tower) < 0


def test_kernels_reject_what_they_do_not_take(cuda):
    rng = np.random.default_rng(0)
    towers = _to(cuda, _towers(rng, 64))
    mrf = pack_towers(towers)
    x = torch.zeros(1, 50, 64, device=cuda)
    with pytest.raises(TypeError):
        fused_mrf(x.double(), mrf, DILS, KS)
    with pytest.raises(ValueError):
        fused_mrf(torch.zeros(1, 64, 50, device=cuda).transpose(1, 2), mrf, DILS, KS)
    with pytest.raises(ValueError):
        fused_mrf(torch.zeros(1, 50, 48, device=cuda), mrf, DILS, KS)
    with pytest.raises(ValueError):  # weights on the CPU
        fused_mrf(x, pack_towers([tuple(t.cpu() for t in tw) for tw in towers]), DILS, KS)
    with pytest.raises(ValueError):  # (C_in, C_out) wider than every instantiated pair
        up = pack_upsampler(torch.zeros(4, 64, 128, device=cuda), torch.zeros(128, device=cuda), 2)
        fused_upsample_stage(x, up, 1, pack_towers(_to(cuda, _towers(rng, 128))), DILS, KS)
    with pytest.raises(ValueError):  # C wider than every instantiated width
        fused_mrf(torch.zeros(1, 50, 256, device=cuda), mrf, DILS, KS)


@pytest.mark.parametrize("C", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("T", [5, 23, 176, 1001, 44096])  # below the halo (12) up to stage 1's length
def test_resblock_kernel_matches_plain(cuda, C, B, T):
    rng = np.random.default_rng(C + B + T)
    x = torch.tensor(rng.normal(size=(B, T, C)).astype(np.float32)).to(cuda)
    tower = _to(cuda, _towers(rng, C, ks=(3,)))[0]
    n0 = fused_resblock1.launches
    got = fused_resblock1(x, *tower, DILS)
    torch.cuda.synchronize()
    assert fused_resblock1.launches == n0 + 1
    ref = resblock1_plain(x, *tower, DILS)
    assert got.shape == ref.shape == (B, T, C)
    assert torch.max(torch.abs(got - ref)).item() < TOL


@pytest.mark.parametrize("k,dils", [(5, (1, 3, 5)), (3, (1, 3)), (7, (2,))])
def test_resblock_kernel_other_towers(cuda, k, dils):
    rng = np.random.default_rng(k + len(dils))
    x = torch.tensor(rng.normal(size=(1, 300, 64)).astype(np.float32)).to(cuda)
    tower = _to(cuda, _towers(rng, 64, ks=(k,), dils=dils))[0]
    got = fused_resblock1(x, *tower, dils)
    assert torch.max(torch.abs(got - resblock1_plain(x, *tower, dils))).item() < TOL


def test_resblock_kernel_takes_packed_weights(cuda):
    """The vocoder's path: the tower packed once (`pack_towers([tower])`)
    and handed in gives the bits of the wrapper packing it itself."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 777, 32)).astype(np.float32)).to(cuda)
    tower = _to(cuda, _towers(rng, 32, ks=(3,)))[0]
    got = fused_resblock1(x, *tower, DILS, packed=pack_towers([tower]))
    assert torch.equal(got, fused_resblock1(x, *tower, DILS))


@pytest.mark.parametrize("C", [8, 16, 32, 64, 128])
def test_resblock_kernel_is_bitwise_repeatable(cuda, C):
    rng = np.random.default_rng(C)
    x = torch.tensor(rng.normal(size=(2, 5000, C)).astype(np.float32)).to(cuda)
    tower = _to(cuda, _towers(rng, C, ks=(3,)))[0]
    packed = pack_towers([tower])
    a = fused_resblock1(x, *tower, DILS, packed=packed)
    assert torch.equal(a, fused_resblock1(x, *tower, DILS, packed=packed))


def test_resblock_kernel_tiles(cuda):
    """The tile K3 takes: a multiple of 4 rows of at least 16, no more than
    the sequence needs, and an error for a width it does not take."""
    from zerovox_tpu_torch.ops import _cuda

    tile = _cuda.lib("resblock").zv_resblock1_tile
    for B, T, C in ((1, 44096, 128), (1, 88192, 64), (1, 176384, 32), (8, 44096, 128), (1, 5, 32),
                    (4, 176384, 32), (1, 88192, 16), (1, 176384, 8), (4, 5, 8)):
        for k, dils in ((3, (1, 3, 5)), (5, (1, 3, 5)), (7, (2, 0, 0))):
            tt = tile(B, T, C, k, sum(d > 0 for d in dils), *dils)
            assert 16 <= tt <= max(T, 16) + 3 and tt % 4 == 0, (B, T, C, k, tt)
    assert tile(1, 100, 48, 3, 3, 1, 3, 5) < 0
    assert tile(1, 100, 64, 4, 3, 1, 3, 5) < 0


def test_resblock_kernel_rejects_what_it_does_not_take(cuda):
    rng = np.random.default_rng(1)
    tower = _to(cuda, _towers(rng, 64, ks=(3,)))[0]
    x = torch.zeros(1, 50, 64, device=cuda)
    n0 = fused_resblock1.launches
    with pytest.raises(TypeError):
        fused_resblock1(x.double(), *tower, DILS)
    with pytest.raises(ValueError):  # not contiguous
        fused_resblock1(torch.zeros(1, 64, 50, device=cuda).transpose(1, 2), *tower, DILS)
    with pytest.raises(ValueError):  # x of another width than the tower's weights
        fused_resblock1(torch.zeros(1, 50, 48, device=cuda), *tower, DILS)
    wide = _to(cuda, _towers(rng, 256, ks=(3,)))[0]
    with pytest.raises(ValueError):  # C wider than every instantiated width
        fused_resblock1(torch.zeros(1, 50, 256, device=cuda), *wide, DILS)
    with pytest.raises(ValueError):  # one dilation per pair
        fused_resblock1(x, *tower, (1, 3))
    even = _to(cuda, _towers(rng, 64, ks=(4,)))[0]
    with pytest.raises(ValueError):  # even kernel size
        fused_resblock1(x, *even, DILS)
    four = _to(cuda, _towers(rng, 64, ks=(3,), dils=(1, 2, 3, 4)))[0]
    with pytest.raises(ValueError):  # more than 3 pairs
        fused_resblock1(x, *four, (1, 2, 3, 4))
    with pytest.raises(ValueError):  # weights on another device
        fused_resblock1(x, *[t.cpu() for t in tower], DILS)
    other = _to(cuda, _towers(rng, 32, ks=(3,)))[0]
    with pytest.raises(ValueError):  # packed buffers of a tower of another width
        fused_resblock1(x, *tower, DILS, packed=pack_towers([other]))
    assert fused_resblock1.launches == n0


def test_kernel_tiles_at_the_narrow_widths(cuda):
    """K1 at C = 16 and 8 and K2 at (16, 8) with and without conv_post take
    a tile like the wider widths; the bf16 K3 too."""
    from zerovox_tpu_torch.ops import _cuda

    tower = [3, 3, 7, 11, 3, 1, 3, 5]
    for B, T, C in ((1, 88192, 16), (1, 176384, 8), (4, 9, 8), (2, 44096, 16)):
        tt = _cuda.lib("mrf").zv_mrf_tile(B, T, C, *tower)
        assert 16 <= tt <= max(T, 16) + 3 and tt % 4 == 0, (B, T, C, tt)
    for B, T_in, post_k in ((1, 88192, 7), (1, 88192, 0), (2, 7, 7)):
        tt = _cuda.lib("upsample_stage").zv_upsample_stage_tile(B, T_in, 16, 8, 4, 2, 1, post_k,
                                                                *tower)
        assert 16 <= tt <= max(2 * T_in, 16) + 3 and tt % 4 == 0, (B, T_in, post_k, tt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_padded_widths(cuda, dtype):
    """A width between the instantiated ones runs zero-padded to the next:
    K1 at C = 24 and 48, K3 at 24 and 12, K2 at (24, 12) with and without
    conv_post and at (8, 4) with it, each against its plain version (5e-4
    in float32, one bf16 step in bf16, and the bf16 K1 and K2's share off
    plain's rounding), the output cut back to C."""
    rng = np.random.default_rng(24)
    bf = dtype == torch.bfloat16

    def close(got, ref, k3=False):
        assert got.shape == ref.shape and got.dtype == ref.dtype and got.is_contiguous()
        bound = bf16_step(ref.float()) if bf else TOL
        assert torch.max(torch.abs(got.float() - ref.float())).item() <= bound
        if bf and not k3:
            _check_bf16x2(got, ref)

    for C in (24, 48):
        x = torch.tensor(rng.normal(size=(1, 1111, C)).astype(np.float32)).to(cuda).to(dtype)
        towers = [tuple(t.to(dtype) for t in tw) for tw in _to(cuda, _towers(rng, C))]
        n0 = fused_mrf.launches_at.get(32 if C == 24 else 64, 0)
        close(fused_mrf(x, pack_towers(towers), DILS, KS), mrf_plain(x, towers, DILS))
        assert fused_mrf.launches_at[32 if C == 24 else 64] == n0 + 1
    for C in (24, 12):
        x = torch.tensor(rng.normal(size=(2, 999, C)).astype(np.float32)).to(cuda).to(dtype)
        tower = tuple(t.to(dtype) for t in _to(cuda, _towers(rng, C, ks=(3,)))[0])
        close(fused_resblock1(x, *tower, DILS), resblock1_plain(x, *tower, DILS), k3=True)
    for C_in, C_out, post in ((24, 12, False), (24, 12, True), (8, 4, True)):
        x, up, towers, p = _stage_inputs(rng, cuda, 1, 333, C_in, C_out, post)
        x, towers = x.to(dtype), [tuple(t.to(dtype) for t in tw) for tw in towers]
        up = pack_upsampler(up.w.to(dtype), up.b.to(dtype), 2)
        p = tuple(t.to(dtype) for t in p) if post else None
        close(fused_upsample_stage(x, up, 1, pack_towers(towers), DILS, KS, post=p),
              upsample_stage_plain(x, up.w, up.b, 2, 1, towers, DILS, post=p))


def test_narrow_vocoders_on_card_match_cpu(cuda):
    """HiFi-GAN V2's widths (128 initial channels, rates 8,8,2,2: K1 at 64
    and 32, K2 at (32, 16) and (16, 8) with conv_post) and a 256-channel
    single-tower vocoder (K3 at 128, 64, 32 and 16) run every stage on its
    kernel, within 1e-3 of the same weights' nn.Modules on the CPU."""
    from zerovox_tpu_torch.models.hifigan import Generator, HifiGanConfig

    v2 = HifiGanConfig(upsample_initial_channel=128, upsample_kernel_sizes=(16, 16, 4, 4))
    single = HifiGanConfig(upsample_initial_channel=256, resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 3, 5),))
    mel = torch.tensor(np.random.default_rng(9).normal(size=(1, 40, 80)).astype(np.float32))
    for cfg, want in ((v2, {"mrf": {64: 1, 32: 1}, "up": {(32, 16): 1, (16, 8): 1}}),
                      (single, {"res": {128: 1, 64: 1, 32: 1, 16: 1}})):
        torch.manual_seed(0)
        plain = Generator(cfg).eval()
        gen = Generator(cfg, use_pallas=True).to(cuda).eval()
        gen.load_state_dict(plain.state_dict())
        before = [dict(f.launches_at) for f in (fused_mrf, fused_upsample_stage, fused_resblock1)]
        with torch.inference_mode():
            got = gen(mel.to(cuda)).cpu()
            ref = plain(mel)
        after = [f.launches_at for f in (fused_mrf, fused_upsample_stage, fused_resblock1)]
        ran = {name: {w: n - b.get(w, 0) for w, n in a.items() if n != b.get(w, 0)}
               for name, b, a in zip(("mrf", "up", "res"), before, after)}
        assert {k: v for k, v in ran.items() if v} == want
        assert got.shape == ref.shape == (1, 40 * 256)
        assert torch.max(torch.abs(got - ref)).item() < 1e-3


def test_kernel_routes_refuse_autograd_on_the_card(cuda):
    """Generator(use_pallas=True) under grad raises on the card, as each
    wrapper does for a CUDA tensor that requires grad; no kernel launches."""
    from zerovox_tpu_torch.models.hifigan import Generator, HifiGanConfig

    n0 = (fused_mrf.launches, fused_upsample_stage.launches, fused_resblock1.launches)
    mel = torch.zeros(1, 8, 80, device=cuda)
    for cfg in (HifiGanConfig(upsample_initial_channel=256),
                HifiGanConfig(upsample_initial_channel=256, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3, 5),))):
        gen = Generator(cfg, use_pallas=True).to(cuda)
        with pytest.raises(RuntimeError, match="no backward"):
            gen(mel)
    rng = np.random.default_rng(4)
    tower = _to(cuda, _towers(rng, 64, ks=(3,)))[0]
    x = torch.zeros(1, 50, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_resblock1(x, *tower, DILS)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mrf(x, pack_towers([tower]), DILS, (3,))
    assert (fused_mrf.launches, fused_upsample_stage.launches, fused_resblock1.launches) == n0


def test_streamer_pinned_copy_is_the_window(cuda):
    """On the card a dispatched window's chunk arrives through a pinned
    host copy: the samples `.cpu()` of the vocoder's output gives."""
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig, MelDec
    from zerovox_tpu_torch.streaming import ChunkStreamer

    cfg = HifiGanConfig(upsample_initial_channel=256)
    md = MelDec(cfg, use_pallas=True).to(cuda).eval()
    mel = torch.tensor(np.random.default_rng(5).normal(size=(1, 60, 80)).astype(np.float32)).to(cuda)
    st = ChunkStreamer(md, cfg, mel, chunk_frames=16)
    up = cfg.total_upsample
    for pos in (0, 16):
        w = st.dispatch(pos)
        assert w.samples.device.type == "cpu" and w.samples.is_pinned() and w.ready is not None
        got = ChunkStreamer.trim(w, 16, up)
        start = st.halo if pos == 0 else pos
        with torch.inference_mode():
            full = md(st._mel_padded[:, start:start + st.window])
        s0 = 0 if pos == 0 else st.halo * up
        assert got.shape == (16 * up,)
        assert np.max(np.abs(got - full[0, s0:s0 + 16 * up].cpu().numpy())) <= 1e-6


def _se_inputs(rng, B, H, W, dev):
    def t(*shape, scale=1.0):
        return torch.tensor((rng.normal(size=shape) * scale).astype(np.float32), device=dev)

    x = t(B, 32, H, W)
    w = t(32, 32, 3, 3, scale=1 / np.sqrt(288))
    s = torch.tensor(rng.uniform(0.5, 1.5, 32).astype(np.float32), device=dev)
    return x, w, s, t(32, scale=0.3)


def _close_rel(got, ref, tol):
    """max |got - ref| within tol x max |ref| (a reduction's bound)."""
    return torch.max(torch.abs(got - ref)).item() <= tol * max(torch.max(torch.abs(ref)).item(), 1e-12)


# off the tile grid, below one tile (H = 1, W = 1-3), and the training shape at B = 1
SE_SHAPES = [(2, 20, 64), (3, 13, 45), (2, 1, 37), (1, 9, 1), (3, 6, 2), (1, 1, 3)]


@pytest.mark.parametrize("B,H,W", SE_SHAPES + [(1, 80, 500)])
@pytest.mark.parametrize("relu", [True, False])
def test_se_conv_forward_matches_plain(cuda, B, H, W, relu):
    from zerovox_tpu_torch.ops.se_conv import se_conv, se_conv_fwd, se_conv_plain

    x, w, s, t = _se_inputs(np.random.default_rng(B * H + W + relu), B, H, W, cuda)
    n0 = se_conv_fwd.launches
    got = se_conv(x, w, s, t, relu)
    torch.cuda.synchronize()
    assert se_conv_fwd.launches == n0 + 1
    ref = se_conv_plain(x, w, s, t, relu)
    assert torch.max(torch.abs(got[0] - ref[0])).item() < TOL
    for a, b in zip(got[1:], ref[1:]):
        assert a.shape == b.shape and _close_rel(a, b, 1e-4)


def _se_grads(fn, x, w, s, t, cts, relu):
    leaves = [a.clone().requires_grad_(True) for a in (x, w, s, t)]
    outs = fn(*leaves, relu)
    torch.autograd.backward(outs, cts)
    return [a.grad for a in leaves]


def _se_cts(rng, B, H, W, dev):
    return [torch.tensor(rng.normal(size=shape).astype(np.float32), device=dev)
            for shape in ((B, 32, H, W), (32,), (32,), (B, 32))]


# B = 8 at the training shape: wgrad sums 320k positions, ~2.4k per block
@pytest.mark.parametrize("B,H,W", SE_SHAPES + [(2, 80, 250), (8, 80, 500)])
@pytest.mark.parametrize("relu", [True, False])
def test_se_conv_backward_matches_plain(cuda, B, H, W, relu):
    """The backward kernel given the plain version's y (one y for both, so
    relu' agrees where y is within rounding of 0) against autograd's
    gradients of the plain version."""
    from zerovox_tpu_torch.ops.se_conv import se_conv_bwd, se_conv_plain

    rng = np.random.default_rng(7 * B + H + W + relu)
    x, w, s, t = _se_inputs(rng, B, H, W, cuda)
    cts = _se_cts(rng, B, H, W, cuda)
    leaves = [a.clone().requires_grad_(True) for a in (x, w, s, t)]
    outs = se_conv_plain(*leaves, relu)
    ref = torch.autograd.grad(outs, leaves, cts)
    n0 = se_conv_bwd.launches
    got = se_conv_bwd(x, outs[0].detach(), cts[0], w, s, t, *cts[1:], relu)
    torch.cuda.synchronize()
    assert se_conv_bwd.launches == n0 + 1
    assert torch.max(torch.abs(got[0] - ref[0])).item() < TOL  # dx
    for a, b in zip(got[1:], ref[1:]):  # dw, ds, dt: reductions over every position
        assert a.shape == b.shape and _close_rel(a, b, 1e-4)


def test_se_conv_autograd_runs_both_kernels(cuda):
    """`se_conv` on CUDA tensors: the forward and the backward kernel, one
    launch each, gradients as the plain version's (no relu, so no mask can
    differ between the two forwards)."""
    from zerovox_tpu_torch.ops.se_conv import se_conv, se_conv_bwd, se_conv_fwd, se_conv_plain

    rng = np.random.default_rng(3)
    x, w, s, t = _se_inputs(rng, 2, 20, 64, cuda)
    cts = _se_cts(rng, 2, 20, 64, cuda)
    n0 = (se_conv_fwd.launches, se_conv_bwd.launches)
    got = _se_grads(se_conv, x, w, s, t, cts, False)
    torch.cuda.synchronize()
    assert (se_conv_fwd.launches, se_conv_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    ref = _se_grads(se_conv_plain, x, w, s, t, cts, False)
    assert torch.max(torch.abs(got[0] - ref[0])).item() < TOL
    for a, b in zip(got[1:], ref[1:]):
        assert _close_rel(a, b, 1e-4)


@pytest.mark.parametrize("relu", [True, False])
def test_se_conv_is_bitwise_repeatable(cuda, relu):
    """y, the sums, dx, dW, ds and dt: fixed-order sums, no atomics."""
    from zerovox_tpu_torch.ops.se_conv import se_conv

    rng = np.random.default_rng(13 + relu)
    x, w, s, t = _se_inputs(rng, 4, 80, 500, cuda)
    cts = _se_cts(rng, 4, 80, 500, cuda)
    for a, b in zip(se_conv(x, w, s, t, relu), se_conv(x, w, s, t, relu)):
        assert torch.equal(a, b)
    for a, b in zip(_se_grads(se_conv, x, w, s, t, cts, relu),
                    _se_grads(se_conv, x, w, s, t, cts, relu)):
        assert torch.equal(a, b)


def test_se_conv_rejects_what_it_does_not_take(cuda):
    from zerovox_tpu_torch.ops.se_conv import se_conv

    x, w, s, t = _se_inputs(np.random.default_rng(0), 1, 8, 8, cuda)
    with pytest.raises(TypeError):
        se_conv(x.double(), w, s, t, True)
    with pytest.raises(ValueError):
        se_conv(x[:, :16].contiguous(), w, s, t, True)


BF16_ULP = 2.0 ** -8  # one bf16 step at the top of [1, 2): y and dx against max |plain|
BF16_RED_TOL = 1e-3  # the float32 sums and gradients, relative to max |plain|


# every residue of W mod 8 with W > 32 (where a row starts in its 16-byte
# chunk, which the bf16 kernels' window copies follow), H off the tile grid
SE_W_RESIDUES = [(2, 11, 40), (1, 13, 33), (2, 5, 34), (1, 9, 67), (2, 7, 68), (1, 12, 69),
                 (1, 11, 502), (2, 3, 503)]


def _bf16_inputs(rng, B, H, W, dev):
    x, w, s, t = _se_inputs(rng, B, H, W, dev)
    return x.bfloat16(), w.bfloat16(), s, t


@pytest.mark.parametrize("B,H,W", SE_SHAPES + [(24, 80, 500)] + SE_W_RESIDUES)
@pytest.mark.parametrize("relu", [True, False])
def test_se_conv_bf16_forward_matches_plain(cuda, B, H, W, relu):
    from zerovox_tpu_torch.ops.se_conv import se_conv_fwd, se_conv_fwd_bf16, se_conv_plain

    x, w, s, t = _bf16_inputs(np.random.default_rng(B * H + W + relu), B, H, W, cuda)
    n0, n32 = se_conv_fwd_bf16.launches, se_conv_fwd.launches
    got = se_conv_fwd_bf16(x, w, s, t, relu)
    torch.cuda.synchronize()
    assert (se_conv_fwd_bf16.launches, se_conv_fwd.launches) == (n0 + 1, n32)
    ref = se_conv_plain(x, w, s, t, relu)
    assert got[0].dtype == torch.bfloat16 and all(a.dtype == torch.float32 for a in got[1:])
    assert _close_rel(got[0].float(), ref[0].float(), BF16_ULP)
    for a, b in zip(got[1:], ref[1:]):
        assert a.shape == b.shape and _close_rel(a, b, BF16_RED_TOL)


@pytest.mark.parametrize("B,H,W", SE_SHAPES + [(24, 80, 500)] + SE_W_RESIDUES)
@pytest.mark.parametrize("relu", [True, False])
def test_se_conv_bf16_backward_matches_plain(cuda, B, H, W, relu):
    """The bf16 backward kernel against se_conv_bwd_plain on the plain
    version's bf16 y (one y for both, so relu' agrees)."""
    from zerovox_tpu_torch.ops.se_conv import se_conv_bwd_bf16, se_conv_bwd_plain, se_conv_plain

    rng = np.random.default_rng(7 * B + H + W + relu)
    x, w, s, t = _bf16_inputs(rng, B, H, W, cuda)
    cts = _se_cts(rng, B, H, W, cuda)
    y = se_conv_plain(x, w, s, t, relu)[0]
    args = (x, y, cts[0].bfloat16(), w, s, t, *cts[1:], relu)
    n0 = se_conv_bwd_bf16.launches
    got = se_conv_bwd_bf16(*args)
    torch.cuda.synchronize()
    assert se_conv_bwd_bf16.launches == n0 + 1
    ref = se_conv_bwd_plain(*args)
    assert got[0].dtype == torch.bfloat16 and _close_rel(got[0].float(), ref[0].float(), BF16_ULP)
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == torch.float32 and a.shape == b.shape and _close_rel(a, b, BF16_RED_TOL)


def _offset_view(a, how):
    """a's values in a contiguous view whose base is not where an allocation
    starts: the second sample of a [B + 1, ...] tensor, or a flat storage
    one element in (a base only 2-byte aligned)."""
    if how == "batch":
        v = torch.empty((a.shape[0] + 1, *a.shape[1:]), dtype=a.dtype, device=a.device)[1:]
    else:
        v = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)[1:].view(a.shape)
    v.copy_(a)
    assert v.is_contiguous() and v.storage_offset() > 0
    return v


@pytest.mark.parametrize("how", ["batch", "element"])
def test_se_conv_bf16_takes_offset_views(cuda, how):
    """x (and y, dy) as views with a storage offset, x[1:] of a [3, 32, 7,
    45] tensor among them: the kernels give what they give on fresh
    tensors, which match plain."""
    from zerovox_tpu_torch.ops.se_conv import (se_conv_bwd_bf16, se_conv_bwd_plain,
                                               se_conv_fwd_bf16, se_conv_plain)

    rng = np.random.default_rng(23)
    x, w, s, t = _bf16_inputs(rng, 2, 7, 45, cuda)
    cts = _se_cts(rng, 2, 7, 45, cuda)
    xv = _offset_view(x, how)
    if how == "element":
        assert xv.data_ptr() % 16 == 2
    got = se_conv_fwd_bf16(xv, w, s, t, True)
    fresh = se_conv_fwd_bf16(x, w, s, t, True)
    assert all(torch.equal(a, b) for a, b in zip(got, fresh))
    ref = se_conv_plain(x, w, s, t, True)
    assert _close_rel(got[0].float(), ref[0].float(), BF16_ULP)
    args = (x, ref[0], cts[0].bfloat16(), w, s, t, *cts[1:], True)
    views = (xv, _offset_view(ref[0], how), _offset_view(args[2], how), *args[3:])
    got_b = se_conv_bwd_bf16(*views)
    assert all(torch.equal(a, b) for a, b in zip(got_b, se_conv_bwd_bf16(*args)))
    for a, b in zip(got_b, se_conv_bwd_plain(*args)):
        assert _close_rel(a.float(), b.float(), BF16_ULP if a.dtype == torch.bfloat16 else BF16_RED_TOL)


def test_se_conv_bf16_autograd_runs_both_bf16_kernels(cuda):
    """`se_conv` on bf16 CUDA tensors: one bf16 forward and one bf16
    backward launch, no float32 launch; dw comes back in w's dtype."""
    from zerovox_tpu_torch.ops import se_conv as m

    rng = np.random.default_rng(5)
    x, w, s, t = _bf16_inputs(rng, 2, 20, 64, cuda)
    cts = _se_cts(rng, 2, 20, 64, cuda)
    cts[0] = cts[0].bfloat16()
    before = (m.se_conv_fwd_bf16.launches, m.se_conv_bwd_bf16.launches,
              m.se_conv_fwd.launches, m.se_conv_bwd.launches)
    grads = _se_grads(m.se_conv, x, w, s, t, cts, True)
    torch.cuda.synchronize()
    after = (m.se_conv_fwd_bf16.launches, m.se_conv_bwd_bf16.launches,
             m.se_conv_fwd.launches, m.se_conv_bwd.launches)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 0, 0]
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                        torch.float32]


@pytest.mark.parametrize("relu", [True, False])
def test_se_conv_bf16_is_bitwise_repeatable(cuda, relu):
    from zerovox_tpu_torch.ops.se_conv import se_conv_bwd_bf16, se_conv_fwd_bf16

    rng = np.random.default_rng(17 + relu)
    x, w, s, t = _bf16_inputs(rng, 4, 80, 500, cuda)
    cts = _se_cts(rng, 4, 80, 500, cuda)
    a, b = se_conv_fwd_bf16(x, w, s, t, relu), se_conv_fwd_bf16(x, w, s, t, relu)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    args = (x, a[0], cts[0].bfloat16(), w, s, t, *cts[1:], relu)
    assert all(torch.equal(p, q) for p, q in zip(se_conv_bwd_bf16(*args), se_conv_bwd_bf16(*args)))


def test_se_conv_bf16_rejects_mixed_types(cuda):
    from zerovox_tpu_torch.ops.se_conv import se_conv_bwd_bf16, se_conv_fwd_bf16

    x, w, s, t = _bf16_inputs(np.random.default_rng(0), 1, 8, 8, cuda)
    with pytest.raises(TypeError):
        se_conv_fwd_bf16(x, w.float(), s, t, True)
    with pytest.raises(TypeError):
        se_conv_fwd_bf16(x, w, s.bfloat16(), t, True)
    with pytest.raises(TypeError):
        se_conv_bwd_bf16(x, x.float(), x, w, s, t, s, s, s[None].expand(1, 32).contiguous(), True)


def k4_f32_digest(dev) -> str:
    """sha256 of K4's float32 forward and backward outputs on seeded inputs
    at [2, 32, 80, 500], both relu settings."""
    import hashlib

    from zerovox_tpu_torch.ops.se_conv import se_conv_bwd, se_conv_fwd

    h = hashlib.sha256()
    for relu in (True, False):
        rng = np.random.default_rng(101 + relu)
        x, w, s, t = _se_inputs(rng, 2, 80, 500, dev)
        cts = _se_cts(rng, 2, 80, 500, dev)
        fwd = se_conv_fwd(x, w, s, t, relu)
        for out in (*fwd, *se_conv_bwd(x, fwd[0], cts[0], w, s, t, *cts[1:], relu)):
            h.update(out.cpu().numpy().tobytes())
    return h.hexdigest()


# k4_f32_digest on an H100 (sm_90a) from the float32 kernels as they were
# before the bf16 kernels joined their source
K4_F32_DIGEST = "cd0c61fb7081a5ddbe95edc4df2ecd9b4e1ec11af4aa4df0a1c3d30ebf2d33bc"


def test_se_conv_f32_bits_unchanged(cuda):
    assert k4_f32_digest(cuda) == K4_F32_DIGEST


def test_engine_on_card_matches_cpu(cuda):
    """A small engine whose every vocoder stage takes a kernel (widths
    128/64 via K1, 64->32 and 32->16 via K2): the card's waveform equals
    the CPU plain run within the waveform tolerance (1e-3), and the
    streamed chunks concatenate to the full render."""
    from zerovox_tpu_torch.config import (DecoderConfig, EncoderConfig, ModelConfig,
                                          ResNetConfig, ZeroVoxConfig)
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    cfg = ZeroVoxConfig(model=ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=16,
        encoder=EncoderConfig(fs2_layer=1, vp_filter_size=16, ve_n_bins=16),
        decoder=DecoderConfig(n_layers=1, conv_filter_size=64),
        resnet=ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 16, 16, 16))))
    gpu = ZeroVoxTTS.from_random(cfg, HifiGanConfig(upsample_initial_channel=256), seed=3)
    cpu = ZeroVoxTTS(cfg, *_sd_pair(gpu), device="cpu")
    wav = np.random.default_rng(1).normal(size=22050).astype(np.float32) * 0.1
    spk = gpu.speaker_embed(wav)
    text = "Hello there, general test."
    dur = np.full(len(gpu.text2phonemeids(text)[0]), 4, np.int32)
    k1, k2 = fused_mrf.launches, fused_upsample_stage.launches
    w_gpu, _, n = gpu.tts(text, spk, duration=dur)
    assert fused_mrf.launches - k1 == 2 and fused_upsample_stage.launches - k2 == 2
    w_cpu, _, n_cpu = cpu.tts(text, spk.cpu(), duration=dur)
    assert n == n_cpu == 4 * len(dur)
    assert np.max(np.abs(w_gpu - w_cpu)) < 1e-3
    streamed = np.concatenate(list(gpu.tts_stream(text, spk, duration=dur, chunk_frames=24)))
    assert streamed.shape == w_gpu.shape
    assert np.max(np.abs(streamed - w_gpu)) < 1e-4


def test_styletts_single_tower_engine_on_card_matches_cpu(cuda):
    """The StyleTTS decoder with a single-tower vocoder whose stages are
    128, 64 and 32 channels wide: one K3 launch per stage at batch 1 (3 per
    `tts`), the card's waveform within 1e-3 of the CPU plain run, streamed
    chunks equal to the full render; `tts_batch` at batch 2 takes K3 as the
    engine's VOCODER_ALL_BATCHES says (3 launches, or none) and matches the
    CPU too."""
    from zerovox_tpu_torch.config import (DecoderConfig, EncoderConfig, ModelConfig,
                                          ResNetConfig, ZeroVoxConfig)
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.synthesize import VOCODER_ALL_BATCHES, ZeroVoxTTS

    cfg = ZeroVoxConfig(model=ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=16,
        encoder=EncoderConfig(fs2_layer=1, vp_filter_size=16, ve_n_bins=16),
        decoder=DecoderConfig(kind="styletts"),
        resnet=ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 16, 16, 16))))
    hcfg = HifiGanConfig(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                         upsample_initial_channel=256, resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3, 5),))
    gpu = ZeroVoxTTS.from_random(cfg, hcfg, seed=5)
    cpu = ZeroVoxTTS(cfg, *_sd_pair(gpu), device="cpu")
    wav = np.random.default_rng(2).normal(size=22050).astype(np.float32) * 0.1
    spk = gpu.speaker_embed(wav)
    text = "Hello there, general test."
    dur = np.full(len(gpu.text2phonemeids(text)[0]), 4, np.int32)
    n0 = fused_resblock1.launches
    w_gpu, _, n = gpu.tts(text, spk, duration=dur)
    assert fused_resblock1.launches - n0 == 3
    w_cpu, _, n_cpu = cpu.tts(text, spk.cpu(), duration=dur)
    assert n == n_cpu == 4 * len(dur)
    assert np.max(np.abs(w_gpu - w_cpu)) < 1e-3
    streamed = np.concatenate(list(gpu.tts_stream(text, spk, duration=dur, chunk_frames=24)))
    assert streamed.shape == w_gpu.shape
    assert np.max(np.abs(streamed - w_gpu)) < 1e-4
    texts = [text, "A second, longer utterance in the batch."]
    spks = torch.cat([spk, gpu.speaker_embed(wav * 0.5)])
    durs = [np.full(len(gpu.text2phonemeids(t)[0]), 3, np.int32) for t in texts]
    n0 = fused_resblock1.launches
    rows = gpu.tts_batch(texts, spks, durations=durs)
    assert fused_resblock1.launches - n0 == (3 if VOCODER_ALL_BATCHES else 0)
    for (w_g, n_g), (w_c, n_c) in zip(rows, cpu.tts_batch(texts, spks.cpu(), durations=durs)):
        assert n_g == n_c and w_g.shape == w_c.shape
        assert np.max(np.abs(w_g - w_c)) < 1e-3


# ------------------------------------------------------- bf16 K1, K2, K3

def bf16_step(t) -> float:
    """One bf16 step at the largest magnitude of t."""
    m = t.abs().max().item()
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _bf(towers):
    return [tuple(t.bfloat16() for t in tw) for tw in towers]


BF16X2_SHARE = 0.01  # bf16 K1-K3: outputs off plain's rounding (chip_smoke.py's bound)


def _check_bf16x2(got, ref):
    """got: the bf16 K1, K2 or K3; ref: the bf16 plain version. Within one
    bf16 step, and at most 1 % of the outputs off plain's rounding (3 of a
    small result, where one output is a third of a percent)."""
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert torch.max(torch.abs(got.float() - ref.float())).item() <= bf16_step(ref.float())
    off = (got != ref).sum().item()
    assert off <= max(BF16X2_SHARE * ref.numel(), 3), (off, ref.numel())


@pytest.mark.parametrize("C,T", [(128, 37), (128, 11008), (64, 2049), (32, 5000), (16, 9000),
                                 (8, 20000)])
@pytest.mark.parametrize("B", [1, 2])
def test_mrf_bf16_kernel_is_the_f32_kernel_rounded(cuda, C, T, B):
    """The bf16 K1 against its plain version (_check_bf16x2), launching
    the bf16 kernel alone."""
    rng = np.random.default_rng(C + T + B + 1)
    x = torch.tensor(rng.normal(size=(B, T, C)).astype(np.float32)).to(cuda).bfloat16()
    towers = _bf(_to(cuda, _towers(rng, C)))
    n0, f0 = fused_mrf.launches_bf16, fused_mrf.launches
    got = fused_mrf(x, pack_towers(towers), DILS, KS)
    torch.cuda.synchronize()
    assert (fused_mrf.launches_bf16, fused_mrf.launches) == (n0 + 1, f0)
    _check_bf16x2(got, mrf_plain(x, towers, DILS))


def test_mrf_bf16_kernel_one_tower(cuda):
    """One tower: no float32 sums are kept (the scratch is not passed)."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(1, 300, 64)).astype(np.float32)).to(cuda).bfloat16()
    towers = _bf(_to(cuda, _towers(rng, 64, ks=(5,))))
    got = fused_mrf(x, pack_towers(towers), DILS, (5,))
    _check_bf16x2(got, mrf_plain(x, towers, DILS))


def test_mrf_bf16_kernel_is_not_one_bf16_term(cuda):
    """The share bound tells two terms from one: the plain version on the
    input rounded to bf16 at every conv (one term) leaves more than 10 %
    of the outputs off plain's rounding, where the kernel leaves < 1 %."""
    import torch.nn.functional as F

    from zerovox_tpu_torch.ops.mrf import LRELU_SLOPE

    rng = np.random.default_rng(12)
    x = torch.tensor(rng.normal(size=(1, 4000, 128)).astype(np.float32)).to(cuda).bfloat16()
    towers = _bf(_to(cuda, _towers(rng, 128)))
    ref = mrf_plain(x, towers, DILS)
    _check_bf16x2(fused_mrf(x, pack_towers(towers), DILS, KS), ref)

    def conv(a, w, b, d):  # one bf16 term of the activation, float32 products
        k = w.shape[0]
        return F.conv1d(a.bfloat16().float(), w.float().permute(2, 1, 0), b.float(),
                        padding=(k - 1) // 2 * d, dilation=d)

    total = 0
    for w1, b1, w2, b2 in towers:
        y = x.float().transpose(1, 2)
        for q, d in enumerate(DILS):
            t = conv(F.leaky_relu(y, LRELU_SLOPE), w1[q], b1[q], d)
            y = conv(F.leaky_relu(t, LRELU_SLOPE), w2[q], b2[q], 1) + y
        total = total + y
    one = (total / len(towers)).transpose(1, 2).bfloat16()
    assert (one != ref).float().mean().item() > 0.1


@pytest.mark.parametrize("widths", KERNEL_WIDTHS)
@pytest.mark.parametrize("T_in", [29, 700, 11008])
@pytest.mark.parametrize("post", [False, True])
def test_upsample_stage_bf16_kernel_is_the_f32_kernel_rounded(cuda, widths, T_in, post):
    C_in, C_out = widths
    rng = np.random.default_rng(C_in + T_in + post + 1)
    x, up, towers, p = _stage_inputs(rng, cuda, 1, T_in, C_in, C_out, post)
    xb, towers = x.bfloat16(), _bf(towers)
    upb = pack_upsampler(up.w.bfloat16(), up.b.bfloat16(), 2)
    pb = tuple(t.bfloat16() for t in p) if post else None
    n0 = fused_upsample_stage.launches_bf16
    got = fused_upsample_stage(xb, upb, 1, pack_towers(towers), DILS, KS, post=pb)
    torch.cuda.synchronize()
    assert fused_upsample_stage.launches_bf16 == n0 + 1
    _check_bf16x2(got, upsample_stage_plain(xb, upb.w, upb.b, 2, 1, towers, DILS, post=pb))


@pytest.mark.parametrize("widths", KERNEL_WIDTHS)
@pytest.mark.parametrize("post", [False, True])
def test_upsample_stage_bf16_kernel_batch(cuda, widths, post):
    """B = 3, ragged T: each row as the plain version's (_check_bf16x2)."""
    C_in, C_out = widths
    rng = np.random.default_rng(C_in + post + 31)
    x, up, towers, p = _stage_inputs(rng, cuda, 3, 333, C_in, C_out, post)
    xb, towers = x.bfloat16(), _bf(towers)
    upb = pack_upsampler(up.w.bfloat16(), up.b.bfloat16(), 2)
    pb = tuple(t.bfloat16() for t in p) if post else None
    got = fused_upsample_stage(xb, upb, 1, pack_towers(towers), DILS, KS, post=pb)
    _check_bf16x2(got, upsample_stage_plain(xb, upb.w, upb.b, 2, 1, towers, DILS, post=pb))


@pytest.mark.parametrize("C", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("B,T", [(1, 9), (1, 23), (1, 44096), (2, 1001), (4, 176)])
def test_resblock_bf16_kernel_is_within_a_step_of_plain(cuda, C, B, T):
    """The bf16 K3 against its plain version (_check_bf16x2), launching the
    bf16 kernel alone; staged and L2 widths, one case below the halo."""
    rng = np.random.default_rng(C + B + T + 1)
    x = torch.tensor(rng.normal(size=(B, T, C)).astype(np.float32)).to(cuda).bfloat16()
    tower = _bf(_to(cuda, _towers(rng, C, ks=(3,))))[0]
    n0, f0 = fused_resblock1.launches_bf16, fused_resblock1.launches
    got = fused_resblock1(x, *tower, DILS)
    torch.cuda.synchronize()
    assert (fused_resblock1.launches_bf16, fused_resblock1.launches) == (n0 + 1, f0)
    _check_bf16x2(got, resblock1_plain(x, *tower, DILS))


def test_bf16_kernels_reject_what_they_do_not_take(cuda):
    rng = np.random.default_rng(0)
    towers = _bf(_to(cuda, _towers(rng, 64)))
    mrf = pack_towers(towers)
    x = torch.zeros(1, 50, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # float16
        fused_mrf(x.half(), pack_towers([tuple(t.half() for t in tw) for tw in towers]), DILS, KS)
    with pytest.raises(TypeError):  # bf16 x, float32 weights
        fused_mrf(x, pack_towers(widen(towers)), DILS, KS)
    with pytest.raises(ValueError):  # not contiguous
        fused_mrf(torch.zeros(1, 64, 50, device=cuda, dtype=torch.bfloat16).transpose(1, 2), mrf,
                  DILS, KS)
    up = pack_upsampler(torch.zeros(4, 64, 32, device=cuda, dtype=torch.bfloat16),
                        torch.zeros(32, device=cuda, dtype=torch.bfloat16), 2)
    tw32 = pack_towers(_bf(_to(cuda, _towers(rng, 32))))
    with pytest.raises(TypeError):
        fused_upsample_stage(x.half(), up, 1, tw32, DILS, KS)
    with pytest.raises(ValueError):
        fused_upsample_stage(torch.zeros(1, 64, 50, device=cuda, dtype=torch.bfloat16)
                             .transpose(1, 2), up, 1, tw32, DILS, KS)
    tower = towers[0]
    with pytest.raises(TypeError):
        fused_resblock1(x.half(), *(t.half() for t in tower), DILS)
    with pytest.raises(ValueError):
        fused_resblock1(torch.zeros(1, 64, 50, device=cuda, dtype=torch.bfloat16).transpose(1, 2),
                        *tower, DILS)
    from zerovox_tpu_torch.ops import _cuda

    for C in (8, 16, 32, 64, 128):
        tt = _cuda.lib("resblock").zv_resblock1_bf16_tile(1, 44096, C, 3, 3, *DILS)
        assert 16 <= tt and tt % 4 == 0
        tt = _cuda.lib("mrf").zv_mrf_bf16_tile(1, 44096, C, 3, *KS, 3, *DILS)
        assert 16 <= tt and tt % 4 == 0
    for C_in, C_out in KERNEL_WIDTHS:
        for post_k in (0, 7):
            tt = _cuda.lib("upsample_stage").zv_upsample_stage_bf16_tile(
                1, 44096, C_in, C_out, 4, 2, 1, post_k, 3, *KS, 3, *DILS)
            assert 16 <= tt and tt % 4 == 0


def k123_f32_digest(dev) -> str:
    """sha256 of the float32 K1, K2 (without and with conv_post) and K3
    outputs on seeded inputs at the streamed window's widths."""
    import hashlib

    h = hashlib.sha256()
    rng = np.random.default_rng(909)
    x = torch.tensor(rng.normal(size=(2, 3001, 128)).astype(np.float32)).to(dev)
    outs = [fused_mrf(x, pack_towers(_to(dev, _towers(rng, 128))), DILS, KS)]
    for C_in, C_out, post in ((128, 64, False), (64, 32, True)):
        xs, up, towers, p = _stage_inputs(rng, dev, 2, 1500, C_in, C_out, post)
        outs.append(fused_upsample_stage(xs, up, 1, pack_towers(towers), DILS, KS, post=p))
    for C in (32, 64, 128):
        xr = torch.tensor(rng.normal(size=(2, 2001, C)).astype(np.float32)).to(dev)
        outs.append(fused_resblock1(xr, *_to(dev, _towers(rng, C, ks=(3,)))[0], DILS))
    for out in outs:
        h.update(out.cpu().numpy().tobytes())
    return h.hexdigest()


# k123_f32_digest on an H100 (sm_90a) from the float32 kernels as they were
# before the bf16 variants joined their sources
K123_F32_DIGEST = "0a9cca97802cf89e933fe614924237ffe0ecd2736332ba4fa6f1a4eebc19ed9c"


def test_mrf_kernels_f32_bits_unchanged(cuda):
    assert k123_f32_digest(cuda) == K123_F32_DIGEST


def _small_cfg(kind="fastspeech2"):
    from zerovox_tpu_torch.config import (DecoderConfig, EncoderConfig, ModelConfig,
                                          ResNetConfig, ZeroVoxConfig)

    return ZeroVoxConfig(model=ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=16,
        encoder=EncoderConfig(fs2_layer=1, vp_filter_size=16, ve_n_bins=16),
        decoder=DecoderConfig(kind=kind, n_layers=1, conv_filter_size=64),
        resnet=ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 16, 16, 16))))


@pytest.mark.parametrize("kind", ["fastspeech2", "styletts"])
def test_bf16_engine_on_card_matches_cpu(cuda, kind):
    """A bf16 engine (`precision="bf16"`) whose vocoder stages take the bf16
    kernels (FastSpeech2: K1 on 128 and 64, K2 on 64->32 and 32->16;
    StyleTTS with one tower: stage 0 at 256 plain, K3 on 128, 64, 32):
    launches of the bf16 kernels only; the vocoder on the card's mel within
    5e-2 of its peak of the CPU's bf16 vocoder; the float32 waveforms within
    5e-2 of the peak of the CPU's bf16 run (FastSpeech2), a quarter of it
    (StyleTTS, whose decoder amplifies bf16 rounding, as
    tests/test_torch_bf16_infer.py bounds it on the CPU); streamed chunks
    within 1e-4 of the full render or four bf16 steps of its peak (cuDNN's
    bf16 convolutions give a few of a window's elements other bits than the
    whole's; chip_smoke.py's bound and its window_dependence)."""
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    hcfg = (HifiGanConfig(upsample_initial_channel=256) if kind == "fastspeech2" else
            HifiGanConfig(upsample_initial_channel=512, resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1, 3, 5),)))
    gpu = ZeroVoxTTS.from_random(_small_cfg(kind), hcfg, seed=3, precision="bf16")
    cpu = ZeroVoxTTS.from_random(_small_cfg(kind), hcfg, seed=3, precision="bf16", device="cpu")
    wav = np.random.default_rng(1).normal(size=22050).astype(np.float32) * 0.1
    spk = gpu.speaker_embed(wav)
    assert spk.dtype == torch.bfloat16
    text = "Hello there, general test."
    dur = np.full(len(gpu.text2phonemeids(text)[0]), 4, np.int32)
    kernels = (fused_mrf, fused_upsample_stage, fused_resblock1)
    before = [(k.launches, k.launches_bf16) for k in kernels]
    w_gpu, _, n, mel = gpu.tts_ex(text, spk, duration=dur)
    after = [(k.launches, k.launches_bf16) for k in kernels]
    f32_launches = [a[0] - b[0] for a, b in zip(after, before)]
    bf16_launches = [a[1] - b[1] for a, b in zip(after, before)]
    assert f32_launches == [0, 0, 0]
    assert bf16_launches == ([2, 2, 0] if kind == "fastspeech2" else [0, 0, 3])
    assert w_gpu.dtype == np.float32 and np.all(np.isfinite(w_gpu))
    # the vocoder alone, on the card's bf16 mel (exact in float32)
    mel16 = torch.from_numpy(mel.T[None]).bfloat16()
    v_gpu, v_cpu = gpu._vocode(mel16.to(cuda)).cpu(), cpu._vocode(mel16)
    v_peak = torch.max(torch.abs(v_cpu)).item()
    v_err = torch.max(torch.abs(v_gpu - v_cpu)).item()
    print(f"{kind}: bf16 vocoder card - cpu {v_err} (peak {v_peak})")
    assert v_peak > 0 and v_err <= min(5e-2, 5e-2 * v_peak)
    w_cpu, _, n_cpu = cpu.tts(text, spk.cpu(), duration=dur)
    assert n == n_cpu == 4 * len(dur)
    peak = np.max(np.abs(w_cpu))
    err = np.max(np.abs(w_gpu - w_cpu))
    print(f"{kind}: bf16 engine card - cpu {err} (peak {peak})")
    assert peak > 0 and err < min(5e-2, (5e-2 if kind == "fastspeech2" else 0.25) * peak)
    streamed = np.concatenate(list(gpu.tts_stream(text, spk, duration=dur, chunk_frames=24)))
    assert streamed.dtype == np.float32 and streamed.shape == w_gpu.shape
    tol = max(1e-4, 4 * bf16_step(torch.from_numpy(w_gpu)))
    err = np.max(np.abs(streamed - w_gpu))
    print(f"{kind}: bf16 stream max abs diff {err} (bound {tol})")
    assert err <= tol


def test_bf16_fused_speaker_routes_to_the_bf16_k4(cuda):
    """`fused_speaker` models in bf16 inference: stage 1 of the speaker
    encoder runs the bf16 K4 forward (float32 affines, as the JAX package's
    affine_packed gives them), near the float32 engine's embedding."""
    import dataclasses as dc

    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.ops.se_conv import se_conv_fwd, se_conv_fwd_bf16
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    base = _small_cfg()
    cfg = dc.replace(base, model=dc.replace(
        base.model, packed_speaker=1, fused_speaker=True,
        resnet=dc.replace(base.model.resnet, num_filters=(32, 16, 16, 16))))
    hcfg = HifiGanConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3, 5),))
    e16 = ZeroVoxTTS.from_random(cfg, hcfg, seed=4, precision="bf16")
    e32 = ZeroVoxTTS.from_random(cfg, hcfg, seed=4)
    wav = np.random.default_rng(2).normal(size=22050).astype(np.float32) * 0.1
    n0, f0 = se_conv_fwd_bf16.launches, se_conv_fwd.launches
    spk = e16.speaker_embed(wav)
    torch.cuda.synchronize()
    assert se_conv_fwd_bf16.launches - n0 == 2 and se_conv_fwd.launches == f0
    assert spk.dtype == torch.bfloat16 and torch.all(torch.isfinite(spk.float()))
    assert torch.max(torch.abs(spk.float() - e32.speaker_embed(wav))).item() < 5e-2


def _sd_pair(engine):
    sd, msd = engine.state_dicts()
    return sd, engine._meldec_cfg, msd


def test_server_on_card_matches_direct_tts_batch(cuda):
    """Two concurrent POST /tts through make_server on the card: one batch
    of 2 formed on the dispatch thread, which launches K1 and K2 there;
    each row, decoded from int16, within 1e-3 of the direct tts_batch (and
    one int16 step), and /health reports no error."""
    import http.client
    import io
    import json
    import threading
    import wave

    from zerovox_tpu_torch.config import (DecoderConfig, EncoderConfig, ModelConfig,
                                          ResNetConfig, ZeroVoxConfig)
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.serving import VoiceRegistry, make_server, serve_in_thread
    from zerovox_tpu_torch.synthesize import VOCODER_ALL_BATCHES, ZeroVoxTTS

    cfg = ZeroVoxConfig(model=ModelConfig(
        max_txt_len=64, max_mel_len=256, emb_dim=48, punct_emb_dim=16,
        encoder=EncoderConfig(fs2_layer=1, vp_filter_size=16, ve_n_bins=16),
        decoder=DecoderConfig(n_layers=1, conv_filter_size=64),
        resnet=ResNetConfig(layers=(1, 1, 1, 1), num_filters=(8, 16, 16, 16))))
    engine = ZeroVoxTTS.from_random(cfg, HifiGanConfig(upsample_initial_channel=256), seed=3)
    # random weights predict durations near zero, and HTTP cannot force
    # them: a duration bias of 1.5 (exp(1.5) - 1 ~ 3.5 frames a phone) gives
    # rows to compare
    with torch.no_grad():
        engine._model._phoneme_encoder._variance_adaptor.duration_predictor.linear_layer.bias.fill_(1.5)
    voices = VoiceRegistry()
    voices.add("v", engine.speaker_embed(
        np.random.default_rng(1).normal(size=22050).astype(np.float32) * 0.1))
    texts = ["Hello there, general test.", "A second request."]
    srv = make_server(engine, voices, port=0, max_batch=2, max_delay_ms=2000)
    serve_in_thread(srv)
    host, port = srv.server_address[:2]
    rows = [None, None]

    def post(i):
        conn = http.client.HTTPConnection(host, port, timeout=300)
        conn.request("POST", "/tts", json.dumps({"text": texts[i], "voice": "v"}))
        resp = conn.getresponse()
        rows[i] = (resp.status, resp.read())
        conn.close()

    try:
        k1, k2 = fused_mrf.launches, fused_upsample_stage.launches
        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert fused_upsample_stage.launches - k2 == 2
        assert fused_mrf.launches - k1 == (2 if VOCODER_ALL_BATCHES else 0)
        assert srv.batcher.stats.max_batch_seen == 2 and srv.batcher.stats.errors == 0
        direct = engine.tts_batch(texts, np.concatenate([voices.get("v")] * 2))
        for (status, body), (wav, n) in zip(rows, direct):
            assert status == 200
            with wave.open(io.BytesIO(body)) as w:
                pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
            assert pcm.shape == wav.shape == (n * cfg.audio.hop_size,) and n > 0
            assert np.max(np.abs(pcm / 32767.0 - wav)) <= 1e-3 + 1.0 / 32767
    finally:
        srv.shutdown_serving()


# ------------------------------------------------------ vocoder GAN training

def test_gan_round_on_card_matches_cpu(cuda, tmp_path):
    """One GAN round at tiny widths (32 initial channels, MPD 2,3, MSD x 2,
    batch 2, 8-frame segments) from the same weights and batch: losses
    within 1e-4 relative of a float64 run on the CPU, the discriminators'
    and generator's gradients within 1e-3 x each tensor's max; no fused
    kernel launched. The reference is float64 because torch's float32 CPU
    convolutions are the less accurate side here: on this batch they put
    the weight gradient of MSD's last conv 2.0e-3 x its max from float64,
    the card's cuDNN 2.5e-6 (measured on an H100)."""
    from zerovox_tpu_torch.dsp.audio import save_wav
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.training.vocoder import (VocoderDataConfig, VocoderDataset,
                                                    VocoderTrainerConfig, card_round_gap)

    rng = np.random.default_rng(12)
    (tmp_path / "wavs").mkdir()
    (tmp_path / "mel").mkdir()
    for i in range(2):
        wav = (0.3 * np.sin(2 * np.pi * (150 + 60 * i) * np.arange(20 * 256) / 22050)
               + 0.02 * rng.normal(size=20 * 256)).astype(np.float32)
        save_wav(tmp_path / "wavs" / f"u{i}.wav", wav, 22050)
        np.save(tmp_path / "mel" / f"mel-u{i}.npy", rng.normal(size=(20, 80)).astype(np.float32))
    (tmp_path / "train.txt").write_text("u0.wav|x\nu1.wav|x\n")
    gcfg = HifiGanConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3),))
    dcfg = VocoderDataConfig(segment_frames=8)
    batch = next(VocoderDataset([str(tmp_path)], dcfg, seed=0).batches(2))
    n0 = (fused_mrf.launches, fused_upsample_stage.launches, fused_resblock1.launches)
    loss_rel, grad_rel = card_round_gap(
        gcfg, dcfg, VocoderTrainerConfig(batch_size=2, mpd_periods=(2, 3), msd_scales=2), batch,
        seed=3, device="cuda")
    assert (fused_mrf.launches, fused_upsample_stage.launches, fused_resblock1.launches) == n0
    assert loss_rel <= 1e-4 and grad_rel <= 1e-3, (loss_rel, grad_rel)


# ---------------------------------------------------------------- preprocessing


def test_tone_ctc_emissions_on_card_match_cpu(cuda):
    from zerovox_tpu_torch.preprocess.tone_ctc import ToneCTCAligner
    from zerovox_tpu_torch.utils.synthvoice import render_text

    wavs = [render_text(t, 16000, seed=i) for i, t in enumerate(("hello world", "jumpy vixen"))]
    n = max(len(w) for w in wavs)
    batch = np.stack([np.pad(w, (0, n - len(w))) for w in wavs])
    got = ToneCTCAligner(device=cuda).emissions(batch)
    want = ToneCTCAligner(device="cpu").emissions(batch)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-4


@pytest.mark.parametrize("n", [9999, 88200])
def test_get_mel_from_wav_on_card_matches_cpu(cuda, n):
    from zerovox_tpu_torch.dsp.mels import get_mel_from_wav

    rng = np.random.default_rng(n)
    wav = (np.sin(np.arange(n) * 0.05) * 0.3 + rng.normal(size=n) * 0.05).astype(np.float32)
    args = (22050, 1024, 256, 1024, 80, 0, 8000)
    mel, en = get_mel_from_wav(wav, *args, device=cuda)
    mel_c, en_c = get_mel_from_wav(wav, *args, device="cpu")
    assert mel.shape == mel_c.shape and mel.dtype == np.float32
    assert np.max(np.abs(mel - mel_c)) <= 1e-4
    assert np.max(np.abs(en - en_c) / np.abs(en_c)) <= 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forced_align_torch_on_card_matches_native(cuda, seed):
    from zerovox_tpu_torch.preprocess.ctc_align import forced_align, forced_align_torch

    rng = np.random.default_rng(seed)
    T, C = int(rng.integers(100, 400)), 28
    logits = rng.normal(size=(T, C))
    em = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    targets = rng.integers(1, C, size=int(rng.integers(5, T // 4)))
    tok, scores = forced_align_torch(torch.from_numpy(em).to(cuda), targets)
    want, want_scores = forced_align(em, targets)
    np.testing.assert_array_equal(tok.cpu().numpy(), want)
    np.testing.assert_array_equal(scores.cpu().numpy(), want_scores)


# ------------------------------------------------------------ K5: flash attention

def _attn_inputs(rng, B, h, L, d, dev, dtype=torch.float32, strided=False):
    """q, k, v [B, h, L, d] (strided: views of [B, L, h, d] tensors, as the
    model passes them), segment ids with per-row valid lengths (row 0 full),
    and an output cotangent."""
    def t():
        x = torch.tensor(rng.normal(size=(B, L, h, d)).astype(np.float32)).to(dev, dtype)
        return x.transpose(1, 2) if strided else x.transpose(1, 2).contiguous()

    n = rng.integers(L // 2, L + 1, size=B)
    n[0] = L
    seg = torch.tensor((np.arange(L)[None] >= n[:, None]).astype(np.int32)).to(dev)
    return t(), t(), t(), seg, t()


# and every other head dim: d not a multiple of 8 through the padding (11 ->
# 16, 44 -> 48, 132 -> 136), d above 272 on the cluster kernels (280 the
# first, 528 tts_medium's one head: bf16's backward on clusters of three,
# 520 uneven parts with a bf16 zero tail, 1040 above 1024: a cluster of
# four, the bf16 backward's of six, 1408 bf16's reach: its backward's
# clusters of eight, 2112 float32's reach: eight, bf16 on the wide kernels)
# and on the wide kernels (2184, beyond both)
FLASH_SHAPES = [(2, 2, 256, 24), (1, 2, 1024, 264), (2, 2, 384, 136), (2, 2, 512, 256),
                (2, 2, 256, 272), (1, 4, 256, 11), (2, 4, 128, 44), (1, 2, 256, 132),
                (2, 1, 256, 280), (1, 1, 256, 528), (2, 1, 128, 520), (1, 1, 128, 1040),
                (1, 1, 128, 1408), (1, 1, 128, 2112), (1, 1, 128, 2184)]


def _flash_grads(fn, q, k, v, seg, do, scale):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v, seg, scale)
    o.backward(do)
    return o.detach(), q.grad, k.grad, v.grad


@pytest.mark.parametrize("B,h,L,d", FLASH_SHAPES)
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, B, h, L, d, strided, dtype):
    from zerovox_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    rng = np.random.default_rng(L + d)
    q, k, v, seg, do = _attn_inputs(rng, B, h, L, d, cuda, dtype, strided)
    scale = 1.0 / np.sqrt(d)
    got = _flash_grads(flash_attention, q, k, v, seg, do, scale)
    want = _flash_grads(flash_attention_plain, q, k, v, seg, do, scale)
    torch.cuda.synchronize()
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == dtype, name
        assert bool(torch.isfinite(g.float()).all()), name
        err = (g.float() - w.float()).abs().max().item()
        if dtype == torch.bfloat16:
            bound = (1 if name == "o" else 2) * bf16_step(w.float())
        else:
            bound = TOL if name == "o" else 1e-4 * w.abs().max().item()
        assert err <= bound, f"{name}: {err} > {bound}"
    if strided:
        assert got[0].stride() == q.stride() and got[1].stride() == q.stride()


# The forward's layouts, each forced by the sizes that select it on an
# H100's 132 SMs (fwd_tile: 64, 32 or 16 query rows a block, each row
# group's keys split 1, 2 or 4 ways between warp pairs); L = 64 is one bf16
# key tile at 16 rows, d = 272 the largest shared-memory layout.
FLASH_FWD_LAYOUTS = [(9, 2, 512, 264, 64), (9, 2, 512, 272, 64), (66, 2, 64, 24, 64),
                     (4, 2, 640, 136, 32), (3, 2, 1024, 264, 32), (1, 2, 1024, 264, 16),
                     (1, 2, 256, 264, 16), (1, 2, 64, 264, 16), (1, 1, 64, 8, 16)]


def _lse_plain(q, k, seg, scale):
    """The float64 log-sum-exp of each row's masked scores."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
    if seg is not None:
        from zerovox_tpu_torch.ops.flash_attention import MASK_VALUE

        same = seg[:, None, :, None] == seg[:, None, None, :]
        s = s + torch.where(same, 0.0, MASK_VALUE).double()
    return torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("B,h,L,d,tile", FLASH_FWD_LAYOUTS)
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_every_layout(cuda, B, h, L, d, tile, masked, strided, dtype):
    """o within the forward's bound of plain and lse within 1e-5 x its
    largest value of the float64 log-sum-exp, in every layout the launcher
    picks; row 0 of the segment ids is all one segment."""
    from zerovox_tpu_torch.ops import flash_attention as fa

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want_tile = 64 if B * h * (L // 64) >= sms else 32 if B * h * (L // 32) >= sms else 16
    assert fa.fwd_tile(B, h, L) == want_tile
    if sms == 132:
        assert want_tile == tile
    rng = np.random.default_rng(B * L + d)
    q, k, v, seg, _ = _attn_inputs(rng, B, h, L, d, cuda, dtype, strided)
    assert bool((seg[0] == 0).all())
    seg = seg if masked else None
    scale = 1.0 / np.sqrt(d)
    o, lse = fa.flash_fwd(q, k, v, seg, scale)
    want = fa.flash_attention_plain(q, k, v, seg, scale)
    want_lse = _lse_plain(q, k, seg, scale)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.stride() == q.stride() and lse.shape == (B, h, L)
    assert bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(lse).all())
    err = (o.float() - want.float()).abs().max().item()
    bound = bf16_step(want.float()) if dtype == torch.bfloat16 else TOL
    assert err <= bound, f"o: {err} > {bound}"
    lse_err, lse_bound = (lse.double() - want_lse).abs().max().item(), \
        1e-5 * want_lse.abs().max().item()
    assert lse_err <= lse_bound, f"lse: {lse_err} > {lse_bound}"


def test_flash_attention_counts_and_repeats(cuda):
    from zerovox_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(3)
    q, k, v, seg, do = _attn_inputs(rng, 4, 2, 512, 264, cuda, strided=True)
    before = [(f.launches, f.launches_bf16) for f in fa.KERNELS]
    a = _flash_grads(fa.flash_attention, q, k, v, seg, do, 0.1)
    b = _flash_grads(fa.flash_attention, q, k, v, seg, do, 0.1)
    after = [(f.launches, f.launches_bf16) for f in fa.KERNELS]
    assert [(x - y, z - w) for (x, z), (y, w) in zip(after, before)] == [(2, 0)] * 3
    for x, y in zip(a, b):
        assert torch.equal(x, y), "K5 is not bitwise repeatable"
    assert fa.fwd_tile(1, 2, 1024) == 16 and fa.fwd_tile(24, 2, 512) == 64


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    from zerovox_tpu_torch.ops.flash_attention import flash_attention, flash_fwd

    def qkv(L, d, dtype=torch.float32):
        return [torch.zeros(1, 2, L, d, device=cuda, dtype=dtype) for _ in range(3)]

    for args, what in ((qkv(100, 24), "multiple of 64"), (qkv(256, 24, torch.float16), "float16"),
                       (qkv(100, 12), "multiple of 64"), (qkv(100, 280), "multiple of 64")):
        with pytest.raises((ValueError, TypeError), match=what):
            flash_attention(*args, None, 1.0)
    # the kernels themselves take multiples of 8 only: flash_attention pads the rest
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd(*qkv(256, 12))
    q, k, v = qkv(256, 24)
    with pytest.raises(ValueError, match="segment ids"):
        flash_fwd(q, k, v, torch.zeros(1, 256, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_fwd(q.cpu(), k.cpu(), v.cpu())


@pytest.mark.parametrize("d", [280, 528, 1040, 1408])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_lse_and_repeats(cuda, d, dtype):
    """The forward's lse above 272 (written by rank 0 of a cluster) within
    1e-5 x its largest value of the float64 log-sum-exp, unmasked and
    masked; the kernels bitwise repeatable, one launch of each a call."""
    from zerovox_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(d)
    q, k, v, seg, do = _attn_inputs(rng, 2, 2, 192, d, cuda, dtype, strided=True)
    scale = 1.0 / np.sqrt(d)
    for s in (seg, None):
        o, lse = fa.flash_fwd(q, k, v, s, scale)
        want = _lse_plain(q, k, s, scale)
        err, bound = (lse.double() - want).abs().max().item(), 1e-5 * want.abs().max().item()
        assert err <= bound, f"lse: {err} > {bound}"
    before = [(f.launches, f.launches_bf16) for f in fa.KERNELS]
    a = _flash_grads(fa.flash_attention, q, k, v, seg, do, scale)
    b = _flash_grads(fa.flash_attention, q, k, v, seg, do, scale)
    after = [(f.launches, f.launches_bf16) for f in fa.KERNELS]
    two = (2, 0) if dtype == torch.float32 else (0, 2)
    assert [(x - y, z - w) for (x, z), (y, w) in zip(after, before)] == [two] * 3
    for x, y in zip(a, b):
        assert torch.equal(x, y), "the wide kernels are not bitwise repeatable"

