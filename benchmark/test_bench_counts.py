"""The counts of FLOPs and bytes against hand counts at small shapes, the
network counts against torch's FLOP counter on the plain reference, and the
step's count against the shapes a CPU run of the step logs."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark.reference import plain


def flops_of(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_film_fwd_hand_count():
    # 2 x 5 points, Din 3, 3 layers of 4, 2 outputs:
    # MACs a point 3*4 + 2*16 + 4*2 = 52
    flops, nbytes = counts.film_fwd(2, 5, 3, 3, 4, 2)
    assert flops == 2 * 10 * 52
    params = 3 * 4 + 4 + 2 * (16 + 4) + 4 * 2 + 2
    assert nbytes == 4 * (10 * 3 + 2 * 2 * 3 * 4 + params + 10 * 2)


def test_film_bwd_hand_count():
    flops, nbytes = counts.film_bwd(2, 5, 3, 3, 4, 2)
    assert flops == 4 * 10 * 52
    params = 3 * 4 + 4 + 2 * (16 + 4) + 4 * 2 + 2
    reads = 10 * 3 + 2 * 2 * 3 * 4 + params + 10 * 2
    writes = 10 * 3 + 2 * 2 * 3 * 4 + params
    assert nbytes == 4 * (reads + writes)


@pytest.mark.parametrize("din,layers", [(3, 4), (32, 8)])
def test_film_fwd_against_flop_counter(din, layers):
    H, B, N = 16, 2, 7
    mapping = plain.LinearMapping(5, layers * H * 2)
    siren = plain.FilmSiren(layers, 3 if din == 3 else din, H, mapping, features_input=din != 3)
    pts = torch.rand(B, N, 3) - 0.5
    z = torch.randn(B, 5) if din == 3 else (torch.randn(B, 4, 4, 4, din), torch.randn(B, 5))
    measured = flops_of(lambda: siren(pts, z))
    expected = counts.film_fwd(B, N, din, layers, H, 4)[0] + counts.mlp_flops(B, [5, layers * H * 2])
    assert measured == expected


def test_trilinear_hand_count_and_touched_rows():
    # one volume of 4^3, two points: the centre cell's 8 corners, and the
    # low corner, whose clamped anchor shares 1 row with them... count them
    coords = torch.tensor([[[0.0, 0.0, 0.0], [-1.0, -1.0, -1.0]]])
    rows = counts.touched_rows((1, 4, 4, 4, 8), coords)
    # centre: unnormalized 1.5 on each axis, anchor 1 -> rows {1,2}^3 (8);
    # -1: unnormalized -0.5, clamped to 0 -> anchor 0 -> rows {0,1}^3 (8),
    # sharing (1,1,1): 15 distinct
    assert rows == 15
    assert counts.trilinear_fwd(1, 2, 8, rows) == (0, 4 * (2 * 3 + 15 * 8 + 2 * 8))
    assert counts.trilinear_bwd(1, 2, 8, rows) == (0, 4 * (2 * 3 + 2 * 8 + 15 * 8))


def test_pointnet_against_flop_counter():
    B, T, h = 2, 9, 8
    net = plain.ResnetPointnet(c_dim=6, dim=6, hidden=h)
    measured = flops_of(lambda: net(torch.randn(B, T, 6)))
    # the reference concatenates the pooled half onto every point; the count
    # takes it once a cloud: the difference is 4 blocks x 2 products of h x h
    # on T - 1 points a cloud
    assert measured == counts.pointnet_flops(B, T, 6, h, 6) + 2 * B * (T - 1) * 4 * 2 * h * h


def test_unet_against_flop_counter():
    net = plain.UNet3D(4, 5, 8, 3)
    measured = flops_of(lambda: net(torch.randn(2, 8, 8, 8, 4)))
    assert measured == counts.unet3d_flops(2, 8, 4, 8, 3, 5)


@pytest.mark.parametrize("img", [16, 32])
def test_discriminator_against_flop_counter(img):
    D = plain.ProgressiveDiscriminator()
    measured = flops_of(lambda: D(torch.rand(2, img, img, 3), 0.5))
    assert measured == counts.progressive_d_flops(2, img)


def test_step_count_follows_the_logged_shapes(tiny_cell):
    from benchmark.drivers import train

    setup = train.Setup(tiny_cell("thesis_train_s2"))
    s = setup.shapes
    assert (s["batch"], s["img"], s["samples"], s["chunks"]) == (2, 16, 6, 4)
    assert s["encoder"]["points"] == 256
    B, pts = 2, 2 * 16 * 16 * 6 * 2
    enc = counts.pointnet_flops(B, 256, 6, 512, 512)
    gen = counts.mlp_flops(B, [512, 256, 256, 256, 2048]) + 2 * pts * (3 * 256 + 3 * 256 ** 2 + 256 * 4)
    d = counts.progressive_d_flops(B, 16)
    # G step: forward + backward of encode and render, D on the fakes and
    # its backward; D step: encode and render without grad, D on real and
    # fake, R1's pass (a backward), all their backwards
    assert counts.train_step_flops(s) == 3 * (enc + gen) + 3 * d + enc + gen + 12 * d


def test_request_count(tiny_cell):
    from benchmark.drivers import serve

    setup = serve.Setup(tiny_cell("dg_serve"))
    s = setup.shapes
    assert (s["views"], s["img"], s["encoder"]["side"]) == (8, 16, 16)
    pts = 8 * 16 * 16 * 6 * 2
    assert counts.request_flops(s) == (counts.unet3d_flops(8, 16, 4, 32, 4, 32)
                                       + counts.mlp_flops(8, [256, 4096])
                                       + 2 * pts * (32 * 256 + 7 * 256 ** 2 + 256 * 4))
