"""The patch route of the port's convolutions (``nn/layers.conv_route``,
``patch_conv`` and the gather of ``ops/hopper/patches_kernel``), held on the
CPU: the gather's plain version against ``pad_spatial`` + an explicit
unfold, the patch conv against ``F.conv2d`` / ``F.conv3d`` at every conv
geometry of the journal, long-horizon, KITTI and SPADE generators, the
route's decisions and its call counters. The gather kernel itself runs only
on a card (the ``cuda`` test at the end). This file imports nothing of JAX.
"""

import pytest
import torch
import torch.nn.functional as F

from c2m_tpu_torch import config as pconfig
from c2m_tpu_torch.data.synthetic import make_batch
from c2m_tpu_torch.models.c2m import C2MGenerator
from c2m_tpu_torch.nn import layers
from c2m_tpu_torch.ops.hopper import patches_kernel as pk
from c2m_tpu_torch.serving import ServingModel, z_dim

# (kernel, stride, pad, mode) of every Conv / Conv3d of the four generators
# (held to the models by test_geometries_cover_the_generators)
GEOMETRIES = [
    ((1, 1), (1, 1), (0, 0), "zeros"),
    ((3, 3), (1, 1), (1, 1), "reflect"),
    ((4, 4), (2, 2), (1, 1), "reflect"),
    ((7, 7), (1, 1), (0, 0), "reflect"),
    ((7, 7), (1, 1), (3, 3), "reflect"),
    ((7, 7), (1, 1), (3, 3), "zeros"),
    ((1, 3, 3), (1, 1, 1), (0, 1, 1), "reflect"),
    ((1, 4, 4), (1, 2, 2), (0, 1, 1), "reflect"),
    ((3, 3, 3), (1, 1, 1), (1, 1, 1), "reflect"),
    ((3, 4, 4), (1, 2, 2), (1, 1, 1), "reflect"),
    ((4, 4, 4), (2, 2, 2), (1, 1, 1), "reflect"),
]
CONFIGS = [("configs/c2m_journal_cityscapes.yaml", False),
           ("configs/c2m_long_horizon.yaml", False),
           ("configs/c2m_kitti.yaml", False),
           ("configs/c2m_journal_cityscapes.yaml", True)]


def spatial_sizes(kernel, pad, short: bool):
    """Small input sizes a conv of ``kernel`` / ``pad`` takes; ``short``
    makes the first padded axis no longer than its pad (reflect falls back
    to edge there) where the kernel still fits."""
    sizes = [max(k - 2 * p, 1) + 4 + a for a, (k, p) in
             enumerate(zip(kernel, pad))]
    if short:
        a = next((a for a, p in enumerate(pad) if p > 0), None)
        if a is None:
            return None
        sizes[a] = max(kernel[a] - 2 * pad[a], 1, min(pad[a], sizes[a]))
        if sizes[a] > pad[a]:
            return None
    return sizes


def unfold_padded(x, kernel, stride, pad, mode):
    """The patch matrix by pad_spatial and Tensor.unfold: [rows, taps * C]
    in (taps, C) order."""
    nd = len(kernel)
    win = layers.pad_spatial(x, [(p, p) for p in pad], mode)
    for a, (k, s) in enumerate(zip(kernel, stride)):
        win = win.unfold(1 + a, k, s)        # [B, *out, C, *kernel]
    win = win.permute(0, *range(1, nd + 1), *range(nd + 2, 2 * nd + 2),
                      nd + 1)
    return win.reshape(-1, x.shape[-1] * torch.Size(kernel).numel())


def reference_conv(x, weight, bias, stride, pad, mode):
    """The cudnn route's arithmetic: pad_spatial + F.conv2d / conv3d."""
    nd = weight.dim() - 2
    xp = layers.pad_spatial(x, [(p, p) for p in pad], mode)
    conv = F.conv2d if nd == 2 else F.conv3d
    y = conv(xp.movedim(-1, 1), weight, bias, stride)
    return y.movedim(1, -1)


CASES = [(g, short, c) for g in GEOMETRIES for short in (False, True)
         for c in (3, 8) if spatial_sizes(g[0], g[2], short) is not None]
MODES = ("zeros", "reflect", "replicate")


@pytest.mark.parametrize("geometry,short,channels", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_gather_plain_is_pad_and_unfold(geometry, short, channels, mode):
    kernel, stride, pad, _ = geometry
    g = torch.Generator().manual_seed(len(CASES))
    x = torch.randn(2, *spatial_sizes(kernel, pad, short), channels,
                    generator=g)
    want = unfold_padded(x, kernel, stride, pad, mode)
    assert torch.equal(pk.conv_patches_plain(x, kernel, stride, pad, mode),
                       want)
    # any run of rows, as a chunk asks for it
    row0, rows = want.shape[0] // 3, want.shape[0] // 2
    assert torch.equal(pk.conv_patches(x, kernel, stride, pad, mode, row0,
                                       rows), want[row0:row0 + rows])


# float64: the patch conv sums the same products as F.conv in another order
# (the GEMM's); 1e-12 relative is some 1e4 units of float64 rounding over
# K <= 448 terms of order 1
TOL_CONV64 = 1e-12


@pytest.mark.parametrize("geometry,short,channels", CASES)
@pytest.mark.parametrize("budget", [layers.PATCH_BYTES, 1000])
def test_patch_conv_is_the_conv(monkeypatch, geometry, short, channels,
                                budget):
    kernel, stride, pad, mode = geometry
    monkeypatch.setattr(layers, "PATCH_BYTES", budget)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, *spatial_sizes(kernel, pad, short), channels,
                    generator=g, dtype=torch.float64)
    w = torch.randn(5, channels, *kernel, generator=g, dtype=torch.float64)
    b = torch.randn(5, generator=g, dtype=torch.float64)
    want = reference_conv(x, w, b, stride, pad, mode)
    for bias in (b, None):
        got = layers.patch_conv(x, w, bias, stride, pad, mode)
        ref = want if bias is not None else want - b
        assert got.shape == ref.shape and got.is_contiguous()
        err = (got - ref).abs().max() / ref.abs().max()
        assert err <= TOL_CONV64, err


def test_geometries_cover_the_generators():
    seen = set()
    for path, spade in CONFIGS:
        cfg = pconfig.load_config(path)
        cfg.model_params.generator.use_spade = spade
        with torch.device("meta"):
            model = C2MGenerator(cfg)
        seen |= {(m.kernel_size, m.stride, m.pad, m.pad_mode)
                 for m in model.modules()
                 if isinstance(m, (layers.Conv, layers.Conv3d))}
    assert seen == set(GEOMETRIES)


PATCH_CALL = dict(device_type="cuda", dtype=torch.float32, inference=True,
                  cudnn_tf32=False, matmul_tf32=False)


@pytest.mark.parametrize("change,route", [
    ({}, "patch"),
    ({"device_type": "cpu"}, "cudnn"),
    ({"device_type": "meta"}, "cudnn"),
    ({"dtype": torch.bfloat16}, "cudnn"),
    ({"dtype": torch.float16}, "cudnn"),
    ({"dtype": torch.float64}, "cudnn"),
    ({"inference": False}, "cudnn"),
    ({"cudnn_tf32": True}, "cudnn"),
    ({"matmul_tf32": True}, "cudnn"),
    ({"cudnn_tf32": True, "matmul_tf32": True}, "cudnn"),
])
def test_conv_route(change, route):
    assert layers.conv_route(**{**PATCH_CALL, **change}) == route


def tiny_cfg():
    cfg = pconfig.shrink_model(pconfig.tiny_config(batch_size=2), 8, 32)
    cfg.train_params.dtype = "float32"
    return cfg


def test_a_cpu_request_routes_every_conv_to_cudnn():
    cfg = tiny_cfg()
    torch.manual_seed(0)
    server = ServingModel(C2MGenerator(cfg), batch_sizes=(2,))
    batch = make_batch(cfg, batch_size=2, seed=1, device="cpu")
    z = torch.randn(2, z_dim(cfg), generator=torch.Generator().manual_seed(1))
    before, launches = dict(layers.CONV_CALLS), pk.CONV_PATCHES.launches
    server(batch, z.numpy(), batch["node_mask"].astype("float32"))
    assert layers.CONV_CALLS["patch"] == before["patch"]
    assert layers.CONV_CALLS["cudnn"] > before["cudnn"]
    assert pk.CONV_PATCHES.launches == launches


@pytest.mark.parametrize("module", [
    layers.Conv(6, 16, 3, 1, 1, "reflect"),
    layers.Conv(6, 16, 4, 2, 1, "zeros"),
    layers.Conv3d(6, 16, (3, 4, 4), (1, 2, 2), 1, "reflect"),
])
def test_a_routed_call_counts_and_computes_the_conv(monkeypatch, module):
    """One call that the route sends down the patch path (the route stood
    in for, since the CPU never takes it) counts once and equals the cudnn
    route's output."""
    x = torch.randn(2, *([3] * (module.weight.dim() - 4)), 6, 7, 6,
                    generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        before = dict(layers.CONV_CALLS)
        want = module(x)
        assert layers.CONV_CALLS["cudnn"] == before["cudnn"] + 1
        monkeypatch.setattr(layers, "conv_route", lambda *a: "patch")
        got = module(x)
    assert layers.CONV_CALLS["patch"] == before["patch"] + 1
    assert layers.CONV_CALLS["cudnn"] == before["cudnn"] + 1
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,rows,align,route", [
    ((12, 16, 32, 256), 12 * 16 * 32, 16, (4, False)),
    ((12, 5, 16, 32, 528), 12 * 5 * 16 * 32, 16, (4, False)),
    ((12, 5, 128, 256, 34), 12 * 5 * 128 * 256, 16, (2, False)),
    ((12, 5, 128, 256, 2), 12 * 5 * 64 * 128, 16, (2, False)),
    ((60, 128, 256, 3), 60 * 128 * 256, 16, (1, False)),
    ((12, 16, 32, 256), 12 * 16 * 32, 8, (2, False)),
    ((12, 16, 32, 256), 12 * 16 * 32, 4, (1, False)),
    ((40, 10, 256, 512, 64), 40 * 10 * 256 * 512, 16, (4, True)),
    ((40, 10, 512, 1024, 34), 40 * 10 * 512 * 1024, 16, (2, True)),
    ((100, 10, 512, 1024, 5), 100 * 10 * 512 * 1024, 16, (1, True)),
    ((1, 1, 2 ** 16, 2 ** 16, 4), 2 ** 31, 16, (4, True)),
])
def test_patches_route(shape, rows, align, route):
    assert pk.patches_route(shape, rows, align) == route


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_gather_kernel_on_the_card(monkeypatch, wide):
    """Every geometry, mode and move width against the plain version, bit
    for bit; ``wide`` sends the same inputs down the 64-bit offsets, which
    the model's sizes never reach."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/patches.cu runs only there")
    if wide:
        route = pk.patches_route
        monkeypatch.setattr(pk, "patches_route",
                            lambda *a: (route(*a)[0], True))
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(11)
    for (kernel, stride, pad, _), short, c in CASES:
        for channels in (c, 34, 64):
            x = torch.randn(3, *spatial_sizes(kernel, pad, short), channels,
                            generator=g)
            for mode in MODES:
                want = pk.conv_patches_plain(x, kernel, stride, pad, mode)
                before = pk.CONV_PATCHES.launches
                got = pk.conv_patches(x.to(dev), kernel, stride, pad, mode)
                assert pk.CONV_PATCHES.launches == before + 1
                assert torch.equal(got.cpu(), want)
                row0 = want.shape[0] // 3
                got = pk.conv_patches(x.to(dev), kernel, stride, pad, mode,
                                      row0, want.shape[0] - row0)
                assert torch.equal(got.cpu(), want[row0:])
    # a view 4 bytes past an allocation: the scalar route whatever C is
    x = torch.randn(2, 5, 6, 8, generator=g)
    flat = torch.empty(1 + x.numel(), device=dev)
    view = flat[1:].view(x.shape).copy_(x)
    want = pk.conv_patches_plain(x, (3, 3), (1, 1), (1, 1), "reflect")
    got = pk.conv_patches(view, (3, 3), (1, 1), (1, 1), "reflect")
    assert torch.equal(got.cpu(), want)
