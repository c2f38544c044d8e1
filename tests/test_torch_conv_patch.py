"""The patch route of the port's convolutions (``nn/layers.conv_route``,
``patch_conv``, ``PatchConv`` and the gather and its adjoint in
``ops/hopper/patches_kernel``), held on the CPU: the gather's plain version
against ``pad_spatial`` + an explicit unfold, the adjoint's against the
gather by the adjoint identity, the patch conv and its gradients against
``F.conv2d`` / ``F.conv3d`` and their autograd at every conv geometry of
the journal, long-horizon, KITTI and SPADE generators, the route's
decisions and its call counters. The kernels themselves run only on a card
(the ``cuda`` tests at the end). This file imports nothing of JAX.
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


@pytest.mark.parametrize("geometry,short,channels", CASES)
@pytest.mark.parametrize("budget", [layers.TRAIN_PATCH_BYTES, 20000])
def test_patch_conv_gradients(monkeypatch, geometry, short, channels,
                              budget):
    """PatchConv's input, weight and bias gradients in float64 against
    autograd of pad_spatial + F.conv2d / conv3d, for each subset of operands
    that needs a gradient (the small budget cuts each image into chunks of
    a few rows)."""
    kernel, stride, pad, mode = geometry
    monkeypatch.setattr(layers, "TRAIN_PATCH_BYTES", budget)
    g = torch.Generator().manual_seed(17)
    x = torch.randn(2, *spatial_sizes(kernel, pad, short), channels,
                    generator=g, dtype=torch.float64)
    w = torch.randn(5, channels, *kernel, generator=g, dtype=torch.float64)
    b = torch.randn(5, generator=g, dtype=torch.float64)
    want_y = reference_conv(x, w, b, stride, pad, mode)
    gy = torch.randn(want_y.shape, generator=g, dtype=torch.float64)
    for need_x, need_w in ((True, True), (True, False), (False, True)):
        operands = [x.clone().requires_grad_(need_x),
                    w.clone().requires_grad_(need_w),
                    b.clone().requires_grad_(need_w)]
        want = torch.autograd.grad(
            (reference_conv(*operands, stride, pad, mode) * gy).sum(),
            [t for t in operands if t.requires_grad])
        before = layers.CONV_CALLS["patch_backward"]
        y = layers.PatchConv.apply(*operands, stride, pad, mode)
        got = torch.autograd.grad((y * gy).sum(),
                                  [t for t in operands if t.requires_grad])
        assert layers.CONV_CALLS["patch_backward"] == before + 1
        for a, e in zip((y, *got), (want_y, *want)):
            assert a.shape == e.shape and a.is_contiguous()
            err = (a - e).abs().max() / e.abs().max()
            assert err <= TOL_CONV64, err


@pytest.mark.parametrize("geometry,short,channels", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_adjoint_plain_is_the_gathers_adjoint(geometry, short, channels,
                                              mode):
    """<gather(x), g> == <x, adjoint(g)> on a chunk of rows, and the run of
    input lines ``adjoint_lines`` gives holds every line the chunk reads."""
    kernel, stride, pad, _ = geometry
    g = torch.Generator().manual_seed(23)
    shape = (2, *spatial_sizes(kernel, pad, short), channels)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    n_rows = pk.conv_patches_plain(x, kernel, stride, pad, mode).shape[0]
    for row0, rows in ((0, n_rows), (n_rows // 3, n_rows // 2 + 1),
                       (n_rows - 1, 1)):
        patches = pk.conv_patches_plain(x, kernel, stride, pad, mode, row0,
                                        rows)
        gp = torch.randn(patches.shape, generator=g, dtype=torch.float64)
        adj = pk.conv_patches_adjoint_plain(gp, shape, kernel, stride, pad,
                                            mode, row0)
        lhs, rhs = (patches * gp).sum(), (x * adj).sum()
        assert abs(lhs - rhs) <= 1e-12 * (patches.abs() * gp.abs()).sum()
        out = torch.ones(shape, dtype=torch.float64)
        pk.conv_patches_adjoint(gp, out, kernel, stride, pad, mode, row0,
                                accumulate=True)
        assert torch.equal(out, adj + 1)
        read = adj.abs().flatten(0, -3).sum((1, 2)).nonzero().flatten()
        first, count = pk.adjoint_lines(shape, kernel, stride, pad, mode,
                                        row0, rows)
        assert first <= int(read.min()) and int(read.max()) < first + count


def test_patch_conv_gradcheck():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 4, 5, 3, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(2, 3, 3, 3, generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(2, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *t: layers.PatchConv.apply(*t, (2, 1), (1, 1), "reflect"),
        (x, w, b))


PATCH_CALL = dict(device_type="cuda", dtype=torch.float32, cudnn_tf32=False,
                  matmul_tf32=False, trains_weight=False)


@pytest.mark.parametrize("change,route", [
    ({}, "patch"),
    ({"device_type": "cpu"}, "cudnn"),
    ({"device_type": "meta"}, "cudnn"),
    ({"dtype": torch.bfloat16}, "cudnn"),
    ({"dtype": torch.float16}, "cudnn"),
    ({"dtype": torch.float64}, "cudnn"),
    ({"cudnn_tf32": True}, "cudnn"),
    ({"matmul_tf32": True}, "cudnn"),
    ({"cudnn_tf32": True, "matmul_tf32": True}, "cudnn"),
    ({"trains_weight": True}, "cudnn"),
])
def test_conv_route(change, route):
    assert layers.conv_route(**{**PATCH_CALL, **change}) == route


@pytest.fixture
def cpu_as_card(monkeypatch):
    """conv_route as it decides for the card, asked for CPU tensors, with
    both TF32 flags off (restored after)."""
    real = layers.conv_route
    monkeypatch.setattr(layers, "conv_route",
                        lambda device, *a: real("cuda", *a))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.mark.parametrize("grad_mode", ["frozen", "no_grad", "inference",
                                       "trained", "bfloat16", "tf32"])
def test_the_route_by_grad_mode(cpu_as_card, grad_mode):
    """A frozen conv in a grad-enabled call (its input needs a gradient), a
    no_grad and an inference call take the patch route; a trained conv's
    grad-enabled call and bfloat16 and TF32 calls cuDNN. A backward on the
    patch route counts once on ``patch_backward`` and gives the cudnn
    route's input gradient."""
    torch.manual_seed(0)
    module = layers.Conv3d(6, 16, (3, 4, 4), (1, 2, 2), 1, "reflect")
    if grad_mode == "frozen":
        module.requires_grad_(False)
    x = torch.randn(2, 3, 6, 7, 6, generator=torch.Generator().manual_seed(4),
                    requires_grad=True)
    if grad_mode == "bfloat16":
        layers.use_compute_dtype(module, torch.bfloat16)
    if grad_mode == "tf32":
        torch.backends.cudnn.allow_tf32 = True
    ctx = {"no_grad": torch.no_grad(),
           "inference": torch.inference_mode()}.get(grad_mode,
                                                    torch.enable_grad())
    before = dict(layers.CONV_CALLS)
    with ctx:
        y = module(x)
    routed = {k: layers.CONV_CALLS[k] - before[k] for k in before}
    want = ("patch" if grad_mode in ("frozen", "no_grad", "inference")
            else "cudnn")
    assert routed == {**dict.fromkeys(before, 0), want: 1}
    assert y.requires_grad == (grad_mode not in ("no_grad", "inference"))
    if grad_mode == "frozen":
        gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
        got, = torch.autograd.grad((y * gy).sum(), [x])
        assert layers.CONV_CALLS["patch_backward"] == before[
            "patch_backward"] + 1
        ref = reference_conv(x, module.weight, module.bias, module.stride,
                             module.pad, module.pad_mode)
        want_g, = torch.autograd.grad((ref * gy).sum(), [x])
        torch.testing.assert_close(got, want_g, rtol=1e-4, atol=1e-4)


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


@pytest.mark.cuda
def test_adjoint_kernel_on_the_card():
    """Every geometry, mode and move width: the adjoint kernel against its
    plain version within float32 rounding on the first chunk (written) and
    the last (added into what the first wrote), with its launch count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/patches.cu runs only there")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(13)
    for (kernel, stride, pad, _), short, c in CASES:
        for channels in (c, 34, 64):
            shape = (3, *spatial_sizes(kernel, pad, short), channels)
            n_rows = pk._geometry(shape, kernel, stride, pad)[4]
            k_all = channels * torch.Size(kernel).numel()
            for mode in MODES:
                gp = torch.randn(n_rows, k_all, generator=g)
                cut = n_rows // 3 + 1
                want = pk.conv_patches_adjoint_plain(
                    gp[:cut], shape, kernel, stride, pad, mode)
                out = torch.full(shape, float("nan"), device=dev)
                before = pk.CONV_PATCHES_ADJOINT.launches
                pk.conv_patches_adjoint(gp[:cut].to(dev), out, kernel,
                                        stride, pad, mode)
                assert pk.CONV_PATCHES_ADJOINT.launches == before + 1
                torch.testing.assert_close(out.cpu(), want, rtol=1e-5,
                                           atol=1e-5)
                want = want + pk.conv_patches_adjoint_plain(
                    gp[cut:], shape, kernel, stride, pad, mode, cut)
                pk.conv_patches_adjoint(gp[cut:].to(dev), out, kernel,
                                        stride, pad, mode, cut,
                                        accumulate=True)
                torch.testing.assert_close(out.cpu(), want, rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("module", [
    layers.Conv(34, 32, 3, 1, 1, "reflect"),
    layers.Conv(3, 32, 7, 1, 3, "reflect"),
    layers.Conv3d(34, 32, 3, 1, 1, "reflect"),
])
def test_patch_backward_on_the_card(monkeypatch, module):
    """On the card, float32 with TF32 off: PatchConv's input, weight and
    bias gradients repeat bit for bit over two backwards of the same inputs
    (chunked: the budget splits the images) and agree with cuDNN's; a
    grad-enabled call counts on ``cudnn`` where the weights train, else on
    ``patch`` and, in its backward, ``patch_backward``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/patches.cu runs only there")
    dev = torch.device("cuda")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(layers, "TRAIN_PATCH_BYTES", 4 << 20)
    module = module.to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (4, *([5] * (module.weight.dim() - 4)), 64, 96,
             module.in_channels)
    x = torch.randn(shape, generator=g, device=dev, requires_grad=True)
    operands = [x, module.weight, module.bias]
    grads = []
    for _ in range(2):
        launches = pk.CONV_PATCHES_ADJOINT.launches
        y = layers.PatchConv.apply(*operands, module.stride, module.pad,
                                   module.pad_mode)
        grads.append(torch.autograd.grad(y.sum(), operands))
        assert pk.CONV_PATCHES_ADJOINT.launches > launches + 1
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    ref = reference_conv(*operands, module.stride, module.pad,
                         module.pad_mode)
    want = torch.autograd.grad(ref.sum(), operands)
    for a, e in zip(grads[0], want):
        err = float((a - e).abs().max() / e.abs().max())
        assert err <= 1e-4, err
    for trains in (True, False):
        module.requires_grad_(trains)
        before = dict(layers.CONV_CALLS)
        torch.autograd.grad(module(x).sum(), [x])
        routed = {k: layers.CONV_CALLS[k] - before[k] for k in before}
        assert routed == ({"patch": 0, "cudnn": 1, "patch_backward": 0}
                          if trains else
                          {"patch": 1, "cudnn": 0, "patch_backward": 1})
