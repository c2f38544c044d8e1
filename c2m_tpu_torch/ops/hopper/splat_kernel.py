"""Kernel K4: forward bilinear splat (``corresponding_map``), no gradient.

Replaces the Pallas kernel ``_splat_call`` / ``_splat_kernel`` in
``c2m_tpu/ops/pallas/splat_kernel.py``. CUDA source: ``csrc/splat.cu``.

A CPU tensor takes :func:`corresponding_map_plain`; a CUDA tensor launches
the kernel or raises. The kernel gathers a tile's corners in shared memory
and flushes them once; :func:`corresponding_map_tiled_plain` is that
decomposition in plain PyTorch, for the CPU tests.
"""

from __future__ import annotations

import torch

from c2m_tpu_torch.ops import hopper

SPLAT = hopper.Kernel("corresponding_map", "c2m_tpu_torch/csrc/splat.cu",
                      "c2m_tpu/ops/pallas/splat_kernel.py:73")
KERNELS = (SPLAT,)

# the kernel's tile of source points (width, height) and the halo of its
# accumulator: TILE_W, TILE_H and HALO of csrc/splat.cu
TILE = (64, 32)
HALO = 8


def corresponding_map_plain(coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (reference ``get_corresponding_map``): every
    point adds unit mass to its 4 grid neighbours with bilinear weights;
    corners outside the image get weight 0. coords [B, H, W, 2] (x, y)
    pixels -> mass [B, H, W, 1]."""
    b, h, w, _ = coords.shape
    x = coords[..., 0].reshape(b, -1)
    y = coords[..., 1].reshape(b, -1)
    x_f = torch.floor(x)
    y_f = torch.floor(y)
    x_c = x_f + 1.0
    y_c = y_f + 1.0
    idx, val = [], []
    # corner order as the JAX scatter, so the summation order matches too
    for cx, cy in ((x_c, y_c), (x_c, y_f), (x_f, y_c), (x_f, y_f)):
        cxc = cx.clamp(0.0, w - 1.0)
        cyc = cy.clamp(0.0, h - 1.0)
        invalid = (cx != cxc) | (cy != cyc)
        wgt = (1.0 - (x - cxc).abs()) * (1.0 - (y - cyc).abs())
        val.append(torch.where(invalid, torch.zeros_like(wgt), wgt))
        # an invalid corner adds 0 at pixel 0 (a NaN coordinate has no index)
        idx.append(torch.where(invalid, torch.zeros_like(cxc),
                               cxc + cyc * w).long())
    idx = torch.cat(idx, dim=1)
    val = torch.cat(val, dim=1)
    out = torch.zeros(b, h * w, dtype=coords.dtype, device=coords.device)
    out.scatter_add_(1, idx, val)
    return out.reshape(b, h, w, 1)


def corresponding_map_tiled_plain(coords: torch.Tensor, tile=TILE,
                                  halo: int = HALO) -> torch.Tensor:
    """The kernel's decomposition in plain PyTorch. The grid of source
    points is cut into tiles of ``tile`` = (width, height); each tile owns an
    accumulator that covers it plus ``halo`` pixels on every side. A corner
    that lands inside its tile's accumulator is added there, any other
    straight to the output; then every accumulator is added to the output
    (its part inside the image). Same corners, weights and ``invalid`` rule
    as :func:`corresponding_map_plain`; only the order of the sums differs."""
    b, h, w, _ = coords.shape
    tw, th = tile
    aw, ah = tw + 2 * halo, th + 2 * halo
    nty, ntx = -(-h // th), -(-w // tw)
    dev = coords.device
    px = torch.arange(w, device=dev)[None, :].expand(h, w).reshape(-1)
    py = torch.arange(h, device=dev)[:, None].expand(h, w).reshape(-1)
    tile_id = (py // th) * ntx + px // tw               # [h*w]
    ox, oy = (px // tw) * tw - halo, (py // th) * th - halo
    x = coords[..., 0].reshape(b, -1)
    y = coords[..., 1].reshape(b, -1)
    x_f, y_f = torch.floor(x), torch.floor(y)
    x_c, y_c = x_f + 1.0, y_f + 1.0
    out = torch.zeros(b, h * w, dtype=coords.dtype, device=dev)
    acc = torch.zeros(b, nty * ntx * ah * aw, dtype=coords.dtype, device=dev)
    for cx, cy in ((x_c, y_c), (x_c, y_f), (x_f, y_c), (x_f, y_f)):
        cxc = cx.clamp(0.0, w - 1.0)
        cyc = cy.clamp(0.0, h - 1.0)
        valid = ~((cx != cxc) | (cy != cyc))
        wgt = (1.0 - (x - cxc).abs()) * (1.0 - (y - cyc).abs())
        # integer coordinates only where the corner is inside the image
        ix = torch.where(valid, cxc, torch.zeros_like(cxc)).long()
        iy = torch.where(valid, cyc, torch.zeros_like(cyc)).long()
        lx, ly = ix - ox, iy - oy
        inside = valid & (lx >= 0) & (lx < aw) & (ly >= 0) & (ly < ah)
        zero = torch.zeros_like(wgt)
        a_idx = torch.where(inside, (tile_id * ah + ly) * aw + lx,
                            torch.zeros_like(lx))
        acc.scatter_add_(1, a_idx, torch.where(inside, wgt, zero))
        out.scatter_add_(1, iy * w + ix,
                         torch.where(valid & ~inside, wgt, zero))
    # the flush: each accumulator entry onto the pixel it stands for
    acc = acc.reshape(b, nty, ntx, ah, aw)
    gy = (torch.arange(nty, device=dev)[:, None] * th - halo
          + torch.arange(ah, device=dev)[None, :])       # [nty, ah]
    gx = (torch.arange(ntx, device=dev)[:, None] * tw - halo
          + torch.arange(aw, device=dev)[None, :])       # [ntx, aw]
    in_img = (((gy >= 0) & (gy < h))[:, None, :, None]
              & ((gx >= 0) & (gx < w))[None, :, None, :])
    idx = (gy.clamp(0, h - 1)[:, None, :, None] * w
           + gx.clamp(0, w - 1)[None, :, None, :])
    out.scatter_add_(1, idx.reshape(1, -1).expand(b, -1),
                     torch.where(in_img, acc, torch.zeros_like(acc)
                                 ).reshape(b, -1))
    return out.reshape(b, h, w, 1)


def splat_route(shape, aligned: bool = True) -> str:
    """How the kernel flushes a tile's accumulator for coords of ``shape``
    [B, H, W, 2] on the card: ``float4`` (one 16-byte atomic per four
    neighbouring pixels) where W is a multiple of 4 and the output starts on
    a 16-byte boundary (``aligned``; a fresh tensor does), so that every
    group does too, else ``scalar``. ``c2m_splat`` makes this choice itself;
    this is its mirror for the tests. Both are the tile kernel of
    ``csrc/splat.cu``; never the plain version."""
    return "float4" if aligned and shape[2] % 4 == 0 else "scalar"


def _launch(coords: torch.Tensor) -> torch.Tensor:
    """The kernel on the card."""
    req = hopper.require
    req(coords.dim() == 4 and coords.shape[-1] == 2,
        lambda: f"coords must be [B,H,W,2], got {tuple(coords.shape)}")
    req(coords.dtype == torch.float32,
        lambda: f"coords dtype {coords.dtype} != float32")
    req(coords.is_contiguous(), "coords must be contiguous")
    b, h, w, _ = coords.shape
    req(h * w < 2 ** 30, lambda: f"an image of {h}x{w} is beyond the kernel's "
        f"32-bit offsets (H*W < 2^30)")
    out = torch.empty(b, h, w, 1, dtype=torch.float32, device=coords.device)
    if out.numel() == 0:
        return out
    err = hopper.library().c2m_splat(coords.data_ptr(), out.data_ptr(), b, h,
                                     w, hopper.stream_ptr(coords))
    hopper.check(err, "c2m_splat")
    SPLAT.launches += 1
    return out


def corresponding_map(coords: torch.Tensor) -> torch.Tensor:
    """Splat unit mass at float target coords [B, H, W, 2] onto the grid."""
    if coords.device.type == "cpu":
        return corresponding_map_plain(coords)
    if coords.device.type != "cuda":
        raise ValueError(f"corresponding_map: no kernel for {coords.device}")
    return _launch(coords)
