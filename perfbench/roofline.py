"""The least time the card could take for one launch of each hand-written
kernel, from the launch's shapes, and the card's published peaks.

Frozen from ``chip_smoke.py`` at commit ef9a2dc: ``HBM_BYTES_PER_S``,
``FP32_FLOPS``, ``bound`` and ``nbytes`` (lines 282-366), ``k2_pairs`` and
``k2_bound`` (lines 989-1011), and the bytes and operations of K1 forward,
K1 backward and K4 that ``phase_kernels`` counts (lines 560-565, 665-672,
839). Each input byte is read once and each output byte written once; K2's
and K3's operations count the (pixel, node) pairs the winner function
needs, from a winner map that the caller takes from the plain reference,
never from the port's output. K3 computes K2's function on larger maps and
is held to the same bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12       # float32 outside the tensor cores: all these kernels
TF32_FLOPS = 494.7e12    # dense TF32 tensor-core peak
BF16_FLOPS = 989e12      # dense bfloat16 tensor-core peak


def peak_flops(dtype: str, allow_tf32: bool = False) -> float:
    """The peak a whole step's share is taken against: that of the
    precision the configuration states for its convolutions and matmuls."""
    if dtype == "bfloat16":
        return BF16_FLOPS
    return TF32_FLOPS if allow_tf32 else FP32_FLOPS

ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    float32 operations over the CUDA-core peak, whichever is larger."""
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {"bound_ms": max(by, op),
            "bound_by": "bytes" if by >= op else "operations"}


def k1_forward(dtype: str, b: int, h: int, w: int, c: int, frames: int = 1,
               masked: bool = False) -> dict:
    """K1 forward writing [b, h, w, c] from an image of b / frames rows, a
    float32 flow [b, h, w, 2] and, when masked, a float32 mask
    [b, h, w, 1]: per output pixel 16 operations, per output value 10."""
    e = ELEMENT_BYTES[dtype]
    pix, n = b * h * w, b * h * w * c
    moved = (b // frames) * h * w * c * e + pix * 8 + (pix * 4 if masked
                                                      else 0) + n * e
    return bound(moved, 16 * pix + 10 * n)


def k1_backward(dtype: str, b: int, h: int, w: int, c: int, frames: int,
                masked: bool, need_image: bool, need_flow: bool,
                need_mask: bool) -> dict:
    """K1 backward: the output gradient, flow and mask read; the image read
    when the flow or mask gradient needs its taps; each gradient asked for
    written once. Per output pixel 16 operations, per value 25."""
    e = ELEMENT_BYTES[dtype]
    pix, n = b * h * w, b * h * w * c
    image = (b // frames) * h * w * c * e
    flow, mask = pix * 8, (pix * 4 if masked else 0)
    need_taps = need_flow or need_mask
    moved = (n * e + flow + mask + (image if need_taps else 0)
             + (image if need_image else 0) + (flow if need_flow else 0)
             + (mask if need_mask else 0))
    return bound(moved, 16 * pix + 25 * n)


def k2_pairs(valid, winner) -> int:
    """The (pixel, node) pairs the winner function needs when the valid
    nodes are visited last to first: a pixel won by node k visits the valid
    nodes from the last down to k; a background pixel visits them all.
    valid [B, N] bool, winner [B, T, H, W] (0 = background)."""
    b, n = valid.shape
    # after[b, k] = valid nodes with index >= k; after[b, 0] = all of them
    after = valid.flip(1).long().cumsum(1).flip(1)
    start = (winner.long() - 1).clamp(min=0).reshape(b, -1)
    return int(after.gather(1, start).sum().item())


def k2(b: int, n: int, t: int, h: int, w: int, pairs: int) -> dict:
    """K2 (and K3) on [b, h, w] instance maps, [b, n] ids and valid flags,
    [b, n, t, 6] thetas: per output pixel 6 operations for its base
    coordinates, ~30 per (pixel, node) pair needed. Bytes: inputs read,
    the int32 winner [b, t, h, w] written."""
    moved = b * h * w * 4 + b * n * 4 + b * n + b * n * t * 6 * 4 \
        + 4 * b * t * h * w
    return bound(moved, 6 * b * t * h * w + 30 * pairs)


def k4(b: int, h: int, w: int) -> dict:
    """K4: float32 coordinates [b, h, w, 2] read, masses [b, h, w, 1]
    written, 14 operations a point."""
    return bound(b * h * w * 12, 14 * b * h * w)
