"""Seeding helpers for deep nets with random weights, shared by the CPU
parity tests (tests/test_torch_panoptic.py, tests/test_torch_siamrpn.py,
tests/torch_metric_fixtures.py) and by ``chip_smoke.py``, which loads this
file by its path on a machine without JAX. Torch only.

Random kernels alone shrink the activations layer by layer until the biases
are all that is left; ``calibrate_bn_`` keeps them of order 1 through the
depth. Random residual branches of unit scale amplify float32 rounding
layer after layer; ``damp_residuals_`` keeps them small, as trained ResNets
do.
"""

import torch


def calibrate_bn_(net: torch.nn.Module, x) -> None:
    """Each BatchNorm's running mean and (biased) variance := those of its
    input over one forward of ``x``, layer after layer, so that the
    activations stay of order 1 through the depth (random kernels alone
    shrink them until the biases are all that is left)."""
    def hook(mod, args):
        a = args[0]
        dims = [d for d in range(a.dim()) if d != 1]
        mod.running_mean.copy_(a.mean(dims))
        mod.running_var.copy_(a.var(dims, unbiased=False))
    handles = [m.register_forward_pre_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in handles:
            h.remove()


class Pair(torch.nn.Module):
    """``net(pair)`` -> ``net.inner(*pair)``: lets ``calibrate_bn_`` run a
    two-input net (SiamRPN++'s template and search) in one forward."""

    def __init__(self, inner: torch.nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, pair):
        return self.inner(*pair)


def damp_residuals_(net: torch.nn.Module, scale: float = 0.25) -> None:
    """The last BatchNorm scale of every residual branch times ``scale``:
    ``bn3`` of SiamRPN++'s and HRNet's bottlenecks, ``bn2`` of HRNet's
    basic blocks. With unit residual branches these random deep nets
    amplify float32 rounding layer after layer, in the JAX package and the
    port alike: a tracker then carries it over frames into its boxes, and
    two devices, or two packages, part by more than their 1e-4 gates.
    Trained ResNets keep their residual branches small (torchvision's
    ``zero_init_residual``)."""
    from c2m_tpu_torch.models import panoptic_deeplab, siamrpn
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (siamrpn.Bottleneck,
                                panoptic_deeplab.BottleneckBlock)):
                mod.bn3.weight.mul_(scale)
            elif isinstance(mod, panoptic_deeplab.BasicBlock):
                mod.bn2.weight.mul_(scale)
