"""c2m_tpu_torch — the PyTorch + CUDA port of c2m_tpu for NVIDIA Hopper.

The JAX package ``c2m_tpu`` stays the reference. This package mirrors its
file layout (``ops/warp.py``, ``models/c2m.py``, ...) and runs in PyTorch;
every Pallas kernel on the ported path becomes a hand-written CUDA kernel
under ``csrc/``, built with nvcc at first use and bound with ctypes
(``ops/hopper``). A tensor on the CPU takes each kernel's plain PyTorch
version; a CUDA tensor launches the kernel or raises.

Ported so far: the serving path (``C2MGenerator.inference`` behind
``serving.ServingModel``, and ``serving.export_artifact``), the train step
(``train.state``, ``train.step`` around ``train.model.C2MTrainModel``), and
the program around it: ``data`` (datasets, loader), ``train.trainer``,
``utils.checkpoint``, ``eval.evaluator``, with ``train_torch.py`` and
``eval_torch.py`` at the repository's root. Public functions take
channels-last tensors (``[B, H, W, C]``, ``[B, T, H, W, C]``), as the JAX
package does. Entry points run on the card unless asked for the CPU.

This package imports nothing of JAX and nothing of ``c2m_tpu``: it keeps its
own copies of the framework-free parts it needs (``config.py``, ``data/``,
the visual output in ``utils/``, the metric math in ``eval/``), and tests
hold the copies to the originals.
"""

__version__ = "0.1.0"
