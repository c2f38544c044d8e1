"""The benchmark's plain reference: a frozen copy of the port's model,
loss, state and step code (``c2m_tpu_torch`` at commit ef9a2dc), which
imports nothing of the port and launches no hand-written kernel.

What differs from the files it copies:
- imports point into ``perfbench.reference``;
- kernels K1, K2/K3 and K4 are their plain PyTorch versions
  (``ops/plain.py``) on every device; the rasterizer takes the plain
  winner at every map size, as K3 computes K2's function;
- ``mesh.py`` stands in for ``parallel/mesh.py``: one process, no group.
The benchmark runs it in float32 with TF32 off, with the weights it draws
from the seed for the port as well; its precision controls run it with
TF32 on, or with the conv stacks in bfloat16.
"""
