"""The port's preprocessing and scoring CLIs, each run as
``python -m c2m_tpu_torch.tools.<name>`` from the repository root:

- ``generate_segmentation``: Panoptic-DeepLab semantic and instance maps;
- ``generate_trajectories``: SiamRPN++ tracks matched to the instances;
- ``precompute_flow``: FlowNet2 flows and occlusions of every clip;
- ``evaluate_cityscapes``: the Cityscapes pixel- and instance-level scores;
- ``convert_c2m``: a reference ``latest_c2m_model.pth.tar`` into a job dir;
- ``export_serving``: a job dir into a serving artifact;
- ``make_synthetic_dataset``: a synthetic dataset tree on disk;
- ``prepare_gt_labels``: Cityscapes label / instance PNGs from the gtFine
  polygon JSON;
- ``kitti2cityscapes_semantic``: KITTI-360 rasters to Cityscapes trainIds.

Each is the port of the tool of the same name in ``tools/`` and writes the
same files. Models, nets and the rasterizer run on the card unless
``--device cpu`` is given; ``prepare_gt_labels`` and
``kitti2cityscapes_semantic`` do host work only and take ``--device`` as
the others do.

:func:`write_instance_png` writes every instance map these tools write.
"""

import numpy as np
from PIL import Image


def write_instance_png(path, inst) -> None:
    """An integer instance map as a 16-bit grayscale PNG: the bytes the JAX
    tools' ``Image.fromarray(inst, mode="I")`` writes (Pillow stores an
    ``I`` image in PNG as 16 bits), without that mode: Pillow 12 warns that
    both the ``mode`` argument and saving ``I`` images as PNG go in Pillow
    13. ValueError when an id does not fit in 16 bits."""
    inst = np.asarray(inst)
    if inst.size and (inst.min() < 0 or inst.max() > np.iinfo(np.uint16).max):
        raise ValueError(f"instance ids outside 16 bits: {inst.min()}.."
                         f"{inst.max()}")
    Image.fromarray(inst.astype(np.uint16)).save(path)
