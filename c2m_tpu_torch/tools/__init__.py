"""The port's preprocessing and scoring CLIs, each run as
``python -m c2m_tpu_torch.tools.<name>`` from the repository root:

- ``generate_segmentation``: Panoptic-DeepLab semantic and instance maps;
- ``generate_trajectories``: SiamRPN++ tracks matched to the instances;
- ``precompute_flow``: FlowNet2 flows and occlusions of every clip;
- ``evaluate_cityscapes``: the Cityscapes pixel- and instance-level scores.

Each is the port of the tool of the same name in ``tools/`` and writes the
same files. The nets run on the card unless ``--device cpu`` is given.
"""
