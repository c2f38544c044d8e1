"""Convert KITTI-360 semantic / instance rasters to Cityscapes-trainId maps:
the port of ``tools/kitti2cityscapes_semantic.py``, with the port's label
table (``c2m_tpu_torch/data/labels.KITTI360_ID_TO_TRAINID``: ids 34-44
extend the Cityscapes ids, garage -> building (2), gate -> fence (4),
smallpole -> pole (5), the rest ignore). Writes the
``train_semantic_segmask/`` and ``train_instance/`` trees that
``tools/preprocess_images.py`` and the KITTI loader read.

Kept from the reference (src/kitti2cityscapes_semantic.py), as the JAX tool
keeps it:

- thing pixels (trainIds 11..18, the reference's hardcoded thing list)
  renumber as ``trainId * 1000 + (instance % (semantic_id * 1000))``: the
  modulo divisor is the semantic id, exact for KITTI-360's
  ``semanticId * 1000 + k`` instance encoding;
- other pixels write the bare trainId into the instance raster;
- ids absent from the table keep 0 in both outputs (the reference
  composites per-label masks onto zeros);
- the first path component under ``leftImg8bit_sequence`` is dropped on
  output: ``<seq>/<d1>/<d2>/<d3>/semantic/f.png`` ->
  ``<seq>/train_semantic_segmask/<d2>/<d3>/image_02/data/f.png``.

Two faults of the JAX tool are not copied:

- its ``convert_pair`` indexes 256-entry tables with the raw semantic id,
  so an id above 255 (a 16-bit semantic raster) raises IndexError; here
  such a pixel is an id absent from the table and stays 0 in both
  outputs, as the reference's per-label loop leaves it;
- it saves the instance map as a 32-bit ``I`` PNG, which Pillow
  deprecates; here it is written from a uint16 array (values reach at most
  18 * 1000 + 999 for KITTI-360's encoding, and are checked to fit), the
  same bytes.

  python -m c2m_tpu_torch.tools.kitti2cityscapes_semantic --root DIR
      [--glob '*/*/*/semantic/*.png'] [--out DIR] [--device cpu]

The conversion is a table lookup on the host and places nothing on a
device: ``--device`` accepts ``cpu`` alone, and refuses any other value.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from c2m_tpu_torch.data.labels import KITTI360_ID_TO_TRAINID
from c2m_tpu_torch.tools import write_instance_png

LABEL_DIVISOR = 1000
# the reference's hardcoded thing trainIds, not the has_instances column
THING_TRAINIDS = frozenset(range(11, 19))


def _luts():
    """(trainId LUT, is-thing LUT, modulo-divisor LUT) over semantic ids."""
    tid = np.zeros(256, np.uint8)          # unmapped ids keep 0
    thing = np.zeros(256, bool)
    div = np.ones(256, np.int64)
    for lid, t in KITTI360_ID_TO_TRAINID.items():
        tid[lid] = t
        if t in THING_TRAINIDS:
            thing[lid] = True
            div[lid] = lid * LABEL_DIVISOR
    return tid, thing, div


def convert_pair(semantic: np.ndarray, instance: np.ndarray):
    """One (semantic, instance) raster pair -> (trainId map, instance map),
    the vectorized form of the reference's per-label mask loop. Pixels whose
    semantic id is not in the table (any id above 255 among them) are 0 in
    both."""
    tid_lut, thing_lut, div_lut = _luts()
    sem = np.asarray(semantic)
    inst = np.asarray(instance).astype(np.int64)
    known = (sem >= 0) & (sem < tid_lut.size)
    idx = np.where(known, sem, 0).astype(np.intp)
    tid = np.where(known, tid_lut[idx], 0).astype(np.int32)
    new_sem = tid.astype(sem.dtype, copy=False)
    renum = (tid.astype(np.int64) * LABEL_DIVISOR
             + inst % div_lut[idx]).astype(np.int32)
    new_inst = np.where(known & thing_lut[idx], renum, tid)
    return new_sem, new_inst


def convert_tree(root: Path, glob: str, out: Path | None = None) -> int:
    from PIL import Image

    seq = root / "leftImg8bit_sequence"
    if not seq.is_dir():
        raise SystemExit(f"{seq} not found")
    out = out or seq
    files = sorted(seq.glob(glob))
    if not files:
        raise SystemExit(f"no semantic pngs under {seq}/{glob}")
    n = 0
    for sem_f in files:
        inst_f = Path(str(sem_f).replace("semantic", "instance"))
        rel = sem_f.relative_to(seq)
        # drop the first dir and the trailing 'semantic' dir (the
        # reference's path depth; see the module docstring)
        mid = rel.parts[1:-2]
        sem_dir = out / "train_semantic_segmask" / Path(*mid) / "image_02" / "data"
        inst_dir = out / "train_instance" / Path(*mid) / "image_02" / "data"
        sem_dir.mkdir(parents=True, exist_ok=True)
        inst_dir.mkdir(parents=True, exist_ok=True)
        semantic = np.array(Image.open(sem_f))
        instance = np.array(Image.open(inst_f))
        new_sem, new_inst = convert_pair(semantic, instance)
        Image.fromarray(new_sem).save(sem_dir / sem_f.name)
        write_instance_png(inst_dir / inst_f.name, new_inst)
        n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="dataset root containing leftImg8bit_sequence/")
    ap.add_argument("--glob", default="*/*/*/semantic/*.png",
                    help="semantic-png glob under leftImg8bit_sequence/")
    ap.add_argument("--out", default=None,
                    help="output base (default: leftImg8bit_sequence/)")
    ap.add_argument("--device", choices=["cpu"], default=None,
                    help="cpu or none: the tool places nothing on a device, "
                         "so any other value is refused")
    args = ap.parse_args(argv)
    n = convert_tree(Path(args.root), args.glob,
                     Path(args.out) if args.out else None)
    print(f"converted {n} semantic/instance pairs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
