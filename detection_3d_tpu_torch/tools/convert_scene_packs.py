"""Write buildings as scene packs, the files the C++ loader streams.

    python -m detection_3d_tpu_torch.tools.convert_scene_packs --out DIR \
        [--synthetic N | --data-root ROOT --split S] [--voxel-scale 50]

Counterpart of the JAX package's tools/convert_scene_packs.py, through
the port's own data/suncg.py and data/synthetic.py: ``--synthetic N``
writes N generated buildings as ``syn_00000.spk``.. (byte for byte the
JAX tool's files), otherwise every house of the reference-format SUNCG
split under ``--data-root`` (default $SUNCG_TORCH_PATH) as
``{split}_000000.spk``... (data/scene_pack.py holds the format; train
over the files with data/native_loader.NativeSceneLoader).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def convert(out: str, synthetic: int = 0, data_root: str = "",
            split: str = "train", voxel_scale: int = 50) -> int:
    """Write the packs into ``out``; returns how many."""
    from detection_3d_tpu_torch.data.scene_pack import write_scene_pack
    os.makedirs(out, exist_ok=True)
    if synthetic:
        from detection_3d_tpu_torch.data.synthetic import synthetic_building
        for i in range(synthetic):
            write_scene_pack(os.path.join(out, f"syn_{i:05d}.spk"),
                             synthetic_building(seed=i,
                                                voxel_scale=voxel_scale))
        return synthetic
    from detection_3d_tpu_torch.config import Config
    from detection_3d_tpu_torch.data.suncg import SUNCGDataset
    ds = SUNCGDataset(split, Config(), data_root=data_root)
    for i in range(len(ds)):
        scene = {k: np.asarray(v) for k, v in ds[i].items()
                 if isinstance(v, np.ndarray)}
        write_scene_pack(os.path.join(out, f"{split}_{i:06d}.spk"), scene)
    return len(ds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--data-root", default=os.environ.get(
        "SUNCG_TORCH_PATH", ""))
    ap.add_argument("--split", default="train")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="N generated buildings instead of SUNCG houses")
    ap.add_argument("--voxel-scale", type=int, default=50,
                    help="voxels per metre of the generated buildings")
    args = ap.parse_args(argv)
    n = convert(args.out, args.synthetic, args.data_root, args.split,
                args.voxel_scale)
    print(f"wrote {n} scene packs to {args.out}")


if __name__ == "__main__":
    main()
