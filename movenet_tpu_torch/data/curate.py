"""Dataset curation CLI (reference: curate_kinetics.py:19-45); the
counterpart of ``movenet_tpu.data.curate``.

Copies a YAML-described subset of clips into a new dataset tree:

    python -m movenet_tpu_torch.data.curate SRC DST \
        --curation-metadata-fp m.yaml

YAML layout:  {split: {category: [video_id, ...]}}
Clip ids may omit the extension; any supported container found under
the source directory is copied.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from movenet_tpu_torch.data.dataset import SUPPORTED_SUFFIXES


def copy_file(src: Path, dst: Path) -> None:
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src, dst)


def curate(dataset_fp: Path, output_fp: Path, metadata_fp: Path) -> int:
    import yaml

    with Path(metadata_fp).open() as fh:
        metadata = yaml.safe_load(fh)

    copied = 0
    for split, categories in metadata.items():
        for category, video_ids in categories.items():
            src_dir = Path(dataset_fp) / split / category
            dst_dir = Path(output_fp) / split / category
            for vid in video_ids:
                candidates = [src_dir / vid] + [
                    (src_dir / vid).with_suffix(sfx)
                    for sfx in SUPPORTED_SUFFIXES
                ]
                src = next((c for c in candidates if c.exists()), None)
                if src is None:
                    print(f"missing clip: {src_dir / vid}")
                    continue
                copy_file(src, dst_dir / src.name)
                copied += 1
    return copied


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset_fp", type=Path)
    parser.add_argument("output_dataset_fp", type=Path)
    parser.add_argument("--curation-metadata-fp", type=Path, required=True)
    args = parser.parse_args(argv)
    print("Curating dataset")
    n = curate(args.dataset_fp, args.output_dataset_fp,
               args.curation_metadata_fp)
    print(f"Done ({n} clips)")


if __name__ == "__main__":
    main()
