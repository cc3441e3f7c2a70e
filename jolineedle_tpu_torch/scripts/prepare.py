"""LARD dataset preparation: CSVs -> bbox txt files + train/test link lists.

A copy of ``scripts/prepare.py`` (it imports neither package), so that the
port's package holds every script a user runs.

Same pipeline as the reference prep script (reference:
scripts/prepare.py:1-122): read the LARD CSVs (runway corner coordinates),
convert each quad to its enclosing xyxy box, drop images that do not exist
on disk and boxes larger than 448px, write one bbox file per image with a
fictitious class 0, and emit ``train.txt``/``test.txt`` link lists
(``image_path bbox_path`` per line — the dataset format consumed by
data/dataset.py).

Usage: python -m jolineedle_tpu_torch.scripts.prepare --dataset-path /path/to/LARD
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path


def read_lard_csv(csv_path: Path) -> list:
    """[(image_path, [x1, y1, x2, y2]), ...] from a LARD csv (';' separated,
    columns image + corner coords x_A..y_D, reference: scripts/prepare.py:6-22)."""
    rows = []
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f, delimiter=";")
        for rec in reader:
            xs = [float(rec[k]) for k in ("x_A", "x_B", "x_C", "x_D")]
            ys = [float(rec[k]) for k in ("y_A", "y_B", "y_C", "y_D")]
            filepath = csv_path.parent / rec["image"]
            rows.append((filepath, [min(xs), min(ys), max(xs), max(ys)]))
    return rows


def remove_nonexistent(bboxes: list) -> list:
    existent = [(p, b) for p, b in bboxes if p.exists()]
    removed = len(bboxes) - len(existent)
    if removed:
        print(
            f"Removed {removed} ({removed / len(bboxes) * 100:.2f}%) "
            "non-existent images."
        )
    return existent


def remove_big(bboxes: list, max_size: int) -> list:
    """Drop boxes that would not fit in one patch (reference:
    scripts/prepare.py:40-52)."""
    small = [
        (p, b)
        for p, b in bboxes
        if b[2] - b[0] < max_size and b[3] - b[1] < max_size
    ]
    removed = len(bboxes) - len(small)
    if removed:
        print(
            f"Removed {removed} ({removed / len(bboxes) * 100:.2f}%) "
            "big bounding boxes."
        )
    return small


def prepare(bboxes: list, link_file: Path, bboxes_dir: Path) -> None:
    bboxes_dir.mkdir(parents=True, exist_ok=True)
    links = []
    for filepath, bbox in bboxes:
        bbox_path = (bboxes_dir / filepath.name).with_suffix(".txt")
        links.append(f"{filepath.absolute()} {bbox_path.absolute()}")
        # Fictitious class 0 (reference: scripts/prepare.py:64-67).
        with open(bbox_path, "w") as f:
            f.write(" ".join(["0"] + [str(int(round(x))) for x in bbox]))
    with open(link_file, "w") as f:
        f.write("\n".join(links))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--dataset-path", type=str, required=True,
        help="Path to the LARD dataset directory",
    )
    parser.add_argument("--max-box-size", type=int, default=448)
    args = parser.parse_args()

    dataset_path = Path(args.dataset_path)
    if not dataset_path.exists():
        raise FileNotFoundError(f"Directory {dataset_path} does not exist.")

    train_csv = dataset_path / "LARD_train.csv"
    test_csvs = [
        dataset_path / "LARD_test_synth/LARD_test_synth.csv",
        dataset_path
        / "LARD_test_real/LARD_test_real_nominal_cases"
        / "LARD_test_real_nominal_cases.csv",
        dataset_path
        / "LARD_test_real/LARD_test_real_domain_adaptation"
        / "LARD_test_real_domain_adaptation.csv",
    ]

    train = read_lard_csv(train_csv)
    test = []
    for csv_path in test_csvs:
        test.extend(read_lard_csv(csv_path))

    train = remove_big(remove_nonexistent(train), args.max_box_size)
    print(f"train: {len(train)}")
    test = remove_big(remove_nonexistent(test), args.max_box_size)
    print(f"test: {len(test)}")

    prepare(train, dataset_path / "train.txt", dataset_path / "train_bboxes")
    prepare(test, dataset_path / "test.txt", dataset_path / "test_bboxes")
    print("OK")


if __name__ == "__main__":
    main()
