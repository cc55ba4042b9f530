"""Dataset registry.

Capability parity with the reference registry (reference
utils/dataset_config.py:19-46) but as a typed, extensible structure: datasets
are registered as ``DatasetMeta`` records and can be added at runtime
(``register_dataset``) or via the same dict shape the reference used.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    """Per-dataset metadata (reference utils/dataset_config.py:2-16)."""

    name: str
    num_classes: int
    train_list_name: str = "train.txt"
    val_list_name: str = "val.txt"
    test_list_name: Optional[str] = None
    filename_separator: str = " "
    image_tmpl: str = "{:05d}.jpg"
    filter_video: int = 0
    label_file: Optional[str] = None


DATASET_CONFIG: Dict[str, DatasetMeta] = {}


def register_dataset(meta: DatasetMeta) -> DatasetMeta:
    DATASET_CONFIG[meta.name] = meta
    return meta


# The single dataset shipped by the reference (utils/dataset_config.py:19-29).
register_dataset(
    DatasetMeta(
        name="kinetics-sounds",
        num_classes=31,
        train_list_name="train.txt",
        val_list_name="val.txt",
        filename_separator=";",
        image_tmpl="{:05d}.jpg",
        filter_video=0,
        label_file="categories.txt",
    )
)

# Synthetic dataset used by tests/benchmarks: data is generated on the fly.
register_dataset(
    DatasetMeta(
        name="synthetic",
        num_classes=31,
        filename_separator=";",
    )
)

# Kinetics-400 (Kay et al., 2017), the dataset of the port's 3D model,
# SlowFast: the TSN-style frame folders of a video's JPEGs, one list line a
# video (folder, first frame, last frame, label)
register_dataset(
    DatasetMeta(
        name="kinetics400",
        num_classes=400,
        train_list_name="train.txt",
        val_list_name="val.txt",
        filename_separator=" ",
        image_tmpl="{:05d}.jpg",
        filter_video=0,
    )
)


def get_dataset_config(name: str) -> DatasetMeta:
    """Look up a dataset (reference utils/dataset_config.py:32-46)."""
    try:
        return DATASET_CONFIG[name]
    except KeyError:
        raise KeyError(
            f"unknown dataset {name!r}; registered: {sorted(DATASET_CONFIG)}"
        ) from None
