"""Video list parsing (the port's copy of ``adamml_tpu/data/records.py``).

Same list format and semantics as the reference loader (reference
utils/video_dataset.py:236-358): each line is
`path<sep>start_frame<sep>end_frame<sep>label[...labels]`; multi-label lists
are auto-detected when the mean field count exceeds 4; videos shorter than
`filter_video` frames are dropped (unless test mode); rgbdiff datasets lose
their final frame (the diff needs idx+1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple, Union

import numpy as np


@dataclasses.dataclass
class VideoRecord:
    """reference utils/video_dataset.py:236-250"""

    path: str
    start_frame: int
    end_frame: int
    label: Union[int, List[float], str]

    @property
    def video_id(self) -> str:
        return os.path.basename(self.path)

    @property
    def num_frames(self) -> int:
        return self.end_frame - self.start_frame + 1


def parse_list_file(list_file: str, separator: str = " ",
                    filter_video: int = 0, test_mode: bool = False,
                    modality: str = "rgb"
                    ) -> Tuple[List[VideoRecord], bool]:
    """Returns (records, multi_label)."""
    rows = []
    with open(list_file) as f:
        for line in f:
            elements = line.strip().split(separator)
            if not elements or elements[0] == "":
                continue
            start_frame, end_frame = int(elements[1]), int(elements[2])
            if test_mode or end_frame - start_frame + 1 >= filter_video:
                rows.append(elements)
    if not rows:
        raise ValueError(f"empty video list: {list_file}")
    multi_label = bool(np.mean([len(r) for r in rows]) > 4.0)

    records: List[VideoRecord] = []
    for item in rows:
        if test_mode:
            records.append(VideoRecord(item[0], int(item[1]), int(item[2]),
                                       -1))
            continue
        labels = [float(x) for x in item[3:]]
        label = labels if multi_label else int(labels[0])
        records.append(VideoRecord(item[0], int(item[1]), int(item[2]), label))

    if modality == "rgbdiff":
        # diff at the last frame would need a frame past the end
        # (reference utils/video_dataset.py:354-356)
        for r in records:
            r.end_frame -= 1
    return records, multi_label
