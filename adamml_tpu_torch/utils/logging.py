"""The port's copy of ``adamml_tpu/utils/logging.py``. Rank-0 logging mirrored to a log file (reference train_adamml.py:198-201,
283, 314-318: stdout prints duplicated into logdir/<arch_name>/log.log with
timestamped backup of pre-existing logs)."""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional, TextIO


class RankZeroLogger:
    def __init__(self, log_folder: str, rank: int = 0, filename: str = "log.log",
                 append: bool = False) -> None:
        self.rank = rank
        self._fh: Optional[TextIO] = None
        if rank == 0 and log_folder:
            os.makedirs(log_folder, exist_ok=True)
            path = os.path.join(log_folder, filename)
            if os.path.exists(path) and not append:
                # timestamped backup (reference train_adamml.py:314-316)
                shutil.copyfile(path, path + ".{}".format(int(time.time())))
            self._fh = open(path, "a" if append else "w")

    def log(self, msg: str) -> None:
        if self.rank != 0:
            return
        print(msg, flush=True)
        if self._fh is not None:
            print(msg, file=self._fh, flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "RankZeroLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
