"""The port's copy of ``adamml_tpu/utils/logging.py``. Rank-0 logging mirrored to a log file (reference train_adamml.py:198-201,
283, 314-318: stdout prints duplicated into logdir/<arch_name>/log.log with
timestamped backup of pre-existing logs)."""

from __future__ import annotations

import os
import shutil
import sys
import time
from typing import Optional, TextIO


def _print_line(line: str) -> None:
    """``line`` and its newline to stdout in one write: under ``python -u``
    or PYTHONUNBUFFERED, ``print`` writes the two apart, and ranks that
    share a pipe then splice each other's lines together."""
    sys.stdout.write(f"{line}\n")
    sys.stdout.flush()


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

    def log(self, msg: str, every_rank: bool = False) -> None:
        """Print ``msg`` and write it to the log file on rank 0. With
        ``every_rank`` the other ranks print it too, prefixed with their
        rank (the summaries every rank computes, to compare them)."""
        if self.rank != 0:
            if every_rank:
                _print_line(f"[rank {self.rank}] {msg}")
            return
        _print_line(msg)
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
