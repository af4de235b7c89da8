"""Genome window table: [start, end) site-index pairs per window.

Reference parity: Window.from_file (src/dataset/dataset.py:120-165) — a CSV
with start/end columns defining <=1020-site chunks of the chromosome — plus
the fixed-stride inference chunking (InferDataset, dataset.py:699-702) and a
generator for synthetic/new chromosomes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .vocab import INFER_WINDOW_LEN


@dataclasses.dataclass
class Window:
    window_info: np.ndarray  # [n_windows, 2] int (start, end) site indices

    @classmethod
    def from_file(cls, path: str) -> "Window":
        """Load a window CSV.  Accepts the reference layout (header row,
        first two numeric columns are start/end)."""
        rows = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = [p.strip() for p in line.strip().split(",") if p != ""]
                nums = []
                for p in parts:
                    try:
                        nums.append(int(float(p)))
                    except ValueError:
                        nums = []
                        break
                if len(nums) >= 2:
                    rows.append(nums[:2])
        info = np.asarray(rows, dtype=np.int64).reshape(-1, 2)
        return cls(window_info=info)

    @classmethod
    def fixed_stride(cls, n_sites: int,
                     window_len: int = INFER_WINDOW_LEN) -> "Window":
        """Non-overlapping fixed-length windows covering n_sites (the
        inference chunking; the tail window is shorter)."""
        starts = np.arange(0, n_sites, window_len, dtype=np.int64)
        ends = np.minimum(starts + window_len, n_sites)
        return cls(window_info=np.stack([starts, ends], axis=1))

    @property
    def count(self) -> int:
        return self.window_info.shape[0]

    def bounds(self, w: int) -> tuple[int, int]:
        return int(self.window_info[w, 0]), int(self.window_info[w, 1])

    def length(self, w: int) -> int:
        s, e = self.bounds(w)
        return e - s

    def save_csv(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("start,end\n")
            for s, e in self.window_info:
                f.write(f"{s},{e}\n")
