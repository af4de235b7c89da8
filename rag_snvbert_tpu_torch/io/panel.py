"""Panel (population-label) files and sample splits.

Reference parity:
  - PanelData.from_file (src/dataset/dataset.py:38-116): tab-separated
    ``.panel``/``.txt`` with a header; columns [sample, pop, super_pop, ...];
    builds sample->pop list and pop->class dict, and side-writes POP.json
    (we make that an explicit method instead of an import-time side effect).
  - PanelProcessingModule.split_dataset (src/dataset/utils.py:40-77):
    population-stratified train/test sample split.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class PanelData:
    samples: list[str]
    pop_list: list[str]          # per-sample population label
    pop_to_class: dict[str, int]

    @classmethod
    def from_file(cls, path: str) -> "PanelData":
        samples, pops = [], []
        with open(path, "r", encoding="utf-8") as f:
            header = f.readline()  # skip header row
            for line in f:
                parts = line.rstrip("\r\n").split("\t")
                if len(parts) < 2 or not parts[0]:
                    continue
                samples.append(parts[0])
                pops.append(parts[1])
        return cls.from_lists(samples, pops)

    @classmethod
    def from_lists(cls, samples: list[str], pops: list[str]) -> "PanelData":
        pop_to_class: dict[str, int] = {}
        for p in pops:
            if p not in pop_to_class:
                pop_to_class[p] = len(pop_to_class)
        return cls(samples=list(samples), pop_list=list(pops),
                   pop_to_class=pop_to_class)

    @property
    def n_samples(self) -> int:
        return len(self.samples)

    def save_pop_json(self, path: str = "POP.json") -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.pop_to_class, f, indent=4)

    def split_stratified(self, test_fraction: float = 0.2,
                         seed: int = 0) -> tuple[list[int], list[int]]:
        """Population-stratified train/test split of sample indices."""
        rng = np.random.default_rng(seed)
        train_idx: list[int] = []
        test_idx: list[int] = []
        pops = np.asarray(self.pop_list)
        for p in self.pop_to_class:
            idx = np.flatnonzero(pops == p)
            idx = rng.permutation(idx)
            n_test = int(round(len(idx) * test_fraction))
            test_idx.extend(idx[:n_test].tolist())
            train_idx.extend(idx[n_test:].tolist())
        return sorted(train_idx), sorted(test_idx)
