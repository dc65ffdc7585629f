"""Simulation history: accuracy against *virtual wallclock* and measured
cumulative bytes — the paper's Figs. 5-8 axes (cumulative upload time), which
a round-indexed history cannot produce.

Each record merges the engine's per-round metrics (losses, test accuracy)
with the scheduler's timing (round duration, cumulative virtual seconds,
participants, staleness) and the measured wire-byte ledger (per-leg uplink/
downlink bytes actually charged, cumulative).  JSON round-trippable for
checkpointing and for the benchmark plots.

A copy of ``repro/sim/history.py`` (numpy only), held exactly equal to it
on the same seeds by ``tests/test_torch_sim.py``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class SimHistory:
    records: list = field(default_factory=list)

    def append(self, rec: dict) -> None:
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]

    def __iter__(self):
        return iter(self.records)

    def series(self, key: str) -> list:
        return [r[key] for r in self.records if key in r]

    # ---------------------------------------------- paper Fig. 5-8 queries --
    def time_to(self, target: float, key: str = "test_acc") -> float | None:
        """Virtual seconds until ``key`` first reaches ``target``."""
        for r in self.records:
            if r.get(key, -float("inf")) >= target:
                return r["t_cum"]
        return None

    def bytes_to(self, target: float, key: str = "test_acc") -> int | None:
        """Cumulative wire bytes until ``key`` first reaches ``target``
        (the paper's ComU@acc metric, on the virtual-time axis)."""
        for r in self.records:
            if r.get(key, -float("inf")) >= target:
                return r["cum_bytes"]
        return None

    # ------------------------------------------------------------ ckpt I/O --
    def to_json(self) -> str:
        return json.dumps(self.records, default=float)

    @classmethod
    def from_json(cls, s: str) -> "SimHistory":
        return cls(records=json.loads(s))
