"""PTT-driven straggler detection.

The paper's PTT records per-(worker, width) EWMA execution times and was
designed to absorb "temporally added heterogeneity such as DVFS ... or even
interference caused by ... background processes" (§3.1).  At fleet scale the
same table is a straggler detector: a device group whose recorded time for a
TAO type is a large multiple of the cross-fleet median is flagged, and the
scheduler (or the elastic fleet manager) routes around it.

Detection rule: worker w is a straggler for type T at width v when

    t_w > max(ratio_threshold * median(t_*), median + z_threshold * MAD)

using median/MAD (robust to the stragglers themselves polluting the stats).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.dag import DEFAULT_IMPL
from ..core.ptt import PTTRegistry


@dataclasses.dataclass(frozen=True)
class StragglerReport:
    worker: int
    tao_type: str
    width: int
    time: float
    median: float
    ratio: float
    impl: str = DEFAULT_IMPL


class StragglerDetector:
    def __init__(self, ptt: PTTRegistry, ratio_threshold: float = 2.0,
                 z_threshold: float = 5.0, min_samples: int = 3):
        self.ptt = ptt
        self.ratio_threshold = ratio_threshold
        self.z_threshold = z_threshold
        self.min_samples = min_samples

    def scan(self, width: int | None = 1) -> list[StragglerReport]:
        """Flag straggling workers from the learned PTT.

        ``width`` selects one resource-partition width (the legacy
        behavior, default 1); ``width=None`` scans every width the table
        models.  The PTT stores a separate EWMA block per implementation
        variant (per-(class, impl) speeds differ, so a group slow on one
        impl may be healthy on another): each recorded impl is compared
        against its own cross-fleet median and reported per-impl.

        Workers under the PTT's dead mask (``PTT.excluded`` — chaos kills)
        are skipped entirely: a corpse is neither reportable as a straggler
        (the fleet manager already routed around it) nor admissible into
        the median/MAD baseline, where its stale pre-kill EWMA would skew
        the threshold the *live* workers are judged against."""
        reports: list[StragglerReport] = []
        for tao_type in self.ptt.types():
            table = self.ptt.table(tao_type)
            spec = table.spec
            dead = table.excluded
            widths = spec.widths if width is None else (width,)
            for impl in table.impls():
                for v in widths:
                    times, workers = [], []
                    for w in range(spec.n_workers):
                        if w in dead:
                            continue
                        if table.samples(w, v, impl) >= self.min_samples:
                            times.append(table.time(w, v, impl))
                            workers.append(w)
                    if len(times) < 4:
                        continue
                    arr = np.asarray(times)
                    med = float(np.median(arr))
                    mad = float(np.median(np.abs(arr - med))) + 1e-12
                    for w, t in zip(workers, arr):
                        slow_ratio = t > self.ratio_threshold * med
                        slow_z = (t - med) / (1.4826 * mad) > self.z_threshold
                        if slow_ratio and slow_z:
                            reports.append(StragglerReport(
                                worker=w, tao_type=tao_type, width=v,
                                time=float(t), median=med,
                                ratio=float(t / med), impl=impl))
        return reports

    def healthy_workers(self, width: int | None = 1) -> set[int]:
        """Live workers not currently flagged: excluded (dead-masked)
        workers are removed alongside the stragglers."""
        spec = self.ptt.spec
        bad = {r.worker for r in self.scan(width)}
        return set(range(spec.n_workers)) - bad - set(self.ptt.excluded)
