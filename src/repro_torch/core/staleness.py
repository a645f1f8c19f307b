"""Staleness measurement (paper §4.3).

"We consider a value as stale if it has been overwritten before the client
reads it, with staleness measured as difference between current (read) time
and timestamp of the operation that changed the value."

The benchmark drives a single logical client (no clock drift, as in the
paper) writing monotonically increasing payloads; given the write log and a
read observation these helpers compute the paper's staleness statistic.
"""
from __future__ import annotations

import bisect
import dataclasses
import sys
from typing import List, Optional, Tuple

_INF_ID = sys.maxsize       # sorts a (t, id) probe after every real record
                            # sharing the same timestamp


@dataclasses.dataclass
class WriteLog:
    """(t_applied, payload_id) records of one key's writes, kept sorted.

    ``add`` may be called OUT of apply-time order — replicated writes
    arrive out of order by design — so records are insertion-sorted on
    ``(t_applied, payload_id)`` and queries are ``bisect`` lookups instead
    of full scans.  The single-logical-client contract (module docstring)
    makes payload ids co-monotonic with apply times, so the sorted order
    is simultaneously time- and payload-ordered; ``add`` verifies that
    property against the insertion point (O(1)) and, should a feed ever
    violate it, ``staleness_of_read`` degrades to the exact linear scan
    instead of silently bisecting a list that is unsorted by payload."""

    records: List[Tuple[float, int]] = dataclasses.field(default_factory=list)
    _payload_sorted: bool = True

    def add(self, t_applied: float, payload_id: int) -> None:
        i = bisect.bisect_right(self.records, (t_applied, payload_id))
        if ((i > 0 and self.records[i - 1][1] > payload_id)
                or (i < len(self.records) and self.records[i][1] < payload_id)):
            self._payload_sorted = False
        self.records.insert(i, (t_applied, payload_id))

    def staleness_of_read(self, t_read: float, payload_id: int) -> float:
        """0.0 if the read value was the newest applied at t_read; otherwise
        t_read - t_apply(first write that overwrote it)."""
        hi = bisect.bisect_right(self.records, (t_read, _INF_ID))
        if not self._payload_sorted:            # exact fallback, O(n)
            newer = [t for t, p in self.records[:hi] if p > payload_id]
            return t_read - min(newer) if newer else 0.0
        # first record with a newer payload among those applied by t_read:
        # payloads are co-monotonic with apply times, so this is a bisect
        # on the same sorted list (earliest overwriter == leftmost)
        j = bisect.bisect_right(self.records, payload_id, hi=hi,
                                key=lambda r: r[1])
        if j >= hi:
            return 0.0
        return t_read - self.records[j][0]

    def latest_at(self, t: float) -> Optional[int]:
        # exact under ANY feed: max((ta, p) with ta <= t) is the last
        # record of the (t, payload)-sorted prefix
        hi = bisect.bisect_right(self.records, (t, _INF_ID))
        return self.records[hi - 1][1] if hi else None


def percentiles(xs: List[float], ps=(50, 90, 99)) -> dict:
    import numpy as np

    if not xs:
        return {p: float("nan") for p in ps}
    arr = np.asarray(xs)
    return {p: float(np.percentile(arr, p)) for p in ps}
