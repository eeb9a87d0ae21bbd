"""Aggregations and grouped datasets.

Reference: ray ``python/ray/data/aggregate.py`` (AggregateFn, Count/Sum/…)
and ``grouped_data.py`` (GroupedData over a hash shuffle).  Aggregations are
(init, accumulate, merge, finalize) quadruples so they distribute: map tasks
pre-aggregate per block, reducers merge partials.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Union

from .block import row_key


class AggregateFn:
    def __init__(
        self,
        init: Callable[[], Any],
        accumulate: Callable[[Any, Any], Any],
        merge: Callable[[Any, Any], Any],
        finalize: Callable[[Any], Any] = lambda a: a,
        name: str = "agg",
    ):
        self.init = init
        self.accumulate = accumulate
        self.merge = merge
        self.finalize = finalize
        self.name = name


def _on(on: Union[str, Callable, None]):
    return lambda row: row_key(row, on)


class Count(AggregateFn):
    def __init__(self):
        super().__init__(
            init=lambda: 0,
            accumulate=lambda a, r: a + 1,
            merge=lambda a, b: a + b,
            name="count()",
        )
        self.kind, self.on = "count", None


class Sum(AggregateFn):
    def __init__(self, on=None):
        get = _on(on)
        super().__init__(
            init=lambda: 0,
            accumulate=lambda a, r: a + get(r),
            merge=lambda a, b: a + b,
            name=f"sum({on})",
        )
        self.kind, self.on = "sum", on


class Min(AggregateFn):
    def __init__(self, on=None):
        get = _on(on)
        super().__init__(
            init=lambda: None,
            accumulate=lambda a, r: get(r) if a is None else min(a, get(r)),
            merge=lambda a, b: b if a is None else (a if b is None else min(a, b)),
            name=f"min({on})",
        )
        self.kind, self.on = "min", on


class Max(AggregateFn):
    def __init__(self, on=None):
        get = _on(on)
        super().__init__(
            init=lambda: None,
            accumulate=lambda a, r: get(r) if a is None else max(a, get(r)),
            merge=lambda a, b: b if a is None else (a if b is None else max(a, b)),
            name=f"max({on})",
        )
        self.kind, self.on = "max", on


class Mean(AggregateFn):
    def __init__(self, on=None):
        get = _on(on)
        super().__init__(
            init=lambda: (0, 0.0),
            accumulate=lambda a, r: (a[0] + 1, a[1] + get(r)),
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            finalize=lambda a: a[1] / a[0] if a[0] else None,
            name=f"mean({on})",
        )
        self.kind, self.on = "mean", on


class Std(AggregateFn):
    """Parallel variance via Chan et al. pairwise merge."""

    def __init__(self, on=None, ddof: int = 1):
        get = _on(on)

        def merge(a, b):
            (n1, m1, s1), (n2, m2, s2) = a, b
            if n1 == 0:
                return b
            if n2 == 0:
                return a
            n = n1 + n2
            d = m2 - m1
            m = m1 + d * n2 / n
            s = s1 + s2 + d * d * n1 * n2 / n
            return (n, m, s)

        def acc(a, r):
            return merge(a, (1, float(get(r)), 0.0))

        super().__init__(
            init=lambda: (0, 0.0, 0.0),
            accumulate=acc,
            merge=merge,
            finalize=lambda a: (
                math.sqrt(a[2] / (a[0] - ddof)) if a[0] > ddof else None
            ),
            name=f"std({on})",
        )
        self.kind, self.on = "std", on


def _aggregate_columnar(block, key, aggs):
    """Vectorized per-block partials for the built-in aggregations over a
    ColumnarBlock with numeric agg columns — one np.unique + a bincount
    or ufunc.at pass per agg instead of a per-row Python loop.  Partial
    SHAPES match the row path exactly, so reducers merge mixed
    columnar/row partials transparently.  Returns None when anything
    needs the generic path (custom aggs, callable keys, missing or
    non-numeric columns)."""
    import numpy as np

    from .block import ColumnarBlock

    if not isinstance(block, ColumnarBlock) or not isinstance(key, str):
        return None
    keys = block.columns.get(key)
    if keys is None or len(keys) == 0:
        return None
    if keys.dtype.kind not in "iufSU":
        # object/mixed key columns (None, heterogenous types) break
        # np.unique's sort — that's the generic path's job.
        return None
    cols = {}
    for a in aggs:
        kind = getattr(a, "kind", None)
        if kind is None:
            return None
        if kind != "count":
            col = block.columns.get(a.on) if isinstance(a.on, str) else None
            if col is None or col.dtype.kind not in "iuf":
                return None
            cols[a.on] = col
    uniq, inv = np.unique(keys, return_inverse=True)
    n_groups = len(uniq)
    counts = np.bincount(inv, minlength=n_groups)
    per_agg = []
    for a in aggs:
        kind = a.kind
        if kind == "count":
            per_agg.append([int(c) for c in counts])
            continue
        v = cols[a.on]
        if kind == "sum":
            if v.dtype.kind in "iu":
                peak = int(np.abs(v.astype(np.float64)).max())
                if peak and peak > (2**62) // max(1, len(v)):
                    # Worst-case total could wrap int64: accumulate in
                    # Python ints (arbitrary precision) — the row path
                    # would wrap identically on np scalars, so this slow
                    # branch is the EXACT one.
                    exact = [0] * n_groups
                    for g, x in zip(inv, v):
                        exact[g] += int(x)
                    per_agg.append(exact)
                else:
                    out = np.zeros(n_groups, np.int64)
                    np.add.at(out, inv, v.astype(np.int64))
                    per_agg.append([int(x) for x in out])
            else:
                per_agg.append(
                    list(np.bincount(inv, weights=v, minlength=n_groups))
                )
        elif kind in ("min", "max"):
            # Same-dtype extremes: casting int64 through float64 above
            # 2^53 fabricates values that are not in the column.
            if v.dtype.kind in "iu":
                info = np.iinfo(v.dtype)
                fill = info.max if kind == "min" else info.min
            else:
                fill = np.inf if kind == "min" else -np.inf
            out = np.full(n_groups, fill, v.dtype)
            (np.minimum if kind == "min" else np.maximum).at(out, inv, v)
            per_agg.append([x.item() for x in out])
        elif kind == "mean":
            s = np.bincount(inv, weights=v, minlength=n_groups)
            per_agg.append(
                [(int(n), float(t)) for n, t in zip(counts, s)]
            )
        elif kind == "std":
            # Two-pass (shifted) variance: the naive s2 - s1^2/n form
            # catastrophically cancels for data with large means (a
            # 1e8-mean column measured ~150% std error); subtracting the
            # per-group mean first is stable and matches the row path's
            # Chan-merge partial shape (n, mean, M2).
            vf = v.astype(np.float64)
            s1 = np.bincount(inv, weights=vf, minlength=n_groups)
            mu = s1 / counts
            dev = vf - mu[inv]
            m2 = np.bincount(inv, weights=dev * dev, minlength=n_groups)
            per_agg.append(
                [(int(n), float(mm), float(ss))
                 for n, mm, ss in zip(counts, mu, m2)]
            )
        else:
            return None
    return {
        uniq[g].item(): [per_agg[i][g] for i in range(len(aggs))]
        for g in range(n_groups)
    }


def aggregate_block(block, key, aggs) -> dict:
    """Per-block partial aggregation: key -> [partial per agg]."""
    fast = _aggregate_columnar(block, key, aggs)
    if fast is not None:
        return fast
    partials: dict = {}
    for row in block:
        k = row_key(row, key) if key is not None else None
        accs = partials.get(k)
        if accs is None:
            accs = [a.init() for a in aggs]
            partials[k] = accs
        for i, a in enumerate(aggs):
            accs[i] = a.accumulate(accs[i], row)
    return partials


def merge_partials(parts, aggs) -> dict:
    merged: dict = {}
    for p in parts:
        for k, accs in p.items():
            cur = merged.get(k)
            if cur is None:
                merged[k] = list(accs)
            else:
                for i, a in enumerate(aggs):
                    cur[i] = a.merge(cur[i], accs[i])
    return merged


def finalize_partials(merged, key, aggs):
    """merged key->accs → list of result rows."""
    rows = []
    for k in sorted(merged.keys(), key=lambda x: (x is None, x)):
        accs = merged[k]
        vals = [a.finalize(acc) for a, acc in zip(aggs, accs)]
        if key is None:
            rows.append(vals[0] if len(vals) == 1 else tuple(vals))
        else:
            row = {key if isinstance(key, str) else "key": k}
            for a, v in zip(aggs, vals):
                row[a.name] = v
            rows.append(row)
    return rows


class GroupedData:
    """Returned by ``Dataset.groupby`` (reference
    ``python/ray/data/grouped_data.py``)."""

    def __init__(self, dataset, key: Union[str, Callable]):
        self._dataset = dataset
        self._key = key

    def aggregate(self, *aggs: AggregateFn):
        return self._dataset._groupby_aggregate(self._key, list(aggs))

    def count(self):
        return self.aggregate(Count())

    def sum(self, on=None):
        return self.aggregate(Sum(on))

    def min(self, on=None):
        return self.aggregate(Min(on))

    def max(self, on=None):
        return self.aggregate(Max(on))

    def mean(self, on=None):
        return self.aggregate(Mean(on))

    def std(self, on=None, ddof: int = 1):
        return self.aggregate(Std(on, ddof))

    def map_groups(self, fn: Callable[[list], list]):
        """Shuffle rows by key, then apply ``fn`` to each key's row list."""
        return self._dataset._map_groups(self._key, fn)
