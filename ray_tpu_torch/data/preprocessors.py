"""Data preprocessors: fit statistics on a Dataset, transform lazily
(counterpart of `ray_tpu/data/preprocessors.py`).

Parity (core family) with `python/ray/data/preprocessors/`
(StandardScaler, MinMaxScaler, LabelEncoder, OneHotEncoder,
Concatenator): `fit` streams the dataset once accumulating statistics
(driver holds only the accumulators, never the data), `transform`
appends a lazy map_batches so the work runs in the cluster and composes
with the operator-graph executor. `transform_batch` applies the fitted
stats to a single in-memory batch (the serving-time path).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Preprocessor:
    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        if not self._fitted:
            raise RuntimeError(f"{type(self).__name__} is not fitted")
        return ds.map_batches(self.transform_batch)

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def _fit(self, ds) -> None:
        raise NotImplementedError

    def transform_batch(self, batch: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (Welford streaming fit)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds) -> None:
        acc = {c: [0.0, None, None] for c in self.columns}  # n, mean, m2
        for batch in ds.iter_batches(batch_size=4096):
            for c in self.columns:
                b = np.asarray(batch[c], np.float64)
                n = len(b)
                cnt, mean, m2 = acc[c]
                if mean is None:
                    acc[c] = [n, b.mean(0), b.var(0) * n]
                else:
                    delta = b.mean(0) - mean
                    tot = cnt + n
                    acc[c] = [tot, mean + delta * n / tot,
                              m2 + b.var(0) * n
                              + delta ** 2 * cnt * n / tot]
        self.stats_ = {c: (acc[c][1], np.sqrt(acc[c][2] / max(acc[c][0], 1)))
                       for c in self.columns}

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats_[c]
            out[c] = ((np.asarray(batch[c], np.float64) - mean)
                      / np.where(std == 0, 1.0, std)).astype(np.float32)
        return out


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds) -> None:
        lo = {c: None for c in self.columns}
        hi = {c: None for c in self.columns}
        for batch in ds.iter_batches(batch_size=4096):
            for c in self.columns:
                b = np.asarray(batch[c], np.float64)
                bmin, bmax = b.min(0), b.max(0)
                lo[c] = bmin if lo[c] is None else np.minimum(lo[c], bmin)
                hi[c] = bmax if hi[c] is None else np.maximum(hi[c], bmax)
        self.stats_ = {c: (lo[c], hi[c]) for c in self.columns}

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            lo, hi = self.stats_[c]
            rng = np.where(hi - lo == 0, 1.0, hi - lo)
            out[c] = ((np.asarray(batch[c], np.float64) - lo)
                      / rng).astype(np.float32)
        return out


class LabelEncoder(Preprocessor):
    """Categorical column -> dense int codes (sorted vocabulary)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: Optional[np.ndarray] = None

    def _fit(self, ds) -> None:
        seen = set()
        for batch in ds.iter_batches(batch_size=4096):
            seen.update(np.asarray(batch[self.label_column]).tolist())
        self.classes_ = np.asarray(sorted(seen))

    def transform_batch(self, batch):
        out = dict(batch)
        idx = {v: i for i, v in enumerate(self.classes_.tolist())}
        out[self.label_column] = np.asarray(
            [idx[v] for v in np.asarray(batch[self.label_column]).tolist()],
            np.int64)
        return out


class OneHotEncoder(Preprocessor):
    """Categorical columns -> `<col>_<value>` 0/1 columns."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.categories_: Dict[str, np.ndarray] = {}

    def _fit(self, ds) -> None:
        seen: Dict[str, set] = {c: set() for c in self.columns}
        for batch in ds.iter_batches(batch_size=4096):
            for c in self.columns:
                seen[c].update(np.asarray(batch[c]).tolist())
        self.categories_ = {c: np.asarray(sorted(v))
                            for c, v in seen.items()}

    def transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        for c in self.columns:
            vals = np.asarray(batch[c])
            for cat in self.categories_[c].tolist():
                out[f"{c}_{cat}"] = (vals == cat).astype(np.int8)
        return out


class Concatenator(Preprocessor):
    """Merge columns into one float matrix column (training ingest:
    feature columns -> a single model-input array)."""

    def __init__(self, columns: Optional[List[str]] = None,
                 output_column_name: str = "concat_out",
                 exclude: Optional[List[str]] = None):
        self.columns = columns
        self.output_column_name = output_column_name
        self.exclude = set(exclude or [])
        self._fitted = True   # stateless

    def _fit(self, ds) -> None:
        pass

    def transform_batch(self, batch):
        cols = (self.columns if self.columns is not None
                else [c for c in batch if c not in self.exclude])
        parts = []
        for c in cols:
            a = np.asarray(batch[c], np.float32)
            parts.append(a[:, None] if a.ndim == 1 else a)
        out = {k: v for k, v in batch.items()
               if k not in cols}
        out[self.output_column_name] = np.concatenate(parts, axis=1)
        return out


class Chain(Preprocessor):
    """Apply preprocessors in sequence (reference Chain)."""

    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = list(preprocessors)

    def fit(self, ds) -> "Chain":
        # each stage fits on the PREVIOUS stage's output (lazy, still
        # cluster-executed per fit pass)
        for i, p in enumerate(self.preprocessors):
            p.fit(ds)
            ds = p.transform(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch
