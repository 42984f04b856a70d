"""Connector pipelines: pluggable observation/action transforms.

Parity: `rllib/connectors/` (env-to-module, module-to-env pipelines) —
composable, stateful transforms sitting between the environment and the
RLModule, owned by the env runner so preprocessing travels WITH the
policy (checkpointable state, e.g. running obs statistics).

- EnvToModule connectors map raw env observations -> module inputs
  (normalize, clip, frame-stack).
- ModuleToEnv connectors map module actions -> env actions (already
  handled structurally by action_scale; connectors add clipping etc.).

Wired via `AlgorithmConfig.env_runners(env_to_module_connector=...)`:
the callable builds a pipeline per runner (reference's
`config.env_to_module_connector` factory contract).

Counterpart of `ray_tpu/rllib/connectors.py`, copied (numpy).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np


class Connector:
    """One transform. `__call__(batch)` maps a [N, ...] numpy batch."""

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, batch: np.ndarray) -> np.ndarray:
        """Apply WITHOUT mutating connector state — for out-of-band
        inputs (bootstrap values at truncations, the trailing value
        step) that must see the same normalization as policy inputs but
        must not advance running statistics/history."""
        return self(batch)

    # connectors may carry state that must checkpoint with the runner
    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class ConnectorPipeline(Connector):
    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors = list(connectors or [])

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def __call__(self, batch):
        for c in self.connectors:
            batch = c(batch)
        return batch

    def transform(self, batch):
        for c in self.connectors:
            batch = c.transform(batch)
        return batch

    def get_state(self) -> dict:
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: dict) -> None:
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, batch):
        return np.clip(batch, self.low, self.high)


class MeanStdObs(Connector):
    """Running mean/std observation normalization (reference
    MeanStdFilter connector) — Welford accumulation over every batch
    that flows through; state checkpoints with the runner."""

    def __init__(self, eps: float = 1e-8, update: bool = True):
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None
        self.eps = eps
        self.update = update

    def __call__(self, batch):
        b = np.asarray(batch, np.float64)
        if self.update:
            n = b.shape[0]
            bmean = b.mean(0)
            bvar = b.var(0)
            if self.mean is None:
                self.mean = bmean
                self.m2 = bvar * n
                self.count = n
            else:
                delta = bmean - self.mean
                tot = self.count + n
                self.mean = self.mean + delta * n / tot
                self.m2 = (self.m2 + bvar * n
                           + delta ** 2 * self.count * n / tot)
                self.count = tot
        if self.mean is None:
            return batch
        std = np.sqrt(self.m2 / max(self.count, 1.0)) + self.eps
        return ((b - self.mean) / std).astype(np.float32)

    def transform(self, batch):
        if self.mean is None:
            return batch
        b = np.asarray(batch, np.float64)
        std = np.sqrt(self.m2 / max(self.count, 1.0)) + self.eps
        return ((b - self.mean) / std).astype(np.float32)

    def get_state(self) -> dict:
        return {"count": self.count,
                "mean": None if self.mean is None else self.mean.copy(),
                "m2": None if self.m2 is None else self.m2.copy()}

    def set_state(self, state: dict) -> None:
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


class FrameStackObs(Connector):
    """Stack the last K observations along the feature axis (reference
    FrameStacking connector; flat-obs variant)."""

    def __init__(self, k: int = 4):
        self.k = k
        self._hist: List[np.ndarray] = []

    def __call__(self, batch):
        b = np.asarray(batch, np.float32)
        self._hist.append(b)
        while len(self._hist) < self.k:
            self._hist.insert(0, np.zeros_like(b))
        self._hist = self._hist[-self.k:]
        return np.concatenate(self._hist, axis=-1)

    def transform(self, batch):
        b = np.asarray(batch, np.float32)
        hist = (self._hist[1:] if len(self._hist) >= self.k
                else self._hist)[:]
        hist.append(b)
        while len(hist) < self.k:
            hist.insert(0, np.zeros_like(b))
        return np.concatenate(hist[-self.k:], axis=-1)

    def get_state(self) -> dict:
        return {"hist": [h.copy() for h in self._hist]}

    def set_state(self, state: dict) -> None:
        self._hist = [np.asarray(h) for h in state["hist"]]


class ClipActions(Connector):
    """module-to-env: clip continuous actions to the env bounds."""

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, batch):
        return np.clip(batch, self.low, self.high)


def build_pipeline(spec: Any) -> Optional[ConnectorPipeline]:
    """Factory contract: spec is None | Connector | list[Connector] |
    callable() -> any of those (the reference passes factories so each
    runner gets its OWN stateful pipeline)."""
    if spec is None:
        return None
    if callable(spec) and not isinstance(spec, Connector):
        spec = spec()
    if spec is None:
        return None
    if isinstance(spec, ConnectorPipeline):
        return spec
    if isinstance(spec, Connector):
        return ConnectorPipeline([spec])
    return ConnectorPipeline(list(spec))
