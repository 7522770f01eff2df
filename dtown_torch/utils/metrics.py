"""Host-side metric sink and the mean of metrics over the ranks.

Counterpart of dtown/utils/metrics.py. Scalar metrics stream in once an
iteration (already averaged over the ranks by ``all_device_mean``), are
kept for running statistics, and are optionally appended to a JSONL
file for offline plots.
"""
from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


class MetricSink:
    """Running aggregation of scalar metric dicts, with an optional JSONL
    log (one record a call to ``log``)."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self.path = jsonl_path
        self.history: list[dict] = []
        self._t0 = time.time()
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def log(self, step: int, metrics: dict, extra: Optional[dict] = None):
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            rec[k] = float(v.item() if isinstance(v, torch.Tensor)
                           else np.asarray(v))
        if extra:
            rec.update(extra)
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def summary(self, key: str) -> dict:
        vals = np.asarray([h[key] for h in self.history if key in h])
        if len(vals) == 0:
            return {}
        return {"last": float(vals[-1]), "mean": float(vals.mean()),
                "min": float(vals.min()), "max": float(vals.max()),
                "n": int(len(vals))}

    def improved(self, key: str, head: int = 5, tail: int = 5) -> bool:
        """True if the mean of the last ``tail`` values of ``key`` beats
        the mean of its first ``head`` (a simple learning-progress
        check)."""
        vals = [h[key] for h in self.history if key in h]
        if len(vals) < head + tail:
            return False
        return float(np.mean(vals[-tail:])) > float(np.mean(vals[:head]))

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def all_device_mean(tree: dict, group=None) -> dict:
    """The mean over the ranks of ``group`` (the default group when None)
    of a dict of 0-d tensors, in one all_reduce of their stack (a sum,
    then a division by the world size, as pmean does). Without an
    initialised process group it is the identity."""
    if not dist.is_initialized() or not tree:
        return tree
    keys = list(tree)
    flat = torch.stack([tree[k].to(torch.float32) for k in keys])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    return dict(zip(keys, flat.unbind()))
