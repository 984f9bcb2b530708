"""Windowed/global average meters (a copy of
``fusiontransformer_tpu/utils/metric_logger.py``)."""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np


class AverageMeter:
    """Tracks a window average, global average and current value
    (reference ``common/utils/metric_logger.py:55``)."""

    default_fmt = "{avg:.4f} ({global_avg:.4f})"

    def __init__(self, window_size=20, fmt=None):
        self.values = deque(maxlen=window_size)
        self.counts = deque(maxlen=window_size)
        self.sum = 0.0
        self.count = 0
        self.fmt = fmt or self.default_fmt

    def update(self, value, count=1):
        self.values.append(value)
        self.counts.append(count)
        self.sum += value
        self.count += count

    @property
    def avg(self):
        return np.sum(self.values) / max(np.sum(self.counts), 1)

    @property
    def global_avg(self):
        return self.sum / self.count if self.count != 0 else float("nan")

    def reset(self):
        self.values.clear()
        self.counts.clear()
        self.sum = 0.0
        self.count = 0

    def __str__(self):
        return self.fmt.format(avg=self.avg, global_avg=self.global_avg)

    @property
    def summary_str(self):
        return "{global_avg:.4f}".format(global_avg=self.global_avg)


class MetricLogger:
    """Named collection of meters (reference ``common/utils/metric_logger.py:11``)."""

    def __init__(self, delimiter="\t"):
        self.meters = defaultdict(AverageMeter)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            count = 1
            if isinstance(v, (tuple, list)):
                v, count = v
            if hasattr(v, "item"):
                v = float(np.asarray(v))
            assert isinstance(v, (float, int))
            self.meters[k].update(v, count)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def add_meters(self, meters):
        if not isinstance(meters, (list, tuple)):
            meters = [meters]
        for m in meters:
            self.add_meter(m.name, m)

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{attr}'")

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    @property
    def summary_str(self):
        return self.delimiter.join(
            f"{name}: {meter.summary_str}" for name, meter in self.meters.items())
