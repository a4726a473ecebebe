"""Metric logging: JSONL always, and tensorboardX as well where it imports.

Counterpart of the JAX package's ``train/logging.py``, with the reference's
tag names (train_loss / train_recon / train_kl, test_loss / test_recon /
test_kl, beta, sigma_max, parameter histograms). Without a ``log_dir`` the
writer records nothing.
"""
import json
import os


class MetricWriter:
    def __init__(self, log_dir=None):
        self.log_dir = log_dir
        self._tb = None
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def add_histogram(self, tag, values, step):
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step, "auto")

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
