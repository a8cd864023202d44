"""Seeded lock-discipline violations — parsed by tests, never imported.

Expected findings (tests/test_torch_analysis.py pins them):
  * lock-order: cache acquired under metrics (rank inversion)
  * lock-order: unnamed lock nested under a named lock
  * lock-order: unknown level name
  * lock-order via receiver map: _metrics call under a histogram lock
  * lock-blocking-call: Future.result under a lock
  * lock-blocking-call: torch.cuda.synchronize under a lock
  * lock-blocking-call: .item() under a lock
  * lock-blocking-call: .cpu() under a lock
  * lock-blocking-call: file I/O under a lock
"""

import threading

import torch

from repro_torch.obs.locks import named_lock


class BadNesting:
    def __init__(self):
        self._metrics_lock = named_lock("metrics")
        self._cache_lock = named_lock("cache")
        self._plain_lock = threading.Lock()
        self._mystery = named_lock("not-a-level")

    def inverted(self):
        with self._metrics_lock:
            with self._cache_lock:      # lock-order: cache ranks above
                pass

    def unnamed_nested(self):
        with self._cache_lock:
            with self._plain_lock:       # lock-order: unnamed under named
                pass

    def unknown_level(self):
        with self._mystery:              # lock-order: unknown level
            pass


class BadBlocking:
    def __init__(self, metrics):
        self._lock = named_lock("registry")
        self._hist_lock = named_lock("histogram")
        self._metrics = metrics

    def waits_under_lock(self, fut):
        with self._lock:
            return fut.result(timeout=5)     # lock-blocking-call

    def syncs_under_lock(self):
        with self._lock:
            torch.cuda.synchronize()         # lock-blocking-call

    def reads_flag_under_lock(self, flag):
        with self._lock:
            return flag.item()               # lock-blocking-call

    def downloads_under_lock(self, mask):
        with self._lock:
            return mask.cpu()                # lock-blocking-call

    def io_under_lock(self, path):
        with self._lock:
            with open(path) as f:            # lock-blocking-call
                return f.read()

    def receiver_inversion(self):
        with self._hist_lock:
            self._metrics.count("x")         # lock-order via receiver map
