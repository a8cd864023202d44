"""Clean lock usage — the negatives: none of this may be flagged."""

from repro_torch.obs.locks import named_condition, named_lock


class GoodNesting:
    def __init__(self, metrics):
        self._lock = named_lock("registry")
        self._cond = named_condition("batcher")
        self._metrics = metrics

    def downward(self):
        with self._lock:
            # registry -> metrics is a declared downward edge
            self._metrics.count("evictions")

    def sync_outside_the_lock(self, flag):
        with self._lock:
            key = "pending"
        # the device read AFTER the lock is released: fine
        done = bool(flag.item())
        with self._lock:
            return key, done

    def callback_not_under_lock(self):
        with self._lock:
            # defining a function under a lock is fine — it runs later
            def cb(mask):
                return mask.cpu()
            return cb

    def joins_strings(self, parts):
        with self._lock:
            return ", ".join(parts)   # str.join is not a thread join
