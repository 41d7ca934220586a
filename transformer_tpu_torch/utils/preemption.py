"""Graceful preemption and a deterministic state fingerprint.

Port of ``transformer_tpu/utils/preemption.py``. Maintenance events and
spot reclaims deliver SIGTERM with a grace window, so a training run
checkpoints *on signal* instead of losing the epoch: ``PreemptionGuard``
latches the signal and the loop saves between steps. ``tree_checksum``
fingerprints a flat dict of tensors or arrays (parameters, optimizer
state): equal dicts give equal checksums across processes and runs, the
audit for replicas or runs drifting apart.
"""

from __future__ import annotations

import os
import signal
import zlib
from typing import Any

import numpy as np

from transformer_tpu_torch.train.checkpoint import dtype_name, to_numpy


class PreemptionGuard:
    """Latches termination signals so the training loop can exit cleanly.

    Use as a context manager around the loop; check ``should_stop`` between
    steps. Handlers are chained (a previously installed handler still runs;
    on the first signal as its ``without_chain`` where it has one: its
    chain without a re-raise of SIG_DFL) and restored on exit. A second
    signal defers to the previous handler,
    or re-delivers the signal under its original disposition, for a hard
    stop."""

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous: dict[int, Any] = {}
        self.should_stop = False
        self.signal_received: int | None = None

    def _handler(self, signum, frame):
        prev = self._previous.get(signum)
        if self.should_stop:
            if callable(prev):
                prev(signum, frame)
            else:  # SIG_DFL / SIG_IGN: restore it and re-deliver
                signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            return
        self.should_stop = True
        self.signal_received = signum
        # Python's default SIGINT handler would raise KeyboardInterrupt and
        # defeat the graceful path on the first signal; a handler that may
        # end in the default disposition (the flight recorder's dump, then
        # its previous handler or SIG_DFL) runs as ``without_chain``, its
        # chain without that re-raise, so the latched stop still
        # checkpoints.
        prev = getattr(prev, "without_chain", prev)
        if callable(prev) and prev is not signal.default_int_handler:
            prev(signum, frame)

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._previous[s] = signal.getsignal(s)
            signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()


def tree_checksum(flat: dict[str, Any]) -> int:
    """crc32 over every entry's name, dtype, shape and bytes, in sorted name
    order: equal dicts give equal checksums."""
    crc = 0
    for key in sorted(flat):
        a = np.ascontiguousarray(to_numpy(flat[key]))
        for part in (key, dtype_name(a), str(a.shape)):
            crc = zlib.crc32(part.encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc
