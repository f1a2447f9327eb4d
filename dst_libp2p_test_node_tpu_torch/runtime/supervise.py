"""Supervision helpers of the resident service: a countdown of forced
failures and a watchdog around one device call.

Copies of the reference's campaign supervisor pieces
(runtime/campaign.py:198-222, `_FailureInjector` and `_call_with_timeout`),
which the port's service needs before the campaign stack exists. The one
change: the watchdog's worker thread runs on the simulator's device (a
thread starts on CUDA device 0, whatever device its parent selected).
"""

from __future__ import annotations

import torch


class _FailureInjector:
    """Counts down `inject_failures` across supervised attempts (global,
    not per request: K injected failures in all)."""

    def __init__(self, k: int):
        self.left = int(k)

    def maybe_fail(self) -> None:
        if self.left > 0:
            self.left -= 1
            raise RuntimeError(
                "injected trial failure (SupervisorConfig.inject_failures)")


def _call_with_timeout(fn, timeout_s: float, device=None):
    """fn() on this thread when timeout_s is 0; otherwise on a worker
    thread pinned to `device`, abandoned (never joined) once timeout_s
    passes: the hung attempt keeps running, as in the reference, and the
    caller sees concurrent.futures.TimeoutError."""
    if timeout_s <= 0.0:
        return fn()
    import concurrent.futures as cf

    def pinned():
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(device)
        return fn()

    ex = cf.ThreadPoolExecutor(max_workers=1)
    try:
        return ex.submit(pinned).result(timeout=timeout_s)
    finally:
        # never join the worker: a hung attempt must not hang the service
        ex.shutdown(wait=False)
