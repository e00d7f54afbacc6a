"""Version subscriber: registry announce → zero-downtime hot swap.

A serving process runs one ``VersionSubscriber`` per engine (or per
swap callback — a fleet rollout plugs in as ``swap_fn``).
Two watch transports, same behavior:

  * ``endpoint=`` — stream ``pub_watch`` version-announce frames over
    the mux wire from whichever server hosts the registry verbs (the
    PSServer when publishing is wired there, or a standalone
    RegistryServer), with the same reconnect-and-resync loop the PS
    hot-row invalidation subscriber uses;
  * file mode — poll ``registry.reload()`` on the shared publish
    root, for single-host deployments with no registry endpoint.

The swap itself is the engine's existing two-phase warm start:
``read_checkpoint`` does the disk read + device upload OFF the step
lock, ``adopt_checkpoint`` flips one reference under it — in-flight
generations finish on the old weights' tokens-so-far, new prefills
see the new version, and the wire never observes a pause. A version
whose swap raises (missing params, torn manifest) is memoized as
failed and never retried, so one bad publication cannot wedge the
subscriber loop; the registry's NEXT announce (e.g. the rollback)
proceeds normally.
"""
from __future__ import annotations

import os
import threading
import time

from ..observability import flight as _flight, registry as _obs
from .registry import RegistryClient, VersionRegistry

__all__ = ["VersionSubscriber"]

_SWAP_SECONDS = _obs.histogram(
    "paddle_tpu_publish_swap_seconds",
    "hot-swap wall time per phase: load = off-lock disk+device, "
    "flip = under the step lock (the only instant traffic could "
    "notice — must stay ~0)", ["phase"])
_LAG = _obs.gauge(
    "paddle_tpu_publish_subscriber_lag_versions",
    "registry latest minus the newest version this subscriber has "
    "adopted (0 = caught up)", ["root"])


class VersionSubscriber:
    """Watches a publish root and hot-swaps an engine (or calls a
    custom ``swap_fn(version, record)``) on every publication or
    rollback announce, newest-wins."""

    def __init__(self, root: str, engine=None, swap_fn=None,
                 registry: VersionRegistry | None = None,
                 endpoint: str | None = None, secret: str | None = None,
                 kinds=("gpt-decode",), poll: float | None = None):
        if engine is None and swap_fn is None:
            raise ValueError("VersionSubscriber needs an engine or a "
                             "swap_fn")
        self.root = root
        self.engine = engine
        self._swap_fn = swap_fn
        self.registry = registry or VersionRegistry(root)
        self.endpoint = endpoint
        self.secret = secret
        self.kinds = frozenset(kinds) if kinds else None
        self.poll = float(os.environ.get("PADDLE_TPU_PUBLISH_POLL",
                                         "0.5") or 0.5) \
            if poll is None else float(poll)
        self._lock = threading.Lock()
        self.current_version = 0
        self.swaps = 0
        self.failed_versions: set[int] = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._client: RegistryClient | None = None

    # -- swap ----------------------------------------------------------
    def _swap(self, version: int, rec: dict) -> bool:
        if self._swap_fn is not None:
            self._swap_fn(version, rec)
            return True
        t0 = time.perf_counter()
        self.engine.warm_start(self.root, step=version,
                               version=version)
        _SWAP_SECONDS.labels(phase="load").observe(
            time.perf_counter() - t0)
        return True

    def maybe_swap(self, rec: dict | None = None) -> bool:
        """Adopt the registry's latest (or ``rec``) if it is new,
        matches our kinds, and hasn't already failed. Returns True
        when a swap happened. Serialized — announce storms collapse to
        newest-wins because each swap re-reads the latest pointer."""
        if rec is None:
            rec = self.registry.record_latest()
        if not rec:
            return False
        version = int(rec.get("version", 0))
        with self._lock:
            if not version or version == self.current_version \
                    or version in self.failed_versions:
                self._set_lag()
                return False
            if self.kinds and rec.get("kind") not in self.kinds:
                return False
            try:
                self._swap(version, rec)
            except Exception:
                self.failed_versions.add(version)
                _flight.record("publish", "swap_failed",
                               root=self.root, version=version)
                self._set_lag()
                return False
            self.current_version = version
            self.swaps += 1
            self._set_lag()
        _flight.record("publish", "swap", root=self.root,
                       version=version, step=rec.get("step"),
                       kind=rec.get("kind"))
        return True

    def _set_lag(self):
        # called under self._lock
        lag = max(0, self.registry.latest() - self.current_version)
        _LAG.labels(root=self.root).set(lag)

    # -- watch loops ---------------------------------------------------
    def _poll_loop(self):
        while not self._stop.wait(self.poll):
            try:
                self.registry.reload(missing_ok=True)
                self.maybe_swap()
            except Exception:
                continue  # transient fs error: next tick retries

    def start(self) -> "VersionSubscriber":
        """Catch up to the current latest, then watch. Endpoint mode
        streams announces (RegistryClient.watch reconnects on its
        own); file mode polls reload()."""
        self.registry.reload(missing_ok=True)
        self.maybe_swap()
        if self.endpoint:
            self._client = RegistryClient(self.endpoint,
                                          secret=self.secret)
            self._client.watch(
                lambda rec: self.maybe_swap(rec), stop=self._stop)
        else:
            self._thread = threading.Thread(
                target=self._poll_loop, daemon=True,
                name="publish-subscriber")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._client is not None:
            self._client.close()
            self._client = None
