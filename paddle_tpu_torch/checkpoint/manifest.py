"""CRC'd JSON manifests with atomic rename commit.

A manifest is the unit of checkpoint visibility: it names every array
(dtype, shape) and the content-addressed chunks that reassemble it.
The COMMIT POINT of a save is the ``os.replace`` that puts
``manifest-<step>.json`` at its final name — chunks land first, the
manifest rename is last, so a crash at ANY byte of the save leaves the
previous committed manifest fully intact (the kill-mid-save test pins
this bit-for-bit).

File layout (pure JSON, no pickle — the restore path is scanned by
scripts/check_no_wire_pickle.py):

    {"format": "paddle-tpu-ckpt-v1", "crc32": <crc of canonical
     payload JSON>, "payload": {"step": N, "meta": {...},
     "arrays": {name: {"dtype", "shape", "nbytes",
                       "chunks": [{"h", "o", "n"}, ...]}}}}

``load_latest`` scans newest-first and skips unreadable / CRC-bad
files, so a torn manifest (crash mid-fsync on a weird filesystem, or
plain disk corruption) degrades to the previous committed step instead
of a failed restore.
"""
from __future__ import annotations

import json
import os
import zlib

from ..observability import registry as _obs

__all__ = ["ManifestError", "commit_manifest", "load_manifest",
           "list_manifests", "load_latest", "manifest_path",
           "commit_part", "part_path", "list_parts", "merge_parts"]

FORMAT = "paddle-tpu-ckpt-v1"
_PREFIX, _SUFFIX = "manifest-", ".json"
_PART_PREFIX = "part-"

_COMMITS = _obs.counter(
    "paddle_tpu_ckpt_manifests_committed_total",
    "checkpoint manifests atomically committed")


class ManifestError(RuntimeError):
    """No committed manifest, or the named one is unreadable."""


def _canonical(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def manifest_path(root: str, step: int) -> str:
    return os.path.join(root, f"{_PREFIX}{step:010d}{_SUFFIX}")


def commit_manifest(root: str, payload: dict) -> str:
    """Atomically commit ``payload`` as step ``payload['step']``.
    Write tmp → fsync → rename; the rename IS the commit."""
    step = int(payload["step"])
    path = manifest_path(root, step)
    body = _canonical(payload)
    doc = json.dumps({"format": FORMAT,
                      "crc32": zlib.crc32(body) & 0xFFFFFFFF,
                      "payload": payload}).encode("utf-8")
    os.makedirs(root, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(doc)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    from .chunks import _BYTES_WRITTEN
    _BYTES_WRITTEN.labels(tier="manifest").inc(len(doc))
    _COMMITS.inc()
    return path


def load_manifest(path: str) -> dict:
    """Parse + CRC-validate one manifest file; returns the payload."""
    with open(path, "rb") as f:
        doc = json.loads(f.read().decode("utf-8"))
    if doc.get("format") != FORMAT:
        raise ManifestError(f"{path}: not a {FORMAT} manifest")
    payload = doc["payload"]
    crc = zlib.crc32(_canonical(payload)) & 0xFFFFFFFF
    if crc != int(doc.get("crc32", -1)):
        raise ManifestError(f"{path}: CRC mismatch "
                            f"(stored {doc.get('crc32')}, computed {crc})")
    return payload


def list_manifests(root: str) -> list[tuple[int, str]]:
    """(step, path) of every committed manifest, ascending by step."""
    out = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    for fn in names:
        if fn.startswith(_PREFIX) and fn.endswith(_SUFFIX):
            try:
                out.append((int(fn[len(_PREFIX):-len(_SUFFIX)]),
                            os.path.join(root, fn)))
            except ValueError:
                continue
    return sorted(out)


def part_path(root: str, step: int, rank: int) -> str:
    return os.path.join(
        root, f"{_PART_PREFIX}{step:010d}.{rank:04d}{_SUFFIX}")


def commit_part(root: str, payload: dict, rank: int,
                world: int) -> str:
    """One rank's PARTIAL manifest of a multi-process save (multi-host
    training: each process writes the chunks of the arrays it owns, then
    publishes this part; rank 0 merges the parts into the ONE
    committed version with ``merge_parts``). Same CRC'd doc + atomic
    rename as a full manifest, but under a ``part-`` name that
    ``list_manifests``/``load_latest`` never see — an unmerged or torn
    multi-host save is invisible, and the previous committed step
    stays the restore target."""
    step = int(payload["step"])
    path = part_path(root, step, int(rank))
    doc = json.dumps({"format": FORMAT,
                      "crc32": zlib.crc32(_canonical(payload))
                      & 0xFFFFFFFF,
                      "rank": int(rank), "world": int(world),
                      "payload": payload}).encode("utf-8")
    os.makedirs(root, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(doc)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def list_parts(root: str, step: int) -> list[tuple[int, str]]:
    """(rank, path) of every published part of ``step``, by rank."""
    prefix = f"{_PART_PREFIX}{step:010d}."
    out = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    for fn in names:
        if fn.startswith(prefix) and fn.endswith(_SUFFIX):
            try:
                out.append((int(fn[len(prefix):-len(_SUFFIX)]),
                            os.path.join(root, fn)))
            except ValueError:
                continue
    return sorted(out)


def _load_part(path: str, expect_world: int | None = None) -> dict:
    with open(path, "rb") as f:
        doc = json.loads(f.read().decode("utf-8"))
    if doc.get("format") != FORMAT:
        raise ManifestError(f"{path}: not a {FORMAT} part")
    if expect_world is not None \
            and int(doc.get("world", -1)) != int(expect_world):
        # a leftover part from a previous life at a DIFFERENT world
        # size (elastic resize) must never merge into this version —
        # its shard pieces were cut for the old partition
        raise ManifestError(
            f"{path}: part written for world {doc.get('world')}, "
            f"merging world {expect_world}")
    payload = doc["payload"]
    crc = zlib.crc32(_canonical(payload)) & 0xFFFFFFFF
    if crc != int(doc.get("crc32", -1)):
        raise ManifestError(f"{path}: part CRC mismatch")
    return payload


def merge_parts(root: str, step: int, world: int,
                meta=None, cleanup: bool = True) -> dict:
    """Rank 0's half of a multi-process commit: merge all ``world``
    parts of ``step`` into one manifest and commit it atomically.
    Every rank must have published its part and no two parts may claim
    the same array — a missing, torn, or CRC-bad part raises
    ManifestError BEFORE anything commits, so a torn multi-host save
    degrades to the previous committed version exactly like a torn
    single-host one. Returns the merged payload."""
    parts = dict(list_parts(root, step))
    missing = [r for r in range(int(world)) if r not in parts]
    if missing:
        raise ManifestError(
            f"step {step}: missing part(s) from rank(s) {missing} "
            f"(found {sorted(parts)})")
    arrays: dict = {}
    merged_meta = {} if meta is None else dict(meta)
    for rank in range(int(world)):
        # raises on torn/corrupt/wrong-world
        payload = _load_part(parts[rank], expect_world=world)
        if int(payload.get("step", -1)) != int(step):
            raise ManifestError(
                f"{parts[rank]}: part claims step {payload.get('step')}"
                f", merging step {step}")
        for name, rec in payload.get("arrays", {}).items():
            if name in arrays:
                raise ManifestError(
                    f"step {step}: array {name!r} published by two "
                    f"ranks — parts must partition the state")
            arrays[name] = rec
        if meta is None and payload.get("meta"):
            merged_meta.update(payload["meta"])
    merged = {"step": int(step), "meta": merged_meta or None,
              "arrays": arrays}
    commit_manifest(root, merged)
    if cleanup:
        for _rank, path in list_parts(root, step):
            try:
                os.unlink(path)
            except OSError:
                pass
    return merged


def load_latest(root: str, step: int | None = None) -> dict:
    """Newest valid manifest (or the exact ``step``). Unreadable or
    CRC-bad files are skipped — restore degrades to the last committed
    step rather than failing on a corrupt newest file."""
    if step is not None:
        return load_manifest(manifest_path(root, step))
    errors = []
    for s, path in reversed(list_manifests(root)):
        try:
            return load_manifest(path)
        except (ManifestError, OSError, ValueError) as e:
            errors.append(f"{path}: {e}")
    raise ManifestError(
        f"no committed checkpoint manifest under {root}"
        + (" (skipped corrupt: " + "; ".join(errors) + ")"
           if errors else ""))
