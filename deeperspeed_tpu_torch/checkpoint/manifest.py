"""Crash-consistent checkpoint commit protocol: staging dirs, per-file
checksum manifests, atomic `latest` flips, and retention GC.

A copy of `deeperspeed_tpu/checkpoint/manifest.py` (pure Python), so
the two packages write and verify the same ``manifest.json``. The port
runs one process, so step 4 below is the JAX package's alone.

Snapshot-then-commit write path (shared by the sync save and the
AsyncCheckpointManager's background writer):

1. all files are written into ``{save_dir}/tmp.{tag}`` and fsynced;
2. ``manifest.json`` (per-file byte size + crc32) is written last, also
   via tmp+fsync+rename — a checkpoint directory is *committed* iff it
   holds a parseable manifest;
3. the staging dir is atomically renamed to ``{save_dir}/{tag}`` and the
   parent dir fsynced — a crash at any earlier point leaves only a
   ``tmp.*`` dir that readers ignore;
4. (multihost) ``sync_global_devices`` — every host's files are durable
   before any host advances;
5. ``latest`` flips via tmp+fsync+rename, strictly after the barrier, so
   it can never point at a checkpoint another host has not finished.

Readers (``load_checkpoint``) verify sizes+checksums against the manifest
and fall back to the newest other committed tag on mismatch; retention GC
(`gc_checkpoints`) only ever deletes *committed* checkpoints and never
the one ``latest`` points to.
"""

import json
import os
import shutil
import zlib

LATEST_FILE = "latest"
MANIFEST_FILE = "manifest.json"
MANIFEST_FORMAT = 1
STAGING_PREFIX = "tmp."


class ManifestError(Exception):
    """A manifest file exists but is unreadable/malformed (distinct from a
    legacy checkpoint that never had one)."""


def _fsync_file(path):
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _fsync_dir(path):  # directory entries themselves need an fsync for
    try:                # the rename to be durable (POSIX); best-effort on
        fd = os.open(path, os.O_RDONLY)  # platforms without dir fds
    except OSError:  # pragma: no cover
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def file_crc32(path, chunk_bytes=1 << 20):
    """Streaming crc32 of a file (constant memory)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def atomic_write_text(path, text):
    """Write `text` to `path` via tmp+fsync+rename: readers see either the
    old contents or the new, never a torn write."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def file_entry(path):
    """One manifest entry for an on-disk file."""
    return {"bytes": os.path.getsize(path),
            "crc32": f"{file_crc32(path):08x}"}


def write_manifest(ckpt_dir, tag, step, extra=None, files=None):
    """Checksum every file under `ckpt_dir` (recursively — streamed-NVMe
    checkpoints hold per-process shard subdirs) into MANIFEST_FILE. A
    writer that already checksummed while staging passes the entries via
    `files` ({rel: {bytes, crc32}}) and skips the re-read pass."""
    if files is None:
        files = {}
        for root, _, names in os.walk(ckpt_dir):
            for name in names:
                if root == ckpt_dir and name == MANIFEST_FILE:
                    continue
                path = os.path.join(root, name)
                files[os.path.relpath(path, ckpt_dir)] = file_entry(path)
    manifest = {"format": MANIFEST_FORMAT, "tag": str(tag),
                "step": int(step), "files": files}
    if extra:
        manifest.update(extra)
    atomic_write_text(os.path.join(ckpt_dir, MANIFEST_FILE),
                      json.dumps(manifest, indent=1, sort_keys=True))
    return manifest


def load_manifest(ckpt_dir):
    """The parsed manifest, or None when the checkpoint predates the
    commit protocol (legacy, unverifiable). Raises ManifestError when a
    manifest exists but cannot be parsed (torn write => not committed)."""
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            manifest = json.load(f)
        if not isinstance(manifest.get("files"), dict):
            raise ValueError("manifest has no 'files' table")
        return manifest
    except (ValueError, OSError) as e:
        raise ManifestError(f"unreadable manifest at {path}: {e}") from e


def verify_manifest(ckpt_dir):
    """(ok, problems): re-checksum every manifest entry. A legacy dir
    without a manifest verifies vacuously (nothing to check against)."""
    try:
        manifest = load_manifest(ckpt_dir)
    except ManifestError as e:
        return False, [str(e)]
    if manifest is None:
        return True, []
    problems = []
    for rel, info in manifest["files"].items():
        path = os.path.join(ckpt_dir, rel)
        if not os.path.isfile(path):
            problems.append(f"{rel}: missing")
            continue
        size = os.path.getsize(path)
        if size != info["bytes"]:
            problems.append(f"{rel}: {size} bytes, manifest says "
                            f"{info['bytes']}")
        elif f"{file_crc32(path):08x}" != info["crc32"]:
            problems.append(f"{rel}: crc32 mismatch")
    return not problems, problems


def is_committed(ckpt_dir):
    try:
        return load_manifest(ckpt_dir) is not None
    except ManifestError:
        return False


def committed_tags(save_dir):
    """[(step, tag)] of committed checkpoints, sorted oldest → newest."""
    out = []
    try:
        names = os.listdir(save_dir)
    except OSError:
        return out
    for name in names:
        if name.startswith(STAGING_PREFIX):
            continue
        ckpt_dir = os.path.join(save_dir, name)
        if not os.path.isdir(ckpt_dir):
            continue
        try:
            manifest = load_manifest(ckpt_dir)
        except ManifestError:
            continue
        if manifest is None:
            continue
        out.append((int(manifest.get("step", -1)), name))
    out.sort()
    return out


def read_latest(save_dir):
    path = os.path.join(save_dir, LATEST_FILE)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        tag = f.read().strip()
    return tag or None


def write_latest(save_dir, tag):
    atomic_write_text(os.path.join(save_dir, LATEST_FILE), str(tag))


def commit_staged(save_dir, staging_dir, tag, step, extra=None,
                  files=None):
    """Finalize a fully-written staging dir: manifest, fsync, atomic
    rename onto `{save_dir}/{tag}`. Does NOT flip `latest` — that happens
    after the multihost barrier (see module docstring)."""
    final = os.path.join(save_dir, str(tag))
    write_manifest(staging_dir, tag, step, extra=extra, files=files)
    _fsync_dir(staging_dir)
    if os.path.isdir(final):
        # Re-save of an existing tag: move the old commit aside BEFORE
        # the new one lands — deleting it first would open a crash
        # window with neither version on disk, breaking the "old state
        # or new state, never nothing" guarantee. The aside dir keeps
        # its manifest, so if we crash mid-swap it is still a committed
        # checkpoint that fallback loading can find; the happy path
        # removes it right after the swap.
        aside = os.path.join(save_dir, str(tag) + ".replaced")
        if os.path.isdir(aside):
            shutil.rmtree(aside)
        os.rename(final, aside)
        os.replace(staging_dir, final)
        _fsync_dir(save_dir)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        os.replace(staging_dir, final)
        _fsync_dir(save_dir)
    return final


def gc_checkpoints(save_dir, keep_last_n=0, keep_every_n_steps=0,
                   protect=()):
    """Retention policy over *committed* checkpoints only: keep the newest
    `keep_last_n`, plus every tag whose step is a multiple of
    `keep_every_n_steps`, plus whatever `latest` points to and any
    `protect`-ed tags. Uncommitted dirs (no manifest — e.g. a save that
    crashed mid-write, or a foreign dir) are never touched. Returns the
    deleted tags."""
    if not keep_last_n and not keep_every_n_steps:
        return []
    tags = committed_tags(save_dir)
    keep = {str(t) for t in protect}
    latest = read_latest(save_dir)
    if latest is not None:
        keep.add(latest)
    if keep_last_n:
        keep.update(tag for _, tag in tags[-int(keep_last_n):])
    if keep_every_n_steps:
        keep.update(tag for step, tag in tags
                    if step >= 0 and step % int(keep_every_n_steps) == 0)
    deleted = []
    for _, tag in tags:
        if tag in keep:
            continue
        shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
        deleted.append(tag)
    return deleted
