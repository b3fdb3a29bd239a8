"""Memory-mapped decoded-image cache for the DREAM loader.

Copy of `horopose_tpu/data/cache.py` (numpy only). JPEG decoding is the
largest share of a sample's host time; this cache stores the decoded RGB
uint8 array of every sample in a single memory-mapped file, written lazily
the first time each index is read, so epoch 1 pays the usual decode cost
and every later epoch reads at memmap speed. Semantics are exact: the
cached array is PIL's `convert("RGB")` output, BEFORE any augmentation,
truncation padding or crop, so the per-epoch randomness downstream is
untouched.

Layout under `cache_dir`:
  meta.json   {"n": N, "h": H, "w": W, "fingerprint": "..."}
  images.u8   memmap uint8 (N, H, W, 3)
  done.u8     memmap uint8 (N,)  1 = slot valid

Validity: meta.json carries a dataset fingerprint (the dataset's absolute
path plus size/mtime of its first and last jpg). A mismatch — regenerated
jpgs, a different same-named dataset pointed at this dir — invalidates the
cache at construction time (files are deleted and refilled). Invalidation
happens ONLY in __init__, i.e. in the parent process before data workers
fork, so no worker can hold a memmap to deleted slots.

Concurrency: thread and process workers share the files. Creation is
elected through an O_EXCL lock file (a second concurrent creator would
truncate the first one's slots); the lock is removed once meta.json is
written (or on creation failure), and a lock older than _LOCK_STALE_S with
no meta.json is treated as a crashed creator's leftover: removed and the
election retried. If the wait for a live creator expires the instance
poisons itself (one message, no per-item retry spin). After creation,
writes are idempotent (decoding image i always yields the same bytes), and
the done flag for a slot is written only after its payload, so a torn read
can at worst miss a concurrent fill and decode redundantly — never observe
a half-written slot as valid. Images whose shape differs from the slot
shape bypass the cache (per-item fallback, no error).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["DecodedImageCache", "dataset_fingerprint"]

_LOCK_STALE_S = 60.0   # a lock this old with no meta.json is a dead creator
_WAIT_S = 10.0         # how long to wait for a live creator to allocate


def dataset_fingerprint(base_dir, jpg_paths) -> str:
    """Cheap identity of a decoded-image set: absolute dataset path, count,
    and size+mtime of a handful of sampled jpgs — the first, last, and a few
    interior quantiles (sorted order). Interior samples catch mid-dataset
    regeneration that leaves the endpoints and count unchanged, while
    staying O(1) stat calls."""
    parts = [str(Path(base_dir).resolve()), str(len(jpg_paths))]
    n = len(jpg_paths)
    if n:
        idxs = sorted({0, n // 4, n // 2, (3 * n) // 4, n - 1})
        for i in idxs:
            p = jpg_paths[i]
            try:
                st = os.stat(p)
                parts.append(f"{os.path.basename(str(p))}:{st.st_size}:"
                             f"{int(st.st_mtime)}")
            except OSError:
                parts.append("unstattable")
    return "|".join(parts)


class DecodedImageCache:
    def __init__(self, cache_dir, n_items: int, fingerprint: str = "",
                 _invalidate_ok: bool = True):
        self.dir = Path(cache_dir)
        self.n = int(n_items)
        self.fingerprint = str(fingerprint)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._meta_path = self.dir / "meta.json"
        self._img_path = self.dir / "images.u8"
        self._done_path = self.dir / "done.u8"
        self._lock_path = self.dir / ".init_lock"
        self._images: Optional[np.memmap] = None
        self._done: Optional[np.memmap] = None
        self._shape = None
        if self._meta_path.exists():
            # _invalidate_ok is False when rebuilt from pickle inside a data
            # worker: a child must never delete files its siblings memmap.
            self._open_existing(invalidate_on_mismatch=_invalidate_ok)

    # -- internal ---------------------------------------------------------

    def _poison(self, why: str):
        if self.n >= 0:
            print(f"[cache] disabled ({why})")
        self.n = -1
        self._images = self._done = None

    def _invalidate(self, why: str):
        """Drop a stale cache so it refills. Called only from __init__
        (before workers fork) — see module docstring for why that is the
        only safe place."""
        print(f"[cache] {self.dir}: stale ({why}); rebuilding")
        for p in (self._meta_path, self._img_path, self._done_path,
                  self._lock_path):
            try:
                p.unlink()
            except OSError:
                pass

    def _open_existing(self, invalidate_on_mismatch: bool = False):
        try:
            meta = json.loads(self._meta_path.read_text())
            n, h, w = int(meta["n"]), int(meta["h"]), int(meta["w"])
            fp = str(meta.get("fingerprint", ""))
        except (KeyError, ValueError, json.JSONDecodeError, OSError):
            if invalidate_on_mismatch:
                self._invalidate("unreadable meta.json")
            else:
                self._poison("unreadable meta.json")
            return
        # empty self.fingerprint = wildcard (direct tool/test constructions);
        # a dataset-provided fingerprint must match exactly — including
        # against fingerprint-less meta.json from the pre-fingerprint format
        if n != self.n or (self.fingerprint and fp != self.fingerprint):
            why = (f"item count {n} != {self.n}" if n != self.n
                   else "dataset fingerprint changed")
            if invalidate_on_mismatch:
                self._invalidate(why)
            else:
                self._poison(why)
            return
        self._shape = (h, w, 3)
        self._images = np.memmap(self._img_path, dtype=np.uint8, mode="r+",
                                 shape=(self.n, h, w, 3))
        self._done = np.memmap(self._done_path, dtype=np.uint8, mode="r+",
                               shape=(self.n,))

    def _create(self, h: int, w: int, _retry: bool = True):
        # Exactly ONE creator: mode="w+" truncates, so a second concurrent
        # _create would wipe slots the first already filled. O_EXCL on a
        # lock file elects the creator atomically (works across processes);
        # losers wait for meta.json and open what the winner built.
        try:
            os.close(os.open(self._lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            # Lost the election: wait for the live creator's meta.json, but
            # recognize a DEAD creator (a lock older than _LOCK_STALE_S, or
            # a lock that vanished without meta) and re-run the election —
            # a crashed epoch-1 fill must not wedge the dir forever.
            deadline = time.monotonic() + _WAIT_S
            stale = False
            while time.monotonic() < deadline:
                if self._meta_path.exists():
                    self._open_existing()
                    return
                try:
                    st = self._lock_path.stat()
                except OSError:
                    # Lock vanished without meta. Three possible worlds:
                    # (a) the creator finished and meta is imminent, (b) the
                    # creator failed and released, (c) ANOTHER WAITER just
                    # os.replace()d a LIVE creator's lock for its inode
                    # check and will restore it momentarily. Breaking to
                    # re-elect immediately in world (c) races a live
                    # creator whose mode="w+" truncation can tear slots —
                    # so wait a grace period for either meta.json or a
                    # restored lock before concluding the creator is dead.
                    grace = time.monotonic() + 1.0
                    vanished = True
                    while time.monotonic() < grace:
                        if self._meta_path.exists() or \
                                self._lock_path.exists():
                            vanished = False
                            break
                        time.sleep(0.01)
                    if vanished and not self._meta_path.exists():
                        stale = True
                        break
                    continue
                if time.time() - st.st_mtime > _LOCK_STALE_S:
                    # Claim the steal ATOMICALLY: rename(2) succeeds for
                    # exactly one waiter (a bare unlink would let a second
                    # waiter delete the first stealer's freshly won lock
                    # and re-elect a concurrent creator whose mode="w+"
                    # truncates files the first has already mapped), then
                    # verify BY INODE that what we moved is the stale lock
                    # we measured — not a fresh one re-created in between.
                    claim = str(self._lock_path) + ".stale"
                    try:
                        os.replace(self._lock_path, claim)
                        if os.stat(claim).st_ino == st.st_ino:
                            stale = True
                            break
                        # we displaced someone's LIVE lock: put it back and
                        # wait for that creator's meta on a fresh deadline
                        os.replace(claim, self._lock_path)
                    except OSError:
                        pass  # another waiter claimed it first
                    deadline = time.monotonic() + _WAIT_S
                    continue
                time.sleep(0.01)
            if self._meta_path.exists():
                self._open_existing()
                return
            if stale and _retry:
                self._create(h, w, _retry=False)
                if self._done is None and self.n >= 0:
                    self._poison("cache creation retry failed")
                return
            self._poison(f"timed out waiting {_WAIT_S:.0f}s for the cache "
                         "creator")
            return
        # Won the election. Sized files first, meta last: a concurrent
        # reader only opens the cache once meta.json exists, by which point
        # both memmaps are fully allocated. The lock is removed in all
        # paths — success or failure — so an interrupted creation never
        # wedges the directory (a later run re-elects).
        try:
            np.memmap(self._img_path, dtype=np.uint8, mode="w+",
                      shape=(self.n, h, w, 3)).flush()
            np.memmap(self._done_path, dtype=np.uint8, mode="w+",
                      shape=(self.n,)).flush()
            tmp = self._meta_path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps({"n": self.n, "h": h, "w": w,
                                       "fingerprint": self.fingerprint}))
            os.replace(tmp, self._meta_path)
        finally:
            try:
                self._lock_path.unlink()
            except OSError:
                pass
        self._open_existing()

    # -- API --------------------------------------------------------------

    def get(self, idx: int) -> Optional[np.ndarray]:
        """Decoded RGB for idx, or None on miss. Returns a copy (the
        caller may mutate it in augmentations)."""
        if self.n < 0:
            return None
        if self._done is None and self._meta_path.exists():
            self._open_existing()  # another worker created it meanwhile
        if self._done is None or not self._done[idx]:
            return None
        return np.array(self._images[idx])

    def put(self, idx: int, rgb: np.ndarray) -> None:
        if self.n < 0:
            return  # poisoned: creation failed once, don't retry per item
        if self._done is None:
            if not self._meta_path.exists():
                try:
                    self._create(rgb.shape[0], rgb.shape[1])
                except OSError as e:  # read-only dataset dir, out of disk
                    self._poison(str(e))
                    return
            else:
                self._open_existing()
            if self._done is None:
                return
        if rgb.shape != self._shape:
            return  # odd-sized image: per-item bypass
        self._images[idx] = rgb
        self._done[idx] = 1

    def __getstate__(self):
        # Pickle cheaply (paths only): np.memmap's default reduction
        # materializes the WHOLE array. Needed for forkserver/spawn data
        # workers; the memmaps reopen lazily in the child.
        return {"dir": self.dir, "n": self.n,
                "fingerprint": self.fingerprint}

    def __setstate__(self, state):
        if state["n"] < 0:  # parent was poisoned: stay poisoned, quietly
            self.dir = Path(state["dir"])
            self.n = -1
            self.fingerprint = state.get("fingerprint", "")
            self._images = self._done = None
            return
        self.__init__(state["dir"], state["n"],
                      state.get("fingerprint", ""), _invalidate_ok=False)

    @property
    def complete(self) -> bool:
        return self._done is not None and bool(self._done.all())

    def hit_count(self) -> int:
        return 0 if self._done is None else int(self._done.sum())
