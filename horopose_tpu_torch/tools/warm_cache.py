"""CLI: pre-fill the decoded-jpg cache for a DREAM dataset directory.

Port of `horopose_tpu/tools/warm_cache.py`, with the same arguments.
Training fills the cache lazily during epoch 1 anyway (data/cache.py);
this tool front-loads that cost with a thread pool, so the first epoch
already reads at memmap speed.

Usage:
  python -m horopose_tpu_torch.tools.warm_cache <dataset_dir>
      [--cache_dir D] [--workers N]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def warm(dataset_dir: str, cache_dir: str = "", workers: int = 0) -> int:
    """Fill the cache; returns the number of cached images."""
    from horopose_tpu_torch.data.cache import (DecodedImageCache,
                                               dataset_fingerprint)
    from horopose_tpu_torch.data.dream import build_frame_index, decode_rgb

    index = build_frame_index(dataset_dir)
    if not index:
        raise FileNotFoundError(f"no *.jpg under {dataset_dir!r}")
    cache = DecodedImageCache(
        cache_dir or os.path.join(dataset_dir, ".decode_cache"), len(index),
        fingerprint=dataset_fingerprint(
            dataset_dir, [r["rgb_path"] for r in index]))
    todo = [i for i in range(len(index)) if cache.get(i) is None]
    if not todo:
        return cache.hit_count()

    def fill(i):
        cache.put(i, decode_rgb(index[i]["rgb_path"]))

    workers = workers or min(16, (os.cpu_count() or 1) * 2)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(fill, todo))
    dt = time.perf_counter() - t0
    print(f"[warm_cache] {len(todo)} images decoded in {dt:.1f}s "
          f"({len(todo) / max(dt, 1e-9):.0f} img/s, {workers} workers); "
          f"cache now holds {cache.hit_count()}/{len(index)}")
    return cache.hit_count()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset_dir")
    p.add_argument("--cache_dir", default="")
    p.add_argument("--workers", type=int, default=0)
    args = p.parse_args(argv)
    n = warm(args.dataset_dir, args.cache_dir, args.workers)
    print(f"[warm_cache] done: {n} images cached")
    return 0


if __name__ == "__main__":
    sys.exit(main())
