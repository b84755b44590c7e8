"""What the soaks share (`eval/kitti_soak.py`, `eval/lidar_soak.py`, and
`chip_smoke.py`'s probes of phases 19-21): methods replaced for the length
of a `with` block, a run's progress readings, and a whole run's record cut
to one of its readings.

Imports neither JAX nor torch.
"""

from __future__ import annotations

import resource
import time


def peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class Patches:
    """Replaced attributes: `patch(owner, attr, make)` sets `owner.attr =
    make(the attribute)`; `restore()` puts every one back, the last first."""

    def __init__(self):
        self._patched = []

    def patch(self, owner, attr, make):
        fn = getattr(owner, attr)
        self._patched.append((owner, attr, fn))
        setattr(owner, attr, make(fn))

    def restore(self):
        for owner, attr, fn in reversed(self._patched):
            setattr(owner, attr, fn)
        self._patched.clear()


class Recorder(Patches):
    """A run counted while the `with` block runs: `tick(n)` after the n-th
    item (frame, scan) keeps a `reading()` in `progress` every `every`
    items and logs its `progress_line`; `wall_s` is the block's seconds. A
    subclass patches in `install()` and defines `reading` and
    `progress_line`."""

    def __init__(self, every: int, log=print):
        super().__init__()
        self.every, self.log = every, log
        self.progress = []
        self._t0 = None

    def install(self):
        raise NotImplementedError

    def __enter__(self):
        self.install()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.restore()
        self.wall_s = time.perf_counter() - self._t0
        return False

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    def tick(self, n: int):
        if n % self.every == 0:
            self.progress.append(self.reading())
            self.log(self.progress_line(self.progress[-1]))


def at_depth(record: dict, depth: int, key: str, reading_key: str) -> dict:
    """A whole run's record cut to its reading at `depth` items (`record[key]`
    items in all, `reading[reading_key]` at each reading of its `progress`):
    what a run of that depth is held against. Raises ValueError where the
    record holds no reading there."""
    if record[key] == depth:
        return record
    for reading in record.get("progress", ()):
        if reading[reading_key] == depth:
            return dict(reading, **{key: depth})
    raise ValueError(f"the record ({record[key]} {key}) holds no reading at {key[:-1]} {depth}")
