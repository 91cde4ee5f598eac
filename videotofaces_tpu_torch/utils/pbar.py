"""Progress reporting. tqdm ships with this environment; a tiny carriage-
return printer keeps the pipeline importable if it is ever absent."""

try:
    from tqdm.auto import tqdm  # type: ignore  # noqa: F401
except ImportError:  # pragma: no cover — tqdm is a baked-in dependency

    class tqdm:  # noqa: N801 — drop-in for the real API
        def __init__(self, total=None, unit=None, **_ignored):
            self.total, self.n = total, 0
            self._scale = 1024 ** 2 if unit == "B" else 1  # bytes -> MB

        def update(self, k):
            self.n += k
            done = self.n // self._scale
            if self.total:
                goal = self.total // self._scale
                print("\r%d/%d (%d%%)" % (done, goal, 100 * done // max(goal, 1)),
                      end="", flush=True)
            else:
                print("\r%d" % done, end="", flush=True)

        def close(self):
            print("\r")

        def __enter__(self):
            return self

        def __exit__(self, *_exc):
            self.close()
