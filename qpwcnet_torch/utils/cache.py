"""file_cache (the port's copy of qpwcnet_tpu/utils/cache.py): a
function's JSON-serializable result cached on disk under a name."""

from __future__ import annotations

import functools
import json
import os
from pathlib import Path


def default_cache_dir() -> Path:
    """``$QPWCNET_TORCH_CACHE``, else ``~/.cache/qpwcnet_torch``, read at
    each call."""
    return Path(os.environ.get("QPWCNET_TORCH_CACHE",
                               "~/.cache/qpwcnet_torch")).expanduser()


def file_cache(name: str, cache_dir: Path | None = None):
    """Decorator: fn()'s result cached as JSON at <cache_dir>/<name>.json
    (:func:`default_cache_dir` by default), and read from there once it exists.
    The name is the whole key: the arguments are not."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            d = Path(cache_dir or default_cache_dir())
            d.mkdir(parents=True, exist_ok=True)
            path = d / f"{name}.json"
            if path.exists():
                with open(path) as f:
                    return json.load(f)
            result = fn(*args, **kwargs)
            with open(path, "w") as f:
                json.dump(result, f)
            return result

        return wrapped

    return decorator
