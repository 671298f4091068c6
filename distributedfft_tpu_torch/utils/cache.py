"""The home of the port's derived, hardware-keyed stores.

The JAX package's ``utils/cache.py`` points XLA at a persistent compile
cache and names its directory; the port compiles no XLA program (its
kernels build into ``distributedfft_tpu_torch/_build/``), so only the
directory remains: the default home of the tuner's wisdom store and the
calibrated hardware profile. Both are derived, keyed by the hardware,
and safe to delete.
"""

from __future__ import annotations

import os
import tempfile


def compile_cache_dir() -> str:
    """``DFFT_COMPILE_CACHE`` when set, else ``dfft_torch_cache`` under
    the temporary directory (``TMPDIR``). A directory of the port's own,
    apart from the JAX package's ``/tmp/dfft_xla_cache``: the two
    packages' wisdom keys differ and their stores must not mix."""
    env = os.environ.get("DFFT_COMPILE_CACHE", "").strip()
    if env:
        return env
    return os.path.join(tempfile.gettempdir(), "dfft_torch_cache")
