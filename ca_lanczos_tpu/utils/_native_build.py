"""Content-addressed builds of the native helpers in ``native/``.

The shared objects are built on demand next to their sources and named by
a hash of the source text (``libspmm.<sha8>.so``): a prebuilt or stale
binary can never be loaded for edited sources.  Git checkouts do not
preserve mtimes, so mtime-based staleness (the previous scheme) could
silently load an old binary after a checkout (ADVICE r4); the binaries
are NOT committed (see .gitignore) — ``native/build.sh`` or the first
import builds them.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Optional, Sequence


def build_native(src: str, flags: Sequence[str]) -> Optional[str]:
    """Compile ``src`` to ``<stem>.<sha8>.so`` beside it (content hash of
    source + flags); reuse if already present.  Returns the .so path, or
    None when the source is missing or the compile fails."""
    src = os.path.abspath(src)
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        text = f.read()
    h = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:8]
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(os.path.dirname(src), f"lib{stem}.{h}.so")
    if os.path.exists(so):
        return so
    try:
        subprocess.run(
            ["g++", *flags, "-shared", "-fPIC", "-o", so, src],
            check=True, capture_output=True,
        )
    except Exception:
        return None
    return so if os.path.exists(so) else None
