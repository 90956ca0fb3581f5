"""What the tune cache needs of the JAX package's benchmark records: the
schema exception and the checkout's git sha."""

from __future__ import annotations

import functools
import os
import subprocess


class SchemaError(ValueError):
    """A results or cache document does not match the expected schema."""


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """Short sha of the checkout this code lives in ("unknown" off-git),
    resolved against this file's directory, not the process cwd."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10,
                             check=False,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else "unknown"
