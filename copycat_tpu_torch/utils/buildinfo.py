"""Process identity for liveness payloads: uptime and the build's git
SHA.

The supervisor's health watch and a rolling-restart check both poll
``/healthz``; without these two fields a freshly restarted child is
indistinguishable from one that was healthy all along (same ok/role
payload), and a half-rolled cluster is indistinguishable from a
finished one. ``uptime_s`` resets on restart; ``git_sha`` changes on
redeploy — together they answer both questions from the cheap route.

The SHA is resolved once per process (a subprocess on first use, cached
forever — ``/healthz`` must stay safe to poll at any frequency) and is
``None`` outside a git checkout (installed wheels, containers without
``.git``), which the payload reports honestly rather than guessing.
"""

from __future__ import annotations

import os
import time

#: process start anchor — import time is process start for every entry
#: point that serves /healthz (server, ingress, supervisor)
_STARTED_MONOTONIC = time.monotonic()

_GIT_SHA: tuple[str | None] | None = None


def process_uptime_s() -> float:
    """Seconds since this process imported the module (monotonic — wall
    clock jumps cannot fake a restart)."""
    return round(time.monotonic() - _STARTED_MONOTONIC, 1)


def git_sha() -> str | None:
    """The checkout's HEAD SHA, resolved once and cached; ``None`` when
    not running from a git checkout."""
    global _GIT_SHA
    if _GIT_SHA is None:
        import subprocess

        sha = None
        try:
            out = subprocess.run(
                ["git", "rev-parse", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=10)
            if out.returncode == 0:
                sha = out.stdout.strip() or None
        except (OSError, subprocess.SubprocessError):
            pass
        _GIT_SHA = (sha,)
    return _GIT_SHA[0]


def healthz_identity() -> dict:
    """The two fields every role's ``/healthz`` payload carries."""
    return {"uptime_s": process_uptime_s(), "git_sha": git_sha()}
