"""Device probing for the port's entry points.

The port's copy of ``copycat_tpu/utils/platform.py``'s
``require_devices``: before an entry point touches the card, a child
process checks it (``torch.cuda.is_available()``, the device count and one
tiny launch) under a timeout, with retries, so a wedged CUDA stack or a card
that will not answer costs a bounded wait and a clear exit code instead of
a hang inside the entry point.

The reference's other helpers are XLA's and have no copy here:

- ``honor_jax_platforms_env`` re-asserts ``JAX_PLATFORMS`` against plugin
  config; the port's device pick is ``device.resolve_device`` (``cuda``
  unless the caller names another, raising without a card).
- ``enable_compilation_cache`` and ``_trim_cache_dir`` keep XLA's compiled
  programs across processes; the port's counterpart is the kernel build
  directory ``copycat_tpu_torch/_build/``, or the user's cache directory
  where the package's is read-only (``ops/kernels.py``: one shared object
  per source, keyed on the hash of the source and its headers).

Unlike the reference's bench, no port entry point falls back to the CPU
when every probe fails: the probe exits 2, and only a caller that asks for
``device="cpu"`` runs there.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from . import knobs

#: Set after one successful verification (per process).
_devices_verified: bool = False

#: Run in the child: the card is there, counted, and takes a launch.
_PROBE_CODE = """
import torch
if not torch.cuda.is_available():
    raise SystemExit("torch.cuda.is_available() is False")
n = torch.cuda.device_count()
got = int((torch.arange(4, device="cuda") + 1).sum())
if got != 10:
    raise SystemExit(f"a launch on the card returned {got}, not 10")
print(n, torch.cuda.get_device_name(0), flush=True)
"""


def _bind() -> int:
    """Bind the card in this process (the probe proved it healthy in a
    child): one tiny launch; returns the device count."""
    import torch

    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    return torch.cuda.device_count()


def _wants_card(device) -> bool:
    import torch

    return torch.device("cuda" if device is None else device).type == "cuda"


def require_devices(device=None,
                    env: str = "COPYCAT_DEVICE_TIMEOUT",
                    default_s: float = 120.0,
                    probes_env: str = "COPYCAT_DEVICE_PROBES",
                    default_probes: int = 5,
                    retry_wait_s: float = 60.0) -> None:
    """Exit 2 unless the card answers — with retries.

    Probes in child processes (a hung child is killed without wedging this
    process's CUDA context) up to ``default_probes`` times (``probes_env``),
    each bounded by ``default_s`` seconds (``env``), waiting
    ``retry_wait_s`` between attempts; then binds the card in this process
    under the same timeout. ``device`` is the device the entry point was
    asked for (``None`` means ``cuda``): for any other device type it
    returns at once. Call it before the first CUDA use.
    """
    global _devices_verified
    if _devices_verified or not _wants_card(device):
        return
    timeout_s = knobs.get_float(env, default=default_s)
    n_probes = max(1, knobs.get_int(probes_env, default=default_probes))
    err = sys.stderr

    for attempt in range(1, n_probes + 1):
        try:
            out = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                                 capture_output=True, text=True,
                                 timeout=timeout_s)
            if out.returncode == 0 and out.stdout.strip():
                print(f"devices (probe {attempt}/{n_probes}): "
                      f"{out.stdout.strip()}", file=err, flush=True)
                break
            detail = (out.stderr or out.stdout).strip()[-500:]
            print(f"probe {attempt}/{n_probes}: the card did not answer "
                  f"(rc={out.returncode}): {detail}", file=err, flush=True)
        except subprocess.TimeoutExpired:
            print(f"probe {attempt}/{n_probes}: no response within "
                  f"{timeout_s:.0f}s", file=err, flush=True)
        if attempt < n_probes:
            print(f"retrying in {retry_wait_s:.0f}s...", file=err, flush=True)
            time.sleep(retry_wait_s)
    else:
        print(f"FATAL: no CUDA card answered after {n_probes} probes "
              "(pass --device cpu to run on the CPU)", file=err, flush=True)
        raise SystemExit(2)

    result: dict = {}

    def bind() -> None:
        try:
            result["count"] = _bind()
        except Exception as e:  # noqa: BLE001 — report any CUDA error
            result["error"] = e

    t = threading.Thread(target=bind, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        print(f"FATAL: binding the card in-process hung for "
              f"{timeout_s:.0f}s after a healthy probe", file=err, flush=True)
        os._exit(2)  # the bind thread holds the CUDA context: hard exit
    if "error" in result:
        print(f"FATAL: binding the card failed: {result['error']!r}",
              file=err, flush=True)
        raise SystemExit(2)
    _devices_verified = True
