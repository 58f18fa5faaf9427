"""The one place that picks an implementation by platform.

Every other part of the pipeline has a single form on every platform, so
the CPU tests check the numerics the GPU runs:

* pyramid: the bilinear resize cascade (``orb.compute_pyramid``);
* per-cell top-k rounds: float32;
* IC angle + rBRIEF: plain XLA element gathers (``orb._ic_angles_gather``,
  ``orb._brief_descriptors_gather``).

What remains is a table of parts whose fastest form is a hand-written
kernel on one platform.  ``dispatch`` stages the choice with
``lax.platform_dependent``, so it is made when a program is lowered for a
device -- a program compiled for the CPU in a GPU process still takes the
XLA path.  A kernel that fails to lower raises; nothing falls back, and
no entry runs a kernel in interpret mode.
"""

from __future__ import annotations

from typing import Callable, Dict

import jax

XLA = "xla"
TRITON = "triton"

# part -> {lax.platform_dependent platform name -> implementation}; a
# platform not listed takes the XLA form.
TABLE: Dict[str, Dict[str, str]] = {
    # fused motion-only pose optimization (ops/pallas_pose.py) for
    # pinhole tracking
    "pose": {"cuda": TRITON},
}


def path(part: str, platform: str) -> str:
    """Implementation of ``part`` on ``platform`` (``"cpu"``, ``"cuda"``,
    ... as ``lax.platform_dependent`` names them; ``"gpu"`` means CUDA)."""
    if platform == "gpu":
        platform = "cuda"
    return TABLE[part].get(platform, XLA)


def dispatch(part: str, impls: Dict[str, Callable], *args):
    """``impls[path(part, p)](*args)`` for the platform ``p`` the program
    is lowered for.  ``impls`` maps implementation names to callables and
    must hold ``"xla"``."""
    branches = {p: impls[name] for p, name in TABLE[part].items()}
    return jax.lax.platform_dependent(*args, default=impls[XLA], **branches)
