"""Hand-written CUDA kernels of the port (Hopper, sm_90a), each beside its
plain PyTorch version: the scheduler's decision path (``sched_weigh``,
``sched_screen``), the model-serving path (``flash_attention``, ``rmsnorm``)
and the training path (the flash-attention backward: dq and dk/dv).

The tensor's device picks the version: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel or raises.  Every kernel wrapper counts its
launches; :func:`launch_counts` reads the counts and
:func:`reset_launch_counts` sets them to 0, so a run can show that the main
path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from ..core.screen_math import TIE_EPS
from . import flash_attention as _flash_attention_mod
from . import rmsnorm as _rmsnorm_mod
from . import sched_screen as _sched_screen_mod
from . import sched_weigh as _sched_weigh_mod
from .flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from .rmsnorm import rmsnorm, rmsnorm_plain
from .sched_screen import (
    sched_screen,
    sched_screen_consts,
    sched_screen_consts_plain,
    sched_screen_topm,
    sched_screen_topm_plain,
)
from .sched_weigh import sched_weigh, sched_weigh_gathered, sched_weigh_plain

_COUNTERS = (_sched_weigh_mod.LAUNCHES, _sched_screen_mod.LAUNCHES,
             _flash_attention_mod.LAUNCHES, _rmsnorm_mod.LAUNCHES)

#: the CUDA sources, one ``nvcc`` run each (``_build.build``).
SOURCES = ("sched_weigh", "sched_screen", "flash_attention", "flash_attention_bwd", "rmsnorm")


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for key in c:
            c[key] = 0


__all__ = [
    "SOURCES",
    "TIE_EPS",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_plain",
    "launch_counts",
    "reset_launch_counts",
    "rmsnorm",
    "rmsnorm_plain",
    "sched_screen",
    "sched_screen_consts",
    "sched_screen_consts_plain",
    "sched_screen_topm",
    "sched_screen_topm_plain",
    "sched_weigh",
    "sched_weigh_gathered",
    "sched_weigh_plain",
]
