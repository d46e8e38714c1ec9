"""Profiling / benchmarking harness.

The reference has only ad-hoc chrono timers (SURVEY.md §5); this module
provides:
  - ``time_op``: host-clock timing around ``block_until_ready``
    (bench_util.time_host),
  - ``roofline_report``: GFLOP/s + fraction-of-GEMM-roofline for a sketch,
  - ``trace``: context manager wrapping jax.profiler for TensorBoard-level
    traces when a trace directory is given.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import jax

from .bench_util import time_host


@dataclasses.dataclass
class OpTiming:
    seconds: float
    flops: float

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9


def time_op(fn: Callable, *operands, flops: float,
            iters: int = 5) -> OpTiming:
    """Time ``fn(*operands)`` (jitted) on the host clock."""
    return OpTiming(seconds=time_host(fn, *operands, iters=iters),
                    flops=flops)


def roofline_report(sketch_timing: OpTiming, gemm_timing: OpTiming,
                    gen_bytes: Optional[float] = None) -> dict:
    """Summary dict: sketch GFLOP/s, roofline GFLOP/s, fraction, and the
    effective in-kernel generation bandwidth (bytes of operator produced
    per second) if gen_bytes is given."""
    rep = {
        "sketch_gflops": sketch_timing.gflops,
        "roofline_gflops": gemm_timing.gflops,
        "fraction_of_roofline": sketch_timing.gflops / gemm_timing.gflops,
    }
    if gen_bytes is not None:
        rep["gen_gbytes_per_s"] = gen_bytes / sketch_timing.seconds / 1e9
    return rep


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """jax.profiler trace context (no-op when trace_dir is None)."""
    if trace_dir is None:
        yield
        return
    with jax.profiler.trace(trace_dir):
        yield
