"""Config / flag system and lightweight observability.

Counterpart of the reference's debug switches and counters (SURVEY.md §5.2,
§5.5-5.6): compile-time consts `DO_ASSERTS` / `ENABLE_INBOUNDS`
(reference src/Raycore.jl:55-72) become env-driven flags checked with
`real_assert`; counters exposed as API (`n_instances`, ...) live on the
scene objects; here we add the missing piece — a tiny timing/trace helper
around `jax.profiler` for the bench harness.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "off")


# Debug switches (reference DO_ASSERTS / ENABLE_INBOUNDS).
DO_ASSERTS = _env_flag("RAYCORE_DO_ASSERTS", False)
# Test-backend selector (reference RAYCORE_TEST_BACKEND; 'cpu' or 'gpu').
TEST_BACKEND = os.environ.get("RAYCORE_TEST_BACKEND", "cpu")


def real_assert(cond, msg: str = ""):
    """Host-side assertion active only when RAYCORE_DO_ASSERTS is set
    (reference @real_assert, src/Raycore.jl:55-62). For traced values use
    jax.debug / checkify upstream; this guards host invariants."""
    if DO_ASSERTS and not cond:
        raise AssertionError(msg or "real_assert failed")


@dataclass
class Timings:
    """min-of-N wall timing registry (the reference benches with
    BenchmarkTools warm+min-of-5; SURVEY.md §5.1)."""
    records: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def time(self, name: str, block=None):
        t0 = time.perf_counter()
        yield
        if block is not None:
            import jax
            jax.block_until_ready(block)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def best(self, name: str) -> float:
        return min(self.records[name])

    def summary(self) -> Dict[str, float]:
        return {k: min(v) for k, v in self.records.items()}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """jax.profiler trace scope (view with TensorBoard / xprof)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
