"""Phase-labelled timing spans + benchmark timing helpers.

Device counterpart of the reference's profiling toolbox: the `-Dprofiling`
`time_in_mill_now()` spans (nlibs/tools/ntimer.cc:3-9, used at phase
granularity e.g. static_omp_csr_kernel.cc:102-183) and the cudaEvent RAII
timer (nlibs/gpus/timer.h:32-56).  Device work is asynchronous under XLA,
so spans block on the produced arrays (`jax.block_until_ready`) the way the
cudaEvent timer synchronises the stream.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


def time_in_mill_now() -> float:
    """Wall-clock in milliseconds (ntimer.cc:3-9 parity)."""
    return time.monotonic() * 1e3


@dataclass
class Profiler:
    """Named phase spans; enable like the reference's -Dprofiling builds."""

    enabled: bool = True
    spans: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, block_on=None):
        # NOTE: block_on is evaluated at entry, so it can only synchronise
        # on arrays that exist BEFORE the span; block inside the span for
        # arrays produced by it (XLA dispatch is asynchronous).
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            self.spans.setdefault(name, []).append(
                (time.monotonic() - t0) * 1e3
            )

    def report(self) -> str:
        lines = []
        for name, times in self.spans.items():
            lines.append(
                f"{name}: n={len(times)} total={sum(times):.3f}ms "
                f"mean={sum(times)/len(times):.3f}ms"
            )
        return "\n".join(lines)


def bench_fn(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall-clock milliseconds of ``fn(*args)`` with device sync
    (the warm-up + timed-repeats pattern of perfTests/only-somp.cc)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.monotonic()
        jax.block_until_ready(fn(*args))
        times.append((time.monotonic() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def slope_bench(make_step, ks=(1, 4), iters: int = 3) -> float:
    """Steady-state ms/op via slope timing.

    ``make_step(x)`` receives a runtime-zero f32 scalar (a lax.scan
    element) and must fold it into its inputs (e.g. ``values + x``) so
    XLA can neither CSE nor hoist the op out of the repetition loop; its
    outputs are checksummed into the carry so nothing is dead-code
    eliminated.  Runs k repetitions inside ONE jitted scan for each k in
    ``ks`` and returns (T(k2) - T(k1)) / (k2 - k1): dispatch latency and
    host-fetch RTT cancel exactly.
    """
    import jax
    import jax.numpy as jnp

    def build(k):
        @jax.jit
        def f():
            def body(acc, x):
                outs = make_step(x)
                s = sum(
                    jnp.sum(o).astype(jnp.float32)
                    for o in jax.tree.leaves(outs)
                )
                return acc + s, None

            acc, _ = jax.lax.scan(body, jnp.float32(0.0), jnp.zeros(k))
            return acc

        return f

    times = {}
    for k in ks:
        f = build(k)
        float(f())  # compile + warm
        ts = []
        for _ in range(iters):
            t0 = time.monotonic()
            float(f())
            ts.append((time.monotonic() - t0) * 1e3)
        ts.sort()
        times[k] = ts[len(ts) // 2]
    k1, k2 = ks
    return max((times[k2] - times[k1]) / (k2 - k1), 1e-3)


def enable_compile_cache(path: str | None = None) -> None:
    """Point JAX's persistent compilation cache at a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing is set in
    code; otherwise the cache lives at ``<repo>/.jax_cache`` (a fixed
    path: the path is part of the cache key).  Called by the CLI drivers,
    bench.py and chip_smoke.py (not on library import — CPU test runs
    would bloat it).  SMF_NO_COMPILE_CACHE=1 disables."""
    import os

    if os.environ.get("SMF_NO_COMPILE_CACHE", "0") == "1":
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # explicit user choice wins
    import jax

    if path is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "..",
            ".jax_cache",
        )
    jax.config.update("jax_compilation_cache_dir", os.path.abspath(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
