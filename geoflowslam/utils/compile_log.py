"""Compile-event accounting and the persistent compile cache.

Compile walls must never pass for compute: a timed window of a benchmark
should hold no compile events.

`install()` turns on jax_log_compiles, swallows the voluminous per-op trace
logs, and returns a CompileLog whose events (wall time, seconds, message)
can be split per benchmark phase. A healthy timed window has ZERO events.
"""
from __future__ import annotations

import logging
import os
import re
import time


class CompileLog(logging.Handler):
    """Captures "Finished XLA compilation of <name> in <t> sec" events."""

    RE = re.compile(r"in ([0-9.]+) sec")

    def __init__(self):
        super().__init__()
        self.events = []    # (wall_time, seconds, message)
        self.cache_notes = []   # persistent-cache hit/miss-explain lines

    def emit(self, record):
        msg = record.getMessage()
        if ("Persistent compilation cache" in msg
                or "PERSISTENT CACHE MISS" in msg):
            self.cache_notes.append(msg[:400])
            return
        # only actual backend compiles (tracing/lowering events are logged
        # too, thousands of them)
        if "XLA compilation" not in msg:
            return
        m = self.RE.search(msg)
        self.events.append((time.time(), float(m.group(1)) if m else 0.0,
                            msg[:120]))

    def split(self, *edges):
        """Per-phase {n, sec} for ascending wall-time boundaries `edges`
        (phase i = [edges[i], edges[i+1]); the last phase is open-ended)."""
        out = []
        for a, b in zip(edges, edges[1:] + (float("inf"),)):
            ev = [e for e in self.events if a <= e[0] < b]
            out.append({"n": len(ev), "sec": round(sum(e[1] for e in ev), 1)})
        return out

    def since(self, t0: float):
        ev = [e for e in self.events if e[0] >= t0]
        return {"n": len(ev), "sec": round(sum(e[1] for e in ev), 1)}


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".jax_cache")   # in .gitignore


def cache_dir() -> str:
    """Where compiled programs persist: JAX_COMPILATION_CACHE_DIR when set,
    else one fixed directory inside the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_persistent_cache(min_compile_secs: float = 0.2) -> str:
    """Turn on XLA's persistent compile cache at cache_dir(); every entry
    point calls this before its first jit dispatch. A cold run compiles
    about a hundred programs, so even short compiles are worth keeping.
    Returns the directory."""
    import jax
    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return d


def install(explain_misses: bool = False) -> CompileLog:
    """Enable compile logging, mute the stderr spam, return the capture.
    explain_misses=True additionally captures the persistent-cache
    hit/miss-explanation lines into CompileLog.cache_notes."""
    import jax
    jax.config.update("jax_log_compiles", True)
    if explain_misses:
        jax.config.update("jax_explain_cache_misses", True)
    clog = CompileLog()
    jlog = logging.getLogger("jax")
    jlog.handlers[:] = [clog]   # replace jax's stderr handler: per-op trace
    jlog.propagate = False      # logs are voluminous at WARNING level
    return clog
