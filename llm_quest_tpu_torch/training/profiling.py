"""Profiling and throughput instrumentation (counterpart of
``llm_quest_tpu/training/profiling.py``).

``torch.profiler`` takes the place of ``jax.profiler``: a trace records the
host's operators and, with a card present, its kernels (CUPTI), and is
written as a Chrome trace (``trace.json``, readable in Perfetto or
``chrome://tracing``). Memory readings come from ``torch.cuda``'s allocator
statistics.

- ``profile_trace``: a context manager tracing its body into ``logdir``.
- ``ScheduledProfiler``: JAX's wait / warmup / active / repeat schedule,
  stepped once a training step; the warm-up steps are not traced (as in
  JAX), each active window goes to ``logdir/cycle_<k>``.
- ``device_memory_gb``: (allocated GB, card GB) of a CUDA device; (0, 0)
  for the CPU, which has no such statistics (JAX's answer for a backend
  without memory stats).
- ``ThroughputMeter``: interval and cumulative tokens a second, memory and,
  with ``flops_per_token``, MFU.
- ``debug_checks``: ``nans`` and ``infs`` turn on
  ``torch.autograd.set_detect_anomaly``, which raises at the backward
  operator that made a NaN (JAX's ``jax_debug_nans`` / ``jax_debug_infs``
  raise at any operator, forward too). ``disable_jit`` is accepted and does
  nothing: the port runs eagerly, op by op, already.
"""

import contextlib
import os
import time

import torch

from llm_quest_tpu_torch.config import resolve_device


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start(with_memory=True):
    prof = torch.profiler.profile(activities=_activities(), profile_memory=with_memory, record_shapes=with_memory)
    prof.__enter__()
    return prof


def _stop(prof, logdir):
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # queued kernels land inside the trace
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def profile_trace(logdir, *, with_memory=True):
    """Trace the body into ``logdir/trace.json``; yields the
    ``torch.profiler.profile`` (its ``key_averages()`` is readable after
    the block)."""
    prof = _start(with_memory)
    try:
        yield prof
    finally:
        _stop(prof, str(logdir))


class ScheduledProfiler:
    """Step-scheduled trace capture. Call ``step()`` once a training step.
    Each cycle runs ``wait`` untraced steps, then ``warmup`` untraced steps,
    then traces exactly ``active`` steps into ``logdir/cycle_<k>``; after
    ``repeat`` cycles it goes inert (``repeat`` 0: forever). ``step()``
    returns True while the step just taken was traced. Use as a context
    manager (or call ``close()``) so a trace in flight is written on an
    early exit."""

    def __init__(self, logdir, *, wait=2, warmup=2, active=3, repeat=1):
        assert active >= 1, "active window must trace at least one step"
        self.logdir = str(logdir)
        self.wait, self.warmup, self.active, self.repeat = wait, warmup, active, repeat
        self._i = 0
        self._cycle = 0
        self._prof = None

    @property
    def cycle_len(self):
        return self.wait + self.warmup + self.active

    def _finish(self):
        _stop(self._prof, f"{self.logdir}/cycle_{self._cycle}")
        self._prof = None

    def step(self):
        """Advance one step; returns True while the profiler is tracing."""
        if self.repeat and self._cycle >= self.repeat:
            return False
        pos = self._i
        self._i += 1
        if pos == self.wait + self.warmup and self._prof is None:
            self._prof = _start()
        if pos == self.cycle_len - 1:
            if self._prof is not None:
                self._finish()
            self._i = 0
            self._cycle += 1
            return True  # this step was the last traced one
        return self._prof is not None

    def close(self):
        if self._prof is not None:
            self._finish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def device_memory_gb(device=None):
    """(allocated_gb, total_gb) of a CUDA ``device`` (default: the card,
    ``config.resolve_device``); (0.0, 0.0) for the CPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        return 0.0, 0.0
    return torch.cuda.memory_allocated(device) / 1e9, torch.cuda.get_device_properties(device).total_memory / 1e9


class ThroughputMeter:
    """Interval and cumulative tokens a second. ``flops_per_token`` (e.g.
    ``training/flops.py::text_train_flops_per_token``) adds MFU beside each
    rate; ``device`` is the card whose memory and peak are read (default:
    the current one; "cpu" reports no memory and takes no MFU)."""

    def __init__(self, flops_per_token=None, device=None):
        self.t0 = time.perf_counter()
        self.t_last = self.t0
        self.tokens_total = 0
        self.tokens_interval = 0
        self.flops_per_token = flops_per_token
        self.device = resolve_device(device)

    def update(self, num_tokens):
        self.tokens_total += num_tokens
        self.tokens_interval += num_tokens

    def report(self):
        """Dict of interval / cumulative tok/s and memory (+ MFU with
        ``flops_per_token`` on a card); resets the interval."""
        now = time.perf_counter()
        interval = self.tokens_interval / max(now - self.t_last, 1e-9)
        cumulative = self.tokens_total / max(now - self.t0, 1e-9)
        self.t_last = now
        self.tokens_interval = 0
        alloc, limit = device_memory_gb(self.device)
        out = {
            "tok_s_interval": interval,
            "tok_s_cumulative": cumulative,
            "mem_gb_allocated": alloc,
            "mem_gb_limit": limit,
        }
        if self.flops_per_token is not None and self.device.type == "cuda":
            from llm_quest_tpu_torch.training.flops import mfu

            out["mfu_interval"] = mfu(interval, self.flops_per_token, device=self.device)
            out["mfu_cumulative"] = mfu(cumulative, self.flops_per_token, device=self.device)
        return out


@contextlib.contextmanager
def debug_checks(*, nans=True, infs=False, disable_jit=False):
    """Numerics-debug mode: with ``nans`` or ``infs``, autograd's anomaly
    detection (a backward operator that returns NaN raises, naming the
    forward operator that made it). ``disable_jit`` is accepted for JAX's
    signature and changes nothing (module docstring)."""
    del disable_jit
    if not (nans or infs):
        yield
        return
    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        yield
