"""Background hardware telemetry — the deployment lab's Prometheus role.

The paper samples vCPU% and RAM% once per load cell; this module
generalizes ``core.loadtest``'s aggregate ``CpuSampler`` into a ring-buffer
*timeline*: a daemon thread samples per-core CPU utilisation, RAM%, and a
page-fault-rate proxy for cache/memory pressure (no perf counters in the
container, so ``/proc/vmstat`` ``pgfault`` deltas stand in) at a fixed
period, and ``TelemetryTimeline.summary()`` reduces any window of it to the
percentile statistics an ``ExperimentRecord`` carries. ``CpuSampler`` is
kept as the aggregate-only compatibility view that ``core.loadtest``
imports back — the /proc parsing lives only here.

All parsing tolerates a missing /proc (non-Linux hosts): readers return
``None`` and summaries mark the series absent instead of raising.

A copy of ``repro/deploy/telemetry.py`` with names, signatures and
records unchanged: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple


def read_proc_stat() -> Optional[Tuple[int, int]]:
    """Aggregate (total, idle) jiffies from the first /proc/stat line."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
    except OSError:
        return None
    vals = list(map(int, parts[1:]))
    idle = vals[3] + vals[4]
    return sum(vals), idle


def read_proc_stat_percpu() -> Optional[List[Tuple[int, int]]]:
    """Per-core (total, idle) jiffies from the cpuN lines of /proc/stat."""
    try:
        with open("/proc/stat") as f:
            lines = f.readlines()
    except OSError:
        return None
    out = []
    for line in lines:
        parts = line.split()
        if not parts or not parts[0].startswith("cpu") or parts[0] == "cpu":
            continue
        vals = list(map(int, parts[1:]))
        out.append((sum(vals), vals[3] + vals[4]))
    return out or None


def read_ram_pct() -> Optional[float]:
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":")
                info[k] = int(v.split()[0])
        return 100.0 * (1 - info["MemAvailable"] / info["MemTotal"])
    except (OSError, KeyError, ValueError):
        return None


def read_pgfaults() -> Optional[int]:
    """Cumulative page faults — the cache/memory-pressure proxy counter."""
    try:
        with open("/proc/vmstat") as f:
            for line in f:
                if line.startswith("pgfault "):
                    return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return None


def _util_pct(cur: Tuple[int, int], prev: Tuple[int, int]) -> Optional[float]:
    dt, didle = cur[0] - prev[0], cur[1] - prev[1]
    if dt <= 0:
        return None
    return 100.0 * (1 - didle / dt)


@dataclasses.dataclass(frozen=True)
class TelemetrySample:
    """One telemetry tick (all percentages 0..100). Any series can be None
    when the host can't expose it (e.g. containers whose /proc/stat reports
    frozen jiffies) — a tick is still recorded so the other series keep
    their timeline."""
    t_s: float                         # seconds since sampler start
    cpu_pct: Optional[float]           # aggregate utilisation
    per_core_pct: Tuple[float, ...]    # () when per-core sampling is off
    ram_pct: Optional[float]
    pgfaults_per_s: Optional[float]    # cache/memory-pressure proxy


def _series_summary(vals: Sequence[float]) -> Optional[dict]:
    if not vals:
        return None
    import numpy as np
    arr = np.asarray(vals, float)
    return {"mean": float(arr.mean()),
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "max": float(arr.max())}


@dataclasses.dataclass
class TelemetryTimeline:
    """A (possibly windowed) sequence of samples + its reductions.

    Constructable directly from synthetic samples in tests; the sampler
    produces one via ``timeline()``/``window()``.
    """
    samples: Tuple[TelemetrySample, ...]

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def duration_s(self) -> float:
        if len(self.samples) < 2:
            return 0.0
        return self.samples[-1].t_s - self.samples[0].t_s

    def summary(self) -> dict:
        """Percentile reductions per series — the ExperimentRecord payload.

        ``ram_spread_pct`` (max - min) is the quantity behind the paper's
        RAM-non-interference finding; ``core_imbalance_pct`` (hottest core
        mean minus aggregate mean) exposes single-thread bottlenecks the
        paper's aggregate vCPU% column hides.
        """
        cpu = [s.cpu_pct for s in self.samples if s.cpu_pct is not None]
        ram = [s.ram_pct for s in self.samples if s.ram_pct is not None]
        pgf = [s.pgfaults_per_s for s in self.samples
               if s.pgfaults_per_s is not None]
        out = {"n_samples": len(self.samples),
               "duration_s": self.duration_s,
               "cpu_pct": _series_summary(cpu),
               "ram_pct": _series_summary(ram),
               "pgfaults_per_s": _series_summary(pgf)}
        if ram:
            out["ram_spread_pct"] = float(max(ram) - min(ram))
        cores = [s.per_core_pct for s in self.samples if s.per_core_pct]
        if cores and cpu:
            n = min(len(c) for c in cores)
            per_core_mean = [sum(c[i] for c in cores) / len(cores)
                             for i in range(n)]
            out["core_count"] = n
            out["hottest_core_mean_pct"] = max(per_core_mean)
            out["core_imbalance_pct"] = (max(per_core_mean)
                                         - sum(cpu) / len(cpu))
        return out


class HardwareSampler:
    """Daemon-thread sampler filling a bounded ring buffer of samples.

    Context-manager protocol like the old ``CpuSampler``; additionally a
    ``mark()``/``window()`` pair so one long-lived sampler can attribute
    samples to successive experiment windows (mirroring
    ``ServingEngine.window()`` for engine counters).
    """

    def __init__(self, period_s: float = 0.1, *, maxlen: int = 4096,
                 per_core: bool = True, sample_pgfaults: bool = True):
        self.period = period_s
        self._buf: "collections.deque[TelemetrySample]" = \
            collections.deque(maxlen=maxlen)
        self._stop = threading.Event()
        self._t: Optional[threading.Thread] = None
        self._per_core = per_core
        self._pgfaults = sample_pgfaults
        # window boundary: t_s of the last sample already attributed to a
        # window. Extent-based (not wall-clock) so a sample appended while
        # window()/mark() runs shifts into the next window, never vanishes.
        self._last_t = -1.0
        self.evicted_samples = 0       # ring overwrote this many (total)
        self._t0: Optional[float] = None

    # ------------------------------------------------------------ control
    def __enter__(self) -> "HardwareSampler":
        import time
        self._t0 = time.perf_counter()

        def run():
            prev = read_proc_stat()
            prev_cores = read_proc_stat_percpu() if self._per_core else None
            prev_pgf = read_pgfaults() if self._pgfaults else None
            prev_t = 0.0
            while not self._stop.wait(self.period):
                now = time.perf_counter() - self._t0
                cur = read_proc_stat()
                cpu = (None if cur is None or prev is None
                       else _util_pct(cur, prev))
                prev = cur
                cores: Tuple[float, ...] = ()
                if self._per_core:
                    cur_cores = read_proc_stat_percpu()
                    if cur_cores and prev_cores \
                            and len(cur_cores) == len(prev_cores):
                        cores = tuple(
                            u for u in (_util_pct(c, p) for c, p in
                                        zip(cur_cores, prev_cores))
                            if u is not None)
                    prev_cores = cur_cores
                pgf_rate = None
                if self._pgfaults:
                    cur_pgf = read_pgfaults()
                    if (cur_pgf is not None and prev_pgf is not None
                            and now > prev_t):
                        pgf_rate = (cur_pgf - prev_pgf) / (now - prev_t)
                    prev_pgf = cur_pgf
                if len(self._buf) == self._buf.maxlen:
                    self.evicted_samples += 1
                self._buf.append(TelemetrySample(
                    t_s=now, cpu_pct=cpu, per_core_pct=cores,
                    ram_pct=read_ram_pct(), pgfaults_per_s=pgf_rate))
                prev_t = now

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc) -> bool:
        self._stop.set()
        if self._t is not None:
            self._t.join(timeout=2)
        return False

    # ------------------------------------------------------------- access
    def sample_now(self) -> Optional[TelemetrySample]:
        """Take one synchronous sample (no CPU delta — cpu_pct is None) so
        a window shorter than the period still records RAM/host state."""
        import time
        if self._t0 is None:
            return None
        s = TelemetrySample(t_s=time.perf_counter() - self._t0,
                            cpu_pct=None, per_core_pct=(),
                            ram_pct=read_ram_pct(), pgfaults_per_s=None)
        self._buf.append(s)
        return s

    def timeline(self) -> TelemetryTimeline:
        """All buffered samples (oldest may have been evicted by the ring)."""
        return TelemetryTimeline(tuple(self._buf))

    def mark(self) -> None:
        """Start a new attribution window: everything currently buffered
        belongs to the previous window."""
        snap = tuple(self._buf)    # atomic C call, safe vs appender thread
        if snap:
            self._last_t = snap[-1].t_s

    def window(self) -> TelemetryTimeline:
        """Samples since the last ``mark()``/``window()`` (then advances
        the boundary to the snapshot's extent, so a concurrent append only
        shifts a sample into the next window)."""
        snap = tuple(self._buf)
        tl = TelemetryTimeline(tuple(s for s in snap
                                     if s.t_s > self._last_t))
        if snap:
            self._last_t = snap[-1].t_s
        return tl


class CpuSampler(HardwareSampler):
    """Aggregate-CPU% compatibility view (the old ``loadtest.CpuSampler``
    surface: ``.samples`` list of floats + ``.mean``); per-core and
    page-fault sampling off to keep the ladder's per-tick cost identical."""

    def __init__(self, period_s: float = 0.1):
        super().__init__(period_s, per_core=False, sample_pgfaults=False)

    @property
    def samples(self) -> List[float]:
        return [s.cpu_pct for s in self._buf if s.cpu_pct is not None]

    @property
    def mean(self) -> float:
        vals = self.samples
        return float(sum(vals) / len(vals)) if vals else 0.0
