"""Executable environment profiles — the single source of truth for the
paper's provider x machine matrix (Table 1 specs + Table 5 prices).

Before this module existed the machine specs and prices lived as literals
inside ``core.environments`` (and the cost arithmetic re-derived hourly
prices on its own); now ``core.environments.INSTANCES`` is a re-export of
``PROFILES`` and every consumer — the static cost model, the live
experiment runner, the drift report — prices a machine through exactly one
record. A profile is *executable* in the deployment-lab sense: the runner
binds one to an engine run and the record carries its specs + hourly price
so measured throughput converts to $/1M sentences per profile.

One beyond-paper row (TPU/T) is kept for cost comparison; it is excluded
from all paper-claim validations (``paper_profiles()``).

A copy of ``repro/deploy/profiles.py`` with names, signatures and
records unchanged: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

NS_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
LATENCY_SLO_S = 2.0                 # the paper's acceptability threshold
HOURS_PER_MONTH = 730.0             # the pricing convention behind Table 5

PROVIDERS = ("AWS", "GCP", "Azure")
MACHINES = tuple("ABCDEFG")


@dataclasses.dataclass(frozen=True)
class EnvironmentProfile:
    """One provider x machine execution environment (paper Table 1 + 5)."""
    provider: str
    machine: str                    # class letter A..G (T = beyond-paper)
    instance_type: str
    processor: str
    clock_ghz: float
    vcpus: int
    cache_gb: Optional[float]       # L2+L3; None for GPU machines (unlisted)
    ram_gb: int
    gpu: Optional[str]
    monthly_cost_usd: float

    @property
    def key(self) -> str:
        return f"{self.provider}/{self.machine}"

    @property
    def hourly_cost_usd(self) -> float:
        return self.monthly_cost_usd / HOURS_PER_MONTH

    @property
    def is_gpu(self) -> bool:
        return self.gpu is not None

    def spec_dict(self) -> dict:
        """The record-schema view the experiment runner embeds in JSONL."""
        return {"provider": self.provider, "machine": self.machine,
                "instance_type": self.instance_type,
                "processor": self.processor, "clock_ghz": self.clock_ghz,
                "vcpus": self.vcpus, "cache_gb": self.cache_gb,
                "ram_gb": self.ram_gb, "gpu": self.gpu,
                "monthly_cost_usd": self.monthly_cost_usd,
                "hourly_cost_usd": self.hourly_cost_usd}


PROFILES: Tuple[EnvironmentProfile, ...] = (
    # ---- AWS ----
    EnvironmentProfile("AWS", "A", "c6a.xlarge", "AMD EPYC 7R13",
                       2.95, 4, 2, 8, None, 110.16),
    EnvironmentProfile("AWS", "B", "c6a.2xlarge", "AMD EPYC 7R13",
                       2.95, 8, 2, 16, None, 220.32),
    EnvironmentProfile("AWS", "C", "t2.xlarge", "Intel Xeon Scalable",
                       3.3, 4, 4, 16, None, 133.63),
    EnvironmentProfile("AWS", "D", "inf1.xlarge",
                       "Intel Xeon Platinum 8275CL", 3.0, 4, 2, 8, None,
                       164.16),
    EnvironmentProfile("AWS", "E", "inf1.2xlarge",
                       "Intel Xeon Platinum 8275CL", 3.0, 8, 2, 16, None,
                       260.64),
    EnvironmentProfile("AWS", "F", "g4dn.xlarge",
                       "Intel Xeon Platinum 8259CL", 2.5, 4, None, 16,
                       "NVIDIA T4", 378.72),
    EnvironmentProfile("AWS", "G", "g4dn.2xlarge",
                       "Intel Xeon Platinum 8259CL", 2.5, 8, None, 32,
                       "NVIDIA T4", 541.44),
    # ---- GCP ----
    EnvironmentProfile("GCP", "A", "n2d-custom-4-8192",
                       "AMD EPYC Milan 7B13", 3.5, 4, 2, 8, None, 100.44),
    EnvironmentProfile("GCP", "B", "n2d-custom-8-16384",
                       "AMD EPYC Milan 7B13", 3.5, 8, 2, 16, None, 200.87),
    EnvironmentProfile("GCP", "C", "n2-custom-8-16384",
                       "Intel Xeon Gold 6268CL", 3.9, 4, 4, 16, None,
                       230.89),
    EnvironmentProfile("GCP", "D", "c3-highcpu-4",
                       "Intel Xeon Platinum 8481C", 3.3, 4, 2, 8, None,
                       124.10),
    EnvironmentProfile("GCP", "E", "c3-highcpu-8",
                       "Intel Xeon Platinum 8481C", 3.3, 8, 2, 16, None,
                       248.21),
    EnvironmentProfile("GCP", "F", "n1-standard-4",
                       "Intel Xeon Platinum 8173M", 3.5, 4, None, 16,
                       "NVIDIA T4", 388.80),
    EnvironmentProfile("GCP", "G", "n1-standard-8",
                       "Intel Xeon Platinum 8173M", 3.5, 8, None, 32,
                       "NVIDIA T4", 525.60),
    # ---- Azure ----
    EnvironmentProfile("Azure", "A", "standard_B4als_v2",
                       "AMD EPYC Milan 7763v", 3.5, 4, 2, 8, None, 95.76),
    EnvironmentProfile("Azure", "B", "standard_B8als_v2",
                       "AMD EPYC Milan 7763v", 3.5, 8, 2, 16, None, 191.52),
    EnvironmentProfile("Azure", "C", "standard_D8lds_v5",
                       "Intel Xeon Platinum 8370C", 3.5, 4, 4, 16, None,
                       276.48),
    EnvironmentProfile("Azure", "D", "standard_F4s_v2",
                       "Intel Xeon Platinum 8370C", 3.7, 4, 2, 8, None,
                       121.68),
    EnvironmentProfile("Azure", "E", "standard_F8s_v2",
                       "Intel Xeon Platinum 8370C", 3.7, 8, 2, 16, None,
                       243.36),
    EnvironmentProfile("Azure", "F", "standard_NC4as_T4_v3",
                       "AMD EPYC Rome 7V12", 3.3, 4, None, 28, "NVIDIA T4",
                       383.98),
    EnvironmentProfile("Azure", "G", "standard_NC8as_T4_v3",
                       "AMD EPYC Rome 7V12", 3.3, 8, None, 56, "NVIDIA T4",
                       548.96),
    # ---- beyond-paper reference point (not part of claim validation) ----
    EnvironmentProfile("TPU", "T", "v5e-1", "TPU v5e (197 TF bf16)",
                       0.94, 8, None, 16, "TPU v5e", 850.0),
)


def profile(provider: str, machine: str) -> EnvironmentProfile:
    for p in PROFILES:
        if p.provider == provider and p.machine == machine:
            return p
    raise KeyError((provider, machine))


def profile_by_key(key: str) -> EnvironmentProfile:
    """Look up by the 'AWS/C' form the CLI and JSONL records use."""
    provider, _, machine = key.partition("/")
    return profile(provider, machine)


def paper_profiles() -> Tuple[EnvironmentProfile, ...]:
    """The 21 scenarios the paper actually ran (no beyond-paper rows)."""
    return tuple(p for p in PROFILES if p.provider in PROVIDERS)
