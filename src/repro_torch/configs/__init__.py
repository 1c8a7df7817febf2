"""Architecture config registry of the port.

Only what the port runs is registered: each module defines ``CONFIG``
(the full-size spec) and ``SMOKE`` (a reduced same-family variant used by
the CPU tests). Any other name raises ``KeyError``.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "gector-base": "gector_base",
    "qwen2-0.5b": "qwen2_0_5b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "stablelm-12b": "stablelm_12b",
    "gemma2-27b": "gemma2_27b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a6_6b",
    "xlstm-125m": "xlstm_125m",
}


def get_config(name: str, smoke: bool = False):
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not yet ported to repro_torch; "
                       f"ported: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG
