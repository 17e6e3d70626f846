"""Architecture registry and assigned input shapes.

Every assigned arch (``ARCHS``) and port-only arch (``PORT_ARCHS``)
exposes ``CONFIG`` (exact published dims, or a stated share of them)
and ``SMOKE`` (reduced same-family config for CPU tests) in its module.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

ARCHS = [
    "whisper_medium",
    "minicpm_2b",
    "internlm2_20b",
    "nemotron_4_340b",
    "stablelm_1_6b",
    "mamba2_1_3b",
    "mixtral_8x22b",
    "granite_moe_1b_a400m",
    "recurrentgemma_2b",
    "llava_next_34b",
]

#: configurations of the port alone: the launcher takes them, but the
#: JAX package has none of them, so nothing pairs them with it
PORT_ARCHS = [
    "granite_4_0_h_small",
]

# assigned shape cells: (name, kind, seq_len, global_batch)
SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

# archs with sub-quadratic attention / O(1)-state decode run long_500k
LONG_OK = {"mamba2_1_3b", "recurrentgemma_2b", "mixtral_8x22b"}


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{_norm(arch)}", __package__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{_norm(arch)}", __package__)
    return mod.SMOKE


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped cells flagged."""
    out = []
    for arch in ARCHS:
        for shape, spec in SHAPES.items():
            skip = None
            if shape == "long_500k" and arch not in LONG_OK:
                skip = "full attention at 524288 context (DESIGN.md §5)"
            if skip is None or include_skipped:
                out.append({"arch": arch, "shape": shape, "skip": skip, **spec})
    return out


def scale_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)
