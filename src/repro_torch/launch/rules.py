"""Per-(arch, shape, mesh) sharding-rule overrides — the §Perf lever.

``rules_for`` starts from ``sharding.DEFAULT_RULES`` and applies
arch/shape-specific overrides. Hillclimb iterations land here so every
perf experiment is reproducible from the config alone.
"""
from __future__ import annotations

from .. import sharding

# baseline overrides (paper-faithful runs = defaults; entries below are
# required for memory feasibility, documented in EXPERIMENTS.md §Dry-run)
_ARCH_RULES: dict[str, dict] = {
    # 340B params: ZeRO over pod+data so params+opt fit 512 chips
    "nemotron_4_340b": {"fsdp": ("data", "pod")},
    # 141B total: same treatment
    "mixtral_8x22b": {"fsdp": ("data", "pod")},
    "llava_next_34b": {"fsdp": ("data", "pod")},
}

# shape-specific overrides
_SHAPE_RULES: dict[str, dict] = {
    # decode_32k: shard the KV-cache sequence axis over 'model'
    # (sequence-parallel attention; XLA inserts the softmax collectives)
    "decode_32k": {"kv_seq": "model"},
    # long_500k has batch=1: batch falls back to replicated automatically
    "long_500k": {"kv_seq": "model"},
}

# hillclimbed overrides (EXPERIMENTS.md §Perf); keyed (arch, shape)
# (i5 tried {"seq": "model"} sequence parallelism for nemotron train_4k:
# temp memory 107 GB -> 33 GB but collectives 156 s -> 440 s; kept OFF for
# step time — re-enable when HBM, not ICI, is the binding constraint.)
# (i7 tried {"head_dim": "model"} for nemotron train_4k to turn the GQA
# KV-projection grad all-reduce into a reduce-scatter: collective went
# 155 s -> 183 s — the hd-sharded K/V pushed communication into the
# attention score contraction instead. Reverted.)
_PERF_RULES: dict[tuple, dict] = {
}


def rules_for(arch: str, shape: str, *, multi_pod: bool,
              override: dict | None = None) -> dict:
    return sharding.merge_rules(
        _ARCH_RULES.get(arch, {}),
        _SHAPE_RULES.get(shape, {}),
        _PERF_RULES.get((arch, shape), {}),
        override or {},
    )
