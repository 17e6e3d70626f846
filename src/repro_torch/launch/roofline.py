"""Roofline terms of a dry-run record, at an H100 SXM's rates.

The three terms come from the per-device counts the dry-run gathers
while it runs one step over ``meta`` DTensors (``launch.dryrun``):

  compute_s    = sum over dtypes of flops_per_device at the dtype's
                 peak (bf16 989e12, float32 67e12 FLOP/s)
  memory_s     = bytes_per_device / 3.35e12              [HBM3]
  collective_s = sum over collectives of ring-model time at 50 GB/s

Ring-model factors, op for op as the reference's: all-reduce moves
2(n-1)/n x bytes, all-gather, reduce-scatter and all-to-all (n-1)/n x
bytes, collective-permute 1 x bytes, where bytes is the op's per-device
result and n its group size. The reference reads the ops from XLA's HLO
text; here they are records ``(op, bytes, group size)`` that the
dry-run's collective counter writes.
"""
from __future__ import annotations

# H100 SXM5 dense BF16 tensor-core peak without sparsity (NVIDIA H100
# Tensor Core GPU datasheet: 1,979 TFLOP/s with sparsity, half dense)
PEAK_FLOPS = 989e12      # bf16 / device
# per dtype of a product's inputs: bf16 at the dense tensor-core peak;
# float32 at 67 TFLOP/s outside the tensor cores (the port runs its
# float32 products with TF32 off; datasheet: FP32 67 TFLOP/s). The port's
# products take no other dtype.
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float32": 67e12}
# H100 SXM5 HBM3 bandwidth (NVIDIA H100 datasheet, 80 GB SXM: 3.35 TB/s)
HBM_BW = 3.35e12         # bytes/s / device
# per-GPU inter-node bandwidth of a mesh wider than one 8-GPU node: one
# 400 Gb/s NDR InfiniBand port per GPU (DGX H100: eight ConnectX-7 NDR
# 400 Gb/s ports) = 50 GB/s
LINK_BW = 50e9           # bytes/s / device

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_seconds(op: str, nbytes: int, n: int) -> float:
    """Seconds of one collective of ``op`` moving ``nbytes`` per device
    over a group of ``n``, by the ring model."""
    if op == "all-reduce":
        return 2.0 * nbytes * (n - 1) / max(n, 1) / LINK_BW
    if op in ("all-gather", "all-to-all", "reduce-scatter"):
        return nbytes * (n - 1) / max(n, 1) / LINK_BW
    if op == "collective-permute":
        return nbytes / LINK_BW
    raise ValueError(f"unknown collective {op!r}")


def collective_stats(records, n_devices: int) -> dict:
    """Per-device collective byte counts + ring-model seconds by op type.

    ``records``: ``(op, bytes, group size)`` triples, op one of
    :data:`COLLECTIVES`; a group size of None means all ``n_devices``.
    """
    out = {k: {"bytes": 0, "count": 0, "seconds": 0.0} for k in COLLECTIVES}
    for op, nbytes, n in records:
        n = n_devices if n is None else n
        out[op]["bytes"] += nbytes
        out[op]["count"] += 1
        out[op]["seconds"] += ring_seconds(op, nbytes, n)
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    out["total_seconds"] = sum(v["seconds"] for v in out.values()
                               if isinstance(v, dict))
    return out


def roofline(record: dict, n_devices: int,
             model_flops: float | None = None) -> dict:
    """All three terms + bookkeeping from a dry-run record: ``flops``
    per device by dtype name (``{"bfloat16": ..., "float32": ...}``),
    ``bytes`` per device, ``collectives`` (records as
    :func:`collective_stats` takes them) and ``memory`` (a dict, or
    "not measured")."""
    by_dtype = {k: float(v) for k, v in record["flops"].items()}
    flops_dev = sum(by_dtype.values())
    bytes_dev = float(record["bytes"])
    coll = collective_stats(record["collectives"], n_devices)
    terms = {
        "chips": n_devices,
        "flops_per_device": flops_dev,
        "flops_global": flops_dev * n_devices,
        "bytes_per_device": bytes_dev,
        "flops_by_dtype": by_dtype,
        "compute_s": sum(f / PEAK_FLOPS_BY_DTYPE[k]
                         for k, f in by_dtype.items()),
        "memory_s": bytes_dev / HBM_BW,
        "collective_s": coll["total_seconds"],
        "collective_bytes_per_device": coll["total_bytes"],
        "collectives": {k: coll[k] for k in COLLECTIVES},
        "memory": record["memory"],
    }
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=lambda k: terms[k])
    terms["dominant"] = dominant
    terms["step_time_lower_bound_s"] = max(
        terms["compute_s"], terms["memory_s"], terms["collective_s"])
    if model_flops:
        terms["model_flops"] = model_flops
        terms["useful_flops_ratio"] = (model_flops / terms["flops_global"]
                                       if terms["flops_global"] else 0.0)
        terms["mfu_upper_bound"] = model_flops / (
            n_devices * PEAK_FLOPS * terms["step_time_lower_bound_s"]) \
            if terms["step_time_lower_bound_s"] else 0.0
    return terms
