"""GPipe-style pipeline parallelism over the 'pod' mesh axis.

Between pods the links are slow, so instead of folding `pod` into data
parallel, the layer stack can be split into `pod`-many stages and
microbatches streamed through with point-to-point hand-offs: the only
inter-stage traffic is one activation tensor per microbatch per tick.

The reference runs the stages as one SPMD program (``shard_map`` +
``ppermute``). Here one process drives a list of stage devices, as
torchgpipe pipelines on one host: each stage has its own CUDA stream,
and a stage hands its activation to the next with
``.to(next_device, non_blocking=True)`` on its own stream, which the
next stage's stream waits for through an event. The schedule is the
classic GPipe fill-compute-drain: ``n_micro + n_stages - 1`` ticks;
stage s works on microbatch ``t - s`` at tick t (bubble fraction
``(S-1)/(M+S-1)``). Devices may repeat (``[cuda:0] * 4`` runs four
stages on one card, their streams free to overlap); on the CPU the
ticks run in order.

``gpipe_forward`` is generic over ``stage_fn(stage_params, x) -> x``;
``tests/test_torch_pipeline.py`` holds it against
:func:`sequential_forward` and the reference's ``gpipe_forward``.
"""
from __future__ import annotations

import contextlib

import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_stages(params_layers, n_stages: int):
    """Split a stacked-layer tree (leading dim L) into (n_stages, L/S, ...)
    views."""
    def split(x):
        n = x.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])
    return _map(split, params_layers)


def schedule(n_micro: int, n_stages: int) -> list:
    """GPipe's ticks: for each, the (stage, microbatch) pairs that run."""
    return [[(s, t - s) for s in range(n_stages) if 0 <= t - s < n_micro]
            for t in range(n_micro + n_stages - 1)]


def stage_devices(devices) -> list:
    """A list of devices, or the devices along a ``DeviceMesh``'s 'pod'
    dim (the other dims at their first coordinate)."""
    if not hasattr(devices, "mesh_dim_names"):
        return [torch.device(d) for d in devices]
    mesh = devices
    ranks = mesh.mesh.movedim(mesh.mesh_dim_names.index("pod"), 0)
    ranks = ranks.reshape(ranks.shape[0], -1)[:, 0].tolist()
    if mesh.device_type == "cuda":
        n = torch.cuda.device_count()
        return [torch.device("cuda", r % n) for r in ranks]
    return [torch.device(mesh.device_type)] * len(ranks)


def gpipe_forward(stage_fn, stage_params, microbatches, *, devices):
    """Run microbatches through pipeline stages, one per device.

    Args:
      stage_fn: (params_one_stage, x) -> y, same x/y shape.
      stage_params: tree with leading dim n_stages (``stack_stages``).
      microbatches: (n_micro, mb, ...) inputs.
      devices: one device per stage (they may repeat), or a
        ``DeviceMesh`` whose 'pod' dim gives them.

    Returns (n_micro, mb, ...) outputs on the last stage's device.
    """
    devs = stage_devices(devices)
    n_stages = len(devs)
    n_micro = microbatches.shape[0]
    params = [_map(lambda p, s=s: p[s].to(devs[s]), stage_params)
              for s in range(n_stages)]
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devs]
    for d, st in zip(devs, streams):
        if st is not None:   # the inputs and parameters are ready
            st.wait_stream(torch.cuda.current_stream(d))
    inbox: list = [None] * n_stages        # (activation, ready event)
    outs: list = [None] * n_micro
    for tick in schedule(n_micro, n_stages):
        # the last stage first: stage s + 1 takes this tick what stage s
        # handed it the tick before, before stage s hands it the next
        for s, m in reversed(tick):
            st = streams[s]
            with (torch.cuda.stream(st) if st is not None
                  else contextlib.nullcontext()):
                if s == 0:
                    x = microbatches[m].to(devs[0], non_blocking=True)
                else:
                    x, ready = inbox[s]
                    if ready is not None:
                        st.wait_event(ready)
                    if x.is_cuda:
                        x.record_stream(st)
                y = stage_fn(params[s], x)
                if s == n_stages - 1:
                    outs[m] = y
                    continue
                y = y.to(devs[s + 1], non_blocking=True)
                ready = None
                if st is not None:
                    ready = torch.cuda.Event()
                    ready.record(st)
                inbox[s + 1] = (y, ready)
    last = devs[-1]
    if streams[-1] is not None:
        torch.cuda.current_stream(last).wait_stream(streams[-1])
        for y in outs:
            y.record_stream(torch.cuda.current_stream(last))
    return torch.stack(outs)


def sequential_forward(stage_fn, stage_params, microbatches, n_stages: int):
    """Reference: apply all stages in order to each microbatch (no
    pipelining), on the microbatches' device."""
    def apply_all(x):
        for s in range(n_stages):
            x = stage_fn(_map(lambda p: p[s], stage_params), x)
        return x
    return torch.stack([apply_all(x) for x in microbatches])


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
